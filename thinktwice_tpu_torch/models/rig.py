"""Camera rig geometry: intrinsics and extrinsics of the 4-camera setup
(a copy of `thinktwice_tpu/models/rig.py`, numpy only).

Ideal pinhole cameras at ego-frame yaws (0, -90, 90, 180) deg, mounted at
cam_height, with intrinsics from the fov. Ego frame: x forward, y right,
z up. Camera frame: z forward (optical axis), x right, y down. Image: u
right, v down.
"""

from __future__ import annotations

import numpy as np

from thinktwice_tpu_torch.config import CameraConfig


def intrinsics(cfg: CameraConfig) -> np.ndarray:
    """(3, 3) pinhole K shared by all cameras."""
    f = cfg.width / (2.0 * np.tan(np.deg2rad(cfg.fov_deg) / 2.0))
    return np.asarray(
        [[f, 0.0, cfg.width / 2.0], [0.0, f, cfg.height / 2.0], [0.0, 0.0, 1.0]],
        np.float32,
    )


def cam_to_ego(cfg: CameraConfig) -> np.ndarray:
    """(N, 4, 4) cam->ego transforms (R | t)."""
    mats = []
    for yaw_deg in cfg.cam_yaws:
        yaw = np.deg2rad(yaw_deg)
        fwd = np.asarray([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.asarray([-np.sin(yaw), np.cos(yaw), 0.0])
        down = np.asarray([0.0, 0.0, -1.0])
        R = np.stack([right, down, fwd], axis=1)  # columns = cam x, y, z in ego
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = R
        M[:3, 3] = np.asarray([0.0, 0.0, cfg.cam_height])
        mats.append(M)
    return np.stack(mats)


def ego_to_img(cfg: CameraConfig) -> np.ndarray:
    """(N, 4, 4) ego->image projective matrices: x_img ~ K @ [R|t]^-1 @ x_ego."""
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = intrinsics(cfg)
    return np.stack([K4 @ np.linalg.inv(M) for M in cam_to_ego(cfg)])
