"""Export collected frames to the reference's on-disk dataset layout
(counterpart of `thinktwice_tpu/train/export_reference.py`).

The inverse of `train/reference_dataset.py`: writes, per route folder, the
files roach_ap_agent_data_collection.py save() produces (:571-642) --
rgb_*/NNNN.png, depth_*/NNNN.png (16-bit centimetres), seg_*/NNNN.png,
lidar/NNNN.npy, measurements/NNNN.json, supervision/NNNN.npy -- so the
reference's torch training stack, the native loader or either package's
reader can consume data collected in the batched world. The PNGs go through
`train/png.py` (no PIL); the JSON, the .npy files and dataset_metadata.pkl
hold what the JAX package's exporter writes for the same frames.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from thinktwice_tpu_torch.train.png import write_png

CAMERAS = ("rgb_front", "rgb_left", "rgb_right", "rgb_back")


def export_route(out_dir: str, frames, sensors: dict, world: int = 0) -> int:
    """One world of `train.collect.collect_batch`'s output -> one route
    folder. frames: the Frame of (B, F, ...) tensors; sensors: rgb (B, F,
    N, H, W, 3) in [0, 1], depth, semantic, lidar, lidar_mask. Returns the
    number of frames written."""

    def host(x) -> np.ndarray:
        return x[world].detach().cpu().numpy()

    F = int(frames.pos.shape[1])
    subdirs = list(CAMERAS)
    subdirs += [c.replace("rgb", "depth") for c in CAMERAS]
    subdirs += [c.replace("rgb", "seg") for c in CAMERAS]
    subdirs += ["lidar", "measurements", "supervision"]
    for d in subdirs:
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)

    rgb = host(sensors["rgb"])
    depth = host(sensors["depth"])
    sem = host(sensors["semantic"])
    lidar = host(sensors["lidar"])
    lidar_mask = host(sensors["lidar_mask"])
    pos = host(frames.pos)
    yaw = host(frames.yaw)
    speed = host(frames.speed)
    control = host(frames.control)
    target = host(frames.target_point)
    sup = {k: host(v) for k, v in frames.supervision.items() if k != "cnn_features"}
    cnn = [host(g) for g in frames.supervision["cnn_features"]]

    # world-frame kinematics for the reference measurement schema
    # (roach_ap_agent save():607-626). Frames are 2 Hz, so acceleration and
    # angular velocity come from finite differences at that cadence.
    fwd = np.stack([np.cos(yaw), np.sin(yaw)], axis=-1)
    vel = speed[:, None] * fwd                              # (F, 2) world
    dt = 0.5
    accel = np.gradient(vel, dt, axis=0)
    yaw_rate = np.gradient(np.unwrap(yaw), dt)
    # the target point back to the world frame: frames carry it ego-relative
    c, s = np.cos(yaw), np.sin(yaw)
    target_world = pos + np.stack(
        [target[:, 0] * c - target[:, 1] * s,
         target[:, 0] * s + target[:, 1] * c], axis=-1,
    )
    # the reference JSON stores the raw RoadOption (LEFT=1 .. CHANGELANERIGHT
    # =6); frames carry the 0-5 class (RoadOption - 1)
    target_command = host(frames.command).astype(int) + 1

    for i in range(F):
        tag = f"{i:04d}"
        for c, cam in enumerate(CAMERAS):
            write_png(os.path.join(out_dir, cam, tag + ".png"),
                      (rgb[i, c] * 255).astype(np.uint8))
            # depth in centimetres as a 16-bit png (metric, lossless to 655 m)
            write_png(os.path.join(out_dir, cam.replace("rgb", "depth"), tag + ".png"),
                      np.clip(depth[i, c] * 100.0, 0, 65535).astype(np.uint16))
            write_png(os.path.join(out_dir, cam.replace("rgb", "seg"), tag + ".png"),
                      sem[i, c].astype(np.uint8))
        np.save(os.path.join(out_dir, "lidar", tag + ".npy"), lidar[i][lidar_mask[i]])
        # The reference's CarlaDataset swaps axes and subtracts pi/2 from
        # theta (carla_dataset.py:120-125); writing the world (x, y, theta)
        # raw makes those transforms cancel exactly, so the ego-frame
        # waypoints and target points it computes equal ours.
        meas = {
            "x": float(pos[i, 0]),
            "y": float(pos[i, 1]),
            "theta": float(yaw[i]),
            "speed": float(speed[i]),
            "acceleration": [float(accel[i, 0]), float(accel[i, 1]), 0.0],
            "angular_velocity": [0.0, 0.0, float(yaw_rate[i])],
            "x_target": float(target_world[i, 0]),
            "y_target": float(target_world[i, 1]),
            "target_command": int(target_command[i]),
            "target_point": target[i].tolist(),
            "command": int(target_command[i]),
            "steer": float(control[i, 0]),
            "throttle": float(control[i, 1]),
            "brake": float(control[i, 2]),
        }
        with open(os.path.join(out_dir, "measurements", tag + ".json"), "w") as f:
            json.dump(meas, f)
        sup_i = {
            "action": sup["action"][i],
            "action_mu": sup["alpha"][i],
            "action_sigma": sup["beta"][i],
            "value": sup["value"][i],
            "features": sup["features"][i],
            "cnn_features": [g[i] for g in cnn],
            "only_ap_brake": bool(sup["only_ap_brake"][i]),
        }
        np.save(os.path.join(out_dir, "supervision", tag + ".npy"), sup_i, allow_pickle=True)
    return F


def export_metadata(root: str, out_pkl: str | None = None) -> dict:
    """dataset_metadata.pkl (dataset/tools/generate_metadata.py's output):
    {route folder: frame count}."""
    meta = {}
    for d in sorted(os.listdir(root)):
        mdir = os.path.join(root, d, "measurements")
        if os.path.isdir(mdir):
            meta[d] = len(os.listdir(mdir))
    if out_pkl:
        with open(out_pkl, "wb") as f:
            pickle.dump(meta, f)
    return meta
