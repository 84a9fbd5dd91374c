"""Reader of the reference's on-disk dataset layout (counterpart of
`thinktwice_tpu/train/reference_dataset.py`).

ThinkTwice's collector (roach_ap_agent_data_collection.py save():571-642)
writes, per route folder, per 2 Hz frame index NNNN:
  rgb_{front,left,right,back}/NNNN.png       camera images
  seg_{...}/NNNN.png, depth_{...}/NNNN.png   semantic / depth images
  lidar/NNNN.npy                             2-sweep merged points
  measurements/NNNN.json                     pose, speed, target, command...
  supervision/NNNN.npy                       Roach action/mu/sigma/value/
                                             features/cnn_features dict

This reader reproduces CarlaDataset.get_data_info
(open_loop_training/code/datasets/carla_dataset.py:115-203): index =
(route_folder, frame), future 4-frame waypoints in the current ego frame,
the only_ap_brake Beta override (:178-196), and the dataset_metadata.pkl
route-length index (dataset/tools/generate_metadata.py). Items and batches
are numpy, as the JAX package's are.

It needs no PIL and no cv2: images go through `train/png.py`, and the
traffic-light colour split takes OpenCV's uint8 RGB->HSV (`rgb_to_hsv_u8`,
its integer division tables and rounding) and `in_range` in numpy. The
connected components of that split come from scipy.ndimage, imported in
the function that uses it.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterator

import numpy as np

from thinktwice_tpu_torch.train.png import read_png

PRED_LEN = 4
FRAME_DT = 0.5  # 2 Hz dataset cadence


def _load_json(path):
    with open(path) as f:
        return json.load(f)


_HSV_SHIFT = 12
_HSV_ROUND = 1 << (_HSV_SHIFT - 1)
# OpenCV's division tables of its uint8 RGB->HSV: 255 / v and 180 / (6 diff)
# in 12-bit fixed point, each rounded to the nearest integer (half to even)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))]
                       ).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256,
                                                                          dtype=np.float64)))]
                       ).astype(np.int64)


def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> (..., 3) uint8 HSV with H in 0-179 (half
    degrees), S and V in 0-255: cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)'s
    integer arithmetic."""
    c = np.asarray(rgb, np.uint8).astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + _HSV_ROUND) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + _HSV_ROUND) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def in_range(img: np.ndarray, lower, upper) -> np.ndarray:
    """cv2.inRange: 255 where every channel lies in [lower, upper], else 0."""
    img = np.asarray(img)
    ok = np.all((img >= np.asarray(lower)) & (img <= np.asarray(upper)), axis=-1)
    return np.where(ok, 255, 0).astype(np.uint8)


def _red_green_yellow(rgb_pixels: np.ndarray | None) -> int:
    """Classify a traffic-light blob's color from its RGB pixels
    (loading.py red_green_yellow:96-115): returns the class offset
    {0 unsure/yellow, 1 red, 2 green} added to the TL seg index. HSV
    thresholds follow the reference exactly (the hue is in half degrees)."""
    if rgb_pixels is None or len(rgb_pixels) == 0:
        return 0
    hsv = rgb_to_hsv_u8(rgb_pixels[:, None, :])
    sat_low = int(hsv[:, :, 1].mean() * 1.1)
    val_low = 140
    green = in_range(
        hsv, np.array([70, sat_low, val_low]), np.array([100, 255, 255])
    ).astype(bool).sum()
    red = in_range(
        hsv, np.array([150, sat_low, val_low]), np.array([180, 255, 255])
    ).astype(bool).sum()
    if red < 3 and green < 3:
        return 0
    return 1 if red >= green else 2


# CARLA semantic ids the seg head trains on (configs/thinktwice.py:108):
# building, pedestrian, pole, roadline, road, sidewalk, vehicle, trafficsign,
# trafficlight (the last split into unsure-yellow/red/green)
SEG_LABEL_IDXS = (1, 4, 5, 6, 7, 8, 10, 12, 18)
TL_LABEL = 18


def remap_seg(src: np.ndarray, rgb_u8: np.ndarray | None) -> np.ndarray:
    """CARLA semantic ids (H, W) -> training class ids with the rule-based
    traffic-light color split (loading.py LoadSeg:96-160): connected
    components of the TL class >= 20 px are classified by HSV thresholds over
    the matching RGB pixels; class becomes tl_idx + {0 unsure/yellow, 1 red,
    2 green}."""
    from scipy import ndimage

    seg = np.zeros(src.shape, np.int32)
    for k, label in enumerate(SEG_LABEL_IDXS):
        if label != TL_LABEL:
            seg[src == label] = k
            continue
        labels_cc, n_cc = ndimage.label(src == label, structure=np.ones((3, 3)))
        for cc in range(1, n_cc + 1):
            rows, cols = np.nonzero(labels_cc == cc)
            if len(rows) < 20:
                continue
            pix = None if rgb_u8 is None else rgb_u8[rows, cols]
            seg[rows, cols] = k + _red_green_yellow(pix)
    return seg


def rotate_into(yaw, vec):
    c, s = np.cos(-yaw), np.sin(-yaw)
    return np.stack(
        [vec[..., 0] * c - vec[..., 1] * s, vec[..., 0] * s + vec[..., 1] * c],
        axis=-1,
    )


class ReferenceDataset:
    """Index over route folders in the reference layout."""

    CAMERAS = ("rgb_front", "rgb_left", "rgb_right", "rgb_back")

    def __init__(self, root: str, metadata_pkl: str | None = None,
                 max_frames_per_route: int | None = None):
        self.root = root
        self.items: list[tuple[str, int]] = []
        if metadata_pkl and os.path.exists(metadata_pkl):
            # dataset_metadata.pkl: {route_folder: usable_length}
            with open(metadata_pkl, "rb") as f:
                meta = pickle.load(f)
            routes = meta.items()
        else:
            routes = []
            for d in sorted(os.listdir(root)):
                mdir = os.path.join(root, d, "measurements")
                if os.path.isdir(mdir):
                    routes.append((d, len(os.listdir(mdir))))
        for route, n in routes:
            usable = int(n) - PRED_LEN
            if max_frames_per_route:
                usable = min(usable, max_frames_per_route)
            for i in range(max(usable, 0)):
                self.items.append((route, i))

    def __len__(self):
        return len(self.items)

    def _measurement(self, route: str, idx: int) -> dict:
        return _load_json(
            os.path.join(self.root, route, "measurements", f"{idx:04d}.json")
        )

    def _supervision(self, route: str, idx: int) -> dict:
        return np.load(
            os.path.join(self.root, route, "supervision", f"{idx:04d}.npy"),
            allow_pickle=True,
        ).item()

    @staticmethod
    def _beta_params(sup: dict) -> tuple[np.ndarray, np.ndarray]:
        """Beta (alpha, beta) with the only_ap_brake accel-dim override.

        carla_dataset.py:178-196 sets action_mu[0]=0.8, action_sigma[0]=5.5
        for rule-brake frames and leaves the steering dim untouched.
        """
        alpha = np.asarray(sup.get("action_mu", [1.0, 1.0]), np.float32).copy()
        beta = np.asarray(sup.get("action_sigma", [1.0, 1.0]), np.float32).copy()
        if bool(sup.get("only_ap_brake", False)):
            alpha[0] = 0.8
            beta[0] = 5.5
        return alpha, beta

    def __getitem__(self, i: int) -> dict:
        route, idx = self.items[i]
        m = self._measurement(route, idx)
        pos = np.asarray([m["x"], m["y"]], np.float64) if "x" in m else np.asarray(
            m.get("pos", [0.0, 0.0]), np.float64
        )
        theta = float(m.get("theta", 0.0))

        # future waypoints in the current ego frame (carla_dataset:115-160)
        wps = []
        futures = []
        for k in range(1, PRED_LEN + 1):
            fm = self._measurement(route, idx + k)
            fpos = (
                np.asarray([fm["x"], fm["y"]], np.float64)
                if "x" in fm
                else np.asarray(fm.get("pos", [0.0, 0.0]), np.float64)
            )
            wps.append(rotate_into(theta, fpos - pos))
            futures.append(fm)
        gt_waypoints = np.stack(wps).astype(np.float32)

        sup = self._supervision(route, idx)
        alpha, beta = self._beta_params(sup)

        # future-frame supervision (carla_dataset.py:183-200): Beta params,
        # flattened features, and cnn grid features of frames idx+1..idx+4,
        # each with the same accel-dim only_ap_brake override
        fsups = [self._supervision(route, idx + k) for k in range(1, PRED_LEN + 1)]
        fab = [self._beta_params(s) for s in fsups]
        future_alpha = np.stack([a for a, _ in fab])
        future_beta = np.stack([b for _, b in fab])

        item = {
            "route": route,
            "frame": idx,
            "pos": pos.astype(np.float32),
            "theta": np.float32(theta),
            "speed": np.float32(m.get("speed", 0.0)),
            "target_point": np.asarray(
                m.get("target_point", [0.0, 0.0]), np.float32
            ),
            # reference command transform (carla_dataset.py:158-165):
            # raw RoadOption, VOID(-1) -> 4, minus 1 -> class 0..5
            "command": (
                int(m["target_command"]) - 1
                if int(m.get("target_command", -1)) > 0
                else 3
            )
            if "target_command" in m
            else int(m.get("command", 3)),
            "gt_waypoints": gt_waypoints,
            "action_alpha": alpha,
            "action_beta": beta,
            "future_action_alpha": future_alpha,
            "future_action_beta": future_beta,
            "future_features": np.stack(
                [
                    np.asarray(s.get("features", np.zeros(256)), np.float32)
                    .reshape(-1)
                    for s in fsups
                ]
            ),
            "value": np.float32(np.asarray(sup.get("value", 0.0)).reshape(-1)[0]),
            "features": np.asarray(
                sup.get("features", np.zeros(256)), np.float32
            ).reshape(-1),
        }
        if "cnn_features" in sup:
            item["cnn_features"] = [
                np.asarray(g, np.float32) for g in sup["cnn_features"]
            ]
        if all("cnn_features" in s for s in fsups):
            # future 21x21 Roach grids — targets for the future-BEV
            # distillation terms (thinktwice_decoder.py:590-620)
            item["future_grid_features"] = np.stack(
                [np.asarray(s["cnn_features"][0], np.float32) for s in fsups]
            )
        lidar_path = os.path.join(self.root, route, "lidar", f"{idx:04d}.npy")
        if os.path.exists(lidar_path):
            item["lidar"] = np.load(lidar_path, allow_pickle=True).astype(
                np.float32
            )
        return item

    def load_depth(self, i: int) -> np.ndarray | None:
        """(N, H, W) float32 meters from the reference's RGB-encoded depth
        PNGs (loading.py LoadDepth:88-91: (r + g*256 + b*256^2) /
        (256^3 - 1) * 1000). Falls back to 16-bit centimeter PNGs (our
        exporter's format) when the image is single-channel."""
        route, idx = self.items[i]
        out = []
        for cam in self.CAMERAS:
            p = os.path.join(
                self.root, route, cam.replace("rgb", "depth"), f"{idx:04d}.png"
            )
            if not os.path.exists(p):
                return None
            img = read_png(p)
            if img.ndim == 3:  # CARLA RGB-encoded
                r = img[..., 0].astype(np.float32)
                g = img[..., 1].astype(np.float32)
                b = img[..., 2].astype(np.float32)
                out.append((r + g * 256.0 + b * 256.0 * 256.0)
                           / (256.0 ** 3 - 1.0) * 1000.0)
            else:              # our 16-bit centimeters
                out.append(img.astype(np.float32) / 100.0)
        return np.stack(out)

    def load_seg(self, i: int) -> np.ndarray | None:
        """(N, H, W) int32 remapped labels with the rule-based traffic-light
        color split — for datasets collected by the reference (CARLA semantic
        ids). Data from our own exporter already carries our class ids and
        needs no remap (sensors/raycast.py docstring)."""
        route, idx = self.items[i]
        rgbs = self.load_images(i)
        out = []
        for c, cam in enumerate(self.CAMERAS):
            p = os.path.join(
                self.root, route, cam.replace("rgb", "seg"), f"{idx:04d}.png"
            )
            if not os.path.exists(p):
                return None
            src = read_png(p)
            if src.ndim == 3:
                src = src[..., 0]
            rgb_u8 = None
            if rgbs is not None:
                rgb_u8 = (rgbs[c] * 255).astype(np.uint8)
            out.append(remap_seg(src, rgb_u8))
        return np.stack(out)

    def load_images(self, i: int) -> np.ndarray | None:
        """(N, H, W, 3) float32 in [0,1], or None if PNGs are absent."""
        route, idx = self.items[i]
        imgs = []
        for cam in self.CAMERAS:
            p = os.path.join(self.root, route, cam, f"{idx:04d}.png")
            if not os.path.exists(p):
                return None
            imgs.append(read_png(p).astype(np.float32) / 255.0)
        return np.stack(imgs)

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0) -> Iterator[list[dict]]:
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            yield [self[int(j)] for j in order[s : s + batch_size]]
