"""PyTorch port parity: the reference-format dataset of thinktwice_tpu_torch
(`train/png.py`, `train/reference_dataset.py`, `train/export_reference.py`)
against PIL, cv2 and thinktwice_tpu on the CPU.

- The PNG codec: images of color types 0, 2 and 6 at bit depths 8 and 16,
  each row filtered by one of the five filters (the filtered streams built
  by hand here, and one image with every filter in turn), decode equal to
  PIL's; what `write_png` writes (8-bit RGB, 16-bit and 8-bit gray) PIL
  reads back equal; PIL's own files decode equal; an interlaced image and a
  damaged chunk raise.
- `rgb_to_hsv_u8` equals cv2's COLOR_RGB2HSV on every gray level, on every
  colour with two equal channels and on 10^6 random colours; `in_range`
  equals cv2.inRange.
- `remap_seg` equals the JAX package's on the JAX suite's synthetic
  traffic-light scene and on random scenes.
- Export: one world of the port's `collect_batch` at the JAX suite's TINY
  sizes (tests/test_pipeline.py), 7 frames, exported by both packages
  (PIL on the JAX side, `train/png.py` on the port's): equal measurement
  JSON, lidar and supervision .npy files, pixels and dataset_metadata.pkl;
  each package's `ReferenceDataset` reads each export to equal items,
  images, depth and seg; the port's read of its own export holds the
  collected images within 1/255, depth within 1 cm, seg exactly.
"""

import json
import os
import pickle
import struct
import types
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from thinktwice_tpu.train import export_reference as jexport
from thinktwice_tpu.train import reference_dataset as jref
from thinktwice_tpu_torch.agents.roach import RoachPolicy
from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, ModelConfig, SimConfig
from thinktwice_tpu_torch.rollout import grid_world
from thinktwice_tpu_torch.train import collect, export_reference, loop, png, reference_dataset

torch.set_num_threads(1)

TINY = Config(
    sim=SimConfig(max_vehicles=8, max_walkers=4, max_route_len=256, max_scenarios=4),
    camera=CameraConfig(height=32, width=64), lidar=LidarConfig(n_beams=4, n_azimuth=64),
    model=ModelConfig(img_height=32, img_width=64, refine_num=1, bev_channels=64,
                      n_depth_bins=16, lidar_pillar_grid=84))
N_FRAMES = 7
FORMATS = [(0, 8), (0, 16), (2, 8), (2, 16), (6, 8), (6, 16)]   # (color type, depth)


# --------------------------------------------------------------------------
# PNG


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_row(kind, line, prior, bpp):
    """The filtered bytes of one scanline (the PNG specification's filters,
    written out byte by byte)."""
    out = []
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) % 256)
    return out


def handmade_png(color, depth, filters, h=5, w=7, seed=0, interlace=0):
    """(PNG bytes, the image as uint8/uint16 (h, w[, channels])) with row r
    filtered by filters[r % len(filters)]."""
    ch = {0: 1, 2: 3, 6: 4}[color]
    rng = np.random.RandomState(seed)
    top = 256 if depth == 8 else 65536
    img = rng.randint(0, top, (h, w, ch)).astype(np.uint8 if depth == 8 else np.uint16)
    img[0, 0] = 0
    img[-1, -1] = top - 1
    lines = img.astype(">u2").view(np.uint8) if depth == 16 else img
    lines = lines.reshape(h, -1)
    bpp = ch * depth // 8
    raw, prior = [], [0] * lines.shape[1]
    for r in range(h):
        kind = filters[r % len(filters)]
        line = lines[r].tolist()
        raw += [kind] + _filter_row(kind, line, prior, bpp)
        prior = line
    data = (png.SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))
    return data, img


def pil_decode(path) -> np.ndarray:
    im = Image.open(path)
    if im.mode == "RGBA":
        im = im.convert("RGB")
    return np.asarray(im)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("filt", range(5))
def test_png_decode_matches_pil(fmt, filt, tmp_path):
    color, depth = fmt
    data, img = handmade_png(color, depth, [filt], seed=10 * filt + color + depth)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    got = png.read_png(str(path))
    want = img[..., 0] if img.shape[-1] == 1 else img[..., :3]
    if depth == 16 and color != 0:
        want = (want >> 8).astype(np.uint8)      # PIL keeps 8 bits of a colour
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    ref = pil_decode(path)
    np.testing.assert_array_equal(got.astype(np.int64), ref.astype(np.int64))


def test_png_decode_every_filter_in_one_image(tmp_path):
    for color, depth in FORMATS:
        data, img = handmade_png(color, depth, [4, 0, 3, 1, 2, 4, 3], h=9, w=11, seed=7)
        path = tmp_path / f"{color}_{depth}.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(png.read_png(str(path)).astype(np.int64),
                                      pil_decode(path).astype(np.int64))


def test_png_encode_is_read_by_pil_and_back(tmp_path):
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (13, 17, 3)).astype(np.uint8),
              rng.randint(0, 65536, (13, 17)).astype(np.uint16),
              rng.randint(0, 256, (13, 17)).astype(np.uint8)]
    for k, img in enumerate(images):
        path = str(tmp_path / f"w{k}.png")
        png.write_png(path, img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)).astype(np.int64),
                                      img.astype(np.int64))
        np.testing.assert_array_equal(png.read_png(path), img)
        # and PIL's own file of the same image (adaptive filters) decodes equal
        Image.fromarray(img).save(tmp_path / f"pil{k}.png")
        np.testing.assert_array_equal(png.read_png(str(tmp_path / f"pil{k}.png")), img)
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))


def test_png_rejects_interlace_and_damage(tmp_path):
    data, _ = handmade_png(2, 8, [0], interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(data)
    data, _ = handmade_png(2, 8, [1])
    bad = bytearray(data)
    bad[40] ^= 0xFF                      # inside IDAT: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + data[6:])


# --------------------------------------------------------------------------
# HSV, inRange, remap_seg


def test_rgb_to_hsv_matches_cv2():
    v = np.arange(256)
    gray = np.repeat(v[:, None], 3, axis=1).astype(np.uint8)[:, None]
    a, b = np.meshgrid(v, v, indexing="ij")
    ties = np.concatenate([np.stack([(a, b)[k] for k in perm], axis=-1).reshape(-1, 1, 3)
                           for perm in ((0, 0, 1), (0, 1, 0), (1, 0, 0))]).astype(np.uint8)
    rand = np.random.RandomState(0).randint(0, 256, (10 ** 6, 1, 3)).astype(np.uint8)
    for img in (gray, ties, rand):
        np.testing.assert_array_equal(reference_dataset.rgb_to_hsv_u8(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    hsv = cv2.cvtColor(rand, cv2.COLOR_RGB2HSV)
    for lo, hi in (([70, 30, 140], [100, 255, 255]), ([150, 0, 140], [180, 255, 255])):
        np.testing.assert_array_equal(reference_dataset.in_range(hsv, np.array(lo), np.array(hi)),
                                      cv2.inRange(hsv, np.array(lo), np.array(hi)))


def _tl_scene():
    """tests/test_export_roundtrip.py's scene: a road patch, a lit red
    traffic light in a dark housing, and a blob under 20 pixels."""
    src = np.zeros((32, 32), np.uint8)
    src[2:6, 2:10] = 7
    src[10:16, 10:16] = 18
    src[25:27, 25:27] = 18
    rgb = np.zeros((32, 32, 3), np.uint8)
    rgb[10:16, 10:16] = [40, 40, 40]
    rgb[11:14, 11:14] = [255, 0, 85]
    return src, rgb


def test_remap_seg_matches_jax():
    src, rgb = _tl_scene()
    for lamp in ([255, 0, 85], [0, 255, 170], [255, 200, 0]):
        rgb[11:14, 11:14] = lamp
        np.testing.assert_array_equal(reference_dataset.remap_seg(src, rgb),
                                      jref.remap_seg(src, rgb))
    assert (reference_dataset.remap_seg(src, rgb)[2:6, 2:10] == 4).all()
    rng = np.random.RandomState(5)
    labels = np.asarray([0, 1, 4, 5, 6, 7, 8, 10, 12, 18, 18, 18])
    for _ in range(4):
        src = labels[rng.randint(0, len(labels), (12, 16))].repeat(4, 0).repeat(4, 1)
        rgb = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        got = reference_dataset.remap_seg(src.astype(np.uint8), rgb)
        np.testing.assert_array_equal(got, jref.remap_seg(src.astype(np.uint8), rgb))
        np.testing.assert_array_equal(reference_dataset.remap_seg(src.astype(np.uint8), None),
                                      jref.remap_seg(src.astype(np.uint8), None))
        assert (got >= 8).any()


# --------------------------------------------------------------------------
# export and read back


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One world's 7 frames collected by the port at TINY sizes, exported
    by both packages into two dataset roots."""
    policy = RoachPolicy.from_config(TINY)
    loop.init_model_params(TINY, policy, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    town, state = grid_world(TINY, 1, 4, device="cpu", generator=g)
    _, frames, sensors = collect.collect_batch(TINY, policy.eval(), town, state, N_FRAMES,
                                               generator=g)
    # the JAX exporter takes one world's frames as numpy, (F, ...)
    sup = {k: v[0].numpy() for k, v in frames.supervision.items() if k != "cnn_features"}
    sup["cnn_features"] = tuple(g_[0].numpy() for g_ in frames.supervision["cnn_features"])
    jframes = types.SimpleNamespace(
        **{k: getattr(frames, k)[0].numpy() for k in ("pos", "yaw", "speed", "control",
                                                       "target_point", "command")},
        supervision=sup)
    jsensors = {k: v[0].numpy() for k, v in sensors.items()}
    roots = {k: tmp_path_factory.mktemp(f"ref_{k}") for k in ("port", "jax")}
    assert export_reference.export_route(str(roots["port"] / "town01_00"), frames,
                                         sensors) == N_FRAMES
    assert jexport.export_route(str(roots["jax"] / "town01_00"), jframes,
                                jsensors) == N_FRAMES
    meta = {k: export_reference.export_metadata(str(r), str(r / "dataset_metadata.pkl"))
            for k, r in roots.items()}
    assert meta["port"] == {"town01_00": N_FRAMES}
    jexport.export_metadata(str(roots["jax"]), str(roots["jax"] / "jax_metadata.pkl"))
    return {k: str(v) for k, v in roots.items()}, jsensors


def _same(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{k}]")
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


def test_export_files_match_the_reference_exporter(exports):
    roots, _ = exports
    port, jax_ = (os.path.join(roots[k], "town01_00") for k in ("port", "jax"))
    for d in sorted(os.listdir(jax_)):
        names = sorted(os.listdir(os.path.join(jax_, d)))
        assert names == sorted(os.listdir(os.path.join(port, d))), d
        for name in names:
            a, b = os.path.join(port, d, name), os.path.join(jax_, d, name)
            if name.endswith(".json"):
                with open(a) as f, open(b) as g:
                    assert json.load(f) == json.load(g), (d, name)
            elif name.endswith(".npy"):
                _same(np.load(a, allow_pickle=True)[()], np.load(b, allow_pickle=True)[()],
                      f"{d}/{name}")
            else:
                np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                              np.asarray(Image.open(b)), err_msg=f"{d}/{name}")
    with open(os.path.join(roots["port"], "dataset_metadata.pkl"), "rb") as f, open(
            os.path.join(roots["jax"], "jax_metadata.pkl"), "rb") as g:
        assert pickle.load(f) == pickle.load(g)


@pytest.mark.parametrize("written_by", ["port", "jax"])
def test_each_reader_reads_each_export_alike(exports, written_by):
    roots, _ = exports
    root = roots[written_by]
    ds = reference_dataset.ReferenceDataset(root, os.path.join(root, "dataset_metadata.pkl"))
    jds = jref.ReferenceDataset(root, os.path.join(root, "dataset_metadata.pkl"))
    assert len(ds) == len(jds) == N_FRAMES - reference_dataset.PRED_LEN
    for i in range(len(ds)):
        _same(ds[i], jds[i], f"item {i}")
        for load in ("load_images", "load_depth", "load_seg"):
            _same(getattr(ds, load)(i), getattr(jds, load)(i), f"{load} {i}")
    batches = list(ds.iter_batches(2, seed=3))
    jbatches = list(jds.iter_batches(2, seed=3))
    assert [[b["frame"] for b in x] for x in batches] == [[b["frame"] for b in x]
                                                           for x in jbatches]


def test_port_export_reads_back_within_tolerance(exports):
    roots, sensors = exports
    ds = reference_dataset.ReferenceDataset(roots["port"])
    for i in range(len(ds)):
        np.testing.assert_allclose(ds.load_images(i), sensors["rgb"][i], atol=1 / 255)
        np.testing.assert_allclose(ds.load_depth(i), sensors["depth"][i], atol=0.01)
        for c, cam in enumerate(reference_dataset.ReferenceDataset.CAMERAS):
            seg = png.read_png(os.path.join(roots["port"], "town01_00",
                                            cam.replace("rgb", "seg"), f"{i:04d}.png"))
            np.testing.assert_array_equal(seg, sensors["semantic"][i, c].astype(np.uint8))
        assert ds.load_seg(i).dtype == np.int32
    item = ds[0]
    assert item["features"].shape == (256,) and len(item["cnn_features"]) == 4
    assert item["future_action_alpha"].shape == (4, 2)
    assert item["future_grid_features"].shape[0] == 4
