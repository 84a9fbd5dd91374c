"""PyTorch port parity: the native loader's wrapper of thinktwice_tpu_torch
(`train/native_loader.py`) against thinktwice_tpu's and the port's PNG
reader on the CPU.

A fake dataset as tests/test_native_loader.py builds it (two routes of 5
frames, two cameras of 24 x 32 RGB), its PNGs written by PIL in one route
and by the port's `write_png` in the other. Both wrappers over the same
tracked `native/build/libttdataloader.so` give equal lengths, shapes, item
ids and batches, in order and shuffled (equal batch for batch with one
decoding thread; with several, frames arrive in the order the threads
finish, so each frame is compared); every image equals the port's
`read_png` of its file. The port's wrapper never builds the library
and raises OSError, naming the path, for one that does not load. The
tests skip only where the library itself fails to load.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from thinktwice_tpu.train import native_loader as jnative
from thinktwice_tpu_torch.train import native_loader
from thinktwice_tpu_torch.train.png import read_png, write_png

torch.set_num_threads(1)

CAMS = ("rgb_front", "rgb_left")


@pytest.fixture(scope="module")
def fake_dataset(tmp_path_factory):
    try:
        native_loader.NativeImageLoader(str(tmp_path_factory.mktemp("empty")), CAMS).close()
    except OSError as e:
        pytest.skip(f"the native loader does not load here: {e}")
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.RandomState(0)
    for route, write in (("town01_r0", lambda p, a: Image.fromarray(a).save(p)),
                         ("town01_r1", write_png)):
        for cam in CAMS:
            os.makedirs(root / route / cam)
        for i in range(5):
            for cam in CAMS:
                write(str(root / route / cam / f"{i:04d}.png"),
                      rng.randint(0, 255, (24, 32, 3)).astype(np.uint8))
    return str(root)


def _loaders(root, n_threads=2):
    return (native_loader.NativeImageLoader(root, cameras=CAMS, n_threads=n_threads),
            jnative.NativeImageLoader(root, cameras=CAMS, n_threads=n_threads))


def _epoch(loader, seed, shuffle, batch=3):
    """Every batch of one epoch -> ([indices of each batch], {index: images})."""
    loader.start(seed=seed, shuffle=shuffle)
    order, images = [], {}
    while True:
        imgs, idxs = loader.next_batch(batch)
        if len(idxs) == 0:
            return order, images
        assert imgs.shape[1:] == (2, 24, 32, 3)
        order.append(idxs.tolist())
        images.update(zip(idxs.tolist(), imgs))


def test_scan_and_item_ids_match(fake_dataset):
    port, ref = _loaders(fake_dataset)
    with port:
        assert len(port) == len(ref) == 10
        assert (port.img_h, port.img_w, port.n_cams) == (ref.img_h, ref.img_w, ref.n_cams) == (
            24, 32, 2)
        assert [port.item_id(i) for i in range(10)] == [ref.item_id(i) for i in range(10)]
        with pytest.raises(IndexError):
            port.item_id(10)
    ref.close()


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_the_reference_wrapper_and_png_reader(fake_dataset, shuffle):
    """With one decoding thread the batches come in the epoch's order, so
    the two wrappers' batches are equal one for one; with three, in the
    order the threads finish, so each frame's images are compared."""
    for n_threads in (1, 3):
        port, ref = _loaders(fake_dataset, n_threads)
        order, images = _epoch(port, 4, shuffle)
        jorder, jimages = _epoch(ref, 4, shuffle)
        assert sorted(images) == sorted(jimages) == list(range(10))
        for i, imgs in images.items():
            np.testing.assert_array_equal(imgs, jimages[i])
            route, frame = port.item_id(i)
            for c, cam in enumerate(CAMS):
                np.testing.assert_array_equal(
                    imgs[c], read_png(os.path.join(fake_dataset, route, cam, frame)))
        if n_threads == 1:
            assert order == jorder
            flat = sum(order, [])
            assert (flat == sorted(flat)) != shuffle
        port.close()
        ref.close()


def test_missing_library_raises_with_its_path(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "LIBRARY", str(tmp_path / "libmissing.so"))
    with pytest.raises(OSError, match="libmissing.so"):
        native_loader.NativeImageLoader(str(tmp_path), CAMS)
