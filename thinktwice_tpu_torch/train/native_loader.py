"""ctypes bridge to the native C++ dataset loader (counterpart of
`thinktwice_tpu/train/native_loader.py`).

`native/build/libttdataloader.so` (built from `native/dataloader.cpp`, and
kept in the repository) decodes a reference-layout dataset's RGB PNGs with
libpng on a thread pool and prefetches whole batches: Python receives uint8
image batches and frame indices, which it joins with the measurements and
supervision through `train/reference_dataset.ReferenceDataset`. This
wrapper loads the library as it is and never builds it; where it does not
load (libpng missing, say), the constructor raises OSError with its path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIBRARY = os.path.join(REPO, "native", "build", "libttdataloader.so")


def _load(path: str) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise OSError(f"cannot load the native dataset loader {path}: {e}") from e
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.dl_create.restype = vp
    lib.dl_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.dl_len.restype = i64
    lib.dl_len.argtypes = [vp]
    lib.dl_image_shape.restype = None
    lib.dl_image_shape.argtypes = [vp, ctypes.POINTER(i64), ctypes.POINTER(i64),
                                   ctypes.POINTER(i64)]
    lib.dl_start.restype = None
    lib.dl_start.argtypes = [vp, ctypes.c_uint64, ctypes.c_int]
    lib.dl_next.restype = i64
    lib.dl_next.argtypes = [vp, i64, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(i64)]
    lib.dl_item.restype = None
    lib.dl_item.argtypes = [vp, i64, ctypes.c_char_p, i64, ctypes.c_char_p, i64]
    lib.dl_destroy.restype = None
    lib.dl_destroy.argtypes = [vp]
    return lib


class NativeImageLoader:
    """Prefetching image-batch loader over a reference-layout dataset root:
    every <route>/<cameras[0]>/*.png is an item, read with the same file name
    from each camera's folder."""

    def __init__(self, root: str, cameras=("rgb_front", "rgb_left", "rgb_right", "rgb_back"),
                 n_threads: int = 4):
        self._h = None
        self._lib = _load(LIBRARY)
        self._h = self._lib.dl_create(root.encode(), ",".join(cameras).encode(), n_threads)
        h, w, n = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        self._lib.dl_image_shape(self._h, ctypes.byref(h), ctypes.byref(w), ctypes.byref(n))
        self.img_h, self.img_w, self.n_cams = h.value, w.value, n.value

    def __len__(self) -> int:
        return int(self._lib.dl_len(self._h))

    def item_id(self, i: int) -> tuple[str, str]:
        """(route folder, frame file name) of item i."""
        if not 0 <= i < len(self):
            raise IndexError(f"item {i} of {len(self)}")
        route = ctypes.create_string_buffer(512)
        frame = ctypes.create_string_buffer(64)
        self._lib.dl_item(self._h, i, route, 512, frame, 64)
        return route.value.decode(), frame.value.decode()

    def start(self, seed: int = 0, shuffle: bool = True) -> None:
        """Begin an epoch: the items in order, or shuffled from seed."""
        self._lib.dl_start(self._h, seed, int(shuffle))

    def next_batch(self, batch_size: int):
        """-> (images uint8 (n, n_cams, H, W, 3), indices (n,)) with
        n <= batch_size; n == 0 signals the epoch's end."""
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size}")
        images = np.empty((batch_size, self.n_cams, self.img_h, self.img_w, 3), np.uint8)
        idxs = np.empty((batch_size,), np.int64)
        n = self._lib.dl_next(
            self._h, batch_size,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return images[:n], idxs[:n]

    def close(self) -> None:
        if self._h:
            self._lib.dl_destroy(self._h)
            self._h = None

    def __enter__(self) -> "NativeImageLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
