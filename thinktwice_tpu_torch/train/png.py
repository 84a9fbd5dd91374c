"""PNG read and write on `zlib` and `struct` alone, for the reference-format
dataset (`train/export_reference.py`, `train/reference_dataset.py`) on a
machine without PIL.

`read_png` decodes non-interlaced images of color type 0 (gray), 2 (RGB)
and 6 (RGBA, returned as RGB), at bit depth 8 or 16, with any of the five
row filters, into the arrays PIL's `np.asarray(Image.open(path))` gives
for those files (RGBA converted to RGB): (H, W) uint8 or, at depth 16,
uint16 gray; (H, W, 3) uint8 RGB, of which PIL keeps the high byte of a
16-bit sample. It raises ValueError on an interlaced image, another color
type or depth, or a damaged chunk. `write_png` writes what the exporter writes through PIL:
8-bit RGB, 8-bit gray and 16-bit gray, every row unfiltered.

The Sub and Up filters are undone with numpy over a whole row; Average and
Paeth depend on the pixel just decoded to their left, so they run byte by
byte in Python (slow for large images; the native loader is the fast path
for a reference dataset's RGB images).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes from its filtered bytes and the decoded line
    above (zeros above the first)."""
    if kind == 0:
        return row
    if kind == 1:      # Sub: a running sum of each byte lane, modulo 256
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:      # Up
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG filter type {kind}")
    out = bytearray(row.tobytes())
    up = prior.tolist()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:  # Average
            pred = (left + up[i]) >> 1
        else:          # Paeth
            pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the image array (see the module's docstring)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without IHDR")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG images are not supported")
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG color type {color} at depth {depth} is not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data of the wrong size")
    lines = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        prior = out[r] = _unfilter(int(lines[r, 0]), lines[r, 1:], prior, bpp)
    if channels == 1:
        img = out.view(">u2").astype(np.uint16) if depth == 16 else out
        return img.reshape(height, width)
    img = out.reshape(height, width, channels, depth // 8)[..., 0]   # the high byte
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> 8-bit RGB; (H, W) uint8 -> 8-bit gray; (H, W)
    uint16 -> 16-bit gray."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth = 2, 8
    elif img.dtype == np.uint8 and img.ndim == 2:
        color, depth = 0, 8
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth = 0, 16
        img = img.astype(">u2")
    else:
        raise ValueError(f"cannot write a PNG of {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)   # filter 0
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
