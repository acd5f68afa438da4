"""Image files for the loader: what ``cv2.imread(path, IMREAD_COLOR)`` +
``cvtColor(BGR2RGB)`` give in ``iif_tpu/detection/pipeline.py::
DetectionLoader._load_image``, without cv2 for PNG.

PNG is decoded exactly with ``zlib`` and NumPy: 8-bit greyscale, RGB and
RGBA, non-interlaced, every one of the five row filters (None, Sub, Up,
Average, Paeth). Greyscale is repeated over three channels and alpha is
dropped, as cv2's colour read does. Any other PNG raises. Every other
format (JPEG) goes through cv2, imported when such a file is read; where
cv2 is missing the error names the file. ``write_png`` writes the PNGs
that this module reads.
"""
from __future__ import annotations

import struct
import zlib
import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}           # PNG colour type -> channels


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the image file at ``path``."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    return decode_image(data, path)


def decode_image(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image file's bytes: PNG without cv2,
    any other format through ``cv2.imdecode``."""
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, path)
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"{path}: only PNG is decoded without cv2, and "
                           "cv2 is not installed") from None
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"{path}: cv2 cannot decode this file")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG file's bytes."""
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type "
                         f"{color}, interlace {interlace} is not read; only "
                         "8-bit greyscale, RGB or RGBA, non-interlaced")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes for "
                         f"{w}x{h}x{ch}")
    rows = raw.reshape(h, 1 + w * ch)
    filters = rows[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {filters.max()}")
    img = _unfilter(rows[:, 1:].reshape(h, w, ch), filters)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the per-row filters of (H, W, C) bytes. None, Sub and Up rows
    are whole-row operations; with an Average or Paeth row, pixels are
    rebuilt one anti-diagonal at a time (each pixel needs its left, upper
    and upper-left neighbours), all rows at once."""
    h, w, ch = filt.shape
    if not np.isin(filters, (3, 4)).any():
        out = np.empty_like(filt)
        prior = np.zeros((w, ch), np.uint8)
        for y in range(h):
            row = filt[y]
            if filters[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif filters[y] == 2:
                row = row + prior
            out[y] = prior = row
        return out
    rec = np.zeros((h + 1, w + 1, ch), np.int32)     # a zero row and column
    f = filt.astype(np.int32)
    kind = filters.astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(d, h - 1) + 1)
        xs = d - ys
        a = rec[ys + 1, xs]
        b = rec[ys, xs + 1]
        c = rec[ys, xs]
        t = kind[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) or (H, W, 1|3|4) uint8 (greyscale, RGB, RGBA) as an
    8-bit non-interlaced PNG, every row unfiltered."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * ch)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))
