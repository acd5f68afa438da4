"""``iif_torch/detection/image_io.py`` against what the JAX loader reads
(``cv2.imread(IMREAD_COLOR)`` + ``cvtColor(BGR2RGB)``,
``iif_tpu/detection/pipeline.py:861-868``): PNGs written by cv2 with each
row filter and with its adaptive choice, in greyscale, RGB and RGBA, and
PNGs written by ``write_png``, decode equal; the PNGs it does not read, a
missing file and a JPEG without cv2 raise."""
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from iif_torch.detection.image_io import decode_png, read_image, write_png

torch.set_num_threads(1)

FILTERS = {0: cv2.IMWRITE_PNG_FILTER_NONE, 1: cv2.IMWRITE_PNG_FILTER_SUB,
           2: cv2.IMWRITE_PNG_FILTER_UP, 3: cv2.IMWRITE_PNG_FILTER_AVG,
           4: cv2.IMWRITE_PNG_FILTER_PAETH,
           "all": cv2.IMWRITE_PNG_ALL_FILTERS}


def _image(channels, seed=0):
    rng = np.random.RandomState(seed)
    smooth = np.kron(rng.randint(0, 256, (6, 8, channels)),
                     np.ones((6, 6, 1)))[:33, :45]
    return np.clip(smooth + rng.randint(-9, 10, smooth.shape), 0,
                   255).astype(np.uint8)


def _cv2_read(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("row_filter", list(FILTERS))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_from_cv2_decodes_as_cv2(tmp_path, channels, row_filter):
    img = _image(channels)
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img[..., 0] if channels == 1 else img,
                [cv2.IMWRITE_PNG_FILTER, FILTERS[row_filter]])
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == (33, 45, 3)
    np.testing.assert_array_equal(got, _cv2_read(path))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_reads_back_as_cv2(tmp_path, channels):
    img = _image(channels, seed=1)
    path = tmp_path / "b.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(read_image(str(path)), _cv2_read(path))
    if channels == 3:
        np.testing.assert_array_equal(read_image(str(path)), img)


def _png(width, height, depth, color, interlace=0, data=b""):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                         color, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,color,interlace", [
    (16, 2, 0),        # 16-bit RGB
    (8, 3, 0),         # palette
    (8, 4, 0),         # greyscale + alpha
    (8, 2, 1),         # interlaced
    (1, 0, 0),         # 1-bit greyscale
])
def test_unread_pngs_raise(depth, color, interlace):
    with pytest.raises(ValueError, match="not read"):
        decode_png(_png(2, 2, depth, color, interlace, b"\0" * 64))


def test_missing_file_and_jpeg_without_cv2(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "none.png"))
    jpg = tmp_path / "c.jpg"
    cv2.imwrite(str(jpg), _image(3))
    np.testing.assert_array_equal(read_image(str(jpg)), _cv2_read(jpg))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="c.jpg"):
        read_image(str(jpg))
