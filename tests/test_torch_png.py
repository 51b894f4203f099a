"""The port's PNG reader and writer (utils/png.py) against PIL.

The port reads dataset images with the standard library alone (the card's
machine has no PIL, imageio or OpenCV). Held here: the reader against
PIL on files PIL wrote (8-bit gray, RGB and RGBA; 16-bit gray), on files
built by hand with each of the five row filters on every row and with the
filters mixed, and on sizes hypothesis draws; PIL reads the port's
written files back to the same arrays; palette, interlaced, 16-bit colour
and corrupt files raise with the file's name. Every comparison is exact.
"""

import struct
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from PIL import Image

from orb_slam2_commit_tpu_torch.utils import png

torch.set_num_threads(1)

MODES = {  # PIL mode -> (colour type, dtype, channels)
    "L": (0, np.uint8, 1),
    "RGB": (2, np.uint8, 3),
    "RGBA": (6, np.uint8, 4),
    "I;16": (0, np.uint16, 1),
}


def _image(rng, mode, h, w):
    _, dtype, channels = MODES[mode]
    shape = (h, w) if channels == 1 else (h, w, channels)
    a = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    # Smooth runs, so the filters' predictions matter.
    a[h // 3: 2 * h // 3] = a[h // 3: 2 * h // 3] // 16 * 16
    return a


def _pil_save(path, a, mode):
    if mode == "I;16":
        Image.fromarray(a.astype(np.uint16)).save(path)
    else:
        Image.fromarray(a, mode=mode).save(path)


def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prior, bpp):
    """The PNG specification's filter, byte by byte."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(ctype + body))


def _hand_png(path, a, colour, depth, kinds, interlace=0):
    """A PNG file of array a with row r under filter kinds[r % len(kinds)]."""
    h, w = a.shape[:2]
    data = a.astype(a.dtype.newbyteorder(">")).tobytes()
    stride = len(data) // h
    bpp = stride // w
    raw, prior = b"", bytes(stride)
    for r in range(h):
        row = data[r * stride:(r + 1) * stride]
        kind = kinds[r % len(kinds)]
        raw += bytes([kind]) + _filter_row(kind, row, prior, bpp)
        prior = row
    with open(path, "wb") as f:
        f.write(png.SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
                + _chunk(b"tEXt", b"Comment\x00made by hand")
                + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
def test_reads_pil_files(tmp_path, mode):
    a = _image(np.random.default_rng(0), mode, 37, 53)
    path = str(tmp_path / "pil.png")
    _pil_save(path, a, mode)
    got = png.read_png(path)
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0, 1, 4)])
def test_every_filter_type(tmp_path, mode, kinds):
    colour, dtype, _ = MODES[mode]
    a = _image(np.random.default_rng(sum(kinds) + colour), mode, 9, 13)
    path = str(tmp_path / "hand.png")
    _hand_png(path, a, colour, 8 * np.dtype(dtype).itemsize, kinds)
    got = png.read_png(path)
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)
    # PIL reads the hand-built file to the same array.
    np.testing.assert_array_equal(np.asarray(Image.open(path)).astype(dtype), a)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pil_reads_written_files(tmp_path, dtype):
    a = _image(np.random.default_rng(1), "L" if dtype == np.uint8 else "I;16", 41, 29)
    path = str(tmp_path / "port.png")
    png.write_png(path, a)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back.astype(dtype), a)
    np.testing.assert_array_equal(png.read_png(path), a)


@pytest.mark.parametrize("shape", [(41, 29), (1, 1), (7, 300)])
def test_rgb_written_files(tmp_path, shape):
    """8-bit RGB (colour type 2), the viewer's and the AR demo's images:
    the port's reader and PIL read the written file back exactly."""
    a = _image(np.random.default_rng(shape[1]), "RGB", *shape)
    path = str(tmp_path / "rgb.png")
    png.write_png(path, a)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (*shape, 3)
    np.testing.assert_array_equal(got, a)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), a)


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), wide=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_sizes_round_trip(tmp_path_factory, h, w, wide, seed):
    dtype = np.uint16 if wide else np.uint8
    a = np.random.default_rng(seed).integers(0, np.iinfo(dtype).max + 1, (h, w)).astype(dtype)
    path = str(tmp_path_factory.mktemp("png") / "h.png")
    png.write_png(path, a)
    np.testing.assert_array_equal(png.read_png(path), a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)).astype(dtype), a)


def test_unsupported_files_raise(tmp_path):
    rng = np.random.default_rng(2)
    pal = str(tmp_path / "palette.png")
    Image.fromarray(rng.integers(0, 4, (8, 8)).astype(np.uint8), mode="L").convert(
        "P").save(pal)
    with pytest.raises(ValueError, match="palette.png.*colour type 3"):
        png.read_png(pal)
    inter = str(tmp_path / "interlaced.png")
    _hand_png(inter, rng.integers(0, 256, (8, 8)).astype(np.uint8), 0, 8, (0,), interlace=1)
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        png.read_png(inter)
    rgb16 = str(tmp_path / "rgb16.png")
    _hand_png(rgb16, rng.integers(0, 65536, (4, 4, 3)).astype(np.uint16), 2, 16, (0,))
    with pytest.raises(ValueError, match="rgb16.png.*bit depth 16"):
        png.read_png(rgb16)
    bad = str(tmp_path / "corrupt.png")
    png.write_png(bad, rng.integers(0, 256, (8, 8)).astype(np.uint8))
    data = bytearray(open(bad, "rb").read())
    data[40] ^= 0xFF
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt.png"):
        png.read_png(bad)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match=r"\[H, W, 3\] uint8"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4, 4), np.uint8))
