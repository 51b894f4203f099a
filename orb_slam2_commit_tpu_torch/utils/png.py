"""PNG reading and writing with the standard library (zlib, struct) and
numpy.

The datasets the drivers read (TUM RGB-D, KITTI odometry, EuRoC MAV)
store their images as PNG files: 8-bit gray (KITTI, EuRoC), 8-bit RGB
(TUM colour) and 16-bit gray (TUM depth). This module reads what they
hold, non-interlaced files of colour type 0 (gray), 2 (RGB) or 6 (RGBA)
at bit depth 8, or gray at bit depth 16 (stored big-endian), under any of
the five row filters; any other file raises with its name. It writes 8-bit
and 16-bit gray files and 8-bit RGB files (the viewer's and the AR demo's
images), every row under the Up filter.

Decoding speed: the None, Sub and Up filters are whole-row numpy
operations; Average and Paeth depend on the reconstructed byte to their
left, so those rows are reconstructed byte by byte in Python.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}     # colour type -> samples a pixel
FILTER_UP = 2


def _chunks(data: bytes, path: str):
    """(type, body) of every chunk, each CRC checked, up to IEND."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{path}: PNG chunk {ctype!r} runs past the end of the file")
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end
    raise ValueError(f"{path}: PNG file has no IEND chunk")


def _unfilter_average(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(min(bpp, len(cur))):
        cur[i] = (cur[i] + (up[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter_paeth(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(min(bpp, len(cur))):
        cur[i] = (cur[i] + up[i]) & 0xFF      # a = c = 0: the predictor is b
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path: str) -> np.ndarray:
    """A PNG file -> [H, W] (gray) or [H, W, 3 | 4] (RGB, RGBA), uint8 at
    bit depth 8, uint16 at bit depth 16."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG file has no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour} is not read "
                         "(gray 0, RGB 2 and RGBA 6 are)")
    if not (depth == 8 or (depth == 16 and colour == 0)):
        raise ValueError(f"{path}: PNG bit depth {depth} of colour type {colour} is not "
                         "read (8, and 16 for gray, are)")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG files are not read")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    channels = CHANNELS[colour]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, "
                         f"{h * (stride + 1)} expected")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = rows[r, 0], rows[r, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            # Sub: a running sum (mod 256) over the bytes bpp apart.
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind == 3:
            cur = _unfilter_average(line, prior, bpp)
        elif kind == 4:
            cur = _unfilter_paeth(line, prior, bpp)
        else:
            raise ValueError(f"{path}: PNG row {r} has unknown filter type {kind}")
        out[r] = cur
        prior = out[r]
    if depth == 16:
        return out.view(">u2").reshape(h, w).astype(np.uint16)
    return out.reshape(h, w) if channels == 1 else out.reshape(h, w, channels)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_png(path: str, image: np.ndarray) -> None:
    """Write a [H, W] uint8 (8-bit gray) or uint16 (16-bit gray) array, or
    an [H, W, 3] uint8 array (8-bit RGB)."""
    image = np.asarray(image)
    gray = image.ndim == 2 and image.dtype in (np.uint8, np.uint16)
    rgb = image.ndim == 3 and image.shape[2] == 3 and image.dtype == np.uint8
    if not (gray or rgb):
        raise ValueError(f"{path}: write_png takes a [H, W] uint8 or uint16 array or an "
                         f"[H, W, 3] uint8 array, got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    depth = 8 * image.dtype.itemsize
    stride = image[0].size * image.dtype.itemsize
    rows = np.frombuffer(image.astype(image.dtype.newbyteorder(">")).tobytes(),
                         np.uint8).reshape(h, stride)
    filtered = rows.copy()
    filtered[1:] -= rows[:-1]
    raw = np.concatenate([np.full((h, 1), FILTER_UP, np.uint8), filtered], axis=1)
    colour = 0 if gray else 2
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
