"""PNG read and write with the standard library and numpy.

Replaces ``cv2.imread`` / ``cv2.imwrite`` for the images of a NOCS tree, so
that the port needs no OpenCV, PIL or matplotlib:

- 16-bit grayscale (``*_depth.png`` of Real scenes),
- 8-bit 3-channel (``*_color.png``, ``*_mask.png``, CAMERA depth),
- 8-bit grayscale,

and 16-bit 3-channel.  Three-channel arrays are in cv2's order, BGR:
``imread(p)[:, :, 2]`` is the PNG's red channel, as with ``cv2.imread``,
and ``imwrite`` takes BGR arrays.  Samples of 16-bit images are big-endian
in the file.  All five row filters are decoded (libpng picks among them
row by row); the writer uses Sub, cv2's default.  Palette, alpha, sub-byte
and interlaced images are refused with a ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # colour type -> samples per pixel (grayscale, truecolour)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f"corrupt PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes from its filtered bytes (PNG spec, section 9)."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: a running sum per byte of a pixel, modulo 256
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return row + prev
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG row filter {ftype}")
    # Average and Paeth depend on the byte just reconstructed: sequential
    f, b = row.tolist(), prev.tolist()
    out = [0] * len(f)
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            out[i] = (f[i] + ((a + b[i]) >> 1)) & 0xFF
            continue
        c = b[i - bpp] if i >= bpp else 0
        p = a + b[i] - c
        pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        out[i] = (f[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> array as stored: [H, W] grayscale or [H, W, 3] RGB,
    uint8 or uint16 (native byte order)."""
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            raise ValueError("palette PNGs are not supported")
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported (grayscale or RGB only)")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported (8 or 16 only)")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if comp or filt:
        raise ValueError("unknown PNG compression or filter method")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {height * (stride + 1)}")
    raw = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    return img.reshape(height, width, channels) if channels > 1 else img.reshape(height, width)


def imread(path: str, unchanged: bool = False) -> np.ndarray:
    """``cv2.imread(path, -1)`` (``unchanged``) or ``cv2.imread(path)``.

    ``unchanged``: grayscale [H, W] or BGR [H, W, 3] at the file's depth.
    Otherwise 8-bit BGR [H, W, 3]: grayscale is repeated into three
    channels and 16-bit samples keep their high byte.  A missing file
    raises ``FileNotFoundError`` (cv2 returns None).
    """
    with open(path, "rb") as f:
        img = decode(f.read())
    if img.ndim == 3:
        img = img[:, :, ::-1]
    if not unchanged:
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img)


def encode(img: np.ndarray) -> bytes:
    """Array as stored ([H, W] grayscale or [H, W, 3] RGB, uint8 or uint16)
    -> PNG bytes, every row with the Sub filter (as cv2 writes them)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"cannot write an image of shape {img.shape}")
    height, width = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(height, -1)
    bpp = channels * depth // 8
    filtered = rows.copy()  # Sub: each byte less the byte one pixel to its left, modulo 256
    filtered[:, bpp:] -= rows[:, :-bpp]
    raw = np.concatenate([np.full((height, 1), 1, np.uint8), filtered], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, 0 if channels == 1 else 2, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite`` for PNGs: grayscale [H, W] or BGR [H, W, 3], uint8 or uint16."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[:, :, ::-1]
    with open(path, "wb") as f:
        f.write(encode(img))
