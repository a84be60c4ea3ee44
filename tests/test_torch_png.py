"""genpose_tpu_torch.utils.png against OpenCV.

The port reads what ``cv2.imwrite`` writes (with cv2's default Sub filter
and with libpng's adaptive choice of all five filters) as ``cv2.imread``
does, in both of its modes, and cv2 reads what the port writes.  Arrays are compared exactly.  cv2 is used in the
test only; the port never imports it.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from genpose_tpu_torch.utils import png


def _images():
    rng = np.random.default_rng(0)
    smooth = np.cumsum(rng.integers(-3, 4, (37, 53, 3)), axis=1) + 128
    return {
        "depth16": (rng.integers(0, 4000, (37, 53)) * (rng.random((37, 53)) > 0.3)
                    ).astype(np.uint16),
        "bgr8": rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
        "smooth_bgr8": np.clip(smooth, 0, 255).astype(np.uint8),
        "gray8": rng.integers(0, 256, (37, 53)).astype(np.uint8),
    }


IMAGES = _images()
# cv2's default (Sub on every row) and libpng's adaptive filters at two levels
CV2_PARAMS = {"default": [], "level9": [cv2.IMWRITE_PNG_COMPRESSION, 9],
              "level3": [cv2.IMWRITE_PNG_COMPRESSION, 3]}


def _row_filters(path):
    data = open(path, "rb").read()
    pos, idat, height = 8, b"", None
    while pos < len(data):
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if ctype == b"IHDR":
            height = struct.unpack(">I", data[pos + 12:pos + 16])[0]
        elif ctype == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = len(raw) // height
    return {raw[y * stride] for y in range(height)}


@pytest.mark.parametrize("params", CV2_PARAMS, ids=list(CV2_PARAMS))
@pytest.mark.parametrize("name", IMAGES, ids=list(IMAGES))
def test_port_reads_cv2_files_as_cv2_does(tmp_path, name, params):
    path = str(tmp_path / f"{name}.png")
    assert cv2.imwrite(path, IMAGES[name], CV2_PARAMS[params])
    for unchanged, flag in ((True, cv2.IMREAD_UNCHANGED), (False, cv2.IMREAD_COLOR)):
        got, want = png.imread(path, unchanged=unchanged), cv2.imread(path, flag)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_cv2_files_use_every_filter(tmp_path):
    """The adaptive writes above hold rows of all five filters, so the
    decoder is held on each of them."""
    seen = set()
    for name, img in IMAGES.items():
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img, CV2_PARAMS["level9"])
        seen |= _row_filters(path)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("name", IMAGES, ids=list(IMAGES))
def test_cv2_reads_port_files(tmp_path, name):
    path = str(tmp_path / f"{name}.png")
    png.imwrite(path, IMAGES[name])
    assert _row_filters(path) == {1}  # Sub, as cv2 writes
    want = IMAGES[name]
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), want)
    np.testing.assert_array_equal(png.imread(path, unchanged=True), want)


def test_bgr_channel_order(tmp_path):
    """Channel 2 of a BGR array is the file's red channel, both ways."""
    img = np.zeros((4, 5, 3), np.uint8)
    img[:, :, 2] = 7
    path = str(tmp_path / "mask.png")
    png.imwrite(path, img)
    rgb = png.decode(open(path, "rb").read())
    assert (rgb[:, :, 0] == 7).all() and (rgb[:, :, 1:] == 0).all()
    assert (png.imread(path)[:, :, 2] == 7).all()
    assert (cv2.imread(path)[:, :, 2] == 7).all()


def _header_only_png(color_type, bit_depth=8, interlace=0, plte=False):
    def chunk(ctype, body):
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(
            ">I", zlib.crc32(ctype + body))

    ihdr = struct.pack(">IIBBBBB", 2, 2, bit_depth, color_type, 0, 0, interlace)
    body = chunk(b"IHDR", ihdr) + (chunk(b"PLTE", bytes(6)) if plte else b"")
    return png._SIGNATURE + body + chunk(b"IDAT", zlib.compress(bytes(20))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("data, match", [
    (_header_only_png(3, plte=True), "palette"),
    (_header_only_png(2, interlace=1), "interlaced"),
    (_header_only_png(6), "colour type 6"),
    (_header_only_png(0, bit_depth=4), "bit depth 4"),
    (b"GIF89a", "not a PNG"),
], ids=["palette", "interlaced", "rgba", "4-bit", "not-png"])
def test_unsupported_files_are_refused(data, match):
    with pytest.raises(ValueError, match=match):
        png.decode(data)


def test_corrupt_chunk_is_refused(tmp_path):
    data = bytearray(png.encode(IMAGES["gray8"]))
    data[-20] ^= 0xFF  # inside the IDAT body: its CRC no longer holds
    with pytest.raises(ValueError, match="corrupt"):
        png.decode(bytes(data))
