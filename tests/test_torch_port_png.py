"""The port's PNG and PPM reader (``data/png.py``) against ``cv2.imread``,
bit for bit, and the host helper's PNG unfilter and inpaint
(``data/host.py``) against their numpy versions.

The PNGs are written by the port's encoder with each of the five row
filters (and all five mixed row by row), because the fixtures never
exercise Average or Paeth: cv2 writes every row of those frames with Sub,
while real Sintel and KITTI files come from other writers.  8 and 16 bits;
grey, grey + alpha, RGB and RGBA; read as ``IMREAD_COLOR`` (8 bits, grey
replicated, alpha dropped) and as ``IMREAD_ANYDEPTH | IMREAD_COLOR``.
Also files that cv2 and PIL write, the binary PPM both ways, and the
files the decoder refuses."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from opticalflowdiffusion_tpu_torch.data import host, png
from opticalflowdiffusion_tpu_torch.data.kitti_single import inpaint_ns_plain

DEPTHS = (8, 16)
CHANNELS = (1, 2, 3, 4)            # grey, grey + alpha, RGB, RGBA
ROW_FILTERS = (0, 1, 2, 3, 4, "mixed")


def _pixels(rng, depth, C, H=9, W=13):
    hi = 256 if depth == 8 else 65536
    return rng.integers(0, hi, (H, W, C)).astype(np.uint8 if depth == 8 else np.uint16)


@pytest.mark.parametrize("filt", ROW_FILTERS)
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_decoder_equals_cv2_imread(tmp_path, depth, C, filt):
    rng = np.random.default_rng(depth * 100 + C * 10 + (5 if filt == "mixed" else filt))
    px = _pixels(rng, depth, C)
    kinds = [i % 5 for i in range(px.shape[0])] if filt == "mixed" else filt
    path = tmp_path / "f.png"
    png.write_png(path, px, kinds)
    for flags, anydepth in ((cv2.IMREAD_COLOR, False),
                            (cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR, True)):
        want = cv2.imread(str(path), flags)[..., ::-1]
        got = png.imread(path, anydepth=anydepth)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # the samples as stored
    np.testing.assert_array_equal(png.decode_png(path.read_bytes()), px)


@pytest.mark.parametrize("depth", DEPTHS)
def test_files_written_by_cv2_and_pil(tmp_path, depth):
    """cv2's writer (Sub rows) and PIL's (its own filter choice), RGB."""
    rng = np.random.default_rng(depth)
    img = _pixels(rng, depth, 3, 37, 53)
    cv2.imwrite(str(tmp_path / "cv.png"), img[..., ::-1])
    np.testing.assert_array_equal(png.imread(tmp_path / "cv.png", anydepth=True), img)
    np.testing.assert_array_equal(png.imread(tmp_path / "cv.png"),
                                  cv2.imread(str(tmp_path / "cv.png"))[..., ::-1])
    if depth == 8:
        smooth = np.cumsum(rng.integers(0, 3, (37, 53, 3)), axis=1).astype(np.uint8)
        Image.fromarray(smooth).save(tmp_path / "pil.png", optimize=True)
        np.testing.assert_array_equal(png.imread(tmp_path / "pil.png"), smooth)


def test_ppm_both_ways(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (11, 17, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "cv.ppm"), img[..., ::-1])
    np.testing.assert_array_equal(png.imread(tmp_path / "cv.ppm"), img)
    png.write_ppm(tmp_path / "port.ppm", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.ppm"))[..., ::-1], img)
    (tmp_path / "c.ppm").write_bytes(b"P6\n# a comment\n17 11\n255\n" + img.tobytes())
    np.testing.assert_array_equal(png.imread(tmp_path / "c.ppm"), img)


def _png_bytes(width, height, depth, color, interlace=0, body=b"\x00"):
    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(body)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("data, match", [
    (_png_bytes(1, 1, 8, 3), "colour type 3"),          # palette
    (_png_bytes(1, 1, 4, 0), "bit depth 4"),
    (_png_bytes(1, 1, 8, 2, interlace=1), "interlaced"),
    (_png_bytes(1, 1, 8, 0, body=b"\x07\x00"), "unknown filter"),
    (_png_bytes(2, 2, 8, 0, body=b"\x00\x00"), "too short"),
    (b"GIF89a", "neither PNG nor binary PPM"),
    (b"P3\n1 1\n255\n0 0 0\n", "binary P6 only"),
    (b"P6\n1 1\n65535\n\x00" * 2, "255 only"),
])
def test_unsupported_files_raise(tmp_path, data, match):
    (tmp_path / "bad").write_bytes(data)
    with pytest.raises(ValueError, match=match):
        png.imread(tmp_path / "bad")


def test_bad_crc_raises(tmp_path):
    data = bytearray(png.encode_png(np.zeros((2, 2, 3), np.uint8)))
    data[-20] ^= 0xFF                          # inside the IDAT chunk
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC|truncated"):
        png.imread(tmp_path / "bad.png")


@pytest.mark.parametrize("bpp", (1, 2, 3, 4, 6, 8))
def test_unfilter_helper_equals_numpy(bpp):
    """The C++ unfilter against ``unfilter_plain`` and the unfiltered rows,
    on rows of every filter (first row included: no prior row)."""
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, (12, 7 * bpp)).astype(np.uint8)
    kinds = [4, 3, 0, 1, 2, 3, 4, 4, 3, 1, 0, 2]
    raw = png.filter_rows(rows, bpp, kinds).tobytes()
    got = host.png_unfilter(raw, 12, 7 * bpp, bpp)
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(png.unfilter_plain(raw, 12, 7 * bpp, bpp), rows)


@pytest.mark.parametrize("shape, frac, radius", [((13, 17), 0.5, 3), ((24, 31), 0.7, 20),
                                                 ((19, 9), 0.3, 5), ((6, 40), 0.9, 20)])
def test_inpaint_helper_equals_numpy_and_cv2(shape, frac, radius):
    """The C++ inpaint, its numpy version and ``cv2.inpaint(INPAINT_NS)`` on
    one float32 channel: bit for bit (masked pixels in the first row and
    column included); two channels in one pass equal each alone."""
    rng = np.random.default_rng(shape[0] + shape[1])
    img = (rng.standard_normal(shape) * 10).astype(np.float32)
    mask = (rng.random(shape) < frac).astype(np.uint8)
    mask[0, 0] = mask[0, -1] = mask[-1, 0] = 1
    want = cv2.inpaint(img, mask, radius, cv2.INPAINT_NS)
    got = host.inpaint_ns(img, mask, radius)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(inpaint_ns_plain(img, mask, radius), want)
    two = host.inpaint_ns(np.stack([img, -2 * img[::-1]], -1), mask, radius)
    np.testing.assert_array_equal(two[..., 0], want)
    np.testing.assert_array_equal(
        two[..., 1], cv2.inpaint(np.ascontiguousarray(-2 * img[::-1]), mask, radius,
                                 cv2.INPAINT_NS))
