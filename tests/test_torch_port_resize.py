"""The port's ``cv2.resize`` (``data/resize.py``: the host helper's
bilinear passes, and ``resize_plain``, their numpy version) against cv2
at the configurations' ratios: Sintel's 1024x436 frame to 512x256 (the
yaml) and to 1024x448 (the native recipe), KITTI's 1242x375 to 1248x376,
the FlyingChairs 512x384 frame to 128x128, and a few odd ratios both ways;
and the helper against the numpy version on every channel count.

Pinned tolerances: ``INTER_LINEAR`` on uint8 (the frames) and on float32
with two channels (the flow fields, the only float input of the readers)
and ``INTER_NEAREST`` are equal to cv2 bit for bit (0).  On one or three
float32 channels cv2 takes another vector path, which no reader uses: the
port stays within 1e-4 of the values' scale there."""

import cv2
import numpy as np
import pytest

from opticalflowdiffusion_tpu_torch.data.resize import resize, resize_plain

RATIOS = [((436, 1024), (512, 256)), ((436, 1024), (1024, 448)), ((375, 1242), (1248, 376)),
          ((384, 512), (128, 128)), ((30, 40), (17, 9)), ((20, 30), (71, 53)),
          ((5, 3), (9, 11))]
IMPLS = pytest.mark.parametrize("resize", [resize, resize_plain], ids=["helper", "numpy"])


@IMPLS
@pytest.mark.parametrize("src, dst", RATIOS, ids=lambda v: "x".join(map(str, v)))
def test_bilinear_uint8_frames_bit_for_bit(src, dst, resize):
    rng = np.random.default_rng(src[0] + dst[0])
    for shape in (src + (3,), src):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(resize(img, dst), cv2.resize(img, dst))


@IMPLS
@pytest.mark.parametrize("src, dst", RATIOS, ids=lambda v: "x".join(map(str, v)))
def test_bilinear_float_flow_bit_for_bit(src, dst, resize):
    rng = np.random.default_rng(src[1] + dst[1])
    flow = (rng.standard_normal(src + (2,)) * 20).astype(np.float32)
    np.testing.assert_array_equal(resize(flow, dst), cv2.resize(flow, dst))
    for C in (1, 3):
        img = (rng.standard_normal(src + (C,)) * 20).astype(np.float32)
        want = cv2.resize(img, dst).reshape(dst[1], dst[0], C)
        np.testing.assert_allclose(resize(img, dst), want, rtol=0, atol=1e-4 * 20 * 5)


@pytest.mark.parametrize("src, dst", RATIOS, ids=lambda v: "x".join(map(str, v)))
def test_nearest_bit_for_bit(src, dst):
    rng = np.random.default_rng(src[0] * 3 + dst[1])
    flow = (rng.standard_normal(src + (2,)) * 20).astype(np.float32)
    img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    for a in (flow, img):
        np.testing.assert_array_equal(resize(a, dst, nearest=True),
                                      cv2.resize(a, dst, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("C", [None, 1, 2, 3, 4, 6])
def test_helper_equals_numpy_version(C):
    rng = np.random.default_rng(C or 0)
    for src, dst in RATIOS[2:]:
        shape = src if C is None else src + (C,)
        for a in (rng.integers(0, 256, shape).astype(np.uint8),
                  (rng.standard_normal(shape) * 20).astype(np.float32)):
            np.testing.assert_array_equal(resize(a, dst), resize_plain(a, dst))


def test_same_size_copies_and_half_raises():
    img = np.arange(24, dtype=np.uint8).reshape(4, 6)
    out = resize(img, (6, 4))
    assert out is not img
    np.testing.assert_array_equal(out, cv2.resize(img, (6, 4)))
    with pytest.raises(NotImplementedError):
        resize(img, (3, 2))
    with pytest.raises(TypeError):
        resize(img.astype(np.float64), (5, 3))
