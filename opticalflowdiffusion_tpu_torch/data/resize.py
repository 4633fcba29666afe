"""``cv2.resize`` without cv2: the interpolations the data readers use.

``resize(img, (W, H))`` is ``cv2.resize(img, (W, H))`` (``INTER_LINEAR``)
and ``resize(img, (W, H), nearest=True)`` is ``INTER_NEAREST``, on (H, W)
or (H, W, C) arrays:

- uint8 bilinear: OpenCV's fixed point.  Each destination column and row
  takes the source position ``(d + 0.5) * scale - 0.5`` (float32), its
  floor and fraction ``f``; the two weights are ``rint((1 - f) * 2048)``
  and ``rint(f * 2048)`` (11 bits).  A row pass sums the two columns'
  products into int32 (columns past an edge clamp, with the weight on the
  edge column), and the column pass gives
  ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2``,
  rows past an edge clamped.  Equal to cv2 bit for bit.
- float32 bilinear: the same positions with float weights ``1 - f`` and
  ``f``, each pass's two products rounded and added in float32.
- nearest: source index ``floor(d * src / dst)`` (double), clamped; not the
  half-pixel ``INTER_NEAREST_EXACT``.

A destination of the source's size is a copy, as in cv2.  cv2's
downscale by exactly 2 in both directions (its area path) is not ported
and raises.  The bilinear passes run in the host helper
(``data/host.py``), which releases the GIL while the numpy version's
gathers hold it against the training loop's thread; ``resize_plain`` is
the numpy version.

``resize_pil(img, (W, H))`` is PIL's ``Image.resize`` with its default
filter (BICUBIC, a = -0.5) on an (H, W, 3) uint8 image, bit for bit:
Pillow's ``Resample.c``.  Each axis takes, for output pixel ``d``, the
centre ``(d + 0.5) * scale`` and the support ``2 * max(scale, 1)`` (so a
downscale is antialiased), the taps ``int(centre -/+ support + 0.5)``
clamped to the frame, the filter at ``(x - centre + 0.5) / max(scale, 1)``
normalised to sum 1 in double, then rounded to 22-bit fixed point (half
away from zero).  A horizontal pass, then a vertical one over the rows it
made, each summing uint8 times coefficient into an integer that starts at
2^21, and clipping ``sum >> 22`` to [0, 255].  An axis that keeps its size
is not resampled, and a resize to the same size is a copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import host

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _positions(dst: int, src: int, clamp: bool):
    """(index, fraction) of each destination pixel along one axis, as
    OpenCV's resize computes them (float32 fraction); ``clamp`` folds
    positions past either edge onto the edge with fraction 0 (columns)."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    if clamp:
        low = sx < 0
        fx[low], sx[low] = 0, 0
        high = sx >= src - 1
        fx[high], sx[high] = 0, src - 1
    return sx, fx


def _weights_fixed(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    one = np.float32(1.0)
    w0 = np.rint((one - f) * np.float32(COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int32)
    return w0, w1


def _linear_u8(img: np.ndarray, W: int, H: int) -> np.ndarray:
    h, w = img.shape[:2]
    sx, fx = _positions(W, w, clamp=True)
    sy, fy = _positions(H, h, clamp=False)
    a0, a1 = _weights_fixed(fx)
    b0, b1 = _weights_fixed(fy)
    sx1 = np.minimum(sx + 1, w - 1)
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    ext = (slice(None),) + (None,) * (img.ndim - 2)
    # the row pass once for every source row that an output row reads
    used = np.unique(np.concatenate([r0, r1]))
    src = img[used].astype(np.int32)
    rows = (src[:, sx] * a0[ext] + src[:, sx1] * a1[ext]) >> 4
    p0, p1 = np.searchsorted(used, r0), np.searchsorted(used, r1)
    col = (slice(None), None) + (None,) * (img.ndim - 2)
    top = (b0[col] * rows[p0]) >> 16
    top += (b1[col] * rows[p1]) >> 16
    top += 2
    top >>= 2
    return top.astype(np.uint8)


def _linear_f32(img: np.ndarray, W: int, H: int) -> np.ndarray:
    h, w = img.shape[:2]
    sx, fx = _positions(W, w, clamp=True)
    sy, fy = _positions(H, h, clamp=False)
    one = np.float32(1.0)
    sx1 = np.minimum(sx + 1, w - 1)
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    ext = (slice(None),) + (None,) * (img.ndim - 2)
    used = np.unique(np.concatenate([r0, r1]))
    src = img[used].astype(np.float32)
    rows = src[:, sx] * (one - fx)[ext] + src[:, sx1] * fx[ext]
    p0, p1 = np.searchsorted(used, r0), np.searchsorted(used, r1)
    col = (slice(None), None) + (None,) * (img.ndim - 2)
    out = rows[p0] * (one - fy)[col]
    out += rows[p1] * fy[col]
    return out


def _nearest(img: np.ndarray, W: int, H: int) -> np.ndarray:
    h, w = img.shape[:2]
    fx, fy = 1.0 / (W / w), 1.0 / (H / h)
    xs = np.minimum(np.floor(np.arange(W) * fx).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(H) * fy).astype(np.int64), h - 1)
    return img[ys][:, xs]


def _resize(img, size, nearest: bool, linear) -> np.ndarray:
    img = np.asarray(img)
    W, H = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (W, H) == (w, h):
        return img.copy()
    if nearest:
        return np.ascontiguousarray(_nearest(img, W, H))
    if w == 2 * W and h == 2 * H:
        raise NotImplementedError("cv2 resizes by exactly 1/2 with its area path, which is "
                                  "not ported")
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"bilinear resize takes uint8 or float32, got {img.dtype}")
    return linear(img, W, H)


def resize(img: np.ndarray, size: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, size)`` (``size`` = (W, H)) with ``INTER_LINEAR``
    (the host helper, ``host.resize_linear``), or ``INTER_NEAREST`` when
    ``nearest``; uint8 or float32 for bilinear."""
    return _resize(img, size, nearest, host.resize_linear)


def resize_plain(img: np.ndarray, size: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """numpy version of :func:`resize`."""
    return _resize(img, size, nearest, lambda a, W, H: (
        _linear_u8 if a.dtype == np.uint8 else _linear_f32)(a, W, H))


PIL_BITS = 22          # Pillow's PRECISION_BITS for 8-bit samples


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first tap, fixed-point coefficients (out, taps)) of one axis, as
    Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``; the
    coefficients past a pixel's last tap are 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax, dtype=np.float64) + xmin - center + 0.5) * (1.0 / filterscale))
        ww = w.sum()
        kk[xx, :xmax] = w / ww if ww != 0.0 else w
        first[xx] = xmin
    scaled = kk * float(1 << PIL_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return first, fixed


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's 8-bit passes along ``axis`` (0 rows, 1 columns)."""
    first, k = _pil_coeffs(img.shape[axis], out_size)
    idx = np.minimum(first[:, None] + np.arange(k.shape[1]), img.shape[axis] - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)     # (out, taps) on that axis
    kshape = [1] * src.ndim
    kshape[axis], kshape[axis + 1] = k.shape
    acc = (src * k.reshape(kshape)).sum(axis=axis + 1) + (1 << (PIL_BITS - 1))
    return np.clip(acc >> PIL_BITS, 0, 255).astype(np.uint8)


def resize_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.fromarray(img).resize(size)`` (``size`` = (W, H);
    BICUBIC, no ``reducing_gap``) of an (H, W, C) uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise TypeError(f"resize_pil takes an (H, W, C) uint8 image, got {img.dtype} "
                        f"{img.shape}")
    W, H = int(size[0]), int(size[1])
    out = img
    if W != img.shape[1]:
        out = _pil_pass(out, W, 1)
    if H != img.shape[0]:
        out = _pil_pass(out, H, 0)
    return np.ascontiguousarray(out) if out is not img else img.copy()


__all__ = ["resize", "resize_pil", "resize_plain"]
