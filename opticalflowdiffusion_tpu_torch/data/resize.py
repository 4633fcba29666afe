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


__all__ = ["resize", "resize_plain"]
