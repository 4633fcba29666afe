"""Flow and image visualization (JAX ``utils/visualization.py``), numpy.

The Baker et al. flow colour wheel (``torchvision.utils.flow_to_image``'s),
image grids, and PNG files through the port's one writer
(``data/png.py``, no PIL).  Images are NHWC numpy arrays, floats in [0, 1].
"""

from __future__ import annotations

import numpy as np

from ..data.png import encode_png


def _make_colorwheel() -> np.ndarray:
    """The 55-entry flow colour wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col: col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col: col + YG, 1] = 255
    col += YG
    wheel[col: col + GC, 1] = 255
    wheel[col: col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col: col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col: col + CB, 2] = 255
    col += CB
    wheel[col: col + BM, 2] = 255
    wheel[col: col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col: col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col: col + MR, 0] = 255
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_image(flow) -> np.ndarray:
    """(B, H, W, 2) flow (dx, dy) -> (B, H, W, 3) float RGB in [0, 1], each
    item normalised by its own largest radius; non-finite flow renders as
    zero."""
    flow = np.nan_to_num(np.asarray(flow, np.float32), nan=0.0, posinf=0.0, neginf=0.0)
    if flow.ndim == 3:
        flow = flow[None]
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    max_rad = np.maximum(rad.reshape(rad.shape[0], -1).max(axis=1), 1e-5)
    u = u / max_rad[:, None, None]
    v = v / max_rad[:, None, None]
    rad = np.sqrt(u ** 2 + v ** 2)
    ncols = _COLORWHEEL.shape[0]
    fk = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.float32)
    for c in range(3):
        col = (1 - f) * (_COLORWHEEL[k0, c] / 255.0) + f * (_COLORWHEEL[k1, c] / 255.0)
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = col
    return np.clip(img, 0.0, 1.0)


def make_grid(images, nrow: int = 8, pad: int = 2, pad_value: float = 1.0) -> np.ndarray:
    """Tile (B, H, W, C) into one image, ``nrow`` images a row."""
    images = np.asarray(images)
    B, H, W, C = images.shape
    ncol = min(nrow, B)
    rows = (B + ncol - 1) // ncol
    grid = np.full((rows * (H + pad) + pad, ncol * (W + pad) + pad, C), pad_value, np.float32)
    for i in range(B):
        r, c = divmod(i, ncol)
        y0, x0 = r * (H + pad) + pad, c * (W + pad) + pad
        grid[y0: y0 + H, x0: x0 + W] = images[i]
    return grid


def to_uint8(img) -> np.ndarray:
    return (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255).astype(np.uint8)


def save_image(img, path) -> None:
    """Save an (H, W, C) or (B, H, W, C) float image (a batch as a grid) to
    PNG; one channel is written as grey RGB."""
    img = np.asarray(img)
    if img.ndim == 4:
        img = make_grid(img)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    with open(path, "wb") as fh:
        fh.write(encode_png(to_uint8(img)))


__all__ = ["flow_to_image", "make_grid", "save_image", "to_uint8"]
