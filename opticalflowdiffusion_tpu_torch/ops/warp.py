"""NaN-aware forward warp, the bilinear backward warp, losses and
``jax.image.resize``'s bilinear and nearest resizes (JAX ``ops/warp.py``),
NCHW.

NaN input pixels carry zero weight; output pixels that receive no weight
become NaN holes, and the ``nan_*`` losses reduce over the finite pairs only.
FlowLearner's photometric terms (``charbonnier``, ``nan_charbonnier``,
``fill_holes_nan``, ``edgeaware_smoothness1``) reduce in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .splat import _softsplat


def bilinear_gather(img: torch.Tensor, coords_x: torch.Tensor,
                    coords_y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (B, C, H, W) at float coordinates (B, H', W') in
    pixels (align-corners: 0 is the first pixel's centre), bilinearly; each
    tap outside the frame reads the nearest border pixel (the caller masks
    such samples)."""
    B, C, H, W = img.shape
    x0 = torch.floor(coords_x)
    y0 = torch.floor(coords_y)
    wx = (coords_x - x0)[:, None]
    wy = (coords_y - y0)[:, None]
    flat = img.reshape(B, C, H * W)

    def take(yy, xx):
        idx = yy.long().clamp(0, H - 1) * W + xx.long().clamp(0, W - 1)
        return flat.gather(2, idx.reshape(B, 1, -1).expand(B, C, -1)).reshape(
            (B, C) + tuple(coords_x.shape[1:]))

    v00, v01 = take(y0, x0), take(y0, x0 + 1)
    v10, v11 = take(y0 + 1, x0), take(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def warp_backward_flow(second: torch.Tensor, flow: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward warp of ``second`` (B, C, H, W) by ``flow`` (B, 2, H, W;
    channel 0 is x): (warped, mask), the mask 1 where the whole bilinear
    footprint lies inside the frame (the reference's grid_sample with a
    thresholded ones mask) and the warped frame 0 elsewhere."""
    B, C, H, W = second.shape
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device).view(1, 1, W)
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device).view(1, H, 1)
    cx = xs + flow[:, 0]
    cy = ys + flow[:, 1]
    out = bilinear_gather(second, cx, cy)
    inside = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
    mask = inside[:, None].to(second.dtype) * torch.ones_like(out)
    return out * mask, mask


def warp_forward_flow(first: torch.Tensor, flow: torch.Tensor, scale: int = 1,
                      set_nans: bool = True, get_variance: bool = False,
                      offset: Sequence[int] = (0, 0), warp_style: str = "sum") -> torch.Tensor:
    """Splat ``first`` (B, C, H, W) forward by ``flow`` (B, 2, H, W) in
    pixels into (B, C, H // scale, W // scale).  ``warp_style='sum'`` keeps
    the weighted sum, otherwise the weighted mean; ``get_variance`` returns
    the splatted second moment minus the square; ``set_nans`` turns pixels
    that received no weight into NaN holes."""
    nan = torch.isnan(first)
    weights = (~nan.any(dim=1, keepdim=True)).to(first.dtype)
    clean = torch.where(nan, torch.zeros_like(first), first)
    offset = [int(o) % int(scale) for o in offset]
    mode = "linear_unn" if warp_style == "sum" else "linear"
    ret, mask = _softsplat(clean, flow, weights, mode, scale, offset)
    img = ret[:, :-1]
    if get_variance:
        var, _ = _softsplat(clean.square(), flow, weights, "linear_unn", scale, offset)
        img = var[:, :-1] - img.square()
    if set_nans:
        img = torch.where(mask, img, torch.full_like(img, float("nan")))
    return img


def permute_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """One-to-one (permutation) warp of ``img`` (B, C, H, W) by ``flow``
    (B, 2, H, W; channel 0 is x) in normalised units (1.0 = the full
    extent), as JAX's ``permute_warp``: each source pixel's destination is
    its pixel centre plus the flow, wrapped torus-style; the sources, sorted
    (stably) by the row-major key ``floor(ty * H) * 2 + tx``, fill the
    output in raster order.  Zero flow is the identity exactly.  The values
    have a gradient (the permuted cotangents), the flow has none.

    The key is JAX's term for term as XLA compiles it: the grid term
    ``(x + 0.5) / W`` is (x + 0.5) times the float32 reciprocal of W (XLA's
    rewrite of a division by a constant), and its sum with the flow is one
    fused multiply-add, rounded to float32 once.  The product is exact in
    float64, so the port takes the sum there and rounds it to float32 (a
    second rounding, off only where the float64 sum lands on a float32 tie:
    about 2^-29 of the keys).  A different rounding or order of operations
    moves keys across rank boundaries."""
    B, C, H, W = img.shape
    dev = img.device

    def grid(n):
        x = np.arange(n, dtype=np.float32) + np.float32(0.5)
        return torch.from_numpy(x.astype(np.float64) * np.float64(np.float32(1) / np.float32(n)))

    flow = flow.detach().double()
    tx = (grid(W).to(dev).view(1, 1, W) + flow[:, 0]).float()
    ty = (grid(H).to(dev).view(1, H, 1) + flow[:, 1]).float()
    tx = tx - torch.floor(tx)
    ty = ty - torch.floor(ty)
    key = torch.floor(ty * H) * 2.0 + tx
    order = torch.argsort(key.reshape(B, H * W), dim=-1, stable=True)
    flat = img.reshape(B, C, H * W)
    return torch.gather(flat, 2, order[:, None, :].expand(B, C, H * W)).reshape(B, C, H, W)


def resize(img: torch.Tensor, size: Sequence[int], method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize`` of ``img`` (B, C, H, W) to ``size`` (H', W'):
    ``bilinear`` is the triangle kernel, widened on an axis that shrinks
    (JAX's antialias, torch's ``antialias=True``; on an axis that grows the
    two agree with the plain bilinear), ``nearest`` is torch's
    ``nearest-exact``.  Computed in float32, returned in ``img``'s dtype."""
    size = (int(size[0]), int(size[1]))
    if tuple(img.shape[-2:]) == size:
        return img
    x = img.float()
    if method == "bilinear":
        out = F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)
    elif method == "nearest":
        out = F.interpolate(x, size=size, mode="nearest-exact")
    else:
        raise ValueError(f"unknown resize method {method!r}")
    return out.to(img.dtype)


def upsample_bilinear(img: torch.Tensor, factor: float) -> torch.Tensor:
    """JAX's ``upsample_bilinear``: the bilinear :func:`resize` to
    (int(H * factor), int(W * factor))."""
    H, W = img.shape[-2:]
    return resize(img, (int(H * factor), int(W * factor)))


def _finite_pair_mask(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ~(torch.isnan(pred) | torch.isnan(target))


def nan_mse_stats(pred: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squared differences over the finite pairs, in float32; their
    count)."""
    mask = _finite_pair_mask(pred, target)
    diff = torch.where(mask, pred - target, torch.zeros((), dtype=pred.dtype,
                                                        device=pred.device)).float()
    return diff.square().sum(), mask.sum()


def nan_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    s, n = nan_mse_stats(pred, target)
    return s / torch.clamp(n, min=1)


def charbonnier(x: torch.Tensor, alpha: float = 0.5, eps: float = 1e-3) -> torch.Tensor:
    return torch.pow(x.square() + eps ** 2, alpha)


def nan_charbonnier(pred: torch.Tensor, target: torch.Tensor, dim=None) -> torch.Tensor:
    """The Charbonnier mean over the finite pairs, in float32; ``dim`` keeps
    the other axes (per-offset means over a leading axis: JAX's
    ``jax.vmap(nan_charbonnier)``)."""
    mask = _finite_pair_mask(pred, target)
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    diff = torch.where(mask, pred - target, zero).float()
    val = torch.where(mask, charbonnier(diff), torch.zeros_like(diff))
    if dim is None:
        return val.sum() / torch.clamp(mask.sum(), min=1)
    return val.sum(dim=dim) / torch.clamp(mask.sum(dim=dim), min=1)


def fill_holes_nan(img: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """NaN where the splat weight is not positive."""
    return torch.where(weights > 0, img, torch.full_like(img, float("nan")))


def edgeaware_smoothness1(image: torch.Tensor, flow: torch.Tensor,
                          edge_weight: float = 30.0) -> torch.Tensor:
    """Edge-aware first-order smoothness of ``flow`` (B, 2, H, W), its
    differences weighed by exp(-edge_weight * the image's mean squared
    difference over channels), in float32."""
    image, flow = image.float(), flow.float()
    img_gy = image[:, :, 1:] - image[:, :, :-1]
    img_gx = image[:, :, :, 1:] - image[:, :, :, :-1]
    flo_gy = flow[:, :, 1:] - flow[:, :, :-1]
    flo_gx = flow[:, :, :, 1:] - flow[:, :, :, :-1]
    wy = torch.exp(-edge_weight * img_gy.square().mean(dim=1, keepdim=True))
    wx = torch.exp(-edge_weight * img_gx.square().mean(dim=1, keepdim=True))
    loss = (wx * charbonnier(flo_gx)).mean() + (wy * charbonnier(flo_gy)).mean()
    return loss / 2


__all__ = ["bilinear_gather", "charbonnier", "edgeaware_smoothness1", "fill_holes_nan", "nan_charbonnier",
           "nan_mse", "nan_mse_stats", "permute_warp", "resize", "upsample_bilinear",
           "warp_backward_flow", "warp_forward_flow"]
