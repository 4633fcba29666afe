"""NaN-aware forward warp and losses (JAX ``ops/warp.py``), NCHW.

NaN input pixels carry zero weight; output pixels that receive no weight
become NaN holes, and the ``nan_*`` losses reduce over the finite pairs only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .splat import _softsplat


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


__all__ = ["nan_mse", "nan_mse_stats", "warp_forward_flow"]
