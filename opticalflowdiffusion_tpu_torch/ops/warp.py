"""NaN-aware forward warp (JAX ``ops/warp.py::warp_forward_flow``).

NaN input pixels carry zero weight; output pixels that receive no weight
become NaN holes.
"""

from __future__ import annotations

import torch

from .splat import softsplat


def warp_forward_flow(first: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Splat ``first`` (B, C, H, W) forward by ``flow`` (B, 2, H, W) in pixels."""
    nan = torch.isnan(first)
    weights = (~nan.any(dim=1, keepdim=True)).to(first.dtype)
    clean = torch.where(nan, torch.zeros_like(first), first)
    ret = softsplat(clean, flow, weights)
    img, wsum = ret[:, :-1], ret[:, -1:]
    return torch.where(wsum > 0, img, torch.full_like(img, float("nan")))


__all__ = ["warp_forward_flow"]
