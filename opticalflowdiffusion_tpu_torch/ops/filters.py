"""Per-pixel filter ("matrix flow") ops (JAX ``ops/filters.py``), NCHW.

Packed layout, channels first: ``[fil (R*R), col (C), colweight (1)]``.  A
filter entry ``fil[b, i, j, y, x]`` is the gather weight from source pixel
``(y + i - R//2, x + j - R//2)`` into ``(y, x)``.  ``unfold`` is
``F.unfold`` (its taps channel-major, (C, i, j), as JAX's
``conv_general_dilated_patches``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def get_radius(num_channels: int, C: int = 3) -> int:
    """Filter radius from the packed channel count."""
    R = math.sqrt(num_channels - C - 1)
    assert abs(int(R) - R) < 1e-6 and int(R) % 2 == 1, "bad packed filter size"
    return int(R)


def unpack_flow(flow: torch.Tensor, C: int = 3
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split packed (B, R^2+C+1, H, W) into (fil (B, R, R, H, W), col, colw)."""
    B, K, H, W = flow.shape
    R = get_radius(K, C)
    return flow[:, : R * R].reshape(B, R, R, H, W), flow[:, R * R: R * R + C], flow[:, -1:]


def pack_flow(fil: torch.Tensor, col: torch.Tensor, colw: torch.Tensor) -> torch.Tensor:
    B, R, _, H, W = fil.shape
    return torch.cat([fil.reshape(B, R * R, H, W), col, colw], dim=1)


def unfold(img: torch.Tensor, R: int) -> torch.Tensor:
    """R x R patches, zero-padded SAME: (B, C, H, W) -> (B, C, R, R, H, W),
    patches[b, c, i, j, y, x] = img[b, c, y+i-R//2, x+j-R//2] (0 outside)."""
    B, C, H, W = img.shape
    return F.unfold(img, R, padding=R // 2).reshape(B, C, R, R, H, W)


def bound_mask(R: int, H: int, W: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(R, R, H, W): 1 where tap (y+i-R//2, x+j-R//2) is in bounds."""
    d = torch.arange(R, device=device) - R // 2
    sy = torch.arange(H, device=device).view(1, H, 1) + d.view(R, 1, 1)   # (R, H, 1)
    sx = torch.arange(W, device=device).view(1, 1, W) + d.view(R, 1, 1)   # (R, 1, W)
    oky = (sy >= 0) & (sy < H)
    okx = (sx >= 0) & (sx < W)
    return (oky[:, None, :, :] & okx[None, :, :, :]).to(dtype)


def apply_filter(img: torch.Tensor, fil: torch.Tensor) -> torch.Tensor:
    """out[y, x] = sum_ij fil[i, j, y, x] img[y+di, x+dj]: img (B, C, H, W),
    fil (B, R, R, H, W) -> (B, C, H, W)."""
    return torch.einsum("bcijhw,bijhw->bchw", unfold(img, fil.shape[1]), fil)


def invert_filter(flow: torch.Tensor, C: int = 3, negate_colweight: bool = False) -> torch.Tensor:
    """Invert a packed gather filter: inv[i', j', y, x] = fil[R-1-i', R-1-j',
    y-(R//2-i'), x-(R//2-j')]; where that source is outside the image the
    original entry stays (the reference writes into a clone under a
    validity mask).  ``negate_colweight``: the MatrixFlow variant."""
    fil, col, colw = unpack_flow(flow, C)
    B, R, _, H, W = fil.shape
    dev = flow.device
    ks = torch.arange(R * R, device=dev)
    offy = (R // 2 - ks // R).view(-1, 1, 1)
    offx = (R // 2 - ks % R).view(-1, 1, 1)
    sy = torch.arange(H, device=dev).view(1, H, 1) - offy            # (R^2, H, 1)
    sx = torch.arange(W, device=dev).view(1, 1, W) - offx            # (R^2, 1, W)
    valid = ((sy >= 0) & (sy < H)) & ((sx >= 0) & (sx < W))          # (R^2, H, W)
    src = (((R * R - 1) - ks).view(-1, 1, 1) * (H * W) + sy.clamp(0, H - 1) * W
           + sx.clamp(0, W - 1))
    flat = fil.reshape(B, R * R * H * W)
    gathered = flat.gather(1, src.reshape(1, -1).expand(B, -1)).view(B, R * R, H, W)
    inv = torch.where(valid[None], gathered, fil.reshape(B, R * R, H, W))
    if negate_colweight:
        colw = -colw
    return torch.cat([inv, col, colw], dim=1)


def filter_to_flow(flow: torch.Tensor, C: int = 3) -> torch.Tensor:
    """Mean tap offset of a packed filter -> (B, 2, H, W) as (dx, dy)."""
    fil, _, _ = unpack_flow(flow, C)
    idx = (torch.arange(fil.shape[1], device=flow.device) - fil.shape[1] // 2).to(fil.dtype)
    dy = torch.einsum("bijhw,i->bhw", fil, idx)
    dx = torch.einsum("bijhw,j->bhw", fil, idx)
    return torch.stack([dx, dy], dim=1)


def occlusion_mask(packed: torch.Tensor, threshold: float = 0.25, C: int = 3) -> torch.Tensor:
    """(B, 1, H, W) float mask of the pixels that receive at least
    ``threshold`` of the inverted filter's mass."""
    R = get_radius(packed.shape[1], C)
    mass = invert_filter(packed, C)[:, : R * R].sum(dim=1, keepdim=True)
    return (mass > threshold).float()


def warp_backward_filter(second: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Filter-representation backward warp: the bounded filter applied to
    ``second``, plus col * colweight."""
    B, C, H, W = second.shape
    fil, col, colw = unpack_flow(flow, C)
    fil = fil * bound_mask(fil.shape[1], H, W, fil.dtype, fil.device)[None]
    return apply_filter(second, fil) + col * colw


def warp_forward_filter(first: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Forward filter warp: invert, then the backward warp."""
    return warp_backward_filter(first, invert_filter(flow, first.shape[1]))


__all__ = [
    "apply_filter", "bound_mask", "filter_to_flow", "get_radius", "invert_filter",
    "occlusion_mask", "pack_flow", "unfold", "unpack_flow", "warp_backward_filter",
    "warp_forward_filter",
]
