"""Forward splat (JAX ``ops/splat.py::softsplat``), plain PyTorch.

Only what ``warp_forward_flow`` uses on the sampling path is ported: mode
``linear_unn`` at scale 1 and offset 0, forward only.  Each source pixel
adds its value, times the bilinear weight, to the four integer corners
around its target ``(x + dx, y + dy)``; corners outside the image and
non-finite targets are dropped.  Sums are taken in float32 and cast back to
the input dtype, as in JAX.

On the GPU ``index_add_`` accumulates with atomics, so the order of the
sums (and the last bits) can change from run to run; the JAX version is
deterministic.  A hand-written splat kernel is queued for a later slice.
"""

from __future__ import annotations

import torch


def splat_raw(inp: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear scatter-add of ``inp`` (B, C, H, W) by ``flow`` (B, 2, H, W)."""
    B, C, H, W = inp.shape
    dev = inp.device
    vals = inp.float().permute(0, 2, 3, 1).reshape(B * H * W, C)
    flow = flow.float()
    xs = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W)
    ys = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1)
    fx = (xs + flow[:, 0]).reshape(-1)
    fy = (ys + flow[:, 1]).reshape(-1)
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    fx = torch.where(finite, fx, torch.zeros_like(fx))
    fy = torch.where(finite, fy, torch.zeros_like(fy))
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1 = fx - x0
    wy1 = fy - y0
    base = torch.arange(B, device=dev).repeat_interleave(H * W) * (H * W)
    dump = B * H * W
    out = torch.zeros(dump + 1, C, device=dev, dtype=torch.float32)
    for cx, cy, w in (
        (x0, y0, (1.0 - wx1) * (1.0 - wy1)),
        (x0 + 1.0, y0, wx1 * (1.0 - wy1)),
        (x0, y0 + 1.0, (1.0 - wx1) * wy1),
        (x0 + 1.0, y0 + 1.0, wx1 * wy1),
    ):
        inb = finite & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
        idx = base + cy.long().clamp(0, H - 1) * W + cx.long().clamp(0, W - 1)
        idx = torch.where(inb, idx, torch.full_like(idx, dump))
        out.index_add_(0, idx, vals * w[:, None])
    out = out[:dump].view(B, H, W, C).permute(0, 3, 1, 2)
    return out.to(inp.dtype)


def softsplat(inp: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor) -> torch.Tensor:
    """Mode ``linear_unn``: ``[inp * metric, metric]`` splatted; returns
    (B, C + 1, H, W) with the raw accumulated weight as the last channel."""
    return splat_raw(torch.cat([inp * metric, metric], dim=1), flow)


__all__ = ["softsplat", "splat_raw"]
