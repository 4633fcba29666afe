"""FlowLearner's photometric pyramid (JAX ``ops/pyramid.py``), NCHW.

At each level L of the pyramid the input is splatted at all L^2 phase
offsets of the scale-L downsample: offset n is (ox, oy) = (n % L, n // L),
each one splat of ``ops/splat.py`` (the CUDA kernels on the card, their
plain versions on the CPU).  This is JAX's per-offset path
(``OFD_PYRAMID=map``); JAX's default path computes the same sums as one
phase-interleaved contraction, and its VJP is the sum over offsets of the
per-offset reference backward, which is what autograd sums here from the
splat backward of every offset.  The 'soft' packing of ``softsplat``
([x exp(m), exp(m)]) is made once per call, not once per offset.

The loss splats the image by the predicted flow and the target by a zero
flow with unit weights (no gradient: those splats launch no backward), and
averages the per-offset masked Charbonnier means over offsets, then over
levels.  A level that does not divide the frame takes the splat's
edge-stretch branch, as in JAX.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import splat as sp
from .warp import nan_charbonnier

# the reference FlowLearner's levels: 832 (level, offset) splats a call
DEFAULT_LEVELS: Tuple[int, ...] = (1, 2, 4, 5, 7, 8, 10, 11, 14, 16)


def offsets(level: int):
    """The level's (ox, oy) phase offsets in JAX's order."""
    return [(n % level, n // level) for n in range(level * level)]


def _soft_pack(inp: torch.Tensor, metric: torch.Tensor) -> torch.Tensor:
    m = torch.exp(metric)
    return torch.cat([inp * m, m], dim=1)


def _normalise(raw: torch.Tensor) -> torch.Tensor:
    """softsplat's 'soft' normalisation (``addeps``) of (L^2, B, C+1, h, w)
    raw sums, the weight channel kept."""
    return torch.cat([raw[:, :, :-1] / (raw[:, :, -1:] + 1e-7), raw[:, :, -1:]], dim=2)


def _offset_splats(packed: torch.Tensor, flow: torch.Tensor, level: int):
    """(L^2, B, C, H // L, W // L): the splat at every offset of ``level``,
    and (L^2, B, 1, H // L, W // L) its hole mask (the weight's sum > 0)."""
    outs, masks = zip(*(sp.splat(packed, flow, level, off) for off in offsets(level)))
    return torch.stack(outs), torch.stack(masks)


def multi_offset_soft_splat(inp: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor,
                            level: int) -> torch.Tensor:
    """All level^2 offset phases of the 'soft' splat of ``inp`` (B, C, H, W)
    by ``flow`` (B, 2, H, W) with ``metric`` (B, 1, H, W): (L^2, B, C + 1,
    H // L, W // L), the values normalised by the accumulated weight plus
    1e-7 and the raw weight as the last channel."""
    return _normalise(_offset_splats(_soft_pack(inp, metric), flow, level)[0])


def photometric_pyramid_loss(img: torch.Tensor, tgt: torch.Tensor, flow_pred: torch.Tensor,
                             warp_weights: torch.Tensor,
                             levels: Sequence[int] = DEFAULT_LEVELS) -> torch.Tensor:
    """Mean over ``levels`` of the mean over offsets of the NaN-Charbonnier
    between the target box-splatted at that offset (zero flow, unit weight)
    and ``img`` soft-splatted by ``flow_pred`` with ``warp_weights`` (NaN
    where no weight landed: JAX's ``weights > 0`` on its float sums, which
    the splat's hole mask gives exactly where the kernel's fixed-point sum
    rounds a few tiny terms to 0)."""
    packed = _soft_pack(img, warp_weights)
    zeros = torch.zeros_like(flow_pred, dtype=torch.float32)
    with torch.no_grad():
        tgt_packed = _soft_pack(tgt, torch.ones_like(warp_weights))
    per_level = []
    for level in levels:
        raw, mask = _offset_splats(packed, flow_pred, level)
        warped = _normalise(raw)[:, :, :-1]
        filled = torch.where(mask, warped, torch.full_like(warped, float("nan")))
        with torch.no_grad():
            tgt_all = _normalise(_offset_splats(tgt_packed, zeros, level)[0])[:, :, :-1]
        per_level.append(nan_charbonnier(tgt_all, filled, dim=(1, 2, 3, 4)).mean())
    return torch.stack(per_level).mean()


__all__ = ["DEFAULT_LEVELS", "multi_offset_soft_splat", "offsets", "photometric_pyramid_loss"]
