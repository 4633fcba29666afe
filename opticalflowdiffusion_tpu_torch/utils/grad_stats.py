"""Gradient and tensor diagnostics (JAX ``utils/grad_stats.py``), with the
reference's metric keys."""

from __future__ import annotations

from typing import Dict, Iterable

import torch


def grad_norm_stats(grads: Iterable[torch.Tensor], params: Iterable[torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Min/max/std/mean/median of the per-leaf gradient norms and of the
    gradient-to-parameter norm ratios."""
    norms = torch.stack([g.detach().float().norm() for g in grads])
    pnorms = torch.stack([p.detach().float().norm() for p in params])
    gpr = norms / torch.clamp(pnorms, min=1e-12)
    out = {}
    for key, v in (("grad_norm", norms), ("gpr", gpr)):
        out.update({
            f"train/{key}/min": v.min(),
            f"train/{key}/max": v.max(),
            f"train/{key}/std": v.std(unbiased=False),
            f"train/{key}/mean": v.mean(),
            # jnp.median: the mean of the two middle values for an even count
            f"train/{key}/median": v.quantile(0.5),
        })
    return out


def tensor_stats(prefix: str, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's per-tensor min/max/mean/std block; std is the mean
    over positions of the standard deviation across the batch."""
    x = x.detach().float()
    return {
        f"{prefix}_min": x.min(),
        f"{prefix}_max": x.max(),
        f"{prefix}_mean": x.mean(),
        f"{prefix}_std": x.std(dim=0, unbiased=False).mean(),
    }


__all__ = ["grad_norm_stats", "tensor_stats"]
