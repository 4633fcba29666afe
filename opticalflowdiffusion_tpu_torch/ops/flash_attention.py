"""Bottleneck attention middle (JAX ``ops/flash_attention.py``).

Only the composition ``_attention_middle_xla`` is ported: the JAX package
runs it below ``_FLASH_MIN_N = 2048`` tokens on every platform, which covers
the 128x128 model (its bottleneck has N = 256).  The flash kernel, used at
native resolution, comes with that slice.
"""

from __future__ import annotations

import torch

FLASH_MIN_N = 2048


def attention_middle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over (B, N, heads, d), q pre-scaled by d^-0.5.

    Scores and softmax in float32; the probabilities are cast to ``v``'s
    dtype before ``p @ v``, as in JAX.
    """
    if q.is_cuda and q.shape[1] >= FLASH_MIN_N:
        raise NotImplementedError(
            f"N={q.shape[1]} takes the flash kernel, which is not ported yet"
        )
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 3, 1).float()
    p = torch.softmax(qh @ kh, dim=-1).to(v.dtype)
    out = p @ v.permute(0, 2, 1, 3)
    return out.permute(0, 2, 1, 3)


__all__ = ["attention_middle", "FLASH_MIN_N"]
