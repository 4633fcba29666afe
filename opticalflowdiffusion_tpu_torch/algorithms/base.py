"""Batch adapter and compute-dtype choice (JAX ``algorithms/base.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def compute_dtype(precision: str) -> torch.dtype:
    """``runtime.precision``: 'bf16' computes in bfloat16 (params stay f32)."""
    return torch.bfloat16 if precision == "bf16" else torch.float32


def pair_batch(batch):
    """(img, tgt, flow) from a pair dataset or a 3-frame (Sintel) one.

    A 4-tuple (frame1, frame2, frame3, flow) pairs frame2 with frame3, whose
    motion the ground-truth flow describes (JAX ``pair_batch``)."""
    if len(batch) == 4:
        return batch[1], batch[2], batch[3]
    return batch


def to_batch(items: Sequence[tuple], device) -> tuple:
    """Stack dataset items (tuples of HWC numpy arrays) into float32 NCHW
    tensors on ``device``."""
    fields = zip(*items)
    return tuple(
        torch.from_numpy(np.stack(f)).permute(0, 3, 1, 2).contiguous().to(device)
        for f in fields
    )


__all__ = ["compute_dtype", "pair_batch", "to_batch"]
