"""Stride-1 'same' convolution (JAX ``ops/conv_pallas.py::conv2d_same``).

The JAX default path is XLA's convolution (``_conv_xla``); the Pallas convs
there are opt-in and not on this slice's path.  Here it is ``F.conv2d`` with
the kernel cast to the input's dtype, NCHW input and OIHW kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_same(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    kh, kw = weight.shape[-2:]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"'same' conv needs an odd kernel, got {kh}x{kw}")
    return F.conv2d(x, weight.to(x.dtype), padding=(kh // 2, kw // 2))


__all__ = ["conv2d_same"]
