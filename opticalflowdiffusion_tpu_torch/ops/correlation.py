"""PWC-Net's 9x9 local cost volume (JAX ``ops/correlation.py``), NCHW.

``local_correlation(a, b)`` is the 81-channel displacement cost volume of
two feature maps (B, C, H, W):

    out[b, i * 9 + j, y, x] = sum_c a[b, c, y, x] * b[b, c, y + i - 4, x + j - 4]

with zero outside the frame: the reference's ``spatial_correlation_sampler``
(kernel_size 1, patch_size 9).  ``pwc_index_reorder`` applies PWCNet's
per-direction permutation of the displacement channels.

The plain version (:func:`local_correlation_plain`) is JAX's composition:
the 9x9 patches of ``b`` unfolded (B, C, 81, H, W), then an einsum with
``a``.  It is the CPU path and the reference of the tests.  On the card
:func:`local_correlation` runs the hand-written kernel of
``kernels/correlation.cu`` (forward, and both cotangents as gathers) through
a ``torch.autograd.Function``; given a ``direction`` the kernel writes the
channels already in that direction's order.  The kernel reads each feature
once and writes the 81 products, where the composition materialises the
B * C * 81 * H * W patches.

RAFT's ``allpairs_correlation`` and ``avg_pool2d`` come with RAFT.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import CORR, CORR_BWD

PATCH = 9
DIRECTIONS = (None, "fwd", "bwd")


def local_correlation_plain(feat_a: torch.Tensor, feat_b: torch.Tensor,
                            patch_size: int = PATCH) -> torch.Tensor:
    """The cost volume (B, P * P, H, W) in the inputs' dtype, as JAX
    composes it (the patches unfolded, then an einsum)."""
    B, C, H, W = feat_a.shape
    r = patch_size // 2
    patches = F.unfold(feat_b, patch_size, padding=r).view(B, C, patch_size * patch_size, H, W)
    return torch.einsum("bchw,bcphw->bphw", feat_a, patches)


def _pwc_idx(patch_size: int = PATCH) -> np.ndarray:
    """The reference's idx_fwd (pwc_net.py:38-40)."""
    n2 = patch_size * patch_size
    idx = [list(range(n, -1, -patch_size)) for n in range(n2 - 1, n2 - 1 - patch_size, -1)]
    return np.array(idx).flatten()


def reorder_index(direction: Optional[str], patch_size: int = PATCH) -> np.ndarray:
    """The source channel of each output channel: the identity for None,
    ``_pwc_idx`` for ``fwd`` (a transpose and flip of the (dy, dx) grid),
    reversed for ``bwd`` (a transpose)."""
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
    if direction is None:
        return np.arange(patch_size * patch_size)
    idx = _pwc_idx(patch_size)
    return idx[::-1].copy() if direction == "bwd" else idx


def pwc_index_reorder(corr: torch.Tensor, direction: str, patch_size: int = PATCH
                      ) -> torch.Tensor:
    """PWCNet's fwd/bwd displacement-channel reorder of ``corr`` (B, P * P,
    H, W) (pwc_net.py:143-145)."""
    idx = torch.from_numpy(reorder_index(direction, patch_size)).to(corr.device)
    return corr.index_select(1, idx)


# ------------------------------------------------------------- CUDA kernels
_DIR_CODE = {None: 0, "fwd": 1, "bwd": 2}


def _lib():
    from ..kernels import build

    lib = build.load("correlation")
    if not getattr(lib, "_ofd_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ofd_corr_fwd.argtypes = [vp, vp, vp, i] + [i] * 5 + [i, vp]
        lib.ofd_corr_fwd.restype = i
        lib.ofd_corr_bwd.argtypes = [vp, vp, vp, vp, vp, i] + [i] * 5 + [i, vp]
        lib.ofd_corr_bwd.restype = i
        lib.ofd_cuda_error_string.argtypes = [i]
        lib.ofd_cuda_error_string.restype = ctypes.c_char_p
        lib._ofd_typed = True
    return lib


def _check(a: torch.Tensor, b: torch.Tensor):
    if not a.is_cuda:
        raise ValueError(f"the correlation kernels take CUDA tensors, got {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got {a.dtype}")
    if a.dim() != 4:
        raise ValueError(f"features must be (B, C, H, W), got {tuple(a.shape)}")
    if b.device != a.device or b.dtype != a.dtype or b.shape != a.shape:
        raise ValueError(f"feat_b {tuple(b.shape)} {b.dtype} on {b.device} does not match "
                         f"feat_a {tuple(a.shape)} {a.dtype} on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the features must be contiguous")
    B, C, H, W = a.shape
    if B > 65535 or H > 65535:
        raise ValueError(f"the correlation kernels take B, H <= 65535, got {(B, H)}")
    return B, C, H, W


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.ofd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def corr_fwd(feat_a: torch.Tensor, feat_b: torch.Tensor,
             direction: Optional[str] = None) -> torch.Tensor:
    """The forward kernel on contiguous CUDA features (B, C, H, W), f32 or
    bf16: the cost volume (B, 81, H, W) in their dtype, summed in f32, its
    channels in ``direction``'s order.  One launch."""
    B, C, H, W = _check(feat_a, feat_b)
    dev = feat_a.device
    out = torch.empty(B, PATCH * PATCH, H, W, dtype=feat_a.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.ofd_corr_fwd(feat_a.data_ptr(), feat_b.data_ptr(), out.data_ptr(),
                           int(feat_a.dtype == torch.bfloat16), B, C, H, W,
                           _DIR_CODE[direction], dev.index,
                           torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, CORR.name)
    CORR.launches += 1
    return out


def corr_bwd(feat_a: torch.Tensor, feat_b: torch.Tensor, g: torch.Tensor,
             direction: Optional[str] = None):
    """The backward kernels: (grad_a, grad_b) in the features' dtype for the
    cost volume's cotangent ``g`` (B, 81, H, W), both as gathers (no
    atomics: a repeat gives the same bits), summed in f32.  Two launches."""
    B, C, H, W = _check(feat_a, feat_b)
    dev = feat_a.device
    g = g.to(feat_a.dtype).contiguous()
    if g.device != dev or tuple(g.shape) != (B, PATCH * PATCH, H, W):
        raise ValueError(f"g must be {(B, PATCH * PATCH, H, W)} on {dev}, "
                         f"got {tuple(g.shape)} on {g.device}")
    grad_a, grad_b = torch.empty_like(feat_a), torch.empty_like(feat_b)
    if feat_a.numel() == 0:
        return grad_a, grad_b
    lib = _lib()
    err = lib.ofd_corr_bwd(feat_a.data_ptr(), feat_b.data_ptr(), g.data_ptr(),
                           grad_a.data_ptr(), grad_b.data_ptr(),
                           int(feat_a.dtype == torch.bfloat16), B, C, H, W,
                           _DIR_CODE[direction], dev.index,
                           torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, CORR_BWD.name)
    CORR_BWD.launches += 1
    return grad_a, grad_b


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, direction):
        ctx.save_for_backward(a, b)
        ctx.direction = direction
        return corr_fwd(a, b, direction)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga, gb = corr_bwd(a, b, g, ctx.direction)
        return ga, gb, None


def local_correlation(feat_a: torch.Tensor, feat_b: torch.Tensor,
                      direction: Optional[str] = None) -> torch.Tensor:
    """The differentiable 9x9 cost volume (B, 81, H, W) of ``feat_a`` and
    ``feat_b`` (B, C, H, W), its channels in ``direction``'s order (None:
    JAX's ``local_correlation``; ``fwd``/``bwd``: then
    ``pwc_index_reorder``).  The CUDA kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if feat_a.is_cuda:
        if feat_b.dtype != feat_a.dtype:
            raise TypeError(f"feat_b has dtype {feat_b.dtype}, feat_a {feat_a.dtype}")
        return _Correlation.apply(feat_a.contiguous(), feat_b.contiguous(), direction)
    out = local_correlation_plain(feat_a, feat_b)
    return out if direction is None else pwc_index_reorder(out, direction)


__all__ = ["DIRECTIONS", "PATCH", "corr_bwd", "corr_fwd", "local_correlation",
           "local_correlation_plain", "pwc_index_reorder", "reorder_index"]
