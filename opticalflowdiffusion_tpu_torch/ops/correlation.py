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

RAFT's correlation (JAX's ``allpairs_correlation``, ``avg_pool2d`` and
``models/raft.py::corr_lookup``) is here too: the all-pairs product of two
feature maps in float32, its average-pool pyramid, and the windowed
bilinear lookup of (2r + 1)^2 taps around each pixel's target at every
level.  :func:`corr_lookup_plain` is JAX's composition (per level, taps
gathered by ``ops/warp.py::bilinear_gather``, clamped to the border); on the
card :func:`corr_lookup` runs ``kernels/corr_lookup.cu`` (S4: every level's
taps in one launch, channels-last, and the levels' dense cotangents in one,
each row's taps summed by one thread into a window in shared memory and the
rows written whole, without atomics) through a ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import CORR, CORR_BWD, CORR_LOOKUP, CORR_LOOKUP_BWD
from .warp import bilinear_gather

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


# ------------------------------------------------------------------- RAFT
def allpairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """RAFT's all-pairs correlation of (B, C, H, W) feature maps: (B, H, W,
    H, W), every product in float32 (JAX's ``preferred_element_type``),
    scaled by 1 / sqrt(C).  The product is ``torch.matmul`` on float32
    operands, so on the card it follows
    ``torch.backends.cuda.matmul.allow_tf32`` (False by default: full
    float32, as the port runs it; TF32 would round the operands to 10
    mantissa bits)."""
    B, C, H, W = fmap1.shape
    a = fmap1.float().reshape(B, C, H * W).transpose(1, 2)
    b = fmap2.float().reshape(B, C, H * W)
    corr = torch.matmul(a, b)
    corr = corr / torch.sqrt(torch.tensor(float(C), dtype=corr.dtype, device=corr.device))
    return corr.reshape(B, H, W, H, W)


def avg_pool2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """The k x k average pool of the last two (spatial) dims of (..., H, W)
    by JAX's reshape: a side that k does not divide raises, as the
    reshape does there."""
    *lead, H, W = x.shape
    if H % k or W % k:
        raise ValueError(f"avg_pool2d: cannot reshape ({H}, {W}) into {k} x {k} blocks "
                         f"(JAX's reshape fails on the same sides)")
    return x.reshape(*lead, H // k, k, W // k, k).mean(dim=(-3, -1))


def lookup_taps(radius: int) -> torch.Tensor:
    """(K, 2) offsets (dx, dy) of the (2r + 1)^2 taps in JAX's order: tap
    i * (2r + 1) + j is (j - r, i - r)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32)
    ddy, ddx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([ddx, ddy], dim=-1).reshape(-1, 2)


def corr_lookup_plain(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                      radius: int = 4) -> torch.Tensor:
    """JAX's ``corr_lookup``: for each level l of ``pyramid`` ((B * H * W,
    Hl, Wl)), the bilinear taps at coords / 2^l + each offset of
    :func:`lookup_taps`, each index clamped to the border; ``coords`` (B, H,
    W, 2) holds each pixel's (x, y) target.  Returns (B, H, W, L * K), the
    levels last."""
    B, H, W, _ = coords.shape
    delta = lookup_taps(radius).to(coords.device)
    K = delta.shape[0]
    out = []
    for lvl, corr in enumerate(pyramid):
        c = coords.reshape(B * H * W, 1, 2) / (2 ** lvl)
        pts = c + delta.reshape(1, K, 2)
        img = corr.reshape(B * H * W, 1, *corr.shape[-2:])
        sampled = bilinear_gather(img, pts[..., 0].reshape(-1, 1, K), pts[..., 1].reshape(-1, 1, K))
        out.append(sampled.reshape(B, H, W, K))
    return torch.cat(out, dim=-1)


def _lookup_lib():
    from ..kernels import build

    lib = build.load("corr_lookup")
    if not getattr(lib, "_ofd_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ofd_corr_lookup_fwd.argtypes = [ctypes.POINTER(vp), ip, ip, i, vp, vp, ll, i, i, vp]
        lib.ofd_corr_lookup_fwd.restype = i
        lib.ofd_corr_lookup_bwd.argtypes = [ctypes.POINTER(vp), ip, ip, i, vp, vp, ll, i, i, vp]
        lib.ofd_corr_lookup_bwd.restype = i
        lib.ofd_cuda_error_string.argtypes = [i]
        lib.ofd_cuda_error_string.restype = ctypes.c_char_p
        lib._ofd_typed = True
    return lib


MAX_LEVELS = 8


def _check_lookup(levels: Sequence[torch.Tensor], coords: torch.Tensor, radius: int):
    if not coords.is_cuda:
        raise ValueError(f"the lookup kernels take CUDA tensors, got {coords.device}")
    if coords.dtype != torch.float32 or coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be float32 (B, H, W, 2), got {coords.dtype} "
                         f"{tuple(coords.shape)}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"the lookup takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    if not 0 <= radius <= 15:
        raise ValueError(f"radius must be in [0, 15], got {radius}")
    N = coords.shape[0] * coords.shape[1] * coords.shape[2]
    for lvl in levels:
        if (lvl.device != coords.device or lvl.dtype != torch.float32 or lvl.dim() != 3
                or lvl.shape[0] != N or not lvl.is_contiguous()):
            raise ValueError(f"each level must be contiguous float32 ({N}, Hl, Wl) on "
                             f"{coords.device}, got {lvl.dtype} {tuple(lvl.shape)} on {lvl.device}")
    return N


def _level_args(levels):
    L = len(levels)
    hs = (ctypes.c_int * L)(*(int(t.shape[1]) for t in levels))
    ws = (ctypes.c_int * L)(*(int(t.shape[2]) for t in levels))
    ptrs = (ctypes.c_void_p * L)(*(t.data_ptr() for t in levels))
    return ptrs, hs, ws, L


def corr_lookup_fwd(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                    radius: int = 4) -> torch.Tensor:
    """The forward kernel: (B, H, W, L * (2r + 1)^2) float32 taps of the
    contiguous float32 CUDA ``levels`` ((B * H * W, Hl, Wl)) at ``coords``
    (B, H, W, 2), the levels last.  One launch for all levels."""
    N = _check_lookup(levels, coords, radius)
    coords = coords.contiguous()
    B, H, W, _ = coords.shape
    K = (2 * radius + 1) ** 2
    out = torch.empty(B, H, W, len(levels) * K, dtype=torch.float32, device=coords.device)
    if N == 0:
        return out
    lib = _lookup_lib()
    ptrs, hs, ws, L = _level_args(levels)
    dev = coords.device
    err = lib.ofd_corr_lookup_fwd(ptrs, hs, ws, L, coords.data_ptr(), out.data_ptr(), N, radius,
                                  dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, CORR_LOOKUP.name)
    CORR_LOOKUP.launches += 1
    return out


def corr_lookup_bwd(shapes: Sequence[Tuple[int, int]], coords: torch.Tensor, g: torch.Tensor,
                    radius: int = 4) -> List[torch.Tensor]:
    """The backward kernel: each level's dense cotangent (B * H * W, Hl, Wl)
    (``shapes`` the levels' (Hl, Wl)) of the taps' cotangent ``g`` (B, H, W,
    L * K), every row summed by one thread in a fixed order (no atomics: a
    repeat gives the same bits).  One launch for all levels."""
    B, H, W, _ = coords.shape
    N = B * H * W
    K = (2 * radius + 1) ** 2
    dev = coords.device
    grads = [torch.empty(N, int(h), int(w), dtype=torch.float32, device=dev) for h, w in shapes]
    _check_lookup(grads, coords, radius)
    g = g.float().contiguous()
    if g.device != dev or tuple(g.shape) != (B, H, W, len(shapes) * K):
        raise ValueError(f"g must be {(B, H, W, len(shapes) * K)} on {dev}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if N == 0:
        return grads
    lib = _lookup_lib()
    ptrs, hs, ws, L = _level_args(grads)
    err = lib.ofd_corr_lookup_bwd(ptrs, hs, ws, L, coords.contiguous().data_ptr(), g.data_ptr(),
                                  N, radius, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, CORR_LOOKUP_BWD.name)
    CORR_LOOKUP_BWD.launches += 1
    return grads


class _CorrLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, radius, *levels):
        ctx.save_for_backward(coords)
        ctx.radius = radius
        ctx.shapes = [tuple(t.shape[1:]) for t in levels]
        return corr_lookup_fwd(levels, coords, radius)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        return (None, None, *corr_lookup_bwd(ctx.shapes, coords, g, ctx.radius))


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """RAFT's differentiable windowed lookup (B, H, W, L * (2r + 1)^2) of
    the correlation ``pyramid`` (levels (B * H * W, Hl, Wl), float32) at
    ``coords`` (B, H, W, 2): the S4 kernels for CUDA tensors, the plain
    version (:func:`corr_lookup_plain`) for CPU tensors.  The coords carry
    no gradient (RAFT stops it): on the card they must not require one."""
    if coords.is_cuda:
        if coords.requires_grad:
            raise ValueError("the lookup kernels give no gradient of coords: detach them")
        return _CorrLookup.apply(coords.float().contiguous(), int(radius),
                                 *(t.contiguous() for t in pyramid))
    return corr_lookup_plain(pyramid, coords, radius)


__all__ = ["DIRECTIONS", "MAX_LEVELS", "PATCH", "allpairs_correlation", "avg_pool2d",
           "corr_bwd", "corr_fwd", "corr_lookup", "corr_lookup_bwd", "corr_lookup_fwd",
           "corr_lookup_plain", "local_correlation", "local_correlation_plain", "lookup_taps",
           "pwc_index_reorder", "reorder_index"]
