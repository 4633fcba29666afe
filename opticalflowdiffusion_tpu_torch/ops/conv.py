"""Stride-1 'same' convolution (JAX ``ops/conv_pallas.py``), NCHW.

Activations are NCHW and kernels OIHW, as everywhere in the port; the
kernel is cast to the input's dtype, the bias stays outside (as in JAX).

Backends, the ``backend`` argument (JAX reads ``OFD_CONV_BACKEND``):

=========  ===================  ==============================================
port       JAX                  spatial (odd, > 1x1) convolutions
=========  ===================  ==============================================
``cudnn``  ``auto`` / ``xla``   ``F.conv2d`` (cuDNN on the card) and autograd's
                                own backward: the counterpart of ``_conv_xla``
``rows``   ``pallas``           :func:`conv_rows`, the CUDA counterpart of the
                                row-slab Pallas ``_kernel`` (kernel row 9)
``fold``   ``fold``             :func:`conv_fold`, the CUDA counterpart of the
                                width-folded ``_fold_kernel`` (kernel row 10),
                                which also applies ``silu(x * a + b)`` per
                                (batch, channel) as it loads its input
=========  ===================  ==============================================

Routing, as JAX's dispatch acts on the UNet's shapes:

* 1x1 kernels run as a matmul (``torch.matmul``, outside any kernel) under
  ``rows`` and ``fold``, as JAX's ``OFD_1X1`` defaults to ``dot`` there, and
  as ``F.conv2d`` under ``cudnn``.
* Under ``rows`` and ``fold`` every odd spatial kernel runs the backend's
  kernel, forward and in the gradient (``_ConvSame``: JAX ``_conv_same``).
  JAX keeps VMEM budgets (``_use_fold``, ``_use_pallas``) that can send a
  shape back to XLA; they accept every conv of the flagship UNet at 128x128
  and 448x1024 (``tests/test_torch_port_conv.py``), so the port has none.
* ``in_affine=(a, b)`` computes ``conv(silu(x * a + b))`` with f32 (B, Cin)
  vectors (``_ConvSameGN``: JAX ``_conv_same_gn``).  Under ``fold`` the
  transform is the kernel's prologue; under ``rows`` the forward is
  :func:`conv2d_same_gn_plain` through cuDNN, as JAX's ``_dispatch_gn``
  sends it to ``_silu_affine_xla`` under ``pallas``; under both the
  gradient's dz runs the backend's kernel without the prologue.

Gradients (JAX ``_conv_same_bwd``, ``_conv_same_gn_bwd``): dx (or dz) is the
backend's kernel applied to the cotangent with the spatially flipped,
io-swapped kernel, skipped when the input needs no gradient (the stem); dk is
``torch.nn.grad.conv2d_weight`` (cuDNN), as JAX takes it outside Pallas; the
SiLU-affine backward is plain torch in JAX's form.

:func:`conv2d_same_plain` and :func:`conv2d_same_gn_plain` are the kernels'
plain versions: the wrappers take them for CPU tensors (the tests), and on
the card nothing on the path calls them.  For CUDA tensors the wrappers
launch ``kernels/conv.cu`` or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import CONV_FOLD, CONV_ROWS

BACKENDS = ("cudnn", "rows", "fold")
# the kernels' tile along Cout and their input-channel slice per dtype: the
# wrapper pads the laid-out weights to these
TILE_N = 64
SLICE_C = {torch.bfloat16: 32, torch.float32: 8}
# the bf16 kernel's tile: TILE_M flat positions of a strip of at most
# STRIP_MAX columns; its shared memory (2 patch stages of np positions x 64
# bytes, 1-2 raw stages of 32 x rh x rw bf16 and 64 f32, 6 weight stages of
# 4 KB, 16-20 mbarriers) may not pass the 227 KB a CTA may have
TILE_M = 512
STRIP_MAX = 64
SMEM_MAX = 227 * 1024


class ConvPlan(NamedTuple):
    """The bf16 kernel's tiling of one conv (the source computes the same
    from ``wt``): strips of ``wt`` image columns, each laid out as rows of
    pitch ``pw`` (the kw - 1 halo columns computed and dropped), cut into
    ``runs`` tiles of TILE_M flat positions; ``np`` patch positions per
    tile, loaded as ``rh`` rows x ``rw`` columns (from a multiple of 8) of 32
    channels at a time; ``tiles`` in all (with ``nblk`` blocks of 64 output
    channels and ``nsl`` slices of 32 input channels)."""
    wt: int
    pw: int
    strips: int
    runs: int
    nblk: int
    nsl: int
    np: int
    rw: int
    rh: int
    tiles: int
    smem: int


def conv_plan(B: int, Cin: int, H: int, W: int, Cout: int, kh: int, kw: int) -> ConvPlan:
    """The bf16 kernel's plan: one strip where W <= STRIP_MAX, otherwise the
    fewest strips of at most STRIP_MAX columns, as even as a multiple of 8
    allows (so that the strips' output rows start 4-byte aligned); two raw
    stages where the shared memory allows, else one."""
    if W <= STRIP_MAX:
        wt = W
    else:
        n = -(-W // STRIP_MAX)
        wt = -(-(-(-W // n)) // 8) * 8
    pw = wt + kw - 1
    strips = -(-W // wt)
    runs = -(-(H * pw) // TILE_M)
    nblk, nsl = -(-Cout // TILE_N), -(-Cin // SLICE_C[torch.bfloat16])
    np_ = TILE_M + (kh - 1) * pw + kw - 1
    rw, rh = -(-(pw + 7) // 8) * 8, (np_ + pw - 2) // pw + 1
    fixed = 2 * np_ * 64 + 6 * 4096
    raw = 32 * rh * rw * 2 + 256
    smem = fixed + 2 * raw + 2 * (2 + 6 + 2) * 8
    if smem > SMEM_MAX:
        smem = fixed + raw + 2 * (2 + 6 + 1) * 8
    return ConvPlan(wt, pw, strips, runs, nblk, nsl, np_, rw, rh, B * strips * runs * nblk, smem)


def _pad(w: torch.Tensor) -> Tuple[int, int]:
    kh, kw = w.shape[-2:]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"'same' conv needs an odd kernel, got {kh}x{kw}")
    return kh // 2, kw // 2


# ------------------------------------------------------------ plain versions
def conv2d_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` with the kernel in x's dtype (JAX ``_conv_xla``)."""
    return F.conv2d(x, w.to(x.dtype), padding=_pad(w))


def silu_affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``silu(x * a + b)`` in f32 with (B, C) vectors, rounded to x's dtype."""
    u = x.float() * a[:, :, None, None].float() + b[:, :, None, None].float()
    return F.silu(u).to(x.dtype)


def conv2d_same_gn_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """``conv(silu(x * a + b))``, z rounded to x's dtype before the product
    (JAX ``_silu_affine_xla``)."""
    return conv2d_same_plain(silu_affine(x, a, b), w)


def dot_1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv as a matmul over the channels (JAX ``x @ kernel[0, 0]``)."""
    B, C, H, W = x.shape
    y = torch.matmul(w[:, :, 0, 0].to(x.dtype), x.reshape(B, C, H * W))
    return y.reshape(B, -1, H, W)


# ------------------------------------------------------------- CUDA kernels
def _lib():
    from ..kernels import build

    lib = build.load("conv")
    if not getattr(lib, "_ofd_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        geo = [i] * 11     # B, Cin, H, W, Cout, kh, kw, cin_pad, cout_pad, wt, ldx
        lib.ofd_conv_rows.argtypes = [vp, vp, vp, i, *geo, i, vp]
        lib.ofd_conv_rows.restype = i
        lib.ofd_conv_fold.argtypes = [vp, vp, vp, vp, vp, i, i, *geo, i, vp]
        lib.ofd_conv_fold.restype = i
        lib.ofd_cuda_error_string.argtypes = [i]
        lib.ofd_cuda_error_string.restype = ctypes.c_char_p
        lib._ofd_typed = True
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"the {what} kernel takes CUDA tensors, x is on {x.device}")
    if x.dtype not in SLICE_C:
        raise TypeError(f"the {what} kernel takes bf16 or f32 x, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"the {what} kernel takes a contiguous NCHW x, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if w.dim() != 4 or w.shape[1] != x.shape[1]:
        raise ValueError(f"kernel {tuple(w.shape)} does not take {x.shape[1]} input channels")
    if w.device != x.device:
        raise ValueError("x and the kernel must be on one device")
    _pad(w)


def _layout(w: torch.Tensor, dtype) -> torch.Tensor:
    """OIHW -> the kernels' weight layout in ``dtype``, zero-padded to the
    channel slice and Cout tile.  bf16: [Cout_pad / 64][Cin_pad / 32]
    [kh * kw][4][64][8], each (slice, tap) tile of 64 output x 32 input
    channels as four 8-channel planes, K-major, as the kernel's wgmma reads
    it.  f32: [kh * kw][Cin_pad][Cout_pad].  One copy where no padding is
    needed (every conv of the UNet but the stem), two where it is."""
    Cout, Cin, kh, kw = w.shape
    sc = SLICE_C[dtype]
    cin_pad, cout_pad = -(-Cin // sc) * sc, -(-Cout // TILE_N) * TILE_N
    if (cin_pad, cout_pad) != (Cin, Cout):
        w = F.pad(w, (0, 0, 0, 0, 0, cin_pad - Cin, 0, cout_pad - Cout))
    if dtype == torch.bfloat16:
        src = w.reshape(cout_pad // TILE_N, TILE_N, cin_pad // sc, sc // 8, 8, kh * kw)
        src = src.permute(0, 2, 5, 3, 1, 4)
        shape = (cout_pad // TILE_N, cin_pad // sc, kh * kw, sc // 8, TILE_N, 8)
    else:
        src = w.permute(2, 3, 1, 0).reshape(kh * kw, cin_pad, cout_pad)
        shape = (kh * kw, cin_pad, cout_pad)
    return torch.empty(shape, device=w.device, dtype=dtype).copy_(src)


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor, a=None, b=None) -> torch.Tensor:
    """Launch ``ofd_conv_<entry>`` on checked tensors; raises on a refused launch."""
    return _launch_laid(entry, x, _layout(w, x.dtype), w.shape, a, b)


def _launch_laid(entry: str, x: torch.Tensor, wt: torch.Tensor, wshape, a=None,
                 b=None) -> torch.Tensor:
    """:func:`_launch` on weights already laid out by :func:`_layout` (the
    OIHW shape ``wshape``); ``chip_smoke.py`` times the kernel alone so."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = wshape
    out = torch.empty(B, Cout, H, W, device=x.device, dtype=x.dtype)
    sc = SLICE_C[x.dtype]
    cin_pad, cout_pad = -(-Cin // sc) * sc, -(-Cout // TILE_N) * TILE_N
    strip, ldx = 0, W
    if x.dtype == torch.bfloat16:
        plan = conv_plan(B, Cin, H, W, Cout, kh, kw)
        if plan.smem > SMEM_MAX or max(plan.rw, plan.rh) > 256:
            raise ValueError(f"the conv_{entry} kernel's tile for x {tuple(x.shape)}, kernel "
                             f"{tuple(wshape)} does not fit: {plan}")
        strip = plan.wt
        if W % 8 or x.data_ptr() % 16:
            # the kernel's tensor map needs 16-byte rows: one copy with zero
            # columns past W (the kernel treats them as outside the image)
            ldx = -(-W // 8) * 8
            x = F.pad(x, (0, ldx - W))
    geo = (B, Cin, H, W, Cout, kh, kw, cin_pad, cout_pad, strip, ldx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    bf16 = int(x.dtype == torch.bfloat16)
    if entry == "rows":
        err = lib.ofd_conv_rows(x.data_ptr(), wt.data_ptr(), out.data_ptr(), bf16, *geo,
                                x.device.index, stream)
    else:
        affine = a is not None
        err = lib.ofd_conv_fold(x.data_ptr(), wt.data_ptr(), a.data_ptr() if affine else None,
                                b.data_ptr() if affine else None, out.data_ptr(), bf16,
                                int(affine), *geo, x.device.index, stream)
    if err != 0:
        msg = lib.ofd_cuda_error_string(err).decode()
        raise RuntimeError(f"conv_{entry} kernel launch failed at x {tuple(x.shape)}, "
                           f"kernel {tuple(wshape)}: {msg} ({err})")
    return out


def conv_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row 9: the stride-1 'same' conv (odd kernel, OIHW ``w``).  For a CUDA
    x (contiguous NCHW, bf16 or f32) it launches ``ofd_conv_rows``; for a CPU
    x it is :func:`conv2d_same_plain`."""
    if not x.is_cuda:
        return conv2d_same_plain(x, w)
    _check(x, w, "conv_rows")
    out = _launch("rows", x, w)
    CONV_ROWS.launches += 1
    return out


def conv_fold(x: torch.Tensor, w: torch.Tensor, a: Optional[torch.Tensor] = None,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row 10: the same conv, with ``silu(x * a + b)`` applied to its input
    as it loads when the f32 (B, Cin) vectors ``a``, ``b`` are given (zero
    padding stays zero after the transform).  For a CUDA x it launches
    ``ofd_conv_fold``; for a CPU x it is :func:`conv2d_same_plain` or
    :func:`conv2d_same_gn_plain`."""
    if (a is None) != (b is None):
        raise ValueError("conv_fold takes both affine vectors or neither")
    if not x.is_cuda:
        return conv2d_same_plain(x, w) if a is None else conv2d_same_gn_plain(x, w, a, b)
    _check(x, w, "conv_fold")
    if a is not None:
        shape = (x.shape[0], x.shape[1])
        for name, v in (("a", a), ("b", b)):
            if (v.dtype != torch.float32 or tuple(v.shape) != shape or not v.is_contiguous()
                    or v.device != x.device):
                raise ValueError(f"conv_fold takes a contiguous f32 {shape} {name} on "
                                 f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    out = _launch("fold", x, w, a, b)
    CONV_FOLD.launches += 1
    return out


def _kernel(backend: str):
    """The backend's kernel wrapper, looked up at call time."""
    return conv_rows if backend == "rows" else conv_fold


def _flip(w: torch.Tensor) -> torch.Tensor:
    """The dgrad kernel: spatially flipped, input and output swapped."""
    return w.flip(2, 3).transpose(0, 1)


# ---------------------------------------------------------------- gradients
class _ConvSame(torch.autograd.Function):
    """conv(x, w) through the backend's kernel (JAX ``_conv_same``)."""

    @staticmethod
    def forward(ctx, x, w, backend):
        ctx.save_for_backward(x, w)
        ctx.backend = backend
        return _kernel(backend)(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _kernel(ctx.backend)(g, _flip(w))
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=_pad(w))
        return dx, dw, None


class _ConvSameGN(torch.autograd.Function):
    """conv(silu(x * a + b), w) (JAX ``_conv_same_gn``): the prologue in the
    fold kernel, or the plain version through cuDNN under ``rows``."""

    @staticmethod
    def forward(ctx, x, w, a, b, backend):
        ctx.save_for_backward(x, w, a, b)
        ctx.backend = backend
        if backend == "fold":
            return conv_fold(x, w, a, b)
        return conv2d_same_gn_plain(x, w, a, b)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need_x, need_w, need_a, need_b = ctx.needs_input_grad[:4]
        a4, b4 = a[:, :, None, None], b[:, :, None, None]
        x32 = x.float()
        u = x32 * a4 + b4
        sig = torch.sigmoid(u)
        dx = dw = da = db = None
        if need_x or need_a or need_b:
            dz = _kernel(ctx.backend)(g, _flip(w)).float()
            du = dz * (sig * (1.0 + u * (1.0 - sig)))
            if need_x:
                dx = (du * a4).to(x.dtype)
            if need_a:
                da = (du * x32).sum(dim=(2, 3)).to(a.dtype)
            if need_b:
                db = du.sum(dim=(2, 3)).to(b.dtype)
        if need_w:
            dw = torch.nn.grad.conv2d_weight((u * sig).to(x.dtype), w.shape, g,
                                             padding=_pad(w))
        return dx, dw, da, db, None


# ------------------------------------------------------------ the dispatch
def conv2d_same(x: torch.Tensor, weight: torch.Tensor, backend: str = "cudnn",
                in_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Stride-1 'same' conv of NCHW x with the OIHW ``weight`` cast to x's
    dtype (JAX ``conv2d_same``), routed as the module docstring says.
    ``in_affine=(a, b)`` computes ``conv(silu(x * a + b))``."""
    if backend not in BACKENDS:
        raise ValueError(f"conv backend {backend!r} is not one of {BACKENDS}")
    kh, kw = weight.shape[-2:]
    _pad(weight)
    w = weight.to(x.dtype)
    if kh == 1 and kw == 1 and backend != "cudnn":
        z = x if in_affine is None else silu_affine(x, *in_affine)
        return dot_1x1(z, w)
    spatial = backend != "cudnn" and (kh > 1 or kw > 1)
    if in_affine is not None:
        a, b = (v.float().contiguous() for v in in_affine)
        if spatial:
            return _ConvSameGN.apply(x, w, a, b, backend)
        return conv2d_same_gn_plain(x, w, a, b)
    if spatial:
        return _ConvSame.apply(x, w, backend)
    return conv2d_same_plain(x, w)


__all__ = ["BACKENDS", "ConvPlan", "conv2d_same", "conv2d_same_gn_plain", "conv2d_same_plain",
           "conv_fold", "conv_plan", "conv_rows", "dot_1x1", "silu_affine"]
