"""Bilinear splat and its backward (JAX ``ops/splat.py``), NCHW.

Each source pixel adds its value, times the bilinear weight, to the four
integer corners around its target ``T(x + dx, y + dy)``; corners outside
the output and non-finite targets are dropped.  ``T`` is the fused integer
``scale`` downsample with its phase ``offset`` and the reference's edge
stretch (``_fwd_transform``), so the output is (H // scale, W // scale).
Sums are taken in float32 (or finer) and cast back to the input dtype, as in
JAX.  The backward is the reference's VJP, not the derivative of the
forward: two bilinear gathers through the ``ingrad`` and ``flowgrad``
transforms, with REFERENCE_QUIRKS 1-3 (JAX ``ops/splat.py:29-38``).

* :func:`splat_raw` and :func:`splat_bwd_raw` are the plain versions: a
  scatter with ``index_add_`` (on the GPU its float atomics sum in a varying
  order, unless the sums are taken in float64) and the gathers.
* :func:`splat_fixed_plain` is the forward kernel's own arithmetic (each
  term rounded once to a 64-bit fixed point, integer sums, non-finite
  terms apart, the hole-mask flag): the kernel equals it bit for bit.
* :func:`splat_fwd` and :func:`splat_bwd` launch the CUDA kernels of
  ``kernels/splat.cu``; the forward's sums are the same bits on every run
  (64-bit fixed-point integer sums, in a shared-memory window per tile of
  sources and then in global memory; the kernel source owns its plan and
  states the scratch it needs), as the JAX version's are.
* :func:`splat` is the differentiable op (``torch.autograd.Function``) over
  the kernels for CUDA tensors and the plain versions for CPU tensors.  It
  also returns the hole mask ``sum of the last channel > 0``; on the card a
  per-target flag keeps that mask exact where terms are far below the
  fixed-point resolution.
* :func:`softsplat` builds the mode's values (``sum``, ``avg``, ``linear``,
  ``soft``, ``linear_unn``, with the eps suffixes) and normalises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from ..kernels import SPLAT, SPLAT_BWD

MODES = ("sum", "avg", "linear", "soft", "linear_unn")


# ------------------------------------------------------------ plain versions
def _stretch(offset: int, size: int, scale: int) -> int:
    """Edge-stretch multiplier ``abs(offset - size % scale) % scale``."""
    return abs(int(offset) - size % scale) % scale


def _div(a, scale: int):
    """a / scale, correctly rounded in float32 on every device: CUDA divides
    a tensor by a Python scalar as a multiplication by its reciprocal, which
    is off by an ulp at scales that are no power of two (the kernels and
    JAX divide)."""
    return a / torch.full_like(a, float(scale))


def _transform(f, size: int, scale: int, off: int, stretch: int, gate: bool = True):
    """Forward transform (JAX ``_fwd_transform``); ``gate=False`` drops the
    ``scale > 1`` gate of the edge branch (``_ingrad_transform_y`` and the
    flowgrad x transform)."""
    shifted = f - off
    f_edge = _div(f + (f - size + 1.0) * stretch - off, scale)
    edge = f >= size - 1.0
    if gate and scale == 1:
        edge = torch.zeros_like(edge)
    return torch.where(edge, f_edge, torch.where(shifted < 0.0, shifted, _div(shifted, scale)))


def _ingrad_x(f, size: int, scale: int, off: int, stretch: int):
    """ingrad x transform with quirk 1 (an extra ``* offset`` stretch)."""
    f1 = f + (f - size + 1.0) * stretch
    f1 = f1 + (f1 - size + 1.0) * off
    shifted = f - off
    return torch.where(f >= size - 1.0, _div(f1 - off, scale),
                       torch.where(shifted < 0.0, shifted, _div(shifted, scale)))


def _flowgrad_y(f, size: int, scale: int, off: int):
    """flowgrad y transform with quirk 2 (``* offset`` for the stretch)."""
    return _transform(f, size, scale, off, off, gate=False)


def _freeze(f, size: int, scale: int, off: int):
    """d(transform)/d(flow), frozen to 0 outside the interior branch."""
    frozen = (f >= size - 1.0) | ((f - off) < 0.0)
    return torch.where(frozen, torch.zeros_like(f), torch.full_like(f, 1.0 / scale))


def _targets(flow: torch.Tensor, H: int, W: int):
    """Raw targets fx, fy (B, H, W) float32, their finite mask, and both
    with non-finite entries replaced by 0 (masked out by the callers)."""
    dev = flow.device
    flow = flow.float()
    xs = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W)
    ys = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1)
    fx = xs + flow[:, 0]
    fy = ys + flow[:, 1]
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    zero = torch.zeros_like(fx)
    return torch.where(finite, fx, zero), torch.where(finite, fy, zero), finite


def _geometry(H: int, W: int, scale: int, offset: Sequence[int]):
    scale = int(scale)
    ox, oy = (int(o) for o in offset)
    if scale < 1 or not (0 <= ox < scale and 0 <= oy < scale):
        raise ValueError(f"need scale >= 1 and 0 <= offset < scale, got {scale}, {offset}")
    return scale, ox, oy, H // scale, W // scale


def _splat_terms(inp: torch.Tensor, flow: torch.Tensor, scale: int, offset: Sequence[int]):
    """The float32 terms of the splat, corner by corner: ((B, C, Ho, Wo),
    dump, [(idx (S,), term (S, C)) for the 4 corners]) over the S = B H W
    sources, with idx = b Ho Wo + y Wo + x, or ``dump`` = B Ho Wo for a
    corner outside the output or a non-finite target."""
    B, C, H, W = inp.shape
    scale, ox, oy, Ho, Wo = _geometry(H, W, scale, offset)
    dev = inp.device
    vals = inp.float().permute(0, 2, 3, 1).reshape(B * H * W, C)
    fx, fy, finite = _targets(flow, H, W)
    tx = _transform(fx, W, scale, ox, _stretch(ox, W, scale)).reshape(-1)
    ty = _transform(fy, H, scale, oy, _stretch(oy, H, scale)).reshape(-1)
    finite = finite.reshape(-1)
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    wx1 = tx - x0
    wy1 = ty - y0
    base = torch.arange(B, device=dev).repeat_interleave(H * W) * (Ho * Wo)
    dump = B * Ho * Wo
    corners = []
    for cx, cy, w in (
        (x0, y0, (1.0 - wx1) * (1.0 - wy1)),
        (x0 + 1.0, y0, wx1 * (1.0 - wy1)),
        (x0, y0 + 1.0, (1.0 - wx1) * wy1),
        (x0 + 1.0, y0 + 1.0, wx1 * wy1),
    ):
        inb = finite & (cx >= 0) & (cx < Wo) & (cy >= 0) & (cy < Ho)
        idx = (base + cy.clamp(0, Ho - 1).long() * Wo + cx.clamp(0, Wo - 1).long())
        idx = torch.where(inb, idx, torch.full_like(idx, dump))
        corners.append((idx, vals * w[:, None]))
    return (B, C, Ho, Wo), dump, corners


def splat_raw(inp: torch.Tensor, flow: torch.Tensor, scale: int = 1,
              offset: Sequence[int] = (0, 0), acc_dtype=torch.float32) -> torch.Tensor:
    """Bilinear scatter-add of ``inp`` (B, C, H, W) by ``flow`` (B, 2, H, W)
    into (B, C, H // scale, W // scale), in ``inp``'s dtype.  The float32
    terms are summed in ``acc_dtype``: with float64 on the GPU the atomics'
    varying order no longer reaches the float32 result, which is then the
    same on every run (as the kernel's fixed-point sums are)."""
    (B, C, Ho, Wo), dump, corners = _splat_terms(inp, flow, scale, offset)
    out = torch.zeros(dump + 1, C, device=inp.device, dtype=acc_dtype)
    for idx, term in corners:
        out.index_add_(0, idx, term.to(acc_dtype))
    out = out[:dump].view(B, Ho, Wo, C).permute(0, 3, 1, 2)
    return out.float().to(inp.dtype)


_NAN_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF), torch.bfloat16: (torch.int16, 0x7FFF)}


def splat_fixed_plain(inp: torch.Tensor, flow: torch.Tensor, scale: int = 1,
                      offset: Sequence[int] = (0, 0)) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic in plain PyTorch: (out (B, C, Ho, Wo)
    in ``inp``'s dtype, hole mask (B, 1, Ho, Wo) bool), the same bits as
    :func:`splat_fwd` for every input.  :func:`splat_raw`'s float32 terms
    are each rounded once (half to even) to a 64-bit fixed point, term * 2^e
    with e = 62 - ceil(log2(H W)) - the exponent of the channel's largest
    finite |v|, and summed as integers (exact in any order); the non-finite
    terms are summed apart (NaN if a NaN or both infinities landed, else
    that infinity) and take the fixed-point sum's place; the sum times 2^-e
    is rounded to float32 and cast once to the dtype (a NaN written with the
    kernel's bits).  mask = (v > 0) | (v == 0 & a finite positive term of
    the last channel landed), on the last channel's v as written."""
    H, W = inp.shape[2:]
    (B, C, Ho, Wo), dump, corners = _splat_terms(inp, flow, scale, offset)
    dev = inp.device
    a = inp.float().abs()
    mx = torch.where(torch.isfinite(a), a, torch.zeros_like(a)).amax(dim=(0, 2, 3))
    e = [62 - max(0, (H * W - 1).bit_length()) - int(k)
         for k in torch.frexp(mx).exponent.tolist()]
    sc = torch.tensor([math.ldexp(1.0, k) for k in e], dtype=torch.float64, device=dev)
    inv = torch.tensor([math.ldexp(1.0, -k) for k in e], dtype=torch.float64, device=dev)
    acc = torch.zeros(dump + 1, C, dtype=torch.int64, device=dev)
    special = torch.zeros(dump + 1, C, 3, dtype=torch.int64, device=dev)  # +inf, -inf, NaN
    hit = torch.zeros(dump + 1, dtype=torch.int64, device=dev)
    for idx, term in corners:
        fin = torch.isfinite(term)
        q = torch.round(torch.where(fin, term, torch.zeros_like(term)).double() * sc)
        acc.index_add_(0, idx, q.long())
        special.index_add_(0, idx, torch.stack(
            [term == float("inf"), term == float("-inf"), torch.isnan(term)], -1).long())
        hit.index_add_(0, idx, (fin[:, -1] & (term[:, -1] > 0)).long())
    r = (acc[:dump].double() * inv).float()
    pos, neg, nan = (special[:dump, :, k] > 0 for k in range(3))
    r = torch.where(pos, torch.full_like(r, float("inf")), r)
    r = torch.where(neg, torch.full_like(r, float("-inf")), r)
    r = torch.where(nan | (pos & neg), torch.full_like(r, float("nan")), r)
    out = r.view(B, Ho, Wo, C).permute(0, 3, 1, 2).to(inp.dtype).contiguous()
    int_dtype, nan_bits = _NAN_BITS[inp.dtype]
    nan_out = torch.isnan(out)
    if bool(nan_out.any()):
        bits = torch.where(nan_out, torch.full_like(out.view(int_dtype), nan_bits),
                           out.view(int_dtype))
        out = bits.view(inp.dtype)
    last = out[:, -1:].float()
    hit = (hit[:dump] > 0).view(B, 1, Ho, Wo)
    return out, (last > 0) | ((last == 0) & hit)


def splat_bwd_raw(inp: torch.Tensor, flow: torch.Tensor, g: torch.Tensor, scale: int = 1,
                  offset: Sequence[int] = (0, 0)) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference VJP of :func:`splat_raw` (JAX ``_splat_bwd``): given the
    output cotangent ``g`` (B, C, Ho, Wo), returns (d_inp in ``inp``'s dtype,
    d_flow float32), both zero where the target is non-finite."""
    B, C, H, W = inp.shape
    scale, ox, oy, Ho, Wo = _geometry(H, W, scale, offset)
    if Ho * Wo == 0:              # H or W below the scale: nothing was splatted
        return torch.zeros_like(inp), torch.zeros(B, 2, H, W, device=inp.device)
    sx, sy = _stretch(ox, W, scale), _stretch(oy, H, scale)
    fx, fy, finite = _targets(flow, H, W)
    g32 = g.float().reshape(B, C, Ho * Wo)

    def gather(cx, cy):
        ok = (cx >= 0) & (cx < Wo) & (cy >= 0) & (cy < Ho)
        idx = cy.clamp(0, Ho - 1).long() * Wo + cx.clamp(0, Wo - 1).long()
        v = torch.gather(g32, 2, idx.view(B, 1, H * W).expand(B, C, H * W))
        v = v.view(B, C, H, W)
        return torch.where(ok[:, None], v, torch.zeros_like(v))

    def corners(t):
        t0 = torch.floor(t)
        a = t - t0
        return (t0, t0 + 1.0), (1.0 - a, a)

    (xi, wxi), (yi, wyi) = corners(_ingrad_x(fx, W, scale, ox, sx)), corners(
        _transform(fy, H, scale, oy, sy, gate=False))
    (xf, wxf), (yf, wyf) = corners(_transform(fx, W, scale, ox, sx, gate=False)), corners(
        _flowgrad_y(fy, H, scale, oy))
    ex = lambda w: w[:, None]
    # every sum starts from zero and adds its terms in order (the channels c
    # = 0 .. C-1 too), as the kernel does, so that the two give the same bits
    d_inp = torch.zeros(B, C, H, W, device=inp.device)
    for k in range(2):
        col = ex(wyi[0]) * gather(xi[k], yi[0]) + ex(wyi[1]) * gather(xi[k], yi[1])
        d_inp = d_inp + ex(wxi[k]) * col
    tfx, tfy = [], []
    for k in range(2):
        g0, g1 = gather(xf[k], yf[0]), gather(xf[k], yf[1])
        tfx.append(ex(wyf[0]) * g0 + ex(wyf[1]) * g1)
        tfy.append(g1 - g0)
    v = inp.float()
    tx = (tfx[1] - tfx[0]) * v
    ty = (ex(wxf[0]) * tfy[0] + ex(wxf[1]) * tfy[1]) * v
    gx, gy = torch.zeros_like(fx), torch.zeros_like(fy)
    for c in range(C):
        gx, gy = gx + tx[:, c], gy + ty[:, c]
    # quirk 3: the x channel takes the y freeze flag, and the y channel the x one
    d_flow = torch.stack([gx * _freeze(fy, H, scale, oy), gy * _freeze(fx, W, scale, ox)], 1)
    d_inp = torch.where(finite[:, None], d_inp, torch.zeros_like(d_inp))
    d_flow = torch.where(finite[:, None], d_flow, torch.zeros_like(d_flow))
    return d_inp.to(inp.dtype), d_flow


# ------------------------------------------------------------- CUDA kernels
def _lib():
    from ..kernels import build

    lib = build.load("splat")
    if not getattr(lib, "_ofd_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ofd_splat.argtypes = [vp, vp, i, vp, ctypes.c_longlong, vp, vp] + [i] * 8 + [vp]
        lib.ofd_splat.restype = i
        lib.ofd_splat_scratch_bytes.argtypes = [i] * 5
        lib.ofd_splat_scratch_bytes.restype = ctypes.c_longlong
        lib.ofd_splat_windows.argtypes = [i] * 5 + [vp, vp]
        lib.ofd_splat_windows.restype = i
        lib.ofd_splat_bwd_scratch_bytes.argtypes = [i] * 5
        lib.ofd_splat_bwd_scratch_bytes.restype = ctypes.c_longlong
        lib.ofd_splat_bwd.argtypes = [vp, vp, vp, i, vp, ctypes.c_longlong, vp, vp] + [i] * 8 + [vp]
        lib.ofd_splat_bwd.restype = i
        lib.ofd_cuda_error_string.argtypes = [i]
        lib.ofd_cuda_error_string.restype = ctypes.c_char_p
        lib._ofd_typed = True
    return lib


def _check_args(inp, flow, scale, offset):
    if not inp.is_cuda:
        raise ValueError(f"the splat kernels take CUDA tensors, got {inp.device}")
    if inp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"inp must be float32 or bfloat16, got {inp.dtype}")
    if inp.dim() != 4:
        raise ValueError(f"inp must be (B, C, H, W), got {tuple(inp.shape)}")
    B, C, H, W = inp.shape
    for name, t, shape, dtype in (("inp", inp, (B, C, H, W), inp.dtype),
                                  ("flow", flow, (B, 2, H, W), torch.float32)):
        if t.device != inp.device:
            raise ValueError(f"{name} is on {t.device}, expected {inp.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return (B, C, H, W) + _geometry(H, W, scale, offset)


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.ofd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _kernel_windows(H: int, W: int, scale: int, offset: Sequence[int] = (0, 0)):
    """The forward kernel's own windows (``ofd_splat_windows``), for the
    checks on the card: per source column and row the origin, in output
    cells, of its tile's window, as int32 (W,) and (H,) CPU tensors, and the
    window's side.  Corners outside it take the escapes' global atomics."""
    ox, oy = (int(o) for o in offset)
    wx0 = torch.empty(W, dtype=torch.int32)
    wy0 = torch.empty(H, dtype=torch.int32)
    win = _lib().ofd_splat_windows(H, W, int(scale), ox, oy, wx0.data_ptr(), wy0.data_ptr())
    if win < 1:
        raise ValueError(f"no splat windows for {(H, W)} at scale {scale}, offset {offset}")
    return wx0, wy0, win


def splat_fwd(inp: torch.Tensor, flow: torch.Tensor, scale: int = 1,
              offset: Sequence[int] = (0, 0)) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on contiguous CUDA tensors ``inp`` (B, C, H, W)
    bf16 or f32 and ``flow`` (B, 2, H, W) f32.  Returns the splat (B, C, Ho,
    Wo) in inp's dtype and the hole mask (B, 1, Ho, Wo) bool of its last
    channel: the bits of :func:`splat_fixed_plain`, the same on every run.
    Three launches, one scratch allocation and no memset."""
    B, C, H, W, scale, ox, oy, Ho, Wo = _check_args(inp, flow, scale, offset)
    dev = inp.device
    out = torch.empty(B, C, Ho, Wo, dtype=inp.dtype, device=dev)
    mask = torch.empty(B, 1, Ho, Wo, dtype=torch.uint8, device=dev)
    if out.numel() == 0:          # H or W below the scale: nothing to splat into
        return out, mask.view(torch.bool)
    lib = _lib()
    nbytes = lib.ofd_splat_scratch_bytes(B, C, H, W, scale)
    if nbytes < 0:
        raise ValueError(f"the splat kernel takes 1 <= B <= 65535, got {B}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = lib.ofd_splat(
        inp.data_ptr(), flow.data_ptr(), int(inp.dtype == torch.bfloat16), scratch.data_ptr(),
        nbytes, out.data_ptr(), mask.data_ptr(), B, C, H, W, scale, ox, oy, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, SPLAT.name)
    SPLAT.launches += 1
    return out, mask.view(torch.bool)


def splat_bwd(inp: torch.Tensor, flow: torch.Tensor, g: torch.Tensor, scale: int = 1,
              offset: Sequence[int] = (0, 0)) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: (d_inp in inp's dtype, d_flow f32) for the
    output cotangent ``g`` (B, C, Ho, Wo), the bits of :func:`splat_bwd_raw`.
    Two launches (the cotangent laid out channels-last into the scratch the
    source states, then the gathers)."""
    B, C, H, W, scale, ox, oy, Ho, Wo = _check_args(inp, flow, scale, offset)
    dev = inp.device
    g = g.float().contiguous()
    if g.device != dev or tuple(g.shape) != (B, C, Ho, Wo):
        raise ValueError(f"g must be (B, C, Ho, Wo) = {(B, C, Ho, Wo)} on {dev}, "
                         f"got {tuple(g.shape)} on {g.device}")
    if g.numel() == 0:            # H or W below the scale: nothing was splatted
        return torch.zeros_like(inp), torch.zeros(B, 2, H, W, device=dev)
    d_inp = torch.empty_like(inp)
    d_flow = torch.empty(B, 2, H, W, dtype=torch.float32, device=dev)
    lib = _lib()
    nbytes = lib.ofd_splat_bwd_scratch_bytes(B, C, H, W, scale)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = lib.ofd_splat_bwd(
        inp.data_ptr(), flow.data_ptr(), g.data_ptr(), int(inp.dtype == torch.bfloat16),
        scratch.data_ptr(), nbytes, d_inp.data_ptr(), d_flow.data_ptr(), B, C, H, W, scale, ox,
        oy, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, SPLAT_BWD.name)
    SPLAT_BWD.launches += 1
    return d_inp, d_flow


# ------------------------------------------------------- differentiable op
class _Splat(torch.autograd.Function):
    """splat(inp, flow) with the reference VJP; offsets get no gradient."""

    @staticmethod
    def forward(ctx, inp, flow, scale, ox, oy):
        if inp.is_cuda:
            out, mask = splat_fwd(inp, flow, scale, (ox, oy))
        else:
            out = splat_raw(inp, flow, scale, (ox, oy))
            mask = out[:, -1:] > 0
        ctx.save_for_backward(inp, flow)
        ctx.geom = (scale, (ox, oy))
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, g, _):
        inp, flow = ctx.saved_tensors
        fn = splat_bwd if inp.is_cuda else splat_bwd_raw
        d_inp, d_flow = fn(inp, flow, g, *ctx.geom)
        return d_inp, d_flow, None, None, None


def splat(inp: torch.Tensor, flow: torch.Tensor, scale: int = 1,
          offset: Sequence[int] = (0, 0)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable splat of ``inp`` (B, C, H, W) by ``flow`` (B, 2, H, W):
    (out (B, C, H // scale, W // scale), hole mask (B, 1, ...) of the last
    channel's sum > 0).  The CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors."""
    if inp.is_cuda:
        inp, flow = inp.contiguous(), flow.float().contiguous()
    return _Splat.apply(inp, flow, int(scale), int(offset[0]), int(offset[1]))


def _softsplat(inp, flow, metric, mode: str, scale: int = 1,
               offset: Sequence[int] = (0, 0)):
    """:func:`softsplat` and the hole mask of its weight channel."""
    base, _, suffix = mode.partition("-")
    if base not in MODES:
        raise ValueError(f"unknown splat mode {mode}")
    if (metric is None) != (base in ("sum", "avg")):
        raise ValueError(f"mode {base} {'takes no' if metric is not None else 'needs a'} metric")
    if base == "avg":
        inp = torch.cat([inp, torch.ones_like(inp[:, :1])], dim=1)
    elif base in ("linear", "linear_unn"):
        inp = torch.cat([inp * metric, metric], dim=1)
    elif base == "soft":
        m = torch.exp(metric)
        inp = torch.cat([inp * m, m], dim=1)
    out, mask = splat(inp, flow, scale, offset)
    if base in ("avg", "linear", "soft"):
        norm = out[:, -1:]
        suffix = suffix or "addeps"
        if suffix == "addeps":
            norm = norm + 1e-7
        elif suffix == "zeroeps":
            norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
        elif suffix == "clipeps":
            norm = torch.clamp(norm, min=1e-7)
        out = torch.cat([out[:, :-1] / norm, out[:, -1:]], dim=1)
    return out, mask


def softsplat(inp: torch.Tensor, flow: torch.Tensor, metric=None, mode: str = "linear_unn",
              scale: int = 1, offset: Sequence[int] = (0, 0)) -> torch.Tensor:
    """Softmax splatting (JAX ``softsplat``): ``inp`` (B, C, H, W), ``flow``
    (B, 2, H, W), ``metric`` (B, 1, H, W) or None for ``sum``/``avg``.
    Returns (B, C [+ 1], H // scale, W // scale); the normalised modes and
    ``linear_unn`` append the raw accumulated weight as the last channel."""
    return _softsplat(inp, flow, metric, mode, scale, offset)[0]


__all__ = ["MODES", "softsplat", "splat", "splat_bwd", "splat_bwd_raw", "splat_fixed_plain",
           "splat_fwd", "splat_raw"]
