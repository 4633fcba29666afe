"""Fused pre-LN linear-attention block (JAX ``ops/attention_fused.py``).

    y = x + postLN(W_out @ middle(W_qkv @ preLN(x)) + b_out)

on ``x`` of shape (B, C, N), the flattened NCHW map.  Weights are in the
torch layout: ``w_qkv`` (3*heads*dim, C), ``w_out`` (C, heads*dim).

* :func:`block_plain` is the plain-PyTorch composition, the counterpart of
  JAX's ``_block_xla`` (with ``_ln32`` and the middle of
  ``ops/attention_pallas.py``, imported here as ``linear_attention_middle``
  as JAX's module does): operands in the compute dtype, LayerNorms and
  softmaxes in float32.
* :func:`fused_linear_attention_block` runs the two CUDA kernels of
  ``kernels/linear_attention.cu`` (context pass, output pass) on a CUDA
  tensor.  When a gradient is asked for it does so inside a
  ``torch.autograd.Function`` that saves ``(ctx, m, s)`` and whose backward
  runs the three backward kernels (pass B', A'1, A'2) when N >= 1024, and
  below that autograd of :func:`block_plain` recomputed (JAX's
  ``_fwd``/``_bwd`` dispatch; the backward kernels take C <= 512, the
  widest block of the flagship).  On a CPU tensor it is :func:`block_plain`.
  There is no other switch and no fallback: a kernel that cannot be built
  or launched raises.  Like the TPU kernels, the CUDA kernels use bf16
  matmul operands with float32 accumulation even when ``x`` is float32.
* ``ctx_plain``, ``out_plain``, ``bwd_q_plain``, ``bwd_kv1_plain`` and
  ``bwd_kv2_plain`` are the plain versions of the five kernels, with the
  kernels' roundings (``compute_dtype``); with float32 they are the TPU
  passes in float32.
* :func:`la_plan` is the forward kernels' plan for one shape: tile, CTAs,
  partials, x stages, weight chunks resident or streamed, shared memory;
  :func:`la_bwd_plan` the same for passes B' and A'2, with where their
  weight-gradient partials are kept.  The wrappers pass them to the
  launchers, which check them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import LA_BWD_KV1, LA_BWD_KV2, LA_BWD_Q, LA_CTX, LA_OUT
from .attention_pallas import linear_attention_middle_plain as linear_attention_middle

EPS = 1e-5
HEAD_DIM = 32
HIDDEN = 128  # heads * dim_head, the only width the kernels take
HEADS = HIDDEN // HEAD_DIM
Q_SCALE = HEAD_DIM ** -0.5
# JAX's _fwd runs the fused backward at N >= 1024 and the composition's VJP below
BWD_MIN_N = 1024
# the forward kernels' plan (kernels/linear_attention.cu, "Hopper bodies of
# rows 1-2"; the source checks what it is given against the same sums)
TILE = 64                 # positions per tile of the bf16 bodies
F32_TILE = 32             # and of the f32 bodies
CHUNK = 16384             # bytes of a w_q or w_out chunk in shared memory (w_kv: 2 CHUNK)
E_PITCH = HIDDEN + 8      # f32 row pitch of pass A's exp(k - m) and v tiles
SMEM_MAX = 227 * 1024     # shared memory a CTA may have
SMS = 132                 # the H100 SXM's SMs (la_plan's default)


class LaPass(NamedTuple):
    """One forward pass of a plan: ``ctas`` CTAs per batch element (pass A:
    one partial each), ``stages`` x tiles in the TMA ring, ``slots`` weight
    chunks in shared memory (64 channels each: 32 KB of w_kv, 16 KB of w_q
    or w_out), ``resident`` (every chunk loaded once per CTA) or streamed
    (per tile, through the slots), ``consumers`` warp groups, ``smem`` bytes
    of dynamic shared memory."""
    ctas: int
    stages: int
    slots: int
    resident: bool
    consumers: int
    smem: int


class LaPlan(NamedTuple):
    """The forward kernels' plan for one (B, C, N, dtype): ``tile``
    positions, the context pass, its ``partials`` per batch element (folded
    by la_ctx_combine_kernel), and the output pass."""
    tile: int
    ctx: LaPass
    partials: int
    out: LaPass


class LaBwdPass(NamedTuple):
    """One backward pass of a plan (B' or A'2): ``stages`` of the x ring (x
    with dy, or with dxq), ``slots`` weight chunks of 16 KB, ``resident``
    (loaded once per CTA) or streamed per tile, ``consumers`` warp groups
    (the f32 bodies: 2, 256 threads without a producer), ``flush``: how
    often the CTA's weight-gradient partials go to its record, 0 = once at
    the end (kept in shared memory) or 1 = every tile (kept in the record,
    through L2), ``ln_tile``: the normalised x tile kept in shared
    memory (else formed from x where it is needed), and ``smem`` bytes of
    dynamic shared memory."""
    stages: int
    slots: int
    resident: bool
    consumers: int
    flush: int
    ln_tile: bool
    smem: int


class LaBwdPlan(NamedTuple):
    """The plan of backward passes B' and A'2 for one (B, C, N, dtype):
    ``tile`` positions, ``ctas`` per batch element (both passes), and the
    two passes."""
    tile: int
    ctas: int
    q: LaBwdPass
    kv2: LaBwdPass


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _ctx_smem(C: int, S: int, slots: int) -> int:
    return (1024 + S * C * 2 * TILE + slots * 2 * CHUNK + 2 * TILE * E_PITCH * 4
            + (2 * 4 * HIDDEN + 2 * HIDDEN + C) * 4 + (2 * S + 2 * slots) * 8)


def _out_smem(C: int, S: int, slots: int, nw: int) -> int:
    return (1024 + (S + nw) * C * 2 * TILE + slots * CHUNK + HIDDEN * HEAD_DIM * 2
            + 3 * C * 4 + (2 * S + 2 * slots) * 8)


def _streamed(smem, chunk, least_slots, stages):
    """The first (stages, slots) with at least ``least_slots`` streamed chunk
    slots of ``chunk`` bytes (up to 8) that fits, or None."""
    for S in stages:
        slots = min(8, (SMEM_MAX - smem(S, 0)) // (chunk + 16))
        if slots >= least_slots and smem(S, slots) <= SMEM_MAX:
            return S, slots
    return None


@functools.lru_cache(maxsize=512)
def la_plan(B: int, C: int, N: int, dtype=torch.bfloat16, sms: int = SMS) -> LaPlan:
    """The forward kernels' plan.  bf16: tiles of 64 positions; one CTA per
    SM split evenly over the batch, each walking its tiles; weights resident
    where they fit beside the x ring (pass A: 4-2 stages; pass B: two
    consumer warp groups with 4 stages at C <= 128, else one with 3-1), else
    streamed through chunk slots (2 stages, or 1 above 256 channels).  f32:
    the first bodies, tiles of 32 positions, pass A on two waves of CTAs,
    pass B one CTA per tile, weights read from L2.  Raises if no plan fits."""
    if dtype == torch.float32:
        nt = -(-N // F32_TILE)
        a = _align128(C * 40 * 2)
        ctx = LaPass(max(1, min(nt, -(-2 * sms // B))), 0, 0, False, 1,
                     a + 32 * 264 * 4 + (8 * 32 + 2 * 32 + HIDDEN) * 4)
        out = LaPass(nt, 0, 0, False, 1, a + _align128(32 * 136 * 4) + _align128(32 * 136 * 2)
                     + _align128(HIDDEN * HEAD_DIM * 2) + _align128(C * 40 * 4) + (8 * 32 + 64) * 4)
        return LaPlan(F32_TILE, ctx, ctx.ctas, out)
    nt = -(-N // TILE)
    nq = -(-C // 64)  # weight chunks of 64 channels (w_kv: 32 KB, w_q and w_out: 16 KB)
    ctas = max(1, min(nt, sms // B))

    ctx = None
    for S in (4, 3, 2):
        if _ctx_smem(C, S, nq) <= SMEM_MAX:
            ctx = LaPass(ctas, S, nq, True, 2, _ctx_smem(C, S, nq))
            break
    if ctx is None:
        S, slots = _streamed(lambda S, k: _ctx_smem(C, S, k), 2 * CHUNK, 2, (2, 1)) or (0, 0)
        ctx = LaPass(ctas, S, slots, False, 2, _ctx_smem(C, S, slots))

    out = None
    for nw, S in ((2, 4),) if C <= 128 else ((1, 3), (1, 2), (1, 1)):
        smem = _out_smem(C, S, 2 * nq, nw)
        if smem <= SMEM_MAX:
            out = LaPass(ctas, S, 2 * nq, True, nw, smem)
            break
    if out is None:
        S, slots = _streamed(lambda S, k: _out_smem(C, S, k, 1), CHUNK, 4, (2, 1)) or (0, 0)
        out = LaPass(ctas, S, slots, False, 1, _out_smem(C, S, slots, 1))
    if not (ctx.stages and out.stages):
        raise ValueError(f"no forward plan fits C={C}: {ctx} {out}")
    return LaPlan(TILE, ctx, ctx.ctas, out)


# the backward plan (kernels/linear_attention.cu, "Hopper bodies of rows 3
# and 5"; the source checks what it is given against the same sums)
BWD_CHUNK = 16384         # bytes of a weight chunk (w_q, w_out, half of w_kv: 64 channels)


def _bwdq_smem(C: int, S: int, slots: int, acc: bool, ln: bool) -> int:
    return (1024 + (2 * S + ln) * C * 2 * TILE + slots * BWD_CHUNK + HIDDEN * HEAD_DIM * 2
            + TILE * 136 * 4 + TILE * 72 * 4 + 4 * 128 * 4 + 2 * TILE * 4
            + ((2 * C * HIDDEN + 3 * C + HIDDEN * HEAD_DIM) * 4 if acc else 0)
            + (2 * S + 2 * slots) * 8)


def _kv2_smem(C: int, S: int, slots: int, acc: bool, ln: bool) -> int:
    return (1024 + (2 * S + ln) * C * 2 * TILE + slots * BWD_CHUNK + HEADS * HEAD_DIM * 36 * 4
            + TILE * 136 * 4 + 2 * TILE * 4 + 3 * HIDDEN * 4
            + ((2 * HIDDEN * C + C) * 4 if acc else 0) + (2 * S + 2 * slots) * 8)


def _bwdq_smem_f32(C: int, acc: bool) -> int:
    """The first bodies' shared memory (bwdq_smem in the source)."""
    a = _align128
    return (a(C * 40 * 2) + a(32 * 136 * 4) + a(32 * 136 * 2) + a(4096 * 2) + a(4096 * 4)
            + a(32 * 136 * 4) + a(32 * 136 * 2) + a(C * 40 * 4) + a((2 * 8 * 32 + 6 * 32 + 3 * C) * 4)
            + (2 * C * HIDDEN * 4 if acc else 0))


def _kv2_smem_f32(C: int, acc: bool) -> int:
    """The first bodies' shared memory (kv2_smem in the source)."""
    a = _align128
    front = max(a(C * 40 * 2) + 2 * a(32 * 264 * 4), a(C * 40 * 4))
    return (front + a(4096 * 4) + a((2 * 8 * 32 + 6 * 32 + 4 * HIDDEN) * 4) + a(32 * 264 * 2)
            + a(4096 * 4) + a((HIDDEN + C) * 4) + (2 * HIDDEN * C * 4 if acc else 0))


def _bwd_pass(smem, nres: int) -> LaBwdPass:
    """The partials in shared memory where they fit (with the normalised
    tile), else in the record; weights resident with the most x stages (2,
    1), the normalised tile kept where it fits; else streamed with one stage
    and the most slots (up to 8): at least 4 beside the normalised tile, or
    at least 2 without it."""
    for acc in (True, False):
        for S in (2, 1):
            for ln in (True,) if acc else (True, False):
                if smem(S, nres, acc, ln) <= SMEM_MAX:
                    return LaBwdPass(S, nres, True, 1, 0 if acc else 1, ln, smem(S, nres, acc, ln))
    for ln, least in ((True, 4), (False, 2)):
        slots = min(8, (SMEM_MAX - smem(1, 0, False, ln)) // (BWD_CHUNK + 16))
        if slots >= least:
            break
    return LaBwdPass(1, slots, False, 1, 1, ln, smem(1, slots, False, ln))


@functools.lru_cache(maxsize=512)
def la_bwd_plan(B: int, C: int, N: int, dtype=torch.bfloat16, sms: int = SMS) -> LaBwdPlan:
    """The plan of backward passes B' and A'2.  bf16: tiles of 64 positions,
    one CTA per SM split evenly over the batch, each walking its tiles (at
    C = 512, native b2, one or two: fewer CTAs, whose records would stay in
    L2, measured slower on an H100); see :func:`_bwd_pass` for the rest.  f32:
    the first bodies, tiles of 32 positions, the partials in shared memory
    where they fit (C = 64).  Raises if no plan fits."""
    if dtype == torch.float32:
        nt = -(-N // F32_TILE)
        ctas = max(1, min(nt, sms // B))
        passes = []
        for smem in (_bwdq_smem_f32, _kv2_smem_f32):
            acc = smem(C, True) <= SMEM_MAX
            passes.append(LaBwdPass(0, 0, False, 2, 0 if acc else 1, False, smem(C, acc)))
        return LaBwdPlan(F32_TILE, ctas, *passes)
    nt = -(-N // TILE)
    nq = -(-C // 64)
    q = _bwd_pass(lambda S, k, acc, ln: _bwdq_smem(C, S, k, acc, ln), 2 * nq)
    kv2 = _bwd_pass(lambda S, k, acc, ln: _kv2_smem(C, S, k, acc, ln), 2 * nq)
    if min(q.slots, kv2.slots) < 2:
        raise ValueError(f"no backward plan fits C={C}: {q} {kv2}")
    return LaBwdPlan(TILE, max(1, min(nt, sms // B)), q, kv2)


def _ln_fwd(xt):
    """(xhat, rstd) of the bias-free LayerNorm over the last axis, float32."""
    x32 = xt.float()
    mean = x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(x32.var(dim=-1, unbiased=False, keepdim=True) + EPS)
    return (x32 - mean) * rstd, rstd


def ln32(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Bias-free LayerNorm over the last axis, in float32 (JAX ``_ln32``)."""
    return _ln_fwd(x)[0] * g


def block_plain(x, g_pre, w_qkv, w_out, b_out, g_post, heads: int = 4,
                dim: int = HEAD_DIM, compute_dtype=None) -> torch.Tensor:
    """The block as a PyTorch composition, on x (B, C, N)."""
    cdt = x.dtype if compute_dtype is None else compute_dtype
    xt = x.transpose(1, 2)
    h = ln32(xt, g_pre).to(cdt)
    qkv = (h @ w_qkv.to(cdt).t()).to(cdt)
    mid = linear_attention_middle(qkv, heads, dim)
    o = mid.to(cdt) @ w_out.to(cdt).t() + b_out.to(cdt)
    o = ln32(o, g_post)
    return (xt + o.to(x.dtype)).transpose(1, 2)


def _mm(a, w, cdt):
    """a @ w.T with operands rounded to ``cdt`` and a float32 sum."""
    return a.to(cdt).float() @ w.to(cdt).float().t()


def ctx_plain(x, g_pre, w_kv, compute_dtype=torch.bfloat16):
    """Plain version of the context pass (JAX ``_ctx_kernel``): ctx
    (B, heads, 32, 32), m and s (B, heads*32), float32.  The projection takes
    operands in ``compute_dtype`` with float32 accumulation, as the kernel."""
    B, C, N = x.shape
    kv = _mm(ln32(x.transpose(1, 2), g_pre), w_kv, compute_dtype)
    k, v = kv[..., :HIDDEN], kv[..., HIDDEN:]
    m = k.amax(dim=1)
    e = torch.exp(k - m[:, None])
    s = e.sum(dim=1)
    heads = HIDDEN // HEAD_DIM
    k4 = (e / s[:, None]).view(B, N, heads, HEAD_DIM)
    ctx = torch.einsum("bnhd,bnhe->bhde", k4, v.view(B, N, heads, HEAD_DIM))
    return ctx, m, s


def out_plain(x, g_pre, w_q, ctx, w_out, b_out, g_post, compute_dtype=torch.bfloat16):
    """Plain version of the output pass (JAX ``_out_kernel``): y (B, C, N)."""
    B, C, N = x.shape
    cdt = compute_dtype
    xt = x.transpose(1, 2)
    q = _mm(ln32(xt, g_pre), w_q, cdt)
    heads = HIDDEN // HEAD_DIM
    q = torch.softmax(q.view(B, N, heads, HEAD_DIM), dim=-1) * HEAD_DIM ** -0.5
    attn = torch.einsum("bnhd,bhde->bnhe", q.to(cdt).float(),
                        (ctx / N).to(cdt).float()).reshape(B, N, HIDDEN)
    o = _mm(attn, w_out, cdt) + b_out
    y = xt.float() + ln32(o, g_post)
    return y.to(x.dtype).transpose(1, 2)


def _ln_bwd_dx(dout_g, xhat, rstd):
    """dx of xhat * g given dout_g = dout * g (JAX ``_ln_bwd_dx``)."""
    m1 = dout_g.mean(dim=-1, keepdim=True)
    m2 = (dout_g * xhat).mean(dim=-1, keepdim=True)
    return (dout_g - m1 - xhat * m2) * rstd


def _heads(t):
    """(B, N, HIDDEN) -> (B, N, heads, dim)."""
    return t.view(*t.shape[:-1], HEADS, HEAD_DIM)


def bwd_q_plain(x, dy, g_pre, w_q, ctx, w_out, b_out, g_post, compute_dtype=torch.bfloat16):
    """Plain version of pass B' (JAX ``_bwd_q_kernel``) on x, dy (B, C, N):
    (dxq (B, C, N) in x.dtype with the residual dy, dctx (B, heads, 32, 32)
    = the cotangent of ctx / N, dW_q (128, C), dW_out (C, 128), db_out,
    dg_pre (the q path's part), dg_post), float32 but dxq.  The products
    that JAX takes on ``compute_dtype`` operands round them so; the others
    (dctx, dq', the weight gradients) are float32."""
    B, C, N = x.shape
    cdt = compute_dtype
    xhat, rstd = _ln_fwd(x.transpose(1, 2))
    dyt = dy.transpose(1, 2).float()
    ln = (xhat * g_pre).to(cdt).float()
    sq = torch.softmax(_heads(_mm(ln, w_q, cdt)), dim=-1)
    qp = sq * Q_SCALE
    ctxn = ctx.float() / N
    attn = torch.einsum("bnhd,bhde->bnhe", qp.to(cdt).float(), ctxn.to(cdt).float())
    attn = attn.reshape(B, N, HIDDEN)
    ohat, rstd_o = _ln_fwd(_mm(attn, w_out, cdt) + b_out)
    dg_post = (dyt * ohat).sum(dim=(0, 1))
    do = _ln_bwd_dx(dyt * g_post, ohat, rstd_o)
    db_out = do.sum(dim=(0, 1))
    dw_out = torch.einsum("bnc,bnj->cj", do, attn)
    dattn = _heads(do.to(cdt).float() @ w_out.to(cdt).float())
    dctx = torch.einsum("bnhd,bnhe->bhde", qp, dattn)
    t = torch.einsum("bnhe,bhde->bnhd", dattn, ctxn) * Q_SCALE
    dq = (sq * (t - (sq * t).sum(dim=-1, keepdim=True))).reshape(B, N, HIDDEN)
    dw_q = torch.einsum("bnj,bnc->jc", dq, ln)
    dln = dq.to(cdt).float() @ w_q.to(cdt).float()
    dg_pre = (dln * xhat).sum(dim=(0, 1))
    dxq = (dyt + _ln_bwd_dx(dln * g_pre, xhat, rstd)).to(x.dtype).transpose(1, 2)
    return dxq, dctx, dw_q, dw_out, db_out, dg_pre, dg_post


def _kv_recompute(x, g_pre, w_kv, m, s, cdt):
    """The A' passes' recompute: (xhat, rstd, ln, k' (B, N, heads, dim), v)."""
    xhat, rstd = _ln_fwd(x.transpose(1, 2))
    ln = (xhat * g_pre).to(cdt).float()
    kv = _mm(ln, w_kv, cdt)
    kp = torch.exp(kv[..., :HIDDEN] - m[:, None]) / s[:, None]
    return xhat, rstd, ln, _heads(kp), _heads(kv[..., HIDDEN:])


def bwd_kv1_plain(x, g_pre, w_kv, m, s, dctx, compute_dtype=torch.bfloat16):
    """Plain version of pass A'1 (JAX ``_bwd_kv1_kernel``): sdot (B, 128) =
    sum_n k' dk' with dk' = (v / N) dctx^T per head."""
    N = x.shape[2]
    _, _, _, kp, v = _kv_recompute(x, g_pre, w_kv, m, s, compute_dtype)
    dkp = torch.einsum("bnhe,bhde->bnhd", v / N, dctx)
    return (kp * dkp).sum(dim=1).reshape(x.shape[0], HIDDEN)


def bwd_kv2_plain(x, g_pre, w_kv, m, s, dctx, sdot, dxq, compute_dtype=torch.bfloat16):
    """Plain version of pass A'2 (JAX ``_bwd_kv2_kernel``) and the sum of the
    two dx: (dx = dxq + dx_kv (B, C, N) in x.dtype, dW_kv (256, C), dg_pre
    (the k/v path's part))."""
    B, C, N = x.shape
    cdt = compute_dtype
    xhat, rstd, ln, kp, v = _kv_recompute(x, g_pre, w_kv, m, s, cdt)
    dkp = torch.einsum("bnhe,bhde->bnhd", v / N, dctx)
    dk = kp * (dkp - _heads(sdot)[:, None])
    dv = torch.einsum("bnhd,bhde->bnhe", kp, dctx) / N
    dkv = torch.cat([dk.reshape(B, N, HIDDEN), dv.reshape(B, N, HIDDEN)], dim=-1)
    dw_kv = torch.einsum("bnj,bnc->jc", dkv, ln)
    dln = dkv.to(cdt).float() @ w_kv.to(cdt).float()
    dg_pre = (dln * xhat).sum(dim=(0, 1))
    dxkv = _ln_bwd_dx(dln * g_pre, xhat, rstd).to(x.dtype).transpose(1, 2)
    return (dxq.float() + dxkv.float()).to(x.dtype), dw_kv, dg_pre


# ------------------------------------------------------------ CUDA kernels
def _lib():
    from ..kernels import build

    lib = build.load("linear_attention")
    if not getattr(lib, "_ofd_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ofd_la_ctx.argtypes = [vp, i, i, vp, vp, vp, vp, vp, vp,
                                   i, i, i, i, i, i, i, i, i, vp]
        lib.ofd_la_ctx.restype = i
        lib.ofd_la_out.argtypes = [vp, i, i, vp, vp, vp, vp, vp, vp, vp,
                                   i, i, i, i, i, i, i, i, i, i, vp]
        lib.ofd_la_out.restype = i
        lib.ofd_la_bwd_record.argtypes = [i, i]
        lib.ofd_la_bwd_record.restype = ctypes.c_longlong
        lib.ofd_la_bwd_q.argtypes = [vp, vp, i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                     i, i, i, i, i, i, i, i, i, i, i, vp]
        lib.ofd_la_bwd_q.restype = i
        lib.ofd_la_bwd_kv1.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.ofd_la_bwd_kv1.restype = i
        lib.ofd_la_bwd_kv2.argtypes = [vp, i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                       i, i, i, i, i, i, i, i, i, i, i, vp]
        lib.ofd_la_bwd_kv2.restype = i
        lib.ofd_cuda_error_string.argtypes = [i]
        lib.ofd_cuda_error_string.restype = ctypes.c_char_p
        lib._ofd_typed = True
    return lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_x(x):
    if not x.is_cuda:
        raise ValueError("the linear-attention kernels take CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, C, N) tensor")
    B, C, N = x.shape
    # 512: the flagship's widest block, and what the backward passes'
    # shared-memory tiles hold (kernels/linear_attention.cu, "Width")
    if C % 16 or not 16 <= C <= 512 or N < 1:
        raise ValueError(f"the kernels take 16 <= C <= 512 with C % 16 == 0 "
                         f"and N >= 1, got C={C}, N={N}")
    return B, C, N


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.ofd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


_sms = {}


def _sm_count(device) -> int:
    sms = _sms.get(device.index)
    if sms is None:
        sms = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def _plan(x):
    return la_plan(*x.shape, x.dtype, _sm_count(x.device))


def _bwd_plan(x):
    return la_bwd_plan(*x.shape, x.dtype, _sm_count(x.device))


def _tma_rows(x):
    """(x, ld): the bf16 kernels' tensor maps need rows of a multiple of 8
    elements and a 16-byte aligned base; other x is copied once into a
    zero-padded (B, C, ld) buffer (positions past N are ignored)."""
    N = x.shape[2]
    if x.dtype != torch.bfloat16 or (N % 8 == 0 and x.data_ptr() % 16 == 0):
        return x, N
    ld = -(-N // 8) * 8
    return F.pad(x, (0, ld - N)), ld


def linear_attention_ctx(x, g_pre, w_kv):
    """Context pass: ctx (B, 4, 32, 32), m and s (B, 128), all float32.

    ``w_kv`` is ``W_qkv[128:]`` in bf16, (256, C)."""
    B, C, N = _check_x(x)
    dev = x.device
    _check("g_pre", g_pre, (C,), torch.float32, dev)
    _check("w_kv", w_kv, (2 * HIDDEN, C), torch.bfloat16, dev)
    plan = _plan(x)
    pa = plan.ctx
    xk, ld = _tma_rows(x)
    part = torch.empty(B, plan.partials, 2 * HIDDEN + HIDDEN * HEAD_DIM, device=dev)
    ctx = torch.empty(B, HIDDEN // HEAD_DIM, HEAD_DIM, HEAD_DIM, device=dev)
    m = torch.empty(B, HIDDEN, device=dev)
    s = torch.empty(B, HIDDEN, device=dev)
    lib = _lib()
    err = lib.ofd_la_ctx(
        xk.data_ptr(), int(x.dtype == torch.bfloat16), ld, g_pre.data_ptr(),
        w_kv.data_ptr(), part.data_ptr(), ctx.data_ptr(), m.data_ptr(), s.data_ptr(),
        B, C, N, pa.ctas, pa.stages, pa.slots, int(pa.resident), pa.smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, LA_CTX.name)
    LA_CTX.launches += 1
    return ctx, m, s


def linear_attention_out(x, g_pre, w_q, ctx, w_out, b_out, g_post):
    """Output pass: y (B, C, N) in x.dtype.  ``w_q`` is ``W_qkv[:128]`` in
    bf16, (128, C); ``w_out`` bf16 (C, 128); ctx from the context pass."""
    B, C, N = _check_x(x)
    dev = x.device
    _check("g_pre", g_pre, (C,), torch.float32, dev)
    _check("w_q", w_q, (HIDDEN, C), torch.bfloat16, dev)
    _check("ctx", ctx, (B, HIDDEN // HEAD_DIM, HEAD_DIM, HEAD_DIM), torch.float32, dev)
    _check("w_out", w_out, (C, HIDDEN), torch.bfloat16, dev)
    _check("b_out", b_out, (C,), torch.float32, dev)
    _check("g_post", g_post, (C,), torch.float32, dev)
    pb = _plan(x).out
    xk, ld = _tma_rows(x)
    y = torch.empty_like(xk)
    lib = _lib()
    err = lib.ofd_la_out(
        xk.data_ptr(), int(x.dtype == torch.bfloat16), ld, g_pre.data_ptr(),
        w_q.data_ptr(), ctx.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        g_post.data_ptr(), y.data_ptr(), B, C, N, pb.ctas, pb.stages, pb.slots,
        int(pb.resident), pb.consumers, pb.smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, LA_OUT.name)
    LA_OUT.launches += 1
    return y if ld == N else y[..., :N].contiguous()


def _bwd_partitions(B: int, ntiles: int, device) -> int:
    """CTAs per batch element for pass A'1: one wave over the SMs (a CTA
    fills an SM's shared memory)."""
    return max(1, min(ntiles, _sm_count(device) // B))


def _part(lib, which, B, P, C, device):
    return torch.empty(B * P * lib.ofd_la_bwd_record(which, C), device=device)


def linear_attention_bwd_q(x, dy, g_pre, w_q, ctx, w_out, b_out, g_post):
    """Pass B' kernel: (dxq, dctx, dW_q, dW_out, db_out, dg_pre, dg_post) as
    :func:`bwd_q_plain`.  ``w_q`` (128, C) and ``w_out`` (C, 128) in bf16."""
    B, C, N = _check_x(x)
    dev = x.device
    _check("dy", dy, (B, C, N), x.dtype, dev)
    _check("g_pre", g_pre, (C,), torch.float32, dev)
    _check("w_q", w_q, (HIDDEN, C), torch.bfloat16, dev)
    _check("ctx", ctx, (B, HEADS, HEAD_DIM, HEAD_DIM), torch.float32, dev)
    _check("w_out", w_out, (C, HIDDEN), torch.bfloat16, dev)
    _check("b_out", b_out, (C,), torch.float32, dev)
    _check("g_post", g_post, (C,), torch.float32, dev)
    lib = _lib()
    plan = _bwd_plan(x)
    P, pq = plan.ctas, plan.q
    part = _part(lib, 0, B, P, C, dev)
    xk, ld = _tma_rows(x)
    dyk = _tma_rows(dy)[0]
    dxq = torch.empty_like(xk)
    out_w = torch.empty(2 * C * HIDDEN + 3 * C, device=dev)
    dctx = torch.empty(B, HEADS, HEAD_DIM, HEAD_DIM, device=dev)
    err = lib.ofd_la_bwd_q(
        xk.data_ptr(), dyk.data_ptr(), int(x.dtype == torch.bfloat16), ld, g_pre.data_ptr(),
        w_q.data_ptr(), ctx.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), g_post.data_ptr(),
        dxq.data_ptr(), part.data_ptr(), out_w.data_ptr(), dctx.data_ptr(), B, C, N, P,
        pq.stages, pq.slots, int(pq.resident), pq.flush, int(pq.ln_tile), pq.smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, LA_BWD_Q.name)
    LA_BWD_Q.launches += 1
    dw_out, dw_q, rest = out_w.split([C * HIDDEN, C * HIDDEN, 3 * C])
    db_out, dg_pre, dg_post = rest.split(C)
    if ld != N:
        dxq = dxq[..., :N].contiguous()
    return (dxq, dctx, dw_q.view(HIDDEN, C), dw_out.view(C, HIDDEN), db_out, dg_pre,
            dg_post)


def linear_attention_bwd_kv1(x, g_pre, w_kv, m, s, dctx):
    """Pass A'1 kernel: sdot (B, 128) as :func:`bwd_kv1_plain`."""
    B, C, N = _check_x(x)
    dev = x.device
    _check("g_pre", g_pre, (C,), torch.float32, dev)
    _check("w_kv", w_kv, (2 * HIDDEN, C), torch.bfloat16, dev)
    for name, t in (("m", m), ("s", s)):
        _check(name, t, (B, HIDDEN), torch.float32, dev)
    _check("dctx", dctx, (B, HEADS, HEAD_DIM, HEAD_DIM), torch.float32, dev)
    lib = _lib()
    P = _bwd_partitions(B, -(-N // 32), dev)
    part = _part(lib, 1, B, P, C, dev)
    sdot = torch.empty(B, HIDDEN, device=dev)
    err = lib.ofd_la_bwd_kv1(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g_pre.data_ptr(), w_kv.data_ptr(),
        m.data_ptr(), s.data_ptr(), dctx.data_ptr(), part.data_ptr(), sdot.data_ptr(),
        B, C, N, P, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, LA_BWD_KV1.name)
    LA_BWD_KV1.launches += 1
    return sdot


def linear_attention_bwd_kv2(x, g_pre, w_kv, m, s, dctx, sdot, dxq):
    """Pass A'2 kernel: (dx = dxq + dx_kv, dW_kv (256, C), dg_pre) as
    :func:`bwd_kv2_plain`."""
    B, C, N = _check_x(x)
    dev = x.device
    _check("g_pre", g_pre, (C,), torch.float32, dev)
    _check("w_kv", w_kv, (2 * HIDDEN, C), torch.bfloat16, dev)
    for name, t in (("m", m), ("s", s), ("sdot", sdot)):
        _check(name, t, (B, HIDDEN), torch.float32, dev)
    _check("dctx", dctx, (B, HEADS, HEAD_DIM, HEAD_DIM), torch.float32, dev)
    _check("dxq", dxq, (B, C, N), x.dtype, dev)
    lib = _lib()
    plan = _bwd_plan(x)
    P, pk = plan.ctas, plan.kv2
    part = _part(lib, 2, B, P, C, dev)
    xk, ld = _tma_rows(x)
    dxqk = _tma_rows(dxq)[0]
    dx = torch.empty_like(xk)
    out_w = torch.empty(2 * HIDDEN * C + C, device=dev)
    err = lib.ofd_la_bwd_kv2(
        xk.data_ptr(), int(x.dtype == torch.bfloat16), ld, g_pre.data_ptr(), w_kv.data_ptr(),
        m.data_ptr(), s.data_ptr(), dctx.data_ptr(), sdot.data_ptr(), dxqk.data_ptr(),
        dx.data_ptr(), part.data_ptr(), out_w.data_ptr(), B, C, N, P, pk.stages, pk.slots,
        int(pk.resident), pk.flush, int(pk.ln_tile), pk.smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, LA_BWD_KV2.name)
    LA_BWD_KV2.launches += 1
    dw_kv, dg_pre = out_w.split([2 * HIDDEN * C, C])
    if ld != N:
        dx = dx[..., :N].contiguous()
    return dx, dw_kv.view(2 * HIDDEN, C), dg_pre


def fused_block_bwd(x, dy, g_pre, w_qkv, w_out, b_out, g_post, ctx, m, s):
    """The three backward kernels in order (JAX ``_fused_block_bwd_pallas``):
    gradients of (x, g_pre, w_qkv, w_out, b_out, g_post), float32 but dx."""
    w16 = w_qkv.to(torch.bfloat16).contiguous()
    w_q, w_kv = w16[:HIDDEN], w16[HIDDEN:]
    g32 = g_pre.float().contiguous()
    dxq, dctx, dw_q, dw_out, db_out, dg_pre_q, dg_post = linear_attention_bwd_q(
        x, dy.to(x.dtype).contiguous(), g32, w_q, ctx,
        w_out.to(torch.bfloat16).contiguous(), b_out.float().contiguous(),
        g_post.float().contiguous())
    sdot = linear_attention_bwd_kv1(x, g32, w_kv, m, s, dctx)
    dx, dw_kv, dg_pre_kv = linear_attention_bwd_kv2(x, g32, w_kv, m, s, dctx, sdot, dxq)
    return dx, dg_pre_q + dg_pre_kv, torch.cat([dw_q, dw_kv]), dw_out, db_out, dg_post


def _forward(x, g_pre, w_qkv, w_out, b_out, g_post):
    """The two forward kernels: (y, ctx, m, s)."""
    w16 = w_qkv.to(torch.bfloat16).contiguous()
    g_pre32 = g_pre.float().contiguous()
    c, m, s = linear_attention_ctx(x, g_pre32, w16[HIDDEN:])
    y = linear_attention_out(
        x, g_pre32, w16[:HIDDEN], c, w_out.to(torch.bfloat16).contiguous(),
        b_out.float().contiguous(), g_post.float().contiguous(),
    )
    return y, c, m, s


class _FusedBlock(torch.autograd.Function):
    """The block on the CUDA kernels with a gradient, with JAX's
    forward/backward dispatch: the backward kernels at N >= 1024, the
    composition's autograd below."""

    @staticmethod
    def forward(ctx, x, g_pre, w_qkv, w_out, b_out, g_post):
        fused_bwd = x.shape[2] >= BWD_MIN_N
        y, c, m, s = _forward(x, g_pre, w_qkv, w_out, b_out, g_post)
        saved = (c, m, s) if fused_bwd else ()
        ctx.save_for_backward(x, g_pre, w_qkv, w_out, b_out, g_post, *saved)
        ctx.fused_bwd = fused_bwd
        return y

    @staticmethod
    def backward(ctx, dy):
        # one read of saved_tensors: under torch.utils.checkpoint (remat) a
        # second read is refused
        x, *params = ctx.saved_tensors
        params, stats = params[:5], params[5:]
        if ctx.fused_bwd:
            grads = fused_block_bwd(x, dy, *params, *stats)
            return tuple(g.to(t.dtype) for g, t in zip(grads, (x, *params)))
        inputs = [t.detach().requires_grad_() for t in (x, *params)]
        with torch.enable_grad():
            y = block_plain(*inputs)
        return torch.autograd.grad(y, inputs, dy)


def fused_linear_attention_block(x, g_pre, w_qkv, w_out, b_out, g_post,
                                 heads: int = 4, dim: int = HEAD_DIM) -> torch.Tensor:
    """y = x + postLN(W_out @ middle(W_qkv @ preLN(x)) + b) on x (B, C, N).

    CUDA tensors go through the forward kernels, and when a gradient is
    asked for at N >= 1024 through the backward ones too (all of them take
    16 <= C <= 512, C % 16 == 0, and refuse any other C); CPU tensors
    through :func:`block_plain`."""
    if x.device.type == "cpu":
        return block_plain(x, g_pre, w_qkv, w_out, b_out, g_post, heads, dim)
    if heads * dim != HIDDEN or dim != HEAD_DIM:
        raise ValueError(f"the kernels take 4 heads of 32, got {heads} of {dim}")
    args = (x, g_pre, w_qkv, w_out, b_out, g_post)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedBlock.apply(*args)
    return _forward(*args)[0]


__all__ = [
    "block_plain", "bwd_kv1_plain", "bwd_kv2_plain", "bwd_q_plain", "ctx_plain",
    "fused_block_bwd", "fused_linear_attention_block", "la_bwd_plan", "la_plan",
    "linear_attention_bwd_kv1",
    "linear_attention_bwd_kv2", "linear_attention_bwd_q", "linear_attention_ctx",
    "linear_attention_middle", "linear_attention_out", "ln32", "out_plain",
]
