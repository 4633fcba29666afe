"""Fused pre-LN linear-attention block (JAX ``ops/attention_fused.py``).

    y = x + postLN(W_out @ middle(W_qkv @ preLN(x)) + b_out)

on ``x`` of shape (B, C, N), the flattened NCHW map.  Weights are in the
torch layout: ``w_qkv`` (3*heads*dim, C), ``w_out`` (C, heads*dim).

* :func:`block_plain` is the plain-PyTorch composition, the counterpart of
  JAX's ``_block_xla`` (with ``_ln32`` and
  ``attention_pallas.py::_linear_attention_middle_xla``): operands in the
  compute dtype, LayerNorms and softmaxes in float32.
* :func:`fused_linear_attention_block` runs the two CUDA kernels of
  ``kernels/linear_attention.cu`` (context pass, output pass) on a CUDA
  tensor, and :func:`block_plain` in ``x.dtype`` on a CPU tensor.  There is
  no other switch and no fallback: a kernel that cannot be built or launched
  raises.  Like the TPU kernels, the CUDA kernels use bf16 matmul operands
  with float32 accumulation even when ``x`` is float32.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import LA_CTX, LA_OUT

EPS = 1e-5
HEAD_DIM = 32
HIDDEN = 128  # heads * dim_head, the only width the kernels take


def ln32(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Bias-free LayerNorm over the last axis, in float32 (JAX ``_ln32``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + EPS) * g


def linear_attention_middle(qkv: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """softmax/context/out middle on packed qkv (B, N, 3*heads*dim) (JAX
    ``_linear_attention_middle_xla``)."""
    B, N, _ = qkv.shape
    qkv = qkv.view(B, N, 3, heads, dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = torch.softmax(q.float(), dim=-1).to(qkv.dtype)
    k = torch.softmax(k.float(), dim=1).to(qkv.dtype)
    q = q * dim ** -0.5
    v = v / N
    ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
    out = torch.einsum("bhde,bnhd->bnhe", ctx, q)
    return out.reshape(B, N, heads * dim)


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


# ------------------------------------------------------------ CUDA kernels
def _lib():
    from ..kernels import build

    lib = build.load("linear_attention")
    if not getattr(lib, "_ofd_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ofd_la_ctx.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, vp,
                                   i, i, i, i, i, vp]
        lib.ofd_la_ctx.restype = i
        lib.ofd_la_out.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, vp,
                                   i, i, i, i, vp]
        lib.ofd_la_out.restype = i
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
    if C % 16 or not 16 <= C <= 512 or N < 1:
        raise ValueError(f"the kernels take 16 <= C <= 512 with C % 16 == 0 "
                         f"and N >= 1, got C={C}, N={N}")
    return B, C, N


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.ofd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _ctx_partitions(B: int, ntiles: int, device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(ntiles, -(-2 * sms // B)))


def linear_attention_ctx(x, g_pre, w_kv):
    """Context pass: ctx (B, 4, 32, 32), m and s (B, 128), all float32.

    ``w_kv`` is ``W_qkv[128:]`` in bf16, (256, C)."""
    B, C, N = _check_x(x)
    dev = x.device
    _check("g_pre", g_pre, (C,), torch.float32, dev)
    _check("w_kv", w_kv, (2 * HIDDEN, C), torch.bfloat16, dev)
    P = _ctx_partitions(B, -(-N // 32), dev)
    part = torch.empty(B, P, 2 * HIDDEN + HIDDEN * HEAD_DIM, device=dev)
    counter = torch.zeros(B, dtype=torch.int32, device=dev)
    ctx = torch.empty(B, HIDDEN // HEAD_DIM, HEAD_DIM, HEAD_DIM, device=dev)
    m = torch.empty(B, HIDDEN, device=dev)
    s = torch.empty(B, HIDDEN, device=dev)
    lib = _lib()
    err = lib.ofd_la_ctx(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g_pre.data_ptr(),
        w_kv.data_ptr(), part.data_ptr(), counter.data_ptr(), ctx.data_ptr(),
        m.data_ptr(), s.data_ptr(), B, C, N, P, dev.index,
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
    y = torch.empty_like(x)
    lib = _lib()
    err = lib.ofd_la_out(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g_pre.data_ptr(),
        w_q.data_ptr(), ctx.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        g_post.data_ptr(), y.data_ptr(), B, C, N, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, LA_OUT.name)
    LA_OUT.launches += 1
    return y


def fused_linear_attention_block(x, g_pre, w_qkv, w_out, b_out, g_post,
                                 heads: int = 4, dim: int = HEAD_DIM) -> torch.Tensor:
    """y = x + postLN(W_out @ middle(W_qkv @ preLN(x)) + b) on x (B, C, N).

    CUDA tensors go through the two kernels, CPU tensors through
    :func:`block_plain`.  Forward only: the backward kernels come with
    training, so a request for a gradient on the kernel path raises.
    """
    if x.device.type == "cpu":
        return block_plain(x, g_pre, w_qkv, w_out, b_out, g_post, heads, dim)
    if heads * dim != HIDDEN or dim != HEAD_DIM:
        raise ValueError(f"the kernels take 4 heads of 32, got {heads} of {dim}")
    params = (g_pre, w_qkv, w_out, b_out, g_post)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise RuntimeError(
            "the linear-attention kernels are forward only; run under torch.no_grad()"
        )
    w_qkv16 = w_qkv.to(torch.bfloat16).contiguous()
    g_pre32 = g_pre.float().contiguous()
    ctx, _, _ = linear_attention_ctx(x, g_pre32, w_qkv16[HIDDEN:])
    return linear_attention_out(
        x, g_pre32, w_qkv16[:HIDDEN], ctx, w_out.to(torch.bfloat16).contiguous(),
        b_out.float().contiguous(), g_post.float().contiguous(),
    )


__all__ = [
    "block_plain", "fused_linear_attention_block", "linear_attention_ctx",
    "linear_attention_out", "linear_attention_middle", "ln32",
]
