"""The unfused linear-attention middle (JAX ``ops/attention_pallas.py``).

On packed qkv (B, N, 3 * heads * dim) (channel s * heads * dim + h * dim +
d), per head:

    q' = softmax_d(q) * dim^-0.5,  k' = softmax_N(k),
    ctx = sum_n k'[n] (x) v[n] / N,  out[n] = ctx^T q'[n]   -> (B, N, heads * dim)

* :func:`linear_attention_middle_plain` is the composition, the counterpart
  of JAX's ``_linear_attention_middle_xla``: softmaxes in float32, their
  results and the einsums in qkv's dtype.
* :func:`middle_ctx_plain` and :func:`middle_out_plain` are the plain
  versions of the two kernels, with the TPU kernels' numerics: float32
  softmaxes, sums and products on qkv's values, the context per head, ctx /
  N folded into the second pass, the output rounded once to qkv's dtype.
* :func:`middle_ctx` and :func:`middle_out` launch the CUDA kernels of
  ``kernels/linear_attention.cu`` (``la_mid_ctx_kernel``,
  ``la_mid_out_kernel``; heads * dim = 4 * 32, bf16 or f32) on a CUDA
  tensor and run the plain versions on a CPU tensor.
* :func:`linear_attention_middle` is the middle with JAX's two settings of
  ``OFD_ATTN_BACKEND``: ``backend="composition"`` (JAX's ``xla``, the
  default) or ``"kernels"`` (JAX's ``pallas``), an autograd Function whose
  forward is the two kernels and whose backward is autograd of the
  composition, recomputed from the saved qkv (JAX's ``_fwd``/``_bwd``).

Layout: the kernels read qkv as (B, 3 * 128, N) with N fastest, which is how
the 1x1 conv ``to_qkv`` lays it out; the public functions take JAX's (B, N,
3 * 128), so the module passes a transposed view and nothing is copied.  A
tensor in another layout is copied into it first, and each pass copies the
rows it reads (k and v, or q) once more into a zero-padded buffer where its
tensor map cannot read them in place (rows or batch stride no multiple of 16
bytes).  ``middle_out`` returns a (B, N, 128) view of a contiguous (B, 128,
N) tensor, which the module's ``to_out`` reads as NCHW with no copy; where a
row of N values is no multiple of 16 bytes, pass B writes a padded buffer
and the wrapper copies it into that tensor once.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import LA_MID_CTX, LA_MID_OUT

HEAD_DIM = 32
HIDDEN = 128  # heads * dim, the only width the kernels take
HEADS = HIDDEN // HEAD_DIM
PART = 2 * HIDDEN + HEADS * HEAD_DIM * HEAD_DIM  # one partial of a context pass: m, s, ctx
BACKENDS = ("composition", "kernels")


def linear_attention_middle_plain(qkv: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """The composition (JAX ``_linear_attention_middle_xla``), (B, N, heads * dim)."""
    B, N, _ = qkv.shape
    qkv = qkv.reshape(B, N, 3, heads, dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = torch.softmax(q.float(), dim=-1).to(qkv.dtype)
    k = torch.softmax(k.float(), dim=1).to(qkv.dtype)
    q = q * dim ** -0.5
    v = v / N
    ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
    out = torch.einsum("bhde,bnhd->bnhe", ctx, q)
    return out.reshape(B, N, heads * dim)


def middle_ctx_plain(qkv: torch.Tensor, heads: int = HEADS, dim: int = HEAD_DIM) -> torch.Tensor:
    """Plain version of pass A (JAX ``_ctx_kernel``): ctx (B, heads, dim,
    dim) = sum_n exp(k - m) (x) v / s per channel, float32."""
    B, N, _ = qkv.shape
    hd = heads * dim
    k = qkv[..., hd:2 * hd].float()
    v = qkv[..., 2 * hd:].float().reshape(B, N, heads, dim)
    e = torch.exp(k - k.amax(dim=1, keepdim=True))
    s = e.sum(dim=1).reshape(B, heads, dim, 1)
    return torch.einsum("bnhd,bnhe->bhde", e.reshape(B, N, heads, dim), v) / s


def middle_out_plain(qkv: torch.Tensor, ctx: torch.Tensor, heads: int = HEADS,
                     dim: int = HEAD_DIM) -> torch.Tensor:
    """Plain version of pass B (JAX ``_out_kernel``): softmax_d(q) * dim^-0.5
    times ctx / N, float32, rounded once to qkv's dtype, (B, N, heads * dim)."""
    B, N, _ = qkv.shape
    q = qkv[..., :heads * dim].float().reshape(B, N, heads, dim)
    qp = torch.softmax(q, dim=-1) * dim ** -0.5
    out = torch.einsum("bnhd,bhde->bnhe", qp, ctx / N)
    return out.reshape(B, N, heads * dim).to(qkv.dtype)


# ------------------------------------------------------------ CUDA kernels
def _lib():
    from ..kernels import build

    lib = build.load("linear_attention")
    if not getattr(lib, "_ofd_mid_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ofd_la_mid_ctx.argtypes = [vp, i, i, ll, vp, vp, i, i, i, i, vp]
        lib.ofd_la_mid_ctx.restype = i
        lib.ofd_la_mid_out.argtypes = [vp, i, i, ll, vp, vp, i, i, i, i, i, vp]
        lib.ofd_la_mid_out.restype = i
        lib.ofd_cuda_error_string.argtypes = [i]
        lib.ofd_cuda_error_string.restype = ctypes.c_char_p
        lib._ofd_mid_typed = True
    return lib


def mid_plan(B: int, N: int, dtype=torch.bfloat16, sms: int = 132) -> int:
    """Pass A's CTAs per batch element (``la_mid_ctx_kernel``, whose tiles
    are 128-byte rows: 64 bf16 or 32 f32 positions): two CTAs an SM split
    evenly over the batch, none without a tile."""
    tile = 32 if dtype == torch.float32 else 64
    return max(1, min(-(-N // tile), -(-2 * sms // B)))


def mid_out_plan(B: int, N: int, dtype=torch.bfloat16, sms: int = 132) -> int:
    """Pass B's CTAs per batch element (``la_mid_out_kernel``, the same
    tiles): three CTAs an SM, no more in all than fit at once (no second
    wave), none without a tile."""
    tile = 32 if dtype == torch.float32 else 64
    return max(1, min(-(-N // tile), 3 * sms // B))


def _rows(u: torch.Tensor, lo: int, n: int):
    """(rows, ld, batch stride): the channels lo .. lo + n - 1 of a (B, 384,
    N) view whose last two axes are contiguous, as the passes' tensor maps
    read them: rows of ld >= N elements, ld and the batch stride multiples
    of 16 bytes, a 16-byte aligned base.  A view that is not so is copied
    once into a zero-padded (B, n, ld) buffer (positions past N are
    ignored)."""
    B, _, N = u.shape
    q = 16 // u.element_size()
    bs = u.stride(0) if B > 1 else 3 * HIDDEN * N   # a lone batch element's stride is free
    if N % q == 0 and bs % q == 0 and u.data_ptr() % 16 == 0:
        return u[:, lo:lo + n], N, bs
    ld = -(-N // q) * q
    return F.pad(u[:, lo:lo + n], (0, ld - N)), ld, n * ld


def _out_rows(B: int, N: int, dtype, device):
    """(buffer, ldo): pass B's output (B, 128, ldo), which its tensor map
    writes in rows of a multiple of 16 bytes.  Where N values make such a
    row, ldo = N and the buffer is the contiguous output; else ldo is N
    rounded up to one and the wrapper copies the first N positions of each
    row out once."""
    q = 16 // torch.empty((), dtype=dtype).element_size()
    ldo = -(-N // q) * q
    return torch.empty(B, HIDDEN, ldo, device=device, dtype=dtype), ldo


def _channels_first(qkv: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """Checks a CUDA qkv (B, N, 3 * 128) and returns it as a (B, 384, N) view
    whose last two axes are contiguous (a copy only if it is not so)."""
    if not qkv.is_cuda:
        raise ValueError(f"the middle kernels take CUDA tensors, qkv is on {qkv.device}")
    if heads * dim != HIDDEN or dim != HEAD_DIM:
        raise ValueError(f"the middle kernels take {HEADS} heads of {HEAD_DIM}, "
                         f"got {heads} of {dim}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv must be bfloat16 or float32, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] != 3 * HIDDEN or qkv.shape[0] < 1 or qkv.shape[1] < 1:
        raise ValueError(f"qkv must be (B, N, {3 * HIDDEN}) with B, N >= 1, "
                         f"got {tuple(qkv.shape)}")
    u = qkv.transpose(1, 2)
    if u.stride()[1:] != (u.shape[2], 1):
        u = u.contiguous()
    return u


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.ofd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def middle_ctx(qkv: torch.Tensor, heads: int = HEADS, dim: int = HEAD_DIM) -> torch.Tensor:
    """Pass A: ctx (B, heads, dim, dim) float32; the kernel on a CUDA tensor,
    :func:`middle_ctx_plain` on a CPU one."""
    if qkv.device.type == "cpu":
        return middle_ctx_plain(qkv, heads, dim)
    u = _channels_first(qkv, heads, dim)
    B, _, N = u.shape
    dev = u.device
    from .attention_fused import _sm_count  # attention_fused imports this module

    P = mid_plan(B, N, u.dtype, _sm_count(dev))
    kv, ld, bs = _rows(u, HIDDEN, 2 * HIDDEN)
    part = torch.empty(B, P, PART, device=dev)
    ctx = torch.empty(B, HEADS, HEAD_DIM, HEAD_DIM, device=dev)
    lib = _lib()
    err = lib.ofd_la_mid_ctx(
        kv.data_ptr(), int(u.dtype == torch.bfloat16), ld, bs, part.data_ptr(),
        ctx.data_ptr(), B, N, P, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, LA_MID_CTX.name)
    LA_MID_CTX.launches += 1
    return ctx


def middle_out(qkv: torch.Tensor, ctx: torch.Tensor, heads: int = HEADS,
               dim: int = HEAD_DIM) -> torch.Tensor:
    """Pass B: (B, N, heads * dim) in qkv's dtype; the kernel on a CUDA
    tensor (a view of a contiguous (B, 128, N) tensor), :func:`middle_out_plain`
    on a CPU one."""
    if qkv.device.type == "cpu":
        return middle_out_plain(qkv, ctx, heads, dim)
    u = _channels_first(qkv, heads, dim)
    B, _, N = u.shape
    want = (B, HEADS, HEAD_DIM, HEAD_DIM)
    if (ctx.device != u.device or ctx.dtype != torch.float32 or tuple(ctx.shape) != want
            or not ctx.is_contiguous()):
        raise ValueError(f"ctx must be a contiguous float32 {want} tensor on {u.device}, got "
                         f"{ctx.dtype} {tuple(ctx.shape)} on {ctx.device}")
    dev = u.device
    from .attention_fused import _sm_count

    q, ld, bs = _rows(u, 0, HIDDEN)
    out, ldo = _out_rows(B, N, u.dtype, dev)
    lib = _lib()
    err = lib.ofd_la_mid_out(
        q.data_ptr(), int(u.dtype == torch.bfloat16), ld, bs, ctx.data_ptr(), out.data_ptr(),
        ldo, B, N, mid_out_plan(B, N, u.dtype, _sm_count(dev)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, LA_MID_OUT.name)
    LA_MID_OUT.launches += 1
    if ldo != N:
        out = out[..., :N].contiguous()
    return out.transpose(1, 2)


class _Middle(torch.autograd.Function):
    """The two passes forward; autograd of the composition, recomputed from
    the saved qkv, backward (JAX has no backward kernel here)."""

    @staticmethod
    def forward(ctx, qkv, heads, dim):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.dim = heads, dim
        return middle_out(qkv, middle_ctx(qkv, heads, dim), heads, dim)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        leaf = qkv.detach().requires_grad_()
        with torch.enable_grad():
            out = linear_attention_middle_plain(leaf, ctx.heads, ctx.dim)
        (d,) = torch.autograd.grad(out, leaf, g)
        return d, None, None


def linear_attention_middle(qkv: torch.Tensor, heads: int = HEADS, dim: int = HEAD_DIM,
                            backend: str = "composition") -> torch.Tensor:
    """The middle on qkv (B, N, 3 * heads * dim): the composition, or with
    ``backend="kernels"`` the two passes (kernels on a CUDA tensor, which
    take heads * dim = 128 and raise otherwise; plain versions on a CPU one)
    with the composition's gradient."""
    if backend == "composition":
        return linear_attention_middle_plain(qkv, heads, dim)
    if backend != "kernels":
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    return _Middle.apply(qkv, heads, dim)


__all__ = ["BACKENDS", "linear_attention_middle",
           "linear_attention_middle_plain", "middle_ctx", "middle_ctx_plain", "middle_out",
           "middle_out_plain", "mid_out_plan", "mid_plan"]
