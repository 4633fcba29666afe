"""Bottleneck attention middle (JAX ``ops/flash_attention.py``).

``softmax(q k^T) v`` over (B, N, heads, d) with q pre-scaled by d^-0.5.

* :func:`attention_middle_plain` is the composition, the counterpart of
  JAX's ``_attention_middle_xla``: f32 scores and softmax, the probabilities
  cast to ``v``'s dtype before ``p @ v``.
* :func:`flash_plain` is the blockwise online-softmax recurrence of the
  Pallas ``_flash_kernel`` in plain PyTorch, with its numerics: f32 scores,
  padded keys at ``-1e30``, p cast to ``v``'s dtype before ``p @ v`` with an
  f32 sum, and the division by the normaliser ``l`` at the end.
* :func:`flash_attention` launches the CUDA kernel of
  ``kernels/flash_attention.cu`` (d = 32, bf16 or f32).
* :func:`attention_middle` dispatches as the JAX package does
  (``_use_flash``): the kernel for a CUDA tensor with N >= 2048, the
  composition otherwise (and always on the CPU).  On the kernel path it is
  an autograd Function whose backward is autograd of the composition,
  recomputed from the saved q, k, v (JAX's ``_fwd``/``_bwd``; JAX has no
  backward kernel for flash).  That backward holds the (B, heads, N, N)
  float32 scores, 1.6 GB at the native b2 bottleneck (N 7168), and their
  softmax beside them.

Layout: the kernel reads q, k and v as (B, heads, d, N) with N fastest,
which is how the UNet's ``to_qkv`` output lies, (B, 3, heads, d, N): k and v
are read where they are, with no copy (the batch stride may be that of the
packed tensor), and the UNet scales q in that layout.  Tensors in another
layout are copied into it first.  The bf16 kernel reads through TMA tensor
maps, which need rows and batch strides of 16 bytes: a ragged N (or a
misaligned view) is copied once into a zero-padded buffer
(:func:`tma_ready`, :func:`_padded`).  The output is a (B, N, heads, d) view
of a contiguous (B, heads, d, N) tensor, so the UNet's ``to_out`` gets NCHW
with no copy.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import FLASH

FLASH_MIN_N = 2048
NEG_INF = -1e30
HEAD_DIM = 32  # the only head width the kernel takes


def attention_middle_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The composition (JAX ``_attention_middle_xla``), (B, N, h, d)."""
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 3, 1).float()
    p = torch.softmax(qh @ kh, dim=-1).to(v.dtype)
    out = p @ v.permute(0, 2, 1, 3)
    return out.permute(0, 2, 1, 3)


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                block_k: int = 1024) -> torch.Tensor:
    """The Pallas kernel's recurrence over key blocks of ``block_k`` (as
    there, at most the next power of two of N and at least 128), all
    queries at once; (B, N, h, d) in, (B, N, h, d) in ``v.dtype`` out."""
    B, N, h, d = q.shape
    cdt = v.dtype
    bk = min(block_k, max(128, 1 << (N - 1).bit_length()))
    nk = -(-N // bk)
    pad = nk * bk - N
    fold = lambda a: a.permute(0, 2, 1, 3).reshape(B * h, N, d).to(cdt)
    qf, kf, vf = fold(q).float(), fold(k), fold(v)
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    m = torch.full((B * h, N, 1), NEG_INF, device=q.device)
    l = torch.zeros((B * h, N, 1), device=q.device)
    acc = torch.zeros((B * h, N, d), device=q.device)
    col = torch.arange(bk, device=q.device)
    for j in range(nk):
        kb, vb = kf[:, j * bk:(j + 1) * bk], vf[:, j * bk:(j + 1) * bk]
        s = qf @ kb.float().transpose(1, 2)                   # (BH, N, bk) f32
        s = torch.where(j * bk + col < N, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=2, keepdim=True)
        acc = acc * alpha + p.to(cdt).float() @ vb.float()
        m = m_new
    out = (acc / l).to(cdt)
    return out.reshape(B, h, N, d).permute(0, 2, 1, 3)


# ------------------------------------------------------------ CUDA kernel
def _lib():
    from ..kernels import build

    lib = build.load("flash_attention")
    if not getattr(lib, "_ofd_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ofd_flash.argtypes = [vp, vp, vp, ll, ll, ll, vp, i, i, i, i, i, i, vp]
        lib.ofd_flash.restype = i
        lib.ofd_cuda_error_string.argtypes = [i]
        lib.ofd_cuda_error_string.restype = ctypes.c_char_p
        lib._ofd_typed = True
    return lib


def _hdn(t: torch.Tensor) -> torch.Tensor:
    """(B, N, h, d) -> a (B, h, d, N) view whose last three axes are
    contiguous; a copy only if ``t`` is not laid out so already."""
    u = t.permute(0, 2, 3, 1)
    _, h, d, N = u.shape
    if u.stride()[1:] != (d * N, N, 1):
        u = u.contiguous()
    return u


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's tensor maps can read the (B, h, d, N) view
    ``t`` where it lies: rows (N) and the batch stride multiples of 8
    elements (16 bytes) and a 16-byte aligned base."""
    return t.shape[-1] % 8 == 0 and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0


def _padded(*ts: torch.Tensor):
    """The (B, h, d, N) views in one zero-padded (3, B, h, d, ld) buffer, ld
    the multiple of 8 at or above N: one copy of q, k and v for the inputs
    that :func:`tma_ready` refuses (a ragged N; the kernel masks keys past
    N and writes only N queries)."""
    B, h, d, N = ts[0].shape
    ld = -(-N // 8) * 8
    buf = ts[0].new_zeros((len(ts), B, h, d, ld))
    for i, t in enumerate(ts):
        buf[i, ..., :N] = t
    return tuple(buf)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: softmax(q k^T) v on CUDA tensors (B, N, h, 32) of one
    dtype, bf16 or f32.  Returns a (B, N, h, 32) view of a contiguous
    (B, h, 32, N) tensor."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"the flash kernel takes CUDA tensors, {name} is on {t.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"q, k, v must share a dtype, bf16 or f32; {name} is {t.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"q, k, v must share a (B, N, h, d) shape; {name} is {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    B, N, h, d = q.shape
    if d != HEAD_DIM or N < 1 or B < 1 or h < 1:
        raise ValueError(f"the flash kernel takes d = {HEAD_DIM} and N >= 1, got {tuple(q.shape)}")
    qt, kt, vt = _hdn(q), _hdn(k), _hdn(v)
    ld = N
    if q.dtype == torch.bfloat16 and not all(map(tma_ready, (qt, kt, vt))):
        qt, kt, vt = _padded(qt, kt, vt)
        ld = qt.shape[-1]
    out = torch.empty(B, h, d, N, device=q.device, dtype=q.dtype)
    dev = q.device
    lib = _lib()
    err = lib.ofd_flash(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
        qt.stride(0), kt.stride(0), vt.stride(0), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, h, N, ld, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.ofd_cuda_error_string(err).decode()
        raise RuntimeError(f"{FLASH.name} kernel launch failed: {msg} ({err})")
    FLASH.launches += 1
    return out.permute(0, 3, 1, 2)


class _FlashMiddle(torch.autograd.Function):
    """The flash kernel forward; autograd of the composition, recomputed
    from the saved q, k, v, backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_middle_plain(*leaves)
        return torch.autograd.grad(out, leaves, g)


def attention_middle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over (B, N, heads, d), q pre-scaled by d^-0.5: the
    flash kernel for a CUDA tensor with N >= ``FLASH_MIN_N`` (with the
    composition's gradient), the composition otherwise."""
    if q.is_cuda and q.shape[1] >= FLASH_MIN_N:
        return _FlashMiddle.apply(q, k, v)
    return attention_middle_plain(q, k, v)


__all__ = ["attention_middle", "attention_middle_plain", "flash_attention", "flash_plain",
           "FLASH_MIN_N"]
