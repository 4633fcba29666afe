"""Forward splat (JAX ``ops/splat.py::softsplat``).

Only what ``warp_forward_flow`` uses on the sampling path is ported: mode
``linear_unn`` at scale 1 and offset 0, forward only.  Each source pixel
adds its value, times the bilinear weight, to the four integer corners
around its target ``(x + dx, y + dy)``; corners outside the image and
non-finite targets are dropped.  Sums are taken in float32 (or finer) and
cast back to the input dtype, as in JAX.

* :func:`splat_raw` is the plain version, a scatter with ``index_add_``.
  On the GPU ``index_add_`` accumulates with float atomics, so the order of
  its sums (and their last bits) changes from run to run.
* :func:`splat_linear_unn` launches the CUDA kernel of ``kernels/splat.cu``,
  whose sums are the same bits on every run (64-bit fixed-point integer
  atomics; see the source), as the JAX version's are.
* :func:`softsplat` takes the kernel for CUDA tensors and the plain version
  for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import SPLAT


def splat_raw(inp: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear scatter-add of ``inp`` (B, C, H, W) by ``flow`` (B, 2, H, W)."""
    B, C, H, W = inp.shape
    dev = inp.device
    vals = inp.float().permute(0, 2, 3, 1).reshape(B * H * W, C)
    flow = flow.float()
    xs = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W)
    ys = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1)
    fx = (xs + flow[:, 0]).reshape(-1)
    fy = (ys + flow[:, 1]).reshape(-1)
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    fx = torch.where(finite, fx, torch.zeros_like(fx))
    fy = torch.where(finite, fy, torch.zeros_like(fy))
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1 = fx - x0
    wy1 = fy - y0
    base = torch.arange(B, device=dev).repeat_interleave(H * W) * (H * W)
    dump = B * H * W
    out = torch.zeros(dump + 1, C, device=dev, dtype=torch.float32)
    for cx, cy, w in (
        (x0, y0, (1.0 - wx1) * (1.0 - wy1)),
        (x0 + 1.0, y0, wx1 * (1.0 - wy1)),
        (x0, y0 + 1.0, (1.0 - wx1) * wy1),
        (x0 + 1.0, y0 + 1.0, wx1 * wy1),
    ):
        inb = finite & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
        idx = base + cy.long().clamp(0, H - 1) * W + cx.long().clamp(0, W - 1)
        idx = torch.where(inb, idx, torch.full_like(idx, dump))
        out.index_add_(0, idx, vals * w[:, None])
    out = out[:dump].view(B, H, W, C).permute(0, 3, 1, 2)
    return out.to(inp.dtype)


def _lib():
    from ..kernels import build

    lib = build.load("splat")
    if not getattr(lib, "_ofd_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ofd_splat.argtypes = [vp, vp, vp, i, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.ofd_splat.restype = i
        lib.ofd_cuda_error_string.argtypes = [i]
        lib.ofd_cuda_error_string.restype = ctypes.c_char_p
        lib._ofd_typed = True
    return lib


def splat_linear_unn(inp: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: ``[inp * metric, metric]`` splatted by ``flow``, on
    contiguous CUDA tensors inp (B, C, H, W) and metric (B, 1, H, W) of one
    dtype (bf16 or f32) and flow (B, 2, H, W) f32.  Returns (B, C + 1, H, W)
    in inp's dtype, the same bits on every run."""
    if not inp.is_cuda:
        raise ValueError(f"the splat kernel takes CUDA tensors, got {inp.device}")
    if inp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"inp must be float32 or bfloat16, got {inp.dtype}")
    if inp.dim() != 4:
        raise ValueError(f"inp must be (B, C, H, W), got {tuple(inp.shape)}")
    B, C, H, W = inp.shape
    for name, t, shape, dtype in (("inp", inp, (B, C, H, W), inp.dtype),
                                  ("metric", metric, (B, 1, H, W), inp.dtype),
                                  ("flow", flow, (B, 2, H, W), torch.float32)):
        if t.device != inp.device:
            raise ValueError(f"{name} is on {t.device}, expected {inp.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = inp.device
    maxbits = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    acc = torch.zeros(B, C + 1, H, W, dtype=torch.int64, device=dev)
    special = torch.zeros(B, C + 1, H, W, dtype=torch.float32, device=dev)
    out = torch.empty(B, C + 1, H, W, dtype=inp.dtype, device=dev)
    lib = _lib()
    err = lib.ofd_splat(
        inp.data_ptr(), metric.data_ptr(), flow.data_ptr(), int(inp.dtype == torch.bfloat16),
        maxbits.data_ptr(), acc.data_ptr(), special.data_ptr(), out.data_ptr(),
        B, C, H, W, max(0, (H * W - 1).bit_length()), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.ofd_cuda_error_string(err).decode()
        raise RuntimeError(f"{SPLAT.name} kernel launch failed: {msg} ({err})")
    SPLAT.launches += 1
    return out


def softsplat(inp: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor) -> torch.Tensor:
    """Mode ``linear_unn``: ``[inp * metric, metric]`` splatted; returns
    (B, C + 1, H, W) with the raw accumulated weight as the last channel.
    The CUDA kernel for CUDA tensors, :func:`splat_raw` for CPU tensors."""
    if inp.is_cuda:
        return splat_linear_unn(inp.contiguous(), flow.float().contiguous(),
                                metric.contiguous())
    return splat_raw(torch.cat([inp * metric, metric], dim=1), flow)


__all__ = ["softsplat", "splat_linear_unn", "splat_raw"]
