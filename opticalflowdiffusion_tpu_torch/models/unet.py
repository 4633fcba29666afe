"""Denoising UNet (JAX ``models/unet.py``), NCHW.

Module and parameter names follow the reference PyTorch UNet
(lucidrains-style: ``init_conv``, ``time_mlp``, ``downs.i.j``,
``mid_block1``, ``mid_attn``, ``ups.i.j``, ``final_res_block``,
``final_conv``), so ``utils/weights.py`` is the inverse of the JAX package's
``utils/import_torch_ckpt.py`` tables.  Parameters are float32; activations
run in the module's compute ``dtype`` with the JAX package's casts:
normalisation statistics in float32, the UNet output in float32.

Only what the flagship FlowDiffuser runs is ported: sinusoidal time
embedding, no self-conditioning, no learned variance.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_fused import fused_linear_attention_block
from ..ops.conv import conv2d_same
from ..ops.flash_attention import attention_middle


class Conv(nn.Module):
    """Stride-1 'same' conv; the input is cast to ``dtype`` (JAX ``Conv``)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = conv2d_same(x.to(self.dtype), self.weight)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        return y


class WSConv(Conv):
    """Weight-standardised 3x3 conv: the kernel is standardised per output
    channel over (cin, kh, kw) with eps 1e-5, in float32."""

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + 1e-5)).to(self.dtype)
        y = conv2d_same(x.to(self.dtype), w)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class ChanLayerNorm(nn.Module):
    """Bias-free LayerNorm over channels, float32 statistics."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=1, keepdim=True)
        var = x32.var(dim=1, unbiased=False, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + 1e-5) * self.g).to(self.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with the JAX package's fast variance E[x^2] - E[x]^2 and
    float32 statistics; returns float32 (``x * a + b`` per channel)."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        B, C = x.shape[:2]
        g = self.groups
        x32 = x.float().reshape(B, g, -1)
        mu = x32.mean(dim=2)
        mu2 = x32.square().mean(dim=2)
        rstd = torch.rsqrt(mu2 - mu.square() + self.eps)        # (B, g)
        sc = self.weight.view(g, C // g)
        a = (rstd[..., None] * sc).reshape(B, C)
        b = (self.bias.view(g, C // g) - (mu * rstd)[..., None] * sc).reshape(B, C)
        return x.float() * a[:, :, None, None] + b[:, :, None, None]


class Block(nn.Module):
    """WSConv -> GroupNorm -> (scale, shift) -> SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = WSConv(dim, dim_out, 3, dtype=dtype)
        self.norm = GroupNorm(groups, dim_out)

    def forward(self, x, scale_shift=None):
        h = self.norm(self.proj(x)).to(self.dtype)
        if scale_shift is not None:
            s, b = scale_shift
            h = h * (s + 1.0) + b
        return F.silu(h)


class ResnetBlock(nn.Module):
    """Two Blocks with the time scale/shift and a 1x1 residual conv (the
    unfused path of JAX ``ResnetBlock``)."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
        self.block1 = Block(dim, dim_out, groups, dtype)
        self.block2 = Block(dim_out, dim_out, groups, dtype)
        self.res_conv = Conv(dim, dim_out, 1, dtype=dtype) if dim != dim_out else None

    def forward(self, x, time_emb):
        lin = self.mlp[1]
        t = F.linear(F.silu(time_emb), lin.weight.to(self.dtype), lin.bias.to(self.dtype))
        scale, shift = t[:, :, None, None].chunk(2, dim=1)
        h = self.block1(x, (scale, shift))
        h = self.block2(h)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class _LinearAttention(nn.Module):
    """Parameter holder of the reference LinearAttention (to_qkv, to_out)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.to_qkv = nn.Module()
        self.to_qkv.weight = nn.Parameter(torch.empty(hidden * 3, dim, 1, 1))
        self.to_out = nn.Sequential(Conv(hidden, dim, 1), ChanLayerNorm(dim))


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, dtype=torch.float32):
        super().__init__()
        self.fn = fn
        self.norm = ChanLayerNorm(dim, dtype)


class LinearAttentionBlock(nn.Module):
    """x + LinearAttention(preLN(x)) as one fused op (JAX
    ``LinearAttentionBlock``), keyed like the reference's
    ``Residual(PreNorm(LinearAttention))``: ``fn.norm.g``,
    ``fn.fn.to_qkv.weight``, ``fn.fn.to_out.{0.weight, 0.bias, 1.g}``."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.heads, self.dim_head = heads, dim_head
        self.fn = _PreNorm(dim, _LinearAttention(dim, heads * dim_head), dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        att = self.fn.fn
        y = fused_linear_attention_block(
            x.reshape(B, C, H * W),
            self.fn.norm.g.view(C),
            att.to_qkv.weight.view(-1, C),
            att.to_out[0].weight.view(C, -1),
            att.to_out[0].bias,
            att.to_out[1].g.view(C),
            self.heads, self.dim_head,
        )
        return y.view(B, C, H, W).to(self.dtype)


class Attention(nn.Module):
    """Quadratic attention at the bottleneck (JAX ``Attention``)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = Conv(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        qkv = self.to_qkv(x).reshape(B, 3, self.heads, self.dim_head, H * W)
        # q, k, v as (B, N, h, d) views of the (B, h, d, N) slices, the layout
        # the flash kernel reads without a copy; q is scaled in that layout
        q = (qkv[:, 0] * self.dim_head ** -0.5).permute(0, 3, 1, 2)
        k, v = qkv[:, 1].permute(0, 3, 1, 2), qkv[:, 2].permute(0, 3, 1, 2)
        out = attention_middle(q, k, v)                        # (B, N, h, d)
        out = out.permute(0, 2, 3, 1).reshape(B, -1, H, W)
        return self.to_out(out)


class PreNormResidual(nn.Module):
    """x + fn(ChanLayerNorm(x)), keyed ``fn.norm.g`` / ``fn.fn.*``."""

    def __init__(self, dim: int, fn: nn.Module, dtype=torch.float32):
        super().__init__()
        self.fn = _PreNorm(dim, fn, dtype)

    def forward(self, x):
        return self.fn.fn(self.fn.norm(x)) + x


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32) * -emb)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def Downsample(dim: int, dim_out: int, dtype=torch.float32) -> nn.Sequential:
    """Pixel-unshuffle (channel order (c, dy, dx), as the reference) + 1x1."""
    return nn.Sequential(nn.PixelUnshuffle(2), Conv(dim * 4, dim_out, 1, dtype=dtype))


def Upsample(dim: int, dim_out: int, dtype=torch.float32) -> nn.Sequential:
    """Nearest 2x upsample + 3x3 conv."""
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                         Conv(dim, dim_out, 3, dtype=dtype))


class Unet(nn.Module):
    """The reference UNet; ``channels`` counts the full input (x plus the
    concatenated external conditioning)."""

    def __init__(self, dim: int, out_dim: int, channels: int = 3,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), resnet_block_groups: int = 8,
                 zero_init_final: bool = False, dtype=torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.zero_init_final = zero_init_final
        G = resnet_block_groups
        time_dim = dim * 4
        self.init_conv = Conv(channels, dim, 7, dtype=dtype)
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(dim, time_dim),
                                      nn.GELU(), nn.Linear(time_dim, time_dim))
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        R = len(in_out)
        self.downs = nn.ModuleList()
        for i, (din, dout) in enumerate(in_out):
            self.downs.append(nn.ModuleList([
                ResnetBlock(din, din, time_dim, G, dtype),
                ResnetBlock(din, din, time_dim, G, dtype),
                LinearAttentionBlock(din, dtype=dtype),
                Downsample(din, dout, dtype) if i < R - 1 else Conv(din, dout, 3, dtype=dtype),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, G, dtype)
        self.mid_attn = PreNormResidual(mid, Attention(mid, dtype=dtype), dtype)
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, G, dtype)
        self.ups = nn.ModuleList()
        for j, (din, dout) in enumerate(reversed(in_out)):
            self.ups.append(nn.ModuleList([
                ResnetBlock(dout + din, dout, time_dim, G, dtype),
                ResnetBlock(dout + din, dout, time_dim, G, dtype),
                LinearAttentionBlock(dout, dtype=dtype),
                Upsample(dout, din, dtype) if j < R - 1 else Conv(dout, din, 3, dtype=dtype),
            ]))
        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, G, dtype)
        self.final_conv = Conv(dim, out_dim, 1, dtype=dtype)

    def forward(self, x, external_cond: Optional[torch.Tensor], time: torch.Tensor):
        if external_cond is not None:
            x = torch.cat([x, external_cond], dim=1)
        x = self.init_conv(x.to(self.dtype))
        r = x
        lin1, lin2 = self.time_mlp[1], self.time_mlp[3]
        cdt = self.dtype
        t = sinusoidal_pos_emb(time, self.dim).to(cdt)
        t = F.linear(t, lin1.weight.to(cdt), lin1.bias.to(cdt))
        t = F.linear(F.gelu(t), lin2.weight.to(cdt), lin2.bias.to(cdt))

        hs = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t)
            hs.append(x)
            x = attn(block2(x, t))
            hs.append(x)
            x = down(x)
        x = self.mid_block1(x, t)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t)
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), t)
            x = block2(torch.cat([x, hs.pop()], dim=1), t)
            x = up(attn(x))
        x = self.final_res_block(torch.cat([x, r], dim=1), t)
        return self.final_conv(x).float()


def init_weights(model: nn.Module, generator: torch.Generator,
                 zero_init_final: Optional[bool] = None) -> nn.Module:
    """Draw every parameter from ``generator``: kernels ~ N(0, 1/fan_in),
    biases ~ N(0, 0.02^2), norm gains ~ 1 + N(0, 0.02^2).  The UNet's output
    conv is zeroed when ``zero_init_final`` (default: the model's own flag).
    Parameters are drawn on the CPU, so a seed gives the same weights on
    every device."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2 and leaf == "weight":
                fan_in = p[0].numel()
                v = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            elif leaf == "bias":
                v = torch.randn(p.shape, generator=generator) * 0.02
            else:
                v = 1.0 + torch.randn(p.shape, generator=generator) * 0.02
            p.copy_(v)
        for m in model.modules():
            if isinstance(m, Unet):
                zero = m.zero_init_final if zero_init_final is None else zero_init_final
                if zero:
                    m.final_conv.weight.zero_()
    return model


__all__ = [
    "Unet", "Conv", "WSConv", "ChanLayerNorm", "GroupNorm", "Block", "ResnetBlock",
    "LinearAttentionBlock", "Attention", "PreNormResidual", "Downsample",
    "Upsample", "sinusoidal_pos_emb", "init_weights",
]
