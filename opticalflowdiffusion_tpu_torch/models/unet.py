"""Denoising UNet (JAX ``models/unet.py``), NCHW.

Module and parameter names follow the reference PyTorch UNet
(lucidrains-style: ``init_conv``, ``time_mlp``, ``downs.i.j``,
``mid_block1``, ``mid_attn``, ``ups.i.j``, ``final_res_block``,
``final_conv``), so ``utils/weights.py`` is the inverse of the JAX package's
``utils/import_torch_ckpt.py`` tables.  Parameters are float32; activations
run in the module's compute ``dtype`` with the JAX package's casts:
normalisation statistics in float32, the UNet output in float32.

The same module serves and trains: nothing on its path runs under
``torch.no_grad``, and its linear-attention blocks are differentiable on the
card (``ops/attention_fused.py``).  The UNet takes JAX's options: no time
input (``time_in=False``: no ``time_mlp``, ResnetBlocks without ``mlp``),
any ``dim_mults``, self-conditioning, learned variance (``out_dim`` None),
and the learned or random Fourier time embedding
(``RandomOrLearnedSinusoidalPosEmb``, ``time_mlp.0.weights``).

``conv_backend`` (``ops/conv.py``: ``cudnn``, ``rows`` or ``fold``; JAX's
``OFD_CONV_BACKEND``) picks the lowering of every conv.  Under ``rows`` and
``fold`` each ResnetBlock also defers its first GroupNorm, time scale/shift
and SiLU into its second conv's input, as a per-(batch, channel) affine that
the ``fold`` kernel applies as it loads (JAX's ``OFD_FUSE_GN`` default).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_fused import fused_linear_attention_block
from ..ops.attention_pallas import BACKENDS as ATTN_BACKENDS
from ..ops.attention_pallas import linear_attention_middle
from ..ops.conv import BACKENDS, conv2d_same
from ..ops.flash_attention import attention_middle


class Conv(nn.Module):
    """Stride-1 'same' conv; the input is cast to ``dtype`` (JAX ``Conv``),
    lowered by ``backend`` (``ops/conv.py``)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True,
                 dtype=torch.float32, backend: str = "cudnn"):
        super().__init__()
        self.dtype = dtype
        self.backend = backend
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = conv2d_same(x.to(self.dtype), self.weight, self.backend)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        return y


class WSConv(Conv):
    """Weight-standardised 3x3 conv: the kernel is standardised per output
    channel over (cin, kh, kw) with eps 1e-5, in float32.  ``in_affine``
    (f32 (B, cin) vectors a, b) convolves ``silu(x * a + b)`` instead of x."""

    def forward(self, x, in_affine=None):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + 1e-5)).to(self.dtype)
        y = conv2d_same(x.to(self.dtype), w, self.backend, in_affine=in_affine)
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
    float32 statistics; returns float32 (``x * a + b`` per channel), or with
    ``return_affine`` the f32 (B, C) vectors a, b themselves."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, return_affine: bool = False):
        B, C = x.shape[:2]
        g = self.groups
        x32 = x.float().reshape(B, g, -1)
        mu = x32.mean(dim=2)
        mu2 = x32.square().mean(dim=2)
        rstd = torch.rsqrt(mu2 - mu.square() + self.eps)        # (B, g)
        sc = self.weight.view(g, C // g)
        a = (rstd[..., None] * sc).reshape(B, C)
        b = (self.bias.view(g, C // g) - (mu * rstd)[..., None] * sc).reshape(B, C)
        if return_affine:
            return a, b
        return x.float() * a[:, :, None, None] + b[:, :, None, None]


class Block(nn.Module):
    """WSConv -> GroupNorm -> (scale, shift) -> SiLU (JAX ``Block``).

    ``defer_norm`` returns ``(h, a, b)``: the raw conv output and the f32
    (B, C) affine that the GroupNorm and the time scale/shift reduce to, for
    the next Block's ``in_affine``, which convolves ``silu(x * a + b)``."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8, dtype=torch.float32,
                 backend: str = "cudnn"):
        super().__init__()
        self.dtype = dtype
        self.proj = WSConv(dim, dim_out, 3, dtype=dtype, backend=backend)
        self.norm = GroupNorm(groups, dim_out)

    def forward(self, x, scale_shift=None, in_affine=None, defer_norm: bool = False):
        h = self.proj(x, in_affine)
        if defer_norm:
            a, b = self.norm(h, return_affine=True)
            if scale_shift is not None:
                s, t = scale_shift
                s32 = s.reshape(s.shape[0], -1).float() + 1.0
                a, b = a * s32, b * s32 + t.reshape(t.shape[0], -1).float()
            return h, a, b
        h = self.norm(h).to(self.dtype)
        if scale_shift is not None:
            s, b = scale_shift
            h = h * (s + 1.0) + b
        return F.silu(h)


class ResnetBlock(nn.Module):
    """Two Blocks with the time scale/shift and a 1x1 residual conv (JAX
    ``ResnetBlock``); under the ``rows`` and ``fold`` backends the first
    Block's norm, scale/shift and SiLU ride in the second Block's conv
    (defer-norm).  ``time_emb_dim`` None: no time input and no ``mlp``."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int], groups: int = 8,
                 dtype=torch.float32, backend: str = "cudnn"):
        super().__init__()
        self.dtype = dtype
        self.fuse_gn = backend != "cudnn"
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim, dim_out, groups, dtype, backend)
        self.block2 = Block(dim_out, dim_out, groups, dtype, backend)
        self.res_conv = (Conv(dim, dim_out, 1, dtype=dtype, backend=backend)
                         if dim != dim_out else None)

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None:
            lin = self.mlp[1]
            t = F.linear(F.silu(time_emb), lin.weight.to(self.dtype), lin.bias.to(self.dtype))
            scale_shift = t[:, :, None, None].chunk(2, dim=1)
        if self.fuse_gn:
            h, a, b = self.block1(x, scale_shift, defer_norm=True)
            h = self.block2(h, in_affine=(a, b))
        else:
            h = self.block2(self.block1(x, scale_shift))
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class LinearAttention(nn.Module):
    """O(N) kernel-feature attention (JAX ``LinearAttention``): qkv 1x1 (no
    bias), the middle (``ops/attention_pallas.py``), out 1x1 with bias,
    ChanLayerNorm.  ``attn_backend`` is JAX's ``OFD_ATTN_BACKEND``:
    ``composition`` (its ``xla``, the default) or ``kernels`` (its
    ``pallas``: the two CUDA kernels on the card, which take heads * dim_head
    = 128 and raise otherwise).  No model of the repo builds it unwrapped:
    the UNet runs ``PreNormResidual(LinearAttention)`` as the fused
    :class:`LinearAttentionBlock`."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dtype=torch.float32,
                 attn_backend: str = "composition"):
        super().__init__()
        if attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend {attn_backend!r} is not one of {ATTN_BACKENDS}")
        self.heads, self.dim_head = heads, dim_head
        self.dtype = dtype
        self.attn_backend = attn_backend
        hidden = heads * dim_head
        self.to_qkv = Conv(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = nn.Sequential(Conv(hidden, dim, 1, dtype=dtype), ChanLayerNorm(dim, dtype))

    def forward(self, x):
        B, C, H, W = x.shape
        hidden = self.heads * self.dim_head
        qkv = self.to_qkv(x).reshape(B, 3 * hidden, H * W)
        # (B, N, 3 hidden) view of the conv's layout, the one the kernels read
        out = linear_attention_middle(qkv.transpose(1, 2), self.heads, self.dim_head,
                                      self.attn_backend)
        out = out.transpose(1, 2).reshape(B, hidden, H, W).to(self.dtype)
        return self.to_out(out)


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
        self.fn = _PreNorm(dim, LinearAttention(dim, heads, dim_head, dtype), dtype)

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
                 dtype=torch.float32, **conv):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv(dim, hidden * 3, 1, bias=False, dtype=dtype, **conv)
        self.to_out = Conv(hidden, dim, 1, dtype=dtype, **conv)

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


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """The learned (or, with ``is_random``, fixed random) Fourier time
    embedding: [t, sin(2 pi t w), cos(2 pi t w)] with ``weights`` w
    (dim // 2,); the random weights take no gradient."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2), requires_grad=not is_random)

    def forward(self, t):
        t = t.float()[:, None]
        freqs = t * self.weights[None, :] * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


def Downsample(dim: int, dim_out: int, dtype=torch.float32, **conv) -> nn.Sequential:
    """Pixel-unshuffle (channel order (c, dy, dx), as the reference) + 1x1."""
    return nn.Sequential(nn.PixelUnshuffle(2), Conv(dim * 4, dim_out, 1, dtype=dtype, **conv))


def Upsample(dim: int, dim_out: int, dtype=torch.float32, **conv) -> nn.Sequential:
    """Nearest 2x upsample + 3x3 conv."""
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                         Conv(dim, dim_out, 3, dtype=dtype, **conv))


class Unet(nn.Module):
    """The reference UNet; ``channels`` counts the full input (x plus the
    concatenated external conditioning), twice that with
    ``self_condition`` (the self-conditioning input, zeros when none is
    given, goes before x).  ``out_dim`` None: ``channels``, twice that with
    ``learned_variance``.  ``time_in=False`` takes no time (no
    ``time_mlp``, no ResnetBlock ``mlp``).  ``conv_backend`` lowers its
    convs (module docstring)."""

    def __init__(self, dim: int, out_dim: Optional[int] = None, channels: int = 3,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), resnet_block_groups: int = 8,
                 zero_init_final: bool = False, dtype=torch.float32,
                 conv_backend: str = "cudnn", time_in: bool = True,
                 self_condition: bool = False, learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False, random_fourier_features: bool = False,
                 learned_sinusoidal_dim: int = 16):
        super().__init__()
        if conv_backend not in BACKENDS:
            raise ValueError(f"conv_backend {conv_backend!r} is not one of {BACKENDS}")
        self.dim, self.dtype = dim, dtype
        self.zero_init_final = zero_init_final
        self.time_in, self.self_condition = time_in, self_condition
        self.fourier = learned_sinusoidal_cond or random_fourier_features
        out_dim = out_dim or channels * (2 if learned_variance else 1)
        G = resnet_block_groups
        time_dim = dim * 4 if time_in else None
        conv = dict(backend=conv_backend)
        res = dict(dtype=dtype, backend=conv_backend)
        self.init_conv = Conv(channels * (2 if self_condition else 1), dim, 7, dtype=dtype,
                              **conv)
        if time_in:
            if self.fourier:
                emb = RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim,
                                                      random_fourier_features)
                emb_dim = learned_sinusoidal_dim + 1
            else:
                emb, emb_dim = nn.Identity(), dim
            self.time_mlp = nn.Sequential(emb, nn.Linear(emb_dim, time_dim),
                                          nn.GELU(), nn.Linear(time_dim, time_dim))
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        R = len(in_out)
        self.downs = nn.ModuleList()
        for i, (din, dout) in enumerate(in_out):
            self.downs.append(nn.ModuleList([
                ResnetBlock(din, din, time_dim, G, **res),
                ResnetBlock(din, din, time_dim, G, **res),
                LinearAttentionBlock(din, dtype=dtype),
                (Downsample(din, dout, dtype, **conv) if i < R - 1
                 else Conv(din, dout, 3, dtype=dtype, **conv)),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, G, **res)
        self.mid_attn = PreNormResidual(mid, Attention(mid, dtype=dtype, **conv), dtype)
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, G, **res)
        self.ups = nn.ModuleList()
        for j, (din, dout) in enumerate(reversed(in_out)):
            self.ups.append(nn.ModuleList([
                ResnetBlock(dout + din, dout, time_dim, G, **res),
                ResnetBlock(dout + din, dout, time_dim, G, **res),
                LinearAttentionBlock(dout, dtype=dtype),
                (Upsample(dout, din, dtype, **conv) if j < R - 1
                 else Conv(dout, din, 3, dtype=dtype, **conv)),
            ]))
        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, G, **res)
        self.final_conv = Conv(dim, out_dim, 1, dtype=dtype, **conv)

    def forward(self, x, external_cond: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None, x_self_cond: Optional[torch.Tensor] = None):
        if external_cond is not None:
            x = torch.cat([x, external_cond], dim=1)
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=1)
        x = self.init_conv(x.to(self.dtype))
        r = x
        t = None
        if self.time_in:
            if time is None:
                raise ValueError("when Unet takes time arg, time must be passed in")
            lin1, lin2 = self.time_mlp[1], self.time_mlp[3]
            cdt = self.dtype
            emb = self.time_mlp[0](time) if self.fourier else sinusoidal_pos_emb(time, self.dim)
            t = F.linear(emb.to(cdt), lin1.weight.to(cdt), lin1.bias.to(cdt))
            t = F.linear(F.gelu(t), lin2.weight.to(cdt), lin2.bias.to(cdt))
        elif time is not None:
            raise ValueError("this Unet does not take time arg")

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


# flax's lecun_normal: a normal truncated at +-2, divided by its standard
# deviation there (jax.nn.initializers.variance_scaling's constant)
TRUNC = 2.0
TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """A draw of flax's ``lecun_normal`` (``variance_scaling(1, "fan_in",
    "truncated_normal")``): JAX's inverse-CDF truncated normal on [-2, 2]
    (a uniform between erf(-2 / sqrt 2) and erf(2 / sqrt 2), through
    sqrt 2 * erfinv), scaled by 1 / (0.8796 * sqrt(fan_in)), so that its
    variance is 1 / fan_in and no entry exceeds 2.2737 / sqrt(fan_in)."""
    lo, hi = (math.erf(v / math.sqrt(2.0)) for v in (-TRUNC, TRUNC))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=torch.float64)
    z = torch.clamp(math.sqrt(2.0) * torch.special.erfinv(u), -TRUNC, TRUNC)
    return (z / (TRUNC_STD * math.sqrt(fan_in))).float()


def init_weights(model: nn.Module, generator: torch.Generator,
                 zero_init_final: Optional[bool] = None) -> nn.Module:
    """Start every parameter where flax's initialisers start it: kernels
    (convs and dense layers) drawn from ``generator`` by
    :func:`lecun_normal`, biases 0, norm gains 1, the Fourier time
    embedding's weights ~ N(0, 1); so a zeroed output conv outputs exactly
    0, as JAX's does.  The UNet's output conv is zeroed when
    ``zero_init_final`` (default: the model's own flag).  Parameters are
    drawn on the CPU, so a seed gives the same weights on every device."""
    with torch.no_grad():
        for m, leaf, p in ((m, n, p) for m in model.modules()
                           for n, p in m.named_parameters(recurse=False)):
            if p.dim() >= 2 and leaf == "weight":
                # flax's fan_in: the kernel's size over its input axes; a
                # transposed conv's weight is (in, out, k, k), the others'
                # (out, in, ...)
                transposed = isinstance(m, nn.modules.conv._ConvTransposeNd)
                v = lecun_normal(p.shape, (p[:, 0] if transposed else p[0]).numel(), generator)
            elif leaf == "weights":          # the Fourier time embedding's
                v = torch.randn(p.shape, generator=generator)
            elif leaf == "bias":
                v = torch.zeros(p.shape)
            else:
                v = torch.ones(p.shape)
            p.copy_(v)
        for m in model.modules():
            if isinstance(m, Unet):
                zero = m.zero_init_final if zero_init_final is None else zero_init_final
                if zero:
                    m.final_conv.weight.zero_()
    return model


__all__ = [
    "Unet", "Conv", "WSConv", "ChanLayerNorm", "GroupNorm", "Block", "ResnetBlock",
    "LinearAttention", "LinearAttentionBlock", "Attention", "PreNormResidual", "Downsample",
    "RandomOrLearnedSinusoidalPosEmb", "Upsample", "sinusoidal_pos_emb", "init_weights",
    "lecun_normal",
]
