"""Flow-consistent data augmentation (JAX ``algorithms/augmentation.py``), NCHW.

Per item: photometric jitter applied identically to both frames (colour
jitter p=0.4, grayscale p=0.1, gaussian blur p=0.2), then geometric
augmentations that keep the flow consistent (horizontal flip p=0.3 negating
dx, vertical flip p=0.3 negating dy, random resized crop p=0.15 rescaling
the flow by image size / crop size).

The randomness is split from the transform: :func:`draw` takes every
per-item parameter from an explicit ``torch.Generator``, and :func:`apply`
is a pure function of those parameters and the batch.  JAX draws its
parameters from PRNG keys, so the two give other numbers for one seed; the
tests hand JAX's draws to :func:`apply`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

GRAY_W = (0.299, 0.587, 0.114)
P_JITTER, P_GRAY, P_BLUR, P_HFLIP, P_VFLIP, P_CROP = 0.4, 0.1, 0.2, 0.3, 0.3, 0.15
JITTER = 0.1
CROP_AREA = (0.8, 1.0)
CROP_LOG_RATIO = (math.log(0.9), math.log(1.1))

Params = Dict[str, torch.Tensor]


def draw(batch: int, generator: Optional[torch.Generator] = None) -> Params:
    """Every per-item parameter of one batch, (batch,) float32 tensors on the
    generator's device: the Bernoulli flags (as 0/1), the jitter factors,
    the blur sigma and the crop's area fraction, log aspect ratio and
    position (uniforms in [0, 1) scaled by the free room)."""
    dev = generator.device if generator is not None else torch.device("cpu")
    u = lambda: torch.rand(batch, generator=generator, device=dev)
    between = lambda lo, hi: lo + u() * (hi - lo)
    return {
        "jitter": (u() < P_JITTER).float(),
        "brightness": 1.0 + between(-JITTER, JITTER),
        "contrast": 1.0 + between(-JITTER, JITTER),
        "saturation": 1.0 + between(-JITTER, JITTER),
        "hue": between(-JITTER, JITTER),
        "gray": (u() < P_GRAY).float(),
        "blur": (u() < P_BLUR).float(),
        "sigma": u() * 0.5 + 1e-4,
        "hflip": (u() < P_HFLIP).float(),
        "vflip": (u() < P_VFLIP).float(),
        "crop": (u() < P_CROP).float(),
        "crop_area": between(*CROP_AREA),
        "crop_log_ratio": between(*CROP_LOG_RATIO),
        "crop_top": u(),
        "crop_left": u(),
    }


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(-1, 1, 1, 1)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) luma of an RGB batch."""
    w = torch.tensor(GRAY_W, dtype=img.dtype, device=img.device)
    return torch.einsum("bchw,c->bhw", img, w)[:, None]


def _rgb_to_hsv(rgb):
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    mx = rgb.amax(dim=1)
    mn = rgb.amin(dim=1)
    diff = mx - mn
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    rc, gc, bc = (mx - r) / safe, (mx - g) / safe, (mx - b) / safe
    h = torch.where(mx == r, bc - gc, torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(diff == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    s = torch.where(mx == 0, torch.zeros_like(mx), diff / torch.where(mx == 0, torch.ones_like(mx), mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.long(), 6)

    def pick(opts):
        out = opts[5]
        for idx in range(4, -1, -1):
            out = torch.where(i == idx, opts[idx], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=1)


def _color_jitter(img, prm: Params):
    img = torch.clamp(img * _col(prm["brightness"]), 0.0, 1.0)
    gray_mean = _gray(img).mean(dim=(1, 2, 3), keepdim=True)
    img = torch.clamp((img - gray_mean) * _col(prm["contrast"]) + gray_mean, 0.0, 1.0)
    gray = _gray(img)
    img = torch.clamp(gray + (img - gray) * _col(prm["saturation"]), 0.0, 1.0)
    h, s, v = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    h = torch.remainder(h + prm["hue"].view(-1, 1, 1), 1.0)
    return _hsv_to_rgb(h, s, v)


def _blur3(img, sigma):
    """Separable 3-tap gaussian, reflect-padded: rows first, then columns."""
    xs = torch.tensor([-1.0, 0.0, 1.0], device=img.device)
    k = torch.exp(-0.5 * (xs[None] / sigma[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)
    k0, k1, k2 = (_col(k[:, i]) for i in range(3))
    p = F.pad(img, (0, 0, 1, 1), mode="reflect")
    img = p[:, :, :-2] * k0 + p[:, :, 1:-1] * k1 + p[:, :, 2:] * k2
    p = F.pad(img, (1, 1, 0, 0), mode="reflect")
    return p[..., :-2] * k0 + p[..., 1:-1] * k1 + p[..., 2:] * k2


def _resized_crop(stacked, prm: Params):
    """RandomResizedCrop(scale=[0.8, 1], ratio=[0.9, 1.1]) of (B, C, H, W)
    whose last two channels are the flow, as two tent-matrix contractions;
    the flow is rescaled by (W / w, H / h)."""
    B, _, H, W = stacked.shape
    area = H * W * prm["crop_area"]
    ratio = torch.exp(prm["crop_log_ratio"])
    w = torch.clamp(torch.sqrt(area * ratio), 1.0, W)
    h = torch.clamp(torch.sqrt(area / ratio), 1.0, H)
    top = prm["crop_top"] * (H - h)
    left = prm["crop_left"] * (W - w)
    dev = stacked.device
    ar_h = torch.arange(H, device=dev, dtype=torch.float32)
    ar_w = torch.arange(W, device=dev, dtype=torch.float32)
    ys = top[:, None] + (ar_h + 0.5) * (h / H)[:, None] - 0.5
    xs = left[:, None] + (ar_w + 0.5) * (w / W)[:, None] - 0.5

    def interp(coords, n, grid):
        c = torch.clamp(coords, 0.0, n - 1.0)
        return torch.clamp(1.0 - (c[..., None] - grid).abs(), min=0.0)

    ry, rx = interp(ys, H, ar_h), interp(xs, W, ar_w)
    out = torch.einsum("bih,bchw,bjw->bcij", ry, stacked.float(), rx)
    fscale = torch.stack([W / w, H / h], dim=1)[:, :, None, None]
    return torch.cat([out[:, :-2], out[:, -2:] * fscale], dim=1)


def apply(prm: Params, img: torch.Tensor, tgt: torch.Tensor, flow: torch.Tensor):
    """Augment a batch: ``img``, ``tgt`` (B, 3, H, W) in [0, 1] and ``flow``
    (B, 2, H, W) ``(dx, dy)``, with the parameters of :func:`draw`.
    Returns (img, tgt, flow)."""
    prm = {k: v.to(img.device) for k, v in prm.items()}
    on = lambda key: _col(prm[key]) > 0.5
    jit = on("jitter")
    img = torch.where(jit, _color_jitter(img, prm), img)
    tgt = torch.where(jit, _color_jitter(tgt, prm), tgt)
    gray = on("gray")
    img = torch.where(gray, _gray(img).expand_as(img), img)
    tgt = torch.where(gray, _gray(tgt).expand_as(tgt), tgt)
    blur = on("blur")
    img = torch.where(blur, _blur3(img, prm["sigma"]), img)
    tgt = torch.where(blur, _blur3(tgt, prm["sigma"]), tgt)

    C = img.shape[1]
    stacked = torch.cat([img, tgt, flow], dim=1)
    sign = torch.ones(stacked.shape[1], device=img.device).view(1, -1, 1, 1)
    flipped = stacked.flip(3) * sign.index_fill(1, torch.tensor([2 * C], device=img.device), -1.0)
    stacked = torch.where(on("hflip"), flipped, stacked)
    flipped = stacked.flip(2) * sign.index_fill(1, torch.tensor([2 * C + 1], device=img.device), -1.0)
    stacked = torch.where(on("vflip"), flipped, stacked)
    stacked = torch.where(on("crop"), _resized_crop(stacked, prm), stacked)
    return stacked[:, :C], stacked[:, C:2 * C], stacked[:, 2 * C:]


def augment(img, tgt, flow, generator: Optional[torch.Generator] = None):
    """:func:`apply` with parameters drawn from ``generator``."""
    return apply(draw(img.shape[0], generator), img, tgt, flow)


__all__ = ["apply", "augment", "draw"]
