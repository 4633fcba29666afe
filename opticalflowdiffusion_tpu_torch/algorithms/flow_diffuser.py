"""FlowDiffuser sampling (JAX ``algorithms/flow_diffuser.py``), NCHW.

Given frame 1 as the conditioning, the flagship (``target='joint'``)
denoises to the forward-warped frame and its flow together: the UNet
predicts a flow and the conditioning is splatted by it (``UnetWithWarp``).
Ported for serving: ``UnetWithWarp``, ``FlowDiffuser.__init__``,
``preprocess(aug=False)`` and ``sample`` (``cfg.sampler`` passes through to
the schedule, so 'dpmpp' selects DPM-Solver++(2M); H and W come from the
conditioning, so one model serves 128x128 and 448x1024).  Training
(losses, augmentation, optimizer) and the latent mode come with later
slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .base import compute_dtype, pair_batch
from ..config import FlowDiffuserConfig
from ..models import diffusion as dm
from ..models.unet import Unet, init_weights
from ..ops.warp import warp_forward_flow


class UnetWithWarp(nn.Module):
    """UNet that predicts flow and splats the conditioning by it.  Output
    channels: warped (dim) [+ flow (2) when ``full_output``]."""

    def __init__(self, flow_max: float, dim: int, channels: int, full_output: bool,
                 zero_init: bool = True, out_dim: int = 2, unet_dim: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.flow_max = float(flow_max)
        self.dim = dim
        self.full_output = full_output
        self.dtype = dtype
        self.model = Unet(unet_dim, out_dim=out_dim, channels=channels,
                          zero_init_final=zero_init, dtype=dtype)

    def _warp(self, image, flow):
        # values splat in the compute dtype; the flow (coordinates) stays f32
        src = image[:, : self.dim].to(self.dtype)
        return warp_forward_flow(src, flow * self.flow_max).to(image.dtype)

    def forward(self, x, external_cond=None, t=None):
        # NaN holes of the state go in as zeros plus a NaN-indicator channel
        nan = torch.isnan(x)
        nan_ch = nan.any(dim=1, keepdim=True).to(x.dtype)
        x = torch.where(nan, torch.zeros_like(x), x)
        flow = self.model(torch.cat([x, nan_ch], dim=1), external_cond, t)
        src = external_cond if external_cond is not None else x[:, : self.dim]
        out = self._warp(src, flow[:, :2])
        if self.full_output:
            out = torch.cat([out, flow], dim=1)
        return out


class FlowDiffuser:
    """The flagship algorithm, for sampling.  ``device`` defaults to cuda."""

    name = "flow_diffuser"

    def __init__(self, cfg: FlowDiffuserConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if cfg.latent:
            raise NotImplementedError("latent mode is not ported yet")
        if not cfg.is_diffusion:
            raise NotImplementedError("only the diffusion model is ported")
        if cfg.target != "joint":
            raise NotImplementedError(f"target {cfg.target!r} is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg.precision)
        self.flow_max = float(cfg.flow_max)
        self.target = cfg.target
        self.image_size = int(cfg.image_size)
        self.dim = 3
        unet_dims = self.dim + 3           # joint state (5) + NaN channel
        self.channels = self.dim + 2       # warped image + flow
        unet_in = self.dim + unet_dims
        self.module = UnetWithWarp(
            flow_max=self.flow_max, dim=self.dim, channels=unet_in,
            full_output=True, zero_init=cfg.zero_init,
            unet_dim=cfg.unet_dim, dtype=self.dtype,
        )
        init_weights(self.module, generator if generator is not None else torch.Generator())
        self.module.to(self.device).eval()
        self.sched = dm.make_schedule(
            timesteps=int(cfg.timesteps),
            sampling_timesteps=(int(cfg.sampling_timesteps)
                                if cfg.sampling_timesteps else None),
            objective="pred_x0",
            noise_space="image" if cfg.noiser == "image" else "flow",
            min_snr_loss_weight=True,
            sampler=cfg.sampler,
            device=self.device,
        )

    def model_fn(self, x, cond, t):
        return self.module(x, cond, t)

    def preprocess(self, batch) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(tgt_x, cond, flow_n) of a batch, without augmentation."""
        img, tgt, flow = pair_batch(batch)
        flow_n = torch.clamp(flow / self.flow_max, -1.0, 1.0)
        img = 2.0 * img - 1.0
        tgt_x = torch.cat([warp_forward_flow(img, flow_n * self.flow_max), flow_n], dim=1)
        return tgt_x, img, flow_n

    @torch.no_grad()
    def sample(self, cond, generator: Optional[torch.Generator] = None,
               x_T=None, noises=None):
        """The final (warped frame (B, 3, H, W), flow (B, 2, H, W)) sampled for
        ``cond`` (B, 3, H, W).  ``x_T`` and ``noises`` replace the draws from
        ``generator`` (see ``models/diffusion.py``)."""
        B, _, H, W = cond.shape
        out = dm.sample(self.sched, self.model_fn, (B, self.channels, H, W),
                        external_cond=cond, generator=generator, x_T=x_T,
                        noises=noises, device=cond.device)
        return out[:, : self.dim], out[:, self.dim:]


__all__ = ["UnetWithWarp", "FlowDiffuser"]
