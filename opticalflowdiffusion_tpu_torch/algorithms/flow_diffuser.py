"""FlowDiffuser (JAX ``algorithms/flow_diffuser.py``), NCHW.

Given frame 1 as the conditioning, the flagship (``target='joint'``)
denoises to the forward-warped frame and its flow together: the UNet
predicts a flow and the conditioning is splatted by it (``UnetWithWarp``).
Ported: ``UnetWithWarp``; ``FlowDiffuser`` with ``preprocess`` (with and
without augmentation), the training loss (``loss``, ``loss_fn``),
``sample`` (``cfg.sampler`` passes through to the schedule, so 'dpmpp'
selects DPM-Solver++(2M); H and W come from the conditioning, so one model
serves 128x128 and 448x1024; ``return_every`` gives trajectories) and
``val_step`` with its metrics and the ``grad_flow`` probe.  With
``cfg.remat`` the model closure (UNet, then splat) is rematerialised in the
backward (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``).  Randomness
comes from an explicit ``torch.Generator`` on the model's device.  The latent
mode, the other targets and the image artifacts come with later slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from . import augmentation
from .base import compute_dtype, pair_batch
from ..config import FlowDiffuserConfig
from ..models import diffusion as dm
from ..models.unet import Unet, init_weights
from ..ops.warp import warp_forward_flow
from ..utils.grad_stats import tensor_stats


def make_warp_fn(flow_max: float, dim: int):
    """The pyramid loss's warp: splat ``image[:, :dim]`` by ``flow * flow_max``."""

    def warp_fn(image, flow, **kwargs):
        return warp_forward_flow(image[:, :dim], flow * flow_max, **kwargs)

    return warp_fn


class UnetWithWarp(nn.Module):
    """UNet that predicts flow and splats the conditioning by it.  Output
    channels: warped (dim) [+ flow (2) when ``full_output``]."""

    def __init__(self, flow_max: float, dim: int, channels: int, full_output: bool,
                 zero_init: bool = True, out_dim: int = 2, unet_dim: int = 64,
                 dtype=torch.float32, conv_backend: str = "cudnn"):
        super().__init__()
        self.flow_max = float(flow_max)
        self.dim = dim
        self.full_output = full_output
        self.dtype = dtype
        self.model = Unet(unet_dim, out_dim=out_dim, channels=channels,
                          zero_init_final=zero_init, dtype=dtype, conv_backend=conv_backend)

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
    """The flagship algorithm.  ``device`` defaults to cuda; the module starts
    in eval mode (the trainer switches it)."""

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
            unet_dim=cfg.unet_dim, dtype=self.dtype, conv_backend=cfg.conv_backend,
        )
        init_weights(self.module, generator if generator is not None else torch.Generator())
        self.module.to(self.device).eval()
        self.warp_fn = make_warp_fn(self.flow_max, self.dim)
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
        """The UnetWithWarp closure; under ``cfg.remat``, when a gradient is
        taken, only its inputs are kept and it runs again in the backward."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(self.module, x, cond, t, use_reentrant=False)
        return self.module(x, cond, t)

    def preprocess(self, batch, aug: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(tgt_x, cond, flow_n) of a batch; ``aug`` applies the
        flow-consistent augmentation with parameters drawn from ``generator``."""
        img, tgt, flow = pair_batch(batch)
        if aug:
            img, tgt, flow = augmentation.augment(img, tgt, flow, generator)
        flow_n = torch.clamp(flow / self.flow_max, -1.0, 1.0)
        img = 2.0 * img - 1.0
        tgt_x = torch.cat([warp_forward_flow(img, flow_n * self.flow_max), flow_n], dim=1)
        return tgt_x, img, flow_n

    def draw_loss_inputs(self, tgt_x, generator: Optional[torch.Generator] = None):
        """The timesteps (B,) and the forward-process noise of one loss, in
        that order from ``generator`` (JAX draws t, then the noise)."""
        B = tgt_x.shape[0]
        dev = generator.device if generator is not None else tgt_x.device
        t = torch.randint(0, self.sched.num_timesteps, (B,), generator=generator, device=dev)
        noise = torch.randn(tgt_x.shape, generator=generator, device=dev)
        return t.to(tgt_x.device), noise.to(tgt_x.device)

    def loss(self, tgt_x, cond, flow_n, generator: Optional[torch.Generator] = None,
             override=None, t=None, noise=None) -> torch.Tensor:
        """The diffusion loss (JAX ``_diffusion_loss``): the pyramid loss at
        timesteps ``t`` with forward-process ``noise``, both drawn from
        ``generator`` unless given."""
        if t is None or noise is None:
            t, noise = self.draw_loss_inputs(tgt_x, generator)
        return dm.p_losses(self.sched, self.model_fn, tgt_x, t, noise, external_cond=cond,
                           warp_fn=self.warp_fn, image_channels=self.dim,
                           model_out_override=override)

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None):
        """(loss, metrics) of one augmented training batch."""
        tgt_x, cond, flow_n = self.preprocess(batch, aug=True, generator=generator)
        loss = self.loss(tgt_x, cond, flow_n, generator)
        metrics = {**tensor_stats("train/cond", cond), **tensor_stats("train/flow", flow_n)}
        return loss, metrics

    def _return_every(self, return_every: Optional[int]) -> Optional[int]:
        """The trajectory stride JAX uses: at most the number of DDIM steps,
        and for the ancestral loop the largest stride <= the request that
        divides T."""
        if return_every is None:
            return None
        sched = self.sched
        ancestral = sched.sampler == "ancestral" or (
            sched.sampler == "auto" and not sched.is_ddim_sampling)
        if not ancestral:
            return max(1, min(int(return_every), sched.sampling_timesteps))
        k = min(int(return_every), sched.num_timesteps)
        while sched.num_timesteps % k:
            k -= 1
        return k

    @torch.no_grad()
    def sample(self, cond, generator: Optional[torch.Generator] = None,
               x_T=None, noises=None, return_every: Optional[int] = None):
        """(warped frame, flow) sampled for ``cond`` (B, 3, H, W): the final
        states (B, 3, H, W) and (B, 2, H, W), or with ``return_every`` the
        trajectories (B, K, 3, H, W) and (B, K, 2, H, W) as JAX returns them.
        ``x_T`` and ``noises`` replace the draws from ``generator`` (see
        ``models/diffusion.py``)."""
        B, _, H, W = cond.shape
        out = dm.sample(self.sched, self.model_fn, (B, self.channels, H, W),
                        external_cond=cond, generator=generator, x_T=x_T,
                        noises=noises, return_every=self._return_every(return_every),
                        device=cond.device)
        return out[..., : self.dim, :, :], out[..., self.dim:, :, :]

    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(metrics, artifacts) of one validation batch (JAX ``val_step``):
        the loss, the sampled frame's MSE, the ideal loss (the ground-truth
        flow's warp in place of the model's), the EPE of the sampled flow,
        the t = 0 probe (``val/last_step``, ``val/last_step_epe``) and the
        descent direction of the pyramid loss in the flow, ``grad_flow``."""
        img, tgt, flow = pair_batch(batch)
        tgt_x, cond, flow_n = self.preprocess(batch)
        with torch.no_grad():
            t, noise = self.draw_loss_inputs(tgt_x, generator)
            loss = self.loss(tgt_x, cond, flow_n, t=t, noise=noise)
        samples_traj, flow_traj = self.sample(cond, generator, return_every=50)
        samples = samples_traj[:, -1]
        p_flows = flow_traj[:, -1] * self.flow_max
        epe = lambda f: torch.sqrt((flow - f).square().sum(dim=1) + 1e-12).mean()
        with torch.no_grad():
            mse = (torch.nan_to_num(samples) - tgt).square().mean()
            ideal_warp = warp_forward_flow(cond[:, : self.dim], flow_n * self.flow_max)
            ideal = self.loss(tgt_x, cond, flow_n, override=torch.cat([ideal_warp, flow_n], 1),
                              t=t, noise=noise)
            B = img.shape[0]
            zero_t = torch.zeros(B, dtype=torch.long, device=cond.device)
            last_step = self.model_fn(tgt_x, cond, zero_t)[:, -2:]
        metrics = {
            "val/loss": loss, "val/mse": mse, "val/ideal_loss": ideal, "val/epe": epe(p_flows),
            **tensor_stats("val/cond", cond), **tensor_stats("val/flow", flow),
            **tensor_stats("val/samples", torch.nan_to_num(samples)),
            **tensor_stats("val/p_flow", p_flows),
            "val/last_step": (last_step - flow_n).square().mean(),
            "val/last_step_epe": epe(last_step * self.flow_max),
        }
        pf = p_flows.detach().clone().requires_grad_()
        with torch.enable_grad():
            probe = dm.pyramid_loss(warp_forward_flow(cond, pf), tgt_x[:, : self.dim], flow_n,
                                    cond, pf / self.flow_max, self.warp_fn)
            (grad,) = torch.autograd.grad(probe, pf)
        artifacts = {
            "samples": samples, "p_flows": p_flows, "mid_samples": samples_traj,
            "mid_flows": flow_traj * self.flow_max, "cond": cond, "tgt_x": tgt_x,
            "flow_n": flow_n, "last_step_flow": last_step * self.flow_max, "grad_flow": -grad,
        }
        return metrics, artifacts


__all__ = ["UnetWithWarp", "FlowDiffuser", "make_warp_fn"]
