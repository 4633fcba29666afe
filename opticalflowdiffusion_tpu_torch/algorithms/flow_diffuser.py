"""FlowDiffuser (JAX ``algorithms/flow_diffuser.py``), NCHW.

Given frame 1 as the conditioning, the model denoises to the forward-warped
frame and its flow together (``target='joint'``, the flagship), to the
warped frame with the flow as an extra output head (``'target'``), or to
the flow alone (``'flow'``: the plain UNet; the sample is the conditioning
splatted by the final flow).  For the first two the UNet predicts a flow and
the conditioning is splatted by it (``UnetWithWarp``).  ``is_diffusion``
false is the single-forward model: no time input, no schedule, one forward
from the conditioning.  ``noiser='flow'`` is the permutation-warp forward
process (``models/diffusion.py``).  In latent mode (``latent``) the frames
are encoded by a frozen Autoencoder (``models/autoencoder.py``), loaded from
the run named by ``cfg.ae`` or drawn from the seed, and the model runs on
the latents.

Ported: ``UnetWithWarp``; ``FlowDiffuser`` with ``preprocess`` (with and
without augmentation), the training loss (``loss``, ``loss_fn``; the
diffusion loss takes ``diffusion_flow_weight``, the single-forward loss
``flow_weight``), ``sample`` (``cfg.sampler`` passes through to the
schedule, so 'dpmpp' selects DPM-Solver++(2M); H and W come from the
conditioning, so one model serves 128x128 and 448x1024; ``return_every``
gives trajectories) and ``val_step`` with JAX's metrics per target and
model, the t = 0 probe and the ``grad_flow`` probe.  With ``cfg.remat`` the
model closure is rematerialised in the backward (``torch.utils.checkpoint``,
JAX's ``jax.checkpoint``).  Randomness comes from an explicit
``torch.Generator`` on the model's device.  ``visualize`` turns a
validation batch and its artifacts into JAX's images (the samples decoded
in latent mode).

One deliberate difference: the single-forward loss takes its frame MSE over
the finite pairs (``nan_mse``).  JAX's plain mean is NaN whenever the
target, a splat, has a hole, which the artificial frames always give; where
JAX's mean is finite the two are the same.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from . import augmentation
from .base import compute_dtype, pair_batch
from ..config import FlowDiffuserConfig
from ..models import diffusion as dm
from ..models.autoencoder import Autoencoder
from ..models.unet import Unet, init_weights
from ..ops.warp import nan_mse, warp_forward_flow
from ..utils.ckpt import load_params_from_run
from ..utils import visualization as viz
from ..utils.grad_stats import tensor_stats

TARGETS = ("joint", "target", "flow")


def make_warp_fn(flow_max: float, dim: int):
    """The pyramid loss's warp: splat ``image[:, :dim]`` by ``flow * flow_max``."""

    def warp_fn(image, flow, **kwargs):
        return warp_forward_flow(image[:, :dim], flow * flow_max, **kwargs)

    return warp_fn


class UnetWithWarp(nn.Module):
    """UNet that predicts flow and splats the conditioning by it.  Output
    channels: warped (dim) [+ flow (2) when ``full_output`` or
    ``additional_out``].  ``channels`` is the UNet's input width: the state,
    its NaN-indicator channel and the conditioning."""

    def __init__(self, flow_max: float, dim: int, channels: int, full_output: bool,
                 zero_init: bool = True, out_dim: int = 2, unet_dim: int = 64,
                 dtype=torch.float32, conv_backend: str = "cudnn", time_in: bool = True):
        super().__init__()
        self.flow_max = float(flow_max)
        self.dim = dim
        self.full_output = full_output
        self.dtype = dtype
        self.model = Unet(unet_dim, out_dim=out_dim, channels=channels,
                          zero_init_final=zero_init, dtype=dtype, conv_backend=conv_backend,
                          time_in=time_in)

    def _warp(self, image, flow):
        # values splat in the compute dtype; the flow (coordinates) stays f32
        src = image[:, : self.dim].to(self.dtype)
        return warp_forward_flow(src, flow * self.flow_max).to(image.dtype)

    def forward(self, x, external_cond=None, t=None, additional_out: bool = False):
        # NaN holes of the state go in as zeros plus a NaN-indicator channel
        nan = torch.isnan(x)
        nan_ch = nan.any(dim=1, keepdim=True).to(x.dtype)
        x = torch.where(nan, torch.zeros_like(x), x)
        flow = self.model(torch.cat([x, nan_ch], dim=1), external_cond, t)
        src = external_cond if external_cond is not None else x[:, : self.dim]
        out = self._warp(src, flow[:, :2])
        if self.full_output or additional_out:
            out = torch.cat([out, flow], dim=1)
        return out


class FlowDiffuser:
    """The flagship algorithm and its other configurations.  ``device``
    defaults to cuda; the module starts in eval mode (the trainer switches
    it).  ``generator`` draws the module's weights, then (latent mode with
    no ``cfg.ae``) the Autoencoder's."""

    name = "flow_diffuser"

    def __init__(self, cfg: FlowDiffuserConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if cfg.target not in TARGETS:
            raise ValueError(f"target {cfg.target!r} is not one of {TARGETS}")
        if cfg.noiser not in ("image", "flow"):
            raise ValueError(f"noiser {cfg.noiser!r} is not 'image' or 'flow'")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg.precision)
        self.flow_max = float(cfg.flow_max)
        self.latent_max = float(cfg.latent_max)
        self.is_diffusion = bool(cfg.is_diffusion)
        self.latent = bool(cfg.latent)
        self.target = cfg.target
        self.image_size = int(cfg.image_size)
        self.dim = int(cfg.latent_dim) if self.latent else 3
        # the diffusion state: the warped frame, [its flow,] or the flow
        self.channels = {"target": self.dim, "joint": self.dim + 2, "flow": 2}[self.target]
        self._plain_unet = self.target == "flow"
        # the stem's input width is what forward concatenates (JAX infers
        # it): [the state, its NaN channel,] the conditioning; the
        # single-forward model takes the conditioning alone, with
        # UnetWithWarp's NaN channel
        if self._plain_unet:
            stem = self.channels + self.dim if self.is_diffusion else self.dim
            self.module = Unet(cfg.unet_dim, out_dim=2, channels=stem,
                               time_in=self.is_diffusion, zero_init_final=cfg.zero_init,
                               dtype=self.dtype, conv_backend=cfg.conv_backend)
        else:
            stem = self.channels + 1 + self.dim if self.is_diffusion else self.dim + 1
            self.module = UnetWithWarp(
                flow_max=self.flow_max, dim=self.dim, channels=stem,
                full_output=self.target == "joint", zero_init=cfg.zero_init,
                unet_dim=cfg.unet_dim, dtype=self.dtype, conv_backend=cfg.conv_backend,
                time_in=self.is_diffusion,
            )
        generator = generator if generator is not None else torch.Generator()
        init_weights(self.module, generator)
        self.module.to(self.device).eval()
        self.ae = None
        if self.latent:
            self.ae = Autoencoder(self.dim, self.dtype, cfg.conv_backend)
            if cfg.ae:
                self.ae.load_state_dict(load_params_from_run(cfg.ae, prefix="ae."))
            else:
                init_weights(self.ae, generator)
            self.ae.requires_grad_(False)
            self.ae.to(self.device).eval()
        self.warp_fn = make_warp_fn(self.flow_max, self.dim)
        self.sched = None
        if self.is_diffusion:
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

    def model_fn(self, x, cond, t, additional_out: bool = False):
        """The model closure (UnetWithWarp, or the plain UNet of the flow
        target); under ``cfg.remat``, when a gradient is taken, only its
        inputs are kept and it runs again in the backward."""
        args = (x, cond, t) if self._plain_unet else (x, cond, t, additional_out)
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(self.module, *args, use_reentrant=False)
        return self.module(*args)

    def _model_fn_extra(self, x, cond, t):
        """``model_fn`` with the flow head (the ``target`` target)."""
        return self.model_fn(x, cond, t, additional_out=True)

    def _forward(self, cond, additional_out: bool = False):
        """The single-forward model's output for ``cond``."""
        return self.model_fn(cond, None, None, additional_out)

    def _encode(self, x):
        """The Autoencoder's latent of a frame in [0, 1], over ``latent_max``
        and clamped to [-1, 1]."""
        return torch.clamp(self.ae.encode(x) / self.latent_max, -1.0, 1.0)

    def _decode(self, lat, img):
        """The frame decoded from the latent ``lat``, conditioned on ``img``."""
        return self.ae.decode(lat * self.latent_max, img)

    def preprocess(self, batch, aug: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(tgt_x, cond, flow_n) of a batch; ``aug`` applies the
        flow-consistent augmentation with parameters drawn from ``generator``.
        In latent mode the conditioning is the first frame's latent, encoded
        with no gradient (JAX encodes the second frame too, and nothing reads
        that latent)."""
        img, tgt, flow = pair_batch(batch)
        if aug:
            img, tgt, flow = augmentation.augment(img, tgt, flow, generator)
        flow_n = torch.clamp(flow / self.flow_max, -1.0, 1.0)
        if self.latent:
            with torch.no_grad():
                img = self._encode(img)
        else:
            img = 2.0 * img - 1.0
        if self.target == "flow":
            return flow_n, img, flow_n
        tgt_x = warp_forward_flow(img, flow_n * self.flow_max)
        if self.target == "joint":
            tgt_x = torch.cat([tgt_x, flow_n], dim=1)
        return tgt_x, img, flow_n

    def draw_loss_inputs(self, tgt_x, generator: Optional[torch.Generator] = None):
        """The timesteps (B,) and the forward-process noise of one loss, in
        that order from ``generator`` (JAX draws t, then the noise); the
        noise is (B, 2, H, W) under flow noise."""
        B = tgt_x.shape[0]
        dev = generator.device if generator is not None else tgt_x.device
        t = torch.randint(0, self.sched.num_timesteps, (B,), generator=generator, device=dev)
        noise = torch.randn(dm.noise_shape(self.sched, tgt_x.shape), generator=generator,
                            device=dev)
        return t.to(tgt_x.device), noise.to(tgt_x.device)

    def loss(self, tgt_x, cond, flow_n, generator: Optional[torch.Generator] = None,
             override=None, t=None, noise=None) -> torch.Tensor:
        """The diffusion loss (JAX ``_diffusion_loss``): the pyramid loss at
        timesteps ``t`` with forward-process ``noise``, both drawn from
        ``generator`` unless given; ``override`` replaces the model's output
        (for the ``target`` target a pair (frame, flow)).  The single-forward
        model's loss: the MSE of the frame plus ``flow_weight`` times that of
        the flow, or the flow's MSE (the flow target)."""
        if not self.is_diffusion:
            if self._plain_unet:
                return (self._forward(cond) - flow_n).square().mean()
            out = self._forward(cond, additional_out=self.target == "target")
            loss = nan_mse(out[:, : self.dim], tgt_x[:, : self.dim])
            return loss + self.cfg.flow_weight * (out[:, self.dim:] - flow_n).square().mean()
        if t is None or noise is None:
            t, noise = self.draw_loss_inputs(tgt_x, generator)
        kw = dict(external_cond=cond, warp_fn=self.warp_fn, image_channels=self.dim,
                  model_out_override=override,
                  flow_loss_weight=float(self.cfg.diffusion_flow_weight))
        if self.target == "target":
            return dm.p_losses(self.sched, self._model_fn_extra, tgt_x, t, noise,
                               additional_tgt=flow_n, **kw)
        return dm.p_losses(self.sched, self.model_fn, tgt_x, t, noise, **kw)

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
        """(frame, flow) sampled for ``cond`` (B, dim, H, W): the final
        states (B, dim, H, W) and (B, 2, H, W), or with ``return_every`` the
        trajectories (B, K, dim, H, W) and (B, K, 2, H, W) as JAX returns
        them (the ``target`` target's flows are those of the same steps, the
        first step's beside x_T; the flow target's frame is the conditioning
        splatted by the final flow, (B, 1, dim, H, W)).  ``x_T`` and
        ``noises`` replace the draws from ``generator`` (see
        ``models/diffusion.py``).  The single-forward model returns its one
        forward's frame and flow."""
        if not self.is_diffusion:
            if self._plain_unet:
                flow = self._forward(cond)
                return warp_forward_flow(cond[:, : self.dim], flow * self.flow_max), flow
            out = self._forward(cond, additional_out=True)
            return out[:, : self.dim], out[:, -2:]
        B, _, H, W = cond.shape
        every = self._return_every(return_every)
        kw = dict(external_cond=cond, generator=generator, x_T=x_T, noises=noises,
                  return_every=every, device=cond.device)
        shape = (B, self.channels, H, W)
        if self.target == "target":
            return dm.sample(self.sched, self._model_fn_extra, shape, additional_channels=2,
                             **kw)
        out = dm.sample(self.sched, self.model_fn, shape, **kw)
        if self.target == "joint":
            return out[..., : self.dim, :, :], out[..., self.dim:, :, :]
        final = out if every is None else out[:, -1]
        samples = warp_forward_flow(cond[:, : self.dim], final * self.flow_max)
        return (samples, out) if every is None else (samples[:, None], out)

    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(metrics, artifacts) of one validation batch (JAX ``val_step``):
        the loss, the sampled frame's MSE (in latent mode against the
        encoded target), the ideal loss (the ground-truth flow's warp in
        place of the model's; the loss itself for the flow target and the
        single-forward model), the EPE of the sampled flow; for the diffusion
        ``target`` and ``joint`` models also the t = 0 probe
        (``val/last_step``, ``val/last_step_epe``) and the descent direction
        of the pyramid loss in the flow, ``grad_flow``."""
        img, tgt, flow = pair_batch(batch)
        tgt_x, cond, flow_n = self.preprocess(batch)
        t = noise = None
        with torch.no_grad():
            if self.is_diffusion:
                t, noise = self.draw_loss_inputs(tgt_x, generator)
            loss = self.loss(tgt_x, cond, flow_n, t=t, noise=noise)
        if self.is_diffusion:
            samples_traj, flow_traj = self.sample(cond, generator, return_every=50)
            samples = samples_traj[:, -1]
            p_flows = flow_traj[:, -1] * self.flow_max
            mid_samples, mid_flows = samples_traj, flow_traj * self.flow_max
        else:
            samples, p_flows = self.sample(cond)
            p_flows = p_flows * self.flow_max
            mid_samples, mid_flows = samples[:, None], p_flows[:, None]
        epe = lambda f: torch.sqrt((flow - f).square().sum(dim=1) + 1e-12).mean()
        with torch.no_grad():
            tgt_cmp = self._encode(tgt) if self.latent else tgt
            mse = (torch.nan_to_num(samples) - tgt_cmp).square().mean()
            ideal_warp = warp_forward_flow(cond[:, : self.dim], flow_n * self.flow_max)
            override = {"target": (ideal_warp, flow_n),
                        "joint": torch.cat([ideal_warp, flow_n], 1)}.get(self.target)
            ideal = (self.loss(tgt_x, cond, flow_n, override=override, t=t, noise=noise)
                     if self.is_diffusion and override is not None else loss)
        metrics = {
            "val/loss": loss, "val/mse": mse, "val/ideal_loss": ideal, "val/epe": epe(p_flows),
            **tensor_stats("val/cond", cond), **tensor_stats("val/flow", flow),
            **tensor_stats("val/samples", torch.nan_to_num(samples)),
            **tensor_stats("val/p_flow", p_flows),
        }
        artifacts = {
            "samples": samples, "p_flows": p_flows, "mid_samples": mid_samples,
            "mid_flows": mid_flows, "cond": cond, "tgt_x": tgt_x, "flow_n": flow_n,
        }
        if self.is_diffusion and not self._plain_unet:
            with torch.no_grad():
                zero_t = torch.zeros(img.shape[0], dtype=torch.long, device=cond.device)
                last_step = self._model_fn_extra(tgt_x, cond, zero_t)[:, -2:]
            metrics["val/last_step"] = (last_step - flow_n).square().mean()
            metrics["val/last_step_epe"] = epe(last_step * self.flow_max)
            artifacts["last_step_flow"] = last_step * self.flow_max
            pf = p_flows.detach().clone().requires_grad_()
            with torch.enable_grad():
                probe = dm.pyramid_loss(warp_forward_flow(cond, pf), tgt_x[:, : self.dim],
                                        flow_n, cond, pf / self.flow_max, self.warp_fn)
                (grad,) = torch.autograd.grad(probe, pf)
            artifacts["grad_flow"] = -grad
        return metrics, artifacts

    def visualize(self, batch, artifacts) -> Dict[str, np.ndarray]:
        """NHWC float images of one validation batch (NCHW tensors) and its
        artifacts, under JAX's keys.  The diffusion target's frame
        (``diffusion_tgt``) is written for pixel frames only: a latent one has
        ``latent_dim`` channels."""
        def nhwc(t):
            t = t.detach().float().cpu()
            return np.asarray(t.permute(*((0, 2, 3, 1) if t.dim() == 4 else (0, 1, 3, 4, 2))))

        img, tgt, flow = (nhwc(x) for x in pair_batch(batch))
        p_flows = nhwc(artifacts["p_flows"])
        B = img.shape[0]
        flows_rgb = viz.flow_to_image(np.concatenate([flow, p_flows, flow - p_flows], axis=0))
        out = {"original": img, "target": tgt}
        if self.dim == 3:
            out["diffusion_tgt"] = (np.nan_to_num(nhwc(artifacts["tgt_x"])[..., : self.dim])
                                    + 1.0) * 0.5
        out["gt_flow"] = flows_rgb[:B]
        out["target_p"] = flows_rgb[B: 2 * B]
        out["concat"] = np.concatenate([flows_rgb[:B], flows_rgb[B: 2 * B]], axis=2)
        out["difference"] = flows_rgb[2 * B:]
        samples = torch.nan_to_num(artifacts["samples"].detach())
        if self.latent:
            with torch.no_grad():
                dec = self._decode(samples, torch.from_numpy(
                    np.ascontiguousarray(img.transpose(0, 3, 1, 2))).to(samples.device))
            dec = nhwc(dec)
            out["samples"] = dec
            out["compare"] = np.concatenate([img, dec], axis=2)
        else:
            out["samples"] = np.clip((nhwc(samples) + 1.0) * 0.5, 0, 1)
        if "grad_flow" in artifacts:
            out["grad_flow"] = viz.flow_to_image(nhwc(artifacts["grad_flow"]))
        if "last_step_flow" in artifacts:
            ls = viz.flow_to_image(nhwc(artifacts["last_step_flow"]))
            out["last_step"] = np.concatenate([flows_rgb[:B], ls], axis=2)
        if self.is_diffusion:
            mid = np.nan_to_num(nhwc(artifacts["mid_samples"]))[..., : min(self.dim, 3)]
            out["mid_samples"] = np.clip(
                (np.concatenate(list(np.moveaxis(mid, 1, 0)), axis=2) + 1) * 0.5, 0, 1)
            midf = nhwc(artifacts["mid_flows"])
            midf_rgb = viz.flow_to_image(midf.reshape((-1,) + midf.shape[2:]))
            midf_rgb = midf_rgb.reshape(midf.shape[:2] + midf_rgb.shape[1:])
            out["mid_flows"] = np.concatenate(list(np.moveaxis(midf_rgb, 1, 0)), axis=2)
        return out


__all__ = ["UnetWithWarp", "FlowDiffuser", "TARGETS", "make_warp_fn"]
