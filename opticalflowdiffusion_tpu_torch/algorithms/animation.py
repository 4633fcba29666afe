"""The animation family (JAX ``algorithms/animation.py``): FrameGenerator
and FlowCompleter, NCHW.

Batches are stacks of ``[target (3), last frame (3), flow (2)]``: a
training batch (B, 8, H, W), a validation batch (B, T, 8, H, W) of T
consecutive transitions (``data/artificial_video.py``).

* FrameGenerator: a conditional DDPM of the next frame (the UNet on the
  noisy frame and the conditioning [last frame, flow], 8 channels, time in;
  ``pred_noise`` on the sigmoid schedule), target and conditioning mapped
  to 2x - 1.  Validation samples the next frame (the 1000-step ancestral
  loop, DDIM with ``sampling_timesteps``) and rolls out over the T
  transitions, each sample the next step's last frame.
* FlowCompleter: the dense flow from at most ``MAX_SPARSE`` sparse samples
  of it and the frame (a UNet of 5 channels without time, float32 whatever
  the precision, as JAX builds it without a dtype); the samples are a
  Gumbel top-k over log(|flow| + mean |flow|) with a random count kept, the
  other pixels a learnt ``null_embedding``; the loss is the flow error's
  norm weighted by 0.2 + |flow| / max |flow|.

Randomness comes from explicit ``torch.Generator``s; the tests feed JAX's
draws into the deterministic cores (``FrameGenerator.loss``,
``FlowCompleter.sparse_mask``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .base import compute_dtype
from ..config import FlowCompleterConfig, FrameGeneratorConfig
from ..models import diffusion as dm
from ..models.unet import Unet, init_weights
from ..utils import visualization as viz

# the UNet width, fixed in the JAX package
WIDTH = 64
# FlowCompleter's sparse samples: at most 9 (the reference's randint(8) + 1)
MAX_SPARSE = 9


def _nhwc(t) -> np.ndarray:
    return np.asarray(t.detach().float().cpu()).transpose(0, 2, 3, 1)


def weighted_mse_loss(inp, target, weight):
    """The mean of ``weight`` times the per-pixel error norm over channels."""
    return (weight * torch.linalg.vector_norm(inp - target, dim=1)).mean()


class FrameGenerator:
    """``device`` defaults to cuda; the weights are drawn from ``generator``;
    the module starts in eval mode (the trainer switches it)."""

    name = "frame_generator"

    def __init__(self, cfg: FrameGeneratorConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg.precision)
        self.image_size = int(cfg.image_size)
        self.module = Unet(WIDTH, channels=3 + 3 + 2, out_dim=3, dtype=self.dtype,
                           conv_backend=cfg.conv_backend)
        init_weights(self.module, generator if generator is not None else torch.Generator())
        self.module.to(self.device).eval()
        self.sched = dm.make_schedule(timesteps=int(cfg.timesteps),
                                      sampling_timesteps=cfg.sampling_timesteps,
                                      objective="pred_noise", device=self.device)

    def model_fn(self, x, cond, t):
        return self.module(x, cond, t)

    def loss(self, target, cond, t, noise):
        """The diffusion loss of the next frame ``target`` (B, 3, H, W) given
        ``cond`` (B, 5, H, W), both in [0, 1] (mapped to 2x - 1), at
        timesteps ``t`` with the forward-process ``noise``."""
        return dm.p_losses(self.sched, self.model_fn, 2 * target - 1, t, noise,
                           external_cond=2 * cond - 1)

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None):
        """(loss, {}) of one training batch; t, then the noise, from
        ``generator`` (JAX's order)."""
        x = batch[0]
        target, cond = x[:, :3], x[:, 3:]
        dev = generator.device if generator is not None else x.device
        t = torch.randint(0, self.sched.num_timesteps, (x.shape[0],), generator=generator,
                          device=dev)
        noise = torch.randn(target.shape, generator=generator, device=dev)
        return self.loss(target, cond, t.to(x.device), noise.to(x.device)), {}

    def sample(self, cond, generator: Optional[torch.Generator] = None, x_T=None,
               noises=None, return_every: Optional[int] = None):
        """Next frames in [0, 1] for ``cond`` (B, 5, H, W) ([last frame,
        flow] in [0, 1]); ``x_T`` and ``noises`` replace the draws from
        ``generator`` (``models/diffusion.py``)."""
        B, _, H, W = cond.shape
        img = dm.sample(self.sched, self.model_fn, (B, 3, H, W), external_cond=2 * cond - 1,
                        generator=generator, x_T=x_T, noises=noises, return_every=return_every,
                        device=cond.device)
        return (img + 1.0) * 0.5

    def rollout(self, x, generator: Optional[torch.Generator] = None):
        """The autoregressive rollout over the T transitions of ``x`` (B, T,
        8, H, W): step t samples from [the previous sample (the given last
        frame at t = 0), the flow of step t]; (B, T, 3, H, W)."""
        frames, prev = [], None
        for it in range(x.shape[1]):
            cond_t = x[:, it, 3:]
            if it != 0:
                cond_t = torch.cat([prev, cond_t[:, 3:]], dim=1)
            s = self.sample(cond_t, generator)
            prev = s[:, :3]
            frames.append(s)
        return torch.stack(frames, dim=1)

    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(metrics, artifacts) of one validation batch: the loss and a
        sample on the first transition, and for a (B, T, 8, H, W) batch the
        rollout over all T."""
        x = batch[0]
        rollout = x.dim() == 5
        x0 = x[:, 0] if rollout else x
        with torch.no_grad():
            loss, _ = self.loss_fn((x0,), generator)
            cond = x0[:, 3:]
            samples = self.sample(cond, generator)
            artifacts = {"samples": samples, "targets": x0[:, :3], "last_frames": cond[:, :3],
                         "flows": cond[:, 3:]}
            if rollout:
                artifacts["rollout"] = self.rollout(x, generator)
                artifacts["rollout_gt"] = x[:, :, :3]
        return {"val/loss": loss}, artifacts

    def visualize(self, batch, artifacts) -> Dict[str, np.ndarray]:
        """NHWC float images; ``val/rollout`` is the ground-truth strip over
        the sampled one (the T frames side by side)."""
        out = {
            "val/samples": np.clip(_nhwc(artifacts["samples"]), 0, 1),
            "val/targets": _nhwc(artifacts["targets"]),
            "val/last_frames": _nhwc(artifacts["last_frames"]),
            "val/flows": viz.flow_to_image(_nhwc(artifacts["flows"])),
        }
        if "rollout" in artifacts:
            strip = lambda v: np.concatenate([_nhwc(v[:, k]) for k in range(v.shape[1])], axis=2)
            out["val/rollout"] = np.concatenate(
                [strip(artifacts["rollout_gt"]), np.clip(strip(artifacts["rollout"]), 0, 1)],
                axis=1)
        return out


class FlowCompleterNet(nn.Module):
    """The UNet on [sparse flow, frame] (float32, no time) and the learnt
    embedding of the pixels without a sample."""

    def __init__(self, conv_backend: str = "cudnn"):
        super().__init__()
        self.net = Unet(WIDTH, channels=3 + 2, out_dim=2, time_in=False,
                        conv_backend=conv_backend)
        self.null_embedding = nn.Parameter(torch.ones(2))

    def forward(self, sparse_flow, frame):
        return self.net(torch.cat([sparse_flow, frame], dim=1))


class FlowCompleter:
    """``device`` defaults to cuda; the weights are drawn from ``generator``
    (the null embedding starts at ones); the module starts in eval mode."""

    name = "flow_completer"

    def __init__(self, cfg: FlowCompleterConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.image_size = int(cfg.image_size)
        self.module = FlowCompleterNet(cfg.conv_backend)
        init_weights(self.module, generator if generator is not None else torch.Generator())
        with torch.no_grad():
            self.module.null_embedding.fill_(1.0)
        self.module.to(self.device).eval()
        self.lmbd = 0.2

    @staticmethod
    def draw(dense, generator: Optional[torch.Generator] = None):
        """(Gumbel noise (B, H*W), counts (B, 1) in [1, MAX_SPARSE]) from
        ``generator``."""
        B, _, H, W = dense.shape
        dev = generator.device if generator is not None else dense.device
        expo = torch.empty((B, H * W), device=dev).exponential_(generator=generator)
        counts = torch.randint(1, MAX_SPARSE + 1, (B, 1), generator=generator, device=dev)
        return -torch.log(expo).to(dense.device), counts.to(dense.device)

    @staticmethod
    def sparse_mask(dense, gumbel, counts):
        """(mask (B, 1, H, W), |flow| (B, H, W)): the first ``counts`` of the
        MAX_SPARSE pixels with the largest log(|flow| + mean |flow| + 1e-9)
        + ``gumbel`` (ties to the lower index, as XLA's top_k)."""
        B, _, H, W = dense.shape
        mags = torch.linalg.vector_norm(dense, dim=1)
        logits = torch.log(mags.reshape(B, -1) + mags.mean() + 1e-9)
        picked = torch.sort(logits + gumbel, dim=1, descending=True, stable=True)[1][
            :, :MAX_SPARSE]
        keep = (torch.arange(MAX_SPARSE, device=dense.device)[None, :] < counts).float()
        mask = torch.zeros((B, H * W), device=dense.device).scatter_reduce(
            1, picked, keep, reduce="amax")
        return mask.reshape(B, 1, H, W), mags

    def complete(self, x, mask):
        """The dense flow completed from the samples of ``x``'s flow (B, 8,
        H, W) under ``mask``."""
        null = self.module.null_embedding.view(1, 2, 1, 1)
        sparse = mask * x[:, -2:] + (1 - mask) * null
        return self.module(sparse, x[:, 3:6])

    def loss(self, x, mask, mags):
        """The peak-weighted flow error of the completion (the peak floored
        at 1e-6: a static sample would divide 0 by 0)."""
        out = self.complete(x, mask)
        peak = torch.clamp(mags.amax(dim=(1, 2), keepdim=True), min=1e-6)
        weight = self.lmbd + mags / peak
        return weighted_mse_loss(out, x[:, -2:], weight), out

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None):
        x = batch[0]
        mask, mags = self.sparse_mask(x[:, -2:], *self.draw(x[:, -2:], generator))
        return self.loss(x, mask, mags)[0], {}

    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The loss and completion of the first transition (one draw of the
        samples for both, as JAX reuses its key)."""
        x = batch[0]
        if x.dim() == 5:
            x = x[:, 0]
        with torch.no_grad():
            mask, mags = self.sparse_mask(x[:, -2:], *self.draw(x[:, -2:], generator))
            loss, out = self.loss(x, mask, mags)
        return {"val/loss": loss}, {"out": out, "frame": x[:, 3:6], "dense": x[:, -2:]}

    def visualize(self, batch, artifacts) -> Dict[str, np.ndarray]:
        return {
            "frames": _nhwc(artifacts["frame"]),
            "real_flows": viz.flow_to_image(_nhwc(artifacts["dense"])),
            "predictions": viz.flow_to_image(_nhwc(artifacts["out"])),
        }


__all__ = ["FlowCompleter", "FlowCompleterNet", "FrameGenerator", "MAX_SPARSE",
           "weighted_mse_loss"]
