"""FlowLearner (JAX ``algorithms/flow_learner.py``): unsupervised optical
flow from the photometric splat pyramid, NCHW.

A UNet maps the frame pair (6 channels, in [-1, 1]) to a flow (2 channels,
times ``flow_max``) and a splat weight (1 channel); the loss is the
photometric pyramid (``ops/pyramid.py``: 832 (level, offset) splats of the
image and as many of the target at the default levels) plus 0.01 times the
edge-aware smoothness.  With ``cfg.radius`` the filter representation maps
the pair to a per-pixel R x R gather filter with colour columns
(``FilterUnet``); its flow is the filter's mean tap offset with unit
weights, and the loss adds the occlusion-masked photometric term of the
filter's own forward warp and a sparsity prior.  Randomness (the
augmentation) comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import augmentation
from .base import compute_dtype, pair_batch
from ..config import FlowLearnerConfig
from ..models.filter_codec import ConvToFilter
from ..models.unet import Unet, init_weights
from ..ops import filters as fops
from ..ops.pyramid import photometric_pyramid_loss
from ..ops.splat import _softsplat
from ..ops.warp import edgeaware_smoothness1
from ..utils import visualization as viz
from ..utils.grad_stats import tensor_stats

# the UNet width of both models, fixed in the JAX package
WIDTH = 64


class FlowUnet(nn.Module):
    """The UNet emitting flow (2) and splat weight (1) from a frame pair (6)."""

    def __init__(self, zero_init: bool = True, dtype=torch.float32, conv_backend: str = "cudnn"):
        super().__init__()
        self.model = Unet(WIDTH, out_dim=3, channels=6, time_in=False,
                          zero_init_final=zero_init, dtype=dtype, conv_backend=conv_backend)

    def forward(self, cond):
        return self.model(cond)


class FilterUnet(nn.Module):
    """The UNet emitting a packed per-pixel filter [R^2, col (3), colw (1)],
    through the ConvToFilter codec when ``c2f``; normalised as (out + 1) /
    (R^2 + 1), the colour channels / 2."""

    def __init__(self, radius: int, c2f: bool = False, dtype=torch.float32,
                 conv_backend: str = "cudnn"):
        super().__init__()
        self.radius, self.c2f = radius, c2f
        dim = 81 if c2f else radius ** 2
        self.model = Unet(WIDTH, out_dim=dim + 4, channels=6, time_in=False, dtype=dtype,
                          conv_backend=conv_backend)
        if c2f:
            self.codec = ConvToFilter(radius, in_dim=81)
        mean = torch.full((radius ** 2 + 4,), float(radius ** 2 + 1))
        mean[-4:-1] = 2.0
        self.register_buffer("mean_val", mean.view(1, -1, 1, 1), persistent=False)

    def forward(self, cond):
        out = self.model(cond)
        if self.c2f:
            out = torch.cat([self.codec(out[:, :-4]), out[:, -4:]], dim=1)
        return (out + 1.0) / self.mean_val


class FlowLearner:
    """``device`` defaults to cuda; the weights are drawn from ``generator``;
    the module starts in eval mode (the trainer switches it)."""

    name = "flow_learner"

    def __init__(self, cfg: FlowLearnerConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg.precision)
        self.image_size = int(cfg.image_size)
        if cfg.radius is not None:
            if cfg.flow_max is not None:
                raise ValueError("cannot specify both flow_max and radius")
            self.radius = int(cfg.radius)
            self.flow_max = float(self.radius // 2)
            self.rep = "filter"
            self.module = FilterUnet(self.radius, bool(cfg.c2f), self.dtype, cfg.conv_backend)
        else:
            self.radius = None
            self.flow_max = float(cfg.flow_max)
            self.rep = "flow"
            self.module = FlowUnet(bool(cfg.zero_init), self.dtype, cfg.conv_backend)
        self.levels = tuple(int(v) for v in cfg.levels)
        init_weights(self.module, generator if generator is not None else torch.Generator())
        self.module.to(self.device).eval()

    # -- data ------------------------------------------------------------------
    def preprocess(self, batch, aug: bool = True, generator: Optional[torch.Generator] = None):
        """(tgt, cond, flow_n): the target frame and the pair in [-1, 1], the
        flow over ``flow_max`` clamped to [-1, 1]; ``aug`` augments first
        with parameters drawn from ``generator``."""
        img, tgt, flow = pair_batch(batch)
        if aug:
            img, tgt, flow = augmentation.augment(img, tgt, flow, generator)
        flow_n = torch.clamp(flow / self.flow_max, -1.0, 1.0)
        img, tgt = 2.0 * img - 1.0, 2.0 * tgt - 1.0
        return tgt, torch.cat([img, tgt], dim=1), flow_n

    # -- loss ------------------------------------------------------------------
    def _predict(self, cond):
        """(flow_pred in pixels, warp weights, packed filter or None)."""
        out = self.module(cond)
        if self.rep == "flow":
            return out[:, :2] * self.flow_max, out[:, 2:3], None
        flow_pred = fops.filter_to_flow(out)
        return flow_pred, torch.ones_like(flow_pred[:, :1]), out

    def loss(self, tgt, cond, flow_n, override_flow=None) -> torch.Tensor:
        """The photometric pyramid of the frame by the predicted flow (or by
        ``override_flow`` times flow_max with unit weights) plus 0.01 of the
        smoothness; the filter terms for the filter representation."""
        if override_flow is None:
            flow_pred, weights, packed = self._predict(cond)
        else:
            flow_pred = override_flow * self.flow_max
            weights, packed = torch.ones_like(flow_pred[:, :1]), None
        img = cond[:, :3]
        loss = photometric_pyramid_loss(img.to(self.dtype), tgt.to(self.dtype), flow_pred,
                                        weights, self.levels)
        loss = loss + 0.01 * edgeaware_smoothness1(img, flow_pred)
        if packed is not None:
            packed_noim = torch.cat([packed[:, :-1], torch.zeros_like(packed[:, -1:])], dim=1)
            warped_noim = fops.warp_forward_filter(img, packed_noim)
            if self.cfg.occlusion_mask:
                mask = fops.occlusion_mask(packed_noim)
            else:
                mask = torch.ones_like(img[:, :1])
            diff = (warped_noim - tgt).square() * mask
            noim_photo = diff.sum() / torch.clamp(mask.sum() * 3, min=1.0)
            sparsity = packed[:, : self.radius ** 2].abs().mean()
            loss = loss + noim_photo + sparsity * float(self.cfg.sparsity_weight)
        return loss

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None):
        """(loss, metrics) of one training batch (augmented when
        ``train_aug``)."""
        tgt, cond, flow_n = self.preprocess(batch, aug=bool(self.cfg.train_aug),
                                            generator=generator)
        loss = self.loss(tgt, cond, flow_n)
        return loss, {**tensor_stats("train/cond", cond), **tensor_stats("train/flow", flow_n)}

    # -- sampling / validation -------------------------------------------------
    def sample(self, cond):
        """(samples, flow_pred, weights, packed): the first frame soft-splatted
        by the predicted flow, NaN where no weight landed (the splat's hole
        mask, JAX's ``weights > 0``)."""
        flow_pred, weights, packed = self._predict(cond)
        sw, mask = _softsplat(cond[:, :3], flow_pred, weights, "soft")
        samples = torch.where(mask, sw[:, :-1], torch.full_like(sw[:, :-1], float("nan")))
        return samples, flow_pred, weights, packed

    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(metrics, artifacts) of one validation batch: the loss, the ideal
        loss (the ground-truth flow with unit weights), the sample's MSE
        against the target frame as JAX takes it (the sample in [-1, 1], the
        frame in [0, 1]), the flow MSE and EPE, the filter statistics, and
        ``grad_flow``, the descent direction of the loss in the flow (through
        the splat backward)."""
        img, tgt, flow = pair_batch(batch)
        tgt_, cond, flow_n = self.preprocess(batch, aug=False)
        with torch.no_grad():
            loss = self.loss(tgt_, cond, flow_n)
            ideal = self.loss(tgt_, cond, flow_n, override_flow=flow_n)
            samples, p_flows, warp_weights, packed = self.sample(cond)
            samples_f = torch.nan_to_num(samples)
            metrics = {
                "val/loss": loss, "val/ideal_loss": ideal,
                "val/mse": (samples_f - tgt).square().mean(),
                "val/flow_mse": (flow_n - p_flows / self.flow_max).square().mean(),
                "val/epe": torch.sqrt((flow - p_flows).square().sum(dim=1) + 1e-12).mean(),
                **tensor_stats("val/cond", cond), **tensor_stats("val/flow", flow),
                **tensor_stats("val/samples", samples_f), **tensor_stats("val/p_flow", p_flows),
            }
            if packed is not None:
                fil = packed[:, : self.radius ** 2]
                metrics["val/filter_sum"] = fil.sum(dim=1).mean()
                metrics["val/filter_min"] = fil.min()
                metrics["val/filter_max"] = fil.max()
                metrics["val/filter_sparsity"] = (fil.abs().amax(dim=1)
                                                  / (1e-4 + fil.abs().sum(dim=1))).mean()
        pf = p_flows.detach().clone().requires_grad_()
        with torch.enable_grad():
            probe = self.loss(tgt_, cond, flow_n, override_flow=pf / self.flow_max)
            (grad,) = torch.autograd.grad(probe, pf)
        artifacts = {"samples": samples_f, "p_flows": p_flows, "warp_weights": warp_weights,
                     "grad_flow": -grad}
        return metrics, artifacts

    def visualize(self, batch, artifacts) -> Dict[str, np.ndarray]:
        """NHWC float images of one validation batch and its artifacts."""
        nhwc = lambda t: np.asarray(t.detach().float().cpu()).transpose(0, 2, 3, 1)
        img, tgt, flow = (nhwc(x) for x in pair_batch(batch))
        p_flows = nhwc(artifacts["p_flows"])
        B = img.shape[0]
        flos = viz.flow_to_image(np.concatenate([flow, p_flows, flow - p_flows], axis=0))
        return {
            "original": img,
            "target": tgt,
            "gt_flow": flos[:B],
            "target_p": flos[B: 2 * B],
            "concat": np.concatenate([flos[:B], flos[B: 2 * B]], axis=2),
            "difference": flos[2 * B:],
            "warp_weights": nhwc(artifacts["warp_weights"]),
            "samples": np.clip((nhwc(artifacts["samples"]) + 1) * 0.5, 0, 1),
            "grad_flow": viz.flow_to_image(nhwc(artifacts["grad_flow"])),
        }


__all__ = ["FilterUnet", "FlowLearner", "FlowUnet"]
