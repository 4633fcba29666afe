"""FlowPred (JAX ``algorithms/flow_pred.py``): training of the
flow-equivariant Autoencoder, NCHW.

A step augments the batch, adds N(0, 1) pixel noise to the flow and, with
probability ``ae_frac`` for the whole batch, zeroes the flow and takes the
input frame itself as the target (identity mixing); the loss is the MSE of
the Autoencoder's reconstruction (encode, splat the latent by the flow,
decode).  The draws come in that order from an explicit generator.  The
module keeps the Autoencoder under ``ae``, so a checkpoint of a FlowPred run
holds it under the ``ae.`` prefix that the latent FlowDiffuser reads
(``cfg.ae``).  ``visualize`` gives JAX's images of a validation batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

import numpy as np

from . import augmentation
from .base import compute_dtype, pair_batch
from ..config import FlowPredConfig
from ..models.autoencoder import Autoencoder
from ..models.unet import init_weights
from ..utils import visualization as viz


class FlowPredModule(nn.Module):
    """The trained module: the Autoencoder as ``ae``."""

    def __init__(self, latent_dim: int, dtype=torch.float32, conv_backend: str = "cudnn"):
        super().__init__()
        self.ae = Autoencoder(latent_dim, dtype, conv_backend)

    def forward(self, x, flow):
        return self.ae(x, flow)


class FlowPred:
    """``device`` defaults to cuda; the weights are drawn from ``generator``;
    the module starts in eval mode (the trainer switches it)."""

    name = "flow_pred"

    def __init__(self, cfg: FlowPredConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg.precision)
        self.image_size = int(cfg.image_size)
        self.ae_frac = float(cfg.ae_frac)
        self.module = FlowPredModule(int(cfg.latent_dim), self.dtype, cfg.conv_backend)
        init_weights(self.module, generator if generator is not None else torch.Generator())
        self.module.to(self.device).eval()
        self.ae = self.module.ae

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None, aug_params=None,
                noise=None, use_identity=None):
        """(loss, metrics) of one training batch.  The augmentation's
        parameters, the flow noise (B, 2, H, W) and the identity coin (a
        bool tensor) are drawn from ``generator`` in that order unless
        given."""
        img, tgt, flow = pair_batch(batch)
        dev = generator.device if generator is not None else flow.device
        if aug_params is None:
            aug_params = augmentation.draw(img.shape[0], generator)
        img, tgt, flow = augmentation.apply(aug_params, img, tgt, flow)
        if noise is None:
            noise = torch.randn(flow.shape, generator=generator, device=dev)
        flow = flow + noise.to(flow.device)
        if use_identity is None:
            use_identity = torch.rand((), generator=generator, device=dev) < self.ae_frac
        use_identity = torch.as_tensor(use_identity, device=flow.device)
        flow_in = torch.where(use_identity, torch.zeros_like(flow), flow)
        target = torch.where(use_identity, img, tgt)
        out = self.module(img, flow_in)
        return (out - target).square().mean(), {}

    @torch.no_grad()
    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The reconstruction MSE of the batch with its own flow, and the
        reconstruction."""
        img, tgt, flow = pair_batch(batch)
        out = self.module(img, flow)
        return {"val/loss": (out - tgt).square().mean()}, {"out": out}

    def visualize(self, batch, artifacts) -> Dict[str, np.ndarray]:
        """NHWC float images of one validation batch (NCHW tensors) and its
        reconstruction."""
        nhwc = lambda t: np.asarray(t.detach().float().cpu()).transpose(0, 2, 3, 1)
        img, tgt, flow = (nhwc(x) for x in pair_batch(batch))
        return {"original": img, "target": tgt, "gt_flow": viz.flow_to_image(flow),
                "target_p": nhwc(artifacts["out"])}


__all__ = ["FlowPred", "FlowPredModule"]
