"""Flow-equivariant Autoencoder (JAX ``models/autoencoder.py``), NCHW.

The encoder UNet maps a frame to a clamped latent, the latent is splatted
forward by the flow, and the decoder UNet reconstructs the target from it,
conditioned on the original frame.  FlowPred trains it; the latent
FlowDiffuser runs on its frozen latents.  Both UNets are JAX's: width 64,
``dim_mults`` (1, 2, 4), no time input, output conv not zeroed.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .unet import Unet
from ..ops.warp import warp_forward_flow


class Autoencoder(nn.Module):
    def __init__(self, latent_dim: int = 16, dtype=torch.float32, conv_backend: str = "cudnn"):
        super().__init__()
        unet = dict(dim_mults=(1, 2, 4), time_in=False, dtype=dtype, conv_backend=conv_backend)
        self.model_enc = Unet(64, out_dim=latent_dim, channels=3, **unet)
        self.model_dec = Unet(64, out_dim=3, channels=latent_dim + 3, **unet)

    def encode(self, x):
        """The latent (B, latent_dim, H, W) in [-1, 1] of a frame in [0, 1]."""
        return torch.clamp(self.model_enc(2 * x - 1.0), -1.0, 1.0)

    def decode(self, latent, x):
        """The frame in [0, 1] decoded from ``latent``, conditioned on ``x``."""
        out = self.model_dec(torch.cat([latent, 2 * x - 1.0], dim=1))
        return (torch.clamp(out, -1.0, 1.0) + 1.0) / 2.0

    def forward(self, x, flow, return_latent: bool = False):
        """Encode ``x``, splat the latent by ``flow`` (pixels; holes stay 0,
        ``set_nans=False``, so that no NaN reaches the decoder), decode; or
        the splatted latent with ``return_latent``."""
        warped = warp_forward_flow(self.encode(x), flow, set_nans=False)
        if return_latent:
            return warped
        return self.decode(warped, x)


__all__ = ["Autoencoder"]
