"""Flagship configuration as a dataclass (no YAML parsing).

The values are those that the JAX package composes for
``experiment=matrix_flow algorithm=flow_diffuser dataset=artificial``
(``config/configurations/{algorithm/flow_diffuser.yaml,
dataset/artificial.yaml, config.yaml}``), with the dataset drawn at the
algorithm's image size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArtificialDataConfig:
    """``dataset/artificial.yaml`` (``image_size`` follows the algorithm)."""

    image_size: int = 128
    size: int = 256000
    num_channels: int = 3
    shape: str = "boxes"
    bg: str = "checkers"
    seed: Optional[int] = None
    max_motion: int = 1


@dataclasses.dataclass(frozen=True)
class FlowDiffuserConfig:
    """``algorithm/flow_diffuser.yaml`` plus ``runtime.precision``."""

    image_size: int = 128
    latent_dim: int = 16
    flow_max: float = 20.0
    latent_max: float = 2.0
    is_diffusion: bool = True
    latent: bool = False
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    target: str = "joint"
    noiser: str = "image"
    sampler: str = "auto"
    zero_init: bool = True
    unet_dim: int = 64
    precision: str = "bf16"


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Native-resolution serving of the flagship: the JAX ``bench.py`` rows
    ``sintel_native_ddim50_frames_per_sec`` (b2), ``..._b8_frames_per_sec``
    and ``sintel_native_dpmpp20_frames_per_sec`` (b2), with the 128-trained
    flagship's weights on the 1024x436 Sintel frame padded to 448x1024 (the
    UNet needs sides divisible by 8).  The port draws the conditioning from
    its artificial dataset rendered square at the larger side and cropped."""

    height: int = 448
    width: int = 1024
    # (sampler, denoise steps, batch) of each served run
    runs: Tuple[Tuple[str, int, int], ...] = (("ddim", 50, 2), ("ddim", 50, 8), ("dpmpp", 20, 2))


FLAGSHIP = FlowDiffuserConfig()
FLAGSHIP_DATA = ArtificialDataConfig()
NATIVE = ServingConfig()

__all__ = ["ArtificialDataConfig", "FlowDiffuserConfig", "ServingConfig", "FLAGSHIP",
           "FLAGSHIP_DATA", "NATIVE"]
