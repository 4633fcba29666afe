"""Flagship configuration as a dataclass (no YAML parsing).

The values are those that the JAX package composes for
``experiment=matrix_flow algorithm=flow_diffuser dataset=artificial``
(``config/configurations/{algorithm/flow_diffuser.yaml,
dataset/artificial.yaml, config.yaml}``), with the dataset drawn at the
algorithm's image size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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


FLAGSHIP = FlowDiffuserConfig()
FLAGSHIP_DATA = ArtificialDataConfig()

__all__ = ["ArtificialDataConfig", "FlowDiffuserConfig", "FLAGSHIP", "FLAGSHIP_DATA"]
