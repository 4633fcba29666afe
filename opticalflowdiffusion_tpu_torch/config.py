"""Flagship configuration as dataclasses (no YAML parsing).

The values are those that the JAX package composes for
``experiment=matrix_flow algorithm=flow_diffuser dataset=artificial``
(``config/configurations/{algorithm/flow_diffuser.yaml,
dataset/artificial.yaml, experiment/{matrix_flow,base}.yaml, config.yaml}``),
with the dataset drawn at the algorithm's image size, the real-data
datasets of ``dataset/{sintel,flying_chairs,kitti_single}.yaml``, and the
MatrixFlow and animation family: ``algorithm/{matrix_flow,frame_generator,
flow_completer}.yaml``, ``dataset/artificial_video.yaml`` and
``experiment/animation.yaml`` over ``experiment/base.yaml``,
``algorithm/pwc_learner.yaml`` and ``dataset/taichi.yaml``, and the
classification experiment: ``algorithm/classifier.yaml``,
``experiment/classification.yaml`` and ``dataset/cifar10.yaml``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


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
class SintelDataConfig:
    """``dataset/sintel.yaml`` (``image_size`` is "W,H"; ``root`` None reads
    ``$OFD_DATA_ROOT`` or ``datasets``) with the reader's ``normalize`` and
    ``scale_flow`` (JAX's ``cfg.get`` defaults)."""

    name: str = "sintel"
    image_size: str = "512,256"
    root: Optional[str] = None
    normalize: bool = True
    scale_flow: bool = False


@dataclasses.dataclass(frozen=True)
class FlyingChairsDataConfig:
    """``dataset/flying_chairs.yaml``."""

    name: str = "flying_chairs"
    image_size: str = "128,128"
    root: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class KittiSingleDataConfig:
    """``dataset/kitti_single.yaml``."""

    name: str = "kitti_single"
    image_size: str = "128,128"
    root: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ArtificialVideoDataConfig:
    """``dataset/artificial_video.yaml``: constant-velocity box sequences
    (``val_length`` transitions a validation item, the motion up to
    ``max_motion`` px a frame); ``seed`` None draws from 0."""

    name: str = "artificial_video"
    image_size: int = 32
    size: int = 4096
    val_length: int = 5
    max_motion: int = 1
    seed: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TaiChiDataConfig:
    """``dataset/taichi.yaml`` (``image_size`` one side: frames are square)
    with the reader's ``cfg.get`` defaults (``flow_iters``,
    ``flow_corr_levels``, ``allow_untrained_flow``) and the device of the
    precompute's RAFT (``flow_device``)."""

    name: str = "taichi"
    image_size: int = 64
    scale_down: float = 1.0
    frame_distance: int = 10
    val_length: int = 10
    calculate_flows: bool = False
    flow_batch_size: int = 48
    flow_method: str = "raft"
    flow_checkpoint: Optional[str] = "raft-artificial"
    flow_iters: int = 12
    flow_corr_levels: int = 4
    allow_untrained_flow: bool = False
    flow_device: str = "cuda"
    root: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Cifar10DataConfig:
    """``dataset/cifar10.yaml`` (``root`` None reads ``$OFD_DATA_ROOT`` or
    ``datasets``; the images are CIFAR's 32x32)."""

    name: str = "cifar10"
    image_size: int = 32
    root: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """``algorithm/classifier.yaml``: the architecture (``resnet18``,
    ``resnet34`` or ``mobilenet_v2``), classes and input channels, Adam at
    ``lr`` with no weight decay; float32 (``precision`` is reported only),
    at CIFAR's ``image_size``."""

    arch: str = "resnet18"
    num_class: int = 10
    in_channels: int = 3
    lr: float = 1e-3
    weight_decay: float = 0.0
    image_size: int = 32
    precision: str = "float32"


@dataclasses.dataclass(frozen=True)
class FlowDiffuserConfig:
    """``algorithm/flow_diffuser.yaml`` plus ``runtime.precision`` and
    ``runtime.remat`` (which JAX's experiment copies into the algorithm as
    ``_remat``: recompute the UnetWithWarp closure in the backward), and the
    JAX package's ``OFD_CONV_BACKEND`` as ``conv_backend`` (``cudnn`` is its
    default XLA lowering, ``rows`` its ``pallas``, ``fold`` its ``fold``;
    ``ops/conv.py``).  ``target`` is ``joint``, ``target`` or ``flow``;
    ``noiser`` is ``image`` or ``flow`` (the permutation-warp forward
    process); ``flow_weight`` weighs the flow term of the single-forward
    model's loss (``is_diffusion`` false) and ``diffusion_flow_weight`` the
    direct flow MSE of the diffusion loss (the yaml's ``+`` knob, default
    0).  ``ae`` is the directory of a port run whose newest checkpoint holds
    the frozen Autoencoder of latent mode (``latent``), under the ``ae.``
    prefix (``utils/ckpt.py``); None draws it from the seed."""

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
    lr: float = 1e-5
    weight_decay: float = 1e-6
    conv_backend: str = "cudnn"
    remat: bool = False
    flow_weight: float = 0.0
    diffusion_flow_weight: float = 0.0
    ae: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FlowPredConfig:
    """``algorithm/flow_pred.yaml`` (its ``image_size: 128,128`` as one side)
    plus ``runtime.precision`` and the conv lowering: the flow-equivariant
    Autoencoder trained with ``ae_frac`` identity mixing."""

    image_size: int = 128
    lr: float = 4e-5
    weight_decay: float = 1e-6
    latent_dim: int = 16
    ae_frac: float = 0.1
    precision: str = "bf16"
    conv_backend: str = "cudnn"


@dataclasses.dataclass(frozen=True)
class FlowLearnerConfig:
    """``algorithm/flow_learner.yaml`` plus ``runtime.precision``, the conv
    lowering, the filter representation's ``radius`` (the yaml has none: it
    is the ``+algorithm.radius`` knob, and then ``flow_max`` must be None)
    and the pyramid's ``levels`` (the reference's ten by default)."""

    image_size: int = 128
    flow_max: Optional[float] = 20.0
    zero_init: bool = True
    c2f: bool = False
    lr: float = 8e-5
    weight_decay: float = 1e-6
    sparsity_weight: float = 0.0
    occlusion_mask: bool = True
    train_aug: bool = True
    radius: Optional[int] = None
    levels: Tuple[int, ...] = (1, 2, 4, 5, 7, 8, 10, 11, 14, 16)
    precision: str = "bf16"
    conv_backend: str = "cudnn"


@dataclasses.dataclass(frozen=True)
class MatrixFlowConfig:
    """``algorithm/matrix_flow.yaml`` plus ``runtime.precision`` and the conv
    lowering: per-pixel R x R filters (``radius``) predicted by a UNet from
    the frame pair.  ``image_size`` is the yaml's "W,H" (or one side);
    ``goal`` is ``gt_flow_pred`` (flow regression), ``filter_pred`` (the
    photometric loss plus the weighted regularisers) or ``gt_filter_pred``
    (the inverted filter's mean tap against the flow); ``cols`` (the
    ``+algorithm.cols`` knob: ``any`` or ``ones``) adds the colour-weight
    channel (and with ``any`` three colour channels); ``architecture`` is
    ``unet`` (``raft`` raises, as JAX's branch cannot run)."""

    image_size: Union[int, str] = "128,128"
    architecture: str = "unet"
    goal: str = "gt_flow_pred"
    lr: float = 4e-5
    weight_decay: float = 1e-6
    radius: int = 17
    smoothness_weight: float = 0.0
    smoothness_lmbd: float = 2.0
    identity_weight: float = 0.0
    copout_weight: float = 0.0
    divergence_weight: float = 0.0
    inversion_weight: float = 0.0
    small_eps: float = 0.5
    eps: float = 1e-15
    cols: Optional[str] = None
    precision: str = "bf16"
    conv_backend: str = "cudnn"


@dataclasses.dataclass(frozen=True)
class FrameGeneratorConfig:
    """``algorithm/frame_generator.yaml`` plus ``runtime.precision``, the
    conv lowering and the diffusion knobs JAX reads with ``cfg.get``:
    ``timesteps`` (1000) and ``sampling_timesteps`` (None: the ancestral
    loop; fewer steps: DDIM)."""

    image_size: int = 64
    lr: float = 7e-5
    weight_decay: float = 2e-4
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    precision: str = "bf16"
    conv_backend: str = "cudnn"


@dataclasses.dataclass(frozen=True)
class FlowCompleterConfig:
    """``algorithm/flow_completer.yaml`` plus the conv lowering;
    ``precision`` is kept for the runner, but the UNet computes in float32
    whatever it says (JAX builds it without a dtype)."""

    image_size: int = 64
    lr: float = 4.5e-6
    weight_decay: float = 2e-4
    precision: str = "bf16"
    conv_backend: str = "cudnn"


@dataclasses.dataclass(frozen=True)
class PWCLearnerConfig:
    """``algorithm/pwc_learner.yaml`` plus ``runtime.precision``, the
    artificial dataset's side (``image_size``: the yaml has none, and the
    model takes any size whose pyramid halves exactly) and JAX's
    ``smoothness_weight`` and ``occ_weight`` knobs (the ``+algorithm`` ones;
    1 is the reference's loss)."""

    image_size: int = 128
    lr: float = 1e-4
    weight_decay: float = 1e-6
    smoothness_weight: float = 1.0
    occ_weight: float = 1.0
    precision: str = "bf16"


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """``experiment/matrix_flow.yaml`` over ``experiment/base.yaml``: the
    training batch, gradient clipping, step budget (``max_steps`` -1 runs
    until stopped) and epoch budget (``epochs`` -1: none), validation
    cadence (``check_interval`` steps, or a float: that share of an epoch)
    and size, checkpoint cadence, microbatches, the loader's threads
    (``num_workers``, capped at the CPU count), the train-metric cadence
    (``runtime.log_every``) and the step traced by the profiler
    (``runtime.profile_step``, -1: none).  The training batches are shuffled
    and the validation ones are not; the test task reads the validation
    settings (the experiment has no ``test`` section).  ``val_shuffle``
    shuffles the validation batches (``experiment/base.yaml``'s, which the
    animation experiment keeps)."""

    batch_size: int = 16
    clipping: Optional[float] = 100.0
    max_steps: int = -1
    epochs: int = -1
    accumulate_grad_batches: int = 1
    check_interval: Union[int, float] = 100
    limit_batch: int = 1
    val_batch_size: int = 8
    every_n_train_steps: int = 5000
    log_every: int = 50
    seed: int = 0
    num_workers: int = 16
    profile_step: int = -1
    val_shuffle: bool = False


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
MATRIX_FLOW_ALGO = MatrixFlowConfig()
FRAME_GENERATOR = FrameGeneratorConfig()
FLOW_COMPLETER = FlowCompleterConfig()
ARTIFICIAL_VIDEO = ArtificialVideoDataConfig()
FLOW_PRED = FlowPredConfig()
FLOW_LEARNER = FlowLearnerConfig()
PWC_LEARNER = PWCLearnerConfig()
FLAGSHIP_DATA = ArtificialDataConfig()
SINTEL = SintelDataConfig()
FLYING_CHAIRS = FlyingChairsDataConfig()
KITTI_SINGLE = KittiSingleDataConfig()
TAICHI = TaiChiDataConfig()
# the dataset configs by name (the artificial one follows the algorithm's size)
DATA = {"artificial": FLAGSHIP_DATA, "sintel": SINTEL, "flying_chairs": FLYING_CHAIRS,
        "kitti_single": KITTI_SINGLE, "artificial_video": ARTIFICIAL_VIDEO, "taichi": TAICHI}
MATRIX_FLOW = TrainingConfig()
# experiment/animation.yaml over base.yaml: no clipping, validation shuffled
ANIMATION = TrainingConfig(batch_size=64, clipping=None, check_interval=400, val_batch_size=8,
                           val_shuffle=True)
NATIVE = ServingConfig()
CLASSIFIER = ClassifierConfig()
CIFAR10 = Cifar10DataConfig()
# experiment/classification.yaml over base.yaml: batch 16 both ways, the
# validation batches shuffled, a validation an epoch, a checkpoint every
# 2000 steps, no clipping
CLASSIFICATION = TrainingConfig(batch_size=16, clipping=None, check_interval=1.0,
                                val_batch_size=16, every_n_train_steps=2000, val_shuffle=True)

__all__ = ["ArtificialDataConfig", "ArtificialVideoDataConfig", "CIFAR10", "CLASSIFICATION",
           "CLASSIFIER", "ClassifierConfig", "Cifar10DataConfig", "FlowCompleterConfig",
           "FlowDiffuserConfig", "FlowLearnerConfig", "FlowPredConfig", "FlyingChairsDataConfig",
           "FrameGeneratorConfig", "KittiSingleDataConfig", "MatrixFlowConfig", "PWCLearnerConfig",
           "ServingConfig",
           "SintelDataConfig", "TaiChiDataConfig", "TrainingConfig", "ANIMATION", "ARTIFICIAL_VIDEO", "DATA",
           "FLAGSHIP", "FLAGSHIP_DATA", "FLOW_COMPLETER", "FLOW_LEARNER", "FLOW_PRED",
           "FLYING_CHAIRS", "FRAME_GENERATOR", "KITTI_SINGLE", "MATRIX_FLOW", "MATRIX_FLOW_ALGO",
           "NATIVE", "PWC_LEARNER", "SINTEL", "TAICHI"]
