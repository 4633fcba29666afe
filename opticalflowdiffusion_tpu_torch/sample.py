"""Serving entry point: sample FlowDiffuser (or FrameGenerator) on a batch.

    python -m opticalflowdiffusion_tpu_torch.sample --batch 8 --seed 0 \\
        [--sampling-timesteps 50] [--sampler {auto,ddim,ancestral,dpmpp}] \\
        [--height 448 --width 1024] [--conv-backend {cudnn,rows,fold}] [--device cuda] \\
        [--target {joint,target,flow}] [--noiser {image,flow}] [--no-diffusion] \\
        [--latent [--ae DIR] [--latent-dim 16]] [--unet-dim 64] [--ckpt PATH]
    python -m opticalflowdiffusion_tpu_torch.sample --algorithm frame_generator --batch 8 \\
        [--sampling-timesteps 50] [--image-size 64] [--val-length 5] \\
        [--ckpt RUN_DIR]

Builds the flagship (trained at 128x128, joint target, UNet width 64, bf16
compute) with weights drawn from ``--seed`` (output conv not zeroed, so the
model predicts a flow) or, with ``--ckpt``, loaded from a checkpoint: a
port run's directory (its newest checkpoint), its ``checkpoints``
directory or one step's directory, or a reference Lightning ``.ckpt`` /
``.pt`` file (``utils/import_torch_ckpt.py``; the model flags must
describe the checkpoint's model).  It draws a batch from the artificial dataset, runs one
warm-up UNet eval at the batch's shape (kernel builds, first-call set-up),
samples once on the clock and prints one JSON line with shapes, the share of
NaN holes and times.  Without ``--sampling-timesteps`` the flagship's
1000-step ancestral loop runs; with it, DDIM, unless ``--sampler`` says
otherwise (``dpmpp``: DPM-Solver++(2M)).  ``--height``/``--width`` (default:
the model's 128) sample at another resolution, such as the native Sintel
448x1024: the frames are rendered square at the larger side and cropped.
``--conv-backend`` lowers the UNet's convs (``ops/conv.py``; default cudnn).
The model flags are ``train.py``'s: another target, the flow-noise process
(sampled with the ancestral loop), the single-forward model (one forward,
``denoise_steps`` 1) or latent mode (the samples are latents; ``--ae``
loads the Autoencoder of a ``flow_pred`` run, else it is drawn from the
seed).

``--algorithm frame_generator`` serves FrameGenerator
(``frame_generator.yaml``; weights from ``--seed`` or a run's ``--ckpt``):
it draws ``--batch`` validation sequences of ``--val-length`` transitions
from the constant-velocity video dataset at ``--image-size`` (default the
yaml's 64), runs one warm-up UNet eval, then rolls the model out over the
transitions on the clock (each sample conditions the next step), with the
1000-step ancestral loop or DDIM with ``--sampling-timesteps``, and prints
one JSON line with the rollout's MSE against the ground-truth frames beside
the copy-the-last-frame baseline, and the times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from .algorithms.animation import FrameGenerator
from .algorithms.base import to_batch
from .algorithms.flow_diffuser import FlowDiffuser
from .config import ARTIFICIAL_VIDEO, FLAGSHIP_DATA, FRAME_GENERATOR
from .data.artificial import ArtificialDataset
from .data.artificial_video import ArtificialVideoDataset
from .experiments.base import resolve_checkpoint, to_device
from .ops.conv import BACKENDS
from .utils.ckpt import FILE, CheckpointManager
from .utils.import_torch_ckpt import flow_diffuser_params_from_lightning, load_torch_state_dict
from .train import add_model_flags, model_config, model_flags

SAMPLERS = ("auto", "ddim", "ancestral", "dpmpp")
ALGORITHMS = ("flow_diffuser", "frame_generator")


def build(seed: int, device: str, sampling_timesteps=None, image_size=None,
          unet_dim=None, sampler: str = "auto", conv_backend: str = "cudnn",
          remat: bool = False, **model):
    """(FlowDiffuser, ArtificialDataset) of the flagship, or with ``model``
    (``train.MODEL_FIELDS``) another configuration, weights from ``seed``
    (``remat`` for training it)."""
    cfg = model_config(zero_init=False, sampler=sampler, conv_backend=conv_backend,
                       remat=remat, image_size=image_size, unet_dim=unet_dim, **model)
    cfg = dataclasses.replace(cfg, sampling_timesteps=sampling_timesteps)
    data_cfg = dataclasses.replace(FLAGSHIP_DATA, image_size=cfg.image_size)
    gen = torch.Generator().manual_seed(seed)
    algo = FlowDiffuser(cfg, device=device, generator=gen)
    return algo, ArtificialDataset(dataclasses.replace(data_cfg, seed=seed))


def load_checkpoint(algo: FlowDiffuser, path) -> str:
    """Load the module's weights from ``path`` (strict): a file is a
    Lightning checkpoint, a directory a port run's checkpoint.  Returns
    what was loaded."""
    p = Path(path)
    if not p.is_file():
        return load_run_checkpoint(algo.module, p)
    sd = flow_diffuser_params_from_lightning(load_torch_state_dict(p), target=algo.target)
    algo.module.load_state_dict(sd, strict=True)
    return str(p)


def load_run_checkpoint(module: torch.nn.Module, path) -> str:
    """Load ``module``'s weights (strict) from a port run's checkpoint: its
    directory (the newest step), its ``checkpoints`` directory or one
    step's directory.  Returns the step's directory."""
    directory, step = resolve_checkpoint(Path(path))
    step = CheckpointManager(directory).latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    sd = torch.load(directory / str(step) / FILE, map_location="cpu", weights_only=True)
    module.load_state_dict(sd["module"], strict=True)
    return str(directory / str(step))


def batch_items(seed: int, batch: int, height: int, width: int):
    """``batch`` artificial items rendered square at max(height, width) and
    cropped to the first ``height`` rows and ``width`` columns."""
    size = max(height, width)
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=size, seed=seed))
    return [tuple(a[:height, :width] for a in data[i]) for i in range(batch)]


def run(batch: int, seed: int, device: str, sampling_timesteps=None,
        image_size=None, unet_dim=None, sampler: str = "auto",
        height=None, width=None, conv_backend: str = "cudnn", ckpt=None, **model) -> dict:
    algo, _ = build(seed, device, sampling_timesteps, image_size, unet_dim, sampler,
                    conv_backend, **model)
    loaded = load_checkpoint(algo, ckpt) if ckpt else None
    H = height or algo.image_size
    W = width or algo.image_size
    _, cond, _ = algo.preprocess(to_batch(batch_items(seed, batch, H, W), algo.device))
    gen = torch.Generator(device=algo.device).manual_seed(seed)
    sync = torch.cuda.synchronize if algo.device.type == "cuda" else (lambda: None)
    with torch.no_grad():                           # warm-up: one model eval
        if algo.is_diffusion:
            x = torch.randn((batch, algo.channels, H, W), generator=gen, device=algo.device)
            t = torch.full((batch,), algo.sched.num_timesteps - 1, dtype=torch.long,
                           device=algo.device)
            algo.model_fn(x, cond, t)
        else:
            algo.sample(cond)
    sync()
    t0 = time.perf_counter()
    samples, flow = algo.sample(cond, generator=gen.manual_seed(seed))
    sync()
    seconds = time.perf_counter() - t0
    if not algo.is_diffusion:
        steps, used = 1, "single_forward"
    else:
        steps = algo.sched.sampling_timesteps
        if algo.sched.sampler != "auto":
            used = algo.sched.sampler
        else:
            used = "ddim" if algo.sched.is_ddim_sampling else "ancestral"
    return {
        "device": str(algo.device),
        "target": algo.target,
        "noiser": algo.cfg.noiser,
        "latent": algo.latent,
        "batch": batch,
        "height": H,
        "width": W,
        "sampler": used,
        "conv_backend": conv_backend,
        "ckpt": loaded,
        "denoise_steps": steps,
        "samples_shape": list(samples.shape),
        "flow_shape": list(flow.shape),
        "nan_share": float(torch.isnan(samples).float().mean()),
        "finite_values_finite": bool(torch.isfinite(samples[~torch.isnan(samples)]).all()
                                     and torch.isfinite(flow).all()),
        "seconds": seconds,
        "denoise_steps_per_s": steps / seconds,
        "frames_per_s": batch / seconds,
    }


def run_frame_generator(batch: int, seed: int, device: str, sampling_timesteps=None,
                        image_size=None, val_length=None, conv_backend: str = "cudnn",
                        ckpt=None) -> dict:
    """FrameGenerator's rollout over ``val_length`` transitions of a batch
    of validation sequences (weights from ``seed`` or ``ckpt``)."""
    cfg = dataclasses.replace(FRAME_GENERATOR, sampling_timesteps=sampling_timesteps,
                              conv_backend=conv_backend,
                              image_size=image_size or FRAME_GENERATOR.image_size)
    algo = FrameGenerator(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    loaded = load_run_checkpoint(algo.module, ckpt) if ckpt else None
    data_cfg = dataclasses.replace(ARTIFICIAL_VIDEO, image_size=cfg.image_size, seed=seed,
                                   size=batch, val_length=val_length or ARTIFICIAL_VIDEO.val_length)
    data = ArtificialVideoDataset(data_cfg, split="validation")
    (x,) = to_device(tuple(np.stack(f) for f in zip(*(data[i] for i in range(batch)))),
                     algo.device)
    gen = torch.Generator(device=algo.device).manual_seed(seed)
    sync = torch.cuda.synchronize if algo.device.type == "cuda" else (lambda: None)
    H = W = cfg.image_size
    with torch.no_grad():                           # warm-up: one model eval
        t = torch.full((batch,), algo.sched.num_timesteps - 1, dtype=torch.long,
                       device=algo.device)
        algo.model_fn(torch.randn((batch, 3, H, W), generator=gen, device=algo.device),
                      2 * x[:, 0, 3:] - 1, t)
        sync()
        t0 = time.perf_counter()
        frames = algo.rollout(x, gen.manual_seed(seed))
        sync()
    seconds = time.perf_counter() - t0
    gt, last = x[:, :, :3], x[:, :, 3:6]
    sched = algo.sched
    steps = sched.sampling_timesteps * x.shape[1]
    return {
        "device": str(algo.device),
        "algorithm": "frame_generator",
        "batch": batch,
        "height": H,
        "width": W,
        "val_length": x.shape[1],
        "sampler": "ddim" if sched.is_ddim_sampling else "ancestral",
        "timesteps": sched.num_timesteps,
        "conv_backend": conv_backend,
        "precision": cfg.precision,
        "ckpt": loaded,
        "denoise_steps": steps,
        "rollout_shape": list(frames.shape),
        "finite": bool(torch.isfinite(frames).all()),
        "rollout_mse": float((frames.clamp(0, 1) - gt).square().mean()),
        "rollout_mse_copy_baseline": float((last - gt).square().mean()),
        "seconds": seconds,
        "denoise_steps_per_s": steps / seconds,
        "frames_per_s": batch * x.shape[1] / seconds,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algorithm", choices=ALGORITHMS, default="flow_diffuser")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampling-timesteps", type=int, default=None)
    ap.add_argument("--sampler", choices=SAMPLERS, default="auto")
    ap.add_argument("--height", type=int, default=None,
                    help="sample height (default: the model's image_size)")
    ap.add_argument("--width", type=int, default=None,
                    help="sample width (default: the model's image_size)")
    ap.add_argument("--conv-backend", choices=BACKENDS, default="cudnn")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--unet-dim", type=int, default=None)
    ap.add_argument("--ckpt", default=None,
                    help="a port run's (or checkpoints, or step) directory, or a Lightning "
                         ".ckpt file")
    ap.add_argument("--image-size", type=int, default=None,
                    help="FrameGenerator's frame side (default its yaml's 64)")
    ap.add_argument("--val-length", type=int, default=None,
                    help="FrameGenerator's rollout transitions (default 5)")
    add_model_flags(ap)
    args = ap.parse_args(argv)
    if args.algorithm == "frame_generator":
        print(json.dumps(run_frame_generator(
            args.batch, args.seed, args.device, args.sampling_timesteps, args.image_size,
            args.val_length, args.conv_backend, args.ckpt)))
        return
    print(json.dumps(run(args.batch, args.seed, args.device, args.sampling_timesteps,
                         unet_dim=args.unet_dim, sampler=args.sampler, height=args.height,
                         width=args.width, conv_backend=args.conv_backend, ckpt=args.ckpt,
                         **model_flags(args))))


if __name__ == "__main__":
    main()
