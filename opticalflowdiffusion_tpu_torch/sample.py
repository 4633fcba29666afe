"""Serving entry point: sample the flagship FlowDiffuser on a batch.

    python -m opticalflowdiffusion_tpu_torch.sample --batch 8 --seed 0 \\
        [--sampling-timesteps 50] [--sampler {auto,ddim,ancestral,dpmpp}] \\
        [--height 448 --width 1024] [--device cuda]

Builds the flagship (trained at 128x128, joint target, UNet width 64, bf16
compute) with weights drawn from ``--seed`` (output conv not zeroed, so the
model predicts a flow), draws a batch from the artificial dataset, runs one
warm-up UNet eval at the batch's shape (kernel builds, first-call set-up),
samples once on the clock and prints one JSON line with shapes, the share of
NaN holes and times.  Without ``--sampling-timesteps`` the flagship's
1000-step ancestral loop runs; with it, DDIM, unless ``--sampler`` says
otherwise (``dpmpp``: DPM-Solver++(2M)).  ``--height``/``--width`` (default:
the model's 128) sample at another resolution, such as the native Sintel
448x1024: the frames are rendered square at the larger side and cropped.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .algorithms.base import to_batch
from .algorithms.flow_diffuser import FlowDiffuser
from .config import FLAGSHIP, FLAGSHIP_DATA
from .data.artificial import ArtificialDataset

SAMPLERS = ("auto", "ddim", "ancestral", "dpmpp")


def build(seed: int, device: str, sampling_timesteps=None, image_size=None,
          unet_dim=None, sampler: str = "auto"):
    """(FlowDiffuser, ArtificialDataset) of the flagship, weights from ``seed``."""
    cfg = dataclasses.replace(FLAGSHIP, zero_init=False,
                              sampling_timesteps=sampling_timesteps, sampler=sampler)
    data_cfg = FLAGSHIP_DATA
    if image_size is not None:
        cfg = dataclasses.replace(cfg, image_size=image_size)
        data_cfg = dataclasses.replace(data_cfg, image_size=image_size)
    if unet_dim is not None:
        cfg = dataclasses.replace(cfg, unet_dim=unet_dim)
    gen = torch.Generator().manual_seed(seed)
    algo = FlowDiffuser(cfg, device=device, generator=gen)
    return algo, ArtificialDataset(dataclasses.replace(data_cfg, seed=seed))


def batch_items(seed: int, batch: int, height: int, width: int):
    """``batch`` artificial items rendered square at max(height, width) and
    cropped to the first ``height`` rows and ``width`` columns."""
    size = max(height, width)
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=size, seed=seed))
    return [tuple(a[:height, :width] for a in data[i]) for i in range(batch)]


def run(batch: int, seed: int, device: str, sampling_timesteps=None,
        image_size=None, unet_dim=None, sampler: str = "auto",
        height=None, width=None) -> dict:
    algo, _ = build(seed, device, sampling_timesteps, image_size, unet_dim, sampler)
    H = height or algo.image_size
    W = width or algo.image_size
    _, cond, _ = algo.preprocess(to_batch(batch_items(seed, batch, H, W), algo.device))
    gen = torch.Generator(device=algo.device).manual_seed(seed)
    sync = torch.cuda.synchronize if algo.device.type == "cuda" else (lambda: None)
    x = torch.randn((batch, algo.channels, H, W), generator=gen, device=algo.device)
    t = torch.full((batch,), algo.sched.num_timesteps - 1, dtype=torch.long,
                   device=algo.device)
    with torch.no_grad():
        algo.module(x, cond, t)                     # warm-up
    sync()
    t0 = time.perf_counter()
    samples, flow = algo.sample(cond, generator=gen.manual_seed(seed))
    sync()
    seconds = time.perf_counter() - t0
    steps = algo.sched.sampling_timesteps
    if algo.sched.sampler != "auto":
        used = algo.sched.sampler
    else:
        used = "ddim" if algo.sched.is_ddim_sampling else "ancestral"
    return {
        "device": str(algo.device),
        "batch": batch,
        "height": H,
        "width": W,
        "sampler": used,
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampling-timesteps", type=int, default=None)
    ap.add_argument("--sampler", choices=SAMPLERS, default="auto")
    ap.add_argument("--height", type=int, default=None,
                    help="sample height (default: the model's image_size)")
    ap.add_argument("--width", type=int, default=None,
                    help="sample width (default: the model's image_size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.batch, args.seed, args.device, args.sampling_timesteps,
                         sampler=args.sampler, height=args.height, width=args.width)))


if __name__ == "__main__":
    main()
