"""Serving entry point: sample the flagship FlowDiffuser on a batch.

    python -m opticalflowdiffusion_tpu_torch.sample --batch 8 --seed 0 \
        [--sampling-timesteps 50] [--device cuda]

Builds the flagship (128x128, joint target, UNet width 64, bf16 compute)
with weights drawn from ``--seed`` (output conv not zeroed, so the model
predicts a flow), draws a batch from the artificial dataset, samples, and
prints one JSON line with shapes, the share of NaN holes and times.
Without ``--sampling-timesteps`` the flagship's 1000-step ancestral loop
runs; with it, DDIM.
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


def build(seed: int, device: str, sampling_timesteps=None, image_size=None,
          unet_dim=None):
    """(FlowDiffuser, ArtificialDataset) of the flagship, weights from ``seed``."""
    cfg = dataclasses.replace(FLAGSHIP, zero_init=False,
                              sampling_timesteps=sampling_timesteps)
    data_cfg = FLAGSHIP_DATA
    if image_size is not None:
        cfg = dataclasses.replace(cfg, image_size=image_size)
        data_cfg = dataclasses.replace(data_cfg, image_size=image_size)
    if unet_dim is not None:
        cfg = dataclasses.replace(cfg, unet_dim=unet_dim)
    gen = torch.Generator().manual_seed(seed)
    algo = FlowDiffuser(cfg, device=device, generator=gen)
    return algo, ArtificialDataset(dataclasses.replace(data_cfg, seed=seed))


def run(batch: int, seed: int, device: str, sampling_timesteps=None,
        image_size=None, unet_dim=None) -> dict:
    algo, data = build(seed, device, sampling_timesteps, image_size, unet_dim)
    items = [data[i] for i in range(batch)]
    _, cond, _ = algo.preprocess(to_batch(items, algo.device))
    gen = torch.Generator(device=algo.device).manual_seed(seed)
    sync = torch.cuda.synchronize if algo.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    samples, flow = algo.sample(cond, generator=gen)
    sync()
    seconds = time.perf_counter() - t0
    steps = algo.sched.sampling_timesteps
    return {
        "device": str(algo.device),
        "batch": batch,
        "image_size": algo.image_size,
        "sampler": "ddim" if algo.sched.is_ddim_sampling else "ancestral",
        "denoise_steps": steps,
        "samples_shape": list(samples.shape),
        "flow_shape": list(flow.shape),
        "nan_share": float(torch.isnan(samples).float().mean()),
        "finite_values_finite": bool(torch.isfinite(samples[~torch.isnan(samples)]).all()
                                     and torch.isfinite(flow).all()),
        "seconds": seconds,
        "denoise_steps_per_s": steps / seconds,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampling-timesteps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.batch, args.seed, args.device, args.sampling_timesteps)))


if __name__ == "__main__":
    main()
