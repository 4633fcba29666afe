"""Training entry point: train the flagship FlowDiffuser on the artificial dataset.

    python -m opticalflowdiffusion_tpu_torch.train --steps 20 [--batch 16] \\
        [--image-size 128] [--unet-dim 64] [--seed 0] [--device cuda] \\
        [--out outputs/train] [--resume] [--check-interval N] \\
        [--ckpt-every N] [--val-batch 8] [--sampling-timesteps S] \\
        [--conv-backend {cudnn,rows,fold}] [--remat]

The counterpart of ``main.py experiment=matrix_flow algorithm=flow_diffuser
dataset=artificial``: the flagship (UNet width 64, dim_mults (1, 2, 4, 8),
joint target, T = 1000, bf16 compute with float32 parameters, Adam at lr
1e-5 with weight decay 1e-6 and global-norm clipping at 100) trained at
batch 16.  Runs ``--steps`` train steps in all, validates every
``--check-interval`` steps (default: at the last step, at most every 100),
checkpoints every ``--ckpt-every`` steps and at the last one under
``--out/checkpoints/<step>``, and writes ``--out/metrics.jsonl``.  With
``--resume`` it continues from the newest checkpoint under ``--out``.
Validation samples with the flagship's 1000-step ancestral loop unless
``--sampling-timesteps`` asks for DDIM.  ``--conv-backend`` lowers the UNet's
convs (``ops/conv.py``; default cudnn).  ``--remat`` recomputes the
UnetWithWarp closure in the backward (JAX's ``runtime.remat=true``, which the
native 448x1024 training row sets).  Prints one JSON line with the last
train and validation metrics and the samples per second of the run
(validation and checkpoint writes included).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .config import FLAGSHIP, FLAGSHIP_DATA, MATRIX_FLOW
from .experiments.matrix_flow import MatrixFlowExperiment
from .ops.conv import BACKENDS


def build(steps: int, batch: int = MATRIX_FLOW.batch_size, image_size=None, unet_dim=None,
          seed: int = 0, device: str = "cuda", out: str = "outputs/train",
          check_interval=None, ckpt_every=None, val_batch=None,
          sampling_timesteps=None, log_every=None,
          conv_backend: str = "cudnn", remat: bool = False) -> MatrixFlowExperiment:
    """The experiment of one run, not yet trained."""
    algo = dataclasses.replace(FLAGSHIP, sampling_timesteps=sampling_timesteps,
                               conv_backend=conv_backend, remat=remat)
    data = FLAGSHIP_DATA
    if image_size is not None:
        algo = dataclasses.replace(algo, image_size=image_size)
        data = dataclasses.replace(data, image_size=image_size)
    if unet_dim is not None:
        algo = dataclasses.replace(algo, unet_dim=unet_dim)
    train = dataclasses.replace(
        MATRIX_FLOW, batch_size=batch, max_steps=steps, seed=seed,
        check_interval=check_interval or min(MATRIX_FLOW.check_interval, steps),
        every_n_train_steps=ckpt_every or MATRIX_FLOW.every_n_train_steps,
        val_batch_size=val_batch or MATRIX_FLOW.val_batch_size,
        log_every=log_every or min(MATRIX_FLOW.log_every, steps))
    return MatrixFlowExperiment(algo, train, dataclasses.replace(data, seed=seed), out, device)


def run(steps: int, resume: bool = False, **kwargs) -> dict:
    """Build, restore when ``resume``, train to ``steps``; the summary line."""
    exp = build(steps, **kwargs)
    start = exp.restore() if resume else 0
    t0 = time.perf_counter()
    train = exp.train()
    if exp.device.type == "cuda":
        torch.cuda.synchronize(exp.device)
    seconds = time.perf_counter() - t0
    return {
        "device": str(exp.device),
        "batch": exp.cfg.batch_size,
        "image_size": exp.algo_cfg.image_size,
        "unet_dim": exp.algo_cfg.unet_dim,
        "conv_backend": exp.algo_cfg.conv_backend,
        "remat": exp.algo_cfg.remat,
        "start_step": start,
        "step": exp.state.step,
        "checkpoints": exp.ckpt.steps(),
        "seconds": seconds,
        "samples_per_s": (exp.state.step - start) * exp.cfg.batch_size / seconds,
        "train": train,
        "val": exp.last_val,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20, help="train steps in all")
    ap.add_argument("--batch", type=int, default=MATRIX_FLOW.batch_size)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--unet-dim", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="outputs/train")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint under --out")
    ap.add_argument("--check-interval", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--val-batch", type=int, default=None)
    ap.add_argument("--sampling-timesteps", type=int, default=None)
    ap.add_argument("--conv-backend", choices=BACKENDS, default="cudnn")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the UnetWithWarp closure in the backward")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.steps, a.resume, batch=a.batch, image_size=a.image_size,
                         unet_dim=a.unet_dim, seed=a.seed, device=a.device, out=a.out,
                         check_interval=a.check_interval, ckpt_every=a.ckpt_every,
                         val_batch=a.val_batch, sampling_timesteps=a.sampling_timesteps,
                         conv_backend=a.conv_backend, remat=a.remat)))


if __name__ == "__main__":
    main()
