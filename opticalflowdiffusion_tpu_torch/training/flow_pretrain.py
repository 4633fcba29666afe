"""Train RAFT for the TaiChi flow precompute (JAX ``training/flow_pretrain.py``).

The reference supervises TaiChi with flows from torchvision's pretrained
raft_large, whose weights are not redistributable; the JAX package trains
its own RAFT on ``ArtificialDataset``'s exact flows instead and publishes
the checkpoint to the local artifact store as ``raft-artificial``, the
TaiChi precompute's default ``flow_checkpoint``.  This is that trainer on
the port's RAFT (the S4 lookup kernel on the card): JAX's defaults (64x64,
b16, 6 iterations, 4 levels, lr 2e-4, gamma 0.8, ``max_motion`` 1, boxes
over checkers, 512 items), its loader order (the first batch of the
loader's first pass is the evaluation batch, training starts at the
second pass), the sequence loss sum_i gamma^(N - i - 1) mean |f_i - f_gt|,
and its optimizer, optax's ``clip_by_global_norm(1.0) -> adamw(lr)``:
decoupled weight decay 1e-4 on every parameter (``torch.optim.AdamW``).
The initial weights are flax's distribution (``init_weights``) from the
seed.  The result reports the EPE before and after, the zero-flow EPE,
and both on the moving pixels (|flow| > 0.5).

Usage:
    python -m opticalflowdiffusion_tpu_torch.training.flow_pretrain \\
        --steps 1000 --image-size 64 --batch 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Sequence

import torch

from ..config import ArtificialDataConfig
from ..data.artificial import ArtificialDataset
from ..data.loader import DataLoader
from ..experiments.base import to_device
from ..models.raft import RAFT
from ..models.unet import init_weights
from ..parallel.train import TrainState, make_optimizer
from ..utils.ckpt import CheckpointManager, publish_artifact

WEIGHT_DECAY = 1e-4       # optax.adamw's default
CLIP = 1.0


def sequence_loss(preds: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                  gamma: float = 0.8) -> torch.Tensor:
    """sum_i gamma^(N - i - 1) * mean |preds[i] - flow_gt|."""
    n = len(preds)
    loss = 0.0
    for i, p in enumerate(preds):
        loss = loss + (gamma ** (n - i - 1)) * (p - flow_gt).abs().mean()
    return loss


def epe_map(pred: torch.Tensor, flow_gt: torch.Tensor) -> torch.Tensor:
    """The end-point error of each pixel, (B, H, W)."""
    return torch.linalg.vector_norm(pred - flow_gt, dim=1)


def setup(image_size: int = 64, batch: int = 16, iters: int = 6, corr_levels: int = 4,
          max_motion: int = 1, seed: int = 0, dataset_size: int = 512, device="cuda"):
    """(RAFT with flax's initial distribution from ``seed``, the loader) at
    JAX's settings."""
    ds = ArtificialDataset(ArtificialDataConfig(image_size=image_size, size=dataset_size,
                                                shape="boxes", bg="checkers", seed=seed,
                                                max_motion=max_motion))
    loader = DataLoader(ds, batch_size=batch, shuffle=True, seed=seed)
    model = RAFT(iters=iters, corr_levels=corr_levels, image_size=image_size)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device), loader


def make_step(model: RAFT, lr: float = 2e-4, gamma: float = 0.8):
    """(state, step): ``step(state, first, second, flow_gt)`` takes one
    AdamW step and returns (loss, epe) on the device."""
    state = TrainState(model, make_optimizer(model.parameters(), lr, WEIGHT_DECAY, CLIP,
                                             decoupled=True))

    def step(state, first, second, flow_gt):
        opt = state.optimizer
        opt.zero_grad()
        preds = state.module(first, second)
        loss = sequence_loss(preds, flow_gt, gamma)
        loss.backward()
        opt.step()
        state.step += 1
        return loss.detach(), epe_map(preds[-1].detach(), flow_gt).mean()

    return state, step


def train_flow_model(steps: int = 1000, image_size: int = 64, batch: int = 16,
                     lr: float = 2e-4, iters: int = 6, corr_levels: int = 4,
                     max_motion: int = 1, gamma: float = 0.8, seed: int = 0,
                     out_dir: str = "outputs/flow_pretrain", artifact: str = "raft-artificial",
                     dataset_size: int = 512, log_every: int = 50, device="cuda") -> dict:
    """Train, evaluate on the first batch, save the checkpoint under
    ``out_dir/checkpoints`` and publish it as ``artifact``; returns
    {'epe', 'epe_init', 'zero_flow_epe', 'epe_moving',
    'zero_flow_epe_moving', 'steps', 'artifact', 'ckpt_dir', 'samples_per_sec'}."""
    model, loader = setup(image_size, batch, iters, corr_levels, max_motion, seed,
                          dataset_size, device)
    state, step = make_step(model, lr, gamma)
    ef, es, eflow = to_device(next(iter(loader)), device)

    def evaluate():
        with torch.no_grad():
            return epe_map(model(ef, es)[-1], eflow)

    epe_init = float(evaluate().mean())
    sync = (lambda: torch.cuda.synchronize(device)) if torch.device(device).type == "cuda" else (
        lambda: None)
    t0, done, t_warm = time.time(), 0, None
    while done < steps:
        for b in loader:
            loss, epe = step(state, *to_device(b, device))
            done += 1
            if done == 1:
                sync()
                t_warm = time.time()
            if done % log_every == 0:
                print(f"[flow_pretrain] step {done}/{steps} loss={float(loss):.4f} "
                      f"epe={float(epe):.4f} ({time.time() - t0:.0f}s)", flush=True)
            if done >= steps:
                break
    sync()
    sps = (done - 1) * batch / max(time.time() - t_warm, 1e-9) if done > 1 else float("nan")
    err = evaluate()
    gmag = torch.linalg.vector_norm(eflow, dim=1)
    moving = gmag > 0.5
    any_moving = bool(moving.any())
    ckpt_dir = Path(out_dir) / "checkpoints"
    CheckpointManager(ckpt_dir, every_n_train_steps=steps).maybe_save(
        state, torch.Generator().manual_seed(seed), force=True)
    publish_artifact(artifact, ckpt_dir)
    result = dict(
        epe=float(err.mean()), epe_init=epe_init, zero_flow_epe=float(gmag.mean()),
        epe_moving=float(err[moving].mean()) if any_moving else float("nan"),
        zero_flow_epe_moving=float(gmag[moving].mean()) if any_moving else float("nan"),
        steps=done, artifact=artifact, ckpt_dir=str(ckpt_dir), samples_per_sec=sps,
    )
    print(f"[flow_pretrain] {result}", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--corr-levels", type=int, default=4)
    ap.add_argument("--max-motion", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="outputs/flow_pretrain")
    ap.add_argument("--artifact", default="raft-artificial")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    train_flow_model(steps=a.steps, image_size=a.image_size, batch=a.batch, lr=a.lr,
                     iters=a.iters, corr_levels=a.corr_levels, max_motion=a.max_motion,
                     seed=a.seed, out_dir=a.out_dir, artifact=a.artifact, device=a.device)


if __name__ == "__main__":
    main()


__all__ = ["epe_map", "make_step", "sequence_loss", "setup", "train_flow_model"]
