"""Pretrain the flow-equivariant Autoencoder for the latent FlowDiffuser
(JAX ``training/ae_pretrain.py::train_ae``).

Trains FlowPred on the artificial dataset with a white background, as JAX's
script draws it (through the port's experiment
loop: Adam with global-norm clipping at 100, float32 as JAX's script runs)
and writes ``<out>/checkpoints/<steps>/``, whose module holds the
Autoencoder under the ``ae.`` prefix that ``train.py --latent --ae <out>``
reads.  Reports the reconstruction MSE on one batch of a validation set
(seed + 1, 256 items) before and after, and the identity baseline (the
input frame as the reconstruction).

    python -m opticalflowdiffusion_tpu_torch.training.ae_pretrain \\
        --steps 3000 --image-size 32 --batch 16 [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ..algorithms.base import to_batch
from ..config import FLAGSHIP_DATA, FLOW_PRED, MATRIX_FLOW
from ..data.artificial import ArtificialDataset
from ..experiments.matrix_flow import MatrixFlowExperiment


def train_ae(steps: int = 3000, image_size: int = 32, batch: int = 16, lr: float = 4e-4,
             latent_dim: int = 16, ae_frac: float = 0.1, seed: int = 0,
             out_dir: str = "outputs/ae_pretrain", dataset_size: int = 4096,
             log_every: int = 100, device: str = "cuda", precision: str = "float32",
             conv_backend: str = "cudnn") -> dict:
    """Train, checkpoint at the last step; returns the reconstruction MSEs
    (``recon_mse``, ``recon_mse_init``, ``identity_mse``) and where the
    checkpoint is."""
    algo_cfg = dataclasses.replace(FLOW_PRED, image_size=image_size, lr=lr,
                                   latent_dim=latent_dim, ae_frac=ae_frac,
                                   precision=precision, conv_backend=conv_backend)
    # JAX's script builds its datasets from the size, the count and the seed
    # alone, so their background is the dataset's default (white), not the
    # yaml's checkers
    data_cfg = dataclasses.replace(FLAGSHIP_DATA, image_size=image_size, size=dataset_size,
                                   seed=seed, bg="white")
    train_cfg = dataclasses.replace(MATRIX_FLOW, batch_size=batch, max_steps=steps, seed=seed,
                                    check_interval=steps, every_n_train_steps=steps,
                                    val_batch_size=batch, log_every=min(log_every, steps))
    exp = MatrixFlowExperiment(algo_cfg, train_cfg, data_cfg, out_dir, device, "flow_pred")
    val = ArtificialDataset(dataclasses.replace(data_cfg, size=256, seed=seed + 1))
    val_batch = to_batch([val[i] for i in range(batch)], exp.device)
    recon = lambda: float(exp.algorithm.val_step(val_batch)[0]["val/loss"])
    mse_init = recon()
    exp.train()
    img, tgt, _ = val_batch
    return dict(recon_mse=recon(), recon_mse_init=mse_init,
                identity_mse=float((img - tgt).square().mean()), steps=exp.state.step,
                ckpt_dir=str(exp.ckpt.directory), latent_dim=latent_dim)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--latent-dim", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="outputs/ae_pretrain")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(train_ae(steps=a.steps, image_size=a.image_size, batch=a.batch, lr=a.lr,
                              latent_dim=a.latent_dim, seed=a.seed, out_dir=a.out_dir,
                              device=a.device)))


if __name__ == "__main__":
    main()


__all__ = ["train_ae"]
