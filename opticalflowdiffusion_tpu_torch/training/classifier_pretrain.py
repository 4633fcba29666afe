"""Train the classifier whose pooled features back the Frechet metric
(JAX ``training/classifier_pretrain.py``; ``utils/fid.py::classifier_feature_fn``).

The reference scores with pretrained InceptionV3, whose weights are not
available here; the JAX package trains its own ResNet18 instead and
publishes the checkpoint to the local artifact store as
``classifier-feat``.  This is that trainer on the port: CIFAR-10 when the
data is present under the dataset root (``data/cifar10.py``), else the
deterministic synthetic shape-by-colour task (:func:`synthetic_class_batch`,
the same numpy draws as JAX's), so a trained feature extractor always
exists.  As in JAX, one ``numpy.random.default_rng(seed)`` draws every
batch, the first batch sizes the initial state and is not trained on,
training is Adam at ``lr`` with no clipping (BatchNorm's running
statistics folded by each step), and the evaluation batch is the next one
after training.  The weights start from flax's distribution
(``init_weights``) at ``seed``.

Usage:
    python -m opticalflowdiffusion_tpu_torch.training.classifier_pretrain \\
        --steps 1000 --batch 128 [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..algorithms.classifier import Classifier
from ..config import CIFAR10, ClassifierConfig
from ..parallel.train import TrainState, make_optimizer, make_train_step
from ..utils.ckpt import CheckpointManager, publish_artifact


def synthetic_class_batch(rng: np.random.Generator, n: int, size: int = 32):
    """(images (n, size, size, 3) float32 in [0, 1], labels (n,) int32):
    class = shape (box / cross) x colour (5), shapes at random positions and
    scales over noise backgrounds."""
    colors = np.asarray(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1]], np.float32
    )
    imgs = rng.normal(0.5, 0.08, size=(n, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    for i in range(n):
        shape, color = labels[i] // 5, colors[labels[i] % 5]
        s = int(rng.integers(6, 13))
        y, x = rng.integers(2, size - s - 2, size=2)
        if shape == 0:  # filled box
            imgs[i, y: y + s, x: x + s] = color
        else:  # cross
            c = s // 2
            imgs[i, y + c - 1: y + c + 2, x: x + s] = color
            imgs[i, y: y + s, x + c - 1: x + c + 2] = color
    return np.clip(imgs, 0, 1), labels


def _to_device(images: np.ndarray, labels: np.ndarray, device) -> tuple:
    return (torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(device),
            torch.from_numpy(labels).long().to(device))


def train_classifier(
    steps: int = 1000,
    batch: int = 128,
    lr: float = 1e-3,
    seed: int = 0,
    out_dir: str = "outputs/classifier_pretrain",
    artifact: str = "classifier-feat",
    log_every: int = 100,
    device="cuda",
    data_cfg=CIFAR10,
) -> dict:
    """Train, evaluate, save under ``out_dir/checkpoints`` and publish as
    ``artifact``; returns {'accuracy', 'source' ('cifar10' or
    'synthetic'), 'steps', 'artifact', 'ckpt_dir', 'samples_per_sec'}."""
    from ..data.cifar10 import CIFAR10Dataset

    dev = torch.device(device)
    algo = Classifier(ClassifierConfig(arch="resnet18", num_class=10, in_channels=3, lr=lr),
                      device=dev, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    try:
        cifar = CIFAR10Dataset(data_cfg, "training")
        source = "cifar10"
    except FileNotFoundError:
        cifar, source = None, "synthetic"

    def next_batch():
        if cifar is not None:
            idx = rng.integers(0, len(cifar), size=batch)
            pairs = [cifar[int(i)] for i in idx]
            return (np.stack([p[0] for p in pairs]),
                    np.asarray([p[1] for p in pairs], np.int32))
        return synthetic_class_batch(rng, batch)

    next_batch()                      # JAX's init batch: shapes the state, not trained on
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), lr))
    step_fn = make_train_step(algo.loss_fn)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    algo.module.train()
    t0 = t_warm = time.time()
    for done in range(1, steps + 1):
        metrics = step_fn(state, _to_device(*next_batch(), dev), None)
        if done == 1:
            sync()
            t_warm = time.time()
        if done % log_every == 0:
            print(f"[classifier_pretrain] step {done}/{steps} "
                  f"loss={float(metrics['train/loss']):.4f} "
                  f"acc={float(metrics['training/accuracy']):.3f} ({time.time() - t0:.0f}s)",
                  flush=True)
    sync()
    sps = (steps - 1) * batch / max(time.time() - t_warm, 1e-9) if steps > 1 else float("nan")
    metrics, _ = algo.val_step(_to_device(*next_batch(), dev))
    accuracy = float(metrics["validation/accuracy"])

    ckpt_dir = Path(out_dir) / "checkpoints"
    CheckpointManager(ckpt_dir, every_n_train_steps=steps).maybe_save(
        state, torch.Generator().manual_seed(seed), force=True)
    publish_artifact(artifact, ckpt_dir)
    result = dict(accuracy=accuracy, source=source, steps=steps, artifact=artifact,
                  ckpt_dir=str(ckpt_dir), samples_per_sec=sps)
    print(f"[classifier_pretrain] {result}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="outputs/classifier_pretrain")
    ap.add_argument("--artifact", default="classifier-feat")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    train_classifier(steps=a.steps, batch=a.batch, lr=a.lr, seed=a.seed, out_dir=a.out_dir,
                     artifact=a.artifact, device=a.device)


if __name__ == "__main__":
    main()


__all__ = ["synthetic_class_batch", "train_classifier"]
