"""The training loop (JAX ``experiments/base.py::JaxExperiment.train`` and
``_validate``), on one device.

Builds the algorithm (weights drawn from the seed), the training and
validation loaders, the optimizer and the checkpoint manager, then runs
train steps with cadenced train metrics, validation (``check_interval``
steps, ``limit_batch`` batches) and checkpoints (``every_n_train_steps``,
and always at ``max_steps``), writing ``metrics.jsonl`` and
``checkpoints/<step>/`` under the output directory.  With ``resume`` it
restores the newest checkpoint there (module, optimizer, step and the
training generator) and continues where that run stood, the loader's
epoch and batch included, so a resumed run takes the same batches and
random draws as one that was never interrupted.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from ..config import (ArtificialDataConfig, FlowDiffuserConfig, FlowLearnerConfig, FlowPredConfig,
                      TrainingConfig)
from ..data.artificial import ArtificialDataset
from ..data.loader import DataLoader
from ..parallel.train import TrainState, make_optimizer, make_train_step
from ..utils.ckpt import CheckpointManager
from ..utils.logging import RunLogger


def to_device(batch, device) -> tuple:
    """Collated NHWC numpy arrays -> float32 NCHW tensors on ``device``."""
    return tuple(torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device)
                 for a in batch)


class Experiment:
    """One training run of ``algorithm_cls(algo_cfg)`` (FlowDiffuser,
    FlowPred or FlowLearner) on the artificial dataset.  ``device`` defaults to cuda."""

    algorithm_cls = None

    def __init__(self, algo_cfg: Union[FlowDiffuserConfig, FlowPredConfig, FlowLearnerConfig],
                 train_cfg: TrainingConfig, data_cfg: ArtificialDataConfig, out_dir, device="cuda"):
        self.algo_cfg, self.cfg, self.data_cfg = algo_cfg, train_cfg, data_cfg
        self.out_dir = Path(out_dir)
        self.device = torch.device(device)
        seed = int(train_cfg.seed)
        self.algorithm = self.algorithm_cls(
            algo_cfg, device=self.device, generator=torch.Generator().manual_seed(seed))
        module = self.algorithm.module
        self.state = TrainState(module, make_optimizer(
            module.parameters(), algo_cfg.lr, algo_cfg.weight_decay, train_cfg.clipping))
        # the training stream: augmentation, timesteps and noise
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        dataset = ArtificialDataset(dataclasses.replace(data_cfg, image_size=algo_cfg.image_size))
        self.train_loader = DataLoader(dataset, train_cfg.batch_size, True, seed)
        self.val_loader = DataLoader(dataset, train_cfg.val_batch_size, False, seed)
        self.ckpt = CheckpointManager(self.out_dir / "checkpoints",
                                      every_n_train_steps=train_cfg.every_n_train_steps)
        self.logger = RunLogger(self.out_dir)
        self.train_step = make_train_step(self.algorithm.loss_fn,
                                          train_cfg.accumulate_grad_batches)
        self.last_val: Dict[str, float] = {}
        self.last_train: Dict[str, float] = {}

    def restore(self, step: Optional[int] = None) -> int:
        """Load the newest (or the given) checkpoint; returns its step."""
        return self.ckpt.restore(self.state, self.generator, step)

    def validate(self) -> Dict[str, float]:
        """``limit_batch`` validation batches with a generator of their own
        (seeded from the step), so validation leaves the training stream as
        it was; logs and returns the last batch's metrics."""
        step = self.state.step
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.cfg.seed) * 1_000_003 + step)
        self.state.module.eval()
        record = {}
        for i, batch in enumerate(self.val_loader):
            if i >= self.cfg.limit_batch:
                break
            metrics, _ = self.algorithm.val_step(to_device(batch, self.device), gen)
            record = self.logger.log_dict(metrics, step)
        self.state.module.train()
        self.last_val = record
        return record

    def train(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Train until ``max_steps`` (default: the config's; -1 forever)."""
        cfg = self.cfg
        max_steps = cfg.max_steps if max_steps is None else int(max_steps)
        state, loader = self.state, self.train_loader
        # resume at the batch where the restored run stood
        loader.epoch, loader.skip = divmod(state.step, len(loader))
        self.state.module.train()
        t_last, steps_since = time.perf_counter(), 0
        while 0 > max_steps or state.step < max_steps:
            for batch in loader:
                metrics = self.train_step(state, to_device(batch, self.device), self.generator)
                steps_since += 1
                if state.step % cfg.log_every == 0 or state.step == max_steps:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    now = time.perf_counter()
                    metrics["train/steps_per_sec"] = steps_since / (now - t_last)
                    self.last_train = self.logger.log_dict(metrics, state.step)
                    t_last, steps_since = now, 0
                if state.step % cfg.check_interval == 0:
                    self.validate()
                    t_last = time.perf_counter()
                self.ckpt.maybe_save(state, self.generator)
                if 0 < max_steps <= state.step:
                    self.ckpt.maybe_save(state, self.generator, force=True)
                    return self.last_train
        return self.last_train


__all__ = ["Experiment", "to_device"]
