"""The training loop and the test task (JAX ``experiments/base.py::
JaxExperiment``: ``train``, ``_validate`` and ``test``), on one device.

Builds the algorithm (weights drawn from the seed), the dataset by name
(``artificial``, ``sintel``, ``flying_chairs``, ``kitti_single``,
``artificial_video``; ``data/__init__.py::get_dataset``) with its training
and validation loaders (``num_workers`` threads, capped at the CPU count;
the validation batches shuffled with ``val_shuffle``), the optimizer
and the checkpoint manager, then runs train steps with cadenced train
metrics, validation (``check_interval`` steps, or that share of an epoch
when it is a float; ``limit_batch`` batches, each batch's images written by
the algorithm's ``visualize`` under ``images/<key>/``), checkpoints
(``every_n_train_steps``, and always at the end) and an optional profiler
trace of one step (``profile_step``: ``torch.profiler``'s chrome trace under
``profile/``; JAX traces an extra step on the same batch, the port that
step itself).  Training ends at ``max_steps`` or after ``epochs`` passes
over the loader in this call, whichever comes first.  It writes
``metrics.jsonl`` and ``checkpoints/<step>/`` under the output directory.
``restore`` loads the newest checkpoint of ``ckpt_path`` (a run directory,
its ``checkpoints`` directory or one step's directory) or, without it, of
the output directory (module, optimizer, step and the training generator),
and training continues where that run stood, the loader's epoch and batch
included, so a resumed run takes the same batches and random draws as one
that was never interrupted.  ``test`` evaluates the newest checkpoint (of
``ckpt_path``, else of the output directory, else the initial weights) on
the whole ``test`` split and logs the mean of each validation metric as
``test/*``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ArtificialDataConfig, TrainingConfig
from ..data import get_dataset
from ..data.loader import DataLoader
from ..parallel.train import TrainState, make_optimizer, make_train_step
from ..utils.ckpt import FILE, CheckpointManager
from ..utils.logging import RunLogger


def to_device(batch, device) -> tuple:
    """Collated NHWC numpy arrays -> float32 NCHW tensors on ``device``; a
    stack of frames (B, T, H, W, C) -> (B, T, C, H, W); an array of fewer
    dimensions (class labels) as it is, integers as int64."""
    def one(a):
        if a.ndim < 4:
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.long() if not t.is_floating_point() else t).to(device)
        return torch.from_numpy(a).permute(*((0, 1, 4, 2, 3) if a.ndim == 5 else (0, 3, 1, 2))
                                           ).contiguous().to(device)
    return tuple(one(a) for a in batch)


def resolve_checkpoint(path) -> Tuple[Path, Optional[int]]:
    """(checkpoints directory, step or None for the newest) of ``path``: a
    run's output directory, its ``checkpoints`` directory, or one step's
    directory ``checkpoints/<step>``."""
    p = Path(path)
    if (p / FILE).exists():
        return p.parent, int(p.name)
    if (p / "checkpoints").is_dir():
        return p / "checkpoints", None
    if p.is_dir():
        return p, None
    raise FileNotFoundError(f"no checkpoint directory at {p}")


class Experiment:
    """One run of ``algorithm_cls(algo_cfg)`` (FlowDiffuser, FlowPred,
    FlowLearner, MatrixFlow, FrameGenerator or FlowCompleter) on the dataset
    ``data_cfg`` names (an ``ArtificialDataConfig`` is the artificial
    dataset, drawn at the algorithm's image size).  ``device`` defaults to
    cuda."""

    algorithm_cls = None

    def __init__(self, algo_cfg, train_cfg: TrainingConfig, data_cfg, out_dir, device="cuda",
                 ckpt_path=None):
        self.algo_cfg, self.cfg, self.data_cfg = algo_cfg, train_cfg, data_cfg
        self.out_dir = Path(out_dir)
        self.device = torch.device(device)
        self.ckpt_path = ckpt_path
        seed = int(train_cfg.seed)
        self.algorithm = self.algorithm_cls(
            algo_cfg, device=self.device, generator=torch.Generator().manual_seed(seed))
        module = self.algorithm.module
        self.state = TrainState(module, make_optimizer(
            module.parameters(), algo_cfg.lr, algo_cfg.weight_decay, train_cfg.clipping))
        # the training stream: augmentation, timesteps and noise
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.dataset_name = getattr(data_cfg, "name", "artificial")
        if isinstance(data_cfg, ArtificialDataConfig):
            self.data_cfg = dataclasses.replace(
                data_cfg, image_size=int(str(algo_cfg.image_size).split(",")[0]))
        self._datasets: Dict[str, object] = {}
        self.train_loader = self.loader("training", train_cfg.batch_size, True)
        self.val_loader = self.loader("validation", train_cfg.val_batch_size,
                                      bool(train_cfg.val_shuffle))
        self.ckpt = CheckpointManager(self.out_dir / "checkpoints",
                                      every_n_train_steps=train_cfg.every_n_train_steps)
        self.logger = RunLogger(self.out_dir)
        self.train_step = make_train_step(self.algorithm.loss_fn,
                                          train_cfg.accumulate_grad_batches)
        self.last_val: Dict[str, float] = {}
        self.last_train: Dict[str, float] = {}
        self.last_test: Dict[str, float] = {}
        self.images: Dict[str, Path] = {}

    def dataset(self, split: str):
        """The dataset of ``split`` (``training``, ``validation`` or
        ``test``); the artificial dataset is one object for every split."""
        key = "all" if self.dataset_name == "artificial" else split
        if key not in self._datasets:
            self._datasets[key] = get_dataset(self.dataset_name)(self.data_cfg, split=split)
        return self._datasets[key]

    def loader(self, split: str, batch_size: int, shuffle: bool) -> DataLoader:
        workers = min(os.cpu_count() or 1, int(self.cfg.num_workers))
        return DataLoader(self.dataset(split), batch_size, shuffle, int(self.cfg.seed),
                          num_workers=workers)

    def restore(self, step: Optional[int] = None) -> int:
        """Load the newest (or the given) checkpoint of ``ckpt_path``, else of
        the output directory; returns its step."""
        if self.ckpt_path is None:
            return self.ckpt.restore(self.state, self.generator, step)
        directory, at = resolve_checkpoint(self.ckpt_path)
        return CheckpointManager(directory).restore(self.state, self.generator,
                                                    step if step is not None else at)

    def _eval_batches(self, loader, gen, limit: Optional[int], images: bool):
        """The validation step's metrics of each batch (the first ``limit``
        ones), with the images of each batch logged when ``images``."""
        self.state.module.eval()
        try:
            for i, batch in enumerate(loader):
                if limit is not None and i >= limit:
                    break
                batch = to_device(batch, self.device)
                metrics, artifacts = self.algorithm.val_step(batch, gen)
                if images:
                    for key, img in self.algorithm.visualize(batch, artifacts).items():
                        self.images[key] = self.logger.log_image(key, img, self.state.step)
                yield metrics
        finally:
            self.state.module.train()

    def validate(self) -> Dict[str, float]:
        """``limit_batch`` validation batches with a generator of their own
        (seeded from the step), so validation leaves the training stream as
        it was; logs each batch's metrics and images, returns the last
        batch's metrics."""
        step = self.state.step
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.cfg.seed) * 1_000_003 + step)
        record = {}
        for metrics in self._eval_batches(self.val_loader, gen, self.cfg.limit_batch, True):
            record = self.logger.log_dict(metrics, step)
        self.last_val = record
        return record

    def test(self) -> Dict[str, float]:
        """The mean of each validation metric over the whole ``test`` split
        (validation's batch size, unshuffled), logged as ``test/*`` at the
        evaluated checkpoint's step."""
        if self.ckpt_path is not None or self.ckpt.latest_step() is not None:
            self.restore()
        loader = self.loader("test", self.cfg.val_batch_size, bool(self.cfg.val_shuffle))
        gen = torch.Generator(device=self.device).manual_seed(int(self.cfg.seed))
        totals: Dict[str, float] = {}
        count = 0
        for metrics in self._eval_batches(loader, gen, None, False):
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        record = {}
        if count:
            record = self.logger.log_dict(
                {k.replace("val/", "test/").replace("validation/", "test/"): v / count
                 for k, v in totals.items()}, self.state.step)
        self.last_test = record
        return record

    def _check_interval(self) -> int:
        every = self.cfg.check_interval
        if isinstance(every, float):
            return max(1, int(len(self.train_loader) * every))
        return int(every)

    def _profiled_step(self, batch) -> dict:
        """One train step under ``torch.profiler``; its chrome trace and
        table go to ``profile/``."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        out = self.out_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        with profile(activities=acts) as prof:
            metrics = self.train_step(self.state, batch, self.generator)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(str(out / f"step_{self.state.step}.json"))
        sort = "cuda_time_total" if self.device.type == "cuda" else "cpu_time_total"
        (out / f"step_{self.state.step}.txt").write_text(
            prof.key_averages().table(sort_by=sort, row_limit=40))
        return metrics

    def train(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Train until ``max_steps`` (default: the config's; -1 forever) or
        the config's ``epochs`` passes over the loader, whichever is first."""
        cfg = self.cfg
        max_steps = cfg.max_steps if max_steps is None else int(max_steps)
        max_epochs = int(cfg.epochs)
        state, loader = self.state, self.train_loader
        check_every = self._check_interval()
        # resume at the batch where the restored run stood
        loader.epoch, loader.skip = divmod(state.step, len(loader))
        self.state.module.train()
        t_last, steps_since = time.perf_counter(), 0
        epoch = 0
        while (max_epochs < 0 or epoch < max_epochs) and (0 > max_steps or state.step < max_steps):
            for batch in loader:
                batch = to_device(batch, self.device)
                if state.step + 1 == cfg.profile_step:
                    metrics = self._profiled_step(batch)
                else:
                    metrics = self.train_step(state, batch, self.generator)
                steps_since += 1
                if state.step % cfg.log_every == 0 or state.step == max_steps:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    now = time.perf_counter()
                    metrics["train/steps_per_sec"] = steps_since / (now - t_last)
                    self.last_train = self.logger.log_dict(metrics, state.step)
                    t_last, steps_since = now, 0
                if state.step % check_every == 0:
                    self.validate()
                    t_last = time.perf_counter()
                self.ckpt.maybe_save(state, self.generator)
                if 0 < max_steps <= state.step:
                    break
            epoch += 1
        self.ckpt.maybe_save(state, self.generator, force=True)
        return self.last_train

    def exec_task(self, task: str) -> Dict[str, float]:
        """Run ``train`` or ``test`` (JAX ``BaseExperiment.exec_task``)."""
        if task == "train":
            return self.train()
        if task == "test":
            return self.test()
        raise ValueError(f"Task '{task}' not implemented for {type(self).__name__}.")


__all__ = ["Experiment", "resolve_checkpoint", "to_device"]
