"""The parity harnesses' first training batch is JAX's: each of JAX's stages
opens its training loader twice before its first step (``algo.init(rng,
next(iter(train_loader)))`` for the initial evaluation's state, then again
in its ``_train``), and a pass reshuffles with seed + epoch, so a stage
trains from the loader's third pass.  The JAX side below builds each
stage's loader as JAX's ``training/parity.py`` and
``training/parity_families.py`` build them and opens those two passes; the
port's harnesses hand their training loop the loaders that
``parity.stage_loaders`` and ``parity_families.stage_setup`` return."""

import dataclasses

import numpy as np
import pytest

from opticalflowdiffusion_tpu.config import Config, compose
from opticalflowdiffusion_tpu.data.artificial import ArtificialDataset as JArtificialDataset
from opticalflowdiffusion_tpu.data.artificial_video import (
    ArtificialVideoDataset as JArtificialVideoDataset,
)
from opticalflowdiffusion_tpu.data.loader import DataLoader as JDataLoader
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP_DATA
from opticalflowdiffusion_tpu_torch.training import parity
from opticalflowdiffusion_tpu_torch.training import parity_families as pf


def _jax_first_training_batch(dataset, batch: int, seed: int = 0):
    loader = JDataLoader(dataset, batch_size=batch, shuffle=True, seed=seed)
    next(iter(loader))                   # the initial evaluation's algo.init
    next(iter(loader))                   # _train's algo.init
    return next(iter(loader))


class _JaxThreeFrame:
    """JAX's ``ThreeFrame`` (``parity_families.py``): (f1, f2, f3, flow)
    from the video's stacks."""

    def __init__(self, cfg, seed):
        c = dict(cfg.dataset)
        c["seed"] = seed
        self.ds = JArtificialVideoDataset(Config(c), split="validation")

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        stack = self.ds[i][0]
        return stack[0, ..., 3:6], stack[1, ..., 3:6], stack[1, ..., :3], stack[1, ..., 6:8]


def _jax_family_dataset(stage: str):
    if stage == "matrix":
        cfg = compose(["experiment=matrix_flow", "dataset=artificial", "dataset.image_size=32",
                       "dataset.size=4096", "+dataset.seed=7", "algorithm=matrix_flow"])
        return JArtificialDataset(cfg.dataset, split="training"), 16
    if stage == "pwc":
        cfg = compose(["experiment=matrix_flow", "dataset=artificial_video",
                       "dataset.image_size=64", "dataset.size=4096", "dataset.val_length=2",
                       "+dataset.max_motion=2", "algorithm=pwc_learner"])
        return _JaxThreeFrame(cfg, 0), 8
    algorithm = {"framegen": "frame_generator", "completer": "flow_completer"}[stage]
    cfg = compose(["experiment=animation", "dataset=artificial_video", "dataset.image_size=32",
                   "dataset.size=4096", f"dataset.val_length={5 if stage == 'framegen' else 2}",
                   "+dataset.max_motion=2", f"algorithm={algorithm}"])
    return JArtificialVideoDataset(cfg.dataset, split="training"), 16


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_parity_stage_trains_from_jax_first_batch():
    """``parity.py``'s stages (FlowDiffuser's, FlowLearner's, the AE's and
    the latent one share the loaders) on the artificial dataset, seed 7."""
    cfg = compose(["experiment=matrix_flow", "dataset=artificial", "dataset.image_size=32",
                   "dataset.size=4096", "+dataset.seed=7", "algorithm=flow_diffuser"])
    want = _jax_first_training_batch(JArtificialDataset(cfg.dataset, split="training"), 16)
    data = dataclasses.replace(FLAGSHIP_DATA, image_size=32, size=4096, seed=7)
    train_loader, _ = parity.stage_loaders(data, 16, 8, 0)
    _assert_same(next(iter(train_loader)), want)


@pytest.mark.parametrize("stage", ["matrix", "framegen", "completer", "pwc"])
def test_family_stage_trains_from_jax_first_batch(stage):
    """Each family stage's (the hunt's runs share the ``pwc`` loaders)."""
    dataset, batch = _jax_family_dataset(stage)
    want = _jax_first_training_batch(dataset, batch)
    _, train_loader, _ = pf.stage_setup(stage, "cpu")
    _assert_same(next(iter(train_loader)), want)
