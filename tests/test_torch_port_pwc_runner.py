"""PWCLearner through the entry points on the CPU: ``train.py --algorithm
pwc_learner`` on the constant-velocity video's three-frame view (train,
validate with JAX's images, checkpoint, ``--resume``, ``--tasks test``),
on the artificial pairs and on a Sintel fixture tree (whose test task
raises, as JAX's reader asserts its split); the three-frame view equal to
JAX's parity harness's ``ThreeFrame``; and the PWC stages of the family
parity harness: their data-only metrics equal JAX's recorded ones (covered
by ``test_torch_port_families_runner.py`` over ``STAGES``), their bars and
the hunt's pick."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.config import Config
from opticalflowdiffusion_tpu.data.artificial_video import (
    ArtificialVideoDataset as JArtificialVideoDataset,
)
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.config import ARTIFICIAL_VIDEO
from opticalflowdiffusion_tpu_torch.data import fixtures
from opticalflowdiffusion_tpu_torch.data.artificial_video import ThreeFrameVideo
from opticalflowdiffusion_tpu_torch.training import parity_families as pf

TINY = ["--device", "cpu", "--batch", "2", "--val-batch", "2", "--precision", "float32",
        "--algorithm", "pwc_learner", "--workers", "0"]
VIDEO = ["--dataset", "artificial_video", "--image-size", "64", "--dataset-size", "8",
         "--val-length", "2", "--max-motion", "2"]
# JAX's PWCLearner.visualize keys
IMAGE_KEYS = ["bwd_flow", "bwd_warped", "combined_frames", "fwd_flow", "fwd_warped",
              "gt_fwd_flow", "occlusions", "reconstructed_comb", "target"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_runs(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _train(capsys, args):
    train_entry.main(TINY + args)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("split,offset", (("training", 0), ("validation", 1000)))
def test_three_frame_view_equals_jax_harness(split, offset):
    """(f1, f2, f3, flow) of JAX's ThreeFrame (parity_families.py:165-187):
    the validation split drawn from seed + 0 (training) or + 1000."""
    cfg = dataclasses.replace(ARTIFICIAL_VIDEO, image_size=16, size=6, val_length=2,
                              max_motion=2, seed=3)
    view = ThreeFrameVideo(cfg, split)
    jds = JArtificialVideoDataset(Config(dict(image_size=16, size=6, val_length=2,
                                              max_motion=2, seed=3 + offset)),
                                  split="validation")
    assert len(view) == 6
    for i in range(6):
        stack = jds[i][0]
        want = (stack[0, ..., 3:6], stack[1, ..., 3:6], stack[1, ..., :3], stack[1, ..., 6:8])
        for got, w in zip(view[i], want):
            np.testing.assert_array_equal(got, w)
    with pytest.raises(ValueError, match="val_length"):
        ThreeFrameVideo(dataclasses.replace(cfg, val_length=1))


def test_train_resume_test_on_video(tmp_path, capsys):
    """Two steps with a validation (JAX's metric keys and images) and a
    checkpoint, ``--resume`` to 3, ``--tasks test`` on the newest."""
    args = VIDEO + ["--out", str(tmp_path)]
    out = _train(capsys, args + ["--steps", "2"])
    assert out["algorithm"] == "pwc_learner" and out["dataset"] == "artificial_video"
    assert out["step"] == 2 and out["checkpoints"] == [2] and out["conv_backend"] is None
    assert out["smoothness_weight"] == 1.0 and out["occ_weight"] == 1.0
    assert sorted(k for k in out["val"] if k.startswith("val/")) == ["val/epe", "val/loss"]
    assert np.isfinite(out["train"]["train/loss"]) and "train/flow_fwd_mean" in out["train"]
    assert out["images"] == IMAGE_KEYS
    out = _train(capsys, args + ["--steps", "3", "--resume"])
    assert out["start_step"] == 2 and out["step"] == 3
    out = _train(capsys, args + ["--steps", "3", "--tasks", "test"])
    assert sorted(k for k in out["test"] if k.startswith("test/")) == ["test/epe", "test/loss"]
    assert all(np.isfinite(v) for v in out["test"].values())


def test_train_on_pairs_with_the_weights(tmp_path):
    """The artificial pairs (the first frame doubles as the past one) with
    JAX's smoothness and occlusion knobs (config fields, set from Python)."""
    out = train_entry.run(1, device="cpu", batch=2, val_batch=2, precision="float32",
                          algorithm="pwc_learner", workers=0, image_size=64, dataset_size=4,
                          out=str(tmp_path), smoothness_weight=0.1, occ_weight=0.01)
    assert out["dataset"] == "artificial" and out["step"] == 1
    assert out["smoothness_weight"] == 0.1 and out["occ_weight"] == 0.01
    assert np.isfinite(out["train"]["train/loss"]) and np.isfinite(out["val"]["val/epe"])


def test_train_on_sintel_and_its_test_raises(tmp_path, capsys):
    """Three frames of a Sintel fixture tree at 64x64; ``test`` raises, as
    JAX's reader asserts its split."""
    fixtures.make_sintel_fixture(tmp_path / "d", scenes=2, frames=13, size=(64, 28))
    args = ["--dataset", "sintel", "--data-root", str(tmp_path / "d"), "--image-size", "64,64",
            "--out", str(tmp_path / "run")]
    out = _train(capsys, args + ["--steps", "1"])
    assert out["dataset"] == "sintel" and out["step"] == 1 and np.isfinite(out["val"]["val/epe"])
    with pytest.raises(AssertionError, match="training or validation"):
        train_entry.main(TINY + args + ["--steps", "1", "--tasks", "test"])


@pytest.mark.parametrize("name,make", (
    ("flying_chairs", lambda r: fixtures.make_chairs_fixture(r, n=8, size=(40, 30))),
    ("kitti_single", lambda r: fixtures.make_kitti_fixture(r, n=4, size=(48, 20))),
), ids=("flying_chairs", "kitti_single"))
def test_train_and_test_on_pair_datasets(tmp_path, capsys, name, make):
    """FlyingChairs and KITTI (pairs: the first frame doubles as the past
    one) at 64x64: a step with a validation, then the test task."""
    make(tmp_path / "d")
    args = ["--dataset", name, "--data-root", str(tmp_path / "d"), "--image-size", "64,64",
            "--out", str(tmp_path / "run"), "--steps", "1"]
    out = _train(capsys, args + ["--tasks", "train,test"])
    assert out["dataset"] == name and out["step"] == 1 and np.isfinite(out["val"]["val/epe"])
    assert sorted(k for k in out["test"] if k.startswith("test/")) == ["test/epe", "test/loss"]


def test_sizes_that_do_not_halve_raise(tmp_path):
    with pytest.raises(ValueError, match="halves exactly"):
        train_entry.main(TINY + ["--image-size", "72", "--dataset-size", "4", "--steps", "1",
                                 "--out", str(tmp_path)])


def test_pwc_bars_and_hunt_pick():
    """JAX's own numbers pass their bars; 10% over, or a tuned moving EPE
    not below zero flow's, misses; the hunt's pick must be JAX's."""
    for key in ("pwc_learner", "pwc_learner_tuned", "pwc_hunt_sw0.1"):
        final = {m: pf.jax_value(key, "final", m) for m in
                 ("val/epe", "epe_moving", "zero_flow_epe", "zero_flow_epe_moving",
                  "moving_frac")}
        res = {"init": {}, "final": dict(final)}
        assert all(b["ok"] for b in pf.family_bars(key, res).values()), key
        metric = "epe_moving" if key == "pwc_learner_tuned" else "val/epe"
        res["final"][metric] *= 1.11
        assert not pf.family_bars(key, res)[f"final {metric}"]["ok"], key
    assert pf.jax_value("pwc_learner", "final", "val/epe") == 1.3370303958654404
    assert abs(pf.jax_value("pwc_learner_tuned", "final", "epe_moving") * pf.FINAL_SLACK
               - 0.3535) < 1e-4
    scores = {"sw0.1": 0.16440139710903168, "sw0.01": 0.3743293136358261,
              "sw0.01_ow0.1": 0.38866107910871506}
    assert pf.hunt_bars({"config": "sw0.1", "scores": scores})["config"]["ok"]
    assert not pf.hunt_bars({"config": "sw0.01", "scores": scores})["config"]["ok"]
    assert [name for name, _ in pf.HUNT_GRID] == list(scores)
