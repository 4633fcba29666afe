"""The entry points on MatrixFlow and the animation family, on the CPU:
``train.py`` with ``--algorithm matrix_flow`` at each goal and with
FrameGenerator and FlowCompleter through the animation experiment on the
constant-velocity video (train, validate with the images, checkpoint,
``--resume``, ``--tasks test``), ``sample.py --algorithm frame_generator
--ckpt`` on a run, the names that wait for the RAFT port (TaiChi,
``architecture: raft``), and the family parity harness: its data-only
metrics equal to JAX's recorded ones (``JAX_FAMILY_BARS``), its bars, a
tiny run of its stages, and the trained weights it keeps.  And, marked ``cuda`` (skipped where there
is no card), ``chip_smoke.py``'s checks of the three models' train steps
with the kernels against the plain versions.  This file imports no JAX, so
the card's tests run with ``--noconftest``."""

import json
import shutil

import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu_torch import sample as sample_entry
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.training import parity_families as pf

TINY = ["--device", "cpu", "--image-size", "8", "--batch", "2", "--val-batch", "2",
        "--precision", "float32", "--dataset-size", "16"]
ANIM = ["--val-length", "2", "--sampling-timesteps", "2", "--dataset-size", "4"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint of these UNets (width 64, with Adam's state) is ~430 MB:
    each test's run directories go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _train(capsys, args):
    train_entry.main(TINY + args)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("goal", ("gt_flow_pred", "filter_pred", "gt_filter_pred"))
def test_train_matrix_flow_goals(tmp_path, capsys, goal):
    """Two MatrixFlow steps of each goal: finite losses, a validation with
    JAX's metric keys and images, a checkpoint."""
    out = _train(capsys, ["--algorithm", "matrix_flow", "--radius", "3", "--goal", goal,
                          "--steps", "2", "--out", str(tmp_path)])
    assert out["experiment"] == "MatrixFlowExperiment" and out["dataset"] == "artificial"
    assert out["goal"] == goal and out["radius"] == 3 and out["image_size"] == "8,8"
    assert out["step"] == 2 and out["checkpoints"] == [2]
    assert np.isfinite(out["train"]["train/loss"]) and "train/flow_err" in out["train"]
    keys = {"val/loss", "val/photometric", "val/flow_err", "val/opt_loss", "val/opt_photo"}
    if goal != "gt_flow_pred":
        keys |= {"val/mode_loss", "val/mode_photometric"}
    assert set(out["val"]) - {"step", "time"} == keys
    assert all(np.isfinite(out["val"][k]) for k in keys)
    assert {"original", "softmax_p", "opt_p", "compare"} <= set(out["images"])
    assert ("mode_flow" in out["images"]) == (goal != "gt_flow_pred")


def test_matrix_flow_resume_and_test(tmp_path, capsys):
    args = ["--algorithm", "matrix_flow", "--radius", "3", "--goal", "filter_pred",
            "--out", str(tmp_path)]
    _train(capsys, args + ["--steps", "2"])
    out = _train(capsys, args + ["--steps", "3", "--resume"])
    assert out["start_step"] == 2 and out["step"] == 3 and out["checkpoints"] == [2, 3]
    out = _train(capsys, args + ["--steps", "3", "--tasks", "test"])
    assert out["step"] == 3 and np.isfinite(out["test"]["test/opt_loss"])


@pytest.mark.parametrize("algorithm", ("frame_generator", "flow_completer"))
def test_train_animation(tmp_path, capsys, algorithm):
    """The animation experiment on the video dataset: 2 steps with a
    validation (FrameGenerator's rollout strip among its images) and a
    checkpoint, ``--resume`` to 3, ``--tasks test``."""
    args = ["--algorithm", algorithm, "--out", str(tmp_path)] + ANIM
    out = _train(capsys, args + ["--steps", "2"])
    assert out["experiment"] == "AnimationExperiment" and out["dataset"] == "artificial_video"
    assert out["step"] == 2 and out["checkpoints"] == [2]
    assert np.isfinite(out["train"]["train/loss"]) and np.isfinite(out["val"]["val/loss"])
    if algorithm == "frame_generator":
        assert "val/rollout" in out["images"] and out["sampling_timesteps"] == 2
        strip = (tmp_path / "images" / "val" / "rollout").glob("*.png")
        assert len(list(strip)) == 1
    else:
        assert out["images"] == ["frames", "predictions", "real_flows"]
    out = _train(capsys, args + ["--steps", "3", "--resume"])
    assert out["start_step"] == 2 and out["step"] == 3
    out = _train(capsys, args + ["--steps", "3", "--tasks", "test"])
    assert np.isfinite(out["test"]["test/loss"])


def test_animation_defaults():
    """The animation experiment's yaml: batch 64, validation 8 shuffled, no
    clipping, a validation every 400 steps; the video dataset at its 32."""
    exp = train_entry.build(10, algorithm="flow_completer", device="cpu", dataset_size=64,
                            out="unused")
    assert exp.cfg.batch_size == 64 and exp.cfg.val_batch_size == 8
    assert exp.cfg.clipping is None and exp.cfg.val_shuffle and exp.cfg.check_interval == 10
    assert exp.data_cfg.image_size == 32 and exp.data_cfg.val_length == 5
    assert exp.state.optimizer.clip is None


def test_sample_frame_generator_from_checkpoint(tmp_path, capsys):
    _train(capsys, ["--algorithm", "frame_generator", "--steps", "1", "--out", str(tmp_path)]
           + ANIM)
    sample_entry.main(["--algorithm", "frame_generator", "--device", "cpu", "--batch", "2",
                       "--sampling-timesteps", "2", "--image-size", "8", "--val-length", "2",
                       "--ckpt", str(tmp_path)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["ckpt"].endswith("checkpoints/1") and res["sampler"] == "ddim"
    assert res["rollout_shape"] == [2, 2, 3, 8, 8] and res["finite"]
    assert res["denoise_steps"] == 4 and res["rollout_mse_copy_baseline"] > 0


def test_waiting_for_raft_raises(tmp_path):
    """TaiChi reads (no frames under the root: the reader's error), and
    ``architecture: raft`` raises as JAX's branch cannot run."""
    with pytest.raises(FileNotFoundError, match="No TaiChi data"):
        train_entry.main(TINY + ["--algorithm", "frame_generator", "--dataset", "taichi",
                                 "--data-root", str(tmp_path / "none"),
                                 "--steps", "1", "--out", str(tmp_path)])
    from opticalflowdiffusion_tpu_torch.algorithms.matrix_flow import MatrixFlow
    from opticalflowdiffusion_tpu_torch.config import MATRIX_FLOW_ALGO

    with pytest.raises(NotImplementedError, match="None for the second frame"):
        MatrixFlow(MATRIX_FLOW_ALGO.__class__(architecture="raft"), device="cpu")


@pytest.mark.parametrize("stage", pf.STAGES)
def test_family_data_only_metrics_equal_jax(stage):
    """The metrics that depend on the data alone (MatrixFlow's optimal
    filter loss, FrameGenerator's copy baseline, FlowCompleter's zero-flow
    EPE split) at the harness's settings equal JAX's recorded ones to 1e-3
    relative, the bars' own tolerance."""
    key = pf.KEYS[stage]
    got = pf.data_only_metrics(stage)
    assert set(got) == {f"{p} {k}" for p, k in pf.DATA_ONLY[key]}
    for name, v in got.items():
        phase, metric = name.split(" ", 1)
        want = pf.jax_value(key, phase, metric)
        assert want == pf.jax_value(key, phase, metric, pick=min)   # both rounds agree
        assert abs(v - want) <= pf.INIT_RTOL * abs(want), (name, v, want)


def test_family_bars():
    """A result at JAX's worse round passes; 10% over it, or not below its
    baseline, misses."""
    key = "flow_completer"
    final = {k: pf.jax_value(key, "final", k) for k in
             ("val/loss", "epe_moving", "zero_flow_epe", "zero_flow_epe_moving", "moving_frac")}
    res = {"init": {}, "final": dict(final)}
    assert all(b["ok"] for b in pf.family_bars(key, res).values())
    res["final"]["epe_moving"] *= 1.11
    assert not pf.family_bars(key, res)["final epe_moving"]["ok"]
    res = {"init": {"rollout_mse_copy_baseline": 0.02587890625},
           "final": {"rollout_mse": 0.004, "rollout_mse_copy_baseline": 0.003}}
    assert not pf.family_bars("frame_generator", res)["final rollout_mse"]["ok"]


def test_run_families_tiny(tmp_path):
    """The stages at 8x8 (the PWC ones at their 64x64, the hunt's three
    runs 2 steps each), 2 steps, DDIM-2, one validation batch: the record
    of each with its init and final metrics, curve, speed, images and
    bars."""
    res = pf.run_families(out_dir=str(tmp_path), steps=2, device="cpu", image_size=8,
                          sampling_timesteps=2, val_batches=1, init_batches=1, log_every=2)
    saved = json.loads((tmp_path / "parity_families.json").read_text())
    for key in pf.KEYS.values():
        assert key in saved and set(saved["bars"][key]) == set(res["bars"][key])
        assert len(saved[key]["loss_curve"]) == 1 and saved[key]["visuals"]
    fg, fc = res["frame_generator"], res["flow_completer"]
    assert len(fg["final"]["rollout_mse_per_step"]) == 5 and np.isfinite(fg["final"]["rollout_mse"])
    assert {"epe_at_k1", "epe_at_k4", "epe_at_k9", "epe_moving"} <= set(fc["final"])
    assert np.isfinite(res["matrix_flow_filter_pred"]["init"]["val/opt_loss"])


def test_run_families_keeps_weights(tmp_path):
    """``keep_weights``: the trained FrameGenerator's weights, rounded to
    bfloat16, read back equal to the module's rounded weights, and the stage
    scored again on them with the final validation's generator state."""
    res = pf.run_families(out_dir=str(tmp_path), steps=1, stages=("framegen",), device="cpu",
                          image_size=8, sampling_timesteps=2, val_batches=1, init_batches=1,
                          log_every=1, keep_weights=True)
    fg = res["frame_generator"]
    assert set(fg["final_bf16_weights"]) == set(fg["final"])
    assert fg["final_bf16_weights"]["rollout_mse_copy_baseline"] == \
        fg["final"]["rollout_mse_copy_baseline"]
    assert np.isfinite(fg["final_bf16_weights"]["rollout_mse"])
    sd = pf.load_weights(tmp_path / "frame_generator.bf16.pt.xz")
    algo, _, _ = pf.stage_setup("framegen", "cpu", image_size=8)
    assert set(sd) == set(algo.module.state_dict())
    for k, v in sd.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, v.to(torch.bfloat16).float()), k


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ("matrix_flow", "frame_generator", "flow_completer"))
def test_family_train_step_kernels_vs_plain_on_card(cuda_device, model):
    """One train step of each model at chip_smoke.py's shape with every
    kernel against the same step with every plain version (its loss pin),
    and rows 1-5 on the step's own block inputs."""
    import chip_smoke as cs

    loss_rel, _ = cs.family_step_vs_plain(model)
    assert loss_rel <= cs.TOL_FAMILY[model][0]


if __name__ == "__main__":
    # One family parity stage under a numerics variant, on the card (JAX-free):
    #   python tests/test_torch_port_families_runner.py {base,notf32,bf16} STAGE STEPS SEED
    # notf32 turns cuDNN's TF32 off, bf16 computes the model in bfloat16; the
    # result and the loss curve print on one RESULT line.
    import dataclasses
    import sys

    variant, stage, steps, seed = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    if variant == "notf32":
        torch.backends.cudnn.allow_tf32 = False
    if variant == "bf16":
        setup = pf.stage_setup

        def bf16_setup(*a, **k):
            algo, train_loader, val_loader = setup(*a, **k)
            return (type(algo)(dataclasses.replace(algo.cfg, precision="bf16"),
                               device=algo.device), train_loader, val_loader)

        pf.stage_setup = bf16_setup
    res = pf.run_families(out_dir=f"outputs/families_{variant}_{stage}_{seed}", steps=steps,
                          stages=(stage,), seed=seed)
    key = pf.KEYS[stage]
    print("RESULT", variant, stage, seed,
          json.dumps({k: v for k, v in res[key]["final"].items() if not isinstance(v, list)}),
          json.dumps(res[key]["loss_curve"]))
