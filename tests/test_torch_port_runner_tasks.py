"""The runner's tasks and options on fixture trees of tens of pixels, on
the CPU, against the JAX runner's semantics (``experiments/base.py``):
``test`` (the mean of the validation metrics over the whole test split,
logged as ``test/*`` at the evaluated checkpoint's step), ``ckpt_path``,
``epochs``, the fractional ``check_interval``, the validation images
(``visualize``: FlowDiffuser's and FlowPred's against JAX's on the same
batch and artifacts), ``train.py``'s flags end to end, and the import of a
Lightning state_dict the test writes (against JAX's import) into
``sample.py --ckpt``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.flow_diffuser import FlowDiffuser as JFlowDiffuser
from opticalflowdiffusion_tpu.algorithms.flow_pred import FlowPred as JFlowPred
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.utils import import_torch_ckpt as jimport
from opticalflowdiffusion_tpu_torch import sample as sample_entry
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.data import fixtures
from opticalflowdiffusion_tpu_torch.data.png import imread
from opticalflowdiffusion_tpu_torch.experiments.base import resolve_checkpoint, to_device
from opticalflowdiffusion_tpu_torch.utils.import_torch_ckpt import (
    flow_diffuser_params_from_lightning, load_torch_state_dict,
)
from opticalflowdiffusion_tpu_torch.utils.logging import RunLogger
from opticalflowdiffusion_tpu_torch.utils.weights import flow_diffuser_state_dict

TINY = dict(unet_dim=8, batch=2, val_batch=1, sampling_timesteps=2, device="cpu",
            precision="float32", workers=2)
JAX_IMAGE_KEYS = {"original", "target", "diffusion_tgt", "gt_flow", "target_p", "concat",
                  "difference", "samples", "grad_flow", "last_step", "mid_samples",
                  "mid_flows"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The tiny models run op by op: a full-width thread pool per xdist
    worker only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A FlyingChairs tree: 12 pairs at 40x30, 9 for training, 3 for
    validation and test; a Sintel one."""
    r = tmp_path_factory.mktemp("data")
    fixtures.make_chairs_fixture(r, n=12, size=(40, 30))
    fixtures.make_sintel_fixture(r, scenes=1, frames=13, size=(40, 20))
    return r


def _exp(root, out, steps=2, **kw):
    args = dict(TINY, dataset="flying_chairs", data_root=str(root), image_size="24,16",
                out=str(out), seed=0)
    args.update(kw)
    return train_entry.build(steps, **args)


def _records(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_test_task_means_the_val_metrics_over_the_test_split(root, tmp_path):
    exp = _exp(root, tmp_path / "run", steps=2, ckpt_every=2)
    exp.train()
    fresh = _exp(root, tmp_path / "run")
    record = fresh.test()
    assert fresh.state.step == 2                               # the newest checkpoint
    loader = fresh.loader("test", 1, False)
    assert len(loader) == 3
    gen = torch.Generator().manual_seed(0)
    fresh.state.module.eval()
    per_batch = [fresh.algorithm.val_step(to_device(b, "cpu"), gen)[0] for b in loader]
    assert set(record) == {"step", "time"} | {k.replace("val/", "test/") for k in per_batch[0]}
    for k, v in per_batch[0].items():
        want = np.mean([float(m[k]) for m in per_batch])
        np.testing.assert_allclose(record[k.replace("val/", "test/")], want, rtol=1e-6, err_msg=k)
    assert _records(tmp_path / "run")[-1]["step"] == 2


def test_ckpt_path_forms_restore_the_run(root, tmp_path):
    a = _exp(root, tmp_path / "a", steps=2, ckpt_every=1)
    a.train()
    want = {k: v.clone() for k, v in a.state.module.state_dict().items()}
    for path, step in ((tmp_path / "a", 2), (tmp_path / "a" / "checkpoints", 2),
                       (tmp_path / "a" / "checkpoints" / "1", 1)):
        d, at = resolve_checkpoint(path)
        assert d == tmp_path / "a" / "checkpoints" and at == (1 if step == 1 else None)
        b = _exp(root, tmp_path / "b", steps=3, ckpt_path=str(path))
        assert b.restore() == step
        if step == 2:
            for k, v in b.state.module.state_dict().items():
                assert torch.equal(v, want[k]), k
    b.train()
    assert b.ckpt.steps() == [3] and not (tmp_path / "a" / "checkpoints" / "3").exists()


def test_epochs_and_fractional_check_interval(root, tmp_path):
    """9 training pairs at batch 2: 4 batches an epoch.  ``epochs`` 2 stops
    at step 8 under a budget of 20 (and checkpoints there); a
    ``check_interval`` of 0.5 validates every int(4 * 0.5) = 2 steps."""
    exp = _exp(root, tmp_path / "e", steps=20, epochs=2, check_interval=0.5, ckpt_every=100)
    assert len(exp.train_loader) == 4 and exp._check_interval() == 2
    exp.train()
    assert exp.state.step == 8 and exp.ckpt.steps() == [8]
    val_steps = [r["step"] for r in _records(tmp_path / "e") if "val/mse" in r]
    assert val_steps == [2, 4, 6, 8]


def test_validation_images_match_jax_visualize(root, tmp_path):
    """The images under ``images/<key>/step_*.png`` are JAX's keys, and
    FlowDiffuser's ``visualize`` equals JAX's on the same batch and
    artifacts."""
    exp = _exp(root, tmp_path / "v", steps=1)
    exp.train()
    assert set(exp.images) == JAX_IMAGE_KEYS
    for key, path in exp.images.items():
        assert path == tmp_path / "v" / "images" / key / "step_00000001.png"
        assert imread(path).ndim == 3
    batch = next(iter(exp.val_loader))
    metrics, arts = exp.algorithm.val_step(to_device(batch, "cpu"), torch.Generator())
    got = exp.algorithm.visualize(to_device(batch, "cpu"), arts)

    def nhwc(t):
        t = t.detach().float()
        return t.permute(*((0, 2, 3, 1) if t.dim() == 4 else (0, 1, 3, 4, 2))).numpy()

    jalgo = JFlowDiffuser(compose(["experiment=matrix_flow", "algorithm=flow_diffuser",
                                   "dataset=flying_chairs"]).algorithm)
    want = jalgo.visualize(batch, {k: nhwc(v) for k, v in arts.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_flow_pred_visualize_matches_jax(root, tmp_path):
    exp = _exp(root, tmp_path / "fp", steps=1, algorithm="flow_pred", latent_dim=4)
    batch = next(iter(exp.val_loader))
    _, arts = exp.algorithm.val_step(to_device(batch, "cpu"))
    got = exp.algorithm.visualize(to_device(batch, "cpu"), arts)
    jalgo = JFlowPred(compose(["experiment=matrix_flow", "algorithm=flow_pred",
                               "dataset=flying_chairs"]).algorithm)
    want = jalgo.visualize(batch, {"out": arts["out"].permute(0, 2, 3, 1).numpy()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_log_image_and_video_files(tmp_path):
    log = RunLogger(tmp_path)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (3, 5, 4, 3)).astype(np.float32)
    p = log.log_image("k", imgs, 7)
    assert p == tmp_path / "images" / "k" / "step_00000007.png"
    from opticalflowdiffusion_tpu_torch.utils import visualization as viz
    np.testing.assert_array_equal(imread(p), viz.to_uint8(viz.make_grid(imgs)))
    v = log.log_video("clip", imgs, 8)
    strip = np.concatenate(list(imgs), axis=1)
    np.testing.assert_array_equal(imread(v), viz.to_uint8(viz.make_grid(strip[None])))


def test_train_entry_point_tasks_on_sintel(root, tmp_path):
    """``train.py`` with --dataset sintel: train (a validation with images
    and checkpoints), --resume, then ``--tasks test``, which raises on
    Sintel as JAX's does (its reader takes training or validation only)."""
    common = ["--device", "cpu", "--unet-dim", "8", "--batch", "2", "--val-batch", "1",
              "--sampling-timesteps", "2", "--precision", "float32", "--dataset", "sintel",
              "--data-root", str(root), "--image-size", "24,16", "--workers", "2",
              "--out", str(tmp_path / "s")]
    train_entry.main(common + ["--steps", "2", "--ckpt-every", "1"])
    train_entry.main(common + ["--steps", "3", "--resume"])
    res = _records(tmp_path / "s")
    assert [r["step"] for r in res if "val/mse" in r] == [2, 3]
    with pytest.raises(AssertionError, match="training or validation"):
        train_entry.main(common + ["--tasks", "test"])


def _lightning(sd, alias=True):
    """A Lightning-style checkpoint of a reference FlowDiffuser: the UNet
    under ``unet.`` (and aliased under ``model.model.model.``), with
    other entries beside the state_dict."""
    lsd = {"unet." + k: v.clone() for k, v in sd.items()}
    if alias:
        lsd.update({"model.model.model." + k: v.clone() for k, v in sd.items()})
    return {"state_dict": lsd, "epoch": 3, "global_step": 1200,
            "hyper_parameters": {"target": "joint"}}


@pytest.mark.parametrize("target", ["joint", "flow"])
def test_lightning_import_matches_jax_and_loads_into_sample(tmp_path, target):
    algo, _ = sample_entry.build(seed=1, device="cpu", sampling_timesteps=2, image_size=16,
                                 unet_dim=8, target=target)
    sd = algo.module.state_dict()
    unet = {k[len("model."):]: v for k, v in sd.items()} if target == "joint" else sd
    path = tmp_path / "ref.ckpt"
    torch.save(_lightning(unet), path)
    got = flow_diffuser_params_from_lightning(load_torch_state_dict(path), target=target)
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    # JAX's import of the same state_dict, carried to the port's keys
    want = flow_diffuser_state_dict(jimport.flow_diffuser_params_from_lightning(
        {k: v.numpy() for k, v in _lightning(unet, alias=False)["state_dict"].items()},
        target=target))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k].numpy(), got[k].numpy(), err_msg=k)
    res = sample_entry.run(2, 5, "cpu", sampling_timesteps=2, image_size=16, unet_dim=8,
                           target=target, ckpt=str(path))
    assert res["ckpt"] == str(path) and res["samples_shape"][0] == 2


def test_sample_ckpt_from_a_run(root, tmp_path):
    exp = _exp(root, tmp_path / "r", steps=1)
    exp.train()
    res = sample_entry.run(1, 0, "cpu", sampling_timesteps=2, image_size=24, unet_dim=8,
                           height=16, width=24, ckpt=str(tmp_path / "r"))
    assert res["ckpt"] == str(tmp_path / "r" / "checkpoints" / "1")
    assert res["samples_shape"] == [1, 3, 16, 24] and res["finite_values_finite"]
    with pytest.raises(RuntimeError):                    # a UNet of another width
        sample_entry.run(1, 0, "cpu", sampling_timesteps=2, unet_dim=16,
                         ckpt=str(tmp_path / "r"))
