"""Port vs JAX for FlowLearner (``algorithms/flow_learner.py``) at 16x16, b2,
levels (1, 2, 3, 5), float32, on weights carried over by
``utils/weights.py`` (the UNet at its fixed width 64), for the flow
representation (``flow_max`` 2, output conv not zeroed) and the filter one
(``radius`` 3): the loss and its gradients, ``val_step``'s metrics and
``grad_flow``, and one train step (clip 100, L2 decay, Adam) with the
augmentation off on both sides (its draws are the frameworks' own; the
augmentation is held to JAX in ``test_torch_port_train.py``).  Also the
config against JAX's ``compose``, the state_dict bridge both ways, and the
entry point on the CPU."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.flow_learner import FlowLearner as JFlowLearner
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.parallel.train import TrainState as TrainStateJ
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.algorithms.base import to_batch
from opticalflowdiffusion_tpu_torch.algorithms.flow_learner import FlowLearner
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP_DATA, FLOW_LEARNER
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset
from opticalflowdiffusion_tpu_torch.models.unet import init_weights
from opticalflowdiffusion_tpu_torch.parallel.train import (
    TrainState, make_optimizer, make_train_step,
)
from opticalflowdiffusion_tpu_torch.utils.weights import (
    flow_learner_jax_layout, flow_learner_state_dict,
)

S, B, LEVELS, LR = 16, 2, (1, 2, 3, 5), 2e-4
REPS = {"flow": dict(flow_max=2.0, zero_init=False), "filter": dict(flow_max=None, radius=3)}
JAX_OVERRIDES = {"flow": ["algorithm.flow_max=2", "algorithm.zero_init=false"],
                 "filter": ["~algorithm.flow_max", "+algorithm.radius=3"]}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _jax_cfg(rep):
    return compose(["experiment=matrix_flow", "dataset=artificial", "algorithm=flow_learner",
                    f"algorithm.image_size={S}", f"algorithm.lr={LR}",
                    "algorithm.train_aug=false", f"+algorithm.levels={list(LEVELS)}",
                    *JAX_OVERRIDES[rep]]).algorithm


def _port(rep):
    cfg = dataclasses.replace(FLOW_LEARNER, image_size=S, lr=LR, train_aug=False, levels=LEVELS,
                              precision="float32", **REPS[rep])
    return FlowLearner(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _random_params(jalgo, jbatch, seed=1):
    """JAX's parameter tree (shapes from ``eval_shape``, no compile) filled
    from numpy: kernels N(0, 1/fan_in), biases N(0, 0.02^2), scales and
    gains 1 + N(0, 0.02^2)."""
    img, tgt, _ = jbatch
    cond = jnp.concatenate([2.0 * img - 1.0, 2.0 * tgt - 1.0], axis=-1)
    shapes = jax.eval_shape(jalgo.module.init, jax.random.PRNGKey(0), cond)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name.endswith("kernel"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
        elif name.endswith("bias"):
            v = rng.standard_normal(leaf.shape) * 0.02
        else:
            v = 1.0 + rng.standard_normal(leaf.shape) * 0.02
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", params=tuple(REPS))
def case(request):
    """JAX's loss, gradients, val_step and one train step for one
    representation, computed once, and the port's algorithm on the same
    weights."""
    rep = request.param
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, seed=3, size=16))
    items = [data[i] for i in range(B)]
    jbatch = tuple(np.stack(f) for f in zip(*items))
    jalgo = JFlowLearner(_jax_cfg(rep))
    params = _random_params(jalgo, jbatch)
    state = TrainStateJ.create(params, jalgo.make_optimizer(100.0))
    rng = jax.random.PRNGKey(2)
    loss_fn = lambda p: jalgo.loss_fn(p, jbatch, rng)[0]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    metrics, arts = jax.jit(jalgo.val_step)(params, jbatch, rng)
    stepped = jax.jit(lambda st, g: st.apply_gradients(g))(state, grads).params
    algo = _port(rep)
    algo.module.load_state_dict(flow_learner_state_dict(params))
    return dict(rep=rep, items=items, params=params, loss=float(loss), grads=grads,
                metrics={k: float(v) for k, v in metrics.items()},
                arts={k: np.asarray(v) for k, v in arts.items()}, stepped=stepped, algo=algo)


def test_loss_and_gradients_match_jax(case):
    algo = case["algo"]
    algo.module.zero_grad(set_to_none=True)
    loss, _ = algo.loss_fn(to_batch(case["items"], "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), case["loss"], rtol=1e-5)
    grads = {k: p.grad for k, p in algo.module.named_parameters()}
    got = dict(_leaves(flow_learner_jax_layout(grads, case["params"])))
    want = dict(_leaves(case["grads"]))
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-8 * top, err_msg=name)
    algo.module.zero_grad(set_to_none=True)


def test_val_step_metrics_and_grad_flow_match_jax(case):
    """Every metric JAX's val_step gives (the filter statistics for the
    filter representation), the sample and the flow, and ``grad_flow``
    (the loss differentiated in the flow through the splat backward)."""
    metrics, arts = case["algo"].val_step(to_batch(case["items"], "cpu"))
    assert metrics.keys() == case["metrics"].keys()
    for k, want in case["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("samples", "p_flows", "warp_weights", "grad_flow"):
        want = case["arts"][k]
        np.testing.assert_allclose(_nhwc(arts[k]), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-6), err_msg=k)
    assert np.abs(case["arts"]["grad_flow"]).max() > 0


def test_train_step_matches_jax(case):
    """One step of the port's trainer (clip at 100, L2 decay 1e-6, Adam at
    lr 2e-4) against JAX's ``apply_gradients`` of its own gradients: the
    parameters after the step to 1e-5 of each leaf's largest value plus
    1e-4 lr (optax's float32 bias correction, ``test_optimizer_matches_optax``),
    plus what the two sides' gradient difference Dg (held to its pin in
    ``test_loss_and_gradients_match_jax``) moves Adam's first step,
    lr g / (|g| + 1e-8) of the clipped gradient plus the decay, g: at most
    lr min(2, 2 |Dg| / (|g| + 1e-8)).  Entries
    where that exceeds lr / 10 (gradients near rounding level, as the
    filter's colour weight under the no-colour term, zero in exact
    arithmetic) must stay under 1% of all entries."""
    algo = _port(case["rep"])
    algo.module.load_state_dict(flow_learner_state_dict(case["params"]))
    cfg = algo.cfg
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, 100.0))
    metrics = make_train_step(algo.loss_fn)(state, to_batch(case["items"], "cpu"), None)
    np.testing.assert_allclose(float(metrics["train/loss"]), case["loss"], rtol=1e-5)
    got = dict(_leaves(flow_learner_jax_layout(algo.module.state_dict(), case["params"])))
    before = dict(_leaves(case["params"]))
    grads = dict(_leaves(case["grads"]))
    norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum() for g in grads.values()))
    clip = min(1.0, 100.0 / norm)                   # both sides clip the same global norm
    port_grads = dict(_leaves(flow_learner_jax_layout(
        {k: p.grad for k, p in algo.module.named_parameters()}, case["params"])))
    moved = loose = total = 0
    for name, w in _leaves(case["stepped"]):
        g = np.abs(grads[name] * clip + cfg.weight_decay * before[name])
        adam = LR * np.minimum(2.0, 2 * np.abs(port_grads[name] - grads[name] * clip) / (g + 1e-8))
        loose, total = loose + int((adam > 0.1 * LR).sum()), total + g.size
        atol = adam + 1e-5 * np.abs(w).max() + 1e-4 * LR
        np.testing.assert_array_less(np.abs(got[name] - w), atol, err_msg=name)
        moved += int(not np.array_equal(w, before[name]))
    assert moved > 0 and loose < 0.01 * total


def test_state_dict_bridge_round_trip(case):
    back = dict(_leaves(flow_learner_jax_layout(
        flow_learner_state_dict(case["params"]), case["params"])))
    for name, w in _leaves(case["params"]):
        np.testing.assert_array_equal(back[name], w, err_msg=name)


def test_config_matches_jax_compose():
    cfg = compose(["experiment=matrix_flow", "algorithm=flow_learner", "dataset=artificial"])
    a = cfg.algorithm
    for field in ("image_size", "flow_max", "zero_init", "c2f", "lr", "weight_decay",
                  "sparsity_weight", "occlusion_mask", "train_aug"):
        assert getattr(FLOW_LEARNER, field) == a[field], field
    assert FLOW_LEARNER.radius is None and "radius" not in a
    assert FLOW_LEARNER.levels == JFlowLearner(a).levels
    with pytest.raises(ValueError, match="both flow_max and radius"):
        FlowLearner(dataclasses.replace(FLOW_LEARNER, radius=3), device="cpu")


def test_zero_init_outputs_zero_flow():
    """With flax's initial values (``init_weights``, as every entry point
    starts) a zero-initialised FlowUnet outputs zero flow and
    zero weight, as JAX's does."""
    cfg = dataclasses.replace(FLOW_LEARNER, image_size=8, levels=(1,), precision="float32")
    algo = FlowLearner(cfg, device="cpu")
    init_weights(algo.module, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = algo.module(torch.randn(1, 6, 8, 8))
    assert torch.equal(out, torch.zeros_like(out))


def test_train_entry_point_flow_learner(tmp_path, capsys):
    """``train.py --algorithm flow_learner`` on the CPU: 2 steps, a
    validation and a checkpoint, the flags parity needs."""
    train_entry.main(["--algorithm", "flow_learner", "--device", "cpu", "--image-size", "8",
                      "--levels", "1,2", "--steps", "2", "--batch", "2", "--val-batch", "2",
                      "--precision", "float32", "--lr", "2e-4", "--flow-max", "2",
                      "--dataset-size", "32", "--dataset-seed", "7", "--out", str(tmp_path)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["algorithm"] == "flow_learner" and res["step"] == 2
    assert res["checkpoints"] == [2] and np.isfinite(res["val"]["val/epe"])
    assert res["levels"] == [1, 2] and res["flow_max"] == 2.0 and res["precision"] == "float32"
