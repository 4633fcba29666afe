"""Port vs JAX for PWCLearner (``algorithms/pwc_learner.py``) at 64x64 b2,
float32, from JAX's initial weights carried across (``utils/weights.py``):
the loss and every gradient leaf against ``jax.value_and_grad`` of JAX's
``loss_fn``, the loss with JAX's smoothness and occlusion weights on a pair
batch (its first frame doubling as the past one), ``val_step``'s metrics
and artifacts, and one train step (clip at 100, Adam with L2 decay) against
JAX's ``apply_gradients``.  Values to 1e-5 relative, gradients to 1e-4 of
each leaf's largest value; Adam's first update is lr * g / (|g| + eps), so
the step is held on the entries whose gradient is not near 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.pwc_learner import PWCLearner as JPWCLearner
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu_torch.algorithms.pwc_learner import LEVEL_WEIGHTS, PWCLearner
from opticalflowdiffusion_tpu_torch.config import PWC_LEARNER
from opticalflowdiffusion_tpu_torch.parallel.train import (
    TrainState, make_optimizer, make_train_step,
)
from opticalflowdiffusion_tpu_torch.utils.weights import pwc_jax_layout, pwc_state_dict

S, B = 64, 2
RTOL, GTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_f32_products():
    with jax.default_matmul_precision("highest"):
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _batch(seed=0, frames=3):
    """Frames of a box moving 2 px a frame over a textured background, and
    its flow on the middle frame."""
    rng = np.random.default_rng(seed)
    bg = rng.random((B, S + 8, S + 8, 3)).astype(np.float32)
    out = [bg[:, 4 + k: 4 + k + S, 2 + k: 2 + k + S].copy() for k in range(frames)]
    flow = np.zeros((B, S, S, 2), np.float32)
    flow[..., 0] = 1.0
    flow[:, 20:40, 20:40] = (2.0, -1.0)
    return tuple(out) + (flow,)


def _learner(**fields):
    over = [f"+algorithm.{k}={v}" for k, v in fields.items()]
    jalgo = JPWCLearner(compose(["experiment=matrix_flow", "algorithm=pwc_learner",
                                 "dataset=artificial", *over]).algorithm)
    algo = PWCLearner(dataclasses.replace(PWC_LEARNER, precision="float32", **fields),
                      device="cpu")
    return jalgo, algo


@pytest.fixture(scope="module")
def pair():
    """(JAX learner, its state, port learner on its params, the batch, JAX's
    loss and gradients on it)."""
    jalgo, algo = _learner()
    batch = _batch()
    jb = tuple(map(jnp.asarray, batch))
    state = jalgo.init(jax.random.PRNGKey(0), jb, clip=100)
    algo.module.load_state_dict(pwc_state_dict(jax.device_get(state.params)))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jalgo.loss_fn(p, jb, jax.random.PRNGKey(1)), has_aux=True))(state.params)
    return jalgo, state, algo, batch, float(loss), grads


def test_loss_and_gradients_match_jax(pair):
    jalgo, state, algo, batch, want, jgrads = pair
    algo.module.zero_grad(set_to_none=True)
    loss, metrics = algo.loss_fn(tuple(map(_nchw, batch)))
    loss.backward()
    assert abs(loss.item() - want) <= RTOL * abs(want)
    assert {"train/flow_fwd_min", "train/flow_fwd_max", "train/flow_fwd_mean",
            "train/flow_fwd_std"} == set(metrics)
    got = pwc_jax_layout({n: p.grad for n, p in algo.module.named_parameters()},
                         jax.device_get(state.params))
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= GTOL * np.abs(w).max(), jax.tree_util.keystr(path)
    algo.module.zero_grad(set_to_none=True)


def test_weighted_loss_on_a_pair_batch_matches_jax(pair):
    """JAX's smoothness and occlusion knobs; a pair (img, tgt, flow) takes
    img as the past frame too."""
    _, state, _, batch, _, _ = pair
    jalgo, algo = _learner(smoothness_weight=0.1, occ_weight=0.01)
    algo.module.load_state_dict(pwc_state_dict(jax.device_get(state.params)))
    pair_batch = (batch[0], batch[2], batch[3])
    want = jax.jit(lambda p, b: jalgo.loss_fn(p, b, jax.random.PRNGKey(1))[0])(
        state.params, tuple(map(jnp.asarray, pair_batch)))
    with torch.no_grad():
        got = algo.loss_fn(tuple(map(_nchw, pair_batch)))[0]
    assert abs(float(got) - float(want)) <= RTOL * abs(float(want))
    assert LEVEL_WEIGHTS == (0.005, 0.01, 0.02, 0.08, 0.32)


def test_val_step_matches_jax(pair):
    jalgo, state, algo, batch, _, _ = pair
    wm, wa = jax.jit(lambda p, b: jalgo.val_step(p, b, jax.random.PRNGKey(2)))(
        state.params, tuple(map(jnp.asarray, batch)))
    gm, ga = algo.val_step(tuple(map(_nchw, batch)))
    assert set(gm) == set(wm) == {"val/loss", "val/epe"}
    for k in gm:
        assert abs(float(gm[k]) - float(wm[k])) <= RTOL * abs(float(wm[k])), k
    assert set(ga) == set(wa)
    for k in ga:
        w = np.asarray(wa[k])
        assert np.abs(_nhwc(ga[k]) - w).max() <= RTOL * np.abs(w).max(), k
    images = algo.visualize(tuple(map(_nchw, batch)), ga)
    want_images = jalgo.visualize(batch, jax.device_get(wa))
    assert set(images) == set(want_images)
    for k in images:
        assert images[k].shape == want_images[k].shape, k
        np.testing.assert_allclose(images[k], want_images[k], atol=1e-4, err_msg=k)


def test_one_clipped_adam_step_matches_jax(pair):
    """One step of the port's train step (clip 100, Adam, L2 decay 1e-6,
    lr 1e-4) against JAX's ``apply_gradients`` on JAX's gradients: the
    loss, and the update of every entry whose gradient is at least 1e-3 of
    its leaf's largest and 1e-4 (elsewhere within 2 lr: the update is
    lr * g / (|g| + 1e-8), which near 0 turns on the gradient's last bits)."""
    _, state, _, batch, jloss, jgrads = pair
    params = jax.device_get(state.params)
    new = jax.device_get(state.apply_gradients(jgrads).params)
    algo = PWCLearner(dataclasses.replace(PWC_LEARNER, precision="float32"), device="cpu")
    algo.module.load_state_dict(pwc_state_dict(params))
    ts = TrainState(algo.module, make_optimizer(algo.module.parameters(), PWC_LEARNER.lr,
                                                PWC_LEARNER.weight_decay, 100.0))
    algo.module.train()
    metrics = make_train_step(algo.loss_fn)(ts, tuple(map(_nchw, batch)), None)
    assert abs(float(metrics["train/loss"]) - jloss) <= RTOL * abs(jloss)
    got = pwc_jax_layout(dict(algo.module.named_parameters()), params)
    lr = PWC_LEARNER.lr
    n_firm = n_all = 0
    for (path, g), (_, w), (_, p0), (_, jg) in zip(*(jax.tree_util.tree_leaves_with_path(t)
                                                     for t in (got, new, params, jgrads))):
        jg, dg, dw = np.abs(np.asarray(jg)), g - np.asarray(p0), np.asarray(w) - np.asarray(p0)
        firm = (jg >= 1e-3 * jg.max()) & (jg >= 1e-4)
        name = jax.tree_util.keystr(path)
        if firm.any():
            assert np.abs(dg - dw)[firm].max() <= 1e-3 * lr, name
        assert np.abs(dg - dw).max() <= 2.0001 * lr, name
        n_firm, n_all = n_firm + firm.sum(), n_all + firm.size
    assert n_firm > 0.25 * n_all, (n_firm, n_all)   # 29% at this batch
