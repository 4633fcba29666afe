"""Port vs JAX for the animation family (``algorithms/animation.py``,
``data/artificial_video.py``) at 16x16, b2, float32, on narrow UNets
(``Unet(16, dim_mults=(1, 2))``, set on both sides) with JAX's weights
carried over: the constant-velocity video dataset bit for bit (both splits,
three seeds); FrameGenerator's loss and gradients on JAX's t and noise, its
DDIM and ancestral trajectories (each model call fed JAX's state of that
step), the rollout's shapes and conditioning hand-off; FlowCompleter's
sparse picks on JAX's Gumbel draws and counts, its loss and gradients,
JAX's zero-motion case, its float32 UNet under bf16; the density sweep's
picks on tied magnitudes (every pixel of a moving box has the same
|flow|).  Values to 1e-5 relative, gradients to 1e-4 of each leaf's largest
value, sampler trajectories to the diffusion tests' trajectory pin."""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from opticalflowdiffusion_tpu.algorithms.animation import FlowCompleter as JFlowCompleter
from opticalflowdiffusion_tpu.algorithms.animation import FrameGenerator as JFrameGenerator
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.data.artificial_video import (
    ArtificialVideoDataset as JArtificialVideoDataset,
)
from opticalflowdiffusion_tpu.models import diffusion as jdm
from opticalflowdiffusion_tpu.models.unet import Unet as JUnet
from opticalflowdiffusion_tpu_torch.algorithms.animation import (
    MAX_SPARSE, FlowCompleter, FrameGenerator,
)
from opticalflowdiffusion_tpu_torch.config import (
    ARTIFICIAL_VIDEO, FLOW_COMPLETER, FRAME_GENERATOR,
)
from opticalflowdiffusion_tpu_torch.data.artificial_video import ArtificialVideoDataset
from opticalflowdiffusion_tpu_torch.experiments.base import to_device
from opticalflowdiffusion_tpu_torch.models import diffusion as dm
from opticalflowdiffusion_tpu_torch.models.unet import Unet, init_weights
from opticalflowdiffusion_tpu_torch.training.parity_families import top_magnitude_mask
from opticalflowdiffusion_tpu_torch.utils.weights import (
    flow_completer_jax_layout, flow_completer_state_dict, jax_layout, params_from_jax,
)

S, B, T_VAL = 16, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_f32_products():
    """JAX's products in full float32, as the port's on the CPU: XLA's
    default precision may take a float32 dot in fewer bits on this host's
    CPU (a 3e-5 relative difference in some runs)."""
    with jax.default_matmul_precision("highest"):
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _jax_video_cfg(seed, **fields):
    over = [f"dataset.image_size={S}", "dataset.size=12", f"dataset.val_length={T_VAL}",
            "+dataset.max_motion=2"]
    if seed is not None:
        over.append(f"+dataset.seed={seed}")
    over += [f"dataset.{k}={v}" for k, v in fields.items()]
    return compose(["experiment=animation", "dataset=artificial_video",
                    "algorithm=frame_generator", *over]).dataset


def _video(seed=None, split="validation"):
    cfg = dataclasses.replace(ARTIFICIAL_VIDEO, image_size=S, size=12, val_length=T_VAL,
                              max_motion=2, seed=seed)
    return ArtificialVideoDataset(cfg, split=split)


def _batch(split="training", seed=3):
    data = _video(seed, split)
    return tuple(np.stack(f) for f in zip(*(data[i] for i in range(B))))


@pytest.mark.parametrize("seed", (None, 5, 11))
@pytest.mark.parametrize("split", ("training", "validation"))
def test_artificial_video_equals_jax(split, seed):
    want = JArtificialVideoDataset(_jax_video_cfg(seed), split=split)
    got = _video(seed, split)
    assert len(got) == len(want)
    moving = 0
    for i in range(len(want)):
        (w,), (g,) = want[i], got[i]
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        moving += int(np.abs(w[..., -2:]).max() > 0)
    assert moving > 0


def test_artificial_video_config_matches_jax_compose():
    cfg = compose(["experiment=animation", "dataset=artificial_video",
                   "algorithm=frame_generator"]).dataset
    for field in ("name", "image_size", "size", "val_length", "max_motion"):
        assert getattr(ARTIFICIAL_VIDEO, field) == cfg[field], field


def _random_params(shapes, seed=1):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name.endswith("kernel"):
            v = rng.standard_normal(leaf.shape) / np.sqrt(int(np.prod(leaf.shape[:-1])))
        elif name.endswith("bias"):
            v = rng.standard_normal(leaf.shape) * 0.02
        else:
            v = 1.0 + rng.standard_normal(leaf.shape) * 0.02
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _check_grads(got_tree, want_tree):
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    assert top > 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-8 * top, err_msg=name)


# -- FrameGenerator ---------------------------------------------------------------


@pytest.fixture(scope="module")
def framegen():
    """JAX's FrameGenerator and the port's on one narrow UNet (f32)."""
    jcfg = compose(["experiment=animation", "dataset=artificial_video",
                    "algorithm=frame_generator", f"algorithm.image_size={S}"]).algorithm
    jalgo = JFrameGenerator(jcfg)
    jalgo.module = JUnet(16, dim_mults=(1, 2), channels=8, out_dim=3)
    algo = FrameGenerator(dataclasses.replace(FRAME_GENERATOR, image_size=S, precision="float32"),
                          device="cpu")
    algo.module = Unet(16, dim_mults=(1, 2), channels=8, out_dim=3)
    x = _batch()[0]
    shapes = jax.eval_shape(jalgo.module.init, jax.random.PRNGKey(0), jnp.asarray(x[..., :3]),
                            jnp.asarray(x[..., 3:]), jnp.zeros((B,), jnp.int32))["params"]
    params = _random_params(shapes)
    algo.module.load_state_dict(params_from_jax(params))
    return jalgo, algo, params


def test_frame_generator_loss_and_gradients_match_jax(framegen):
    """The loss on JAX's draws: t from the first half of its key, the
    forward-process noise from p_losses' first split of the second."""
    jalgo, algo, params = framegen
    x = _batch()[0]
    rng = jax.random.PRNGKey(5)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jalgo.loss_fn(p, (jnp.asarray(x),), rng)[0]))(params)
    rng_t, rng_p = jax.random.split(rng)
    t = jax.random.randint(rng_t, (B,), 0, jalgo.sched.num_timesteps)
    noise = jax.random.normal(jax.random.split(rng_p, 3)[0], x[..., :3].shape, jnp.float32)
    xt = _nchw(x)
    algo.module.zero_grad(set_to_none=True)
    got = algo.loss(xt[:, :3], xt[:, 3:], torch.from_numpy(np.array(t)).long(),
                    _nchw(noise))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    _check_grads(jax_layout({k: p.grad for k, p in algo.module.named_parameters()}, params,
                            prefix=""), grads)
    algo.module.zero_grad(set_to_none=True)


def _jax_model_fn(jalgo, params):
    return jalgo._model_fn(params)


def test_frame_generator_ddim_steps_match_jax(framegen):
    """DDIM-5 of T = 20 (pred_noise, the sigmoid schedule): each of the
    port's steps (its model's noise, x0 clipped, the noise re-derived, eta
    0) taken from JAX's state of that step gives JAX's next state, to
    test_torch_port_diffusion.py's trajectory pin (rtol 1e-4, atol 2e-4;
    the first step divides the model's error by sqrt(alpha_bar) = 0.004).
    Then ``sample`` on the port's own schedule is that sampler's output
    mapped to [0, 1]."""
    jalgo, algo, params = framegen
    x = _batch()[0]
    shape = (B, S, S, 3)
    jsched = jdm.make_schedule(timesteps=20, sampling_timesteps=5, objective="pred_noise")
    want, _ = jdm.ddim_sample(jsched, _jax_model_fn(jalgo, params), jax.random.PRNGKey(13),
                              shape, external_cond=jnp.asarray(2 * x[..., 3:] - 1),
                              return_every=1)
    want = np.asarray(want)
    sched = dm.make_schedule(timesteps=20, sampling_timesteps=5, objective="pred_noise",
                             device="cpu")
    cond = 2 * _nchw(x[..., 3:]) - 1
    times = dm.linspace_int(-1, 19, 6)[::-1]
    ac = sched.alphas_cumprod
    with torch.no_grad():
        for k, (t, t_next) in enumerate(zip(times[:-1], times[1:])):
            bt = torch.full((B,), t, dtype=torch.long)
            noise, x0 = dm.model_predictions(sched, algo.model_fn, _nchw(want[:, k]), bt,
                                             clip_x_start=True, rederive_pred_noise=True,
                                             external_cond=cond)[:2]
            nxt = x0 if t_next < 0 else (x0 * torch.sqrt(ac[t_next])
                                         + torch.sqrt(1 - ac[t_next]) * noise)
            np.testing.assert_allclose(_nhwc(nxt), want[:, k + 1], rtol=1e-4, atol=2e-4,
                                       err_msg=f"step {k}")
        algo.sched = sched
        try:
            x_T = _nchw(want[:, 0])
            got = algo.sample(_nchw(x[..., 3:]), x_T=x_T)
            ref = dm.ddim_sample(sched, algo.model_fn, (B, 3, S, S), external_cond=cond,
                                 x_T=x_T, device="cpu")
        finally:
            algo.sched = dm.make_schedule(objective="pred_noise", device="cpu")
    assert torch.equal(got, (ref + 1) * 0.5)


def test_frame_generator_ancestral_matches_jax(framegen):
    """The ancestral loop at T = 4 from JAX's x_T and per-step noises, each
    port model call fed JAX's state of that step: the samples (x + 1) / 2
    after every step, to the trajectory pin."""
    jalgo, algo, params = framegen
    x = _batch()[0]
    shape = (B, S, S, 3)
    key = jax.random.PRNGKey(12)
    jsched = jdm.make_schedule(timesteps=4, objective="pred_noise")
    want, _ = jdm.p_sample_loop(jsched, _jax_model_fn(jalgo, params), key, shape,
                                external_cond=jnp.asarray(2 * x[..., 3:] - 1), return_every=1)
    want = np.asarray(want)
    rng, init_key = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(init_key, shape, jnp.float32))
    noises = []
    for _ in range(4):
        rng, nk = jax.random.split(rng)
        noises.append(_nchw(jax.random.normal(nk, shape, jnp.float32)))
    states = iter(_nchw(want[:, k]) for k in range(want.shape[1]))
    algo.sched = dm.make_schedule(timesteps=4, objective="pred_noise", device="cpu")
    try:
        algo.model_fn = lambda xx, c, t, sc=None: algo.module(next(states), c, t)
        with torch.no_grad():
            got = algo.sample(_nchw(x[..., 3:]), x_T=_nchw(x_T), noises=noises, return_every=1)
    finally:
        del algo.model_fn
        algo.sched = dm.make_schedule(objective="pred_noise", device="cpu")
    got = _nhwc(got)
    assert got.shape == want.shape == (B, 5, S, S, 3)
    np.testing.assert_allclose(got, (want + 1) * 0.5, rtol=1e-4, atol=2e-4)


def test_frame_generator_rollout_hands_off_conditioning(framegen):
    """The rollout over T transitions: step t's conditioning is [the
    previous sample, the flow of step t] (the given last frame at t = 0);
    the artifacts' shapes and keys are JAX's."""
    _, algo, _ = framegen
    x = to_device(_batch("validation"), "cpu")[0]
    assert x.shape == (B, T_VAL, 8, S, S)
    seen = []

    def fake_sample(cond, generator=None, **kw):
        seen.append(cond.clone())
        return torch.full((cond.shape[0], 3, S, S), float(len(seen)))

    algo.sample = fake_sample
    try:
        metrics, arts = algo.val_step((x,), torch.Generator().manual_seed(0))
    finally:
        del algo.sample
    assert set(arts) == {"samples", "targets", "last_frames", "flows", "rollout", "rollout_gt"}
    assert set(metrics) == {"val/loss"} and np.isfinite(float(metrics["val/loss"]))
    assert arts["rollout"].shape == (B, T_VAL, 3, S, S)
    assert torch.equal(arts["rollout_gt"], x[:, :, :3])
    rollout = seen[1:]                               # seen[0]: the single sample
    assert torch.equal(rollout[0], x[:, 0, 3:])
    for t in range(1, T_VAL):
        assert torch.equal(rollout[t][:, :3], torch.full_like(rollout[t][:, :3], t + 1))
        assert torch.equal(rollout[t][:, 3:], x[:, t, 6:])
    strip = algo.visualize((x,), arts)["val/rollout"]
    assert strip.shape == (B, 2 * S, T_VAL * S, 3)


def test_frame_generator_weights_round_trip(framegen):
    _, _, params = framegen
    back = dict(_leaves(jax_layout(params_from_jax(params), params, prefix="")))
    for name, w in _leaves(params):
        np.testing.assert_array_equal(back[name], w, err_msg=name)


# -- FlowCompleter ------------------------------------------------------------------


class _NarrowNet(nn.Module):
    """JAX's FlowCompleterNet on the narrow UNet."""

    @nn.compact
    def __call__(self, sparse_flow, frame):
        x = jnp.concatenate([sparse_flow, frame], axis=-1)
        return JUnet(16, dim_mults=(1, 2), channels=5, out_dim=2, time_in=False)(x, None, None)


@pytest.fixture(scope="module")
def completer():
    jcfg = compose(["experiment=animation", "dataset=artificial_video",
                    "algorithm=flow_completer", f"algorithm.image_size={S}"]).algorithm
    jalgo = JFlowCompleter(jcfg)
    jalgo.module = _NarrowNet()
    algo = FlowCompleter(dataclasses.replace(FLOW_COMPLETER, image_size=S), device="cpu")
    algo.module.net = Unet(16, dim_mults=(1, 2), channels=5, out_dim=2, time_in=False)
    x = _batch()[0]
    shapes = jax.eval_shape(jalgo.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((B, S, S, 2)), jnp.asarray(x[..., 3:6]))["params"]
    params = {"net": _random_params(shapes),
              "null_embedding": jnp.asarray([0.7, -0.3], jnp.float32)}
    algo.module.load_state_dict(flow_completer_state_dict(params))
    return jalgo, algo, params


def _jax_draws(rng, x):
    """JAX's Gumbel noise and counts of ``_sparse_from_dense``."""
    k1, k2 = jax.random.split(rng)
    gumbel = jax.random.gumbel(k1, (x.shape[0], S * S))
    counts = jax.random.randint(k2, (x.shape[0], 1), 1, MAX_SPARSE + 1)
    return torch.from_numpy(np.asarray(gumbel)), torch.from_numpy(np.asarray(counts)).long()


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_sparse_from_dense_matches_jax(completer, seed):
    """The picks on JAX's draws, equal; the magnitudes of a moving box tie
    (the Gumbel noise orders them)."""
    jalgo, algo, params = completer
    x = _batch(seed=seed)[0]
    rng = jax.random.PRNGKey(seed)
    want, want_mags = jalgo._sparse_from_dense(rng, jnp.asarray(x[..., -2:]), params)
    mask, mags = algo.sparse_mask(_nchw(x)[:, -2:], *_jax_draws(rng, x))
    np.testing.assert_array_equal(_nhwc(mask), np.asarray(want))
    np.testing.assert_allclose(mags.numpy(), np.asarray(want_mags), rtol=1e-6)
    assert 1 <= float(mask.sum()) <= B * MAX_SPARSE


def _completer_case(completer, x, seed=4):
    jalgo, algo, params = completer
    rng = jax.random.PRNGKey(seed)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jalgo.loss_fn(p, (jnp.asarray(x),), rng)[0]))(params)
    xt = _nchw(x)
    mask, mags = algo.sparse_mask(xt[:, -2:], *_jax_draws(rng, x))
    algo.module.zero_grad(set_to_none=True)
    got, _ = algo.loss(xt, mask, mags)
    got.backward()
    g = flow_completer_jax_layout({k: p.grad for k, p in algo.module.named_parameters()}, params)
    algo.module.zero_grad(set_to_none=True)
    return float(loss), grads, float(got.detach()), g


def test_flow_completer_loss_and_gradients_match_jax(completer):
    want, want_g, got, got_g = _completer_case(completer, _batch()[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_grads(got_g, want_g)
    assert np.abs(np.asarray(want_g["null_embedding"])).max() > 0


def test_flow_completer_zero_motion_matches_jax(completer):
    """A static sample in the batch (all-zero flow: the peak floored at
    1e-6, as JAX's test_flow_completer_zero_motion_sample_finite holds):
    finite, and equal to JAX."""
    x = _batch()[0].copy()
    x[0, ..., -2:] = 0.0
    want, want_g, got, got_g = _completer_case(completer, x, seed=6)
    assert np.isfinite(got) and all(np.isfinite(v).all() for _, v in _leaves(got_g))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_grads(got_g, want_g)


def test_flow_completer_weights_round_trip(completer):
    _, _, params = completer
    back = dict(_leaves(flow_completer_jax_layout(flow_completer_state_dict(params), params)))
    for name, w in _leaves(params):
        np.testing.assert_array_equal(back[name], w, err_msg=name)


def test_flow_completer_unet_is_float32_under_bf16():
    """JAX builds FlowCompleter's UNet without a dtype: under bf16 it
    computes in float32, the same values as the float32 config's; the
    null embedding starts at ones (flax's initial value too)."""
    x = _nchw(_batch()[0])
    out = {}
    for precision in ("bf16", "float32"):
        algo = FlowCompleter(dataclasses.replace(FLOW_COMPLETER, image_size=S,
                                                 precision=precision),
                             device="cpu", generator=torch.Generator().manual_seed(0))
        assert algo.module.net.dtype == torch.float32
        assert torch.equal(algo.module.null_embedding.detach(), torch.ones(2))
        with torch.no_grad():
            out[precision] = algo.complete(x, torch.zeros_like(x[:, :1]))
    assert out["bf16"].dtype == torch.float32
    assert torch.equal(out["bf16"], out["float32"])
    fg = FrameGenerator(dataclasses.replace(FRAME_GENERATOR, image_size=S), device="cpu")
    assert fg.module.dtype == torch.bfloat16
    init_weights(algo.module, torch.Generator().manual_seed(1))
    assert torch.equal(algo.module.null_embedding.detach(), torch.ones(2))


@pytest.mark.parametrize("k", (1, 4, 9))
def test_density_sweep_picks_match_jax_on_ties(k):
    """The sweep's top-k by |flow|: every pixel of a moving box ties, and
    XLA's top_k takes the lower index first, as the port's stable sort."""
    x = _batch("validation", seed=1)[0][:, 0]
    dense = jnp.asarray(x[..., -2:])
    mags = jnp.linalg.norm(dense, axis=-1).reshape(B, -1)
    _, picked = jax.lax.top_k(mags, MAX_SPARSE)
    keep = jnp.broadcast_to(jnp.asarray(np.arange(MAX_SPARSE) < k, jnp.float32), picked.shape)
    want = jax.vmap(lambda m, p, kk: m.at[p].max(kk))(jnp.zeros((B, S * S)), picked, keep)
    got = top_magnitude_mask(_nchw(x)[:, -2:], k)
    np.testing.assert_array_equal(got.reshape(B, -1).numpy(), np.asarray(want))
    tied = np.asarray(mags)[:, np.asarray(picked)[0]]
    assert (tied[0] == tied[0, 0]).all()             # the picks are ties


def _write_jax_init(path, seed=0):
    """JAX's FrameGenerator init for the framegen stage at ``seed``
    (``algo.init(PRNGKey(seed), first batch)``) as the port's state_dict."""
    from opticalflowdiffusion_tpu_torch.training import parity_families as pf

    _, train_loader, _ = pf.stage_setup("framegen", "cpu", seed=seed)
    jalgo = JFrameGenerator(compose([
        "experiment=animation", "dataset=artificial_video", "algorithm=frame_generator",
        "algorithm.image_size=32", "algorithm.lr=2e-4",
        "+algorithm.sampling_timesteps=50"]).algorithm)
    first = next(iter(train_loader))
    jstate = jalgo.init(jax.random.PRNGKey(seed), tuple(map(jnp.asarray, first)), clip=100)
    torch.save(params_from_jax(jax.device_get(jstate.params)), path)


def _lockstep(steps, score=False):
    """The framegen parity stage's first ``steps`` steps on the CPU, JAX and
    the port from JAX's initial weights (PRNGKey 0) on the same batches, the
    port's loss fed JAX's draws of t and the noise for each step; with
    ``score``, each trained model then scored as the stage scores it (its
    own sampler, generator seed 0)."""
    from opticalflowdiffusion_tpu.training import parity_families as jpf
    from opticalflowdiffusion_tpu_torch.parallel.train import TrainState, make_optimizer
    from opticalflowdiffusion_tpu_torch.training import parity_families as pf

    algo, train_loader, val_loader = pf.stage_setup("framegen", "cpu")
    jalgo = JFrameGenerator(compose([
        "experiment=animation", "dataset=artificial_video", "algorithm=frame_generator",
        "algorithm.image_size=32", "algorithm.lr=2e-4",
        "+algorithm.sampling_timesteps=50"]).algorithm)

    def epochs():                                   # the loader's epochs, one after another
        while True:
            yield from train_loader

    stream = epochs()
    first = next(stream)
    batches = itertools.chain([first], itertools.islice(stream, steps - 1))
    jstate = jalgo.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, first)), clip=100)
    algo.module.load_state_dict(params_from_jax(jax.device_get(jstate.params)))

    @jax.jit
    def jstep(st, b, key):
        loss, g = jax.value_and_grad(lambda p: jalgo.loss_fn(p, b, key)[0])(st.params)
        return st.apply_gradients(g), loss

    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), 2e-4, 2e-4, 100.0))
    algo.module.train()
    rng = jax.random.PRNGKey(0)
    for i, b in enumerate(batches):
        rng, sub = jax.random.split(rng)
        jstate, jloss = jstep(jstate, tuple(map(jnp.asarray, b)), sub)
        rng_t, rng_p = jax.random.split(sub)
        t = torch.from_numpy(np.array(jax.random.randint(rng_t, (len(b[0]),), 0, 1000))).long()
        noise = _nchw(jax.random.normal(jax.random.split(rng_p, 3)[0], b[0][..., :3].shape))
        x = _nchw(b[0])
        state.optimizer.zero_grad()
        loss = algo.loss(x[:, :3], x[:, 3:], t, noise)
        loss.backward()
        state.optimizer.step()
        if (i + 1) % 10 == 0:
            print(i + 1, float(jloss), float(loss), flush=True)
    if score:
        algo.module.eval()
        with torch.no_grad():
            m, arts, b0 = jpf._val_avg(jalgo, jstate, val_loader, jax.random.PRNGKey(0), 2)
            m.update(jpf._rollout_scores(arts, b0))
            print("JAX", json.dumps(m), flush=True)
            m, arts, b0 = pf._val_avg(algo, val_loader, torch.Generator().manual_seed(0), 2)
            m.update(pf._rollout_scores(arts, b0))
            print("port", json.dumps(m), flush=True)


def _rollout_on_weights(path, seeds):
    """The framegen parity stage's final scoring (``_val_avg`` over its 2
    validation batches, the rollout scored on the first) of one set of
    trained weights (``parity_families.py --save-weights``), by JAX's
    sampler and by the port's on the CPU, each at ``seeds`` seeds of its own
    generator; float32 products on both sides."""
    from opticalflowdiffusion_tpu.training import parity_families as jpf
    from opticalflowdiffusion_tpu_torch.training import parity_families as pf

    algo, train_loader, val_loader = pf.stage_setup("framegen", "cpu")
    algo.module.load_state_dict(pf.load_weights(path))
    jalgo = JFrameGenerator(compose([
        "experiment=animation", "dataset=artificial_video", "algorithm=frame_generator",
        "algorithm.image_size=32", "algorithm.lr=2e-4",
        "+algorithm.sampling_timesteps=50"]).algorithm)
    template = jalgo.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, next(iter(train_loader)))))
    params = jax.tree_util.tree_map(
        jnp.asarray, jax_layout(algo.module.state_dict(), template.params, prefix=""))
    state = type("State", (), {"params": params})
    with jax.default_matmul_precision("highest"), torch.no_grad():
        for seed in range(seeds):
            m, arts, b0 = jpf._val_avg(jalgo, state, val_loader, jax.random.PRNGKey(seed), 2)
            m.update(jpf._rollout_scores(arts, b0))
            print("JAX", seed, json.dumps(m), flush=True)
            m, arts, b0 = pf._val_avg(algo, val_loader, torch.Generator().manual_seed(seed), 2)
            m.update(pf._rollout_scores(arts, b0))
            print("port", seed, json.dumps(m), flush=True)


if __name__ == "__main__":
    #   python tests/test_torch_port_animation.py STEPS [--score]
    #   python tests/test_torch_port_animation.py --rollout WEIGHTS [SEEDS]
    #   python tests/test_torch_port_animation.py --jax-init OUT.pt [SEED]
    # (--jax-init: JAX's initial weights of the framegen parity stage, from
    # PRNGKey(SEED) as its init draws them, as the port's float32 state_dict,
    # for ``parity_families.py --init-weights``)
    import sys

    if sys.argv[1] == "--jax-init":
        _write_jax_init(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 0)
    elif sys.argv[1] == "--rollout":
        _rollout_on_weights(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 1)
    else:
        _lockstep(int(sys.argv[1]), "--score" in sys.argv[2:])
