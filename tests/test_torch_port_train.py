"""Port vs JAX for the training slice: augmentation, the diffusion loss and its
gradients on bridged weights, the optimizer, the loader and the gradient
statistics; and, on the port alone, that training lowers a fixed probe
loss, that a checkpoint restores a run bit for bit, the validation step and
the training entry point.  Tiny widths on the CPU; every input is made from
a seed with numpy and handed to both frameworks."""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms import augmentation as jaug
from opticalflowdiffusion_tpu.algorithms.flow_diffuser import FlowDiffuser as JFlowDiffuser
from opticalflowdiffusion_tpu.algorithms.flow_diffuser import UnetWithWarp as JUnetWithWarp
from opticalflowdiffusion_tpu.algorithms.flow_diffuser import make_warp_fn as jmake_warp_fn
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.data.artificial import ArtificialDataset as JArtificial
from opticalflowdiffusion_tpu.data.loader import DataLoader as JDataLoader
from opticalflowdiffusion_tpu.models import diffusion as jdm
from opticalflowdiffusion_tpu.parallel.train import make_optimizer as jmake_optimizer
from opticalflowdiffusion_tpu.utils import grad_stats as jgs
from opticalflowdiffusion_tpu.utils import import_torch_ckpt as itc
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.algorithms import augmentation as aug
from opticalflowdiffusion_tpu_torch.algorithms.base import to_batch
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser, make_warp_fn
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP, FLAGSHIP_DATA, MATRIX_FLOW
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset
from opticalflowdiffusion_tpu_torch.data.loader import DataLoader
from opticalflowdiffusion_tpu_torch.experiments.base import to_device
from opticalflowdiffusion_tpu_torch.experiments.matrix_flow import MatrixFlowExperiment
from opticalflowdiffusion_tpu_torch.models import diffusion as dm
from opticalflowdiffusion_tpu_torch.parallel.train import (
    TrainState, make_optimizer, make_train_step,
)
from opticalflowdiffusion_tpu_torch.utils import grad_stats
from opticalflowdiffusion_tpu_torch.utils.weights import jax_layout

S = 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return jnp.asarray(t.detach().permute(0, 2, 3, 1).numpy())


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


# ------------------------------------------------------------ augmentation
def _jax_params(rng, B):
    """The per-item parameters that JAX ``augment`` draws from ``rng``, by
    the key splits of ``_augment_item``."""

    def item(key):
        k = jax.random.split(key, 10)
        kb, kc, ks, kh = jax.random.split(k[1], 4)
        k1, k2, k3, k4 = jax.random.split(k[8], 4)
        u = lambda kk, lo=0.0, hi=1.0: jax.random.uniform(kk, minval=lo, maxval=hi)
        return dict(
            jitter=jax.random.bernoulli(k[0], 0.4), brightness=1.0 + u(kb, -0.1, 0.1),
            contrast=1.0 + u(kc, -0.1, 0.1), saturation=1.0 + u(ks, -0.1, 0.1),
            hue=u(kh, -0.1, 0.1), gray=jax.random.bernoulli(k[2], 0.1),
            blur=jax.random.bernoulli(k[3], 0.2), sigma=u(k[4]) * 0.5 + 1e-4,
            hflip=jax.random.bernoulli(k[5], 0.3), vflip=jax.random.bernoulli(k[6], 0.3),
            crop=jax.random.bernoulli(k[7], 0.15), crop_area=u(k1, 0.8, 1.0),
            crop_log_ratio=u(k2, jnp.log(0.9), jnp.log(1.1)), crop_top=u(k3),
            crop_left=u(k4))

    vals = jax.jit(jax.vmap(item))(jax.random.split(rng, B))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in vals.items()}


@pytest.mark.parametrize("seed", [3, 4])
def test_augment_apply_matches_jax(seed):
    """The port's ``apply`` given JAX's draws reproduces JAX ``augment``:
    f32, summation order only (the crop's contractions, the luma)."""
    B, H, W = 32, S, 20
    r = np.random.default_rng(seed)
    img, tgt = (r.random((B, H, W, 3)).astype(np.float32) for _ in range(2))
    flow = (r.standard_normal((B, H, W, 2)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax.jit(jaug.augment)(key, jnp.asarray(img), jnp.asarray(tgt), jnp.asarray(flow))
    prm = _jax_params(key, B)
    assert all(prm[k].sum() > 0 for k in ("jitter", "blur", "hflip", "vflip", "crop"))
    got = aug.apply(prm, _nchw(img), _nchw(tgt), _nchw(flow))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_augment_draw_is_seeded():
    a = aug.draw(64, torch.Generator().manual_seed(0))
    b = aug.draw(64, torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k, p in (("jitter", 0.4), ("hflip", 0.3), ("crop", 0.15)):
        assert set(a[k].tolist()) <= {0.0, 1.0}
    assert ((a["brightness"] >= 0.9) & (a["brightness"] <= 1.1)).all()
    assert ((a["crop_area"] >= 0.8) & (a["crop_area"] <= 1.0)).all()


# ------------------------------------------------------- loss and gradients
def _algo(precision="float32", timesteps=20, **kw):
    cfg = dataclasses.replace(FLAGSHIP, image_size=S, unet_dim=8, precision=precision,
                              timesteps=timesteps, **kw)
    return FlowDiffuser(cfg, device="cpu", generator=torch.Generator().manual_seed(6))


def _items(n, seed=5):
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, seed=seed, size=64))
    return [data[i] for i in range(n)]


def _bridged(algo):
    sd = {k[len("model."):]: v.numpy() for k, v in algo.module.state_dict().items()}
    tree = {"model": itc.unet_params_from_torch(sd)}
    jmod = JUnetWithWarp(flow_max=20.0, dim=3, channels=9, full_output=True, zero_init=False,
                         unet_dim=8)
    return tree, jmod


def test_pyramid_loss_matches_jax():
    rng = np.random.default_rng(8)
    cond = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    img_out = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    target[0, 3, 4] = np.nan
    flow = (rng.standard_normal((2, S, S, 2)) * 0.05).astype(np.float32)
    want = jax.jit(lambda *a: jdm.pyramid_loss(*a, jmake_warp_fn(20.0, 3)))(
        jnp.asarray(img_out), jnp.asarray(target), jnp.asarray(flow), jnp.asarray(cond),
        jnp.asarray(flow))
    got = dm.pyramid_loss(_nchw(img_out), _nchw(target), _nchw(flow), _nchw(cond),
                          _nchw(flow), make_warp_fn(20.0, 3))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_p_losses_and_gradients_match_jax():
    """The joint-target loss at fixed t and noise, and its gradient in every
    parameter, against ``jax.value_and_grad`` of JAX ``p_losses`` on bridged
    weights (f32; a random UNet whose flow moves the splats).  Tolerance:
    the loss to 1e-5; each leaf to 1e-4 of its largest value plus 1e-8 of
    the largest gradient anywhere.  The level**4 weights (up to 65536) make
    gradients of ~4e6, and where a gradient is zero in exact arithmetic (a
    conv bias right before a GroupNorm of one channel per group) both
    frameworks leave f32 rounding noise of ~1e-9 of that."""
    algo = _algo(zero_init=False)
    tgt_x, cond, _ = algo.preprocess(to_batch(_items(3), "cpu"))
    tree, jmod = _bridged(algo)
    jsched = jdm.make_schedule(timesteps=20, objective="pred_x0", min_snr_loss_weight=True)
    t = np.array([1, 7, 19])
    noise = np.random.default_rng(0).standard_normal(tuple(tgt_x.shape)).astype(np.float32)

    def jloss(params):
        fn = lambda x, c, tt, sc=None: jmod.apply({"params": params}, x, c, tt, sc)
        return jdm.p_losses(jsched, fn, jax.random.PRNGKey(0), _nhwc(tgt_x), jnp.asarray(t),
                            external_cond=_nhwc(cond), warp_fn=jmake_warp_fn(20.0, 3),
                            image_channels=3, noise=_nhwc(torch.from_numpy(noise)))

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(tree)
    loss = dm.p_losses(algo.sched, algo.model_fn, tgt_x, torch.from_numpy(t),
                       external_cond=cond, warp_fn=algo.warp_fn, noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in algo.module.named_parameters()}
    got = dict(_leaves(jax_layout(grads, tree["model"])))
    want_g = dict(_leaves(jgrads["model"]))
    assert got.keys() == want_g.keys()
    top = max(np.abs(w).max() for w in want_g.values())
    for name, w in want_g.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-8 * top, err_msg=name)


def test_weight_bridge_round_trip():
    algo = _algo()
    tree, _ = _bridged(algo)
    back = dict(_leaves(jax_layout(algo.module.state_dict(), tree["model"])))
    for name, w in _leaves(tree["model"]):
        np.testing.assert_array_equal(back[name], w, err_msg=name)


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("clip", [100.0, 0.5, None])
def test_optimizer_matches_optax(clip):
    """Two steps of clip -> L2 decay -> Adam from the same gradients.  optax
    forms Adam's bias corrections 1 - beta**t in float32 (1 - 0.999**2 keeps
    ~4 digits) and torch in double, so the updates differ by ~1e-5 of lr."""
    rng = np.random.default_rng(9)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    tx = jmake_optimizer(1e-2, 1e-3, clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.values(), 1e-2, 1e-3, clip)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-4 * 1e-2)


def test_train_step_microbatches_and_grad_stats():
    """``accumulate=2`` averages the gradients of the two halves of the
    batch (as JAX's scanned microbatches do) before one optimizer step, so
    with a mean loss it equals one step on the whole batch; and
    ``with_grad_stats`` adds the reference's gradient-norm keys."""
    torch.manual_seed(0)
    w = torch.randn(4, 3)
    x = torch.randn(6, 4)

    def run(accumulate, stats):
        lin = torch.nn.Linear(4, 3, bias=False)
        with torch.no_grad():
            lin.weight.copy_(w.t())
        state = TrainState(lin, make_optimizer(lin.parameters(), 1e-2, 0.0, None))
        loss_fn = lambda batch, gen: (lin(batch[0]).square().mean(), {})
        m = make_train_step(loss_fn, accumulate, stats)(state, (x,), None)
        return lin.weight.detach(), m

    w1, m1 = run(1, False)
    halves = [x[:3], x[3:]]
    grads = []
    for h in halves:
        lin = torch.nn.Linear(4, 3, bias=False)
        with torch.no_grad():
            lin.weight.copy_(w.t())
        lin(h).square().mean().backward()
        grads.append(lin.weight.grad)
    w2, m2 = run(2, True)
    lin = torch.nn.Linear(4, 3, bias=False)
    with torch.no_grad():
        lin.weight.copy_(w.t())
    lin.weight.grad = (grads[0] + grads[1]) / 2
    opt = make_optimizer(lin.parameters(), 1e-2, 0.0, None)
    opt.step()
    torch.testing.assert_close(w2, lin.weight.detach())
    torch.testing.assert_close(w1, w2)       # equal halves: the mean of their means
    assert set(m2) == {"train/loss"} | {f"train/{k}/{s}" for k in ("grad_norm", "gpr")
                                        for s in ("min", "max", "std", "mean", "median")}
    assert "train/grad_norm/max" not in m1


def test_grad_stats_match_jax():
    rng = np.random.default_rng(10)
    shapes = [(3, 4), (5,), (2, 2), (6,)]
    g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jgs.grad_norm_stats([jnp.asarray(a) for a in g], [jnp.asarray(a) for a in p])
    got = grad_stats.grad_norm_stats([torch.from_numpy(a) for a in g],
                                     [torch.from_numpy(a) for a in p])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    x = rng.standard_normal((4, 5, 6, 3)).astype(np.float32)
    want = jgs.tensor_stats("val/x", jnp.asarray(x))
    got = grad_stats.tensor_stats("val/x", _nchw(x))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_training_config_matches_jax_compose():
    """The port's training config holds the values that JAX composes for
    ``experiment=matrix_flow algorithm=flow_diffuser``."""
    cfg = compose(["experiment=matrix_flow", "algorithm=flow_diffuser", "dataset=artificial"])
    exp, tr, val = cfg.experiment, cfg.experiment.training, cfg.experiment.validation
    assert (FLAGSHIP.lr, FLAGSHIP.weight_decay) == (cfg.algorithm.lr, cfg.algorithm.weight_decay)
    assert MATRIX_FLOW.batch_size == tr.data.batch_size
    assert MATRIX_FLOW.clipping == tr.clipping
    assert MATRIX_FLOW.max_steps == tr.max_steps
    assert MATRIX_FLOW.accumulate_grad_batches == tr.optim.accumulate_grad_batches
    assert MATRIX_FLOW.every_n_train_steps == tr.checkpointing.every_n_train_steps
    assert MATRIX_FLOW.check_interval == val.check_interval
    assert MATRIX_FLOW.limit_batch == val.limit_batch
    assert MATRIX_FLOW.val_batch_size == val.data.batch_size
    assert (tr.data.shuffle, val.data.shuffle) == (True, False)
    assert MATRIX_FLOW.log_every == cfg.get("runtime", {}).get("log_every", 50)
    assert MATRIX_FLOW.seed == cfg.runtime.get("seed", 0)


def test_loader_matches_jax():
    cfg = compose(["experiment=matrix_flow", "algorithm=flow_diffuser", "dataset=artificial",
                   f"dataset.image_size={S}", "dataset.size=40", "+dataset.seed=2"])
    jl = JDataLoader(JArtificial(cfg.dataset), batch_size=8, shuffle=True, seed=3)
    pl = DataLoader(ArtificialDataset(dataclasses.replace(
        FLAGSHIP_DATA, image_size=S, size=40, seed=2)), batch_size=8, shuffle=True, seed=3)
    assert len(pl) == len(jl) == 5
    for _ in range(2):                               # two epochs: reshuffled alike
        for a, b in zip(pl, jl):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    pl.skip = 3
    assert len(list(pl)) == 2 and len(list(pl)) == 5


# ------------------------------------------------------------ the training run
def test_flow_diffuser_train_loss_decreases():
    """Port of tests/test_end_to_end.py::test_flow_diffuser_train_loss_decreases:
    the tiny config (16x16, T = 8, flow_max 2, batch 8, 64 items, clip 100)
    at lr 2e-4; a fixed probe (the mean loss over four fixed-seed draws of
    augmentation, t and noise on a fixed batch) must fall below 0.97x its
    start at the best of four epochs."""
    cfg = dataclasses.replace(FLAGSHIP, image_size=S, timesteps=8, flow_max=2.0,
                              precision="float32", lr=2e-4, unet_dim=16)
    algo = FlowDiffuser(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, size=64, seed=0))
    loader = DataLoader(data, batch_size=8, shuffle=True, seed=0)
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, 100.0))
    step = make_train_step(algo.loss_fn)
    eval_batch = to_device(next(iter(loader)), "cpu")

    def probe():
        with torch.no_grad():
            return sum(float(algo.loss_fn(eval_batch, torch.Generator().manual_seed(42 + i))[0])
                       for i in range(4)) / 4

    before = probe()
    gen = torch.Generator().manual_seed(1)
    losses, evals = [], []
    algo.module.train()
    for _ in range(4):
        for batch in loader:
            losses.append(float(step(state, to_device(batch, "cpu"), gen)["train/loss"]))
        evals.append(probe())
    assert state.step == 32
    assert np.isfinite(losses).all() and np.isfinite(evals).all()
    assert min(evals) < before * 0.97, (before, evals)


def _experiment(out, steps=3, **kw):
    algo = dataclasses.replace(FLAGSHIP, image_size=S, unet_dim=8, sampling_timesteps=2,
                               precision="float32")
    train = dataclasses.replace(MATRIX_FLOW, batch_size=4, max_steps=steps, check_interval=100,
                                every_n_train_steps=2, val_batch_size=2, log_every=1, **kw)
    data = dataclasses.replace(FLAGSHIP_DATA, image_size=S, size=32, seed=0)
    return MatrixFlowExperiment(algo, train, data, out, device="cpu")


def test_checkpoint_restores_bit_for_bit(tmp_path):
    """Save at step 2 (the cadence), restore into a fresh run: the step, the
    parameters, the optimizer state and the generator are the saved ones
    bit for bit, and the next step's loss equals the uninterrupted run's."""
    exp = _experiment(tmp_path, steps=2)
    exp.train()
    assert exp.ckpt.steps() == [2]
    saved_params = {k: v.clone() for k, v in exp.state.module.state_dict().items()}
    saved_opt = copy.deepcopy(exp.state.optimizer.state_dict()["state"])
    saved_gen = exp.generator.get_state().clone()
    uninterrupted = exp.train(3)["train/loss"]

    fresh = _experiment(tmp_path, steps=3)
    assert fresh.restore(2) == 2 and fresh.state.step == 2
    for k, v in fresh.state.module.state_dict().items():
        assert torch.equal(v, saved_params[k]), k
    opt = fresh.state.optimizer.state_dict()["state"]
    for i, s in saved_opt.items():
        for name, v in s.items():
            assert torch.equal(opt[i][name], v), (i, name)
    assert torch.equal(fresh.generator.get_state(), saved_gen)
    assert fresh.train()["train/loss"] == uninterrupted


# the metric keys of JAX ``FlowDiffuser.val_step`` for the joint target
VAL_KEYS = {"val/loss", "val/mse", "val/ideal_loss", "val/epe", "val/last_step",
            "val/last_step_epe"} | {f"val/{t}_{s}" for t in ("cond", "flow", "samples", "p_flow")
                                    for s in ("min", "max", "mean", "std")}


def test_val_step_metrics_and_grad_flow_probe():
    """The validation step gives JAX's metric keys, all finite; its t = 0
    probe equals JAX's model at t = 0 on bridged weights; and its
    ``grad_flow`` (the pyramid loss differentiated in the flow through the
    splats) equals ``jax.grad`` of JAX's probe at the same flow."""
    from opticalflowdiffusion_tpu.ops.warp import warp_forward_flow

    algo = _algo(zero_init=False, timesteps=8, sampling_timesteps=2)
    batch = to_batch(_items(2), "cpu")
    metrics, art = algo.val_step(batch, torch.Generator().manual_seed(0))
    assert metrics.keys() == VAL_KEYS
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert art["mid_samples"].shape == (2, 2, 3, S, S)     # x_T and the final state
    tree, jmod = _bridged(algo)
    cond, tgt_x, flow_n = (_nhwc(art[k]) for k in ("cond", "tgt_x", "flow_n"))
    last = jax.jit(jmod.apply)({"params": tree}, tgt_x, cond,
                               jnp.zeros((2,), jnp.int32))[..., -2:]
    flow = _nhwc(batch[2])
    np.testing.assert_allclose(float(metrics["val/last_step"]),
                               float(jnp.mean(jnp.square(last - flow_n))), rtol=1e-5)
    epe = jnp.mean(jnp.sqrt(jnp.sum(jnp.square(flow - last * 20.0), axis=-1) + 1e-12))
    np.testing.assert_allclose(float(metrics["val/last_step_epe"]), float(epe), rtol=1e-5)

    def jprobe(f):
        return jdm.pyramid_loss(warp_forward_flow(cond, f), tgt_x[..., :3], flow_n, cond,
                                f / 20.0, jmake_warp_fn(20.0, 3))

    want = np.asarray(-jax.jit(jax.grad(jprobe))(_nhwc(art["p_flows"])))
    got = art["grad_flow"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_sample_trajectory_matches_jax():
    """``sample(return_every=2)`` on DDIM-4 returns JAX's trajectory: the
    initial noise, every second state and the final one; each port model
    call fed JAX's state of that step (free running, the random UNet
    amplifies float rounding beyond the pin: ``test_torch_port_diffusion.py``)."""
    algo = _algo(zero_init=False, sampling_timesteps=4)
    jcfg = compose(["experiment=matrix_flow", "algorithm=flow_diffuser", "dataset=artificial",
                    f"algorithm.image_size={S}", "algorithm.timesteps=20",
                    "algorithm.sampling_timesteps=4", "+algorithm.unet_dim=8"])
    jalgo = JFlowDiffuser(jcfg.algorithm)
    tree, _ = _bridged(algo)
    _, cond, _ = algo.preprocess(to_batch(_items(2), "cpu"))
    key = jax.random.PRNGKey(7)
    want_img, want_flow = jalgo.sample(tree, _nhwc(cond), key, return_every=2)
    traj, _ = jdm.ddim_sample(jalgo.sched, jalgo._model_fn(tree), key, (2, S, S, 5),
                              external_cond=_nhwc(cond), return_every=1)
    traj = np.asarray(traj)
    _, init_key = jax.random.split(key)
    x_T = np.array(jax.random.normal(init_key, (2, S, S, 5), jnp.float32))
    np.testing.assert_array_equal(traj[:, 0], x_T)
    states = iter(_nchw(traj[:, k]) for k in range(traj.shape[1]))
    algo.model_fn = lambda x, c, t: algo.module(next(states), c, t)
    img, flow = algo.sample(cond, x_T=_nchw(x_T), return_every=2)
    assert img.shape == (2, 3, 3, S, S) and flow.shape == (2, 3, 2, S, S)
    for g, w in ((img, want_img), (flow, want_flow)):
        g, w = g.permute(0, 1, 3, 4, 2).numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-4, atol=2e-4)


def test_train_entry_point_on_cpu(tmp_path, capsys):
    """``train.py`` on the CPU: steps, one validation, a checkpoint, then
    ``--resume`` continues from it."""
    args = ["--device", "cpu", "--image-size", "16", "--unet-dim", "8", "--batch", "4",
            "--val-batch", "2", "--sampling-timesteps", "2", "--out", str(tmp_path)]
    train_entry.main(args + ["--steps", "2"])
    first = json.loads(capsys.readouterr().out)
    assert first["step"] == 2 and first["checkpoints"] == [2]
    assert np.isfinite(first["train"]["train/loss"]) and "val/epe" in first["val"]
    train_entry.main(args + ["--steps", "3", "--resume"])
    second = json.loads(capsys.readouterr().out)
    assert second["start_step"] == 2 and second["step"] == 3 and second["checkpoints"] == [2, 3]
    records = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "val/loss" in r] == [2, 3]
