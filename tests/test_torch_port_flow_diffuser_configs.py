"""Port vs JAX for FlowDiffuser's other configurations of
``flow_diffuser.yaml`` at a small size (16x16, UNet width 8, T = 4,
float32): the ``target`` and ``flow`` targets, flow noise, the
single-forward model, the flow-loss weight, and latent mode on the in-repo
AE checkpoint, each on one set of weights carried over by
``utils/weights.py`` (stem widths, preprocess, loss, sample, val_step
metrics).  JAX's random draws are handed to the port.  Where JAX runs
``permute_warp`` it runs under jit, as every caller does
(``test_torch_port_permute_warp.py``)."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.flow_diffuser import FlowDiffuser as JFlowDiffuser
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.models import diffusion as jdm
from opticalflowdiffusion_tpu.models.autoencoder import Autoencoder as JAutoencoder
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.config import (
    FLAGSHIP, FLAGSHIP_DATA, FLOW_PRED, FlowDiffuserConfig,
)
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset
from opticalflowdiffusion_tpu_torch.models.autoencoder import Autoencoder
from opticalflowdiffusion_tpu_torch.ops.warp import nan_mse
from opticalflowdiffusion_tpu_torch.utils.weights import (
    autoencoder_jax_layout, autoencoder_state_dict, flow_diffuser_state_dict, jax_layout,
)

S, DIM, B, T = 16, 8, 2, 4
ROOT = Path(__file__).resolve().parents[1]
AE_CKPT = ROOT / "parity" / "ae_pretrain" / "checkpoints"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    a = np.asarray(a)
    axes = (0, 3, 1, 2) if a.ndim == 4 else (0, 1, 4, 2, 3)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(axes)))


def _nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t.permute(0, 1, 3, 4, 2)).numpy()


def _close(got, want, rtol=1e-4, atol=2e-4, what=""):
    """NaN masks equal, finite values close (f32 through a few model calls
    whose flow, x20, drives the splat)."""
    got, want = _nhwc(got) if isinstance(got, torch.Tensor) else got, np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol, err_msg=what)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _items(n=B, seed=5, size=S):
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=size, seed=seed,
                                                 size=64))
    return [data[i] for i in range(n)]


def _np_batch(items):
    return tuple(np.stack(f) for f in zip(*items))


def _keys_ancestral(key, shape, nshape, steps):
    """x_T and the per-step noises of JAX's p_sample_loop: one split for x_T,
    one per step."""
    rng, init = jax.random.split(key)
    x_T = jax.random.normal(init, shape, jnp.float32)
    noises = []
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        noises.append(_nchw(jax.random.normal(k, nshape, jnp.float32)))
    return _nchw(x_T), noises


# ------------------------------------------------ FlowDiffuser configurations
COMMON = ["experiment=matrix_flow", "algorithm=flow_diffuser", "dataset=artificial",
          f"dataset.image_size={S}", f"algorithm.image_size={S}", "+dataset.seed=5",
          "+algorithm.unet_dim=8", "algorithm.zero_init=false", f"algorithm.timesteps={T}"]
# name: (JAX overrides, port fields, the stem's input width); DDIM-2 for
# image noise, the ancestral loop (T = 4) for flow noise
CONFIGS = {
    "target": (["algorithm.target=target"], dict(target="target"), 7),
    "flow": (["algorithm.target=flow"], dict(target="flow"), 5),
    "flownoise": (["algorithm.noiser=flow"], dict(noiser="flow"), 9),
    "single_joint": (["algorithm.is_diffusion=false", "algorithm.flow_weight=0.5"],
                     dict(is_diffusion=False, flow_weight=0.5), 4),
    "single_flow": (["algorithm.is_diffusion=false", "algorithm.target=flow"],
                    dict(is_diffusion=False, target="flow"), 3),
    "flowloss": (["+algorithm.diffusion_flow_weight=1.0"], dict(diffusion_flow_weight=1.0), 9),
}


def _template(module, *args):
    """The parameter shapes of a flax module traced on ``args``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)


def _pair(name, fields=None, jover=None, size=S, items=None):
    """(JAX algorithm, its params, port algorithm, numpy batch) on one set
    of weights: the port draws them (non-trivial biases and gains, output
    conv not zeroed) and utils/weights.py carries them to JAX's tree, whose
    shapes JAX's module gives (the Autoencoder's too, in latent mode).  The
    single-forward template is JAX's module traced on what its loss feeds
    it, the conditioning alone: JAX's ``init`` traces it on (state,
    conditioning) whatever ``is_diffusion``, so its single-forward params
    carry the diffusion stem (9 inputs for UnetWithWarp) that its own
    forward (4: the frame and the NaN channel) cannot apply."""
    jover0, fields0, _ = CONFIGS.get(name, ([], {}, None))
    fields = fields0 if fields is None else fields
    jover = jover0 if jover is None else jover
    image = fields.get("noiser") != "flow" and fields.get("is_diffusion", True)
    extra = ["algorithm.sampling_timesteps=2"] if image else []
    jalgo = JFlowDiffuser(compose(COMMON + jover + extra).algorithm)
    batch = _np_batch(items or _items(size=size))
    cfg = dataclasses.replace(FLAGSHIP, image_size=size, unet_dim=DIM, zero_init=False,
                              precision="float32", timesteps=T,
                              sampling_timesteps=2 if image else None, **fields)
    algo = FlowDiffuser(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    img, _, flow = batch
    if algo.latent:
        jalgo.ae_params = autoencoder_jax_layout(algo.ae.state_dict(),
                                                 _template(jalgo.ae, img, flow))
    cond = np.asarray(jalgo.preprocess(None, batch, aug=False)[1])
    state = np.zeros((B, size, size, algo.channels), np.float32)
    t = np.zeros((B,), np.int32)
    if not algo.is_diffusion:
        args = (cond, None, None) if algo._plain_unet else (cond,)
    else:
        args = (state, cond, t) if algo._plain_unet else (state, cond, t, None)
    tmpl = _template(jalgo.module, *args)
    sd = algo.module.state_dict()
    if algo._plain_unet:
        params = jax_layout(sd, tmpl, prefix="")
    else:
        params = {"model": jax_layout(sd, tmpl["model"], prefix="model.")}
    back = flow_diffuser_state_dict(params)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    return jalgo, params, algo, batch


def _torch_batch(batch):
    return tuple(_nchw(a) for a in batch)


def _stem(params):
    unet = params.get("model", params)
    return unet["Conv_0"]["kernel"].shape[2]


def _jax_loss_draws(jalgo, key, shape):
    """The t and noise that JAX's ``_diffusion_loss`` draws from ``key``."""
    rng_t, rng_p = jax.random.split(key)
    t = jax.random.randint(rng_t, (shape[0],), 0, jalgo.sched.num_timesteps)
    rng_noise, _, _ = jax.random.split(rng_p, 3)
    nshape = (shape[:-1] + (2,)) if jalgo.sched.noise_space == "flow" else shape
    return (torch.from_numpy(np.array(t)).long(),
            _nchw(jax.random.normal(rng_noise, nshape, jnp.float32)))


def _injected_sample(algo, jalgo, params, key):
    """The port's ``sample`` fed the draws of JAX's sampler under ``key``
    (x_T, and the ancestral loop's per-step noise), and each model call fed
    JAX's state of that step: free running, the random UNet's flow (x20
    before the splat) amplifies float rounding step by step
    (``test_dpmpp_trajectory``)."""
    sample, model_fn = algo.sample, algo.model_fn

    def fn(cond, generator=None, x_T=None, noises=None, return_every=None):
        if not algo.is_diffusion:
            return sample(cond, generator, return_every=return_every)
        Bn, _, H, W = cond.shape
        shape = (Bn, H, W, algo.channels)
        nshape = shape[:-1] + (2,) if jalgo.sched.noise_space == "flow" else shape
        x_T, noises = _keys_ancestral(key, shape, nshape, jalgo.sched.num_timesteps)
        extra = 2 if algo.target == "target" else 0
        traj = jdm.sample(jalgo.sched, jalgo._model_fn(params, additional_out=extra > 0), key,
                          shape, external_cond=jnp.asarray(_nhwc(cond)),
                          additional_channels=extra, return_every=1)[0]
        states = iter(_nchw(np.asarray(traj)[:, k]) for k in range(traj.shape[1]))
        algo.model_fn = lambda x, c, t, additional_out=False: model_fn(next(states), c, t,
                                                                       additional_out)
        try:
            return sample(cond, x_T=x_T, noises=noises, return_every=return_every)
        finally:
            del algo.model_fn

    return fn


def _val_step_vs_jax(jalgo, params, algo, batch, rng):
    """The port's val_step on the draws of JAX's (jitted) val_step: every
    metric (rtol 1e-4: a few model calls whose flow, x20, drives the
    splat), the samples and flows (trajectories at JAX's stride) and the
    grad_flow probe.  Returns JAX's (metrics, artifacts)."""
    jmetrics, jart = jax.jit(jalgo.val_step)(params, batch, rng)
    _, rng_loss, rng_s, _ = jax.random.split(rng, 4)
    if algo.is_diffusion:
        draws = _jax_loss_draws(jalgo, rng_loss, (B,) + batch[0].shape[1:3] + (algo.channels,))
        algo.draw_loss_inputs = lambda tgt_x, generator=None: draws
    algo.sample = _injected_sample(algo, jalgo, params, rng_s)
    try:
        metrics, art = algo.val_step(_torch_batch(batch))
    finally:
        del algo.sample
        algo.__dict__.pop("draw_loss_inputs", None)
    assert metrics.keys() == jmetrics.keys()
    nan_losses = not algo.is_diffusion and not algo._plain_unet
    for k, w in jmetrics.items():
        if nan_losses and k in ("val/loss", "val/ideal_loss"):
            continue
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in ("samples", "p_flows", "mid_samples", "mid_flows", "tgt_x", "cond"):
        _close(art[k], jart[k], what=k)
    if "grad_flow" in jart:
        g, w = _nhwc(art["grad_flow"]), np.asarray(jart["grad_flow"])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    if nan_losses:
        # JAX's plain mean is NaN (the splats have holes); the port's frame
        # term is the mean over the finite pairs of the same output
        assert np.isnan(float(jmetrics["val/loss"]))
        assert np.isnan(np.asarray(jart["samples"])).any() or np.isnan(jart["tgt_x"]).any()
        d = algo.dim
        frame = nan_mse(_nchw(jart["samples"]), _nchw(jart["tgt_x"][..., :d]))
        flow = jnp.mean(jnp.square(jart["p_flows"] / algo.flow_max - jart["flow_n"]))
        want = float(frame) + algo.cfg.flow_weight * float(flow)
        np.testing.assert_allclose(float(metrics["val/loss"]), want, rtol=1e-5)
        np.testing.assert_allclose(float(metrics["val/ideal_loss"]), want, rtol=1e-5)
    return jmetrics, jart


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_matches_jax(name):
    """Each configuration on one set of weights: the module's shapes are
    JAX's (the stem's input width derived from what forward concatenates:
    4 for the single-forward UnetWithWarp, where JAX's formula says 3),
    preprocess to 1e-5, and ``val_step`` on JAX's draws
    (``_val_step_vs_jax``): the loss on JAX's t and noise, the ideal loss,
    the samples of DDIM-2, of the ancestral loop of T = 4 under flow noise
    or of the one forward, the EPE, the t = 0 probe and grad_flow."""
    jalgo, params, algo, batch = _pair(name)
    want_stem = CONFIGS[name][2]
    unet = algo.module if algo._plain_unet else algo.module.model
    assert _stem(params) == unet.init_conv.weight.shape[1] == want_stem
    want = jalgo.preprocess(jax.random.PRNGKey(1), batch, aug=False)
    got = algo.preprocess(_torch_batch(batch))
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-5)
    _val_step_vs_jax(jalgo, params, algo, batch, jax.random.PRNGKey(5))


def test_config_fields_and_flow_pred_config_match_jax_compose():
    """The new fields' defaults are flow_diffuser.yaml's (and the JAX
    FlowDiffuser's ``cfg.get`` defaults); FlowPredConfig is flow_pred.yaml."""
    algo = compose(["experiment=matrix_flow", "algorithm=flow_diffuser",
                    "dataset=artificial"]).algorithm
    assert FLAGSHIP.flow_weight == algo.flow_weight
    assert FLAGSHIP.ae == algo.ae
    assert FLAGSHIP.diffusion_flow_weight == algo.get("diffusion_flow_weight", 0.0)
    assert FlowDiffuserConfig() == FLAGSHIP
    fp = compose(["experiment=matrix_flow", "algorithm=flow_pred",
                  "dataset=artificial"]).algorithm
    w, h = (int(v) for v in str(fp.image_size).split(","))
    assert FLOW_PRED.image_size == w == h
    for field in ("lr", "weight_decay", "latent_dim", "ae_frac"):
        assert getattr(FLOW_PRED, field) == fp[field], field


def test_ae_checkpoint_carried_over_matches_jax():
    """The in-repo AE checkpoint (orbax, read by JAX here) carried over
    through utils/weights.py, and back: encode, decode and the Autoencoder
    forward agree with JAX's (f32, 1e-5 after the width-64 UNets); the
    latent joint FlowDiffuser on it (latent_dim 16) matches JAX's as the
    other configurations do (``test_config_matches_jax``)."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(AE_CKPT.absolute())
    try:
        tree = mgr.restore(mgr.latest_step(), args=ocp.args.StandardRestore())
    finally:
        mgr.close()
    ae_params = tree["params"]["ae"]
    enc = ae_params["model_enc"]
    latent_dim = enc[max((k for k in enc if k.startswith("Conv_")), key=lambda k: int(k[5:]))]["kernel"].shape[-1]
    ae = Autoencoder(latent_dim).eval()
    ae.load_state_dict(autoencoder_state_dict(ae_params), strict=True)
    jae = JAutoencoder(latent_dim=latent_dim)
    img, _, flow = _np_batch(_items())
    def jax_ae(p, img, flow):
        lat = jae.apply({"params": p}, img, method=JAutoencoder.encode)
        dec = jae.apply({"params": p}, lat, img, method=JAutoencoder.decode)
        return lat, dec, jae.apply({"params": p}, img, flow)

    want_lat, want_dec, want_rec = jax.jit(jax_ae)(ae_params, img, flow)
    with torch.no_grad():
        _close(ae.encode(_nchw(img)), want_lat, 1e-5, 1e-5, "encode")
        _close(ae.decode(_nchw(want_lat), _nchw(img)), want_dec, 1e-5, 1e-5, "decode")
        _close(ae(_nchw(img), _nchw(flow)), want_rec, 1e-5, 1e-5, "forward")
    back = autoencoder_jax_layout(ae.state_dict(), ae_params)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(_leaves(back),
                                                              _leaves(ae_params)))
    # the latent joint FlowDiffuser on this AE (as cfg.ae loads it): its
    # stem (state 18, NaN channel, conditioning 16), preprocess (the encoded
    # frame) and val_step on JAX's draws
    fields = dict(latent=True, latent_dim=latent_dim)
    jalgo, params, algo, batch = _pair(
        "latent", fields, ["algorithm.latent=true", f"algorithm.latent_dim={latent_dim}"])
    jalgo.ae_params = ae_params
    algo.ae.load_state_dict(autoencoder_state_dict(ae_params), strict=True)
    assert _stem(params) == algo.module.model.init_conv.weight.shape[1] == 2 * latent_dim + 3
    for g, w in zip(algo.preprocess(_torch_batch(batch)),
                    jalgo.preprocess(None, batch, aug=False)):
        _close(g, w, 1e-5, 1e-5)
    _val_step_vs_jax(jalgo, params, algo, batch, jax.random.PRNGKey(9))
