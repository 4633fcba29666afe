"""Port vs JAX: the UNet's options (no time input, dim_mults (1, 2, 4),
self-conditioning, learned variance, the learned and random Fourier time
embeddings) and the weight bridge both ways for them, at width 8 on 16x16;
FlowPred's loss on JAX's draws and its val_step, on the port's Autoencoder
weights carried over to JAX's tree.  Float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.flow_pred import FlowPred as JFlowPred
from opticalflowdiffusion_tpu.config import Config
from opticalflowdiffusion_tpu.models.unet import Unet as JUnet
from opticalflowdiffusion_tpu.utils import import_torch_ckpt as itc
from opticalflowdiffusion_tpu_torch.algorithms.flow_pred import FlowPred
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP_DATA, FLOW_PRED
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset
from opticalflowdiffusion_tpu_torch.models.unet import Unet, init_weights
from opticalflowdiffusion_tpu_torch.utils.weights import (
    autoencoder_jax_layout, jax_layout, params_from_jax,
)

S, DIM, B = 16, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _np_batch(n):
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, seed=5, size=64))
    return tuple(np.stack(f) for f in zip(*[data[i] for i in range(n)]))


def _template(module, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)


# ----------------------------------------------------------------- the UNet
UNET_OPTIONS = {
    # the Autoencoder's UNets: no time input, three levels
    "no_time_three_levels": dict(time_in=False, dim_mults=(1, 2, 4), out_dim=3),
    # self-conditioning doubles the stem; learned variance doubles the output
    "self_cond_learned_variance_learned_sin": dict(self_condition=True, learned_variance=True,
                                                   learned_sinusoidal_cond=True),
    "random_fourier": dict(random_fourier_features=True, out_dim=2),
}


@pytest.mark.parametrize("name", list(UNET_OPTIONS))
def test_unet_options_match_jax(name):
    """The port's UNet with JAX's options: its parameter shapes are JAX's
    (the stem's input width and the output width included), the weight
    bridge carries a port draw to JAX and back leaf for leaf, and the
    outputs agree in f32 (rtol 1e-5, atol 2e-5, as the flagship UNet's)."""
    kw = UNET_OPTIONS[name]
    C = 5
    time_in = kw.get("time_in", True)
    net = init_weights(Unet(DIM, channels=C, **kw), torch.Generator().manual_seed(1))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    tree = itc.unet_params_from_torch(
        sd, dim_mults=kw.get("dim_mults", (1, 2, 4, 8)), time_in=time_in,
        learned_sinusoidal=kw.get("learned_sinusoidal_cond", False)
        or kw.get("random_fourier_features", False))
    jnet = JUnet(DIM, channels=C, **kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, S, C)).astype(np.float32)
    t = np.array([1, 3], np.int32) if time_in else None
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, None, t)["params"]
    want_shapes = dict((p, a.shape) for p, a in _leaves(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)))
    assert {p: a.shape for p, a in _leaves(tree)} == want_shapes
    assert net.init_conv.weight.shape[1] == (2 * C if kw.get("self_condition") else C)
    back = params_from_jax(tree)
    assert back.keys() == sd.keys()
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(
        _leaves(jax_layout(net.state_dict(), tree, prefix="")), _leaves(tree)))
    want = np.asarray(jax.jit(lambda p, x: jnet.apply({"params": p}, x, None, t))(tree, x))
    with torch.no_grad():
        got = net(_nchw(x), None, None if t is None else torch.from_numpy(t).long())
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=2e-5)
    if kw.get("self_condition"):
        sc = rng.standard_normal((B, S, S, C)).astype(np.float32)
        want = np.asarray(jax.jit(lambda p, x, s: jnet.apply({"params": p}, x, None, t, s))(
            tree, x, sc))
        with torch.no_grad():
            got = net(_nchw(x), None, torch.from_numpy(t).long(), _nchw(sc))
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=2e-5)
    if kw.get("random_fourier_features"):
        assert not net.time_mlp[0].weights.requires_grad
    with pytest.raises(ValueError):
        net(_nchw(x), None, None if time_in else torch.zeros(B, dtype=torch.long))


# --------------------------------------------------- FlowPred and the AE
def _jax_aug_params(rng, Bn):
    """The per-item augmentation parameters JAX ``augment`` draws from
    ``rng`` (as tests/test_torch_port_train.py)."""

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

    vals = jax.jit(jax.vmap(item))(jax.random.split(rng, Bn))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in vals.items()}


@pytest.fixture(scope="module")
def flow_pred_pair():
    """(JAX FlowPred, params, port FlowPred, numpy batch) on the port's
    weights carried over to JAX's Autoencoder tree."""
    jfp = JFlowPred(Config(dict(name="flow_pred", image_size=f"{S},{S}", lr=4e-5,
                                weight_decay=1e-6, latent_dim=4, ae_frac=0.5)))
    batch = _np_batch(4)
    fp = FlowPred(dataclasses.replace(FLOW_PRED, image_size=S, latent_dim=4, ae_frac=0.5,
                                      precision="float32"), device="cpu",
                  generator=torch.Generator().manual_seed(8))
    params = autoencoder_jax_layout(fp.module.ae.state_dict(),
                                    _template(jfp.ae, batch[0], batch[2]))
    return jfp, params, fp, batch


@pytest.mark.parametrize("seed", [0, 3])
def test_flow_pred_loss_and_val_step_match_jax(flow_pred_pair, seed):
    """FlowPred's loss on JAX's draws (augmentation, flow noise, the
    batch's identity coin: seeds 0 and 3 give both sides of the coin at
    ae_frac 0.5) and val_step's reconstruction MSE; f32, rtol 1e-5."""
    jfp, params, fp, batch = flow_pred_pair
    key = jax.random.PRNGKey(seed)
    want, _ = jax.jit(jfp.loss_fn)(params, batch, key)
    rng_aug, rng_noise, rng_frac = jax.random.split(key, 3)
    coin = bool(jax.random.bernoulli(rng_frac, 0.5))
    with torch.no_grad():
        got, _ = fp.loss_fn(tuple(_nchw(a) for a in batch), aug_params=_jax_aug_params(rng_aug, 4),
                            noise=_nchw(jax.random.normal(rng_noise, batch[2].shape)),
                            use_identity=coin)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    wm, wart = jax.jit(jfp.val_step)(params, batch, key)
    gm, gart = fp.val_step(tuple(_nchw(a) for a in batch))
    np.testing.assert_allclose(float(gm["val/loss"]), float(wm["val/loss"]), rtol=1e-5)
    np.testing.assert_allclose(_nhwc(gart["out"]), np.asarray(wart["out"]), rtol=1e-5,
                               atol=1e-5)


def test_flow_pred_coin_takes_both_sides():
    coins = [bool(jax.random.bernoulli(jax.random.split(jax.random.PRNGKey(s), 3)[2], 0.5))
             for s in (0, 3)]
    assert sorted(coins) == [False, True]
