"""Port vs JAX: the weight bridge, the UNet forward on bridged weights and
``UnetWithWarp`` (unet_dim 8 at 16x16, so the test stays small)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.flow_diffuser import UnetWithWarp as JUnetWithWarp
from opticalflowdiffusion_tpu.models.unet import Unet as JUnet
from opticalflowdiffusion_tpu.utils import import_torch_ckpt as itc
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import UnetWithWarp
from opticalflowdiffusion_tpu_torch.models.unet import Unet, init_weights
from opticalflowdiffusion_tpu_torch.utils.weights import (
    flow_diffuser_state_dict, params_from_jax,
)

DIM, S, B = 8, 16, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_params(seed=0):
    """(flax tree, state_dict) of one seeded UNet (width DIM, 9 input
    channels).  The port draws the weights, with non-trivial biases, gains
    and output conv; the JAX package's own importer makes the flax tree."""
    net = init_weights(Unet(DIM, out_dim=2, channels=9),
                       torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    return itc.unet_params_from_torch(sd), sd


@pytest.fixture(scope="module")
def params():
    return port_params()[0]


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, S, 6)).astype(np.float32)
    cond = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    return x, cond, t


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def test_bridge_inverts_import_tables():
    """params_from_jax undoes the JAX package's importer exactly, and the
    tree it reads has the paths and shapes of a flax-initialised UNet."""
    tree, sd = port_params()
    back = params_from_jax(tree)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    shapes = jax.eval_shape(
        JUnet(DIM, channels=9, out_dim=2).init, jax.random.PRNGKey(0),
        jnp.zeros((1, S, S, 6)), jnp.zeros((1, S, S, 3)), jnp.zeros((1,), jnp.int32),
    )["params"]
    want = {p: l.shape for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {p: np.shape(l) for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want


def _port_unet(params, dtype):
    net = Unet(DIM, out_dim=2, channels=9, dtype=dtype)
    net.load_state_dict(params_from_jax(params), strict=True)
    return net.eval()


def test_unet_forward_f32(params):
    x, cond, t = _inputs()
    want = np.asarray(jax.jit(JUnet(DIM, channels=9, out_dim=2).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t)))
    with torch.no_grad():
        got = _port_unet(params, torch.float32)(_nchw(x), _nchw(cond), torch.from_numpy(t).long())
    # f32 through ~60 layers; conv and norm sums run in another order
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=2e-5)
    assert np.abs(want).max() > 0.1


def test_unet_forward_bf16(params):
    x, cond, t = _inputs()
    want = np.asarray(jax.jit(JUnet(DIM, channels=9, out_dim=2, dtype=jnp.bfloat16).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t)))
    with torch.no_grad():
        got = _nhwc(_port_unet(params, torch.bfloat16)(
            _nchw(x), _nchw(cond), torch.from_numpy(t).long()))
    # bf16 activations: the two frameworks round at different points of each
    # layer (bias adds, fused GELU/SiLU), so the outputs differ by a few bf16
    # ulps of the output scale
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * scale)
    assert np.mean(np.abs(got - want)) < 0.01 * scale


def test_unet_with_warp_f32(params):
    x, cond, t = _inputs(2)
    x5 = x[..., :5].copy()
    x5[0, 3, 4, :] = np.nan                      # NaN holes in the state
    x5[1, :2, :, 0] = np.nan
    jmod = JUnetWithWarp(flow_max=20.0, dim=3, channels=9, full_output=True,
                         zero_init=False, unet_dim=DIM)
    want = np.asarray(jax.jit(jmod.apply)({"params": {"model": params}}, jnp.asarray(x5),
                                 jnp.asarray(cond), jnp.asarray(t), None))
    mod = UnetWithWarp(flow_max=20.0, dim=3, channels=9, full_output=True,
                       zero_init=False, unet_dim=DIM)
    mod.load_state_dict(flow_diffuser_state_dict({"model": params}), strict=True)
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x5), _nchw(cond), torch.from_numpy(t).long()))
    assert got.shape == want.shape == (B, S, S, 5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() and np.isfinite(want).any()
    ok = np.isfinite(want)
    # the flow is scaled by flow_max = 20 before the splat, so a 1e-6 flow
    # difference moves a target by 2e-5 px
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=2e-4)
