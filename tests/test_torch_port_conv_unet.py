"""Port vs JAX for the UNet under the opt-in conv backends: the port's
``Unet`` under ``fold`` and ``rows`` (defer-norm fusion and 1x1 matmuls on,
as JAX defaults them there) against the JAX ``Unet`` under
``OFD_CONV_BACKEND=fold|pallas`` with its Pallas conv kernels in interpret
mode, f32 and bf16, on bridged weights.  The UNet is small (width 8, two
levels, 16x16): every kind of block, and about half the convs of four
levels, since each interpret-mode Pallas call takes the JAX side a second
to trace and compile.  Each JAX model is traced inside its test, after the
environment is set."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opticalflowdiffusion_tpu.models.unet import Unet as JUnet
from opticalflowdiffusion_tpu.utils import import_torch_ckpt as itc
from opticalflowdiffusion_tpu_torch.models.unet import Unet, init_weights
from opticalflowdiffusion_tpu_torch.utils.weights import params_from_jax

# JAX's name for each port backend
JAX_BACKEND = {"rows": "pallas", "fold": "fold"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _jax_backend(monkeypatch, backend):
    """The JAX package's environment for ``backend``, with its Pallas
    kernels in interpret mode (set before anything is traced)."""
    monkeypatch.setenv("OFD_CONV_BACKEND", JAX_BACKEND[backend])
    with pltpu.force_tpu_interpret_mode():
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


DIM, MULTS, S, B = 8, (1, 2), 16, 2


def _bridged_unet(seed=0):
    net = init_weights(Unet(DIM, out_dim=2, channels=9, dim_mults=MULTS),
                       torch.Generator().manual_seed(seed))
    return itc.unet_params_from_torch({k: v.numpy() for k, v in net.state_dict().items()},
                                      dim_mults=MULTS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["rows", "fold"])
def test_unet_matches_jax_under_backend(monkeypatch, backend, dtype):
    """f32: sums in another order through the layers (rtol 1e-5, atol
    2e-5, as the cuDNN path's test).  bf16: the frameworks round at other
    places of each layer, a few bf16 ulps of the output scale (5% max, 1%
    mean)."""
    params = _bridged_unet()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, S, 6)).astype(np.float32)
    cond = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    with _jax_backend(monkeypatch, backend):
        jnet = JUnet(DIM, channels=9, out_dim=2, dim_mults=MULTS, dtype=jdt)
        want = np.asarray(jax.jit(lambda p, *a: jnet.apply({"params": p}, *a))(
            params, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t)))
    net = Unet(DIM, out_dim=2, channels=9, dim_mults=MULTS, dtype=getattr(torch, dtype),
               conv_backend=backend)
    net.load_state_dict(params_from_jax(params, dim_mults=MULTS), strict=True)
    with torch.no_grad():
        got = _nhwc(net.eval()(_nchw(x), _nchw(cond), torch.from_numpy(t).long()))
    scale = np.abs(want).max()
    assert scale > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * scale)
        assert np.mean(np.abs(got - want)) < 0.01 * scale
