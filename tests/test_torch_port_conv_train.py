"""Port vs JAX for training under the ``fold`` conv backend: the
FlowDiffuser loss and its gradient in every parameter against
``jax.value_and_grad`` of JAX ``p_losses`` under ``OFD_CONV_BACKEND=fold``
(the Pallas fold kernel in interpret mode, forward and in the gradient), on
bridged weights.  The JAX model is traced inside the test, after the
environment is set."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opticalflowdiffusion_tpu.algorithms.flow_diffuser import UnetWithWarp as JUnetWithWarp
from opticalflowdiffusion_tpu.algorithms.flow_diffuser import make_warp_fn as jmake_warp_fn
from opticalflowdiffusion_tpu.models import diffusion as jdm
from opticalflowdiffusion_tpu.utils import import_torch_ckpt as itc
from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch.algorithms.base import to_batch
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP, FLAGSHIP_DATA
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset
from opticalflowdiffusion_tpu_torch.models import diffusion as dm
from opticalflowdiffusion_tpu_torch.utils.weights import jax_layout

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


DIM, S = 8, 16


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def test_p_losses_and_gradients_match_jax_under_fold(monkeypatch):
    """The joint-target loss at fixed t and noise, and its gradient in every
    parameter, under ``fold`` against ``jax.value_and_grad`` of JAX
    ``p_losses`` under ``OFD_CONV_BACKEND=fold`` (interpret mode), at the
    pins of ``test_p_losses_and_gradients_match_jax``: the loss to 1e-5,
    each leaf to 1e-4 of its largest value plus 1e-8 of the largest
    gradient anywhere (f32, a random UNet whose flow moves the splats)."""
    cfg = dataclasses.replace(FLAGSHIP, image_size=S, unet_dim=DIM, precision="float32",
                              timesteps=20, zero_init=False, conv_backend="fold")
    algo = FlowDiffuser(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, seed=5, size=64))
    tgt_x, cond, _ = algo.preprocess(to_batch([data[i] for i in range(3)], "cpu"))
    sd = {k[len("model."):]: v.numpy() for k, v in algo.module.state_dict().items()}
    tree = {"model": itc.unet_params_from_torch(sd)}
    t = np.array([1, 7, 19])
    noise = np.random.default_rng(0).standard_normal(tuple(tgt_x.shape)).astype(np.float32)
    nhwc = lambda a: jnp.asarray(a.detach().permute(0, 2, 3, 1).numpy())
    with _jax_backend(monkeypatch, "fold"):
        jmod = JUnetWithWarp(flow_max=20.0, dim=3, channels=9, full_output=True,
                             zero_init=False, unet_dim=DIM)
        jsched = jdm.make_schedule(timesteps=20, objective="pred_x0", min_snr_loss_weight=True)

        def jloss(params):
            fn = lambda x, c, tt, sc=None: jmod.apply({"params": params}, x, c, tt, sc)
            return jdm.p_losses(jsched, fn, jax.random.PRNGKey(0), nhwc(tgt_x), jnp.asarray(t),
                                external_cond=nhwc(cond), warp_fn=jmake_warp_fn(20.0, 3),
                                image_channels=3, noise=nhwc(torch.from_numpy(noise)))

        want, jgrads = jax.jit(jax.value_and_grad(jloss))(tree)
    before = [k.launches for k in kernels.KERNELS]
    loss = dm.p_losses(algo.sched, algo.model_fn, tgt_x, torch.from_numpy(t),
                       external_cond=cond, warp_fn=algo.warp_fn, noise=torch.from_numpy(noise))
    loss.backward()
    assert [k.launches for k in kernels.KERNELS] == before       # CPU: plain versions
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in algo.module.named_parameters()}
    got = dict(_leaves(jax_layout(grads, tree["model"])))
    want_g = dict(_leaves(jgrads["model"]))
    assert got.keys() == want_g.keys()
    top = max(np.abs(w).max() for w in want_g.values())
    for name, w in want_g.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-8 * top, err_msg=name)
