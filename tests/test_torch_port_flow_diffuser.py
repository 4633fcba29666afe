"""Port vs JAX for the slice as a whole: the artificial dataset, the batch
adapter, ``FlowDiffuser.preprocess`` and ``FlowDiffuser.sample`` (DDIM, on
bridged weights, with JAX's initial noise); and the serving entry point and
the profile script's helpers on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.flow_diffuser import FlowDiffuser as JFlowDiffuser
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.data.artificial import ArtificialDataset as JArtificial
from opticalflowdiffusion_tpu.models import diffusion as jdm
from opticalflowdiffusion_tpu.utils import import_torch_ckpt as itc
from opticalflowdiffusion_tpu_torch import profile_step
from opticalflowdiffusion_tpu_torch import sample as sample_entry
from opticalflowdiffusion_tpu_torch.algorithms.base import pair_batch, to_batch
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP, FLAGSHIP_DATA
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset

S = 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_cfg(*extra):
    return compose(["experiment=matrix_flow", "algorithm=flow_diffuser",
                    "dataset=artificial", f"dataset.image_size={S}",
                    f"algorithm.image_size={S}", "+dataset.seed=5", *extra])


def _items(n=3):
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, seed=5, size=64))
    return [data[i] for i in range(n)]


def test_artificial_dataset_matches_jax():
    cfg = _jax_cfg("dataset.size=64")
    jdata = JArtificial(cfg.dataset)
    for i, item in enumerate(_items(8)):
        for got, want in zip(item, jdata[i]):
            np.testing.assert_array_equal(got, want)


def test_pair_batch_and_to_batch():
    items = _items(2)
    img, tgt, flow = to_batch(items, "cpu")
    assert img.shape == (2, 3, S, S) and flow.shape == (2, 2, S, S)
    np.testing.assert_array_equal(flow[1].permute(1, 2, 0).numpy(), items[1][2])
    assert pair_batch((0, img, tgt, flow))[0] is img
    assert pair_batch((img, tgt, flow))[2] is flow


def _pair(sampling_timesteps=None, sampler="auto"):
    cfg = dataclasses.replace(FLAGSHIP, image_size=S, unet_dim=8, zero_init=False,
                              precision="float32", sampling_timesteps=sampling_timesteps,
                              sampler=sampler)
    algo = FlowDiffuser(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    extra = ["+algorithm.unet_dim=8"]
    if sampling_timesteps:
        extra.append(f"algorithm.sampling_timesteps={sampling_timesteps}")
    if sampler != "auto":
        extra.append(f"+algorithm.sampler={sampler}")
    jalgo = JFlowDiffuser(_jax_cfg(*extra).algorithm)
    sd = {k[len("model."):]: v.numpy() for k, v in algo.module.state_dict().items()}
    params = {"model": itc.unet_params_from_torch(sd)}
    return algo, jalgo, params


def test_preprocess_matches_jax():
    algo, jalgo, _ = _pair()
    items = _items(3)
    batch = tuple(np.stack(f) for f in zip(*items))
    want = jalgo.preprocess(jax.random.PRNGKey(0), batch, aug=False)
    got = algo.preprocess(to_batch(items, "cpu"))
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=1e-6, atol=1e-6)


def test_flow_diffuser_sample_ddim_matches_jax():
    algo, jalgo, params = _pair(sampling_timesteps=4)
    items = _items(2)
    _, cond, _ = algo.preprocess(to_batch(items, "cpu"))
    jcond = jnp.asarray(cond.permute(0, 2, 3, 1).numpy())
    key = jax.random.PRNGKey(7)
    want_img, want_flow = jalgo.sample(params, jcond, key, return_every=None)
    _, init_key = jax.random.split(key)              # ddim_sample's first split
    x_T = np.array(jax.random.normal(init_key, (2, S, S, 5), jnp.float32))
    got_img, got_flow = algo.sample(
        cond, x_T=torch.from_numpy(x_T).permute(0, 3, 1, 2).contiguous())
    for g, w in ((got_img, want_img), (got_flow, want_flow)):
        g, w = g.permute(0, 2, 3, 1).numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = np.isfinite(w)
        # f32 over 4 model calls whose flow (x20) drives the splat
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-4, atol=2e-4)
    assert np.isnan(np.asarray(want_img)).any()
    assert np.isfinite(np.asarray(want_flow)).all()


def test_flow_diffuser_sample_dpmpp_non_square_matches_jax():
    """The serving slice at a small size: conditioning rendered square and
    cropped to 16x32 as the native path does, DPM++(2M)-3 through
    ``FlowDiffuser.sample`` (sampler='dpmpp' passes through to the
    schedule), port vs JAX on bridged weights from JAX's initial noise.
    Each port model call is fed JAX's state of that step: free running, the
    random UNet's flow (x20 before the splat) amplifies float rounding
    beyond any pin within a few steps (``test_dpmpp_trajectory``)."""
    algo, jalgo, params = _pair(sampling_timesteps=3, sampler="dpmpp")
    items = sample_entry.batch_items(5, 2, S, 2 * S)
    assert items[0][0].shape == (S, 2 * S, 3)
    _, cond, _ = algo.preprocess(to_batch(items, "cpu"))
    jcond = jnp.asarray(cond.permute(0, 2, 3, 1).numpy())
    assert algo.sched.sampler == jalgo.sched.sampler == "dpmpp"
    traj, _ = jdm.dpmpp_sample(jalgo.sched, jalgo._model_fn(params), jax.random.PRNGKey(8),
                               (2, S, 2 * S, 5), external_cond=jcond, return_every=1)
    traj = np.asarray(traj)
    want = traj[:, -1]                      # the joint state: image (3) + flow (2)
    states = iter(torch.from_numpy(traj[:, k]).permute(0, 3, 1, 2).contiguous()
                  for k in range(traj.shape[1]))
    algo.model_fn = lambda x, c, t: algo.module(next(states), c, t)
    got_img, got_flow = algo.sample(
        cond, x_T=torch.from_numpy(traj[:, 0]).permute(0, 3, 1, 2).contiguous())
    got = torch.cat([got_img, got_flow], dim=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=2e-4)
    assert np.isfinite(want[..., 3:]).all()


def test_sample_entry_point_native_options_on_cpu():
    out = sample_entry.run(2, 0, "cpu", sampling_timesteps=3, unet_dim=8, sampler="dpmpp",
                           height=S, width=2 * S)
    assert out["samples_shape"] == [2, 3, S, 2 * S] and out["flow_shape"] == [2, 2, S, 2 * S]
    assert out["sampler"] == "dpmpp" and out["denoise_steps"] == 3
    assert out["finite_values_finite"] and out["frames_per_s"] > 0


def test_sample_entry_point_runs_on_cpu():
    out = sample_entry.run(2, 0, "cpu", sampling_timesteps=2, image_size=S, unet_dim=8)
    assert out["samples_shape"] == [2, 3, S, S] and out["flow_shape"] == [2, 2, S, S]
    assert out["sampler"] == "ddim" and out["denoise_steps"] == 2
    assert out["finite_values_finite"] and 0.0 <= out["nan_share"] <= 1.0


def test_profile_helpers():
    assert profile_step.busy_us([(0, 10), (5, 12), (20, 25)]) == 17
    assert profile_step.kind_of("void la_ctx_kernel<float>(...)") == "linear_attention"
    assert profile_step.kind_of("sm90_xmma_fprop_implicit_gemm_bf16") == "conv"
    assert profile_step.kind_of("indexFuncLargeIndex") == "index"
    assert profile_step.kind_of("flash_bf16_kernel(...)") == "flash_attention"
    assert profile_step.kind_of("void splat_scatter_kernel<float>(...)") == "splat"
