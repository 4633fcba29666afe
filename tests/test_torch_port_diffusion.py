"""Port vs JAX: schedule tables, the DDIM and DPM++ time grids, a DDIM-5
trajectory, a 4-step ancestral trajectory of the flagship's UnetWithWarp
(unet_dim 8 at 16x16) and a DPM++(2M)-5 trajectory at 16x32, step by step.  Both frameworks get the same initial and per-step
noise: the test draws it from JAX's key stream and hands it to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.flow_diffuser import UnetWithWarp as JUnetWithWarp
from opticalflowdiffusion_tpu.models import diffusion as jdm
from opticalflowdiffusion_tpu.utils import import_torch_ckpt as itc
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import UnetWithWarp
from opticalflowdiffusion_tpu_torch.models import diffusion as dm
from opticalflowdiffusion_tpu_torch.models.unet import Unet, init_weights
from opticalflowdiffusion_tpu_torch.utils.weights import flow_diffuser_state_dict

DIM, S, B = 8, 16, 2
SHAPE = (B, S, S, 5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def models():
    """(JAX model_fn, port model_fn, cond NHWC) with one set of seeded weights."""
    net = init_weights(Unet(DIM, out_dim=2, channels=9), torch.Generator().manual_seed(3))
    tree = {"model": itc.unet_params_from_torch(
        {k: v.numpy() for k, v in net.state_dict().items()})}
    jmod = JUnetWithWarp(flow_max=20.0, dim=3, channels=9, full_output=True,
                         zero_init=False, unet_dim=DIM)
    mod = UnetWithWarp(flow_max=20.0, dim=3, channels=9, full_output=True,
                       zero_init=False, unet_dim=DIM).eval()
    mod.load_state_dict(flow_diffuser_state_dict(tree), strict=True)

    def jfn(x, cond, t, sc=None):
        return jmod.apply({"params": tree}, x, cond, t, sc)

    cond = np.random.default_rng(4).uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    return jfn, mod, cond


@pytest.mark.parametrize("objective", ["pred_x0", "pred_noise", "pred_v"])
def test_schedule_tables(objective):
    want = jdm.make_schedule(timesteps=1000, objective=objective, min_snr_loss_weight=True)
    got = dm.make_schedule(timesteps=1000, objective=objective, min_snr_loss_weight=True,
                           device="cpu")
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
              "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
              "posterior_variance", "posterior_log_variance_clipped",
              "posterior_mean_coef1", "posterior_mean_coef2", "loss_weight"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def _grid_cases():
    """(T, S): the earlier five pairs, the two where the exact-integer grid
    is off by one (1000, 55) and (1000, 82), and for each T a stride over
    2..T."""
    cases = [(1000, 50), (1000, 250), (1000, 1000), (20, 5), (100, 10), (1000, 55), (1000, 82)]
    for T in (20, 100, 250, 1000, 2000):
        cases += [(T, s) for s in range(2, T + 1, max(1, T // 6)) if (T, s) not in cases]
    return cases


@pytest.mark.parametrize("T,S_", _grid_cases())
def test_ddim_times_match_jax(T, S_):
    """The DDIM grid (JAX ``ddim_sample``) and the DPM++ grid (JAX
    ``dpmpp_sample``) equal JAX's float32 ``linspace`` truncated to int32."""
    want = np.asarray(jnp.linspace(-1, T - 1, S_ + 1).astype(jnp.int32))
    assert dm.linspace_int(-1, T - 1, S_ + 1) == want.tolist()
    want = np.asarray(jnp.linspace(0, T - 1, S_).astype(jnp.int32))
    assert dm.linspace_int(0, T - 1, S_) == want.tolist()


def test_grid_differs_from_exact_integers():
    """The two named pairs are where JAX's grid is not ``T*i//S - 1``."""
    assert dm.linspace_int(-1, 999, 56)[11] == 198 != 1000 * 11 // 55 - 1
    assert dm.linspace_int(-1, 999, 83)[41] == 498 != 1000 * 41 // 82 - 1


def _compare_traj(got, want):
    """got (B, K, C, H, W) port, want (B, K, H, W, C) JAX: NaN masks, then
    finite values."""
    got = got.permute(0, 1, 3, 4, 2).numpy()
    assert got.shape == want.shape
    for k in range(want.shape[1]):
        np.testing.assert_array_equal(np.isnan(got[:, k]), np.isnan(want[:, k]),
                                      err_msg=f"step {k}")
        ok = np.isfinite(want[:, k])
        # f32; the splat scales the flow by 20, and each step feeds the last
        np.testing.assert_allclose(got[:, k][ok], want[:, k][ok], rtol=1e-4, atol=2e-4,
                                   err_msg=f"step {k}")
    assert np.isnan(want[:, -1]).any() and np.isfinite(want[:, -1]).any()


def test_ddim5_trajectory(models):
    jfn, mod, cond = models
    jsched = jdm.make_schedule(timesteps=20, sampling_timesteps=5, min_snr_loss_weight=True)
    key = jax.random.PRNGKey(11)
    want, _ = jdm.ddim_sample(jsched, jfn, key, SHAPE, external_cond=jnp.asarray(cond),
                              return_every=1)
    _, init_key = jax.random.split(key)           # ddim_sample's first split
    x_T = np.asarray(jax.random.normal(init_key, SHAPE, jnp.float32))
    sched = dm.make_schedule(timesteps=20, sampling_timesteps=5, min_snr_loss_weight=True,
                             device="cpu")
    with torch.no_grad():
        got = dm.ddim_sample(sched, mod, (B, 5, S, S), external_cond=_nchw(cond),
                             x_T=_nchw(x_T), return_every=1, device="cpu")
    assert got.shape == (B, 6, 5, S, S)
    _compare_traj(got, np.asarray(want))


def test_ancestral4_trajectory(models):
    jfn, mod, cond = models
    jsched = jdm.make_schedule(timesteps=4, min_snr_loss_weight=True)
    key = jax.random.PRNGKey(12)
    want, _ = jdm.p_sample_loop(jsched, jfn, key, SHAPE, external_cond=jnp.asarray(cond),
                                return_every=1)
    # p_sample_loop's key stream: one split for x_T, one per step
    rng, init_key = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(init_key, SHAPE, jnp.float32))
    noises = []
    for _ in range(4):
        rng, noise_key = jax.random.split(rng)
        noises.append(_nchw(jax.random.normal(noise_key, SHAPE, jnp.float32)))
    sched = dm.make_schedule(timesteps=4, min_snr_loss_weight=True, device="cpu")
    with torch.no_grad():
        got = dm.p_sample_loop(sched, mod, (B, 5, S, S), external_cond=_nchw(cond),
                               x_T=_nchw(x_T), noises=noises, return_every=1, device="cpu")
    assert got.shape == (B, 5, 5, S, S)
    _compare_traj(got, np.asarray(want))


@pytest.fixture(scope="module")
def models_wide():
    """As ``models``, on a non-square 16x32 conditioning."""
    net = init_weights(Unet(DIM, out_dim=2, channels=9), torch.Generator().manual_seed(5))
    tree = {"model": itc.unet_params_from_torch(
        {k: v.numpy() for k, v in net.state_dict().items()})}
    jmod = JUnetWithWarp(flow_max=20.0, dim=3, channels=9, full_output=True,
                         zero_init=False, unet_dim=DIM)
    mod = UnetWithWarp(flow_max=20.0, dim=3, channels=9, full_output=True,
                       zero_init=False, unet_dim=DIM).eval()
    mod.load_state_dict(flow_diffuser_state_dict(tree), strict=True)

    def jfn(x, cond, t, sc=None):
        return jmod.apply({"params": tree}, x, cond, t, sc)

    cond = np.random.default_rng(6).uniform(-1, 1, (B, S, 2 * S, 3)).astype(np.float32)
    return jfn, mod, cond


def test_dpmpp_trajectory(models_wide):
    """DPM-Solver++(2M), 5 steps on the trailing grid of T = 20, on a
    non-square 16x32 input: the port's sampler and UnetWithWarp against
    JAX's ``dpmpp_sample`` after every step, from JAX's initial noise.

    Each of the port's model calls is fed JAX's state of that step (the
    port's solver carries its own state, x0 history and coefficients).  A
    free-running comparison cannot hold any pin here: the random UNet's flow
    (x20 before the splat) amplifies float rounding about 4x per step, so
    that JAX's own sampler, run once inside its scan and once with the model
    called eagerly, differs by 2e-5 after one step and 1e-2 after five."""
    jfn, mod, cond = models_wide
    shape = (B, S, 2 * S, 5)
    jsched = jdm.make_schedule(timesteps=20, sampling_timesteps=5, min_snr_loss_weight=True,
                               sampler="dpmpp")
    key = jax.random.PRNGKey(13)
    want, _ = jdm.dpmpp_sample(jsched, jfn, key, shape, external_cond=jnp.asarray(cond),
                               return_every=1)
    want = np.asarray(want)
    states = iter(_nchw(want[:, k]) for k in range(want.shape[1]))

    def forced(x, c, t):
        return mod(next(states), c, t)

    sched = dm.make_schedule(timesteps=20, sampling_timesteps=5, min_snr_loss_weight=True,
                             sampler="dpmpp", device="cpu")
    with torch.no_grad():
        got = dm.sample(sched, forced, (B, 5, S, 2 * S), external_cond=_nchw(cond),
                        x_T=_nchw(want[:, 0]), return_every=1, device="cpu")
    assert got.shape == (B, 6, 5, S, 2 * S)
    _compare_traj(got, want)


def test_dpmpp_solver_free_running():
    """The solver alone, free running: port and JAX on a smooth model
    (x0 = tanh(0.7 x + t / 100)) agree to float32 rounding at every step."""
    shape = (B, 4, 8, 5)
    jsched = jdm.make_schedule(timesteps=20, sampling_timesteps=5, sampler="dpmpp")
    key = jax.random.PRNGKey(14)
    want, _ = jdm.dpmpp_sample(
        jsched, lambda x, c, t, sc=None: jnp.tanh(0.7 * x + 0.01 * t[:, None, None, None]),
        key, shape, return_every=1)
    want = np.asarray(want)
    sched = dm.make_schedule(timesteps=20, sampling_timesteps=5, sampler="dpmpp", device="cpu")
    got = dm.dpmpp_sample(sched, lambda x, c, t: torch.tanh(0.7 * x + 0.01 * t[:, None, None, None]),
                          (B, 5, 4, 8), x_T=_nchw(want[:, 0]), return_every=1, device="cpu")
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kwargs,err", [
    (dict(noise_space="flow"), NotImplementedError),
    (dict(sampling_timesteps=1), ValueError),
])
def test_dpmpp_guards(kwargs, err):
    """The two guards of JAX's ``make_schedule`` for sampler='dpmpp'."""
    with pytest.raises(err):
        jdm.make_schedule(timesteps=20, sampler="dpmpp", **kwargs)
    with pytest.raises(err):
        dm.make_schedule(timesteps=20, sampler="dpmpp", device="cpu", **kwargs)


@pytest.mark.parametrize("objective", ["pred_x0", "pred_noise", "pred_v"])
@pytest.mark.parametrize("clip", [False, True])
def test_model_predictions_match_jax(objective, clip):
    """All three objectives, with and without the clipped, re-derived noise
    (the DDIM path), on a fixed model output; and predict_v."""
    rng = np.random.default_rng(9)
    x, out, noise = (rng.standard_normal(SHAPE).astype(np.float32) * 1.5 for _ in range(3))
    t = np.array([3, 950], np.int32)
    jsched = jdm.make_schedule(timesteps=1000, objective=objective)
    sched = dm.make_schedule(timesteps=1000, objective=objective, device="cpu")
    want = jdm.model_predictions(jsched, lambda *a: jnp.asarray(out), jnp.asarray(x),
                                 jnp.asarray(t), clip_x_start=clip, rederive_pred_noise=clip)
    got = dm.model_predictions(sched, lambda *a: _nchw(out), _nchw(x),
                               torch.from_numpy(t).long(), clip_x_start=clip,
                               rederive_pred_noise=clip)
    for g, w in zip(got, want[:2]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        dm.predict_v(sched, _nchw(x), torch.from_numpy(t).long(), _nchw(noise))
        .permute(0, 2, 3, 1).numpy(),
        np.asarray(jdm.predict_v(jsched, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))),
        rtol=1e-5, atol=1e-5)
