"""Port vs JAX: ``permute_warp`` (bit for bit), the flow-noise scale
``_flow_sigma`` and the flow-space forward process ``q_sample`` on JAX's
noise, and the schedule's guards for flow noise; and, on a toy model,
``p_losses`` with an extra target, the flow-loss weight, flow noise,
self-conditioning and offset noise, ``model_predictions`` and the three
samplers with extra output channels, and ``interpolate`` (image and flow
noise).  Inputs are numpy-seeded; images NHWC for JAX, NCHW for the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.flow_diffuser import make_warp_fn as jmake_warp_fn
from opticalflowdiffusion_tpu.models import diffusion as jdm
from opticalflowdiffusion_tpu.ops.warp import permute_warp as jpermute_warp
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import make_warp_fn
from opticalflowdiffusion_tpu_torch.models import diffusion as dm
from opticalflowdiffusion_tpu_torch.ops.warp import permute_warp

S, B, T = 16, 2, 4


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


def _close(got, want, rtol, atol, what=""):
    """NaN masks equal, finite values close."""
    got, want = _nhwc(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol, err_msg=what)


def _flow(kind, B, H, W, rng):
    """Normalised flows (1.0 = the full extent), (B, H, W, 2), x then y."""
    if kind == "zero":
        return np.zeros((B, H, W, 2), np.float32)
    if kind == "integer_wrap":
        # whole-pixel shifts of up to two extents, so most sources wrap
        px = rng.integers(-2 * W, 2 * W, (B, H, W, 1))
        py = rng.integers(-2 * H, 2 * H, (B, H, W, 1))
        return np.concatenate([px / W, py / H], -1).astype(np.float32)
    if kind == "subpixel":
        return (rng.standard_normal((B, H, W, 2)) * 1e-3).astype(np.float32)
    if kind == "large":
        return (rng.standard_normal((B, H, W, 2)) * 30.0).astype(np.float32)
    if kind == "ties":
        # every source of a row sent to one destination: equal keys, so the
        # order is the sort's stability (raster order within the tie)
        xs = (np.arange(W, dtype=np.float32) + np.float32(0.5)) / np.float32(W)
        f = np.zeros((B, H, W, 2), np.float32)
        f[..., 0] = np.float32(0.25) - xs
        return f
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["zero", "integer_wrap", "subpixel", "large", "ties"])
@pytest.mark.parametrize("H,W", [(16, 16), (8, 24), (7, 13)])
def test_permute_warp_bitwise_jax(kind, H, W):
    """The same permutation as JAX under jit (as every caller runs it), so
    the same bits: JAX's key as XLA compiles it (the grid ``(x + 0.5) / W``
    as a product with the reciprocal of W, fused with the flow's add into
    one rounding: at W = 13 and 24 the integer-wrap and tie flows, whose
    sources collide, tell that apart from a division or a rounded product)
    and a stable sort."""
    rng = np.random.default_rng(hash((kind, H, W)) % 2 ** 32)
    img = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    flow = _flow(kind, 2, H, W, rng)
    want = np.asarray(jax.jit(jpermute_warp)(img, flow))
    got = _nhwc(permute_warp(_nchw(img), _nchw(flow)))
    np.testing.assert_array_equal(got, want)
    # a permutation of each image's pixels
    np.testing.assert_array_equal(np.sort(got.reshape(2, -1, 3), axis=1),
                                  np.sort(img.reshape(2, -1, 3), axis=1))
    if kind == "zero":
        np.testing.assert_array_equal(got, img)


def test_permute_warp_key_at_a_row_boundary():
    """Keys within an ulp of a rank boundary: y flows that put ty * H one
    float32 ulp below, at and above an integer.  The port computes the same
    float32 operations in the same order as JAX (the grid on the host,
    correctly rounded), so such keys round alike and the test holds bit for
    bit; a reordered key (``(y + 0.5 + H * f) / H``, say) would move these
    sources to another row."""
    H, W = 8, 8
    ys = (np.arange(H, dtype=np.float32) + np.float32(0.5)) / np.float32(H)
    rng = np.random.default_rng(3)
    img = rng.standard_normal((1, H, W, 2)).astype(np.float32)
    flow = np.zeros((1, H, W, 2), np.float32)
    for col in range(W):
        target = np.float32((col % 3 + 1) / H)
        step = [-1, 0, 1][col % 3]
        for row in range(H):
            f = np.float32(target - ys[row])
            flow[0, row, col, 1] = np.nextafter(f, np.float32(step * np.inf)) if step else f
    want = np.asarray(jax.jit(jpermute_warp)(img, flow))
    np.testing.assert_array_equal(_nhwc(permute_warp(_nchw(img), _nchw(flow))), want)


def test_permute_warp_gradients():
    """Values take the permuted cotangent (as jax.grad), the flow none."""
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 8, 12, 2)) * 0.3).astype(np.float32)
    w = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jpermute_warp(x, flow) * w)))(img))
    x, f = _nchw(img).requires_grad_(), _nchw(flow).requires_grad_()
    (permute_warp(x, f) * _nchw(w)).sum().backward()
    np.testing.assert_array_equal(_nhwc(x.grad), want)
    assert f.grad is None


@pytest.mark.parametrize("H,W", [(16, 16), (16, 32)])
def test_flow_sigma_and_q_sample_match_jax(H, W):
    """``_flow_sigma`` at every t against JAX's (1e-7 relative: f32
    divisions of the tables); ``q_sample`` under flow noise on JAX's noise,
    bit for bit (the same sigma, so the same keys)."""
    jsched = jdm.make_schedule(timesteps=1000, noise_space="flow", min_snr_loss_weight=True)
    sched = dm.make_schedule(timesteps=1000, noise_space="flow", min_snr_loss_weight=True,
                             device="cpu")
    x = np.random.default_rng(5).uniform(-1, 1, (4, H, W, 5)).astype(np.float32)
    t = np.array([0, 1, 500, 999], np.int32)
    want = np.asarray(jdm._flow_sigma(jsched, jnp.asarray(t), jnp.asarray(x)))  # (B, 1, 1, 2)
    got = dm._flow_sigma(sched, torch.from_numpy(t).long(), _nchw(x))             # (B, 2, 1, 1)
    assert got.shape == (4, 2, 1, 1)
    np.testing.assert_allclose(got[:, :, 0, 0].numpy(), want[:, 0, 0], rtol=1e-7, atol=0)
    noise = jax.random.normal(jax.random.PRNGKey(6), (4, H, W, 2), jnp.float32)
    want_x = np.asarray(jax.jit(jdm.q_sample)(jsched, jnp.asarray(x), jnp.asarray(t), noise))
    got_x = dm.q_sample(sched, _nchw(x), torch.from_numpy(t).long(), _nchw(noise))
    np.testing.assert_array_equal(_nhwc(got_x), want_x)
    np.testing.assert_array_equal(_nhwc(got_x)[0], x[0])        # t = 0: the identity
    assert not np.array_equal(_nhwc(got_x)[3], x[3])            # t = T - 1: a shuffle


def test_flow_noise_schedule_guards():
    """make_schedule raises where JAX raises: DPM++ with flow noise, flow
    noise without pred_x0; it takes flow noise with the other samplers."""
    for kw in (dict(sampler="dpmpp", sampling_timesteps=4),
               dict(objective="pred_noise"), dict(objective="pred_v")):
        with pytest.raises(NotImplementedError):
            jdm.make_schedule(timesteps=20, noise_space="flow", **kw)
        with pytest.raises(NotImplementedError):
            dm.make_schedule(timesteps=20, noise_space="flow", device="cpu", **kw)
    for sampler in ("auto", "ancestral", "ddim"):
        assert dm.make_schedule(timesteps=20, noise_space="flow", sampler=sampler,
                                device="cpu").noise_space == "flow"
    assert dm.noise_shape(dm.make_schedule(timesteps=20, noise_space="flow", device="cpu"),
                          (2, 5, 8, 8)) == (2, 2, 8, 8)


# ------------------------------------------------- diffusion with a toy model
def _toy(extra, lib):
    """A smooth deterministic model of (x, cond, t) with ``extra`` extra
    output channels, written once for each framework (NHWC / NCHW)."""

    def fn(x, cond, t, sc=None):
        if lib is jnp:
            tt = t.astype(jnp.float32)[:, None, None, None] / T
            base = jnp.tanh(0.7 * x + 0.3 * cond[..., :1] - 0.2 * tt)
            return jnp.concatenate([base] + [jnp.sin(x[..., :1] + tt)] * extra, axis=-1)
        tt = t.float()[:, None, None, None] / T
        base = torch.tanh(0.7 * x + 0.3 * cond[:, :1] - 0.2 * tt)
        return torch.cat([base] + [torch.sin(x[:, :1] + tt)] * extra, dim=1)

    return fn


def _scheds(noise_space="image", **kw):
    return (jdm.make_schedule(timesteps=T, noise_space=noise_space, min_snr_loss_weight=True,
                              **kw),
            dm.make_schedule(timesteps=T, noise_space=noise_space, min_snr_loss_weight=True,
                             device="cpu", **kw))


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


@pytest.mark.parametrize("sampler,noise_space", [("ddim", "image"), ("dpmpp", "image"),
                                                 ("ancestral", "image"),
                                                 ("ancestral", "flow"), ("ddim", "flow")])
@pytest.mark.parametrize("every", [None, 2])
def test_samplers_additional_channels_match_jax(sampler, noise_space, every):
    """The three samplers with ``additional_channels=2`` through the
    dispatcher: the state, or the trajectory, and the extra channels of the
    last step or of the trajectory's steps, against JAX's on JAX's noise
    (ancestral under flow noise: the permutation warp of the posterior
    mean, none at t = 0; DDIM applies its additive update, as JAX does).
    f32, 1e-5."""
    kw = dict(sampler=sampler)
    if sampler != "ancestral":
        kw["sampling_timesteps"] = 3
    jsched, sched = _scheds(noise_space, **kw)
    rng = np.random.default_rng(7)
    cond = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    shape = (B, S, S, 5)
    key = jax.random.PRNGKey(8)
    want, wadd = jdm.sample(jsched, _toy(2, jnp), key, shape, external_cond=jnp.asarray(cond),
                            additional_channels=2, return_every=every)
    nshape = shape[:-1] + (2,) if noise_space == "flow" else shape
    x_T, noises = _keys_ancestral(key, shape, nshape, T)
    got, gadd = dm.sample(sched, _toy(2, torch), (B, 5, S, S), external_cond=_nchw(cond),
                          x_T=x_T, noises=noises, return_every=every, device="cpu",
                          additional_channels=2)
    _close(got, want, 1e-5, 1e-5, "state")
    _close(gadd, wadd, 1e-5, 1e-5, "additional")
    plain = dm.sample(sched, _toy(0, torch), (B, 5, S, S), external_cond=_nchw(cond),
                      x_T=x_T, noises=noises, return_every=every, device="cpu")
    assert isinstance(plain, torch.Tensor) and plain.shape == got.shape


def test_model_predictions_additional_channels():
    jsched, sched = _scheds()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, S, 5)).astype(np.float32)
    cond = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    t = np.array([0, 3], np.int32)
    want = jdm.model_predictions(jsched, _toy(2, jnp), jnp.asarray(x), jnp.asarray(t),
                                 clip_x_start=True, rederive_pred_noise=True,
                                 external_cond=jnp.asarray(cond), additional_channels=2)
    got = dm.model_predictions(sched, _toy(2, torch), _nchw(x), torch.from_numpy(t).long(),
                               clip_x_start=True, rederive_pred_noise=True,
                               external_cond=_nchw(cond), additional_channels=2)
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-5)


@pytest.mark.parametrize("noise_space", ["image", "flow"])
def test_interpolate_matches_jax(noise_space):
    """interpolate from step t = 3: both states noised by JAX's draws,
    mixed, denoised by the ancestral steps 2..0 on JAX's per-step noise."""
    jsched, sched = _scheds(noise_space)
    rng = np.random.default_rng(10)
    x1, x2 = (rng.uniform(-1, 1, (B, S, S, 5)).astype(np.float32) for _ in range(2))
    cond = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda a, b, c: jdm.interpolate(jsched, _toy(0, jnp), key, a, b, t=3,
                                                   lam=0.3, external_cond=c))(x1, x2, cond)
    nshape = (B, S, S, 2) if noise_space == "flow" else (B, S, S, 5)
    rng_, k1, k2 = jax.random.split(key, 3)
    n1, n2 = (_nchw(jax.random.normal(k, nshape, jnp.float32)) for k in (k1, k2))
    noises = []
    for _ in range(3):
        rng_, k = jax.random.split(rng_)
        noises.append(_nchw(jax.random.normal(k, nshape, jnp.float32)))
    got = dm.interpolate(sched, _toy(0, torch), _nchw(x1), _nchw(x2), t=3, lam=0.3,
                         external_cond=_nchw(cond), x_T=(n1, n2), noises=noises, device="cpu")
    _close(got, want, 1e-5, 1e-5)


def _p_losses_case(extra, **kw):
    rng = np.random.default_rng(12)
    c = 3
    cond = rng.uniform(-1, 1, (B, S, S, c)).astype(np.float32)
    x0 = rng.uniform(-1, 1, (B, S, S, c + (2 if extra is None else 0))).astype(np.float32)
    flow = (rng.standard_normal((B, S, S, 2)) * 0.05).astype(np.float32)
    t = np.array([1, 3], np.int32)
    return cond, x0, flow, t


@pytest.mark.parametrize("case", ["target_flow_weight", "joint_flow_weight",
                                  "joint_flow_noise", "target_flow_noise", "offset_noise",
                                  "self_condition"])
def test_p_losses_match_jax(case):
    """p_losses on injected t and noise: the ``target`` target (its flow
    head as ``additional_tgt``) and the joint target with
    ``flow_loss_weight``, either under flow noise, offset noise and
    self-conditioning (coin and offset draws from JAX's keys).  The toy
    model's flow is small, so the splats move.  f32, rtol 1e-5."""
    extra = 2 if case.startswith("target") else None
    cond, x0, flow, t = _p_losses_case(extra)
    noise_space = "flow" if "flow_noise" in case else "image"
    jsched, sched = _scheds(noise_space)
    key = jax.random.PRNGKey(13)
    rng_noise, rng_sc, rng_off = jax.random.split(key, 3)
    nshape = (B, S, S, 2) if noise_space == "flow" else x0.shape
    noise = np.asarray(jax.random.normal(rng_noise, nshape, jnp.float32))
    kw, pkw = {}, {}
    if case == "offset_noise":
        kw["offset_noise_strength"] = pkw["offset_noise_strength"] = 0.1
        pkw["offset_noise"] = _nchw(jax.random.normal(rng_off, (B, 1, 1, x0.shape[-1]),
                                                      jnp.float32))
    if case == "self_condition":
        kw["self_condition"] = pkw["self_condition"] = True
        pkw["self_cond_coin"] = bool(jax.random.bernoulli(rng_sc))
    weight = 0.0 if case in ("offset_noise", "self_condition") else 0.7
    jfn = lambda x, c, tt, sc=None: _toy(2 if extra else 0, jnp)(x, c, tt) * 0.1 + (
        0.0 if sc is None else 0.01 * sc[..., :1])
    pfn = lambda x, c, tt, sc=None: _toy(2 if extra else 0, torch)(x, c, tt) * 0.1 + (
        0.0 if sc is None else 0.01 * sc[:, :1])
    want = jax.jit(lambda x0, tt, c, f, n: jdm.p_losses(
        jsched, jfn, key, x0, tt, external_cond=c, additional_tgt=f if extra else None,
        warp_fn=jmake_warp_fn(20.0, 3), image_channels=3, flow_loss_weight=weight,
        noise=n, **kw))(x0, t, cond, flow, noise)
    got = dm.p_losses(sched, pfn, _nchw(x0), torch.from_numpy(t).long(), _nchw(noise),
                      external_cond=_nchw(cond), warp_fn=make_warp_fn(20.0, 3),
                      image_channels=3, flow_loss_weight=weight,
                      additional_tgt=_nchw(flow) if extra else None, **pkw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert np.isfinite(float(want))
