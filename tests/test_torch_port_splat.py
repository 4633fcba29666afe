"""Port vs JAX: the splat at integer scales and phase offsets, its reference
VJP (with REFERENCE_QUIRKS 1-3), the softsplat modes, the forward warp's
``scale``/``set_nans``/``get_variance``/``warp_style`` options and the
NaN-aware MSE.  The port's plain versions run here on the CPU; the CUDA
kernels are checked against them in tests/test_torch_port_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.ops import splat, warp
from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch.ops import splat as psplat
from opticalflowdiffusion_tpu_torch.ops import warp as pwarp


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _inputs(seed, B=2, H=13, W=18, C=4, flow_scale=3.0):
    """Values and a flow with targets off the image, one non-finite target,
    and sources on the last row and column moved onto the edge branch."""
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * flow_scale).astype(np.float32)
    flow[0, 0, 0] = (np.inf, 0.0)
    flow[1, 2, 3] = (-40.0, 1.0)
    flow[:, H - 1, :, 1] = np.abs(flow[:, H - 1, :, 1])       # y >= H - 1
    flow[:, :, W - 1, 0] = np.abs(flow[:, :, W - 1, 0]) * 0.1  # x >= W - 1
    return inp, flow


def _close(got, want, rel=1e-5):
    """|got - want| <= rel * max |want|: f32 sums of a few bilinear terms in
    another order."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("scale,offset", [(1, (0, 0)), (2, (0, 0)), (2, (1, 1)), (4, (0, 0)),
                                          (4, (1, 1)), (4, (3, 2))])
def test_splat_and_vjp_match_jax(scale, offset):
    inp, flow = _inputs(10 * scale + offset[0])
    out, vjp = jax.vjp(lambda i, f: splat.splat_raw(i, f, scale, *offset),
                       jnp.asarray(inp), jnp.asarray(flow))
    g = np.random.default_rng(1).standard_normal(out.shape).astype(np.float32)
    d_inp, d_flow = vjp(jnp.asarray(g))
    got = psplat.splat_raw(_nchw(inp), _nchw(flow), scale, offset)
    assert got.shape[2:] == (13 // scale, 18 // scale)
    _close(_nhwc(got), out)
    gi, gf = psplat.splat_bwd_raw(_nchw(inp), _nchw(flow), _nchw(g), scale, offset)
    _close(_nhwc(gi), d_inp)
    _close(_nhwc(gf), d_flow)
    assert np.abs(np.asarray(d_flow)).max() > 0


@pytest.mark.parametrize("scale,offset", [(1, (0, 0)), (4, (3, 2))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splat_float64_sums_match_jax(scale, offset, dtype):
    """splat_raw with float64 sums (the card's deterministic reference): in
    the input's dtype, within float32 rounding of JAX's sums (one bf16
    rounding of them for bf16)."""
    inp, flow = _inputs(3 * scale + offset[0])
    want = splat.splat_raw(jnp.asarray(inp), jnp.asarray(flow), scale, *offset)
    got = psplat.splat_raw(_nchw(inp).to(dtype), _nchw(flow), scale, offset,
                           acc_dtype=torch.float64)
    assert got.dtype == dtype
    if dtype == torch.float32:
        _close(_nhwc(got), want)
    else:
        f32 = psplat.splat_raw(_nchw(inp).to(dtype).float(), _nchw(flow), scale, offset)
        _close(_nhwc(got), _nhwc(f32.to(dtype)), rel=2.0 ** -7)


@pytest.mark.parametrize("scale", [1, 4])
def test_splat_autograd_is_the_reference_vjp(scale):
    inp, flow = _inputs(7)
    ti, tf = _nchw(inp).requires_grad_(), _nchw(flow).requires_grad_()
    out, mask = psplat.splat(ti, tf, scale, (0, 0))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    (out * g).sum().backward()
    want_i, want_f = psplat.splat_bwd_raw(ti.detach(), tf.detach(), g, scale, (0, 0))
    assert torch.equal(ti.grad, want_i) and torch.equal(tf.grad, want_f)
    assert not mask.requires_grad
    assert torch.equal(mask, out[:, -1:] > 0)


@pytest.mark.parametrize("mode", ["avg", "linear", "soft", "linear-zeroeps", "soft-clipeps",
                                  "sum"])
def test_softsplat_modes_match_jax(mode):
    inp, flow = _inputs(3, C=3)
    metric = np.random.default_rng(2).uniform(0, 1, inp.shape[:-1] + (1,)).astype(np.float32)
    base = mode.split("-")[0]
    m = None if base in ("sum", "avg") else metric
    want = splat.softsplat(jnp.asarray(inp), jnp.asarray(flow),
                           None if m is None else jnp.asarray(m), mode, 2, (1, 0))
    got = psplat.softsplat(_nchw(inp), _nchw(flow), None if m is None else _nchw(m), mode, 2,
                           (1, 0))
    _close(_nhwc(got), want, 1e-4)


def test_splat_kernel_wrappers_refuse_cpu_tensors():
    inp, flow = (_nchw(a) for a in _inputs(4))
    before = [k.launches for k in kernels.KERNELS]
    with pytest.raises(ValueError):
        psplat.splat_fwd(inp, flow, 2)
    with pytest.raises(ValueError):
        psplat.splat_bwd(inp, flow, torch.zeros(2, 4, 6, 9), 2)
    with pytest.raises(ValueError):
        psplat.splat_raw(inp, flow, 2, (2, 0))          # offset must be < scale
    assert [k.launches for k in kernels.KERNELS] == before


def _warp_inputs(seed, B=2, H=16, W=20):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    img[0, 2, 3, 1] = np.nan
    img[1, 5, :4, :] = np.nan
    flow = (rng.standard_normal((B, H, W, 2)) * 2.0).astype(np.float32)
    flow[1, 7, 7] = (np.inf, 0.0)
    return img, flow


@pytest.mark.parametrize("seed,kw", enumerate([
    dict(scale=2), dict(scale=4, offset=(1, 3)), dict(scale=2, set_nans=False),
    dict(get_variance=True), dict(scale=2, warp_style="avg"),
]))
def test_warp_forward_flow_options_match_jax(seed, kw):
    img, flow = _warp_inputs(seed)
    want = np.asarray(warp.warp_forward_flow(jnp.asarray(img), jnp.asarray(flow), **kw))
    got = _nhwc(pwarp.warp_forward_flow(_nchw(img), _nchw(flow), **kw))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5 * np.abs(want[ok]).max())


def test_nan_mse_stats_match_jax():
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    tgt = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    pred[0, 1, 2] = np.nan
    tgt[1, :3, 4, 0] = np.nan
    s, n = warp.nan_mse_stats(jnp.asarray(pred), jnp.asarray(tgt))
    ps, pn = pwarp.nan_mse_stats(_nchw(pred), _nchw(tgt))
    assert ps.dtype == torch.float32 and int(pn) == int(n)
    np.testing.assert_allclose(float(ps), float(s), rtol=1e-6)
    np.testing.assert_allclose(float(pwarp.nan_mse(_nchw(pred), _nchw(tgt))),
                               float(warp.nan_mse(jnp.asarray(pred), jnp.asarray(tgt))),
                               rtol=1e-6)
    bf = pwarp.nan_mse_stats(_nchw(pred).bfloat16(), _nchw(tgt).bfloat16())[0]
    assert bf.dtype == torch.float32       # bf16 values, f32 sum
