"""Port vs JAX for the filter representation's ops (``ops/filters.py``) and
the filter codecs (``models/filter_codec.py``, weights carried over by
``utils/weights.py``), on the CPU, f32 to 1e-5.  The port is NCHW: a
packed filter is (B, R^2 + C + 1, H, W) and an unpacked one (B, R, R, H, W)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.models import filter_codec as jcodec
from opticalflowdiffusion_tpu.ops import filters as jf
from opticalflowdiffusion_tpu_torch.models import filter_codec as pcodec
from opticalflowdiffusion_tpu_torch.ops import filters as pf
from opticalflowdiffusion_tpu_torch.utils.weights import filter_codec_rows, from_jax, to_jax

B, H, W, R = 2, 7, 9, 3


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    packed = rng.uniform(-0.2, 1.0, (B, H, W, R * R + 4)).astype(np.float32)
    img = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    return packed, img


def test_radius_pack_unpack(data):
    packed, _ = data
    assert pf.get_radius(R * R + 4) == jf.get_radius(R * R + 4) == R
    fil, col, colw = pf.unpack_flow(_nchw(packed))
    jfil, jcol, jcolw = jf.unpack_flow(jnp.asarray(packed))
    np.testing.assert_array_equal(fil.numpy().transpose(0, 3, 4, 1, 2), np.asarray(jfil))
    np.testing.assert_array_equal(_nhwc(col), np.asarray(jcol))
    np.testing.assert_array_equal(_nhwc(colw), np.asarray(jcolw))
    np.testing.assert_array_equal(_nhwc(pf.pack_flow(fil, col, colw)), packed)


@pytest.mark.parametrize("radius", [3, 5])
def test_unfold_tap_order(data, radius):
    """F.unfold's taps are channel-major (C, i, j), as JAX's patches."""
    _, img = data
    got = pf.unfold(_nchw(img), radius).numpy().transpose(0, 4, 5, 2, 3, 1)
    np.testing.assert_array_equal(got, np.asarray(jf.unfold(jnp.asarray(img), radius)))


def test_bound_mask(data):
    got = pf.bound_mask(R, H, W).numpy().transpose(2, 3, 0, 1)
    np.testing.assert_array_equal(got, np.asarray(jf.bound_mask(R, H, W)))


def test_apply_filter(data):
    packed, img = data
    fil = pf.unpack_flow(_nchw(packed))[0]
    jfil = jf.unpack_flow(jnp.asarray(packed))[0]
    _close(_nhwc(pf.apply_filter(_nchw(img), fil)), jf.apply_filter(jnp.asarray(img), jfil))


@pytest.mark.parametrize("negate", [False, True])
def test_invert_filter(data, negate):
    packed, _ = data
    got = pf.invert_filter(_nchw(packed), negate_colweight=negate)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(
        jf.invert_filter(jnp.asarray(packed), negate_colweight=negate)))


def test_filter_to_flow_and_occlusion_mask(data):
    packed, _ = data
    _close(_nhwc(pf.filter_to_flow(_nchw(packed))), jf.filter_to_flow(jnp.asarray(packed)))
    packed = packed * 0.06          # inverted masses on both sides of the 0.25 threshold
    got = _nhwc(pf.occlusion_mask(_nchw(packed)))
    want = np.asarray(jf.occlusion_mask(jnp.asarray(packed)))
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


def test_filter_warps(data):
    packed, img = data
    _close(_nhwc(pf.warp_backward_filter(_nchw(img), _nchw(packed))),
           jf.warp_backward_filter(jnp.asarray(img), jnp.asarray(packed)))
    _close(_nhwc(pf.warp_forward_filter(_nchw(img), _nchw(packed))),
           jf.warp_forward_filter(jnp.asarray(img), jnp.asarray(packed)))


def test_conv_transpose_same_shapes():
    """Flax's SAME transposed conv at stride 2 doubles the side; the port's
    layer cuts torch's output to the same size."""
    for k in (3, 5):
        lo, hi = pcodec._pads(k, 2)
        assert (lo, hi) == jax._src.lax.convolution._conv_transpose_padding(k, 2, "SAME")
    layer = pcodec._ConvTransposeSame(4, 2, 5)
    assert layer(torch.zeros(3, 4, 6, 6)).shape == (3, 2, 12, 12)


def test_conv_to_filter_matches_jax():
    """ConvToFilter with bridged weights (kernels flipped) against JAX, and
    the bridge back to the JAX tree."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 3, 4, 81)).astype(np.float32)
    jmod = jcodec.ConvToFilter(5, in_dim=81)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(1), p.shape), params)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    mod = pcodec.ConvToFilter(5, 81)
    rows = filter_codec_rows()
    mod.load_state_dict(from_jax(params, rows))
    got = mod(_nchw(x))
    assert got.shape == (B, 25, 3, 4)
    _close(_nhwc(got), want)
    back = to_jax(mod.state_dict(), params, rows)
    for path, _, _ in rows:
        a, b = back, params
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("enabled", [False, True])
def test_filter_to_conv_matches_jax(enabled):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 3, 4, 25)).astype(np.float32)
    jmod = jcodec.FilterToConv(5, enabled=enabled)
    mod = pcodec.FilterToConv(5, enabled=enabled)
    if not enabled:
        np.testing.assert_array_equal(_nhwc(mod(_nchw(x))), x)
        return
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    mod.load_state_dict(from_jax(params, filter_codec_rows(filter_to_conv=True)))
    _close(_nhwc(mod(_nchw(x))), want)
