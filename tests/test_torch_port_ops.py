"""Port vs JAX: forward warp (with its NaN holes), splat, conv and the
bottleneck attention middle; and the splat kernel's wrapper on the CPU
(the kernel itself: test_torch_port_kernels.py).  Images are NHWC in JAX
and NCHW in the port."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opticalflowdiffusion_tpu.ops import conv_pallas, flash_attention, splat, warp
from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch.ops import conv as pconv
from opticalflowdiffusion_tpu_torch.ops import flash_attention as pflash
from opticalflowdiffusion_tpu_torch.ops import splat as psplat
from opticalflowdiffusion_tpu_torch.ops import warp as pwarp


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _warp_inputs(seed, B=2, H=12, W=16, C=3, flow_scale=3.0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    img[0, 2, 3, 1] = np.nan                  # NaN inputs carry zero weight
    img[1, 5, :4, :] = np.nan
    flow = (rng.standard_normal((B, H, W, 2)) * flow_scale).astype(np.float32)
    flow[0, 0, 0] = (-40.0, 3.0)              # lands outside the image
    flow[1, 7, 7] = (np.inf, 0.0)             # non-finite target: dropped
    return img, flow


@pytest.mark.parametrize("seed,flow_scale", [(0, 1.5), (1, 4.0), (2, 0.0)])
def test_warp_forward_flow_f32(seed, flow_scale):
    img, flow = _warp_inputs(seed, flow_scale=flow_scale)
    want = np.asarray(warp.warp_forward_flow(jnp.asarray(img), jnp.asarray(flow)))
    got = _nhwc(pwarp.warp_forward_flow(_nchw(img), _nchw(flow)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() and np.isfinite(want).any()
    ok = np.isfinite(want)
    # f32 sums of at most a few bilinear terms, in another order
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)


def test_warp_forward_flow_bf16():
    img, flow = _warp_inputs(3)
    want = np.asarray(warp.warp_forward_flow(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(flow)).astype(jnp.float32))
    got = _nhwc(pwarp.warp_forward_flow(_nchw(img).to(torch.bfloat16), _nchw(flow)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    # both sum in f32 and round the result once to bf16: one ulp apart at most
    np.testing.assert_allclose(got[ok], want[ok], rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("k,cin,cout", [(7, 9, 8), (3, 16, 8), (1, 32, 16)])
def test_conv2d_same(k, cin, cout):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 10, 12, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    want = np.asarray(conv_pallas.conv2d_same(jnp.asarray(x), jnp.asarray(w)))
    got = _nhwc(pconv.conv2d_same(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy())))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_middle(dtype):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 64, 4, 32)).astype(np.float32) for _ in range(3))
    q *= 32 ** -0.5
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(flash_attention._attention_middle_xla(
        *(jnp.asarray(a, jd) for a in (q, k, v))).astype(jnp.float32))
    got = pflash.attention_middle(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert got.dtype == td
    # f32: summation order only; bf16: p and the output are rounded to bf16
    # (values < 1 here, so one ulp is below 2^-8)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_splat_raw_non_square(dtype):
    """The plain splat against JAX's ``splat_raw`` on a 12x20 map (W != H),
    with targets off the image and a non-finite one."""
    img, flow = _warp_inputs(4, H=12, W=20, C=4)
    img = np.nan_to_num(img)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(splat.splat_raw(jnp.asarray(img, jd), jnp.asarray(flow))
                      .astype(jnp.float32))
    got = psplat.splat_raw(_nchw(img).to(td), _nchw(flow))
    assert got.dtype == td
    # f32 sums of a few terms in another order; bf16: one rounding of that sum
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(_nhwc(got), want, **tol)


def test_softsplat_cpu_is_plain_and_launches_nothing():
    img, flow = _warp_inputs(5, H=12, W=20, C=3)
    x, fl = _nchw(np.nan_to_num(img)), _nchw(flow)
    metric = torch.ones(2, 1, 12, 20)
    before = [k.launches for k in kernels.KERNELS]
    got = psplat.softsplat(x, fl, metric)
    assert [k.launches for k in kernels.KERNELS] == before
    np.testing.assert_array_equal(
        got.numpy(), psplat.splat_raw(torch.cat([x * metric, metric], dim=1), fl).numpy())
    with pytest.raises(ValueError):
        psplat.splat_fwd(torch.cat([x * metric, metric], dim=1), fl)
