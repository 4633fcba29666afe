"""Port vs JAX for FlowLearner's photometric pyramid (``ops/pyramid.py``) and
the loss helpers of ``ops/warp.py`` it uses, on the CPU (the splat's plain
versions): ``multi_offset_soft_splat`` and ``photometric_pyramid_loss``
against JAX's default phase-interleaved path and its per-offset
``OFD_PYRAMID=map`` path, values and gradients in the image, the flow and
the weights, at a level that divides the 12x20 frame (2) and at one that
takes the edge-stretch branch (5).  f32: the value to 1e-5 relative, the
gradients to 1e-4 of their largest entry."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.ops import pyramid as jpyr
from opticalflowdiffusion_tpu.ops import warp as jwarp
from opticalflowdiffusion_tpu_torch.ops import pyramid as pyr
from opticalflowdiffusion_tpu_torch.ops import warp as pwarp

B, H, W = 2, 12, 20
PATHS = ("phase", "map")


def _nchw(a):
    a = np.asarray(a)
    axes = (0, 3, 1, 2) if a.ndim == 4 else (0, 1, 4, 2, 3)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(axes)))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * 2).astype(np.float32)
    flow[0, 1, 2] = np.nan                       # a non-finite target drops
    weights = (rng.standard_normal((B, H, W, 1)) * 0.3).astype(np.float32)
    return img, tgt, flow, weights


def _jax_path(path, fn, *args):
    """``fn(*args)`` on JAX's ``path`` ('map' sets OFD_PYRAMID while it
    traces; the variable is restored afterwards)."""
    old = os.environ.get("OFD_PYRAMID")
    if path == "map":
        os.environ["OFD_PYRAMID"] = "map"
    else:
        os.environ.pop("OFD_PYRAMID", None)
    try:
        return jax.block_until_ready(jax.jit(fn)(*args))
    finally:
        if old is None:
            os.environ.pop("OFD_PYRAMID", None)
        else:
            os.environ["OFD_PYRAMID"] = old


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("level", [2, 5])
def test_multi_offset_soft_splat_matches_jax(path, level):
    img, _, flow, weights = _inputs()
    want = np.asarray(_jax_path(path, lambda i, f, w: jpyr.multi_offset_soft_splat(
        i, f, w, level), img, flow, weights))
    got = pyr.multi_offset_soft_splat(_nchw(img), _nchw(flow), _nchw(weights), level)
    assert got.shape == (level * level, B, 4, H // level, W // level)
    got = got.numpy().transpose(0, 1, 3, 4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_losses():
    """JAX's loss and its gradients in (img, flow, weights), per (path,
    level), traced once for the module."""
    img, tgt, flow, weights = _inputs(1)
    out = {}
    for path in PATHS:
        for level in (2, 5):
            def loss(i, f, w, level=level):
                return jpyr.photometric_pyramid_loss(i, jnp.asarray(tgt), f, w, (level,))
            v, g = _jax_path(path, jax.value_and_grad(loss, argnums=(0, 1, 2)),
                             img, flow, weights)
            out[path, level] = float(v), [np.asarray(x) for x in g]
    return out


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("level", [2, 5])
def test_pyramid_loss_and_gradients_match_jax(jax_losses, path, level):
    img, tgt, flow, weights = _inputs(1)
    leaves = [_nchw(a).requires_grad_() for a in (img, flow, weights)]
    loss = pyr.photometric_pyramid_loss(leaves[0], _nchw(tgt), leaves[1], leaves[2], (level,))
    loss.backward()
    want, grads = jax_losses[path, level]
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    for name, leaf, g in zip(("img", "flow", "weights"), leaves, grads):
        g = g.transpose(0, 3, 1, 2)
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)


def test_pyramid_loss_over_levels_matches_jax():
    """Several levels at once (the mean over levels of the offset means)."""
    img, tgt, flow, weights = _inputs(2)
    levels = (1, 2, 3, 5)
    want = _jax_path("phase", lambda *a: jpyr.photometric_pyramid_loss(*a, levels),
                     img, tgt, flow, weights)
    got = pyr.photometric_pyramid_loss(*(_nchw(a) for a in (img, tgt, flow, weights)), levels)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_pyramid_offsets_and_levels():
    assert pyr.DEFAULT_LEVELS == jpyr.DEFAULT_LEVELS
    assert sum(L * L for L in pyr.DEFAULT_LEVELS) == 832
    assert pyr.offsets(3) == [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1), (0, 2), (1, 2),
                              (2, 2)]


def test_warp_loss_helpers_match_jax():
    """charbonnier, nan_charbonnier (whole and per leading index),
    fill_holes_nan and edgeaware_smoothness1."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, B, 3, 5, 6)).astype(np.float32)
    b = rng.standard_normal((3, B, 3, 5, 6)).astype(np.float32)
    a[0, 0, 1, 2, 3] = np.nan
    b[1, 1, 0, 0, 0] = np.nan
    np.testing.assert_allclose(pwarp.charbonnier(torch.from_numpy(a[1])).numpy(),
                               np.asarray(jwarp.charbonnier(a[1])), rtol=1e-6)
    np.testing.assert_allclose(float(pwarp.nan_charbonnier(torch.from_numpy(a),
                                                           torch.from_numpy(b))),
                               float(jwarp.nan_charbonnier(a, b)), rtol=1e-6)
    per = pwarp.nan_charbonnier(torch.from_numpy(a), torch.from_numpy(b), dim=(1, 2, 3, 4))
    np.testing.assert_allclose(per.numpy(), np.asarray(jax.vmap(jwarp.nan_charbonnier)(a, b)),
                               rtol=1e-6)
    w = rng.standard_normal((B, 1, 5, 6)).astype(np.float32)
    got = pwarp.fill_holes_nan(torch.from_numpy(a[2]), torch.from_numpy(w)).numpy()
    want = np.asarray(jwarp.fill_holes_nan(a[2].transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), want)
    img = rng.uniform(0, 1, (B, 7, 9, 3)).astype(np.float32)
    flow = rng.standard_normal((B, 7, 9, 2)).astype(np.float32)
    np.testing.assert_allclose(float(pwarp.edgeaware_smoothness1(_nchw(img), _nchw(flow))),
                               float(jwarp.edgeaware_smoothness1(img, flow)), rtol=1e-6)
