"""Port vs JAX for PWC's modules (``ops/correlation.py``, the resizes of
``ops/warp.py``, ``algorithms/losses.py``, ``models/pwc_net.py``,
``utils/weights.py``'s PWCNet table), float32, on the same numpy-seeded
inputs: the 9x9 cost volume and its reorder (sizes below the patch and odd
ones, forward and ``jax.grad``), ``jax.image.resize``'s bilinear (down:
antialiased; up) and nearest at integer and other ratios, every loss, the
feature block at even and odd sides (flax's stride-2 ``SAME`` padding),
and PWCNet at 64x64 and 61x125 b2 from JAX's weights: all five output
lists.  (JAX's PWCNet runs only where each pyramid level halves exactly: at
72x88 both raise.)  Values to 1e-5 of the reference's largest value,
gradients to 1e-4 of each leaf's largest value.  The kernels' own tests
are in ``test_torch_port_correlation.py`` (no JAX, so they run on the
card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms import losses as jlosses
from opticalflowdiffusion_tpu.models import pwc_net as jpwc
from opticalflowdiffusion_tpu.ops import correlation as jcorr
from opticalflowdiffusion_tpu.ops import warp as jwarp
from opticalflowdiffusion_tpu_torch.algorithms import losses as plosses
from opticalflowdiffusion_tpu_torch.models import pwc_net as ppwc
from opticalflowdiffusion_tpu_torch.ops import correlation as pcorr
from opticalflowdiffusion_tpu_torch.ops import warp as pwarp
from opticalflowdiffusion_tpu_torch.utils.weights import pwc_jax_layout, pwc_rows, pwc_state_dict

RTOL = 1e-5        # f32 values, of the reference's largest |value|
GTOL = 1e-4        # gradients, of each leaf's largest |value|


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_f32_products():
    """JAX's products in full float32, as the port's on the CPU."""
    with jax.default_matmul_precision("highest"):
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _close(got, want, tol=RTOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (msg, np.abs(got - want).max(), scale)


# ----------------------------------------------------------- correlation
CORR_SIZES = ((1, 3, 5, 4), (2, 4, 8, 8), (2, 5, 9, 13), (1, 6, 11, 7), (2, 8, 16, 12))


@pytest.mark.parametrize("shape", CORR_SIZES)
@pytest.mark.parametrize("direction", (None, "fwd", "bwd"))
def test_local_correlation_and_grads_match_jax(shape, direction):
    """The cost volume (reordered per direction) and both cotangents of
    <volume, g>, at sides below the patch (5, 4) and odd ones."""
    B, C, H, W = shape
    rng = np.random.default_rng(sum(shape))
    a, b = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((B, H, W, 81)).astype(np.float32)

    def jfn(x, y):
        c = jcorr.local_correlation(x, y)
        return c if direction is None else jcorr.pwc_index_reorder(c, direction)

    want = jfn(jnp.asarray(a), jnp.asarray(b))
    ja, jb = jax.grad(lambda x, y: jnp.sum(jfn(x, y) * g), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = _nchw(a).requires_grad_(), _nchw(b).requires_grad_()
    got = pcorr.local_correlation(ta, tb, direction)
    got.backward(_nchw(g))
    _close(_nhwc(got), want, msg="volume")
    _close(_nhwc(ta.grad), ja, GTOL, "grad a")
    _close(_nhwc(tb.grad), jb, GTOL, "grad b")


@pytest.mark.parametrize("direction", ("fwd", "bwd"))
def test_reorder_matches_jax_and_the_kernel_formula(direction):
    """pwc_index_reorder equals JAX's; ``reorder_index`` is the inverse of
    the channel the CUDA kernel writes displacement (i, j) to
    (``kernels/correlation.cu::channel``)."""
    rng = np.random.default_rng(0)
    c = rng.standard_normal((2, 3, 4, 81)).astype(np.float32)
    want = jcorr.pwc_index_reorder(jnp.asarray(c), direction)
    np.testing.assert_array_equal(_nhwc(pcorr.pwc_index_reorder(_nchw(c), direction)), want)
    idx = pcorr.reorder_index(direction)
    for i in range(9):
        for j in range(9):
            p = (8 - j) * 9 + (8 - i) if direction == "fwd" else j * 9 + i
            assert idx[p] == i * 9 + j
    assert (pcorr.reorder_index(None) == np.arange(81)).all()
    with pytest.raises(ValueError, match="direction"):
        pcorr.reorder_index("up")


# ----------------------------------------------------------------- resize
RESIZES = (((16, 24), (3, 5)), ((16, 24), (8, 12)), ((61, 125), (30, 62)), ((36, 44), (9, 11)),
           ((7, 9), (14, 18)), ((9, 5), (36, 20)), ((10, 6), (7, 13)), ((5, 3), (1, 1)))


@pytest.mark.parametrize("sizes", RESIZES)
@pytest.mark.parametrize("method", ("bilinear", "nearest"))
def test_resize_matches_jax_image_resize(sizes, method):
    """Down (antialiased in JAX and the port), up and mixed, at integer and
    other ratios."""
    (h, w), (H, W) = sizes
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 3)).astype(np.float32)
    want = jax.image.resize(x, (2, H, W, 3), method=method)
    _close(_nhwc(pwarp.resize(_nchw(x), (H, W), method)), want)


def test_resize_gradient_and_upsample_match_jax():
    """The bilinear downsample's gradient (the flows' path) and JAX's
    ``upsample_bilinear`` (``int(H * factor)``)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 15, 31, 2)).astype(np.float32)
    g = rng.standard_normal((2, 7, 15, 2)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax.image.resize(v, (2, 7, 15, 2), "bilinear") * g))(
        jnp.asarray(x))
    t = _nchw(x).requires_grad_()
    pwarp.resize(t, (7, 15)).backward(_nchw(g))
    _close(_nhwc(t.grad), want, GTOL)
    for factor in (2, 1.5):
        _close(_nhwc(pwarp.upsample_bilinear(_nchw(x), factor)),
               jwarp.upsample_bilinear(jnp.asarray(x), factor))
    with pytest.raises(ValueError, match="method"):
        pwarp.resize(_nchw(x), (3, 3), "cubic")


# ----------------------------------------------------------------- losses
def _loss_inputs(seed=0, B=2, H=11, W=13):
    rng = np.random.default_rng(seed)
    img = lambda: rng.random((B, H, W, 3)).astype(np.float32)
    flow = lambda: rng.normal(0, 2, (B, H, W, 2)).astype(np.float32)
    occ = rng.random((B, H, W, 2)).astype(np.float32)
    return img(), img(), img(), flow(), flow(), occ / occ.sum(-1, keepdims=True)


LOSSES = {
    "photometric_loss": lambda m, r, pw, fw, pf, ff, o: m.photometric_loss(r, pw, fw, o),
    "constant_velocity_loss": lambda m, r, pw, fw, pf, ff, o: m.constant_velocity_loss(pf, ff),
    "edgeaware_smoothness1": lambda m, r, pw, fw, pf, ff, o: m.edgeaware_smoothness1(r, ff),
    "occlusion_smoothness": lambda m, r, pw, fw, pf, ff, o: m.occlusion_smoothness(r, o),
    "occlusion_prior": lambda m, r, pw, fw, pf, ff, o: m.occlusion_prior(o),
    "min_per_pixel_loss": lambda m, r, pw, fw, pf, ff, o: m.min_per_pixel_loss(r, pw, fw),
    "total_loss": lambda m, r, pw, fw, pf, ff, o: m.total_loss(r, pw, fw, pf, ff, o),
    "total_loss_weighted": lambda m, r, pw, fw, pf, ff, o: m.total_loss(
        r, pw, fw, pf, ff, o, smoothness_weight=0.1, occ_weight=0.01),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    """Each loss of the library (sum-reduced as JAX's; edge weight 20)."""
    arrays = _loss_inputs()
    want = float(LOSSES[name](jlosses, *map(jnp.asarray, arrays)))
    got = float(LOSSES[name](plosses, *map(_nchw, arrays)))
    assert abs(got - want) <= RTOL * abs(want), (got, want)


# ------------------------------------------------------------ PWC modules
@pytest.mark.parametrize("size", (12, 13, 1, 2))
@pytest.mark.parametrize("stride", (1, 2))
def test_same_pads_are_lax(size, stride):
    """lax's SAME padding: (0, 1) at stride 2 on an even side, (1, 1) on an
    odd one, (1, 1) at stride 1."""
    from jax import lax

    assert ppwc.same_pads(size, stride) == tuple(
        lax.padtype_to_pads((size,), (3,), (stride,), "SAME")[0])


def _conv_sd(tree, prefix):
    return {f"{prefix}convs.{j}.{n}": torch.from_numpy(np.array(
        np.asarray(tree[f"Conv_{j}"][k]).transpose(3, 2, 0, 1) if k == "kernel"
        else np.asarray(tree[f"Conv_{j}"][k])))
        for j in range(len(tree)) for k, n in (("kernel", "weight"), ("bias", "bias"))}


@pytest.mark.parametrize("hw", ((16, 24), (13, 9), (7, 11)))
def test_conv_feat_block_matches_jax(hw):
    """ConvFeatBlock (stride 2, then 1) at an even and odd sides, and its
    gradients."""
    H, W = hw
    x = np.random.default_rng(H).standard_normal((2, H, W, 5)).astype(np.float32)
    jm = jpwc.ConvFeatBlock(8)
    params = jm.init(jax.random.PRNGKey(H), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    jg = jax.grad(lambda v: jnp.sum(jm.apply({"params": params}, v) ** 2))(jnp.asarray(x))
    pm = ppwc.ConvFeatBlock(5, 8)
    pm.load_state_dict(_conv_sd(params, ""))
    t = _nchw(x).requires_grad_()
    out = pm(t)
    (out ** 2).sum().backward()
    assert out.shape[-2:] == (-(-H // 2), -(-W // 2))
    _close(_nhwc(out), want)
    _close(_nhwc(t.grad), jg, GTOL)


def test_backward_warp_border_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12, 4)).astype(np.float32)
    flow = rng.normal(0, 4, (2, 9, 12, 2)).astype(np.float32)
    want = jpwc.backward_warp_border(jnp.asarray(x), jnp.asarray(flow))
    _close(_nhwc(ppwc.backward_warp_border(_nchw(x), _nchw(flow))), want)


@pytest.fixture(scope="module", params=((64, 64), (61, 125)), ids=("64x64", "61x125"))
def pwc_pair(request):
    """(JAX outputs, port outputs, params) of PWCNet at b2 from JAX's
    initial weights on three random frames."""
    H, W = request.param
    rng = np.random.default_rng(H + W)
    f1, f2, f3 = (rng.random((2, H, W, 3)).astype(np.float32) for _ in range(3))
    jm = jpwc.PWCNet()
    params = jax.jit(lambda a, b, c: jm.init(jax.random.PRNGKey(1), a, [b, c]))(f2, f1, f3)[
        "params"]
    want = jax.jit(lambda p, a, b, c: jm.apply({"params": p}, a, [b, c]))(params, f2, f1, f3)
    net = ppwc.PWCNet()
    net.load_state_dict(pwc_state_dict(jax.device_get(params)))
    with torch.no_grad():
        got = net(_nchw(f2), [_nchw(f1), _nchw(f3)])
    return want, got, params


@pytest.mark.parametrize("which", range(5), ids=("flow_fwd", "flow_bwd", "occ", "warped",
                                                 "tar_ds"))
def test_pwcnet_matches_jax(pwc_pair, which):
    """Each of the five per-level lists (flows, occlusions, warped frames,
    image pyramid), every level."""
    want, got, _ = pwc_pair
    assert len(got[which]) == len(want[which]) == 5
    for lv, (w, g) in enumerate(zip(want[which], got[which])):
        pairs = zip(w, g) if which == 3 else [(w, g)]
        for w_, g_ in pairs:
            _close(_nhwc(g_), w_, msg=f"level {lv}")


def test_pwc_weight_table_both_ways(pwc_pair):
    """Every leaf of JAX's PWCNet tree maps to one port key and back."""
    _, _, params = pwc_pair
    params = jax.device_get(params)
    sd = pwc_state_dict(params)
    assert set(sd) == set(ppwc.PWCNet().state_dict())
    assert len(pwc_rows()) == len(jax.tree_util.tree_leaves(params)) == len(sd)
    back = pwc_jax_layout(sd, params)
    for (path, leaf), (_, want) in zip(jax.tree_util.tree_leaves_with_path(back),
                                       jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(leaf, np.asarray(want), err_msg=str(path))


def test_pwcnet_sizes_that_do_not_halve_raise():
    """JAX's module fails on 72x88 (a level of 3 meets an upsampled 4); the
    port says why."""
    x = jnp.zeros((1, 72, 88, 3))
    with pytest.raises(Exception):
        jax.eval_shape(lambda: jpwc.PWCNet().init(jax.random.PRNGKey(0), x, [x, x]))
    t = torch.zeros(1, 3, 72, 88)
    with pytest.raises(ValueError, match="halves exactly"):
        ppwc.PWCNet()(t, [t, t])
    ppwc.check_size(448, 1024)
    ppwc.check_size(61, 125)
