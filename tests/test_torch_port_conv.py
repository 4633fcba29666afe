"""Port vs JAX for the UNet's opt-in conv backends (``ops/conv.py`` against
JAX ``ops/conv_pallas.py``): the plain versions of the two conv kernels
against the Pallas kernels in interpret mode, the routing against JAX's
feasibility predicates at the flagship's shapes, the custom gradients
against ``jax.vjp``.  The UNet under ``fold`` and ``rows`` is held against
JAX's in ``test_torch_port_conv_unet.py``, and the FlowDiffuser loss and
gradients under ``fold`` in ``test_torch_port_conv_train.py`` (each traces
the JAX package's Pallas kernels in interpret mode, tens of seconds, so
they are files of their own that test workers run side by side).  Inputs
come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opticalflowdiffusion_tpu.ops import conv_pallas as cp
from opticalflowdiffusion_tpu_torch.models import unet as unet_mod
from opticalflowdiffusion_tpu_torch.models.unet import Unet, init_weights
from opticalflowdiffusion_tpu_torch.ops import attention_fused as paf
from opticalflowdiffusion_tpu_torch.ops import conv as pconv

# JAX's name for each port backend
JAX_BACKEND = {"rows": "pallas", "fold": "fold"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def _conv_data(seed, B, H, W, C, Cout, kh, kw, affine=False):
    """NHWC x, HWIO kernel and (B, C) affine vectors as the JAX conv tests
    draw them (the bias at +1 so that silu(b) is far from 0 at the border)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    k = (rng.standard_normal((kh, kw, C, Cout)) * 0.1).astype(np.float32)
    if not affine:
        return x, k
    a = (rng.standard_normal((B, C)) * 0.5 + 1.0).astype(np.float32)
    b = (rng.standard_normal((B, C)) * 0.3 + 1.0).astype(np.float32)
    return x, k, a, b


# ------------------------------------------- plain versions vs the kernels
@pytest.mark.parametrize("B,H,W,C,Cout,kh,kw", [
    (2, 16, 32, 64, 64, 3, 3), (1, 8, 16, 9, 64, 7, 7), (2, 8, 16, 128, 128, 3, 3),
    (1, 32, 16, 3, 8, 5, 5),
])
def test_plain_conv_matches_jax_row_kernel(B, H, W, C, Cout, kh, kw):
    """conv2d_same_plain (row 9's plain version) against JAX ``_conv_pallas``
    in interpret mode, f32, at the JAX tests' shapes and tolerance."""
    x, k = _conv_data(0, B, H, W, C, Cout, kh, kw)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(cp._conv_pallas(jnp.asarray(x), jnp.asarray(k),
                                          compute_dtype=jnp.float32))
    got = _nhwc(pconv.conv2d_same_plain(_nchw(x), _oihw(k)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,H,W,C,Cout,kh,kw", [
    (2, 16, 32, 64, 64, 3, 3), (1, 8, 16, 9, 64, 7, 7), (2, 8, 16, 128, 128, 3, 3),
    (1, 32, 16, 3, 8, 5, 5), (1, 8, 24, 64, 128, 3, 3), (1, 6, 32, 16, 16, 3, 3),
])
def test_plain_conv_matches_jax_fold_kernel(B, H, W, C, Cout, kh, kw):
    """conv2d_same_plain (row 10's plain version, prologue off) against JAX
    ``_conv_fold`` in interpret mode, f32."""
    x, k = _conv_data(1, B, H, W, C, Cout, kh, kw)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(cp._conv_fold(jnp.asarray(x), jnp.asarray(k),
                                        compute_dtype=jnp.float32))
    got = _nhwc(pconv.conv2d_same_plain(_nchw(x), _oihw(k)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,H,W,C,Cout", [(2, 16, 32, 64, 64), (1, 8, 24, 16, 32),
                                          (2, 6, 16, 128, 64)])
def test_gn_conv_plain_matches_jax_fold_prologue(B, H, W, C, Cout):
    """conv2d_same_gn_plain (row 10's plain version with its prologue)
    against JAX ``_conv_fold`` with the in-kernel silu(x * a + b), f32: the
    first and last rows and columns too, where the zero padding must stay
    zero after the transform."""
    x, k, a, b = _conv_data(2, B, H, W, C, Cout, 3, 3, affine=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(cp._conv_fold(jnp.asarray(x), jnp.asarray(k),
                                        compute_dtype=jnp.float32, in_scale=jnp.asarray(a),
                                        in_bias=jnp.asarray(b), silu=True))
    got = _nhwc(pconv.conv2d_same_gn_plain(_nchw(x), _oihw(k), torch.from_numpy(a),
                                           torch.from_numpy(b)))
    for sl in (np.s_[:, [0, -1]], np.s_[:, :, [0, -1]]):
        np.testing.assert_allclose(got[sl], want[sl], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the border is where a transformed zero padding would show
    z = pconv.conv2d_same_plain(torch.nn.functional.silu(
        _nchw(x) * torch.from_numpy(a)[:, :, None, None] + torch.from_numpy(b)[:, :, None, None]
    ), _oihw(k))
    assert np.abs(_nhwc(z) - want).max() < 1e-3


# ------------------------------------------------------------------ routing
class _Recorder:
    """Replaces the kernel wrappers, the gn plain version and the 1x1 matmul
    of ``ops/conv.py`` with recorders that call the plain versions."""

    def __init__(self, monkeypatch):
        self.calls = []
        plain, gn_plain, dot = pconv.conv2d_same_plain, pconv.conv2d_same_gn_plain, pconv.dot_1x1

        def kernel(name):
            def fn(x, w, a=None, b=None):
                self.calls.append((name, tuple(x.shape), tuple(w.shape), a is not None))
                return plain(x, w) if a is None else gn_plain(x, w, a, b)
            return fn

        def gn(x, w, a, b):
            self.calls.append(("gn_plain", tuple(x.shape), tuple(w.shape), True))
            return gn_plain(x, w, a, b)

        def dot_(x, w):
            self.calls.append(("dot", tuple(x.shape), tuple(w.shape), False))
            return dot(x, w)

        monkeypatch.setattr(pconv, "conv_rows", kernel("conv_rows"))
        monkeypatch.setattr(pconv, "conv_fold", kernel("conv_fold"))
        monkeypatch.setattr(pconv, "conv2d_same_gn_plain", gn)
        monkeypatch.setattr(pconv, "dot_1x1", dot_)

    def of(self, name):
        return [c for c in self.calls if c[0] == name]


def _flagship_convs_on_meta(monkeypatch, backend, H, W, B=2):
    """One forward and backward of the flagship UNet (width 64, the
    UnetWithWarp's 9 input channels) on the meta device: shapes only (the
    linear-attention blocks through their plain composition)."""
    monkeypatch.setattr(unet_mod, "fused_linear_attention_block", paf.block_plain)
    with torch.device("meta"):
        net = Unet(64, out_dim=2, channels=9, dtype=torch.bfloat16, conv_backend=backend)
        x = torch.empty(B, 6, H, W)
        cond = torch.empty(B, 3, H, W)
        t = torch.zeros(B, dtype=torch.long)
    net(x, cond, t).sum().backward()


def _jax_accepts(kernel_name, x_shape, w_shape, monkeypatch):
    """JAX's predicate for the conv that the port routes to ``kernel_name``:
    NCHW / OIHW shapes as NHWC / HWIO."""
    B, C, H, W = x_shape
    Cout, Cin, kh, kw = w_shape
    xs = jax.ShapeDtypeStruct((B, H, W, C), jnp.bfloat16)
    ks = jax.ShapeDtypeStruct((kh, kw, Cin, Cout), jnp.bfloat16)
    if kernel_name == "conv_fold":
        return cp._use_fold(xs, ks)
    monkeypatch.setenv("OFD_CONV_BACKEND", "pallas")
    return cp._use_pallas(xs, ks)


@pytest.mark.parametrize("backend", ["rows", "fold"])
@pytest.mark.parametrize("H,W", [(128, 128), (448, 1024)])
def test_jax_predicates_accept_every_routed_conv(monkeypatch, backend, H, W):
    """Every conv that the port sends to a kernel in a forward and backward
    of the flagship UNet is one that JAX's ``_use_fold`` (fold) or
    ``_use_pallas`` under ``OFD_CONV_BACKEND=pallas`` (rows) takes to its
    Pallas kernel, so the port needs no fallback.  And the counts per eval
    that chip_smoke.py asserts: 44 spatial convs forward (19 with the
    prologue under fold; under rows those 19 go to cuDNN), 43 dgrads (the
    stem's input needs none); every 1x1 is a matmul."""
    rec = _Recorder(monkeypatch)
    _flagship_convs_on_meta(monkeypatch, backend, H, W)
    name = "conv_" + backend
    routed = rec.of(name)
    n_gn = 19
    forward = 44 - (n_gn if backend == "rows" else 0)
    assert len(routed) == forward + 43
    assert sum(c[3] for c in routed) == (n_gn if backend == "fold" else 0)
    assert len(rec.of("gn_plain")) == (n_gn if backend == "rows" else 0)
    assert len(rec.calls) == len(routed) + len(rec.of("gn_plain")) + len(rec.of("dot"))
    assert all(c[2][2:] == (1, 1) for c in rec.of("dot")) and rec.of("dot")
    assert all(c[2][2:] != (1, 1) for c in routed)
    for _, xs, ws, _ in set(routed):
        assert _jax_accepts(name, xs, ws, monkeypatch), (xs, ws)


def test_cudnn_backend_routes_nothing_to_the_kernels(monkeypatch):
    rec = _Recorder(monkeypatch)
    _flagship_convs_on_meta(monkeypatch, "cudnn", 64, 64)
    assert rec.calls == []


@pytest.mark.parametrize("backend", ["rows", "fold"])
def test_1x1_routes_as_dot_like_jax(monkeypatch, backend):
    """A 1x1 conv under rows/fold is a matmul, as JAX's ``OFD_1X1``
    defaults to ``dot`` there, with and without the affine; under cudnn it
    stays a convolution (JAX's default XLA lowering), with the same result."""
    x, k, a, b = _conv_data(3, 2, 8, 8, 16, 32, 1, 1, affine=True)
    monkeypatch.setenv("OFD_CONV_BACKEND", JAX_BACKEND[backend])
    want = np.asarray(cp.conv2d_same(jnp.asarray(x), jnp.asarray(k)))
    want_aff = np.asarray(cp.conv2d_same(jnp.asarray(x), jnp.asarray(k),
                                         in_affine=(jnp.asarray(a), jnp.asarray(b))))
    rec = _Recorder(monkeypatch)
    got = pconv.conv2d_same(_nchw(x), _oihw(k), backend)
    got_aff = pconv.conv2d_same(_nchw(x), _oihw(k), backend,
                                in_affine=(torch.from_numpy(a), torch.from_numpy(b)))
    assert [c[0] for c in rec.calls] == ["dot", "dot"]
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_nhwc(got_aff), want_aff, rtol=1e-5, atol=1e-5)
    conv = pconv.conv2d_same(_nchw(x), _oihw(k), "cudnn")
    assert [c[0] for c in rec.calls] == ["dot", "dot"]
    np.testing.assert_allclose(_nhwc(conv), want, rtol=1e-5, atol=1e-5)


def test_conv2d_same_refuses_unknown_options():
    x, w = torch.zeros(1, 4, 8, 8), torch.zeros(4, 4, 3, 3)
    with pytest.raises(ValueError):
        pconv.conv2d_same(x, w, "pallas")
    with pytest.raises(ValueError):
        pconv.conv2d_same(x, torch.zeros(4, 4, 2, 2), "fold")
    with pytest.raises(ValueError):
        Unet(8, out_dim=2, channels=9, conv_backend="xla")


# ---------------------------------------------------------------- gradients
def _rel_close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("backend", ["rows", "fold"])
def test_conv_same_vjp_matches_jax(monkeypatch, backend):
    """``_ConvSame`` (dx through the backend's kernel, dk by cuDNN's weight
    gradient) against ``jax.vjp`` of ``_conv_same`` under the same backend
    (the Pallas kernels in interpret mode), f32, 1e-5 of each gradient's
    largest value."""
    monkeypatch.setenv("OFD_CONV_BACKEND", JAX_BACKEND[backend])
    x, k = _conv_data(4, 2, 8, 16, 16, 32, 3, 3)
    g = np.random.default_rng(5).standard_normal((2, 8, 16, 32)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(cp._conv_same, jnp.asarray(x), jnp.asarray(k))
        dx, dk = vjp(jnp.asarray(g))
    xt, kt = _nchw(x).requires_grad_(), _oihw(k).requires_grad_()
    yt = pconv._ConvSame.apply(xt, kt, backend)
    yt.backward(_nchw(g))
    _rel_close(_nhwc(yt), y)
    _rel_close(_nhwc(xt.grad), dx)
    _rel_close(kt.grad.permute(2, 3, 1, 0).numpy(), dk)


@pytest.mark.parametrize("backend", ["rows", "fold"])
def test_conv_same_gn_vjp_matches_jax(monkeypatch, backend):
    """``_ConvSameGN`` against ``jax.vjp`` of ``_conv_same_gn``: dx, dk, da
    and db, f32, 1e-5 of each gradient's largest value."""
    monkeypatch.setenv("OFD_CONV_BACKEND", JAX_BACKEND[backend])
    x, k, a, b = _conv_data(6, 2, 8, 16, 16, 32, 3, 3, affine=True)
    g = np.random.default_rng(7).standard_normal((2, 8, 16, 32)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(cp._conv_same_gn, *(jnp.asarray(v) for v in (x, k, a, b)))
        dx, dk, da, db = vjp(jnp.asarray(g))
    leaves = [_nchw(x), _oihw(k), torch.from_numpy(a), torch.from_numpy(b)]
    for t in leaves:
        t.requires_grad_()
    yt = pconv._ConvSameGN.apply(*leaves, backend)
    yt.backward(_nchw(g))
    _rel_close(_nhwc(yt), y)
    _rel_close(_nhwc(leaves[0].grad), dx)
    _rel_close(leaves[1].grad.permute(2, 3, 1, 0).numpy(), dk)
    _rel_close(leaves[2].grad.numpy(), da)
    _rel_close(leaves[3].grad.numpy(), db)


def test_stem_dgrad_is_skipped(monkeypatch):
    """No dgrad for an input that needs no gradient (the UNet's stem)."""
    rec = _Recorder(monkeypatch)
    x, k = _conv_data(8, 1, 8, 8, 9, 16, 7, 7)
    kt = _oihw(k).requires_grad_()
    pconv.conv2d_same(_nchw(x), kt, "fold").sum().backward()
    assert [c[0] for c in rec.calls] == ["conv_fold"] and kt.grad is not None


# -------------------------------------------------------------------- UNet
def test_fused_and_unfused_blocks_differ_only_by_rounding():
    """The defer-norm Block of the fold backend changes where bf16 rounds,
    not what is computed: in f32 the fold UNet (fused Blocks, 1x1 as matmul)
    and the cudnn UNet (unfused) agree to f32 rounding."""
    net = init_weights(Unet(8, out_dim=2, channels=9, conv_backend="fold"),
                       torch.Generator().manual_seed(2))
    ref = Unet(8, out_dim=2, channels=9, conv_backend="cudnn")
    assert net.mid_block1.fuse_gn and not ref.mid_block1.fuse_gn
    ref.load_state_dict(net.state_dict())
    g = torch.Generator().manual_seed(3)
    x, cond = torch.randn(2, 6, 16, 16, generator=g), torch.randn(2, 3, 16, 16, generator=g)
    t = torch.tensor([5, 11])
    with torch.no_grad():
        a, b = net(x, cond, t), ref(x, cond, t)
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
