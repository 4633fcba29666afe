"""Port vs JAX: the unfused linear attention (kernel rows 7-8) and remat.

The plain versions of the two middle kernels against JAX's Pallas
``_linear_attention_middle_pallas`` in interpret mode (as
tests/test_attention_pallas.py runs it), the composition against
``_linear_attention_middle_xla``, the middle's gradient against
``jax.grad``; ``LinearAttention`` and ``PreNormResidual(LinearAttention)``
against the JAX modules on bridged weights and against the fused
``LinearAttentionBlock``; and the remat option of the training slice.  On
the CPU the middle's wrappers take the kernels' plain versions.  The
kernels themselves are checked on the card by tests/test_torch_port_kernels.py
and chip_smoke.py.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.models import unet as junet
from opticalflowdiffusion_tpu.ops import attention_pallas as jap
from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.algorithms.base import to_batch
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP, FLAGSHIP_DATA
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset
from opticalflowdiffusion_tpu_torch.models import diffusion as dm
from opticalflowdiffusion_tpu_torch.models import unet as punet
from opticalflowdiffusion_tpu_torch.ops import attention_fused as paf
from opticalflowdiffusion_tpu_torch.ops import attention_pallas as pap
from opticalflowdiffusion_tpu_torch.utils import weights

BACKENDS = ("composition", "kernels")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, N):
    return np.random.default_rng(seed).standard_normal((B, N, 384)).astype(np.float32)


# ------------------------------------------------------------ the middle
@pytest.mark.parametrize("B,N", [(2, 1000), (1, 200)])
def test_middle_plain_passes_match_pallas_interpret(B, N):
    """``middle_ctx_plain`` then ``middle_out_plain`` against the two Pallas
    kernels in interpret mode (block_n 256, so N = 1000 pads), f32: the pin of
    tests/test_attention_pallas.py::test_pallas_matches_xla_interpret."""
    qkv = _qkv(0, B, N)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jap._linear_attention_middle_pallas(jnp.asarray(qkv), 4, 32,
                                                              block_n=256))
    t = torch.from_numpy(qkv)
    got = pap.middle_out_plain(t, pap.middle_ctx_plain(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N", [(2, 300), (1, 64)])
def test_middle_composition_matches_xla(B, N, dtype):
    """``linear_attention_middle_plain`` against ``_linear_attention_middle_xla``
    on the same qkv: f32 to 1e-5 of the output's scale (summation order);
    bf16 within 2^-7 of it, one bf16 ulp at the largest value, since both
    round the softmaxes and einsums to bf16 but sum in another order."""
    qkv = _qkv(1, B, N)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jap._linear_attention_middle_xla(jnp.asarray(qkv, jdt), 4, 32)
                      .astype(jnp.float32))
    t = torch.from_numpy(qkv).to(getattr(torch, dtype))
    got = pap.linear_attention_middle_plain(t, 4, 32).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("backend", BACKENDS)
def test_middle_gradient_matches_jax_grad(backend):
    """The gradient of sum(middle^2) through the port's
    ``linear_attention_middle`` (the kernels' Function recomputes the
    composition in its backward) against ``jax.grad`` of JAX's custom-VJP
    middle: the pin of test_custom_vjp_matches_xla_grad."""
    qkv = _qkv(2, 1, 64)
    want = jax.grad(lambda t: jnp.sum(jnp.square(jap.linear_attention_middle(t, 4, 32))))(
        jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_()
    pap.linear_attention_middle(t, 4, 32, backend).square().sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_middle_wrappers_take_plain_versions_on_cpu():
    """On a CPU tensor the wrappers are the plain versions and launch
    nothing; an unknown backend raises."""
    t = torch.from_numpy(_qkv(3, 2, 100))
    before = [k.launches for k in kernels.KERNELS]
    ctx = pap.middle_ctx(t)
    assert torch.equal(ctx, pap.middle_ctx_plain(t))
    assert torch.equal(pap.middle_out(t, ctx), pap.middle_out_plain(t, ctx))
    assert torch.equal(pap.linear_attention_middle(t, backend="kernels"),
                       pap.middle_out_plain(t, ctx))
    assert [k.launches for k in kernels.KERNELS] == before
    with pytest.raises(ValueError):
        pap.linear_attention_middle(t, backend="pallas")
    with pytest.raises(ValueError):
        punet.LinearAttention(16, attn_backend="xla")


# (B, N) of the unfused middle at every block of a 128x128 b8 and a native
# b2 eval (chip_smoke.py's middle_phase), and edge sizes
_MID = [(8, 16384), (8, 4096), (8, 1024), (8, 256), (2, 458752), (2, 114688), (2, 28672),
        (2, 7168), (1, 1), (1, 20), (3, 1001), (16, 64)]


@pytest.mark.parametrize("B,N", _MID)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_middle_ctx_plan_fits(B, N, dtype):
    """Row 7's CTAs per batch element: 1 <= CTAs <= tiles of 128-byte rows
    (64 bf16 or 32 f32 positions), about two CTAs an SM over the batch."""
    ctas = pap.mid_plan(B, N, dtype)
    tiles = -(-N // (64 if dtype == torch.bfloat16 else 32))
    assert 1 <= ctas <= tiles
    assert ctas == tiles or (ctas - 1) * B < 2 * 132 <= ctas * B


def test_middle_ctx_plan_pins():
    assert pap.mid_plan(2, 458752) == 132
    assert pap.mid_plan(8, 256, torch.float32) == 8
    assert pap.mid_plan(8, 256, torch.bfloat16) == 4
    assert pap.mid_plan(8, 16384, torch.bfloat16, sms=100) == 25


@pytest.mark.parametrize("lo,n", [(128, 256), (0, 128)], ids=["kv", "q"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_middle_ctx_reads_kv_in_place_or_from_a_padded_copy(dtype, lo, n):
    """The passes' tensor maps read their rows (pass A the k and v rows,
    pass B the q rows) in place where rows and batch stride are multiples
    of 16 bytes (a (B, 400, N) buffer's view too), else from one zero-padded
    (B, n, ld) copy of those rows."""
    q = 16 // torch.empty((), dtype=dtype).element_size()
    for C, N in ((384, 1000), (400, 1000), (384, 1001), (385, 999), (384, 20), (384, 12810)):
        a = torch.randn(2, C, N).to(dtype)
        u = a[:, :384]
        rows, ld, bs = pap._rows(u, lo, n)
        assert rows.shape == (2, n, ld) and ld % q == 0 and bs % q == 0 and ld - N < q
        assert torch.equal(rows[..., :N], u[:, lo:lo + n]) and not rows[..., N:].any()
        in_place = N % q == 0 and C * N % q == 0
        assert (rows.data_ptr() == u[:, lo:].data_ptr()) == in_place
        assert bs == (C * N if in_place else n * ld)
        assert bs >= n * ld   # the launchers refuse batches that overlap
    one = torch.randn(1, 384, 64).to(dtype)
    assert pap._rows(one, lo, n)[2] == 384 * 64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_middle_out_writes_in_place_or_through_a_padded_buffer(dtype):
    """Pass B's tensor map writes rows of a multiple of 16 bytes: where N
    values make one, its buffer is the contiguous (B, 128, N) output; else
    a (B, 128, ldo) buffer, ldo the next such length, whose first N
    positions the wrapper copies out once."""
    q = 16 // torch.empty((), dtype=dtype).element_size()
    for N in (1, 20, 64, 999, 1000, 1001, 12810, 458752):
        out, ldo = pap._out_rows(3, N, dtype, "cpu")
        assert out.shape == (3, 128, ldo) and out.dtype == dtype and out.is_contiguous()
        assert ldo % q == 0 and N <= ldo < N + q
        assert (ldo == N) == (N % q == 0)


@pytest.mark.parametrize("B,N", _MID)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_middle_out_plan_fits(B, N, dtype):
    """Row 8's CTAs per batch element: 1 <= CTAs <= tiles of 128-byte rows,
    as many as three CTAs an SM hold at once over the batch and no more
    (a CTA past them would wait for a second wave)."""
    ctas = pap.mid_out_plan(B, N, dtype)
    tiles = -(-N // (64 if dtype == torch.bfloat16 else 32))
    assert 1 <= ctas <= tiles
    assert ctas == tiles or ctas * B <= 3 * 132 < (ctas + 1) * B


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_middle_out_plan_pins(dtype):
    """Pass B walks pass A's tiles with three CTAs an SM; where the tiles do
    not divide evenly, some CTAs take one tile fewer than the others (the
    card tests' N = 12810)."""
    tile = 64 if dtype == torch.bfloat16 else 32
    assert pap.mid_out_plan(2, 458752, dtype) == 198
    assert pap.mid_out_plan(8, 16384, dtype) == 49
    assert pap.mid_out_plan(1, 20, dtype) == 1
    assert pap.mid_out_plan(2, tile, dtype) == 1 and pap.mid_out_plan(2, tile + 1, dtype) == 2
    assert pap.mid_out_plan(8, 16384, dtype, sms=100) == 37
    P = pap.mid_out_plan(2, 12810, dtype)
    tiles = -(-12810 // tile)
    per_cta = [(tiles - 1 - p) // P + 1 for p in range(P)]   # the kernel's split
    assert P == min(tiles, 198) and sum(per_cta) == tiles
    assert max(per_cta) - min(per_cta) == 1


@pytest.mark.parametrize("B,N,block_n", [(2, 512, 256), (1, 200, 128)])
def test_middle_out_plain_matches_pallas_out_kernel_interpret(B, N, block_n):
    """``middle_out_plain`` against JAX's pass B alone: a ``pallas_call`` of
    ``_out_kernel`` in interpret mode on the same f32 ctx (per head, laid
    out block-diagonal (128, 128) as JAX's pass A leaves it), q zero-padded
    to a block multiple as ``_linear_attention_middle_pallas`` pads it.
    Both take the softmax over d and the product in f32 in another order:
    1e-5 of the largest sum of the terms' magnitudes (sum_d q' |ctx| / N),
    chip_smoke.py's TOL_MID rule, and 1e-5 of the output's largest value."""
    qkv = _qkv(8, B, N)
    t = torch.from_numpy(qkv)
    ctx = pap.middle_ctx_plain(t)
    bd = np.zeros((B, 128, 128), np.float32)
    for h in range(4):
        bd[:, 32 * h:32 * h + 32, 32 * h:32 * h + 32] = ctx[:, h].numpy()
    Np = -(-N // block_n) * block_n
    q = np.pad(qkv[..., :128], ((0, 0), (0, Np - N), (0, 0)))
    sel = jap._head_selector(4, 32)
    lsel = jnp.where((jnp.arange(128) % 32 == 0)[:, None], sel, 0.0)
    spec = lambda shape, index: pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            functools.partial(jap._out_kernel, dim=32, n_total=N),
            grid=(B, Np // block_n),
            in_specs=[spec((1, block_n, 128), lambda b, n: (b, n, 0)),
                      spec((1, 128, 128), lambda b, n: (b, 0, 0)),
                      spec((128, 4), lambda b, n: (0, 0)),
                      spec((128, 4), lambda b, n: (0, 0))],
            out_specs=spec((1, block_n, 128), lambda b, n: (b, n, 0)),
            out_shape=jax.ShapeDtypeStruct((B, Np, 128), jnp.float32),
        )(jnp.asarray(q), jnp.asarray(bd), sel, lsel))[:, :N]
    got = pap.middle_out_plain(t, ctx).numpy()
    mass = float(pap.middle_out_plain(t, ctx.abs()).max())
    assert np.abs(got - want).max() <= 1e-5 * mass
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_fused_module_keeps_the_middle_under_its_old_name():
    assert paf.linear_attention_middle is pap.linear_attention_middle_plain


# ------------------------------------------------------------ the modules
def _module_pair(prenorm, C, backend, dtype, seed):
    """(port module, JAX module, JAX params) with the JAX params drawn from
    the port's seeded weights through the bridge's rows."""
    inner = punet.LinearAttention(C, dtype=dtype, attn_backend=backend)
    mod = punet.PreNormResidual(C, inner, dtype) if prenorm else inner
    punet.init_weights(mod, torch.Generator().manual_seed(seed))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jinner = junet.LinearAttention(dtype=jdt)
    jmod = junet.PreNormResidual(jinner, dtype=jdt) if prenorm else jinner
    x0 = jnp.zeros((1, 4, 4, C), jnp.float32)
    template = jmod.init(jax.random.PRNGKey(0), x0)["params"]
    rows = weights.linear_attention_rows(prenorm)
    tree = weights.to_jax(mod.state_dict(), template, rows)
    return mod, jmod, tree


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("prenorm", [False, True], ids=["LinearAttention", "PreNormResidual"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_matches_jax(prenorm, backend, dtype):
    """``LinearAttention`` and ``PreNormResidual(LinearAttention)`` against
    the JAX modules on bridged weights, NCHW against NHWC: f32 to 1e-5 of
    the output's scale (summation order); bf16 within 5% max and 1% mean
    of it, the UNet tests' bf16 pin (the frameworks round bf16 at other
    places, and the kernels' plain versions keep the middle in f32)."""
    tdt = getattr(torch, dtype)
    B, C, H, W = 2, 32, 6, 10
    mod, jmod, tree = _module_pair(prenorm, C, backend, tdt, 3)
    x = np.random.default_rng(4).standard_normal((B, H, W, C)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 1e-5 * scale
    else:
        assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("C,H,W", [(32, 6, 10), (64, 4, 4)])
def test_prenorm_linear_attention_equals_the_fused_block(backend, C, H, W):
    """``PreNormResidual(LinearAttention)`` loaded with a
    ``LinearAttentionBlock``'s state_dict computes the block (f32, 1e-5 of
    the residual branch's scale; the keys are the same)."""
    blk = punet.LinearAttentionBlock(C)
    punet.init_weights(blk, torch.Generator().manual_seed(5))
    mod = punet.PreNormResidual(C, punet.LinearAttention(C, attn_backend=backend))
    mod.load_state_dict(blk.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, C, H, W))
                         .astype(np.float32))
    with torch.no_grad():
        a, b = mod(x), blk(x)
    assert float((a - b).abs().max()) <= 1e-5 * float((b - x).abs().max())


@pytest.mark.parametrize("prenorm", [False, True], ids=["LinearAttention", "PreNormResidual"])
def test_linear_attention_weight_round_trip(prenorm):
    """JAX params -> state_dict -> JAX params gives the same leaves, and
    the state_dict loads into the port's module as it is."""
    C = 16
    jmod = junet.PreNormResidual(junet.LinearAttention()) if prenorm else junet.LinearAttention()
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(7), jnp.zeros((1, 4, 4, C)))["params"])
    rows = weights.linear_attention_rows(prenorm)
    sd = weights.from_jax(params, rows)
    mod = punet.LinearAttention(C)
    mod = punet.PreNormResidual(C, mod) if prenorm else mod
    assert sorted(sd) == sorted(mod.state_dict())
    mod.load_state_dict(sd)
    back = weights.to_jax(mod.state_dict(), params, rows)
    flat = jax.tree_util.tree_leaves_with_path
    want = {jax.tree_util.keystr(k): v for k, v in flat(params)}
    got = {jax.tree_util.keystr(k): v for k, v in flat(back)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ remat
S = 16


def _algo(remat):
    cfg = dataclasses.replace(FLAGSHIP, image_size=S, unet_dim=8, precision="float32",
                              timesteps=20, zero_init=False, remat=remat)
    return FlowDiffuser(cfg, device="cpu", generator=torch.Generator().manual_seed(6))


def test_remat_gives_the_same_gradients():
    """``p_losses`` and its gradient in every parameter with the UnetWithWarp
    closure rematerialised (``torch.utils.checkpoint``) against the same
    without: the recompute repeats the same f32 operations, so 1e-6 of each
    leaf's largest value."""
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, seed=5, size=64))
    out = []
    for remat in (False, True):
        algo = _algo(remat)
        tgt_x, cond, _ = algo.preprocess(to_batch([data[i] for i in range(3)], "cpu"))
        noise = torch.from_numpy(np.random.default_rng(0).standard_normal(
            tuple(tgt_x.shape)).astype(np.float32))
        loss = dm.p_losses(algo.sched, algo.model_fn, tgt_x, torch.tensor([1, 7, 19]), noise,
                           external_cond=cond, warp_fn=algo.warp_fn)
        loss.backward()
        out.append((float(loss.detach()), {k: p.grad.clone()
                                           for k, p in algo.module.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert g0.keys() == g1.keys()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-6 * float(g0[k].abs().max()))


def test_remat_config_follows_jax_compose():
    """``FlowDiffuserConfig.remat`` defaults to JAX's composed
    ``runtime.remat``, which JAX's experiment copies into ``_remat``."""
    cfg = compose(["experiment=matrix_flow", "algorithm=flow_diffuser", "dataset=artificial"])
    assert FLAGSHIP.remat is bool(cfg.runtime.remat) is False
    cfg = compose(["experiment=matrix_flow", "algorithm=flow_diffuser", "dataset=artificial",
                   "runtime.remat=true"])
    assert bool(cfg.runtime.remat) is True
    assert train_entry.build(1, device="cpu", image_size=S, unet_dim=8, remat=True,
                             out="unused").algorithm.cfg.remat is True


def test_train_entry_point_with_remat_on_cpu(tmp_path, capsys):
    """``train.py --remat`` on the CPU: two steps, a validation and a
    checkpoint, with the closure rematerialised."""
    train_entry.main(["--device", "cpu", "--image-size", str(S), "--unet-dim", "8",
                      "--batch", "4", "--val-batch", "2", "--sampling-timesteps", "2",
                      "--out", str(tmp_path), "--steps", "2", "--remat"])
    out = json.loads(capsys.readouterr().out)
    assert out["remat"] is True and out["step"] == 2 and out["checkpoints"] == [2]
    assert np.isfinite(out["train"]["train/loss"]) and "val/epe" in out["val"]
