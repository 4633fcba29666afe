"""Port vs JAX: the fused linear-attention block.

The port's ``block_plain`` (and the plain versions of the two kernel
passes) are held against the JAX composition ``_block_xla`` and against the
Pallas pipeline ``_fused_block_pallas`` run in interpret mode (as
tests/test_attention_pallas.py runs it).  The port takes x as (B, C, N) and
torch-layout weights; JAX takes (B, N, C).  The kernels themselves are
checked on the card by tests/test_torch_port_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opticalflowdiffusion_tpu.ops import attention_fused as af
from opticalflowdiffusion_tpu_torch.ops import attention_fused as paf


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, N, C, hd=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    p = (
        (rng.standard_normal(C) * 0.1 + 1.0).astype(np.float32),        # g_pre
        (rng.standard_normal((C, 3 * hd)) / np.sqrt(C)).astype(np.float32),
        (rng.standard_normal((hd, C)) / np.sqrt(hd)).astype(np.float32),
        (rng.standard_normal(C) * 0.01).astype(np.float32),             # b_out
        (rng.standard_normal(C) * 0.1 + 1.0).astype(np.float32),        # g_post
    )
    return x, p


def _port_args(x, p):
    g_pre, w_qkv, w_out, b_out, g_post = (torch.from_numpy(a) for a in p)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    return xt, (g_pre, w_qkv.t().contiguous(), w_out.t().contiguous(), b_out, g_post)


def _to_jax_layout(y):
    return y.float().transpose(1, 2).numpy()


@pytest.mark.parametrize("B,N,C", [(2, 200, 64), (1, 256, 96), (2, 64, 128)])
def test_block_plain_matches_block_xla_f32(B, N, C):
    x, p = _inputs(0, B, N, C)
    want = np.asarray(af._block_xla(jnp.asarray(x), *map(jnp.asarray, p), 4, 32,
                                    compute_dtype=jnp.float32))
    xt, tp = _port_args(x, p)
    got = _to_jax_layout(paf.block_plain(xt, *tp))
    # f32 end to end: only summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_block_plain_matches_block_xla_bf16():
    x, p = _inputs(1, 2, 200, 64)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(af._block_xla(xb, *map(jnp.asarray, p), 4, 32,
                                    compute_dtype=jnp.bfloat16).astype(jnp.float32))
    xt, tp = _port_args(x, p)
    got = _to_jax_layout(paf.block_plain(xt.to(torch.bfloat16), *tp))
    # bf16 operands in both; the frameworks round at a few other places, so
    # a value may differ by one bf16 ulp of the output's magnitude (< 8 here)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -5)
    assert np.mean(np.abs(got - want)) < 1e-4


def test_block_plain_matches_pallas_interpret():
    """Against the TPU kernels themselves (interpret mode), with the same
    tolerances tests/test_attention_pallas.py pins between them and XLA."""
    for B, N, C in ((2, 200, 64), (1, 256, 96)):
        x, p = _inputs(2, B, N, C)
        xj, pj = jnp.asarray(x), tuple(map(jnp.asarray, p))
        with pltpu.force_tpu_interpret_mode():
            got_f32 = np.asarray(af._fused_block_pallas(
                xj, *pj, 4, 32, block_n=128, compute_dtype=jnp.float32)[0])
            got_bf16 = np.asarray(af._fused_block_pallas(xj, *pj, 4, 32, block_n=128)[0])
        xt, tp = _port_args(x, p)
        plain_f32 = _to_jax_layout(paf.block_plain(xt, *tp))
        plain_bf16 = _to_jax_layout(
            paf.block_plain(xt, *tp, compute_dtype=torch.bfloat16))
        np.testing.assert_allclose(plain_f32, got_f32, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(plain_bf16, got_bf16, rtol=0.2, atol=0.15)
        assert np.mean(np.abs(plain_bf16 - got_bf16)) < 5e-3


def test_pass_plain_versions_match_pallas_passes():
    """The plain versions of the two kernels (context pass, output pass)
    against the Pallas passes in interpret mode, f32 compute: ctx per head,
    the k-softmax max m and denominator s, and y."""
    B, N, C = 2, 200, 64
    x, p = _inputs(6, B, N, C)
    with pltpu.force_tpu_interpret_mode():
        y, (ctx, m, s) = af._fused_block_pallas(
            jnp.asarray(x), *map(jnp.asarray, p), 4, 32, block_n=128,
            compute_dtype=jnp.float32)
    ctx = np.asarray(ctx)
    want_ctx = np.stack([ctx[:, h * 32:(h + 1) * 32, h * 32:(h + 1) * 32]
                         for h in range(4)], axis=1)
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _port_args(x, p)
    got_ctx, got_m, got_s = paf.ctx_plain(xt, g_pre, w_qkv[128:], torch.float32)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(m)[:, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(s)[:, 0], rtol=1e-4, atol=1e-5)
    got_y = paf.out_plain(xt, g_pre, w_qkv[:128], got_ctx, w_out, b_out, g_post,
                          torch.float32)
    np.testing.assert_allclose(_to_jax_layout(got_y), np.asarray(y), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(
        got_y.numpy(), paf.block_plain(xt, g_pre, w_qkv, w_out, b_out, g_post).numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,N,C", [(2, 200, 64), (1, 256, 96), (2, 64, 128)])
def test_attention_branch_matches_jax(B, N, C):
    """With a zero output bias the residual branch y - x is all attention
    (the context is ~1/N, so with the bias it would mostly be LN(bias)):
    against _block_xla and the Pallas passes, relative to that branch."""
    x, p = _inputs(0, B, N, C)
    p = (p[0], p[1], p[2], np.zeros_like(p[3]), p[4])
    xj, pj = jnp.asarray(x), tuple(map(jnp.asarray, p))
    want = np.asarray(af._block_xla(xj, *pj, 4, 32, compute_dtype=jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        pal_f32 = np.asarray(af._fused_block_pallas(
            xj, *pj, 4, 32, block_n=128, compute_dtype=jnp.float32)[0])
        pal_bf16 = np.asarray(af._fused_block_pallas(xj, *pj, 4, 32, block_n=128)[0])
    xt, tp = _port_args(x, p)
    got = _to_jax_layout(paf.block_plain(xt, *tp))
    got_bf16 = _to_jax_layout(paf.block_plain(xt, *tp, compute_dtype=torch.bfloat16))
    scale = np.abs(want - x).max()
    # f32: summation order only (measured <= 4e-6 of the branch)
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got - pal_f32).max() <= 1e-4 * scale
    # bf16 operands, rounded at other points (measured <= 0.6% of the branch)
    assert np.abs(got_bf16 - pal_bf16).max() <= 2e-2 * scale


_GRADS = ("dx", "dg_pre", "dw_qkv", "dw_out", "db_out", "dg_post")


def _port_grads_jax_layout(dx, dg_pre, dw_qkv, dw_out, db_out, dg_post):
    """Port-layout gradients (x (B, C, N), torch-layout weights) as JAX's."""
    return (_to_jax_layout(dx), dg_pre.numpy(), dw_qkv.t().numpy(), dw_out.t().numpy(),
            db_out.numpy(), dg_post.numpy())


def test_backward_plain_passes_match_pallas_bwd():
    """The plain versions of the three backward kernels (pass B', A'1, A'2),
    composed, against ``_fused_block_bwd_pallas`` in interpret mode with f32
    compute, at the shape and tolerances of
    tests/test_attention_pallas.py::test_fused_block_bwd_pallas_matches_xla_grad
    (B=2, N=200 pads the blocks, C=64)."""
    B, N, C = 2, 200, 64
    x, p = _inputs(11, B, N, C)
    dy = np.random.default_rng(12).standard_normal((B, N, C)).astype(np.float32)
    xj, pj = jnp.asarray(x), tuple(map(jnp.asarray, p))
    with pltpu.force_tpu_interpret_mode():
        _, (ctx, m, s) = af._fused_block_pallas(xj, *pj, 4, 32, block_n=128,
                                                compute_dtype=jnp.float32)
        want = af._fused_block_bwd_pallas(xj, *pj, ctx, m, s, jnp.asarray(dy), 4, 32,
                                          compute_dtype=jnp.float32)
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _port_args(x, p)
    dyt = torch.from_numpy(dy).transpose(1, 2).contiguous()
    f32 = torch.float32
    w_q, w_kv = w_qkv[:128], w_qkv[128:]
    ctx_p, m_p, s_p = paf.ctx_plain(xt, g_pre, w_kv, f32)
    dxq, dctx, dw_q, dw_out, db_out, dg_q, dg_post = paf.bwd_q_plain(
        xt, dyt, g_pre, w_q, ctx_p, w_out, b_out, g_post, f32)
    sdot = paf.bwd_kv1_plain(xt, g_pre, w_kv, m_p, s_p, dctx, f32)
    dx, dw_kv, dg_kv = paf.bwd_kv2_plain(xt, g_pre, w_kv, m_p, s_p, dctx, sdot, dxq, f32)
    got = _port_grads_jax_layout(dx, dg_q + dg_kv, torch.cat([dw_q, dw_kv]), dw_out,
                                 db_out, dg_post)
    for name, a, b in zip(_GRADS, got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=2e-4 * np.abs(b).max(),
                                   err_msg=name)
    # the per-head context cotangent is what the TPU's pass B' accumulates
    assert dctx.shape == (B, 4, 32, 32) and sdot.shape == (B, 128)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C", [(2, 200, 64), (1, 48, 32), (2, 1100, 128)])
def test_kv1_from_ctx_matches_bwd_kv1_plain(B, N, C, cdt):
    """Pass A'1's closed form: sum_e ctx dctx / N from ``ctx_plain``'s ctx
    equals ``bwd_kv1_plain``'s sum over positions with the same m and s.
    The two sum the same products in another order: within 2e-6 of the
    largest |sdot| (measured <= 3.5e-7), f32 and bf16 compute."""
    x, p = _inputs(21, B, N, C)
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _port_args(x, p)
    dctx = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (B, 4, 32, 32)).astype(np.float32))
    w_kv = w_qkv[128:]
    ctx, m, s = paf.ctx_plain(xt, g_pre, w_kv, cdt)
    want = paf.bwd_kv1_plain(xt, g_pre, w_kv, m, s, dctx, cdt)
    got = paf.kv1_from_ctx_plain(ctx, dctx, N)
    assert got.shape == want.shape == (B, 128) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


def test_backward_plain_passes_with_sdot_from_ctx_match_pallas_bwd():
    """test_backward_plain_passes_match_pallas_bwd with pass A'1 in closed
    form (``kv1_from_ctx_plain`` on the context pass's ctx, as the kernel
    takes it): the whole backward chain against ``_fused_block_bwd_pallas``
    in interpret mode, at the same shape and pins."""
    B, N, C = 2, 200, 64
    x, p = _inputs(11, B, N, C)
    dy = np.random.default_rng(12).standard_normal((B, N, C)).astype(np.float32)
    xj, pj = jnp.asarray(x), tuple(map(jnp.asarray, p))
    with pltpu.force_tpu_interpret_mode():
        _, (ctx, m, s) = af._fused_block_pallas(xj, *pj, 4, 32, block_n=128,
                                                compute_dtype=jnp.float32)
        want = af._fused_block_bwd_pallas(xj, *pj, ctx, m, s, jnp.asarray(dy), 4, 32,
                                          compute_dtype=jnp.float32)
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _port_args(x, p)
    dyt = torch.from_numpy(dy).transpose(1, 2).contiguous()
    f32 = torch.float32
    w_q, w_kv = w_qkv[:128], w_qkv[128:]
    ctx_p, m_p, s_p = paf.ctx_plain(xt, g_pre, w_kv, f32)
    dxq, dctx, dw_q, dw_out, db_out, dg_q, dg_post = paf.bwd_q_plain(
        xt, dyt, g_pre, w_q, ctx_p, w_out, b_out, g_post, f32)
    sdot = paf.kv1_from_ctx_plain(ctx_p, dctx, N)
    dx, dw_kv, dg_kv = paf.bwd_kv2_plain(xt, g_pre, w_kv, m_p, s_p, dctx, sdot, dxq, f32)
    got = _port_grads_jax_layout(dx, dg_q + dg_kv, torch.cat([dw_q, dw_kv]), dw_out,
                                 db_out, dg_post)
    for name, a, b in zip(_GRADS, got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=2e-4 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("B,N,C", [(2, 200, 64), (1, 48, 32)])
def test_block_autograd_on_cpu_matches_jax_vjp(B, N, C):
    """Autograd of the port's ``fused_linear_attention_block`` on a CPU tensor
    (``block_plain``) against ``jax.vjp`` of ``_block_xla``, f32: summation
    order only (the pin of tests/test_attention_pallas.py's custom-VJP test)."""
    x, p = _inputs(13, B, N, C)
    dy = np.random.default_rng(14).standard_normal((B, N, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: af._block_xla(*a, 4, 32, compute_dtype=jnp.float32),
                     jnp.asarray(x), *map(jnp.asarray, p))
    want = vjp(jnp.asarray(dy))
    xt, tp = _port_args(x, p)
    leaves = [t.clone().requires_grad_() for t in (xt, *tp)]
    y = paf.fused_linear_attention_block(*leaves)
    y.backward(torch.from_numpy(dy).transpose(1, 2))
    got = _port_grads_jax_layout(*(t.grad for t in leaves))
    for name, a, b in zip(_GRADS, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------- the forward kernels' plan
# (N, C) of the 7 LinearAttentionBlocks of a 128x128 and of a native
# 448x1024 UNet eval (chip_smoke.py's SHAPES and NATIVE_SHAPES)
_EVAL_128 = ((16384, 64), (4096, 64), (4096, 128), (1024, 128), (1024, 256), (256, 256),
             (256, 512))
_EVAL_NATIVE = ((458752, 64), (114688, 64), (114688, 128), (28672, 128), (28672, 256),
                (7168, 256), (7168, 512))
# the flagship's (B, N, C): serving 128x128 b8, native b2 and b8, 128x128
# training b16 (chip_smoke.py's TRAIN_SHAPES and the two N = 256 blocks),
# native training b2 (the eval's blocks)
_FLAGSHIP = sorted({(8, n, c) for n, c in _EVAL_128} | {(16, n, c) for n, c in _EVAL_128}
                   | {(b, n, c) for b in (2, 8) for n, c in _EVAL_NATIVE})


def _check_plan(B, N, C, dtype):
    plan = paf.la_plan(B, C, N, dtype)
    tiles = -(-N // plan.tile)
    assert plan.partials == plan.ctx.ctas
    for p in (plan.ctx, plan.out):
        assert 0 < p.smem <= paf.SMEM_MAX
        assert 1 <= p.ctas <= tiles
    if dtype == torch.bfloat16:
        assert plan.tile == paf.TILE
        chunks = -(-C // 64)
        for p, resident_slots, least in ((plan.ctx, chunks, 2), (plan.out, 2 * chunks, 4)):
            assert p.ctas * B <= paf.SMS and p.stages >= 1
            assert p.slots == resident_slots if p.resident else p.slots >= least
        assert plan.ctx.consumers == 2 and plan.out.consumers in (1, 2)
        # two consumer warp groups take alternate tiles of one ring
        assert plan.out.consumers == 1 or plan.out.stages >= 2
    else:
        assert plan.tile == paf.F32_TILE and plan.out.ctas == tiles
    return plan


@pytest.mark.parametrize("B,N,C", _FLAGSHIP)
def test_forward_plan_fits_every_flagship_shape(B, N, C):
    """Every (B, N, C) the flagship runs the forward kernels at gets a plan
    within the 227 KB of shared memory a CTA may have, bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        _check_plan(B, N, C, dtype)


@pytest.mark.parametrize("C", [16, 48, 496])
def test_forward_plan_takes_other_widths(C):
    """Widths the flagship does not use (the kernels take 16 <= C <= 512, C %
    16 == 0) also get a plan, with ragged N."""
    for B, N in ((1, 1), (3, 1000), (2, 7169)):
        for dtype in (torch.bfloat16, torch.float32):
            _check_plan(B, N, C, dtype)


@pytest.mark.parametrize("args,want", [
    # native level 0: weights resident, two consumer warp groups in pass B
    ((2, 64, 458752), ((66, 4, 1, True, 2, 141648), (66, 4, 2, True, 2, 92000))),
    # native C = 256: pass A streams w_kv, pass B keeps its weights with one stage
    ((2, 256, 28672), ((66, 2, 2, False, 2, 207936), (66, 1, 8, True, 1, 209040))),
    # the 128x128 bottleneck at b8: 4 tiles, both passes stream their weights
    ((8, 512, 256), ((4, 1, 2, False, 2, 208944), (4, 1, 5, False, 1, 228448))),
])
def test_forward_plan_pins(args, want):
    plan = paf.la_plan(*args)
    assert (tuple(plan.ctx), tuple(plan.out)) == want


def test_forward_plan_f32_keeps_the_first_bodies():
    """f32 x: tiles of 32 positions, pass A on two waves of CTAs, pass B one
    CTA per tile, the first bodies' shared memory."""
    plan = paf.la_plan(16, 64, 16384, torch.float32)
    assert plan == paf.LaPlan(32, paf.LaPass(17, 0, 0, False, 1, 40704), 17,
                              paf.LaPass(512, 0, 0, False, 1, 50944))


# ------------------------------------------------ the backward kernels' plan
# (B, N, C) of the blocks that take the backward kernels (N >= 1024): a
# 128x128 b16 train step (chip_smoke.py's TRAIN_SHAPES) and a native b2 one
_TRAIN_BWD = sorted({(16, n, c) for n, c in _EVAL_128 if n >= 1024}
                    | {(2, n, c) for n, c in _EVAL_NATIVE})


def _check_bwd_plan(B, N, C, dtype):
    plan = paf.la_bwd_plan(B, C, N, dtype)
    tiles = -(-N // plan.tile)
    assert 1 <= plan.ctas <= tiles and plan.ctas * B <= max(paf.SMS, B)
    smem = {torch.bfloat16: (paf._bwdq_smem, paf._kv2_smem)}.get(dtype)
    for i, p in enumerate((plan.q, plan.kv2)):
        assert 0 < p.smem <= paf.SMEM_MAX and p.flush in (0, 1)
        if dtype == torch.bfloat16:
            assert plan.tile == paf.TILE and p.consumers == 1 and p.stages >= 1
            # the launcher's check: the same sum from the plan's own fields
            assert p.smem == smem[i](C, p.stages, p.slots, p.flush == 0, p.ln_tile)
            chunks = 2 * -(-C // 64)  # 16 KB weight chunks a pass uses once each
            assert p.slots == chunks if p.resident else p.slots >= 2
            # partials in shared memory only beside the normalised tile
            assert p.flush == 1 or p.ln_tile
        else:
            assert plan.tile == paf.F32_TILE and p.stages == 0 and not p.ln_tile
    return plan


@pytest.mark.parametrize("B,N,C", _TRAIN_BWD)
def test_backward_plan_fits_every_train_shape(B, N, C):
    """Every (B, N, C) of a 128x128 b16 and a native b2 train step gets a
    backward plan within the 227 KB a CTA may have, bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        _check_bwd_plan(B, N, C, dtype)


@pytest.mark.parametrize("C", [16, 48, 496])
def test_backward_plan_takes_other_widths(C):
    """Widths the flagship does not use (16 <= C <= 512, C % 16 == 0) with
    N from 1 to ragged 7169 also get a backward plan."""
    for N in (1, 1000, 7169):
        for B in (1, 3):
            for dtype in (torch.bfloat16, torch.float32):
                _check_bwd_plan(B, N, C, dtype)


@pytest.mark.parametrize("args,want", [
    # native level 0: partials in shared memory, weights resident, two stages
    ((2, 64, 458752), (66, (2, 2, True, 1, 0, True, 221504), (2, 2, True, 1, 0, True, 195904))),
    # C = 128: the partials in the record, flushed every tile
    ((2, 128, 114688), (66, (2, 4, True, 1, 1, True, 212576), (2, 4, True, 1, 1, True, 203872))),
    # C = 256 at 128x128 b16: weights streamed through 4 slots, one stage
    ((16, 256, 1024), (8, (1, 4, False, 1, 1, True, 228944), (1, 4, False, 1, 1, True, 220240))),
    # C = 512: no room for the normalised tile, 2 slots; three or four tiles a CTA
    ((2, 512, 7168), (66, (1, 2, False, 1, 1, False, 228912), (1, 2, False, 1, 1, False, 220208))),
])
def test_backward_plan_pins(args, want):
    plan = paf.la_bwd_plan(*args)
    assert (plan.ctas, tuple(plan.q), tuple(plan.kv2)) == want


def test_backward_plan_f32_keeps_the_first_bodies():
    """f32 x: tiles of 32 positions, one CTA per SM split over the batch, the
    first bodies' shared memory, the partials in it at C = 64 only."""
    plan = paf.la_bwd_plan(16, 64, 16384, torch.float32)
    assert plan == paf.LaBwdPlan(32, 8, paf.LaBwdPass(0, 0, False, 2, 0, False, 161280),
                                 paf.LaBwdPass(0, 0, False, 2, 0, False, 193536))
    wide = paf.la_bwd_plan(2, 512, 7168, torch.float32)
    assert (wide.q.flush, wide.kv2.flush) == (1, 1)
