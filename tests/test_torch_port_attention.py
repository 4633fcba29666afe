"""Port vs JAX: the fused linear-attention block.

The port's ``block_plain`` (and the plain versions of the two kernel
passes) are held against the JAX composition ``_block_xla`` and against the
Pallas pipeline ``_fused_block_pallas`` run in interpret mode (as
tests/test_attention_pallas.py runs it).  The port takes x as (B, C, N) and
torch-layout weights; JAX takes (B, N, C).  The kernels themselves are
checked on the card by tests/test_torch_port_kernels.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
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
