"""The CUDA kernels of the fused linear-attention block (forward and
backward), of the unfused linear-attention middle, of the splat (forward and
backward) and of the UNet's convs (rows and fold), the flash kernel under
autograd, and their wrappers.

Imports torch and the port only (no JAX), so that it also runs on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

The tests marked ``cuda`` compare the kernels with their plain versions on
the card and skip where there is none; the others check the wrappers' CPU
behaviour.
"""

import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch.models import unet as punet
from opticalflowdiffusion_tpu_torch.ops import attention_fused as paf
from opticalflowdiffusion_tpu_torch.ops import attention_pallas as pap
from opticalflowdiffusion_tpu_torch.ops import flash_attention as pfa
from opticalflowdiffusion_tpu_torch.ops import conv as pconv
from opticalflowdiffusion_tpu_torch.ops import splat as psplat_


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, B, N, C, hd=128):
    """x (B, C, N) and torch-layout block parameters from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    x = f(rng.standard_normal((B, C, N)))
    p = (
        f(rng.standard_normal(C) * 0.1 + 1.0),                  # g_pre
        f(rng.standard_normal((3 * hd, C)) / np.sqrt(C)),        # w_qkv
        f(rng.standard_normal((C, hd)) / np.sqrt(hd)),           # w_out
        f(rng.standard_normal(C) * 0.01),                        # b_out
        f(rng.standard_normal(C) * 0.1 + 1.0),                   # g_post
    )
    return x, p


def test_wrapper_dispatches_plain_on_cpu():
    xt, tp = _inputs(3, 2, 100, 64)
    np.testing.assert_array_equal(
        paf.fused_linear_attention_block(xt, *tp).numpy(),
        paf.block_plain(xt, *tp).numpy(),
    )


def test_kernel_wrappers_refuse_cpu_tensors():
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _inputs(4, 1, 64, 64)
    w16 = w_qkv.to(torch.bfloat16)
    with pytest.raises(ValueError):
        paf.linear_attention_ctx(xt, g_pre, w16[128:].contiguous())
    ctx = torch.zeros(1, 4, 32, 32)
    with pytest.raises(ValueError):
        paf.linear_attention_out(xt, g_pre, w16[:128].contiguous(), ctx,
                                 w_out.to(torch.bfloat16), b_out, g_post)
    before = kernels.LA_BWD_KV1.launches
    with pytest.raises(ValueError):
        paf.linear_attention_bwd_kv1(ctx, ctx, 64)
    assert kernels.LA_BWD_KV1.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,C", [(1000, 64), (256, 256), (64, 512)])
def test_kernels_match_plain_on_card(cuda_device, dtype, N, C):
    """The block through the two CUDA kernels against block_plain on the
    card.  With a zero output bias the residual branch y - x is all
    attention; the kernels round matmul operands to bf16 also for f32 x (as
    the TPU kernels do), so the pin is 5% of that branch, plus one bf16 ulp
    of y for bf16 x."""
    xt, (g_pre, w_qkv, w_out, _, g_post) = _inputs(5, 2, N, C)
    tp = tuple(t.to(cuda_device) for t in (g_pre, w_qkv, w_out, torch.zeros(C), g_post))
    xt = xt.to(cuda_device, dtype)
    with torch.no_grad():
        got = paf.fused_linear_attention_block(xt, *tp).float()
        want = paf.block_plain(xt, *tp).float()
    torch.cuda.synchronize()
    scale = float((want - xt.float()).abs().max())
    ulp = 2.0 ** -7 * float(want.abs().max()) if dtype == torch.bfloat16 else 0.0
    assert float((got - want).abs().max()) <= 0.05 * scale + ulp


def test_cpu_path_launches_nothing():
    xt, tp = _inputs(6, 1, 64, 64)
    before = [k.launches for k in kernels.KERNELS]
    paf.fused_linear_attention_block(xt, *tp)
    assert [k.launches for k in kernels.KERNELS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_pass_matches_its_plain_version_on_card(cuda_device, dtype):
    """Context pass vs ctx_plain and output pass vs out_plain, with the same
    bf16 operands (f32 sums in another order, y rounded once to x.dtype); and
    one launch counted per call.  The output pass gets a context with
    ctx / N ~ N(0, 1), so that attention, not the bias, makes y - x."""
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _inputs(7, 2, 1000, 128)
    dev = cuda_device
    xt = xt.to(dev, dtype)
    g_pre, b_out, g_post = (t.to(dev) for t in (g_pre, b_out, g_post))
    w16 = w_qkv.to(dev, torch.bfloat16)
    w_kv, w_q = w16[128:].contiguous(), w16[:128].contiguous()
    wo16 = w_out.to(dev, torch.bfloat16).contiguous()
    n_ctx, n_out = kernels.LA_CTX.launches, kernels.LA_OUT.launches
    ctx_in = 1000 * torch.randn(2, 4, 32, 32, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        ctx, m, s = paf.linear_attention_ctx(xt, g_pre, w_kv)
        ctx_p, m_p, s_p = paf.ctx_plain(xt, g_pre, w_kv)
        y = paf.linear_attention_out(xt, g_pre, w_q, ctx_in.to(dev), wo16, b_out, g_post)
        y_p = paf.out_plain(xt, g_pre, w_q, ctx_in.to(dev), wo16, b_out, g_post)
    torch.cuda.synchronize()
    assert (kernels.LA_CTX.launches, kernels.LA_OUT.launches) == (n_ctx + 1, n_out + 1)
    assert float((ctx - ctx_p).abs().max()) <= 1e-2 * float(ctx_p.abs().max())
    assert float((m - m_p).abs().max()) <= 1e-2 * float(m_p.abs().max())
    assert float(((s - s_p).abs() / s_p).max()) <= 1e-2
    y, y_p = y.float(), y_p.float()
    scale = float((y_p - xt.float()).abs().max())
    ulp = 2.0 ** -7 * float(y_p.abs().max()) if dtype == torch.bfloat16 else 0.0
    assert float((y - y_p).abs().max()) <= 2e-2 * scale + ulp


@pytest.mark.cuda
def test_kernel_path_refuses_gradients(cuda_device):
    """What the kernel path still refuses: a block wider than 512 channels
    or with C % 16 != 0 raises (forward and backward kernels alike); C =
    512, the flagship's widest block, computes a gradient through the
    backward kernels at N >= 1024, and through the composition below."""
    for C in (528, 504):
        xt, tp = _inputs(8, 1, 1024, C)
        xt = xt.to(cuda_device).requires_grad_()
        with pytest.raises(ValueError):
            paf.fused_linear_attention_block(xt, *(t.to(cuda_device) for t in tp))
    n0 = kernels.LA_BWD_KV2.launches
    for N in (1024, 64):
        xs, ts = _inputs(8, 1, N, 512)
        xs = xs.to(cuda_device).requires_grad_()
        paf.fused_linear_attention_block(xs, *(t.to(cuda_device) for t in ts)).sum().backward()
        assert xs.grad is not None and torch.isfinite(xs.grad).all()
    assert kernels.LA_BWD_KV2.launches == n0 + 1


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


# every (B, N, C) of chip_smoke.py's la_phase: the 7 blocks of a 128x128 b8
# and of a native 448x1024 b2 UNet eval
LA_PHASE_SHAPES = (
    [(8, N, C) for N, C in ((16384, 64), (4096, 64), (4096, 128), (1024, 128), (1024, 256),
                            (256, 256), (256, 512))]
    + [(2, N, C) for N, C in ((458752, 64), (114688, 64), (114688, 128), (28672, 128),
                              (28672, 256), (7168, 256), (7168, 512))])
# ragged N (rows the tensor maps cannot take are padded once), batches 1-16,
# C from 16 to 512 (resident and streamed weights), and one CTA per batch
# element (P = 1: N <= 64)
EDGE_SHAPES = ((1, 1, 16), (2, 31, 64), (16, 64, 256), (8, 1000, 256), (16, 2100, 512),
               (1, 7169, 64), (2, 7169, 512), (16, 1000, 16), (1, 2100, 256))


def _forward_vs_plain(dev, dtype, B, N, C, seed):
    """Both forward passes against ctx_plain and out_plain, and the block
    against block_plain, at chip_smoke.py's pins: TOL_CTX = 1e-2 of the
    context's largest value (m: of its own, s: relative), TOL_OUT = 2e-2 of
    the residual branch y - x fed an attention-dominated context (ctx / N ~
    N(0, 1)), TOL_BLOCK = 5e-2 of that branch with a zero output bias (f32 x:
    the kernels round the operands to bf16, the plain block does not), plus
    one bf16 ulp of y for bf16 x.  Two launches of each pass give the same
    bits."""
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _inputs(seed, B, N, C)
    x = xt.to(dev, dtype)
    g_pre, w_qkv, w_out, b_out, g_post = (t.to(dev) for t in (g_pre, w_qkv, w_out, b_out, g_post))
    w16 = w_qkv.to(torch.bfloat16)
    w_kv, w_q = w16[128:].contiguous(), w16[:128].contiguous()
    wo16 = w_out.to(torch.bfloat16).contiguous()
    ctx_in = (N * torch.randn(B, 4, 32, 32, generator=torch.Generator().manual_seed(seed))).to(dev)
    zero = torch.zeros_like(b_out)
    with torch.no_grad():
        got = paf.linear_attention_ctx(x, g_pre, w_kv)
        again = paf.linear_attention_ctx(x, g_pre, w_kv)
        ctx_p, m_p, s_p = paf.ctx_plain(x, g_pre, w_kv)
        y = paf.linear_attention_out(x, g_pre, w_q, ctx_in, wo16, b_out, g_post)
        y2 = paf.linear_attention_out(x, g_pre, w_q, ctx_in, wo16, b_out, g_post)
        y_p = paf.out_plain(x, g_pre, w_q, ctx_in, wo16, b_out, g_post)
        yb = paf.fused_linear_attention_block(x, g_pre, w_qkv, w_out, zero, g_post)
        yb_p = paf.block_plain(x, g_pre, w_qkv, w_out, zero, g_post)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(y, y2)
    ctx, m, s = got
    assert float((ctx - ctx_p).abs().max()) <= 1e-2 * float(ctx_p.abs().max())
    assert float((m - m_p).abs().max()) <= 1e-2 * float(m_p.abs().max())
    assert float(((s - s_p).abs() / s_p).max()) <= 1e-2
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    xf = x.float()
    for got_y, want, tol in ((y, y_p, 2e-2), (yb, yb_p, 5e-2)):
        got_y, want = got_y.float(), want.float()
        assert got_y.shape == (B, C, N)
        scale = float((want - xf).abs().max())
        assert float((got_y - want).abs().max()) <= tol * scale + ulp * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C", LA_PHASE_SHAPES, ids=lambda v: str(v))
def test_forward_passes_match_plain_at_every_eval_shape_on_card(cuda_device, dtype, B, N, C):
    _forward_vs_plain(cuda_device, dtype, B, N, C, 11)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C", EDGE_SHAPES, ids=lambda v: str(v))
def test_forward_passes_match_plain_at_edge_shapes_on_card(cuda_device, dtype, B, N, C):
    _forward_vs_plain(cuda_device, dtype, B, N, C, 12)


@pytest.mark.cuda
def test_forward_plan_on_card(cuda_device):
    """The launchers check the plan they get: a plan whose shared memory
    does not add up, or one CTA more than there are tiles, is refused."""
    xt, (g_pre, w_qkv, *_rest) = _inputs(13, 2, 1024, 64)
    x = xt.to(cuda_device, torch.bfloat16)
    g_pre = g_pre.to(cuda_device)
    w_kv = w_qkv[128:].to(cuda_device, torch.bfloat16).contiguous()
    lib = paf._lib()
    plan = paf.la_plan(2, 64, 1024)
    for bad in (plan.ctx._replace(smem=plan.ctx.smem + 8),
                plan.ctx._replace(ctas=1024 // paf.TILE + 1)):
        part = torch.empty(2, bad.ctas, 4352, device=cuda_device)
        outs = [torch.empty(2, 4, 32, 32, device=cuda_device)] + [
            torch.empty(2, 128, device=cuda_device) for _ in range(2)]
        err = lib.ofd_la_ctx(x.data_ptr(), 1, 1024, g_pre.data_ptr(), w_kv.data_ptr(),
                             part.data_ptr(), *(t.data_ptr() for t in outs), 2, 64, 1024,
                             bad.ctas, bad.stages, bad.slots, int(bad.resident), bad.smem,
                             cuda_device.index or 0,
                             torch.cuda.current_stream(cuda_device).cuda_stream)
        assert err != 0


@pytest.mark.cuda
def test_backward_plan_on_card(cuda_device):
    """The backward launchers check the plan they get: shared memory that
    does not add up, the normalised tile switched off beside partials kept
    in shared memory, or one CTA more than there are tiles, is refused."""
    dev = cuda_device
    B, C, N = 2, 64, 1024
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _inputs(14, B, N, C)
    x = xt.to(dev, torch.bfloat16)
    g_pre, b_out, g_post = (t.to(dev) for t in (g_pre, b_out, g_post))
    w16 = w_qkv.to(dev, torch.bfloat16)
    w_q, w_kv = w16[:128].contiguous(), w16[128:].contiguous()
    wo = w_out.to(dev, torch.bfloat16).contiguous()
    stats = [torch.zeros(B, 128, device=dev) for _ in range(3)]  # m, s, sdot
    ctx = torch.zeros(B, 4, 32, 32, device=dev)
    lib = paf._lib()
    plan = paf.la_bwd_plan(B, C, N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for q, kv2, ctas in ((plan.q._replace(smem=plan.q.smem + 8), plan.kv2, plan.ctas),
                         (plan.q._replace(ln_tile=False), plan.kv2._replace(ln_tile=False),
                          plan.ctas),
                         (plan.q, plan.kv2, N // paf.TILE + 1)):
        part = torch.empty(B * ctas * lib.ofd_la_bwd_record(0, C), device=dev)
        out_w = torch.empty(2 * 256 * C + 3 * C, device=dev)
        dx = torch.empty_like(x)
        err_q = lib.ofd_la_bwd_q(x.data_ptr(), x.data_ptr(), 1, N, g_pre.data_ptr(),
                                 w_q.data_ptr(), ctx.data_ptr(), wo.data_ptr(), b_out.data_ptr(),
                                 g_post.data_ptr(), dx.data_ptr(), part.data_ptr(),
                                 out_w.data_ptr(), ctx.data_ptr(), B, C, N, ctas, q.stages,
                                 q.slots, int(q.resident), q.flush, int(q.ln_tile), q.smem,
                                 dev.index or 0, stream)
        err_kv2 = lib.ofd_la_bwd_kv2(x.data_ptr(), 1, N, g_pre.data_ptr(), w_kv.data_ptr(),
                                     *(t.data_ptr() for t in stats[:2]), ctx.data_ptr(),
                                     stats[2].data_ptr(), x.data_ptr(), dx.data_ptr(),
                                     part.data_ptr(), out_w.data_ptr(), B, C, N, ctas,
                                     kv2.stages, kv2.slots, int(kv2.resident), kv2.flush,
                                     int(kv2.ln_tile), kv2.smem, dev.index or 0, stream)
        assert err_q != 0 and (err_kv2 != 0 or kv2 == plan.kv2 and ctas == plan.ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C", [(2, 1000, 64), (2, 1024, 256), (1, 2100, 128),
                                   (2, 1024, 512), (1, 1100, 512), (16, 1024, 64),
                                   (1, 16384, 64), (16, 1031, 16), (1, 1024, 128),
                                   (16, 16384, 128)])
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, B, N, C):
    """Pass B', A'1 and A'2 against bwd_q_plain, bwd_kv1_plain and
    bwd_kv2_plain with the same bf16 operands: f32 sums in another order,
    within 1e-3 of each output's largest value (measured <= 3e-4 on an
    H100); pass A'1 takes the context kernel's ctx where bwd_kv1_plain
    recomputes over N; each launch counted once; two launches give the
    same bits.  The
    shapes cover B 1 and 16, C 16 to 512, N ragged (1000, 1031, 1100, 2100)
    and aligned (1024, 16384), partials in shared memory (C <= 64) and in the
    record, weights resident and streamed, and one tile a CTA (1, 1024)."""
    dev = cuda_device
    xt, (g_pre, w_qkv, w_out, b_out, g_post) = _inputs(9, B, N, C)
    x = xt.to(dev, dtype)
    dy = torch.randn(B, C, N, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    g_pre, b_out, g_post = (t.to(dev) for t in (g_pre, b_out, g_post))
    w16 = w_qkv.to(dev, torch.bfloat16)
    w_q, w_kv = w16[:128].contiguous(), w16[128:].contiguous()
    wo = w_out.to(dev, torch.bfloat16).contiguous()
    ctx, m, s = paf.linear_attention_ctx(x, g_pre, w_kv)
    n0 = [k.launches for k in (kernels.LA_BWD_Q, kernels.LA_BWD_KV1, kernels.LA_BWD_KV2)]
    got_q = paf.linear_attention_bwd_q(x, dy, g_pre, w_q, ctx, wo, b_out, g_post)
    want_q = paf.bwd_q_plain(x, dy, g_pre, w_q, ctx, wo, b_out, g_post)
    dctx = want_q[1]
    got_s = paf.linear_attention_bwd_kv1(ctx, dctx, N)
    want_s = paf.bwd_kv1_plain(x, g_pre, w_kv, m, s, dctx)
    got_kv = paf.linear_attention_bwd_kv2(x, g_pre, w_kv, m, s, dctx, want_s, want_q[0])
    want_kv = paf.bwd_kv2_plain(x, g_pre, w_kv, m, s, dctx, want_s, want_q[0])
    again = paf.linear_attention_bwd_q(x, dy, g_pre, w_q, ctx, wo, b_out, g_post)
    again_s = paf.linear_attention_bwd_kv1(ctx, dctx, N)
    again_kv = paf.linear_attention_bwd_kv2(x, g_pre, w_kv, m, s, dctx, want_s, want_q[0])
    torch.cuda.synchronize()
    assert [k.launches for k in (kernels.LA_BWD_Q, kernels.LA_BWD_KV1, kernels.LA_BWD_KV2)] \
        == [n0[0] + 2, n0[1] + 2, n0[2] + 2]
    assert torch.equal(got_s, again_s)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0      # dx rounded to bf16
    for i, (a, b) in enumerate(zip(got_q, want_q)):
        assert _rel(a, b) <= 1e-3 + (ulp if i == 0 else 0.0), i
    assert _rel(got_s, want_s) <= 1e-3
    for i, (a, b) in enumerate(zip(got_kv, want_kv)):
        assert _rel(a, b) <= 1e-3 + (ulp if i == 0 else 0.0), i
    assert all(torch.equal(a, b) for a, b in zip(got_q, again))
    assert all(torch.equal(a, b) for a, b in zip(got_kv, again_kv))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,remat,blocks", [(16, 128, 128, False, 6), (2, 448, 1024, True, 8)])
def test_backward_kernels_match_plain_on_train_activations_on_card(cuda_device, B, H, W, remat,
                                                                   blocks):
    """Pass B', A'1 and A'2 against their plain versions on the activations
    that reach every block's backward (fused_block_bwd) in one train step of
    the flagship (bf16, random weights from a seed, a standard-normal batch
    from numpy): 128x128 b16, and native 448x1024 b2 with remat.  Within 1e-3
    of each output's largest value (dx also one bf16 ulp), as on the random
    inputs above; unlike the step's loss, this does not depend on which bf16
    roundings a change of the kernels flips."""
    import dataclasses

    from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
    from opticalflowdiffusion_tpu_torch.config import FLAGSHIP
    from opticalflowdiffusion_tpu_torch.experiments.base import to_device

    cfg = dataclasses.replace(FLAGSHIP, zero_init=False, precision="bf16", remat=remat)
    algo = FlowDiffuser(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    algo.module.train()
    rng = np.random.default_rng(0)
    batch = to_device(tuple(rng.standard_normal((B, H, W, c)).astype(np.float32)
                            for c in (3, 3, 2)), cuda_device)
    calls, original = [], paf.fused_block_bwd

    def capture(*args):
        calls.append(tuple(a.detach().clone() for a in args))
        return original(*args)

    paf.fused_block_bwd = capture
    try:
        loss, _ = algo.loss_fn(batch, torch.Generator(device="cuda").manual_seed(11))
        loss.backward()
    finally:
        paf.fused_block_bwd = original
    del algo, loss
    assert len(calls) == blocks
    ulp = 2.0 ** -7
    with torch.no_grad():
        for x, dy, g_pre, w_qkv, w_out, b_out, g_post, c, m, s in calls:
            w16 = w_qkv.to(torch.bfloat16).contiguous()
            w_q, w_kv = w16[:128], w16[128:]
            g32 = g_pre.float().contiguous()
            args_q = (x, dy.to(x.dtype).contiguous(), g32, w_q, c,
                      w_out.to(torch.bfloat16).contiguous(), b_out.float().contiguous(),
                      g_post.float().contiguous())
            want_q = paf.bwd_q_plain(*args_q)
            for i, (a, b) in enumerate(zip(paf.linear_attention_bwd_q(*args_q), want_q)):
                assert _rel(a, b) <= 1e-3 + (ulp if i == 0 else 0.0), (x.shape, "B'", i)
            want_s = paf.bwd_kv1_plain(x, g32, w_kv, m, s, want_q[1])
            assert _rel(paf.linear_attention_bwd_kv1(c, want_q[1], x.shape[2]),
                        want_s) <= 1e-3, (x.shape, "A'1")
            args_kv2 = (x, g32, w_kv, m, s, want_q[1], want_s, want_q[0])
            for i, (a, b) in enumerate(zip(paf.linear_attention_bwd_kv2(*args_kv2),
                                           paf.bwd_kv2_plain(*args_kv2))):
                assert _rel(a, b) <= 1e-3 + (ulp if i == 0 else 0.0), (x.shape, "A'2", i)


@pytest.mark.cuda
def test_block_gradients_through_kernels_match_plain_on_card(cuda_device):
    """Autograd of the block on the card at N = 1024 (the backward kernels)
    against autograd of block_plain, f32 x: the kernels round the matmul
    operands to bf16 as the TPU's do, so 5% of each gradient's scale."""
    dev = cuda_device
    xt, tp = _inputs(10, 2, 1024, 64)
    leaves = [t.to(dev).requires_grad_() for t in (xt, *tp)]
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    dy = torch.randn(2, 64, 1024, generator=torch.Generator().manual_seed(2)).to(dev)
    n0 = kernels.LA_BWD_KV2.launches
    paf.fused_linear_attention_block(*leaves).backward(dy)
    paf.block_plain(*ref).backward(dy)
    torch.cuda.synchronize()
    assert kernels.LA_BWD_KV2.launches == n0 + 1
    for a, b in zip(leaves, ref):
        assert _rel(a.grad, b.grad) <= 5e-2


# ------------------------------------------------------------ unfused middle
def _qkv_conv_layout(seed, B, N, dtype, dev):
    """qkv (B, N, 384) as the module hands it over: a view of (B, 384, N)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((B, 384, N)).astype(np.float32))
    return a.to(dev, dtype).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N", [(2, 1000), (1, 37), (2, 7168)])
def test_middle_kernels_match_plain_on_card(cuda_device, dtype, B, N):
    """Rows 7-8 against middle_ctx_plain and middle_out_plain (N not a
    multiple of the 32-position tile, and one tile short): the same f32
    arithmetic on qkv's values in another order, so 1e-5 of the largest sum
    of the terms' magnitudes (the signed sums cancel, so their own largest
    value falls with N while the rounding does not), plus one bf16 ulp of
    the largest output (2^-7) for a bf16 output; one launch counted per
    call; two launches give the same bits."""
    t = _qkv_conv_layout(11, B, N, dtype, cuda_device)
    n0 = (kernels.LA_MID_CTX.launches, kernels.LA_MID_OUT.launches)
    ctx, ctx2 = pap.middle_ctx(t), pap.middle_ctx(t)
    ctx_p = pap.middle_ctx_plain(t)
    out, out2 = pap.middle_out(t, ctx_p), pap.middle_out(t, ctx_p)
    out_p = pap.middle_out_plain(t, ctx_p)
    torch.cuda.synchronize()
    assert (kernels.LA_MID_CTX.launches, kernels.LA_MID_OUT.launches) == (n0[0] + 2, n0[1] + 2)
    assert torch.equal(ctx, ctx2) and torch.equal(out, out2)
    assert out.shape == (B, N, 128) and out.dtype == dtype
    va = t.clone()
    va[..., 256:] = va[..., 256:].abs()
    ctx_mass = float(pap.middle_ctx_plain(va).max())
    out_mass = float(pap.middle_out_plain(t, ctx_p.abs()).float().max())
    ulp = 2.0 ** -7 * float(out_p.float().abs().max()) if dtype == torch.bfloat16 else 0.0
    assert float((ctx - ctx_p).abs().max()) <= 1e-5 * ctx_mass
    assert float((out.float() - out_p.float()).abs().max()) <= 1e-5 * out_mass + ulp


@pytest.mark.cuda
def test_middle_kernels_refuse_what_they_cannot_take_on_card(cuda_device):
    t = _qkv_conv_layout(12, 1, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        pap.middle_ctx(t, heads=2, dim=64)
    with pytest.raises(ValueError):
        punet.LinearAttention(64, heads=2, dim_head=32, attn_backend="kernels").to(
            cuda_device)(torch.randn(1, 64, 4, 4, device=cuda_device))
    with pytest.raises(TypeError):
        pap.middle_ctx(t.half())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_middle_module_on_kernels_matches_composition_and_block_on_card(cuda_device, dtype):
    """PreNormResidual(LinearAttention) on the kernels, on the composition,
    and the fused LinearAttentionBlock from the same state_dict: within 5%
    of the residual branch's scale plus one bf16 ulp of y, the pin of the
    fused block against block_plain; the kernels' backward is the
    composition's, so its input gradient is within 5% of the composition
    module's.  The middle's output is ~N^-1.5, below the post-LayerNorm's
    eps, so the out conv's weight is scaled by N^1.5 and its bias zeroed:
    the residual branch is then all attention, at unit scale."""
    C, H, W = 64, 32, 40
    blk = punet.LinearAttentionBlock(C, dtype=dtype)
    punet.init_weights(blk, torch.Generator().manual_seed(13))
    with torch.no_grad():
        blk.fn.fn.to_out[0].bias.zero_()
        blk.fn.fn.to_out[0].weight.mul_(float(H * W) ** 1.5)
    blk = blk.to(cuda_device)
    mods = {}
    for be in ("kernels", "composition"):
        m = punet.PreNormResidual(C, punet.LinearAttention(C, dtype=dtype, attn_backend=be), dtype)
        m.load_state_dict(blk.state_dict())
        mods[be] = m.to(cuda_device)
    x = torch.randn(2, C, H, W, generator=torch.Generator().manual_seed(14)).to(cuda_device, dtype)
    xs = {be: x.clone().requires_grad_() for be in mods}
    n0 = [k.launches for k in (kernels.LA_MID_CTX, kernels.LA_MID_OUT)]
    y = {be: m(xs[be]) for be, m in mods.items()}
    with torch.no_grad():
        y["block"] = blk(x)
    for be in mods:
        y[be].float().square().sum().backward()
    torch.cuda.synchronize()
    assert [k.launches for k in (kernels.LA_MID_CTX, kernels.LA_MID_OUT)] == [n0[0] + 1, n0[1] + 1]
    ref = y["composition"].detach().float()
    scale = float((ref - x.float()).abs().max())
    ulp = 2.0 ** -7 * float(ref.abs().max()) if dtype == torch.bfloat16 else 0.0
    assert scale > 0.5
    for be in ("kernels", "block"):
        assert float((y[be].detach().float() - ref).abs().max()) <= 0.05 * scale + ulp, be
    assert _rel(xs["kernels"].grad, xs["composition"].grad) <= 0.05


@pytest.mark.cuda
def test_block_gradients_under_checkpoint_on_card(cuda_device):
    """The fused block inside torch.utils.checkpoint (remat, non-reentrant)
    on the backward kernels: its forward runs again in the backward, and
    the gradients are those of the same block without checkpointing."""
    from torch.utils.checkpoint import checkpoint

    xt, tp = _inputs(17, 2, 1024, 512)
    dy = torch.randn(2, 512, 1024, generator=torch.Generator().manual_seed(18)).to(cuda_device)
    grads = []
    for remat in (False, True):
        leaves = [t.to(cuda_device).requires_grad_() for t in (xt, *tp)]
        n0 = kernels.LA_CTX.launches
        if remat:
            y = checkpoint(paf.fused_linear_attention_block, *leaves, use_reentrant=False)
        else:
            y = paf.fused_linear_attention_block(*leaves)
        y.backward(dy)
        torch.cuda.synchronize()
        assert kernels.LA_CTX.launches == n0 + (2 if remat else 1)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------------------ flash under autograd
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradients_match_the_composition_on_card(cuda_device, dtype):
    """attention_middle on the kernel path (N >= 2048) under autograd: the
    forward is the flash kernel, and the gradients are autograd of the
    composition on the same saved q, k, v, so they equal those of the
    composition itself (pin 1e-6 of each gradient's scale, for cuBLAS's
    choice of algorithm)."""
    B, N = 1, 2100
    qkv = torch.randn(B, 3, 4, 32, N, generator=torch.Generator().manual_seed(15))
    qkv = qkv.to(cuda_device, dtype)
    g = torch.randn(B, N, 4, 32, generator=torch.Generator().manual_seed(16)).to(cuda_device, dtype)
    grads = []
    n0 = kernels.FLASH.launches
    for fn in (pfa.attention_middle, pfa.attention_middle_plain):
        leaf = qkv.clone().requires_grad_()
        q = (leaf[:, 0] * 32 ** -0.5).permute(0, 3, 1, 2)
        k, v = leaf[:, 1].permute(0, 3, 1, 2), leaf[:, 2].permute(0, 3, 1, 2)
        out = fn(q, k, v)
        out.backward(g)
        grads.append(leaf.grad)
    torch.cuda.synchronize()
    assert kernels.FLASH.launches == n0 + 1
    assert _rel(grads[0], grads[1]) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale,offset", [(1, (0, 0)), (2, (1, 0)), (4, (0, 0)), (16, (0, 0))])
def test_splat_kernels_match_plain_on_card(cuda_device, dtype, scale, offset):
    """The forward kernel at a scale and offset against splat_raw (and its
    hole mask against sum > 0), the backward kernel against splat_bwd_raw:
    both gather the same f32 products in the same order, so to f32
    rounding; each launch counted."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(scale)
    inp = (2 * torch.rand(2, 4, 64, 96, generator=g, device=dev) - 1).to(dtype)
    flow = 4 * torch.randn(2, 2, 64, 96, generator=g, device=dev)
    flow[0, 0, 3, 5] = float("inf")
    n_f, n_b = kernels.SPLAT.launches, kernels.SPLAT_BWD.launches
    out, mask = psplat_.splat_fwd(inp, flow, scale, offset)
    want = psplat_.splat_raw(inp, flow, scale, offset)
    cot = torch.randn(out.shape, generator=g, device=dev)
    d_inp, d_flow = psplat_.splat_bwd(inp, flow, cot, scale, offset)
    w_inp, w_flow = psplat_.splat_bwd_raw(inp, flow, cot, scale, offset)
    torch.cuda.synchronize()
    assert (kernels.SPLAT.launches, kernels.SPLAT_BWD.launches) == (n_f + 1, n_b + 1)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert _rel(out, want) <= rel
    assert torch.equal(mask, want[:, -1:] > 0)
    assert _rel(d_inp, w_inp) <= rel and _rel(d_flow, w_flow) <= 1e-5


@pytest.mark.cuda
def test_splat_hole_mask_keeps_tiny_weights_on_card(cuda_device):
    """At 448x1024, column 0 moves by 1e-20 px and every other source off
    the image: column 1 receives only weights of 1e-20, far below the
    kernel's fixed-point resolution.  Its hole mask must still be the plain
    path's sum > 0, and so must the warp's NaN holes."""
    dev = cuda_device
    H, W = 448, 1024
    flow = torch.zeros(1, 2, H, W, device=dev)
    flow[:, 0] = 1e6
    flow[0, 0, :, 0] = 1e-20
    inp = torch.ones(1, 4, H, W, device=dev)
    _, mask = psplat_.splat_fwd(inp, flow)
    want = psplat_.splat_raw(inp, flow)[:, -1:] > 0
    assert torch.equal(mask, want) and int(want.sum()) == 2 * H
    from opticalflowdiffusion_tpu_torch.ops import warp as pwarp_
    holes = torch.isnan(pwarp_.warp_forward_flow(inp[:, :3], flow))
    assert torch.equal(holes[:, :1], ~want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splat_kernel_deterministic_on_card(cuda_device, dtype):
    """Two launches give the same bits, and the kernel agrees with
    ``splat_raw`` to float32 rounding of the sums (one rounding to bf16 for
    bf16), on a 96x160 map with colliding targets and an inf flow."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (2 * torch.rand(2, 3, 96, 160, generator=g, device=cuda_device) - 1).to(dtype)
    metric = (torch.rand(2, 1, 96, 160, generator=g, device=cuda_device) > 0.1).to(dtype)
    flow = 4 * torch.randn(2, 2, 96, 160, generator=g, device=cuda_device)
    flow[0, 0, 5, 7] = float("inf")
    n0 = kernels.SPLAT.launches
    v = torch.cat([x * metric, metric], dim=1)
    a, _ = psplat_.splat_fwd(v, flow)
    b, _ = psplat_.splat_fwd(v, flow)
    want = psplat_.splat_raw(v, flow).float()
    torch.cuda.synchronize()
    assert kernels.SPLAT.launches == n0 + 2
    assert torch.equal(a, b)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((a.float() - want).abs().max()) <= rel * float(want.abs().max()) + 1e-6


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _bitwise_splat_inputs(kind, dtype, dev, seed, B=2, H=64, W=96, C=4):
    """chip_smoke.py's bit-for-bit cases: 4 N(0, 1) px or 40 N(0, 1) px flows
    with an infinite target, a zero flow, 1e6 px flows with 1e-20 px at
    column 0 (weights of 1e-20), inf, -inf and NaN values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = 2 * torch.rand(B, C, H, W, generator=g, device=dev) - 1
    flow = 4 * torch.randn(B, 2, H, W, generator=g, device=dev)
    if kind == "flow40":
        flow *= 10
    elif kind == "zero":
        flow.zero_()
    elif kind == "huge":
        flow.zero_()
        flow[:, 0] = 1e6
        flow[:, 0, :, 0] = 1e-20
        v[:, -1] = 1.0
    elif kind == "nonfinite":
        v[0, 0, 1, 2], v[0, 0, 1, 3] = float("inf"), float("-inf")
        v[0, C - 1, 4, 4] = float("inf")
        v[-1, min(1, C - 1), 5, 6] = float("nan")
    if kind != "huge":
        flow[0, 0, 0, 0] = float("inf")
    return v.to(dtype), flow


# (C, H, W, scale, offset): C = 4 at 64x96 over the scales; C below, at and
# past the chunk of 4 (two and three chunks); sizes no multiple of the
# 32-source tile or of the scale (partial edge tiles)
SPLAT_BITWISE_GEOMS = [(4, 64, 96, 1, (0, 0)), (4, 64, 96, 2, (1, 0)), (4, 64, 96, 4, (3, 2)),
                       (4, 64, 96, 16, (15, 9)), (1, 64, 96, 1, (0, 0)), (3, 64, 96, 2, (1, 0)),
                       (5, 64, 96, 4, (3, 2)), (9, 64, 96, 1, (0, 0)), (9, 64, 96, 16, (0, 0)),
                       (4, 100, 70, 3, (2, 1)), (5, 100, 70, 1, (0, 0)), (1, 37, 29, 3, (0, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,H,W,scale,offset", SPLAT_BITWISE_GEOMS)
@pytest.mark.parametrize("kind", ["flow4", "flow40", "zero", "huge", "nonfinite"])
def test_splat_kernel_is_bitwise_its_fixed_point_plain_on_card(cuda_device, dtype, C, H, W,
                                                               scale, offset, kind):
    """The forward kernel equals splat_fixed_plain bit for bit (values as
    integers, NaN bits included, and the hole mask) and two launches give
    the same bits: the kernel's sums are 64-bit integer sums of the same
    once-rounded terms, in whatever grouping, chunk by chunk of channels."""
    v, flow = _bitwise_splat_inputs(kind, dtype, cuda_device, 17 * scale + len(kind),
                                    H=H, W=W, C=C)
    n0 = kernels.SPLAT.launches
    out, mask = psplat_.splat_fwd(v, flow, scale, offset)
    again, mask2 = psplat_.splat_fwd(v, flow, scale, offset)
    want, wmask = psplat_.splat_fixed_plain(v, flow, scale, offset)
    torch.cuda.synchronize()
    assert kernels.SPLAT.launches == n0 + 2
    assert torch.equal(_bits(out), _bits(want)) and torch.equal(mask, wmask)
    assert torch.equal(_bits(out), _bits(again)) and torch.equal(mask, mask2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,W,scale", [(2, 4, 448, 1024, 1), (2, 4, 448, 1024, 16),
                                           (8, 4, 128, 128, 1), (16, 4, 128, 128, 2),
                                           (16, 4, 128, 128, 16), (1, 9, 13, 18, 4),
                                           (1, 5, 100, 70, 3), (1, 1, 40, 40, 40)])
def test_splat_windows_cover_the_output_on_card(cuda_device, B, C, H, W, scale):
    """The forward kernel's own windows (``ofd_splat_windows``): every corner
    of a source that does not move lands inside its tile's window (the halo
    takes the rest of the bilinear footprint), and the windows together
    cover the output, so the finish pass, which sums the windows over each
    cell, misses no cell, at every phase offset; the scratch it states
    holds a window per 32 x 32 tile and the escapes' accumulator."""
    lib = psplat_._lib()
    Ho, Wo = H // scale, W // scale
    for off in {(0, 0), (scale - 1, scale // 2)}:
        wx0, wy0, win = psplat_._kernel_windows(H, W, scale, off)
        _, dump, corners = psplat_._splat_terms(torch.zeros(1, 1, H, W), torch.zeros(1, 2, H, W),
                                                scale, off)
        ox, oy = wx0.long().view(1, W).expand(H, W).reshape(-1), wy0.long().view(H, 1).expand(
            H, W).reshape(-1)
        for idx, _ in corners:
            ok = idx != dump
            lx, ly = idx % Wo - ox, idx // Wo - oy
            assert bool(((lx >= 0) & (lx < win) & (ly >= 0) & (ly < win))[ok].all())
        for origins, size in ((wx0.unique(), Wo), (wy0.unique(), Ho)):
            v = torch.arange(size)
            covered = ((origins.long().view(-1, 1) <= v)
                       & (v < origins.long().view(-1, 1) + win)).any(0)
            assert bool(covered.all())
    tiles = B * -(-H // 32) * -(-W // 32)
    assert lib.ofd_splat_scratch_bytes(B, C, H, W, scale) >= (
        tiles * win * win * (8 * C + 4) + B * Ho * Wo * (8 * C + 4))


# ------------------------------------------------------------------- convs
def _conv_inputs(seed, B, Cin, H, W, Cout, k, affine=False):
    """x (B, Cin, H, W), an OIHW kernel and, with ``affine``, f32 (B, Cin)
    vectors whose bias makes silu(b) far from 0 (so a border that is
    transformed instead of kept zero shows)."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    x = f(rng.standard_normal((B, Cin, H, W)))
    w = f(rng.standard_normal((Cout, Cin, k, k)) / np.sqrt(Cin * k * k))
    if not affine:
        return x, w, None, None
    return (x, w, f(rng.standard_normal((B, Cin)) * 0.5 + 1.0),
            f(rng.standard_normal((B, Cin)) * 0.5 + 2.0))


def test_conv_wrappers_take_plain_versions_on_cpu():
    x, w, a, b = _conv_inputs(11, 2, 9, 12, 20, 16, 7, affine=True)
    before = [k.launches for k in kernels.KERNELS]
    assert torch.equal(pconv.conv_rows(x, w), pconv.conv2d_same_plain(x, w))
    assert torch.equal(pconv.conv_fold(x, w), pconv.conv2d_same_plain(x, w))
    assert torch.equal(pconv.conv_fold(x, w, a, b), pconv.conv2d_same_gn_plain(x, w, a, b))
    assert [k.launches for k in kernels.KERNELS] == before
    with pytest.raises(ValueError):
        pconv.conv_rows(x, w[:, :, :2, :2])             # an even kernel
    with pytest.raises(ValueError):
        pconv.conv_fold(x, w, a)                        # a without b


# (B, Cin, H, W, Cout, k): the stem's ragged Cin at 7x7; H and W no multiple
# of the tile with Cout no multiple of 64; a 5x5; the UNet's 64 -> 64 level
# at a width of two tiles; a narrow level (W = 16) at Cin 192
CONV_CASES = [(2, 9, 37, 50, 64, 7), (1, 40, 13, 21, 70, 3), (1, 3, 32, 16, 8, 5),
              (2, 64, 8, 256, 64, 3), (2, 192, 16, 16, 128, 3)]


def _conv_tol(want, dtype):
    """f32: sums in another order (the card's plain version with TF32 off);
    bf16: the same bf16 operands and f32 sums, one rounding of the output
    to bf16 that may fall the other way (one ulp, 2^-8 of a value)."""
    scale = float(want.float().abs().max())
    return (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_conv_kernels_match_plain_on_card(cuda_device, no_tf32, dtype, case):
    """conv_rows and conv_fold (prologue off and on) against
    conv2d_same_plain and conv2d_same_gn_plain on the same inputs; each
    launch counted once; two launches give the same bits."""
    x, w, a, b = _conv_inputs(12, *case, affine=True)
    dev = cuda_device
    x, w, a, b = x.to(dev, dtype), w.to(dev), a.to(dev), b.to(dev)
    n_rows, n_fold = kernels.CONV_ROWS.launches, kernels.CONV_FOLD.launches
    rows = pconv.conv_rows(x, w)
    fold = pconv.conv_fold(x, w)
    gn, gn2 = pconv.conv_fold(x, w, a, b), pconv.conv_fold(x, w, a, b)
    want = pconv.conv2d_same_plain(x, w)
    want_gn = pconv.conv2d_same_gn_plain(x, w, a, b)
    torch.cuda.synchronize()
    assert (kernels.CONV_ROWS.launches, kernels.CONV_FOLD.launches) == (n_rows + 1, n_fold + 3)
    assert rows.dtype == fold.dtype == gn.dtype == dtype
    assert torch.equal(rows, fold) and torch.equal(gn, gn2)
    assert float((rows.float() - want.float()).abs().max()) <= _conv_tol(want, dtype)
    assert float((gn.float() - want_gn.float()).abs().max()) <= _conv_tol(want_gn, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_fold_prologue_keeps_the_border_zero_on_card(cuda_device, no_tf32, dtype):
    """The zero padding is zero after the transform (silu(0 * a + b) =
    silu(b) != 0 here): the first and last rows and columns of the output
    agree with the plain version as well as the interior, at 3x3 and 7x7."""
    dev = cuda_device
    for k in (3, 7):
        x, w, a, b = _conv_inputs(13, 2, 24, 20, 40, 64, k, affine=True)
        x, w, a, b = x.to(dev, dtype), w.to(dev), a.to(dev), b.to(dev)
        got = pconv.conv_fold(x, w, a, b).float()
        want = pconv.conv2d_same_gn_plain(x, w, a, b).float()
        torch.cuda.synchronize()
        tol = _conv_tol(want, dtype)
        for edge in (got - want)[:, :, [0, -1], :], (got - want)[:, :, :, [0, -1]]:
            assert float(edge.abs().max()) <= tol
        assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_conv_wrappers_refuse_what_they_cannot_take_on_card(cuda_device):
    dev = cuda_device
    x, w, a, b = _conv_inputs(14, 2, 16, 8, 16, 64, 3, affine=True)
    x, w, a, b = x.to(dev), w.to(dev), a.to(dev), b.to(dev)
    with pytest.raises(TypeError):
        pconv.conv_rows(x.half(), w)                    # no fp16 kernel
    with pytest.raises(ValueError):
        pconv.conv_rows(x.transpose(2, 3), w.transpose(2, 3))   # not contiguous
    with pytest.raises(ValueError):
        pconv.conv_fold(x, w[:, :, :2, :2])             # an even kernel
    with pytest.raises(ValueError):
        pconv.conv_fold(x, w[:, :8])                    # Cin mismatch
    with pytest.raises(ValueError):
        pconv.conv_fold(x, w, a.double(), b)            # a not f32
    with pytest.raises(ValueError):
        pconv.conv_fold(x, w, a[:1], b[:1])             # a not (B, Cin)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["rows", "fold"])
def test_conv_gradients_through_kernels_match_plain_on_card(cuda_device, no_tf32, backend):
    """Autograd of conv2d_same with and without in_affine through the
    backend's kernels (forward and dgrad) against autograd of the plain
    versions, f32 with TF32 off: to f32 rounding of the sums."""
    dev = cuda_device
    x, w, a, b = _conv_inputs(15, 2, 32, 12, 40, 64, 3, affine=True)
    g = torch.randn(2, 64, 12, 40, generator=torch.Generator().manual_seed(3)).to(dev)
    for affine in (False, True):
        leaves = [t.to(dev).requires_grad_() for t in ((x, w, a, b) if affine else (x, w))]
        ref = [t.detach().clone().requires_grad_() for t in leaves]
        counts = kernels.CONV_ROWS.launches + kernels.CONV_FOLD.launches
        if affine:
            pconv.conv2d_same(leaves[0], leaves[1], backend,
                              in_affine=tuple(leaves[2:])).backward(g)
            pconv.conv2d_same_gn_plain(*ref).backward(g)
        else:
            pconv.conv2d_same(*leaves, backend).backward(g)
            pconv.conv2d_same_plain(*ref).backward(g)
        torch.cuda.synchronize()
        # forward and dgrad through the kernel; rows' gn forward is the plain one
        launched = kernels.CONV_ROWS.launches + kernels.CONV_FOLD.launches - counts
        assert launched == (1 if affine and backend == "rows" else 2)
        for p, q in zip(leaves, ref):
            assert _rel(p.grad, q.grad) <= 1e-5


# ------------------------------------------------ the bf16 conv kernel's tiling
def _flagship_conv_calls(backend, H, W, B=2):
    """(entry, x shape, OIHW w shape, with the prologue) of every conv that a
    forward and backward of the flagship UNet (width 64, the UnetWithWarp's
    9 input channels) sends to the backend's kernel, recorded on the meta
    device (the dgrads with the flipped kernel's shape)."""
    calls = []

    def record(name, plain):
        def fn(x, w, a=None, b=None):
            calls.append((name, tuple(x.shape), tuple(w.shape), a is not None))
            return plain(x, w) if a is None else pconv.conv2d_same_gn_plain(x, w, a, b)
        return fn

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(punet, "fused_linear_attention_block", paf.block_plain)
        mp.setattr(pconv, "conv_rows", record("conv_rows", pconv.conv2d_same_plain))
        mp.setattr(pconv, "conv_fold", record("conv_fold", pconv.conv2d_same_plain))
        with torch.device("meta"):
            net = punet.Unet(64, out_dim=2, channels=9, dtype=torch.bfloat16,
                             conv_backend=backend)
            x, cond = torch.empty(B, 6, H, W), torch.empty(B, 3, H, W)
            t = torch.zeros(B, dtype=torch.long)
        net(x, cond, t).sum().backward()
    finally:
        mp.undo()
    return calls


def _distinct_flagship_convs():
    """Distinct (x shape, w shape, prologue) of the flagship's fold convs at
    128x128 b8 and native 448x1024 b2, forward and dgrad."""
    return sorted({c[1:] for H, W, B in ((128, 128, 8), (448, 1024, 2))
                   for c in _flagship_conv_calls("fold", H, W, B)})


def test_conv_plan_holds_every_flagship_conv():
    """The bf16 kernel's plan (``conv_plan``) for every conv of the flagship
    at 128x128 and native 448x1024, forward and dgrad, taken from the model:
    strips of at most 64 columns (multiples of 8 where there are several)
    covering W, a pitch of the strip plus the kw - 1 halo, runs of 512
    positions covering H rows, a raw slice wide and tall enough for any
    run's patch, and shared memory within the 227 KB a CTA may have."""
    convs = _distinct_flagship_convs()
    assert len(convs) >= 10
    for (B, Cin, H, W), (Cout, _, kh, kw), _ in convs:
        p = pconv.conv_plan(B, Cin, H, W, Cout, kh, kw)
        assert p.wt <= pconv.STRIP_MAX and p.strips * p.wt >= W > (p.strips - 1) * p.wt
        assert p.strips == 1 or p.wt % 8 == 0
        assert p.pw == p.wt + kw - 1
        assert p.runs * pconv.TILE_M >= H * p.pw > (p.runs - 1) * pconv.TILE_M
        assert p.np == pconv.TILE_M + (kh - 1) * p.pw + kw - 1
        # the raw slice starts at the multiple of 8 at or below x0 - kw // 2
        assert p.rw % 8 == 0 and p.rw >= p.pw + 7
        rows = max((m0 + p.np - 1) // p.pw - m0 // p.pw + 1
                   for m0 in range(0, p.runs * pconv.TILE_M, pconv.TILE_M))
        assert p.rh >= rows and p.rh <= 256
        assert p.nblk * 64 >= Cout and p.nsl * 32 >= Cin
        assert p.tiles == B * p.strips * p.runs * p.nblk
        assert p.smem <= pconv.SMEM_MAX


@pytest.mark.parametrize("shape,plan", [
    # native level 0, 3x3 64 -> 64 at b2 (rows 9 and 10 of the kernel table)
    ((2, 64, 448, 1024, 64, 3, 3), (64, 66, 16, 58, 1, 2, 646, 80, 11, 1856)),
    # the native stem, 7x7 9 -> 64 (one raw stage)
    ((2, 9, 448, 1024, 64, 7, 7), (64, 70, 16, 62, 1, 1, 938, 80, 15, 1984)),
    # the widest conv, 768 -> 512 at 56x128 b2
    ((2, 768, 56, 128, 512, 3, 3), (64, 66, 2, 8, 8, 24, 646, 80, 11, 256)),
    # 128x128 level 3 (one strip, runs across rows)
    ((8, 512, 16, 16, 512, 3, 3), (16, 18, 1, 1, 8, 16, 550, 32, 32, 64)),
    # a ragged card case: W = 21 in one strip, Cout = 70 in two blocks
    ((1, 40, 13, 21, 70, 3, 3), (21, 23, 1, 1, 2, 2, 560, 32, 26, 2)),
])
def test_conv_plan_pins(shape, plan):
    p = pconv.conv_plan(*shape)
    assert tuple(p)[:10] == plan
    assert p.smem <= pconv.SMEM_MAX


def test_conv_layout_is_the_kernels_planes():
    """bf16 weights laid out [Cout / 64][Cin / 32][kh kw][4][64][8]: element
    (n, c, dy, dx) of the OIHW kernel at block n // 64, slice c // 32, tap
    dy kw + dx, plane (c % 32) // 8, row n % 64, column c % 8; zero past Cin
    and Cout.  f32 keeps [kh kw][Cin_pad][Cout_pad]."""
    rng = np.random.default_rng(20)
    w = torch.from_numpy(rng.standard_normal((70, 40, 3, 3)).astype(np.float32))
    lay = pconv._layout(w, torch.bfloat16)
    assert lay.shape == (2, 2, 9, 4, 64, 8)
    n, c, dy, dx = np.meshgrid(np.arange(70), np.arange(40), np.arange(3), np.arange(3),
                               indexing="ij")
    got = lay[n // 64, c // 32, dy * 3 + dx, (c % 32) // 8, n % 64, c % 8]
    assert torch.equal(got, w.to(torch.bfloat16)[n, c, dy, dx])
    assert float(lay.float().abs().sum()) == float(w.to(torch.bfloat16).float().abs().sum())
    lay32 = pconv._layout(w, torch.float32)
    assert lay32.shape == (9, 40, 128)
    assert torch.equal(lay32[:, :, :70], w.permute(2, 3, 1, 0).reshape(9, 40, 70))


@pytest.mark.cuda
def test_conv_kernels_take_every_flagship_conv_on_card(cuda_device):
    """Both entries, bf16, at every distinct conv of the flagship at 128x128
    b8 and native 448x1024 b2 (forward and dgrad shapes, from the model),
    against the plain versions; the prologue where the model uses it, and
    each kernel launched twice for the same bits."""
    dev = cuda_device
    for i, ((B, Cin, H, W), (Cout, _, kh, kw), pro) in enumerate(_distinct_flagship_convs()):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn(B, Cin, H, W, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(Cout, Cin, kh, kw, generator=g, device=dev) / (Cin * kh * kw) ** 0.5
        a = 1.0 + 0.5 * torch.rand(B, Cin, generator=g, device=dev)
        b = torch.randn(B, Cin, generator=g, device=dev)
        with torch.no_grad():
            rows, rows2 = pconv.conv_rows(x, w), pconv.conv_rows(x, w)
            want = pconv.conv2d_same_plain(x, w)
            got = [(rows, rows2, want)]
            if pro:
                got.append((pconv.conv_fold(x, w, a, b), pconv.conv_fold(x, w, a, b),
                            pconv.conv2d_same_gn_plain(x, w, a, b)))
            else:
                got.append((pconv.conv_fold(x, w), pconv.conv_fold(x, w), want))
            torch.cuda.synchronize()
        for one, two, ref in got:
            assert torch.equal(one, two), (x.shape, w.shape, pro)
            e = float((one.float() - ref.float()).abs().max())
            assert e <= _conv_tol(ref, torch.bfloat16), (x.shape, w.shape, pro, e)
        del x, w, got, rows, rows2, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_dgrad_with_flipped_kernel_on_card(cuda_device, no_tf32, dtype):
    """The dgrad launch of ``_ConvSame``'s backward: the kernel on the
    cotangent with the spatially flipped, io-swapped kernel, against the
    plain conv with the same kernel, at the native level-0 shape (bf16) and
    a narrow one; twice for the same bits."""
    dev = cuda_device
    shapes = [(2, 64, 32, 40, 64, 3)]
    if dtype == torch.bfloat16:
        shapes.append((2, 64, 448, 1024, 128, 3))
    for B, Cin, H, W, Cout, k in shapes:
        gen = torch.Generator(device=dev).manual_seed(7)
        g = torch.randn(B, Cout, H, W, generator=gen, device=dev).to(dtype)
        w = torch.randn(Cout, Cin, k, k, generator=gen, device=dev) / (Cin * k * k) ** 0.5
        wf = pconv._flip(w)
        with torch.no_grad():
            one, two = pconv.conv_fold(g, wf), pconv.conv_fold(g, wf)
            want = pconv.conv2d_same_plain(g, wf)
            torch.cuda.synchronize()
        assert one.shape == (B, Cin, H, W) and torch.equal(one, two)
        assert float((one.float() - want.float()).abs().max()) <= _conv_tol(want, dtype)
