"""The CUDA kernels of the fused linear-attention block (forward and
backward) and of the splat (forward and backward), and their wrappers.

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
from opticalflowdiffusion_tpu_torch.ops import attention_fused as paf
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
    """A gradient through the kernels at N >= 1024 needs the backward
    kernels, which take C <= 256: a wider block refuses it when the forward
    runs; below N = 1024 the backward is the composition's and any C goes."""
    xt, tp = _inputs(8, 1, 1024, 512)
    xt = xt.to(cuda_device).requires_grad_()
    tp = tuple(t.to(cuda_device) for t in tp)
    with pytest.raises(ValueError):
        paf.fused_linear_attention_block(xt, *tp)
    xs, ts = _inputs(8, 1, 64, 512)
    xs = xs.to(cuda_device).requires_grad_()
    paf.fused_linear_attention_block(xs, *(t.to(cuda_device) for t in ts)).sum().backward()
    assert xs.grad is not None and torch.isfinite(xs.grad).all()


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C", [(2, 1000, 64), (2, 1024, 256), (1, 2100, 128)])
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, B, N, C):
    """Pass B', A'1 and A'2 against bwd_q_plain, bwd_kv1_plain and
    bwd_kv2_plain with the same bf16 operands: f32 sums in another order,
    within 1e-3 of each output's largest value (measured <= 3e-4 on an
    H100); each launch counted once; two launches give the same bits."""
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
    got_s = paf.linear_attention_bwd_kv1(x, g_pre, w_kv, m, s, dctx)
    want_s = paf.bwd_kv1_plain(x, g_pre, w_kv, m, s, dctx)
    got_kv = paf.linear_attention_bwd_kv2(x, g_pre, w_kv, m, s, dctx, want_s, want_q[0])
    want_kv = paf.bwd_kv2_plain(x, g_pre, w_kv, m, s, dctx, want_s, want_q[0])
    again = paf.linear_attention_bwd_q(x, dy, g_pre, w_q, ctx, wo, b_out, g_post)
    torch.cuda.synchronize()
    assert [k.launches for k in (kernels.LA_BWD_Q, kernels.LA_BWD_KV1, kernels.LA_BWD_KV2)] \
        == [n0[0] + 2, n0[1] + 1, n0[2] + 1]
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0      # dx rounded to bf16
    for i, (a, b) in enumerate(zip(got_q, want_q)):
        assert _rel(a, b) <= 1e-3 + (ulp if i == 0 else 0.0), i
    assert _rel(got_s, want_s) <= 1e-3
    for i, (a, b) in enumerate(zip(got_kv, want_kv)):
        assert _rel(a, b) <= 1e-3 + (ulp if i == 0 else 0.0), i
    assert all(torch.equal(a, b) for a, b in zip(got_q, again))


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
