"""The CUDA kernels of the fused linear-attention block (forward and
backward), of the splat (forward and backward) and of the UNet's convs
(rows and fold), and their wrappers.

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
