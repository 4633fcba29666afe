"""The CUDA kernels of the fused linear-attention block and of the splat, and
their wrappers.

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
    xt, tp = _inputs(8, 1, 64, 64)
    xt = xt.to(cuda_device).requires_grad_()
    tp = tuple(t.to(cuda_device) for t in tp)
    with pytest.raises(RuntimeError):
        paf.fused_linear_attention_block(xt, *tp)


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
    a = psplat_.splat_linear_unn(x, flow, metric)
    b = psplat_.splat_linear_unn(x, flow, metric)
    want = psplat_.splat_raw(torch.cat([x * metric, metric], dim=1), flow).float()
    torch.cuda.synchronize()
    assert kernels.SPLAT.launches == n0 + 2
    assert torch.equal(a, b)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((a.float() - want).abs().max()) <= rel * float(want.abs().max()) + 1e-6
