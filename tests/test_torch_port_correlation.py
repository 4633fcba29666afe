"""The correlation kernels (``kernels/correlation.cu``) against the plain
version (``ops/correlation.py::local_correlation_plain`` and the reorder).
On the CPU: the wrappers refuse CPU tensors, and ``local_correlation``
runs the plain version there.  Marked ``cuda`` (skipped where there is no
card): the forward and both cotangents at sizes below the patch, at a
level's shape and at ragged ones, f32 and bf16, every direction, within
1e-5 (f32) or 2^-7 (bf16) of the plain version's largest value (its sums
in float32, rounded once as the kernel's), a repeat bit for bit, and a
PWCNet forward on the kernels against the same on the plain version (TF32
off).  This
file imports no JAX, so the card runs it with ``--noconftest``."""

import pytest
import torch

from opticalflowdiffusion_tpu_torch.models import pwc_net as ppwc
from opticalflowdiffusion_tpu_torch.models.unet import init_weights
from opticalflowdiffusion_tpu_torch.ops import correlation as pcorr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_wrappers_refuse_cpu_tensors():
    a = torch.zeros(1, 2, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        pcorr.corr_fwd(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        pcorr.corr_bwd(a, a, torch.zeros(1, 81, 3, 3))


@pytest.mark.parametrize("direction", (None, "fwd", "bwd"))
def test_cpu_path_is_the_plain_version(direction):
    """On CPU tensors ``local_correlation`` is the plain version (then the
    reorder), and each channel is its displacement's dot product."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(2, 3, 6, 7, generator=g), torch.randn(2, 3, 6, 7, generator=g)
    got = pcorr.local_correlation(a, b, direction)
    want = pcorr.pwc_index_reorder(pcorr.local_correlation_plain(a, b), direction)
    assert torch.equal(got, want)
    idx = pcorr.reorder_index(direction)
    for p in (0, 40, 80, 13):
        i, j = divmod(int(idx[p]), 9)
        dy, dx = i - 4, j - 4
        ref = torch.zeros(2, 6, 7)
        for y in range(6):
            for x in range(7):
                if 0 <= y + dy < 6 and 0 <= x + dx < 7:
                    ref[:, y, x] = (a[:, :, y, x] * b[:, :, y + dy, x + dx]).sum(1)
        torch.testing.assert_close(got[:, p], ref, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- the CUDA kernels
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("shape", ((2, 3, 5, 4), (2, 32, 28, 64), (1, 20, 37, 45)))
@pytest.mark.parametrize("direction", (None, "fwd", "bwd"))
def test_kernels_match_plain(cuda_device, dtype, shape, direction):
    """Forward and both cotangents against the plain version (its sums in
    float32, rounded once as the kernel's), and a repeat bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    a, b = (torch.randn(*shape, generator=g, device="cuda").to(dtype) for _ in range(2))
    cot = torch.randn(shape[0], 81, *shape[2:], generator=g, device="cuda").to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    la, lb = (t.float().requires_grad_() for t in (a, b))
    want = pcorr.pwc_index_reorder(pcorr.local_correlation_plain(la, lb), direction)
    wa, wb = torch.autograd.grad(want, (la, lb), cot.float())
    got = pcorr.corr_fwd(a, b, direction)
    ga, gb = pcorr.corr_bwd(a, b, cot, direction)
    for x, y in ((got, want), (ga, wa), (gb, wb)):
        assert x.dtype == dtype
        y = y.detach().to(dtype).float()
        assert float((x.float() - y).abs().max()) <= tol * float(y.abs().max())
    assert torch.equal(got, pcorr.corr_fwd(a, b, direction))
    assert all(torch.equal(x, y) for x, y in zip((ga, gb), pcorr.corr_bwd(a, b, cot, direction)))


@pytest.mark.cuda
def test_pwcnet_on_the_kernels_matches_plain(cuda_device):
    """A PWCNet forward on the card through the kernels against the same
    through the plain version (64x64 b2, f32, TF32 off: cuDNN's TF32 convs
    would turn the sums' last-bit differences into 1e-3 ones): the finest
    forward flow within 1e-4 of its largest value."""
    net = init_weights(ppwc.PWCNet(), torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = [torch.rand(2, 3, 64, 64, generator=g, device=cuda_device) for _ in range(3)]
    saved = (ppwc.local_correlation, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            out = net(frames[1], [frames[0], frames[2]])[0][0]
            ppwc.local_correlation = lambda a, b, d=None: pcorr.pwc_index_reorder(
                pcorr.local_correlation_plain(a, b), d)
            ref = net(frames[1], [frames[0], frames[2]])[0][0]
    finally:
        (ppwc.local_correlation, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
