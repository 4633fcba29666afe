"""RAFT's windowed-lookup kernels (``kernels/corr_lookup.cu``, S4) against
the plain version (``ops/correlation.py::corr_lookup_plain`` and its
autograd).  On the CPU: the wrappers refuse CPU tensors, and
``corr_lookup`` runs the plain version there.  Marked ``cuda`` (skipped
where there is no card): the forward and the levels' cotangents at radii 1
and 4 over pyramids of two to four levels (odd and even level sides,
points past every border), within 1e-6 (forward) and 1e-5 (cotangents) of
the plain version's largest value, a repeat bit for bit, and RAFT at 64x64
b2 on the kernels against the same on the plain version (TF32 off).  This
file imports no JAX, so the card runs it with ``--noconftest``."""

import pytest
import torch

from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch.models import raft as praft
from opticalflowdiffusion_tpu_torch.models.unet import init_weights
from opticalflowdiffusion_tpu_torch.ops import correlation as pcorr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _case(B, H, W, levels, device="cpu", seed=0, spread=9.0):
    g = torch.Generator().manual_seed(seed)
    f1, f2 = torch.randn(B, 16, H, W, generator=g), torch.randn(B, 16, H, W, generator=g)
    pyramid = [t.to(device) for t in praft.corr_pyramid(f1, f2, levels)]
    grid = praft.coords_grid(B, H, W).permute(0, 2, 3, 1)
    coords = grid + (torch.rand(B, H, W, 2, generator=g) * 2 - 1) * spread
    coords[0, 0, :3] = torch.tensor([[-30.0, 0.5], [2.0, 3.0], [W + 20.0, -7.25]])
    return pyramid, coords.to(device)


def test_wrappers_refuse_cpu_tensors():
    pyramid, coords = _case(1, 4, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pcorr.corr_lookup_fwd(pyramid, coords)
    with pytest.raises(ValueError, match="CUDA"):
        pcorr.corr_lookup_bwd([(4, 4), (2, 2)], coords, torch.zeros(1, 4, 4, 162))


def test_cpu_path_is_the_plain_version():
    pyramid, coords = _case(2, 6, 10, 2, seed=1)
    before = kernels.CORR_LOOKUP.launches
    assert torch.equal(pcorr.corr_lookup(pyramid, coords, 4),
                       pcorr.corr_lookup_plain(pyramid, coords, 4))
    assert kernels.CORR_LOOKUP.launches == before


# ------------------------------------------------------- the CUDA kernels
@pytest.mark.cuda
@pytest.mark.parametrize("radius", (1, 4))
@pytest.mark.parametrize("shape", ((1, 4, 6, 2), (2, 6, 10, 2), (2, 28, 64, 3), (1, 16, 8, 4)))
def test_kernels_match_plain(cuda_device, shape, radius):
    """Forward and the levels' cotangents against the plain version, and a
    repeat bit for bit."""
    B, H, W, L = shape
    pyramid, coords = _case(B, H, W, L, cuda_device, seed=H * W + radius)
    K = (2 * radius + 1) ** 2
    cot = torch.randn(B, H, W, len(pyramid) * K, device=cuda_device)
    levels = [t.clone().requires_grad_() for t in pyramid]
    want = pcorr.corr_lookup_plain(levels, coords, radius)
    wgrads = torch.autograd.grad(want, levels, cot)
    got = pcorr.corr_lookup_fwd(pyramid, coords, radius)
    ggrads = pcorr.corr_lookup_bwd([t.shape[1:] for t in pyramid], coords, cot, radius)
    scale = float(want.abs().max())
    assert float((got - want.detach()).abs().max()) <= 1e-6 * scale
    for g, w in zip(ggrads, wgrads):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    assert torch.equal(got, pcorr.corr_lookup_fwd(pyramid, coords, radius))
    again = pcorr.corr_lookup_bwd([t.shape[1:] for t in pyramid], coords, cot, radius)
    assert all(torch.equal(a, b) for a, b in zip(ggrads, again))


@pytest.mark.cuda
def test_autograd_function_counts_and_refuses_coords_gradients(cuda_device):
    pyramid, coords = _case(2, 6, 10, 2, cuda_device)
    levels = [t.clone().requires_grad_() for t in pyramid]
    kernels.reset_counts()
    pcorr.corr_lookup(levels, coords).sum().backward()
    assert kernels.CORR_LOOKUP.launches == 1 and kernels.CORR_LOOKUP_BWD.launches == 1
    with pytest.raises(ValueError, match="detach"):
        pcorr.corr_lookup(pyramid, coords.clone().requires_grad_())


@pytest.mark.cuda
def test_raft_on_the_kernels_matches_plain(cuda_device):
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = torch.Generator(device=cuda_device).manual_seed(0)
        f1 = torch.rand(2, 3, 64, 64, generator=g, device=cuda_device)
        f2 = torch.roll(f1, (2, -3), dims=(2, 3))
        net = init_weights(praft.RAFT(iters=3, corr_levels=4),
                           torch.Generator().manual_seed(0)).to(cuda_device)
        with torch.no_grad():
            got = net(f1, f2)
            plain = pcorr.corr_lookup
            try:
                praft.corr_lookup = pcorr.corr_lookup_plain
                want = net(f1, f2)
            finally:
                praft.corr_lookup = plain
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    finally:
        torch.backends.cudnn.allow_tf32 = True
