"""Port vs JAX: the bottleneck attention middle.  ``flash_plain`` (the
recurrence of the flash kernel in plain PyTorch) against JAX's Pallas
``_flash_middle_pallas`` in interpret mode, and ``attention_middle`` on the
CPU against ``_attention_middle_xla``; the dispatch; and, on the card, the
CUDA kernel against its plain version.  JAX is imported inside the tests that
compare with it, so that the card's cases also run where there is no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_flash.py -m cuda
"""

import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch.ops import flash_attention as pfa

# the JAX flash tests' own pins (tests/test_flash_attention.py)
TOL = {"float32": dict(rtol=2e-3, atol=2e-5), "bfloat16": dict(rtol=0.1, atol=0.05)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_flash():
    """(jnp, pltpu, the JAX package's flash_attention module)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("compares with the JAX package on the CPU (interpret mode)")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from opticalflowdiffusion_tpu.ops import flash_attention as jfa

    return jnp, pltpu, jfa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, B, N, h=4, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, h, d)).astype(np.float32) * d ** -0.5
    k = rng.standard_normal((B, N, h, d)).astype(np.float32)
    v = rng.standard_normal((B, N, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N", [(2, 700), (1, 256)])
def test_flash_plain_matches_pallas_interpret(jax_flash, B, N, dtype):
    """N = 700 is not a multiple of the key block: padded keys at -1e30."""
    jnp, pltpu, jfa = jax_flash
    q, k, v = _qkv(N, B, N)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash_middle_pallas(
            *(jnp.asarray(a, jd) for a in (q, k, v)), block_q=256, block_k=128
        ).astype(jnp.float32))
    got = pfa.flash_plain(*(torch.from_numpy(a).to(td) for a in (q, k, v)), block_k=128)
    assert got.dtype == td and got.shape == (B, N, 4, 32)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N", [(2, 700), (1, 256)])
def test_attention_middle_cpu_matches_xla(jax_flash, B, N, dtype):
    jnp, _, jfa = jax_flash
    q, k, v = _qkv(N + 1, B, N)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jfa._attention_middle_xla(
        *(jnp.asarray(a, jd) for a in (q, k, v))).astype(jnp.float32))
    got = pfa.attention_middle(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_cpu_tensor_launches_nothing():
    """On the CPU even N >= FLASH_MIN_N takes the composition, as in JAX."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, pfa.FLASH_MIN_N, h=1))
    before = [k_.launches for k_ in kernels.KERNELS]
    out = pfa.attention_middle(q, k, v)
    assert [k_.launches for k_ in kernels.KERNELS] == before
    np.testing.assert_array_equal(out.numpy(), pfa.attention_middle_plain(q, k, v).numpy())
    with pytest.raises(ValueError):
        pfa.flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N", [(2, 2048), (1, 2100)])
def test_flash_kernel_matches_plain_on_card(cuda_device, B, N, dtype):
    """The kernel on q, k, v laid out as the UNet's to_qkv output, against
    flash_plain; one launch per call through attention_middle."""
    g = torch.Generator(device=cuda_device).manual_seed(N)
    qkv = torch.randn(B, 3, 4, 32, N, generator=g, device=cuda_device).to(dtype)
    q = (qkv[:, 0] * 32 ** -0.5).permute(0, 3, 1, 2)
    k, v = qkv[:, 1].permute(0, 3, 1, 2), qkv[:, 2].permute(0, 3, 1, 2)
    n0 = kernels.FLASH.launches
    with torch.no_grad():
        got = pfa.attention_middle(q, k, v).float()
        want = pfa.flash_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert kernels.FLASH.launches == n0 + 1
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((got - want).abs().max()) <= tol
