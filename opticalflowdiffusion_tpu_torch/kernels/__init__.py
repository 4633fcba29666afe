"""Hand-written CUDA kernels: sources, build (``build.py``) and launch counts.

Every kernel wrapper owns a :class:`Kernel` whose ``launches`` it raises by
one each time it launches the kernel, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations


class Kernel:
    """Identity and launch count of one hand-written kernel."""

    def __init__(self, name: str, source: str, replaces: str, route: str = "cuda"):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.route = route
        self.launches = 0


LA_CTX = Kernel(
    "linear_attention_ctx",
    "opticalflowdiffusion_tpu_torch/kernels/linear_attention.cu",
    "opticalflowdiffusion_tpu/ops/attention_fused.py:131",
)
LA_OUT = Kernel(
    "linear_attention_out",
    "opticalflowdiffusion_tpu_torch/kernels/linear_attention.cu",
    "opticalflowdiffusion_tpu/ops/attention_fused.py:189",
)
FLASH = Kernel(
    "flash_attention",
    "opticalflowdiffusion_tpu_torch/kernels/flash_attention.cu",
    "opticalflowdiffusion_tpu/ops/flash_attention.py:62",
)
SPLAT = Kernel(
    "splat_linear_unn",
    "opticalflowdiffusion_tpu_torch/kernels/splat.cu",
    "opticalflowdiffusion_tpu/ops/splat.py:176",
)
KERNELS = (LA_CTX, LA_OUT, FLASH, SPLAT)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["Kernel", "KERNELS", "FLASH", "LA_CTX", "LA_OUT", "SPLAT", "reset_counts"]
