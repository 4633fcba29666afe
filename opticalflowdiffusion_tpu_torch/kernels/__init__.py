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
LA_BWD_Q = Kernel(
    "linear_attention_bwd_q",
    "opticalflowdiffusion_tpu_torch/kernels/linear_attention.cu",
    "opticalflowdiffusion_tpu/ops/attention_fused.py:303",
)
LA_BWD_KV1 = Kernel(
    "linear_attention_bwd_kv1",
    "opticalflowdiffusion_tpu_torch/kernels/linear_attention.cu",
    "opticalflowdiffusion_tpu/ops/attention_fused.py:434",
)
LA_BWD_KV2 = Kernel(
    "linear_attention_bwd_kv2",
    "opticalflowdiffusion_tpu_torch/kernels/linear_attention.cu",
    "opticalflowdiffusion_tpu/ops/attention_fused.py:459",
)
SPLAT = Kernel(
    "splat_fwd",
    "opticalflowdiffusion_tpu_torch/kernels/splat.cu",
    "opticalflowdiffusion_tpu/ops/splat.py:176",
)
SPLAT_BWD = Kernel(
    "splat_bwd",
    "opticalflowdiffusion_tpu_torch/kernels/splat.cu",
    "opticalflowdiffusion_tpu/ops/splat.py:521",
)
CONV_ROWS = Kernel(
    "conv_rows",
    "opticalflowdiffusion_tpu_torch/kernels/conv.cu",
    "opticalflowdiffusion_tpu/ops/conv_pallas.py:69",
)
CONV_FOLD = Kernel(
    "conv_fold",
    "opticalflowdiffusion_tpu_torch/kernels/conv.cu",
    "opticalflowdiffusion_tpu/ops/conv_pallas.py:255",
)
LA_MID_CTX = Kernel(
    "linear_attention_middle_ctx",
    "opticalflowdiffusion_tpu_torch/kernels/linear_attention.cu",
    "opticalflowdiffusion_tpu/ops/attention_pallas.py:49",
)
LA_MID_OUT = Kernel(
    "linear_attention_middle_out",
    "opticalflowdiffusion_tpu_torch/kernels/linear_attention.cu",
    "opticalflowdiffusion_tpu/ops/attention_pallas.py:89",
)
CORR = Kernel(
    "correlation_fwd",
    "opticalflowdiffusion_tpu_torch/kernels/correlation.cu",
    "opticalflowdiffusion_tpu/ops/correlation.py:28",
)
CORR_BWD = Kernel(
    "correlation_bwd",
    "opticalflowdiffusion_tpu_torch/kernels/correlation.cu",
    "opticalflowdiffusion_tpu/ops/correlation.py:28",
)
CORR_LOOKUP = Kernel(
    "corr_lookup_fwd",
    "opticalflowdiffusion_tpu_torch/kernels/corr_lookup.cu",
    "opticalflowdiffusion_tpu/models/raft.py:95",
)
CORR_LOOKUP_BWD = Kernel(
    "corr_lookup_bwd",
    "opticalflowdiffusion_tpu_torch/kernels/corr_lookup.cu",
    "opticalflowdiffusion_tpu/models/raft.py:95",
)
KERNELS = (LA_CTX, LA_OUT, LA_BWD_Q, LA_BWD_KV1, LA_BWD_KV2, FLASH, SPLAT, SPLAT_BWD,
           CONV_ROWS, CONV_FOLD, LA_MID_CTX, LA_MID_OUT, CORR, CORR_BWD, CORR_LOOKUP,
           CORR_LOOKUP_BWD)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["Kernel", "KERNELS", "CONV_FOLD", "CONV_ROWS", "CORR", "CORR_BWD", "CORR_LOOKUP",
           "CORR_LOOKUP_BWD", "FLASH",
           "LA_BWD_KV1", "LA_BWD_KV2", "LA_BWD_Q", "LA_CTX", "LA_MID_CTX", "LA_MID_OUT", "LA_OUT",
           "SPLAT", "SPLAT_BWD", "reset_counts"]
