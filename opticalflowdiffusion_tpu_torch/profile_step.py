"""Where the time of one UNet eval of the flagship goes on the card.

    python -m opticalflowdiffusion_tpu_torch.profile_step [--steps 10] [--seed 0] \
        [--batch 8] [--height 128 --width 128]

Builds the flagship as ``sample.py`` does (bf16, weights from ``--seed``) on
a batch of ``--batch`` at ``--height`` x ``--width`` (default 128x128 b8;
448x1024 is native Sintel), warms up, times ``--steps`` UnetWithWarp evals with the
host clock around synchronised runs, then traces the same evals with
``torch.profiler``.  Prints one JSON line: wall ms per eval, device-busy ms
per eval (the union of the traced kernels' intervals), the device's idle
share, the kernel count per eval, kernel time per eval grouped by kind,
and the slowest kernels.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from .algorithms.base import to_batch
from .sample import batch_items, build

KINDS = (
    ("linear_attention", ("la_ctx_kernel", "la_out_kernel")),
    ("flash_attention", ("flash_bf16_kernel", "flash_f32_kernel")),
    ("splat", ("splat_max_kernel", "splat_scatter_kernel", "splat_finish_kernel")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop", "dgrad")),
    ("gemm", ("gemm", "cutlass", "matmul")),
    ("index", ("index", "scatter", "gather")),
    ("reduction", ("reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def run(steps: int, seed: int, batch: int = 8, height: int = 128, width: int = 128) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    algo, _ = build(seed, "cuda")
    items = batch_items(seed, batch, height, width)
    _, cond, _ = algo.preprocess(to_batch(items, algo.device))
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, algo.channels, height, width, generator=g, device="cuda")
    t = torch.full((batch,), 500, dtype=torch.long, device="cuda")

    def evals():
        with torch.no_grad():
            for _ in range(steps):
                algo.module(x, cond, t)
        torch.cuda.synchronize()

    evals()                                   # warm-up (cuDNN, kernel build)
    t0 = time.perf_counter()
    evals()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        evals()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_kind = collections.Counter()
    by_name = collections.Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name)] += us
        by_name[e.name[:80]] += us
    busy_ms = busy_us(spans) / 1e3 / steps if spans else None
    return {
        "device": torch.cuda.get_device_name(0),
        "batch": batch, "height": height, "width": width,
        "evals": steps,
        "wall_ms_per_eval": wall_ms,
        "device_busy_ms_per_eval": busy_ms,
        "idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / wall_ms),
        "kernels_per_eval": len(kernels) / steps,
        "kernel_ms_per_eval_by_kind": {k: v / 1e3 / steps for k, v in by_kind.most_common()},
        "top_kernels_ms_per_eval": {k: v / 1e3 / steps for k, v in by_name.most_common(12)},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.steps, args.seed, args.batch, args.height, args.width)),
          flush=True)


if __name__ == "__main__":
    main()
