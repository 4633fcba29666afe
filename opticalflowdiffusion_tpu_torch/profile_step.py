"""Where the time of one UNet eval, or one train step, of the flagship (or of
FlowLearner's train step) goes on the card.

    python -m opticalflowdiffusion_tpu_torch.profile_step [--steps 10] [--seed 0] \
        [--batch 8] [--height 128 --width 128] [--train [--remat]] \
        [--conv-backend {cudnn,rows,fold}] [--algorithm flow_learner [--precision bf16]]

Builds the flagship as ``sample.py`` does (bf16, weights from ``--seed``) on
a batch of ``--batch`` at ``--height`` x ``--width`` (default 128x128 b8;
448x1024 is native Sintel), warms up, times ``--steps`` UnetWithWarp evals with the
host clock around synchronised runs, then traces the same evals with
``torch.profiler``.  With ``--train`` the unit is one train step instead
(augment, pyramid loss, backward, clip, Adam; default batch 16, on a
standard-normal batch from numpy seed ``--seed`` as the JAX ``bench.py``
train row; ``--remat`` recomputes the UnetWithWarp closure in the backward,
as the native row ``--train --batch 2 --height 448 --width 1024 --remat``
does).  Prints one JSON line: wall ms per unit, device-busy ms per
unit (the union of the traced kernels' intervals), the device's idle
share, the kernel count per unit, kernel time per unit grouped by kind,
and the slowest kernels.  ``--conv-backend`` lowers the UNet's convs
(``ops/conv.py``; default cudnn).  ``--algorithm flow_learner`` profiles
FlowLearner's train step instead (``--train`` implied; the reference's ten
pyramid levels, weights from ``--seed`` with the output conv not zeroed,
``--precision`` float32 by default, as the JAX ``bench.py`` row
``flow_learner_train_samples_per_sec``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import dataclasses

import numpy as np
import torch

from .algorithms.base import to_batch
from .algorithms.flow_learner import FlowLearner
from .config import FLOW_LEARNER, MATRIX_FLOW
from .experiments.base import to_device
from .ops.conv import BACKENDS
from .parallel.train import TrainState, make_optimizer, make_train_step
from .sample import batch_items, build

KINDS = (
    ("linear_attention_bwd", ("la_bwd_", "la_reduce_kernel")),
    ("linear_attention", ("la_ctx_", "la_out_")),  # the passes, their f32 bodies, the combine
    ("flash_attention", ("flash_bf16_kernel", "flash_f32_kernel")),
    ("splat_bwd", ("splat_bwd_",)),  # the channels-last layout pass and the gathers
    ("splat", ("splat_max_kernel", "splat_scatter_kernel", "splat_finish_kernel")),
    ("conv_kernel", ("conv_bf16_kernel", "conv_f32_kernel")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop", "dgrad", "wgrad")),
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


def _profile(work, steps: int, unit: str) -> dict:
    """Time ``work`` (``steps`` units, ending synchronised) on the host clock
    after a warm-up, then trace it; the profile's numbers per ``unit``."""
    work()                                    # warm-up (cuDNN, kernel build)
    t0 = time.perf_counter()
    work()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        work()
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
        f"{unit}s": steps,
        f"wall_ms_per_{unit}": wall_ms,
        f"device_busy_ms_per_{unit}": busy_ms,
        "idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / wall_ms),
        f"kernels_per_{unit}": len(kernels) / steps,
        f"kernel_ms_per_{unit}_by_kind": {k: v / 1e3 / steps for k, v in by_kind.most_common()},
        f"top_kernels_ms_per_{unit}": {k: v / 1e3 / steps for k, v in by_name.most_common(12)},
    }


def run(steps: int, seed: int, batch: int = 8, height: int = 128, width: int = 128,
        conv_backend: str = "cudnn") -> dict:
    """The profile of ``steps`` UnetWithWarp evals."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    algo, _ = build(seed, "cuda", conv_backend=conv_backend)
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

    return {"batch": batch, "height": height, "width": width, "conv_backend": conv_backend,
            **_profile(evals, steps, "eval")}


def run_train(steps: int, seed: int, batch: int = 16, height: int = 128,
              width: int = 128, conv_backend: str = "cudnn", remat: bool = False,
              algorithm: str = "flow_diffuser", precision=None) -> dict:
    """The profile of ``steps`` train steps (the algorithm's optimizer)."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    if algorithm == "flow_learner":
        cfg = dataclasses.replace(FLOW_LEARNER, image_size=height, zero_init=False,
                                  precision=precision or "float32", conv_backend=conv_backend)
        algo = FlowLearner(cfg, "cuda", torch.Generator().manual_seed(seed))
    else:
        algo, _ = build(seed, "cuda", conv_backend=conv_backend, remat=remat)
    cfg = algo.cfg
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, MATRIX_FLOW.clipping))
    step = make_train_step(algo.loss_fn)
    rng = np.random.default_rng(seed)
    data = to_device(tuple(rng.standard_normal((batch, height, width, c)).astype(np.float32)
                           for c in (3, 3, 2)), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    algo.module.train()

    def train_steps():
        for _ in range(steps):
            step(state, data, gen)
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    out = _profile(train_steps, steps, "step")
    return {"algorithm": algorithm, "precision": cfg.precision, "batch": batch,
            "height": height, "width": width, "conv_backend": conv_backend,
            "remat": remat, "train_samples_per_s": batch * 1e3 / out["wall_ms_per_step"],
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9, **out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=None, help="default 8, and 16 with --train")
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--train", action="store_true", help="profile train steps")
    ap.add_argument("--conv-backend", choices=BACKENDS, default="cudnn")
    ap.add_argument("--remat", action="store_true",
                    help="with --train: recompute the UnetWithWarp closure in the backward")
    ap.add_argument("--algorithm", choices=("flow_diffuser", "flow_learner"),
                    default="flow_diffuser")
    ap.add_argument("--precision", choices=("bf16", "float32"), default=None,
                    help="FlowLearner's compute dtype (default float32)")
    args = ap.parse_args(argv)
    if args.remat and not args.train:
        ap.error("--remat needs --train")
    if args.train or args.algorithm == "flow_learner":
        out = run_train(args.steps, args.seed, args.batch or MATRIX_FLOW.batch_size,
                        args.height, args.width, args.conv_backend, args.remat,
                        args.algorithm, args.precision)
    else:
        out = run(args.steps, args.seed, args.batch or 8, args.height, args.width,
                  args.conv_backend)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
