"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Budget: under 10 minutes on one H100, the kernel build included (one plain
``nvcc`` call per source, all started together; seconds each).  A run takes
about four minutes on an H100.  Every line
it prints is one JSON object, flushed as it goes, apart from the card's
``nvidia-smi`` line.  Phases:

1. device: needs ``torch.cuda.is_available()``; prints the name and power
   limit of the card as ``nvidia-smi`` gives them (again before the kernels
   line), and its top SM clock.
2. build: compiles every CUDA source of the port (in parallel) and prints
   the seconds.
3. kernel_vs_plain: each kernel against its plain PyTorch version on the
   card, with errors, CUDA-event times and the least time the card could
   take (bound):
   - both linear-attention passes at every (N, C) of the 128x128 UNet,
     batch 8, and of the native 448x1024 UNet, batch 2, bf16 and f32 x;
   - the flash kernel at (2, 7168, 4, 32) bf16 and f32, (8, 7168, 4, 32)
     bf16 and (1, 2100, 4, 32) bf16 (N not a multiple of the tile), against
     ``flash_plain`` and the composition, beside one PyTorch
     ``scaled_dot_product_attention`` call (a yardstick only);
   - the splat at 128x128 b8 and 448x1024 b2: bit for bit against
     ``splat_fixed_plain`` (values as integers and the hole mask), against
     ``splat_raw`` within TOL_SPLAT, two launches bit for bit, and the
     modelled share of corners beyond the windows (the kernel's own windows,
     ``ofd_splat_windows``, on the plain version's targets); then bit for
     bit at 64x96 over scales 1-16 with offsets, at 1, 3, 5 and 9 channels
     and at sizes no multiple of the tile or the scale (100x70, 37x29),
     with flows of 4 and 40 px, zero, 1e6 px with 1e-20 weights and
     non-finite values, the zero flow at scale 16 at 128x128 b16 and the
     tiny-weight flow at 448x1024;
   - the three backward passes of the linear-attention block at every
     (N, C) of a 128x128 b16 train step that takes them (N >= 1024: five
     shapes, six launches a pass) and at every (N, C) of a native 448x1024
     b2 train step (all 8 blocks, C up to 512), bf16 and f32 x,
     against ``bwd_q_plain``, ``bwd_kv1_plain`` and ``bwd_kv2_plain`` (row
     4 takes the context kernel's ctx and dctx, its plain version
     recomputes over N; two launches bit for bit; ``torch.einsum`` of ctx
     and dctx is its yardstick); each line carries the bounds, rows 3 and 5
     with their f32 products counted in split TF32 and on f32 CUDA cores
     (``*_bound_ms_f32_cores``);
   - the flash kernel under autograd at (2, 7168, 4, 32) bf16: its
     gradients against the composition's autograd, with the times and the
     peak memory of both backwards;
   - the unfused middle's two kernels (rows 7-8) against
     ``middle_ctx_plain`` and ``middle_out_plain`` at the qkv shape of every
     block of a 128x128 b8 and a native b2 UNet eval, bf16 and f32, two
     launches bit for bit, beside the composition's time;
   - the splat backward at scales 1, 2, 4, 8 and 16 at 128x128 b16 and at
     scale 1 at 448x1024 b2, against ``splat_bwd_raw``, and the hole mask
     of the tiny-weight construction at 448x1024 against the plain path's;
   - the two conv kernels (``conv_rows``, ``conv_fold``) against
     ``conv2d_same_plain`` (and ``conv_fold`` with its prologue against
     ``conv2d_same_gn_plain``) at the level-0 3x3 64->64 and the 7x7 stem
     at 448x1024 b2, the widest conv (768->512) at 56x128 b2 and the level-0
     conv at 128x128 b8, bf16 and f32 (TF32 off for the f32 plain version);
     two launches bit for bit; one ``F.conv2d`` (cuDNN) call on the same
     NCHW tensors as the yardstick.
4. slice: the flagship FlowDiffuser (UNet width 64, bf16, weights from a
   seed, output conv not zeroed).  At 128x128 on a batch of 8 from the
   artificial dataset: one UnetWithWarp forward with the kernels against
   the same forward with the plain linear attention; then DDIM-50 and the
   1000-step ancestral loop.  At native 448x1024 (the artificial dataset
   rendered at 1024 and cropped to 448 rows): one UnetWithWarp forward at
   b2 with all kernels against the same forward with all plain versions;
   then DDIM-50 at b2 and b8 and DPM++(2M)-20 at b2, each after a warm-up
   UNet eval.  Under the opt-in conv backends (``ops/conv.py``): one native
   b2 UnetWithWarp forward under ``fold`` with every kernel against the
   same forward with every plain version (one under ``rows`` at 128x128);
   ``PreNormResidual(LinearAttention)`` on the middle's kernels, on the
   composition, and the fused ``LinearAttentionBlock`` loaded from the same
   state_dict at every native block shape, with a backward through the
   module at native level 0 and at (7168, 512), in a count window of its
   own (one launch of each middle kernel per forward, none in a backward);
   DDIM-50 at 128x128 b8 under ``fold`` and ``rows`` and at native b2 under
   ``fold``, their rates printed beside the cuDNN paths'.  Each sampling
   path is one count window: the launch counts
   are set to 0, the batch is preprocessed (a splat) and sampled, and each
   kernel's count is checked against what that path must launch.  The
   samples keep the NaN holes of the splat: a hole in the state stays a
   hole, and with random weights the predicted flow moves from step to step.
   The checks are on shapes, the finite flow and the finiteness of every
   non-NaN value.
5. train: the flagship trained at 128x128 b16 (random weights from a seed,
   output conv not zeroed, a standard-normal batch from numpy seed 0, as
   the JAX ``bench.py`` train row): one step with every kernel against the
   same step with every plain version (loss and per-leaf gradients; the
   plain splat sums in float64, so the reference is the same every run),
   and rows 3, 4 and 5 against their plain versions on the activations
   captured from that step's block backwards (``kernel_vs_plain`` lines at
   ``train_activations_128x128_b16``, TOL_BWD), and the splat forward bit
   for bit against ``splat_fixed_plain`` on the inputs of that step's 10
   splats (``splat_on_step_inputs``, with their times); one
   count window of 8 steps (augment, loss, backward, clip, Adam) whose
   launches must be 8x a step's (6 per backward pass, 5 splat backward, 10
   splat forward); train samples/s over the last 6 of them after 2
   warm-ups, synchronised, host clock.  Then ``train.py``'s run with the
   real flagship config: 3 steps, a validation (DDIM-10) and a checkpoint,
   continued to 5 steps; a fresh run restored from the step-3 checkpoint
   must hold the saved step, parameters, optimizer state and generator bit
   for bit, and ``train.py --resume`` must give the uninterrupted run's
   losses at steps 4 and 5 within the run-to-run spread of a second
   restored run (cuDNN's backward is not bit-deterministic).  Under
   ``fold``: one step with every kernel against the same step with every
   plain version (bf16, and f32 with TF32 off on both sides), and a count
   window of 8 steps whose launches add 87 ``conv_fold`` a step (44 forward,
   43 dgrad), its samples/s printed beside the cuDNN window's.  Then
   ``train.py --remat`` for 2 steps at 128x128.
6. native_train: the flagship trained at native 448x1024 b2 with remat (the
   JAX ``bench.py`` row ``sintel_native_train_samples_per_sec``): one step
   with every kernel against the all-plain step (bf16), with rows 3-5 on its
   captured activations (``train_activations_448x1024_b2``) and the splat on
   its 11 splats' inputs; a count window of 2
   warm-up and 3 timed steps with exact launches, native train samples/s and
   the window's peak memory.
7. profiler: device times from ``torch.profiler``, after the last
   host-clock window, so that no profiler trace runs before one: the
   splat forward by pass and its launches per call at 128x128 b8 and
   448x1024 b2 (bf16, f32) and at the pyramid loss's f32 scales 2-16 at
   128x128 b16 by a flow and by a zero flow (``splat_by_pass`` lines, with
   CUDA-event ms taken before the first trace); row 4's device time a
   launch at b16 and b2 and an empty kernel's (``device_times``).
8. the kernels line: for each kernel its route, source, the TPU kernel it
   replaces, launches over all count windows, error, ms, plain ms, bound
   ms and what bounds it, library ms; for rows 6, 9 and 10 also
   ``vs_library`` (ms / library ms) and ``bound_share`` (bound ms / ms),
   and for the flash kernel the same at (8, 7168) (``at_8x7168``); for rows
   1 and 2 ``bound_share`` per native eval (their per-shape lines carry
   ``ctx_bound_share`` and ``out_bound_share``); for rows 3 and 5
   ``bound_ms_f32_cores`` beside the split-TF32 bound, and ``bound_share``
   with ``per_native_step`` (ms, bounds, share per native b2 train step);
   for row 4 ``library_ms`` (the einsum), ``vs_library``, ``bound_share``,
   ``device_ms`` (torch.profiler), ``launch_floor_ms`` and
   ``launch_floor_device_ms`` (an empty kernel's launch through the same
   path) and ``per_native_step``; for the splat ``split_ms`` by pass,
   ``launches_per_call``, ``pyramid_128x128_b16_f32`` (ms and device ms
   at scales 2-16, by a flow and a zero flow), ``escape_share_modelled``,
   ``bitwise_cases`` and
   ``per_native_step`` (its 11 calls on a native step's inputs).
9. the result line.

Any failure raises and exits non-zero without the result line; so does a
run without a CUDA device or without the port's package beside this file.
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.algorithms.base import to_batch
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP, NATIVE
from opticalflowdiffusion_tpu_torch.kernels import build as kbuild
from opticalflowdiffusion_tpu_torch.models import unet as unet_mod
from opticalflowdiffusion_tpu_torch.ops import attention_fused as af
from opticalflowdiffusion_tpu_torch.ops import attention_pallas as am
from opticalflowdiffusion_tpu_torch.ops import conv as pc
from opticalflowdiffusion_tpu_torch.ops import flash_attention as fa
from opticalflowdiffusion_tpu_torch.ops import splat as sp
from opticalflowdiffusion_tpu_torch.experiments.base import to_device
from opticalflowdiffusion_tpu_torch.parallel.train import (
    TrainState, make_optimizer, make_train_step,
)
from opticalflowdiffusion_tpu_torch.sample import batch_items
from opticalflowdiffusion_tpu_torch.sample import build as build_flagship

T0 = time.perf_counter()
B = 8
SEED = 0
# (N, C) of the LinearAttentionBlocks of one 128x128 UNet eval, with counts
SHAPES = ((16384, 64, 2), (4096, 64, 1), (4096, 128, 1), (1024, 128, 1),
          (1024, 256, 1), (256, 256, 1), (256, 512, 1))
# the same at native 448x1024 (N 28x larger), at the smallest served batch
NATIVE_B = min(b for _, _, b in NATIVE.runs)
NATIVE_SHAPES = ((458752, 64, 2), (114688, 64, 1), (114688, 128, 1), (28672, 128, 1),
                 (28672, 256, 1), (7168, 256, 1), (7168, 512, 1))
# flash kernel cases: (B, N, dtype); the first is the native b2 bottleneck
FLASH_CASES = ((2, 7168, torch.bfloat16), (2, 7168, torch.float32),
               (8, 7168, torch.bfloat16), (1, 2100, torch.bfloat16))
# splat cases: (B, H, W)
SPLAT_CASES = ((8, 128, 128), (2, 448, 1024))
# training at 128x128 b16: the (N, C) of the blocks that take the backward
# kernels (N >= 1024), with counts per step; the two N = 256 blocks take the
# composition's backward
TRAIN_B = 16
TRAIN_SHAPES = ((16384, 64, 2), (4096, 64, 1), (4096, 128, 1), (1024, 128, 1), (1024, 256, 1))
TRAIN_EXPECTED = {"linear_attention_ctx": 8, "linear_attention_out": 8,
                  "linear_attention_bwd_q": 6, "linear_attention_bwd_kv1": 6,
                  "linear_attention_bwd_kv2": 6, "flash_attention": 0, "splat_fwd": 10,
                  "splat_bwd": 5}
TRAIN_WARMUP, TRAIN_TIMED = 2, 6
# native training (bench.py:570-573): b2 at 448x1024, remat, bf16
NATIVE_TRAIN_B = 2
NATIVE_TRAIN_WARMUP, NATIVE_TRAIN_TIMED = 2, 3
# launches per native train step under remat, derived from the code: every
# block has N >= 1024, so all 8 take the backward kernels; the UnetWithWarp
# closure runs twice (its forward, and again in the backward), so do its 8
# blocks' forward kernels, the bottleneck's flash kernel and its splat; the
# other 9 splats of a step (preprocess 1, pyramid levels 2-16: 2 each) and
# the 5 splat backwards (the closure's and the 4 model-flow warps of the
# pyramid) are outside it
NATIVE_TRAIN_EXPECTED = {"linear_attention_ctx": 16, "linear_attention_out": 16,
                         "linear_attention_bwd_q": 8, "linear_attention_bwd_kv1": 8,
                         "linear_attention_bwd_kv2": 8, "flash_attention": 2, "splat_fwd": 11,
                         "splat_bwd": 5}
# conv cases (B, Cin, H, W, Cout, k, with the prologue): the level-0 3x3
# 64->64 and the 7x7 stem (Cin None: the UnetWithWarp's channels) at
# 448x1024 b2, the widest conv (768->512) at 56x128 b2, the level-0 conv at
# 128x128 b8; the prologue at the first and the last
CONV_CASES = ((NATIVE_B, 64, 448, 1024, 64, 3, True), (NATIVE_B, None, 448, 1024, 64, 7, False),
              (NATIVE_B, 768, 56, 128, 512, 3, False), (B, 64, 128, 128, 64, 3, True))
# conv kernel launches per UNet eval (tests/test_torch_port_conv.py pins them
# from the model): under fold all 44 spatial convs, 19 of them (each
# ResnetBlock's second) with the prologue; under rows the 25 others (those
# 19 run the plain gn-conv through cuDNN).  A train step adds one dgrad
# launch for every spatial conv but the stem.
CONV_PER_EVAL = {"fold": 44, "rows": 25}
CONV_DGRAD_PER_STEP = 43
# conv kernels vs their plain versions, relative to the output's largest
# |value|: f32 sums in another order (plain with TF32 off); bf16 the same
# bf16 operands and f32 sums, the output rounded once to bf16 (one ulp)
TOL_CONV = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM, bf16 tensor, f32;
# SFU exponentials per clock per SM, and the SMs
HBM_BPS, BF16_FLOPS, F32_FLOPS, TF32_FLOPS = 3.35e12, 989e12, 67e12, 495e12
SFU_PER_CLK_SM, SMS = 16, 132
SM_CLOCK_HZ = 1.98e9  # max boost of the H100 SXM; replaced by nvidia-smi's reading
# max error relative to the checked quantity's scale (see la_phase).
# Pass A and pass B vs their plain versions: the same bf16 operands, f32
# sums in another order (an LN statistic can flip one bf16 rounding).
TOL_CTX = 1e-2
TOL_OUT = 2e-2
# whole block vs block_plain in x.dtype: for f32 x the plain version keeps
# f32 operands while the kernels round them to bf16 (as the TPU kernels do)
TOL_BLOCK = 5e-2
# UnetWithWarp flow with kernels vs with the plain versions, relative to the
# flow's max |value|: bf16 differences carried through ~60 layers
TOL_FLOW = (0.05, 0.01)
# flash vs flash_plain (same operands, f32 sums in another order, p rounded
# to bf16 in both): f32 2e-5 absolute; bf16 one bf16 ulp at 1 (2^-7), the
# outputs being averages of v ~ N(0, 1).  Vs the composition (which rounds
# exp / l, not exp): the same plus one more rounding.
TOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
TOL_FLASH_COMP = {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -6}
# splat vs splat_raw, relative to the largest |output|: f32 sums of a few
# terms in another order (and the kernel's 2^-40-fine fixed point); bf16 one
# rounding of that sum to bf16
TOL_SPLAT = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# backward passes vs their plain versions (the same bf16 operands, f32 sums
# in another order), relative to each output's largest value; a bf16 dx may
# differ by one bf16 ulp where the two f32 values round apart
TOL_BWD = 1e-3 + 2.0 ** -7
# one train step with every kernel vs the same step with every plain
# version: (loss, all gradients as one vector) relative errors, per compute
# precision.  The two share their bf16 operands; their f32 sums run in
# another order, which flips a few bf16 roundings downstream, and those
# carry through the backward of ~60 layers.  The random-weight loss is so
# sensitive to them that its difference is a draw per seed (weights and
# batch): chip_train_spread.py runs this check over seeds.  The plain
# splat takes its sums in float64, so that the reference is the same on
# every run; in float32 its atomics (index_add_) moved the plain loss by
# up to a few 1e-4 between runs, a good part of this pin.
TOL_TRAIN = {"bf16": (1e-3, 2e-2), "float32": (1e-3, 5e-3)}
# the same at native 448x1024 b2 with remat (bf16 only): the same sources of
# difference as at 128x128, so the same pins; the plain step runs the flash
# kernel's plain recurrence under autograd where the kernel path takes the
# composition's gradient (the same function, rounded elsewhere)
TOL_TRAIN_NATIVE = (1e-3, 2e-2)
# rows 7-8 vs middle_ctx_plain / middle_out_plain: the same f32 arithmetic on
# qkv's values in another order (the kernels sum a tile's 32 positions, then
# the tiles, then the CTAs' partials), 1e-5 of the terms' magnitude, the
# largest sum of |terms| (ctx: sum_n softmax(k) |v|; out: sum_d q' |ctx| / N),
# since the signed sums cancel (max |ctx| falls as 1/sqrt(N) while the
# rounding stays that of the terms: ~3e-7 at every N, measured on an H100);
# a bf16 output is also allowed one bf16 ulp of its largest value (2^-7)
TOL_MID = 1e-5
# the flash kernel's gradients vs the composition's autograd: the backward is
# that autograd on the same saved q, k, v, so the same bits (1e-6 of each
# gradient's scale for cuBLAS's choice of algorithm)
TOL_FLASH_GRAD = 1e-6
# PreNormResidual(LinearAttention) on the kernels vs on the composition,
# gradients (per leaf, norm of the difference over the norm): the forwards
# differ by the composition's bf16 roundings of the softmaxes, the context
# and the middle, which reach every gradient through the out conv and the
# LayerNorm's backward
TOL_MID_GRAD = 5e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def sig(v):
    """Floats to 6 significant digits, so that the phase lines stay short."""
    if isinstance(v, float):
        return float(f"{v:.6g}")
    if isinstance(v, dict):
        return {k: sig(x) for k, x in v.items()}
    return v


def phase(name, **kw):
    emit({"phase": name, "t": round(time.perf_counter() - T0, 2), **sig(kw)})


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def empty_launch():
    """One launch of an empty kernel through the same ctypes path as the
    wrappers (kernels/linear_attention.cu ``la_empty_kernel``): the floor
    under a kernel whose work is a few KB."""
    lib, dev = af._lib(), torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lambda: lib.ofd_la_empty(dev.index, stream)


def bound_ms(kernel, Bn, C, N, xbytes, f32_cores=False):
    """Least time for one launch on (Bn, C, N): the larger of its bytes over
    the HBM rate and its operations over the peak rate of their type.
    Returns (bytes ms, operations ms).  Pass A's f32 context sums (2 x 4096
    FLOP a position) run on the tensor cores as 3xTF32 (three TF32 products
    for each f32 one), so they count three times at the TF32 rate; with
    ``f32_cores`` once at the f32 CUDA-core rate, the figure of the first
    bodies."""
    if kernel == "ctx":
        nbytes = Bn * C * N * xbytes + 256 * C * 2 + C * 4 + Bn * (4096 + 256) * 4
        sums = 2 * Bn * N * 4096 / F32_FLOPS if f32_cores else 3 * 2 * Bn * N * 4096 / TF32_FLOPS
        t_ops = 2 * Bn * N * C * 256 / BF16_FLOPS + sums
    else:
        nbytes = 2 * Bn * C * N * xbytes + 2 * 128 * C * 2 + Bn * 4096 * 4 + 3 * C * 4
        t_ops = 2 * Bn * N * (C * 128 + 128 * 32 + 128 * C) / BF16_FLOPS
    return 1e3 * nbytes / HBM_BPS, 1e3 * t_ops


def flash_bound_ms(Bn, N, h, d, dtype):
    """(bytes ms, operations ms) of one flash launch: q, k, v read and the
    output written once; 4 Bn h N^2 d matmul FLOPs (tensor cores for bf16,
    CUDA cores for f32) and Bn h N^2 exponentials on the SFU, which run
    beside each other, so the larger of the two."""
    xb = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * Bn * h * N * d * xb
    flops = 4 * Bn * h * N * N * d / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    exps = Bn * h * N * N / (SFU_PER_CLK_SM * SMS * SM_CLOCK_HZ)
    return 1e3 * nbytes / HBM_BPS, 1e3 * max(flops, exps)


def block_inputs(Bn, C, N, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = rn(Bn, C, N).to(dtype)
    p = (1.0 + 0.1 * rn(C), rn(3 * 128, C) / C ** 0.5, rn(C, 128) / 128 ** 0.5,
         0.01 * rn(C), 1.0 + 0.1 * rn(C))
    return x, p


def err(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def device_phase():
    global SM_CLOCK_HZ
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if clk and clk[0].strip().isdigit():
        SM_CLOCK_HZ = 1e6 * int(clk[0].strip())
    phase("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=smi, sm_clock_max_mhz=SM_CLOCK_HZ / 1e6, torch=torch.__version__,
          cuda=torch.version.cuda)
    return smi


def build_phase():
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kbuild.SOURCES)) as pool:
        list(pool.map(kbuild.build, kbuild.SOURCES))
    for name in kbuild.SOURCES:
        kbuild.load(name)
    ptxas = {n: [ln.strip() for ln in kbuild.build_log[n]["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in kbuild.SOURCES}
    phase("build", seconds=round(time.perf_counter() - t, 2),
          per_source={n: round(kbuild.build_log[n]["seconds"], 2) for n in kbuild.SOURCES},
          ptxas=ptxas)


def la_phase(Bn, shapes, label, iters=20):
    """Both linear-attention passes against their plain versions at every
    shape of one UNet eval.

    Errors are taken relative to the scale of what each check is about:
    the context for pass A; for pass B the residual branch y - x, fed an
    attention-dominated context (ctx / N ~ N(0, 1), since the block's own
    context is ~1/N and its bias would otherwise hide the attention path);
    for the whole block the residual branch with a zero output bias.  A
    bf16 y is also allowed one bf16 ulp of its largest value, 2^-7 max |y|.
    Returns, per pass, the sums over one UNet eval (bf16 x) and the largest
    error."""
    stats = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound": 0.0,
                 "bytes_ms": 0.0, "ops_ms": 0.0} for k in ("ctx", "out")}
    stats["ctx"]["bound_f32_cores"] = 0.0
    for i, (N, C, count) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            x, (g_pre, w_qkv, w_out, b_out, g_post) = block_inputs(Bn, C, N, dtype, 100 + i)
            w16 = w_qkv.to(torch.bfloat16)
            w_kv, w_q = w16[128:].contiguous(), w16[:128].contiguous()
            wo16 = w_out.to(torch.bfloat16).contiguous()
            g = torch.Generator(device="cuda").manual_seed(200 + i)
            ctx_in = N * torch.randn(Bn, 4, 32, 32, generator=g, device="cuda")
            b_zero = torch.zeros_like(b_out)
            rounding = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
            with torch.no_grad():
                ctx_k, m_k, s_k = af.linear_attention_ctx(x, g_pre, w_kv)
                ctx_p, m_p, s_p = af.ctx_plain(x, g_pre, w_kv)
                y_k = af.linear_attention_out(x, g_pre, w_q, ctx_in, wo16, b_out, g_post)
                y_p = af.out_plain(x, g_pre, w_q, ctx_in, wo16, b_out, g_post)
                yb_k = af.fused_linear_attention_block(x, g_pre, w_qkv, w_out, b_zero, g_post)
                yb_p = af.block_plain(x, g_pre, w_qkv, w_out, b_zero, g_post)
                torch.cuda.synchronize()
                e_ctx, e_m, e_out, e_blk = err(ctx_k, ctx_p), err(m_k, m_p), err(y_k, y_p), err(yb_k, yb_p)
                e_s = float(((s_k - s_p).abs() / s_p).max())
                ctx_scale = float(ctx_p.abs().max())
                out_scale = float((y_p.float() - x.float()).abs().max())
                blk_scale = float((yb_p.float() - x.float()).abs().max())
                out_tol = TOL_OUT * out_scale + rounding * float(y_p.float().abs().max())
                blk_tol = TOL_BLOCK * blk_scale + rounding * float(yb_p.float().abs().max())
                del ctx_k, m_k, s_k, y_k, y_p, yb_k, yb_p
                times = {
                    "ctx_ms": cuda_ms(lambda: af.linear_attention_ctx(x, g_pre, w_kv), iters),
                    "ctx_plain_ms": cuda_ms(lambda: af.ctx_plain(x, g_pre, w_kv), iters),
                    "out_ms": cuda_ms(lambda: af.linear_attention_out(
                        x, g_pre, w_q, ctx_p, wo16, b_out, g_post), iters),
                    "out_plain_ms": cuda_ms(lambda: af.out_plain(
                        x, g_pre, w_q, ctx_p, wo16, b_out, g_post), iters),
                    "block_ms": cuda_ms(lambda: af.fused_linear_attention_block(
                        x, g_pre, w_qkv, w_out, b_out, g_post), iters),
                    "block_plain_ms": cuda_ms(lambda: af.block_plain(
                        x, g_pre, w_qkv, w_out, b_out, g_post), iters),
                }
            xbytes = x.element_size()
            b_ctx, b_out_ = bound_ms("ctx", Bn, C, N, xbytes), bound_ms("out", Bn, C, N, xbytes)
            b_ctx32 = max(bound_ms("ctx", Bn, C, N, xbytes, f32_cores=True))
            phase("kernel_vs_plain", kernel="linear_attention", at=label, N=N, C=C, B=Bn,
                  dtype=str(dtype).split(".")[1],
                  ctx_max_abs=e_ctx[0], ctx_max_rel=e_ctx[0] / ctx_scale,
                  m_max_abs=e_m[0], s_max_rel=e_s,
                  out_max_abs=e_out[0], out_residual_scale=out_scale, out_tol=out_tol,
                  block_max_abs=e_blk[0], block_residual_scale=blk_scale, block_tol=blk_tol,
                  ctx_bound_ms=max(b_ctx), ctx_bound_ms_f32_cores=b_ctx32, out_bound_ms=max(b_out_),
                  ctx_bound_share=max(b_ctx) / times["ctx_ms"],
                  out_bound_share=max(b_out_) / times["out_ms"],
                  **{k: round(v, 5) for k, v in times.items()})
            check(e_ctx[0] <= TOL_CTX * ctx_scale and e_s <= TOL_CTX
                  and e_m[0] <= TOL_CTX * float(m_p.abs().max()),
                  f"ctx kernel disagrees at N={N} C={C} {dtype}: {e_ctx} {e_m} {e_s}")
            check(e_out[0] <= out_tol, f"out kernel disagrees at N={N} C={C} {dtype}: {e_out}")
            check(e_blk[0] <= blk_tol, f"fused block disagrees at N={N} C={C} {dtype}: {e_blk}")
            for k, e, b in (("ctx", max(e_ctx[0], e_m[0]), b_ctx), ("out", e_out[0], b_out_)):
                stats[k]["err"] = max(stats[k]["err"], e)
                if dtype == torch.bfloat16:   # the main path's dtype
                    stats[k]["ms"] += count * times[f"{k}_ms"]
                    stats[k]["plain_ms"] += count * times[f"{k}_plain_ms"]
                    stats[k]["bound"] += count * max(b)
                    stats[k]["bytes_ms"] += count * b[0]
                    stats[k]["ops_ms"] += count * b[1]
            if dtype == torch.bfloat16:
                stats["ctx"]["bound_f32_cores"] += count * b_ctx32
            del x, ctx_p, m_p, s_p
    for s in stats.values():
        s["bound_by"] = "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations"
    phase("linear_attention_per_eval", at=label, B=Bn,
          **{f"{k}_{f}": v for k, s in stats.items() for f, v in s.items()})
    return stats


def flash_phase():
    """The flash kernel against flash_plain and the composition, on q, k, v
    laid out as the UNet's to_qkv output (B, 3, h, d, N); with the time of
    one scaled_dot_product_attention call on contiguous (B, h, N, d) copies.
    Returns the bf16 rows at (2, 7168) (the native b2 bottleneck) and
    (8, 7168) by batch, and the largest error."""
    out = {}
    worst = 0.0
    for i, (Bn, N, dtype) in enumerate(FLASH_CASES):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        qkv = torch.randn(Bn, 3, 4, 32, N, generator=g, device="cuda").to(dtype)
        q = (qkv[:, 0] * 32 ** -0.5).permute(0, 3, 1, 2)
        k, v = qkv[:, 1].permute(0, 3, 1, 2), qkv[:, 2].permute(0, 3, 1, 2)
        with torch.no_grad():
            got = fa.flash_attention(q, k, v)
            e_plain = err(got, fa.flash_plain(q, k, v))
            e_comp = err(got, fa.attention_middle_plain(q, k, v))
            torch.cuda.synchronize()
            sq, sk, sv = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            times = {
                "ms": cuda_ms(lambda: fa.flash_attention(q, k, v)),
                "plain_ms": cuda_ms(lambda: fa.flash_plain(q, k, v), 5, 1),
                "composition_ms": cuda_ms(lambda: fa.attention_middle_plain(q, k, v), 5, 1),
                "sdpa_ms": cuda_ms(lambda: sdpa(sq, sk, sv, scale=1.0)),
            }
        b = flash_bound_ms(Bn, N, 4, 32, dtype)
        row = dict(B=Bn, N=N, dtype=str(dtype).split(".")[1], max_abs_vs_plain=e_plain[0],
                   mean_abs_vs_plain=e_plain[1], max_abs_vs_composition=e_comp[0],
                   bytes_ms=b[0], ops_ms=b[1], bound_ms=max(b),
                   bound_by="bytes" if b[0] >= b[1] else "operations",
                   **{k_: round(t, 5) for k_, t in times.items()})
        phase("kernel_vs_plain", kernel="flash_attention", **row)
        check(e_plain[0] <= TOL_FLASH[dtype],
              f"flash kernel disagrees with flash_plain at {Bn, N, dtype}: {e_plain}")
        check(e_comp[0] <= TOL_FLASH_COMP[dtype],
              f"flash kernel disagrees with the composition at {Bn, N, dtype}: {e_comp}")
        worst = max(worst, e_plain[0])
        if dtype == torch.bfloat16 and N == 7168:
            out[Bn] = row
        del qkv, q, k, v, got, sq, sk, sv
    return out, worst


def flash_grad_phase(Bn=NATIVE_B, N=7168):
    """The flash kernel under autograd at the native bottleneck, bf16: its
    q, k, v gradients against the composition's autograd (the same bits
    expected), with the time of forward + backward on each path and the
    peak memory that each backward adds (the composition holds the
    (B, 4, N, N) f32 scores)."""
    g = torch.Generator(device="cuda").manual_seed(350)
    qkv = torch.randn(Bn, 3, 4, 32, N, generator=g, device="cuda").to(torch.bfloat16)
    dout = torch.randn(Bn, N, 4, 32, generator=g, device="cuda").to(torch.bfloat16)
    out = {}

    def fwd_bwd(fn):
        leaf = qkv.detach().requires_grad_()
        q = (leaf[:, 0] * 32 ** -0.5).permute(0, 3, 1, 2)
        k, v = leaf[:, 1].permute(0, 3, 1, 2), leaf[:, 2].permute(0, 3, 1, 2)
        fn(q, k, v).backward(dout)
        return leaf.grad

    for name, fn in (("kernel", fa.attention_middle), ("composition", fa.attention_middle_plain)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[name] = fwd_bwd(fn)
        torch.cuda.synchronize()
        out[name + "_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        out[name + "_ms"] = cuda_ms(lambda: fwd_bwd(fn), 5, 1)
    e = err(out["kernel"], out["composition"])[0]
    scale = float(out["composition"].float().abs().max())
    phase("flash_grad_vs_composition", B=Bn, N=N, dtype="bfloat16", max_abs=e, scale=scale,
          fwd_bwd_ms=out["kernel_ms"], composition_fwd_bwd_ms=out["composition_ms"],
          added_peak_gb=out["kernel_peak_gb"], composition_added_peak_gb=out["composition_peak_gb"],
          scores_gb=Bn * 4 * N * N * 4 / 1e9)
    check(torch.isfinite(out["kernel"]).all() and e <= TOL_FLASH_GRAD * scale,
          f"flash gradients disagree with the composition's: {e} (scale {scale})")
    return e


def mid_bound_ms(Bn, N, xbytes):
    """(bytes ms, operations ms) of one launch of either middle pass: pass A
    reads k and v and writes ctx, pass B reads q and ctx and writes out, each
    once (2 * 128 values a position either way); both do
    2 * 4096 f32 FLOP per position on CUDA cores and 128 exponentials per
    position on the SFU (beside them: the larger of the two)."""
    nbytes = 2 * 128 * Bn * N * xbytes + Bn * 4096 * 4
    flops = 2 * Bn * N * 4096 / F32_FLOPS
    exps = Bn * N * 128 / (SFU_PER_CLK_SM * SMS * SM_CLOCK_HZ)
    return 1e3 * nbytes / HBM_BPS, 1e3 * max(flops, exps)


def middle_phase(iters=20):
    """Rows 7-8 against middle_ctx_plain / middle_out_plain at the qkv shape
    (B, 384, N), laid out as the module's 1x1 conv gives it, of every block
    of one 128x128 b8 and one native b2 UNet eval, bf16 and f32; two
    launches bit for bit; CUDA-event times of each kernel alone, its bound,
    its plain version and the composition.  Returns per-eval sums at native
    b2 (bf16, 8 blocks) and the largest absolute errors."""
    stats = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound": 0.0, "bytes_ms": 0.0,
                 "ops_ms": 0.0} for k in ("ctx", "out")}
    composition_ms = 0.0
    for Bn, shapes, label in ((B, SHAPES, "128x128"), (NATIVE_B, NATIVE_SHAPES, "448x1024")):
        counts = {}
        for N, _, c in shapes:
            counts[N] = counts.get(N, 0) + c
        for i, (N, count) in enumerate(counts.items()):
            for dtype in (torch.bfloat16, torch.float32):
                g = torch.Generator(device="cuda").manual_seed(1000 + i)
                qkv = torch.randn(Bn, 384, N, generator=g, device="cuda").to(dtype).transpose(1, 2)
                with torch.no_grad():
                    c1, c2 = am.middle_ctx(qkv), am.middle_ctx(qkv)
                    cp = am.middle_ctx_plain(qkv)
                    o1, o2 = am.middle_out(qkv, cp), am.middle_out(qkv, cp)
                    op = am.middle_out_plain(qkv, cp)
                    torch.cuda.synchronize()
                    same = bool(torch.equal(c1, c2) and torch.equal(o1, o2))
                    e = {"ctx": err(c1, cp)[0], "out": err(o1, op)[0]}
                    scale = {"ctx": float(cp.abs().max()), "out": float(op.float().abs().max())}
                    va = qkv.clone()
                    va[..., 256:] = va[..., 256:].abs()
                    mass = {"ctx": float(am.middle_ctx_plain(va).max()),
                            "out": float(am.middle_out_plain(qkv, cp.abs()).float().max())}
                    del c1, c2, o1, o2, op, va
                    times = {
                        "ctx_ms": cuda_ms(lambda: am.middle_ctx(qkv), iters),
                        "ctx_plain_ms": cuda_ms(lambda: am.middle_ctx_plain(qkv), 5, 1),
                        "out_ms": cuda_ms(lambda: am.middle_out(qkv, cp), iters),
                        "out_plain_ms": cuda_ms(lambda: am.middle_out_plain(qkv, cp), 5, 1),
                        "composition_ms": cuda_ms(
                            lambda: am.linear_attention_middle_plain(qkv, 4, 32), 2, 1),
                    }
                xb = qkv.element_size()
                bounds = dict.fromkeys(("ctx", "out"), mid_bound_ms(Bn, N, xb))
                ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
                tol = {"ctx": TOL_MID * mass["ctx"],
                       "out": TOL_MID * mass["out"] + ulp * scale["out"]}
                phase("linear_attention_middle_vs_plain", at=label, B=Bn, N=N, blocks=count,
                      dtype=str(dtype).split(".")[1], bitwise_same=same,
                      **{f"{k}_max_abs": e[k] for k in e}, **{f"{k}_scale": scale[k] for k in e},
                      **{f"{k}_terms_mass": mass[k] for k in e}, **{f"{k}_tol": tol[k] for k in e},
                      **{f"{k}_bound_ms": max(bounds[k]) for k in e},
                      **{k: round(v, 5) for k, v in times.items()})
                check(same, f"middle kernels not deterministic at {Bn, N, dtype}")
                for k in ("ctx", "out"):
                    check(e[k] <= tol[k],
                          f"middle {k} kernel disagrees at {Bn, N, dtype}: {e[k]} "
                          f"(tolerance {tol[k]})")
                    stats[k]["err"] = max(stats[k]["err"], e[k])
                    if label == "448x1024" and dtype == torch.bfloat16:
                        stats[k]["ms"] += count * times[f"{k}_ms"]
                        stats[k]["plain_ms"] += count * times[f"{k}_plain_ms"]
                        stats[k]["bound"] += count * max(bounds[k])
                        stats[k]["bytes_ms"] += count * bounds[k][0]
                        stats[k]["ops_ms"] += count * bounds[k][1]
                if label == "448x1024" and dtype == torch.bfloat16:
                    composition_ms += count * times["composition_ms"]
                del qkv, cp
    for st in stats.values():
        st["bound_by"] = "bytes" if st["bytes_ms"] >= st["ops_ms"] else "operations"
    phase("linear_attention_middle_per_eval", at="448x1024", B=NATIVE_B,
          composition_ms=composition_ms,
          **{f"{k}_{f}": v for k, st in stats.items() for f, v in st.items()})
    return stats


def middle_modules_phase():
    """The path of rows 7-8: PreNormResidual(LinearAttention) at every
    native b2 block shape on the middle's kernels, on the composition, and
    the fused LinearAttentionBlock from the same state_dict, all held
    together.  The middle's output is ~N^-1.5 with weights drawn as the
    model's, below the post-LayerNorm's eps, so the out conv's weight is
    scaled by N^1.5 and its bias zeroed: the residual branch is then all
    attention, at unit scale;
    at native level 0 and at (7168, 512) also a backward through the module
    on the kernels against the one on the composition.  One count window:
    one launch of each middle kernel per kernels forward, none in a
    backward, and the block's two forward kernels once per block forward.
    Returns the window's launches."""
    dt = torch.bfloat16
    torch.cuda.synchronize()
    kernels.reset_counts()
    expected = {k.name: 0 for k in kernels.KERNELS}
    worst = {"out": 0.0, "grad": 0.0}
    for i, (N, C, _) in enumerate(NATIVE_SHAPES):
        lvl = {458752: 0, 114688: 1, 28672: 2, 7168: 3}[N]
        H, W = NATIVE.height >> lvl, NATIVE.width >> lvl
        blk = unet_mod.LinearAttentionBlock(C, dtype=dt)
        unet_mod.init_weights(blk, torch.Generator().manual_seed(1100 + i))
        with torch.no_grad():
            blk.fn.fn.to_out[0].bias.zero_()
            blk.fn.fn.to_out[0].weight.mul_(float(N) ** 1.5)
        blk = blk.cuda()
        mods = {}
        for be in ("kernels", "composition"):
            m = unet_mod.PreNormResidual(C, unet_mod.LinearAttention(C, dtype=dt, attn_backend=be),
                                         dt)
            m.load_state_dict(blk.state_dict())
            mods[be] = m.cuda()
        g = torch.Generator(device="cuda").manual_seed(1200 + i)
        x = torch.randn(NATIVE_B, C, H, W, generator=g, device="cuda").to(dt)
        backward = i == 0 or C == 512
        xs = {be: x.clone().requires_grad_(backward) for be in mods}
        with torch.set_grad_enabled(backward):
            y = {be: m(xs[be]) for be, m in mods.items()}
        with torch.no_grad():
            y["block"] = blk(x)
        expected["linear_attention_middle_ctx"] += 1
        expected["linear_attention_middle_out"] += 1
        expected["linear_attention_ctx"] += 1
        expected["linear_attention_out"] += 1
        ref = y["composition"].detach().float()
        scale = float((ref - x.float()).abs().max())
        tol = TOL_BLOCK * scale + 2.0 ** -7 * float(ref.abs().max())
        e = {be: err(y[be].detach(), ref)[0] for be in ("kernels", "block")}
        row = dict(N=N, C=C, B=NATIVE_B, H=H, W=W, dtype="bfloat16", residual_scale=scale,
                   tol=tol, kernels_vs_composition=e["kernels"], block_vs_composition=e["block"],
                   kernels_vs_block=err(y["kernels"].detach(), y["block"])[0])
        if backward:
            dy = torch.randn(y["kernels"].shape, generator=g, device="cuda").to(dt)
            grads = {}
            for be, m in mods.items():
                y[be].backward(dy)
                grads[be] = {"x": xs[be].grad, **{k: p.grad for k, p in m.named_parameters()}}
            rel = {k: float((grads["kernels"][k].float() - grads["composition"][k].float()).norm())
                   / max(float(grads["composition"][k].float().norm()), 1e-30)
                   for k in grads["composition"]}
            row["grad_rel"] = rel
            check(all(torch.isfinite(v).all() for v in grads["kernels"].values()),
                  f"module gradients not finite at {N, C}")
            check(max(rel.values()) <= TOL_MID_GRAD,
                  f"module gradients on the kernels disagree at {N, C}: {rel}")
            worst["grad"] = max(worst["grad"], max(rel.values()))
        phase("linear_attention_module_vs_composition", **row)
        for be in ("kernels", "block"):
            check(e[be] <= tol, f"{be} disagrees with the composition module at {N, C}: {e[be]}")
        worst["out"] = max(worst["out"], e["kernels"], e["block"])
        del blk, mods, x, xs, y
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    phase("linear_attention_modules", launches=launches, expected_launches=expected, **worst)
    check(launches == expected, f"module launches {launches}, expected {expected}")
    return launches


def splat_inputs(Bn, H, W, dtype, seed):
    """Values as the warp gives them (image in [-1, 1], metric 0 or 1 with
    one NaN-hole in ten) and a flow of a few pixels, one of them infinite."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.rand(Bn, 3, H, W, generator=g, device="cuda") - 1).to(dtype)
    metric = (torch.rand(Bn, 1, H, W, generator=g, device="cuda") > 0.1).to(dtype)
    flow = 4 * torch.randn(Bn, 2, H, W, generator=g, device="cuda")
    flow[0, 0, 0, 0] = float("inf")
    return x, metric, flow


def bits(t):
    """A float tensor's bits as integers, so that equality covers NaN bits."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def bitwise_equal(a, b):
    return a.dtype == b.dtype and bool(torch.equal(bits(a), bits(b)))


def device_split(fn, n=20):
    """torch.profiler over ``n`` calls of ``fn``: device ms per call by pass
    (the splat's three kernels by name, anything else by its own name) and
    the launches per call (kernels and memsets).  Only profiler_phase calls
    it, after the last host-clock window."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    split = {}
    for e in evs:
        key = next((k for k in ("splat_max", "splat_scatter", "splat_finish") if k in e.name),
                   e.name[:40])
        split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return split, len(evs) / n


def splat_escape_share(flow, scale=1, offset=(0, 0)):
    """Modelled, not counted in the kernel: the share of the corners in the
    output that fall outside their CTA's window and so take the escapes'
    global atomics, from the kernel's own windows (``ofd_splat_windows``)
    and the plain version's targets of ``flow``."""
    Bn, _, H, W = flow.shape
    _, dump, corners = sp._splat_terms(torch.zeros(Bn, 1, H, W, device=flow.device), flow,
                                       scale, offset)
    Ho, Wo = H // scale, W // scale
    wx0, wy0, win = sp._kernel_windows(H, W, scale, offset)
    wx0 = wx0.long().to(flow.device).view(1, W).expand(H, W).reshape(-1).repeat(Bn)
    wy0 = wy0.long().to(flow.device).view(H, 1).expand(H, W).reshape(-1).repeat(Bn)
    escaped = total = 0
    for idx, _ in corners:
        ok = idx != dump
        t = idx % (Ho * Wo)
        lx, ly = t % Wo - wx0, t // Wo - wy0
        inside = (lx >= 0) & (lx < win) & (ly >= 0) & (ly < win)
        escaped += int((ok & ~inside).sum())
        total += int(ok.sum())
    return escaped / max(total, 1)


def splat_phase():
    """The forward splat kernel on the values the warp builds ([x * metric,
    metric]): bit for bit against splat_fixed_plain (values and hole mask),
    within TOL_SPLAT of splat_raw, two launches bit for bit; and the
    modelled share of corners beyond the windows on these flows (its split
    by pass comes from profiler_phase).  Returns the native b2 bf16 row and
    the largest error."""
    out = None
    worst = 0.0
    for i, (Bn, H, W) in enumerate(SPLAT_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            x, metric, flow = splat_inputs(Bn, H, W, dtype, 400 + i)
            v = torch.cat([x * metric, metric], dim=1)
            a, mask_a = sp.splat_fwd(v, flow)
            b_, mask_b = sp.splat_fwd(v, flow)
            fixed, mask_f = sp.splat_fixed_plain(v, flow)
            want = sp.splat_raw(v, flow)
            torch.cuda.synchronize()
            same = bitwise_equal(a, b_) and bool(torch.equal(mask_a, mask_b))
            exact = bitwise_equal(a, fixed) and bool(torch.equal(mask_a, mask_f))
            e = err(a, want)
            scale = float(want.float().abs().max())
            del fixed, mask_f, mask_b, b_
            times = {"ms": cuda_ms(lambda: sp.splat_fwd(v, flow)),
                     "plain_ms": cuda_ms(lambda: sp.splat_raw(v, flow)),
                     "fixed_plain_ms": cuda_ms(lambda: sp.splat_fixed_plain(v, flow), 3, 1)}
            xb = x.element_size()
            nbytes = Bn * H * W * (3 * xb + xb + 2 * 4 + 4 * xb)
            bound = 1e3 * nbytes / HBM_BPS
            row = dict(B=Bn, H=H, W=W, dtype=str(dtype).split(".")[1], bitwise_same=same,
                       bitwise_vs_fixed_plain=exact, max_abs=e[0], mean_abs=e[1], scale=scale,
                       bound_ms=bound, bound_by="bytes", bound_share=bound / times["ms"],
                       escape_share_modelled=splat_escape_share(flow),
                       **{k: round(t, 5) for k, t in times.items()})
            phase("kernel_vs_plain", kernel="splat_fwd", **row)
            check(same, f"splat kernel not deterministic at {Bn, H, W, dtype}")
            check(exact, f"splat kernel differs from splat_fixed_plain at {Bn, H, W, dtype}")
            check(e[0] <= TOL_SPLAT[dtype] * scale,
                  f"splat kernel disagrees with splat_raw at {Bn, H, W, dtype}: {e}")
            worst = max(worst, e[0])
            if (Bn, H, W, dtype) == (NATIVE_B, NATIVE.height, NATIVE.width, torch.bfloat16):
                out = row
            del x, metric, flow, v, a, want
    return out, worst


# the bit-for-bit cases: (C, H, W, scale, offset) at b2, and the flows.  C = 4
# (the warp's 3 + 1) at 64x96 over the scales; C below, at and past the
# kernel's chunk of 4 channels; sizes no multiple of its 32-source tile or
# of the scale (partial edge tiles)
SPLAT_BITWISE_GEOMS = ((4, 64, 96, 1, (0, 0)), (4, 64, 96, 2, (1, 0)), (4, 64, 96, 4, (3, 2)),
                       (4, 64, 96, 8, (7, 5)), (4, 64, 96, 16, (0, 0)),
                       (4, 64, 96, 16, (15, 9)), (1, 64, 96, 1, (0, 0)),
                       (3, 64, 96, 2, (1, 0)), (5, 64, 96, 4, (3, 2)), (9, 64, 96, 1, (0, 0)),
                       (9, 64, 96, 16, (0, 0)), (4, 100, 70, 3, (2, 1)),
                       (5, 100, 70, 1, (0, 0)), (1, 37, 29, 3, (0, 2)))
SPLAT_BITWISE_KINDS = ("flow4", "flow40", "zero", "huge", "nonfinite")


def bitwise_splat_inputs(kind, Bn, H, W, dtype, seed, C=4):
    """Values in [-1, 1] (C channels) and a flow: 4 N(0, 1) px (``flow4``)
    or 40 N(0, 1) px (``flow40``, most corners beyond the halo) with one
    infinite target, a zero flow, 1e6 px with 1e-20 px at column 0 and a
    last channel of 1 (``huge``: column 1 gets weights of 1e-20 only), or 4
    N(0, 1) px with inf, -inf and NaN values (``nonfinite``, both
    infinities side by side, so on shared targets)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = 2 * torch.rand(Bn, C, H, W, generator=g, device="cuda") - 1
    flow = 4 * torch.randn(Bn, 2, H, W, generator=g, device="cuda")
    if kind == "flow40":
        flow *= 10
    elif kind == "zero":
        flow.zero_()
    elif kind == "huge":
        flow.zero_()
        flow[:, 0] = 1e6
        flow[:, 0, :, 0] = 1e-20
        v[:, -1] = 1.0
    elif kind == "nonfinite":
        v[0, 0, 1, 2], v[0, 0, 1, 3] = float("inf"), float("-inf")
        v[0, C - 1, 4, 4] = float("inf")
        v[-1, min(1, C - 1), 5, 6] = float("nan")
    if kind != "huge":
        flow[0, 0, 0, 0] = float("inf")
    return v.to(dtype), flow


def splat_bitwise_phase():
    """The forward kernel bit for bit against splat_fixed_plain (values as
    integers, NaN bits included, and the hole mask), two launches the same:
    at b2 over SPLAT_BITWISE_GEOMS x SPLAT_BITWISE_KINDS in bf16 and f32;
    the zero flow at scale 16 at 128x128 b16 (256 sources a target); the
    tiny-weight flow at 448x1024.  Returns the number of cases."""
    cases = [(k, 2, C, H, W, sc, off, dt) for C, H, W, sc, off in SPLAT_BITWISE_GEOMS
             for k in SPLAT_BITWISE_KINDS for dt in (torch.bfloat16, torch.float32)]
    cases += [("zero", TRAIN_B, 4, 128, 128, 16, (0, 0), torch.float32),
              ("huge", 1, 4, NATIVE.height, NATIVE.width, 1, (0, 0), torch.float32)]
    bad = []
    for i, (kind, Bn, C, H, W, scale, off, dtype) in enumerate(cases):
        v, flow = bitwise_splat_inputs(kind, Bn, H, W, dtype, 1400 + i, C)
        a, ma = sp.splat_fwd(v, flow, scale, off)
        b_, mb = sp.splat_fwd(v, flow, scale, off)
        f, mf = sp.splat_fixed_plain(v, flow, scale, off)
        torch.cuda.synchronize()
        ok = (bitwise_equal(a, f) and bool(torch.equal(ma, mf)) and bitwise_equal(a, b_)
              and bool(torch.equal(ma, mb)))
        if not ok:
            bad.append(dict(kind=kind, B=Bn, C=C, H=H, W=W, scale=scale, offset=list(off),
                            dtype=str(dtype).split(".")[1],
                            values_differ=int((bits(a) != bits(f)).sum()),
                            mask_differs=int((ma != mf).sum())))
        del v, flow, a, ma, b_, mb, f, mf
    phase("splat_bitwise_vs_fixed_plain", cases=len(cases), failed=bad)
    check(not bad, f"splat kernel differs from splat_fixed_plain: {bad}")
    return len(cases)


@contextlib.contextmanager
def captured_splats():
    """The arguments of every forward splat kernel call inside the window,
    detached copies, in call order."""
    calls, original = [], sp.splat_fwd

    def capture(inp, flow, scale=1, offset=(0, 0)):
        calls.append((inp.detach().clone(), flow.detach().clone(), int(scale),
                      tuple(int(o) for o in offset)))
        return original(inp, flow, scale, offset)

    sp.splat_fwd = capture
    try:
        yield calls
    finally:
        sp.splat_fwd = original


def splat_on_step_inputs(calls, label):
    """The forward splat kernel bit for bit against splat_fixed_plain on the
    (inp, flow) of every splat of a train step (``calls`` from
    captured_splats), with the modelled share of corners beyond the windows
    per call
    and the kernel's and splat_raw's CUDA-event times summed over the step.
    Returns the per-step sums."""
    rows, bad = [], []
    kernel_ms = plain_ms = 0.0
    for i, (inp, flow, scale, off) in enumerate(calls):
        a, ma = sp.splat_fwd(inp, flow, scale, off)
        f, mf = sp.splat_fixed_plain(inp, flow, scale, off)
        torch.cuda.synchronize()
        if not (bitwise_equal(a, f) and bool(torch.equal(ma, mf))):
            bad.append(i)
        ms = cuda_ms(lambda: sp.splat_fwd(inp, flow, scale, off), 10)
        pms = cuda_ms(lambda: sp.splat_raw(inp, flow, scale, off), 3, 1)
        kernel_ms, plain_ms = kernel_ms + ms, plain_ms + pms
        finite = torch.isfinite(flow)
        rows.append(dict(shape=list(inp.shape), dtype=str(inp.dtype).split(".")[1],
                         scale=scale, offset=list(off), ms=round(ms, 5),
                         max_abs_flow_px=float(flow[finite].abs().max()) if finite.any() else 0.0,
                         escape_share_modelled=splat_escape_share(flow, scale, off)))
        del a, ma, f, mf
    phase("splat_on_step_inputs", at=label, calls=len(calls), bitwise_failed=bad,
          kernel_ms_per_step=kernel_ms, plain_ms_per_step=plain_ms, per_call=rows)
    check(not bad, f"splat kernel differs from splat_fixed_plain on the {label} inputs: {bad}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, calls=len(calls))


# the splat forward by pass: (label, B, H, W, dtype, scale, zero flow) on the
# warp's values [x * metric, metric] (C = 4): SPLAT_CASES, and the pyramid
# loss's f32 scales at 128x128 b16 by a flow and by a zero flow (the
# target's downsample, s^2 sources a target)
SPLAT_PROFILE_CASES = (
    tuple((f"{H}x{W}_b{Bn}_{str(dt).split('.')[1]}", Bn, H, W, dt, 1, False)
          for Bn, H, W in SPLAT_CASES
          for dt in (torch.bfloat16, torch.float32))
    + tuple((f"pyramid_s{sc}" + ("_zero" if z else ""), TRAIN_B, 128, 128, torch.float32, sc, z)
            for sc in (2, 4, 8, 16) for z in (False, True)))


def profiler_phase():
    """Device times from torch.profiler, run after the last host-clock
    window so that no profiler trace precedes one: the splat forward by
    pass, with its launches per call, at SPLAT_PROFILE_CASES (their
    CUDA-event ms taken first, before any trace); row 4's device ms a
    launch at b16 and b2; an empty kernel's launch.  Returns {"splat":
    {label: row}, "bwd_kv1": {B: ms a launch}, "empty_device_ms": ms}."""
    cases = []
    for i, (label, Bn, H, W, dtype, scale, zero) in enumerate(SPLAT_PROFILE_CASES):
        x, metric, flow = splat_inputs(Bn, H, W, dtype, 1300 + i)
        if zero:
            flow.zero_()
        v = torch.cat([x * metric, metric], dim=1)
        call = (lambda v=v, flow=flow, scale=scale: sp.splat_fwd(v, flow, scale))
        cases.append((label, Bn, H, W, dtype, scale, zero, call, cuda_ms(call)))
        del x, metric
    kv1_in = {}
    for Bn in (TRAIN_B, NATIVE_TRAIN_B):
        g = torch.Generator(device="cuda").manual_seed(900 + Bn)
        kv1_in[Bn] = [torch.randn(Bn, 4, 32, 32, generator=g, device="cuda") for _ in range(2)]
    rows = {}
    for label, Bn, H, W, dtype, scale, zero, call, ms in cases:
        split, per_call = device_split(call)
        rows[label] = dict(B=Bn, H=H, W=W, dtype=str(dtype).split(".")[1], scale=scale,
                           zero_flow=zero, ms=ms, device_ms=sum(split.values()),
                           split_ms=split, launches_per_call=per_call)
        phase("splat_by_pass", case=label, **rows[label])
        check(set(split) == {"splat_max", "splat_scatter", "splat_finish"},
              f"the splat forward at {label} ran {sorted(split)}, not its three passes")
    kv1 = {Bn: sum(device_split(lambda c=c, d=d: af.linear_attention_bwd_kv1(c, d, 1024))[0]
                   .values()) for Bn, (c, d) in kv1_in.items()}
    empty = sum(device_split(empty_launch())[0].values())
    phase("device_times", bwd_kv1_device_ms_per_launch=kv1, empty_launch_device_ms=empty)
    return {"splat": rows, "bwd_kv1": kv1, "empty_device_ms": empty}


def bwd_bound_ms(kernel, Bn, C, N, xbytes, f32_cores=False):
    """(bytes ms, operations ms) of one backward launch on (Bn, C, N): x and
    dy (and dxq) read once, dx written once, weights once; operations per
    position: the bf16 tensor-core products and the f32 ones.  Rows 3 and 5
    (bwd_q, bwd_kv2) take their f32 products on the tensor cores in split
    TF32, as their bodies do: three TF32 products for f32 x f32 (dW_out =
    do^T attn, dctx = q'^T dattn, dq' = dattn ctx^T; dk' = v dctx^T, dv = k'
    dctx), two where one operand is bf16 (dW_q = dq^T ln, dW_kv = dkv^T ln),
    at the TF32 rate, on the same units as the bf16 products (so the two
    times add); with ``f32_cores`` they count the f32 products once at the
    f32 CUDA-core rate, beside the tensor cores (the larger of the two).
    Row 4 (bwd_kv1) computes sdot from ctx and dctx: its bytes are theirs
    and sdot's, its operations 4096 f32 multiply-adds per batch element,
    whatever C and N."""
    if kernel == "bwd_kv1":
        # ctx and dctx read (16 KB each per batch element), sdot written
        # (512 B); 4096 f32 multiply-adds per batch element, on CUDA cores
        return 1e3 * Bn * (2 * 16384 + 512) / HBM_BPS, 1e3 * 2 * Bn * 4096 / F32_FLOPS
    P = Bn * N
    io = {"bwd_q": 3, "bwd_kv2": 3}[kernel]
    nbytes = io * P * C * xbytes + 3 * 128 * C * 2 + Bn * 4096 * 4 + 2 * 128 * C * 4
    bf16_macs = {"bwd_q": 4 * 128 * C + 4096, "bwd_kv2": 512 * C}[kernel]
    f32_macs = {"bwd_q": 256 * C + 8192, "bwd_kv2": 256 * C + 8192}[kernel]
    tf32_macs = {"bwd_q": 3 * 128 * C + 3 * 8192 + 2 * 128 * C,
                 "bwd_kv2": 3 * 8192 + 2 * 256 * C}[kernel]
    t_bf16 = 2 * P * bf16_macs / BF16_FLOPS
    if f32_cores:
        t_ops = max(t_bf16, 2 * P * f32_macs / F32_FLOPS)
    else:
        t_ops = t_bf16 + 2 * P * tf32_macs / TF32_FLOPS
    return 1e3 * nbytes / HBM_BPS, 1e3 * t_ops


def la_bwd_phase(Bn=TRAIN_B, shapes=TRAIN_SHAPES, dtypes=(torch.bfloat16, torch.float32),
                 label="128x128", iters=10):
    """The three backward kernels against their plain versions at every
    (N, C) of a train step that takes them (by default 128x128 b16), in
    ``dtypes``.  Errors relative to each output's largest value; times per
    train step (bf16 x, the main path's dtype) summed over the shapes."""
    names = ("bwd_q", "bwd_kv1", "bwd_kv2")
    stats = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound": 0.0, "bytes_ms": 0.0,
                 "ops_ms": 0.0, "bound_f32_cores": 0.0} for k in names}
    stats["bwd_kv1"]["library_ms"] = 0.0
    for i, (N, C, count) in enumerate(shapes):
        for dtype in dtypes:
            x, (g_pre, w_qkv, w_out, b_out, g_post) = block_inputs(Bn, C, N, dtype, 600 + i)
            g = torch.Generator(device="cuda").manual_seed(700 + i)
            dy = torch.randn(Bn, C, N, generator=g, device="cuda").to(dtype)
            w16 = w_qkv.to(torch.bfloat16)
            w_q, w_kv = w16[:128].contiguous(), w16[128:].contiguous()
            wo = w_out.to(torch.bfloat16).contiguous()
            with torch.no_grad():
                c, m, s_ = af.linear_attention_ctx(x, g_pre, w_kv)
                args_q = (x, dy, g_pre, w_q, c, wo, b_out, g_post)
                want_q = af.bwd_q_plain(*args_q)
                dctx, dxq = want_q[1], want_q[0]
                want_s = af.bwd_kv1_plain(x, g_pre, w_kv, m, s_, dctx)
                args_kv2 = (x, g_pre, w_kv, m, s_, dctx, want_s, dxq)
                want_kv = af.bwd_kv2_plain(*args_kv2)
                got = {"bwd_q": af.linear_attention_bwd_q(*args_q),
                       "bwd_kv1": (af.linear_attention_bwd_kv1(c, dctx, N),),
                       "bwd_kv2": af.linear_attention_bwd_kv2(*args_kv2)}
                again_s = af.linear_attention_bwd_kv1(c, dctx, N)
                torch.cuda.synchronize()
                same_s = bool(torch.equal(got["bwd_kv1"][0], again_s))
                want = {"bwd_q": want_q, "bwd_kv1": (want_s,), "bwd_kv2": want_kv}
                errs = {k: max(err(a, b)[0] / max(float(b.float().abs().max()), 1e-30)
                               for a, b in zip(got[k], want[k])) for k in names}
                del got, want, want_q, want_kv, again_s
                fast = dtype == torch.bfloat16
                times = {}
                if fast:
                    times = {
                        "bwd_q_ms": cuda_ms(lambda: af.linear_attention_bwd_q(*args_q), iters),
                        "bwd_q_plain_ms": cuda_ms(lambda: af.bwd_q_plain(*args_q), 3, 1),
                        "bwd_kv1_ms": cuda_ms(lambda: af.linear_attention_bwd_kv1(
                            c, dctx, N), 50),
                        "bwd_kv1_plain_ms": cuda_ms(lambda: af.bwd_kv1_plain(
                            x, g_pre, w_kv, m, s_, dctx), 3, 1),
                        "bwd_kv1_library_ms": cuda_ms(lambda: torch.einsum(
                            "bhde,bhde->bhd", c, dctx) / N, 50),
                        "bwd_kv2_ms": cuda_ms(lambda: af.linear_attention_bwd_kv2(*args_kv2),
                                              iters),
                        "bwd_kv2_plain_ms": cuda_ms(lambda: af.bwd_kv2_plain(*args_kv2), 3, 1),
                    }
            bounds = {k: bwd_bound_ms(k, Bn, C, N, x.element_size()) for k in names}
            cores = {k: max(bwd_bound_ms(k, Bn, C, N, x.element_size(), True)) for k in names}
            phase("kernel_vs_plain", kernel="linear_attention_bwd", at=label, N=N, C=C, B=Bn,
                  dtype=str(dtype).split(".")[1], **{f"{k}_max_rel": errs[k] for k in names},
                  bwd_kv1_bitwise_same=same_s,
                  **{f"{k}_bound_ms": max(bounds[k]) for k in names},
                  **{f"{k}_bound_ms_f32_cores": cores[k] for k in ("bwd_q", "bwd_kv2")},
                  **{k: round(v, 5) for k, v in times.items()})
            check(same_s, f"bwd_kv1 kernel not deterministic at N={N} C={C} {dtype}")
            for k in names:
                check(errs[k] <= TOL_BWD, f"{k} kernel disagrees at N={N} C={C} {dtype}: "
                      f"{errs[k]}")
                stats[k]["err"] = max(stats[k]["err"], errs[k])
                if fast:
                    stats[k]["ms"] += count * times[f"{k}_ms"]
                    stats[k]["plain_ms"] += count * times[f"{k}_plain_ms"]
                    if k == "bwd_kv1":
                        stats[k]["library_ms"] += count * times["bwd_kv1_library_ms"]
                    stats[k]["bound"] += count * max(bounds[k])
                    stats[k]["bound_f32_cores"] += count * cores[k]
                    stats[k]["bytes_ms"] += count * bounds[k][0]
                    stats[k]["ops_ms"] += count * bounds[k][1]
            del x, dy, c, m, s_, args_q, args_kv2
    for st in stats.values():
        st["bound_by"] = "bytes" if st["bytes_ms"] >= st["ops_ms"] else "operations"
        if st["ms"]:
            st["bound_share"] = st["bound"] / st["ms"]
    stats["bwd_kv1"]["launch_floor_ms"] = cuda_ms(empty_launch(), 50)
    stats["bwd_kv1"]["launches"] = sum(count for _, _, count in shapes)
    phase("linear_attention_bwd_per_step", at=label, B=Bn,
          **{f"{k}_{f}": v for k, st in stats.items() for f, v in st.items()})
    return stats


def splat_bwd_phase():
    """The splat backward kernel against splat_bwd_raw at every scale of a
    128x128 b16 train step (bf16 and f32 values) and at scale 1 at 448x1024
    b2; and the tiny-weight hole-mask construction at 448x1024.  Returns the
    per-step sums (bf16 at scale 1 as the UNet's warp, f32 at the pyramid
    scales as the loss) and the largest error."""
    per_step = {"ms": 0.0, "plain_ms": 0.0, "bound": 0.0}
    worst = 0.0
    cases = [(TRAIN_B, 128, 128, sc) for sc in (1, 2, 4, 8, 16)] + [(2, 448, 1024, 1)]
    for i, (Bn, H, W, scale) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(800 + i)
            v = (2 * torch.rand(Bn, 4, H, W, generator=g, device="cuda") - 1).to(dtype)
            flow = 4 * torch.randn(Bn, 2, H, W, generator=g, device="cuda")
            flow[0, 0, 0, 0] = float("inf")
            cot = torch.randn(Bn, 4, H // scale, W // scale, generator=g, device="cuda")
            d_inp, d_flow = sp.splat_bwd(v, flow, cot, scale)
            w_inp, w_flow = sp.splat_bwd_raw(v, flow, cot, scale)
            torch.cuda.synchronize()
            e_in = err(d_inp, w_inp)[0] / max(float(w_inp.float().abs().max()), 1e-30)
            e_fl = err(d_flow, w_flow)[0] / max(float(w_flow.abs().max()), 1e-30)
            times = {"ms": cuda_ms(lambda: sp.splat_bwd(v, flow, cot, scale)),
                     "plain_ms": cuda_ms(lambda: sp.splat_bwd_raw(v, flow, cot, scale), 5, 1)}
            xb = v.element_size()
            nbytes = Bn * H * W * (2 * 4 * xb + 2 * 2 * 4) + cot.numel() * 4
            bound = 1e3 * nbytes / HBM_BPS
            phase("kernel_vs_plain", kernel="splat_bwd", B=Bn, H=H, W=W, scale=scale,
                  dtype=str(dtype).split(".")[1], d_inp_max_rel=e_in, d_flow_max_rel=e_fl,
                  bound_ms=bound, **{k: round(t, 5) for k, t in times.items()})
            check(e_in <= TOL_SPLAT[dtype] and e_fl <= TOL_SPLAT[torch.float32],
                  f"splat_bwd disagrees at {Bn, H, W, scale, dtype}: {e_in} {e_fl}")
            worst = max(worst, e_in, e_fl)
            if H == 128 and dtype == (torch.bfloat16 if scale == 1 else torch.float32):
                for k in ("ms", "plain_ms"):
                    per_step[k] += times[k]
                per_step["bound"] += bound
            del v, flow, cot, d_inp, d_flow, w_inp, w_flow
    H, W = NATIVE.height, NATIVE.width
    flow = torch.zeros(1, 2, H, W, device="cuda")
    flow[:, 0] = 1e6                       # every source off the image ...
    flow[0, 0, :, 0] = 1e-20               # ... but column 0, by 1e-20 px
    inp = torch.ones(1, 4, H, W, device="cuda")
    _, mask = sp.splat_fwd(inp, flow)
    want = sp.splat_raw(inp, flow)[:, -1:] > 0
    torch.cuda.synchronize()
    phase("splat_hole_mask", H=H, W=W, kernel_targets=int(mask.sum()),
          plain_targets=int(want.sum()), equal=bool(torch.equal(mask, want)))
    check(torch.equal(mask, want) and int(want.sum()) == 2 * H,
          "the splat's hole mask differs from the plain path's on the tiny-weight case")
    phase("splat_bwd_per_step", B=TRAIN_B, **per_step)
    return per_step, worst


def conv_bound_ms(Bn, Cin, H, W, Cout, k, dtype, prologue):
    """(bytes ms, operations ms) of one conv launch: x read and the output
    written once, the weights once (and a, b); 2 Bn H W Cin Cout k^2 FLOPs
    on the bf16 tensor cores (f32: CUDA cores), and with the prologue one
    exponential per input element on the SFU beside them."""
    xb = torch.empty((), dtype=dtype).element_size()
    nbytes = (Bn * H * W * (Cin + Cout) + Cout * Cin * k * k) * xb
    nbytes += 2 * Bn * Cin * 4 if prologue else 0
    flops = 2 * Bn * H * W * Cin * Cout * k * k / (
        BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    exps = Bn * Cin * H * W / (SFU_PER_CLK_SM * SMS * SM_CLOCK_HZ) if prologue else 0.0
    return 1e3 * nbytes / HBM_BPS, 1e3 * max(flops, exps)


@contextlib.contextmanager
def tf32(allowed):
    """cuDNN's TF32 for f32 convolutions on or off (it is on by default)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def stem_channels():
    """The stem's input channels: those of the flagship's UnetWithWarp."""
    cfg = dataclasses.replace(FLAGSHIP, unet_dim=8)
    return FlowDiffuser(cfg, device="cpu").module.model.init_conv.weight.shape[1]


def conv_phase():
    """Both conv kernels against their plain versions at CONV_CASES, bf16
    and f32, two launches bit for bit, with CUDA-event times beside the
    bound and one F.conv2d call on the same tensors.  A kernel's ``ms`` is
    the launch alone on weights laid out beforehand; ``*_wrapper_ms`` adds
    the wrapper's per-call weight relayout, as the model's path pays it.
    Returns the native level-0 bf16 rows (rows 9 and 10) and the largest
    errors."""
    stem = stem_channels()
    out, worst = {}, {"conv_rows": 0.0, "conv_fold": 0.0}
    for i, (Bn, Cin, H, W, Cout, k, pro) in enumerate(CONV_CASES):
        Cin = Cin or stem
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(900 + i)
            x = torch.randn(Bn, Cin, H, W, generator=g, device="cuda").to(dtype)
            w = torch.randn(Cout, Cin, k, k, generator=g, device="cuda") / (Cin * k * k) ** 0.5
            a = 1.0 + 0.5 * torch.rand(Bn, Cin, generator=g, device="cuda")
            b = torch.randn(Bn, Cin, generator=g, device="cuda")
            wc = w.to(dtype)
            wt = pc._layout(wc, dtype)
            iters = 20 if dtype == torch.bfloat16 else 5
            with torch.no_grad(), tf32(False):
                got = {"conv_rows": (pc.conv_rows(x, w), pc.conv_rows(x, w)),
                       "conv_fold": (pc.conv_fold(x, w), pc.conv_fold(x, w))}
                want = {"conv_rows": pc.conv2d_same_plain(x, w)}
                want["conv_fold"] = want["conv_rows"]
                if pro:
                    got["conv_fold_prologue"] = (pc.conv_fold(x, w, a, b),
                                                 pc.conv_fold(x, w, a, b))
                    want["conv_fold_prologue"] = pc.conv2d_same_gn_plain(x, w, a, b)
                torch.cuda.synchronize()
                same = {n: bool(torch.equal(*v)) for n, v in got.items()}
                errs = {n: err(v[0], want[n])[0] for n, v in got.items()}
                scales = {n: float(v.float().abs().max()) for n, v in want.items()}
                del got, want
                times = {
                    "rows_ms": cuda_ms(lambda: pc._launch_laid("rows", x, wt, w.shape), iters),
                    "fold_ms": cuda_ms(lambda: pc._launch_laid("fold", x, wt, w.shape), iters),
                    "rows_wrapper_ms": cuda_ms(lambda: pc.conv_rows(x, wc), iters),
                    "fold_wrapper_ms": cuda_ms(lambda: pc.conv_fold(x, wc), iters),
                    "plain_ms": cuda_ms(lambda: pc.conv2d_same_plain(x, w), iters),
                    "library_ms": cuda_ms(lambda: torch.nn.functional.conv2d(
                        x, wc, padding=k // 2), iters),
                }
                if pro:
                    times["fold_prologue_ms"] = cuda_ms(
                        lambda: pc._launch_laid("fold", x, wt, w.shape, a, b), iters)
                    times["fold_prologue_wrapper_ms"] = cuda_ms(
                        lambda: pc.conv_fold(x, wc, a, b), iters)
                    times["gn_plain_ms"] = cuda_ms(
                        lambda: pc.conv2d_same_gn_plain(x, w, a, b), iters)
            bnd = conv_bound_ms(Bn, Cin, H, W, Cout, k, dtype, False)
            bnd_pro = conv_bound_ms(Bn, Cin, H, W, Cout, k, dtype, True)
            row = dict(B=Bn, Cin=Cin, H=H, W=W, Cout=Cout, k=k, dtype=str(dtype).split(".")[1],
                       bitwise_same=same, max_abs=errs, scale=scales,
                       bound_ms=max(bnd), bound_by="bytes" if bnd[0] >= bnd[1] else "operations",
                       **({"prologue_bound_ms": max(bnd_pro)} if pro else {}),
                       **{n: round(t, 5) for n, t in times.items()})
            phase("kernel_vs_plain", kernel="conv", **row)
            for n, e in errs.items():
                check(same[n], f"{n} not deterministic at {Bn, Cin, H, W, Cout, k, dtype}")
                check(e <= TOL_CONV[dtype] * scales[n],
                      f"{n} disagrees with its plain version at {Bn, Cin, H, W, Cout, k, dtype}: "
                      f"{e} (scale {scales[n]})")
                key = "conv_rows" if n == "conv_rows" else "conv_fold"
                worst[key] = max(worst[key], e)
            if i == 0 and dtype == torch.bfloat16:
                out["conv_rows"] = dict(ms=times["rows_ms"], plain_ms=times["plain_ms"],
                                        bound_ms=max(bnd), bound_by=row["bound_by"],
                                        library_ms=times["library_ms"])
                out["conv_fold"] = dict(
                    ms=times["fold_prologue_ms"], plain_ms=times["gn_plain_ms"],
                    bound_ms=max(bnd_pro),
                    bound_by="bytes" if bnd_pro[0] >= bnd_pro[1] else "operations",
                    library_ms=times["library_ms"])
            del x, w, a, b, wc, wt
    return out, worst


class _PlainSplat(torch.autograd.Function):
    """The splat through its plain versions on the card (this script's
    reference runs only): splat_raw forward, with float64 sums so that the
    reference is the same on every run, and splat_bwd_raw backward."""

    @staticmethod
    def forward(ctx, inp, flow, scale, ox, oy):
        out = sp.splat_raw(inp, flow, scale, (ox, oy), acc_dtype=torch.float64)
        ctx.save_for_backward(inp, flow)
        ctx.geom = (scale, (ox, oy))
        mask = out[:, -1:] > 0
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, g, _):
        inp, flow = ctx.saved_tensors
        d_inp, d_flow = sp.splat_bwd_raw(inp, flow, g, *ctx.geom)
        return d_inp, d_flow, None, None, None


class _PlainPasses(torch.autograd.Function):
    """The linear-attention block through the plain versions of its five
    kernels (forward: ctx_plain, out_plain; backward at N >= 1024:
    bwd_q_plain, bwd_kv1_plain, bwd_kv2_plain; below, the composition's
    autograd, as the kernel path dispatches)."""

    @staticmethod
    def forward(ctx, x, g_pre, w_qkv, w_out, b_out, g_post):
        w16 = w_qkv.to(torch.bfloat16)
        c, m, s_ = af.ctx_plain(x, g_pre.float(), w16[128:])
        y = af.out_plain(x, g_pre.float(), w16[:128], c, w_out.to(torch.bfloat16),
                         b_out.float(), g_post.float())
        ctx.save_for_backward(x, g_pre, w_qkv, w_out, b_out, g_post, c, m, s_)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g_pre, w_qkv, w_out, b_out, g_post, c, m, s_ = ctx.saved_tensors
        params = (g_pre, w_qkv, w_out, b_out, g_post)
        if x.shape[2] < af.BWD_MIN_N:
            leaves = [t.detach().requires_grad_() for t in (x, *params)]
            with torch.enable_grad():
                y = af.block_plain(*leaves)
            return torch.autograd.grad(y, leaves, dy)
        w16 = w_qkv.to(torch.bfloat16)
        w_q, w_kv = w16[:128], w16[128:]
        dxq, dctx, dw_q, dw_out, db_out, dg_q, dg_post = af.bwd_q_plain(
            x, dy.to(x.dtype), g_pre.float(), w_q, c, w_out.to(torch.bfloat16),
            b_out.float(), g_post.float())
        sdot = af.bwd_kv1_plain(x, g_pre.float(), w_kv, m, s_, dctx)
        dx, dw_kv, dg_kv = af.bwd_kv2_plain(x, g_pre.float(), w_kv, m, s_, dctx, sdot, dxq)
        return dx, dg_q + dg_kv, torch.cat([dw_q, dw_kv]), dw_out, db_out, dg_post


@contextlib.contextmanager
def plain_versions(attention=True, flash=False, splat=False, conv=False):
    """Route the UNet through the plain versions of the kernels (the
    reference runs of this script only).  ``attention``: True for the
    composition ``block_plain``, "passes" for the plain versions of the
    five kernels; ``conv``: both conv kernels through conv2d_same_plain and
    conv2d_same_gn_plain."""
    saved = (unet_mod.fused_linear_attention_block, unet_mod.attention_middle, sp.splat)
    saved_conv = (pc.conv_rows, pc.conv_fold)
    if conv:
        pc.conv_rows = pc.conv2d_same_plain
        pc.conv_fold = lambda x, w, a=None, b=None: (
            pc.conv2d_same_plain(x, w) if a is None else pc.conv2d_same_gn_plain(x, w, a, b))
    if attention == "passes":
        unet_mod.fused_linear_attention_block = lambda x, *a: _PlainPasses.apply(x, *a[:5])
    elif attention:
        unet_mod.fused_linear_attention_block = lambda x, *a: af.block_plain(x, *a)
    if flash:
        unet_mod.attention_middle = fa.flash_plain
    if splat:
        sp.splat = lambda inp, flow, scale=1, offset=(0, 0): _PlainSplat.apply(
            inp, flow, int(scale), int(offset[0]), int(offset[1]))
    try:
        yield
    finally:
        unet_mod.fused_linear_attention_block, unet_mod.attention_middle, sp.splat = saved
        pc.conv_rows, pc.conv_fold = saved_conv


def forward_vs_plain(algo, cond, label, **plain):
    """One UnetWithWarp forward with the kernels against the same forward
    with plain versions: the flow within TOL_FLOW of its scale."""
    Bn, _, H, W = cond.shape
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(Bn, algo.channels, H, W, generator=g, device="cuda")
    tt = torch.full((Bn,), 500, dtype=torch.long, device="cuda")
    with torch.no_grad():
        out_k = algo.module(x, cond, tt)
        with plain_versions(**plain):
            out_p = algo.module(x, cond, tt)
    torch.cuda.synchronize()
    flow_k, flow_p = out_k[:, 3:], out_p[:, 3:]
    scale = float(flow_p.abs().max())
    e_flow = err(flow_k, flow_p)
    nan_k, nan_p = torch.isnan(out_k[:, :3]), torch.isnan(out_p[:, :3])
    phase("unet_with_warp_vs_plain", at=label, B=Bn, H=H, W=W, plain=plain,
          conv_backend=algo.cfg.conv_backend,
          flow_max_abs=e_flow[0], flow_mean_abs=e_flow[1], flow_scale=scale,
          nan_mask_agreement=float((nan_k == nan_p).float().mean()))
    check(torch.isfinite(flow_k).all() and scale > 0, f"{label}: UnetWithWarp flow not finite")
    check(e_flow[0] <= TOL_FLOW[0] * scale and e_flow[1] <= TOL_FLOW[1] * scale,
          f"{label}: UnetWithWarp with kernels disagrees with the plain versions: "
          f"{e_flow}, scale {scale}")


def sample_path(name, algo, items, native):
    """One count window: preprocess and sample, then check the outputs and
    every kernel's launches.  Returns (result, launches)."""
    torch.cuda.synchronize()
    kernels.reset_counts()
    _, cond, _ = algo.preprocess(to_batch(items, algo.device))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    t = time.perf_counter()
    samples, flow = algo.sample(cond, generator=gen)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches = {k.name: k.launches for k in kernels.KERNELS}
    steps = algo.sched.sampling_timesteps
    Bn, _, H, W = cond.shape
    finite = ~torch.isnan(samples)
    res = {
        "batch": Bn, "height": H, "width": W, "sampler": algo.sched.sampler,
        "denoise_steps": steps, "seconds": sec, "denoise_steps_per_s": steps / sec,
        "frames_per_s": Bn / sec,
        "samples_shape": list(samples.shape), "flow_shape": list(flow.shape),
        "nan_share": float((~finite).float().mean()),
        "finite_values_finite": bool(torch.isfinite(samples[finite]).all()
                                     and torch.isfinite(flow).all()),
    }
    expected = {k.name: 0 for k in kernels.KERNELS}
    expected.update({"linear_attention_ctx": 8 * steps, "linear_attention_out": 8 * steps,
                     "flash_attention": steps if native else 0, "splat_fwd": steps + 1})
    backend = algo.cfg.conv_backend
    if backend != "cudnn":
        expected["conv_" + backend] = CONV_PER_EVAL[backend] * steps
    res["conv_backend"] = backend
    phase("sample_" + name, launches=launches, expected_launches=expected, **res)
    check(res["samples_shape"] == [Bn, 3, H, W] and res["flow_shape"] == [Bn, 2, H, W],
          f"{name}: wrong output shapes")
    check(res["finite_values_finite"], f"{name}: non-finite values")
    check(launches == expected, f"{name}: launches {launches}, expected {expected}")
    return res, launches


def slice_phase():
    t = time.perf_counter()
    algo, data = build_flagship(SEED, "cuda")
    algo_ddim, _ = build_flagship(SEED, "cuda", sampling_timesteps=50)
    native_algos = {(s, n): build_flagship(SEED, "cuda", sampling_timesteps=n, sampler=s)[0]
                    for s, n, _ in NATIVE.runs}
    conv_algos = {be: build_flagship(SEED, "cuda", sampling_timesteps=50, sampler="ddim",
                                     conv_backend=be)[0] for be in ("fold", "rows")}
    items = [data[i] for i in range(B)]
    native_items = {b: batch_items(SEED, b, NATIVE.height, NATIVE.width)
                    for _, _, b in NATIVE.runs}
    _, cond, _ = algo.preprocess(to_batch(items, algo.device))
    _, cond_native, _ = algo.preprocess(to_batch(native_items[NATIVE_B], algo.device))
    phase("slice_build", seconds=round(time.perf_counter() - t, 2),
          params=sum(p.numel() for p in algo.module.parameters()),
          cond_shape=list(cond.shape), native_cond_shape=list(cond_native.shape),
          dtype=str(algo.dtype))

    forward_vs_plain(algo, cond, "128x128")
    forward_vs_plain(algo, cond_native, "448x1024", flash=True, splat=True)
    forward_vs_plain(conv_algos["rows"], cond, "128x128", conv=True)
    forward_vs_plain(conv_algos["fold"], cond_native, "448x1024", flash=True, splat=True,
                     conv=True)
    del cond_native

    totals = {k.name: 0 for k in kernels.KERNELS}
    results = {}
    gen = torch.Generator(device="cuda")
    algo_ddim.sample(cond, generator=gen.manual_seed(SEED))        # warm-up
    paths = [("ddim50", algo_ddim, items, False), ("ancestral1000", algo, items, False)]
    paths += [(f"native_{s}{n}_b{b}", native_algos[s, n], native_items[b], True)
              for s, n, b in NATIVE.runs]
    native_b = f"ddim50_b{NATIVE_B}"
    paths += [("fold_ddim50", conv_algos["fold"], items, False),
              ("rows_ddim50", conv_algos["rows"], items, False),
              ("native_fold_" + native_b, conv_algos["fold"], native_items[NATIVE_B], True)]
    warmed = set()
    for name, a, its, native in paths:
        shape = (len(its), native, a.cfg.conv_backend)
        if (native or a.cfg.conv_backend != "cudnn") and shape not in warmed:
            # a warm-up UNet eval at this shape and conv backend
            _, c, _ = a.preprocess(to_batch(its, a.device))
            x = torch.randn((len(its), a.channels) + tuple(c.shape[2:]), device="cuda")
            with torch.no_grad():
                a.module(x, c, torch.full((len(its),), 999, dtype=torch.long, device="cuda"))
            warmed.add(shape)
            del c, x
        res, launches = sample_path(name, a, its, native)
        results[name] = res
        for k, n in launches.items():
            totals[k] += n
    phase("conv_backends_vs_cudnn",
          ddim50_128x128_b8_steps_per_s={be: results[n]["denoise_steps_per_s"] for be, n in (
              ("cudnn", "ddim50"), ("fold", "fold_ddim50"), ("rows", "rows_ddim50"))},
          **{f"{native_b}_448x1024_frames_per_s": {
              "cudnn": results["native_" + native_b]["frames_per_s"],
              "fold": results["native_fold_" + native_b]["frames_per_s"]}})
    phase("launch_counts", launches=totals)
    return totals


@contextlib.contextmanager
def captured_block_bwd():
    """The arguments of every fused_block_bwd call (each block's backward on
    the kernels) inside the window, detached copies, in call order."""
    calls, original = [], af.fused_block_bwd

    def capture(*args):
        calls.append(tuple(a.detach().clone() for a in args))
        return original(*args)

    af.fused_block_bwd = capture
    try:
        yield calls
    finally:
        af.fused_block_bwd = original


def bwd_on_activations(calls, label):
    """Rows 3, 4 and 5 against their plain versions on the activations that
    reached each block's backward in a train step (``calls`` from
    captured_block_bwd), with TOL_BWD: a kernel fault shows here apart from
    the draw of the step's random-weight loss.  Each row gets the same
    inputs as its plain version (rows 4 and 5 the plain dctx, sdot, dxq),
    as fused_block_bwd prepares them; row 4 takes the forward's saved ctx,
    its plain version recomputes over N.  One kernel_vs_plain line per
    row."""
    errs = {k: [] for k in ("bwd_q", "bwd_kv1", "bwd_kv2")}
    shapes = []
    rel = lambda got, want: max(err(a, b)[0] / max(float(b.float().abs().max()), 1e-30)
                                for a, b in zip(got, want))
    with torch.no_grad():
        for x, dy, g_pre, w_qkv, w_out, b_out, g_post, c, m, s_ in calls:
            w16 = w_qkv.to(torch.bfloat16).contiguous()
            w_q, w_kv = w16[:128], w16[128:]
            g32 = g_pre.float().contiguous()
            args_q = (x, dy.to(x.dtype).contiguous(), g32, w_q, c,
                      w_out.to(torch.bfloat16).contiguous(), b_out.float().contiguous(),
                      g_post.float().contiguous())
            want_q = af.bwd_q_plain(*args_q)
            errs["bwd_q"].append(rel(af.linear_attention_bwd_q(*args_q), want_q))
            dxq, dctx = want_q[0], want_q[1]
            want_s = af.bwd_kv1_plain(x, g32, w_kv, m, s_, dctx)
            errs["bwd_kv1"].append(rel((af.linear_attention_bwd_kv1(c, dctx, x.shape[2]),),
                                       (want_s,)))
            args_kv2 = (x, g32, w_kv, m, s_, dctx, want_s, dxq)
            errs["bwd_kv2"].append(rel(af.linear_attention_bwd_kv2(*args_kv2),
                                       af.bwd_kv2_plain(*args_kv2)))
            shapes.append(list(x.shape))
            del want_q, want_s
    torch.cuda.synchronize()
    for k, e in errs.items():
        phase("kernel_vs_plain", kernel=f"linear_attention_{k}", at=label, blocks=len(e),
              shapes=shapes, max_rel=max(e), per_block=[sig(v) for v in e])
        check(max(e) <= TOL_BWD, f"{k} disagrees with its plain version on the {label} "
              f"activations: {e}")


# the splat kernel on the captured inputs of one train step, by "HxW_bB"
STEP_SPLATS = {}


def train_batch(seed=0, B=TRAIN_B, H=128, W=128):
    """A standard-normal (img, tgt, flow) batch from numpy, as the JAX
    bench.py train rows draw it."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, H, W, 3)), rng.standard_normal((B, H, W, 3)),
              rng.standard_normal((B, H, W, 2)))
    return to_device(tuple(a.astype(np.float32) for a in arrays), "cuda")


def step_grads(algo, batch, seed):
    """Loss and per-parameter gradients of one train step's loss (augment,
    pyramid loss, backward), with the generator from ``seed``."""
    algo.module.zero_grad(set_to_none=True)
    loss, _ = algo.loss_fn(batch, torch.Generator(device="cuda").manual_seed(seed))
    loss.backward()
    torch.cuda.synchronize()
    loss = loss.detach()
    grads = {k: p.grad.detach().clone() for k, p in algo.module.named_parameters()}
    algo.module.zero_grad(set_to_none=True)
    return float(loss), grads


def train_losses(out_dir):
    """{step: train/loss} of a run's metrics.jsonl."""
    recs = [json.loads(x) for x in (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def step_vs_plain(precision, batch, conv_backend="cudnn", remat=False, tol=None):
    """One train step's loss and gradients (the flagship built at 128x128,
    weights from the seed, on ``batch``) with every kernel against the same
    step with every plain version: the same weights, batch and draws.  Under
    a conv backend in f32, both steps run with cuDNN's TF32 off (the f32
    conv kernels are exact f32).  With ``remat`` the UnetWithWarp closure
    is rematerialised.  Where the bottleneck takes the flash kernel (N >=
    2048: the native batch) the plain step runs its plain recurrence.  The
    cuDNN bf16 step also holds rows 3-5 to their plain versions on its own
    block activations (bwd_on_activations), and the splat kernel bit for bit
    to splat_fixed_plain on its splats' own inputs (splat_on_step_inputs)."""
    cfg = dataclasses.replace(FLAGSHIP, zero_init=False, precision=precision,
                              conv_backend=conv_backend, remat=remat)
    algo = FlowDiffuser(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    algo.module.train()
    conv = conv_backend != "cudnn"
    # the activations of the cuDNN bf16 step: the rows' check on them
    capture = conv_backend == "cudnn" and precision == "bf16"
    with tf32(not (conv and precision == "float32")):
        with contextlib.ExitStack() as stack:
            if capture:
                calls = stack.enter_context(captured_block_bwd())
                splat_calls = stack.enter_context(captured_splats())
            loss_k, g_k = step_grads(algo, batch, 11)
        if capture:
            label = f"{batch[0].shape[2]}x{batch[0].shape[3]}_b{batch[0].shape[0]}"
            bwd_on_activations(calls, "train_activations_" + label)
            STEP_SPLATS[label] = splat_on_step_inputs(splat_calls, "train_step_" + label)
            del calls, splat_calls
        flash = batch[0].shape[2] * batch[0].shape[3] // 64 >= fa.FLASH_MIN_N
        with plain_versions(attention="passes", splat=True, conv=conv, flash=flash):
            loss_p, g_p = step_grads(algo, batch, 11)
    rel = {k: float((g_k[k] - g_p[k]).norm()) / float(g_p[k].norm())
           for k in g_p if float(g_p[k].norm()) > 0}
    worst = max(rel, key=rel.get)
    total = float(torch.sqrt(sum((g_k[k] - g_p[k]).square().sum() for k in g_p))
                  / torch.sqrt(sum(g.square().sum() for g in g_p.values())))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    phase("train_step_vs_plain", precision=precision, conv_backend=conv_backend,
          B=batch[0].shape[0], H=batch[0].shape[2], W=batch[0].shape[3], remat=remat,
          loss=loss_k, plain_loss=loss_p,
          loss_rel=loss_rel, grad_leaves=len(rel), grad_global_rel=total,
          grad_worst_leaf=worst, grad_worst_rel=rel[worst],
          grad_median_rel=float(np.median(list(rel.values()))))
    check(np.isfinite(loss_k) and all(torch.isfinite(g).all() for g in g_k.values()),
          f"train step ({precision}): non-finite loss or gradient")
    tol_loss, tol_grad = tol or TOL_TRAIN[precision]
    check(loss_rel <= tol_loss and total <= tol_grad,
          f"train step ({precision}) with kernels disagrees with the plain versions: "
          f"loss {loss_rel}, gradients {total}")


def train_phase():
    """The train step at 128x128 b16: kernels vs plain versions, launch
    counts, samples/s; then the entry point's run, checkpoint and resume.
    Returns the launches of the counted window."""
    t = time.perf_counter()
    algo, _ = build_flagship(SEED, "cuda")          # bf16, output conv not zeroed
    cfg = algo.cfg
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, 100.0))
    step = make_train_step(algo.loss_fn)
    batch = train_batch()
    algo.module.train()
    phase("train_build", seconds=round(time.perf_counter() - t, 2), batch=TRAIN_B,
          image_size=cfg.image_size, lr=cfg.lr, weight_decay=cfg.weight_decay, clip=100.0)

    for backend in ("cudnn", "fold"):
        for precision in ("bf16", "float32"):
            step_vs_plain(precision, batch, backend)

    launches = {k.name: 0 for k in kernels.KERNELS}
    rates = {}
    for backend in ("cudnn", "fold"):
        if backend != "cudnn":
            algo, _ = build_flagship(SEED, "cuda", conv_backend=backend)
            algo.module.train()
            state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                           cfg.weight_decay, 100.0))
            step = make_train_step(algo.loss_fn)
        # one count window: warm-up steps, then the timed ones
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        for _ in range(TRAIN_WARMUP):
            metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_TIMED):
            metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / TRAIN_TIMED
        counted = {k.name: k.launches for k in kernels.KERNELS}
        n = TRAIN_WARMUP + TRAIN_TIMED
        expected = {k.name: 0 for k in kernels.KERNELS}
        expected.update({k: n * v for k, v in TRAIN_EXPECTED.items()})
        if backend != "cudnn":
            expected["conv_" + backend] = n * (CONV_PER_EVAL[backend] + CONV_DGRAD_PER_STEP)
        rates[backend] = TRAIN_B / sec
        phase("train_steps", conv_backend=backend, steps=n, timed=TRAIN_TIMED,
              ms_per_step=1e3 * sec, train_samples_per_s=TRAIN_B / sec,
              loss=float(metrics["train/loss"]), launches=counted, expected_launches=expected,
              max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        check(counted == expected, f"train launches ({backend}) {counted}, expected {expected}")
        check(np.isfinite(float(metrics["train/loss"])), f"train loss ({backend}) not finite")
        for k, v in counted.items():
            launches[k] += v
        del algo, state, step
    phase("train_conv_backends_vs_cudnn", train_samples_per_s=rates)
    del batch

    # the entry point with remat: 2 steps and a validation at 128x128
    root = Path(tempfile.mkdtemp(prefix="ofd_train_remat_"))
    try:
        res = train_entry.run(2, out=str(root), sampling_timesteps=10, log_every=1, remat=True)
        phase("train_entry_point_remat", step=res["step"], remat=res["remat"],
              checkpoints=res["checkpoints"], loss=res["train"]["train/loss"],
              val_epe=res["val"].get("val/epe"), samples_per_s=res["samples_per_s"])
        check(res["remat"] and res["step"] == 2 and res["checkpoints"] == [2]
              and np.isfinite(res["train"]["train/loss"]) and "val/epe" in res["val"],
              "train.py --remat did not run its 2 steps and validation")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the entry point: 3 steps, validation, checkpoint; continued to 5
    root = Path(tempfile.mkdtemp(prefix="ofd_train_smoke_"))
    try:
        kw = dict(sampling_timesteps=10, log_every=1)
        first = train_entry.build(3, out=str(root / "a"), ckpt_every=3, **kw)
        first.train()
        first_val = dict(first.last_val)
        check(first.ckpt.steps() == [3] and first_val.get("step") == 3 and "val/epe" in first_val,
              "train.py run: no checkpoint or validation at step 3")
        saved = ({k: v.clone() for k, v in first.state.module.state_dict().items()},
                 copy.deepcopy(first.state.optimizer.state_dict()),
                 first.generator.get_state().clone())
        first.cfg = dataclasses.replace(first.cfg, max_steps=5, check_interval=5)
        first.train()
        uninterrupted = train_losses(root / "a")
        for name in ("b", "c"):
            shutil.copytree(root / "a" / "checkpoints" / "3", root / name / "checkpoints" / "3")
        restored = train_entry.build(5, out=str(root / "b"), **kw)
        step_r = restored.restore()
        same = (step_r == 3
                and all(torch.equal(v, saved[0][k])
                        for k, v in restored.state.module.state_dict().items())
                and all(torch.equal(v.cpu(), saved[1]["state"][i][name].cpu())
                        for i, st in restored.state.optimizer.state_dict()["state"].items()
                        for name, v in st.items())
                and torch.equal(restored.generator.get_state(), saved[2]))
        restored.train()
        resumed = train_entry.run(5, resume=True, out=str(root / "c"), **kw)
        resumed_losses = train_losses(root / "c")
        again = train_losses(root / "b")
        spread = max(abs(again[s_] - resumed_losses[s_]) for s_ in (4, 5))
        gap = max(abs(uninterrupted[s_] - resumed_losses[s_]) for s_ in (4, 5))
        phase("train_entry_point", first_val=first_val, restored_step=step_r,
              restored_bit_for_bit=same, resumed=resumed,
              losses_uninterrupted=[uninterrupted[4], uninterrupted[5]],
              losses_resumed=[resumed_losses[4], resumed_losses[5]],
              losses_second_resume=[again[4], again[5]], resume_gap=gap,
              run_to_run_spread=spread)
        check(same, "the restored step, parameters, optimizer state or generator differ "
              "from the saved ones")
        check(resumed["start_step"] == 3 and resumed["step"] == 5
              and resumed["checkpoints"] == [3, 5], "train.py --resume did not continue")
        check(uninterrupted[4] == resumed_losses[4],
              "the first resumed step's loss differs from the uninterrupted run's")
        check(gap <= max(4 * spread, 1e-4 * abs(uninterrupted[5])),
              f"resumed losses {resumed_losses} vs uninterrupted {uninterrupted}: "
              f"gap {gap}, spread {spread}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def native_train_phase():
    """The flagship trained at native 448x1024 b2 with remat, bf16, on a
    standard-normal batch from numpy seed 0 (the JAX bench.py row
    sintel_native_train_samples_per_sec): one step with every kernel
    against the all-plain step; then one count window of warm-up and timed
    steps with exact launches.  Returns the window's launches."""
    batch = train_batch(0, NATIVE_TRAIN_B, NATIVE.height, NATIVE.width)
    step_vs_plain("bf16", batch, remat=True, tol=TOL_TRAIN_NATIVE)
    algo, _ = build_flagship(SEED, "cuda", remat=True)
    cfg = algo.cfg
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, 100.0))
    step = make_train_step(algo.loss_fn)
    algo.module.train()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    for _ in range(NATIVE_TRAIN_WARMUP):
        metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NATIVE_TRAIN_TIMED):
        metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / NATIVE_TRAIN_TIMED
    counted = {k.name: k.launches for k in kernels.KERNELS}
    n = NATIVE_TRAIN_WARMUP + NATIVE_TRAIN_TIMED
    expected = {k.name: 0 for k in kernels.KERNELS}
    expected.update({k: n * v for k, v in NATIVE_TRAIN_EXPECTED.items()})
    phase("native_train", B=NATIVE_TRAIN_B, H=NATIVE.height, W=NATIVE.width, remat=True,
          precision=cfg.precision, steps=n, timed=NATIVE_TRAIN_TIMED, ms_per_step=1e3 * sec,
          native_train_samples_per_s=NATIVE_TRAIN_B / sec, loss=float(metrics["train/loss"]),
          max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counted,
          expected_launches=expected)
    check(np.isfinite(float(metrics["train/loss"])), "native train loss not finite")
    check(counted == expected, f"native train launches {counted}, expected {expected}")
    del algo, state, step, batch
    return counted


def main():
    smi = device_phase()
    build_phase()
    la128 = la_phase(B, SHAPES, "128x128")
    la_native = la_phase(NATIVE_B, NATIVE_SHAPES, "448x1024", iters=10)
    la_bwd = la_bwd_phase()
    la_bwd_native = la_bwd_phase(NATIVE_TRAIN_B, NATIVE_SHAPES, (torch.bfloat16, torch.float32),
                                 "448x1024", iters=5)
    flash_row, flash_err = flash_phase()
    flash_grad_phase()
    mid = middle_phase()
    splat_row, splat_err = splat_phase()
    splat_bitwise = splat_bitwise_phase()
    splat_bwd_row, splat_bwd_err = splat_bwd_phase()
    conv_rows_, conv_err = conv_phase()
    launches = slice_phase()
    for window in (middle_modules_phase, train_phase, native_train_phase):
        for k, n in window().items():
            launches[k] += n
    phase("launch_counts_all_paths", launches=launches)
    prof = profiler_phase()
    per_la = f"one 448x1024 b{NATIVE_B} UNet eval (8 launches, bf16 x)"
    per_step = f"one 128x128 b{TRAIN_B} train step (6 launches, bf16 x)"
    bwd = {kernels.LA_BWD_Q: "bwd_q", kernels.LA_BWD_KV1: "bwd_kv1",
           kernels.LA_BWD_KV2: "bwd_kv2"}
    rows = []
    for k in kernels.KERNELS:
        if k is kernels.FLASH:
            r, r8 = flash_row[NATIVE_B], flash_row[8]
            vals = dict(max_abs_err=flash_err, ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["sdpa_ms"], per="one launch at (2, 7168, 4, 32) bf16",
                        vs_library=r["ms"] / r["sdpa_ms"], bound_share=r["bound_ms"] / r["ms"],
                        at_8x7168=dict(ms=r8["ms"], library_ms=r8["sdpa_ms"],
                                       bound_ms=r8["bound_ms"],
                                       vs_library=r8["ms"] / r8["sdpa_ms"],
                                       bound_share=r8["bound_ms"] / r8["ms"]))
        elif k is kernels.SPLAT:
            r = splat_row
            nat = STEP_SPLATS[f"{NATIVE.height}x{NATIVE.width}_b{NATIVE_TRAIN_B}"]
            pr = prof["splat"][f"{NATIVE.height}x{NATIVE.width}_b{NATIVE_B}_bfloat16"]
            pyramid = {lb: dict(ms=p["ms"], device_ms=p["device_ms"])
                       for lb, p in prof["splat"].items() if lb.startswith("pyramid")}
            vals = dict(max_abs_err=splat_err, ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
                        per=f"one call at 448x1024 b{NATIVE_B} bf16 (3 + 1 channels)",
                        bound_share=r["bound_share"], device_ms=pr["device_ms"],
                        split_ms=pr["split_ms"], launches_per_call=pr["launches_per_call"],
                        pyramid_128x128_b16_f32=pyramid,
                        escape_share_modelled=r["escape_share_modelled"],
                        bitwise_cases=splat_bitwise,
                        per_native_step=dict(ms=nat["ms"], plain_ms=nat["plain_ms"],
                                             calls=nat["calls"],
                                             per=f"the splats of one 448x1024 b{NATIVE_TRAIN_B} "
                                                 "remat train step, on their own inputs"))
        elif k is kernels.SPLAT_BWD:
            r = splat_bwd_row
            vals = dict(max_abs_err=splat_bwd_err, ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound"], bound_by="bytes", library_ms=None,
                        per=f"one 128x128 b{TRAIN_B} train step (5 launches: scale 1 bf16, "
                            "scales 2-16 f32)")
        elif k in (kernels.CONV_ROWS, kernels.CONV_FOLD):
            r = conv_rows_[k.name]
            vals = dict(max_abs_err=conv_err[k.name], **r,
                        vs_library=r["ms"] / r["library_ms"], bound_share=r["bound_ms"] / r["ms"],
                        per=f"one launch, 3x3 64->64 at 448x1024 b{NATIVE_B} bf16"
                            + (" with the prologue" if k is kernels.CONV_FOLD else ""))
        elif k in (kernels.LA_MID_CTX, kernels.LA_MID_OUT):
            st = mid["ctx" if k is kernels.LA_MID_CTX else "out"]
            vals = dict(max_abs_err=st["err"], ms=st["ms"], plain_ms=st["plain_ms"],
                        bound_ms=st["bound"], bound_by=st["bound_by"], library_ms=None,
                        per=f"the qkv of the 8 blocks of one 448x1024 b{NATIVE_B} UNet eval "
                            "(8 launches, bf16)")
        elif k in bwd:
            st, nat = la_bwd[bwd[k]], la_bwd_native[bwd[k]]
            vals = dict(max_abs_err=max(st["err"], nat["err"]), ms=st["ms"],
                        plain_ms=st["plain_ms"], bound_ms=st["bound"], bound_by=st["bound_by"],
                        library_ms=None, per=per_step)
            if k is kernels.LA_BWD_KV1:     # row 4: sdot from ctx and dctx
                vals.update(library_ms=st["library_ms"], vs_library=st["ms"] / st["library_ms"],
                            bound_share=st["bound"] / st["ms"],
                            device_ms=st["launches"] * prof["bwd_kv1"][TRAIN_B],
                            launch_floor_ms=nat["launch_floor_ms"],
                            launch_floor_device_ms=prof["empty_device_ms"],
                            per_native_step=dict(ms=nat["ms"], device_ms=nat["launches"]
                                                 * prof["bwd_kv1"][NATIVE_TRAIN_B],
                                                 bound_ms=nat["bound"],
                                                 bound_share=nat["bound"] / nat["ms"],
                                                 plain_ms=nat["plain_ms"],
                                                 library_ms=nat["library_ms"],
                                                 vs_library=nat["ms"] / nat["library_ms"],
                                                 per=f"one 448x1024 b{NATIVE_TRAIN_B} train "
                                                     "step (8 launches, bf16 x)"))
            else:                            # rows 3 and 5: split TF32 on the tensor cores
                vals.update(bound_ms_f32_cores=st["bound_f32_cores"],
                            bound_share=nat["bound"] / nat["ms"],
                            per_native_step=dict(ms=nat["ms"], bound_ms=nat["bound"],
                                                 bound_ms_f32_cores=nat["bound_f32_cores"],
                                                 bound_share=nat["bound"] / nat["ms"],
                                                 plain_ms=nat["plain_ms"],
                                                 per=f"one 448x1024 b{NATIVE_TRAIN_B} train "
                                                     "step (8 launches, bf16 x)"))
        else:
            key = "ctx" if k is kernels.LA_CTX else "out"
            st, s128 = la_native[key], la128[key]
            vals = dict(max_abs_err=max(st["err"], s128["err"]), ms=st["ms"],
                        plain_ms=st["plain_ms"], bound_ms=st["bound"], bound_by=st["bound_by"],
                        library_ms=None, per=per_la, bound_share=st["bound"] / st["ms"])
            if k is kernels.LA_CTX:
                vals["bound_ms_f32_cores"] = st["bound_f32_cores"]
        rows.append({"name": k.name, "route": k.route, "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name], **vals})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
