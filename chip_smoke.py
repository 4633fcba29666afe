"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Budget: under 10 minutes on one H100, the kernel build included (one plain
``nvcc`` call per source, all started together; seconds each).  A run took
539 s on an H100 (596 s with the parity smoke at 20 steps; the real-data
phase ~2 minutes of it, the MatrixFlow and animation phase ~1.5), under
half the 1200 s limit.  Every line
it prints is one JSON object, flushed as it goes, apart from the card's
``nvidia-smi`` line.  Phases:

1. device: needs ``torch.cuda.is_available()``; prints the name and power
   limit of the card as ``nvidia-smi`` gives them (again before the kernels
   line), and its top SM clock.
2. build: compiles every CUDA source of the port and the data readers'
   host helper (``data/host_ops.cpp``, through nvcc) in parallel and prints
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
     non-finite values, at 16 and 17 channels at 128x128 over scales 1-16
     (the latent model's pyramid splats), the zero flow at scale 16 at 128x128 b16 and the
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
     scale 1 at 448x1024 b2, bit for bit against ``splat_bwd_raw`` (values
     as integers), and the hole mask of the tiny-weight construction at
     448x1024 against the plain path's;
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
   ``train_activations_128x128_b16``, TOL_BWD), rows 1 and 2 on the inputs
   of its block forwards (``fwd_on_activations``: TOL_CTX, TOL_OUT, as
   la_phase holds them), and the splat forward bit
   for bit against ``splat_fixed_plain`` on the inputs of that step's 10
   splats (``splat_on_step_inputs``, with their times), and the splat
   backward bit for bit against ``splat_bwd_raw`` on the inputs of its 5
   (``splat_bwd_on_step_inputs``, with their times); one
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
   captured activations (``train_activations_448x1024_b2``), the splat on
   its 11 splats' inputs and the splat backward on its 5; a count window of 2
   warm-up and 3 timed steps with exact launches, native train samples/s and
   the window's peak memory.
7. flow_diffuser_configs: every other configuration of
   ``flow_diffuser.yaml`` at the flagship's width (UNet 64, bf16, 128x128,
   weights from the seed, output conv not zeroed): ``target: target``,
   ``target: flow``, ``noiser: flow``, the single-forward model with the
   joint and the flow target, ``diffusion_flow_weight: 1``, and the AE
   chain (FlowPred trained 3 steps at b16 through ``train.py``, its
   checkpoint, the latent joint model loading its Autoencoder through
   ``ae``, held bit for bit to the trained one).  For each (FlowPred too):
   one 128x128 b16 train step with every kernel against the same step with
   every plain version (``TOL_TRAIN_CONFIGS``, from
   ``chip_train_spread.py --configs``), the model's flow (FlowPred's
   reconstruction) with the kernels against the plain versions; then a
   count window each for a sampler run (DDIM-50 at b8, the ancestral loop
   at T = 1000 at b2 under flow noise, one forward at b8 for the
   single-forward models: steps/s and frames/s) and for 2 train steps
   (finite losses and gradient norms), in which every kernel on the path
   must launch and no other; last the flow target at native 448x1024,
   DDIM-50 b2, through the flash kernel (50 launches).  Each
   configuration's train step (FlowPred's too) also holds rows 1-5 to their
   plain versions on its own block inputs and the splat forward and
   backward bit for bit on its own splat inputs (``check_captured``).
8. learner: FlowLearner at the bench's shape (128x128 b16, the reference's
   ten pyramid levels, UNet 64, weights from the seed, output conv not
   zeroed), f32 and bf16: one train step with every kernel against the same
   step with every plain version (the loss within TOL_LEARNER; the
   gradient, whose spread over seeds is 0.86-14x its norm, is recorded and
   not pinned), with rows 1-5 on that step's own block inputs and the
   splat forward (1664 calls) and backward (832) bit for bit on its own
   inputs, over all 832 distinct (level, offset) pairs; the kernel step's
   gradient against itself repeated and with the first frame nudged by one
   ulp, at flow_max 20 and 2 (``learner_gradient_sensitivity``); then a count window of 1 + 3 steps whose launches
   must be exactly 8 of rows 1-2, 6 of rows 3-5, 1664 splat forwards and 832
   backwards a step, and the samples/s of the 3 (``learner_train_steps``).
9. parity_smoke: ``training/parity.py::run_parity`` on the card, 10 steps
   each of the joint and learner stages at 32x32 b16, f32: the initial
   metrics, which depend on the data alone, within 1e-3 of JAX's recorded
   ones, finite final metrics, every kernel of both paths launched.
10. matrix_flow_animation: MatrixFlow and the animation family at full
   width (UNet 64, bf16, weights from the seed), every window's launches
   checked (rows 1-2 in every UNet eval, rows 3-5 in every train step, the
   splat forward only in MatrixFlow's debug-warp window, no other kernel).
   MatrixFlow at 128x128 b16 (radius 17): the default goal's train step
   with every kernel against the all-plain step (``TOL_FAMILY``) with rows
   1-5 on its own block inputs, a warm-up and 2 train steps and a
   val_step; ``filter_pred`` (289 output channels, a 17x17 unfold) for a
   warm-up, a step and a val_step with the peak memory, ``gt_filter_pred``
   for a warm-up and a step; the ``flow_in='first'`` debug warp through the splat kernel, bit
   for bit.  FrameGenerator at the JAX bench row's 256x256 b8 (a
   standard-normal stack from numpy seed 0, lr 1e-5): the step against
   its plain step with rows 1-5, 2 warm-ups and 4 timed steps
   (``video256_train_samples_per_sec``); at its yaml's 64 b8: the UNet
   against its plain version, the 1000-step ancestral loop (denoise
   steps/s) and a DDIM-50 val_step rolling out over 5 transitions of the
   video dataset.  FlowCompleter at 64x64 b16: its UNet float32 under
   bf16, the step against its plain step with rows 1-5, 2 train steps and
   a val_step.  ``train.py`` through both experiments (2 steps with a
   validation, ``--resume`` to 3) and ``sample.py --algorithm
   frame_generator --ckpt`` on the animation run.  Then 20 steps of each
   stage of ``training/parity_families.py``: the data-only metrics within
   1e-3 of JAX's recorded ones, every final metric finite.
   ``python3 chip_smoke.py --families-only`` runs the device, build and
   this phase alone and prints no result line (a development aid).
11. real_data: the JAX package's dress rehearsal on the port.  For
   Sintel (2 scenes of 13 frames at 1024x436), FlyingChairs (8 pairs at
   512x384) and KITTI (6 training and 3 validation pairs at 1242x375,
   sparse 16-bit flow), the rehearsal's trees, the port's fixture writer
   makes the tree, and the port's readers read it at the rehearsal's native
   sizes (1024,448, 512,384, 1248,376), b2: the loader's items/s by the
   rehearsal's definition (4 workers, one warm batch, then up to 6
   batches), over the whole first epoch from a cold start and over a second
   epoch (KITTI's densify memoised), the KITTI densify's seconds an item
   alone; then one count window through ``train.py`` (4 steps with remat and
   the rehearsal's flow_max 32, a DDIM-2 validation with its images,
   checkpoints at 2 and 4, ``--resume`` to 6, FlyingChairs' step 5 traced
   by ``--profile-step``), ``--tasks test`` (Sintel's
   must raise, as JAX's reader asserts its split) and ``sample.py --ckpt``
   at the native size, in which rows 1-6 and the splat forward and
   backward must launch and no other; the validation keys must be the
   rehearsal's (``debug/rehearsal_r05.jsonl``).  Then one train step at
   the dataset's shape (weights from the seed, output conv not zeroed)
   with rows 1-5 on its own block inputs, row 6 on its own q, k, v (KITTI's
   bottleneck N = 7332 takes the padded tail; Chairs' is 3072) and the
   splat forward and backward bit for bit on its own splat inputs, and
   the samples/s of that step alone on the batch (1 warm-up, 3 timed), for
   the loader-fed rate of ``train.py``'s steps 2-4 to stand beside.  One
   ``real_data`` line a dataset with the card's name and power limit.
   ``python3 chip_smoke.py --real-data-only`` runs the device, build and
   this phase alone and prints no result line (a development aid).
12. profiler: device times from ``torch.profiler``, after the last
   host-clock window, so that no profiler trace runs before one: the
   splat forward by pass and its launches per call at 128x128 b8 and
   448x1024 b2 (bf16, f32) and at the pyramid loss's f32 scales 2-16 at
   128x128 b16 by a flow and by a zero flow (``splat_by_pass`` lines, with
   CUDA-event ms taken before the first trace); row 4's device time a
   launch at b16 and b2 and an empty kernel's (``device_times``); the splat
   backward's device time a call at each case of its phase and per train
   step on the two steps' captured inputs (``splat_bwd_device_times``);
   the device times of rows 7 and 8 a call at each qkv of their phase and
   summed over a native b2 eval (``mid_ctx_device_times``, row 8's keys
   prefixed ``out_``); one f32 learner step's device-busy time against its
   wall time, by kernel kind (``learner_step_device_time``).
13. the kernels line: for each kernel its route, source, the TPU kernel it
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
   ``per_native_step`` (its 11 calls on a native step's inputs); for the
   splat backward ``device_ms`` (its 5 cases of a 128x128 b16 step),
   ``per_128x128_step`` and ``per_native_step`` (its 5 calls on each
   step's own inputs: events, plain, bound and device ms); for rows 7 and
   8 ``device_ms`` (torch.profiler, a native b2 eval's 8 blocks) and
   ``bound_share`` (bound ms / device ms); every row also
   ``learner_launches_per_step``.
14. the result line.

Any failure raises and exits non-zero without the result line; so does a
run without a CUDA device or without the port's package beside this file.
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from opticalflowdiffusion_tpu_torch import kernels, profile_step
from opticalflowdiffusion_tpu_torch import sample as sample_entry
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.algorithms.base import to_batch
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.algorithms.flow_learner import FlowLearner
from opticalflowdiffusion_tpu_torch.algorithms.flow_pred import FlowPred
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP, FLOW_LEARNER, FLOW_PRED, NATIVE
from opticalflowdiffusion_tpu_torch.data import fixtures, get_dataset, host
from opticalflowdiffusion_tpu_torch.data.loader import DataLoader
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
from opticalflowdiffusion_tpu_torch.ops import pyramid as pyr
from opticalflowdiffusion_tpu_torch.sample import batch_items
from opticalflowdiffusion_tpu_torch.sample import build as build_flagship
from opticalflowdiffusion_tpu_torch.training import parity

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
    with concurrent.futures.ThreadPoolExecutor(len(kbuild.SOURCES) + 1) as pool:
        helper = pool.submit(host.load)
        list(pool.map(kbuild.build, kbuild.SOURCES))
        helper.result()
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


def mid_blocks(shapes):
    """{N: blocks} of a UNet eval's qkv shapes."""
    counts = {}
    for N, _, c in shapes:
        counts[N] = counts.get(N, 0) + c
    return counts


def mid_qkv(i, Bn, N, dtype):
    """A standard-normal qkv (B, 384, N) from seed 1000 + i, laid out as the
    module's 1x1 conv gives it, as the public (B, N, 384) view."""
    g = torch.Generator(device="cuda").manual_seed(1000 + i)
    return torch.randn(Bn, 384, N, generator=g, device="cuda").to(dtype).transpose(1, 2)


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
        for i, (N, count) in enumerate(mid_blocks(shapes).items()):
            for dtype in (torch.bfloat16, torch.float32):
                qkv = mid_qkv(i, Bn, N, dtype)
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


def traced_device_events(fn, tries=20):
    """The device events (kernels and memsets) of one torch.profiler trace
    of ``fn()``.  A trace that holds no device event at all is taken again,
    up to ``tries`` traces in all, and each retry is printed: CUPTI now and
    then hands back an empty trace of calls whose kernels did launch (six
    times in one run of this script, at most twice in a row).  Fails when
    every trace is empty, so that no device time is read as 0 from a lost
    trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if evs:
            break
        phase("profiler_empty_trace", attempt=attempt + 1, of=tries)
    check(evs, f"{tries} torch.profiler traces in a row held no device event")
    return evs


def device_split(fn, n=20):
    """torch.profiler over ``n`` calls of ``fn``: device ms per call by pass
    (the splat's three kernels by name, anything else by its own name) and
    the launches per call (kernels and memsets).  Only profiler_phase calls
    it, after the last host-clock window."""
    fn()
    evs = traced_device_events(lambda: [fn() for _ in range(n)])
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
# the latent model's pyramid splats: 16 latent channels (17 with the weight
# channel that the warp appends) at 128x128, scales 1-16
LATENT_SPLAT_GEOMS = tuple((C, 128, 128, s, (0, 0)) for C in (16, 17) for s in (1, 2, 4, 8, 16))


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
    cases = [(k, 2, C, H, W, sc, off, dt)
             for C, H, W, sc, off in SPLAT_BITWISE_GEOMS + LATENT_SPLAT_GEOMS
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


def clone_once():
    """``keep(t)``: a detached copy of ``t``, one per tensor and version
    within a capture window (the pyramid hands one packed input and one
    flow to each of its 832 offsets); the window holds the original, so its
    address is not reused while the window lasts."""
    cache = {}

    def keep(t):
        key = (t.data_ptr(), t._version, tuple(t.shape), t.dtype, tuple(t.stride()))
        if key not in cache:
            cache[key] = (t, t.detach().clone())
        return cache[key][1]

    return keep


@contextlib.contextmanager
def captured_splat_bwd():
    """The arguments of every splat backward kernel call inside the window,
    detached copies, in call order."""
    calls, original, keep = [], sp.splat_bwd, clone_once()

    def capture(inp, flow, g, scale=1, offset=(0, 0)):
        calls.append((keep(inp), keep(flow), g.detach().clone(),
                      int(scale), tuple(int(o) for o in offset)))
        return original(inp, flow, g, scale, offset)

    sp.splat_bwd = capture
    try:
        yield calls
    finally:
        sp.splat_bwd = original


def splat_bwd_on_step_inputs(calls, label, launched, expected=TRAIN_EXPECTED["splat_bwd"],
                             timed=True):
    """The splat backward kernel bit for bit against splat_bwd_raw on the
    (inp, flow, g) of every backward splat of a train step (``calls`` from
    captured_splat_bwd; all ``launched`` of the step's launches,
    ``expected``: the flagship's 5), with the kernel's and splat_bwd_raw's
    CUDA-event times and the bytes bound summed over the step (not with
    ``timed`` False).  Returns the per-step sums, whether every call was bit
    for bit, the calls (profiler_phase takes their device time) and the
    distinct (scale, offset) pairs."""
    check(len(calls) == launched == expected,
          f"{label}: captured {len(calls)} splat backward calls of the step's {launched} "
          f"launches, expected {expected}")
    rows, bad = [], []
    kernel_ms = plain_ms = bound = 0.0
    for i, (inp, flow, g, scale, off) in enumerate(calls):
        exact = splat_bwd_equal(sp.splat_bwd(inp, flow, g, scale, off),
                                sp.splat_bwd_raw(inp, flow, g, scale, off))
        torch.cuda.synchronize()
        if not exact:
            bad.append(i)
        if not timed:
            continue
        ms = cuda_ms(lambda: sp.splat_bwd(inp, flow, g, scale, off), 10)
        pms = cuda_ms(lambda: sp.splat_bwd_raw(inp, flow, g, scale, off), 3, 1)
        b = splat_bwd_bound_ms(inp, g)
        kernel_ms, plain_ms, bound = kernel_ms + ms, plain_ms + pms, bound + b
        finite = torch.isfinite(flow)
        rows.append(dict(shape=list(inp.shape), dtype=str(inp.dtype).split(".")[1],
                         scale=scale, offset=list(off), ms=round(ms, 5), bound_ms=b,
                         max_abs_flow_px=float(flow[finite].abs().max()) if finite.any() else 0.0))
    pairs = sorted({(scale, off) for _, _, _, scale, off in calls})
    phase("splat_bwd_on_step_inputs", at=label, calls=len(calls), bitwise_failed=bad,
          distinct_scale_offsets=len(pairs), kernel_ms_per_step=kernel_ms if timed else None,
          plain_ms_per_step=plain_ms if timed else None,
          bound_ms_per_step=bound if timed else None, per_call=rows)
    check(not bad, f"splat_bwd differs from splat_bwd_raw on the {label} inputs: {bad}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bitwise=not bad, calls=calls,
                pairs=len(pairs))


@contextlib.contextmanager
def captured_splats():
    """The arguments of every forward splat kernel call inside the window,
    detached copies, in call order."""
    calls, original, keep = [], sp.splat_fwd, clone_once()

    def capture(inp, flow, scale=1, offset=(0, 0)):
        calls.append((keep(inp), keep(flow), int(scale), tuple(int(o) for o in offset)))
        return original(inp, flow, scale, offset)

    sp.splat_fwd = capture
    try:
        yield calls
    finally:
        sp.splat_fwd = original


def splat_on_step_inputs(calls, label, launched, timed=True):
    """The forward splat kernel bit for bit against splat_fixed_plain on the
    (inp, flow) of every splat of a train step (``calls`` from
    captured_splats; all ``launched`` of the step's launches), with the
    modelled share of corners beyond the windows per call
    and the kernel's and splat_raw's CUDA-event times summed over the step
    (not with ``timed`` False).  Returns the per-step sums and the
    distinct (scale, offset) pairs."""
    check(0 < len(calls) == launched,
          f"{label}: captured {len(calls)} splat calls of the step's {launched} launches")
    rows, bad = [], []
    kernel_ms = plain_ms = 0.0
    for i, (inp, flow, scale, off) in enumerate(calls):
        a, ma = sp.splat_fwd(inp, flow, scale, off)
        f, mf = sp.splat_fixed_plain(inp, flow, scale, off)
        torch.cuda.synchronize()
        if not (bitwise_equal(a, f) and bool(torch.equal(ma, mf))):
            bad.append(i)
        if not timed:
            del a, ma, f, mf
            continue
        ms = cuda_ms(lambda: sp.splat_fwd(inp, flow, scale, off), 10)
        pms = cuda_ms(lambda: sp.splat_raw(inp, flow, scale, off), 3, 1)
        kernel_ms, plain_ms = kernel_ms + ms, plain_ms + pms
        finite = torch.isfinite(flow)
        rows.append(dict(shape=list(inp.shape), dtype=str(inp.dtype).split(".")[1],
                         scale=scale, offset=list(off), ms=round(ms, 5),
                         max_abs_flow_px=float(flow[finite].abs().max()) if finite.any() else 0.0,
                         escape_share_modelled=splat_escape_share(flow, scale, off)))
        del a, ma, f, mf
    pairs = sorted({(scale, off) for _, _, scale, off in calls})
    phase("splat_on_step_inputs", at=label, calls=len(calls), bitwise_failed=bad,
          distinct_scale_offsets=len(pairs), kernel_ms_per_step=kernel_ms if timed else None,
          plain_ms_per_step=plain_ms if timed else None, per_call=rows)
    check(not bad, f"splat kernel differs from splat_fixed_plain on the {label} inputs: {bad}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, calls=len(calls), pairs=len(pairs))


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
    launch at b16 and b2; an empty kernel's launch; the splat backward's
    device ms a call at splat_bwd_phase's cases and a step on the captured
    train steps' inputs; the device ms of row 7 (the pass and its combine)
    and of row 8 a call at middle_phase's qkv, and each summed over a
    native b2 eval's 8 blocks (bf16).  Returns {"splat": {label: row},
    "bwd_kv1": {B: ms a launch}, "empty_device_ms": ms, "splat_bwd": {label:
    row}, "mid_ctx": {label: row}, "mid_ctx_native_eval_device_ms": ms,
    "mid_out_native_eval_device_ms": ms}."""
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
    # the splat backward: device ms a call at splat_bwd_phase's cases, and
    # summed over the backward splats of each captured train step
    bwd = {}
    for i, (Bn, H, W, scale) in enumerate(SPLAT_BWD_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            v, flow, cot = splat_bwd_inputs(i, Bn, H, W, scale, dtype)
            split, per_call = device_split(lambda: sp.splat_bwd(v, flow, cot, scale))
            label = f"{H}x{W}_b{Bn}_s{scale}_{str(dtype).split('.')[1]}"
            bwd[label] = dict(device_ms=sum(split.values()), launches_per_call=per_call,
                              bound_ms=splat_bwd_bound_ms(v, cot))
            del v, flow, cot
    for label, st in STEP_SPLAT_BWD.items():
        bwd["train_step_" + label] = dict(device_ms=sum(
            sum(device_split(lambda a=a: sp.splat_bwd(*a))[0].values()) for a in st["calls"]),
            calls=len(st["calls"]), bound_ms=st["bound_ms"])
    phase("splat_bwd_device_times", per_case=bwd)
    # rows 7 and 8: device ms a call at middle_phase's qkv (row 8 on row 7's
    # ctx), and each summed over a native b2 eval's 8 blocks (bf16)
    mid, mid_native, out_native = {}, 0.0, 0.0
    for Bn, shapes, at in ((B, SHAPES, "128x128"), (NATIVE_B, NATIVE_SHAPES, "448x1024")):
        for i, (N, count) in enumerate(mid_blocks(shapes).items()):
            for dtype in (torch.bfloat16, torch.float32):
                qkv = mid_qkv(i, Bn, N, dtype)
                with torch.no_grad():
                    split, per_call = device_split(lambda: am.middle_ctx(qkv), 10)
                    cp = am.middle_ctx(qkv)
                    out_split, out_per_call = device_split(lambda: am.middle_out(qkv, cp), 10)
                row = dict(B=Bn, N=N, blocks=count, device_ms=sum(split.values()),
                           launches_per_call=per_call,
                           bound_ms=max(mid_bound_ms(Bn, N, qkv.element_size())),
                           out_device_ms=sum(out_split.values()),
                           out_launches_per_call=out_per_call)
                mid[f"{at}_b{Bn}_N{N}_{str(dtype).split('.')[1]}"] = row
                if at == "448x1024" and dtype == torch.bfloat16:
                    mid_native += count * row["device_ms"]
                    out_native += count * row["out_device_ms"]
                del qkv, cp
    phase("mid_ctx_device_times", per_case=mid, native_eval_device_ms=mid_native,
          out_native_eval_device_ms=out_native)
    learner = learner_step_device_time()
    return {"learner": learner, "splat": rows, "bwd_kv1": kv1, "empty_device_ms": empty,
            "splat_bwd": bwd, "mid_ctx": mid, "mid_ctx_native_eval_device_ms": mid_native,
            "mid_out_native_eval_device_ms": out_native}


def learner_step_device_time():
    """One f32 FlowLearner train step (learner_train_steps' state) under
    torch.profiler: the device-busy ms (the union of its device events'
    intervals), the kernel ms by kind (profile_step.py's kinds) and the
    device events, against the step's wall ms from the host-clock window.
    Frees the state."""
    st = LEARNER_PROFILE
    step, state, batch, gen = st["step"], st["state"], st["batch"], st["gen"]
    evs = traced_device_events(lambda: step(state, batch, gen))
    kinds = {}
    for e in evs:
        kind = profile_step.kind_of(e.name)
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = profile_step.busy_us([(e.time_range.start, e.time_range.end) for e in evs]) / 1e3
    row = dict(wall_ms=st["wall_ms"], device_ms=device_ms,
               idle_share=1.0 - device_ms / st["wall_ms"], device_events=len(evs),
               device_ms_by_kind=kinds)
    phase("learner_step_device_time", precision="float32", B=batch[0].shape[0],
          H=batch[0].shape[2], W=batch[0].shape[3], **row)
    LEARNER_PROFILE.clear()
    return row


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


# the splat backward's cases: (B, H, W, scale), each in bf16 and f32 values
SPLAT_BWD_CASES = tuple((TRAIN_B, 128, 128, sc) for sc in (1, 2, 4, 8, 16)) + ((2, 448, 1024, 1),)


def splat_bwd_inputs(i, Bn, H, W, scale, dtype):
    """Values in [-1, 1] (4 channels), a 4 px flow with one infinite target
    and a standard-normal cotangent, from seed 800 + i."""
    g = torch.Generator(device="cuda").manual_seed(800 + i)
    v = (2 * torch.rand(Bn, 4, H, W, generator=g, device="cuda") - 1).to(dtype)
    flow = 4 * torch.randn(Bn, 2, H, W, generator=g, device="cuda")
    flow[0, 0, 0, 0] = float("inf")
    cot = torch.randn(Bn, 4, H // scale, W // scale, generator=g, device="cuda")
    return v, flow, cot


def splat_bwd_bound_ms(inp, cot):
    """Bytes ms of one splat backward: inp, flow and the cotangent read once,
    d_inp and d_flow written once."""
    Bn, C, H, W = inp.shape
    nbytes = Bn * H * W * (2 * C * inp.element_size() + 2 * 2 * 4) + cot.numel() * 4
    return 1e3 * nbytes / HBM_BPS


def splat_bwd_equal(got, want):
    """(d_inp, d_flow) equal bit for bit, values as integers."""
    return all(bitwise_equal(a, b) for a, b in zip(got, want))


def splat_bwd_phase():
    """The splat backward kernel bit for bit against splat_bwd_raw (and
    within TOL_SPLAT) at every scale of a 128x128 b16 train step (bf16 and
    f32 values) and at scale 1 at 448x1024 b2; and the tiny-weight
    hole-mask construction at 448x1024.  Returns the per-step sums (bf16 at
    scale 1 as the UNet's warp, f32 at the pyramid scales as the loss) with
    whether every case was bit for bit, and the largest error."""
    per_step = {"ms": 0.0, "plain_ms": 0.0, "bound": 0.0, "bitwise": True}
    worst = 0.0
    for i, (Bn, H, W, scale) in enumerate(SPLAT_BWD_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            v, flow, cot = splat_bwd_inputs(i, Bn, H, W, scale, dtype)
            d_inp, d_flow = sp.splat_bwd(v, flow, cot, scale)
            w_inp, w_flow = sp.splat_bwd_raw(v, flow, cot, scale)
            torch.cuda.synchronize()
            exact = splat_bwd_equal((d_inp, d_flow), (w_inp, w_flow))
            e_in = err(d_inp, w_inp)[0] / max(float(w_inp.float().abs().max()), 1e-30)
            e_fl = err(d_flow, w_flow)[0] / max(float(w_flow.abs().max()), 1e-30)
            times = {"ms": cuda_ms(lambda: sp.splat_bwd(v, flow, cot, scale)),
                     "plain_ms": cuda_ms(lambda: sp.splat_bwd_raw(v, flow, cot, scale), 5, 1)}
            bound = splat_bwd_bound_ms(v, cot)
            phase("kernel_vs_plain", kernel="splat_bwd", B=Bn, H=H, W=W, scale=scale,
                  dtype=str(dtype).split(".")[1], bitwise_vs_plain=exact, d_inp_max_rel=e_in,
                  d_flow_max_rel=e_fl, bound_ms=bound, **{k: round(t, 5) for k, t in times.items()})
            per_step["bitwise"] &= exact
            check(exact, f"splat_bwd differs from splat_bwd_raw at {Bn, H, W, scale, dtype}")
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


@contextlib.contextmanager
def captured_block_fwd():
    """The arguments of every forward of the fused block on the kernels
    (``af._forward``: rows 1 and 2) inside the window, detached copies, in
    call order."""
    calls, original = [], af._forward

    def capture(*args):
        calls.append(tuple(a.detach().clone() for a in args))
        return original(*args)

    af._forward = capture
    try:
        yield calls
    finally:
        af._forward = original


def fwd_on_activations(calls, label):
    """Rows 1 and 2 against ctx_plain and out_plain on the inputs that
    reached each block's forward in a train step (``calls`` from
    captured_block_fwd), as la_phase holds them: the context (and m, s)
    within TOL_CTX of its scale; the output, fed the plain context, within
    TOL_OUT of the residual branch's scale plus one bf16 ulp of its largest
    value for bf16 x.  A kernel fault shows here apart from the draw of the
    step's random-weight loss.  One kernel_vs_plain line per row."""
    ctx_rel, out_rel, shapes = [], [], []
    with torch.no_grad():
        for x, g_pre, w_qkv, w_out, b_out, g_post in calls:
            w16 = w_qkv.to(torch.bfloat16).contiguous()
            g32 = g_pre.float().contiguous()
            w_kv, w_q = w16[af.HIDDEN:], w16[:af.HIDDEN]
            c_k, m_k, s_k = af.linear_attention_ctx(x, g32, w_kv)
            c_p, m_p, s_p = af.ctx_plain(x, g32, w_kv)
            ctx_rel.append(max(err(c_k, c_p)[0] / max(float(c_p.abs().max()), 1e-30),
                               err(m_k, m_p)[0] / max(float(m_p.abs().max()), 1e-30),
                               float(((s_k - s_p).abs() / s_p).max())))
            args = (x, g32, w_q, c_p, w_out.to(torch.bfloat16).contiguous(),
                    b_out.float().contiguous(), g_post.float().contiguous())
            y_k, y_p = af.linear_attention_out(*args), af.out_plain(*args)
            rounding = 2.0 ** -7 if x.dtype == torch.bfloat16 else 0.0
            scale = max(float((y_p.float() - x.float()).abs().max()), 1e-30)
            allowed = TOL_OUT * scale + rounding * float(y_p.float().abs().max())
            out_rel.append(err(y_k, y_p)[0] / allowed * TOL_OUT)
            shapes.append(list(x.shape))
            del c_k, m_k, s_k, c_p, m_p, s_p, y_k, y_p
    torch.cuda.synchronize()
    for k, e, tol in (("ctx", ctx_rel, TOL_CTX), ("out", out_rel, TOL_OUT)):
        phase("kernel_vs_plain", kernel=f"linear_attention_{k}", at=label, blocks=len(e),
              shapes=shapes, max_rel=max(e), pin=tol, per_block=[sig(v) for v in e])
        check(max(e) <= tol, f"linear_attention_{k} disagrees with its plain version on the "
              f"{label} activations: {e}")


# the splat kernels on the captured inputs of one train step, by "HxW_bB"
STEP_SPLATS = {}
STEP_SPLAT_BWD = {}


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
    cuDNN bf16 step also holds rows 1-2 (fwd_on_activations) and rows 3-5
    (bwd_on_activations) to their plain versions on its own block
    activations, the splat kernel bit for bit
    to splat_fixed_plain on its splats' own inputs (splat_on_step_inputs),
    and the splat backward bit for bit to splat_bwd_raw on its own inputs
    (splat_bwd_on_step_inputs)."""
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
                fwd_calls = stack.enter_context(captured_block_fwd())
                calls = stack.enter_context(captured_block_bwd())
                splat_calls = stack.enter_context(captured_splats())
                splat_bwd_calls = stack.enter_context(captured_splat_bwd())
            launched = (kernels.SPLAT.launches, kernels.SPLAT_BWD.launches)
            loss_k, g_k = step_grads(algo, batch, 11)
            launched = (kernels.SPLAT.launches - launched[0],
                        kernels.SPLAT_BWD.launches - launched[1])
        if capture:
            label = f"{batch[0].shape[2]}x{batch[0].shape[3]}_b{batch[0].shape[0]}"
            fwd_on_activations(fwd_calls, "train_activations_" + label)
            bwd_on_activations(calls, "train_activations_" + label)
            STEP_SPLATS[label] = splat_on_step_inputs(splat_calls, "train_step_" + label,
                                                      launched[0])
            STEP_SPLAT_BWD[label] = splat_bwd_on_step_inputs(splat_bwd_calls,
                                                             "train_step_" + label, launched[1])
            del fwd_calls, calls, splat_calls, splat_bwd_calls
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

# FlowDiffuser's other configurations (flow_diffuser.yaml), each at the
# flagship's width (UNet 64, bf16, 128x128, weights from the seed, output
# conv not zeroed): (label, config fields); the latent model loads the
# Autoencoder of a FlowPred run of FLOWPRED_STEPS steps (AE chain)
CONFIGS = (("target", dict(target="target")), ("flow", dict(target="flow")),
           ("flownoise", dict(noiser="flow")), ("single_joint", dict(is_diffusion=False)),
           ("single_flow", dict(is_diffusion=False, target="flow")),
           ("flowloss", dict(diffusion_flow_weight=1.0)), ("latent", dict(latent=True)))
FLOWPRED_STEPS = 3
CONFIG_TRAIN_STEPS = 2
# sampler runs: DDIM-50 at b8 (image noise), the ancestral loop at the yaml's
# T = 1000 at b2 (flow noise: the parity flownoise stage's sampler), one
# forward at b8 (the single-forward models)
CONFIG_DDIM, CONFIG_B, FLOWNOISE_B = 50, 8, 2
# the flow target at native 448x1024: DDIM-50 at b2, through row 6
NATIVE_FLOW_B = 2
# the kernels each window of a configuration must launch (rows 1-2 in every
# UNet eval, the AE's included; rows 3-5 in every train step; the splat
# forward wherever a frame is warped: UnetWithWarp, the preprocess of the
# target and joint targets, the pyramid loss, the flow target's final warp;
# its backward wherever a train step differentiates a warp); every other
# kernel must launch no time at 128x128 under cuDNN
FWD_KERNELS = ("linear_attention_ctx", "linear_attention_out")
BWD_KERNELS = ("linear_attention_bwd_q", "linear_attention_bwd_kv1", "linear_attention_bwd_kv2")
# a train step with every kernel vs every plain version, per configuration
# (loss, gradients): the flagship's pins (TOL_TRAIN bf16), or wider ones
# where a configuration's spread over seeds 0-4 needs it
# (chip_train_spread.py --configs, on an H100: the largest loss and gradient
# differences target 9.39e-4 and 1.81e-2, latent 1.06e-3 and 7.2e-3,
# single_joint 1.99e-3 and 0.338).  The single-forward joint model's only
# loss term is the full-resolution splat of the conditioning by a flow that
# the random UNet puts at ~200 px: a bf16 rounding that moves the flow
# moves where its gradient is read (the pyramid of the diffusion models
# averages that out)
TOL_TRAIN_CONFIGS = {"target": (1.5e-3, 3e-2), "latent": (1.5e-3, 2e-2),
                     "single_joint": (3e-3, 0.5)}
# FlowPred's reconstruction (a frame in [0, 1], bf16 through two UNets) with
# the kernels vs the plain versions of the kernels, relative to its scale
# (max, mean): bf16's ulp at 1 is 2^-8, and the f32 sums of the linear
# attention in another order flip roundings that the decoder carries to a
# few pixels (0.0552 and 0.0527 max, 0.0037 and 0.0034 mean in two runs of
# seed 0 on an H100)
TOL_RECON = (0.1, 0.01)


def config_algo(fields, sampling_timesteps=CONFIG_DDIM, seed=SEED):
    """A FlowDiffuser configuration at the flagship's width and size."""
    if fields.get("noiser") == "flow":
        sampling_timesteps = None                   # the ancestral loop
    cfg = dataclasses.replace(FLAGSHIP, zero_init=False, sampling_timesteps=sampling_timesteps,
                              **fields)
    return FlowDiffuser(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))


def on_path(algo, window):
    """The kernels that ``window`` ('train' or 'sample') of ``algo`` must
    launch at 128x128 under cuDNN."""
    names = set(FWD_KERNELS)
    warps = getattr(algo, "target", "joint") != "flow" or window == "sample"
    if window == "train":
        names |= set(BWD_KERNELS)
        if warps:
            names.add("splat_bwd")
    if warps:
        names.add("splat_fwd")
    return names


def check_launches(label, launches, must):
    """Every kernel in ``must`` launched, every other one not."""
    missing = sorted(k for k in must if launches[k] == 0)
    extra = sorted(k for k, n in launches.items() if n and k not in must)
    check(not missing and not extra,
          f"{label}: kernels of the path not launched {missing}, off the path launched {extra}")


@contextlib.contextmanager
def captured_step():
    """The captures of one train step: the blocks' forward and backward
    inputs, the splat forward's and backward's, and the splat launches of
    the window (set on exit)."""
    with contextlib.ExitStack() as stack:
        cap = dict(fwd=stack.enter_context(captured_block_fwd()),
                   bwd=stack.enter_context(captured_block_bwd()),
                   splats=stack.enter_context(captured_splats()),
                   splat_bwd=stack.enter_context(captured_splat_bwd()))
        before = (kernels.SPLAT.launches, kernels.SPLAT_BWD.launches)
        yield cap
        cap["launched"] = (kernels.SPLAT.launches - before[0],
                           kernels.SPLAT_BWD.launches - before[1])


def check_captured(cap, label, timed=True):
    """Rows 1-2 and 3-5 against their plain versions on a step's own block
    inputs, the splat forward bit for bit against splat_fixed_plain and its
    backward against splat_bwd_raw on the step's own splat inputs (those
    that the step launched; a step without a warp launches none).  Returns
    (distinct forward, distinct backward (scale, offset) pairs)."""
    fwd_on_activations(cap["fwd"], "train_activations_" + label)
    if cap["bwd"]:
        bwd_on_activations(cap["bwd"], "train_activations_" + label)
    fwd_pairs = bwd_pairs = 0
    if cap["launched"][0] or cap["splats"]:
        fwd_pairs = splat_on_step_inputs(cap["splats"], "train_step_" + label,
                                         cap["launched"][0], timed)["pairs"]
    if cap["launched"][1] or cap["splat_bwd"]:
        bwd_pairs = splat_bwd_on_step_inputs(cap["splat_bwd"], "train_step_" + label,
                                             cap["launched"][1], cap["launched"][1],
                                             timed)["pairs"]
    return fwd_pairs, bwd_pairs


def config_step_vs_plain(algo, label, batch, tol=None, capture=True):
    """One train step's loss and gradients of ``algo`` (FlowDiffuser or
    FlowPred) with every kernel against the same step with every plain
    version (the same weights, batch and draws), as step_vs_plain holds the
    flagship; with ``capture`` also the kernels against their plain
    versions on that step's own inputs (check_captured: rows 1-5, the splat
    forward and backward bit for bit)."""
    algo.module.train()
    with captured_step() if capture else contextlib.nullcontext() as cap:
        loss_k, g_k = step_grads(algo, batch, 11)
    if capture:
        check_captured(cap, f"{label}_128x128_b{batch[0].shape[0]}")
        del cap
    with plain_versions(attention="passes", splat=True):
        loss_p, g_p = step_grads(algo, batch, 11)
    algo.module.eval()
    rel, worst, total = grad_diff(g_k, g_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    tol_loss, tol_grad = tol or TOL_TRAIN_CONFIGS.get(label, TOL_TRAIN["bf16"])
    phase("config_train_step_vs_plain", config=label, B=batch[0].shape[0],
          H=batch[0].shape[2], W=batch[0].shape[3], loss=loss_k, plain_loss=loss_p,
          loss_rel=loss_rel, grad_leaves=len(rel), grad_global_rel=total,
          grad_worst_leaf=worst, grad_worst_rel=rel[worst], pins=[tol_loss, tol_grad])
    check(np.isfinite(loss_k) and all(torch.isfinite(g).all() for g in g_k.values()),
          f"{label}: non-finite loss or gradient")
    check(loss_rel <= tol_loss and total <= tol_grad,
          f"{label}: train step with kernels disagrees with the plain versions: "
          f"loss {loss_rel}, gradients {total}")
    return loss_rel, total


def config_forward_vs_plain(label, fwd, tol=TOL_FLOW):
    """``fwd()`` (the model's flow, or FlowPred's reconstruction) with the
    kernels against the same with the plain versions of the kernels (the
    linear attention's passes, the splat): within ``tol`` of its scale."""
    with torch.no_grad():
        out_k = fwd()
        with plain_versions(attention="passes", splat=True):
            out_p = fwd()
    torch.cuda.synchronize()
    scale = float(out_p.abs().max())
    e = err(out_k, out_p)
    phase("config_forward_vs_plain", config=label, shape=list(out_k.shape), max_abs=e[0],
          mean_abs=e[1], scale=scale, pins=list(tol))
    check(torch.isfinite(out_k).all() and scale > 0, f"{label}: forward not finite")
    check(e[0] <= tol[0] * scale and e[1] <= tol[1] * scale,
          f"{label}: forward with kernels disagrees with the plain versions: {e}, scale {scale}")


def model_flow(algo, cond):
    """The model's flow head for ``cond``: at t = 500 from a normal state
    (the diffusion models), or the single forward."""
    Bn, _, H, W = cond.shape
    if not algo.is_diffusion:
        return lambda: algo._forward(cond, additional_out=True)[:, -2:]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(Bn, algo.channels, H, W, generator=g, device="cuda")
    tt = torch.full((Bn,), 500, dtype=torch.long, device="cuda")
    return lambda: algo.model_fn(x, cond, tt, additional_out=True)[:, -2:]


def config_sample(label, algo, items, must, native=False):
    """One count window: preprocess and sample (or the one forward), the
    outputs' shapes and finiteness, the launches.  Returns (result,
    launches)."""
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
    Bn, _, H, W = cond.shape
    if algo.is_diffusion:
        steps = algo.sched.sampling_timesteps
        sampler = "ddim" if algo.sched.is_ddim_sampling else "ancestral"
    else:
        steps, sampler = 1, "single_forward"
    finite = ~torch.isnan(samples)
    res = {"config": label, "batch": Bn, "height": H, "width": W, "sampler": sampler,
           "denoise_steps": steps, "seconds": sec, "denoise_steps_per_s": steps / sec,
           "frames_per_s": Bn / sec, "samples_shape": list(samples.shape),
           "flow_shape": list(flow.shape), "nan_share": float((~finite).float().mean()),
           "finite_values_finite": bool(torch.isfinite(samples[finite]).all()
                                        and torch.isfinite(flow).all())}
    phase("config_sample", launches=launches, **res)
    check(res["samples_shape"] == [Bn, algo.dim, H, W] and res["flow_shape"] == [Bn, 2, H, W],
          f"{label}: wrong sample shapes")
    check(res["finite_values_finite"], f"{label}: non-finite samples")
    check_launches(label + " sample", launches, must)
    if native:
        check(launches["flash_attention"] == steps, f"{label}: flash launches {launches}")
    return res, launches


def config_train(label, algo, batch, must):
    """CONFIG_TRAIN_STEPS train steps (augment, loss, backward, clip, Adam)
    in one count window: finite losses and gradients, the launches."""
    cfg = algo.cfg
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, 100.0))
    step = make_train_step(algo.loss_fn, with_grad_stats=True)
    algo.module.train()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_counts()
    losses, grads_finite = [], True
    t = time.perf_counter()
    for _ in range(CONFIG_TRAIN_STEPS):
        m = step(state, batch, gen)
        losses.append(float(m["train/loss"]))
        grads_finite &= all(np.isfinite(float(v)) for k, v in m.items() if "grad_norm" in k)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t) / CONFIG_TRAIN_STEPS
    launches = {k.name: k.launches for k in kernels.KERNELS}
    algo.module.eval()
    phase("config_train_steps", config=label, B=batch[0].shape[0], steps=CONFIG_TRAIN_STEPS,
          losses=losses, grads_finite=grads_finite, ms_per_step_first_two=1e3 * sec,
          launches=launches)
    check(all(np.isfinite(losses)) and grads_finite, f"{label}: non-finite loss or gradients")
    check_launches(label + " train", launches, must)
    return launches


def flow_diffuser_configs_phase():
    """Every other configuration of flow_diffuser.yaml, and the AE chain
    (FlowPred trained for a few steps at b16, its checkpoint, the latent
    joint model loading it through ``ae``): for each, a train step with
    kernels against plain (config_step_vs_plain), the model's forward with
    kernels against plain, a sampler run, CONFIG_TRAIN_STEPS train steps;
    then the flow target at native 448x1024 (DDIM-50 b2, row 6).  Returns
    the launches of all its count windows."""
    totals = {k.name: 0 for k in kernels.KERNELS}

    def add(launches):
        for k, n in launches.items():
            totals[k] += n

    batch = train_batch()
    _, data = build_flagship(SEED, "cuda")
    items = [data[i] for i in range(CONFIG_B)]
    root = Path(tempfile.mkdtemp(prefix="ofd_ae_chain_"))
    try:
        # the AE chain: FlowPred through the training entry point
        t = time.perf_counter()
        kernels.reset_counts()
        exp = train_entry.build(FLOWPRED_STEPS, algorithm="flow_pred", out=str(root),
                                batch=TRAIN_B, log_every=1)
        exp.train()
        launches = {k.name: k.launches for k in kernels.KERNELS}
        add(launches)
        phase("config_flow_pred_run", steps=exp.state.step, checkpoints=exp.ckpt.steps(),
              loss=exp.last_train.get("train/loss"), val_loss=exp.last_val.get("val/loss"),
              seconds=time.perf_counter() - t, launches=launches)
        check(exp.ckpt.steps() == [FLOWPRED_STEPS]
              and np.isfinite(exp.last_train["train/loss"]), "FlowPred run: no checkpoint")
        check_launches("flow_pred run", launches,
                       set(FWD_KERNELS) | set(BWD_KERNELS) | {"splat_fwd", "splat_bwd"})
        trained_ae = {k: v.detach().clone() for k, v in exp.state.module.ae.state_dict().items()}
        del exp
        fp = FlowPred(FLOW_PRED, device="cuda", generator=torch.Generator().manual_seed(SEED))
        config_step_vs_plain(fp, "flow_pred", batch)
        img, _, flw = batch
        config_forward_vs_plain("flow_pred", lambda: fp.module(img[:CONFIG_B], flw[:CONFIG_B]),
                                TOL_RECON)
        del fp

        for label, fields in CONFIGS:
            if fields.get("latent"):
                fields = dict(fields, ae=str(root))
            algo = config_algo(fields)
            if algo.latent:
                same = all(torch.equal(v, trained_ae[k]) for k, v in algo.ae.state_dict().items())
                phase("config_latent_ae_loaded", bit_for_bit=same, ae=str(root))
                check(same, "the latent model's Autoencoder differs from the FlowPred run's")
            config_step_vs_plain(algo, label, batch)
            n = FLOWNOISE_B if algo.cfg.noiser == "flow" else CONFIG_B
            _, cond, _ = algo.preprocess(to_batch(items[:n], algo.device))
            config_forward_vs_plain(label, model_flow(algo, cond))
            _, launches = config_sample(label, algo, items[:n], on_path(algo, "sample"))
            add(launches)
            add(config_train(label, algo, batch, on_path(algo, "train")))
            del algo, cond
    finally:
        shutil.rmtree(root, ignore_errors=True)

    algo = config_algo(dict(target="flow"))
    native = batch_items(SEED, NATIVE_FLOW_B, NATIVE.height, NATIVE.width)
    _, c, _ = algo.preprocess(to_batch(native, algo.device))
    with torch.no_grad():                           # a warm-up UNet eval at this shape
        algo.model_fn(torch.randn((NATIVE_FLOW_B, 2) + tuple(c.shape[2:]), device="cuda"), c,
                      torch.full((NATIVE_FLOW_B,), 999, dtype=torch.long, device="cuda"))
    del c
    must = on_path(algo, "sample") | {"flash_attention"}
    _, launches = config_sample("flow_native", algo, native, must, native=True)
    add(launches)
    phase("launch_counts_configs", launches=totals)
    return totals


# FlowLearner at the bench's shape (bench.py's flow_learner rows: 128x128
# b16 at the reference's ten pyramid levels, f32 and bf16), weights from the
# seed with the output conv not zeroed, on the train rows' standard-normal
# batch.  A step splats the image at all 832 (level, offset) pairs and the
# target at as many (no backward), and takes the splat backward at each pair
LEARNER_PRECISIONS = ("float32", "bf16")
LEARNER_PAIRS = sum(L * L for L in pyr.DEFAULT_LEVELS)
LEARNER_EXPECTED = {"linear_attention_ctx": 8, "linear_attention_out": 8,
                    "linear_attention_bwd_q": 6, "linear_attention_bwd_kv1": 6,
                    "linear_attention_bwd_kv2": 6, "splat_fwd": 2 * LEARNER_PAIRS,
                    "splat_bwd": LEARNER_PAIRS}
LEARNER_WARMUP, LEARNER_TIMED = 1, 3
# the learner step with every kernel vs every plain version: the loss pins
# from chip_train_spread.py --learner over seeds 0-4 on an H100 (largest
# 9.13e-5 f32, 9.04e-4 bf16), taken before this check ran with them.  The
# gradient is not pinned: it moves by 0.86-14x its norm there (0.35-5.4x at
# parity's flow_max 2, LEARNER_FLOW_MAX_SMALL), far wider than C6's 0.338;
# learner_gradient_sensitivity measures what a one-ulp nudge of the input
# does to it on the kernels alone.  The step relies on the checks on its own
# inputs instead
TOL_LEARNER = {"float32": (5e-4, None), "bf16": (2e-3, None)}
LEARNER_FLOW_MAX_SMALL = 2.0
# the parity harness on the card: 10 steps of the joint and learner stages
# at 32x32 (training/parity.py's settings), the initial metrics over JAX's 2
# validation batches, the final ones over 1
PARITY_SMOKE_STEPS = 10
# the f32 learner's timed step, kept for the profiler phase
LEARNER_PROFILE = {}


def grad_diff(g_k, g_p):
    """(per-leaf relative difference, worst leaf, global relative norm) of
    two gradient dicts."""
    rel = {k: float((g_k[k] - g_p[k]).norm()) / float(g_p[k].norm())
           for k in g_p if float(g_p[k].norm()) > 0}
    total = float(torch.sqrt(sum((g_k[k] - g_p[k]).square().sum() for k in g_p))
                  / torch.sqrt(sum(g.square().sum() for g in g_p.values())))
    return rel, max(rel, key=rel.get), total


def learner_algo(precision, flow_max=FLOW_LEARNER.flow_max):
    """FlowLearner at the bench's shape, weights from SEED, output conv not
    zeroed."""
    cfg = dataclasses.replace(FLOW_LEARNER, precision=precision, zero_init=False,
                              flow_max=flow_max)
    return FlowLearner(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))


def learner_step_vs_plain(precision, batch, tol=None, capture=True,
                          flow_max=FLOW_LEARNER.flow_max):
    """One FlowLearner train step (augment, UNet, the pyramid, backward)
    with every kernel against the same step with every plain version: the
    loss and the global relative gradient norm within TOL_LEARNER (at
    the gradient's None pin is not checked); with
    ``capture`` the step's own inputs checked (check_captured, the splats
    untimed: rows 1-5, the splat forward at every one of its 1664 calls and
    the backward at its 832 bit for bit), over all 832 (level, offset)
    pairs.  Returns (loss_rel, grad_global_rel)."""
    algo = learner_algo(precision, flow_max)
    algo.module.train()
    with captured_step() if capture else contextlib.nullcontext() as cap:
        loss_k, g_k = step_grads(algo, batch, 11)
    pairs = None
    if capture:
        launched = cap["launched"]
        pairs = check_captured(cap, f"learner_{precision}_128x128_b{batch[0].shape[0]}",
                               timed=False)
        del cap
        check(launched == (LEARNER_EXPECTED["splat_fwd"], LEARNER_EXPECTED["splat_bwd"])
              and pairs == (LEARNER_PAIRS, LEARNER_PAIRS),
              f"learner step: splat launches {launched}, distinct pairs {pairs}")
    with plain_versions(attention="passes", splat=True):
        loss_p, g_p = step_grads(algo, batch, 11)
    rel, worst, total = grad_diff(g_k, g_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    tol_loss, tol_grad = tol or TOL_LEARNER[precision]
    phase("learner_train_step_vs_plain", precision=precision, B=batch[0].shape[0],
          H=batch[0].shape[2], W=batch[0].shape[3], flow_max=flow_max,
          levels=list(algo.levels),
          loss=loss_k, plain_loss=loss_p, loss_rel=loss_rel, grad_leaves=len(rel),
          grad_global_rel=total, grad_worst_leaf=worst, grad_worst_rel=rel[worst],
          pins=[tol_loss, tol_grad], distinct_pairs_checked=pairs)
    check(np.isfinite(loss_k) and all(torch.isfinite(g).all() for g in g_k.values()),
          f"learner step ({precision}): non-finite loss or gradient")
    check(loss_rel <= tol_loss and (tol_grad is None or total <= tol_grad),
          f"learner step ({precision}, flow_max {flow_max}) with kernels disagrees with the "
          f"plain versions: loss {loss_rel}, gradients {total}")
    del algo, g_k, g_p
    return loss_rel, total


def learner_gradient_sensitivity(precision, batch):
    """The kernel step's gradient against itself: once more on the same
    batch (the splat's sums are the same bits on every run; cuDNN's backward
    need not be) and on the batch with the first frame nudged by one float32
    ulp, at flow_max 20 and 2: the global relative gradient difference each
    gives, the yardstick for the kernels-vs-plain spread.  Finite values
    only are checked."""
    row = {}
    for flow_max in (FLOW_LEARNER.flow_max, LEARNER_FLOW_MAX_SMALL):
        algo = learner_algo(precision, flow_max)
        algo.module.train()
        nudged = (torch.nextafter(batch[0], torch.full_like(batch[0], float("inf"))),) + batch[1:]
        loss_a, g_a = step_grads(algo, batch, 11)
        loss_b, g_b = step_grads(algo, batch, 11)
        loss_c, g_c = step_grads(algo, nudged, 11)
        row[f"flow_max{flow_max:g}"] = dict(
            repeat_loss_rel=abs(loss_b - loss_a) / abs(loss_a),
            repeat_grad_global_rel=grad_diff(g_b, g_a)[2],
            nudged_loss_rel=abs(loss_c - loss_a) / abs(loss_a),
            nudged_grad_global_rel=grad_diff(g_c, g_a)[2])
        check(all(np.isfinite(v) for v in row[f"flow_max{flow_max:g}"].values()),
              f"learner gradient sensitivity ({precision}): {row}")
        del algo, g_a, g_b, g_c
    phase("learner_gradient_sensitivity", precision=precision, B=batch[0].shape[0],
          H=batch[0].shape[2], W=batch[0].shape[3], **row)
    return row


def learner_train_steps(precision, batch):
    """One count window of LEARNER_WARMUP + LEARNER_TIMED steps (augment,
    loss, backward, clip, Adam): every kernel's launches exactly
    LEARNER_EXPECTED a step (none of the others), and the train samples/s
    of the timed steps (host clock, synchronised).  Returns the launches."""
    algo = learner_algo(precision)
    cfg = algo.cfg
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, 100.0))
    step = make_train_step(algo.loss_fn)
    algo.module.train()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    for _ in range(LEARNER_WARMUP):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LEARNER_TIMED):
        metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / LEARNER_TIMED
    launches = {k.name: k.launches for k in kernels.KERNELS}
    n = LEARNER_WARMUP + LEARNER_TIMED
    expected = {k.name: n * LEARNER_EXPECTED.get(k.name, 0) for k in kernels.KERNELS}
    loss = float(metrics["train/loss"])
    phase("learner_train_steps", precision=precision, B=batch[0].shape[0],
          H=batch[0].shape[2], W=batch[0].shape[3], steps=n, timed=LEARNER_TIMED,
          ms_per_step=1e3 * sec, train_samples_per_s=batch[0].shape[0] / sec, loss=loss,
          launches=launches, expected_launches=expected,
          launches_per_step={k: v / n for k, v in launches.items()},
          peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(np.isfinite(loss), f"learner steps ({precision}): non-finite loss")
    check(launches == expected, f"learner steps ({precision}): launches {launches}, "
          f"expected {expected}")
    if precision == "float32":
        LEARNER_PROFILE.update(step=step, state=state, batch=batch, gen=gen, wall_ms=1e3 * sec)
    return launches


def learner_phase():
    """FlowLearner at 128x128 b16, f32 and bf16: the step with every kernel
    against the all-plain step with the checks on its own inputs, the
    gradient's sensitivity to a one-ulp nudge, then a count window of train
    steps.  Returns the launches of the windows."""
    batch = train_batch()
    totals = {k.name: 0 for k in kernels.KERNELS}
    for precision in LEARNER_PRECISIONS:
        learner_step_vs_plain(precision, batch)
        learner_gradient_sensitivity(precision, batch)
        for k, n in learner_train_steps(precision, batch).items():
            totals[k] += n
    phase("launch_counts_learner", launches=totals)
    return totals


def parity_smoke_phase():
    """The parity harness on the card (training/parity.py's run_parity):
    PARITY_SMOKE_STEPS steps each of the joint and learner stages at 32x32
    b16, f32, one count window.  Their initial metrics, which depend on the
    data alone, must pass JAX's bars (1e-3 relative); their final metrics
    must be finite; every kernel of both paths must launch.  Returns the
    launches."""
    root = Path(tempfile.mkdtemp(prefix="ofd_parity_"))
    log = io.StringIO()
    try:
        torch.cuda.synchronize()
        kernels.reset_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(log):
            res = parity.run_parity(out_dir=str(root), diffuser_steps=PARITY_SMOKE_STEPS,
                                    learner_steps=PARITY_SMOKE_STEPS, stages=("joint", "learner"),
                                    device="cuda", val_batches=1, init_batches=2,
                                    log_every=PARITY_SMOKE_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        launches = {k.name: k.launches for k in kernels.KERNELS}
        saved = json.loads((root / "parity.json").read_text())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    keys = ("val/epe", "val/mse", "val/loss", "zero_flow_epe", "moving_frac_gt")
    stages = {key: dict(init={k: res[key]["init"][k] for k in keys},
                        final={k: res[key]["final"][k] for k in keys},
                        steps_per_sec=res[key]["perf"]["steps_per_sec"],
                        init_bars={k: v for k, v in res["bars"][key].items()
                                   if k.startswith("init")})
              for key in ("flow_diffuser", "flow_learner")}
    phase("parity_smoke", steps=PARITY_SMOKE_STEPS, seconds=sec, launches=launches,
          saved_stages=sorted(k for k in saved if k.startswith("flow_")), stages=stages)
    for key, st in stages.items():
        check(all(np.isfinite(v) for v in st["final"].values()),
              f"parity smoke {key}: non-finite final metrics {st['final']}")
        check(all(b["ok"] for b in st["init_bars"].values()),
              f"parity smoke {key}: initial metrics off JAX's {st['init_bars']}")
    check_launches("parity smoke", launches, set(LEARNER_EXPECTED))
    return launches


# MatrixFlow and the animation family on the UNet kernels at full width (UNet
# 64): MatrixFlow at its yaml's shape (128x128, b16 as experiment/
# matrix_flow.yaml's batch, radius 17, clip 100), FrameGenerator at the JAX
# bench.py row video256_train_samples_per_sec (256x256 b8, a standard-normal
# (8, 256, 256, 8) stack from numpy seed 0, lr 1e-5, weight decay 1e-6, clip
# 100; 2 warm-ups, 4 timed steps) and at its yaml's 64 (b8), FlowCompleter at
# 64x64 b16 (its float32 UNet under bf16).  Every window must launch rows 1-2
# (and rows 3-5 in a train step), and no other kernel but the splat forward
# of MatrixFlow's flow_in='first' debug warp in its own window
FAMILY_MODELS = ("matrix_flow", "frame_generator", "flow_completer")
MF_B, MF_SIZE = 16, 128
FG_BENCH_B, FG_BENCH_SIZE, FG_WARMUP, FG_TIMED = 8, 256, 2, 4
FG_YAML_B, FG_DDIM = 8, 50
FC_B = 16
FAMILY_STEPS = 2
# a train step with every kernel vs every plain version (loss, gradient
# global relative norm): the flagship's bf16 pins (TOL_TRAIN), the f32 ones
# for FlowCompleter's float32 UNet.  chip_train_spread.py --families over
# seeds 0-2 on an H100: the largest loss and gradient differences
# MatrixFlow 4.7e-5 and 1.1e-3, FrameGenerator 4.4e-5 and 7.4e-4,
# FlowCompleter 2.1e-5 and 3.2e-5, taken before this check ran with them
TOL_FAMILY = {"matrix_flow": TOL_TRAIN["bf16"], "frame_generator": TOL_TRAIN["bf16"],
              "flow_completer": TOL_TRAIN["float32"]}
# the families' parity harness on the card: 20 steps of each stage at its
# 32x32 settings, the initial metrics over JAX's batches, the final ones
# over 1
FAMILY_PARITY_STEPS = 20


def family_algo(model, seed=SEED, **fields):
    """One of the three models at the phase's shape, weights from ``seed``."""
    from opticalflowdiffusion_tpu_torch.algorithms.animation import FlowCompleter, FrameGenerator
    from opticalflowdiffusion_tpu_torch.algorithms.matrix_flow import MatrixFlow
    from opticalflowdiffusion_tpu_torch.config import (FLOW_COMPLETER, FRAME_GENERATOR,
                                                       MATRIX_FLOW_ALGO)
    gen = torch.Generator().manual_seed(seed)
    if model == "matrix_flow":
        return MatrixFlow(dataclasses.replace(MATRIX_FLOW_ALGO, **fields), device="cuda",
                          generator=gen)
    if model == "frame_generator":
        fields = {"image_size": FG_BENCH_SIZE, "lr": 1e-5, "weight_decay": 1e-6, **fields}
        return FrameGenerator(dataclasses.replace(FRAME_GENERATOR, **fields), device="cuda",
                              generator=gen)
    return FlowCompleter(dataclasses.replace(FLOW_COMPLETER, **fields), device="cuda",
                         generator=gen)


def video_items(size, n, split="training", val_length=5, seed=0):
    """``n`` items of the constant-velocity video dataset at ``size``, as
    one batch on the card."""
    from opticalflowdiffusion_tpu_torch.config import ARTIFICIAL_VIDEO
    from opticalflowdiffusion_tpu_torch.data.artificial_video import ArtificialVideoDataset

    data = ArtificialVideoDataset(dataclasses.replace(
        ARTIFICIAL_VIDEO, image_size=size, size=n, val_length=val_length, max_motion=2,
        seed=seed), split=split)
    return to_device(tuple(np.stack(f) for f in zip(*(data[i] for i in range(n)))), "cuda")


def family_batch(model, seed=0):
    """The phase's batch of ``model``: MatrixFlow the train rows'
    standard-normal pair and flow at 128x128 b16, FrameGenerator the bench
    row's standard-normal stack at 256x256 b8, FlowCompleter video items at
    64x64 b16."""
    if model == "matrix_flow":
        return train_batch(seed, MF_B, MF_SIZE, MF_SIZE)
    if model == "frame_generator":
        rng = np.random.default_rng(seed)
        stack = rng.standard_normal((FG_BENCH_B, FG_BENCH_SIZE, FG_BENCH_SIZE, 8))
        return to_device((stack.astype(np.float32),), "cuda")
    return video_items(64, FC_B, seed=seed)


def family_step_vs_plain(model, fields=None, batch=None, tol=None, capture=True, seed=SEED):
    """One train step of ``model`` with every kernel against the same step
    with every plain version (the same weights, batch and draws; the
    flagship's loss-pin method), with rows 1-5 on that step's own block
    inputs (check_captured) when ``capture``.  Returns (loss_rel,
    grad_global_rel)."""
    algo = family_algo(model, seed, **(fields or {}))
    batch = family_batch(model, seed) if batch is None else batch
    x = batch[0]
    label = f"{model}_{x.shape[-2]}x{x.shape[-1]}_b{x.shape[0]}"
    algo.module.train()
    with captured_step() if capture else contextlib.nullcontext() as cap:
        loss_k, g_k = step_grads(algo, batch, 11)
    if capture:
        check(cap["launched"] == (0, 0), f"{label}: splat launches {cap['launched']}")
        check_captured(cap, label)
        del cap
    with plain_versions(attention="passes", splat=True):
        loss_p, g_p = step_grads(algo, batch, 11)
    rel, worst, total = grad_diff(g_k, g_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    tol_loss, tol_grad = tol or TOL_FAMILY[model]
    phase("family_train_step_vs_plain", model=model, at=label, fields=fields or {},
          loss=loss_k, plain_loss=loss_p, loss_rel=loss_rel, grad_leaves=len(rel),
          grad_global_rel=total, grad_worst_leaf=worst, grad_worst_rel=rel[worst],
          pins=[tol_loss, tol_grad])
    check(np.isfinite(loss_k) and all(torch.isfinite(g).all() for g in g_k.values()),
          f"{label}: non-finite loss or gradient")
    check(loss_rel <= tol_loss and total <= tol_grad,
          f"{label}: train step with kernels disagrees with the plain versions: "
          f"loss {loss_rel}, gradients {total}")
    del algo, g_k, g_p
    return loss_rel, total


def family_train_steps(label, algo, batch, warmup=1, timed=FAMILY_STEPS):
    """One count window of ``warmup`` + ``timed`` train steps (loss,
    backward, clip at 100, Adam): finite losses, rows 1-5 launched and no
    other kernel, the samples/s of the timed steps (host clock,
    synchronised) and the window's peak memory.  Returns (row, launches)."""
    cfg = algo.cfg
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, 100.0))
    step = make_train_step(algo.loss_fn)
    algo.module.train()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    losses = [float(step(state, batch, gen)["train/loss"]) for _ in range(warmup)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed):
        m = step(state, batch, gen)
    losses.append(float(m["train/loss"]))
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t) / timed
    launches = {k.name: k.launches for k in kernels.KERNELS}
    Bn = batch[0].shape[0]
    row = dict(at=label, B=Bn, H=batch[0].shape[-2], W=batch[0].shape[-1], warmup=warmup,
               timed=timed, ms_per_step=1e3 * sec, train_samples_per_s=Bn / sec,
               losses=losses, peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    algo.module.eval()
    check(all(np.isfinite(losses)), f"{label}: non-finite train loss {losses}")
    check_launches(label + " train", launches, set(FWD_KERNELS) | set(BWD_KERNELS))
    return row, launches


def family_window(label, fn, must=FWD_KERNELS):
    """``fn()`` in a count window of its own (under no_grad): returns
    (its result, seconds, launches); ``must`` launched, no other kernel."""
    torch.cuda.synchronize()
    kernels.reset_counts()
    t = time.perf_counter()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches = {k.name: k.launches for k in kernels.KERNELS}
    check_launches(label, launches, set(must))
    return out, sec, launches


def finite_metrics(label, metrics):
    vals = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in vals.values()), f"{label}: non-finite metrics {vals}")
    return vals


def matrix_flow_paths(totals):
    """MatrixFlow at 128x128 b16: the default goal (gt_flow_pred) checked
    against its plain step, a warm-up and 2 train steps and a val_step;
    filter_pred at radius 17 (289 output channels, a 17x17 unfold) for a
    warm-up and a step and a val_step with the peak memory; gt_filter_pred
    for a warm-up and a step; the flow_in='first' debug warp through the
    splat kernel, bit for bit."""
    family_step_vs_plain("matrix_flow")
    batch = family_batch("matrix_flow")
    for goal in ("gt_flow_pred", "filter_pred", "gt_filter_pred"):
        algo = family_algo("matrix_flow", goal=goal)
        steps = (1, FAMILY_STEPS) if goal == "gt_flow_pred" else (1, 1)
        row, launches = family_train_steps(f"matrix_flow_{goal}", algo, batch, *steps)
        for k, n in launches.items():
            totals[k] += n
        val = {}
        if goal != "gt_filter_pred":
            torch.cuda.reset_peak_memory_stats()
            (metrics, _), sec, launches = family_window(
                f"matrix_flow_{goal} val_step", lambda: algo.val_step(batch))
            for k, n in launches.items():
                totals[k] += n
            val = dict(metrics=finite_metrics(f"matrix_flow {goal} val_step", metrics),
                       seconds=sec, peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        phase("matrix_flow_goal", goal=goal, radius=algo.radius,
              out_channels=int(algo.module.final_conv.weight.shape[0]), train=row, val=val)
        del algo
    algo = family_algo("matrix_flow")
    img = batch[0]
    flow = 4 * torch.randn(img.shape[0], 2, MF_SIZE, MF_SIZE,
                           generator=torch.Generator(device="cuda").manual_seed(SEED),
                           device="cuda")
    with captured_splats() as calls:
        (warped, _), _, launches = family_window(
            "matrix_flow flow_in=first", lambda: algo.apply_filter(flow, img, flow_in="first"),
            must={"splat_fwd"})
    for k, n in launches.items():
        totals[k] += n
    check(bool(torch.isfinite(warped).all()), "matrix_flow flow_in=first: non-finite warp")
    splat_on_step_inputs(calls, "matrix_flow_flow_in_first_128x128_b16", launches["splat_fwd"])
    del algo, calls


def frame_generator_paths(totals):
    """FrameGenerator at the bench row's 256x256 b8 (the step against its
    plain step with rows 1-5 on its own inputs; 2 warm-ups and 4 timed
    steps: video256_train_samples_per_sec), then at its yaml's 64 b8: the
    forward against its plain version, the 1000-step ancestral loop
    (denoise steps/s) and a DDIM-50 val_step rolling out over 5
    transitions of the video dataset."""
    family_step_vs_plain("frame_generator")
    algo = family_algo("frame_generator")
    row, launches = family_train_steps("frame_generator_256x256_b8", algo,
                                       family_batch("frame_generator"), FG_WARMUP, FG_TIMED)
    for k, n in launches.items():
        totals[k] += n
    phase("video256_train_samples_per_sec", value=row["train_samples_per_s"], **row)
    del algo
    yaml = family_algo("frame_generator", image_size=64, lr=7e-5, weight_decay=2e-4)
    (x,) = video_items(64, FG_YAML_B, "validation")
    cond = x[:, 0, 3:]
    H, W = cond.shape[-2:]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    noisy = torch.randn(FG_YAML_B, 3, H, W, generator=g, device="cuda")
    tt = torch.full((FG_YAML_B,), 500, dtype=torch.long, device="cuda")
    config_forward_vs_plain("frame_generator_64x64_b8",
                            lambda: yaml.model_fn(noisy, 2 * cond - 1, tt))
    samples, sec, launches = family_window(
        "frame_generator ancestral", lambda: yaml.sample(cond, torch.Generator(
            device="cuda").manual_seed(SEED)))
    for k, n in launches.items():
        totals[k] += n
    T = yaml.sched.num_timesteps
    phase("frame_generator_sample", sampler="ancestral", B=FG_YAML_B, H=H, W=W,
          denoise_steps=T, seconds=sec, denoise_steps_per_s=T / sec,
          frames_per_s=FG_YAML_B / sec, launches=launches,
          finite=bool(torch.isfinite(samples).all()))
    check(samples.shape == (FG_YAML_B, 3, H, W) and bool(torch.isfinite(samples).all()),
          "frame_generator ancestral: wrong or non-finite samples")
    ddim = family_algo("frame_generator", image_size=64, sampling_timesteps=FG_DDIM)
    ddim.module.load_state_dict(yaml.module.state_dict())
    (metrics, arts), sec, launches = family_window(
        "frame_generator rollout", lambda: ddim.val_step(
            (x,), torch.Generator(device="cuda").manual_seed(SEED)))
    for k, n in launches.items():
        totals[k] += n
    ro = arts["rollout"]
    phase("frame_generator_rollout", sampler=f"ddim{FG_DDIM}", B=FG_YAML_B, H=H, W=W,
          transitions=int(x.shape[1]), seconds=sec,
          denoise_steps_per_s=FG_DDIM * (1 + x.shape[1]) / sec,
          metrics=finite_metrics("frame_generator val_step", metrics),
          rollout_shape=list(ro.shape), launches=launches)
    check(list(ro.shape) == [FG_YAML_B, 5, 3, H, W] and bool(torch.isfinite(ro).all()),
          "frame_generator rollout: wrong or non-finite frames")
    del yaml, ddim, arts


def flow_completer_paths(totals):
    """FlowCompleter at 64x64 b16 under bf16: its UNet float32, the step
    against its plain step with rows 1-5 on its own inputs, a warm-up and 2
    train steps, and a val_step."""
    algo = family_algo("flow_completer")
    check(algo.module.net.dtype == torch.float32 and algo.cfg.precision == "bf16",
          "flow_completer: the UNet must compute in float32 under bf16")
    family_step_vs_plain("flow_completer")
    batch = family_batch("flow_completer")
    row, launches = family_train_steps("flow_completer_64x64_b16", algo, batch)
    for k, n in launches.items():
        totals[k] += n
    (metrics, arts), sec, launches = family_window(
        "flow_completer val_step", lambda: algo.val_step(
            batch, torch.Generator(device="cuda").manual_seed(SEED)))
    for k, n in launches.items():
        totals[k] += n
    phase("flow_completer_steps", unet_dtype=str(algo.module.net.dtype).split(".")[1],
          out_dtype=str(arts["out"].dtype).split(".")[1], train=row,
          val=finite_metrics("flow_completer val_step", metrics))
    check(arts["out"].dtype == torch.float32, "flow_completer: the output is not float32")
    del algo


def family_entry_points(totals, root):
    """train.py through both experiments (MatrixFlow at 128x128 b16 and
    FrameGenerator at 64 b8 on the video dataset: 2 steps, a validation, a
    checkpoint, then --resume to 3), then sample.py --algorithm
    frame_generator --ckpt on the animation run's checkpoint (DDIM-10),
    one count window."""
    torch.cuda.synchronize()
    kernels.reset_counts()
    t = time.perf_counter()
    runs = {}
    for name, kw in (("matrix_flow", dict(algorithm="matrix_flow")),
                     ("animation", dict(algorithm="frame_generator", image_size=64, batch=8,
                                        dataset_size=64, sampling_timesteps=10))):
        out = str(root / name)
        first = train_entry.run(2, out=out, log_every=1, **kw)
        second = train_entry.run(3, resume=True, out=out, log_every=1, **kw)
        runs[name] = dict(experiment=first["experiment"], steps=[first["step"], second["step"]],
                          checkpoints=second["checkpoints"], start_step=second["start_step"],
                          loss=second["train"]["train/loss"],
                          val={k: v for k, v in first["val"].items() if k.startswith("val/")},
                          images=first["images"], samples_per_s=first["samples_per_s"])
        check(first["step"] == 2 and second["start_step"] == 2 and second["step"] == 3
              and second["checkpoints"] == [2, 3] and np.isfinite(second["train"]["train/loss"])
              and all(np.isfinite(v) for v in runs[name]["val"].values()) and runs[name]["val"],
              f"train.py {name}: {runs[name]}")
    check("val/rollout" in runs["animation"]["images"], "train.py animation: no rollout strip")
    res = sample_entry.run_frame_generator(FG_YAML_B, SEED, "cuda", sampling_timesteps=10,
                                           image_size=64, ckpt=str(root / "animation"))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for k, n in launches.items():
        totals[k] += n
    phase("family_entry_points", seconds=time.perf_counter() - t, runs=runs, sample=res,
          launches=launches)
    check(res["finite"] and res["ckpt"].endswith("checkpoints/3")
          and res["rollout_shape"][:3] == [FG_YAML_B, 5, 3],
          f"sample.py --algorithm frame_generator --ckpt: {res}")
    check_launches("family entry points", launches, set(FWD_KERNELS) | set(BWD_KERNELS))


def family_parity_smoke(totals, root):
    """training/parity_families.py on the card: FAMILY_PARITY_STEPS steps of
    each stage at its 32x32 settings, one count window; the data-only
    metrics within 1e-3 of JAX's recorded ones, every final metric finite."""
    from opticalflowdiffusion_tpu_torch.training import parity_families as pfam

    log = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(log):
        res = pfam.run_families(out_dir=str(root / "parity_families"),
                                steps=FAMILY_PARITY_STEPS, device="cuda", val_batches=1,
                                log_every=FAMILY_PARITY_STEPS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for k, n in launches.items():
        totals[k] += n
    stages = {}
    for key in pfam.KEYS.values():
        data_only = {k: v for k, v in res["bars"][key].items()
                     if isinstance(v["bar"], str)}
        final = {k: v for k, v in res[key]["final"].items() if not isinstance(v, list)}
        stages[key] = dict(data_only=data_only, final=final,
                           steps_per_sec=res[key]["perf"]["steps_per_sec"])
        check(data_only and all(b["ok"] for b in data_only.values()),
              f"family parity smoke {key}: data-only metrics off JAX's {data_only}")
        check(all(np.isfinite(v) for v in final.values()),
              f"family parity smoke {key}: non-finite final metrics {final}")
    phase("family_parity_smoke", steps=FAMILY_PARITY_STEPS, seconds=sec, launches=launches,
          stages=stages)
    check_launches("family parity smoke", launches, set(FWD_KERNELS) | set(BWD_KERNELS))


def matrix_flow_animation_phase():
    """MatrixFlow, FrameGenerator and FlowCompleter on the card (the
    functions above), each window's launches checked; returns the
    launches of all windows."""
    totals = {k.name: 0 for k in kernels.KERNELS}
    root = Path(tempfile.mkdtemp(prefix="ofd_families_"))
    t = time.perf_counter()
    try:
        matrix_flow_paths(totals)
        frame_generator_paths(totals)
        flow_completer_paths(totals)
        family_entry_points(totals, root)
        family_parity_smoke(totals, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase("launch_counts_matrix_flow_animation", seconds=time.perf_counter() - t,
          launches=totals)
    check_launches("matrix_flow_animation", totals,
                   set(FWD_KERNELS) | set(BWD_KERNELS) | {"splat_fwd"})
    return totals


# the real-data path (the JAX package's debug/dress_rehearsal.py): native
# fixture trees written by the port (data/fixtures.py), read by its readers
# at the rehearsal's native sizes, b2, through train.py (remat, the
# rehearsal's flow_max 32) and sample.py: (dataset, fixture writer and its
# arguments, image size W,H); KITTI's tree has JAX's REAL_KITTI_PAIRS
# training pairs (and half as many for validation and test)
REAL_KITTI_PAIRS = 6
REAL_DATA = (
    ("sintel", fixtures.make_sintel_fixture, dict(scenes=2, frames=13), "1024,448"),
    ("flying_chairs", fixtures.make_chairs_fixture, dict(n=8), "512,384"),
    ("kitti_single", fixtures.make_kitti_fixture, dict(n=REAL_KITTI_PAIRS), "1248,376"),
)
REAL_B = 2
REAL_STEPS, REAL_RESUMED = 4, 6
REAL_DDIM = 2
REAL_FLOW_MAX = 32.0
REAL_LOADER_WORKERS = 4          # the rehearsal's loader measurement
REAL_LOADER_BATCHES = 6
REAL_TIMED = 3
REAL_MUST = set(FWD_KERNELS) | set(BWD_KERNELS) | {"flash_attention", "splat_fwd", "splat_bwd"}
REHEARSAL = Path(__file__).resolve().parent / "debug" / "rehearsal_r05.jsonl"


@contextlib.contextmanager
def captured_flash():
    """The (q, k, v) of every flash kernel call inside the window, detached
    copies, in call order."""
    calls, original = [], fa.flash_attention

    def capture(q, k, v):
        calls.append(tuple(t.detach().clone() for t in (q, k, v)))
        return original(q, k, v)

    fa.flash_attention = capture
    try:
        yield calls
    finally:
        fa.flash_attention = original


def flash_on_activations(calls, label):
    """Row 6 against flash_plain on the q, k, v that reached it in a train
    step, at the step's own N (a tail N no multiple of the tile goes through
    the padded copy, ``_padded``): within TOL_FLASH of the output's scale
    (its largest value, at least 1; TOL_FLASH is absolute on the unit-scale
    random inputs of flash_phase, and a step's outputs reach a few units)."""
    rel, shapes = [], []
    with torch.no_grad():
        for q, k, v in calls:
            want = fa.flash_plain(q, k, v)
            scale = max(float(want.float().abs().max()), 1.0)
            rel.append(err(fa.flash_attention(q, k, v), want)[0] / scale)
            shapes.append(list(q.shape))
    torch.cuda.synchronize()
    tol = TOL_FLASH[calls[0][0].dtype]
    phase("kernel_vs_plain", kernel="flash_attention", at=label, calls=len(rel),
          shapes=shapes[:1], max_rel=max(rel), pin=tol)
    check(max(rel) <= tol, f"flash kernel disagrees with flash_plain on the {label} inputs: "
          f"{rel}")


def loader_items_per_s(name, data_cfg, n_batches=REAL_LOADER_BATCHES):
    """The rehearsal's loader measurement (``dress_rehearsal.py:74-101``):
    a fresh training dataset at the native size, the loader at b2 with 4
    workers, one batch to warm the pool, then items/s over up to
    ``n_batches`` more of the first epoch (host clock).  The port's loader
    keeps 4 items in flight across batches, so the warm batch also starts
    the next; the first epoch's items/s from a cold start, the warm batch
    included, is returned beside it.  Returns (items/s, items timed, cold
    first-epoch items/s, the dataset)."""
    ds = get_dataset(name)(data_cfg, split="training")
    start = time.perf_counter()
    it = iter(DataLoader(ds, REAL_B, True, 0, num_workers=REAL_LOADER_WORKERS))
    first = len(next(it)[0])
    t0, n = time.perf_counter(), 0
    for i, b in enumerate(it):
        n += len(b[0])
        if i + 1 >= n_batches:
            break
    end = time.perf_counter()
    for b in it:
        first += len(b[0])
    cold = (first + n) / (time.perf_counter() - start)
    return (n / (end - t0) if n else None), n, cold, ds


def real_data_phase(smi):
    """The rehearsal's path on the port: for Sintel, FlyingChairs and KITTI,
    native-size fixture trees through the readers, ``train.py`` (4 steps at
    b2 with remat, a DDIM validation with its images, checkpoints, a
    resume to 6), ``--tasks test`` (Sintel's raising as JAX's does) and
    ``sample.py --ckpt``, one count window per dataset in which every
    kernel of the path must launch and no other; the kernels held to their
    plain versions on one train step's own inputs at the dataset's shapes
    (rows 1-5, row 6, the splat forward and backward bit for bit); one line
    per dataset with the loader's items/s beside the train samples/s, the
    KITTI densify's seconds an item, the validation keys (the rehearsal's)
    and the card.  Returns the launches of the windows."""
    rehearsal = {json.loads(x)["dataset"]: json.loads(x)
                 for x in REHEARSAL.read_text().splitlines() if x.strip()}
    want_val = rehearsal["sintel"]["val_metric_keys"]
    totals = {k.name: 0 for k in kernels.KERNELS}
    work = Path(tempfile.mkdtemp(prefix="ofd_real_data_"))
    try:
        for name, make, kw, size in REAL_DATA:
            data_root = work / "data"
            t = time.perf_counter()
            make(data_root, **kw)
            fixture_s = time.perf_counter() - t
            W, H = (int(v) for v in size.split(","))
            data_cfg = train_entry.data_config(name, size, str(data_root))
            densify = None
            if name == "kitti_single":
                probe = get_dataset(name)(data_cfg, split="training")
                t = time.perf_counter()
                probe._densify(probe.records[0][2])
                densify = time.perf_counter() - t
            loader_rate, loader_items, cold_rate, ds = loader_items_per_s(name, data_cfg)
            # the memoised epoch: the same loader's second pass (KITTI's
            # densify is cached after the first)
            again = DataLoader(ds, REAL_B, True, 0, num_workers=REAL_LOADER_WORKERS)
            t, n = time.perf_counter(), 0
            for b in again:
                n += len(b[0])
            second_epoch_rate = n / (time.perf_counter() - t)
            out = work / f"run_{name}"
            common = dict(batch=REAL_B, val_batch=REAL_B, image_size=size, seed=SEED,
                          device="cuda", out=str(out), sampling_timesteps=REAL_DDIM,
                          remat=True, flow_max=REAL_FLOW_MAX, dataset=name,
                          data_root=str(data_root))
            torch.cuda.synchronize()
            kernels.reset_counts()
            first = train_entry.run(REAL_STEPS, check_interval=REAL_STEPS, ckpt_every=2,
                                    log_every=1, **common)
            # the samples/s the loader fed each step (host clock, synchronised
            # at each log; the first step holds the first batch's load and the
            # kernels' first calls)
            per_step = [r["train/steps_per_sec"] * REAL_B for r in
                        (json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines())
                        if "train/steps_per_sec" in r]
            # FlyingChairs' resumed run also traces its first step (--profile-step)
            traced = REAL_STEPS + 1 if name == "flying_chairs" else None
            resumed = train_entry.run(REAL_RESUMED, resume=True, profile_step=traced, **common)
            check(traced is None or (out / "profile" / f"step_{traced}.json").stat().st_size
                  > 0, f"{name}: no profiler trace of step {traced}")
            if name == "sintel":
                try:
                    train_entry.run(REAL_RESUMED, tasks=("test",), **common)
                    test, test_raised = None, None
                except AssertionError as e:          # JAX's reader asserts the split
                    test, test_raised = None, str(e)
                check(test_raised is not None and "training or validation" in test_raised,
                      "sintel: the test task did not raise as JAX's does")
            else:
                test, test_raised = train_entry.run(REAL_RESUMED, tasks=("test",),
                                                    **common)["test"], None
            sampled = sample_entry.run(REAL_B, SEED, "cuda", sampling_timesteps=REAL_DDIM,
                                       height=H, width=W, ckpt=str(out),
                                       flow_max=REAL_FLOW_MAX)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in kernels.KERNELS}
            for k, v in launches.items():
                totals[k] += v
            val_keys = sorted(k for k in resumed["val"] if k.startswith("val/"))
            check(first["step"] == REAL_STEPS and first["checkpoints"] == [2, REAL_STEPS],
                  f"{name}: first run {first['step']} {first['checkpoints']}")
            check(resumed["start_step"] == REAL_STEPS and resumed["step"] == REAL_RESUMED,
                  f"{name}: resumed {resumed['start_step']} -> {resumed['step']}")
            check(val_keys == want_val, f"{name}: validation keys {val_keys}, the rehearsal's "
                  f"{want_val}")
            check(all(np.isfinite(v) for k, v in resumed["val"].items() if k != "time")
                  and np.isfinite(resumed["train"]["train/loss"]),
                  f"{name}: non-finite metrics {resumed['val']}")
            check(len(first["images"]) >= 10 and all((out / "images" / k).is_dir()
                                                       for k in first["images"]),
                  f"{name}: validation images {first['images']}")
            if test is not None:
                check(sorted(k for k in test if k.startswith("test/"))
                      == [k.replace("val/", "test/") for k in want_val]
                      and all(np.isfinite(v) for v in test.values()),
                      f"{name}: test metrics {test}")
            check(sampled["samples_shape"] == [REAL_B, 3, H, W] and sampled["finite_values_finite"]
                  and sampled["ckpt"].endswith(f"checkpoints/{REAL_RESUMED}"),
                  f"{name}: sample.py --ckpt {sampled}")
            check_launches(f"real data {name}", launches, REAL_MUST)
            # the kernels on one train step's own inputs at these shapes
            cfg = dataclasses.replace(FLAGSHIP, zero_init=False, remat=True, image_size=W,
                                      flow_max=REAL_FLOW_MAX)
            algo = FlowDiffuser(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
            batch = to_device(next(iter(DataLoader(ds, REAL_B, True, SEED))), "cuda")
            algo.module.train()
            label = f"{name}_{H}x{W}_b{REAL_B}"
            with captured_step() as cap, captured_flash() as flash_calls:
                loss, _ = step_grads(algo, batch, 11)
            check(np.isfinite(loss), f"{name}: captured step loss {loss}")
            fwd_pairs, bwd_pairs = check_captured(cap, label, timed=False)
            flash_on_activations(flash_calls, "train_activations_" + label)
            n_bottleneck = flash_calls[0][0].shape[1]
            del cap, flash_calls
            # the step alone on that batch, no loader beside it: 1 warm-up and
            # REAL_TIMED steps (augment, loss, backward, clip, Adam), host clock
            state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                           cfg.weight_decay, 100.0))
            step = make_train_step(algo.loss_fn)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            step(state, batch, gen)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(REAL_TIMED):
                step(state, batch, gen)
            torch.cuda.synchronize()
            alone = REAL_TIMED * REAL_B / (time.perf_counter() - t)
            del algo, batch, state, step
            phase("real_data", dataset=name, image_size=size, B=REAL_B, nvidia_smi=smi,
                  fixture_s=fixture_s, fixture=kw,
                  loader_items_per_s=loader_rate, loader_items_timed=loader_items,
                  loader_workers=REAL_LOADER_WORKERS,
                  loader_first_epoch_cold_items_per_s=cold_rate,
                  loader_second_epoch_items_per_s=second_epoch_rate,
                  train_samples_per_s_by_step=per_step,
                  train_samples_per_s_after_first=(float(np.mean(per_step[1:]))
                                                   if len(per_step) > 1 else None),
                  train_step_alone_samples_per_s=alone,
                  train_run_samples_per_s=first["samples_per_s"],
                  resumed_run_samples_per_s=resumed["samples_per_s"],
                  densify_s_per_item=densify, val_metric_keys_equal_rehearsal=True,
                  val=resumed["val"], test=test, test_raised=test_raised,
                  sample=dict(shape=sampled["samples_shape"], seconds=sampled["seconds"],
                              nan_share=sampled["nan_share"]),
                  images=len(first["images"]), launches=launches,
                  flash_n=n_bottleneck, captured_splat_pairs=[fwd_pairs, bwd_pairs],
                  workers=first["workers"])
            shutil.rmtree(data_root, ignore_errors=True)
            shutil.rmtree(out, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase("launch_counts_real_data", launches=totals)
    return totals


def main():
    smi = device_phase()
    build_phase()
    if sys.argv[1:] == ["--real-data-only"]:     # a development aid: no result line
        real_data_phase(smi)
        return
    if sys.argv[1:] == ["--families-only"]:      # a development aid: no result line
        matrix_flow_animation_phase()
        return
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
    for window in (middle_modules_phase, train_phase, native_train_phase,
                   flow_diffuser_configs_phase, learner_phase, parity_smoke_phase,
                   matrix_flow_animation_phase, lambda: real_data_phase(smi)):
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
            st128, nat = (STEP_SPLAT_BWD[f"{h}x{w}_b{b}"] for h, w, b in (
                (128, 128, TRAIN_B), (NATIVE.height, NATIVE.width, NATIVE_TRAIN_B)))
            dev = prof["splat_bwd"]
            vals = dict(max_abs_err=splat_bwd_err, ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound"], bound_by="bytes", library_ms=None,
                        per=f"one 128x128 b{TRAIN_B} train step (5 launches: scale 1 bf16, "
                            "scales 2-16 f32)",
                        bitwise_vs_plain=r["bitwise"] and st128["bitwise"] and nat["bitwise"],
                        device_ms=sum(dev[f"128x128_b{TRAIN_B}_s{sc}_"
                                          f"{'bfloat16' if sc == 1 else 'float32'}"]["device_ms"]
                                      for sc in (1, 2, 4, 8, 16)),
                        per_128x128_step=dict(
                            ms=st128["ms"], plain_ms=st128["plain_ms"], bound_ms=st128["bound_ms"],
                            device_ms=dev[f"train_step_128x128_b{TRAIN_B}"]["device_ms"],
                            calls=len(st128["calls"]),
                            per="the splat backwards of one 128x128 b16 train step, on their "
                                "own inputs"),
                        per_native_step=dict(
                            ms=nat["ms"], plain_ms=nat["plain_ms"], bound_ms=nat["bound_ms"],
                            device_ms=dev[f"train_step_{NATIVE.height}x{NATIVE.width}_"
                                          f"b{NATIVE_TRAIN_B}"]["device_ms"],
                            calls=len(nat["calls"]),
                            per=f"the splat backwards of one 448x1024 b{NATIVE_TRAIN_B} remat "
                                "train step, on their own inputs"))
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
            dev = prof["mid_ctx_native_eval_device_ms" if k is kernels.LA_MID_CTX
                       else "mid_out_native_eval_device_ms"]
            vals.update(device_ms=dev, bound_share=st["bound"] / dev)
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
        vals["learner_launches_per_step"] = LEARNER_EXPECTED.get(k.name, 0)
        rows.append({"name": k.name, "route": k.route, "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name], **vals})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
