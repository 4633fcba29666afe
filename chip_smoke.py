"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Budget: under 10 minutes on one H100, the kernel build included (one plain
``nvcc`` call per source, all started together; seconds each).  Every line
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
   - the splat at 128x128 b8 and 448x1024 b2: against ``splat_raw`` and two
     launches bit for bit.
4. slice: the flagship FlowDiffuser (UNet width 64, bf16, weights from a
   seed, output conv not zeroed).  At 128x128 on a batch of 8 from the
   artificial dataset: one UnetWithWarp forward with the kernels against
   the same forward with the plain linear attention; then DDIM-50 and the
   1000-step ancestral loop.  At native 448x1024 (the artificial dataset
   rendered at 1024 and cropped to 448 rows): one UnetWithWarp forward at
   b2 with all kernels against the same forward with all plain versions;
   then DDIM-50 at b2 and b8 and DPM++(2M)-20 at b2, each after a warm-up
   UNet eval.  Each sampling path is one count window: the launch counts
   are set to 0, the batch is preprocessed (a splat) and sampled, and each
   kernel's count is checked against what that path must launch.  The
   samples keep the NaN holes of the splat: a hole in the state stays a
   hole, and with random weights the predicted flow moves from step to step.
   The checks are on shapes, the finite flow and the finiteness of every
   non-NaN value.
5. the kernels line, 6. the result line.

Any failure raises and exits non-zero without the result line; so does a
run without a CUDA device or without the port's package beside this file.
"""

import concurrent.futures
import contextlib
import json
import subprocess
import sys
import time

import torch

from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch.algorithms.base import to_batch
from opticalflowdiffusion_tpu_torch.config import NATIVE
from opticalflowdiffusion_tpu_torch.kernels import build as kbuild
from opticalflowdiffusion_tpu_torch.models import unet as unet_mod
from opticalflowdiffusion_tpu_torch.ops import attention_fused as af
from opticalflowdiffusion_tpu_torch.ops import flash_attention as fa
from opticalflowdiffusion_tpu_torch.ops import splat as sp
from opticalflowdiffusion_tpu_torch.ops import warp as warp_mod
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
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM, bf16 tensor, f32;
# SFU exponentials per clock per SM, and the SMs
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
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


def bound_ms(kernel, Bn, C, N, xbytes):
    """Least time for one launch on (Bn, C, N): the larger of its bytes over
    the HBM rate and its operations over the peak rate of their type.
    Returns (bytes ms, operations ms)."""
    if kernel == "ctx":
        nbytes = Bn * C * N * xbytes + 256 * C * 2 + C * 4 + Bn * (4096 + 256) * 4
        t_ops = 2 * Bn * N * C * 256 / BF16_FLOPS + 2 * Bn * N * 4096 / F32_FLOPS
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
            phase("kernel_vs_plain", kernel="linear_attention", at=label, N=N, C=C, B=Bn,
                  dtype=str(dtype).split(".")[1],
                  ctx_max_abs=e_ctx[0], ctx_max_rel=e_ctx[0] / ctx_scale,
                  m_max_abs=e_m[0], s_max_rel=e_s,
                  out_max_abs=e_out[0], out_residual_scale=out_scale, out_tol=out_tol,
                  block_max_abs=e_blk[0], block_residual_scale=blk_scale, block_tol=blk_tol,
                  ctx_bound_ms=max(b_ctx), out_bound_ms=max(b_out_),
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
    Returns the native b2 bf16 row and the largest error."""
    out = None
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
        if i == 0:
            out = row
        del qkv, q, k, v, got, sq, sk, sv
    return out, worst


def splat_inputs(Bn, H, W, dtype, seed):
    """Values as the warp gives them (image in [-1, 1], metric 0 or 1 with
    one NaN-hole in ten) and a flow of a few pixels, one of them infinite."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.rand(Bn, 3, H, W, generator=g, device="cuda") - 1).to(dtype)
    metric = (torch.rand(Bn, 1, H, W, generator=g, device="cuda") > 0.1).to(dtype)
    flow = 4 * torch.randn(Bn, 2, H, W, generator=g, device="cuda")
    flow[0, 0, 0, 0] = float("inf")
    return x, metric, flow


def splat_phase():
    """The splat against splat_raw; two launches bit for bit.  Returns the
    native b2 bf16 row and the largest error."""
    out = None
    worst = 0.0
    for i, (Bn, H, W) in enumerate(SPLAT_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            x, metric, flow = splat_inputs(Bn, H, W, dtype, 400 + i)
            plain = lambda: sp.splat_raw(torch.cat([x * metric, metric], dim=1), flow)
            a = sp.splat_linear_unn(x, flow, metric)
            b_ = sp.splat_linear_unn(x, flow, metric)
            want = plain()
            torch.cuda.synchronize()
            same = bool(torch.equal(a, b_))
            e = err(a, want)
            scale = float(want.float().abs().max())
            times = {"ms": cuda_ms(lambda: sp.splat_linear_unn(x, flow, metric)),
                     "plain_ms": cuda_ms(plain)}
            xb = x.element_size()
            nbytes = Bn * H * W * (3 * xb + xb + 2 * 4 + 4 * xb)
            bound = 1e3 * nbytes / HBM_BPS
            row = dict(B=Bn, H=H, W=W, dtype=str(dtype).split(".")[1], bitwise_same=same,
                       max_abs=e[0], mean_abs=e[1], scale=scale, bound_ms=bound,
                       bound_by="bytes", **{k: round(t, 5) for k, t in times.items()})
            phase("kernel_vs_plain", kernel="splat_linear_unn", **row)
            check(same, f"splat kernel not deterministic at {Bn, H, W, dtype}")
            check(e[0] <= TOL_SPLAT[dtype] * scale,
                  f"splat kernel disagrees with splat_raw at {Bn, H, W, dtype}: {e}")
            worst = max(worst, e[0])
            if (Bn, H, W, dtype) == (NATIVE_B, NATIVE.height, NATIVE.width, torch.bfloat16):
                out = row
    return out, worst


@contextlib.contextmanager
def plain_versions(attention=True, flash=False, splat=False):
    """Route the UNet through the plain versions of the kernels (the
    reference forward of this script only)."""
    saved = (unet_mod.fused_linear_attention_block, unet_mod.attention_middle,
             warp_mod.softsplat)
    if attention:
        unet_mod.fused_linear_attention_block = lambda x, *a: af.block_plain(x, *a)
    if flash:
        unet_mod.attention_middle = fa.flash_plain
    if splat:
        warp_mod.softsplat = lambda inp, flow, metric: sp.splat_raw(
            torch.cat([inp * metric, metric], dim=1), flow)
    try:
        yield
    finally:
        (unet_mod.fused_linear_attention_block, unet_mod.attention_middle,
         warp_mod.softsplat) = saved


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
    expected = {"linear_attention_ctx": 8 * steps, "linear_attention_out": 8 * steps,
                "flash_attention": steps if native else 0, "splat_linear_unn": steps + 1}
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
    del cond_native

    totals = {k.name: 0 for k in kernels.KERNELS}
    results = {}
    gen = torch.Generator(device="cuda")
    algo_ddim.sample(cond, generator=gen.manual_seed(SEED))        # warm-up
    paths = [("ddim50", algo_ddim, items, False), ("ancestral1000", algo, items, False)]
    paths += [(f"native_{s}{n}_b{b}", native_algos[s, n], native_items[b], True)
              for s, n, b in NATIVE.runs]
    warmed = set()
    for name, a, its, native in paths:
        if native and len(its) not in warmed:            # warm-up UNet eval at this shape
            _, c, _ = a.preprocess(to_batch(its, a.device))
            x = torch.randn((len(its), a.channels) + tuple(c.shape[2:]), device="cuda")
            with torch.no_grad():
                a.module(x, c, torch.full((len(its),), 999, dtype=torch.long, device="cuda"))
            warmed.add(len(its))
            del c, x
        res, launches = sample_path(name, a, its, native)
        results[name] = res
        for k, n in launches.items():
            totals[k] += n
    phase("launch_counts", launches=totals)
    return totals


def main():
    smi = device_phase()
    build_phase()
    la128 = la_phase(B, SHAPES, "128x128")
    la_native = la_phase(NATIVE_B, NATIVE_SHAPES, "448x1024", iters=10)
    flash_row, flash_err = flash_phase()
    splat_row, splat_err = splat_phase()
    launches = slice_phase()
    per_la = f"one 448x1024 b{NATIVE_B} UNet eval (8 launches, bf16 x)"
    rows = []
    for k in kernels.KERNELS:
        if k is kernels.FLASH:
            r = flash_row
            vals = dict(max_abs_err=flash_err, ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["sdpa_ms"], per="one launch at (2, 7168, 4, 32) bf16")
        elif k is kernels.SPLAT:
            r = splat_row
            vals = dict(max_abs_err=splat_err, ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
                        per=f"one launch at 448x1024 b{NATIVE_B} bf16 (3 + 1 channels)")
        else:
            key = "ctx" if k is kernels.LA_CTX else "out"
            s, s128 = la_native[key], la128[key]
            vals = dict(max_abs_err=max(s["err"], s128["err"]), ms=s["ms"],
                        plain_ms=s["plain_ms"], bound_ms=s["bound"], bound_by=s["bound_by"],
                        library_ms=None, per=per_la)
        rows.append({"name": k.name, "route": k.route, "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name], **vals})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
