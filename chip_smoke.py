"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Budget: under 10 minutes on one H100, the kernel build included (the build
is one plain ``nvcc`` call per source and takes seconds).  Every line it
prints is one JSON object, flushed as it goes, apart from the card's
``nvidia-smi`` line.  Phases:

1. device: needs ``torch.cuda.is_available()``; prints the name and power
   limit of the card as ``nvidia-smi`` gives them.
2. build: compiles every CUDA source of the port (in parallel) and prints
   the seconds.
3. kernel_vs_plain: each kernel against its plain PyTorch version on the
   card, at every (N, C) that the 128x128 UNet gives it, batch 8, bf16 and
   f32 x; errors and CUDA-event times.
4. slice: the flagship FlowDiffuser (128x128, UNet width 64, bf16, weights
   from a seed, output conv not zeroed) on a batch of 8 from the artificial
   dataset: one UnetWithWarp forward with the kernels against the same
   forward with ``block_plain``; then DDIM-50 and the 1000-step ancestral
   loop, each once after a warm-up, with the kernels' launch counts.  The
   samples keep the NaN holes of the splat: a hole in the state stays a hole
   (the posterior mean carries it), and with random weights the predicted
   flow moves from step to step, so after the 1000-step loop nearly every
   pixel has been a hole once.  The checks are on shapes, the finite flow
   and the finiteness of every non-NaN value.
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
from opticalflowdiffusion_tpu_torch.kernels import build as kbuild
from opticalflowdiffusion_tpu_torch.models import unet as unet_mod
from opticalflowdiffusion_tpu_torch.ops import attention_fused as af
from opticalflowdiffusion_tpu_torch.sample import build as build_flagship

T0 = time.perf_counter()
B = 8
SEED = 0
# (N, C) of the LinearAttentionBlocks of one 128x128 UNet eval, with counts
SHAPES = ((16384, 64, 2), (4096, 64, 1), (4096, 128, 1), (1024, 128, 1),
          (1024, 256, 1), (256, 256, 1), (256, 512, 1))
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM, bf16 tensor, f32
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# max error relative to the checked quantity's scale (see kernel_phase).
# Pass A and pass B vs their plain versions: the same bf16 operands, f32
# sums in another order (an LN statistic can flip one bf16 rounding).
TOL_CTX = 1e-2
TOL_OUT = 2e-2
# whole block vs block_plain in x.dtype: for f32 x the plain version keeps
# f32 operands while the kernels round them to bf16 (as the TPU kernels do)
TOL_BLOCK = 5e-2
# UnetWithWarp flow with kernels vs with block_plain, relative to the flow's
# max |value|: bf16 differences carried through ~60 layers
TOL_FLOW = (0.05, 0.01)


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name, **kw):
    emit({"phase": name, "t": round(time.perf_counter() - T0, 2), **kw})


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


def bound_ms(kernel, C, N, xbytes):
    """Least time for one launch on (B, C, N): the larger of its bytes over
    the HBM rate and its operations over the peak rate of their type.
    Returns (bytes ms, operations ms)."""
    if kernel == "ctx":
        nbytes = B * C * N * xbytes + 256 * C * 2 + C * 4 + B * (4096 + 256) * 4
        t_ops = 2 * B * N * C * 256 / BF16_FLOPS + 2 * B * N * 4096 / F32_FLOPS
    else:
        nbytes = 2 * B * C * N * xbytes + 2 * 128 * C * 2 + B * 4096 * 4 + 3 * C * 4
        t_ops = 2 * B * N * (C * 128 + 128 * 32 + 128 * C) / BF16_FLOPS
    return 1e3 * nbytes / HBM_BPS, 1e3 * t_ops


def block_inputs(C, N, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = rn(B, C, N).to(dtype)
    p = (1.0 + 0.1 * rn(C), rn(3 * 128, C) / C ** 0.5, rn(C, 128) / 128 ** 0.5,
         0.01 * rn(C), 1.0 + 0.1 * rn(C))
    return x, p


def err(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def device_phase():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    phase("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
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


def kernel_phase():
    """Each kernel against its plain version at every main-path shape.

    Errors are taken relative to the scale of what each check is about:
    the context for pass A; for pass B the residual branch y - x, fed an
    attention-dominated context (ctx / N ~ N(0, 1), since the block's own
    context is ~1/N and its bias would otherwise hide the attention path);
    for the whole block the residual branch with a zero output bias.  A
    bf16 y is also allowed one bf16 ulp of its largest value, 2^-7 max |y|."""
    stats = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound": 0.0,
                 "bytes_ms": 0.0, "ops_ms": 0.0} for k in ("ctx", "out")}
    for i, (N, C, count) in enumerate(SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            x, (g_pre, w_qkv, w_out, b_out, g_post) = block_inputs(C, N, dtype, 100 + i)
            w16 = w_qkv.to(torch.bfloat16)
            w_kv, w_q = w16[128:].contiguous(), w16[:128].contiguous()
            wo16 = w_out.to(torch.bfloat16).contiguous()
            g = torch.Generator(device="cuda").manual_seed(200 + i)
            ctx_in = N * torch.randn(B, 4, 32, 32, generator=g, device="cuda")
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
                times = {
                    "ctx_ms": cuda_ms(lambda: af.linear_attention_ctx(x, g_pre, w_kv)),
                    "ctx_plain_ms": cuda_ms(lambda: af.ctx_plain(x, g_pre, w_kv)),
                    "out_ms": cuda_ms(lambda: af.linear_attention_out(
                        x, g_pre, w_q, ctx_p, wo16, b_out, g_post)),
                    "out_plain_ms": cuda_ms(lambda: af.out_plain(
                        x, g_pre, w_q, ctx_p, wo16, b_out, g_post)),
                    "block_ms": cuda_ms(lambda: af.fused_linear_attention_block(
                        x, g_pre, w_qkv, w_out, b_out, g_post)),
                    "block_plain_ms": cuda_ms(lambda: af.block_plain(
                        x, g_pre, w_qkv, w_out, b_out, g_post)),
                }
            xbytes = x.element_size()
            b_ctx, b_out_ = bound_ms("ctx", C, N, xbytes), bound_ms("out", C, N, xbytes)
            phase("kernel_vs_plain", N=N, C=C, B=B, dtype=str(dtype).split(".")[1],
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
    for s in stats.values():
        s["bound_by"] = "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations"
    return stats


@contextlib.contextmanager
def plain_attention():
    """Route the UNet's linear-attention blocks through block_plain (the
    reference forward of this script only)."""
    saved = unet_mod.fused_linear_attention_block
    unet_mod.fused_linear_attention_block = (
        lambda x, *a: af.block_plain(x, *a))
    try:
        yield
    finally:
        unet_mod.fused_linear_attention_block = saved


def slice_phase():
    t = time.perf_counter()
    algo, data = build_flagship(SEED, "cuda")
    algo_ddim, _ = build_flagship(SEED, "cuda", sampling_timesteps=50)
    items = [data[i] for i in range(B)]
    _, cond, _ = algo.preprocess(to_batch(items, algo.device))
    H = algo.image_size
    phase("slice_build", seconds=round(time.perf_counter() - t, 2),
          params=sum(p.numel() for p in algo.module.parameters()),
          cond_shape=list(cond.shape), dtype=str(algo.dtype))

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(B, algo.channels, H, H, generator=g, device="cuda")
    tt = torch.full((B,), 500, dtype=torch.long, device="cuda")
    with torch.no_grad():
        out_k = algo.module(x, cond, tt)
        with plain_attention():
            out_p = algo.module(x, cond, tt)
    torch.cuda.synchronize()
    flow_k, flow_p = out_k[:, 3:], out_p[:, 3:]
    scale = float(flow_p.abs().max())
    e_flow = err(flow_k, flow_p)
    nan_k, nan_p = torch.isnan(out_k[:, :3]), torch.isnan(out_p[:, :3])
    phase("unet_with_warp_vs_plain", flow_max_abs=e_flow[0], flow_mean_abs=e_flow[1],
          flow_scale=scale, nan_mask_agreement=float((nan_k == nan_p).float().mean()))
    check(torch.isfinite(flow_k).all() and scale > 0, "UnetWithWarp flow not finite")
    check(e_flow[0] <= TOL_FLOW[0] * scale and e_flow[1] <= TOL_FLOW[1] * scale,
          f"UnetWithWarp with kernels disagrees with block_plain: {e_flow}, scale {scale}")

    gen = torch.Generator(device="cuda")
    algo_ddim.sample(cond, generator=gen.manual_seed(SEED))        # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    results = {}
    for name, a in (("ddim50", algo_ddim), ("ancestral1000", algo)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        samples, flow = a.sample(cond, generator=gen.manual_seed(SEED))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        steps = a.sched.sampling_timesteps
        finite = ~torch.isnan(samples)
        res = {
            "denoise_steps": steps, "seconds": sec, "denoise_steps_per_s": steps / sec,
            "samples_shape": list(samples.shape), "flow_shape": list(flow.shape),
            "nan_share": float((~finite).float().mean()),
            "finite_values_finite": bool(torch.isfinite(samples[finite]).all()
                                         and torch.isfinite(flow).all()),
        }
        phase("sample_" + name, **res)
        check(res["samples_shape"] == [B, 3, H, H] and res["flow_shape"] == [B, 2, H, H],
              f"{name}: wrong output shapes")
        check(res["finite_values_finite"], f"{name}: non-finite values")
        results[name] = res
    launches = {k.name: k.launches for k in kernels.KERNELS}
    evals = 8 * (50 + 1000)
    phase("launch_counts", launches=launches, expected_each=evals)
    for k in kernels.KERNELS:
        check(k.launches == evals, f"{k.name} launched {k.launches} times, expected {evals}")
    return launches


def main():
    device_phase()
    build_phase()
    stats = kernel_phase()
    launches = slice_phase()
    key = {"linear_attention_ctx": "ctx", "linear_attention_out": "out"}
    rows = []
    for k in kernels.KERNELS:
        s = stats[key[k.name]]
        rows.append({
            "name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name], "max_abs_err": s["err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound"], "bound_by": s["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
