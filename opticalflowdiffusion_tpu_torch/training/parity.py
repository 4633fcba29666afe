"""Trained-model parity (JAX ``training/parity.py``): train FlowDiffuser's
and FlowLearner's stages on the artificial dataset and hold their
validation metrics to the bars that the JAX package recorded.

Settings as in JAX: 32x32 frames, an artificial dataset of 4096 items with
seed 7 (the validation batches are its first items, unshuffled), batch 16
(validation 8), ``flow_max`` 2, lr 2e-4, clipping at 100, DDIM-50, float32
compute (JAX's parity run sets no precision), 4000 steps (2000 for the
latent stage, 3000 for the AE and the learners).  The weights start as
flax's initialisers give them (``init_weights``: truncated lecun-normal
kernels, biases 0, gains 1), so a zero-initialised model outputs zero flow and its
initial metrics depend on the data alone.

Each stage records, under JAX's keys, ``steps``, the metrics before
(``init``, 2 validation batches) and after training (``final``, 8), the
loss curve, the speed, the saved images and, for the learners, the
loss oracles (the loss of the ground-truth, zero and negated flows with
unit weights).  The final evaluation of a pixel-space FlowDiffuser stage
adds JAX's Frechet rows (``utils/fid.py::auto_feature_fn``: the trained
classifier's features when ``classifier-feat`` resolves, else the
random-conv bank, the source in the key): ``frechet_{src}`` between the
sampled and the target frames, its split-half ``_floor``, its ``_ceiling``
against uniform noise and, for the flow target (scored on the colour-wheel
renders), ``_render_noise_floor``.  The markdown report of the JAX script
is not ported.  ``JAX_BARS`` holds JAX's recorded numbers
(``parity/parity_r05.json``), and each finished stage is printed beside
them with its pass bars (``bars``).

    python -m opticalflowdiffusion_tpu_torch.training.parity --stages joint,learner \\
        [--diffuser-steps 4000] [--learner-steps 3000] [--ae-steps 3000] [--seed 0] \\
        [--out outputs/parity] [--device cuda] [--image-size 32] [--levels 1,2,4] \\
        [--ae RUN_DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..algorithms.flow_diffuser import FlowDiffuser
from ..algorithms.flow_learner import FlowLearner
from ..config import FLAGSHIP, FLAGSHIP_DATA, FLOW_LEARNER
from ..data.artificial import ArtificialDataset
from ..data.loader import DataLoader
from ..experiments.base import to_device
from ..models.unet import init_weights
from ..parallel.train import TrainState, make_optimizer, make_train_step
from ..utils import fid as fidlib
from ..utils import visualization as viz

STAGES = ("joint", "dpmpp", "flow", "flowloss", "flowloss_sweep", "ancestral", "latent",
          "flownoise", "learner", "learner_bf16", "learner_filter")
DEFAULT_STAGES = ("joint", "dpmpp", "flow", "flowloss", "flowloss_sweep", "latent", "flownoise",
                  "learner", "learner_filter")

# JAX's harnesses open a stage's training loader twice before its first step
# (``algo.init(rng, next(iter(train_loader)))`` for the initial evaluation's
# state, then again in ``_train``), and each pass reshuffles with seed +
# epoch: a stage trains from its loader's third pass
INIT_PASSES = 2

# JAX's recorded results (parity/parity_r05.json, a TPU run), to 6 digits:
# per stage the steps and a subset of the init and final metrics
_K = ("val/epe", "val/mse", "val/loss", "zero_flow_epe", "epe_moving", "moving_frac_gt",
      "moving_frac_sampled", "dist_w1_mag")
_INIT = (0.171198, 0.307515, None, 0.171198, 1.22031, 0.136536, 0.0, 0.171506)


def _bar(steps, init, final):
    return {"steps": steps, "init": {k: v for k, v in zip(_K, init) if v is not None},
            "final": dict(zip(_K, final))}


JAX_BARS = {
    "flow_diffuser": _bar(4000, _INIT[:2] + (2216.59,) + _INIT[3:], (
        0.209578, 0.230478, 101.041, 0.137823, 1.32208, 0.112061, 0.056488, 0.113426)),
    "flow_diffuser_flow": _bar(4000, _INIT[:2] + (0.0275269,) + _INIT[3:], (
        0.200039, 0.260577, 0.00446224, 0.137823, 1.64472, 0.112061, 0.111099, 0.0254395)),
    "flow_diffuser_flowloss": _bar(4000, _INIT[:2] + (1469.35,) + _INIT[3:], (
        0.196462, 0.233635, 38.1397, 0.137823, 1.21865, 0.112061, 0.0105133, 0.163248)),
    "flow_diffuser_flowloss_w0.1": _bar(4000, _INIT[:2] + (1469.34,) + _INIT[3:], (
        0.24006, 0.218417, 54.3567, 0.137823, 1.34602, 0.112061, 0.0544891, 0.150935)),
    "flow_diffuser_flowloss_w10": _bar(4000, _INIT[:2] + (1469.43,) + _INIT[3:], (
        0.21052, 0.233559, 69.9096, 0.137823, 1.24208, 0.112061, 0.0254822, 0.156777)),
    "flow_diffuser_dpmpp20": _bar(4000, _INIT[:2] + (2216.59,) + _INIT[3:], (
        0.21043, 0.230173, 101.039, 0.137823, 1.33521, 0.112061, 0.0558319, 0.112542)),
    "flow_diffuser_latent": _bar(2000, (0.171198, 0.0, 554.133) + _INIT[3:], (
        0.169478, 0.000200097, 110.722, 0.137823, 1.20057, 0.112061, 0.00105286, 0.152978)),
    "flow_diffuser_flownoise": _bar(4000, _INIT[:2] + (2216.59,) + _INIT[3:], (
        0.36169, 0.223887, 11.7064, 0.137823, 1.32027, 0.112061, 0.152802, 0.223742)),
    "flow_learner": _bar(3000, _INIT[:2] + (0.0374822,) + _INIT[3:], (
        0.146536, 0.242688, 0.00270297, 0.137823, 1.07874, 0.112061, 0.0386963, 0.0979208)),
    "flow_learner_filter": _bar(3000, (0.484752, 0.215911, 0.431487, 0.171198, 1.43118, 0.136536,
                                       0.195679, 0.32665), (
        0.149964, 0.23312, 0.0093002, 0.137823, 0.794101, 0.112061, 0.134903, 0.10611)),
    "ae_pretrain": {"steps": 3000, "recon_mse": 0.000204178, "recon_mse_init": 0.687002,
                    "identity_mse": 0.0217896},
}

# the pass bars: the data-only initial metrics to 1e-3 relative (and, for
# the zero-initialised models, the initial val/mse and val/epe); the final
# val/mse of the FlowDiffuser stages within 10% of JAX's or lower, the
# learners' final val/epe within 15% or lower, the AE's recon_mse within 2x
INIT_RTOL = 1e-3
FINAL_SLACK = {"val/mse": 1.10, "val/epe": 1.15, "recon_mse": 2.0}


def bars(key: str, result: dict) -> dict:
    """The pass bars of a finished stage: {metric: {port, jax, bar, pass}}."""
    want = JAX_BARS.get(key)
    if want is None:
        return {}
    out = {}
    if key == "ae_pretrain":
        got, jax_ = result["recon_mse"], want["recon_mse"]
        return {"recon_mse": dict(port=got, jax=jax_, bar=jax_ * FINAL_SLACK["recon_mse"],
                                  ok=got <= jax_ * FINAL_SLACK["recon_mse"])}
    init_keys = ["zero_flow_epe", "moving_frac_gt"]
    if want["init"]["val/epe"] == want["init"]["zero_flow_epe"]:    # zero-initialised model
        init_keys += ["val/epe"] + (["val/mse"] if want["init"]["val/mse"] else [])
    for k in init_keys:
        got, jax_ = result["init"][k], want["init"][k]
        out["init " + k] = dict(port=got, jax=jax_, bar=f"within {INIT_RTOL:g} relative",
                                ok=abs(got - jax_) <= INIT_RTOL * abs(jax_))
    k = "val/epe" if key.startswith("flow_learner") else "val/mse"
    got, jax_ = result["final"][k], want["final"][k]
    out["final " + k] = dict(port=got, jax=jax_, bar=jax_ * FINAL_SLACK[k],
                             ok=got <= jax_ * FINAL_SLACK[k])
    return out


def _w1(a: np.ndarray, b: np.ndarray, cap: int = 50000) -> float:
    """1-Wasserstein distance between two empirical 1-D distributions
    (mean |quantile difference| at 512 quantiles)."""
    rng = np.random.default_rng(0)
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.size == 0 or b.size == 0:
        return float("nan")
    if a.size > cap:
        a = rng.choice(a, cap, replace=False)
    if b.size > cap:
        b = rng.choice(b, cap, replace=False)
    q = np.linspace(0.0, 1.0, 512)
    return float(np.abs(np.quantile(a, q) - np.quantile(b, q)).mean())


def _nhwc(x) -> np.ndarray:
    """A (B, C, H, W) tensor (or array) as a (B, H, W, C) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x).transpose(0, 2, 3, 1)


def _frechet_rows(frames_real, frames_fake, flows_real, flows_fake, device) -> dict:
    """JAX's Frechet rows (module docstring) of the collected frames, at
    most 512 of each; the render noise floor when the frames are flow
    renders."""
    fn, src = fidlib.auto_feature_fn(device=device)
    fake = np.concatenate(frames_fake)[:512]
    real = np.concatenate(frames_real)[:512]
    half = len(real) // 2
    out = {f"frechet_{src}": fidlib.fid_between(real, fake, feature_fn=fn),
           f"frechet_{src}_floor": fidlib.fid_between(real[:half], real[half:], feature_fn=fn)}
    # the ceiling at the floor's n/2 (the estimator's bias depends on n)
    noise = np.random.default_rng(0).random(real.shape, dtype=np.float32)
    out[f"frechet_{src}_ceiling"] = fidlib.fid_between(real[:half], noise[:half], feature_fn=fn)
    if flows_real:
        # the render normalises each image by its own largest radius, so a
        # sampled flow's faint background residual colours every static
        # pixel: the floor of a render-space stage is Frechet(render(gt),
        # render(gt + sigma N)), sigma the sampled residual on static pixels
        fr = np.concatenate(flows_real)[:512]
        ff = np.concatenate(flows_fake)[:512]
        static = np.sqrt((fr ** 2).sum(-1)) <= 0.5
        sigma = float(np.std(ff[static]) if static.any() else np.std(ff))
        out["render_static_residual_sigma"] = sigma
        g = np.random.default_rng(1).standard_normal(fr.shape).astype(np.float32)
        out[f"frechet_{src}_render_noise_floor"] = fidlib.fid_between(
            real, viz.flow_to_image(fr + sigma * g), feature_fn=fn)
    return out


def _eval(algo, val_loader, generator, n_batches: int = 8, val_step=None,
          frechet: bool = False):
    """Mean validation metrics over ``n_batches`` batches, the flow-error
    splits (zero-flow EPE, moving and static EPE: moving is |flow| > 0.5)
    and the distribution distances of the sampled flows, with ``frechet``
    the Frechet rows (:func:`_frechet_rows`) of the sampled against the
    target frames (frames in [0, 1], or colour-wheel renders of a flow-only
    target); returns (metrics, the first batch's artifacts, the first
    batch).  ``val_step(batch, generator)`` defaults to the algorithm's; the
    loader yields NHWC numpy batches, the step takes them on the algorithm's
    device as NCHW."""
    if val_step is None:
        val_step = algo.val_step
    device = getattr(algo, "device", torch.device("cpu"))
    totals, count = {}, 0
    arts0 = batch0 = None
    acc = {"gt_u": [], "gt_v": [], "p_u": [], "p_v": [], "gt_mag": [], "p_mag": []}
    frames_real, frames_fake, flows_real, flows_fake = [], [], [], []
    for i, batch in enumerate(val_loader):
        if i >= n_batches:
            break
        metrics, arts = val_step(to_device(batch, device), generator)
        if i == 0:
            arts0, batch0 = arts, batch
        for k in ("val/epe", "val/mse", "val/loss", "val/last_step_epe", "val/ideal_loss"):
            if k in metrics:
                totals[k] = totals.get(k, 0.0) + float(metrics[k])
        flow = np.asarray(batch[2])
        p_flows = _nhwc(arts["p_flows"])
        err = np.sqrt(((flow - p_flows) ** 2).sum(-1) + 1e-12)
        mag = np.sqrt((flow ** 2).sum(-1) + 1e-12)
        moving = mag > 0.5
        add = lambda k, v: totals.__setitem__(k, totals.get(k, 0.0) + float(v))
        add("zero_flow_epe", mag.mean())
        add("epe_moving", err[moving].mean() if moving.any() else 0.0)
        add("epe_static", err[~moving].mean() if (~moving).any() else 0.0)
        add("zero_flow_epe_moving", mag[moving].mean() if moving.any() else 0.0)
        acc["gt_u"].append(flow[..., 0][moving])
        acc["gt_v"].append(flow[..., 1][moving])
        p_mag = np.sqrt((p_flows ** 2).sum(-1) + 1e-12)
        acc["p_u"].append(p_flows[..., 0][p_mag > 0.5])
        acc["p_v"].append(p_flows[..., 1][p_mag > 0.5])
        acc["gt_mag"].append(mag.ravel())
        acc["p_mag"].append(p_mag.ravel())
        if frechet and "samples" in arts and "tgt_x" in arts:
            s = np.nan_to_num(_nhwc(arts["samples"]))
            t_ = np.nan_to_num(_nhwc(arts["tgt_x"]))
            if s.shape[-1] >= 3 and t_.shape[-1] >= 3:
                frames_fake.append(np.clip((s[..., :3] + 1) * 0.5, 0, 1))
                frames_real.append(np.clip((t_[..., :3] + 1) * 0.5, 0, 1))
            else:      # a flow-only target: its colour-wheel renders
                frames_fake.append(viz.flow_to_image(s[..., -2:]))
                frames_real.append(viz.flow_to_image(t_[..., -2:]))
                flows_fake.append(s[..., -2:])
                flows_real.append(t_[..., -2:])
        if "last_step_flow" in arts:
            lerr = np.sqrt(((flow - _nhwc(arts["last_step_flow"])) ** 2).sum(-1) + 1e-12)
            add("last_step_epe_moving", lerr[moving].mean() if moving.any() else 0.0)
        count += 1
    out = {k: v / count for k, v in totals.items()}
    cat = {k: np.concatenate(v) if v else np.zeros(0) for k, v in acc.items()}
    out["dist_w1_mag"] = _w1(cat["p_mag"], cat["gt_mag"])
    out["dist_w1_mag_zeroflow"] = _w1(np.zeros_like(cat["gt_mag"]), cat["gt_mag"])
    out["dist_w1_u_moving"] = _w1(cat["p_u"], cat["gt_u"])
    out["dist_w1_v_moving"] = _w1(cat["p_v"], cat["gt_v"])
    out["moving_frac_gt"] = float((cat["gt_mag"] > 0.5).mean() if cat["gt_mag"].size
                                  else np.nan)
    out["moving_frac_sampled"] = float((cat["p_mag"] > 0.5).mean() if cat["p_mag"].size
                                       else np.nan)
    if frechet and frames_fake:
        out.update(_frechet_rows(frames_real, frames_fake, flows_real, flows_fake, device))
    return out, arts0, batch0


def stage_loaders(data_cfg, batch: int, val_batch: int, seed: int):
    """(training loader, validation loader) of a stage on ``data_cfg``; the
    training loader starts at the pass that JAX's stages train from."""
    ds = ArtificialDataset(data_cfg)
    train_loader = DataLoader(ds, batch_size=batch, shuffle=True, seed=seed)
    train_loader.epoch = INIT_PASSES
    return train_loader, DataLoader(ds, batch_size=val_batch, shuffle=False, seed=seed)


def _train(algo, train_loader, generator, steps: int, clip: float, log_every: int = 100):
    """``steps`` train steps (augment, loss, backward, clip, Adam); returns
    (state, loss curve [(step, loss)], perf)."""
    cfg = algo.cfg
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), cfg.lr,
                                                   cfg.weight_decay, clip))
    step_fn = make_train_step(algo.loss_fn)
    sync = (lambda: torch.cuda.synchronize(algo.device)) if algo.device.type == "cuda" else (
        lambda: None)
    algo.module.train()
    curve, done = [], 0
    t0, t_first = time.time(), None
    while done < steps:
        for batch in train_loader:
            metrics = step_fn(state, to_device(batch, algo.device), generator)
            done += 1
            if t_first is None:
                sync()
                t_first = time.time() - t0
            if done % log_every == 0 or done == steps:
                loss = float(metrics["train/loss"])
                curve.append((done, loss))
                print(f"  step {done}/{steps} loss={loss:.5f} "
                      f"({(done - 1) / max(time.time() - t0 - t_first, 1e-9):.1f} steps/s)",
                      flush=True)
            if done >= steps:
                break
    sync()
    algo.module.eval()
    wall = time.time() - t0
    sps = (done - 1) / max(wall - t_first, 1e-9)
    return state, curve, dict(steps_per_sec=sps, compile_s=t_first, wall_s=wall)


def _save_visuals(algo, batch, arts, out_dir: Path, prefix: str):
    """The algorithm's images of one validation batch as PNGs."""
    saved = []
    images = algo.visualize(to_device(batch, "cpu"), arts)
    for key in ("original", "target", "samples", "gt_flow", "target_p", "grad_flow",
                "last_step"):
        if key in images:
            p = out_dir / f"{prefix}-{key}.png"
            viz.save_image(np.asarray(images[key]), p)
            saved.append(p.name)
    return saved


def run_parity(out_dir: str = "outputs/parity", diffuser_steps: int = 4000,
               learner_steps: int = 3000, batch: int = 16, image_size: int = 32,
               dataset_size: int = 4096, sampling_timesteps: int = 50, seed: int = 0,
               latent: bool = True, ae_steps: int = 3000, stages=DEFAULT_STAGES,
               device: str = "cuda", val_batch: int = 8, val_batches: int = 8,
               init_batches: int = 2, levels=None, unet_dim=None, log_every: int = 100,
               ae_dir=None) -> dict:
    """Train and evaluate ``stages``; writes ``<out_dir>/parity.json`` after
    each stage and returns the results.  ``levels`` (FlowLearner's pyramid),
    ``unet_dim`` (FlowDiffuser's width), ``val_batch``, ``val_batches`` and
    ``init_batches`` shrink a run for the CPU.  ``ae_dir`` (a run directory
    whose newest checkpoint holds an Autoencoder under ``ae.``) runs the
    latent stage on that Autoencoder instead of pretraining one."""
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        raise ValueError(f"unknown stages {unknown}; known: {STAGES}")
    dev = torch.device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    results = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "n_devices": 1, "bars": {}}
    data_cfg = dataclasses.replace(FLAGSHIP_DATA, image_size=image_size, size=dataset_size,
                                   seed=7)

    def flush():
        with open(out / "parity.json", "w") as fh:
            json.dump(results, fh, indent=1)

    def report(key):
        b = bars(key, results[key])
        results["bars"][key] = b
        line = "; ".join(f"{k} {v['port']:.6g} (JAX {v['jax']:.6g}, bar {v['bar']}: "
                         f"{'pass' if v['ok'] else 'MISS'})" if isinstance(v["bar"], str) else
                         f"{k} {v['port']:.6g} (JAX {v['jax']:.6g}, bar <= {v['bar']:.6g}: "
                         f"{'pass' if v['ok'] else 'MISS'})" for k, v in b.items())
        print(f"[parity] {key} vs JAX: {line}", flush=True)
        flush()

    def run_stage(key, algo, steps, rseed, oracles=False, frechet=False):
        init_weights(algo.module, torch.Generator().manual_seed(rseed))
        train_loader, val_loader = stage_loaders(data_cfg, batch, val_batch, seed)
        gen = torch.Generator(device=dev).manual_seed(rseed)
        init_metrics, _, _ = _eval(algo, val_loader, gen, n_batches=init_batches)
        _, curve, perf = _train(algo, train_loader, gen, steps, clip=100.0, log_every=log_every)
        final_metrics, arts, batch0 = _eval(algo, val_loader, gen, n_batches=val_batches,
                                            frechet=frechet)
        res = dict(steps=steps, init=init_metrics, final=final_metrics, loss_curve=curve,
                   perf=perf, visuals=_save_visuals(algo, batch0, arts, out, key))
        if oracles:
            tgt_o, cond_o, flow_o = algo.preprocess(to_device(batch0, dev), aug=False)
            with torch.no_grad():
                loss = lambda ov: float(algo.loss(tgt_o, cond_o, flow_o, override_flow=ov))
                res["loss_oracles"] = dict(gt_flow=loss(flow_o),
                                           zero_flow=loss(torch.zeros_like(flow_o)),
                                           negated_gt=loss(-flow_o))
        results[key] = res
        print(f"[parity] {key}: {json.dumps(final_metrics)} "
              f"(init epe {init_metrics.get('val/epe'):.3f})", flush=True)
        report(key)

    def diffuser_run(key, steps, rseed, **fields):
        print(f"[parity] FlowDiffuser ({key}) on the artificial dataset", flush=True)
        cfg = dataclasses.replace(FLAGSHIP, image_size=image_size, flow_max=2.0, lr=2e-4,
                                  sampling_timesteps=sampling_timesteps, precision="float32",
                                  **({"unet_dim": unet_dim} if unet_dim else {}))
        cfg = dataclasses.replace(cfg, **fields)
        # the Frechet rows for pixel-space samples (a latent stage's samples
        # are the Autoencoder's latents, not frames)
        run_stage(key, FlowDiffuser(cfg, device=dev), steps, rseed, frechet=not cfg.latent)

    def learner_run(key, rseed, **fields):
        print(f"[parity] FlowLearner ({key}, unsupervised photometric)", flush=True)
        cfg = dataclasses.replace(FLOW_LEARNER, image_size=image_size, flow_max=2.0, lr=2e-4,
                                  precision="float32",
                                  **({"levels": tuple(levels)} if levels else {}))
        cfg = dataclasses.replace(cfg, **fields)
        run_stage(key, FlowLearner(cfg, device=dev), learner_steps, rseed, oracles=True)

    if "joint" in stages:
        diffuser_run("flow_diffuser", diffuser_steps, seed)
    if "flow" in stages:
        diffuser_run("flow_diffuser_flow", diffuser_steps, seed + 2, target="flow")
    if "flowloss" in stages:
        diffuser_run("flow_diffuser_flowloss", diffuser_steps, seed + 4, diffusion_flow_weight=1.0)
    if "flowloss_sweep" in stages:
        for w in (0.1, 10.0):
            diffuser_run(f"flow_diffuser_flowloss_w{w:g}", diffuser_steps, seed + 4,
                         diffusion_flow_weight=w)
    if "dpmpp" in stages:
        diffuser_run("flow_diffuser_dpmpp20", diffuser_steps, seed, sampler="dpmpp",
                     sampling_timesteps=20)
    if "ancestral" in stages:
        diffuser_run("flow_diffuser_ancestral", diffuser_steps, seed, sampling_timesteps=None)
    if latent and "latent" in stages:
        from .ae_pretrain import train_ae

        if ae_dir is None:
            ae_dir = out / "ae_pretrain"
            ae = train_ae(steps=ae_steps, image_size=image_size, batch=batch,
                          dataset_size=dataset_size, out_dir=str(ae_dir), seed=seed,
                          device=device)
            results["ae_pretrain"] = {k: ae[k] for k in ("recon_mse", "recon_mse_init",
                                                         "identity_mse", "steps")}
            report("ae_pretrain")
        diffuser_run("flow_diffuser_latent", diffuser_steps // 2, seed + 3, latent=True,
                     ae=str(ae_dir), latent_dim=16)
    if "flownoise" in stages:
        diffuser_run("flow_diffuser_flownoise", diffuser_steps, seed + 6, noiser="flow",
                     sampling_timesteps=None)
    if "learner" in stages:
        learner_run("flow_learner", seed + 1)
    if "learner_bf16" in stages:
        learner_run("flow_learner_bf16", seed + 1, precision="bf16")
    if "learner_filter" in stages:
        learner_run("flow_learner_filter", seed + 5, flow_max=None, radius=3)
    flush()
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default=",".join(DEFAULT_STAGES),
                    help=f"comma list of {','.join(STAGES)}")
    ap.add_argument("--diffuser-steps", type=int, default=4000)
    ap.add_argument("--learner-steps", type=int, default=3000)
    ap.add_argument("--ae-steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="outputs/parity")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--levels", default=None, help="FlowLearner's levels, comma-separated")
    ap.add_argument("--ae", default=None,
                    help="run the latent stage on this run directory's Autoencoder")
    a = ap.parse_args(argv)
    run_parity(out_dir=a.out, diffuser_steps=a.diffuser_steps, learner_steps=a.learner_steps,
               ae_steps=a.ae_steps, seed=a.seed, device=a.device, image_size=a.image_size,
               batch=a.batch, stages=tuple(a.stages.split(",")), ae_dir=a.ae,
               levels=tuple(int(v) for v in a.levels.split(",")) if a.levels else None)


if __name__ == "__main__":
    main()


__all__ = ["INIT_PASSES", "JAX_BARS", "STAGES", "bars", "run_parity", "stage_loaders"]
