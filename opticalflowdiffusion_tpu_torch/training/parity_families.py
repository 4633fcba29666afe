"""Trained parity of the MatrixFlow and animation families (JAX
``training/parity_families.py``, its ``matrix``, ``framegen`` and
``completer`` stages): train each on a synthetic dataset with exact ground
truth and hold its validation metrics to the bars taken from JAX's two
recorded rounds.

* ``matrix``: MatrixFlow, goal ``filter_pred``, radius 3, on the artificial
  dataset (32x32, 4096 items, seed 7), lr 2e-4; scored beside its own
  oracle, the loss of the ground-truth flow's one-hot filter
  (``val/opt_loss``, data only).
* ``framegen``: FrameGenerator on the constant-velocity video (32x32, 4096
  sequences, val_length 5, max_motion 2), lr 2e-4, DDIM-50; the rollout's
  MSE against the ground-truth continuation beside the copy-the-last-frame
  baseline (``_rollout_scores``).
* ``completer``: FlowCompleter on the same video (val_length 2), lr 2e-4;
  the dense EPE at 1, 4 and 9 sparse samples (``_completer_density_sweep``)
  and the moving and static EPE beside the zero-flow baselines
  (``_flow_epe_split``).

Settings as JAX's: batch 16 (validation 8, unshuffled), float32 (JAX's
family run sets no precision), clipping at 100, 3000 steps, weights as
flax initialises them (``init_weights(flax_defaults=True)``).  The initial
metrics average 2 validation batches (FrameGenerator's 1), the final ones 4
(FrameGenerator's 2).  ``JAX_FAMILY_BARS`` holds JAX's recorded numbers of
both rounds (``parity/parity_families_r03.json`` and ``_r05.json``; that
directory does not go to the card); each finished stage is printed beside
its bars (``family_bars``): the data-only metrics within 1e-3 relative, the
trained ones at most the larger of the two rounds plus 10% (and below
their baselines).  The PWC stages wait for the PWC port; the markdown
report is not ported.

``--save-weights`` writes each trained model's weights, rounded to
bfloat16 and lzma-compressed (~50 MB for a width-64 UNet), to
``<out>/<key>.bf16.pt.xz`` (``load_weights`` reads them back), and scores
the stage again on the rounded weights with the final validation's
generator state (``final_bf16_weights``), so that the rounding's effect is
on record beside the full weights' scores.

    python -m opticalflowdiffusion_tpu_torch.training.parity_families \\
        --stages matrix,framegen,completer [--steps 3000] [--seed 0] \\
        [--out outputs/parity_families] [--device cuda] [--save-weights]
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import lzma
from pathlib import Path

import numpy as np
import torch

from ..algorithms.animation import MAX_SPARSE, FlowCompleter, FrameGenerator
from ..algorithms.matrix_flow import MatrixFlow
from ..config import (ARTIFICIAL_VIDEO, FLAGSHIP_DATA, FLOW_COMPLETER, FRAME_GENERATOR,
                      MATRIX_FLOW_ALGO)
from ..data.artificial import ArtificialDataset
from ..data.artificial_video import ArtificialVideoDataset
from ..data.loader import DataLoader
from ..experiments.base import to_device
from ..models.unet import init_weights
from ..utils import visualization as viz
from .parity import _train

STAGES = ("matrix", "framegen", "completer")
KEYS = {"matrix": "matrix_flow_filter_pred", "framegen": "frame_generator",
        "completer": "flow_completer"}

# JAX's recorded results (a TPU's, rounds r03 and r05), 3000 steps each:
# the metrics that the bars read
JAX_FAMILY_BARS = {
    "matrix_flow_filter_pred": {
        "r03": {"init": {"val/opt_loss": 0.009584770537912846, "val/photometric": 0.1407562494277954,
                         "val/flow_err": 0.2307635098695755},
                "final": {"val/photometric": 0.00021237557814401953,
                          "val/flow_err": 0.14566146209836006,
                          "val/opt_loss": 0.007937564223539084}},
        "r05": {"init": {"val/opt_loss": 0.009584770537912846, "val/photometric": 0.1407490372657776,
                         "val/flow_err": 0.23074790835380554},
                "final": {"val/photometric": 0.00022880740823438828,
                          "val/flow_err": 0.1488675456494093,
                          "val/opt_loss": 0.007937564223539084}},
    },
    "frame_generator": {
        "r03": {"init": {"rollout_mse_copy_baseline": 0.02587890625,
                         "rollout_mse": 0.5714799761772156},
                "final": {"rollout_mse": 0.0039042301941663027,
                          "rollout_mse_copy_baseline": 0.02587890625,
                          "val/loss": 0.006896869977936149}},
        "r05": {"init": {"rollout_mse_copy_baseline": 0.02587890625,
                         "rollout_mse": 0.5713893175125122},
                "final": {"rollout_mse": 0.0042334445752203465,
                          "rollout_mse_copy_baseline": 0.02587890625,
                          "val/loss": 0.007186481263488531}},
    },
    "flow_completer": {
        "r03": {"init": {"val/loss": 0.6946538984775543},
                "final": {"val/loss": 0.032047613989561796, "epe_moving": 0.832349956035614,
                          "zero_flow_epe": 0.06660254299640656,
                          "zero_flow_epe_moving": 2.005882740020752, "moving_frac": 0.033203125}},
        "r05": {"init": {"val/loss": 0.6946689188480377},
                "final": {"val/loss": 0.02907563094049692, "epe_moving": 0.6860537528991699,
                          "zero_flow_epe": 0.06660254299640656,
                          "zero_flow_epe_moving": 2.005882740020752, "moving_frac": 0.033203125}},
    },
}

# the bars: the data-only metrics to 1e-3 relative; the trained ones at
# most the larger round plus 10%, and below their baselines
INIT_RTOL = 1e-3
FINAL_SLACK = 1.10
DATA_ONLY = {"matrix_flow_filter_pred": (("init", "val/opt_loss"),),
             "frame_generator": (("init", "rollout_mse_copy_baseline"),),
             "flow_completer": (("final", "zero_flow_epe"), ("final", "zero_flow_epe_moving"),
                                ("final", "moving_frac"))}
TRAINED = {"matrix_flow_filter_pred": (("val/photometric", None), ("val/flow_err", None)),
           "frame_generator": (("rollout_mse", "rollout_mse_copy_baseline"),),
           "flow_completer": (("val/loss", None), ("epe_moving", "zero_flow_epe_moving"))}


def jax_value(key: str, phase: str, metric: str, pick=max) -> float:
    """``pick`` (max) of JAX's two rounds' values of a metric."""
    return pick(r[phase][metric] for r in JAX_FAMILY_BARS[key].values())


def family_bars(key: str, result: dict) -> dict:
    """The bars of a finished stage: {metric: {port, jax, bar, ok}}."""
    out = {}
    for phase, k in DATA_ONLY[key]:
        got, want = result[phase][k], jax_value(key, phase, k)
        out[f"{phase} {k}"] = dict(port=got, jax=want, bar=f"within {INIT_RTOL:g} relative",
                                   ok=bool(abs(got - want) <= INIT_RTOL * abs(want)))
    for k, baseline in TRAINED[key]:
        got, bar = result["final"][k], jax_value(key, "final", k) * FINAL_SLACK
        ok = got <= bar
        row = dict(port=got, jax=jax_value(key, "final", k), bar=bar)
        if baseline is not None:
            row["baseline"] = result["final"][baseline]
            ok = ok and got < row["baseline"]
        out[f"final {k}"] = dict(row, ok=bool(ok))
    return out


def _nhwc(t) -> np.ndarray:
    """A (B, [T,] C, H, W) tensor as a (B, [T,] H, W, C) numpy array."""
    a = t.detach().float().cpu().numpy()
    return np.moveaxis(a, -3, -1)


def _val_avg(algo, val_loader, generator, n_batches: int = 4):
    """The mean of every scalar validation metric over ``n_batches``
    batches; (means, the first batch's artifacts, the first batch as the
    loader gave it)."""
    totals, count = {}, 0
    arts0 = batch0 = None
    for i, batch in enumerate(val_loader):
        if i >= n_batches:
            break
        metrics, arts = algo.val_step(to_device(batch, algo.device), generator)
        if i == 0:
            arts0, batch0 = arts, batch
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + float(v)
        count += 1
    return {k: v / count for k, v in totals.items()}, arts0, batch0


def _flow_epe_split(pred: np.ndarray, gt: np.ndarray) -> dict:
    """Global, moving (|gt| > 0.5) and static EPE and the zero-flow
    baselines of NHWC flows."""
    err = np.sqrt(((pred - gt) ** 2).sum(-1) + 1e-12)
    mag = np.sqrt((gt ** 2).sum(-1) + 1e-12)
    moving = mag > 0.5
    return dict(
        zero_flow_epe=float(mag.mean()),
        epe_moving=float(err[moving].mean()) if moving.any() else float("nan"),
        epe_static=float(err[~moving].mean()) if (~moving).any() else float("nan"),
        zero_flow_epe_moving=float(mag[moving].mean()) if moving.any() else float("nan"),
        moving_frac=float(moving.mean()),
    )


def _rollout_scores(arts, batch) -> dict:
    """The rollout's per-step MSE against the ground-truth continuation and
    the copy-the-last-frame baseline's (``batch``: the loader's (B, T, H, W,
    8) numpy stack)."""
    if arts is None or "rollout" not in arts:
        return {}
    ro = np.clip(_nhwc(arts["rollout"]), 0, 1)
    gt = _nhwc(arts["rollout_gt"])
    last = np.asarray(batch[0])[..., 3:6]
    per_step = ((ro - gt) ** 2).mean(axis=(0, 2, 3, 4))
    base_step = ((last - gt) ** 2).mean(axis=(0, 2, 3, 4))
    return {"rollout_mse": float(per_step.mean()),
            "rollout_mse_copy_baseline": float(base_step.mean()),
            "rollout_mse_per_step": [float(v) for v in per_step],
            "rollout_mse_copy_per_step": [float(v) for v in base_step]}


def top_magnitude_mask(dense: torch.Tensor, k: int) -> torch.Tensor:
    """(B, 1, H, W): 1 at the ``k`` pixels of largest |flow| among the
    first MAX_SPARSE (a stable descending sort: equal magnitudes, as every
    pixel of a moving box has, go to the lower index, as XLA's top_k)."""
    B, _, H, W = dense.shape
    mags = torch.linalg.vector_norm(dense, dim=1).reshape(B, -1)
    picked = torch.sort(mags, dim=1, descending=True, stable=True)[1][:, :MAX_SPARSE]
    keep = (torch.arange(MAX_SPARSE, device=dense.device) < k).float().expand(B, -1)
    mask = torch.zeros((B, H * W), device=dense.device).scatter_reduce(1, picked, keep, "amax")
    return mask.reshape(B, 1, H, W)


def _completer_density_sweep(algo, val_loader, ks=(1, 4, 9), n_batches: int = 4) -> dict:
    """The completed dense flow's EPE given the k largest-magnitude samples
    (the rest the learnt null embedding), k in ``ks``."""
    scores = {}
    with torch.no_grad():
        for k in ks:
            tot, n = 0.0, 0
            for i, b in enumerate(val_loader):
                if i >= n_batches:
                    break
                x = to_device(b, algo.device)[0]
                x = x[:, 0] if x.dim() == 5 else x
                out = algo.complete(x, top_magnitude_mask(x[:, -2:], k))
                tot += float(torch.sqrt((out - x[:, -2:]).square().sum(dim=1) + 1e-12).mean())
                n += 1
            scores[f"epe_at_k{k}"] = tot / max(n, 1)
    return scores


def _save_all_visuals(algo, batch, arts, out_dir: Path, prefix: str):
    saved = []
    for key, img in algo.visualize(to_device(batch, "cpu"), arts).items():
        p = out_dir / f"{prefix}-{key.replace('/', '_')}.png"
        viz.save_image(np.asarray(img), p)
        saved.append(p.name)
    return saved


def stage_setup(stage: str, device="cuda", image_size: int = 32, batch: int = 16,
                seed: int = 0, sampling_timesteps: int = 50, dataset_size: int = 4096):
    """(algorithm, training loader, validation loader) of a stage at JAX's
    settings."""
    if stage == "matrix":
        data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=image_size,
                                                     size=dataset_size, seed=7))
        train_ds = val_ds = data
        cfg = dataclasses.replace(MATRIX_FLOW_ALGO, image_size=f"{image_size},{image_size}",
                                  goal="filter_pred", radius=3, lr=2e-4, precision="float32")
        algo = MatrixFlow(cfg, device=device)
    else:
        video = dataclasses.replace(ARTIFICIAL_VIDEO, image_size=image_size, size=dataset_size,
                                    val_length=5 if stage == "framegen" else 2, max_motion=2)
        train_ds = ArtificialVideoDataset(video, split="training")
        val_ds = ArtificialVideoDataset(video, split="validation")
        if stage == "framegen":
            cfg = dataclasses.replace(FRAME_GENERATOR, image_size=image_size, lr=2e-4,
                                      sampling_timesteps=sampling_timesteps, precision="float32")
            algo = FrameGenerator(cfg, device=device)
        elif stage == "completer":
            cfg = dataclasses.replace(FLOW_COMPLETER, image_size=image_size, lr=2e-4,
                                      precision="float32")
            algo = FlowCompleter(cfg, device=device)
        else:
            raise ValueError(f"unknown stage {stage!r}; known: {STAGES}")
    return (algo, DataLoader(train_ds, batch_size=batch, shuffle=True, seed=seed),
            DataLoader(val_ds, batch_size=8, shuffle=False, seed=seed))


def data_only_metrics(stage: str, device="cpu") -> dict:
    """The metrics of a stage that depend on its data alone, computed as
    the harness computes them but without a model: MatrixFlow's oracle loss
    over the 2 initial validation batches, the copy baseline of
    FrameGenerator's first rollout batch, the zero-flow EPE split of
    FlowCompleter's first batch.  Keyed "phase metric" as ``family_bars``."""
    algo, _, val_loader = stage_setup(stage, device)
    batches = iter(val_loader)
    if stage == "matrix":
        tot = 0.0
        for _ in range(2):
            img, tgt, flow = to_device(next(batches), device)
            opt = algo.filter_from_vector(flow)
            applied, _ = algo.apply_filter(opt, img, mode="weighted_sum")
            tot += float(algo.loss(applied, opt, tgt, img, flow)[0])
        return {"init val/opt_loss": tot / 2}
    x = np.asarray(next(batches)[0])
    if stage == "framegen":
        return {"init rollout_mse_copy_baseline":
                float(((x[..., 3:6] - x[..., :3]) ** 2).mean(axis=(0, 2, 3, 4)).mean())}
    split = _flow_epe_split(np.zeros_like(x[:, 0, ..., -2:]), x[:, 0, ..., -2:])
    return {f"final {k}": split[k] for k in ("zero_flow_epe", "zero_flow_epe_moving",
                                             "moving_frac")}


def save_weights(module: torch.nn.Module, path: Path) -> None:
    """``module``'s state dict rounded to bfloat16, lzma-compressed."""
    buf = io.BytesIO()
    torch.save({k: v.detach().to(torch.bfloat16).cpu() for k, v in module.state_dict().items()},
               buf)
    path.write_bytes(lzma.compress(buf.getvalue(), preset=0))


def load_weights(path) -> dict:
    """The float32 state dict that ``save_weights`` wrote."""
    sd = torch.load(io.BytesIO(lzma.decompress(Path(path).read_bytes())), weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def _final_scores(stage, algo, val_loader, generator, n_final):
    """The final validation's metrics (and its first batch's artifacts and
    the batch), with the stage's own scores."""
    final_m, arts, batch0 = _val_avg(algo, val_loader, generator, n_final)
    if stage == "framegen":
        final_m.update(_rollout_scores(arts, batch0))
    if stage == "completer":
        final_m.update(_completer_density_sweep(algo, val_loader, n_batches=n_final))
        x = np.asarray(batch0[0])
        x = x[:, 0] if x.ndim == 5 else x
        final_m.update(_flow_epe_split(_nhwc(arts["out"]), x[..., -2:]))
    return final_m, arts, batch0


def run_families(out_dir: str = "outputs/parity_families", steps: int = 3000, batch: int = 16,
                 seed: int = 0, stages=STAGES, device: str = "cuda", image_size: int = 32,
                 sampling_timesteps: int = 50, val_batches=None, init_batches=None,
                 log_every: int = 100, keep_weights: bool = False) -> dict:
    """Train and evaluate ``stages``; writes ``<out_dir>/parity_families.json``
    after each stage and returns the results.  ``val_batches`` and
    ``init_batches`` (default JAX's) and ``image_size`` and
    ``sampling_timesteps`` shrink a run; ``keep_weights`` saves each
    trained model (``save_weights``) and scores it again on them."""
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        raise ValueError(f"unknown stages {unknown}; known: {STAGES}")
    dev = torch.device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    results = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "n_devices": 1, "bars": {}}

    def flush():
        with open(out / "parity_families.json", "w") as fh:
            json.dump(results, fh, indent=1)

    for stage in STAGES:
        if stage not in stages:
            continue
        key = KEYS[stage]
        print(f"[families] {key}", flush=True)
        algo, train_loader, val_loader = stage_setup(stage, dev, image_size, batch, seed,
                                                     sampling_timesteps)
        init_weights(algo.module, torch.Generator().manual_seed(seed), flax_defaults=True)
        gen = torch.Generator(device=dev).manual_seed(seed)
        n_init = init_batches or (1 if stage == "framegen" else 2)
        n_final = val_batches or (2 if stage == "framegen" else 4)
        init_m, init_arts, init_b = _val_avg(algo, val_loader, gen, n_init)
        if stage == "framegen":
            init_m.update(_rollout_scores(init_arts, init_b))
        if stage == "completer":
            init_m.update(_completer_density_sweep(algo, val_loader, n_batches=n_init))
        del init_arts
        _, curve, perf = _train(algo, train_loader, gen, steps, clip=100.0, log_every=log_every)
        gen_state = gen.get_state()
        final_m, arts, batch0 = _final_scores(stage, algo, val_loader, gen, n_final)
        results[key] = dict(steps=steps, init=init_m, final=final_m, loss_curve=curve,
                            perf=perf, visuals=_save_all_visuals(algo, batch0, arts, out, key))
        if keep_weights:
            path = out / f"{key}.bf16.pt.xz"
            save_weights(algo.module, path)
            algo.module.load_state_dict(load_weights(path))
            gen.set_state(gen_state)
            results[key]["final_bf16_weights"] = _final_scores(stage, algo, val_loader, gen,
                                                               n_final)[0]
        b = family_bars(key, results[key])
        results["bars"][key] = b
        line = "; ".join(f"{k} {v['port']:.6g} (JAX {v['jax']:.6g}, bar "
                         + (v["bar"] if isinstance(v["bar"], str) else f"<= {v['bar']:.6g}")
                         + (f", baseline {v['baseline']:.6g}" if "baseline" in v else "")
                         + f": {'pass' if v['ok'] else 'MISS'})" for k, v in b.items())
        print(f"[families] {key}: {json.dumps({k: v for k, v in final_m.items() if not isinstance(v, list)})}",
              flush=True)
        print(f"[families] {key} vs JAX: {line}", flush=True)
        if keep_weights:
            print(f"[families] {key} on its bfloat16 weights: "
                  + json.dumps({k: v for k, v in results[key]["final_bf16_weights"].items()
                                if not isinstance(v, list)}), flush=True)
        flush()
        del algo, arts
    flush()
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default=",".join(STAGES), help=f"comma list of {','.join(STAGES)}")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="outputs/parity_families")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--sampling-timesteps", type=int, default=50)
    ap.add_argument("--save-weights", action="store_true",
                    help="write each trained model, bfloat16 and lzma-compressed, to "
                         "<out>/<key>.bf16.pt.xz and score it again on those weights")
    a = ap.parse_args(argv)
    run_families(out_dir=a.out, steps=a.steps, batch=a.batch, seed=a.seed,
                 stages=tuple(a.stages.split(",")), device=a.device, image_size=a.image_size,
                 sampling_timesteps=a.sampling_timesteps, keep_weights=a.save_weights)


if __name__ == "__main__":
    main()


__all__ = ["JAX_FAMILY_BARS", "STAGES", "data_only_metrics", "family_bars", "load_weights",
           "run_families", "save_weights", "stage_setup", "top_magnitude_mask"]
