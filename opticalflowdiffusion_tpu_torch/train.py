"""Training entry point: train FlowDiffuser (or FlowPred, FlowLearner or
MatrixFlow) on the artificial dataset, Sintel, FlyingChairs or KITTI, or
FrameGenerator or FlowCompleter on the constant-velocity video dataset,
and test it.

    python -m opticalflowdiffusion_tpu_torch.train --steps 20 [--batch 16] \\
        [--image-size 128 | --image-size W,H] [--unet-dim 64] [--seed 0] [--device cuda] \\
        [--out outputs/train] [--resume] [--check-interval N|F] \\
        [--ckpt-every N] [--val-batch 8] [--sampling-timesteps S] \\
        [--conv-backend {cudnn,rows,fold}] [--remat] \\
        [--algorithm {flow_diffuser,flow_pred,flow_learner,matrix_flow,frame_generator,
                      flow_completer}] \\
        [--target {joint,target,flow}] \\
        [--noiser {image,flow}] [--no-diffusion] [--flow-weight W] \\
        [--diffusion-flow-weight W] [--latent --ae DIR] [--latent-dim 16] \\
        [--radius R] [--levels 1,2,4] [--precision {bf16,float32}] [--lr LR] \\
        [--flow-max F] [--dataset-size N] [--dataset-seed S] \\
        [--dataset {artificial,sintel,flying_chairs,kitti_single,artificial_video}] \\
        [--data-root DIR] [--workers N] [--tasks train,test] [--ckpt-path DIR] [--epochs E] \\
        [--profile-step N] [--goal {gt_flow_pred,filter_pred,gt_filter_pred}] \\
        [--val-length L] [--max-motion M]

The counterpart of ``main.py experiment=matrix_flow algorithm=flow_diffuser
dataset=artificial``: the flagship (UNet width 64, dim_mults (1, 2, 4, 8),
joint target, T = 1000, bf16 compute with float32 parameters, Adam at lr
1e-5 with weight decay 1e-6 and global-norm clipping at 100) trained at
batch 16.  Runs ``--steps`` train steps in all (or ``--epochs`` passes over
the training split, whichever ends first), validates every
``--check-interval`` steps (default: at the last step, at most every 100;
a fraction such as 0.5 is that share of an epoch) and writes each
validation's images under ``--out/images/<key>/``, checkpoints every
``--ckpt-every`` steps and at the last one under
``--out/checkpoints/<step>``, and writes ``--out/metrics.jsonl``.  With
``--resume`` it continues from the newest checkpoint under ``--out``, with
``--ckpt-path`` from the newest checkpoint of another run (its directory,
its ``checkpoints`` directory or one step's).  ``--tasks`` runs ``train``,
``test`` or both in order: ``test`` evaluates the newest checkpoint (of
``--ckpt-path``, else of ``--out``) on the whole test split and logs the
mean of each validation metric as ``test/*``.  ``--profile-step N`` traces
step N with ``torch.profiler`` into ``--out/profile/``.
Validation samples with the flagship's 1000-step ancestral loop unless
``--sampling-timesteps`` asks for DDIM.  ``--conv-backend`` lowers the UNet's
convs (``ops/conv.py``; default cudnn).  ``--remat`` recomputes the
UnetWithWarp closure in the backward (JAX's ``runtime.remat=true``, which the
native 448x1024 training row sets).  Prints one JSON line with the last
train, validation and test metrics and the samples per second of the run
(validation and checkpoint writes included).

``--dataset`` reads Sintel, FlyingChairs or KITTI from ``--data-root`` (or
``$OFD_DATA_ROOT``, else ``datasets``) with ``--workers`` loader threads
(default the yaml's 16, capped at the CPU count); ``--image-size W,H`` is
the dataset's size (default its yaml's: Sintel 512,256, the others 128,128)
and the algorithm takes W.  The artificial dataset is square: one side.

The model flags select FlowDiffuser's other configurations
(``flow_diffuser.yaml``): ``--target``, ``--noiser flow`` (the
permutation-warp forward process), ``--no-diffusion`` (the single-forward
model), ``--flow-weight`` (its flow term), ``--diffusion-flow-weight`` (the
direct flow MSE of the diffusion loss) and ``--latent`` (the model on the
latents of a frozen Autoencoder: ``--ae`` names the output directory of a
``--algorithm flow_pred`` run, whose newest checkpoint holds it; without
``--ae`` it is drawn from the seed).  ``--algorithm flow_pred`` trains that
Autoencoder (``algorithm/flow_pred.yaml``: lr 4e-5, ``--latent-dim``).
``--algorithm flow_learner`` trains FlowLearner (``flow_learner.yaml``: the
photometric pyramid at ``--levels``, default the reference's ten; the
filter representation with ``--radius``).  ``--precision``, ``--lr`` and
``--flow-max`` replace the algorithm's values; ``--dataset-size`` and
``--dataset-seed`` the artificial dataset's (default: 256000 items drawn
from ``--seed``).

``--algorithm matrix_flow`` trains MatrixFlow (``matrix_flow.yaml``: the
UNet maps the pair to R x R filters, ``--radius`` default 17, or to a flow;
``--goal`` gt_flow_pred, filter_pred or gt_filter_pred; ``--image-size``
one side or "W,H", default 128) on the artificial dataset.
``frame_generator`` and ``flow_completer`` run ``experiment/animation.yaml``
(batch 64, validation batch 8 shuffled, no clipping, a validation every 400
steps) on ``--dataset artificial_video`` (its default; ``--val-length``
transitions a validation item, default 5, ``--max-motion`` px a frame,
default 1; ``--image-size`` default the yaml's 32): FrameGenerator
(``frame_generator.yaml``: T = 1000, the ancestral loop unless
``--sampling-timesteps`` asks for DDIM; validation rolls the model out
over the transitions) or FlowCompleter (``flow_completer.yaml``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .algorithms.flow_diffuser import TARGETS
from .algorithms.matrix_flow import GOALS
from .config import (ANIMATION, DATA, FLAGSHIP, FLOW_COMPLETER, FLOW_LEARNER, FLOW_PRED,
                     FRAME_GENERATOR, MATRIX_FLOW, MATRIX_FLOW_ALGO)
from .data import DATASETS, get_dataset
from .experiments import animation as anim_exp
from .experiments.matrix_flow import ALGORITHMS as FLOW_ALGORITHMS
from .experiments.matrix_flow import MatrixFlowExperiment
from .ops.conv import BACKENDS

# the experiments and their algorithms (JAX's experiment=matrix_flow and
# experiment=animation)
EXPERIMENTS = {"matrix_flow": (MatrixFlowExperiment, MATRIX_FLOW),
               "animation": (anim_exp.AnimationExperiment, ANIMATION)}
ALGORITHMS = {**{k: "matrix_flow" for k in FLOW_ALGORITHMS},
              **{k: "animation" for k in anim_exp.ALGORITHMS}}
# the algorithms' yaml configs (FlowDiffuser's is the flagship)
BASES = {"flow_pred": FLOW_PRED, "flow_learner": FLOW_LEARNER, "matrix_flow": MATRIX_FLOW_ALGO,
         "frame_generator": FRAME_GENERATOR, "flow_completer": FLOW_COMPLETER}
# the config fields each algorithm's summary line reports
SUMMARY_FIELDS = {"flow_pred": ("latent_dim",), "flow_learner": ("flow_max", "radius", "levels"),
                  "matrix_flow": ("goal", "radius", "cols"),
                  "frame_generator": ("timesteps", "sampling_timesteps"), "flow_completer": ()}

# the fields of FlowDiffuserConfig that the model flags set
MODEL_FIELDS = ("target", "noiser", "is_diffusion", "flow_weight", "diffusion_flow_weight",
                "latent", "ae", "latent_dim")


def model_config(algorithm: str = "flow_diffuser", **fields):
    """The algorithm's config: the flagship's (or the yaml's of another
    algorithm, ``BASES``) with the given fields replaced; a field given as
    None keeps its default (FlowLearner's ``radius`` drops its
    ``flow_max``)."""
    base = BASES.get(algorithm, FLAGSHIP)
    fields = {k: v for k, v in fields.items() if v is not None}
    if algorithm == "flow_learner" and "radius" in fields:
        fields.setdefault("flow_max", None)
    return dataclasses.replace(base, **fields)


def parse_image_size(value):
    """``--image-size``: one side (an int) or the yaml's "W,H" (a string);
    None stays None."""
    if value is None or isinstance(value, int):
        return value
    parts = [int(v) for v in str(value).split(",")]
    return parts[0] if len(parts) == 1 else f"{parts[0]},{parts[1]}"


def data_config(dataset: str, image_size=None, data_root=None, size=None, seed=0,
                val_length=None, max_motion=None):
    """The dataset's config: the artificial one at one side (``size`` items
    drawn from ``seed``), the video one likewise (with ``val_length`` and
    ``max_motion``), or a real dataset's yaml with ``image_size`` ("W,H" or
    one side for both) and ``root`` replaced where given."""
    if dataset == "taichi":
        get_dataset(dataset)                        # raises: not ported yet
    if dataset not in DATASETS:
        raise ValueError(f"dataset {dataset!r} is not one of {DATASETS}")
    base = DATA[dataset]
    if dataset == "artificial_video":
        fields = dict(image_size=image_size, size=size, val_length=val_length,
                      max_motion=max_motion)
        return dataclasses.replace(base, seed=seed,
                                   **{k: v for k, v in fields.items() if v is not None})
    if dataset == "artificial":
        if isinstance(image_size, str):
            w, h = (int(v) for v in image_size.split(","))
            if w != h:
                raise ValueError(f"the artificial dataset is square, not {image_size}")
            image_size = w
        return dataclasses.replace(base, image_size=image_size or base.image_size,
                                   size=size or base.size, seed=seed)
    if image_size is not None:
        image_size = image_size if isinstance(image_size, str) else f"{image_size},{image_size}"
        base = dataclasses.replace(base, image_size=image_size)
    return dataclasses.replace(base, root=data_root) if data_root else base


def build(steps: int, batch=None, image_size=None, unet_dim=None,
          seed: int = 0, device: str = "cuda", out: str = "outputs/train",
          check_interval=None, ckpt_every=None, val_batch=None,
          sampling_timesteps=None, log_every=None,
          conv_backend: str = "cudnn", remat: bool = False, algorithm: str = "flow_diffuser",
          precision=None, lr=None, flow_max=None, dataset_size=None, dataset_seed=None,
          dataset=None, data_root=None, workers=None, ckpt_path=None,
          epochs=None, profile_step=None, val_length=None, max_motion=None,
          **model):
    """The experiment of one run, not yet trained.  ``model`` holds config
    fields of the algorithm (``MODEL_FIELDS``; FlowPred's ``latent_dim``;
    FlowLearner's ``radius`` and ``levels``; MatrixFlow's ``goal``,
    ``radius`` and ``cols``; FrameGenerator's ``timesteps``; the CLI sets
    ``goal`` and ``radius``).
    ``image_size`` is one side or "W,H"; the algorithm takes W (MatrixFlow
    both).  The experiment is the algorithm's (``ALGORITHMS``), the dataset
    defaults to the experiment's (artificial, or artificial_video)."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm {algorithm!r} is not one of {tuple(ALGORITHMS)}")
    experiment = ALGORITHMS[algorithm]
    exp_cls, train_base = EXPERIMENTS[experiment]
    dataset = dataset or ("artificial_video" if experiment == "animation" else "artificial")
    image_size = parse_image_size(image_size)
    data = data_config(dataset, image_size if dataset != "artificial_video" else (
        None if image_size is None else int(str(image_size).split(",")[0])), data_root,
        dataset_size, seed if dataset_seed is None else dataset_seed, val_length, max_motion)
    side = (int(str(data.image_size).split(",")[0])
            if dataset != "artificial" or image_size is not None else None)
    common = dict(image_size=side, conv_backend=conv_backend, precision=precision, lr=lr)
    if algorithm == "matrix_flow":
        # both sides: the filter's bound mask takes the frame's shape
        if image_size is not None:
            common["image_size"] = (image_size if isinstance(image_size, str)
                                    else f"{image_size},{image_size}")
        elif dataset != "artificial":
            common["image_size"] = data.image_size
        algo = model_config(algorithm, **common, **model)
    elif algorithm in ("flow_pred", "flow_completer"):
        algo = model_config(algorithm, **common, **model)
    elif algorithm == "frame_generator":
        algo = model_config(algorithm, **common, **model)
        algo = dataclasses.replace(algo, sampling_timesteps=sampling_timesteps)
    elif algorithm == "flow_learner":
        algo = model_config(algorithm, flow_max=flow_max, **common, **model)
    else:
        algo = model_config(algorithm, remat=remat, unet_dim=unet_dim, flow_max=flow_max,
                            **common, **model)
        algo = dataclasses.replace(algo, sampling_timesteps=sampling_timesteps)
    if dataset == "artificial":
        data = dataclasses.replace(data, image_size=int(str(algo.image_size).split(",")[0]))
    train = dataclasses.replace(
        train_base, batch_size=batch or train_base.batch_size, max_steps=steps, seed=seed,
        check_interval=check_interval or min(train_base.check_interval, steps),
        every_n_train_steps=ckpt_every or train_base.every_n_train_steps,
        val_batch_size=val_batch or train_base.val_batch_size,
        log_every=log_every or min(train_base.log_every, steps),
        num_workers=train_base.num_workers if workers is None else workers,
        epochs=train_base.epochs if epochs is None else epochs,
        profile_step=train_base.profile_step if profile_step is None else profile_step)
    return exp_cls(algo, train, data, out, device, algorithm, ckpt_path)


def add_model_flags(ap: argparse.ArgumentParser) -> None:
    """The flags of FlowDiffuser's configurations (and FlowPred's latent
    width), shared with ``sample.py``."""
    ap.add_argument("--target", choices=TARGETS, default=None)
    ap.add_argument("--noiser", choices=("image", "flow"), default=None)
    ap.add_argument("--no-diffusion", action="store_true",
                    help="the single-forward model (is_diffusion: false)")
    ap.add_argument("--flow-weight", type=float, default=None)
    ap.add_argument("--diffusion-flow-weight", type=float, default=None)
    ap.add_argument("--latent", action="store_true",
                    help="run on the latents of a frozen Autoencoder")
    ap.add_argument("--ae", default=None,
                    help="output directory of a flow_pred run holding the Autoencoder")
    ap.add_argument("--latent-dim", type=int, default=None)


def model_flags(a: argparse.Namespace) -> dict:
    """The config fields that the model flags set (None: the default)."""
    algorithm = getattr(a, "algorithm", "flow_diffuser")
    if algorithm == "flow_pred":
        return {"latent_dim": a.latent_dim}
    if algorithm == "matrix_flow":
        return {"goal": a.goal, "radius": a.radius}
    if algorithm in ("frame_generator", "flow_completer"):
        return {}
    if algorithm == "flow_learner":
        levels = getattr(a, "levels", None)
        return {"radius": getattr(a, "radius", None),
                "levels": tuple(int(v) for v in levels.split(",")) if levels else None}
    return {"target": a.target, "noiser": a.noiser,
            "is_diffusion": False if a.no_diffusion else None, "flow_weight": a.flow_weight,
            "diffusion_flow_weight": a.diffusion_flow_weight,
            "latent": True if a.latent else None, "ae": a.ae, "latent_dim": a.latent_dim}


def run(steps: int, resume: bool = False, tasks=("train",), **kwargs) -> dict:
    """Build, restore when ``resume`` (or from ``ckpt_path``), run ``tasks``
    in order; the summary line."""
    exp = build(steps, **kwargs)
    start = exp.restore() if (resume or exp.ckpt_path is not None) and "train" in tasks else 0
    t0 = time.perf_counter()
    train = {}
    for task in tasks:
        res = exp.exec_task(task)
        if task == "train":
            train = res
            if exp.device.type == "cuda":
                torch.cuda.synchronize(exp.device)
            seconds = time.perf_counter() - t0
    trained = "train" in tasks
    cfg = exp.algo_cfg
    fields = SUMMARY_FIELDS.get(exp.algorithm.name, MODEL_FIELDS + ("flow_max",))
    return {
        "device": str(exp.device),
        "algorithm": exp.algorithm.name,
        "experiment": type(exp).__name__,
        "dataset": exp.dataset_name,
        "tasks": list(tasks),
        "batch": exp.cfg.batch_size,
        "image_size": cfg.image_size,
        "data_image_size": exp.data_cfg.image_size,
        "unet_dim": getattr(cfg, "unet_dim", None),
        "conv_backend": cfg.conv_backend,
        "remat": getattr(cfg, "remat", False),
        "precision": cfg.precision,
        "lr": cfg.lr,
        "dataset_size": getattr(exp.data_cfg, "size", None),
        "dataset_seed": getattr(exp.data_cfg, "seed", None),
        "workers": exp.train_loader.num_workers,
        **{k: list(v) if isinstance(v, tuple) else v for k, v in
           ((k, getattr(cfg, k)) for k in fields)},
        "start_step": start,
        "step": exp.state.step,
        "checkpoints": exp.ckpt.steps(),
        "seconds": seconds if trained else None,
        "samples_per_s": ((exp.state.step - start) * exp.cfg.batch_size / seconds
                          if trained else None),
        "train": train,
        "val": exp.last_val,
        "test": exp.last_test,
        "images": sorted(exp.images),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20, help="train steps in all")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"default the experiment's ({MATRIX_FLOW.batch_size}, animation "
                         f"{ANIMATION.batch_size})")
    ap.add_argument("--image-size", default=None,
                    help="one side, or W,H (a real dataset's; the algorithm takes W)")
    ap.add_argument("--unet-dim", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="outputs/train")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint under --out")
    ap.add_argument("--check-interval", type=lambda v: float(v) if "." in v else int(v),
                    default=None, help="steps, or a fraction of an epoch (0.5)")
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--val-batch", type=int, default=None)
    ap.add_argument("--sampling-timesteps", type=int, default=None)
    ap.add_argument("--conv-backend", choices=BACKENDS, default="cudnn")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the UnetWithWarp closure in the backward")
    ap.add_argument("--algorithm", choices=tuple(ALGORITHMS), default="flow_diffuser")
    add_model_flags(ap)
    ap.add_argument("--radius", type=int, default=None,
                    help="FlowLearner's filter representation (drops its flow_max); "
                         "MatrixFlow's filter size")
    ap.add_argument("--goal", choices=GOALS, default=None, help="MatrixFlow's training goal")
    ap.add_argument("--levels", default=None,
                    help="FlowLearner's pyramid levels, comma-separated")
    ap.add_argument("--precision", choices=("bf16", "float32"), default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--flow-max", type=float, default=None)
    ap.add_argument("--dataset-size", type=int, default=None)
    ap.add_argument("--dataset-seed", type=int, default=None)
    ap.add_argument("--dataset", choices=DATASETS + ("taichi",), default=None,
                    help="default the experiment's (artificial, animation: artificial_video)")
    ap.add_argument("--val-length", type=int, default=None,
                    help="artificial_video's transitions a validation item")
    ap.add_argument("--max-motion", type=int, default=None,
                    help="artificial_video's largest motion, px a frame")
    ap.add_argument("--data-root", default=None,
                    help="the datasets' root (default $OFD_DATA_ROOT, else datasets)")
    ap.add_argument("--workers", type=int, default=None,
                    help=f"loader threads (default {MATRIX_FLOW.num_workers}, capped at the "
                         "CPU count)")
    ap.add_argument("--tasks", default="train", help="comma list of train, test")
    ap.add_argument("--ckpt-path", default=None,
                    help="restore from this run's (or checkpoints, or step) directory")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--profile-step", type=int, default=None,
                    help="trace this step with torch.profiler into --out/profile")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.steps, a.resume, tuple(a.tasks.split(",")), batch=a.batch,
                         image_size=a.image_size,
                         unet_dim=a.unet_dim, seed=a.seed, device=a.device, out=a.out,
                         check_interval=a.check_interval, ckpt_every=a.ckpt_every,
                         val_batch=a.val_batch, sampling_timesteps=a.sampling_timesteps,
                         conv_backend=a.conv_backend, remat=a.remat, algorithm=a.algorithm,
                         precision=a.precision, lr=a.lr, flow_max=a.flow_max,
                         dataset_size=a.dataset_size, dataset_seed=a.dataset_seed,
                         dataset=a.dataset, data_root=a.data_root, workers=a.workers,
                         ckpt_path=a.ckpt_path, epochs=a.epochs, profile_step=a.profile_step,
                         val_length=a.val_length,
                         max_motion=a.max_motion, **model_flags(a))))


if __name__ == "__main__":
    main()
