"""The spread of chip_smoke.py's train-step check over seeds, on an H100.

chip_smoke.py holds one 128x128 b16 bf16 train step with every kernel to
the same step with every plain version (``step_vs_plain``, pins
``TOL_TRAIN``), at one seed.  The random-weight flagship's loss is so
sensitive that a few flipped bf16 roundings move it by ~1e-4-1e-3 of its
value, so one seed is one draw.  This script runs the same check at
``--seeds`` seeds (weights and batch), under both conv backends, each case
``--reps`` times, and prints one JSON line per case and a summary: the
largest and mean loss difference per backend, and whether the repeats gave
the same numbers.

``--configs`` runs instead the check of FlowDiffuser's other
configurations and of FlowPred (``config_step_vs_plain``, chip_smoke.py's
``CONFIGS``; the latent model with its Autoencoder drawn from the seed) at
each seed, once, and prints the largest loss and gradient differences per
configuration against the flagship's pins.

``--learner`` runs instead FlowLearner's check (``learner_step_vs_plain``
at 128x128 b16, the reference's ten pyramid levels, f32 and bf16, at
``flow_max`` 20 and at parity's 2) at each seed, ``--reps`` times, with no
pin and without the checks on the step's own inputs, and prints the
largest loss and gradient differences per precision and flow_max against
chip_smoke.py's ``TOL_LEARNER``.

``--splat-sums float32`` takes the plain splat's sums in float32, whose GPU
atomics sum in a varying order (chip_smoke.py's reference before it took
them in float64), to show what that order does to the reference.

Usage (from the root of a checkout, one card)::

    python3 chip_train_spread.py [--seeds 5] [--reps 2] [--splat-sums float64]
    python3 chip_train_spread.py --configs [--seeds 5]
    python3 chip_train_spread.py --learner [--seeds 5] [--reps 1]
"""

import argparse
import json

import numpy as np

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--splat-sums", choices=("float64", "float32"), default="float64")
    ap.add_argument("--configs", action="store_true",
                    help="the other configurations' train-step check instead")
    ap.add_argument("--learner", action="store_true",
                    help="FlowLearner's train-step check instead")
    args = ap.parse_args()
    cs.device_phase()
    cs.build_phase()
    if args.configs:
        return configs_spread(args.seeds)
    if args.learner:
        return learner_spread(args.seeds, args.reps)
    if args.splat_sums == "float32":
        raw = cs.sp.splat_raw
        cs.sp.splat_raw = lambda *a, acc_dtype=None, **k: raw(*a, **k)

    rows = []

    def phase(name, **kw):
        if name == "train_step_vs_plain":
            rows.append(kw)

    cs.phase = phase
    for seed in range(args.seeds):
        cs.SEED = seed
        batch = cs.train_batch(seed)
        for backend in ("cudnn", "fold"):
            for rep in range(args.reps):
                try:
                    cs.step_vs_plain("bf16", batch, backend)
                    ok = True
                except AssertionError:
                    ok = False
                r = rows[-1]
                cs.emit({"case": "train_step_vs_plain", "seed": seed, "conv_backend": backend,
                         "rep": rep, "splat_sums": args.splat_sums, "within_pins": ok,
                         "loss_rel": r["loss_rel"], "grad_global_rel": r["grad_global_rel"],
                         "loss": r["loss"], "plain_loss": r["plain_loss"]})
    summary = {}
    for backend in ("cudnn", "fold"):
        rel = [r["loss_rel"] for r in rows if r["conv_backend"] == backend]
        per_case = [rel[i:i + args.reps] for i in range(0, len(rel), args.reps)]
        summary[backend] = {"loss_rel_max": max(rel), "loss_rel_mean": float(np.mean(rel)),
                            "over_pin": sum(x > cs.TOL_TRAIN["bf16"][0] for x in rel),
                            "cases": len(rel),
                            "repeats_equal": all(len(set(c)) == 1 for c in per_case)}
    cs.emit({"summary": summary, "splat_sums": args.splat_sums, "seeds": args.seeds,
             "reps": args.reps, "pin": cs.TOL_TRAIN["bf16"][0]})


def configs_spread(seeds):
    """config_step_vs_plain over ``seeds`` for every configuration and
    FlowPred, with no pin; a summary per configuration."""
    out = {}
    for seed in range(seeds):
        cs.SEED = seed
        batch = cs.train_batch(seed)
        algos = [("flow_pred", lambda: cs.FlowPred(cs.FLOW_PRED, device="cuda",
                                                    generator=cs.torch.Generator().manual_seed(seed)))]
        algos += [(label, lambda f=fields: cs.config_algo(f, seed=seed))
                  for label, fields in cs.CONFIGS]
        for label, make in algos:
            algo = make()
            loss_rel, grad_rel = cs.config_step_vs_plain(algo, label, batch,
                                                         tol=(float("inf"), float("inf")),
                                                         capture=False)
            del algo
            cs.emit({"case": "config_train_step_vs_plain", "config": label, "seed": seed,
                     "loss_rel": loss_rel, "grad_global_rel": grad_rel})
            out.setdefault(label, []).append((loss_rel, grad_rel))
    cs.emit({"summary": {label: {"loss_rel_max": max(r[0] for r in rows),
                                 "grad_global_rel_max": max(r[1] for r in rows)}
                         for label, rows in out.items()},
             "seeds": seeds, "pins": cs.TOL_TRAIN["bf16"]})


def learner_spread(seeds, reps):
    """learner_step_vs_plain over ``seeds`` (weights and batch), f32 and
    bf16, at flow_max 20 and 2, ``reps`` times each, with no pin; a summary
    per precision and flow_max."""
    out = {}
    for seed in range(seeds):
        cs.SEED = seed
        batch = cs.train_batch(seed)
        for precision in cs.LEARNER_PRECISIONS:
            for flow_max in (cs.FLOW_LEARNER.flow_max, cs.LEARNER_FLOW_MAX_SMALL):
                for rep in range(reps):
                    loss_rel, grad_rel = cs.learner_step_vs_plain(
                        precision, batch, tol=(float("inf"), float("inf")), capture=False,
                        flow_max=flow_max)
                    cs.emit({"case": "learner_train_step_vs_plain", "precision": precision,
                             "flow_max": flow_max, "seed": seed, "rep": rep,
                             "loss_rel": loss_rel, "grad_global_rel": grad_rel})
                    out.setdefault(f"{precision}_flow_max{flow_max:g}", []).append(
                        (loss_rel, grad_rel))
    cs.emit({"summary": {p: {"loss_rel_max": max(r[0] for r in rows),
                             "grad_global_rel_max": max(r[1] for r in rows)}
                         for p, rows in out.items()},
             "seeds": seeds, "reps": reps,
             "pins": cs.TOL_LEARNER})


if __name__ == "__main__":
    main()
