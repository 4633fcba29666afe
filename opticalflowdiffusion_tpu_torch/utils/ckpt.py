"""Step checkpoints in the port's own format (the JAX package uses orbax).

One directory per step, ``<dir>/<step>/state.pt``: a ``torch.save`` of the
module's state_dict, the optimizer's state, the step and the training
generator's state.  A checkpoint is written to a temporary name and renamed,
so a directory that exists is complete.  ``every_n_train_steps`` sets the
cadence and the newest ``MAX_TO_KEEP`` are kept.  :func:`load_params_from_run`
reads a sub-tree of another run's newest checkpoint (the frozen Autoencoder
of the latent FlowDiffuser, JAX's ``load_params_from_run``).

The local artifact store (JAX's ``publish_artifact`` and
``download_latest_checkpoint``): :func:`publish_artifact` links a run's
``checkpoints`` directory under ``$OFD_ARTIFACT_ROOT`` (default
``outputs/artifacts``) by name, and :func:`resolve_artifact` finds a name
as a direct path, then in that store, then in the repository's bundled
``artifacts/``.  A bundled JAX artifact is an orbax checkpoint, which the
port does not read: it raises, naming the script that bridges it into a
port run (``tests/test_torch_port_raft.py --bridge`` for RAFT's,
``tests/test_torch_port_fid.py --bridge`` for ``classifier-feat``).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, Optional

import torch

FILE = "state.pt"
MAX_TO_KEEP = 3


class CheckpointManager:
    def __init__(self, directory, every_n_train_steps: int = 5000):
        self.directory = Path(directory).absolute()
        self.every_n = int(every_n_train_steps)

    def steps(self):
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state, generator: torch.Generator, extra: Optional[dict] = None) -> Path:
        """Write the checkpoint of ``state`` (a ``TrainState``) at its step,
        with the entries of ``extra`` beside it (the standalone trainer's
        ``ema``)."""
        step = int(state.step)
        final = self.directory / str(step)
        tmp = self.directory / f".tmp-{step}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save({
            "step": step,
            "module": state.module.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": generator.get_state(),
            **(extra or {}),
        }, tmp / FILE)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-MAX_TO_KEEP]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return final

    def maybe_save(self, state, generator: torch.Generator, force: bool = False) -> bool:
        step = int(state.step)
        if not force and (self.every_n <= 0 or step == 0 or step % self.every_n != 0):
            return False
        if step in self.steps():
            return False
        self.save(state, generator)
        return True

    def restore(self, state, generator: torch.Generator, step: Optional[int] = None) -> int:
        """Load the checkpoint of ``step`` (default: the newest) into
        ``state`` and ``generator``, bit for bit; returns the step."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        # loaded on the host: load_state_dict copies the module's tensors onto
        # its device and moves Adam's moments to the parameters' device, while
        # Adam's step counts stay on the host where it keeps them
        ck = torch.load(self.directory / str(step) / FILE, map_location="cpu", weights_only=True)
        state.module.load_state_dict(ck["module"])
        state.optimizer.load_state_dict(ck["optimizer"])
        state.step = int(ck["step"])
        generator.set_state(ck["generator"])
        return state.step


def load_params_from_run(run_dir, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The module state_dict entries under ``prefix`` (stripped) of the
    newest checkpoint of a port run, whose output directory is ``run_dir``."""
    mgr = CheckpointManager(Path(run_dir) / "checkpoints")
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
    ck = torch.load(mgr.directory / str(step) / FILE, map_location="cpu", weights_only=True)
    out = {k[len(prefix):]: v for k, v in ck["module"].items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"the checkpoint {mgr.directory / str(step)} holds no {prefix!r} entries")
    return out


BUNDLED = Path(__file__).resolve().parents[2] / "artifacts"
BRIDGE = "tests/test_torch_port_raft.py --bridge"
# the script that bridges each bundled JAX artifact into a port run
BRIDGES = {"classifier-feat": "tests/test_torch_port_fid.py --bridge"}


def artifact_root() -> Path:
    """The run-local artifact store: ``$OFD_ARTIFACT_ROOT`` or
    ``outputs/artifacts``."""
    return Path(os.environ.get("OFD_ARTIFACT_ROOT", "outputs/artifacts"))


def publish_artifact(name: str, src_ckpt_dir) -> Path:
    """Link the checkpoint directory ``src_ckpt_dir`` into the store as
    ``name`` (kept if the name exists, as in JAX)."""
    dst = artifact_root() / name
    dst.parent.mkdir(parents=True, exist_ok=True)
    if dst.is_symlink() or dst.exists():
        return dst
    dst.symlink_to(Path(src_ckpt_dir).absolute())
    return dst


def _is_orbax(path: Path) -> bool:
    return path.is_dir() and any((p / "_CHECKPOINT_METADATA").exists()
                                 for p in path.iterdir() if p.is_dir())


def resolve_artifact(name) -> Path:
    """The checkpoint directory of ``name``: a direct path, then the
    store, then the bundled ``artifacts/``; a run directory resolves to its
    ``checkpoints``.  An orbax (JAX) checkpoint raises."""
    for p in (Path(name), artifact_root() / str(name), BUNDLED / str(name)):
        if p.exists():
            break
    else:
        raise FileNotFoundError(f"checkpoint artifact {str(name)!r} not found (searched the "
                                f"path, {artifact_root()} and {BUNDLED})")
    if (p / "checkpoints").is_dir():
        p = p / "checkpoints"
    if _is_orbax(p):
        raise ValueError(
            f"{p} is a JAX (orbax) checkpoint, which the port does not read: write it as a "
            f"port run with `python {BRIDGES.get(Path(str(name)).name, BRIDGE)} OUT_DIR` on a "
            f"machine with JAX, then pass OUT_DIR")
    return p


def load_artifact(name) -> Dict[str, torch.Tensor]:
    """The module state_dict of the newest checkpoint of artifact ``name``."""
    mgr = CheckpointManager(resolve_artifact(name))
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
    ck = torch.load(mgr.directory / str(step) / FILE, map_location="cpu", weights_only=True)
    return ck["module"]


__all__ = ["BUNDLED", "CheckpointManager", "artifact_root", "load_artifact",
           "load_params_from_run", "publish_artifact", "resolve_artifact"]
