"""Build the hand-written CUDA kernels with a plain ``nvcc`` call.

Each ``.cu`` source in this directory exposes ``extern "C"`` launchers that
take raw device pointers, sizes and a ``cudaStream_t``.  It is compiled on
first use into ``_build/lib<name>-<hash>.so`` (``-O3``, ``sm_90a``, shared,
``-fPIC``) and loaded with ``ctypes``; the hash of the source names the
library, so an edited source is rebuilt.  No ninja, no pybind and no torch
headers are involved, so a build takes seconds.  Without ``nvcc`` the build
raises: there is no fallback.

Usage: ``python -m opticalflowdiffusion_tpu_torch.kernels.build`` builds
every source and prints each one's build time and ``ptxas`` report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
SOURCES = ("linear_attention", "flash_attention", "splat")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (KERNEL_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cu`` unless the library for its hash exists."""
    out = library_path(name)
    if out.exists():
        build_log.setdefault(name, {"seconds": 0.0, "cached": True, "ptxas": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(KERNEL_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_log[name] = {"seconds": seconds, "cached": False,
                       "ptxas": proc.stderr + proc.stdout}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def main() -> None:
    for name in SOURCES:
        load(name)
        log = build_log[name]
        print(f"{name}: {log['seconds']:.1f} s (cached={log['cached']})")
        print(log["ptxas"])


if __name__ == "__main__":
    main()
