"""ctypes bindings of the readers' host helper (``data/host_ops.cpp``).

The source is compiled on first use into
``kernels/_build/libofd_host-<hash>.so``: with ``nvcc`` where the CUDA
toolkit is installed (it hands a ``.cpp`` to the host compiler, as for the
kernels' launchers), else with ``g++``.  A failed build raises; nothing
falls back to the numpy versions, which stay beside each entry point as
their plain references (``png.unfilter_plain``,
``kitti_single.inpaint_ns_plain``, ``resize.resize_plain``).  ctypes releases the GIL during a call,
so the loader's threads run the helpers side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
FLAGS = ("-O3", "-std=c++17", "-shared")
HOST_FLAGS = ("-fPIC", "-ffp-contract=off")

_lib = None
_lock = threading.Lock()


def _compiler() -> list:
    nvcc = shutil.which("nvcc") or ("/usr/local/cuda/bin/nvcc"
                                    if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    if nvcc is not None:
        return [nvcc, *FLAGS, "-Xcompiler", ",".join(HOST_FLAGS)]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("neither nvcc nor g++ found: the data readers' host helper "
                           "cannot be built")
    return [gxx, *FLAGS, *HOST_FLAGS]


def library_path(cmd) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(cmd[1:]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libofd_host-{digest}.so"


def load() -> ctypes.CDLL:
    """The helper library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cmd = _compiler()
        out = library_path(cmd)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([*cmd, "-o", tmp, str(SOURCE)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}):"
                                   f"\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.ofd_png_unfilter.restype = ctypes.c_int
        lib.ofd_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.ofd_inpaint_ns.restype = ctypes.c_int64
        lib.ofd_inpaint_ns.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                       ctypes.c_void_p]
        for name in ("ofd_resize_u8", "ofd_resize_f32"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def png_unfilter(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """The (height, stride) uint8 rows of a decompressed PNG image stream
    (each row a filter byte and ``stride`` bytes), unfiltered."""
    raw = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    if raw.size < height * (stride + 1):
        raise ValueError(f"PNG image data too short: {raw.size} bytes for {height} rows of "
                         f"{stride + 1}")
    out = np.empty((height, stride), np.uint8)
    rc = load().ofd_png_unfilter(raw.ctypes.data, height, stride, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"PNG row {-1 - rc} has an unknown filter type")
    return out


def inpaint_ns(img: np.ndarray, mask: np.ndarray, radius: float) -> np.ndarray:
    """``cv2.inpaint(img[..., c], mask, radius, cv2.INPAINT_NS)`` of each
    channel of a float32 (H, W) or (H, W, C) image, in one pass of the
    front; ``mask`` nonzero where the values are to be filled."""
    img = np.asarray(img, np.float32)
    planes = np.ascontiguousarray(img[None] if img.ndim == 2 else img.transpose(2, 0, 1))
    mask = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if mask.shape != planes.shape[1:]:
        raise ValueError(f"inpaint needs a mask of the image's (H, W), got {mask.shape} for "
                         f"{img.shape}")
    out = np.empty_like(planes)
    load().ofd_inpaint_ns(planes.ctypes.data, mask.ctypes.data, planes.shape[0],
                          planes.shape[1], planes.shape[2], float(radius), out.ctypes.data)
    return out[0] if img.ndim == 2 else out.transpose(1, 2, 0)


def resize_linear(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """``cv2.resize(img, (W, H))`` (``INTER_LINEAR``) of a uint8 or float32
    (h, w) or (h, w, C) image; ``resize._linear_u8`` and ``_linear_f32`` are
    the numpy versions."""
    img = np.ascontiguousarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"bilinear resize takes uint8 or float32, got {img.dtype}")
    h, w = img.shape[:2]
    if min(h, w, H, W) < 1 or img.ndim not in (2, 3):
        raise ValueError(f"cannot resize {img.shape} to ({H}, {W})")
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((H, W) + img.shape[2:], img.dtype)
    fn = load().ofd_resize_u8 if img.dtype == np.uint8 else load().ofd_resize_f32
    fn(img.ctypes.data, h, w, c, out.ctypes.data, H, W)
    return out


__all__ = ["inpaint_ns", "load", "png_unfilter", "resize_linear"]
