"""Optical-flow file IO (JAX ``data/flow_io.py``): Middlebury ``.flo`` and
the KITTI 16-bit flow PNG, without cv2.  Flow arrays are (H, W, 2) float32
(dx, dy)."""

from __future__ import annotations

import numpy as np

from .png import imread

FLO_MAGIC = 202021.25


def read_flo(path) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        assert abs(float(magic) - FLO_MAGIC) < 1e-3, f"bad .flo magic in {path}"
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=h * w * 2)
    return data.reshape(h, w, 2)


def write_flo(path, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_kitti_png(path):
    """KITTI flow PNG: 16-bit RGB (u * 64 + 2^15, v * 64 + 2^15, valid).

    Returns (flow (H, W, 2) float32, valid (H, W) bool)."""
    raw = imread(path, anydepth=True).astype(np.float32)
    flow = (raw[..., :2] - 2 ** 15) / 64.0
    valid = raw[..., 2] > 0
    return flow, valid


__all__ = ["read_flo", "write_flo", "read_kitti_png", "FLO_MAGIC"]
