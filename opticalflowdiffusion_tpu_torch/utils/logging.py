"""Run logger (JAX ``utils/logging.py::RunLogger`` without its wandb sink):
scalars as JSON lines, images as PNG files.

    out_dir/metrics.jsonl                 one JSON object per log_dict call
    out_dir/images/<key>/step_<n>.png     one image (a batch as a grid)
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np

from . import visualization as viz


class RunLogger:
    def __init__(self, out_dir):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.out_dir / "metrics.jsonl"

    def log_dict(self, metrics: Dict, step: int) -> dict:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        return record

    def log_image(self, key: str, images, step: int) -> Path:
        """images: (B, H, W, C) or (H, W, C) floats in [0, 1] (a batch tiled
        into one grid)."""
        d = self.out_dir / "images" / key
        d.mkdir(parents=True, exist_ok=True)
        img = np.asarray(images)
        if img.ndim == 3:
            img = img[None]
        path = d / f"step_{int(step):08d}.png"
        viz.save_image(img, path)
        return path

    def log_video(self, key: str, frames, step: int) -> Path:
        """frames: (T, H, W, C), written as a horizontal filmstrip."""
        strip = np.concatenate(list(np.asarray(frames)), axis=1)
        return self.log_image(key, strip[None], step)


__all__ = ["RunLogger"]
