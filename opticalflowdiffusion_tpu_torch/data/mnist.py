"""MNIST (JAX ``data/mnist.py``): the IDX files under ``<root>/MNIST``, raw
or gzip-compressed, named ``train-images-idx3-ubyte`` or
``train-images.idx3-ubyte`` (``t10k-`` for any split but training).  Items
are (image (28, 28, 1) float32 in [0, 1], label int32).  No experiment
reads it, as in JAX."""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

from .sintel import _data_root


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


class MNISTDataset:
    def __init__(self, cfg, split: str = "training"):
        base = _data_root(cfg, "MNIST")
        prefix = "train" if split == "training" else "t10k"
        img_path = lbl_path = None
        for suffix in ("-images-idx3-ubyte", "-images.idx3-ubyte"):
            for ext in ("", ".gz"):
                p = base / f"{prefix}{suffix}{ext}"
                if p.exists():
                    img_path = p
                    lbl = suffix.replace("images", "labels").replace("idx3", "idx1")
                    lbl_path = base / f"{prefix}{lbl}{ext}"
                    break
            if img_path:
                break
        if img_path is None:
            raise FileNotFoundError(f"No MNIST idx files under {base}")
        self.images = _read_idx(img_path).astype(np.float32)[..., None] / 255.0
        self.labels = _read_idx(lbl_path).astype(np.int32)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int):
        return self.images[idx], self.labels[idx]


__all__ = ["MNISTDataset"]
