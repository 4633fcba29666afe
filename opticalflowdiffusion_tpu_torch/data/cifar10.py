"""CIFAR-10 (JAX ``data/cifar10.py``): the ``cifar-10-batches-py`` pickles
read from the dataset root (``data/sintel.py::_data_root``: ``cfg.root``,
else ``$OFD_DATA_ROOT``, else ``datasets``; nothing is downloaded).

The training split is ``data_batch_1`` to ``data_batch_5`` with the
reference's augmentation (a 32x32 crop of the image padded by 4 with zeros,
then a horizontal flip at probability 1/2), drawn from
``numpy.random.default_rng(0)`` in JAX's order (the crop's two offsets,
then the flip's coin), so the crops and flips equal JAX's bit for bit for
the same sequence of reads; ``test`` and ``validation`` are ``test_batch``,
unaugmented.  Every item is normalised by the per-channel ``MEAN`` and
``STD`` and emitted as (image (32, 32, 3) float32, label int32).  The
pickles are the dataset's own format: read only a tree you trust.
"""

from __future__ import annotations

import pickle

import numpy as np

from .sintel import _data_root

MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
STD = np.asarray([0.2023, 0.1994, 0.2010], np.float32)

classes = (
    "plane", "car", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)


class CIFAR10Dataset:
    def __init__(self, cfg, split: str = "training"):
        self.cfg = cfg
        self.train = split == "training"
        if split not in ("training", "test", "validation"):
            raise ValueError(f"split {split} not available for cifar10")
        base = _data_root(cfg, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if self.train else ["test_batch"]
        images, labels = [], []
        for f in files:
            p = base / f
            if not p.exists():
                raise FileNotFoundError(
                    f"CIFAR-10 batch {p} not found; set the dataset's root or OFD_DATA_ROOT")
            with open(p, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            images.append(d[b"data"])
            labels += list(d[b"labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.images = data.transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        self.labels = np.asarray(labels, np.int32)
        self._rng = np.random.default_rng(0)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int):
        img = self.images[idx]
        if self.train:
            # RandomCrop(32, padding=4) + RandomHorizontalFlip
            padded = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="constant")
            y, x = self._rng.integers(0, 9, size=2)
            img = padded[y: y + 32, x: x + 32]
            if self._rng.random() < 0.5:
                img = img[:, ::-1]
        img = (img - MEAN) / STD
        return img.astype(np.float32), self.labels[idx]


__all__ = ["CIFAR10Dataset", "MEAN", "STD", "classes"]
