"""MPI-Sintel three frames and the ground-truth flow (JAX
``data/sintel.py``), read without cv2 (``data/png.py``, ``data/resize.py``).

The index follows ``Sintel.dat`` / ``Sintel_split.dat`` where both exist
(split 1 training, 2 validation), else scans
``training/clean/<scene>/frame_%04d.png`` with ``training/flow/<scene>``,
every middle frame whose position in its scene is a multiple of 10 going to
validation.  The split is ``training`` or ``validation``: JAX asserts so,
and its ``test`` task therefore raises on Sintel; so does this reader.

Emits (frame1, frame2, frame3, flow): the frames resized to ``image_size``
(W,H), in [0, 1] and ImageNet-normalised unless ``normalize`` is false; the
flow (dx, dy) resized without rescaling its magnitude unless ``scale_flow``
(as JAX keeps the reference's).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .flow_io import read_flo
from .png import imread
from .resize import resize

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def image_size(cfg):
    """[W, H] of a dataset config's ``image_size`` ("W,H" or one side)."""
    return [int(x) for x in str(cfg.image_size).split(",")]


def _data_root(cfg, default_subdir: str) -> Path:
    root = getattr(cfg, "root", None) or os.environ.get("OFD_DATA_ROOT", "datasets")
    p = Path(root)
    return p if p.name == default_subdir else p / default_subdir


class SintelDataset:
    def __init__(self, cfg, split: str = "training"):
        self.cfg = cfg
        self.imsz = image_size(cfg)
        self.split = split
        assert split in ("training", "validation"), "Split must be training or validation"
        self.normalize = bool(getattr(cfg, "normalize", True))
        self.scale_flow = bool(getattr(cfg, "scale_flow", False))

        base = _data_root(cfg, "MPI_Sintel")
        path_file = base / "Sintel.dat"
        split_file = base / "Sintel_split.dat"
        self.split_paths = []
        if path_file.exists() and split_file.exists():
            path_content = [line.strip().split() for line in open(path_file)]
            split_content = [line.strip().split() for line in open(split_file)]
            want = "1" if split == "training" else "2"
            for i, row in enumerate(path_content):
                if split_content[i][0] != want:
                    continue
                frame_num = int(row[2])
                flow_path = str(base) + "/" + (row[1][7:] % frame_num)
                png = row[0][7:]
                self.split_paths.append([
                    str(base) + "/" + (png % (frame_num - 1)),
                    str(base) + "/" + (png % frame_num),
                    str(base) + "/" + (png % (frame_num + 1)),
                    flow_path,
                ])
        else:
            clean = base / "training" / "clean"
            flow_dir = base / "training" / "flow"
            if clean.exists():
                for scene in sorted(os.listdir(clean)):
                    frames = sorted((clean / scene).glob("frame_*.png"))
                    for i in range(1, len(frames) - 1):
                        num = int(frames[i].stem.split("_")[1])
                        flo = flow_dir / scene / f"frame_{num:04d}.flo"
                        if not flo.exists():
                            continue
                        rec = [str(frames[i - 1]), str(frames[i]), str(frames[i + 1]), str(flo)]
                        is_val = (i % 10) == 0
                        if (split == "training") != is_val:
                            self.split_paths.append(rec)
        if not self.split_paths:
            raise FileNotFoundError(
                f"No Sintel data found under {base}; set dataset.root or OFD_DATA_ROOT")

    def __len__(self) -> int:
        return len(self.split_paths)

    def _load_image(self, path) -> np.ndarray:
        img = resize(imread(path), (self.imsz[0], self.imsz[1]))
        img = img.astype(np.float32) / 255.0
        if self.normalize:
            img = (img - IMAGENET_MEAN) / IMAGENET_STD
        return img

    def __getitem__(self, idx: int):
        p1, p2, p3, pf = self.split_paths[idx]
        flow = read_flo(pf)
        h0, w0 = flow.shape[:2]
        flow = resize(flow, (self.imsz[0], self.imsz[1]))
        if self.scale_flow:
            flow = flow * np.asarray([self.imsz[0] / w0, self.imsz[1] / h0], np.float32)
        return (self._load_image(p1), self._load_image(p2), self._load_image(p3),
                flow.astype(np.float32))


__all__ = ["SintelDataset", "image_size"]
