"""FlyingChairs frame pairs and flow (JAX ``data/flying_chairs.py``), read
without cv2.

``data/NNNNN_img{1,2}.ppm`` and ``NNNNN_flow.flo`` with the official
train/val split file (``FlyingChairs_train_val.txt`` beside or inside
``FlyingChairs_release``) where it exists: 1 is training, 2 validation; a
split other than ``training`` reads validation.  Frames resized bilinearly
to ``image_size`` in [0, 1]; the flow resized nearest and rescaled to the
resized pixels.  Emits (img1, img2, flow) float32 NHWC, flow (dx, dy).
"""

from __future__ import annotations

import numpy as np

from .flow_io import read_flo
from .png import imread
from .resize import resize
from .sintel import _data_root, image_size


class FlyingChairsDataset:
    def __init__(self, cfg, split: str = "training"):
        self.cfg = cfg
        self.imsz = image_size(cfg)
        split = "train" if split == "training" else "val"
        base = _data_root(cfg, "FlyingChairs_release")
        data = base / "data"
        if not data.exists():
            raise FileNotFoundError(
                f"No FlyingChairs data under {base}; set dataset.root or OFD_DATA_ROOT")
        ids = sorted(p.stem.split("_")[0] for p in data.glob("*_flow.flo"))
        split_file = base.parent / "FlyingChairs_train_val.txt"
        if not split_file.exists():
            split_file = base / "FlyingChairs_train_val.txt"
        if split_file.exists():
            labels = [int(line.strip()) for line in open(split_file) if line.strip()]
            want = 1 if split == "train" else 2
            ids = [i for i, lab in zip(ids, labels) if lab == want]
        self.records = [(data / f"{i}_img1.ppm", data / f"{i}_img2.ppm", data / f"{i}_flow.flo")
                        for i in ids]

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int):
        p1, p2, pf = self.records[idx]
        img1, img2 = imread(p1), imread(p2)
        flow = read_flo(pf)
        h0, w0 = img1.shape[:2]
        W, H = self.imsz[0], self.imsz[-1]
        img1 = resize(img1, (W, H)).astype(np.float32) / 255.0
        img2 = resize(img2, (W, H)).astype(np.float32) / 255.0
        flow = resize(flow, (W, H), nearest=True)
        flow = flow * np.asarray([W / w0, H / h0], np.float32)
        return img1, img2, flow.astype(np.float32)


__all__ = ["FlyingChairsDataset"]
