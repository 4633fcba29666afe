"""Native-layout synthetic fixture trees for the real-data readers (JAX
``data/fixtures.py``), written without cv2 (``data/png.py``).

* Sintel: ``MPI_Sintel/training/{clean,flow}/<scene>/frame_%04d.{png,flo}``
  at the native 1024x436.
* Chairs: ``FlyingChairs_release/data/NNNNN_{img1,img2,flow}.{ppm,flo}`` at
  the native 512x384, with ``FlyingChairs_train_val.txt``.
* KITTI: ``KITTI/<split>/training/{image_2,flow_occ}/%06d_1{0,1}.png`` at
  the native 1242x375, the ground truth sparse 16-bit with its validity
  channel.
* TaiChi: ``taichi/taichi/{training,test}/<video>/%04d.png`` frame
  directories (RGB PNGs, TaiChi's 256x256 by default), no flow cache (the
  precompute writes it).
* CIFAR-10: ``cifar-10-batches-py/{data_batch_1..5,test_batch}`` pickles
  (the test suite's ``_fake_cifar`` layout: random bytes and labels in the
  first training batch and the test batch, zeros in batches 2-5).

Scenes are textured boxes moving at constant integer velocities over a
textured background, with the exact forward flow.  The random draws are
JAX's, so a tree decodes to the arrays of the tree JAX's writer makes from
the same arguments.  PNG rows are written with the Sub filter, as cv2
writes these frames.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .flow_io import write_flo
from .png import write_png, write_ppm


def _texture(rng: np.random.Generator, h: int, w: int, cell: int = 16) -> np.ndarray:
    """Smooth random RGB texture: coarse noise nearest-upsampled (keeps
    gradients for edge-aware/photometric losses without cv2)."""
    ch, cw = max(h // cell, 1) + 1, max(w // cell, 1) + 1
    coarse = rng.integers(40, 216, size=(ch, cw, 3)).astype(np.uint8)
    return np.kron(coarse, np.ones((cell, cell, 1), np.uint8))[:h, :w]


def render_sequence(
    rng: np.random.Generator,
    w: int,
    h: int,
    n_frames: int,
    n_boxes: int = 6,
    max_motion: int = 16,
):
    """(frames uint8 [n](H,W,3), flows float32 [n-1](H,W,2) fwd (dx, dy)).

    Constant-velocity textured boxes over a static textured background;
    flow is the exact per-pixel motion of the TOP-MOST box at each pixel
    (later boxes draw over earlier ones, like real occlusion)."""
    bg = _texture(rng, h, w)
    boxes = []
    for _ in range(n_boxes):
        bh = int(rng.integers(h // 8, h // 3))
        bw = int(rng.integers(w // 8, w // 3))
        vx = int(rng.integers(-max_motion, max_motion + 1))
        vy = int(rng.integers(-max_motion // 2, max_motion // 2 + 1))
        x0 = int(rng.integers(0, max(w - bw, 1)))
        y0 = int(rng.integers(0, max(h - bh, 1)))
        boxes.append(dict(tex=_texture(rng, bh, bw, cell=8),
                          x=x0, y=y0, vx=vx, vy=vy, bh=bh, bw=bw))

    frames, flows = [], []
    for t in range(n_frames):
        img = bg.copy()
        flow = np.zeros((h, w, 2), np.float32)
        for b in boxes:
            x = b["x"] + t * b["vx"]
            y = b["y"] + t * b["vy"]
            xs, ys = max(x, 0), max(y, 0)
            xe, ye = min(x + b["bw"], w), min(y + b["bh"], h)
            if xe <= xs or ye <= ys:
                continue
            img[ys:ye, xs:xe] = b["tex"][ys - y : ye - y, xs - x : xe - x]
            flow[ys:ye, xs:xe, 0] = b["vx"]
            flow[ys:ye, xs:xe, 1] = b["vy"]
        frames.append(img)
        if t < n_frames - 1:
            # constant velocity: the flow field at frame t IS the forward
            # flow t -> t+1
            flows.append(flow)
    return frames, flows


def make_sintel_fixture(root, scenes: int = 2, frames: int = 8, size=(1024, 436),
                        seed: int = 0) -> Path:
    base = Path(root) / "MPI_Sintel"
    w, h = size
    rng = np.random.default_rng(seed)
    for s in range(scenes):
        clean = base / "training" / "clean" / f"scene_{s}"
        flow_d = base / "training" / "flow" / f"scene_{s}"
        clean.mkdir(parents=True, exist_ok=True)
        flow_d.mkdir(parents=True, exist_ok=True)
        imgs, flows = render_sequence(rng, w, h, frames)
        for i, img in enumerate(imgs):
            write_png(clean / f"frame_{i + 1:04d}.png", img, filters=1)
        for i, fl in enumerate(flows):
            write_flo(flow_d / f"frame_{i + 1:04d}.flo", fl)
    return base


def make_chairs_fixture(root, n: int = 8, size=(512, 384), seed: int = 0) -> Path:
    base = Path(root) / "FlyingChairs_release"
    data = base / "data"
    data.mkdir(parents=True, exist_ok=True)
    w, h = size
    rng = np.random.default_rng(seed)
    labels = []
    for i in range(1, n + 1):
        imgs, flows = render_sequence(rng, w, h, 2, n_boxes=4)
        write_ppm(data / f"{i:05d}_img1.ppm", imgs[0])
        write_ppm(data / f"{i:05d}_img2.ppm", imgs[1])
        write_flo(data / f"{i:05d}_flow.flo", flows[0])
        labels.append("1" if i % 4 else "2")  # official-style 1=train 2=val
    (base / "FlyingChairs_train_val.txt").write_text("\n".join(labels) + "\n")
    return base


def make_kitti_fixture(root, n: int = 6, size=(1242, 375), seed: int = 0,
                       valid_frac: float = 0.3) -> Path:
    w, h = size
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        base = Path(root) / "KITTI" / split / "training"
        img_d = base / "image_2"
        flow_d = base / "flow_occ"
        img_d.mkdir(parents=True, exist_ok=True)
        flow_d.mkdir(parents=True, exist_ok=True)
        for i in range(n if split == "train" else max(n // 2, 1)):
            imgs, flows = render_sequence(rng, w, h, 2, max_motion=32)
            write_png(img_d / f"{i:06d}_10.png", imgs[0], filters=1)
            write_png(img_d / f"{i:06d}_11.png", imgs[1], filters=1)
            # sparse ground truth: a random subset valid, KITTI's 16-bit
            # encoding (u * 64 + 2^15, v * 64 + 2^15, valid)
            valid = rng.random((h, w)) < valid_frac
            enc = np.zeros((h, w, 3), np.uint16)
            enc[..., 0] = np.clip(flows[0][..., 0] * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
            enc[..., 1] = np.clip(flows[0][..., 1] * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
            enc[..., 2] = valid.astype(np.uint16)
            write_png(flow_d / f"{i:06d}_10.png", enc, filters=1)
    return Path(root) / "KITTI"


def make_taichi_fixture(root, videos: int = 2, frames: int = 13, size: int = 256,
                        seed: int = 0, splits=("training", "test")) -> Path:
    """``videos`` clips of ``frames`` frames a split under
    ``<root>/taichi/taichi/<split>``, textured boxes at up to ``size`` / 32
    px a frame."""
    rng = np.random.default_rng(seed)
    base = Path(root) / "taichi" / "taichi"
    for split in splits:
        for v in range(videos):
            d = base / split / f"vid_{v:03d}"
            d.mkdir(parents=True, exist_ok=True)
            imgs, _ = render_sequence(rng, size, size, frames, max_motion=max(size // 32, 1))
            for i, img in enumerate(imgs):
                write_png(d / f"{i:04d}.png", img, filters=1)
    return Path(root) / "taichi"


def make_cifar10_fixture(root, train: int = 64, test: int = 16, seed: int = 0) -> Path:
    """A ``cifar-10-batches-py`` tree under ``root``: ``train`` random images
    in ``data_batch_1``, 8 black ones labelled 0 in each of batches 2-5,
    ``test`` random ones in ``test_batch``."""
    import pickle

    rng = np.random.default_rng(seed)
    base = Path(root) / "cifar-10-batches-py"
    base.mkdir(parents=True, exist_ok=True)
    for name, n in (("data_batch_1", train), ("test_batch", test)):
        with open(base / name, "wb") as f:
            pickle.dump({b"data": (rng.random((n, 3072)) * 255).astype(np.uint8),
                         b"labels": list(rng.integers(0, 10, n))}, f)
    for i in range(2, 6):
        with open(base / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": np.zeros((8, 3072), np.uint8), b"labels": [0] * 8}, f)
    return base


__all__ = ["render_sequence", "make_sintel_fixture", "make_chairs_fixture",
           "make_kitti_fixture", "make_taichi_fixture", "make_cifar10_fixture"]
