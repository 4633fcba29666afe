"""Procedural constant-velocity video dataset with exact ground-truth flow
(JAX ``data/artificial_video.py``, a numpy copy: the same draws in the same
order, so its items equal JAX's bit for bit).

A black box over a white background moves with a constant integer velocity
per sequence, and stays in the frame for all ``val_length + 1`` frames.
Items are the TaiChi layout's channel stacks ``[target (3), last frame (3),
flow (2)]`` (HWC float32): a training item is one (H, W, 8) stack at a
random transition, a validation (or test) item the (val_length, H, W, 8)
stacks of consecutive transitions.  ``experiments/base.py::to_device``
turns them into (B, 8, H, W) and (B, T, 8, H, W) tensors.
"""

from __future__ import annotations

import numpy as np

from ..config import ArtificialVideoDataConfig


class ArtificialVideoDataset:
    def __init__(self, cfg: ArtificialVideoDataConfig, split: str = "training"):
        self.cfg = cfg
        self.image_size = int(cfg.image_size)
        self.size = int(cfg.size)
        self.split = split
        self.val_length = int(cfg.val_length)
        base = 21 if split == "training" else 1021
        rng = np.random.default_rng((cfg.seed if cfg.seed is not None else 0) + base)

        S = self.image_size
        m = int(cfg.max_motion)
        T = self.val_length + 1
        # the box's size, velocity (fy, fx) and start: in frame for all T + 1
        # frames, so the motion is exact (no wrap)
        self.wh = rng.integers(3, max(S // 3, 4), size=(self.size, 2))
        self.vel = rng.integers(-m, m + 1, size=(self.size, 2))
        lo = np.maximum(0, -self.vel * T)
        hi = np.maximum(lo + 1, S - self.wh - np.maximum(0, self.vel * T))
        self.p0 = (lo + rng.random((self.size, 2)) * (hi - lo)).astype(np.int64)
        self.t_train = rng.integers(0, T, size=self.size)

    def __len__(self) -> int:
        return self.size

    def _frame(self, i: int, t: int) -> np.ndarray:
        S = self.image_size
        y, x = self.p0[i] + t * self.vel[i]
        h, w = self.wh[i]
        img = np.ones((S, S, 3), np.float32)
        img[y: y + h, x: x + w] = 0.0
        return img

    def _flow(self, i: int, t: int) -> np.ndarray:
        """The forward flow (dx, dy) on frame t's pixels: the velocity on
        the box, 0 elsewhere."""
        S = self.image_size
        y, x = self.p0[i] + t * self.vel[i]
        h, w = self.wh[i]
        fy, fx = self.vel[i]
        flow = np.zeros((S, S, 2), np.float32)
        flow[y: y + h, x: x + w, 0] = fx
        flow[y: y + h, x: x + w, 1] = fy
        return flow

    def _stack(self, i: int, t: int) -> np.ndarray:
        """[target (3), last frame (3), flow (2)] of the transition t -> t+1."""
        return np.concatenate([self._frame(i, t + 1), self._frame(i, t), self._flow(i, t)],
                              axis=-1)

    def __getitem__(self, index: int):
        if self.split == "training":
            return (self._stack(index, int(self.t_train[index])),)
        return (np.stack([self._stack(index, t) for t in range(self.val_length)], axis=0),)


__all__ = ["ArtificialVideoDataset"]
