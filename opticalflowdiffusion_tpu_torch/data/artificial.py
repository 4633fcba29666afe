"""Procedural moving-shapes dataset with exact integer ground-truth flow.

Numpy-only copy of the JAX package's ``data/artificial.py`` (its plain numpy
path), configured by :class:`~..config.ArtificialDataConfig`.  Items are HWC
float32 frames in [0, 1] and the flow ``(dx, dy)``, exactly as there;
:func:`..algorithms.base.to_batch` turns a list of items into NCHW tensors.
"""

from __future__ import annotations

import numpy as np

from ..config import ArtificialDataConfig


class ArtificialDataset:
    def __init__(self, cfg: ArtificialDataConfig):
        self.cfg = cfg
        self.image_size = int(cfg.image_size)
        self.size = int(cfg.size)
        rng = np.random.default_rng(cfg.seed if cfg.seed is not None else 14)

        S = self.image_size
        self.initial = (rng.random((self.size, 2)) * S).astype(np.int64)

        if cfg.shape == "boxes":
            self.wh = (rng.random((self.size, 2)) * S).astype(np.int64)
        elif cfg.shape == "squares":
            wh = (rng.random((self.size, 1)) * S).astype(np.int64)
            self.wh = np.tile(wh, (1, 2))
        elif cfg.shape == "pixel":
            self.wh = np.ones((self.size, 2), np.int64)
        elif cfg.shape == "2by1":
            self.wh = np.ones((self.size, 2), np.int64)
            self.wh[:, 0] = 2
        else:
            raise ValueError(f"unknown shape {cfg.shape}")

        self.max_motion = int(cfg.max_motion)
        m = self.max_motion
        self.flows = (rng.random((self.size, 2)) * (2 * m + 1)).astype(
            np.int64
        ) - m

    def _background(self) -> np.ndarray:
        S = self.image_size
        bg = np.ones((S, S, 3), np.float32)
        if self.cfg.bg == "checkers":
            bg[::2, ::2] = 0.2
            bg[::4, ::4] = 0.4
        return bg

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int):
        S = self.image_size
        m = self.max_motion
        bg = self._background()
        y0, x0 = self.initial[index]
        hh, ww = self.wh[index]
        fy, fx = self.flows[index]

        first = np.tile(bg, (2, 2, 1))
        first[y0 : y0 + hh, x0 : x0 + ww] = 0.0

        second = np.ones((2 * S + 2 * m, 2 * S + 2 * m, 3), np.float32)
        second[m:-m, m:-m] = np.tile(bg, (2, 2, 1))
        second[
            y0 + fy + m : y0 + fy + hh + m, x0 + fx + m : x0 + fx + ww + m
        ] = 0.0

        flow = np.zeros((2 * S, 2 * S, 2), np.float32)
        flow[y0 : y0 + hh, x0 : x0 + ww, 0] = fx
        flow[y0 : y0 + hh, x0 : x0 + ww, 1] = fy

        first = first[:S, :S]
        second = second[m : m + S, m : m + S]
        flow = flow[:S, :S]
        return first, second, flow


__all__ = ["ArtificialDataset"]
