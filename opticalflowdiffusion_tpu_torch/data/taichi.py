"""TaiChi video frame pairs with their flow precomputed and cached (JAX
``data/taichi.py``, the reference's taichi.py:15-123), without PIL or cv2.

The reader scans ``<root>/taichi/<split>/<video>/<frame>`` (``validation``
reads ``test``), keeps a video when ``random.Random(14).random() <
scale_down`` (one draw a video, in sorted order), pairs each frame with
the one ``frame_distance`` later, and takes every ``mod``-th pair from
``rem`` (``mod="rem,mod"``, the reference's rank sharding).  A pair's flow
is read from ``<split>-flows2/<video>/<frame>.npy`` (only the split's own
path segment is renamed), channels-first caches (2, H, W) turned
channels-last.  Items: training (H, W, 8) = [second frame, first frame,
flow]; validation and test a stack of ``val_length`` items
``frame_distance`` apart (the last pair repeated past the end).

Frames are read by ``data/png.py`` (PNG or binary PPM, as RGB) and resized
by ``data/resize.py::resize_pil``, PIL's default ``Image.resize`` (BICUBIC)
bit for bit; a cached flow of another size goes through
``data/resize.py::resize``, cv2's float bilinear.

``calculate_flows`` writes the cache: the pairs in ``random.Random(0)``
order, ``flow_batch_size`` at a time, through the port's RAFT
(``flow_iters`` iterations, ``flow_corr_levels`` levels; the S4 lookup on
the card) on ``flow_device``, its last prediction saved (H, W, 2) as JAX's.
Its weights come from ``flow_checkpoint`` (a port run or a published
artifact, ``utils/ckpt.py::resolve_artifact``); without one the
precompute refuses to write untrained flows unless
``allow_untrained_flow``.
"""

from __future__ import annotations

import os
import random
import time
from pathlib import Path

import numpy as np
import torch

from . import png
from .resize import resize, resize_pil
from .sintel import _data_root


class TaiChiDataset:
    def __init__(self, cfg, split: str = "training", mod: str = "0,0"):
        if split == "validation":
            split = "test"
        self.cfg = cfg
        self.split = split
        self.image_size = int(cfg.image_size)

        base = _data_root(cfg, "taichi") / "taichi" / split
        self.first_frames, self.second_frames = [], []
        rng = random.Random(14)
        if base.exists():
            fd = int(cfg.frame_distance)
            for vid in sorted(os.listdir(base)):
                if rng.random() < float(cfg.scale_down):
                    frames = [str(f) for f in sorted((base / vid).iterdir())]
                    self.first_frames += frames[:-fd]
                    self.second_frames += frames[fd:]
        if not self.first_frames:
            raise FileNotFoundError(
                f"No TaiChi data under {base}; set the dataset's root or OFD_DATA_ROOT")

        rem, m = (int(x) for x in mod.split(","))
        if m != 0:
            self.first_frames = self.first_frames[rem::m]
            self.second_frames = self.second_frames[rem::m]

        if cfg.calculate_flows:
            self.calculate_flows(cfg)
        self.flows = [self._flow_cache_path(x) for x in self.first_frames]

    def _flow_cache_path(self, frame_path: str) -> str:
        """<split>/vid/frame -> <split>-flows2/vid/frame.npy, renaming only
        the last path segment that is the split."""
        parts = list(Path(frame_path).parts)
        idx = len(parts) - 1 - parts[::-1].index(self.split)
        parts[idx] = self.split + "-flows2"
        return str(Path(*parts)) + ".npy"

    # -- items ----------------------------------------------------------------
    def _load_frame(self, path) -> np.ndarray:
        img = resize_pil(png.imread(path), (self.image_size, self.image_size))
        return np.asarray(img, np.float32) / 255.0

    def __len__(self) -> int:
        return len(self.flows)

    def _item(self, index: int) -> np.ndarray:
        first = self._load_frame(self.first_frames[index])
        second = self._load_frame(self.second_frames[index])
        flow = np.load(self.flows[index]).astype(np.float32)
        if flow.shape[0] == 2:                      # a channels-first cache
            flow = flow.transpose(1, 2, 0)
        if flow.shape[0] != self.image_size:
            flow = resize(np.ascontiguousarray(flow), (self.image_size, self.image_size))
        return np.concatenate([second, first, flow], axis=-1)

    def __getitem__(self, index: int) -> np.ndarray:
        if self.split == "test":
            fd = int(self.cfg.frame_distance)
            items = [self._item(min(index + i * fd, len(self.flows) - 1))
                     for i in range(int(self.cfg.val_length))]
            return np.stack(items, axis=0)
        return self._item(index)

    # -- the precompute --------------------------------------------------------
    def calculate_flows(self, cfg) -> None:
        """Batched flow inference into the ``<split>-flows2`` cache."""
        if cfg.flow_method != "raft":
            raise NotImplementedError("Only raft flow precompute is supported")
        infer = self._build_raft_inference(cfg)
        bs = int(cfg.flow_batch_size)
        order = list(range(len(self.first_frames)))
        random.Random(0).shuffle(order)
        start = time.time()
        for bi in range(0, len(order), bs):
            idxs = order[bi: bi + bs]
            firsts = np.stack([self._load_frame(self.first_frames[i]) for i in idxs])
            seconds = np.stack([self._load_frame(self.second_frames[i]) for i in idxs])
            flows = infer(firsts, seconds)
            for j, i in enumerate(idxs):
                out = self._flow_cache_path(self.first_frames[i])
                Path(out).parent.mkdir(parents=True, exist_ok=True)
                np.save(out, flows[j])
            print(f"Calculating flows... {bi}/{len(order)} -- {time.time() - start:.1f}s",
                  end="\r")

    def _build_raft_inference(self, cfg):
        """``infer(firsts, seconds)``: (B, H, W, 2) numpy flows of (B, H, W,
        3) frame batches, RAFT's last prediction."""
        from ..models.raft import RAFT
        from ..models.unet import init_weights

        # the architecture must match the trained checkpoint's
        # (training/flow_pretrain.py): corr_levels sets the motion
        # encoder's input width, cut to what the frames' grid holds
        model = RAFT(iters=int(cfg.flow_iters), corr_levels=int(cfg.flow_corr_levels),
                     image_size=int(cfg.image_size))
        if cfg.flow_checkpoint:
            from ..utils.ckpt import load_artifact

            model.load_state_dict(load_artifact(cfg.flow_checkpoint))
        elif cfg.allow_untrained_flow:
            init_weights(model, torch.Generator().manual_seed(0))
            print("[taichi] WARNING: allow_untrained_flow=true; caching flows from UNTRAINED "
                  "RAFT weights (debug only)")
        else:
            # the cache is a persistent artifact that training trusts as the
            # ground truth: refuse to fill it with an untrained model's flows
            raise ValueError(
                "taichi flow precompute needs the dataset's flow_checkpoint (a trained "
                "flow-model artifact; see training/flow_pretrain.py). Set "
                "allow_untrained_flow=True only for debugging.")
        device = torch.device(cfg.flow_device)
        model.to(device).eval()

        def infer(first: np.ndarray, second: np.ndarray) -> np.ndarray:
            t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device)
            with torch.no_grad():
                flow = model(t(first), t(second))[-1]
            return flow.permute(0, 2, 3, 1).cpu().numpy()

        return infer


__all__ = ["TaiChiDataset"]
