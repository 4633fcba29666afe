"""PWCLearner (JAX ``algorithms/pwc_learner.py``, reference
pwc_learner.py:10-121): unsupervised three-frame PWC-Net, NCHW.

The centre frame f2 against its past f1 and future f3 (``models/pwc_net.py``);
the loss is the level-weighted sum (``LEVEL_WEIGHTS``, finest first) of
``algorithms/losses.py::total_loss`` at each of the five pyramid levels,
with JAX's ``smoothness_weight`` and ``occ_weight`` knobs (1: the
reference's loss).  A pair batch (img, tgt, flow) takes its first frame as
the past one too.  Frames go in as the dataset gives them ([0, 1]); there
is no augmentation.  The weights are drawn from an explicit
``torch.Generator`` as flax's initialisers draw them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .base import compute_dtype
from .losses import total_loss
from ..config import PWCLearnerConfig
from ..models.pwc_net import PWCNet
from ..models.unet import init_weights
from ..utils import visualization as viz
from ..utils.grad_stats import tensor_stats

LEVEL_WEIGHTS = (0.005, 0.01, 0.02, 0.08, 0.32)  # pwc_learner.py:37


def three_frames(batch):
    """(f1, f2, f3, flow) of a 3-frame batch; a pair (img, tgt, flow)
    duplicates its first frame as the past frame."""
    if len(batch) == 4:
        return batch
    img, tgt, flow = batch
    return img, img, tgt, flow


class PWCLearner:
    """``device`` defaults to cuda; the weights are drawn from ``generator``;
    the module starts in eval mode (the trainer switches it)."""

    name = "pwc_learner"

    def __init__(self, cfg: PWCLearnerConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg.precision)
        self.smoothness_weight = float(cfg.smoothness_weight)
        self.occ_weight = float(cfg.occ_weight)
        self.module = PWCNet(self.dtype)
        init_weights(self.module, generator if generator is not None else torch.Generator())
        self.module.to(self.device).eval()

    def forward(self, batch):
        """PWCNet's five per-level lists on the centre frame."""
        f1, f2, f3, _ = three_frames(batch)
        return self.module(f2, [f1, f3])

    def loss(self, flow_fwd, flow_bwd, occ, warped_imgs, tar_ds) -> torch.Tensor:
        total = 0.0
        for i in range(len(flow_fwd)):
            total = total + LEVEL_WEIGHTS[i] * total_loss(
                tar_ds[i], warped_imgs[i][1], warped_imgs[i][0], flow_bwd[i], flow_fwd[i],
                occ[i], smoothness_weight=self.smoothness_weight, occ_weight=self.occ_weight)
        return total

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None):
        """(loss, metrics) of one training batch (no randomness)."""
        outs = self.forward(batch)
        return self.loss(*outs), tensor_stats("train/flow_fwd", outs[0][0])

    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(metrics, artifacts): the loss and the finest forward flow's EPE
        against the ground truth; the finest level's flows, occlusion,
        warped frames and target."""
        gt = three_frames(batch)[3]
        with torch.no_grad():
            flow_fwd, flow_bwd, occ, warped_imgs, tar_ds = self.forward(batch)
            loss = self.loss(flow_fwd, flow_bwd, occ, warped_imgs, tar_ds)
            epe = torch.sqrt((flow_fwd[0].float() - gt).square().sum(dim=1) + 1e-12).mean()
        metrics = {"val/loss": loss, "val/epe": epe}
        artifacts = {"flow_fwd": flow_fwd[0], "flow_bwd": flow_bwd[0], "occ": occ[0],
                     "warped_fwd": warped_imgs[0][0], "warped_bwd": warped_imgs[0][1],
                     "target": tar_ds[0]}
        return metrics, artifacts

    def visualize(self, batch, artifacts) -> Dict[str, np.ndarray]:
        """NHWC float images of one validation batch and its artifacts."""
        nhwc = lambda t: np.asarray(t.detach().float().cpu()).transpose(0, 2, 3, 1)
        f1, f2, f3, gt_flow = (nhwc(x) for x in three_frames(batch))
        fwd = viz.flow_to_image(nhwc(artifacts["flow_fwd"]))
        bwd = viz.flow_to_image(nhwc(artifacts["flow_bwd"]))
        gt = viz.flow_to_image(gt_flow)
        occ = nhwc(artifacts["occ"])
        wf = np.clip(nhwc(artifacts["warped_fwd"]), 0, 1)
        wb = np.clip(nhwc(artifacts["warped_bwd"]), 0, 1)
        recon = occ[..., 0:1] * wf + occ[..., 1:2] * wb
        return {
            "combined_frames": np.concatenate([f1, f2, f3], axis=2),
            "fwd_flow": np.concatenate([f2, f3, fwd], axis=2),
            "bwd_flow": np.concatenate([f1, f2, bwd], axis=2),
            "occlusions": occ[..., 0:1],
            "fwd_warped": np.concatenate([f2, f3, wf], axis=2),
            "bwd_warped": np.concatenate([f2, f1, wb], axis=2),
            "target": nhwc(artifacts["target"]),
            "gt_fwd_flow": np.concatenate([gt, fwd], axis=2),
            "reconstructed_comb": np.concatenate([f2, recon], axis=2),
        }


__all__ = ["LEVEL_WEIGHTS", "PWCLearner", "three_frames"]
