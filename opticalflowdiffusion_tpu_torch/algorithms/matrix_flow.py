"""MatrixFlow (JAX ``algorithms/matrix_flow.py``): optical flow as per-pixel
R x R filter matrices, NCHW.

A UNet maps the frame pair (6 channels, in [-1, 1]) to a per-pixel filter
over an R x R neighbourhood (or, for the goal ``gt_flow_pred``, straight to
a flow); the filter, normalised (``softmax``, ``mode`` or ``weighted_sum``),
gathers the first frame toward the second.  The goals: ``gt_flow_pred``
(the flow's MSE against the ground truth), ``filter_pred`` (the photometric
MSE plus five weighted regularisers) and ``gt_filter_pred`` (the inverted
filter's mean tap against the flow).

Packed channels: ``[fil (R*R), colweight (1), col (3)]`` (MatrixFlow's own
order, which ``ops/filters.py``'s ``[fil, col, colweight]`` is not); the
colour weight exists with ``cols`` set, the colours with ``cols: any``.
Pixels that a ``weighted_sum`` filter leaves without weight (a denominator
at most ``eps``) are NaN holes, filled from the first frame blurred by a
Gaussian of the filter's size.  A flow (2 channels) warps the first frame
backward, red where the footprint leaves the frame (``flow_in='second'``),
or forward through the splat's ``linear`` mode, red in the holes (the
``flow_in='first'`` debug path).

The reference's quirk, kept: with a colour weight (``cols`` set) the
filter goals' ``val_step`` raises, as JAX's does: the optimal filter it
builds from the flow has no colour-weight channel, which the split of
``apply_filter`` expects.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .base import compute_dtype, pair_batch
from ..config import MatrixFlowConfig
from ..models.unet import Unet, init_weights
from ..ops import filters as fops
from ..ops.warp import warp_backward_flow, warp_forward_flow
from ..utils import visualization as viz

# the UNet width, fixed in the JAX package
WIDTH = 64
GOALS = ("gt_flow_pred", "filter_pred", "gt_filter_pred")
# the reference's quirk, kept: JAX's branch cannot run
RAFT_ARCHITECTURE_ERROR = (
    "architecture {!r}: JAX's MatrixFlow builds RAFT(radius=R) and calls it with one "
    "6-channel tensor and None for the second frame (RAFT.init(x, None, None)), which fails "
    "in RAFT's feature net (AttributeError on None); RAFT's filter representation itself "
    "cannot run either (models/raft.py). Only architecture 'unet' trains")


def image_wh(image_size) -> Tuple[int, int]:
    """(W, H) of an ``image_size``: one side, or the yaml's "W,H"."""
    parts = [int(v) for v in str(image_size).split(",")]
    return parts[0], parts[-1]


def gaussian_blur(img: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, C, H, W) with reflect padding (numpy's
    and JAX's ``reflect``: the edge pixel not repeated), the taps summed in
    order along H, then along W."""
    xs = torch.arange(kernel_size, dtype=torch.float32, device=img.device) - (kernel_size - 1) / 2
    k = torch.exp(-0.5 * (xs / max(sigma, 1e-6)) ** 2)
    k = k / k.sum()
    pad = kernel_size // 2
    H, W = img.shape[2:]
    out = F.pad(img, (0, 0, pad, pad), mode="reflect")
    out = sum(out[:, :, i: i + H] * k[i] for i in range(kernel_size))
    out = F.pad(out, (pad, pad, 0, 0), mode="reflect")
    return sum(out[:, :, :, i: i + W] * k[i] for i in range(kernel_size))


def _red(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0], dtype=like.dtype, device=like.device).view(1, 3, 1, 1)


class MatrixFlow:
    """``device`` defaults to cuda; the weights are drawn from ``generator``;
    the module starts in eval mode (the trainer switches it)."""

    name = "matrix_flow"

    def __init__(self, cfg: MatrixFlowConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg.precision)
        self.image_w, self.image_h = image_wh(cfg.image_size)
        self.image_size = self.image_w
        self.radius = int(cfg.radius)
        if self.radius % 2 != 1:
            raise ValueError(f"radius must be odd, not {self.radius}")
        if cfg.goal not in GOALS:
            raise ValueError(f"goal {cfg.goal!r} is not one of {GOALS}")
        self.goal = cfg.goal
        self.eps = float(cfg.eps)
        if cfg.cols is not None:
            self.has = ["cols", "colweights"] if cfg.cols == "any" else ["colweights"]
        else:
            self.has = []
        if cfg.architecture != "unet":
            raise NotImplementedError(RAFT_ARCHITECTURE_ERROR.format(cfg.architecture))
        out_dim = 2 if self.goal == "gt_flow_pred" else (
            self.radius ** 2 + ("colweights" in self.has) + 3 * ("cols" in self.has))
        self.module = Unet(WIDTH, channels=6, out_dim=out_dim, time_in=False, dtype=self.dtype,
                           conv_backend=cfg.conv_backend)
        init_weights(self.module, generator if generator is not None else torch.Generator())
        self.module.to(self.device).eval()
        R = self.radius
        self._mask = fops.bound_mask(R, self.image_h, self.image_w, device=self.device).reshape(
            1, R * R, self.image_h, self.image_w)

    # -- filter ops ------------------------------------------------------------
    def _split(self, fil):
        """(taps, colweight or None, colours or None) of a packed filter."""
        R2 = self.radius ** 2
        colw = fil[:, R2: R2 + 1] if fil.shape[1] > R2 else None
        cols = fil[:, R2 + 1:] if fil.shape[1] > R2 + 1 else None
        return fil[:, :R2], colw, cols

    def apply_filter(self, fil, img, mode: str = "softmax", flow_in: str = "second"):
        """(the first frame ``img`` moved by ``fil``, the filter as applied):
        a packed filter normalised by ``mode`` (``softmax``, ``mode``,
        ``weighted_sum``, ``none``) and gathered, NaN holes filled from the
        blurred frame, plus colour weight times colour with ``cols: any``; or
        a flow (2 channels) warped backward (``flow_in='second'``) or forward
        (``'first'``), red where nothing lands."""
        R2 = self.radius ** 2
        if fil.shape[1] > 2:
            col = None
            if fil.shape[1] > R2 + 1:
                col = fil[:, -3:]
                fil = fil[:, :-3]
            elif fil.shape[1] > R2 and self.cfg.cols == "ones":
                col = torch.ones((fil.shape[0], 3) + fil.shape[2:], dtype=fil.dtype,
                                 device=fil.device)
            mask = self._mask.to(fil.dtype)
            if fil.shape[1] > R2:                   # the colour weight's channel
                mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
            if mode == "softmax":
                f = fil - fil.amax(dim=1, keepdim=True)
                f = (torch.exp(f) + self.eps) * mask
                fil = f / f.sum(dim=1, keepdim=True)
            elif mode == "mode":
                f = torch.exp(fil) * mask
                f = (f == f.amax(dim=1, keepdim=True)).to(fil.dtype)
                fil = f / f.sum(dim=1, keepdim=True)
            elif mode == "weighted_sum":
                denom = (fil[:, :R2] * mask[:, :R2]).sum(dim=1, keepdim=True)
                denom = torch.where(denom > self.eps, denom,
                                    torch.full_like(denom, float("nan")))
                fil = fil / denom
            elif mode != "none":
                raise ValueError(f"unknown filter mode {mode!r}")
            orig_fil = fil if col is None else torch.cat([fil, col], dim=1)
            if "colweights" in self.has:
                fil_w, colw = fil[:, :-1], fil[:, -1:]
            else:
                fil_w, colw = fil, None
            B = img.shape[0]
            fil5 = fil_w.reshape(B, self.radius, self.radius, self.image_h, self.image_w)
            applied = fops.apply_filter(img, fil5)
            # the NaN holes take the blurred frame
            bg = gaussian_blur(img, self.radius, self.radius // 2)
            applied = torch.where(torch.isnan(applied), bg, applied)
            if "cols" in self.has and col is not None:
                applied = applied + colw * col
            return applied, orig_fil
        if flow_in == "second":
            warped, m = warp_backward_flow(img, fil)
            return warped + _red(img) * (1 - m), fil
        warped = warp_forward_flow(img, fil, warp_style="avg", set_nans=True)
        return torch.where(torch.isnan(warped), _red(warped).expand_as(warped), warped), fil

    def invert_filter(self, fil):
        """The inverted taps, the colour weight negated, the colours kept."""
        taps, colw, cols = self._split(fil)
        parts = [fops.invert_taps(taps)]
        if colw is not None:
            parts.append(-colw)
        if cols is not None:
            parts.append(cols)
        return torch.cat(parts, dim=1)

    def vector_from_filter(self, fil):
        """The mean tap offset (dx, dy) of a filter (a flow stays as it is)."""
        if fil.shape[1] == 2:
            return fil
        return fops.taps_to_flow(fil[:, : self.radius ** 2])

    def filter_from_vector(self, vec):
        """The one-hot filter at the rounded flow (half to even, clipped to
        the radius), inverted."""
        R = self.radius
        v = torch.clamp(torch.round(vec), -(R // 2), R // 2) + R // 2
        idx = v[:, 1].long() * R + v[:, 0].long()            # (B, H, W)
        onehot = F.one_hot(idx, R * R).permute(0, 3, 1, 2).to(vec.dtype)
        return self.invert_filter(onehot)

    def mode_to_flow(self, fil):
        """The offset (dx, dy) of the largest tap, the first one on ties."""
        R = self.radius
        idx = torch.argmax(fil[:, : R * R], dim=1)
        dy = torch.div(idx, R, rounding_mode="floor") - R // 2
        dx = idx % R - R // 2
        return torch.stack([dx, dy], dim=1).float()

    # -- losses ----------------------------------------------------------------
    def smoothness_loss(self, fil, target):
        """Edge-aware smoothness of the mean-tap field."""
        vecs = self.vector_from_filter(fil)
        lam = float(self.cfg.smoothness_lmbd)
        loss = 0.0
        for dim in (2, 3):
            dv = torch.diff(vecs, dim=dim).abs().sum(dim=1)
            di = torch.diff(target, dim=dim).abs().sum(dim=1)
            loss = loss + torch.mean(torch.exp(-lam * di) * dv)
        return loss / 2

    def copout_loss(self, fil):
        R2 = self.radius ** 2
        if fil.shape[1] > R2:
            return fil[:, R2].square().mean()
        return torch.zeros((), device=fil.device)

    def corrective_loss(self, inp, target):
        """Minus the share of the target's pixels at 0 in the samples whose
        input is all white (JAX keeps it for the class's API; no loss uses
        it)."""
        which_white = inp.reshape(inp.shape[0], -1).amin(dim=1) == 1.0
        missed = (target[:, 0] == 0.0).float() * which_white[:, None, None].float()
        return -missed.sum() / (self.image_h * self.image_w * inp.shape[0])

    def identity_loss(self, fil):
        R = self.radius
        w = (torch.arange(R, dtype=torch.float32, device=fil.device) - R // 2).square()
        w = (w[None, :] + w[:, None]).reshape(1, R * R, 1, 1)
        return (fil[:, : R * R] * w).mean()

    def divergence_loss(self, fil):
        R = self.radius
        inv = self.invert_filter(fil)
        crop = inv[:, : R * R, R // 2: -(R // 2), R // 2: -(R // 2)]
        se = float(self.cfg.small_eps)
        div = torch.clamp(crop.sum(dim=1), se, 1.0 / se)
        return (div + 1.0 / div).mean() - 2.0

    def inversion_loss(self, fil, inp, target):
        out, _ = self.apply_filter(self.invert_filter(fil), target, mode="weighted_sum")
        return (out - inp).square().mean()

    def loss(self, out, fil, target, inp, flow):
        """(loss, photometric MSE) of the applied frame ``out`` and the
        filter (or flow) ``fil`` for the goal."""
        cfg = self.cfg
        photo = (out - target).square().mean()
        if self.goal == "filter_pred":
            total = (photo
                     + cfg.smoothness_weight * self.smoothness_loss(fil, target)
                     + cfg.copout_weight * self.copout_loss(fil)
                     + cfg.identity_weight * self.identity_loss(fil)
                     + cfg.divergence_weight * self.divergence_loss(fil)
                     + cfg.inversion_weight * self.inversion_loss(fil, inp, target))
            return total, photo
        if self.goal == "gt_filter_pred":
            vec = self.vector_from_filter(self.invert_filter(fil))
            return (vec - flow).square().mean(), photo
        return (fil - flow).square().mean(), photo

    # -- steps -----------------------------------------------------------------
    def forward(self, img, tgt):
        """The UNet on the pair in [-1, 1]."""
        return self.module(2.0 * torch.cat([img, tgt], dim=1) - 1.0)

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None):
        """(loss, metrics) of one training batch (no randomness)."""
        img, tgt, flow = pair_batch(batch)
        applied, fil = self.apply_filter(self.forward(img, tgt), img)
        err, photo = self.loss(applied, fil, tgt, img, flow)
        mean_flow = self.vector_from_filter(fil)
        return err, {"train/photo": photo.detach(),
                     "train/flow_err": (mean_flow - flow).square().mean().detach()}

    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(metrics, artifacts) of one validation batch, JAX's keys: the
        softmax filter's loss, photometric and mean-flow errors, for the
        filter goals also the mode filter's, and the loss of the optimal
        filter (the ground-truth flow's one-hot filter, or the flow itself)
        applied as a weighted sum."""
        img, tgt, flow = pair_batch(batch)
        with torch.no_grad():
            out = self.forward(img, tgt)
            out_sf, sfs = self.apply_filter(out, img)
            err, photo = self.loss(out_sf, sfs, tgt, img, flow)
            mean_flow = self.vector_from_filter(sfs)
            metrics = {"val/loss": err, "val/photometric": photo,
                       "val/flow_err": (mean_flow - flow).square().mean()}
            artifacts = {"out_sf": out_sf, "mean_flow": mean_flow}
            if self.goal != "gt_flow_pred":
                out_md, modes = self.apply_filter(out, img, mode="mode")
                err_m, photo_m = self.loss(out_md, modes, tgt, img, flow)
                metrics["val/mode_loss"] = err_m
                metrics["val/mode_photometric"] = photo_m
                artifacts["out_md"] = out_md
                artifacts["mode_flow"] = self.mode_to_flow(modes)
                artifacts["invert_p"] = self.apply_filter(self.invert_filter(sfs), tgt,
                                                          mode="none")[0]
                opt_vecs = self.filter_from_vector(flow)
            else:
                opt_vecs = flow
            opt_result, _ = self.apply_filter(opt_vecs, img, mode="weighted_sum")
            opt_loss, opt_photo = self.loss(opt_result, opt_vecs, tgt, img, flow)
            metrics["val/opt_loss"] = opt_loss
            metrics["val/opt_photo"] = opt_photo
            artifacts["opt_p"] = opt_result
            R2 = self.radius ** 2
            if "colweights" in self.has:
                artifacts["col_weight"] = sfs[:, R2: R2 + 1]
            if "cols" in self.has:
                artifacts["color"] = sfs[:, -3:]
        return metrics, artifacts

    def visualize(self, batch, artifacts) -> Dict[str, np.ndarray]:
        """NHWC float images of one validation batch and its artifacts."""
        nhwc = lambda t: np.asarray(t.detach().float().cpu()).transpose(0, 2, 3, 1)
        img, tgt, flow = (nhwc(x) for x in pair_batch(batch))
        out_sf = np.clip(nhwc(artifacts["out_sf"]), 0, 1)
        out = {
            "original": img,
            "target": tgt,
            "softmax_p": out_sf,
            "opt_p": np.clip(np.nan_to_num(nhwc(artifacts["opt_p"])), 0, 1),
            "mean_flow": viz.flow_to_image(nhwc(artifacts["mean_flow"])),
            "gt_flow": viz.flow_to_image(flow),
        }
        if "out_md" in artifacts:
            out["mode_p"] = np.clip(nhwc(artifacts["out_md"]), 0, 1)
            out["mode_flow"] = viz.flow_to_image(nhwc(artifacts["mode_flow"]))
            out["invert_p"] = np.clip(nhwc(artifacts["invert_p"]), 0, 1)
        for k in ("col_weight", "color"):
            if k in artifacts:
                out[k] = np.clip(nhwc(artifacts[k]), 0, 1)
        out["compare"] = np.concatenate([img, tgt, out_sf], axis=2)
        return out

    def filter_to_image(self, filters) -> np.ndarray:
        """A grid of filters (K, N): each of the N filters as an R x R
        image, its centre row and column tinted, tripled in size."""
        R = self.radius
        f = np.asarray(filters)[: R * R]
        f = f.reshape(R, R, -1).transpose(2, 0, 1)[..., None]
        f = np.tile(f, (1, 1, 1, 3))
        f[:, R // 2, :, 2] = 0.33 * (1 + 2 * f[:, R // 2, :, 2])
        f[:, :, R // 2, 1] = 0.33 * (1 + 2 * f[:, :, R // 2, 1])
        f = np.repeat(np.repeat(f, 3, axis=1), 3, axis=2)
        return viz.make_grid(f, nrow=int(round(math.sqrt(f.shape[0]))))


__all__ = ["GOALS", "MatrixFlow", "RAFT_ARCHITECTURE_ERROR", "gaussian_blur", "image_wh"]
