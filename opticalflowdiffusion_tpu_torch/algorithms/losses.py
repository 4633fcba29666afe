"""PWC-Net's unsupervised loss library (JAX ``algorithms/losses.py``,
reference losses.py:3-66), NCHW.

Every term is sum-reduced as in JAX but the two means
(``constant_velocity_loss``, ``min_per_pixel_loss``).  This
``edgeaware_smoothness1`` is the sum-reduced twin with edge weight 20;
``ops/warp.py``'s is FlowLearner's mean-reduced one with 30.  The terms
reduce in float32 whatever the inputs' dtype.
"""

from __future__ import annotations

import torch

from ..ops.warp import charbonnier


def _edge_weights(image: torch.Tensor, edge_weight: float):
    """(wx, wy): exp(-edge_weight * the mean over channels of the image's
    squared x and y differences)."""
    img_gy = image[:, :, 1:] - image[:, :, :-1]
    img_gx = image[:, :, :, 1:] - image[:, :, :, :-1]
    wy = torch.exp(-edge_weight * img_gy.square().mean(dim=1, keepdim=True))
    wx = torch.exp(-edge_weight * img_gx.square().mean(dim=1, keepdim=True))
    return wx, wy


def photometric_loss(ref, past_warped, future_warped, occ) -> torch.Tensor:
    """The occlusion-weighed Charbonnier sums of ref against the future
    (occ channel 0) and the past (channel 1) warped frames."""
    ref, occ = ref.float(), occ.float()
    future = (occ[:, 0:1] * charbonnier(ref - future_warped.float())).sum()
    past = (occ[:, 1:2] * charbonnier(ref - past_warped.float())).sum()
    return future + past


def constant_velocity_loss(p_flow, f_flow) -> torch.Tensor:
    return charbonnier(p_flow.float() + f_flow.float()).mean()


def edgeaware_smoothness1(image, flow, edge_weight: float = 20.0) -> torch.Tensor:
    """The edge-aware first-order smoothness of ``flow``, summed."""
    wx, wy = _edge_weights(image.float(), edge_weight)
    flow = flow.float()
    flo_gy = flow[:, :, 1:] - flow[:, :, :-1]
    flo_gx = flow[:, :, :, 1:] - flow[:, :, :, :-1]
    return (wx * charbonnier(flo_gx)).sum() + (wy * charbonnier(flo_gy)).sum()


def occlusion_smoothness(image, occ, edge_weight: float = 20.0) -> torch.Tensor:
    """The edge-aware squared differences of the occlusion map, summed."""
    wx, wy = _edge_weights(image.float(), edge_weight)
    occ = occ.float()
    occ_gy = occ[:, :, 1:] - occ[:, :, :-1]
    occ_gx = occ[:, :, :, 1:] - occ[:, :, :, :-1]
    return (wx * occ_gx.square()).sum() + (wy * occ_gy.square()).sum()


def occlusion_prior(occ) -> torch.Tensor:
    occ = occ.float()
    return -1.0 * (occ[:, 0] * occ[:, 1]).sum()


def min_per_pixel_loss(ref, past_warped, future_warped) -> torch.Tensor:
    ref = ref.float()
    return torch.minimum(charbonnier(ref - future_warped.float()),
                         charbonnier(ref - past_warped.float())).mean()


def total_loss(ref, past_warped, future_warped, p_flow, f_flow, occ,
               smoothness_weight: float = 1.0, occ_weight: float = 1.0) -> torch.Tensor:
    """losses.py:56-65, with JAX's ``smoothness_weight`` and ``occ_weight``
    knobs (default 1: the reference's loss)."""
    return (
        photometric_loss(ref, past_warped, future_warped, occ)
        + smoothness_weight * edgeaware_smoothness1(ref, p_flow)
        + smoothness_weight * edgeaware_smoothness1(ref, f_flow)
        + occ_weight * occlusion_smoothness(ref, occ)
        + occ_weight * 0.05 * occlusion_prior(occ)
    )


__all__ = ["constant_velocity_loss", "edgeaware_smoothness1", "min_per_pixel_loss",
           "occlusion_prior", "occlusion_smoothness", "photometric_loss", "total_loss"]
