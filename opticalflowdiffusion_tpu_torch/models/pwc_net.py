"""Three-frame PWC-Net (JAX ``models/pwc_net.py``, reference
pwc_net.py:34-308), NCHW.

Three siamese 6-level conv feature pyramids (centre, future, past frame),
at each of levels 6..2 the 9x9 cost volumes of the centre features against
the future and the past ones (``ops/correlation.py``: the CUDA kernel on
the card, each direction's channel order written by the kernel), flow
decoders for both directions with the coarser flow upsampled and the
features warped by it (border padding), an occlusion decoder (a softmax
over its two channels), and the per-level outputs at the image pyramid's
sizes with the reference's flow scalings (x20 ... x1.25).

Convs are flax's ``nn.Conv(features, (3, 3))``: kernels float32, computed
in ``dtype``, padded ``SAME`` by lax's rule (at stride 2: (0, 1) on an even
side, (1, 1) on an odd one).  Leaky ReLU slope 0.2.  The resizes are
``jax.image.resize``'s (``ops/warp.py::resize``: antialiased bilinear
downsamples, ``nearest-exact``).  One difference from JAX: the warp's pixel
grid is float32 whatever ``dtype`` (JAX's takes the flow's dtype, and
bfloat16 cannot hold the columns of a wide frame).

The sides must halve exactly down the pyramid (ceil(H / 4) = 16 *
ceil(H / 64), e.g. multiples of 64, or 61): JAX's module fails on others
with a shape error, the port raises.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.correlation import local_correlation
from ..ops.warp import bilinear_gather, resize, upsample_bilinear

FEAT_WIDTHS = (16, 32, 64, 96, 128, 192)
DEC_WIDTHS = (128, 128, 96, 64, 32)
LEVELS = 5                                   # decoders at levels 6..2
WARP_SCALES = (0.625, 1.25, 2.5, 5.0)        # on the upsampled flow (pwc_net.py)
FLOW_SCALES = (20.0, 10.0, 5.0, 2.5, 1.25)   # full-resolution flows, finest first
SLOPE = 0.2


def same_pads(size: int, stride: int, k: int = 3) -> Tuple[int, int]:
    """lax's ``SAME`` padding (low, high) of one side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(cout, (3, 3), strides=stride)``: a float32 kernel and
    bias, computed in ``dtype`` with lax's ``SAME`` padding."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        (t, b), (l, r) = (same_pads(n, self.stride) for n in x.shape[-2:])
        x, pad = x.to(self.dtype), t
        if not t == b == l == r:             # stride 2 on an even side: (0, 1)
            x, pad = F.pad(x, (l, r, t, b)), 0
        return F.conv2d(x, self.weight.to(self.dtype), self.bias.to(self.dtype),
                        stride=self.stride, padding=pad)


class ConvFeatBlock(nn.Module):
    """A stride-2 conv and a conv, each followed by a leaky ReLU."""

    def __init__(self, cin: int, features: int, dtype=torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([Conv(cin, features, 2, dtype),
                                    Conv(features, features, 1, dtype)])

    def forward(self, x):
        for conv in self.convs:
            x = F.leaky_relu(conv(x), SLOPE)
        return x


class ConvDecBlock(nn.Module):
    """Five convs (128, 128, 96, 64, 32) with leaky ReLUs, then a conv to 2."""

    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        widths = (cin,) + DEC_WIDTHS + (2,)
        self.convs = nn.ModuleList([Conv(i, o, 1, dtype) for i, o in zip(widths, widths[1:])])

    def forward(self, x):
        for conv in self.convs[:-1]:
            x = F.leaky_relu(conv(x), SLOPE)
        return self.convs[-1](x)


def backward_warp_border(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp of ``x`` (B, C, H, W) by ``flow`` (B, 2, H, W; channel
    0 is x) with border padding and no mask (pwc_net.py:275-308); the pixel
    grid in float32."""
    B, C, H, W = x.shape
    xs = torch.arange(W, dtype=torch.float32, device=flow.device).view(1, 1, W)
    ys = torch.arange(H, dtype=torch.float32, device=flow.device).view(1, H, 1)
    out = bilinear_gather(x, xs + flow[:, 0].float(), ys + flow[:, 1].float())
    return out.to(x.dtype)


class FeaturePyramid(nn.ModuleList):
    """Six ConvFeatBlocks (16 ... 192 features); returns every level."""

    def __init__(self, dtype=torch.float32):
        widths = (3,) + FEAT_WIDTHS
        super().__init__([ConvFeatBlock(i, o, dtype) for i, o in zip(widths, widths[1:])])

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for block in self:
            x = block(x)
            feats.append(x)
        return feats


def check_size(H: int, W: int) -> None:
    """Raise unless both sides halve exactly from the finest decoded level
    (1/4) to the coarsest (1/64)."""
    for n in (H, W):
        if -(-n // 4) != 16 * -(-n // 64):
            raise ValueError(f"PWCNet needs sides whose pyramid halves exactly "
                             f"(ceil(n / 4) = 16 * ceil(n / 64), e.g. multiples of 64); "
                             f"got {H}x{W}")


class PWCNet(nn.Module):
    """``forward(im_tar, [past, future])`` -> (flow_fwd, flow_bwd, occ,
    warped_imgs, tar_ds): five per-level lists, finest first, at the image
    pyramid's sizes (the frame, then halved four times), as JAX's."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pyr_a = FeaturePyramid(dtype)   # centre frame
        self.pyr_b = FeaturePyramid(dtype)   # future frame
        self.pyr_c = FeaturePyramid(dtype)   # past frame
        corr = 2 * 81
        ins = [corr] + [corr + FEAT_WIDTHS[lv] + 2 for lv in range(LEVELS - 1, 0, -1)]
        occ_ins = [corr + FEAT_WIDTHS[LEVELS]] + ins[1:]
        self.dec_fwd = nn.ModuleList([ConvDecBlock(c, dtype) for c in ins])
        self.dec_bwd = nn.ModuleList([ConvDecBlock(c, dtype) for c in ins])
        self.dec_occ = nn.ModuleList([ConvDecBlock(c, dtype) for c in occ_ins])

    def forward(self, im_tar: torch.Tensor, im_refs: Sequence[torch.Tensor]):
        past, future = im_refs[0], im_refs[1]
        H, W = im_tar.shape[-2:]
        check_size(H, W)
        fa, fb, fc = self.pyr_a(im_tar), self.pyr_b(future), self.pyr_c(past)

        flows_fwd, flows_bwd, occs = [], [], []
        flow_f_up = flow_b_up = None
        fb_cur, fc_cur = fb[LEVELS], fc[LEVELS]
        for li, level in enumerate(range(LEVELS, 0, -1)):   # levels 6..2 (index 5..1)
            corr = torch.cat([local_correlation(fa[level], fb_cur, "fwd"),
                              local_correlation(fa[level], fc_cur, "bwd")], dim=1)
            if flow_f_up is None:
                feat_fwd = feat_bwd = corr
                occ_feat = torch.cat([corr, fa[level]], dim=1)
            else:
                feat_fwd = torch.cat([corr, fa[level], flow_f_up.to(corr.dtype)], dim=1)
                feat_bwd = torch.cat([corr, fa[level], flow_b_up.to(corr.dtype)], dim=1)
                occ_feat = feat_fwd
            flow_f = self.dec_fwd[li](feat_fwd)
            flow_b = self.dec_bwd[li](feat_bwd)
            occ = torch.softmax(self.dec_occ[li](occ_feat), dim=1)
            flows_fwd.append(flow_f)
            flows_bwd.append(flow_b)
            occs.append(occ)
            flow_f_up = upsample_bilinear(flow_f, 2)
            flow_b_up = upsample_bilinear(flow_b, 2)
            if level - 1 >= 1:
                s = WARP_SCALES[li] if li < len(WARP_SCALES) else 1.0
                fb_cur = backward_warp_border(fb[level - 1], s * flow_f_up)
                fc_cur = backward_warp_border(fc[level - 1], -s * flow_b_up)

        # full resolution (pwc_net.py:224-240), finest level first
        flows_fwd, flows_bwd, occs = flows_fwd[::-1], flows_bwd[::-1], occs[::-1]

        def to_fullres(f, sgn, scale):
            return sgn * scale * resize(upsample_bilinear(f, 2), (H, W))

        flow_fwd = [to_fullres(f, 1.0, s) for f, s in zip(flows_fwd, FLOW_SCALES)]
        flow_bwd = [to_fullres(f, -1.0, s) for f, s in zip(flows_bwd, FLOW_SCALES)]
        occ = [resize(o, (H, W), "nearest") for o in occs]

        # image pyramids and the per-level warped references (pwc_net.py:242-271)
        def img_pyr(img):
            ds = [img]
            for _ in range(LEVELS - 1):
                h, w = ds[-1].shape[-2:]
                ds.append(resize(ds[-1], (h // 2, w // 2)))
            return ds

        past_ds, fut_ds, tar_ds = img_pyr(past), img_pyr(future), img_pyr(im_tar)
        flow_fwd_lv, flow_bwd_lv, occ_lv, warped_imgs = [], [], [], []
        for i in range(LEVELS):
            size = tar_ds[i].shape[-2:]
            ff, fb_ = resize(flow_fwd[i], size), resize(flow_bwd[i], size)
            warped_imgs.append([backward_warp_border(fut_ds[i], ff),
                                backward_warp_border(past_ds[i], fb_)])
            flow_fwd_lv.append(ff)
            flow_bwd_lv.append(fb_)
            occ_lv.append(resize(occ[i], size, "nearest"))
        return flow_fwd_lv, flow_bwd_lv, occ_lv, warped_imgs, tar_ds


__all__ = ["Conv", "ConvDecBlock", "ConvFeatBlock", "FeaturePyramid", "PWCNet",
           "backward_warp_border", "check_size", "same_pads"]
