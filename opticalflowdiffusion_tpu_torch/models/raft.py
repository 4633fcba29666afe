"""RAFT optical flow (JAX ``models/raft.py``), NCHW.

The stride-8 feature and context encoders (``BasicEncoder``: a 7x7
stride-2 stem and six residual blocks; instance norm over (H, W), eps
1e-5, no affine, in the feature net; none in the context net), the
all-pairs correlation in float32 with its average-pool pyramid
(``ops/correlation.py``), the windowed lookup of 81 taps a level on the
hand-written CUDA kernel S4 (``ops/correlation.py::corr_lookup``), the
motion encoder, the separable ConvGRU, the flow head and the learnt
convex 8x upsampling.  Each iteration's flow is one prediction; the
coords of the lookup carry no gradient.

Convs are flax's ``nn.Conv``: float32 kernels, ``SAME`` padding by lax's
rule (at stride 2 the 7x7 stem pads (2, 3) on an even side, a 3x3 conv (0,
1); ``models/pwc_net.py::same_pads``).  Images are (B, 3, H, W) in [0, 1];
H and W must be multiples of 8.

JAX's pyramid depth shrinks on a small grid (``max_levels``), and flax
sizes the motion encoder's first conv from the channels it then receives:
the port's RAFT takes the image size at construction (``image_size``) and
builds that conv for the level count the grid holds
(:func:`grid_levels`); without an image size it is built for
``corr_levels``.  A grid that holds another level count than the conv was
built for raises, as applying flax params of another width does.  The
reference's quirk, kept: JAX's filter representation (``radius=R``)
cannot run, at any R (its ``ConvToFilter`` reads the update block's 289
channels as a 3 x 3 grid of 289 // 9 = 32, 288 values, and the reshape
fails); the port's raises with that reason.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .pwc_net import same_pads
from ..ops.correlation import allpairs_correlation, avg_pool2d, corr_lookup
from ..ops.filters import unfold
from ..ops.warp import resize

BLOCKS = ((64, 1), (64, 1), (96, 2), (96, 1), (128, 2), (128, 1))
FILTER_MODE_ERROR = (
    "RAFT's filter representation (radius={}) cannot run: its ConvToFilter reads the "
    "update block's 289 output channels as a 3 x 3 grid of 289 // 9 = 32 channels "
    "(288 values), and JAX's RAFT(radius=R) fails at the same reshape for every R")


class Conv(nn.Conv2d):
    """flax ``nn.Conv(cout, (kh, kw), strides=stride)`` with lax's ``SAME``
    padding: a float32 kernel and bias."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        super().__init__(cin, cout, (kh, kw), stride=stride)

    def forward(self, x):
        (t, b), (l, r) = (same_pads(n, self.stride[0], k)
                          for n, k in zip(x.shape[-2:], self.kernel_size))
        if t == b and l == r:
            return F.conv2d(x, self.weight, self.bias, self.stride, (t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight, self.bias, self.stride)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-channel normalisation over (H, W), eps 1e-5, no affine."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str = "instance", stride: int = 1):
        super().__init__()
        if norm not in ("instance", "none"):
            raise ValueError(f"norm must be 'instance' or 'none', got {norm!r}")
        self.norm = norm
        self.conv1 = Conv(cin, planes, 3, stride)
        self.conv2 = Conv(planes, planes, 3)
        self.down = Conv(cin, planes, 1, stride) if stride != 1 or cin != planes else None

    def _norm(self, x):
        return instance_norm(x) if self.norm == "instance" else x

    def forward(self, x):
        y = F.relu(self._norm(self.conv1(x)))
        y = F.relu(self._norm(self.conv2(y)))
        if self.down is not None:
            x = self._norm(self.down(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 encoder: (B, 3, H, W) -> (B, output_dim, H / 8, W / 8)."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.norm = norm
        self.stem = Conv(3, 64, 7, 2)
        blocks, cin = [], 64
        for planes, stride in BLOCKS:
            blocks.append(ResidualBlock(cin, planes, norm, stride))
            cin = planes
        self.blocks = nn.ModuleList(blocks)
        self.out = Conv(cin, output_dim, 1)

    def forward(self, x):
        x = self.stem(x)
        if self.norm == "instance":
            x = instance_norm(x)
        x = F.relu(x)
        for block in self.blocks:
            x = block(x)
        return self.out(x)


def max_levels(H: int, W: int) -> int:
    """The deepest pyramid JAX builds on an H x W grid (its coarsest level
    at least 1 px)."""
    return max(1, min(H, W).bit_length())


def grid_levels(image_size, corr_levels: int = 4) -> int:
    """The pyramid levels RAFT uses on images of ``image_size`` (one side
    or (H, W)): ``corr_levels``, cut to what the stride-8 grid holds."""
    H, W = (image_size, image_size) if isinstance(image_size, int) else image_size
    return min(corr_levels, max_levels(-(-H // 8), -(-W // 8)))


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4
                 ) -> List[torch.Tensor]:
    """The all-pairs correlation (B * H * W, H, W) and ``num_levels`` - 1
    average pools of it (JAX clamps the depth to :func:`max_levels`)."""
    B, _, H, W = fmap1.shape
    corr = allpairs_correlation(fmap1, fmap2).reshape(B * H * W, H, W)
    pyramid = [corr]
    for _ in range(min(num_levels, max_levels(H, W)) - 1):
        pyramid.append(avg_pool2d(pyramid[-1], 2))
    return pyramid


class FlowHead(nn.Module):
    def __init__(self, cin: int = 128, flow_dim: int = 2):
        super().__init__()
        self.conv1 = Conv(cin, 256, 3)
        self.conv2 = Conv(256, flow_dim, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """A (1, 5) GRU step, then a (5, 1) one."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convs = nn.ModuleList(
            [Conv(cin, hidden_dim, k) for k in ((1, 5),) * 3 + ((5, 1),) * 3])

    def forward(self, h, x):
        for s in (0, 3):
            convz, convr, convq = self.convs[s: s + 3]
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    """(flow, corr) -> 126 features, then the flow itself."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4, flow_dim: int = 2):
        super().__init__()
        self.levels = corr_levels
        self.convc1 = Conv(corr_levels * (2 * corr_radius + 1) ** 2, 256, 1)
        self.convc2 = Conv(256, 192, 3)
        self.convf1 = Conv(flow_dim, 128, 7)
        self.convf2 = Conv(128, 64, 3)
        self.conv = Conv(192 + 64, 126, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4, hidden_dim: int = 128,
                 context_dim: int = 128, flow_dim: int = 2, learn_upsample_mask: bool = True):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius, flow_dim)
        self.gru = SepConvGRU(hidden_dim, context_dim + 126 + flow_dim)
        self.flow_head = FlowHead(hidden_dim, flow_dim)
        self.mask = (nn.ModuleList([Conv(hidden_dim, 256, 3), Conv(256, 64 * 9, 1)])
                     if learn_upsample_mask else None)

    def forward(self, net, inp, corr, flow):
        x = torch.cat([inp, self.encoder(flow, corr)], dim=1)
        net = self.gru(net, x)
        delta = self.flow_head(net)
        mask = None
        if self.mask is not None:
            mask = 0.25 * self.mask[1](F.relu(self.mask[0](net)))
        return net, delta, mask


def coords_grid(B: int, H: int, W: int, device=None) -> torch.Tensor:
    """(B, 2, H, W) pixel coordinates, channel 0 x, channel 1 y."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys]).expand(B, 2, H, W)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8 x the bilinear 8x upsample of ``flow`` (B, 2, H, W)."""
    H, W = flow.shape[-2:]
    return 8.0 * resize(flow, (8 * H, 8 * W))


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The learnt convex 8x upsample: each fine pixel a softmax-weighted
    mix of the 3 x 3 coarse neighbours of 8 x ``flow`` (B, 2, H, W) (zero
    outside), ``mask`` (B, 576, H, W) read as (9 taps, 8 rows, 8 columns)."""
    B, C, H, W = flow.shape
    mask = torch.softmax(mask.reshape(B, 9, 8, 8, H, W), dim=1)
    patches = unfold(8.0 * flow, 3).reshape(B, C, 9, 1, 1, H, W)
    up = (mask[:, None] * patches).sum(dim=2)                # (B, C, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, C, 8 * H, 8 * W)


class RAFT(nn.Module):
    """RAFT: ``forward(image1, image2, iters)`` gives each iteration's
    (B, 2, H, W) flow, upsampled 8x.  ``image_size`` (one side or (H, W))
    sizes the motion encoder for the levels its grid holds (module
    docstring).  ``radius`` set selects JAX's filter representation, which
    raises."""

    def __init__(self, radius: Optional[int] = None, iters: int = 12, hidden_dim: int = 128,
                 context_dim: int = 128, corr_levels: int = 4, corr_radius: int = 4,
                 image_size=None):
        super().__init__()
        self.radius, self.iters = radius, iters
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "none")
        levels = corr_levels if image_size is None else grid_levels(image_size, corr_levels)
        self.update_block = BasicUpdateBlock(levels, corr_radius, hidden_dim, context_dim)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: Optional[int] = None) -> List[torch.Tensor]:
        if self.radius is not None:
            raise ValueError(FILTER_MODE_ERROR.format(self.radius))
        iters = iters or self.iters
        B, _, H, W = image1.shape
        if H % 8 or W % 8:
            raise ValueError(f"RAFT takes sides that are multiples of 8, got {H} x {W}")
        fmap1, fmap2 = self.fnet(image1), self.fnet(image2)
        h, w = fmap1.shape[-2:]
        built = self.update_block.encoder.levels
        if min(self.corr_levels, max_levels(h, w)) != built:
            raise ValueError(
                f"a {h} x {w} feature grid holds {min(self.corr_levels, max_levels(h, w))} "
                f"correlation levels, and this RAFT's motion encoder was built for {built}: "
                f"build it with image_size=({H}, {W}), as JAX's init sizes it from the image")
        pyramid = corr_pyramid(fmap1, fmap2, self.corr_levels)
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, : self.hidden_dim])
        inp = F.relu(cnet[:, self.hidden_dim:])
        coords0 = coords_grid(B, h, w, image1.device)
        flow = torch.zeros(B, 2, h, w, device=image1.device)
        predictions = []
        for _ in range(iters):
            coords1 = (coords0 + flow).detach().permute(0, 2, 3, 1)
            corr = corr_lookup(pyramid, coords1, self.corr_radius).permute(0, 3, 1, 2)
            net, delta, mask = self.update_block(net, inp, corr, flow)
            flow = flow + delta
            predictions.append(convex_upsample(flow, mask))
        return predictions


__all__ = ["RAFT", "BasicEncoder", "BasicMotionEncoder", "BasicUpdateBlock", "FlowHead",
           "ResidualBlock", "SepConvGRU", "Conv", "FILTER_MODE_ERROR", "convex_upsample",
           "coords_grid", "corr_pyramid", "grid_levels", "instance_norm", "max_levels", "upflow8"]
