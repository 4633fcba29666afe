"""Filter <-> compact conv codecs (JAX ``models/filter_codec.py``), NCHW.

``FilterToConv`` is the identity unless ``enabled`` (the reference's
forward returns its input before the conv stack).  ``ConvToFilter``
expands an 81-dim per-pixel code, read as a 3 x 3 grid of 9 channels, to an
R^2 filter through three stride-2 transposed convs over that grid (3 -> 6
-> 12 -> 24) and a dense layer.

Flax's ``ConvTranspose`` (``transpose_kernel=False``, ``SAME``) correlates
the stride-dilated input, padded by lax's SAME amounts (``_pads``), with
the kernel as stored; ``torch.nn.ConvTranspose2d`` correlates with the
spatially flipped kernel.  So the weight bridge (``utils/weights.py``)
flips the kernel, each layer pads by ``k - 1 - pad_lo`` and the output is
cut to ``stride x`` the input, which drops the one extra row and column
that torch's symmetric padding gives.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _pads(k: int, s: int):
    """(lo, hi) padding of the dilated input for lax's SAME transposed conv."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    return lo, pad_len - lo


class _ConvTransposeSame(nn.ConvTranspose2d):
    """Flax's ``ConvTranspose(features, (k, k), strides=(s, s))``, SAME."""

    def __init__(self, cin: int, cout: int, k: int, s: int = 2):
        lo, hi = _pads(k, s)
        super().__init__(cin, cout, k, stride=s, padding=k - 1 - lo)
        self.k, self.s = k, s

    def forward(self, x):
        H, W = x.shape[2:]
        return super().forward(x)[:, :, : H * self.s, : W * self.s]


class ConvToFilter(nn.Module):
    """(B, 81, H, W) code -> (B, R^2, H, W) filter."""

    def __init__(self, radius: int, in_dim: int = 81):
        super().__init__()
        self.radius, self.in_dim = radius, in_dim
        self.up = nn.ModuleList([_ConvTransposeSame(in_dim // 9, 32, 3),
                                 _ConvTransposeSame(32, 8, 5), _ConvTransposeSame(8, 1, 5)])
        self.dense = nn.Linear(24 * 24, radius ** 2)

    def forward(self, x):
        B, _, H, W = x.shape
        f = x.permute(0, 2, 3, 1).reshape(B * H * W, 3, 3, self.in_dim // 9).permute(0, 3, 1, 2)
        for up in self.up:
            f = F.relu(up(f))
        f = self.dense(f.reshape(B, H, W, -1))
        return f.permute(0, 3, 1, 2)


class FilterToConv(nn.Module):
    """(B, R^2, H, W) filter -> (B, out_dim // 9, H, W) code when
    ``enabled``; else the identity."""

    def __init__(self, radius: int, out_dim: int = 216, enabled: bool = False):
        super().__init__()
        self.radius, self.enabled = radius, enabled
        if enabled:
            self.convs = nn.ModuleList([nn.Conv2d(1, 8, 5, stride=2), nn.Conv2d(8, 32, 5, stride=2),
                                        nn.Conv2d(32, out_dim // 9, 3, stride=2)])

    @staticmethod
    def _same(x, conv):
        """Flax's SAME padding for a strided conv: out = ceil(n / s)."""
        k, s = conv.kernel_size[0], conv.stride[0]
        pads = []
        for n in (x.shape[3], x.shape[2]):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return conv(F.pad(x, pads))

    def forward(self, x):
        if not self.enabled:
            return x
        B, _, H, W = x.shape
        f = x.permute(0, 2, 3, 1).reshape(B * H * W, 1, self.radius, self.radius)
        for conv in self.convs:
            f = F.relu(self._same(f, conv))
        return f.permute(0, 2, 3, 1).reshape(B, H, W, -1).permute(0, 3, 1, 2)


__all__ = ["ConvToFilter", "FilterToConv"]
