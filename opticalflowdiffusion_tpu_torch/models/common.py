"""Common small models (JAX ``models/common.py``), NCHW: ``SimpleMlp``, the
64x64 ``CnnEncoder``/``CnnDecoder``, the ``CustomizableCnn`` conv stack and
the ``bottle`` time-batch wrapper.

The convs take flax's padding: ``VALID`` in the encoder and decoder (the
decoder's transposed convs grow 1 -> 5 -> 13 -> 30 -> 64), ``SAME`` by lax's
rule in the customizable stack.  A flattened feature map is read in JAX's
(H, W, C) order, so a dense kernel maps across as it is
(``utils/weights.py::common_rows``)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .raft import Conv as SameConv


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class SimpleMlp(nn.Module):
    """``n_layers`` dense layers, ``activation`` between them."""

    def __init__(self, in_dim: int, out_dim: int = 1, hidden_dim: int = 64, n_layers: int = 2,
                 activation: Callable = F.relu,
                 output_activation: Optional[Callable] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (n_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.activation, self.output_activation = activation, output_activation

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.activation(layer(x))
        x = self.layers[-1](x)
        return x if self.output_activation is None else self.output_activation(x)


class CnnEncoder(nn.Module):
    """(B, in_channels, 64, 64) image -> (B, embedding_size)."""

    def __init__(self, embedding_size: int, in_channels: int = 3,
                 activation: Callable = F.relu):
        super().__init__()
        dims = (in_channels, 32, 64, 128, 256)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 4, stride=2) for a, b in zip(dims[:-1],
                                                                                 dims[1:]))
        self.dense = nn.Linear(256 * 2 * 2, embedding_size)
        self.activation = activation

    def forward(self, x):
        for conv in self.convs:
            x = self.activation(conv(x))
        return self.dense(_flatten_hwc(x))


class CnnDecoder(nn.Module):
    """(B, embedding_size) -> (B, 3, 64, 64) image."""

    def __init__(self, embedding_size: int, activation: Callable = F.relu):
        super().__init__()
        self.dense = nn.Linear(embedding_size, 128)
        self.convs = nn.ModuleList(nn.ConvTranspose2d(a, b, k, stride=2) for a, b, k in (
            (128, 128, 5), (128, 64, 5), (64, 32, 6), (32, 3, 6)))
        self.activation = activation

    def forward(self, emb):
        x = self.dense(emb).reshape(emb.shape[0], 128, 1, 1)
        for conv in self.convs[:-1]:
            x = self.activation(conv(x))
        return self.convs[-1](x)


class CustomizableCnn(nn.Module):
    """A stack of ``kernel`` x ``kernel`` convs at ``strides`` (``SAME``
    padding), ``activation`` after each; with ``out_dim`` a dense layer over
    the flattened map, whose size ``in_size`` (one side of the input) sets."""

    def __init__(self, in_channels: int, features: Sequence[int] = (32, 64, 128),
                 kernel: int = 3, strides: int = 2, out_dim: Optional[int] = None,
                 activation: Callable = F.relu, in_size: Optional[int] = None):
        super().__init__()
        dims = (in_channels,) + tuple(features)
        self.convs = nn.ModuleList(SameConv(a, b, kernel, strides) for a, b in zip(dims[:-1],
                                                                                   dims[1:]))
        self.activation = activation
        self.dense = None
        if out_dim is not None:
            if in_size is None:
                raise ValueError("CustomizableCnn with out_dim needs in_size (the input's side)")
            side = in_size
            for _ in features:
                side = -(-side // strides)
            self.dense = nn.Linear(side * side * dims[-1], out_dim)

    def forward(self, x):
        for conv in self.convs:
            x = self.activation(conv(x))
        return x if self.dense is None else self.dense(_flatten_hwc(x))


def bottle(f: Callable, x_tuple: Sequence[torch.Tensor]):
    """Apply ``f`` over (T, B, ...) inputs by flattening time into batch."""
    sizes = [x.shape for x in x_tuple]
    flat = [x.reshape((s[0] * s[1],) + tuple(s[2:])) for x, s in zip(x_tuple, sizes)]
    y = f(*flat)
    return y.reshape(tuple(sizes[0][:2]) + tuple(y.shape[1:]))


__all__ = ["CnnDecoder", "CnnEncoder", "CustomizableCnn", "SimpleMlp", "bottle"]
