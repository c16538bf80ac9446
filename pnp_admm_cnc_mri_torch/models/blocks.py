"""Building blocks of the parity denoisers, NCHW.

Port of the JAX package's ``models/blocks.py:32-149`` (reference
``models/basicblock.py``). Each block names its convolutions as the Flax
block does (``conv``, ``conv1``, ``conv2``), so a Flax parameter path maps
onto the block's ``state_dict`` key by name (``models/convert.py``). Torch
needs each conv's input width, which Flax infers, so every block takes
``in_nc``. No BatchNorm: the deployed checkpoints are plain conv stacks.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _act(h: torch.Tensor, act: str, slope: float = 0.2) -> torch.Tensor:
    """Activation by the reference's mode letter: 'R' relu, 'L' leaky, '' none."""
    if act in ("R", "r"):
        return F.relu(h)
    if act in ("L", "l"):
        return F.leaky_relu(h, negative_slope=slope)
    if act == "":
        return h
    raise ValueError(f"unknown activation {act!r}")


class ConvBlock(nn.Module):
    """Same-padding conv (3x3 by default, optionally dilated), optional ReLU
    (reference ``basicblock.conv`` mode 'C' / 'CR')."""

    def __init__(self, in_nc: int, features: int, relu: bool = False, use_bias: bool = True,
                 kernel: int = 3, dilation: int = 1):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.conv = nn.Conv2d(in_nc, features, kernel, padding=pad, dilation=dilation, bias=use_bias)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.relu else x


class ResBlock(nn.Module):
    """``x + conv2(relu(conv1(x)))`` with 3x3 convs (reference
    ``basicblock.ResBlock`` mode 'CRC'; DRUNet's are bias-free)."""

    def __init__(self, features: int, use_bias: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=use_bias)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=use_bias)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class DownStride(nn.Module):
    """2x2 stride-2 conv downsampler (reference ``downsample_strideconv``)."""

    def __init__(self, in_nc: int, features: int, use_bias: bool = False, act: str = ""):
        super().__init__()
        self.conv = nn.Conv2d(in_nc, features, 2, stride=2, bias=use_bias)
        self.act = act

    def forward(self, x):
        return _act(self.conv(x), self.act)


class UpTranspose(nn.Module):
    """2x2 stride-2 transposed-conv upsampler (reference
    ``upsample_convtranspose``; Flax ``ConvTranspose(transpose_kernel=True)``)."""

    def __init__(self, in_nc: int, features: int, use_bias: bool = False, act: str = ""):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_nc, features, 2, stride=2, bias=use_bias)
        self.act = act

    def forward(self, x):
        return _act(self.conv(x), self.act)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Space-to-depth, (N, C, H r, W r) -> (N, C r r, H, W), output channel
    ``c r r + dy r + dx``: torch's order, which the JAX NHWC version copies."""
    return F.pixel_unshuffle(x, factor)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space, the inverse of ``pixel_unshuffle``."""
    return F.pixel_shuffle(x, factor)


def replication_pad_2d(x: torch.Tensor, pad_bottom: int, pad_right: int) -> torch.Tensor:
    """Edge-replication pad of H at the bottom and W at the right, NCHW."""
    return F.pad(x, (0, pad_right, 0, pad_bottom), mode="replicate")
