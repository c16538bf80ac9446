"""Building blocks of the parity denoisers, NCHW.

Port of the JAX package's ``models/blocks.py`` (reference
``models/basicblock.py``). Each block names its convolutions as the Flax
block does (``conv``, ``conv1``, ``conv2``), so a Flax parameter path maps
onto the block's ``state_dict`` key by name (``models/convert.py``). Torch
needs each conv's input width, which Flax infers, so every block whose
input width is not its output width takes ``in_nc``. No BatchNorm: the
deployed checkpoints are plain conv stacks, and the catalog's BatchNorms are
folded into their convs by the converters.
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


# ---------------------------------------------------------------------------
# The blocks of the reference's unused architecture catalog
# (``models/basicblock.py:232-536``), behind ``models/unet_variants.py``;
# the JAX package's ``models/blocks.py:150-375``. Eval-mode BatchNorm is
# folded into the preceding conv by the converters (``models/convert.py``),
# so the graphs are norm-free. Blocks with a residual take ``features``
# channels in; samplers take ``in_nc``.
# ---------------------------------------------------------------------------


def _conv3(in_nc: int, features: int, use_bias: bool = True, kernel: int = 3) -> nn.Conv2d:
    """A SAME-padded square conv (Flax ``nn.Conv(..., padding="SAME")`` at odd sizes)."""
    return nn.Conv2d(in_nc, features, kernel, padding=kernel // 2, bias=use_bias)


class IMDBlock(nn.Module):
    """Information multi-distillation block (reference
    ``basicblock.IMDBlock:232-266``): three conv + act stages, each
    splitting ``d_nc = int(features * d_rate)`` distilled channels off along
    dim 1, a conv on the remainder, a 1x1 fuse of the distillations, and the
    residual. Its leaky slope is 0.05."""

    def __init__(self, features: int, d_rate: float = 0.25, act: str = "L", slope: float = 0.05,
                 use_bias: bool = True):
        super().__init__()
        self.d_nc = d_nc = int(features * d_rate)
        r_nc = features - d_nc
        self.conv1 = _conv3(features, features, use_bias)
        self.conv2 = _conv3(r_nc, features, use_bias)
        self.conv3 = _conv3(r_nc, features, use_bias)
        self.conv4 = _conv3(r_nc, d_nc, use_bias)
        self.conv1x1 = _conv3(4 * d_nc, features, use_bias, kernel=1)
        self.act, self.slope = act, slope

    def forward(self, x):
        d = self.d_nc
        h = _act(self.conv1(x), self.act, self.slope)
        d1, r = h[:, :d], h[:, d:]
        h = _act(self.conv2(r), self.act, self.slope)
        d2, r = h[:, :d], h[:, d:]
        h = _act(self.conv3(r), self.act, self.slope)
        d3, r = h[:, :d], h[:, d:]
        return x + self.conv1x1(torch.cat([d1, d2, d3, self.conv4(r)], dim=1))


class CALayer(nn.Module):
    """Squeeze-and-excite channel attention (reference
    ``basicblock.CALayer:277-294``): global mean, 1x1 down (ReLU), 1x1 up
    (sigmoid), channel-wise rescale."""

    def __init__(self, features: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(features, features // reduction, 1)
        self.fc2 = nn.Conv2d(features // reduction, features, 1)

    def forward(self, x):
        y = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(y)


class RCABlock(nn.Module):
    """Residual channel-attention block (reference
    ``basicblock.RCABlock:298-313``): conv, act, conv, ``CALayer``, + x."""

    def __init__(self, features: int, act: str = "R", reduction: int = 16, use_bias: bool = True):
        super().__init__()
        self.conv1 = _conv3(features, features, use_bias)
        self.conv2 = _conv3(features, features, use_bias)
        self.ca = CALayer(features, reduction)
        self.act = act

    def forward(self, x):
        return x + self.ca(self.conv2(_act(self.conv1(x), self.act)))


class RCAGroup(nn.Module):
    """``nb`` RCABlocks and a conv, with an outer residual (reference
    ``basicblock.RCAGroup:317-331``)."""

    def __init__(self, features: int, nb: int = 12, act: str = "R", reduction: int = 16):
        super().__init__()
        for i in range(nb):
            self.add_module(f"rcab{i}", RCABlock(features, act, reduction))
        self.conv = _conv3(features, features)
        self.nb = nb

    def forward(self, x):
        h = x
        for i in range(self.nb):
            h = getattr(self, f"rcab{i}")(h)
        return x + self.conv(h)


class ResidualDenseBlock5C(nn.Module):
    """Five-conv residual dense block (reference
    ``basicblock.ResidualDenseBlock_5C:337-357``): conv k sees the
    concatenation ``[x, f1, ..., f(k-1)]``, the fifth conv returns to
    ``features``, and the residual is scaled by 0.2."""

    def __init__(self, features: int, gc: int = 32, act: str = "R", use_bias: bool = True):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", _conv3(features + i * gc, gc, use_bias))
        self.conv5 = _conv3(features + 4 * gc, features, use_bias)
        self.act = act

    def forward(self, x):
        feats = [x]
        for i in range(4):
            feats.append(_act(getattr(self, f"conv{i + 1}")(torch.cat(feats, dim=1)), self.act))
        return self.conv5(torch.cat(feats, dim=1)) * 0.2 + x


class RRDB(nn.Module):
    """Three ``ResidualDenseBlock5C``s with a 0.2-scaled residual (reference
    ``basicblock.RRDB:360-372``)."""

    def __init__(self, features: int, gc: int = 32, act: str = "R"):
        super().__init__()
        for i in range(3):
            self.add_module(f"rdb{i + 1}", ResidualDenseBlock5C(features, gc, act))

    def forward(self, x):
        h = x
        for i in range(3):
            h = getattr(self, f"rdb{i + 1}")(h)
        return h * 0.2 + x


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local attention (reference
    ``basicblock.NonLocalBlock2D:487-536``): 1x1 ``theta``, ``phi``, ``g``
    to C/2, ``softmax(theta phi^T) g`` over space flattened row-major
    (``h w``), a 1x1 ``w`` back to C (the reference's eval-mode BatchNorm
    folded into it), + x. ``downsample`` max-pools ``phi`` and ``g`` 2x2."""

    def __init__(self, features: int, downsample: bool = False):
        super().__init__()
        inter = features // 2
        self.theta = nn.Conv2d(features, inter, 1)
        self.phi = nn.Conv2d(features, inter, 1)
        self.g = nn.Conv2d(features, inter, 1)
        self.w = nn.Conv2d(inter, features, 1)
        self.downsample = downsample

    def forward(self, x):
        n, _, h, w = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)  # (n, h w, inter)
        phi, g = self.phi(x), self.g(x)
        if self.downsample:
            phi, g = F.max_pool2d(phi, 2), F.max_pool2d(g, 2)
        att = torch.softmax(torch.matmul(theta, phi.flatten(2)), dim=-1)  # (n, h w, keys)
        y = torch.matmul(att, g.flatten(2).transpose(1, 2))  # (n, h w, inter)
        return x + self.w(y.transpose(1, 2).reshape(n, -1, h, w))


class DownMaxPool(nn.Module):
    """2x2 max-pool, then a 3x3 conv and act (reference
    ``basicblock.downsample_maxpool:451-460``; SAME padding where the
    reference's dead code has VALID, so the skips line up, as in JAX)."""

    def __init__(self, in_nc: int, features: int, use_bias: bool = True, act: str = ""):
        super().__init__()
        self.conv = _conv3(in_nc, features, use_bias)
        self.act = act

    def forward(self, x):
        return _act(self.conv(F.max_pool2d(x, 2)), self.act)


class DownAvgPool(nn.Module):
    """2x2 average pool, then a 3x3 conv and act (reference
    ``basicblock.downsample_avgpool:464-473``)."""

    def __init__(self, in_nc: int, features: int, use_bias: bool = True, act: str = ""):
        super().__init__()
        self.conv = _conv3(in_nc, features, use_bias)
        self.act = act

    def forward(self, x):
        return _act(self.conv(F.avg_pool2d(x, 2)), self.act)


class UpNearestConv(nn.Module):
    """Nearest-neighbour 2x upsampling, then a 3x3 conv and act (reference
    ``basicblock.upsample_upconv:399-409``)."""

    def __init__(self, in_nc: int, features: int, use_bias: bool = True, act: str = ""):
        super().__init__()
        self.conv = _conv3(in_nc, features, use_bias)
        self.act = act

    def forward(self, x):
        return _act(self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)), self.act)


class UpPixelShuffle(nn.Module):
    """A 3x3 conv to ``4 features``, depth-to-space, act (reference
    ``basicblock.upsample_pixelshuffle:390-394``)."""

    def __init__(self, in_nc: int, features: int, use_bias: bool = True, act: str = ""):
        super().__init__()
        self.conv = _conv3(in_nc, 4 * features, use_bias)
        self.act = act

    def forward(self, x):
        return _act(pixel_shuffle(self.conv(x), 2), self.act)
