"""The reference's remaining U-Net catalog (``models/network_unet.py:16-394``), NCHW.

Port of the JAX package's ``models/unet_variants.py``: ``UNet``
(``network_unet.py:16-74``), ``ResUNet`` (``:139-204``, IMD blocks, pad to a
multiple of 8), ``UNetResSubP`` (``:207-265``, pixel-unshuffle front and
back), ``UNetPlus`` (``:268-334``) and ``NonLocalUNet`` (``:342-394``,
non-local attention around the deepest down and up stages). The reference's
entry scripts load none of them (only DRUNet); they are its model inventory.

Shared topology: head, three [blocks, downsample] stages over ``nc`` with
the skips kept, body, three [upsample of ``h + skip``, blocks] stages, tail
of ``h + skips[0]``, and a global ``+ x0`` for every variant but
``ResUNet``. The children carry the Flax modules' names, so
``models/convert.py::state_dict_from_flax`` loads a Flax tree, or a
converted KAIR checkpoint, by name. As in the JAX package: eval-mode
BatchNorm is folded into the convs by the converters; ``UNetPlus`` applies
its activation string directly (the reference's ``act_mode[1]`` indexing
takes only 'BR'); ``DownMaxPool``'s conv is SAME-padded.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn as nn

from pnp_admm_cnc_mri_torch.models.blocks import (
    DownAvgPool,
    DownMaxPool,
    DownStride,
    IMDBlock,
    NonLocalBlock,
    ResBlock,
    UpNearestConv,
    UpPixelShuffle,
    UpTranspose,
    _act,
    _conv3,
    pixel_shuffle,
    pixel_unshuffle,
    replication_pad_2d,
)

_DOWN = {"strideconv": DownStride, "maxpool": DownMaxPool, "avgpool": DownAvgPool}
_UP = {"convtranspose": UpTranspose, "upconv": UpNearestConv, "pixelshuffle": UpPixelShuffle}


class _UNetBase(nn.Module):
    """The shared skeleton. A variant's stage blocks are named
    ``down{lvl}_{stage}{i}``, ``body_{stage}{i}``, ``up{lvl}_{stage}{i}``
    with ``stage`` one of ``conv``, ``imd``, ``res``, as in Flax."""

    def _samplers(self, nc, use_bias, act, downsample_mode, upsample_mode):
        down, up = _DOWN[downsample_mode], _UP[upsample_mode]
        for lvl in range(3):
            self.add_module(f"down{lvl}_ds", down(nc[lvl], nc[lvl + 1], use_bias=use_bias, act=act))
            self.add_module(f"up{lvl}_us", up(nc[lvl + 1], nc[lvl], use_bias=use_bias, act=act))

    def _run(self, h, stage, n_down, n_body, n_up, hooks=None):
        """Head output ``h`` through the stages; returns ``h + skips[0]``.
        ``hooks`` maps ``("down", lvl)`` / ``("up", lvl)`` to a callable run
        before the down stage or after the up stage of that level."""
        hooks = hooks or {}
        skips = [h]
        for lvl in range(3):
            if ("down", lvl) in hooks:
                h = hooks[("down", lvl)](h)
            for i in range(n_down):
                h = getattr(self, f"down{lvl}_{stage}{i}")(h)
            h = getattr(self, f"down{lvl}_ds")(h)
            skips.append(h)
        for i in range(n_body):
            h = getattr(self, f"body_{stage}{i}")(h)
        for lvl in reversed(range(3)):
            h = getattr(self, f"up{lvl}_us")(h + skips[lvl + 1])
            for i in range(n_up):
                h = getattr(self, f"up{lvl}_{stage}{i}")(h)
            if ("up", lvl) in hooks:
                h = hooks[("up", lvl)](h)
        return h + skips[0]


class _ConvAct(nn.Conv2d):
    """A biased SAME 3x3 conv and an activation, its parameters at the
    block's own name (a Flax ``nn.Conv`` followed by ``_act``)."""

    def __init__(self, in_nc: int, features: int, act: str):
        super().__init__(in_nc, features, 3, padding=1)
        self.act = act

    def forward(self, x):
        return _act(super().forward(x), self.act)


class UNet(_UNetBase):
    """Plain conv U-Net, additive skips, global residual (reference
    ``network_unet.py:16-74``; act 'R', biased convs)."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: Tuple[int, ...] = (64, 128, 256, 512),
                 nb: int = 2, act: str = "R", downsample_mode: str = "strideconv",
                 upsample_mode: str = "convtranspose", head_act: bool = True):
        super().__init__()
        self.head = _ConvAct(in_nc, nc[0], act if head_act else "")
        for lvl in range(3):
            for i in range(nb):
                self.add_module(f"down{lvl}_conv{i}", _ConvAct(nc[lvl], nc[lvl], act))
                self.add_module(f"up{lvl}_conv{i}", _ConvAct(nc[lvl], nc[lvl], act))
        for i in range(nb + 1):
            self.add_module(f"body_conv{i}", _ConvAct(nc[3], nc[3], act))
        self._samplers(nc, True, act, downsample_mode, upsample_mode)
        self.tail = _conv3(nc[0], out_nc)
        self.nb = nb

    def forward(self, x0):
        return self.tail(self._run(self.head(x0), "conv", self.nb, self.nb + 1, self.nb)) + x0


class UNetPlus(UNet):
    """``UNet`` with an activation-free head and ``nb`` 1 (reference
    ``network_unet.py:268-334``; its BatchNorms folded by the converter)."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: Tuple[int, ...] = (64, 128, 256, 512),
                 nb: int = 1, act: str = "R", downsample_mode: str = "strideconv",
                 upsample_mode: str = "convtranspose"):
        super().__init__(in_nc, out_nc, nc, nb, act, downsample_mode, upsample_mode, head_act=False)


class NonLocalUNet(UNet):
    """``UNet`` (``nb`` 1) with non-local attention entering the deepest down
    stage (``down_nonlocal``) and leaving the matching up stage
    (``up_nonlocal``) (reference ``network_unet.py:342-394``)."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: Tuple[int, ...] = (64, 128, 256, 512),
                 nb: int = 1, act: str = "R", downsample_mode: str = "strideconv",
                 upsample_mode: str = "convtranspose"):
        super().__init__(in_nc, out_nc, nc, nb, act, downsample_mode, upsample_mode)
        self.down_nonlocal = NonLocalBlock(nc[2])
        self.up_nonlocal = NonLocalBlock(nc[2])

    def forward(self, x0):
        hooks = {("down", 2): self.down_nonlocal, ("up", 2): self.up_nonlocal}
        return self.tail(self._run(self.head(x0), "conv", self.nb, self.nb + 1, self.nb, hooks)) + x0


class ResUNet(_UNetBase):
    """IMD-block U-Net (reference ``network_unet.py:139-204``): bias-free,
    leaky act (slope 0.05 inside the IMD blocks), H and W padded by edge
    replication to multiples of 8 and cropped back, no global residual."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: Tuple[int, ...] = (64, 128, 256, 512),
                 nb: int = 4, act: str = "L", downsample_mode: str = "strideconv",
                 upsample_mode: str = "convtranspose"):
        super().__init__()
        self.head = _conv3(in_nc, nc[0], use_bias=False)
        for lvl in range(3):
            for i in range(nb):
                self.add_module(f"down{lvl}_imd{i}", IMDBlock(nc[lvl], act=act, use_bias=False))
                self.add_module(f"up{lvl}_imd{i}", IMDBlock(nc[lvl], act=act, use_bias=False))
        for i in range(nb):
            self.add_module(f"body_imd{i}", IMDBlock(nc[3], act=act, use_bias=False))
        self._samplers(nc, False, "", downsample_mode, upsample_mode)
        self.tail = _conv3(nc[0], out_nc, use_bias=False)
        self.nb = nb

    def forward(self, x0):
        hh, ww = x0.shape[-2:]
        x = replication_pad_2d(x0, (-hh) % 8, (-ww) % 8)
        h = self.tail(self._run(self.head(x), "imd", self.nb, self.nb, self.nb))
        return h[..., :hh, :ww]


class UNetResSubP(_UNetBase):
    """Sub-pixel UNetRes (reference ``network_unet.py:207-265``):
    ``pixel_unshuffle(2)`` in front, biased ResBlocks, a bias-free tail to
    ``4 out_nc`` channels shuffled back to full size, global residual."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: Tuple[int, ...] = (64, 128, 256, 512),
                 nb: int = 2, act: str = "R", downsample_mode: str = "strideconv",
                 upsample_mode: str = "convtranspose"):
        super().__init__()
        self.head = _ConvAct(4 * in_nc, nc[0], act)
        for lvl in range(3):
            for i in range(nb):
                self.add_module(f"down{lvl}_res{i}", ResBlock(nc[lvl], use_bias=True))
                self.add_module(f"up{lvl}_res{i}", ResBlock(nc[lvl], use_bias=True))
        for i in range(nb + 1):
            self.add_module(f"body_res{i}", ResBlock(nc[3], use_bias=True))
        self._samplers(nc, True, act, downsample_mode, upsample_mode)
        self.tail = _conv3(nc[0], 4 * out_nc, use_bias=False)
        self.nb = nb

    def forward(self, x0):
        h = self.head(pixel_unshuffle(x0, 2))
        return pixel_shuffle(self.tail(self._run(h, "res", self.nb, self.nb + 1, self.nb)), 2) + x0
