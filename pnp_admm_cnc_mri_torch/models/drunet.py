"""DRUNet (UNetRes) denoiser, NCHW (reference ``models/network_unet.py:76-136``).

Port of the JAX package's ``models/drunet.py``: a bias-free 3x3 head,
three [nb ResBlocks, 2x2 stride-2 conv] down stages over
nc = (64, 128, 256, 512), nb ResBlocks in the body, three [2x2 transposed
conv, nb ResBlocks] up stages with ADDITIVE skips, and a bias-free tail.
The input carries a sigma-map channel (in_nc = 2). H and W must be
multiples of 8; ``priors/tiling.py`` pads to 16.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn as nn

from pnp_admm_cnc_mri_torch.models.blocks import DownStride, ResBlock, UpTranspose


class UNetRes(nn.Module):
    def __init__(self, in_nc: int = 2, out_nc: int = 1, nc: Tuple[int, ...] = (64, 128, 256, 512),
                 nb: int = 4):
        super().__init__()
        self.head = nn.Conv2d(in_nc, nc[0], 3, padding=1, bias=False)
        for lvl in range(3):
            for i in range(nb):
                self.add_module(f"down{lvl}_res{i}", ResBlock(nc[lvl]))
            self.add_module(f"down{lvl}_ds", DownStride(nc[lvl], nc[lvl + 1]))
        for i in range(nb):
            self.add_module(f"body_res{i}", ResBlock(nc[3]))
        for lvl in range(3):
            self.add_module(f"up{lvl}_us", UpTranspose(nc[lvl + 1], nc[lvl]))
            for i in range(nb):
                self.add_module(f"up{lvl}_res{i}", ResBlock(nc[lvl]))
        self.tail = nn.Conv2d(nc[0], out_nc, 3, padding=1, bias=False)
        self.nb = nb

    def forward(self, x0):
        h = self.head(x0)
        # skips[0] is the head's output, skips[lvl + 1] the output of down
        # stage lvl; each is summed into the input of the matching up stage
        # or the tail (reference: m_up3(x + x4) ... m_tail(x + x1)).
        skips = [h]
        for lvl in range(3):
            for i in range(self.nb):
                h = getattr(self, f"down{lvl}_res{i}")(h)
            h = getattr(self, f"down{lvl}_ds")(h)
            skips.append(h)
        for i in range(self.nb):
            h = getattr(self, f"body_res{i}")(h)
        for lvl in reversed(range(3)):
            h = getattr(self, f"up{lvl}_us")(h + skips[lvl + 1])
            for i in range(self.nb):
                h = getattr(self, f"up{lvl}_res{i}")(h)
        return self.tail(h + skips[0])
