"""DnCNN / FDnCNN / IRCNN denoisers, NCHW (reference ``models/network_dncnn.py``).

Port of the JAX package's ``models/dncnn.py``:

- DnCNN: nb conv layers (17, or 20 for the blind variants), ReLU between,
  residual output ``x - model(x)``;
- FDnCNN: in_nc=2 (image and noise-level map), nb=20, not residual;
- IRCNN: 7 convs with dilations 1,2,3,4,3,2,1, residual. Its checkpoint is
  25 weight sets, one per noise bin; ``priors/denoiser.py`` stacks them
  and indexes the stack each iteration.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from pnp_admm_cnc_mri_torch.models.blocks import ConvBlock


class _ConvStack(nn.Module):
    """head, body0 .. body{nb-3}, tail: the Flax modules' names."""

    def __init__(self, in_nc: int, out_nc: int, nc: int, nb: int):
        super().__init__()
        self.head = ConvBlock(in_nc, nc, relu=True)
        for i in range(nb - 2):
            self.add_module(f"body{i}", ConvBlock(nc, nc, relu=True))
        self.tail = ConvBlock(nc, out_nc)
        self.nb = nb

    def trunk(self, x):
        h = self.head(x)
        for i in range(self.nb - 2):
            h = getattr(self, f"body{i}")(h)
        return self.tail(h)


class DnCNN(_ConvStack):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64, nb: int = 17,
                 residual: bool = True):
        super().__init__(in_nc, out_nc, nc, nb)
        self.out_nc = out_nc
        self.residual = residual

    def forward(self, x):
        n = self.trunk(x)
        # residual learning: the network predicts the noise
        return x[:, : self.out_nc] - n if self.residual else n


class FDnCNN(_ConvStack):
    """Non-residual DnCNN whose input carries a noise-level map channel."""

    def __init__(self, in_nc: int = 2, out_nc: int = 1, nc: int = 64, nb: int = 20):
        super().__init__(in_nc, out_nc, nc, nb)

    def forward(self, x):
        return self.trunk(x)


IRCNN_DILATIONS: Sequence[int] = (1, 2, 3, 4, 3, 2, 1)


class IRCNN(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64):
        super().__init__()
        last = len(IRCNN_DILATIONS) - 1
        for i, d in enumerate(IRCNN_DILATIONS):
            self.add_module(f"layer{i}", ConvBlock(in_nc if i == 0 else nc, out_nc if i == last else nc,
                                                   relu=i != last, dilation=d))
        self.out_nc = out_nc

    def forward(self, x):
        h = x
        for i in range(len(IRCNN_DILATIONS)):
            h = getattr(self, f"layer{i}")(h)
        return x[:, : self.out_nc] - h
