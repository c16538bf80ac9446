"""TDNet denoiser, NCHW.

Port of the JAX package's ``models/tdnet.py:34-65``, a model of that
package with no reference counterpart: FFDNet's layout (pixel-unshuffle by
``sf``, a sigma-map channel after the unshuffled channels, a stack of
3x3 convs at width ``nc``, pixel-shuffle) with a residual output, the
network predicting the noise, ``x - noise``. Odd sizes are
replication-padded to a multiple of ``sf`` and cropped back.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pnp_admm_cnc_mri_torch.models.blocks import (
    ConvBlock,
    pixel_shuffle,
    pixel_unshuffle,
    replication_pad_2d,
)


class TDNet(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 128, nb: int = 12, sf: int = 2):
        super().__init__()
        self.head = ConvBlock(in_nc * sf * sf + 1, nc, relu=True)
        for i in range(nb - 2):
            self.add_module(f"body{i}", ConvBlock(nc, nc, relu=True))
        self.tail = ConvBlock(nc, out_nc * sf * sf)
        self.nb, self.sf = nb, sf

    def forward(self, x, sigma):
        """x: (N, C, H, W); sigma: a number or a tensor of N or 1 noise
        levels in [0, 1]. Returns the denoised image."""
        h0, w0 = x.shape[-2:]
        pb, pr = (-h0) % self.sf, (-w0) % self.sf
        xp = replication_pad_2d(x, pb, pr) if (pb or pr) else x
        d = pixel_unshuffle(xp, self.sf)
        sig = torch.as_tensor(sigma, dtype=d.dtype, device=d.device).reshape(-1, 1, 1, 1)
        h = torch.cat([d, sig.expand(d.shape[0], 1, d.shape[2], d.shape[3])], dim=1)
        h = self.head(h)
        for i in range(self.nb - 2):
            h = getattr(self, f"body{i}")(h)
        noise = pixel_shuffle(self.tail(h), self.sf)[..., :h0, :w0]
        return x - noise
