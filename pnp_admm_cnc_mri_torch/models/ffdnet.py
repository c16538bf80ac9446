"""FFDNet denoiser, NCHW (reference ``models/network_ffdnet.py:31-73``).

Port of the JAX package's ``models/ffdnet.py``: pixel-unshuffle by ``sf``,
a sigma-map channel concatenated after it, [conv + ReLU] x (nb - 1), conv,
pixel-shuffle. Odd sizes are replication-padded to a multiple of ``sf``
and cropped back, as the reference does.
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


class FFDNet(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64, nb: int = 15, sf: int = 2):
        super().__init__()
        self.head = ConvBlock(in_nc * sf * sf + 1, nc, relu=True)
        for i in range(nb - 2):
            self.add_module(f"body{i}", ConvBlock(nc, nc, relu=True))
        self.tail = ConvBlock(nc, out_nc * sf * sf)
        self.nb, self.sf = nb, sf

    def forward(self, x, sigma):
        """x: (N, C, H, W); sigma: a number or an (N, 1, 1, 1) tensor, the
        noise level in [0, 1]."""
        h0, w0 = x.shape[-2:]
        pb, pr = (-h0) % self.sf, (-w0) % self.sf
        if pb or pr:
            x = replication_pad_2d(x, pb, pr)
        d = pixel_unshuffle(x, self.sf)
        sig = torch.as_tensor(sigma, dtype=d.dtype, device=d.device).reshape(-1, 1, 1, 1)
        sig = sig.expand(d.shape[0], 1, d.shape[2], d.shape[3])
        h = self.head(torch.cat([d, sig], dim=1))
        for i in range(self.nb - 2):
            h = getattr(self, f"body{i}")(h)
        out = pixel_shuffle(self.tail(h), self.sf)
        return out[..., :h0, :w0]
