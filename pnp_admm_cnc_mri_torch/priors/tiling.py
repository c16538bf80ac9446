"""Test-mode wrappers of a denoiser: pad, quad-split tiling, split x8.

Port of the JAX package's ``priors/tiling.py`` (reference
``utils/utils_model.py:12-186``), on NCHW batches:

    mode 1: replication-pad to a modulo, forward, crop   (``pad_to_modulo``)
    mode 2: recursive 4-quadrant split with refield-aligned overlap
            (``quad_split``)
    mode 3: x8 dihedral self-ensemble         (``denoiser.x8_ensemble``)
    mode 4: quad-split under the x8 ensemble  (``split_x8``)
    mode 5: one split                         (``one_split``)
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def pad_to_modulo(core: Callable, x: torch.Tensor, modulo: int = 16) -> torch.Tensor:
    """Mode 1 (reference ``test_pad:58-65``): edge-pad bottom and right to a
    multiple of ``modulo``, run, crop back."""
    h, w = x.shape[-2:]
    pb = int(math.ceil(h / modulo) * modulo - h)
    pr = int(math.ceil(w / modulo) * modulo - w)
    if pb or pr:
        x = F.pad(x, (0, pr, 0, pb), mode="replicate")
    return core(x)[..., :h, :w]


def _quadrants(x: torch.Tensor, refield: int):
    """The four overlapping refield-aligned quadrants of x: top-left,
    top-right, bottom-left, bottom-right."""
    h, w = x.shape[-2:]
    th = (h // 2 // refield + 1) * refield
    tw = (w // 2 // refield + 1) * refield
    return [x[..., :th, :tw], x[..., :th, w - tw:], x[..., h - th:, :tw], x[..., h - th:, w - tw:]]


def _stitch(outs, h: int, w: int) -> torch.Tensor:
    """Each quadrant's interior into one (h, w) image."""
    h2, w2 = h // 2, w // 2
    top = torch.cat([outs[0][..., :h2, :w2], outs[1][..., :h2, -(w - w2):]], dim=-1)
    bottom = torch.cat([outs[2][..., -(h - h2):, :w2], outs[3][..., -(h - h2):, -(w - w2):]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quad_split(core: Callable, x: torch.Tensor, refield: int = 32, min_size: int = 256,
               modulo: int = 1) -> torch.Tensor:
    """Mode 2 (reference ``test_split_fn:76-109``): at most ``min_size**2``
    pixels run as ``pad_to_modulo``; larger images split into four
    overlapping quadrants, each run as it is (recursively split above
    4 ``min_size**2``), and are stitched from the quadrants' interiors.
    The quadrants' sides are multiples of ``refield``."""
    h, w = x.shape[-2:]
    if h * w <= min_size**2:
        return pad_to_modulo(core, x, modulo)
    if h * w <= 4 * (min_size**2):
        outs = [core(q) for q in _quadrants(x, refield)]
    else:
        outs = [quad_split(core, q, refield, min_size, modulo) for q in _quadrants(x, refield)]
    return _stitch(outs, h, w)


def split_x8(core: Callable, x: torch.Tensor, refield: int = 32, min_size: int = 256,
             modulo: int = 1) -> torch.Tensor:
    """Mode 4 (reference ``test_split_x8:177-186``): ``quad_split`` inside
    each of the 8 dihedral ensemble branches."""
    from pnp_admm_cnc_mri_torch.priors.denoiser import x8_ensemble

    return x8_ensemble(lambda v: quad_split(core, v, refield, min_size, modulo), x)


def one_split(core: Callable, x: torch.Tensor, refield: int = 32, modulo: int = 1) -> torch.Tensor:
    """Mode 5 (reference ``test_onesplit``): always split exactly once."""
    h, w = x.shape[-2:]
    return _stitch([core(q) for q in _quadrants(x, refield)], h, w)
