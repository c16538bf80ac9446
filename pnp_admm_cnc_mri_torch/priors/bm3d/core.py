"""BM3D: block matching and collaborative 3-D filtering in torch.

Port of the JAX package's ``priors/bm3d/core.py``: the white-noise core and
the colored-noise half (per-coefficient variances from a PSD, the
exact-variance stages, the spectral gate and the adaptive pilot). The
algorithm is the JAX package's, a fixed-shape redesign of the reference's C
binaries
(``bm3d_thr.so`` / ``bm3d_wie.so``) with the parameters of profile 'np'
(``profiles.py:44-67``) and the white-noise auto-parameters lambda 3.0 and
mu^2 0.4 (reference ``__init__.py:868-869``):

- every bs x bs block is 2-D transformed once, as one product with the
  (bs^2, bs^2) Kronecker matrix;
- block matching measures, for every search offset, the squared difference
  of the image and its shifted copy summed over the bs x bs block at each
  reference position (stride ``step``, the last row and column forced);
  candidates outside the image are poisoned with a large pad value;
- the group size is the largest power of two at or below the number of
  candidates within ``tau``, at least 1 (reference ``profiles.py:49,66``);
- hard-threshold (first stage) or Wiener (second stage) shrinkage in the
  Haar transform along the stack, the inverse, and a Kaiser-weighted
  aggregation.

Every function takes images of shape (..., H, W) and runs the leading axes
as one batch of torch ops. One code path runs on the CPU and on the card,
and the white-noise core differs from the JAX package in four deliberate
ways:

- **exact, stable top-k**: candidates are ranked by ``torch.sort(...,
  stable=True)``, so among equal distances the lower offset index comes
  first, as ``jax.lax.top_k`` has it (``torch.topk`` breaks ties in no set
  order). The JAX package uses ``lax.approx_max_k`` on accelerators;
- **distances as explicit sums**: the box sums add the eight rows, then the
  eight columns, in a fixed order (JAX: a separable convolution on the CPU,
  banded matrix products elsewhere). The sums are the same on the CPU and
  the card bit for bit, and blocks with equal pixels have equal distances;
- **the Haar tree** filters the stacks on both devices (JAX: the per-size
  matrix filter on the CPU, the tree elsewhere);
- **deterministic aggregation**: the filtered blocks are sorted by target
  position and summed by segment (``torch.segment_reduce``) instead of a
  scatter-add, whose CUDA form uses atomics and is not reproducible.

The colored stages filter the stacks with the per-size matrix loop (the
Haar matrices rounded to float32, then cast to the working dtype), as the
JAX package does on every backend. Their host decisions (the prefilter
from the PSD, the adaptive pilot threshold of each image) are made once a
call, and a per-image threshold is carried as a (..., 1, 1, 1) tensor.

Matrix products run at full float32 precision (``fourier.full_precision_
matmul``): TF32 would move the distances' inputs and the transforms by
~1e-3 relative and flip matches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pnp_admm_cnc_mri_torch.ops.fourier import full_precision_matmul
from pnp_admm_cnc_mri_torch.priors.bm3d import transforms as tr
from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device
from pnp_admm_cnc_mri_torch.solvers.fista import host_scalar

_POISON = 1e4  # pad value and per-pixel cap of the squared differences
_D2_BYTES = 1 << 28  # bound on one chunk of shifted squared differences


@dataclasses.dataclass(frozen=True)
class BM3DProfile:
    """Profile 'np' constants (reference ``bm3d307/bm3d/profiles.py:16-68``)."""

    # HT stage
    bs_ht: int = 8
    step_ht: int = 3
    max_3d_ht: int = 16
    search_ht: int = 39
    tau_match_ht: float = 3000.0
    lambda_thr3d: float = 3.0  # white-noise auto value (__init__.py:868)
    # Wiener stage
    bs_wie: int = 8
    step_wie: int = 3
    max_3d_wie: int = 32
    search_wie: int = 39
    tau_match_wie: float = 400.0
    mu2: float = 0.4  # white-noise auto value (__init__.py:869)
    lambda_2d: float = 2.0  # coarse-prefilter threshold (classic BM3D)
    tau_scale: float = 2.0  # d-distance scale calibrated against the C binaries
    # Transforms / aggregation
    transform_ht: str = "bior1.5"
    transform_wie: str = "dct"
    dec_level: int = 0  # HT wavelet column roll (reference profiles.py:67)
    beta: float = 2.0  # Kaiser beta, HT-stage aggregation
    beta_wie: float = 2.0  # Kaiser beta, Wiener-stage aggregation
    # Refiltering (the reference's denoise_residual flag, profiles.py:36)
    denoise_residual: bool = False
    # Routes scalar-sigma (white) calls of ``api.bm3d`` through the
    # exact-variance colored core (block-overlap correlations modeled, ~2x
    # the cost); set on the named variants, off on 'np'.
    exact_white: bool = False


DEFAULT_PROFILE = BM3DProfile()

# Named profile variants (reference ``bm3d307/bm3d/profiles.py:136-220``).
PROFILES = {
    "np": DEFAULT_PROFILE,
    "refilter": BM3DProfile(denoise_residual=True),
    "vn": BM3DProfile(
        max_3d_ht=32, step_ht=4, bs_wie=11, step_wie=6,
        lambda_thr3d=2.8, tau_match_wie=3500.0, search_wie=39,
        exact_white=True,
    ),
    "lc": BM3DProfile(
        step_ht=6, search_ht=25, step_wie=5, max_3d_wie=16, search_wie=25,
    ),
    "vn_old": BM3DProfile(
        transform_ht="dct", bs_ht=12, step_ht=4, bs_wie=11, step_wie=6,
        lambda_thr3d=2.8, tau_match_wie=3500.0, tau_match_ht=5000.0,
        search_wie=39, exact_white=True,
    ),
    "high": BM3DProfile(
        step_ht=2, step_wie=2, lambda_thr3d=2.5, beta=2.5, beta_wie=1.5,
        dec_level=1, exact_white=True,
    ),
    "deb": BM3DProfile(
        transform_ht="dst", lambda_thr3d=2.9, bs_wie=8, step_wie=2,
        max_3d_wie=16, search_wie=39, tau_match_wie=800.0, beta_wie=0.0,
        exact_white=True,
    ),
}


def get_profile(name) -> BM3DProfile:
    """A named profile ('np', 'refilter', 'vn', 'lc', 'vn_old', 'high',
    'deb', the reference's ``_select_profile``), or a ``BM3DProfile`` as given."""
    if isinstance(name, BM3DProfile):
        return name
    try:
        return PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown BM3D profile {name!r}; choose from {sorted(PROFILES)}"
        ) from None


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def _ref_grid(n_pos: int, step: int) -> np.ndarray:
    """Stride-``step`` reference positions, always including the last
    (the C code forces the final row/column block)."""
    g = list(range(0, n_pos, step))
    if g[-1] != n_pos - 1:
        g.append(n_pos - 1)
    return np.asarray(g, dtype=np.int32)


def _offsets(search: int, bs: int) -> np.ndarray:
    """Candidate top-left offsets of the (search - bs + 1)^2 window."""
    n = search - bs + 1  # 32 for the default profile
    lo = -(n // 2 - 1)  # -15..16
    return np.arange(lo, lo + n, dtype=np.int32)


def _extract_blocks(img: torch.Tensor, bs: int) -> torch.Tensor:
    """All overlapping bs x bs blocks of (..., H, W) -> (..., nH, nW, bs*bs),
    pixels in row-major order."""
    blocks = img.unfold(-2, bs, 1).unfold(-2, bs, 1)  # (..., nH, nW, bs, bs)
    return blocks.reshape(*blocks.shape[:-2], bs * bs)


def _box_sums_at(field: torch.Tensor, ref: torch.Tensor, bs: int) -> torch.Tensor:
    """bs x bs box sums of the trailing (H, W) axes at the top-left positions
    ``ref`` x ``ref``: rows added one by one, then columns, in a fixed order."""
    rows = field.index_select(-2, ref)
    for i in range(1, bs):
        rows = rows + field.index_select(-2, ref + i)
    out = rows.index_select(-1, ref)
    for j in range(1, bs):
        out = out + rows.index_select(-1, ref + j)
    return out


def _block_distances(match_img: torch.Tensor, ref_pos: np.ndarray, offs: np.ndarray,
                     bs: int) -> torch.Tensor:
    """SSD between each reference block and every offset candidate.

    (..., H, W) -> (..., R, R, O*O) with R = len(ref_pos), O = len(offs),
    candidate index ``oi * O + oj``. Each squared difference is capped at
    the pad value, so a candidate reaching outside the image costs at least
    that much per outside pixel.
    """
    *lead, h, w = match_img.shape
    x = match_img.reshape(-1, h, w)
    n_off = len(offs)
    pad = int(max(-offs.min(), offs.max()))
    zp = F.pad(x, (pad, pad, pad, pad), value=_POISON)
    # (B, 2 pad + 1, 2 pad + 1, H, W) views: the image shifted by each offset
    shifted = zp.unfold(1, h, 1).unfold(2, w, 1)
    o0 = pad + int(offs[0])
    shifted = shifted[:, o0:o0 + n_off, o0:o0 + n_off]
    ref = torch.as_tensor(ref_pos, dtype=torch.long, device=x.device)
    rows = max(1, _D2_BYTES // (x.shape[0] * n_off * h * w * x.element_size()))
    fields = []
    for i0 in range(0, n_off, rows):
        d2 = x[:, None, None] - shifted[:, i0:i0 + rows]
        d2 = (d2 * d2).clamp_max_(_POISON)
        fields.append(_box_sums_at(d2, ref, bs))  # (B, rows, O, R, R)
    d = torch.cat(fields, dim=1).permute(0, 3, 4, 1, 2)
    r = len(ref_pos)
    return d.reshape(*lead, r, r, n_off * n_off)


def _coeff_distances(coeffs: torch.Tensor, ref_pos: np.ndarray, offs: np.ndarray) -> torch.Tensor:
    """SSD between per-block coefficient vectors, (..., nh, nw, C) ->
    (..., R, R, O*O); candidates outside the block grid get 1e10.

    The coarse prefiltered distance of classic BM3D at high noise (sigma >
    40/255): matching on hard-thresholded 2-D transform coefficients.
    """
    *lead, nh, nw, c = coeffs.shape
    feats = coeffs.reshape(-1, nh, nw, c)
    dev = feats.device
    ref = torch.as_tensor(ref_pos, dtype=torch.long, device=dev)
    off = torch.as_tensor(offs, dtype=torch.long, device=dev)
    r, n_off = len(ref_pos), len(offs)
    ref_feats = feats[:, ref][:, :, ref]  # (B, R, R, C)
    pj = ref[:, None] + off[None, :]  # (R, O)
    valid_j = (pj >= 0) & (pj < nw)
    pjc = pj.clamp(0, nw - 1)
    per_row = []
    for oi in offs:
        pi = ref + int(oi)
        valid = ((pi >= 0) & (pi < nh))[:, None, None] & valid_j[None]  # (R, R, O)
        cand = feats[:, pi.clamp(0, nh - 1)][:, :, pjc]  # (B, R, R, O, C)
        diff = ref_feats[:, :, :, None, :] - cand
        d = (diff * diff).sum(-1)
        per_row.append(torch.where(valid, d, torch.full_like(d, 1e10)))
    d = torch.stack(per_row, dim=-2)  # (B, R, R, O(oi), O(oj))
    return d.reshape(*lead, r, r, n_off * n_off)


def _match(match_img: torch.Tensor, ref_pos: np.ndarray, offs: np.ndarray, bs: int, k_max: int,
           tau: float, match_coeffs: Optional[torch.Tensor] = None):
    """Block matching: (positions (..., G, K, 2), counts (..., G)), int64.

    The K nearest candidates in ascending distance, the lower candidate
    index first among equal distances. ``counts`` is the largest power of
    two at or below the number of candidates with distance at most ``tau``
    (``tau`` rounded to the working dtype, as JAX's weak-typed comparison
    does), clipped to [1, k_max]. With ``match_coeffs``, distances use the
    prefiltered coefficient vectors.
    """
    if match_coeffs is not None:
        d = _coeff_distances(match_coeffs, ref_pos, offs)
    else:
        d = _block_distances(match_img, ref_pos, offs, bs)
    *lead, r, _, n2 = d.shape
    d = d.reshape(*lead, r * r, n2)
    dk, idx = torch.sort(d, dim=-1, stable=True)
    dk, idx = dk[..., :k_max], idx[..., :k_max]
    n = (dk <= float(host_scalar(tau, d.dtype))).sum(-1)
    counts = torch.ones_like(n)
    for j in range(1, int(math.log2(k_max)) + 1):
        counts = torch.where(n >= 2**j, 2**j, counts)
    dev = d.device
    off = torch.as_tensor(offs, dtype=torch.long, device=dev)
    ref = torch.as_tensor(ref_pos, dtype=torch.long, device=dev)
    n_off = len(offs)
    pi = ref.repeat_interleave(r)[:, None] + off[idx // n_off]
    pj = ref.repeat(r)[:, None] + off[idx % n_off]
    return torch.stack([pi, pj], dim=-1), counts


def _group_coeffs(t2b: torch.Tensor, pos: torch.Tensor, nw: int) -> torch.Tensor:
    """Gather 2-D transformed blocks (..., nh, nw, C) at matched positions
    (..., G, K, 2) -> (..., G, K, C)."""
    *lead, nh, _, c = t2b.shape
    flat = (pos[..., 0] * nw + pos[..., 1]).reshape(-1, *pos.shape[-3:-1])  # (B, G, K)
    b = flat.shape[0]
    rows = t2b.reshape(b * nh * nw, c)
    base = torch.arange(b, device=flat.device).view(b, 1, 1) * (nh * nw)
    return rows[flat + base].reshape(*pos.shape[:-1], c)


# ---------------------------------------------------------------------------
# Shared-prefix Haar tree stack filtering
# ---------------------------------------------------------------------------
#
# The orthonormal Haar transform is dyadic: the transform of the first 2^j
# stack rows is a prefix of the butterfly tree over all K rows, so one
# elementwise tree (K - 1 butterflies) gives every stack size's coefficients
# at once, and one select-guided inverse tree rebuilds each group at its own
# matched size. Same values as the per-size matrix filter (up to row order
# and sign, which neither |c|-thresholding, Wiener c^2 shrinkage nor the
# orthonormal inverse sees); only the float summation order differs.


def _haar_tree_fwd(groups: torch.Tensor):
    """Butterfly cascade over the stack axis of (..., K, C), K a power of 2.

    Returns (scal, det): ``scal[l]`` (..., K/2^l, C) level-l scaling
    coefficients (``scal[0]`` is the input), ``det[l]`` the level-l details
    (``det[0]`` is None). Entry i of level l is computed from input rows
    [i 2^l, (i + 1) 2^l): the prefix property.
    """
    k = groups.shape[-2]
    if k & (k - 1):
        raise ValueError(f"the Haar tree needs a power-of-two group size, got {k}")
    r2i = float(host_scalar(1.0 / np.sqrt(2.0), groups.dtype))
    scal, det = [groups], [None]
    s = groups
    while s.shape[-2] > 1:
        a, b = s[..., 0::2, :], s[..., 1::2, :]
        s = (a + b) * r2i
        det.append((a - b) * r2i)
        scal.append(s)
    return scal, det


def _interleave_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.stack([x, y], dim=-2).reshape(*x.shape[:-2], 2 * x.shape[-2], x.shape[-1])


def _tree_select_nnz(per_level, scal_root, counts: torch.Tensor, k_max: int) -> torch.Tensor:
    """The sum over the size-2^j coefficient set, 2^j selected per group by
    ``counts``. ``per_level[l]`` (..., K/2^l, C): the per-coefficient summand
    at detail level l (l >= 1); ``scal_root[j]`` (...,): the root-scaling
    summand for size 2^j."""
    n_lev = int(np.log2(k_max))
    out = torch.zeros_like(scal_root[0])
    for j in range(n_lev + 1):
        tot = scal_root[j]
        for lv in range(1, j + 1):
            tot = tot + per_level[lv][..., : 2 ** (j - lv), :].sum(dim=(-2, -1))
        out = torch.where(counts == 2**j, tot, out)
    return out


def _tree_synth(hat_s, hat_d, counts: torch.Tensor, k_max: int) -> torch.Tensor:
    """Inverse Haar tree with per-group root selection: a group of size 2^j
    rebuilds from root ``hat_s[j][..., 0, :]``; rows at or beyond its count
    come out as don't-care values that the aggregation weights zero."""
    r2i = float(host_scalar(1.0 / np.sqrt(2.0), hat_s[0].dtype))
    n_lev = int(np.log2(k_max))
    s = hat_s[n_lev]
    for lv in range(n_lev, 0, -1):
        up = _interleave_rows((s + hat_d[lv]) * r2i, (s - hat_d[lv]) * r2i)
        s = torch.where((counts >= 2**lv)[..., None, None], up, hat_s[lv - 1])
    return s


def _row_weights(w_g: torch.Tensor, counts: torch.Tensor, k_max: int) -> torch.Tensor:
    """(..., G) group weights on the stack's first ``counts`` rows, 0 after."""
    rows = torch.arange(k_max, device=counts.device)
    return torch.where(rows < counts[..., None], w_g[..., None], torch.zeros_like(w_g[..., None]))


def _per_group(x):
    """A per-image value of shape (..., 1, 1, 1) as (..., 1), to broadcast
    against per-group sums (..., G); a number as it is."""
    return x[..., 0, 0] if torch.is_tensor(x) else x


def _tree_filter_ht(groups: torch.Tensor, counts: torch.Tensor, thr, sigma2, k_max: int):
    """Hard-threshold stack filter -> (hat, wts). ``thr`` and ``sigma2``
    (sigma^2) are values of the working dtype: numbers, or per-image
    tensors of shape (..., 1, 1, 1)."""
    scal, det = _haar_tree_fwd(groups)
    keep_s = [x.abs() > thr for x in scal]
    hat_s = [torch.where(k, x, torch.zeros_like(x)) for k, x in zip(keep_s, scal)]
    keep_d = [None] + [x.abs() > thr for x in det[1:]]
    hat_d = [None] + [torch.where(k, x, torch.zeros_like(x)) for k, x in zip(keep_d[1:], det[1:])]
    dt = groups.dtype
    nnz = _tree_select_nnz(
        [None] + [k.to(dt) for k in keep_d[1:]],
        [keep_s[j][..., 0, :].to(dt).sum(-1) for j in range(len(scal))],
        counts, k_max)
    w_g = 1.0 / (_per_group(sigma2) * nnz.clamp_min(1.0))
    return _tree_synth(hat_s, hat_d, counts, k_max), _row_weights(w_g, counts, k_max)


def _tree_filter_wiener(gz: torch.Tensor, gp: torch.Tensor, counts: torch.Tensor, sigma_w2, k_max: int):
    """Wiener stack filter -> (hat, wts): the pilot's coefficients p give the
    shrinkage p^2 / (p^2 + sigma_w^2) of z's. ``sigma_w2`` as ``sigma2`` in
    :func:`_tree_filter_ht`."""
    scal_z, det_z = _haar_tree_fwd(gz)
    scal_p, det_p = _haar_tree_fwd(gp)
    wien_s = [p * p / (p * p + sigma_w2) for p in scal_p]
    wien_d = [None] + [p * p / (p * p + sigma_w2) for p in det_p[1:]]
    hat_s = [z * w for z, w in zip(scal_z, wien_s)]
    hat_d = [None] + [z * w for z, w in zip(det_z[1:], wien_d[1:])]
    wsum = _tree_select_nnz(
        [None] + [w * w for w in wien_d[1:]],
        [(wien_s[j][..., 0, :] * wien_s[j][..., 0, :]).sum(-1) for j in range(len(scal_z))],
        counts, k_max)
    w_g = 1.0 / (_per_group(sigma_w2) * wsum.clamp_min(1e-10))
    return _tree_synth(hat_s, hat_d, counts, k_max), _row_weights(w_g, counts, k_max)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def _aggregate(img_shape, hat_blocks: torch.Tensor, weights: torch.Tensor, pos: torch.Tensor,
               window: np.ndarray) -> torch.Tensor:
    """Kaiser-weighted aggregation of the filtered blocks: num / den.

    hat_blocks: (..., G, K, bs*bs) spatial-domain filtered blocks
    weights:    (..., G, K) per-block weights (0 for unused slots)
    pos:        (..., G, K, 2) top-left positions

    Each block row (values and weight) is first summed onto its top-left
    position, then bs^2 shifted adds spread the positions over the image.
    The first sum runs over the rows sorted by target (stable) with
    ``torch.segment_reduce``, each segment in a fixed order, so a call is
    bit-reproducible on the card (a CUDA scatter-add is not).
    """
    h, w = img_shape
    *lead, g, k, bsq = hat_blocks.shape
    bs = math.isqrt(bsq)
    nh, nw = h - bs + 1, w - bs + 1
    dev, dt = hat_blocks.device, hat_blocks.dtype
    win = torch.as_tensor(window.reshape(-1), dtype=dt, device=dev)
    flat = (pos[..., 0] * nw + pos[..., 1]).reshape(-1, g * k)  # (B, G K)
    b = flat.shape[0]
    keys = (flat + torch.arange(b, device=dev)[:, None] * (nh * nw)).reshape(-1)
    vals = (hat_blocks * win * weights[..., None]).reshape(-1, bsq)
    rows = torch.cat([vals, weights.reshape(-1, 1)], dim=-1)
    order = torch.sort(keys, stable=True).indices
    lengths = torch.bincount(keys, minlength=b * nh * nw)
    acc = torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0)
    acc = acc.reshape(b, nh, nw, bsq + 1)
    # (B, 2, nh, nw, bs^2): the value sums, and the weight sums times the window
    parts = torch.stack([acc[..., :bsq], acc[..., bsq:] * win], dim=1)
    canvas = torch.zeros(b, 2, h, w, dtype=dt, device=dev)
    for di in range(bs):
        for dj in range(bs):
            canvas[:, :, di:di + nh, dj:dj + nw] += parts[..., di * bs + dj]
    out = canvas[:, 0] / canvas[:, 1].clamp_min(1e-10)
    return out.reshape(*lead, h, w)


def _kron_pair(bs: int, kind: str, dec_level: int, like: torch.Tensor):
    """The (bs^2, bs^2) 2-D forward and inverse transforms, Kronecker
    products formed in float64 and cast to ``like``'s dtype."""
    t2f, t2i = tr.transform_pair(bs, kind, dec_level)
    return (torch.as_tensor(np.kron(t2f, t2f), dtype=like.dtype, device=like.device),
            torch.as_tensor(np.kron(t2i, t2i), dtype=like.dtype, device=like.device))


def _sigma_value(sigma, z: torch.Tensor):
    """sigma in z's dtype: a numpy scalar for a number; for a tensor (0-d,
    or one value an image, of shape z.shape[:-2]) a tensor of shape
    (..., 1, 1, 1) on z's device, never read on the host."""
    if torch.is_tensor(sigma):
        return sigma.to(dtype=z.dtype, device=z.device).reshape(*sigma.shape, 1, 1, 1)
    return host_scalar(sigma, z.dtype)


def _times(value, sig):
    """``value`` rounded to sig's dtype, times sig (a numpy scalar or a
    tensor), as JAX multiplies a weak-typed Python number into an array."""
    if torch.is_tensor(sig):
        return float(host_scalar(value, sig.dtype)) * sig
    return type(sig)(value) * sig


def _as_float(x):
    return x if torch.is_tensor(x) else float(x)


def ht_stage(z: torch.Tensor, sigma, profile: BM3DProfile = DEFAULT_PROFILE,
             prefilter: Optional[bool] = None) -> torch.Tensor:
    """Hard-thresholding (basic-estimate) stage of (..., H, W) images.

    ``sigma`` is a number, rounded to z's dtype, or a tensor of z's dtype
    with one value an image (shape ``z.shape[:-2]``) or one for all (0-d).
    ``prefilter`` (default: sigma > 40/255, the classic rule; off for a
    tensor sigma, which is not read) matches on hard-thresholded 2-D
    coefficients.
    """
    p = profile
    h, w = z.shape[-2:]
    bs = p.bs_ht
    nw = w - bs + 1
    sig = _sigma_value(sigma, z)
    with full_precision_matmul():
        k2f, k2i = _kron_pair(bs, p.transform_ht, p.dec_level, z)
        t2b = _extract_blocks(z, bs) @ k2f.T  # (..., nh, nw, bs^2)
        tau = p.tau_match_ht * p.tau_scale * (bs * bs) / (255.0**2)
        if prefilter is None:
            prefilter = not torch.is_tensor(sigma) and float(sigma) > 40.0 / 255.0
        match_coeffs = None
        if prefilter:
            lim = _as_float(_times(p.lambda_2d, sig))
            match_coeffs = torch.where(t2b.abs() > lim, t2b, torch.zeros_like(t2b))
        ref = _ref_grid(h - bs + 1, p.step_ht)
        pos, counts = _match(z, ref, _offsets(p.search_ht, bs), bs, p.max_3d_ht, tau, match_coeffs)
        groups = _group_coeffs(t2b, pos, nw)  # (..., G, K, bs^2)
        thr = _as_float(_times(p.lambda_thr3d, sig))
        hat, wts = _tree_filter_ht(groups, counts, thr, _as_float(sig * sig), p.max_3d_ht)
        hat_spatial = hat @ k2i.T
    return _aggregate((h, w), hat_spatial, wts, pos, tr.kaiser_window(bs, p.beta))


def wiener_stage(z: torch.Tensor, pilot: torch.Tensor, sigma, profile: BM3DProfile = DEFAULT_PROFILE) -> torch.Tensor:
    """Wiener (final-estimate) stage with the HT output as pilot; matching
    runs on the pilot. ``sigma`` as in :func:`ht_stage`.

    The Wiener variance is mu^2 sigma^2 (the reference multiplies the PSD
    by mu2 before the Wiener call, ``__init__.py:293-299``)."""
    p = profile
    h, w = z.shape[-2:]
    bs = p.bs_wie
    nw = w - bs + 1
    sig = _sigma_value(sigma, z)
    with full_precision_matmul():
        k2f, k2i = _kron_pair(bs, p.transform_wie, 0, z)
        t2b_z = _extract_blocks(z, bs) @ k2f.T
        t2b_p = _extract_blocks(pilot, bs) @ k2f.T
        tau = p.tau_match_wie * p.tau_scale * (bs * bs) / (255.0**2)
        ref = _ref_grid(h - bs + 1, p.step_wie)
        pos, counts = _match(pilot, ref, _offsets(p.search_wie, bs), bs, p.max_3d_wie, tau)
        gz = _group_coeffs(t2b_z, pos, nw)
        gp = _group_coeffs(t2b_p, pos, nw)
        sigma_w = _times(np.sqrt(p.mu2), sig)
        hat, wts = _tree_filter_wiener(gz, gp, counts, _as_float(sigma_w * sigma_w), p.max_3d_wie)
        hat_spatial = hat @ k2i.T
    return _aggregate((h, w), hat_spatial, wts, pos, tr.kaiser_window(bs, p.beta_wie))


def bm3d(z, sigma, profile: BM3DProfile = DEFAULT_PROFILE, stages: str = "all",
         prefilter: Optional[bool] = None, device=None) -> torch.Tensor:
    """Two-stage BM3D for white noise of std ``sigma`` ([0, 1] scale).

    ``z``: (..., H, W), a tensor or an array, moved to ``device`` (None: the
    CUDA card) with its dtype kept; leading axes are independent images.
    ``sigma``: a number, or a tensor with one std an image (shape
    ``z.shape[:-2]``) or one for all, which stays on the device.
    ``stages``: 'all' (HT then Wiener, the reference default) or 'ht'.
    ``prefilter`` selects coarse prefiltered block matching; by default it
    is on for a number sigma > 40/255, the classic rule, and off for a
    tensor sigma (as the JAX package has it for a traced one). Matches the
    reference entry ``bm3d(z, sigma_psd)`` with ``sigma = sqrt(psd / (H W))``
    for white PSDs.
    """
    if stages not in ("all", "ht"):
        raise ValueError(f"stages must be 'all' or 'ht', got {stages!r}")
    z = torch.as_tensor(z, device=resolve_device(device))
    if prefilter is None:
        prefilter = not torch.is_tensor(sigma) and float(sigma) > 40.0 / 255.0
    yb = ht_stage(z, sigma, profile, prefilter=bool(prefilter))
    if stages == "ht":
        return yb
    return wiener_stage(z, yb, sigma, profile)


def bm3d_from_psd(z, psd, profile: BM3DProfile = DEFAULT_PROFILE, prefilter: Optional[bool] = None,
                  device=None) -> torch.Tensor:
    """Reference-compatible entry taking a white PSD array."""
    h, w = np.shape(z)[-2:]
    sigma = np.sqrt(float(np.mean(np.asarray(psd))) / (h * w))
    return bm3d(z, sigma, profile, prefilter=prefilter, device=device)


# ---------------------------------------------------------------------------
# The per-size matrix filter (the colored stages and the staged API)
# ---------------------------------------------------------------------------


def _haar_bank(k_max: int, like: torch.Tensor):
    """(sizes, forward, inverse): the Haar stack transforms of the sizes 1,
    2, 4, ..., ``k_max``, rounded to float32 and then cast to ``like``'s
    dtype, as the JAX package's ``_haar_bank`` keeps them in float32 in
    every dtype (its float64 products promote the float32 values)."""
    fwd, inv = tr.stack_transforms(k_max, "haar")
    sizes = sorted(fwd)

    def cast(m):
        return torch.as_tensor(m.astype(np.float32), device=like.device).to(like.dtype)

    return sizes, [cast(fwd[s]) for s in sizes], [cast(inv[s]) for s in sizes]


def _select_size(hat, wts, blocks_s, w_g, counts, s: int, k_max: int):
    """Take the size-s result for the groups whose count is s: the filtered
    stack (..., G, s, C), padded to k_max rows, and its group weight
    (..., G) on the first s rows."""
    sel = counts == s
    blocks = F.pad(blocks_s, (0, 0, 0, k_max - s))
    hat = torch.where(sel[..., None, None], blocks, hat)
    rows = torch.arange(k_max, device=counts.device) < s
    w_b = torch.where(rows, w_g[..., None], torch.zeros_like(w_g[..., None]))
    return hat, torch.where(sel[..., None], w_b, wts)


# ---------------------------------------------------------------------------
# Colored noise: per-coefficient variances from a PSD
# ---------------------------------------------------------------------------

_VAR_BYTES = 1 << 29  # bound on one chunk of gathered covariances


def _basis_responses(bs: int, kind: str, h: int, w: int):
    """|FFT_{H x W}(b_uv)|^2 of each 2-D transform basis patch b_uv (the
    inverse transform's columns' outer products, zero-padded), in order."""
    t2f, _ = tr.transform_pair(bs, kind)
    tinv = np.linalg.inv(t2f)
    for u in range(bs):
        for v in range(bs):
            pad = np.zeros((h, w))
            pad[:bs, :bs] = np.outer(tinv[:, u], tinv[:, v])
            yield u * bs + v, np.abs(np.fft.fft2(pad)) ** 2


def psd_to_coeff_stds(psd: np.ndarray, kind: str, bs: int = 8, dec_level: int = 0) -> np.ndarray:
    """Noise std of each 2-D transform coefficient under stationary noise.

    For a PSD P(k) (DC at the corner, the ``var * H * W`` convention of
    ``data/noise.white_noise_psd``) the variance of coefficient (u, v) of any
    bs x bs block is ``(1 / (H W)^2) sum_k P(k) |FFT_{HxW}(b_uv)(k)|^2``, with
    b_uv the (u, v) basis patch zero-padded to the image size. For a flat
    PSD it is sigma^2 ||row_u||^2 ||row_v||^2. Returns (bs*bs,) float64.
    Host numpy, as the JAX package's; ``dec_level`` is accepted and unused
    there too.
    """
    h, w = psd.shape[-2:]
    psd = np.asarray(psd, np.float64)
    stds = np.zeros(bs * bs)
    for c, resp in _basis_responses(bs, kind, h, w):
        var = float((psd * resp).sum()) / (h * w) ** 2
        stds[c] = np.sqrt(max(var, 0.0))
    return stds


def coeff_cov_field(psd: np.ndarray, kind: str, bs: int = 8, radius: int = 32, dec_level: int = 0) -> np.ndarray:
    """Cross-covariance of each 2-D transform coefficient between two blocks
    at offset (dr, dc) under stationary noise with the given PSD:
    ``cov_c(d) = (1 / (HW)^2) sum_k P(k) |B_c(k)|^2 e^{+j 2 pi k.d / N}``, an
    inverse FFT cropped circularly to |dr|, |dc| <= radius. Returns
    (bs*bs, 2r+1, 2r+1) float32, centered: ``out[c, r + dr, r + dc]``. At
    d = 0 it equals ``psd_to_coeff_stds(...)**2``. The quantity behind the
    reference C binaries' exact transform-domain variances for correlated
    noise (Makinen, Azzari, Foi 2020).
    """
    h, w = psd.shape[-2:]
    psd = np.asarray(psd, np.float64)
    d = 2 * radius + 1
    idx_r = np.arange(-radius, radius + 1) % h
    idx_c = np.arange(-radius, radius + 1) % w
    out = np.zeros((bs * bs, d, d), np.float32)
    for c, resp in _basis_responses(bs, kind, h, w):
        cov = np.real(np.fft.ifft2(psd * resp)) / (h * w)
        out[c] = cov[np.ix_(idx_r, idx_c)]
    return out


def _exact_group_vars(pos_s: torch.Tensor, covf: torch.Tensor, hf: torch.Tensor, radius: int) -> torch.Tensor:
    """Exact noise variance of every 3-D (stack-transformed) coefficient.

    pos_s: (..., G, s, 2) matched top-left positions; covf: (C, D, D), the
    field of ``coeff_cov_field`` in the working dtype; hf: (s, s), the
    forward stack transform. Returns (..., G, s, C):
    ``var[g, j, c] = sum_{i, i'} hf[j, i] hf[j, i'] cov_c(p_i - p_i')``, at
    least 1e-12. The (n, s, s, C) covariances of n groups are gathered at a
    time (a bounded chunk), then contracted as a product with hf over i and
    a weighted sum over i'.
    """
    *lead, g, s, _ = pos_s.shape
    c, d, _ = covf.shape
    rows = covf.reshape(c, d * d).T.contiguous()  # (D*D, C): one row an offset
    flat = pos_s.reshape(-1, s, 2)
    out = torch.empty(flat.shape[0], s, c, dtype=covf.dtype, device=covf.device)
    chunk = max(1, _VAR_BYTES // (s * s * c * covf.element_size()))
    for n0 in range(0, flat.shape[0], chunk):
        p = flat[n0:n0 + chunk]
        n = p.shape[0]
        dr = p[:, :, None, 0] - p[:, None, :, 0] + radius
        dc = p[:, :, None, 1] - p[:, None, :, 1] + radius
        covm = rows[dr * d + dc]  # (n, s, s, C): [g, i, i', c]
        t = torch.matmul(hf, covm.reshape(n, s, s * c)).reshape(n, s, s, c)  # sum over i
        out[n0:n0 + n] = (t * hf[:, :, None]).sum(2)  # sum over i'
    return out.clamp_min(1e-12).reshape(*lead, g, s, c)


def ht_stage_colored(z: torch.Tensor, coeff_stds: np.ndarray, match_sigma: float,
                     profile: BM3DProfile = DEFAULT_PROFILE, cov_field=None, cov_radius: int = 32,
                     match_weights: Optional[np.ndarray] = None, lam=None) -> torch.Tensor:
    """HT stage with per-coefficient thresholds (colored noise) of (..., H, W)
    images.

    ``coeff_stds``: (bs*bs,) stds from ``psd_to_coeff_stds`` for the HT
    transform; ``match_sigma`` the average std, which decides the prefilter
    (> 40/255). Group weights use the sum of the retained coefficients'
    variances. With ``cov_field`` (``coeff_cov_field``), the thresholds use
    the exact per-group 3-D coefficient variances from the matched blocks'
    relative positions; the joint DC is never thresholded. ``lam``: the
    threshold multiplier (default ``profile.lambda_thr3d``), a number or a
    tensor with one value an image. The stacks are filtered by the per-size
    matrix loop, as the JAX package does on every backend.
    """
    p = profile
    h, w = z.shape[-2:]
    bs = p.bs_ht
    nw = w - bs + 1
    dt, dev = z.dtype, z.device
    lam_v = _sigma_value(p.lambda_thr3d if lam is None else lam, z)
    with full_precision_matmul():
        k2f, k2i = _kron_pair(bs, p.transform_ht, p.dec_level, z)
        t2b = _extract_blocks(z, bs) @ k2f.T
        tau = p.tau_match_ht * p.tau_scale * (bs * bs) / (255.0**2)
        match_coeffs = None
        if match_sigma > 40.0 / 255.0:
            thr2d = torch.as_tensor(p.lambda_2d * coeff_stds, dtype=dt, device=dev)
            match_coeffs = torch.where(t2b.abs() > thr2d, t2b, torch.zeros_like(t2b))
        elif match_weights is not None:
            match_coeffs = t2b * torch.as_tensor(np.sqrt(match_weights), dtype=dt, device=dev)
        ref = _ref_grid(h - bs + 1, p.step_ht)
        pos, counts = _match(z, ref, _offsets(p.search_ht, bs), bs, p.max_3d_ht, tau, match_coeffs)
        groups = _group_coeffs(t2b, pos, nw)
        stds_d = torch.as_tensor(coeff_stds, dtype=dt, device=dev)
        vars_d = stds_d * stds_d
        thr = lam_v * stds_d
        covf = None if cov_field is None else torch.as_tensor(cov_field, device=dev).to(dt)
        hat = torch.zeros_like(groups)
        wts = groups.new_zeros(*groups.shape[:-2], p.max_3d_ht)
        for s, hf, hi in zip(*_haar_bank(p.max_3d_ht, z)):
            c3 = hf @ groups[..., :s, :]
            if covf is not None:
                vars_s = _exact_group_vars(pos[..., :s, :], covf, hf, cov_radius)
                keep = c3.abs() > lam_v * vars_s.sqrt()
                keep[..., 0, 0] = True  # the joint DC (stack mean, 2-D DC) is kept
                kept_var = (keep * vars_s).sum(dim=(-2, -1))
                floor = vars_s.mean(dim=(-2, -1))
            else:
                keep = c3.abs() > thr
                kept_var = (keep * vars_d).sum(dim=(-2, -1))
                floor = vars_d.mean()
            c3 = torch.where(keep, c3, torch.zeros_like(c3))
            w_g = 1.0 / torch.maximum(kept_var, floor + 1e-12)
            hat, wts = _select_size(hat, wts, hi @ c3, w_g, counts, s, p.max_3d_ht)
        hat_spatial = hat @ k2i.T
    return _aggregate((h, w), hat_spatial, wts, pos, tr.kaiser_window(bs, p.beta))


def wiener_stage_colored(z: torch.Tensor, pilot: torch.Tensor, coeff_stds: np.ndarray,
                         profile: BM3DProfile = DEFAULT_PROFILE, cov_field=None,
                         cov_radius: int = 32) -> torch.Tensor:
    """Wiener stage with per-coefficient noise variances (colored noise),
    mu^2 times the coefficient variances; ``cov_field`` as in
    :func:`ht_stage_colored`."""
    p = profile
    h, w = z.shape[-2:]
    bs = p.bs_wie
    nw = w - bs + 1
    dt, dev = z.dtype, z.device
    with full_precision_matmul():
        k2f, k2i = _kron_pair(bs, p.transform_wie, 0, z)
        t2b_z = _extract_blocks(z, bs) @ k2f.T
        t2b_p = _extract_blocks(pilot, bs) @ k2f.T
        tau = p.tau_match_wie * p.tau_scale * (bs * bs) / (255.0**2)
        ref = _ref_grid(h - bs + 1, p.step_wie)
        pos, counts = _match(pilot, ref, _offsets(p.search_wie, bs), bs, p.max_3d_wie, tau)
        gz = _group_coeffs(t2b_z, pos, nw)
        gp = _group_coeffs(t2b_p, pos, nw)
        vars_w = torch.as_tensor(coeff_stds**2 * p.mu2, dtype=dt, device=dev)
        mu2 = float(host_scalar(p.mu2, dt))
        covf = None if cov_field is None else torch.as_tensor(cov_field, device=dev).to(dt)
        hat = torch.zeros_like(gz)
        wts = gz.new_zeros(*gz.shape[:-2], p.max_3d_wie)
        for s, hf, hi in zip(*_haar_bank(p.max_3d_wie, z)):
            cz = hf @ gz[..., :s, :]
            cp = hf @ gp[..., :s, :]
            var = vars_w if covf is None else mu2 * _exact_group_vars(pos[..., :s, :], covf, hf, cov_radius)
            wien = cp * cp / (cp * cp + var)
            w_g = 1.0 / (wien * wien * var).sum(dim=(-2, -1)).clamp_min(1e-10)
            hat, wts = _select_size(hat, wts, hi @ (cz * wien), w_g, counts, s, p.max_3d_wie)
        hat_spatial = hat @ k2i.T
    return _aggregate((h, w), hat_spatial, wts, pos, tr.kaiser_window(bs, p.beta_wie))


def bm3d_colored(z, psd: np.ndarray, profile: BM3DProfile = DEFAULT_PROFILE, exact: bool = False,
                 lam=None, device=None) -> torch.Tensor:
    """Two-stage BM3D for stationary colored noise of a given PSD (DC at the
    corner, the ``var * H * W`` convention), shared by the images of z
    (..., H, W): PSD-derived per-coefficient thresholds, and with ``exact``
    the exact 3-D coefficient variances of each group. ``lam`` overrides the
    HT threshold multiplier (a number or one an image); ``device`` as in
    :func:`bm3d`.
    """
    z = torch.as_tensor(z, device=resolve_device(device))
    psd = np.asarray(psd, np.float64)
    h, w = z.shape[-2:]
    match_sigma = float(np.sqrt(psd.mean() / (h * w)))
    stds_ht = psd_to_coeff_stds(psd, profile.transform_ht, profile.bs_ht, dec_level=profile.dec_level)
    stds_wie = psd_to_coeff_stds(psd, profile.transform_wie, profile.bs_wie)
    cov_ht = cov_wie = None
    if exact:
        cov_ht = coeff_cov_field(psd, profile.transform_ht, profile.bs_ht, dec_level=profile.dec_level)
        cov_wie = coeff_cov_field(psd, profile.transform_wie, profile.bs_wie)
    yb = ht_stage_colored(z, stds_ht, match_sigma, profile, cov_field=cov_ht, lam=lam)
    return wiener_stage_colored(z, yb, stds_wie, profile, cov_field=cov_wie)


def _freq_radius(h: int, w: int) -> np.ndarray:
    """Distance of each DFT bin from DC, on the circular frequency grid."""
    fy = np.minimum(np.arange(h), h - np.arange(h))
    fx = np.minimum(np.arange(w), w - np.arange(w))
    return np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)


def spectral_gate(z, psd: np.ndarray, concentration: float = 16.0, eps: float = 8.0,
                  dc_guard_frac: float = 0.08):
    """Suppress narrowband noise with an empirical-Wiener gate in the global
    FFT of each image of z (..., H, W).

    On the bins where the PSD exceeds ``concentration * mean(PSD)``, outside
    a ``dc_guard_frac`` disk around DC, the spectrum is scaled by S / (S +
    eps P), S = max(|Z|^2 - P, 0) the single-realization signal-power
    estimate; flat PSDs have no such bins and pass unchanged. The gate runs
    in float64 whatever z's dtype (the JAX package does when x64 is on), and
    the gated images come back in z's dtype. Returns (gated images, the PSD
    times the gate's square), the PSD from image 0's gate, as the JAX
    package returns it for a batch. No reference counterpart.
    """
    z = torch.as_tensor(z)
    h, w = z.shape[-2:]
    psd_t = torch.as_tensor(np.asarray(psd, np.float64), device=z.device)
    guard = torch.as_tensor(_freq_radius(h, w) <= dc_guard_frac * min(h, w), device=z.device)
    hot = (psd_t > concentration * psd_t.mean()) & ~guard
    zf = torch.fft.fft2(z.to(torch.float64))
    s_emp = (zf.abs() ** 2 - psd_t).clamp_min(0.0)
    att = torch.where(hot, s_emp / (s_emp + eps * psd_t + 1e-12), torch.ones_like(s_emp))
    zg = torch.real(torch.fft.ifft2(zf * att)).to(z.dtype)
    att0 = att.reshape(-1, h, w)[0].cpu().numpy()
    return zg, np.asarray(psd) * att0**2


def adaptive_pilot_lambda(z, psd: np.ndarray, hot_conc: float = 8.0, dc_guard_frac: float = 0.08,
                          hot_energy_thr: float = 0.5, sparsity_thr: float = 0.45,
                          hard_lambda: float = 8.0) -> Optional[float]:
    """Scene-adaptive HT-pilot threshold for narrowband noise, of one (H, W)
    image on the host.

    ``hard_lambda`` when both (a) the PSD's away-from-DC hot bins (>
    ``hot_conc`` x mean, outside the ``dc_guard_frac`` DC disk) carry more
    than ``hot_energy_thr`` of the noise energy, and (b) the top 0.1% of
    z's non-hot spectrum bins carry more than ``sparsity_thr`` of its
    out-of-band energy (a patch-sparse scene); else None (keep the
    estimated lambda). The JAX package's decision, measured there: a hard
    pilot is worth 1.5-15 dB on synthetic scenes under narrowband noise and
    over-smooths natural images.
    """
    psd = np.asarray(psd, np.float64)
    h, w = psd.shape[-2:]
    rr = _freq_radius(h, w)
    hot = (psd > hot_conc * psd.mean()) & (rr > dc_guard_frac * min(h, w))
    if not hot.any() or psd[hot].sum() / psd.sum() <= hot_energy_thr:
        return None
    zf = np.abs(np.fft.fft2(np.asarray(z, np.float64))) ** 2
    e = np.sort(zf[~hot & (rr > 2)])[::-1]
    topk = max(1, int(0.001 * e.size))
    if e[:topk].sum() / max(e.sum(), 1e-30) <= sparsity_thr:
        return None
    return hard_lambda


def bm3d_colored_auto(z, psd: np.ndarray, profile: BM3DProfile = DEFAULT_PROFILE,
                      gate_concentration: Optional[float] = None, exact: bool = True, auto_params: bool = True,
                      pilot_lambda: Optional[float] = None, adaptive_pilot: bool = True,
                      device=None) -> torch.Tensor:
    """Colored-noise BM3D: estimated parameters and exact variances, the
    entry point for arbitrary stationary noise of a PSD shared by the images
    of z (..., H, W).

    ``auto_params`` estimates PSD-matched (lambda, mu^2) with the
    reference's feature-matching estimator (``psd_params``; a colored PSD
    needs its database, ``param_matching_data.mat``); without it the
    profile's values are used. ``pilot_lambda`` overrides the HT threshold
    multiplier alone (the HT output only serves as the Wiener pilot); with
    ``adaptive_pilot`` and no ``pilot_lambda`` it is decided per image by
    :func:`adaptive_pilot_lambda` (z is copied to the host once a call), so
    the images of a batch may take different values.
    ``gate_concentration`` first applies :func:`spectral_gate` at that
    threshold. ``device`` as in :func:`bm3d`.
    """
    z = torch.as_tensor(z, device=resolve_device(device))
    psd = np.asarray(psd, np.float64)
    if gate_concentration is not None:
        z, psd = spectral_gate(z, psd, gate_concentration)
    floor = float(np.mean(psd)) * 1e-3 + 1e-20
    psd_g = np.maximum(psd, floor)
    if auto_params:
        from pnp_admm_cnc_mri_torch.priors.bm3d import psd_params

        lam, mu2, _, _ = psd_params.estimate_parameters_for_psd(psd_params.shrink_and_normalize_psd(psd_g))
        profile = dataclasses.replace(profile, lambda_thr3d=lam, mu2=mu2)
    lam_img = None
    if pilot_lambda is not None:
        profile = dataclasses.replace(profile, lambda_thr3d=pilot_lambda)
    elif adaptive_pilot:
        pilots = [adaptive_pilot_lambda(img, psd_g) for img in z.detach().reshape(-1, *z.shape[-2:]).cpu().numpy()]
        lams = [profile.lambda_thr3d if pl is None else pl for pl in pilots]
        if len(set(lams)) == 1:
            profile = dataclasses.replace(profile, lambda_thr3d=lams[0])
        else:
            lam_img = torch.as_tensor(np.asarray(lams).reshape(z.shape[:-2]), dtype=z.dtype, device=z.device)
    return bm3d_colored(z, psd_g, profile, exact=exact, lam=lam_img, device=z.device)
