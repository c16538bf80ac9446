"""BM3D's white-noise core against the JAX package, on the CPU.

The same numpy images go through ``pnp_admm_cnc_mri_tpu.priors.bm3d`` and
the port's ``priors/bm3d`` at 48 x 48 and 64 x 64 (one image; three for the
batched cases). The JAX package filters the stacks with its per-size matrix
loop on the CPU and with the Haar tree elsewhere; the port runs the tree on
every device, so each stage is held against both JAX forms (the tree one is
chosen with ``core._STACK_FILTER_TREE``, JAX's compiled caches cleared
around it). Tolerances (max abs):

- float64 against JAX's tree form: 1e-9 (measured 7e-16);
- float64 against JAX's matrix form: 1e-7 (measured 2.8e-8: JAX's
  ``_haar_bank`` keeps the Haar matrices in float32 in every dtype);
- float32 against either form: 2e-5 (measured 6.6e-7, and 5.3e-6 where a
  float32 rounding flips one threshold decision at 64 x 64);
- distances, positions and counts: equal in float64 on the tie-free test
  images, identical positions in both dtypes on the dyadic tie image.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore
from pnp_admm_cnc_mri_tpu.priors.bm3d import transforms as jtr
from pnp_admm_cnc_mri_torch.priors.bm3d import core, transforms as tr

CPU = "cpu"
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
ATOL = {torch.float64: 1e-9, torch.float32: 2e-5}
MATRIX_F64_ATOL = 1e-7
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
SIZES = pytest.mark.parametrize("n", [48, 64])
FORMS = pytest.mark.parametrize("tree", [True, False], ids=["jax_tree", "jax_matrix"])
SIGMA = 0.1


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_form():
    """Set JAX's stack-filter form for one test; its compiled BM3D (traced
    with the form of the moment) is dropped before and after."""
    def use(tree: bool):
        jax.clear_caches()
        jcore._STACK_FILTER_TREE = tree

    yield use
    jcore._STACK_FILTER_TREE = None
    jax.clear_caches()


def _image(n, seed=0, noise=SIGMA):
    """A smooth disc on a flat background, plus white noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    x = 0.5 + 0.3 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    x = np.where((xx - n / 2) ** 2 + (yy - n / 2) ** 2 < (n / 3) ** 2, x, 0.1)
    return x + noise * rng.standard_normal((n, n))


def _tie_image(n=48):
    """Piecewise-constant, dyadic levels on a zero background: every squared
    difference and every partial sum is exact in float32, so equal
    distances are exact ties in any summation order, and there are many
    (flat regions give distance 0)."""
    yy, xx = np.mgrid[:n, :n]
    img = np.zeros((n, n))
    img[(xx >= 8) & (xx < 30) & (yy >= 6) & (yy < 40)] = 0.5
    img[(xx - 30) ** 2 + (yy - 28) ** 2 < 90] = 0.75
    img[(yy // 4 + xx // 4) % 5 == 0] += 0.25
    return img


def _tol(dtype, tree):
    return MATRIX_F64_ATOL if (dtype == torch.float64 and not tree) else ATOL[dtype]


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


def _both(a, dtype):
    """(port tensor, JAX array) of one numpy array in one dtype."""
    return torch.as_tensor(np.asarray(a), dtype=dtype), jnp.asarray(a, JNP[dtype])


# -- transforms, window, profiles ----------------------------------------------


@pytest.mark.parametrize("n,kind,dec", [(8, "bior1.5", 0), (8, "bior1.5", 1), (16, "bior1.5", 0),
                                        (16, "bior1.5", 2), (4, "haar", 0), (32, "haar", 0),
                                        (8, "dct", 0), (12, "dct", 0), (8, "dst", 0), (1, "dct", 0)])
def test_transform_pairs_equal_the_jax_packages(n, kind, dec):
    f, i = tr.transform_pair(n, kind, dec)
    jf, ji = jtr.transform_pair(n, kind, dec)
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-12)
    np.testing.assert_allclose(i, ji, rtol=0, atol=1e-9)


def test_wavelets_and_window_equal_the_jax_packages():
    x = np.random.default_rng(0).standard_normal(16)
    for wav in ("bior1.5", "haar"):
        for a, b in zip(tr.wavedec_vector(x, wav), jtr.wavedec_vector(x, wav)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tr.wavelet_matrix(8, wav), jtr.wavelet_matrix(8, wav))
    for n, beta in ((8, 2.0), (11, 1.5), (8, 0.0)):
        np.testing.assert_array_equal(tr.kaiser_window(n, beta), jtr.kaiser_window(n, beta))
    np.testing.assert_array_equal(tr.dct_matrix(8), jtr.dct_matrix(8))


def test_dst_matrix_is_scipys():
    from scipy.fftpack import dst

    for n in (4, 8, 11):
        np.testing.assert_allclose(tr.dst_matrix(n), dst(np.eye(n), norm="ortho"), rtol=0, atol=1e-14)


def test_every_profile_field_equals_the_jax_packages():
    assert list(core.PROFILES) == list(jcore.PROFILES)
    for name, prof in core.PROFILES.items():
        assert dataclasses.asdict(prof) == dataclasses.asdict(jcore.PROFILES[name]), name
        assert core.get_profile(name) is prof
    assert [f.name for f in dataclasses.fields(core.BM3DProfile)] == \
        [f.name for f in dataclasses.fields(jcore.BM3DProfile)]
    assert core.get_profile(core.PROFILES["lc"]) is core.PROFILES["lc"]
    with pytest.raises(ValueError, match="unknown BM3D profile"):
        core.get_profile("nope")


# -- geometry, distances, matching ---------------------------------------------


def test_geometry_equals_the_jax_packages():
    for n_pos, step in ((41, 3), (57, 3), (249, 3), (10, 4), (9, 4)):
        np.testing.assert_array_equal(core._ref_grid(n_pos, step), jcore._ref_grid(n_pos, step))
    for search, bs in ((39, 8), (25, 8), (39, 11)):
        np.testing.assert_array_equal(core._offsets(search, bs), jcore._offsets(search, bs))
    z = _image(20)
    blocks = core._extract_blocks(torch.as_tensor(z), 8)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jcore._extract_blocks(jnp.asarray(z), 8)))
    batched = core._extract_blocks(torch.as_tensor(np.stack([z, 2 * z])), 8)
    assert torch.equal(batched[1], 2 * blocks)


@SIZES
@pytest.mark.parametrize("search", [39, 25])
def test_block_distances_equal_both_jax_forms_on_valid_candidates(n, search):
    z = _image(n, seed=n)
    ref, offs = core._ref_grid(n - 7, 3), core._offsets(search, 8)
    got = core._block_distances(torch.as_tensor(z), ref, offs, 8).numpy()
    conv = np.asarray(jcore._block_distances(jnp.asarray(z), ref, offs, 8))
    mm = np.asarray(jcore._block_distances_matmul(jnp.asarray(z), ref, offs, 8))
    assert got.shape == conv.shape == (len(ref), len(ref), len(offs) ** 2)
    ok = conv < 1e3  # candidates inside the image
    assert ok.mean() > 0.5
    np.testing.assert_allclose(got[ok], conv[ok], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[ok], mm[ok], rtol=0, atol=1e-12)
    assert got[~ok].min() >= 1e4  # poisoned candidates stay poisoned


def test_block_distances_chunking_and_batching_give_the_same_values(monkeypatch):
    z = np.stack([_image(40, seed=s) for s in range(3)])
    ref, offs = core._ref_grid(33, 3), core._offsets(39, 8)
    whole = core._block_distances(torch.as_tensor(z), ref, offs, 8)
    monkeypatch.setattr(core, "_D2_BYTES", 1)  # one offset row a chunk
    chunked = core._block_distances(torch.as_tensor(z), ref, offs, 8)
    assert torch.equal(whole, chunked)
    assert torch.equal(whole[2], core._block_distances(torch.as_tensor(z[2]), ref, offs, 8))


@SIZES
@DTYPES
def test_coeff_distances_equal_the_jax_packages(n, dtype):
    rng = np.random.default_rng(n)
    coeffs = np.where(rng.random((n - 7, n - 7, 64)) < 0.3, rng.standard_normal((n - 7, n - 7, 64)), 0.0)
    ref, offs = core._ref_grid(n - 7, 3), core._offsets(39, 8)
    got = core._coeff_distances(_both(coeffs, dtype)[0], ref, offs)
    want = np.asarray(jcore._coeff_distances(jnp.asarray(coeffs, JNP[dtype]), ref, offs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12 if dtype == torch.float64 else 1e-5, atol=0)


@SIZES
@DTYPES
@pytest.mark.parametrize("k,tau", [(16, 1.4), (32, 1.5)])
def test_match_positions_and_counts_equal_the_jax_packages(n, dtype, k, tau):
    z, jz = _both(_image(n, seed=n + 1), dtype)
    ref, offs = core._ref_grid(n - 7, 3), core._offsets(39, 8)
    pos, counts = core._match(z, ref, offs, 8, k, tau)
    jpos, jcounts = jcore._match(jz, ref, offs, 8, k, tau)
    assert tuple(pos.shape) == (len(ref) ** 2, k, 2) and pos.dtype == torch.long
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert len(set(counts.tolist())) > 2  # several group sizes
    if dtype == torch.float64:
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    else:  # float32: the groups' used rows (a near-tie may order the tail apart)
        p, jp, c = pos.numpy(), np.asarray(jpos), counts.numpy()
        same = np.mean([np.array_equal(p[g, :c[g]], jp[g, :c[g]]) for g in range(len(c))])
        assert same > 0.99, same


@DTYPES
@pytest.mark.parametrize("k,tau", [(16, 0.5), (32, 0.2)])
def test_match_breaks_exact_ties_by_the_lower_index_like_jax(dtype, k, tau):
    z, jz = _both(_tie_image(), dtype)
    ref, offs = core._ref_grid(41, 3), core._offsets(39, 8)
    d = core._block_distances(z, ref, offs, 8).reshape(len(ref) ** 2, -1)
    kth = torch.sort(d, dim=-1).values[:, k - 1:k]
    assert float((d == kth).sum(-1).float().mean()) > 4  # ties straddle the k-th place
    pos, counts = core._match(z, ref, offs, 8, k, tau)
    jpos, jcounts = jcore._match(jz, ref, offs, 8, k, tau)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("k", [16, 32])
def test_group_sizes_are_the_largest_power_of_two_within_tau(k):
    z = torch.as_tensor(_image(48, seed=3))
    ref, offs = core._ref_grid(41, 3), core._offsets(39, 8)
    d = core._block_distances(z, ref, offs, 8).reshape(len(ref) ** 2, -1)
    _, counts = core._match(z, ref, offs, 8, k, 0.3)
    within = (torch.sort(d, dim=-1).values[:, :k] <= 0.3).sum(-1).clamp_min(1)
    expect = torch.tensor([1 << (int(c).bit_length() - 1) for c in within])
    assert torch.equal(counts, expect)


def test_group_coeffs_gather_equal_the_jax_packages():
    rng = np.random.default_rng(4)
    t2b = rng.standard_normal((2, 33, 33, 64))
    pos = rng.integers(0, 33, size=(2, 121, 16, 2))
    got = core._group_coeffs(torch.as_tensor(t2b), torch.as_tensor(pos), 33)
    for b in range(2):
        want = np.asarray(jcore._group_coeffs(jnp.asarray(t2b[b]), jnp.asarray(pos[b]), 33))
        np.testing.assert_array_equal(got[b].numpy(), want)


# -- stack filters ---------------------------------------------------------------


def _groups(g=64, k=16, seed=11):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((g, k, 64)) * 0.1, rng.choice([s for s in (1, 2, 4, 8, 16, 32) if s <= k], size=g)


@DTYPES
@pytest.mark.parametrize("k", [16, 32])
def test_tree_filters_equal_the_jax_tree_and_matrix_filters(dtype, k):
    groups, counts = _groups(k=k)
    pilot = groups + 0.05 * np.random.default_rng(12).standard_normal(groups.shape)
    g, jg = _both(groups, dtype)
    p, jp = _both(pilot, dtype)
    c, jc = torch.as_tensor(counts), jnp.asarray(counts, jnp.int32)
    s = JNP[dtype](SIGMA)
    thr, s2w = float(JNP[dtype](3.0) * s), float((s * JNP[dtype](np.sqrt(0.4))) ** 2)
    hat, wts = core._tree_filter_ht(g, c, thr, float(s * s), k)
    jhat, jwts = jcore._tree_filter_ht(jg, jc, JNP[dtype](thr), s, k)
    hat_w, wts_w = core._tree_filter_wiener(g, p, c, s2w, k)
    jhat_w, jwts_w = jcore._tree_filter_wiener(jg, jp, jc, s * JNP[dtype](np.sqrt(0.4)), k)
    atol = ATOL[dtype]
    for got, want, gw, ww, what in ((hat, jhat, wts, jwts, "ht"), (hat_w, jhat_w, wts_w, jwts_w, "wiener")):
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=atol, atol=0, err_msg=what)
        rows = np.arange(k)[None, :] < counts[:, None]
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], rtol=0, atol=atol, err_msg=what)
    # the matrix form of the JAX package (its Haar bank is float32, hence 1e-6 in float64)
    sizes, hf, hi = jcore._haar_bank(k)
    for idx in range(len(counts)):
        sz = int(counts[idx])
        h3 = np.asarray(hf[sizes.index(sz)], np.float64) @ groups[idx, :sz]
        h3 = np.where(np.abs(h3) > thr, h3, 0.0)
        ref = np.asarray(hi[sizes.index(sz)], np.float64) @ h3
        np.testing.assert_allclose(hat[idx, :sz].double().numpy(), ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(wts[idx, 0]), 1.0 / (float(s) ** 2 * max((h3 != 0).sum(), 1)), rtol=1e-6)
    assert float(wts[counts < k][:, -1].abs().max()) == 0.0  # no weight beyond a group's count


# -- stages and the whole call ------------------------------------------------------


@SIZES
@DTYPES
@FORMS
def test_stages_and_bm3d_equal_the_jax_packages(n, dtype, tree, jax_form):
    jax_form(tree)
    z, jz = _both(_image(n, seed=n + 2), dtype)
    s = jnp.asarray(SIGMA, JNP[dtype])
    atol = _tol(dtype, tree)
    ht = core.ht_stage(z, SIGMA)
    jht = jcore.bm3d(jz, SIGMA, stages="ht")  # the jitted ht_stage
    _close(ht, jht, atol, "ht_stage")
    assert torch.equal(core.bm3d(z, SIGMA, stages="ht", device=CPU), ht)
    wie = core.wiener_stage(z, torch.as_tensor(np.array(jht)), SIGMA)
    _close(wie, jax.jit(jcore.wiener_stage)(jz, jht, s), atol, "wiener_stage on JAX's pilot")
    out = core.bm3d(z, SIGMA, device=CPU)
    assert out.dtype == dtype and tuple(out.shape) == (n, n)
    _close(out, jcore.bm3d(jz, SIGMA), atol, "bm3d")


@SIZES
def test_bm3d_wiener_matches_use_the_same_positions_as_jax(n, jax_form):
    """Float64: the HT output agrees to rounding, and the Wiener stage's
    matching on it picks the same blocks as JAX's on its own pilot."""
    jax_form(True)
    z = _image(n, seed=n + 3)
    ht = core.ht_stage(torch.as_tensor(z), SIGMA)
    jht = jcore.bm3d(jnp.asarray(z), SIGMA, stages="ht")
    ref, offs = core._ref_grid(n - 7, 3), core._offsets(39, 8)
    tau = 400.0 * 2.0 * 64 / 255.0**2
    pos, counts = core._match(ht, ref, offs, 8, 32, tau)
    jpos, jcounts = jcore._match(jht, ref, offs, 8, 32, tau)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("n", [48, 64])
def test_prefilter_path_at_sigma_0_2_equals_the_jax_packages(n, jax_form):
    """sigma 0.2 > 40/255: ``bm3d`` matches on hard-thresholded coefficients."""
    jax_form(True)
    z = _image(n, seed=n + 4, noise=0.2)
    out = core.bm3d(torch.as_tensor(z), 0.2, device=CPU)
    _close(out, jcore.bm3d(jnp.asarray(z), 0.2), ATOL[torch.float64], "prefilter on")
    plain = core.bm3d(torch.as_tensor(z), 0.2, prefilter=False, device=CPU)
    _close(plain, jcore.bm3d(jnp.asarray(z), 0.2, prefilter=False), ATOL[torch.float64], "prefilter off")
    assert float((out - plain).abs().max()) > 1e-3  # the prefilter changes the matches


def test_bm3d_from_psd_equals_the_jax_packages(jax_form):
    jax_form(True)
    z = _image(48, seed=10)
    psd = np.full((48, 48), SIGMA**2 * 48 * 48)
    _close(core.bm3d_from_psd(torch.as_tensor(z), psd, device=CPU), jcore.bm3d_from_psd(jnp.asarray(z), psd),
           ATOL[torch.float64])


@DTYPES
def test_batched_images_equal_single_image_calls(dtype):
    z = np.stack([_image(48, seed=s) for s in range(3)]).reshape(3, 1, 48, 48)
    out = core.bm3d(z.astype(np.float32 if dtype == torch.float32 else np.float64), SIGMA, device=CPU)
    assert tuple(out.shape) == (3, 1, 48, 48) and out.dtype == dtype
    for i in range(3):
        one = core.bm3d(torch.as_tensor(z[i, 0], dtype=dtype), SIGMA, device=CPU)
        assert float((out[i, 0] - one).abs().max()) <= 1e-12


def test_repeated_calls_are_bit_equal_and_the_output_is_finite():
    z = torch.as_tensor(np.stack([_image(40, seed=s) for s in range(2)]), dtype=torch.float32)
    a, b = core.bm3d(z, SIGMA, device=CPU), core.bm3d(z, SIGMA, device=CPU)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_bm3d_defaults_to_the_card_and_refuses_a_bad_stage(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        core.bm3d(_image(16), SIGMA)
    with pytest.raises(ValueError, match="stages"):
        core.bm3d(_image(24), SIGMA, stages="wiener", device=CPU)


def test_a_group_size_that_is_not_a_power_of_two_is_refused():
    """The Haar tree takes power-of-two stacks only; every named profile has
    them (16, 32). The JAX package falls back to its matrix filter."""
    prof = dataclasses.replace(core.DEFAULT_PROFILE, max_3d_ht=12)
    with pytest.raises(ValueError, match="power-of-two"):
        core.bm3d(_image(24), SIGMA, prof, device=CPU)
    assert all(p.max_3d_ht & (p.max_3d_ht - 1) == 0 and p.max_3d_wie & (p.max_3d_wie - 1) == 0
               for p in core.PROFILES.values())
