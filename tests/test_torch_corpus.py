"""The port's leakage-free corpus (``train/corpus.py``) against the JAX
package's: the numpy families are the same code on the same draws, so
dead leaves, elastic warps, Gaussian fields and phantoms are bit-equal;
``local_sample_images`` finds the same files (the port locates the
packages' folders without importing them) and reads the same arrays;
``materialize`` writes the same pixels (the port through its own PNG
writer, the JAX package through PIL)."""

import os

import numpy as np
import pytest

from pnp_admm_cnc_mri_tpu.train import corpus as jcorpus
from pnp_admm_cnc_mri_torch.data import images
from pnp_admm_cnc_mri_torch.train import corpus


@pytest.mark.parametrize("name,kw", [
    ("dead_leaves", dict(n=2, size=64, seed=3)),
    ("dead_leaves", dict(n=1, size=48, seed=0, rmax=20.0, sigma_blur=0.0)),
    ("gaussian_fields", dict(n=3, size=64, seed=3)),
    ("mri_phantoms", dict(n=3, size=64, seed=5)),
], ids=["dead_leaves", "dead_leaves_no_blur", "gaussian_fields", "mri_phantoms"])
def test_numpy_families_bit_equal(name, kw):
    got = getattr(corpus, name)(**kw)
    ref = getattr(jcorpus, name)(**kw)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0.0 and got.max() <= 1.0 and got.std() > 0.01


def test_elastic_warp_bit_equal():
    img = corpus.mri_phantoms(1, 64, seed=1)[0]
    np.testing.assert_array_equal(corpus.elastic_warp(img, 2, seed=4, amp=6.0, smooth=8.0),
                                  jcorpus.elastic_warp(img, 2, seed=4, amp=6.0, smooth=8.0))


def test_local_sample_images_match_the_jax_package():
    got = corpus.local_sample_images()
    ref = jcorpus.local_sample_images()
    assert sorted(got) == sorted(ref)
    assert ref, "the installed sklearn/matplotlib/pygame ship sample images"
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_local_sample_images_skip_what_cannot_be_read(tmp_path, monkeypatch):
    bad = tmp_path / "broken.jpg"
    bad.write_bytes(b"not a jpeg")
    png = tmp_path / "gray.png"
    png.write_bytes(images.encode_png_gray8(np.full((100, 120), 7, np.uint8)))
    monkeypatch.setattr(corpus, "_candidate_paths", lambda: {"broken": str(bad), "gray": str(png)})
    out = corpus.local_sample_images()
    assert list(out) == ["gray"] and out["gray"].shape == (100, 120)
    np.testing.assert_array_equal(out["gray"], np.full((100, 120), 7 / 255.0, np.float32))


def test_materialize_writes_the_same_pixels(tmp_path):
    from PIL import Image

    kw = dict(n_dead_leaves=2, n_mri_warps=1, seed=0)
    got = corpus.materialize(str(tmp_path / "port"), **kw)
    ref = jcorpus.materialize(str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    for g, r in zip(got, ref):
        a = images.imread_gray(g)
        np.testing.assert_array_equal(a, np.asarray(Image.open(r)))
        np.testing.assert_array_equal(np.asarray(Image.open(g)), a)


def test_main_writes_the_corpus(tmp_path, capsys):
    out = tmp_path / "c"
    assert corpus.main(["--out", str(out), "--n_dead_leaves", "1", "--n_mri_warps", "0"]) == 0
    assert "deadleaves00.png" in os.listdir(out)
    assert "wrote" in capsys.readouterr().out
