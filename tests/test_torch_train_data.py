"""The port's training patches and batches (``train/data.py``) against the
JAX package's: numpy on both sides, so the patches, the dihedral
augmentation and every batch of ``batches`` are bit-equal for a seed. The
multiscale pool goes through each package's MATLAB-bicubic ``imresize``
(torch on the CPU here, XLA there): within 1e-6 in float32."""

import numpy as np
import pytest
import torch

from pnp_admm_cnc_mri_tpu.train import data as jdata
from pnp_admm_cnc_mri_torch.train import data


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def imgs():
    r = np.random.default_rng(7)
    return [r.random((64, 64)), r.random((48, 80)), r.random((40, 40)).astype(np.float32)]


@pytest.mark.parametrize("patch,stride", [(16, 16), (16, 8), (40, 20)])
def test_extract_patches_equal(imgs, patch, stride):
    got = data.extract_patches(imgs, patch=patch, stride=stride)
    ref = jdata.extract_patches(imgs, patch=patch, stride=stride)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_extract_patches_multiscale_matches(imgs):
    got = data.extract_patches_multiscale(imgs, patch=16, stride=16, scales=(1.0, 0.75, 0.5))
    ref = jdata.extract_patches_multiscale(imgs, patch=16, stride=16, scales=(1.0, 0.75, 0.5))
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        data.extract_patches_multiscale(imgs, patch=128)


def test_augment_batch_equal(imgs):
    p = data.extract_patches(imgs, patch=16, stride=8)
    got = data.augment_batch(p, np.random.default_rng(3))
    ref = jdata.augment_batch(p, np.random.default_rng(3))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sigma,augment,epochs", [(0.1, True, None), ((0.01, 0.3), True, None),
                                                  (15 / 255, False, 2)], ids=["fixed", "range", "epochs"])
def test_batches_bit_equal(imgs, sigma, augment, epochs):
    p = data.extract_patches(imgs, patch=16, stride=8)
    got = list(data.batches(p, 8, sigma, seed=5, epochs=epochs, augment=augment)) if epochs else \
        [b for _, b in zip(range(12), data.batches(p, 8, sigma, seed=5, augment=augment))]
    ref = list(jdata.batches(p, 8, sigma, seed=5, epochs=epochs, augment=augment)) if epochs else \
        [b for _, b in zip(range(12), jdata.batches(p, 8, sigma, seed=5, augment=augment))]
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_batches_refuses_a_small_corpus(imgs):
    p = data.extract_patches(imgs[:1], patch=40, stride=40)
    with pytest.raises(ValueError):
        next(data.batches(p, 8, 0.1))
