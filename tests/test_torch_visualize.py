"""The port's display helpers (``utils/visualize.py``) against the JAX package's."""

import numpy as np
import pytest

from pnp_admm_cnc_mri_tpu.utils import visualize as jvis
from pnp_admm_cnc_mri_torch.utils import visualize as vis


@pytest.mark.parametrize("shape,dtype", [((40, 52), np.float64), ((40, 52, 3), np.uint8), ((33, 31), np.float32)])
def test_draw_box_and_enlarge_region_equal_jax(shape, dtype):
    rng = np.random.default_rng(0)
    img = rng.random(shape)
    img = (img * 255).astype(dtype) if dtype == np.uint8 else img.astype(dtype)
    for tl, br, t in (((5, 7), (30, 25), 2), ((29, 30), (3, 2), 1), ((-4, 10), (80, 60), 3)):
        got = vis.draw_box(img, tl, br, thickness=t)
        ref = jvis.draw_box(img, tl, br, thickness=t)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    for tl, br in (((5, 7), (30, 25)), ((20, 4), (8, 30))):
        # colour: each channel as the JAX package enlarges a gray image (its
        # own resize fails on (H, W, C): ROADMAP section 3)
        refs = (jvis.enlarge_region(img, tl, br) if img.ndim == 2 else
                [np.stack(c, axis=-1) for c in zip(*(jvis.enlarge_region(img[..., k], tl, br) for k in range(3)))])
        for got, ref in zip(vis.enlarge_region(img, tl, br), refs):
            assert got.dtype == ref.dtype and got.shape == img.shape
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(vis.draw_box(img, (1, 1), (9, 9), value=7),
                                  jvis.draw_box(img, (1, 1), (9, 9), value=7))


def test_imshow_and_surf_run_headless():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = np.random.default_rng(1).random((12, 9))
    fig = vis.imshow(z, title="z", cbar=True, show=False)
    assert len(fig.axes) == 2
    plt.close(fig)
    fig = vis.surf(z, show=False)
    assert fig.axes[0].name == "3d"
    plt.close(fig)
