"""The port's command line against the JAX package's on the CNN algorithms
and the restoration pipelines, on the CPU, on the same files.

As ``test_torch_cli.py`` (its helpers and limits): narrow networks (``--nc``
/ ``--nb``) whose npz the port's ``save_npz`` writes, every CNN run given
``--weights``, 2 iterations, float64 unless said. ``pnp_sr`` and
``pnp_deblur`` run in float32 in both packages (whatever ``--f64`` says),
with the JAX package's noise (``jax.random.normal(PRNGKey(seed))``), which
the port replays on the host (``utils/jax_random.py``): they are held to
the float32 limits, and their ``.log`` lines and PNGs too. One run per
solver family in float32 (PnP-ADMM, PnP-FISTA, PnP-HQS, RED, consensus).
"""

import pytest
import torch

from test_torch_cli import check_same, few_threads, narrow_weights, run_both, run_cli  # noqa: F401
from test_torch_experiments import write_assets



def _argv(tmp_path, algo, model, *extra, model2=None, full=False):
    path, arch = narrow_weights(tmp_path, model, full=full)
    argv = [algo, "--model", model, "--weights", path, *arch, "--iter_num", "2"]
    if model2:
        argv += ["--model2", model2, "--weights2", narrow_weights(tmp_path, model2, seed=1)[0]]
    return [*argv, *extra]


CNN_F64 = [
    ("pnp_l1_d", "dncnn_25", []), ("pnp_l1_d", "drunet_gray", []), ("pnp_l1_d", "fdncnn_gray", ["--nlm", "12"]),
    ("pnp_l1_d", "ircnn_gray", ["--tuned", "--clean"]),
    ("pnp_cnc_d", "ffdnet_gray", ["--tuned"]), ("pnp_cnc_d", "drunet_gray", ["--tuned", "--clean", "--no_x8"]),
    ("consensus_d", "dncnn_25", ["--tuned"]), ("consensus_fista_d", "drunet_gray", ["--tuned"]),
    ("consensus_hqs_d", "ircnn_gray", ["--nlm", "10"]), ("pnp_fista_d", "tdnet", ["--tuned", "--x8"]),
    ("pnp_pgd_d", "ffdnet_gray", ["--step", "0.9"]), ("pnp_pgd_cnc", "drunet_gray", ["--tuned"]),
    ("pnp_hqs_d", "drunet_gray", ["--noise_sigma", "8", "--model_sigma1", "30"]),
    ("red_d", "dncnn_25", ["--red_variant", "gd", "--lambda1", "0.2"]), ("red_d", "drunet_gray", ["--nlm", "12"]),
]


@pytest.mark.parametrize("algo,model,extra", CNN_F64, ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_cnn_algorithms_f64(tmp_path, algo, model, extra):
    got, ref, pdir, jdir = run_both(tmp_path, [*_argv(tmp_path, algo, model, *extra), "--f64"])
    check_same(got, ref, pdir, jdir)


def test_dncnn_pair_f64(tmp_path):
    """pnp_cnc_d with two DnCNNs: the registries' ``dncnn_pair`` key."""
    argv = _argv(tmp_path, "pnp_cnc_d", "dncnn_25", "--tuned", "--f64", model2="dncnn_25")
    got, ref, pdir, jdir = run_both(tmp_path, argv)
    check_same(got, ref, pdir, jdir)
    assert got["iters"] == 2


@pytest.mark.parametrize("algo,model,extra", [
    ("pnp_cnc_d", "drunet_gray", []), ("pnp_fista_d", "dncnn_25", []), ("pnp_hqs_d", "ircnn_gray", []),
    ("red_d", "ffdnet_gray", []), ("consensus_fista_d", "drunet_gray", ["--tuned", "--no_x8"]),
], ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_solver_families_f32(tmp_path, algo, model, extra):
    got, ref, pdir, jdir = run_both(tmp_path, _argv(tmp_path, algo, model, *extra))
    check_same(got, ref, pdir, jdir, torch.float32)


@pytest.mark.parametrize("algo,model,extra", [
    ("pnp_sr", "dncnn_25", ["--tuned"]), ("pnp_sr", "ffdnet_gray", ["--sf", "3"]),
    ("pnp_deblur", "fdncnn_gray", ["--kernel", "gauss", "--f64"]), ("pnp_deblur", "ircnn_gray", ["--tuned"]),
    ("pnp_deblur", "dncnn_25", ["--kernel", "box", "--noise_sigma", "5", "--images", "02"]),
], ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_restoration_matches_the_jax_cli(tmp_path, algo, model, extra):
    """The restoration pipelines build their prior at its full width (they
    take no --nc / --nb in either package)."""
    got, ref, pdir, jdir = run_both(tmp_path, _argv(tmp_path, algo, model, *extra, full=True))
    check_same(got, ref, pdir, jdir, torch.float32)


def test_bm3d_restoration_matches_the_jax_cli(tmp_path):
    """Deblurring with the BM3D ladder. (SR with BM3D is not held here to
    the float32 limits: its first rung, rho ~2e-4, amplifies float32
    roundings, 2.7e-4 dB between the packages at this size; the float32
    SR-BM3D gap is a known property of both, ROADMAP.md section 3.)"""
    import jax

    from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore

    jcore._STACK_FILTER_TREE = True
    jax.clear_caches()
    try:
        got, ref, pdir, jdir = run_both(tmp_path, ["pnp_deblur", "--model", "bm3d", "--iter_num", "2",
                                                    "--images", "01"])
    finally:
        jcore._STACK_FILTER_TREE = None
        jax.clear_caches()
    check_same(got, ref, pdir, jdir, torch.float32)


def test_bf16_runs_near_float32(tmp_path):
    """--bf16 runs the narrow DRUNet in bfloat16: finite, and within 0.5 dB
    of the float32 run per image (the port against itself; the two packages'
    bfloat16 convolutions accumulate differently)."""
    from pnp_admm_cnc_mri_torch.cli import main as pmain

    tdir, ddir = write_assets(str(tmp_path))
    argv = [*_argv(tmp_path, "pnp_fista_d", "drunet_gray"), "--cpu", "--testsets_dir", tdir, "--data_dir", ddir,
            "--no_save", "--results_dir", str(tmp_path / "r")]
    _, f32 = run_cli(pmain.main, argv)
    _, bf16 = run_cli(pmain.main, [*argv, "--bf16"])
    for k, v in bf16["per_image_psnr"].items():
        assert abs(v - f32["per_image_psnr"][k]) < 0.5, k
