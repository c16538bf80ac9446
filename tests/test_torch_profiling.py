"""The port's FLOP counter, describers and timers (``utils/flops.py``,
``models/describe.py``, ``utils/profiling.py``) against the JAX package's.

``matmul_flops`` counts from the aten ops a call runs, the JAX package's
from the jaxpr; both apply the same rules, so the counts are equal: a
DnCNN and a DRUNet forward, an l2 loss's value and gradient through each
(the backward convolutions, the transposed ones included), FFTs and
matmuls. ``num_params`` and the printed tables are equal too.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.models import describe as jdescribe
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.utils import flops as jflops
from pnp_admm_cnc_mri_tpu.utils import profiling as jprofiling
from pnp_admm_cnc_mri_torch.models import convert, describe, dncnn, drunet
from pnp_admm_cnc_mri_torch.utils import flops, profiling


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


MODELS = {
    "dncnn": (lambda: jdncnn.DnCNN(out_nc=1, nc=16, nb=5), lambda: dncnn.DnCNN(1, 1, nc=16, nb=5), 1),
    "drunet": (lambda: jdrunet.UNetRes(out_nc=1, nc=(8, 16, 32, 64), nb=2),
               lambda: drunet.UNetRes(2, 1, nc=(8, 16, 32, 64), nb=2), 2),
}


def _pair(name):
    jf, tf, c = MODELS[name]
    jm = jf()
    params = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, c)))))
    tm = tf()
    tm.load_state_dict(convert.state_dict_from_flax(tm, params))
    return jm, params, tm, c


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_flops_equal_jax(name):
    jm, params, tm, c = _pair(name)
    ref = jflops.matmul_flops(lambda a: jm.apply(params, a), jnp.zeros((2, 32, 32, c)))
    with torch.no_grad():
        got = flops.matmul_flops(tm, torch.zeros(2, c, 32, 32))
    assert got == ref > 0


@pytest.mark.parametrize("name", list(MODELS))
def test_value_and_grad_flops_equal_jax(name):
    jm, params, tm, c = _pair(name)

    def jloss(p, a):
        return 0.5 * jnp.mean((jm.apply(p, a) - a[..., :1]) ** 2)

    ref = jflops.matmul_flops(lambda p, a: jax.value_and_grad(jloss)(p, a), params, jnp.zeros((2, 32, 32, c)))

    def tstep(a):
        loss = 0.5 * torch.mean((tm(a) - a[:, :1]) ** 2)
        loss.backward()
        return loss

    got = flops.matmul_flops(tstep, torch.zeros(2, c, 32, 32))
    assert got == ref
    assert got > 2.5 * flops.matmul_flops(lambda a: tm(a).detach(), torch.zeros(2, c, 32, 32))


def test_fft_and_matmul_flops_equal_jax():
    x = jnp.zeros((4, 64, 64), jnp.complex64)
    assert flops.matmul_flops(lambda u: torch.fft.fft2(u).real.mean(), torch.zeros(4, 64, 64, dtype=torch.complex64)) \
        == jflops.matmul_flops(lambda u: jnp.fft.fft2(u, axes=(-2, -1)).real.mean(), x) == 4 * 5 * 4096 * 12
    xr = jnp.zeros((4, 64, 48))
    assert flops.matmul_flops(lambda u: torch.fft.irfft2(torch.fft.rfft2(u), s=(64, 48)).mean(),
                              torch.zeros(4, 64, 48)) \
        == jflops.matmul_flops(lambda u: jnp.fft.irfft2(jnp.fft.rfft2(u), s=(64, 48)).mean(), xr)
    a, b = torch.zeros(128, 256), torch.zeros(256, 512)
    assert flops.matmul_flops(lambda p, q: p @ q, a, b) == 2 * 128 * 256 * 512
    assert flops.matmul_flops(lambda p, q: torch.einsum("bik,bkj->bij", p, q), torch.zeros(4, 32, 64),
                              torch.zeros(4, 64, 16)) == 2 * 4 * 32 * 64 * 16
    assert flops.matmul_flops(lambda: torch.nn.functional.linear(torch.zeros(8, 32), torch.zeros(16, 32),
                                                                 torch.zeros(16))) == 2 * 8 * 32 * 16


@pytest.mark.parametrize("name", list(MODELS))
def test_describe_equals_jax(name):
    _, params, tm, _ = _pair(name)
    assert describe.num_params(tm) == jdescribe.num_params(params) == sum(p.numel() for p in tm.parameters())
    assert describe.describe_model(tm, name) == jdescribe.describe_model(params, name)
    assert describe.describe_params(tm) == jdescribe.describe_params(params)


def test_phase_timers_trace_and_device_time(tmp_path):
    t, jt = profiling.PhaseTimers(), jprofiling.PhaseTimers()
    for timers in (t, jt):
        for _ in range(3):
            with timers.phase("a"):
                pass
        with timers.phase("b"):
            pass
    assert {k: v["count"] for k, v in t.report().items()} == {k: v["count"] for k, v in jt.report().items()}
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0 and len(prof.key_averages()) > 0
    if not torch.cuda.is_available():  # a host clock is not the device's
        with pytest.raises(RuntimeError):
            profiling.device_time(lambda: None)
