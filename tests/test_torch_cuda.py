"""CUDA tail kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc, and skip without them. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from pnp_admm_cnc_mri_torch.ops import tail_kernels

pytestmark = pytest.mark.cuda

CNC = (0.45, 0.05, 0.5, 64.0)
C_L1 = 0.015 * 0.1


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels are compiled with nvcc for sm_90a")
    tail_kernels.load_library()
    return torch.device("cuda")


def _operands(device, shape, dtype, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(3):
        scale = 10.0 ** (-4.0 * torch.rand(shape, generator=gen, device=device, dtype=dtype))
        out.append(torch.randn(shape, generator=gen, device=device, dtype=dtype) * scale)
    out[0].view(-1)[:8] = 0.0
    out[2].view(-1)[:8] = 0.0
    out[1].view(-1)[8:16] = 0.0
    out[0].view(-1)[16] = float("nan")
    out[1].view(-1)[17] = float("nan")
    return out


def _assert_same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = ~torch.isnan(a)
        assert torch.equal(a[fin], b[fin])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(4, 256, 256), (3, 7, 33)])
def test_kernels_equal_plain(cuda, shape, dtype):
    x, z, w = _operands(cuda, shape, dtype)
    before = (tail_kernels.l1_tail.launches, tail_kernels.cnc_tail.launches)
    _assert_same(tail_kernels.l1_tail(x, z, w, C_L1), tail_kernels.l1_tail_plain(x, z, w, C_L1))
    _assert_same(tail_kernels.cnc_tail(x, z, w, *CNC), tail_kernels.cnc_tail_plain(x, z, w, *CNC))
    assert (tail_kernels.l1_tail.launches, tail_kernels.cnc_tail.launches) == (before[0] + 1, before[1] + 1)


def test_misaligned_operands_take_the_scalar_path(cuda):
    base = _operands(cuda, (4 * 64 * 64 + 1,), torch.float32)
    x, z, w = (a[1:].view(4, 64, 64) for a in base)
    _assert_same(tail_kernels.l1_tail(x, z, w, C_L1), tail_kernels.l1_tail_plain(x, z, w, C_L1))
    _assert_same(tail_kernels.cnc_tail(x, z, w, *CNC), tail_kernels.cnc_tail_plain(x, z, w, *CNC))


def test_nan_in_gives_nan_out(cuda):
    x, z, w = _operands(cuda, (2, 8, 128), torch.float32)
    zn, wn = tail_kernels.l1_tail(x, z, w, C_L1)
    assert torch.isnan(zn.view(-1)[16]) and torch.isnan(wn.view(-1)[16])
    zn, wn = tail_kernels.cnc_tail(x, z, w, *CNC)
    assert torch.isnan(zn.view(-1)[16:18]).all() and torch.isnan(wn.view(-1)[16:18]).all()


def test_mixed_devices_raise(cuda):
    x = torch.zeros(2, 8, 8, device=cuda)
    with pytest.raises(ValueError):
        tail_kernels.l1_tail(x, x, x.cpu(), C_L1)
