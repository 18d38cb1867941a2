"""The port's CUDA kernels and solver on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it also runs where JAX is absent, without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tol(dtype):
    # float64: the same products summed in another order; float32 likewise.
    if dtype == torch.float64:
        return dict(rtol=1e-12, atol=1e-12)
    return dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 20, 64, 130])
def test_kernels_match_plain(cuda_device, dtype, m):
    op = fdtt.generate_banded_bsr(37, 16, bandwidth=3, seed=1, dtype=dtype,
                                  device=cuda_device)
    x = torch.randn((op.shape[0], m), dtype=dtype, device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    y = kernels.banded_bsr_spmm(op.blocks, x, 3)
    assert kernels.banded_bsr_spmm.launches == before + 1
    torch.testing.assert_close(
        y, kernels.banded_bsr_spmm_plain(op.blocks, x, 3), **_tol(dtype))
    before = kernels.bsr_spmm.launches
    y = kernels.bsr_spmm(op.block_cols, op.blocks, x)
    assert kernels.bsr_spmm.launches == before + 1
    torch.testing.assert_close(
        y, kernels.bsr_spmm_plain(op.block_cols, op.blocks, x), **_tol(dtype))


def test_edge_rows_never_read_past_the_window(cuda_device):
    # Inf/NaN in x rows that only zero blocks touch must not leak into y.
    op = fdtt.generate_banded_bsr(8, 4, bandwidth=2, seed=2,
                                  device=cuda_device)
    x = torch.randn((op.shape[0], 5), dtype=torch.float64, device=cuda_device)
    y = kernels.banded_bsr_spmm(op.blocks, x, 2)
    assert bool(torch.all(torch.isfinite(y)))
    torch.testing.assert_close(y, op.to_dense() @ x, **_tol(torch.float64))


def test_rejects_bf16_and_mixed_types(cuda_device):
    blocks = torch.zeros((4, 2, 6), dtype=torch.bfloat16, device=cuda_device)
    x = torch.zeros((8, 1), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(NotImplementedError):
        kernels.banded_bsr_spmm(blocks, x, 1, out_dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        kernels.banded_bsr_spmm(blocks.double(), x.float(), 1)


def test_solver_on_the_card_matches_dense(cuda_device):
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    res = fdtt.eigensolve(op, 3, max_dim_sub=12)
    assert res.converged and kernels.banded_bsr_spmm.launches > before
    want = torch.linalg.eigvalsh(op.to_dense().cpu())[:3]
    torch.testing.assert_close(res.eigenvalues.cpu(), want, rtol=0, atol=1e-9)
    assert res.eigenvectors.device.type == "cuda"
