"""The port's default-width budget, the result's extra fields and the
numpy-seeded ``generate_diagonal_dominant``, on the CPU.

The CPU budget is the JAX package's 12 GB, so its widths are the JAX
package's (``tests/test_auto_width.py``). On a GPU the budget is ¾ of the
card's free memory (the allocator's unused cache counted as free), and a
refined solve's footprint also counts the compensated Gram's partials
(``config._memory_clamped_max_dim``); those paths are reached here with
``device="cuda"`` and the budget given, or the CUDA queries replaced.
"""

import pytest
import torch

from fortran_davidson_tpu.config import DavidsonOptions as JaxOptions
from fortran_davidson_tpu.config import resolve_options as jax_resolve
from fortran_davidson_tpu_torch import config
from fortran_davidson_tpu_torch.models.generators import (
    generate_diagonal_dominant, low_rank_plus_diag_apply,
    surrogate_hamiltonian)
from fortran_davidson_tpu_torch.solver import eigensolve
from fortran_davidson_tpu_torch.utils.ds import gram_chunk

NORTHSTAR = dict(dtype="float32", expansion="lowest-k", relative_tolerance=True,
                 tolerance=1e-8)


def _width(n, device=None, **opts):
    cfg = config.resolve_options(config.merge_options(None, opts), 20, n,
                                 generalized=False, device=device)
    return cfg.max_dim, cfg.m_max


@pytest.mark.parametrize("n", [10_000_000, 10_000_384])
@pytest.mark.parametrize("refined", [False, True])
def test_cpu_budget_resolves_the_jax_widths(n, refined):
    opts = dict(NORTHSTAR, refined=refined, final_polish=3 if refined else 0)
    want = jax_resolve(JaxOptions(**opts), 20, n, generalized=False).max_dim
    assert _width(n, **opts)[0] == want == 44


def test_gpu_refined_budget_counts_the_gram_partials(monkeypatch):
    # At n = 10,000,000 the compensated Gram's chunk is 128 rows (it
    # halves until it divides n), so an m_max = 220 basis's partials take
    # 15 GB each: the refined solve resolves narrower than the plain one.
    monkeypatch.setenv("FDT_CARRY_BUDGET_BYTES", "56e9")
    assert gram_chunk(10_000_000) == 128
    assert gram_chunk(10_000_384) == 2048
    plain = _width(10_000_000, "cuda", **NORTHSTAR)
    refined = _width(10_000_000, "cuda", refined=True, final_polish=3,
                     **NORTHSTAR)
    assert plain == (200, 220)
    assert refined == (112, 132)
    # The same budget on the CPU keeps the JAX package's model.
    assert _width(10_000_000, "cpu", refined=True, **NORTHSTAR) == (200, 220)
    # Where the chunk stays wide the partials are small: 200 still fits.
    assert _width(10_000_384, "cuda", refined=True, **NORTHSTAR) == (200, 220)


def test_gpu_budget_counts_the_allocators_unused_cache(monkeypatch):
    monkeypatch.delenv("FDT_CARRY_BUDGET_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (40e9, 80e9))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 30e9)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 10e9)
    assert config._carry_budget_bytes("cuda") == int(0.75 * 60e9)
    assert config._carry_budget_bytes("cpu") == int(12e9)


def test_result_carries_the_polish_low_words():
    # The float32 words alone floor a dense-coupled matrix's float64
    # residual at ~eps·coupling·sqrt(n); the polish's hi + lo vectors do
    # not. A is the float64 promotion of the stored float32 surrogate.
    op = surrogate_hamiltonian(100_000, dtype=torch.float32, device="cpu")
    res = eigensolve(op, 4, dtype="float32", expansion="lowest-k",
                     refined=True, final_polish=3, tolerance=1e-8,
                     relative_tolerance=True)
    assert res.converged
    assert res.eigenvectors_lo.shape == res.eigenvectors.shape
    d, U, w = (t.double() for t in op.captured)
    lam = res.eigenvalues.double() + res.eigenvalues_lo.double()

    def residual(X):
        X = X / torch.linalg.vector_norm(X, dim=0)
        R = low_rank_plus_diag_apply(X, d, U, w) - X * lam
        return float(torch.linalg.vector_norm(R, dim=0).max())

    hi = residual(res.eigenvectors.double())
    hi_lo = residual(res.eigenvectors.double()
                     + res.eigenvectors_lo.double())
    assert hi_lo < 1e-11 < hi < 1e-8
    plain = eigensolve(op, 4, dtype="float32", tolerance=1e-3,
                       relative_tolerance=True)
    assert plain.eigenvectors_lo is None
    assert plain.block_until_ready() is plain


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generate_diagonal_dominant_construction(dtype):
    A = generate_diagonal_dominant(50, 1e-3, seed=3, dtype=dtype,
                                   device="cpu")
    assert A.dtype == dtype and A.shape == (50, 50)
    assert torch.equal(A, A.T)
    assert torch.equal(torch.diagonal(A),
                       torch.arange(1, 51, dtype=dtype))
    off = A - torch.diag(torch.diagonal(A))
    assert float(off.min()) >= 0 and 0 < float(off.max()) <= 1e-3
    assert torch.equal(A, generate_diagonal_dominant(
        50, 1e-3, seed=3, dtype=dtype, device="cpu"))
    assert not torch.equal(A, generate_diagonal_dominant(
        50, 1e-3, seed=4, dtype=dtype, device="cpu"))
    B = generate_diagonal_dominant(50, 1e-3, diag_val=1.0, seed=1,
                                   dtype=dtype, device="cpu")
    assert torch.equal(torch.diagonal(B), torch.ones(50, dtype=dtype))
