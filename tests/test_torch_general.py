"""The general block-ELL path (kernel 2's) on a matrix whose columns have no
band: a banded BSR permuted blockwise, P A Pᵀ, built through
``BSROperator.from_block_coo`` in both packages from the same numpy
arrays, with no declared bandwidth.

On the CPU the port's ``bsr_spmm`` takes its plain version; the JAX
package's Pallas ``bsr_spmm`` runs in interpret mode, as
``tests/test_sparse.py`` runs it. The CUDA kernel itself is held to the
plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.ops import pallas_kernels as pk
from fortran_davidson_tpu.ops.sparse import BSROperator as JaxBSR
from fortran_davidson_tpu.ops.sparse import generate_banded_bsr
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch.ops import kernels
from tests.torch_parity import to_numpy, true_residuals

NBR, BS, BW = 64, 16, 1   # n = 1024


def _permuted_coo(coupling, seed=0, perm_seed=1):
    """The banded matrix ``generate_banded_bsr(NBR, BS, BW)`` of the JAX
    package and its blockwise permutation as block COO: block (r, c) of A
    is block (p[r], p[c]) of P A Pᵀ. Returns (A, brows, bcols, vals)."""
    op = generate_banded_bsr(NBR, BS, bandwidth=BW, coupling=coupling,
                             seed=seed)
    K = 2 * BW + 1
    blocks = np.asarray(op.blocks).reshape(NBR, BS, K, BS).transpose(
        0, 2, 1, 3)
    r = np.arange(NBR)[:, None]
    col = r - BW + np.arange(K)[None, :]
    keep = (col >= 0) & (col < NBR)
    p = np.random.default_rng(perm_seed).permutation(NBR)
    brows = p[np.broadcast_to(r, col.shape)[keep]]
    return op, brows, p[col[keep]], blocks[keep]


def _dense(brows, bcols, vals):
    a = np.zeros((NBR, BS, NBR, BS))
    a[brows, :, bcols, :] = vals
    return a.reshape(NBR * BS, NBR * BS)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_block_permuted_solve_matches_jax(backend):
    # Default lowest-3. Eigenvalues to 1e-10 and iterations within ±1 of
    # the JAX package's (tests/test_parity.py); true residuals at the
    # 1e-8 tolerance; and the unpermuted banded solve's eigenvalues to
    # 1e-10 (P A Pᵀ has A's spectrum).
    op, brows, bcols, vals = _permuted_coo(coupling=1e-2)
    Aj = JaxBSR.from_block_coo(brows, bcols, vals, NBR, backend=backend)
    At = fdtt.BSROperator.from_block_coo(brows, bcols, vals, NBR,
                                         device="cpu")
    assert At.bandwidth is None
    assert not np.any(np.all(np.diff(to_numpy(At.block_cols), axis=0) == 1,
                             axis=1)), "the permuted table kept a band"
    rj = fdt.eigensolve(Aj, 3)
    rt = fdtt.eigensolve(At, 3)
    assert rt.converged and bool(rj.converged)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    np.testing.assert_allclose(to_numpy(rt.eigenvalues),
                               np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    res = true_residuals(_dense(brows, bcols, vals), rt.eigenvectors,
                         rt.eigenvalues)
    assert np.all(res <= 1e-8), f"true residuals {res}"
    banded = fdtt.eigensolve(convert.operator(op, device="cpu"), 3)
    np.testing.assert_allclose(to_numpy(rt.eigenvalues),
                               to_numpy(banded.eigenvalues), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("m", [1, 6, 20])
def test_plain_matches_pallas_on_the_permuted_table(dtype, m):
    # 1e-12 of max|Y| in float64, 1e-5 in float32: the same products
    # summed in another order.
    _, brows, bcols, vals = _permuted_coo(coupling=1e-2, seed=3)
    op = JaxBSR.from_block_coo(brows, bcols, vals.astype(np.dtype(dtype)),
                               NBR)
    X = np.random.default_rng(m).standard_normal(
        (NBR * BS, m)).astype(np.dtype(dtype))
    ref = np.asarray(pk.bsr_spmm(op.block_cols, op.blocks, jnp.asarray(X),
                                 interpret=True))
    out = kernels.bsr_spmm(torch.from_numpy(np.array(op.block_cols)),
                           torch.from_numpy(np.array(op.blocks)),
                           torch.from_numpy(X))
    tol = 1e-12 if dtype == jnp.float64 else 1e-5
    np.testing.assert_allclose(to_numpy(out), ref, rtol=tol,
                               atol=tol * np.max(np.abs(ref)))
