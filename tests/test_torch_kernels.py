"""The port's BSR SpMM (``fortran_davidson_tpu_torch.ops.kernels``) against
the JAX package's Pallas kernels, run in interpret mode as
``tests/test_sparse.py`` runs them.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels themselves are compared with those plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fortran_davidson_tpu.ops import pallas_kernels as pk
from fortran_davidson_tpu.ops.sparse import BSROperator as JaxBSR
from fortran_davidson_tpu.ops.sparse import generate_banded_bsr
from fortran_davidson_tpu_torch.ops import kernels
from tests.torch_parity import to_numpy

# float64: the same products summed in another order; float32 likewise.
RTOL = {jnp.float64: 1e-12, jnp.float32: 1e-5}
TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}


def _x(n, m, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.dtype(dtype))


def _assert_close(out, ref, dtype):
    ref = np.asarray(ref)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(to_numpy(out), ref, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale)


BANDED_CASES = ([(nbr, bw, m, jnp.float64) for nbr, bw in
                 [(16, 2), (24, 1), (32, 7)] for m in (3, 16, 130)]
                + [(nbr, bw, 16, jnp.float32) for nbr, bw in
                   [(16, 2), (24, 1), (32, 7)]])


@pytest.mark.parametrize("nbr,bw,m,dtype", BANDED_CASES)
def test_banded_plain_matches_pallas(nbr, bw, m, dtype):
    op = generate_banded_bsr(nbr, 8, bandwidth=bw, seed=9, dtype=dtype)
    X = _x(op.shape[0], m, dtype)
    ref = pk.banded_bsr_spmm(op.blocks, jnp.asarray(X), bandwidth=bw,
                             interpret=True)
    out = kernels.banded_bsr_spmm(torch.from_numpy(np.array(op.blocks)),
                                  torch.from_numpy(X), bw)
    assert out.dtype == TORCH[dtype]
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_general_plain_matches_pallas_on_clipped_band(dtype):
    # generate_banded_bsr clips the virtual columns of edge rows into range
    # (repeated columns with zero blocks).
    op = generate_banded_bsr(24, 8, bandwidth=2, seed=4, dtype=dtype)
    X = _x(op.shape[0], 16, dtype, seed=1)
    ref = pk.bsr_spmm(op.block_cols, op.blocks, jnp.asarray(X),
                      interpret=True)
    out = kernels.bsr_spmm(torch.from_numpy(np.array(op.block_cols)),
                           torch.from_numpy(np.array(op.blocks)),
                           torch.from_numpy(X))
    _assert_close(out, ref, dtype)


def _scrambled(nbr=13, bs=8, seed=5):
    """Random symmetric block pattern, own-row slot padding (from_block_coo)."""
    rng = np.random.default_rng(seed)
    pairs = {(r, r) for r in range(nbr)}
    while len(pairs) < 4 * nbr:
        i, j = (int(v) for v in rng.integers(0, nbr, 2))
        pairs |= {(i, j), (j, i)}
    brows, bcols = np.array(sorted(pairs)).T
    vals = rng.standard_normal((len(brows), bs, bs))
    return brows, bcols, vals, nbr


@pytest.mark.parametrize("m", [3, 130])
def test_general_plain_matches_pallas_on_scrambled_pattern(m):
    brows, bcols, vals, nbr = _scrambled()
    op = JaxBSR.from_block_coo(brows, bcols, vals, nbr, pad_width=9)
    cols = np.array(op.block_cols)
    # own-row padding: padded slots repeat the row's own block index
    assert np.any(np.sum(cols == np.arange(nbr)[:, None], axis=1) > 1)
    X = _x(op.shape[0], m, jnp.float64, seed=2)
    ref = pk.bsr_spmm(op.block_cols, op.blocks, jnp.asarray(X),
                      interpret=True)
    out = kernels.bsr_spmm(torch.from_numpy(cols),
                           torch.from_numpy(np.array(op.blocks)),
                           torch.from_numpy(X))
    _assert_close(out, ref, jnp.float64)


def test_bf16_storage_accumulates_in_f32():
    op = generate_banded_bsr(16, 8, bandwidth=1, seed=10, dtype=jnp.float32)
    X = _x(op.shape[0], 8, jnp.float32, seed=3)
    ref = pk.banded_bsr_spmm(op.blocks.astype(jnp.bfloat16),
                             jnp.asarray(X).astype(jnp.bfloat16),
                             bandwidth=1, interpret=True,
                             out_dtype=jnp.float32)
    out = kernels.banded_bsr_spmm(
        torch.from_numpy(np.array(op.blocks)).to(torch.bfloat16),
        torch.from_numpy(X).to(torch.bfloat16), 1, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    # Exact products of bf16 values, summed in float32 in another order.
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    op = generate_banded_bsr(16, 8, bandwidth=1, seed=3)
    blocks = torch.from_numpy(np.array(op.blocks))
    cols = torch.from_numpy(np.array(op.block_cols))
    X = torch.from_numpy(_x(op.shape[0], 4, jnp.float64))
    before = (kernels.banded_bsr_spmm.launches, kernels.bsr_spmm.launches)
    y1 = kernels.banded_bsr_spmm(blocks, X, 1)
    y2 = kernels.bsr_spmm(cols, blocks, X)
    assert (kernels.banded_bsr_spmm.launches,
            kernels.bsr_spmm.launches) == before
    torch.testing.assert_close(y1, kernels.banded_bsr_spmm_plain(blocks, X, 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(y2, kernels.bsr_spmm_plain(cols, blocks, X),
                               rtol=0, atol=0)


def test_wrappers_reject_bad_shapes():
    blocks = torch.zeros((4, 2, 6), dtype=torch.float64)
    with pytest.raises(ValueError):
        kernels.banded_bsr_spmm(blocks, torch.zeros((7, 1)), 1)
    with pytest.raises(ValueError):
        kernels.banded_bsr_spmm(blocks, torch.zeros((8, 1)), 2)
    with pytest.raises(ValueError):
        kernels.bsr_spmm(torch.zeros((4, 2), dtype=torch.int32), blocks,
                         torch.zeros((8, 1)))


def test_source_hash_names_the_build():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libfdt_bsr_spmm_") and path.suffix == ".so"
