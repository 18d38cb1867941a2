"""The banded generators' row builds (``ops.sparse.banded_bsr_rows``,
``banded_bsr_quantized_rows``) against the JAX package's generators, and
the sharded operators built from a rank's rows (``n_block_rows=``).

- Each rank's block rows, drawn alone, equal those rows of the JAX
  package's ``generate_banded_bsr`` (float64, float32) and
  ``generate_banded_bsr_quantized`` (int8 blocks, scales, diagonal) bit
  for bit, block columns included, at world sizes 2 and 4.
- The whole build, in chunks of 1, 7 and all block rows (1 and 7 on
  several host threads), equals the JAX generators bit for bit.
- The float32 diagonal is numpy's float range past 2**24.
- ``HaloBSROperator``, ``HaloQuantizedOperator`` and
  ``ShardedBSROperator`` built from a rank's rows hold the rows they cut
  from the global tables; a world size that does not divide the block
  rows raises ``OperatorError``, and so do tables of the wrong height.

The sharded solves built from rank rows (the bits of the solves built
from the global tables, at gloo worlds 2 and 4) run in the spawns of
``tests/torch_dist_worker.py`` and are held in
``tests/test_torch_parallel.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu_torch.ops import sparse as tsparse
from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                 HaloQuantizedOperator,
                                                 RowMesh)
from fortran_davidson_tpu_torch.parallel.sharded import ShardedBSROperator
from fortran_davidson_tpu_torch.utils.errors import OperatorError

CPU = torch.device("cpu")
BS = 8
SEED = 5
FORMS = ("float64", "float32", "int8")
BANDS = (1, 2, 3)
# (block rows, world size): 66 block rows split over two ranks only.
SPLITS = ((64, 2), (64, 4), (66, 2))
CHUNKS = (1, 7, None)


def _mesh(world: int, rank: int) -> RowMesh:
    """A rank of a ``world``-rank mesh whose group is never called."""
    return RowMesh(group=None, size=world, rank=rank, device=CPU)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor)
                             else np.asarray(a))
    return a.view(np.uint8)


def _jax_tables(form: str, nbr: int, bw: int) -> tuple:
    """The JAX generator's tables of ``form``, as numpy."""
    if form == "int8":
        op = jsparse.generate_banded_bsr_quantized(nbr, BS, bandwidth=bw,
                                                   seed=SEED)
        return op.qblocks, op.scale_rows, op.diag
    op = jsparse.generate_banded_bsr(nbr, BS, bandwidth=bw, seed=SEED,
                                     dtype=getattr(jnp, form))
    return op.block_cols, op.blocks


def _rows(form: str, nbr: int, bw: int, rows: slice) -> tuple:
    if form == "int8":
        return tsparse.banded_bsr_quantized_rows(nbr, BS, rows, bandwidth=bw,
                                                 seed=SEED, device="cpu")
    return tsparse.banded_bsr_rows(nbr, BS, rows, bandwidth=bw, seed=SEED,
                                   dtype=form, device="cpu")


@pytest.mark.parametrize("nbr,world", SPLITS)
@pytest.mark.parametrize("bw", BANDS)
@pytest.mark.parametrize("form", FORMS)
def test_rank_rows_equal_the_jax_generator(form, bw, nbr, world):
    want = _jax_tables(form, nbr, bw)
    for rank in range(world):
        rows = _mesh(world, rank).rows(nbr)
        got = _rows(form, nbr, bw, rows)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)[rows]
            assert g.shape == w.shape and g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("bw", BANDS)
@pytest.mark.parametrize("form", FORMS)
def test_chunked_whole_build_equals_the_jax_generator(form, bw, chunk):
    nbr = 64
    want = _jax_tables(form, nbr, bw)
    got = tsparse._banded_tables(nbr, BS, bw, 1e-3, SEED,
                                 torch.float32 if form == "int8" else form,
                                 slice(None), CPU, quantize=form == "int8",
                                 chunk_rows=chunk)
    if form != "int8":
        np.testing.assert_array_equal(
            tsparse._dia_block_cols(nbr, bw), np.asarray(want[0]))
        want = want[1:]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # The public generators take the default chunk.
    if form == "int8":
        op = tsparse.generate_banded_bsr_quantized(nbr, BS, bandwidth=bw,
                                                   seed=SEED, device="cpu")
        public = (op.qblocks, op.scale_rows, op.diag)
    else:
        public = (tsparse.generate_banded_bsr(nbr, BS, bandwidth=bw,
                                              seed=SEED, dtype=form,
                                              device="cpu").blocks,)
    for g, w in zip(public, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_float32_diagonal_is_numpys_range_past_2_24():
    # Block rows around entry 2**24 of a float32 diagonal, where not
    # every integer is a float32: the rows drawn alone carry
    # np.arange(1, n + 1, dtype=float32)'s entries, as the JAX generator
    # does.
    bs, a, b = 8, 2 ** 21 - 40, 2 ** 21 + 40
    nbr = b + 3
    _, _, diag = tsparse._banded_rows(nbr, bs, 1, 1e-3, SEED,
                                      np.dtype(np.float32), a, b,
                                      quantize=True)
    full = np.arange(1, nbr * bs + 1, dtype=np.float32)
    np.testing.assert_array_equal(_bits(diag.reshape(-1)),
                                  _bits(full[a * bs:b * bs]))


def _rank_operators(kind: str, nbr: int, bw: int, mesh: RowMesh) -> tuple:
    """(built from the rank's rows, cut from the global tables)."""
    rows = mesh.rows(nbr)
    if kind == "int8":
        q = tsparse.generate_banded_bsr_quantized(nbr, BS, bandwidth=bw,
                                                  seed=SEED, device="cpu")
        return (HaloQuantizedOperator(*_rows("int8", nbr, bw, rows), bw,
                                      mesh, n_block_rows=nbr),
                HaloQuantizedOperator.from_quantized(q, mesh))
    A = tsparse.generate_banded_bsr(nbr, BS, bandwidth=bw, seed=SEED,
                                    device="cpu")
    cols, blocks = _rows("float64", nbr, bw, rows)
    if kind == "general":
        return (ShardedBSROperator(tsparse.BSROperator(cols, blocks,
                                                       bandwidth=bw),
                                   mesh, n_block_rows=nbr),
                ShardedBSROperator(A, mesh))
    return (HaloBSROperator(cols, blocks, bw, mesh, backend=kind,
                            n_block_rows=nbr),
            HaloBSROperator.from_bsr(A, bw, mesh, backend=kind))


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("kind", ("xla", "pallas", "pallas-remote", "int8",
                                  "general"))
def test_operator_from_rank_rows_holds_the_cut_rows(kind, world):
    nbr, bw = 64, 2
    for rank in range(world):
        mesh = _mesh(world, rank)
        own, cut = _rank_operators(kind, nbr, bw, mesh)
        assert type(own) is type(cut) and own.shape == cut.shape
        names = (("qblocks", "scale_rows", "diag") if kind == "int8"
                 else ("block_cols", "blocks"))
        for name in names:
            a, b = getattr(own, name), getattr(cut, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(own.diagonal()),
                                      _bits(cut.diagonal()))
        if kind.startswith("pallas"):
            assert own.route == cut.route


@pytest.mark.parametrize("kind", ("pallas-remote", "int8", "general"))
def test_indivisible_or_misfit_rank_rows_raise(kind):
    mesh = _mesh(4, 1)
    # 66 block rows over four ranks: no rank's rows are drawn.
    with pytest.raises(OperatorError, match="not divisible"):
        _rank_operators(kind, 66, 1, mesh)
    # Tables of another height than the rank's rows.
    rows = _mesh(2, 1).rows(64)
    with pytest.raises(OperatorError, match="owns 16 of 64"):
        if kind == "int8":
            HaloQuantizedOperator(*_rows("int8", 64, 1, rows), 1, mesh,
                                  n_block_rows=64)
        elif kind == "general":
            ShardedBSROperator(tsparse.BSROperator(
                *_rows("float64", 64, 1, rows), bandwidth=1), mesh,
                n_block_rows=64)
        else:
            HaloBSROperator(*_rows("float64", 64, 1, rows), 1, mesh,
                            backend=kind, n_block_rows=64)
    # A world size that does not divide the block rows, handed tables.
    with pytest.raises(OperatorError, match="not divisible"):
        HaloBSROperator(*_rows("float64", 66, 1, slice(0, 16)), 1, mesh,
                        backend="pallas", n_block_rows=66)
