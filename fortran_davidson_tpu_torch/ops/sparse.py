"""Block-sparse (BSR, block-ELL) operator and its generator (counterpart of
``BSROperator`` and ``generate_banded_bsr`` in
``fortran_davidson_tpu/ops/sparse.py``).

``matmat`` always goes through the SpMM wrappers of
:mod:`fortran_davidson_tpu_torch.ops.kernels`: the CUDA kernels for
tensors on a GPU, their plain versions for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.ops.operators import LinearOperator
from fortran_davidson_tpu_torch.utils.dtypes import as_torch_dtype, numpy_dtype
from fortran_davidson_tpu_torch.utils.errors import OperatorError, require


class BSROperator(LinearOperator):
    """Block-ELL sparse symmetric operator (dense ``bs x bs`` blocks).

    ``block_cols``: (nbr, K) int32 — block-column index of each stored
    block (``from_block_coo`` pads slots with the row's own index;
    ``generate_banded_bsr`` clips virtual columns into range; the padded
    blocks are zero either way, and columns need not be distinct).
    ``blocks``: (nbr, bs, K*bs) — ``blocks[r, :, k*bs:(k+1)*bs]`` is the
    block at ``(r, block_cols[r, k])``.
    ``bandwidth``: declared block bandwidth of DIA-aligned storage (slot k
    of row r holds column r - bw + k); selects the banded kernel.
    """

    def __init__(self, block_cols, blocks, bandwidth: Optional[int] = None,
                 device=None):
        blocks = torch.as_tensor(blocks, device=device)
        block_cols = torch.as_tensor(block_cols, device=blocks.device).to(
            torch.int32).contiguous()
        require(blocks.ndim == 3 and block_cols.ndim == 2
                and blocks.shape[0] == block_cols.shape[0]
                and blocks.shape[2] == block_cols.shape[1] * blocks.shape[1],
                OperatorError,
                f"BSR needs (nbr, K) block_cols and (nbr, bs, K*bs) blocks, "
                f"got {tuple(block_cols.shape)} / {tuple(blocks.shape)}")
        if bandwidth is not None:
            require(block_cols.shape[1] == 2 * bandwidth + 1, OperatorError,
                    "banded BSR needs K == 2*bandwidth + 1 window-aligned "
                    f"slots, got K={block_cols.shape[1]}, bw={bandwidth}")
        self.block_cols = block_cols
        self.blocks = blocks.contiguous()
        self.bandwidth = None if bandwidth is None else int(bandwidth)

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_block_coo(cls, brows, bcols, block_vals, n_block_rows: int,
                       pad_width: Optional[int] = None, device=None):
        """Build from block-COO (host-side): ``block_vals[i]`` is the dense
        block at block position ``(brows[i], bcols[i])``."""
        brows = np.asarray(brows, np.int64)
        bcols = np.asarray(bcols, np.int64)
        block_vals = np.asarray(block_vals)
        bs = block_vals.shape[-1]
        nbr = n_block_rows
        order = np.lexsort((bcols, brows))
        brows, bcols, block_vals = brows[order], bcols[order], block_vals[order]
        counts = np.bincount(brows, minlength=nbr)
        K = int(counts.max()) if len(brows) else 1
        if pad_width is not None:
            require(pad_width >= K, OperatorError,
                    f"pad_width={pad_width} < max blocks/row {K}")
            K = pad_width
        K = max(K, 1)
        starts = np.zeros(nbr + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(len(brows)) - starts[brows]
        cols = np.tile(np.arange(nbr, dtype=np.int64)[:, None], (1, K))
        vals = np.zeros((nbr, K, bs, bs), block_vals.dtype)
        cols[brows, slot] = bcols
        vals[brows, slot] = block_vals
        return cls(torch.from_numpy(cols.astype(np.int32)),
                   torch.from_numpy(np.ascontiguousarray(
                       vals.transpose(0, 2, 1, 3)).reshape(nbr, bs, K * bs)),
                   device=device)

    @classmethod
    def from_dense(cls, matrix, bs: int, tol: float = 0.0, device=None):
        m = np.asarray(matrix.cpu() if isinstance(matrix, torch.Tensor)
                       else matrix)
        n = m.shape[0]
        require(n % bs == 0, OperatorError,
                f"matrix dim {n} not divisible by block size {bs}")
        nbr = n // bs
        t = m.reshape(nbr, bs, nbr, bs).transpose(0, 2, 1, 3)
        nz = np.abs(t).max(axis=(2, 3)) > tol
        brows, bcols = np.nonzero(nz)
        return cls.from_block_coo(brows, bcols, t[brows, bcols], nbr,
                                  device=device)

    # -- LinearOperator -------------------------------------------------
    @property
    def block_size(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def blocks_per_row(self) -> int:
        return self.blocks.shape[2] // self.blocks.shape[1]

    @property
    def shape(self):
        n = self.n_block_rows * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    def matmat(self, block):
        # Mixed precision (``ops/sparse.py:669-675``): sub-32-bit stored
        # blocks contract in their own type and return the input's type.
        target = block.dtype
        compute = (self.dtype if self.dtype.itemsize < target.itemsize
                   else target)
        x = block.to(compute).contiguous()
        blocks = self.blocks.to(compute)
        if self.bandwidth is not None:
            return kernels.banded_bsr_spmm(blocks, x, self.bandwidth,
                                           out_dtype=target)
        return kernels.bsr_spmm(self.block_cols, blocks, x, out_dtype=target)

    def _blocks4(self):
        nbr, bs, kbs = self.blocks.shape
        return self.blocks.reshape(nbr, bs, kbs // bs, bs)

    def _own_slots(self):
        """(nbr, K) bool: slot k of row r is the diagonal block."""
        nbr = self.n_block_rows
        return self.block_cols == torch.arange(
            nbr, dtype=torch.int32, device=self.device)[:, None]

    def diagonal(self):
        nbr, bs, _ = self.blocks.shape
        if self.bandwidth is not None:
            bw = self.bandwidth
            diag_blocks = self.blocks[:, :, bw * bs:(bw + 1) * bs]
        else:
            own = self._own_slots()
            diag_blocks = torch.sum(torch.where(
                own[:, None, :, None], self._blocks4(), 0), dim=2)
        return torch.diagonal(diag_blocks, dim1=1, dim2=2).reshape(-1)

    def to_dense(self):
        nbr, bs, kbs = self.blocks.shape
        K = kbs // bs
        dense = torch.zeros((nbr, nbr, bs, bs), dtype=self.dtype,
                            device=self.device)
        rows = torch.arange(nbr, device=self.device)[:, None].expand(nbr, K)
        dense.index_put_((rows, self.block_cols.long()),
                         self._blocks4().permute(0, 2, 1, 3), accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(nbr * bs, nbr * bs)

    def offdiag(self) -> "BSROperator":
        """Exact off-diagonal split: diagonal entries of the on-diagonal
        blocks zeroed."""
        nbr, bs, kbs = self.blocks.shape
        j = torch.arange(kbs, device=self.device)
        in_block_diag = (torch.arange(bs, device=self.device)[:, None]
                         == (j % bs)[None, :])              # (bs, K*bs)
        slot_of = j // bs
        if self.bandwidth is not None:
            mask = ((slot_of == self.bandwidth)[None, :]
                    & in_block_diag)[None]
        else:
            mask = self._own_slots()[:, None, slot_of] & in_block_diag[None]
        return BSROperator(self.block_cols,
                           torch.where(mask, 0, self.blocks),
                           bandwidth=self.bandwidth)

    def astype(self, dtype) -> "BSROperator":
        """Recast the stored blocks (e.g. bfloat16 storage for float32
        solves; the CUDA kernels take float32 and float64 only yet)."""
        return BSROperator(self.block_cols,
                           self.blocks.to(as_torch_dtype(dtype)),
                           bandwidth=self.bandwidth)


def _dia_block_cols(nbr: int, bw: int):
    """Gather-safe column table of DIA-aligned storage: virtual column
    r - bw + k clipped into range."""
    offs = np.arange(nbr)[:, None] - bw + np.arange(2 * bw + 1)
    return np.clip(offs, 0, nbr - 1).astype(np.int32)


def generate_banded_bsr(n_block_rows: int, bs: int, bandwidth: int = 1,
                        coupling: float = 1e-3, seed: int = 0,
                        dtype=torch.float64, device=None) -> BSROperator:
    """Banded block-sparse symmetric diagonal-dominant matrix.

    Bit-equal to ``fortran_davidson_tpu.ops.sparse.generate_banded_bsr``
    (the same numpy draws in the same order): dense diagonal blocks with
    dominant diagonal ``1..n`` and small random coupling blocks within
    ``bandwidth`` block diagonals on each side, stored DIA-aligned.
    """
    rng = np.random.default_rng(seed)
    dt = numpy_dtype(dtype)
    nbr = n_block_rows
    bw = bandwidth
    K = 2 * bw + 1
    require(nbr >= K, OperatorError,
            f"need at least K={K} block rows for bandwidth {bw}")
    vals = np.zeros((nbr, K, bs, bs), dt)
    for d in range(1, bw + 1):
        cnt = nbr - d
        if cnt <= 0:
            continue
        blocks = (rng.random((cnt, bs, bs)).astype(dt) - 0.5) * coupling
        r = np.arange(cnt)
        vals[r, bw + d] = blocks
        vals[r + d, bw - d] = blocks.transpose(0, 2, 1)
    dblocks = (rng.random((nbr, bs, bs)).astype(dt) - 0.5) * coupling
    dblocks = dblocks + dblocks.transpose(0, 2, 1)
    diag = np.arange(1, nbr * bs + 1, dtype=dt).reshape(nbr, bs)
    idx = np.arange(bs)
    dblocks[:, idx, idx] = diag
    vals[:, bw] = dblocks
    blocks = np.ascontiguousarray(vals.transpose(0, 2, 1, 3)).reshape(
        nbr, bs, K * bs)
    del vals, dblocks
    return BSROperator(torch.from_numpy(_dia_block_cols(nbr, bw)),
                       torch.from_numpy(blocks), bandwidth=bw, device=device)
