"""Sparse operators and their generators (counterpart of
``fortran_davidson_tpu/ops/sparse.py``): the block-sparse
``BSROperator`` and ``QuantizedBandedOperator`` with
``generate_banded_bsr``, ``quantize_banded_int8`` and
``generate_banded_bsr_quantized``; and the ELL family,
``ELLOperator``, ``SlicedELLOperator`` and ``HybridBandedOperator`` with
``split_band_remainder``, ``generate_sparse_diagonal_dominant`` and
``generate_local_sparse``.

``matmat`` and ``matmat_with_gram`` of the block-sparse operators go
through the wrappers of :mod:`fortran_davidson_tpu_torch.ops.kernels`:
the CUDA kernels for tensors on a GPU, their plain versions for tensors
on the CPU. There is no ``backend`` field: the kernel follows the
device. The ELL and sliced-ELL applies are plain PyTorch gathers and
sums, as the JAX package's are XLA outside any Pallas kernel; the hybrid
operator's band is a banded ``BSROperator`` (kernel 1).

Constructors, ``from_coo``, ``from_block_coo``, ``from_dense`` and the
generators put what they build from numpy on ``device``, by default the
GPU; tensors handed to a constructor stay on their device
(``utils.dtypes.as_device_tensor``). COO assembly runs on the host, in
the native C++ assembler of :mod:`fortran_davidson_tpu_torch.native`
where it builds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.ops.operators import LinearOperator
from fortran_davidson_tpu_torch.utils import ds as dsm
from fortran_davidson_tpu_torch.utils.dtypes import (as_device_tensor,
                                                     as_torch_dtype,
                                                     default_device,
                                                     numpy_dtype)
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
        blocks = as_device_tensor(blocks, device)
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
                   device=default_device(device))

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

    def matmat_with_gram(self, block, v=None, *, write_out: bool = True):
        """Fused ``Y = A @ X`` and ``G = Vᵀ Y`` (``v=None``: V = X), G
        float32 of shape (mv, m) (``ops/sparse.py:699-734``).

        Banded storage runs the fused kernel; general storage takes the
        two-pass composition (the same math, one more pass over Y).
        Returns ``(Y, G)``, or ``G`` alone with ``write_out=False``.
        """
        if self.bandwidth is None:
            return _two_pass_gram(self, block, block if v is None else v,
                                  write_out)
        target = block.dtype
        compute = (self.dtype if self.dtype.itemsize < target.itemsize
                   else target)
        return kernels.banded_bsr_spmm_gram(
            self.blocks.to(compute), block.to(compute).contiguous(),
            None if v is None else v.to(compute), bandwidth=self.bandwidth,
            write_out=write_out, out_dtype=target)

    def matmat_ds(self, x_hi, x_lo):
        """Compensated double-single block apply (``ops/sparse.py:736-781``).

        Each slot contracts as its own ``(bs, bs) @ (bs, m)`` batched
        product in the working dtype (true float32: the caller pins TF32
        off), the K per-slot partials combine by exact ``two_sum``, and
        the lo words pass through the same contractions into the error
        channel. What remains is each slot's own accumulation rounding,
        ~eps·sqrt(bs)·|entries|·|x|: far below the whole apply's
        eps·|A x| on the off-diagonal split of a diagonal-dominant
        operator (the refined solver's ``A_off``). Plain PyTorch: it is
        no Pallas kernel in the JAX package either.
        """
        nbr, bs, kbs = self.blocks.shape
        K = kbs // bs
        m = x_hi.shape[1]
        dt = x_hi.dtype
        xb_hi = x_hi.reshape(nbr, bs, m)
        xb_lo = x_lo.reshape(nbr, bs, m)
        if self.bandwidth is not None:
            hi_slices = _slot_slices_dia(xb_hi, self.bandwidth, K)
            lo_slices = _slot_slices_dia(xb_lo, self.bandwidth, K)
        else:
            hi_slices = _slot_slices_gather(xb_hi, self.block_cols)
            lo_slices = _slot_slices_gather(xb_lo, self.block_cols)
        parts_hi, parts_lo = [], []
        for k in range(K):
            blk = self.blocks[:, :, k * bs:(k + 1) * bs].to(dt)
            parts_hi.append(torch.bmm(blk, hi_slices[k]))
            parts_lo.append(torch.bmm(blk, lo_slices[k]))
        y_hi, y_lo = _ds_slot_accumulate(parts_hi, parts_lo)
        return y_hi.reshape(nbr * bs, m), y_lo.reshape(nbr * bs, m)

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
            # The diagonal entries of every slot's block, summed over the
            # row's own slots: reads nbr*K*bs entries, not the whole table.
            entries = torch.diagonal(self._blocks4(), dim1=1, dim2=3)
            return torch.sum(torch.where(self._own_slots()[:, :, None],
                                         entries, 0), dim=1).reshape(-1)
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
        solves: the kernels sum bf16 products in float32)."""
        return BSROperator(self.block_cols,
                           self.blocks.to(as_torch_dtype(dtype)),
                           bandwidth=self.bandwidth)


def _slot_slices_dia(xb, bw: int, K: int):
    """Per-slot (nbr, bs, m) input slices of DIA-aligned storage: ``bw``
    zero block rows padded on each side, contiguous slices, no gather
    (out-of-range slots store zero blocks)."""
    nbr = xb.shape[0]
    xp = torch.nn.functional.pad(xb, (0, 0, 0, 0, bw, bw))
    return [xp[k:k + nbr] for k in range(K)]


def _slot_slices_gather(xb, block_cols):
    """Per-slot input slices through the stored block-column table."""
    cols = block_cols.long()
    return [xb[cols[:, k]] for k in range(block_cols.shape[1])]


def _ds_slot_accumulate(parts_hi, parts_lo):
    """Exact two_sum fold of per-slot (hi, lo) contributions."""
    y_hi, y_lo = parts_hi[0], parts_lo[0]
    for ph, pl in zip(parts_hi[1:], parts_lo[1:]):
        y_hi, e = dsm.two_sum(y_hi, ph)
        y_lo = y_lo + pl + e
    return dsm.fast_two_sum(y_hi, y_lo)


def _two_pass_gram(op, block, vv, write_out: bool):
    """Two-pass composition of ``matmat_with_gram``
    (``ops/sparse.py:549-556``): the apply, then a float32 product."""
    y = op.matmat(block)
    g = vv.to(torch.float32).T @ y.to(torch.float32)
    return (y, g) if write_out else g


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
                       torch.from_numpy(blocks), bandwidth=bw,
                       device=default_device(device))


class QuantizedBandedOperator(LinearOperator):
    """int8-quantized DIA-banded BSR operator (``ops/sparse.py:938-1137``).

    ``qblocks``: (nbr, bs, K*bs) int8, the OFF-diagonal part of the
    operator, quantized with one float32 scale per (block row, band slot);
    ``scale_rows``: (nbr, K*bs) float32, each slot's scale broadcast over
    its lanes; ``diag``: (nbr, bs) float32, the exact matrix diagonal;
    ``bandwidth``: the block bandwidth (K = 2*bw + 1). Off-diagonal entries
    carry ~0.4% relative quantization error: bf16-class tolerances only.
    Build with :func:`quantize_banded_int8` or
    :func:`generate_banded_bsr_quantized`.
    """

    def __init__(self, qblocks, scale_rows, diag, bandwidth: int,
                 device=None):
        qblocks = as_device_tensor(qblocks, device).to(torch.int8)
        dev = qblocks.device
        scale_rows = torch.as_tensor(scale_rows, device=dev).to(torch.float32)
        diag = torch.as_tensor(diag, device=dev).to(torch.float32)
        require(qblocks.ndim == 3, OperatorError,
                f"quantized banded needs (nbr, bs, K*bs) int8 blocks, got "
                f"{tuple(qblocks.shape)}")
        nbr, bs, kbs = qblocks.shape
        require(tuple(scale_rows.shape) == (nbr, kbs)
                and tuple(diag.shape) == (nbr, bs), OperatorError,
                f"quantized banded needs (nbr, K*bs) scales and (nbr, bs) "
                f"diag for blocks {tuple(qblocks.shape)}; got "
                f"{tuple(scale_rows.shape)} / {tuple(diag.shape)}")
        require(kbs == (2 * bandwidth + 1) * bs, OperatorError,
                "quantized banded needs DIA-aligned K == 2*bw+1 slots")
        self.qblocks = qblocks.contiguous()
        self.scale_rows = scale_rows.contiguous()
        self.diag = diag.contiguous()
        self.bandwidth = int(bandwidth)

    @property
    def block_size(self) -> int:
        return self.qblocks.shape[1]

    @property
    def n_block_rows(self) -> int:
        return self.qblocks.shape[0]

    @property
    def shape(self):
        n = self.n_block_rows * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.scale_rows.dtype

    @property
    def device(self):
        return self.qblocks.device

    def matmat(self, block):
        return kernels.banded_q_bsr_spmm(
            self.qblocks, self.scale_rows, self.diag, block.contiguous(),
            self.bandwidth, out_dtype=block.dtype)

    def matmat_with_gram(self, block, v=None, *, write_out: bool = True):
        """Fused SpMM + Gram on int8 storage (see
        :meth:`BSROperator.matmat_with_gram`)."""
        return kernels.banded_q_bsr_spmm_gram(
            self.qblocks, self.scale_rows, self.diag, block.contiguous(), v,
            bandwidth=self.bandwidth, write_out=write_out,
            out_dtype=block.dtype)

    def matmat_ds(self, x_hi, x_lo):
        """Compensated double-single apply on int8 storage
        (``ops/sparse.py:1050-1105``; the combine of
        :meth:`BSROperator.matmat_ds`).

        Per slot the integer contraction ``Q_k @ x`` runs first (int8
        values are exact in float32; each slot's blocks are widened to
        float32 on every call, as the JAX package does), the slot's scale
        multiplies afterwards by exact ``two_prod``, and the exact
        diagonal enters as ``two_prod(d, x_hi)`` with ``d * x_lo`` in the
        error channel. On the ``offdiag()`` instance the diagonal is zero.
        """
        nbr, bs, kbs = self.qblocks.shape
        K = kbs // bs
        m = x_hi.shape[1]
        dt = x_hi.dtype
        xb_hi = x_hi.reshape(nbr, bs, m)
        xb_lo = x_lo.reshape(nbr, bs, m)
        hi_slices = _slot_slices_dia(xb_hi, self.bandwidth, K)
        lo_slices = _slot_slices_dia(xb_lo, self.bandwidth, K)
        scales = self.scale_rows.reshape(nbr, K, bs)[:, :, 0].to(dt)
        parts_hi, parts_lo = [], []
        for k in range(K):
            qk = self.qblocks[:, :, k * bs:(k + 1) * bs].to(dt)
            ik_hi = torch.bmm(qk, hi_slices[k])
            ik_lo = torch.bmm(qk, lo_slices[k])
            del qk
            sk = scales[:, k][:, None, None]
            p, e = dsm.two_prod(ik_hi, sk)
            parts_hi.append(p)
            parts_lo.append(e + ik_lo * sk)
        d = self.diag.to(dt)[:, :, None]
        p, e = dsm.two_prod(d, xb_hi)
        parts_hi.append(p)
        parts_lo.append(e + d * xb_lo)
        y_hi, y_lo = _ds_slot_accumulate(parts_hi, parts_lo)
        return y_hi.reshape(nbr * bs, m), y_lo.reshape(nbr * bs, m)

    def diagonal(self):
        return self.diag.reshape(-1)

    def offdiag(self) -> "QuantizedBandedOperator":
        """Exact: the diagonal is stored separately; zero it."""
        return QuantizedBandedOperator(self.qblocks, self.scale_rows,
                                       torch.zeros_like(self.diag),
                                       bandwidth=self.bandwidth)

    def to_dense(self):
        deq = self.qblocks.to(torch.float32) * self.scale_rows[:, None, :]
        cols = torch.from_numpy(_dia_block_cols(self.n_block_rows,
                                                self.bandwidth))
        base = BSROperator(cols, deq, bandwidth=self.bandwidth)
        return base.to_dense() + torch.diag(self.diagonal())


def quantize_banded_int8(op: BSROperator) -> QuantizedBandedOperator:
    """Quantize a DIA-aligned banded :class:`BSROperator` to int8 storage
    (``ops/sparse.py:1145-1169``): per band slot of each block row,
    symmetric int8 quantization of the off-diagonal entries (scale =
    max|block| / 127); the diagonal is split out and kept exact in
    float32."""
    require(op.bandwidth is not None, OperatorError,
            "quantize_banded_int8 needs window-aligned banded storage "
            "(BSROperator(..., bandwidth=bw))")
    nbr, bs, kbs = op.blocks.shape
    K = kbs // bs
    b4 = op.offdiag().blocks.to(torch.float32).reshape(nbr, bs, K, bs)
    amax = torch.amax(torch.abs(b4), dim=(1, 3))              # (nbr, K)
    scales = torch.where(amax > 0, amax / 127.0,
                         torch.ones((), dtype=torch.float32))
    q4 = torch.clamp(torch.round(b4 / scales[:, None, :, None]),
                     -127, 127).to(torch.int8)
    scale_rows = scales[:, :, None].expand(nbr, K, bs).reshape(nbr, K * bs)
    diag = op.diagonal().to(torch.float32).reshape(nbr, bs)
    return QuantizedBandedOperator(q4.reshape(nbr, bs, K * bs), scale_rows,
                                   diag, bandwidth=op.bandwidth)


def generate_banded_bsr_quantized(n_block_rows: int, bs: int,
                                  bandwidth: int = 1,
                                  coupling: float = 1e-3, seed: int = 0,
                                  device=None) -> QuantizedBandedOperator:
    """Generate and int8-quantize a banded operator on the host
    (``ops/sparse.py:1172-1227``), so only the int8 blocks and the float32
    scales and diagonal reach the device. Bit-equal to the JAX package's:
    the same numpy draws, assembly and quantization, in the same order.
    """
    rng = np.random.default_rng(seed)
    dt = np.float32
    nbr, bw = n_block_rows, bandwidth
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
    del dblocks
    # b4[r, i, k, j] == vals[r, k, i, j] (the stored row-major layout),
    # with the centre slot's diagonal zeroed for the off-diagonal split.
    b4 = vals.transpose(0, 2, 1, 3).copy()
    del vals
    b4[:, idx, bw, idx] = 0.0
    amax = np.max(np.abs(b4), axis=(1, 3))              # (nbr, K)
    scales = np.where(amax > 0, amax / dt(127.0), dt(1.0)).astype(dt)
    # clip(round(b4 / s)), in place: the same float32 operations.
    np.divide(b4, scales[:, None, :, None], out=b4)
    np.round(b4, out=b4)
    np.clip(b4, -127, 127, out=b4)
    q4 = b4.astype(np.int8)
    del b4
    scale_rows = np.broadcast_to(
        scales[:, :, None], (nbr, K, bs)).reshape(nbr, K * bs)
    return QuantizedBandedOperator(
        torch.from_numpy(q4.reshape(nbr, bs, K * bs)),
        torch.from_numpy(np.ascontiguousarray(scale_rows)),
        torch.from_numpy(diag), bandwidth=bw, device=default_device(device))


# -- the ELL family: padded ELL, sliced ELL, band + remainder --------------

def _coo_dedup_np(rows, cols, vals, n):
    """Host-side COO canonicalisation (``ops/sparse.py:48-75``): range
    check, row-major sort, duplicates summed. Shared by the padded-ELL and
    sliced-ELL builders."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    # The native assembler's index contract: out-of-range indices raise
    # instead of folding into a neighbouring row or column.
    if len(rows) and not (rows.min() >= 0 and cols.min() >= 0
                          and rows.max() < n and cols.max() < n):
        raise OperatorError(
            f"COO indices out of range [0, {n}): rows in "
            f"[{rows.min()}, {rows.max()}], cols in "
            f"[{cols.min()}, {cols.max()}]")
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        # Duplicates are adjacent after the sort: group-sum with reduceat.
        key = rows * n + cols
        first = np.empty(len(key), bool)
        first[0] = True
        np.not_equal(key[1:], key[:-1], out=first[1:])
        idx = np.flatnonzero(first)
        vals = np.add.reduceat(vals, idx)
        rows, cols = rows[idx], cols[idx]
    return rows, cols, vals


def _ell_from_coo_np(rows, cols, vals, n, pad_width: Optional[int] = None):
    """Host-side COO -> padded ELL (``ops/sparse.py:78-96``; duplicates
    summed): the numpy fallback of ``native.ell_from_coo``, bit for bit."""
    rows, cols, vals = _coo_dedup_np(rows, cols, vals, n)
    counts = np.bincount(rows, minlength=n)
    L = int(counts.max()) if len(rows) else 1
    if pad_width is not None:
        require(pad_width >= L, OperatorError,
                f"pad_width={pad_width} < max row nnz {L}")
        L = pad_width
    L = max(L, 1)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(rows)) - starts[rows]
    indices = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, L))
    values = np.zeros((n, L), vals.dtype)
    indices[rows, slot] = cols
    values[rows, slot] = vals
    return indices.astype(np.int32), values


def _ell_piece(idx, val, x):
    """``sum_l val[:, l] * x[idx[:, l]]`` of one chunk of slots: a gather
    of (r, c, m) rows through the int32 index, then a multiply and a sum
    over the slot axis (no matmul: nothing here can run in TF32)."""
    r, c = idx.shape
    g = torch.index_select(x, 0, idx.reshape(-1)).reshape(r, c, x.shape[1])
    return torch.sum(val.to(x.dtype)[:, :, None] * g, dim=1)


def _ell_chunked_apply(indices, values, block, chunk: int):
    """Chunked gather and contraction over one fixed-width slot table
    (``ops/sparse.py:220-250``): ``indices``/``values`` (r, L), returns
    (r, m); the peak temporary is (r, chunk, m). The shared inner SpMM of
    :class:`ELLOperator` and :class:`SlicedELLOperator`."""
    r, L = indices.shape
    c = max(1, min(chunk, L))
    out = torch.zeros((r, block.shape[1]), dtype=block.dtype,
                      device=block.device)
    for s in range(0, L, c):
        out = out + _ell_piece(indices[:, s:s + c], values[:, s:s + c], block)
    return out


def _ell_chunked_apply_ds(indices, values, x_hi, x_lo, chunk: int):
    """Double-single sibling of :func:`_ell_chunked_apply`
    (``ops/sparse.py:253-289``): every chunk's partial of the hi words
    folds in with an exact ``two_sum``; its error and the lo words'
    partial (first-order small) ride in the error channel."""
    r, L = indices.shape
    c = max(1, min(chunk, L))
    hi = torch.zeros((r, x_hi.shape[1]), dtype=x_hi.dtype,
                     device=x_hi.device)
    lo = torch.zeros_like(hi)
    for s in range(0, L, c):
        idx, val = indices[:, s:s + c], values[:, s:s + c]
        hi, e = dsm.two_sum(hi, _ell_piece(idx, val, x_hi))
        lo = lo + e + _ell_piece(idx, val, x_lo)
    return dsm.fast_two_sum(hi, lo)


class ELLOperator(LinearOperator):
    """Padded-row (ELLPACK) sparse symmetric operator
    (``ops/sparse.py:100-217``).

    Stores the full symmetric pattern, ``indices`` (int32) and ``values``
    (the stored dtype), both (n, L) on the operator's device; padded slots
    hold ``(row, 0)``, so they add nothing and every gather index stays in
    range. ``chunk`` bounds the apply's temporary at (n, chunk, m).
    ``matmat`` is plain PyTorch (a gather and a sum over the slot axis),
    as the JAX package's is XLA outside any Pallas kernel.
    """

    def __init__(self, indices, values, chunk: int = 8, device=None):
        values = as_device_tensor(values, device)
        indices = torch.as_tensor(indices, device=values.device).to(
            torch.int32)
        require(indices.shape == values.shape and indices.ndim == 2,
                OperatorError,
                f"ELL needs matching (n, L) indices/values, got "
                f"{tuple(indices.shape)} / {tuple(values.shape)}")
        self.indices = indices.contiguous()
        self.values = values.contiguous()
        self.chunk = int(chunk)

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, dtype=torch.float64,
                 pad_width: Optional[int] = None, chunk: int = 8,
                 use_native: bool = True, device=None):
        """Build from COO triplets (duplicates summed) on the host: in the
        native C++ assembler (:mod:`fortran_davidson_tpu_torch.native`)
        when it builds, else its numpy fallback, which gives the same
        tables."""
        from fortran_davidson_tpu_torch import native
        vals_np = np.asarray(vals, numpy_dtype(dtype))
        out = (native.ell_from_coo(np.asarray(rows), np.asarray(cols),
                                   vals_np, n, pad_width)
               if use_native else None)
        if out is None:
            out = _ell_from_coo_np(np.asarray(rows), np.asarray(cols),
                                   vals_np, n, pad_width)
        return cls(torch.from_numpy(out[0]), torch.from_numpy(out[1]),
                   chunk=chunk, device=default_device(device))

    @classmethod
    def from_csr(cls, indptr, indices, data, dtype=torch.float64,
                 pad_width: Optional[int] = None, chunk: int = 8,
                 device=None):
        indptr = np.asarray(indptr, np.int64)
        n = len(indptr) - 1
        rows = np.repeat(np.arange(n), np.diff(indptr))
        return cls.from_coo(rows, indices, np.asarray(data,
                                                      numpy_dtype(dtype)),
                            n, dtype=dtype, pad_width=pad_width,
                            chunk=chunk, device=device)

    @classmethod
    def from_dense(cls, matrix, tol: float = 0.0, chunk: int = 8,
                   device=None):
        m = np.asarray(matrix.cpu() if isinstance(matrix, torch.Tensor)
                       else matrix)
        rows, cols = np.nonzero(np.abs(m) > tol)
        return cls.from_coo(rows, cols, m[rows, cols], m.shape[0],
                            dtype=m.dtype, chunk=chunk, device=device)

    # -- LinearOperator -------------------------------------------------
    @property
    def shape(self):
        return (self.indices.shape[0], self.indices.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz_per_row(self) -> int:
        return self.indices.shape[1]

    @property
    def nnz(self) -> int:
        """Stored nonzero count."""
        return int(torch.count_nonzero(self.values))

    def matmat(self, block):
        return _ell_chunked_apply(self.indices, self.values, block,
                                  self.chunk)

    def matmat_ds(self, x_hi, x_lo):
        """Compensated double-single apply (``ops/sparse.py:180-187``):
        chunk partials combined with exact ``two_sum``, the lo words
        through the same contractions (see :meth:`BSROperator.matmat_ds`
        for the accuracy contract)."""
        return _ell_chunked_apply_ds(self.indices, self.values, x_hi, x_lo,
                                     self.chunk)

    def _on_diag(self):
        n = self.indices.shape[0]
        return self.indices == torch.arange(
            n, dtype=torch.int32, device=self.device)[:, None]

    def diagonal(self):
        return torch.sum(torch.where(self._on_diag(), self.values, 0), dim=1)

    def offdiag(self) -> "ELLOperator":
        """Exact off-diagonal split: stored diagonal slots zeroed."""
        return ELLOperator(self.indices,
                           torch.where(self._on_diag(), 0, self.values),
                           chunk=self.chunk)

    def to_dense(self):
        n, L = self.indices.shape
        dense = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)[:, None].expand(n, L)
        return dense.index_put_((rows, self.indices.long()), self.values,
                                accumulate=True)


class SlicedELLOperator(LinearOperator):
    """Row-length-sorted sliced ELL (SELL-σ with a global sort, σ = n;
    ``ops/sparse.py:292-515``).

    Rows are sorted by stored-entry count into contiguous buckets of
    power-of-two width, each padded only to its own width (at most 2x
    waste); rows with no entries take no part in the compute. One final
    n-row gather (``gather_map``) puts the concatenated bucket outputs
    back in row order, so the apply has no scatter. Gather traffic falls
    from ``n * L_max`` slots to ``sum_b rows_b * 2^b + n``: the layout of
    a skewed remainder (:func:`split_band_remainder`).

    ``bucket_rows`` (int32 (r_b,)), ``bucket_indices`` (int32 (r_b, w_b))
    and ``bucket_values`` ((r_b, w_b), the stored dtype) are tuples, one
    entry a bucket; ``gather_map`` (int32 (n,)) is each row's position in
    the concatenated output, or the appended zero row for empty rows.
    """

    def __init__(self, bucket_rows, bucket_indices, bucket_values,
                 gather_map, chunk: int = 8, device=None):
        require(len(bucket_rows) == len(bucket_indices)
                == len(bucket_values) > 0,
                OperatorError, "sliced ELL needs >= 1 (rows, idx, val) "
                "bucket triple (an empty (0, 1) bucket is fine)")
        bucket_values = tuple(as_device_tensor(v, device).contiguous()
                              for v in bucket_values)
        dev = bucket_values[0].device

        def index(t):
            return torch.as_tensor(t, device=dev).to(torch.int32).contiguous()

        bucket_rows = tuple(index(r) for r in bucket_rows)
        bucket_indices = tuple(index(i) for i in bucket_indices)
        for r, i, v in zip(bucket_rows, bucket_indices, bucket_values):
            require(i.shape == v.shape and i.ndim == 2
                    and r.shape == i.shape[:1], OperatorError,
                    f"bucket shape mismatch: rows {tuple(r.shape)}, idx "
                    f"{tuple(i.shape)}, val {tuple(v.shape)}")
        self.bucket_rows = bucket_rows
        self.bucket_indices = bucket_indices
        self.bucket_values = bucket_values
        self.gather_map = index(gather_map)
        self.chunk = int(chunk)

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, dtype=torch.float64,
                 chunk: int = 8, device=None):
        """Build from COO triplets (duplicates summed, host-side)."""
        vals_np = np.asarray(vals, numpy_dtype(dtype))
        rows, cols, vals_np = _coo_dedup_np(
            np.asarray(rows), np.asarray(cols), vals_np, n)
        counts = np.bincount(rows, minlength=n)
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        nz_rows = np.nonzero(counts)[0]
        # Rows with a count in (2^(k-1), 2^k] share a bucket.
        widths = (1 << np.ceil(np.log2(np.maximum(
            counts[nz_rows], 1))).astype(np.int64)) if len(nz_rows) else \
            np.zeros(0, np.int64)
        # Vectorised slot placement: an entry's slot is its rank in its
        # row; its bucket row is the row's place in the width-descending
        # order.
        slot_of = np.arange(len(rows)) - starts[rows]
        row_width = (widths[np.searchsorted(nz_rows, rows)]
                     if len(rows) else np.zeros(0, np.int64))
        positions = np.full(n, -1, np.int64)
        b_rows, b_idx, b_val = [], [], []
        pos = 0
        for w in sorted(set(widths.tolist()), reverse=True):
            sel = np.sort(nz_rows[widths == w])
            positions[sel] = pos + np.arange(len(sel))
            pos += len(sel)
            in_b = row_width == w
            local = np.searchsorted(sel, rows[in_b])
            idx_b = np.tile(sel[:, None], (1, w)).astype(np.int64)
            val_b = np.zeros((len(sel), w), vals_np.dtype)
            idx_b[local, slot_of[in_b]] = cols[in_b]
            val_b[local, slot_of[in_b]] = vals_np[in_b]
            b_rows.append(sel.astype(np.int32))
            b_idx.append(idx_b.astype(np.int32))
            b_val.append(val_b)
        if not b_rows:  # no stored entries at all: one empty bucket
            b_rows = [np.zeros(0, np.int32)]
            b_idx = [np.zeros((0, 1), np.int32)]
            b_val = [np.zeros((0, 1), vals_np.dtype)]
        gather_map = np.where(positions >= 0, positions, pos)
        dev = default_device(device)
        return cls([torch.from_numpy(r) for r in b_rows],
                   [torch.from_numpy(i) for i in b_idx],
                   [torch.from_numpy(v) for v in b_val],
                   torch.from_numpy(gather_map), chunk=chunk, device=dev)

    @classmethod
    def from_ell(cls, op: ELLOperator) -> "SlicedELLOperator":
        """Re-slice a padded ELL operator (host-side), on its device."""
        idx = op.indices.cpu().numpy()
        val = op.values.cpu().numpy()
        keep = val != 0
        rows = np.broadcast_to(np.arange(idx.shape[0])[:, None],
                               idx.shape)[keep]
        return cls.from_coo(rows, idx[keep], val[keep], idx.shape[0],
                            dtype=val.dtype, chunk=op.chunk,
                            device=op.device)

    def to_ell(self) -> ELLOperator:
        """Host-side conversion back to the uniformly padded layout, on the
        operator's device: a (n, L) table splits by rows with no output
        crossing ranks, while the unsort gather would cross them."""
        r2, c2, v2 = [], [], []
        for r, i, v in zip(self.bucket_rows, self.bucket_indices,
                           self.bucket_values):
            v = v.cpu().numpy()
            keep = v != 0
            r2.append(np.broadcast_to(r.cpu().numpy()[:, None],
                                      v.shape)[keep])
            c2.append(i.cpu().numpy()[keep])
            v2.append(v[keep])
        return ELLOperator.from_coo(
            np.concatenate(r2), np.concatenate(c2), np.concatenate(v2),
            self.shape[0], dtype=self.dtype, chunk=self.chunk,
            device=self.device)

    # -- LinearOperator -------------------------------------------------
    @property
    def shape(self):
        n = self.gather_map.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.bucket_values[0].dtype

    @property
    def device(self):
        return self.bucket_values[0].device

    @property
    def nnz(self) -> int:
        """Stored nonzero count."""
        return sum(int(torch.count_nonzero(v)) for v in self.bucket_values)

    @property
    def gather_slots(self) -> int:
        """Gather traffic per SpMM, in slots (padded ELL's is
        ``n * L_max``), the final unsort gather included."""
        return (sum(int(i.shape[0]) * int(i.shape[1])
                    for i in self.bucket_indices)
                + int(self.gather_map.shape[0]))

    def _unsort(self, outs, like):
        """The bucket outputs, with the empty rows' zero row appended, in
        row order."""
        zero = torch.zeros((1, like.shape[1]), dtype=like.dtype,
                           device=like.device)
        return torch.index_select(torch.cat([*outs, zero]), 0,
                                  self.gather_map)

    def matmat(self, block):
        return self._unsort(
            [_ell_chunked_apply(i, v, block, self.chunk)
             for i, v in zip(self.bucket_indices, self.bucket_values)], block)

    def matmat_ds(self, x_hi, x_lo):
        """Compensated double-single apply (``ops/sparse.py:459-475``):
        each bucket's DS partials (see :meth:`ELLOperator.matmat_ds`), both
        words put back in row order by the same gather, which moves values
        and adds no arithmetic."""
        parts = [_ell_chunked_apply_ds(i, v, x_hi, x_lo, self.chunk)
                 for i, v in zip(self.bucket_indices, self.bucket_values)]
        return (self._unsort([h for h, _ in parts], x_hi),
                self._unsort([l for _, l in parts], x_lo))

    def diagonal(self):
        d = torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)
        for r, i, v in zip(self.bucket_rows, self.bucket_indices,
                           self.bucket_values):
            d.index_add_(0, r, torch.sum(torch.where(i == r[:, None], v, 0),
                                         dim=1))
        return d

    def offdiag(self) -> "SlicedELLOperator":
        """Exact off-diagonal split: stored diagonal slots zeroed; the
        buckets stay as they are."""
        vals = [torch.where(i == r[:, None], 0, v)
                for r, i, v in zip(self.bucket_rows, self.bucket_indices,
                                   self.bucket_values)]
        return SlicedELLOperator(self.bucket_rows, self.bucket_indices, vals,
                                 self.gather_map, chunk=self.chunk)

    def to_dense(self):
        n = self.shape[0]
        dense = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for r, i, v in zip(self.bucket_rows, self.bucket_indices,
                           self.bucket_values):
            dense.index_put_((r.long()[:, None].expand(i.shape), i.long()),
                             v, accumulate=True)
        return dense


class HybridBandedOperator(LinearOperator):
    """Band plus remainder of a sparse operator (``ops/sparse.py:1231-1331``).

    The near-diagonal mass goes through a DIA-banded :class:`BSROperator`
    (kernel 1 on one GPU, kernel 2 sharded), the off-band tail through an
    :class:`ELLOperator` or :class:`SlicedELLOperator` (``remainder``, or
    None when everything is in the band). ``perm`` (int32 (n,), or None):
    the operator is ``P A Pᵀ``, ``perm[i]`` the original index at position
    ``i``; solve in that order and map vectors back with
    :meth:`unpermute`. There is no ``backend`` and no ``with_backend``:
    the band's kernel follows its device. Build with
    :func:`split_band_remainder`.
    """

    def __init__(self, band: BSROperator, remainder=None, perm=None):
        require(remainder is None or band.shape == remainder.shape,
                OperatorError, "band/remainder shapes differ")
        self.band = band
        self.remainder = remainder
        self.perm = (None if perm is None else torch.as_tensor(
            perm, device=band.device).to(torch.int32))

    @property
    def shape(self):
        return self.band.shape

    @property
    def dtype(self):
        return self.band.dtype

    @property
    def device(self):
        return self.band.device

    @property
    def band_fraction(self) -> float:
        """Share of the stored nonzeros that the band holds."""
        band_nnz = float(torch.count_nonzero(self.band.blocks))
        rem_nnz = 0.0 if self.remainder is None else float(
            self.remainder.nnz)
        total = band_nnz + rem_nnz
        return band_nnz / total if total else 1.0

    def matmat(self, block):
        out = self.band.matmat(block)
        if self.remainder is not None:
            out = out + self.remainder.matmat(block)
        return out

    def matmat_ds(self, x_hi, x_lo):
        """Compensated double-single apply: the band's and the remainder's
        DS partials combined with an exact ``two_sum``."""
        bh, bl = self.band.matmat_ds(x_hi, x_lo)
        if self.remainder is None:
            return bh, bl
        rh, rl = self.remainder.matmat_ds(x_hi, x_lo)
        h, e = dsm.two_sum(bh, rh)
        return dsm.fast_two_sum(h, bl + rl + e)

    def diagonal(self):
        d = self.band.diagonal()
        if self.remainder is not None:
            d = d + self.remainder.diagonal()
        return d

    def to_dense(self):
        dense = self.band.to_dense()
        if self.remainder is not None:
            dense = dense + self.remainder.to_dense()
        return dense

    def offdiag(self) -> "HybridBandedOperator":
        rem = None if self.remainder is None else self.remainder.offdiag()
        return HybridBandedOperator(self.band.offdiag(), rem, perm=self.perm)

    def unpermute(self, X):
        """Rows of ``X`` in the operator's (reordered, padded) order, put
        back in the original order: ``(len(perm), ...)`` rows, the padded
        rows dropped. ``X`` itself when there is no reordering."""
        if self.perm is None:
            return X
        n_orig = self.perm.shape[0]
        out = torch.zeros((n_orig, *X.shape[1:]), dtype=X.dtype,
                          device=X.device)
        return out.index_copy_(0, self.perm.long(), X[:n_orig])


def split_band_remainder(rows, cols, vals, n: int, *, block_size: int = 128,
                         bandwidth: int = 1, dtype=torch.float64,
                         chunk: int = 8, pad_diag: Optional[float] = None,
                         block_rows_multiple: int = 1,
                         reorder: Optional[str] = None,
                         remainder_format: str = "sell",
                         device=None) -> HybridBandedOperator:
    """Split COO triplets into a DIA-banded BSR part plus a sparse
    remainder (``ops/sparse.py:1334-1438``), built on the host and put on
    ``device`` (by default the GPU).

    Entries with ``|i//bs - j//bs| <= bandwidth`` land in the band (dense
    ``bs x bs`` blocks in DIA-aligned slots, ``bandwidth`` declared, so
    kernel 1 applies it); the rest goes to the remainder. ``n`` is padded
    up to a multiple of ``block_size`` (and of ``block_rows_multiple``
    block rows, for a row split over that many ranks); ``op.shape`` is
    the padded size. There is no ``backend`` argument: the port's
    :func:`generate_banded_bsr` dropped it the same way, since the kernel
    follows the device.

    ``pad_diag``: the diagonal of the padded rows. The default (None)
    puts it above the spectrum (twice the Gershgorin bound ``||A||_inf``,
    plus one), so a lowest-eigenvalue solve never returns a padding pair;
    pass 1.0 for the B of a pencil.

    ``reorder="rcm"``: a reverse Cuthill-McKee permutation first (native
    C++, scipy fallback); the operator is ``P A Pᵀ`` and
    :meth:`HybridBandedOperator.unpermute` maps eigenvectors back.

    ``remainder_format``: ``"sell"`` (default, :class:`SlicedELLOperator`)
    or ``"ell"`` (:class:`ELLOperator`).
    """
    from fortran_davidson_tpu_torch import native
    require(remainder_format in ("sell", "ell"), OperatorError,
            f"unknown remainder_format {remainder_format!r} "
            "(supported: 'sell', 'ell')")
    bs = block_size
    bw = bandwidth
    K = 2 * bw + 1
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, numpy_dtype(dtype))
    perm = None
    if reorder is not None:
        require(reorder == "rcm", OperatorError,
                f"unknown reorder {reorder!r} (supported: 'rcm')")
        perm = native.rcm_order(rows, cols, n)
        require(perm is not None, OperatorError,
                "rcm reordering needs the native component or scipy")
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        rows = inv[rows]
        cols = inv[cols]
    quantum = bs * max(int(block_rows_multiple), 1)
    n_pad = -(-n // quantum) * quantum
    nbr = n_pad // bs
    require(nbr >= K, OperatorError,
            f"need at least {K} block rows for bandwidth {bw}")

    in_band = np.abs(rows // bs - cols // bs) <= bw
    blocks = np.zeros((nbr, K, bs, bs), vals.dtype)
    rb, cb, vb = rows[in_band], cols[in_band], vals[in_band]
    slot = (cb // bs) - (rb // bs) + bw
    np.add.at(blocks, (rb // bs, slot, rb % bs, cb % bs), vb)
    del rb, cb, vb, slot
    if n_pad > n:
        if pad_diag is None:
            row_abs = np.zeros(n, np.float64)
            np.add.at(row_abs, rows, np.abs(vals).astype(np.float64))
            pad_diag = 2.0 * float(row_abs.max(initial=0.0)) + 1.0
        pad_idx = np.arange(n, n_pad)
        blocks[pad_idx // bs, bw, pad_idx % bs, pad_idx % bs] += \
            vals.dtype.type(pad_diag)
    slabs = np.ascontiguousarray(blocks.transpose(0, 2, 1, 3)).reshape(
        nbr, bs, K * bs)
    del blocks
    dev = default_device(device)
    band = BSROperator(torch.from_numpy(_dia_block_cols(nbr, bw)),
                       torch.from_numpy(slabs), bandwidth=bw, device=dev)
    del slabs

    remainder = None
    if not np.all(in_band):
        rem_cls = (SlicedELLOperator if remainder_format == "sell"
                   else ELLOperator)
        out = ~in_band
        remainder = rem_cls.from_coo(rows[out], cols[out], vals[out], n_pad,
                                     dtype=vals.dtype, chunk=chunk,
                                     device=dev)
    return HybridBandedOperator(band, remainder, perm=perm)


def sparse_diagonal_dominant_coo(n: int, nnz_per_row: int,
                                 sparsity: float = 1e-3, seed: int = 0,
                                 dtype=torch.float64):
    """The COO triplets ``(rows, cols, vals)`` (numpy, duplicates not yet
    summed) of :func:`generate_sparse_diagonal_dominant`: the JAX
    package's draws (``ops/sparse.py:866-882``) from
    ``np.random.default_rng(seed)``, in the same order. Hand them to
    ``scipy.sparse.csr_matrix`` for a CSR input."""
    rng = np.random.default_rng(seed)
    # Unordered pairs drawn uniformly: each row receives ~Poisson(
    # nnz_per_row - 1) off-diagonal entries.
    n_pairs = max(n * max(nnz_per_row - 1, 0) // 2, 0)
    dt = numpy_dtype(dtype)
    if n_pairs and n > 1:
        i = rng.integers(0, n, n_pairs)
        j = rng.integers(0, n - 1, n_pairs)
        j = np.where(j >= i, j + 1, j)  # uniform over j != i
        v = (rng.random(n_pairs).astype(dt)) * sparsity
        rows = np.concatenate([i, j, np.arange(n)])
        cols = np.concatenate([j, i, np.arange(n)])
        vals = np.concatenate([v, v, np.arange(1, n + 1, dtype=dt)])
    else:
        rows = cols = np.arange(n)
        vals = np.arange(1, n + 1, dtype=dt)
    return rows, cols, vals


def generate_sparse_diagonal_dominant(n: int, nnz_per_row: int,
                                      sparsity: float = 1e-3,
                                      seed: int = 0, dtype=torch.float64,
                                      chunk: int = 8,
                                      device=None) -> ELLOperator:
    """Random sparse symmetric diagonal-dominant matrix in ELL form
    (``ops/sparse.py:855-883``; BASELINE config 3): diagonal ``1..n``,
    ~``nnz_per_row`` off-diagonal entries per row of magnitude
    ~``sparsity``. Bit-equal to the JAX package's: the same numpy draws
    (:func:`sparse_diagonal_dominant_coo`) and the same assembly."""
    rows, cols, vals = sparse_diagonal_dominant_coo(n, nnz_per_row, sparsity,
                                                    seed, dtype)
    return ELLOperator.from_coo(rows, cols, vals, n, dtype=dtype, chunk=chunk,
                                device=device)


def generate_local_sparse(n: int, nnz_per_row: int, locality: float = 200.0,
                          sparsity: float = 1e-3, seed: int = 0,
                          dtype=torch.float64):
    """Random symmetric diagonal-dominant sparse matrix with locality
    (``ops/sparse.py:1441-1462``): off-diagonal distances |i - j| ~
    geometric(1/locality). Returns numpy COO triplets ``(rows, cols,
    vals)`` for :func:`split_band_remainder` or ``ELLOperator.from_coo``,
    bit-equal to the JAX package's (the same draws from
    ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    dt = numpy_dtype(dtype)
    n_pairs = max(n * max(nnz_per_row - 1, 0) // 2, 0)
    i = rng.integers(0, n, n_pairs)
    d = rng.geometric(min(1.0 / max(locality, 1.0), 1.0), n_pairs)
    j = np.clip(i + d * rng.choice([-1, 1], n_pairs), 0, n - 1)
    keep = j != i
    i, j = i[keep], j[keep].astype(np.int64)
    v = rng.random(i.shape[0]).astype(dt) * sparsity
    rows = np.concatenate([i, j, np.arange(n)])
    cols = np.concatenate([j, i, np.arange(n)])
    vals = np.concatenate([v, v, np.arange(1, n + 1, dtype=dt)])
    return rows, cols, vals
