"""Block-sparse operators and their generators (counterpart of
``BSROperator``, ``QuantizedBandedOperator``, ``generate_banded_bsr``,
``quantize_banded_int8`` and ``generate_banded_bsr_quantized`` in
``fortran_davidson_tpu/ops/sparse.py``).

``matmat`` and ``matmat_with_gram`` go through the wrappers of
:mod:`fortran_davidson_tpu_torch.ops.kernels`: the CUDA kernels for
tensors on a GPU, their plain versions for tensors on the CPU. There is
no ``backend`` field: the kernel follows the device.

Constructors, ``from_block_coo``, ``from_dense`` and the generators put
what they build from numpy on ``device``, by default the GPU; tensors
handed to a constructor stay on their device
(``utils.dtypes.as_device_tensor``).
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
