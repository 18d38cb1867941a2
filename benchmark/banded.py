"""The banded block-sparse problem of BASELINE config 5, drawn on the
device, and its plain reference.

The recipe is that of ``fortran_davidson_tpu_torch.ops.sparse``'s
``_banded_tables``: block rows of ``bs`` rows, DIA-aligned slots
``k = 0 .. 2*bw`` (slot k of block row r holds block column r - bw + k),
upper coupling blocks ``(u - 0.5) * coupling`` with u uniform on [0, 1),
each lower slot the transpose of the mirrored upper block, and a
diagonal block ``D + Dᵀ`` whose diagonal is replaced by the global
indices ``1 .. n``. Out-of-range slots hold zero blocks.

What differs is where the numbers come from: a ``torch.Generator`` on
the tables' device, seeded anew for every chunk of ``CHUNK_ROWS`` block
rows from ``(seed, slot, chunk)``, so that any range of block rows, a
rank's own rows of a row-sharded matrix among them, is drawn alone in a
few large calls and gives the same bits as the whole table's rows.

This module imports nothing of the program: the reference half
(:func:`reference_apply`, :func:`reference_eigenvalues`) works from the
tables that :func:`draw_rows` makes, which the benchmark hands to the
program and to the reference alike.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# Block rows drawn by one call of the generator (4096 x 128 x 128 float64
# is 537 MB).
CHUNK_ROWS = 4096
# Block rows of the reference's dense leading block (see
# :func:`reference_eigenvalues`).
LEADING_BLOCK_ROWS = 8


def chunk_seed(seed: int, slot: int, chunk: int) -> int:
    """The generator seed of one chunk of one slot's draws: 63 bits of a
    hash of the three, so that any ``--seed`` (also beyond 64 bits) and
    any chunk give independent streams."""
    digest = hashlib.sha256(f"{seed}:{slot}:{chunk}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _chunk(seed: int, slot: int, chunk: int, bs: int, coupling: float,
           dtype, device) -> torch.Tensor:
    """One chunk of one slot's stream: the (CHUNK_ROWS, bs, bs) blocks of
    block rows ``chunk * CHUNK_ROWS ..``, ``(u - 0.5) * coupling``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, slot, chunk))
    part = torch.rand((CHUNK_ROWS, bs, bs), generator=gen, dtype=dtype,
                      device=device)
    return part.sub_(0.5).mul_(coupling)


def _chunks(lo: int, hi: int):
    """``(chunk, c0, a, b)``: the chunks that rows ``lo .. hi-1`` touch,
    each with its first row and its part ``[a, b)`` of the range."""
    for chunk in range(lo // CHUNK_ROWS, (hi - 1) // CHUNK_ROWS + 1):
        c0 = chunk * CHUNK_ROWS
        yield chunk, c0, max(lo, c0), min(hi, c0 + CHUNK_ROWS)


def draw_rows(params: dict, seed: int, rows: slice, device) -> torch.Tensor:
    """Block rows ``rows`` of the matrix of ``params`` (``n_block_rows``,
    ``block_size``, ``bandwidth``, ``coupling``, ``dtype``) from ``seed``:
    the (b - a, bs, K*bs) blocks of the program's BSR layout, on
    ``device``, drawn a chunk at a time. The lower slots of the first
    rows mirror upper blocks of the rows before ``rows``, which are drawn
    for that (a rank draws its predecessor's boundary blocks)."""
    nbr, bs = int(params["n_block_rows"]), int(params["block_size"])
    bw, coupling = int(params["bandwidth"]), float(params["coupling"])
    dtype = getattr(torch, params["dtype"])
    a, b, _ = rows.indices(nbr)
    K = 2 * bw + 1
    blocks = torch.empty((b - a, bs, K * bs), dtype=dtype, device=device)

    def slot(r0: int, r1: int, k: int) -> torch.Tensor:
        return blocks[r0 - a:r1 - a, :, k * bs:(k + 1) * bs]

    for d in range(1, bw + 1):
        # Upper blocks (r, r + d) exist for r < nbr - d. Row r's upper
        # slot d holds block r of this stream; its lower slot d holds
        # block r - d, transposed. Rows without one hold zeros.
        lo, hi = max(a - d, 0), min(b, nbr - d)
        if hi < b:
            slot(max(hi, a), b, bw + d).zero_()
        if a < d:
            slot(a, min(d, b), bw - d).zero_()
        if hi <= lo:
            continue
        for chunk, c0, u0, u1 in _chunks(lo, hi):
            upper = _chunk(seed, d, chunk, bs, coupling, dtype, device)
            if u1 > max(u0, a):
                r0 = max(u0, a)
                slot(r0, u1, bw + d).copy_(upper[r0 - c0:u1 - c0])
            r0, r1 = max(u0 + d, a), min(u1 + d, b)
            if r1 > r0:
                slot(r0, r1, bw - d).copy_(
                    upper[r0 - d - c0:r1 - d - c0].transpose(1, 2))
            del upper
    for chunk, c0, r0, r1 in _chunks(a, b):
        diag = _chunk(seed, 0, chunk, bs, coupling, dtype, device)[
            r0 - c0:r1 - c0]
        diag = diag + diag.transpose(1, 2)
        values = torch.arange(r0 * bs, r1 * bs, dtype=dtype, device=device)
        diag.diagonal(dim1=1, dim2=2).copy_((values + 1).reshape(r1 - r0, bs))
        slot(r0, r1, bw).copy_(diag)
        del diag
    return blocks


def block_cols(params: dict, rows: slice, device) -> torch.Tensor:
    """The (b - a, K) int32 column table of DIA-aligned storage: virtual
    column r - bw + k clipped into range (its blocks are zero there)."""
    nbr, bw = int(params["n_block_rows"]), int(params["bandwidth"])
    a, b, _ = rows.indices(nbr)
    offs = (torch.arange(a, b, device=device)[:, None] - bw
            + torch.arange(2 * bw + 1, device=device))
    return offs.clamp(0, nbr - 1).to(torch.int32)


def reference_apply(blocks: torch.Tensor, x: torch.Tensor,
                    prev: torch.Tensor = None, nxt: torch.Tensor = None,
                    chunk_rows: int = 2048,
                    absolute: bool = False) -> torch.Tensor:
    """``A @ x`` for the block rows ``blocks`` holds (plain PyTorch, one
    batched product a slot, in ``x``'s type): ``x`` the rows of those
    block rows, ``prev`` / ``nxt`` the ``bw * bs`` rows before and after
    them (zero where ``None``, as at the matrix's two ends). With
    ``absolute``, ``|A| @ x``: every entry of A taken by its magnitude."""
    nbr, bs, kbs = blocks.shape
    K = kbs // bs
    bw = (K - 1) // 2
    m = x.shape[1]
    halo = torch.zeros((bw * bs, m), dtype=x.dtype, device=x.device)
    x_ext = torch.cat([halo if prev is None else prev, x,
                       halo if nxt is None else nxt]).reshape(
                           nbr + 2 * bw, bs, m)
    y = torch.empty((nbr, bs, m), dtype=x.dtype, device=x.device)
    for r0 in range(0, nbr, chunk_rows):
        r1 = min(nbr, r0 + chunk_rows)
        acc = torch.zeros((r1 - r0, bs, m), dtype=x.dtype, device=x.device)
        for k in range(K):
            a = blocks[r0:r1, :, k * bs:(k + 1) * bs].to(x.dtype)
            acc += torch.bmm(torch.abs(a) if absolute else a,
                             x_ext[r0 + k:r1 + k])
        y[r0:r1] = acc
    return y.reshape(nbr * bs, m)


def reference_eigenvalues(blocks: torch.Tensor, k: int) -> np.ndarray:
    """The lowest ``k`` eigenvalues, from the dense leading principal
    block of ``LEADING_BLOCK_ROWS`` block rows (numpy's ``eigvalsh`` in
    float64). ``blocks`` holds the matrix's first block rows.

    Exact to rounding for this recipe: its diagonal is 1..n and every
    coupling entry lies within ``coupling / 2`` of zero, so an
    eigenvector of one of the lowest eigenvalues falls off by about
    ``sqrt(bs) * coupling / (2 * gap)`` a block row, gap being the
    hundreds by which the diagonal of a further block row exceeds it:
    by block row 3 its entries are near 1e-15, and the leading block
    leaves out entries some 1e-60 smaller than the eigenvalue."""
    nbr, bs, kbs = blocks.shape
    K = kbs // bs
    bw = (K - 1) // 2
    lead = min(LEADING_BLOCK_ROWS, nbr)
    head = blocks[:lead].to("cpu", torch.float64).numpy()
    dense = np.zeros((lead * bs, lead * bs))
    for r in range(lead):
        for s in range(K):
            c = r - bw + s
            if 0 <= c < lead:
                dense[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = \
                    head[r, :, s * bs:(s + 1) * bs]
    return np.linalg.eigvalsh(dense)[:k]


def apply_cost(params: dict, m: int, world: int) -> tuple:
    """``(bytes, flops)`` of one apply to ``m`` columns on one rank: the
    rank's stored blocks read once, its x rows and the halo rows it
    reads from its neighbours read once, its y rows written once; two
    operations per multiply-add of its nonzero blocks (the out-of-range
    slots at the matrix's two ends hold zeros, and need none)."""
    nbr, bs = int(params["n_block_rows"]), int(params["block_size"])
    bw = int(params["bandwidth"])
    item = getattr(torch, params["dtype"]).itemsize
    K = 2 * bw + 1
    nbr_l = nbr // world
    n_l = nbr_l * bs
    halo_rows = 2 * bw * bs if world > 1 else 0
    moved = (nbr_l * bs * K * bs * item + (n_l + halo_rows) * m * item
             + n_l * m * item)
    nonzero = nbr * K - bw * (bw + 1)          # the whole matrix's
    flops = 2 * (nonzero / world) * bs * bs * m
    return moved, flops
