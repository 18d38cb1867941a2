"""BASELINE config 5, the row-partitioned banded BSR matrix of
``cfg5-bsr-10m.json`` (n = 10,000,384, 30.72 GB of float64 blocks).

On one card it is handed to the program whole as
``BSROperator(block_cols, blocks, bandwidth)``, whose apply is kernel 1.
On more, each rank draws only its own block rows (and its predecessor's
boundary blocks, which its first rows mirror) and hands them to
``parallel.HaloBSROperator(..., backend=<halo_backend>, n_block_rows=)``,
whose apply is kernel 8 on the route the topology decides."""

import sys

from benchmark import banded
from benchmark.banded import apply_cost  # noqa: F401 (read by the harness)


def _rows(params: dict, rank: int, world: int) -> slice:
    per = int(params["n_block_rows"]) // world
    return slice(rank * per, (rank + 1) * per)


def make_inputs(params: dict, seed: int, device, rank: int, world: int):
    rows = _rows(params, rank, world)
    return {"blocks": banded.draw_rows(params, seed, rows, device),
            "block_cols": banded.block_cols(params, rows, device)}


def build_operator(inputs: dict, params: dict, mesh, dtype):
    if mesh is None:
        from fortran_davidson_tpu_torch import BSROperator
        return BSROperator(inputs["block_cols"], inputs["blocks"].to(dtype),
                           bandwidth=int(params["bandwidth"]))
    from fortran_davidson_tpu_torch.parallel import HaloBSROperator
    op = HaloBSROperator(inputs["block_cols"], inputs["blocks"].to(dtype),
                         int(params["bandwidth"]), mesh,
                         backend=params["halo_backend"],
                         n_block_rows=int(params["n_block_rows"]))
    if mesh.rank == 0:
        print(f"halo route: {op.route}", file=sys.stderr, flush=True)
    return op


def reference_apply(inputs: dict, params: dict, x, comm,
                    absolute: bool = False):
    halo = int(params["bandwidth"]) * int(params["block_size"])
    prev, nxt = comm.neighbour_rows(x, halo)
    return banded.reference_apply(inputs["blocks"], x, prev, nxt,
                                  absolute=absolute)


def reference_eigenvalues(inputs: dict, params: dict, k: int):
    # Rank 0 holds the matrix's first block rows.
    return banded.reference_eigenvalues(inputs["blocks"], k)
