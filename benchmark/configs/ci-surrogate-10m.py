"""BASELINE config 4, the matrix-free CI-matrix surrogate, at 10,000,000
rows on one card: the benchmark makes the phases t (the same for every
seed, as the source's), and hands the program the diagonal 1..n, U = [cos t, sin t] and the weights
(coupling, -coupling) over ``models.generators.low_rank_plus_diag_apply``
as ``surrogate_hamiltonian`` composes them. Its apply is a few small
GEMMs and elementwise passes, no kernel of the program's own."""

import torch

from benchmark import surrogate
from benchmark.surrogate import apply_cost  # noqa: F401 (read by the harness)


def make_inputs(params: dict, seed: int, device, rank: int, world: int):
    if world != 1:
        raise ValueError("the surrogate cell runs on one card")
    return {"t": surrogate.phases(params, device)}


def build_operator(inputs: dict, params: dict, mesh, dtype):
    from fortran_davidson_tpu_torch import MatrixFreeOperator
    from fortran_davidson_tpu_torch.models.generators import \
        low_rank_plus_diag_apply
    t = inputs["t"]
    rho = float(params["coupling"])
    diag = torch.arange(1, t.shape[0] + 1, dtype=dtype, device=t.device)
    U = torch.stack([torch.cos(t), torch.sin(t)], dim=1).to(dtype)
    w = torch.tensor([rho, -rho], dtype=dtype, device=t.device)
    return MatrixFreeOperator(low_rank_plus_diag_apply, t.shape[0],
                              dtype=dtype, diag=diag, captured=(diag, U, w),
                              device=t.device)


def reference_apply(inputs: dict, params: dict, x, comm,
                    absolute: bool = False):
    return surrogate.reference_apply(inputs["t"], float(params["coupling"]),
                                     x, absolute=absolute)


def reference_eigenvalues(inputs: dict, params: dict, k: int):
    return surrogate.reference_eigenvalues(inputs["t"],
                                           float(params["coupling"]), k)
