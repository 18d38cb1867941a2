"""Solver options and results (counterpart of
``fortran_davidson_tpu/config.py``).

The options, their defaults and their validation are the JAX package's,
so the two APIs match; see ``fortran_davidson_tpu.config.DavidsonOptions``
for what each knob does. Options whose machinery is not ported yet are
accepted by the dataclass and rejected with :class:`InvalidOptionsError`,
naming the option, when a solve is resolved (:func:`resolve_options`):
they never silently fall back to something else.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from fortran_davidson_tpu_torch.core.correction import validate_method
from fortran_davidson_tpu_torch.utils.dtypes import as_torch_dtype
from fortran_davidson_tpu_torch.utils.errors import (InvalidOptionsError,
                                                     OperatorError, require)


@dataclasses.dataclass(frozen=True)
class DavidsonOptions:
    """User-facing solver knobs (the JAX package's, field for field)."""

    method: str = "DPR"
    carry_layout: str = "auto"
    fused_gram: str = "auto"
    max_iterations: int = 1000
    tolerance: float = 1e-8
    max_dim_sub: Optional[int] = None
    init_dim: Optional[int] = None
    sticky_convergence: bool = True
    gjd_inner_iters: Optional[int] = None
    gjd_inner_tol: float = 1e-12
    gjd_inner_schedule: str = "adaptive"
    gjd_preconditioner: str = "none"
    gjd_warm_start: bool = False
    n_reorth: int = 2
    relative_tolerance: bool = False
    orthonormalization: str = "cholqr2"
    expansion: str = "doubling"
    dtype: str = "float64"
    refined: bool = False
    locking: bool = False
    matmul_precision: Optional[str] = None
    cheb_degree: Union[int, str] = 0
    final_polish: int = 0
    polish_update: str = "dpr"

    def __post_init__(self):
        validate_method(self.method)
        require(self.max_iterations >= 1, InvalidOptionsError,
                "max_iterations must be >= 1")
        require(self.tolerance > 0, InvalidOptionsError, "tolerance must be > 0")
        require(self.orthonormalization in ("cholqr2", "qr"),
                InvalidOptionsError,
                f"unknown orthonormalization {self.orthonormalization!r}")
        require(self.gjd_preconditioner in ("none", "dpr", "olsen"),
                InvalidOptionsError,
                f"unknown gjd_preconditioner {self.gjd_preconditioner!r}")
        require(self.gjd_inner_schedule in ("adaptive", "fixed"),
                InvalidOptionsError,
                f"unknown gjd_inner_schedule {self.gjd_inner_schedule!r}")
        require(self.expansion in ("doubling", "lowest-k"),
                InvalidOptionsError, f"unknown expansion {self.expansion!r}")
        require(self.matmul_precision in (None, "bfloat16", "bfloat16_3x",
                                          "tensorfloat32", "float32",
                                          "highest"),
                InvalidOptionsError,
                f"unknown matmul_precision {self.matmul_precision!r}")
        require(self.cheb_degree == "auto"
                or (isinstance(self.cheb_degree, (int, np.integer))
                    and self.cheb_degree >= 0),
                InvalidOptionsError,
                "cheb_degree must be a non-negative int or 'auto'")
        require(self.fused_gram in ("auto", "on", "off"), InvalidOptionsError,
                f"unknown fused_gram {self.fused_gram!r} "
                "(supported: 'auto', 'on', 'off')")
        require(self.carry_layout in ("auto", "flat", "chunked"),
                InvalidOptionsError,
                f"unknown carry_layout {self.carry_layout!r}")
        require(self.carry_layout != "chunked" or self.refined,
                InvalidOptionsError,
                "carry_layout='chunked' requires refined=True")
        require(self.final_polish >= 0, InvalidOptionsError,
                "final_polish must be >= 0")
        require(self.final_polish == 0 or self.refined, InvalidOptionsError,
                "final_polish requires refined=True")
        require(self.polish_update in ("dpr", "olsen"), InvalidOptionsError,
                f"unknown polish_update {self.polish_update!r}")
        try:
            as_torch_dtype(self.dtype)
        except (TypeError, ValueError) as exc:
            raise InvalidOptionsError(f"unknown dtype {self.dtype!r}") from exc


def _require_ported(opts: DavidsonOptions) -> None:
    """Reject options whose machinery the torch port does not have yet."""
    not_yet = [
        (opts.method.upper() == "GJD", "method='GJD'",
         "ROADMAP slice 2 (core/krylov.py block MINRES)"),
        (opts.refined, "refined=True",
         "ROADMAP slice 3 (double-single refined path)"),
        (opts.final_polish > 0, "final_polish", "ROADMAP slice 3"),
        (opts.carry_layout == "chunked", "carry_layout='chunked'",
         "the refined path"),
        (opts.cheb_degree != 0, "cheb_degree",
         "ROADMAP item 18 (Chebyshev restarts)"),
        (opts.locking, "locking=True", "ROADMAP item 18"),
        (opts.fused_gram == "on", "fused_gram='on'",
         "ROADMAP item 17 (fused SpMM+Gram engine)"),
        (opts.matmul_precision in ("bfloat16", "bfloat16_3x",
                                   "tensorfloat32"),
         f"matmul_precision={opts.matmul_precision!r}",
         "reduced-precision matmuls (the port pins TF32 off)"),
    ]
    for bad, name, where in not_yet:
        require(not bad, InvalidOptionsError,
                f"{name} is not ported to the torch package yet; it waits "
                f"for {where}")


@dataclasses.dataclass(frozen=True)
class ResolvedConfig:
    """Options resolved against a concrete problem."""

    lowest: int
    method: str
    max_iterations: int
    tolerance: float
    max_dim: int
    init_dim: int
    m_max: int
    sticky: bool
    n_reorth: int
    relative: bool
    ortho: str
    expansion: str
    dtype: str
    generalized: bool


def merge_options(options: Optional[DavidsonOptions],
                  overrides: dict) -> DavidsonOptions:
    """Options + keyword overrides -> validated DavidsonOptions."""
    opts = options or DavidsonOptions()
    if overrides:
        opts = DavidsonOptions(**{**dataclasses.asdict(opts), **overrides})
    return opts


def subspace_cap(init_dim: int, max_dim: int, step: Optional[int] = None) -> int:
    """Largest subspace dimension the expansion schedule can reach
    (``fortran_davidson_tpu.config.subspace_cap``): the first doubling
    lattice value past ``max_dim``, or ``max_dim + step`` for lowest-k."""
    cap = init_dim
    while cap <= max_dim:
        cap = cap * 2 if step is None else cap + step
    if step is not None and init_dim <= max_dim:
        cap = max(cap, max_dim + step)
    return cap


def _carry_budget_bytes(device=None) -> int:
    """Device-memory budget for the solver's tall working set.

    ``FDT_CARRY_BUDGET_BYTES`` overrides it. On a GPU it is three quarters
    of the card's free memory when the solve starts (the operator is
    already resident then); elsewhere it is the JAX package's 12 GB, so
    CPU solves resolve the same widths as the reference.
    """
    env = os.environ.get("FDT_CARRY_BUDGET_BYTES")
    if env is not None:
        return int(float(env))
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(0.75 * free)
    return int(12e9)


def _memory_clamped_max_dim(max_dim: int, *, n_local: int, lowest: int,
                            init_dim: int, step: Optional[int],
                            itemsize: int, generalized: bool,
                            budget: int) -> int:
    """Clamp the default ``max_dim`` so the tall carries fit the budget
    (the JAX package's footprint model: V, AV (and BV) at the padded width,
    doubled during a collapse, plus ~8*lowest n-length columns)."""
    n_carries = 3 if generalized else 2
    aux = 8 * lowest

    def fits(md: int) -> bool:
        m_max = subspace_cap(init_dim, md, step)
        return itemsize * n_local * (2 * n_carries * m_max + aux) <= budget

    floor = init_dim + 4
    if max_dim <= floor or fits(max_dim):
        return max_dim
    md = max_dim - (max_dim % 4 or 4)
    while md > floor and not fits(md):
        md -= 4
    return max(md, floor)


def validate_initial_vectors(initial_vectors, n: int, init_dim: int, dtype,
                             device=None):
    """Validated (n, j) warm-start block as a tensor of ``dtype`` on
    ``device`` (None for None)."""
    if initial_vectors is None:
        return None
    X0 = torch.as_tensor(initial_vectors).to(device=device,
                                             dtype=as_torch_dtype(dtype))
    require(X0.ndim == 2 and X0.shape[0] == n, OperatorError,
            f"initial_vectors must be (n, j) with n={n}; got "
            f"{tuple(X0.shape)}")
    require(1 <= X0.shape[1] <= init_dim, OperatorError,
            f"initial_vectors: j={X0.shape[1]} must be in "
            f"[1, init_dim={init_dim}]")
    return X0


def resolve_options(opts: DavidsonOptions, lowest: int, n: int,
                    generalized: bool, device=None) -> ResolvedConfig:
    _require_ported(opts)
    require(1 <= lowest, InvalidOptionsError, "lowest must be >= 1")
    require(lowest <= n, InvalidOptionsError,
            f"lowest={lowest} exceeds matrix dimension {n}")
    init_dim = opts.init_dim if opts.init_dim is not None else 2 * lowest
    require(init_dim >= lowest, InvalidOptionsError,
            "init_dim must be >= lowest")
    require(init_dim <= n, InvalidOptionsError,
            f"init_dim={init_dim} exceeds matrix dimension {n}")
    step = None if opts.expansion == "doubling" else lowest
    dtype = as_torch_dtype(opts.dtype)
    if opts.max_dim_sub is not None:
        max_dim = opts.max_dim_sub
    else:
        # Reference default 10*lowest (``src/davidson.f90:115-119``),
        # halved until the padded schedule fits the problem ...
        max_dim = 10 * lowest
        while max_dim > init_dim and subspace_cap(init_dim, max_dim,
                                                  step) > n:
            max_dim //= 2
        # ... and clamped so the tall carries fit device memory.
        max_dim = _memory_clamped_max_dim(
            max_dim, n_local=n, lowest=lowest, init_dim=init_dim, step=step,
            itemsize=dtype.itemsize, generalized=generalized,
            budget=_carry_budget_bytes(device))
    m_max = subspace_cap(init_dim, max_dim, step)
    require(m_max <= n, InvalidOptionsError,
            f"padded subspace width {m_max} exceeds matrix dimension {n}; "
            "reduce max_dim_sub or init_dim")
    return ResolvedConfig(
        lowest=lowest,
        method=validate_method(opts.method),
        max_iterations=opts.max_iterations,
        tolerance=float(opts.tolerance),
        max_dim=max_dim,
        init_dim=init_dim,
        m_max=m_max,
        sticky=opts.sticky_convergence,
        n_reorth=int(opts.n_reorth),
        relative=bool(opts.relative_tolerance),
        ortho=str(opts.orthonormalization),
        expansion=str(opts.expansion),
        dtype=str(dtype).removeprefix("torch."),
        generalized=generalized,
    )


@dataclasses.dataclass
class DavidsonResult:
    """Solver output (the JAX package's fields).

    ``iterations`` is the 1-based index of the iteration at which
    convergence was detected (``src/davidson.f90:189-192``); it equals
    ``max_iterations`` with ``converged=False`` when the loop ran out.
    ``residual_history`` has ``max_iterations`` rows (NaN after exit) and
    ``subspace_dims`` ``max_iterations`` entries (0 after exit).
    """

    eigenvalues: torch.Tensor          # (k,)
    eigenvectors: torch.Tensor         # (n, k)
    iterations: int
    converged: bool
    converged_pairs: torch.Tensor      # (k,) bool
    residual_norms: torch.Tensor       # (k,)
    residual_history: torch.Tensor     # (max_iterations, k)
    subspace_dims: torch.Tensor        # (max_iterations,) int32
    operator_columns: int = None       # live columns A was applied to
    stalled: bool = None               # a lowest-k expansion admitted nothing
    inner_iterations: int = None       # GJD only (not ported): None
    eigenvalues_lo: torch.Tensor = None  # refined polish only: None
