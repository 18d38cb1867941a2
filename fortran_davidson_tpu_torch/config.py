"""Solver options and results (counterpart of
``fortran_davidson_tpu/config.py``).

The options, their defaults and their validation are the JAX package's,
so the two APIs match; see ``fortran_davidson_tpu.config.DavidsonOptions``
for what each knob does. Every option runs on the row-sharded solve
too (``orthonormalization="qr"`` as a TSQR, ``core.orthogonal.tsqr``).

``carry_layout``: the port stores the tall carries flat, always.
``"chunked"`` (and ``"auto"``, which picks it for refined solves in the
JAX package) resolves to ``"flat"``: the JAX package's chunked layout
exists to spare the TPU a relayout copy per iteration, and its
trajectories are bit for bit the flat layout's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from fortran_davidson_tpu_torch.core.correction import validate_method
from fortran_davidson_tpu_torch.utils.ds import gram_chunk
from fortran_davidson_tpu_torch.utils.dtypes import (as_device_tensor,
                                                     as_torch_dtype)
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
        require(self.carry_layout != "chunked"
                or self.orthonormalization == "cholqr2",
                InvalidOptionsError,
                "carry_layout='chunked' requires "
                "orthonormalization='cholqr2'")
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
    # Incremental-H engine (fused SpMM+Gram); resolved by the solver entry
    # point, where the operator is known (``solver.py``).
    fused_gram: bool = False
    gjd_inner_iters: int = 128
    gjd_inner_tol: float = 1e-12
    gjd_schedule: str = "adaptive"
    gjd_precond: str = "none"
    gjd_warm: bool = False
    refined: bool = False
    final_polish: int = 0
    polish_update: str = "dpr"
    locking: bool = False
    # ``None`` or one of DavidsonOptions' names; the solver's precision
    # context (``utils.dtypes.full_precision_matmuls``) maps it.
    matmul_precision: Optional[str] = None
    cheb_degree: int = 0
    cheb_auto: bool = False


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
    already resident then), counting as free what PyTorch's caching
    allocator holds unused, so that the width does not depend on what an
    earlier solve left cached; elsewhere it is the JAX package's 12 GB, so
    CPU solves resolve the same widths as the reference.
    """
    env = os.environ.get("FDT_CARRY_BUDGET_BYTES")
    if env is not None:
        return int(float(env))
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        free += (torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
        return int(0.75 * free)
    return int(12e9)


def _carry_fits(max_dim: int, *, n_local: int, lowest: int, init_dim: int,
                step: Optional[int], itemsize: int, generalized: bool,
                budget: int, refined_chunk: Optional[int] = None) -> bool:
    """Whether the tall carries of width ``max_dim`` fit the budget (the
    footprint model of :func:`_memory_clamped_max_dim`)."""
    n_carries = 3 if generalized else 2
    aux = 8 * lowest * (1 if refined_chunk is None else 2)
    m_max = subspace_cap(init_dim, max_dim, step)
    need = itemsize * n_local * (2 * n_carries * m_max + aux)
    if refined_chunk is not None:
        need += 4 * itemsize * (n_local // refined_chunk) * m_max ** 2
    return need <= budget


def _memory_clamped_max_dim(max_dim: int, **model) -> int:
    """Clamp the default ``max_dim`` so the tall carries fit the budget
    (the JAX package's footprint model: V, AV (and BV) at the padded width,
    doubled during a collapse, plus ~8*lowest n-length columns).

    ``refined_chunk`` (a refined solve on a GPU: the compensated Gram's
    row chunk, ``utils.ds.gram_chunk``) adds what the refined path holds
    besides: ~8*lowest more n-length columns (its residuals, polish and
    warm-start blocks) and the compensated Gram's partials and their
    two_sum fold, four (n/chunk, m_max, m_max) blocks. The chunk halves
    until it divides n, so at n = 10,000,000 (= 2^7 5^7) it is 128 and the
    partials of an m_max = 220 basis take 15 GB each (PERF.md §6).
    """
    def fits(md: int) -> bool:
        return _carry_fits(md, **model)

    floor = model["init_dim"] + 4
    if max_dim <= floor or fits(max_dim):
        return max_dim
    md = max_dim - (max_dim % 4 or 4)
    while md > floor and not fits(md):
        md -= 4
    return max(md, floor)


def validate_initial_vectors(initial_vectors, n: int, init_dim: int, dtype,
                             device=None):
    """Validated (n, j) warm-start block as a tensor of ``dtype`` on
    ``device`` (None for None; ``device=None`` follows a tensor's device
    and sends anything else to the GPU)."""
    if initial_vectors is None:
        return None
    X0 = as_device_tensor(initial_vectors, device).to(as_torch_dtype(dtype))
    require(X0.ndim == 2 and X0.shape[0] == n, OperatorError,
            f"initial_vectors must be (n, j) with n={n}; got "
            f"{tuple(X0.shape)}")
    require(1 <= X0.shape[1] <= init_dim, OperatorError,
            f"initial_vectors: j={X0.shape[1]} must be in "
            f"[1, init_dim={init_dim}]")
    return X0


def _footprint_model(opts: DavidsonOptions, lowest: int, n: int,
                     init_dim: int, step: Optional[int], generalized: bool,
                     device, sharded: bool, shard_row_divisor: int) -> dict:
    """The arguments of :func:`_carry_fits` for a problem on ``device``
    (the rows one rank holds, for a sharded solve)."""
    n_local = n // max(shard_row_divisor if sharded else 1, 1)
    on_gpu = torch.device("cpu" if device is None else device).type == "cuda"
    return dict(n_local=n_local, lowest=lowest, init_dim=init_dim,
                step=step, itemsize=as_torch_dtype(opts.dtype).itemsize,
                generalized=generalized, budget=_carry_budget_bytes(device),
                refined_chunk=(gram_chunk(n_local) if opts.refined and on_gpu
                               else None))


def width_fits(cfg: "ResolvedConfig", opts: DavidsonOptions, n: int,
               device=None, sharded: bool = False,
               shard_row_divisor: int = 1) -> bool:
    """Whether ``cfg``'s width fits today's device-memory budget (the
    default width's clamp): a checkpoint's width, adopted on resume when
    ``max_dim_sub`` was left to the default."""
    step = None if cfg.expansion == "doubling" else cfg.lowest
    return _carry_fits(cfg.max_dim, **_footprint_model(
        opts, cfg.lowest, n, cfg.init_dim, step, cfg.generalized, device,
        sharded, shard_row_divisor))


def resolve_options(opts: DavidsonOptions, lowest: int, n: int,
                    generalized: bool, device=None, sharded: bool = False,
                    shard_row_divisor: int = 1) -> ResolvedConfig:
    """Options resolved against a problem of order ``n``. A row-sharded
    solve (``sharded``, over ``shard_row_divisor`` ranks) sizes the
    memory clamp by the rows one rank holds, as the JAX package does."""
    cheb_auto = opts.cheb_degree == "auto"
    require(not ((cheb_auto or opts.cheb_degree >= 2) and generalized),
            InvalidOptionsError,
            "Chebyshev-filtered restarts (cheb_degree >= 2 or 'auto') "
            "require a standard problem: the filter is a polynomial in "
            "A alone")
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
            max_dim, **_footprint_model(opts, lowest, n, init_dim, step,
                                        generalized, device, sharded,
                                        shard_row_divisor))
    m_max = subspace_cap(init_dim, max_dim, step)
    require(m_max <= n, InvalidOptionsError,
            f"padded subspace width {m_max} exceeds matrix dimension {n}; "
            "reduce max_dim_sub or init_dim")
    inner = opts.gjd_inner_iters
    if inner is None:
        inner = min(n, 128)
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
        gjd_inner_iters=int(inner),
        gjd_inner_tol=float(opts.gjd_inner_tol),
        gjd_schedule=str(opts.gjd_inner_schedule),
        gjd_precond=str(opts.gjd_preconditioner),
        gjd_warm=bool(opts.gjd_warm_start),
        refined=bool(opts.refined),
        final_polish=int(opts.final_polish),
        polish_update=str(opts.polish_update),
        locking=bool(opts.locking),
        # A float32 solve pins full float32 matmuls unless asked otherwise
        # (``fortran_davidson_tpu/config.py:550-554``).
        matmul_precision=(opts.matmul_precision
                          if opts.matmul_precision is not None
                          else ("float32" if dtype == torch.float32
                                else None)),
        cheb_degree=0 if cheb_auto else int(opts.cheb_degree),
        cheb_auto=cheb_auto,
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
    # The loop stopped at a fixed point: a lowest-k expansion admitted no
    # column, or (refined) the residual plateau or the trial polish's
    # certification ended it.
    stalled: bool = None
    inner_iterations: int = None       # GJD: MINRES steps over the solve
    # final_polish: low words of the polished eigenvalues;
    # float64(eigenvalues) + float64(eigenvalues_lo) is what the residual
    # check used.
    eigenvalues_lo: torch.Tensor = None
    # final_polish: low words of the polished eigenvectors (the JAX
    # package's result drops them); eigenvectors + eigenvectors_lo is the
    # vector the residual check used. At n = 10M the float32 words alone
    # floor a dense-coupled problem's float64 residual near 1e-8.
    eigenvectors_lo: torch.Tensor = None

    def block_until_ready(self) -> "DavidsonResult":
        """Wait for the device that holds the result
        (``fortran_davidson_tpu.config.DavidsonResult.block_until_ready``);
        nothing to wait for on the CPU."""
        if self.eigenvalues.device.type == "cuda":
            torch.cuda.synchronize(self.eigenvalues.device)
        return self
