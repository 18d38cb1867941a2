"""The block-Davidson outer loop as an eager loop over device tensors
(counterpart of ``fortran_davidson_tpu/core/loop.py``, on flat carries:
DPR, Olsen and GJD corrections, the refined double-single path with its
final polish, the incremental-H engine of ``fused_gram``, locking,
Chebyshev-filtered restarts, and the chunked stepper that checkpoints
and per-chunk callbacks run on).

The design keeps the JAX package's invariants:

- **Padded storage.** The basis lives in a buffer ``V in R^{n x m_max}``
  whose inactive columns are exactly zero; ``col_ok`` marks the live
  columns, which need not be a prefix. ``m_max`` is the widest the
  schedule can reach (``config.subspace_cap``), so grow and collapse move
  data inside fixed buffers, updated in place.
- **Cached operator applications.** A@V (and B@V) are cached; each
  expansion applies the operator to the new orthonormal block only, and a
  collapse updates the caches with a triangular solve.
- **Span parity.** Every transformation preserves the exact-arithmetic
  span of the reference schedule (``src/davidson.f90:138-229``), so Ritz
  values and iteration counts match the reference within roundoff.

What differs from the JAX loop is what an eager loop makes cheap: the
host knows an upper bound ``m_hi`` of the active width (exact for the
doubling schedule), so the projections, Ritz products and operator
applications run on the leading ``m_hi`` columns, not on all ``m_max``.
Columns past the active ones are zero, so this changes no value in exact
arithmetic. The loop reads the device once per iteration: the
``all_conv`` flag, the exact active width and the previous expansion's
stall flag, in one transfer; this replaces the ``lax.cond``s of
``core/loop.py:695-697``.

The incremental-H engine (``cfg.fused_gram``, lowest-k standard solves)
keeps the projected matrix H = VᵀAV in the state instead of recomputing it
each iteration: seeded from the initial basis, extended at each expansion
by the operator's fused ``G = Vᵀ(AQ)`` (``matmat_with_gram``), re-seeded
at a collapse (``core/loop.py:119-127,343-344,589-604,682-688``). The
gram operand is the basis up to the new block's end, ``V[:, :c0+kk]``,
not all ``m_max`` columns: the columns past it are zero in V and in H.

The refined path (``cfg.refined``) measures the projection compensated
and refines the k wanted Ritz vectors against it, takes true residuals
and Rayleigh-refined eigenvalues from ``refine.refined_pairs`` (one
off-diagonal apply of the k columns), gates admitted columns by their
Rayleigh quotient, and exits at its attainable
floor: after ``_PLATEAU_ITERS`` iterations without a 1% gain of the worst
unconverged residual, or, with ``final_polish``, as soon as a trial
polish at the first short plateau certifies the pairs. The JAX package
asks for that certification in a ``lax.cond``; here it is a Python branch
on the iteration's one host read. ``operator_columns`` counts the
correction blocks the loop applied A to; the JAX package's refined
standard path also computes (and charges) the block of a collapse or
converged iteration, which it discards, so its count there is higher.

The tall arrays may be one rank's rows of a row-sharded solve
(``parallel.sharded``): every reduction over rows goes through the
``rows`` hook (``core/rows.py``), so every rank sees the same small
matrices, flags and counts and takes the same branches.

**The explicit state.** Everything the loop carries from one iteration
to the next is in the state dict of :func:`init_state`, so a state can
stop at any iteration boundary (``st["chunk_end"]``) and go on later,
from memory or from a checkpoint (``checkpoint.py``), with the same
iterates, the same iteration count and no operator applied again.
:func:`run_chunked` is that driver; the one-shot solve is its single
chunk. The port compiles nothing, so :func:`get_stepper` hands out plain
functions and the JAX package's compiled-program caches have nothing to
hold (:func:`set_compiled_cache_capacity`, :func:`clear_compiled_caches`).

**Spans.** Under a recording profiler (``utils.observability.
profile_trace``, or any ``torch.profiler.profile``) the loop marks its
phases, so a trace read in Perfetto shows each kernel and each host wait
under the phase that issued it (the innermost span open at its launch):
``fdt.init`` (the stepper's :func:`init_state`, and the diagonals
:func:`run_state` takes before its first iteration), ``fdt.rayleigh_ritz``
(the masks, H and the masked eigh), ``fdt.residual`` (X, AXW, R, the
norms and the convergence test), ``fdt.host_read`` (the iteration's one
read and the history it records; :func:`settle`'s and
:func:`pack_result`'s reads), ``fdt.correction`` (DPR, Olsen or GJD),
``fdt.orthonormalize`` (the block's CGS2 + CholQR2 or SVQB; a collapse's
thin QR), ``fdt.basis_update`` (Q, AQ, BQ and ``col_ok`` written into the
carried buffers; a collapse's rewrite of them), ``fdt.apply`` (every
operator apply, nested in the phase that asked for it, or, for the new
block's AQ, directly in the solve) and ``fdt.polish`` (the refined path's
trial and final polish). The solver's entry points open ``fdt.solve``
around the whole call. Off the profiler a span is one boolean check.
"""

from __future__ import annotations

from typing import Optional

import torch

from fortran_davidson_tpu_torch.config import DavidsonResult, ResolvedConfig
from fortran_davidson_tpu_torch.core import chebyshev
from fortran_davidson_tpu_torch.core import correction as corr_mod
from fortran_davidson_tpu_torch.core import orthogonal, refine, subspace
from fortran_davidson_tpu_torch.core.rows import LOCAL, Rows
from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.ops.operators import LinearOperator
from fortran_davidson_tpu_torch.utils import debugging
from fortran_davidson_tpu_torch.utils.ds import DS, two_sum
from fortran_davidson_tpu_torch.utils.dtypes import \
    full_precision_matmuls as _precision_ctx
from fortran_davidson_tpu_torch.utils.observability import annotate

# Refined-path plateau exit: consecutive iterations without a 1% gain of
# the worst unconverged wanted residual before the loop concludes it has
# hit the float32-basis floor.
_PLATEAU_ITERS = 10

# Trial-polish poll point: when the no-progress counter first reaches
# this value (and ``final_polish`` is on), the polish is asked whether the
# k pairs already certify at the user's tolerance.
_POLISH_POLL_AT = 4


def _apply(op: LinearOperator, X, dt):
    with annotate("fdt.apply"):
        return op.matmat(X).to(dt)


def _filtered(cfg: ResolvedConfig) -> bool:
    """Collapses restart through the Chebyshev filter."""
    return cfg.cheb_degree >= 2 or cfg.cheb_auto


def _check_fused(cfg: ResolvedConfig, gen: bool) -> None:
    if cfg.fused_gram and (gen or cfg.refined
                           or cfg.expansion != "lowest-k"):
        raise ValueError(
            "fused_gram requires a standard, non-refined, lowest-k "
            "configuration (the solver entry point gates this)")


def _roll_add(T, Q, m: int):
    """``T += roll(Q padded to T's width, m)`` on the leading columns: column
    j of Q lands on column (j + m) mod m_max (``core/loop.py:613-616``)."""
    m_max = T.shape[1]
    b = Q.shape[1]
    if m + b <= m_max:
        T[:, m:m + b] += Q
    else:
        cols = (torch.arange(b, device=T.device) + m) % m_max
        T.index_add_(1, cols, Q)


def init_state(cfg: ResolvedConfig, A: LinearOperator,
               B: Optional[LinearOperator], X0=None,
               rows: Rows = LOCAL) -> dict:
    """Initial loop state (a dict of tensors and host scalars).

    ``X0``: optional (n, j) warm-start vectors, j <= init_dim (the local
    rows of a sharded solve).
    """
    k = cfg.lowest
    m_max = cfg.m_max
    init_dim = cfg.init_dim
    dt = getattr(torch, cfg.dtype)
    dev = A.device
    _check_fused(cfg, B is not None)
    diag_a = A.diagonal().to(dt)
    n = diag_a.shape[0]

    if X0 is None:
        V = subspace.initial_subspace(diag_a, init_dim, m_max, rows)
        col_ok = orthogonal.col_mask(init_dim, m_max, dt, dev)
        m = init_dim
    else:
        V, col_ok, m = subspace.initial_subspace_with_guess(
            diag_a, X0, init_dim, m_max, rows, precise=cfg.refined)
        if cfg.expansion == "doubling":
            # Doubling doubles m regardless of the live count
            # (``src/davidson.f90:199``) and its roll-add placement needs m
            # on the init_dim lattice: snap it. Dropped guess columns stay
            # zero columns inside the active window (``core/loop.py:107-118``).
            m = init_dim
    AV = torch.zeros_like(V)
    AV[:, :init_dim] = _apply(A, V[:, :init_dim], dt)
    if cfg.fused_gram:
        # The carried projection's seed, one full Gram
        # (``core/loop.py:119-127``). The caller holds the precision
        # context, so the product does not run in TF32.
        H = torch.zeros((m_max, m_max), dtype=dt, device=dev)
        H[:init_dim, :init_dim] = subspace.project(V[:, :init_dim],
                                                   AV[:, :init_dim], rows)
    state = dict(
        V=V, AV=AV, m=m, m_hi=init_dim, col_ok=col_ok, it=0,
        chunk_end=cfg.max_iterations,
        has_conv=torch.zeros((k,), dtype=torch.bool, device=dev),
        all_conv=False,
        evals=torch.zeros((k,), dtype=dt, device=dev),
        evecs=torch.zeros((n, k), dtype=dt, device=dev),
        errors=torch.full((k,), float("inf"), dtype=dt, device=dev),
        history=torch.full((cfg.max_iterations, k), float("nan"), dtype=dt,
                           device=dev),
        dims=torch.zeros((cfg.max_iterations,), dtype=torch.int32, device=dev),
        op_cols=torch.zeros((), dtype=torch.int64, device=dev) + m,
        stalled=False,
    )
    if B is not None:
        BV = torch.zeros_like(V)
        BV[:, :init_dim] = _apply(B, V[:, :init_dim], dt)
        state["BV"] = BV
    if cfg.fused_gram:
        state["H"] = H
    if _filtered(cfg):
        # The filter's damping interval ends at an upper bound of the
        # spectrum: 12 single-column applies, once per solve
        # (``core/loop.py:122-123``), not charged to ``operator_columns``.
        state["spec_ub"] = chebyshev.lanczos_upper_bound(
            lambda T: _apply(A, T, dt), A.shape[0], dt, device=dev,
            rows=rows, n_local=n)
    if cfg.method == "GJD":
        # Cumulative inner MINRES steps over the solve, and (warm start)
        # the previous raw correction block; zero is a cold start.
        state["inner_ops"] = torch.zeros((), dtype=torch.int64, device=dev)
        if cfg.gjd_warm:
            kk0 = k if cfg.expansion == "lowest-k" else m_max
            state["corr_prev"] = torch.zeros((n, kk0), dtype=dt, device=dev)
    if cfg.refined:
        # Residual-plateau tracking (see the module docstring).
        state["best_err"] = torch.full((), float("inf"), dtype=dt,
                                       device=dev)
        state["no_prog"] = 0
    return state


def _refined_ritz(Vw, AVw, BVw, mask, m_max: int, k: int, rows: Rows):
    """Rayleigh-Ritz of the refined path (``core/loop.py:295-335``): the
    projection(s) measured compensated, the masked (generalized) eigh of
    their roundings, and the k wanted eigenvectors refined first-order
    against the DS residual of the same penalized matrices the eigh
    diagonalized (penalties added with exact two_sum)."""
    H_ds = subspace.project_ds(Vw, AVw, rows)
    H = H_ds.hi + H_ds.lo
    pen = torch.diag(subspace._pad_penalties(H, mask, m_max))
    ph, pl = two_sum(H_ds.hi, pen)
    if BVw is None:
        lam, W = orthogonal.eigh(H + pen)
        W[:, :k] = refine.refine_ritz(DS(ph, pl + H_ds.lo), lam, W, k)
        return lam, W
    S_ds = subspace.project_ds(Vw, BVw, rows)
    lam, W = subspace.masked_generalized_eigh(H, S_ds.hi + S_ds.lo, mask,
                                              m_max)
    sh, sl = two_sum(S_ds.hi, torch.diag(1.0 - mask))
    W[:, :k] = refine.refine_ritz_pencil(DS(ph, pl + H_ds.lo),
                                         DS(sh, sl + S_ds.lo), lam, W, k)
    return lam, W


def _rq_gate(Q, AQ, alive_q, lam, pair_mask, k: int, rows: Rows):
    """The refined path's spectral noise gate (``core/loop.py:553-579``):
    a whitened junk direction has a Rayleigh quotient at the mean-diagonal
    scale, far above the wanted pairs', and one admitted junk column
    inflates ||H|| until the eigh can no longer resolve them. Columns with
    |rq| > 250·max(max|λ_wanted|, 1) are dropped; survivors are compacted
    to a prefix."""
    dt = Q.dtype
    rq = rows.sum(torch.sum(Q * AQ, dim=0))
    wmax = torch.max(torch.abs(lam[:k]) * pair_mask[:k])
    cap = 250.0 * torch.clamp(wmax, min=1.0)
    keep = alive_q * (torch.abs(rq) <= cap).to(dt)
    order = torch.argsort((keep <= 0.5).to(torch.int8), stable=True)
    return ((Q * keep[None, :])[:, order], (AQ * keep[None, :])[:, order],
            keep[order])


def _certify(cfg: ResolvedConfig, A_off, B_off, diag_a, diag_b, evals, X,
             rows: Rows):
    """The trial polish: does a final polish of these pairs certify at
    the user's tolerance? (One host read.)"""
    with annotate("fdt.polish"):
        pol = refine.polish(A_off, diag_a, evals, X,
                            iterations=cfg.final_polish, B_off=B_off,
                            diag_b=diag_b, update=cfg.polish_update,
                            rows=rows)
        return bool(torch.all(_converged(cfg, pol.errors, pol.evals)))


def _converged(cfg: ResolvedConfig, errors, evals):
    if cfg.relative:
        return errors < cfg.tolerance * torch.clamp(torch.abs(evals), min=1.0)
    return errors < cfg.tolerance


def _gjd(cfg: ResolvedConfig, A, B, dt, lam, X, R, pmk, diag_a, diag_b,
         warm_t, rows: Rows):
    """The GJD correction with the loop's inner schedule
    (``core/loop.py:466-507``). Returns ``(corr, iters)``, ``iters`` the
    (b,) MINRES steps each column ran."""
    precond = cfg.gjd_precond in ("dpr", "olsen")
    if cfg.gjd_schedule == "adaptive":
        # Outer-target-linked inner forcing (inexact JD): stop at 1% of
        # the outer tolerance absolute or 1e-2 relative, whichever is
        # looser, never tighter than gjd_inner_tol.
        tol_eff = (cfg.tolerance * torch.clamp(torch.abs(lam), min=1.0)
                   if cfg.relative else cfg.tolerance)
        rnorm = rows.norms(R)
        inner_tol = torch.clamp(
            0.01 * tol_eff / torch.clamp(rnorm, min=1e-30),
            min=cfg.gjd_inner_tol, max=1e-2)
    else:
        inner_tol = cfg.gjd_inner_tol
    return corr_mod.gjd_correction(
        lambda T: _apply(A, T, dt),
        None if B is None else (lambda T: _apply(B, T, dt)),
        lam, X, R, pmk, cfg.gjd_inner_iters, inner_tol,
        diag_a=diag_a if precond else None,
        diag_b=diag_b if (precond and B is not None) else None,
        olsen_start=cfg.gjd_precond == "olsen",
        scale=cfg.gjd_precond == "dpr",
        return_inner_iters=True, warm_t=warm_t, rows=rows)


def run_state(cfg: ResolvedConfig, A: LinearOperator,
              B: Optional[LinearOperator], st: dict,
              rows: Rows = LOCAL, A_off: Optional[LinearOperator] = None,
              B_off: Optional[LinearOperator] = None) -> dict:
    """Iterate until convergence, a stall, ``max_iterations`` or
    ``st["chunk_end"]``, whichever comes first.

    ``st`` is updated in place and returned. ``st["m"]`` and
    ``st["stalled"]`` may be 0-d device tensors between iterations; they
    are read at the next iteration's synchronisation (or by
    :func:`settle`). ``A_off``/``B_off``: the off-diagonal splits the
    refined path needs (``A.offdiag()``). Under
    ``utils.debugging.nan_trap`` a NaN raises ``FloatingPointError``.
    """
    k = cfg.lowest
    m_max = cfg.m_max
    init_dim = cfg.init_dim
    dt = getattr(torch, cfg.dtype)
    dev = A.device
    gen = B is not None
    _check_fused(cfg, gen)
    fused = cfg.fused_gram
    precise = cfg.refined
    if precise and A_off is None:
        raise ValueError("cfg.refined requires A_off (= A.offdiag())")
    lowest_k = cfg.expansion == "lowest-k"
    with annotate("fdt.init"):
        diag_a = A.diagonal().to(dt)
        n = diag_a.shape[0]
        diag_b = (B.diagonal().to(dt) if gen
                  else torch.ones((n,), dtype=dt, device=dev))
        ar = torch.arange(m_max, device=dev)
    V, AV = st["V"], st["AV"]
    BV = st["BV"] if gen else None
    trap = debugging.nans_trapped()
    end = min(st["chunk_end"], cfg.max_iterations)

    while st["it"] < end and not st["all_conv"]:
        w = st["m_hi"]
        with annotate("fdt.rayleigh_ritz"):
            # Active columns: prefix up to m minus the columns dropped by
            # the rank-revealing orthonormalization. Ritz pairs live in
            # pair index space, a prefix of width sum(mask).
            mask = (ar[:w] < st["m"]).to(dt) * st["col_ok"][:w]
            pair_mask = (ar[:w] < torch.sum(mask)).to(dt)

            # Rayleigh-Ritz on the leading w columns (masked, penalized
            # eigh). The fused engine reads H from the state: CGS2 never
            # touches admitted columns, so their entries stay valid.
            Vw, AVw = V[:, :w], AV[:, :w]
            try:
                if precise:
                    lam, W = _refined_ritz(Vw, AVw,
                                           BV[:, :w] if gen else None,
                                           mask, m_max, k, rows)
                else:
                    H = (st["H"][:w, :w] if fused
                         else subspace.project(Vw, AVw, rows))
                    S = subspace.project(Vw, BV[:, :w], rows) if gen else None
                    lam, W = subspace.ritz_decomposition(H, S, mask, m_max)
            except torch.linalg.LinAlgError as exc:
                if trap:
                    # A solver library may refuse a NaN matrix outright.
                    raise FloatingPointError(
                        f"NaN in the projected matrix at iteration "
                        f"{st['it'] + 1}") from exc
                raise

        with annotate("fdt.residual"):
            # Ritz vectors and block residuals from the caches. Lowest-k
            # only ever corrects the k wanted pairs; doubling corrects
            # every pair.
            kk = k if lowest_k else w
            Wk = W[:, :kk]
            pmk = pair_mask[:kk]
            X = (Vw @ Wk) * pmk[None, :]
            AXW = AVw @ Wk
            BXW = BV[:, :w] @ Wk if gen else X
            R = (AXW - BXW * lam[:kk][None, :]) * pmk[None, :]
            del AXW, BXW
            if precise:
                # True residuals and Rayleigh-refined eigenvalues of the k
                # wanted pairs; the compensated residual also feeds the
                # correction (the cache residual carries ~sqrt(n)*eps*λ
                # noise). Nonexistent pairs read an infinite error.
                ref = refine.refined_pairs(A_off, diag_a, X[:, :k],
                                           B_off=B_off,
                                           diag_b=diag_b if gen else None,
                                           rows=rows)
                pm_k = pair_mask[:k] > 0.5
                errors = torch.where(pm_k, ref.errors.to(dt),
                                     torch.full_like(ref.errors.to(dt),
                                                     float("inf")))
                evals = ref.evals.to(dt)
                R[:, :k] = torch.where(pm_k[None, :], ref.residual.to(dt),
                                       torch.zeros_like(R[:, :k]))
            else:
                errors = rows.norms(R[:, :k])
                evals = lam[:k]
            conv_now = _converged(cfg, errors, evals)
            # A pair can only converge if it exists (rank-deficient starts).
            conv_now = conv_now & (pair_mask[:k] > 0.5)
            has_conv = (st["has_conv"] | conv_now) if cfg.sticky else conv_now

        with annotate("fdt.host_read"):
            # The iteration's one host synchronisation.
            pending = [torch.all(has_conv)]
            if precise:
                worst = torch.max(torch.where(has_conv,
                                              torch.zeros_like(errors),
                                              errors))
                pending.append(worst < st["best_err"] * (1.0 - 1e-2))
            for key in ("m", "stalled"):
                if isinstance(st[key], torch.Tensor):
                    pending.append(st[key])
            if trap:
                # Ritz values must be finite; a residual norm may be +inf
                # (a refined pair that does not exist yet), never NaN.
                pending.append(torch.all(torch.isfinite(evals))
                               & ~torch.any(torch.isnan(errors)))
            flags = torch.stack([t.to(torch.int64) for t in pending]).tolist()
            all_conv = bool(flags.pop(0))
            improved = bool(flags.pop(0)) if precise else False
            for key in ("m", "stalled"):
                if isinstance(st[key], torch.Tensor):
                    st[key] = flags.pop(0)
            if trap and not flags.pop(0):
                raise FloatingPointError(
                    f"NaN in the Ritz values or residual norms at iteration "
                    f"{st['it'] + 1}")
            st["stalled"] = bool(st["stalled"])
            if st["stalled"]:
                # The previous expansion admitted no column: the state is
                # a fixed point. Exit with that iteration's results.
                break
            m = st["m"]
            st["m_hi"] = m
            it = st["it"]
            st["history"][it] = errors
            st["dims"][it] = m
            st.update(has_conv=has_conv, all_conv=all_conv, evals=evals,
                      evecs=X[:, :k], errors=errors, it=it + 1)
            if precise:
                st["best_err"] = torch.minimum(st["best_err"], worst)
            if all_conv:
                break

        collapse = m > cfg.max_dim
        if not collapse:
            # Expansion iff the current dim <= max_dim
            # (``src/davidson.f90:195``).
            with annotate("fdt.correction"):
                corr_mask = pmk
                if cfg.locking:
                    # Deflation (``core/loop.py:451-458``): converged pairs
                    # keep their Ritz vectors in the basis but spend no
                    # correction column; the orthonormalization drops
                    # their zero columns.
                    unconv = torch.ones((kk,), dtype=dt, device=dev)
                    unconv[:k] = (~has_conv).to(dt)
                    corr_mask = pmk * unconv
                if cfg.method == "DPR":
                    corr = corr_mod.dpr_correction(R, lam[:kk], diag_a,
                                                   diag_b, corr_mask)
                elif cfg.method == "OLSEN":
                    corr = corr_mod.olsen_correction(R, lam[:kk], X, diag_a,
                                                     diag_b, corr_mask, rows)
                else:
                    warm_t = None
                    if cfg.gjd_warm:
                        warm_t = st["corr_prev"][:, :kk]
                    corr, it_in = _gjd(cfg, A, B, dt, lam[:kk], X, R,
                                       corr_mask, diag_a, diag_b, warm_t,
                                       rows)
                    st["inner_ops"] += torch.max(it_in)
                    if cfg.gjd_warm:
                        # The raw correction, before orthonormalization, is
                        # what the next inner solve recycles.
                        st["corr_prev"][:, :kk] = corr
                        st["corr_prev"][:, kk:] = 0
                del R, X
            with annotate("fdt.orthonormalize"):
                Q, alive_q = orthogonal.orthonormalize_block(
                    V[:, :m], corr, corr_mask, n_reorth=cfg.n_reorth,
                    method=cfg.ortho,
                    rank_width=k if lowest_k else m_max, rows=rows,
                    precise=precise)
            del corr
            # The fused engine applies A after the write of Q: the gram
            # needs the basis that holds it.
            AQ = None if fused else _apply(A, Q, dt)
            with annotate("fdt.basis_update"):
                st["op_cols"] += torch.sum(alive_q).to(torch.int64)
                if precise:
                    Q, AQ, alive_q = _rq_gate(Q, AQ, alive_q, lam, pair_mask,
                                              k, rows)
                BQ = _apply(B, Q, dt) if gen else None
                live = torch.sum(alive_q).to(torch.int64)
                if lowest_k:
                    # Survivors are a prefix of the k-column block: write
                    # them at column m; the live count keeps the basis
                    # hole-free.
                    c0 = min(m, m_max - kk)
                    V[:, c0:c0 + kk] = Q
                    if fused:
                        # G = V[:, :c0+kk]ᵀ (A Q) holds H's new rows and
                        # columns; dead Q columns are zero, so are theirs.
                        with annotate("fdt.apply"):
                            AQ, G = A.matmat_with_gram(Q, v=V[:, :c0 + kk])
                            AQ, G = AQ.to(dt), G.to(dt)
                        H = st["H"]
                        H[:c0 + kk, c0:c0 + kk] = G
                        H[c0:c0 + kk, :c0 + kk] = G.T
                    AV[:, c0:c0 + kk] = AQ
                    if gen:
                        BV[:, c0:c0 + kk] = BQ
                    st["col_ok"][c0:c0 + kk] = alive_q
                    st["m"] = m + live
                    st["m_hi"] = min(m + kk, m_max)
                    # Zero admitted columns leave the state a fixed point.
                    st["stalled"] = live == 0
                else:
                    # Doubling: new columns shift to [m, 2m); the dimension
                    # bookkeeping follows the reference schedule, not drops.
                    _roll_add(V, Q, m)
                    _roll_add(AV, AQ, m)
                    if gen:
                        _roll_add(BV, BQ, m)
                    ok = st["col_ok"]
                    _roll_add(ok[None, :], alive_q[None, :], m)
                    st["m"] = st["m_hi"] = 2 * m
        else:
            # Collapse to the first init_dim Ritz vectors
            # (``src/davidson.f90:218``), kept orthonormal by a thin QR;
            # the caches follow by a triangular solve.
            with annotate("fdt.basis_update"):
                del R, X
                W2 = W[:, :init_dim]
                if _filtered(cfg):
                    # The filtered restart (``core/loop.py:643-674``): damp
                    # the restart block on [first unwanted Ritz value,
                    # spectral upper bound]. The filtered block leaves the
                    # span of the cached AV, so its A-image is applied
                    # afresh: degree + 1 block applies, charged to
                    # operator_columns.
                    a = lam[init_dim]
                    b = torch.maximum(st["spec_ub"],
                                      a + 1e-3 * (torch.abs(a) + 1.0))
                    lo = torch.minimum(lam[0],
                                       a - 1e-6 * (torch.abs(a) + 1.0))
                    degree = (chebyshev.auto_degree(lo, a, b, dt)
                              if cfg.cheb_auto else cfg.cheb_degree)
                    X2 = chebyshev.chebyshev_filter(
                        lambda T: _apply(A, T, dt), Vw @ W2, degree, a, b, lo)
                    with annotate("fdt.orthonormalize"):
                        Qc, Rc = orthogonal.thin_qr_collapse(
                            X2, method=cfg.ortho, rows=rows, precise=precise)
                    del X2
                    AQc = _apply(A, Qc, dt)
                    st["op_cols"] += (degree + 1) * init_dim
                else:
                    X2 = Vw @ W2
                    with annotate("fdt.orthonormalize"):
                        Qc, Rc = orthogonal.thin_qr_collapse(
                            X2, method=cfg.ortho, rows=rows, precise=precise)
                    del X2
                    AQc = orthogonal.right_tri_solve(AVw @ W2, Rc)
                BQc = (orthogonal.right_tri_solve(BV[:, :w] @ W2, Rc) if gen
                       else None)
                V.zero_()
                V[:, :init_dim] = Qc
                AV.zero_()
                AV[:, :init_dim] = AQc
                if gen:
                    BV.zero_()
                    BV[:, :init_dim] = BQc
                if fused:
                    # Re-seed the carried projection from the restart basis.
                    st["H"].zero_()
                    st["H"][:init_dim, :init_dim] = subspace.project(
                        Qc, AQc, rows)
                st["col_ok"] = orthogonal.col_mask(init_dim, m_max, dt, dev)
                st["m"] = st["m_hi"] = init_dim
                st["stalled"] = lowest_k and init_dim == m

        if precise:
            # Plateau tracking (``core/loop.py:732-788``). A collapse is
            # neutral: it neither counts nor resets (the doubling schedule
            # collapses more often than the window is long).
            if improved:
                st["no_prog"] = 0
            elif not collapse:
                st["no_prog"] += 1
            if st["no_prog"] >= _PLATEAU_ITERS:
                st["stalled"] = True
            elif (cfg.final_polish > 0 and st["no_prog"] == _POLISH_POLL_AT
                  and not collapse
                  and _certify(cfg, A_off, B_off, diag_a,
                               diag_b if gen else None, evals, st["evecs"],
                               rows)):
                st["stalled"] = True
            if st["stalled"] is True:
                break
    return st


def settle(st: dict) -> dict:
    """Read the flags an expansion left on the device (``m``,
    ``stalled``) into host values: one synchronisation. A chunk boundary
    and the end of a solve call it; the state is then all host values and
    tensors, as a checkpoint stores it."""
    pending = [key for key in ("m", "stalled")
               if isinstance(st[key], torch.Tensor)]
    if pending:
        with annotate("fdt.host_read"):
            vals = torch.stack([st[key].to(torch.int64)
                                for key in pending]).tolist()
        st.update(zip(pending, vals))
    st["stalled"] = bool(st["stalled"])
    return st


def pack_result(st: dict) -> DavidsonResult:
    """The result of a settled state (:func:`settle`)."""
    with annotate("fdt.host_read"):
        op_cols = int(st["op_cols"])
        inner = int(st["inner_ops"]) if "inner_ops" in st else None
    return DavidsonResult(
        eigenvalues=st["evals"],
        eigenvectors=st["evecs"],
        iterations=st["it"],
        converged=st["all_conv"],
        converged_pairs=st["has_conv"],
        residual_norms=st["errors"],
        residual_history=st["history"],
        subspace_dims=st["dims"],
        operator_columns=op_cols,
        stalled=st["stalled"],
        inner_iterations=inner,
    )


def _apply_final_polish(cfg: ResolvedConfig, A: LinearOperator,
                        B: Optional[LinearOperator], A_off, B_off,
                        res: DavidsonResult,
                        rows: Rows = LOCAL) -> DavidsonResult:
    """Double-single polish of the k returned pairs and the honest
    re-check (``core/loop.py:837-882``): convergence is evaluated against
    the polished TRUE residuals."""
    dt = getattr(torch, cfg.dtype)
    with annotate("fdt.polish"):
        pol = refine.polish(A_off, A.diagonal().to(dt), res.eigenvalues,
                            res.eigenvectors, iterations=cfg.final_polish,
                            B_off=B_off,
                            diag_b=None if B is None else B.diagonal().to(dt),
                            update=cfg.polish_update, rows=rows)
        conv = _converged(cfg, pol.errors, pol.evals)
        converged = bool(torch.all(conv))
    return DavidsonResult(
        eigenvalues=pol.evals,
        eigenvectors=pol.evecs_hi,
        iterations=res.iterations,
        converged=converged,
        converged_pairs=conv,
        residual_norms=pol.errors,
        residual_history=res.residual_history,
        subspace_dims=res.subspace_dims,
        # hi and lo both pass through A_off once per polish iteration.
        operator_columns=res.operator_columns
        + 2 * cfg.final_polish * cfg.lowest,
        stalled=res.stalled,
        inner_iterations=res.inner_iterations,
        eigenvalues_lo=pol.evals_lo,
        eigenvectors_lo=pol.evecs_lo,
    )


def set_compiled_cache_capacity(capacity: int) -> None:
    """Kept for the JAX package's API: there it bounds the compiled
    engines and steppers kept alive. The port compiles nothing, so there
    is nothing to bound; a capacity below 1 raises ``ValueError`` as
    there."""
    if capacity < 1:
        raise ValueError("cache capacity must be >= 1")


def clear_compiled_caches() -> None:
    """Kept for the JAX package's API: there it drops every compiled
    program. The port compiles nothing and caches nothing: a no-op."""


def get_stepper(cfg: ResolvedConfig, rows: Rows = LOCAL):
    """``(init, step)`` over an explicit state dict
    (``fortran_davidson_tpu.core.loop.get_stepper``), as plain functions:
    nothing is compiled, so nothing is cached.

    ``init(A, B, X0=None) -> state``; ``step(A, B, state, A_off=None,
    B_off=None) -> state`` iterates up to ``state["chunk_end"]`` (at first
    ``max_iterations``) and leaves the device flags unread. Both run
    under the solve's precision context and ``no_grad``.
    """
    def init(A, B, X0=None):
        with _precision_ctx(cfg.matmul_precision), torch.no_grad(), \
                annotate("fdt.init"):
            return init_state(cfg, A, B, X0=X0, rows=rows)

    def step(A, B, st, A_off=None, B_off=None):
        with _precision_ctx(cfg.matmul_precision), torch.no_grad():
            return run_state(cfg, A, B, st, rows, A_off=A_off, B_off=B_off)

    return init, step


def run_chunked(cfg: ResolvedConfig, A: LinearOperator,
                B: Optional[LinearOperator], *, every: int, callbacks=(),
                state: Optional[dict] = None, rows: Rows = LOCAL,
                A_off: Optional[LinearOperator] = None,
                B_off: Optional[LinearOperator] = None,
                X0=None) -> DavidsonResult:
    """Chunked driver (``fortran_davidson_tpu.core.loop.run_chunked``):
    run ``every`` iterations, settle the state (one host read), call each
    callback with it, and go on. The exit test is the one-shot's
    (convergence, a stall, ``max_iterations``), so the iterates, the
    iteration count and the operator applies are the one-shot solve's;
    the final polish runs at the end. ``state`` resumes a stopped solve
    (a callback's state, or a restored checkpoint); ``X0`` warm-starts a
    fresh one. ``A_off``/``B_off`` default to the operators' splits when
    the configuration is refined. A halo push that ran out of its wait
    (kernel 8's one launch) is raised by name where its CUDA error
    surfaces (:func:`~fortran_davidson_tpu_torch.ops.kernels.
    halo_push_faults`), usually at the iteration's synchronisation.
    """
    if every < 1:
        raise ValueError("every must be >= 1")
    with kernels.halo_push_faults():
        if cfg.refined and A_off is None:
            A_off = A.offdiag()
            B_off = None if B is None else B.offdiag()
        init, step = get_stepper(cfg, rows)
        st = init(A, B, X0) if state is None else state
        while True:
            st["chunk_end"] = min(st["it"] + every, cfg.max_iterations)
            settle(step(A, B, st, A_off=A_off, B_off=B_off))
            for cb in callbacks:
                cb(st)
            if st["all_conv"] or st["stalled"] or (st["it"]
                                                   >= cfg.max_iterations):
                break
        res = pack_result(st)
        if cfg.final_polish > 0:
            with _precision_ctx(cfg.matmul_precision), torch.no_grad():
                res = _apply_final_polish(cfg, A, B, A_off, B_off, res, rows)
    return res


def _engine(cfg: ResolvedConfig, A: LinearOperator,
            B: Optional[LinearOperator], X0=None,
            rows: Rows = LOCAL, A_off: Optional[LinearOperator] = None,
            B_off: Optional[LinearOperator] = None) -> DavidsonResult:
    """The one-shot solve: :func:`run_chunked` in one chunk."""
    return run_chunked(cfg, A, B, every=cfg.max_iterations, rows=rows,
                       A_off=A_off, B_off=B_off, X0=X0)
