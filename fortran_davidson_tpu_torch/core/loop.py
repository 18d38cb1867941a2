"""The block-Davidson outer loop as an eager loop over device tensors
(counterpart of ``fortran_davidson_tpu/core/loop.py``: the branch that is
not refined, uses flat carries and is not fused).

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
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from fortran_davidson_tpu_torch.config import DavidsonResult, ResolvedConfig
from fortran_davidson_tpu_torch.core import correction as corr_mod
from fortran_davidson_tpu_torch.core import orthogonal, subspace
from fortran_davidson_tpu_torch.ops.operators import LinearOperator


@contextlib.contextmanager
def _precision_ctx():
    """Full-precision float32 matmuls for everything inside the solver.

    The GPU form of the JAX package's ``_precision_ctx``
    (``core/loop.py:54-68``): TF32 keeps ~10 mantissa bits, which poisons
    the projected matrix, Ritz products and residuals of a float32 solve.
    No effect on float64.
    """
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _apply(op: LinearOperator, X, dt):
    return op.matmat(X).to(dt)


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
               B: Optional[LinearOperator], X0=None) -> dict:
    """Initial loop state (a dict of tensors and host scalars).

    ``X0``: optional (n, j) warm-start vectors, j <= init_dim.
    """
    n = A.shape[0]
    k = cfg.lowest
    m_max = cfg.m_max
    init_dim = cfg.init_dim
    dt = getattr(torch, cfg.dtype)
    dev = A.device
    diag_a = A.diagonal().to(dt)

    if X0 is None:
        V = subspace.initial_subspace(diag_a, init_dim, m_max)
        col_ok = orthogonal.col_mask(init_dim, m_max, dt, dev)
        m = init_dim
    else:
        V, col_ok, m = subspace.initial_subspace_with_guess(
            diag_a, X0, init_dim, m_max)
        if cfg.expansion == "doubling":
            # Doubling doubles m regardless of the live count
            # (``src/davidson.f90:199``) and its roll-add placement needs m
            # on the init_dim lattice: snap it. Dropped guess columns stay
            # zero columns inside the active window (``core/loop.py:107-118``).
            m = init_dim
    AV = torch.zeros_like(V)
    AV[:, :init_dim] = _apply(A, V[:, :init_dim], dt)
    state = dict(
        V=V, AV=AV, m=m, m_hi=init_dim, col_ok=col_ok, it=0,
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
    return state


def run_state(cfg: ResolvedConfig, A: LinearOperator,
              B: Optional[LinearOperator], st: dict) -> dict:
    """Iterate until convergence, a stall, or ``max_iterations``.

    ``st`` is updated in place and returned. ``st["m"]`` and
    ``st["stalled"]`` may be 0-d device tensors between iterations; they
    are read at the next iteration's synchronisation (or by
    :func:`pack_result`).
    """
    n = A.shape[0]
    k = cfg.lowest
    m_max = cfg.m_max
    init_dim = cfg.init_dim
    dt = getattr(torch, cfg.dtype)
    dev = A.device
    gen = B is not None
    lowest_k = cfg.expansion == "lowest-k"
    diag_a = A.diagonal().to(dt)
    diag_b = (B.diagonal().to(dt) if gen
              else torch.ones((n,), dtype=dt, device=dev))
    V, AV = st["V"], st["AV"]
    BV = st["BV"] if gen else None
    ar = torch.arange(m_max, device=dev)

    while st["it"] < cfg.max_iterations and not st["all_conv"]:
        w = st["m_hi"]
        # Active columns: prefix up to m minus the columns dropped by the
        # rank-revealing orthonormalization. Ritz pairs live in pair index
        # space, a prefix of width sum(mask).
        mask = (ar[:w] < st["m"]).to(dt) * st["col_ok"][:w]
        pair_mask = (ar[:w] < torch.sum(mask)).to(dt)

        # Rayleigh-Ritz on the leading w columns (masked, penalized eigh).
        Vw, AVw = V[:, :w], AV[:, :w]
        H = subspace.project(Vw, AVw)
        S = subspace.project(Vw, BV[:, :w]) if gen else None
        lam, W = subspace.ritz_decomposition(H, S, mask, m_max)

        # Ritz vectors and block residuals from the caches. Lowest-k only
        # ever corrects the k wanted pairs; doubling corrects every pair.
        kk = k if lowest_k else w
        Wk = W[:, :kk]
        pmk = pair_mask[:kk]
        X = (Vw @ Wk) * pmk[None, :]
        AXW = AVw @ Wk
        BXW = BV[:, :w] @ Wk if gen else X
        R = (AXW - BXW * lam[:kk][None, :]) * pmk[None, :]
        del AXW, BXW
        errors = torch.linalg.vector_norm(R[:, :k], dim=0)
        if cfg.relative:
            conv_now = errors < cfg.tolerance * torch.clamp(
                torch.abs(lam[:k]), min=1.0)
        else:
            conv_now = errors < cfg.tolerance
        # A pair can only converge if it exists (rank-deficient starts).
        conv_now = conv_now & (pair_mask[:k] > 0.5)
        has_conv = (st["has_conv"] | conv_now) if cfg.sticky else conv_now

        # The iteration's one host synchronisation.
        pending = [torch.all(has_conv)]
        for key in ("m", "stalled"):
            if isinstance(st[key], torch.Tensor):
                pending.append(st[key])
        flags = torch.stack([t.to(torch.int64) for t in pending]).tolist()
        all_conv = bool(flags.pop(0))
        for key in ("m", "stalled"):
            if isinstance(st[key], torch.Tensor):
                st[key] = flags.pop(0)
        st["stalled"] = bool(st["stalled"])
        if st["stalled"]:
            # The previous expansion admitted no column: the state is a
            # fixed point. Exit with that iteration's results.
            break
        m = st["m"]
        st["m_hi"] = m
        it = st["it"]
        st["history"][it] = errors
        st["dims"][it] = m
        st.update(has_conv=has_conv, all_conv=all_conv, evals=lam[:k],
                  evecs=X[:, :k], errors=errors, it=it + 1)
        if all_conv:
            break

        if m <= cfg.max_dim:
            # Expansion iff the current dim <= max_dim
            # (``src/davidson.f90:195``).
            if cfg.method == "DPR":
                corr = corr_mod.dpr_correction(R, lam[:kk], diag_a, diag_b,
                                               pmk)
            else:
                corr = corr_mod.olsen_correction(R, lam[:kk], X, diag_a,
                                                 diag_b, pmk)
            del R, X
            Q, alive_q = orthogonal.orthonormalize_block(
                V[:, :m], corr, pmk, n_reorth=cfg.n_reorth, method=cfg.ortho,
                rank_width=k if lowest_k else m_max)
            del corr
            AQ = _apply(A, Q, dt)
            BQ = _apply(B, Q, dt) if gen else None
            live = torch.sum(alive_q).to(torch.int64)
            st["op_cols"] += live
            if lowest_k:
                # Survivors are a prefix of the k-column block: write them
                # at column m; the live count keeps the basis hole-free.
                c0 = min(m, m_max - kk)
                V[:, c0:c0 + kk] = Q
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
            del R, X
            W2 = W[:, :init_dim]
            Qc, Rc = orthogonal.thin_qr_collapse(Vw @ W2, method=cfg.ortho)
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
            st["col_ok"] = orthogonal.col_mask(init_dim, m_max, dt, dev)
            st["m"] = st["m_hi"] = init_dim
            st["stalled"] = lowest_k and init_dim == m
    return st


def pack_result(st: dict) -> DavidsonResult:
    stalled = st["stalled"]
    if isinstance(stalled, torch.Tensor):
        # An expansion on the last allowed iteration left its flag unread.
        stalled = bool(stalled)
    return DavidsonResult(
        eigenvalues=st["evals"],
        eigenvectors=st["evecs"],
        iterations=st["it"],
        converged=st["all_conv"],
        converged_pairs=st["has_conv"],
        residual_norms=st["errors"],
        residual_history=st["history"],
        subspace_dims=st["dims"],
        operator_columns=int(st["op_cols"]),
        stalled=stalled,
    )


def _engine(cfg: ResolvedConfig, A: LinearOperator,
            B: Optional[LinearOperator], X0=None) -> DavidsonResult:
    with _precision_ctx(), torch.no_grad():
        st = init_state(cfg, A, B, X0=X0)
        return pack_result(run_state(cfg, A, B, st))
