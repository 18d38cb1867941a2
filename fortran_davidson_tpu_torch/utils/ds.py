"""Double-single (two-float) compensated arithmetic (counterpart of
``fortran_davidson_tpu/utils/ds.py``).

The error-free transformations (Knuth two-sum, Dekker two-product) and
the compensated reductions that let a float32 solve measure and reach
residuals of float64 grade:

- ``two_sum`` / ``two_prod``: exact ``a + b`` / ``a * b`` as a
  (value, error) pair of floats;
- double-single values as a ``(hi, lo)`` pair with ``|lo| <= ulp(hi)``
  (~48-bit mantissa in float32);
- ``gram_ds``: the row axis cut into ``chunk``-row slabs, each slab's
  partial Gram a batched float32 product, the partials combined by an
  exact two_sum tree, so each rounding is bounded by its chunk's own
  magnitude (~eps * c / sqrt(n) instead of ~eps * sqrt(n)).

Every function runs in any float dtype and works on either device.

**Every operation must round on its own.** The transforms are exact only
if each add, subtract and multiply is rounded as written. Eager PyTorch
runs one kernel per operation (no FMA contraction, no flush to zero of
float32 on CUDA). So nothing here, and nothing that feeds these functions
an intermediate, may use ``torch.compile`` or a fused form that can
contract a product into an add (``addcmul``, ``addcdiv``, ``lerp``,
``torch.add``/``torch.sub`` with ``alpha``, ``addmm``/``baddbmm`` with
``beta``). ``_split`` truncates by an integer mask, so it stays exact
whatever the compiler does.

Tall reductions (rows ~10⁶-10⁷) fold with the JAX package's default
single-device strategy: a sequential cascade of 65,536-row slabs from
``_CASCADE_MIN_ROWS`` rows up, the two_sum tree below. The tree pairs
contiguous halves, the order the JAX package uses off the TPU. The
shard-local pairings of its GSPMD strategy wait for the sharded refined
path (ROADMAP item 19).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DS(NamedTuple):
    """A double-single number/array: value ``hi + lo`` with |lo| <= ulp(hi)."""

    hi: torch.Tensor
    lo: torch.Tensor

    def to_float(self):
        return self.hi + self.lo


def ds(hi, lo=None) -> DS:
    hi = torch.as_tensor(hi)
    return DS(hi, torch.zeros_like(hi) if lo is None else torch.as_tensor(lo))


# -- error-free transformations ------------------------------------------

def two_sum(a, b):
    """Knuth two-sum: s = fl(a+b), e exact error (a+b = s+e). 6 flops."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def fast_two_sum(a, b):
    """Dekker fast two-sum; REQUIRES |a| >= |b| (or a == 0). 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


# Masks that keep the high half of the significand: float32 drops 12 low
# mantissa bits (12 + 12), float64 drops 27 (26 + 27). As signed
# integers: 0xFFFFF000 and 0xFFFFFFFFF8000000.
_SPLIT_MASK = {torch.float32: (torch.int32, -0x1000),
               torch.float64: (torch.int64, -0x8000000)}


def _split(a):
    """Split into hi/lo mantissa halves by bit masking.

    ``hi`` is exact by construction and ``a - hi`` is exact (same
    exponent, trailing bits only), so the split cannot be undone by any
    floating-point rewrite (the classic ``t = c*a; hi = t - (t - a)``
    can). The widths keep every two_prod partial product representable.
    """
    itype, mask = _SPLIT_MASK[a.dtype]
    hi = (a.view(itype) & mask).view(a.dtype)
    return hi, a - hi


def two_prod(a, b):
    """Dekker two-product: p = fl(a*b), e exact error (a*b = p+e)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- double-single arithmetic --------------------------------------------

def ds_add(x: DS, y: DS) -> DS:
    """DS + DS (Dekker add2: ~11 flops, |error| ~ eps^2)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DS(*fast_two_sum(s, e))


def ds_neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def ds_sub(x: DS, y: DS) -> DS:
    return ds_add(x, ds_neg(y))


def ds_mul(x: DS, y: DS) -> DS:
    """DS * DS."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DS(*fast_two_sum(p, e))


def ds_mul_f(x: DS, a) -> DS:
    """DS * plain float."""
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    return DS(*fast_two_sum(p, e))


def ds_div(x: DS, y: DS) -> DS:
    """DS / DS via Newton-corrected quotient."""
    q1 = x.hi / y.hi
    r = ds_sub(x, ds_mul_f(y, q1))
    q2 = (r.hi + r.lo) / y.hi
    return DS(*fast_two_sum(q1, q2))


def ds_sqrt(x: DS) -> DS:
    """sqrt of a DS (one Newton step on the working-precision sqrt)."""
    s = torch.sqrt(x.hi)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    r = ds_sub(x, DS(*two_prod(s, s)))
    corr = torch.where(s > 0, (r.hi + r.lo) / (2.0 * safe),
                       torch.zeros_like(s))
    return DS(*fast_two_sum(s, corr))


# -- compensated reductions ----------------------------------------------

# Slab rows of the cascade, and the row count from which the tall
# reductions take it (below it, the tree), as in the JAX package.
_CASCADE_SLAB = 65536
_CASCADE_MIN_ROWS = 4 * _CASCADE_SLAB


def _use_cascade(n: int) -> bool:
    return n >= _CASCADE_MIN_ROWS


def _cascade_fold(slab_fn, n: int, width: int, like, B: int) -> DS:
    """Compensated column sums by a sequential slab cascade.

    ``slab_fn(start, size)`` returns the (size, width) ``(hi, lo)``
    contribution of rows [start, start+size). Accumulator entry (i, j)
    two_sums rows i, i+B, i+2B, ... of column j exactly; every rounding
    lands in the lo channel. The (B, width) pair then folds by the tree.
    """
    nslab = n // B
    hi = torch.zeros((B, width), dtype=like.dtype, device=like.device)
    lo = torch.zeros_like(hi)
    for i in range(nslab):
        sh, sl = slab_fn(i * B, B)
        hi, e = two_sum(hi, sh)
        lo = lo + (sl + e)
    rem = n - nslab * B
    if rem:
        sh, sl = slab_fn(nslab * B, rem)
        s, e = two_sum(hi[:rem], sh)
        hi = torch.cat([s, hi[rem:]])
        lo = torch.cat([lo[:rem] + (sl + e), lo[rem:]])
    return _tall_sum_tree(hi, lo)


def _fold_leading(hi, lo):
    """Two_sum tree fold of axis 0 down to one entry (no final renorm),
    pairing contiguous halves."""
    while hi.shape[0] > 1:
        k = hi.shape[0]
        half = (k + 1) // 2
        if half * 2 - k:
            hi = torch.cat([hi, torch.zeros_like(hi[:1])])
            lo = torch.cat([lo, torch.zeros_like(lo[:1])])
        s, e = two_sum(hi[:half], hi[half:])
        lo = lo[:half] + lo[half:] + e
        hi = s
    return hi[0], lo[0]


def ds_sum_tree(x, axis: int = 0, lo=None) -> DS:
    """Exact-compensated sum along ``axis`` by a two_sum binary tree.

    ``lo`` seeds the error channel (e.g. per-element two_prod errors, for
    Dot2-grade compensated dot products).
    """
    hi = torch.movedim(x, axis, 0)
    lo = (torch.zeros_like(hi) if lo is None
          else torch.movedim(lo, axis, 0))
    return DS(*fast_two_sum(*_fold_leading(hi, lo)))


def tall_sum_ds(x, lo=None) -> DS:
    """Exact-compensated column sums of a tall (n, m) pair: the cascade
    from ``_CASCADE_MIN_ROWS`` rows, the tree below."""
    lo = torch.zeros_like(x) if lo is None else lo
    n, m = x.shape
    if _use_cascade(n):
        return _cascade_fold(lambda s, c: (x[s:s + c], lo[s:s + c]),
                             n, m, x, _CASCADE_SLAB)
    return _tall_sum_tree(x, lo)


def _tall_sum_tree(x, lo) -> DS:
    """The two_sum tree on a full-lane ``(n/g, g*m)`` reshape of the pair
    (g = 128/m' strata, m' = m rounded up to a power of two), its g
    strata per column folded by an exact sequential cascade at the end:
    the JAX package's order, kept so the two agree bit for bit."""
    n, m = x.shape
    mp = 1
    while mp < m:
        mp *= 2
    if mp > 128:
        return ds_sum_tree(x, axis=0, lo=lo)
    g = 128 // mp
    pad_rows = (g - n % g) % g
    if mp != m or pad_rows:
        x = torch.nn.functional.pad(x, (0, mp - m, 0, pad_rows))
        lo = torch.nn.functional.pad(lo, (0, mp - m, 0, pad_rows))
        n += pad_rows
    hi1, lo1 = _fold_leading(x.reshape(n // g, g * mp),
                             lo.reshape(n // g, g * mp))
    s = hi1.reshape(g, mp)
    e = lo1.reshape(g, mp)
    hi_acc, lo_acc = s[0], e[0]
    for i in range(1, g):
        hi_acc, err = two_sum(hi_acc, s[i])
        lo_acc = lo_acc + e[i] + err
    out = DS(*fast_two_sum(hi_acc, lo_acc))
    return DS(out.hi[:m], out.lo[:m])


def gram_chunk(n: int, chunk: Optional[int] = None) -> int:
    """The Gram's chunk rows: ``chunk`` (default 4096) halved until it
    divides n."""
    chunk = 4096 if chunk is None else chunk
    while n % chunk and chunk > 1:
        chunk //= 2
    return max(chunk, 1)


def gram_ds(V, W=None, *, chunk: Optional[int] = None) -> DS:
    """Compensated Gram matrix ``Vᵀ W`` (W defaults to V) as a DS pair.

    The row axis is cut into ``chunk``-row slabs; each slab's partial
    Gram is one batched product in the working dtype (true float32 on a
    GPU: the caller pins TF32 off), and the partials combine by the exact
    two_sum tree. Error ~ eps * chunk / sqrt(n) instead of ~ eps * sqrt(n).
    """
    W = V if W is None else W
    n, m = V.shape
    c = gram_chunk(n, chunk)
    return gram_ds_pre(V.reshape(n // c, c, m),
                       W.reshape(n // c, c, W.shape[1]))


def gram_ds_pre(Vc, Wc=None) -> DS:
    """Compensated Gram on pre-chunked ``(n/c, c, m)`` operands."""
    Wc = Vc if Wc is None else Wc
    return ds_sum_tree(torch.bmm(Vc.transpose(1, 2), Wc), axis=0)


def col_sumsq_ds(X, *, chunk: Optional[int] = None) -> DS:
    """Compensated per-column sum of squares."""
    n, m = X.shape
    c = gram_chunk(n, chunk)
    Xc = X.reshape(n // c, c, m)
    return ds_sum_tree(torch.sum(Xc * Xc, dim=1), axis=0)


def col_norms_ds(X, *, chunk: Optional[int] = None):
    """Compensated per-column 2-norms (plain float result)."""
    return ds_sqrt(col_sumsq_ds(X, chunk=chunk)).to_float()


def dot_cols_ds(X, Y) -> DS:
    """Fully compensated per-column dots diag(XᵀY) (Dot2 quality): exact
    elementwise products (two_prod) and exact summation, accurate under
    heavy cancellation. For (n, k) column blocks, not wide bases."""
    n, k = X.shape
    if _use_cascade(n):
        return _cascade_fold(lambda s, c: two_prod(X[s:s + c], Y[s:s + c]),
                             n, k, X, _CASCADE_SLAB)
    p, e = two_prod(X, Y)
    return tall_sum_ds(p, lo=e)


def weighted_dot_cols_ds(d, X, Y=None, extra_lo=None) -> DS:
    """Fully compensated ``Σ_i d_i X_ij Y_ij`` per column (Y defaults X).

    Both multiplications use two_prod. ``extra_lo`` adds a per-element
    first-order term (e.g. the x_lo cross terms of a DS iterate).
    """
    Y = X if Y is None else Y
    n, k = X.shape

    def terms(dv, xv, yv, ev):
        p, e = two_prod(dv[:, None], xv)
        q, eq = two_prod(p, yv)
        lo = eq + e * yv
        if ev is not None:
            lo = lo + ev
        return q, lo

    if _use_cascade(n):
        return _cascade_fold(
            lambda s, c: terms(d[s:s + c], X[s:s + c], Y[s:s + c],
                               None if extra_lo is None
                               else extra_lo[s:s + c]),
            n, k, X, _CASCADE_SLAB)
    q, lo = terms(d, X, Y, extra_lo)
    return tall_sum_ds(q, lo=lo)


def col_sumsq_pair_ds(hi, lo) -> DS:
    """Compensated per-column ``Σ (hi+lo)²`` of a DS column block:
    ``Σ hi² + 2 Σ hi∘lo``, the squares exact, the cross term in the error
    channel (the lo² term, ~eps⁴, is dropped)."""
    n, k = hi.shape

    def terms(hs, ls):
        p, e = two_prod(hs, hs)
        return p, e + 2.0 * (hs * ls)

    if _use_cascade(n):
        return _cascade_fold(lambda s, c: terms(hi[s:s + c], lo[s:s + c]),
                             n, k, hi, _CASCADE_SLAB)
    p, e = terms(hi, lo)
    return tall_sum_ds(p, lo=e)


# -- compensated elementwise kernels used by the solver -------------------

def shifted_diag_apply(diag, shift, X):
    """``(diag - shift)[:, None] * X`` in double-single: near convergence
    ``diag_i ≈ shift`` where the eigenvector has its mass, and the plain
    subtraction and product would leave an eps*|diag| error there.

    diag: (n,), shift: (k,), X: (n, k). Returns a DS (n, k) pair.
    """
    d, e_sub = two_sum(diag[:, None], -shift[None, :])
    p, e_mul = two_prod(d, X)
    return DS(*fast_two_sum(p, e_mul + e_sub * X))
