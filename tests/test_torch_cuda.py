"""The port's CUDA kernels and solver on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it also runs where JAX is absent, without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tol(dtype):
    # float64: the same products summed in another order; float32 likewise.
    if dtype == torch.float64:
        return dict(rtol=1e-12, atol=1e-12)
    return dict(rtol=1e-5, atol=1e-4)


def _assert_gram_close(g, g_plain, v, y, rel=1e-5):
    """Elementwise |G - G_plain| <= rel * (|V|ᵀ|Y|): G sums n products
    with cancellation, so max|G| is the wrong yardstick."""
    bound = rel * (v.abs().double().T @ y.abs().double()) + 1e-30
    assert bool(torch.all((g.double() - g_plain.double()).abs() <= bound))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 20, 64, 130])
def test_kernels_match_plain(cuda_device, dtype, m):
    op = fdtt.generate_banded_bsr(37, 16, bandwidth=3, seed=1, dtype=dtype,
                                  device=cuda_device)
    x = torch.randn((op.shape[0], m), dtype=dtype, device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    y = kernels.banded_bsr_spmm(op.blocks, x, 3)
    assert kernels.banded_bsr_spmm.launches == before + 1
    torch.testing.assert_close(
        y, kernels.banded_bsr_spmm_plain(op.blocks, x, 3), **_tol(dtype))
    before = kernels.bsr_spmm.launches
    y = kernels.bsr_spmm(op.block_cols, op.blocks, x)
    assert kernels.bsr_spmm.launches == before + 1
    torch.testing.assert_close(
        y, kernels.bsr_spmm_plain(op.block_cols, op.blocks, x), **_tol(dtype))


@pytest.mark.parametrize("m", [3, 48, 130])
def test_bf16_storage_writes_f32_sums(cuda_device, m):
    op = fdtt.generate_banded_bsr(37, 16, bandwidth=2, seed=3,
                                  dtype=torch.float32, device=cuda_device)
    blocks = op.blocks.to(torch.bfloat16)
    x = torch.randn((op.shape[0], m), device=cuda_device).to(torch.bfloat16)
    y = kernels.banded_bsr_spmm(blocks, x, 2, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    # Exact products of bf16 values, summed in float32 in another order.
    torch.testing.assert_close(
        y, kernels.banded_bsr_spmm_plain(blocks, x, 2,
                                         out_dtype=torch.float32),
        rtol=1e-5, atol=1e-5)
    y = kernels.bsr_spmm(op.block_cols, blocks, x, out_dtype=torch.float32)
    torch.testing.assert_close(
        y, kernels.bsr_spmm_plain(op.block_cols, blocks, x,
                                  out_dtype=torch.float32),
        rtol=1e-5, atol=1e-5)


def _gram_cases(dev, nbr, bs, bw, seed):
    """(kernel, plain, lead) of the float32 kernel 3 and kernel 5 on one
    random banded matrix and its int8 form."""
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=seed,
                                  dtype=torch.float32, device=dev)
    q = fdtt.generate_banded_bsr_quantized(nbr, bs, bandwidth=bw, seed=seed,
                                           device=dev)
    return [
        (kernels.banded_bsr_spmm_gram, kernels.banded_bsr_spmm_gram_plain,
         (op.blocks,)),
        (kernels.banded_q_bsr_spmm_gram, kernels.banded_q_bsr_spmm_gram_plain,
         (q.qblocks, q.scale_rows, q.diag)),
    ]


def _check_gram(kernel, plain, lead, x, v, bw, write_out):
    """One launch against the plain version: Y within 1e-5 of max|Y|, G
    elementwise within 1e-5 of |V|ᵀ|Y|, the same bits on a second launch."""
    vv = x if v is None else v
    before = kernel.launches
    out = kernel(*lead, x, v, bandwidth=bw, write_out=write_out)
    assert kernel.launches == before + 1
    ref = plain(*lead, x, v, bandwidth=bw, write_out=True)
    g = out[1] if write_out else out
    assert g.dtype == torch.float32 and g.shape == (vv.shape[1], x.shape[1])
    if write_out:
        err = float((out[0] - ref[0]).abs().max())
        assert err <= 1e-5 * float(ref[0].abs().max())
    _assert_gram_close(g, ref[1], vv, ref[0])
    again = kernel(*lead, x, v, bandwidth=bw, write_out=write_out)
    assert torch.equal(g, again[1] if write_out else again), \
        "the gram reduction is not deterministic"
    return g


@pytest.mark.parametrize("bs", [8, 24, 128])
@pytest.mark.parametrize("m,mv", [(m, mv) for m in (1, 20, 33, 128, 130)
                                  for mv in (None, 7, 40, 220, 1408, 1500)]
                         + [(256, 1408)])
@pytest.mark.parametrize("write_out", [True, False])
def test_gram_kernels_match_plain(cuda_device, bs, m, mv, write_out):
    # Ragged against every tile: bs of 8 and 24 leave the 16-row tiles
    # partly empty, 17 block rows, mv not a multiple of 8 (and below the
    # cluster size), m not a multiple of 8 or wider than one column tile;
    # v is the leading mv columns of a wider buffer (ldv = mv + 5).
    dev = cuda_device
    nbr, bw = 17, 2
    n = nbr * bs
    x = torch.randn((n, m), device=dev)
    v = None if mv is None else torch.randn((n, mv + 5), device=dev)[:, :mv]
    for kernel, plain, lead in _gram_cases(dev, nbr, bs, bw, seed=4):
        _check_gram(kernel, plain, lead, x, v, bw, write_out)


def _framed(t, pad: int, cols: int = 0):
    """``t`` inside a buffer of NaNs: ``pad`` rows above and below and
    ``cols`` columns to the right (a view with row stride t.shape[1] +
    cols)."""
    buf = torch.full((t.shape[0] + 2 * pad, t.shape[1] + cols), float("nan"),
                     dtype=t.dtype, device=t.device)
    buf[pad:pad + t.shape[0], :t.shape[1]] = t
    return buf[pad:pad + t.shape[0], :t.shape[1]]


@pytest.mark.parametrize("m,mv", [(20, None), (20, 220), (128, 1408),
                                  (33, 40)])
def test_gram_kernels_edge_windows_read_no_frame(cuda_device, m, mv):
    # x and V are views into buffers framed by NaN rows (and V by NaN
    # columns past mv): a load outside the edge windows, past n or past
    # mv brings a NaN into Y or G.
    dev = cuda_device
    nbr, bs, bw = 9, 24, 2
    pad = bw * bs
    x = _framed(torch.randn((nbr * bs, m), device=dev), pad)
    v = None if mv is None else _framed(
        torch.randn((nbr * bs, mv), device=dev), pad, cols=3)
    for kernel, plain, lead in _gram_cases(dev, nbr, bs, bw, seed=12):
        y, g = kernel(*lead, x, v, bandwidth=bw)
        assert bool(torch.all(torch.isfinite(y)))
        assert bool(torch.all(torch.isfinite(g)))
        clean_v = None if v is None else v.clone()
        yp, gp = plain(*lead, x.clone(), clean_v, bandwidth=bw)
        assert float((y - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
        _assert_gram_close(g, gp, x if v is None else v, yp)


def test_gram_cluster_and_single_block_launches_agree(cuda_device):
    # mv = 1408 at m = 128 runs clusters of 8 blocks sharing each Y tile
    # through distributed shared memory; mv = 40 one block a group. Both
    # match the plain version on the same matrix, and G's leading rows
    # agree.
    dev = cuda_device
    nbr, bs, bw = 33, 128, 1
    x = torch.randn((nbr * bs, 128), device=dev)
    v = torch.randn((nbr * bs, 1408), device=dev)
    for kernel, plain, lead in _gram_cases(dev, nbr, bs, bw, seed=13):
        wide = _check_gram(kernel, plain, lead, x, v, bw, True)
        narrow = _check_gram(kernel, plain, lead, x, v[:, :40], bw, True)
        yp = plain(*lead, x, v[:, :40], bandwidth=bw)[0]
        _assert_gram_close(wide[:40], narrow, v[:, :40], yp, rel=2e-5)


def test_gram_variants_reduce_y(cuda_device):
    # The measurement variants (no V; V streamed, no gram) return Y's
    # column sums in G's row 0 at the main cases' widths.
    dev = cuda_device
    nbr, bs, bw = 17, 128, 1
    cases = list(zip(_gram_cases(dev, nbr, bs, bw, 14), (128, 20),
                     (1408, 220)))
    # Kernel 5 at the probe's width too (m = mv = 256, a column tile of 128).
    cases.append((cases[1][0], 256, 256))
    for (kernel, plain, lead), m, mv in cases:
        x = torch.randn((nbr * bs, m), device=dev)
        v = torch.randn((nbr * bs, mv), device=dev)
        y = plain(*lead, x, v, bandwidth=bw)[0]
        for variant in ("nov", "nogram"):
            g = kernels.fused_gram_variant(kernel.__name__, lead, x, v,
                                           bandwidth=bw, variant=variant)
            assert g.shape == (mv, m) and not bool(torch.any(g[1:]))
            want = y.double().sum(0)
            bound = 1e-5 * y.double().abs().sum(0) + 1e-30
            assert bool(torch.all((g[0].double() - want).abs() <= bound))


# Kernel 3's bf16 and float64 entries (csrc/fused_gram_typed.cuh): Y to
# 1e-5 (bf16: exact products, f32 sums in another order) or 1e-12 of max|Y|;
# G elementwise to one bf16 ulp (2^-8) of |V|ᵀ|Y| for bf16 (Y is staged as
# bf16 for the gram; a sum in another order may round to the neighbouring
# bf16 value), 1e-6 for float64 (f64 sums, G rounded once to float32).
TYPED_TOL = {torch.bfloat16: (1e-5, 2.0 ** -8), torch.float64: (1e-12, 1e-6)}


def _typed_case(dev, dtype, nbr, bs, bw, seed, band_only=False):
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=seed,
                                  device=dev)
    if band_only:
        op = op.offdiag()
    return op.blocks.to(dtype)


def _check_typed(blocks, x, v, bw, write_out, clean_x, clean_v):
    """One launch against the plain version on clean copies of x and v,
    counted apart by type, and the same bits on a second launch."""
    dtype = x.dtype
    y_tol, g_tol = TYPED_TOL[dtype]
    counter = "bf16_launches" if dtype == torch.bfloat16 else "f64_launches"
    gram = kernels.banded_bsr_spmm_gram
    before = (gram.launches, getattr(gram, counter))
    out = gram(blocks, x, v, bandwidth=bw, write_out=write_out,
               out_dtype=kernels.acc_dtype(dtype))
    assert (gram.launches, getattr(gram, counter)) == (before[0] + 1,
                                                       before[1] + 1)
    yp, gp = kernels.banded_bsr_spmm_gram_plain(
        blocks, clean_x, clean_v, bandwidth=bw,
        out_dtype=kernels.acc_dtype(dtype))
    g = out[1] if write_out else out
    vv = clean_x if clean_v is None else clean_v
    assert g.dtype == torch.float32 and g.shape == (vv.shape[1], x.shape[1])
    assert bool(torch.all(torch.isfinite(g)))
    if write_out:
        assert bool(torch.all(torch.isfinite(out[0])))
        scale = float(yp.abs().max())
        assert float((out[0].double() - yp.double()).abs().max()) <= (
            y_tol * scale)
    _assert_gram_close(g, gp, vv.double(), yp, rel=g_tol)
    again = gram(blocks, x, v, bandwidth=bw, write_out=write_out,
                 out_dtype=kernels.acc_dtype(dtype))
    assert torch.equal(g, again[1] if write_out else again)
    if write_out:
        assert torch.equal(out[0], again[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("m", [1, 4, 20, 44, 64, 128, 256])
@pytest.mark.parametrize("mv", [None, 12, 200, 1408])
@pytest.mark.parametrize("bs,bw", [(24, 1), (24, 2), (128, 1), (128, 2)])
def test_gram_kernel_f64_and_bf16(cuda_device, dtype, m, mv, bs, bw):
    # 17 block rows, ragged against the 16-row tiles (bs = 24) and the
    # column tiles; x and V inside buffers framed by NaN rows (V also by NaN
    # columns past mv, so its row stride is mv + 3): a read outside the
    # edge windows, past n or past mv brings a NaN into Y or G.
    dev = cuda_device
    nbr = 17
    n = nbr * bs
    blocks = _typed_case(dev, dtype, nbr, bs, bw, seed=m + bs + bw)
    pad = bw * bs
    x = torch.randn((n, m), device=dev).to(dtype)
    v = None if mv is None else torch.randn((n, mv), device=dev).to(dtype)
    xf = _framed(x, pad)
    vf = None if v is None else _framed(v, pad, cols=3)
    for write_out in (True, False):
        _check_typed(blocks, xf, vf, bw, write_out, x, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("m,mv", [(20, None), (20, 220), (128, 1408)])
@pytest.mark.parametrize("bs,bw", [(24, 2), (128, 1)])
def test_gram_kernel_f64_and_bf16_band_alone(cuda_device, dtype, m, mv, bs,
                                             bw):
    # The band alone (the diagonal zeroed): with the diagonal the band is a
    # small share of Y, so a fault in the band's windows would hide under
    # the limit of max|Y|.
    dev = cuda_device
    nbr = 17
    blocks = _typed_case(dev, dtype, nbr, bs, bw, seed=31, band_only=True)
    x = torch.randn((nbr * bs, m), device=dev).to(dtype)
    v = None if mv is None else torch.randn((nbr * bs, mv),
                                            device=dev).to(dtype)
    _check_typed(blocks, x, v, bw, True, x, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_gram_kernel_f64_and_bf16_refuse_a_width_past_the_plan(cuda_device,
                                                             dtype):
    # No layout holds G of 16 blocks' registers and shared memory past
    # ~16k rows: the wrapper raises, naming the entry and the shape, and
    # launches nothing (no fallback to another kernel).
    dev = cuda_device
    blocks = _typed_case(dev, dtype, 4, 16, 1, seed=2)
    x = torch.randn((64, 8), device=dev).to(dtype)
    v = torch.randn((64, 40000), device=dev).to(dtype)
    gram = kernels.banded_bsr_spmm_gram
    before = gram.launches
    sfx = "bf16" if dtype == torch.bfloat16 else "f64"
    with pytest.raises(RuntimeError, match=f"fdt_fused_gram_{sfx}_plan.*"
                       "mv=40000"):
        gram(blocks, x, v, bandwidth=1)
    assert gram.launches == before


def test_typed_gram_plans_at_the_main_case(cuda_device):
    # Row 3's shape (1M rows, bs 128, bw 1, m 128, mv 1408): the layouts
    # the wrapper takes, reported as the float32 kernel's are.
    for dtype in (torch.bfloat16, torch.float64):
        plan = kernels.fused_typed_plan(0, dtype, 8192, 128, 3, 128, 1408)
        assert set(plan) == set(kernels.FUSED_PLAN_KEYS)
        assert plan["C"] * plan["MB"] >= 1408 and plan["n_groups"] >= 1
        assert plan["TN"] in (64, 128) and plan["clusters_resident"] >= 1


def test_int8_kernel_matches_plain(cuda_device):
    q = fdtt.generate_banded_bsr_quantized(17, 24, bandwidth=2, seed=6,
                                           device=cuda_device)
    x = torch.randn((q.shape[0], 20), device=cuda_device)
    before = kernels.banded_q_bsr_spmm.launches
    y = q.matmat(x)
    assert kernels.banded_q_bsr_spmm.launches == before + 1
    torch.testing.assert_close(
        y, kernels.banded_q_bsr_spmm_plain(q.qblocks, q.scale_rows, q.diag,
                                           x, 2), **_tol(torch.float32))


@pytest.mark.parametrize("m", [1, 4, 20, 44, 64, 256])
@pytest.mark.parametrize("bs,bw", [(24, 1), (24, 2), (128, 1)])
def test_int8_tensor_core_kernel(cuda_device, m, bs, bw):
    # Kernel 4's float32 entry (csrc/q_spmm.cu, kernel 5's slot-by-slot
    # apply): 17 block rows, ragged against the 16-row tiles and the column
    # tiles; x framed by NaN rows, so a read outside [0, n) brings a NaN
    # into Y. Within 1e-5 of max|Y| of the plain version (TF32 products of
    # x hi and lo, another order of sums), the same bits twice, and Y of
    # kernel 5 on the same inputs bit for bit (one apply, one epilogue).
    dev = cuda_device
    q = fdtt.generate_banded_bsr_quantized(17, bs, bandwidth=bw, seed=m + bs,
                                           device=dev)
    lead = (q.qblocks, q.scale_rows, q.diag)
    x = _framed(torch.randn((q.shape[0], m), device=dev), bw * bs)
    before = kernels.banded_q_bsr_spmm.launches
    y = kernels.banded_q_bsr_spmm(*lead, x, bw)
    assert kernels.banded_q_bsr_spmm.launches == before + 1
    assert y.dtype == torch.float32 and bool(torch.all(torch.isfinite(y)))
    yp = kernels.banded_q_bsr_spmm_plain(*lead, x.clone(), bw)
    assert float((y - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert torch.equal(y, kernels.banded_q_bsr_spmm(*lead, x, bw))
    y5, _ = kernels.banded_q_bsr_spmm_gram(*lead, x, None, bandwidth=bw)
    assert torch.equal(y, y5)
    # The band alone (the diagonal zeroed): with the diagonal in, the
    # coupling-1e-3 band is ~1e-6 of max|Y|, under the limit above.
    band = (q.qblocks, q.scale_rows, torch.zeros_like(q.diag))
    yb = kernels.banded_q_bsr_spmm(*band, x, bw)
    ybp = kernels.banded_q_bsr_spmm_plain(*band, x.clone(), bw)
    assert float((yb - ybp).abs().max()) <= 1e-5 * float(ybp.abs().max())


def _exact_int8(dev, nbr, bs, bw, m, mv, seed):
    """Int8 operands and inputs on which every product and every sum of
    kernel 4, kernel 5's bf16-dequant variants and their plain versions is
    exact in float32 (and bf16(q) * bf16(s) exact in bf16), whatever the
    order: q in [-15, 15] (zero in the slots past the matrix's ends), one
    scale of 2^-4 or 2^-5 a (block row, slot), an integer diagonal in
    [-2, 2], x and v in {-1, 0, 1}. Y and G are multiples of 2^-5 below
    2^15, so a kernel matches its plain version bit for bit, and a dropped
    slot, a wrong scale or a wrong window changes the bits."""
    gen = torch.Generator().manual_seed(seed)
    K = 2 * bw + 1

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen)
    q = ints(-15, 15, nbr, bs, K, bs)
    for k in range(K):                    # slot k holds block (i, i + k - bw)
        for i in range(nbr):
            if not 0 <= i + k - bw < nbr:
                q[i, :, k] = 0
    scale = torch.pow(2.0, -4.0 - ints(0, 1, nbr, K, 1).float())
    lead = (q.reshape(nbr, bs, K * bs).to(torch.int8).to(dev),
            scale.expand(nbr, K, bs).reshape(nbr, K * bs).contiguous().to(dev),
            ints(-2, 2, nbr, bs).float().to(dev))
    return (lead, ints(-1, 1, nbr * bs, m).float().to(dev),
            ints(-1, 1, nbr * bs, mv).float().to(dev))


@pytest.mark.parametrize("m", [1, 20, 64, 256])
@pytest.mark.parametrize("bs,bw", [(24, 1), (24, 2), (128, 1)])
def test_int8_kernels_exact_on_exact_inputs(cuda_device, m, bs, bw):
    # Kernel 4 (float32 x) and kernel 5's bf16-dequant variants, bit for
    # bit against their plain versions, on and off the diagonal, where no
    # rounding can hide a fault in the band (see _exact_int8).
    lead, x, v = _exact_int8(cuda_device, 17, bs, bw, m, 40, m + bs + bw)
    band = (*lead[:2], torch.zeros_like(lead[2]))
    for ld in (lead, band):
        y = kernels.banded_q_bsr_spmm(*ld, x, bw)
        assert torch.equal(y, kernels.banded_q_bsr_spmm_plain(*ld, x, bw))
        xb, vb = x.to(torch.bfloat16), v.to(torch.bfloat16)
        for variant in kernels.BF16_VARIANTS:
            vv = None if variant == "nov_bf16" else vb
            g = kernels.fused_gram_variant(
                "banded_q_bsr_spmm_gram", ld, xb, vv, bandwidth=bw,
                variant=variant)
            assert torch.equal(g, kernels.fused_gram_variant_plain(
                "banded_q_bsr_spmm_gram", ld, xb, vv, bandwidth=bw,
                variant=variant)), variant


def _bf16_variant_check(lead, x, v, bw, variant):
    """One launch of a bf16-dequant variant of kernel 5 against
    fused_gram_variant_plain, and a second launch's bits. G within 2^-7 of
    |V|ᵀ|Y| elementwise (a Y sum in another order can round to the
    neighbouring bf16 value before the gram); nov_bf16's row 0 within 1e-5
    of Y's column sums of |Y|, the other rows 0. Returns G."""
    g = kernels.fused_gram_variant("banded_q_bsr_spmm_gram", lead, x, v,
                                   bandwidth=bw, variant=variant)
    gp = kernels.fused_gram_variant_plain(
        "banded_q_bsr_spmm_gram", lead, x.clone(),
        None if v is None else v.clone(), bandwidth=bw, variant=variant)
    assert g.dtype == torch.float32 and g.shape == gp.shape
    assert bool(torch.all(torch.isfinite(g)))
    y = kernels.q_bf16_apply_plain(*lead, x.clone(), bw)
    if v is None:
        assert not bool(torch.any(g[1:]))
        bound = 1e-5 * y.double().abs().sum(0)
        assert bool(torch.all((g[0].double() - gp[0].double()).abs() <= bound))
    else:
        _assert_gram_close(g, gp, v.float(), y, rel=2.0 ** -7)
    again = kernels.fused_gram_variant("banded_q_bsr_spmm_gram", lead, x, v,
                                       bandwidth=bw, variant=variant)
    assert torch.equal(g, again), "the G reduction is not deterministic"
    return g


@pytest.mark.parametrize("variant,mv", [("bf16deq", 40), ("bf16deq", 220),
                                        ("tg_bf16deq", 40),
                                        ("tg_bf16deq", 220),
                                        ("nov_bf16", None)])
@pytest.mark.parametrize("m", [1, 4, 20, 44, 64, 256])
@pytest.mark.parametrize("bw", [1, 2, 3])
def test_bf16_dequant_variants_match_plain(cuda_device, variant, mv, m, bw):
    # Kernel 5's bf16-dequant variants (csrc/fused_gram_q8bf16.cu): 17
    # block rows of bs 24 (ragged against the 16-row tiles, an odd count
    # for tg_bf16deq's tiles of two block rows); x and v bf16, framed by NaN
    # rows (v also by NaN columns past mv, ldv = mv + 3). nov_bf16 reads no
    # v. On the operator and on its band alone (the diagonal zeroed).
    # tg_bf16deq is bf16deq's function summed in the same order: its bits.
    dev = cuda_device
    bs = 24
    q = fdtt.generate_banded_bsr_quantized(17, bs, bandwidth=bw, seed=m + bw,
                                           device=dev)
    x = _framed(torch.randn((q.shape[0], m), device=dev).to(torch.bfloat16),
                bw * bs)
    v = None if variant == "nov_bf16" else _framed(
        torch.randn((q.shape[0], mv), device=dev).to(torch.bfloat16), bw * bs,
        cols=3)
    for diag in (q.diag, torch.zeros_like(q.diag)):
        lead = (q.qblocks, q.scale_rows, diag)
        g = _bf16_variant_check(lead, x, v, bw, variant)
        if variant == "tg_bf16deq":
            assert torch.equal(g, kernels.fused_gram_variant(
                "banded_q_bsr_spmm_gram", lead, x, v, bandwidth=bw,
                variant="bf16deq"))


@pytest.mark.parametrize("variant", ["bf16deq", "tg_bf16deq", "nov_bf16"])
@pytest.mark.parametrize("m", [20, 64, 130, 256])
@pytest.mark.parametrize("bw", [1, 2])
def test_bf16_dequant_variants_at_bs_128(cuda_device, variant, m, bw):
    # 33 block rows of bs 128: the slab by the copy engine (bs a multiple
    # of 16), several row tiles a pass, mv = 220.
    dev = cuda_device
    q = fdtt.generate_banded_bsr_quantized(33, 128, bandwidth=bw, seed=m,
                                           device=dev)
    x = torch.randn((q.shape[0], m), device=dev).to(torch.bfloat16)
    v = None if variant == "nov_bf16" else torch.randn(
        (q.shape[0], 220), device=dev).to(torch.bfloat16)
    _bf16_variant_check((q.qblocks, q.scale_rows, q.diag), x, v, bw, variant)


def test_bf16_dequant_variants_at_the_probe_widths(cuda_device):
    # The probe's shape cut to 64 block rows (bs 128, bw 2, m = mv = 256:
    # two column tiles, a cluster of two blocks), contiguous x and v.
    dev = cuda_device
    q = fdtt.generate_banded_bsr_quantized(64, 128, bandwidth=2, seed=3,
                                           device=dev)
    lead = (q.qblocks, q.scale_rows, q.diag)
    x = torch.randn((q.shape[0], 256), device=dev).to(torch.bfloat16)
    v = torch.randn((q.shape[0], 256), device=dev).to(torch.bfloat16)
    for variant in kernels.BF16_VARIANTS:
        _bf16_variant_check(lead, x, None if variant == "nov_bf16" else v, 2,
                            variant)


def test_bf16_dequant_variants_refuse(cuda_device):
    dev = cuda_device
    q = fdtt.generate_banded_bsr_quantized(8, 16, bandwidth=1, device=dev)
    lead = (q.qblocks, q.scale_rows, q.diag)
    x = torch.zeros((q.shape[0], 8), dtype=torch.bfloat16, device=dev)
    call = kernels.fused_gram_variant
    with pytest.raises(NotImplementedError):      # float32 x
        call("banded_q_bsr_spmm_gram", lead, x.float(), x.float(),
             bandwidth=1, variant="bf16deq")
    with pytest.raises(ValueError):               # kernel 3's name
        call("banded_bsr_spmm_gram", (q.qblocks,), x, x, bandwidth=1,
             variant="bf16deq")
    with pytest.raises(ValueError):               # nov_bf16 takes no v
        call("banded_q_bsr_spmm_gram", lead, x, x, bandwidth=1,
             variant="nov_bf16")


def test_edge_rows_never_read_past_the_window(cuda_device):
    # Inf/NaN in x rows that only zero blocks touch must not leak into y.
    op = fdtt.generate_banded_bsr(8, 4, bandwidth=2, seed=2,
                                  device=cuda_device)
    x = torch.randn((op.shape[0], 5), dtype=torch.float64, device=cuda_device)
    y = kernels.banded_bsr_spmm(op.blocks, x, 2)
    assert bool(torch.all(torch.isfinite(y)))
    torch.testing.assert_close(y, op.to_dense() @ x, **_tol(torch.float64))


def test_types_without_a_kernel_raise(cuda_device):
    # A CUDA tensor of a type no kernel takes raises; it never falls back
    # to the plain version.
    dev = cuda_device
    blocks = torch.zeros((4, 2, 6), dtype=torch.float16, device=dev)
    x = torch.zeros((8, 1), dtype=torch.float16, device=dev)
    with pytest.raises(NotImplementedError):
        kernels.banded_bsr_spmm(blocks, x, 1, out_dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        kernels.banded_bsr_spmm(blocks.double(), x.float(), 1)
    with pytest.raises(NotImplementedError):
        kernels.banded_bsr_spmm_gram(blocks.float(), x.float(),
                                     x.double(), bandwidth=1)
    # int8 storage takes float32 and float64 x; float16 x raises.
    q = fdtt.generate_banded_bsr_quantized(4, 2, bandwidth=1, device=dev)
    before = kernels.banded_q_bsr_spmm.launches
    with pytest.raises(NotImplementedError):
        q.matmat(x)
    with pytest.raises(NotImplementedError):
        q.matmat_with_gram(x)
    assert kernels.banded_q_bsr_spmm.launches == before


def test_solver_on_the_card_matches_dense(cuda_device):
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    res = fdtt.eigensolve(op, 3, max_dim_sub=12)
    assert res.converged and kernels.banded_bsr_spmm.launches > before
    want = torch.linalg.eigvalsh(op.to_dense().cpu())[:3]
    torch.testing.assert_close(res.eigenvalues.cpu(), want, rtol=0, atol=1e-9)
    assert res.eigenvectors.device.type == "cuda"


def test_bf16_storage_solve_on_the_card(cuda_device):
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    res = fdtt.eigensolve(op.astype(torch.bfloat16), 3, dtype="float32",
                          relative_tolerance=True, tolerance=1e-3)
    assert res.converged and kernels.banded_bsr_spmm.launches > before
    want = torch.linalg.eigvalsh(op.to_dense().cpu())[:3]
    # bf16 storage perturbs the operator by ~2^-9 of its entries.
    torch.testing.assert_close(res.eigenvalues.cpu().double(), want,
                               rtol=1e-2, atol=0)


def test_fused_engine_on_the_card(cuda_device):
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, seed=0,
                                  dtype=torch.float32, device=cuda_device)
    kw = dict(dtype="float32", expansion="lowest-k", relative_tolerance=True,
              tolerance=1e-4, max_iterations=60, max_dim_sub=8, init_dim=6)
    for A, kernel in ((op, kernels.banded_bsr_spmm_gram),
                      (fdtt.quantize_banded_int8(op),
                       kernels.banded_q_bsr_spmm_gram)):
        before = kernel.launches
        on = fdtt.eigensolve(A, 3, fused_gram="on", **kw)
        assert on.converged and kernel.launches > before
        off = fdtt.eigensolve(A, 3, fused_gram="off", **kw)
        assert abs(on.iterations - off.iterations) <= 2
        torch.testing.assert_close(on.eigenvalues, off.eigenvalues,
                                   rtol=1e-5, atol=0)


def test_float32_eigh_on_the_card_is_accurate(cuda_device):
    # cuSOLVER's float32 eigh loses ~1e-4 of ‖M‖ (3.6e-2 here); the port's
    # eigh takes float32 matrices in float64, to LAPACK's float32 accuracy
    # or better: within 64 eps ‖M‖ of the float64 spectrum.
    from fortran_davidson_tpu_torch.core import orthogonal
    g = torch.Generator().manual_seed(0)
    w = 400
    M = torch.randn((w, w), generator=g, dtype=torch.float64)
    M = M + M.T + torch.diag(torch.arange(w, dtype=torch.float64))
    want = torch.linalg.eigvalsh(M)
    lam, U = orthogonal.eigh(M.float().to(cuda_device))
    assert lam.dtype == U.dtype == torch.float32
    bound = 64 * torch.finfo(torch.float32).eps * float(torch.linalg.norm(M, 2))
    assert float((lam.cpu().double() - want).abs().max()) <= bound


@pytest.mark.parametrize("max_dim_sub", [None, 256])
def test_auto_engine_at_k128_on_the_card(cuda_device, max_dim_sub):
    # The gate's own case on a matrix that expands twice (and with
    # max_dim_sub=256, collapses): "auto" runs kernel 3 and returns pairs
    # whose true relative residual meets the tolerance.
    op = fdtt.generate_banded_bsr(32, 128, bandwidth=1, coupling=3.0, seed=0,
                                  dtype=torch.float32, device=cuda_device)
    before = kernels.banded_bsr_spmm_gram.launches
    res = fdtt.eigensolve(op, 128, dtype="float32", expansion="lowest-k",
                          relative_tolerance=True, tolerance=1e-3,
                          max_dim_sub=max_dim_sub)
    assert res.converged and kernels.banded_bsr_spmm_gram.launches > before
    X, lam = res.eigenvectors.double(), res.eigenvalues.double()
    r = torch.linalg.vector_norm(op.to_dense().double() @ X - X * lam, dim=0)
    assert bool(torch.all(r <= 1e-3 * lam.abs().clamp(min=1.0)))


# -- the halo kernels (6, 7) and the sharded solve --------------------------

def _ring_ext(x, lo, hi, halo):
    """Rows [lo - halo, hi + halo) of x, wrapped around the ring: the
    halo-extended input that the exchange gives the slab [lo, hi)."""
    idx = torch.arange(lo - halo, hi + halo, device=x.device) % x.shape[0]
    return x[idx]


# The widths of kernels 6 and 7's checks: each side of kernel 6's TMA rule
# (m * itemsize a multiple of 16 bytes) in every type.
EXT_WIDTHS = [1, 4, 20, 44, 64, 256]


# The (dtype, bs) -> widths of EXT_WIDTHS that kernel 6 sends down its TMA
# route at 16-byte aligned addresses; every other case takes the cp.async
# route (bs = 24 is no multiple of the row tile, bf16 at bs = 16 none of
# its 32-element chunk).
EXT_TMA = {(torch.float64, 16): {4, 20, 44, 64, 256},
           (torch.float64, 128): {4, 20, 44, 64, 256},
           (torch.float32, 16): {4, 20, 44, 64, 256},
           (torch.float32, 128): {4, 20, 44, 64, 256},
           (torch.bfloat16, 128): {64, 256}}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m", EXT_WIDTHS)
@pytest.mark.parametrize("bw", [1, 2, 3])
@pytest.mark.parametrize("bs", [16, 24, 128])
def test_ext_kernel_matches_plain(cuda_device, dtype, m, bw, bs):
    # 37 block rows (ragged against every tile); x_ext in a buffer framed by
    # NaN rows, so that a read outside it changes the result.
    nbr = 37
    store = torch.float32 if dtype == torch.bfloat16 else dtype
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=7, dtype=store,
                                  device=cuda_device)
    blocks = op.blocks.to(dtype)
    x_ext = _apart(torch.randn(((nbr + 2 * bw) * bs, m),
                               device=cuda_device).to(dtype), bw * bs)
    route = kernels.ext_spmm_route(dtype, bs, m, blocks.data_ptr(),
                                   x_ext.data_ptr())
    assert route == ("tma" if m in EXT_TMA.get((dtype, bs), ()) else
                     "cp.async")
    plan = kernels.ext_spmm_plan(0, dtype, bs, m, route)
    assert plan["threads"] == plan["TM"] * 2 + (32 if route == "tma" else 0)
    # bf16 storage returns the float32 sums (the halo operator's use).
    out = torch.float32 if dtype == torch.bfloat16 else None
    before = kernels.banded_ext_bsr_spmm.launches
    y = kernels.banded_ext_bsr_spmm(blocks, x_ext, bandwidth=bw,
                                    out_dtype=out)
    assert kernels.banded_ext_bsr_spmm.launches == before + 1
    assert y.shape == (nbr * bs, m) and y.dtype == (out or dtype)
    torch.testing.assert_close(
        y, kernels.banded_ext_bsr_spmm_plain(blocks, x_ext, bandwidth=bw,
                                             out_dtype=out),
        **_tol(store))
    # Both routes compute kernel 1's products in kernel 1's order; the TMA
    # route refuses the operands its rule sends elsewhere.
    assert torch.equal(y, kernels.banded_ext_bsr_spmm_at(
        "cp.async", blocks, x_ext, bandwidth=bw, out_dtype=out))
    if route == "tma":
        assert torch.equal(y, kernels.banded_ext_bsr_spmm_at(
            "tma", blocks, x_ext, bandwidth=bw, out_dtype=out))
    else:
        with pytest.raises(ValueError, match="TMA route"):
            kernels.banded_ext_bsr_spmm_at("tma", blocks, x_ext,
                                           bandwidth=bw)
    assert kernels.banded_ext_bsr_spmm.launches == before + 1


@pytest.mark.parametrize("dtype,m", [(torch.float64, 6), (torch.float64, 40),
                                     (torch.float64, 160),
                                     (torch.float32, 40),
                                     (torch.bfloat16, 40),
                                     (torch.bfloat16, 160)])
def test_ext_tma_route_repeats_the_cp_async_bits(cuda_device, dtype, m):
    # A fault of the TMA pipeline (a stage freed while a lane's loads of it
    # are in flight, so that the next TMA write lands under them) shows as
    # a few wrong rows or columns of one warp tile now and then, not on
    # every call: 200 TMA calls, each bit for bit the cp.async route's.
    nbr, bs, bw = 2048, 128, 1
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=3,
                                  device=cuda_device)
    blocks = op.blocks.to(dtype)
    x_ext = torch.randn(((nbr + 2 * bw) * bs, m),
                        device=cuda_device).to(dtype)
    assert kernels.ext_spmm_route(dtype, bs, m, blocks.data_ptr(),
                                  x_ext.data_ptr()) == "tma"
    acc = kernels.acc_dtype(dtype)   # bf16: compare the float32 sums
    want = kernels.banded_ext_bsr_spmm_at("cp.async", blocks, x_ext,
                                          bandwidth=bw, out_dtype=acc)
    bad = sum(not torch.equal(kernels.banded_ext_bsr_spmm_at(
        "tma", blocks, x_ext, bandwidth=bw, out_dtype=acc), want)
        for _ in range(200))
    assert bad == 0


@pytest.mark.parametrize("m", EXT_WIDTHS)
@pytest.mark.parametrize("bw", [1, 2, 3])
@pytest.mark.parametrize("bs", [16, 24, 128])
def test_q_ext_kernel_matches_plain(cuda_device, m, bw, bs):
    nbr = 17
    q = fdtt.generate_banded_bsr_quantized(nbr, bs, bandwidth=bw, seed=8,
                                           device=cuda_device)
    halo = bw * bs
    x_ext = _apart(torch.randn((q.shape[0] + 2 * halo, m),
                               device=cuda_device), halo)
    lead = (q.qblocks, q.scale_rows, q.diag)
    before = kernels.banded_q_ext_bsr_spmm.launches
    y = kernels.banded_q_ext_bsr_spmm(*lead, x_ext, bandwidth=bw)
    assert kernels.banded_q_ext_bsr_spmm.launches == before + 1
    torch.testing.assert_close(
        y, kernels.banded_q_ext_bsr_spmm_plain(*lead, x_ext, bandwidth=bw),
        **_tol(torch.float32))
    # Kernel 4 on the same rows: the tables framed by bw zero block rows
    # (scale 1, diagonal 0) over x_ext applies every slot of the shard's
    # rows, in the same order: the same Y.
    frames = [torch.zeros((bw, *t.shape[1:]), dtype=t.dtype,
                          device=cuda_device) for t in lead]
    frames[1] += 1
    framed = [torch.cat([f, t, f]) for f, t in zip(frames, lead)]
    assert torch.equal(y, kernels.banded_q_bsr_spmm(*framed, x_ext,
                                                    bw)[halo:-halo])


@pytest.mark.parametrize("kind", ["float64", "int8"])
def test_ext_kernels_at_full_size(cuda_device, kind):
    # The sharded solve's matrices at world size 1 (chip_smoke.py phase 8).
    if kind == "int8":
        op = fdtt.generate_banded_bsr_quantized(16384, 128, bandwidth=1,
                                                seed=0, device=cuda_device)
        lead, m = (op.qblocks, op.scale_rows, op.diag), 20
        kernel, plain = (kernels.banded_q_ext_bsr_spmm,
                         kernels.banded_q_ext_bsr_spmm_plain)
        x_ext = torch.randn((op.shape[0] + 256, m), device=cuda_device)
        rel = 1e-5
    else:
        op = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, seed=0,
                                      device=cuda_device)
        lead, m = (op.blocks,), 40
        kernel, plain = (kernels.banded_ext_bsr_spmm,
                         kernels.banded_ext_bsr_spmm_plain)
        x_ext = torch.randn((op.shape[0] + 256, m), dtype=torch.float64,
                            device=cuda_device)
        rel = 1e-12
    y = kernel(*lead, x_ext, bandwidth=1)
    want = plain(*lead, x_ext, bandwidth=1)
    assert float((y - want).abs().max()) <= rel * float(want.abs().max())


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("bw", [1, 2])
def test_four_slabs_match_the_whole_matrix(cuda_device, bw, bs):
    # Four shards on one card: each slab's kernel 6/7 apply on its
    # ring-wrapped x_ext, put together, is kernel 1/4 on the whole matrix,
    # bit for bit: kernel 6 computes kernel 1's products in kernel 1's
    # order (in f64, f32 and bf16 storage, on either route), kernel 7 is
    # kernel 4's apply with the out-of-range slots' +0 added.
    slabs, nbr = 4, 64
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=9,
                                  device=cuda_device)
    q = fdtt.generate_banded_bsr_quantized(nbr, bs, bandwidth=bw, seed=9,
                                           device=cuda_device)
    nl, halo = nbr // slabs, bw * bs
    for m in (20, 40):
        x64 = torch.randn((op.shape[0], m), dtype=torch.float64,
                          device=cuda_device)
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            blocks, x = op.blocks.to(dtype), x64.to(dtype)
            acc = kernels.acc_dtype(dtype)
            parts = [kernels.banded_ext_bsr_spmm(
                blocks[s * nl:(s + 1) * nl],
                _ring_ext(x, s * nl * bs, (s + 1) * nl * bs, halo),
                bandwidth=bw, out_dtype=acc) for s in range(slabs)]
            assert torch.equal(torch.cat(parts), kernels.banded_bsr_spmm(
                blocks, x, bw, out_dtype=acc)), (dtype, m)
        xf = x64.float()
        tables = (q.qblocks, q.scale_rows, q.diag)
        parts = [kernels.banded_q_ext_bsr_spmm(
            *(t[s * nl:(s + 1) * nl] for t in tables),
            _ring_ext(xf, s * nl * bs, (s + 1) * nl * bs, halo), bandwidth=bw)
            for s in range(slabs)]
        assert torch.equal(torch.cat(parts),
                           kernels.banded_q_bsr_spmm(*tables, xf, bw))


def test_sharded_solve_world_size_one_over_nccl(cuda_device, tmp_path):
    # One rank over NCCL runs the same exchange as four: kernels 6 and 7
    # launch, kernels 1 and 4 do not, and the solves match one device's.
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     eigensolve_sharded,
                                                     multihost)
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    q = fdtt.quantize_banded_int8(op.astype(torch.float32))
    loose = dict(dtype="float32", expansion="lowest-k",
                 relative_tolerance=True, tolerance=1e-3)
    single = fdtt.eigensolve(op, 3, max_dim_sub=12)
    single_q = fdtt.eigensolve(q, 3, **loose)
    mesh = multihost.initialize(init_method=f"file://{tmp_path}/rendezvous",
                                world_size=1, rank=0, device=cuda_device)
    try:
        assert dist.get_backend() == "nccl" and mesh.size == 1
        H = HaloBSROperator.from_bsr(op, 1, mesh, backend="pallas")
        assert H.blocks.data_ptr() == op.blocks.data_ptr()
        kernels.reset_launch_counts()
        res = eigensolve_sharded(H, 3, mesh, max_dim_sub=12)
        res_q = eigensolve_sharded(q, 3, mesh, **loose)
        assert kernels.banded_ext_bsr_spmm.launches > 0
        assert kernels.banded_q_ext_bsr_spmm.launches > 0
        assert (kernels.banded_bsr_spmm.launches
                == kernels.banded_q_bsr_spmm.launches == 0)
    finally:
        dist.destroy_process_group()
    assert res.converged and res.iterations == single.iterations
    torch.testing.assert_close(res.eigenvalues, single.eigenvalues, rtol=0,
                               atol=1e-10)
    assert res_q.converged and res_q.iterations == single_q.iterations
    torch.testing.assert_close(res_q.eigenvalues, single_q.eigenvalues,
                               rtol=1e-5, atol=0)


def test_ring_exchange_halo_applies_equal_their_plain_versions(cuda_device):
    # World size 1 (the ring exchange's halos are views of the rank's own
    # rows; a mesh whose group is never called): HaloBSROperator("pallas")
    # launches kernel 6 once and HaloQuantizedOperator kernel 7 once (float32
    # and float64 x), each on the x_ext the exchange builds, equal to the
    # plain versions on the same x_ext.
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     HaloQuantizedOperator,
                                                     RowMesh)
    mesh = RowMesh(group=None, size=1, rank=0, device=cuda_device)
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    q = fdtt.quantize_banded_int8(op.astype(torch.float32))
    halo = op.block_size

    def ext(x):
        return torch.cat([x[-halo:], x, x[:halo]])

    H = HaloBSROperator.from_bsr(op, 1, mesh, backend="pallas")
    x = torch.randn((op.shape[0], 20), dtype=torch.float64,
                    device=cuda_device)
    before = kernels.banded_ext_bsr_spmm.launches
    y = H.matmat(x)
    assert kernels.banded_ext_bsr_spmm.launches == before + 1
    torch.testing.assert_close(y, kernels.banded_ext_bsr_spmm_plain(
        op.blocks, ext(x), bandwidth=1), **_tol(torch.float64))
    hq = HaloQuantizedOperator.from_quantized(q, mesh)
    for dtype in (torch.float32, torch.float64):
        xq = x.to(dtype)
        before = kernels.banded_q_ext_bsr_spmm.launches
        y = hq.matmat(xq)
        assert kernels.banded_q_ext_bsr_spmm.launches == before + 1
        # The int8 apply's sums round to float32 in both.
        torch.testing.assert_close(y, kernels.banded_q_ext_bsr_spmm_plain(
            q.qblocks, q.scale_rows, q.diag, ext(xq), bandwidth=1),
            rtol=1e-5, atol=1e-5)


# -- kernel 8: a shard's rows and its halos through three pointers ----------

def _apart(t, pad: int):
    """``t`` copied into a buffer of its own between ``pad`` NaN rows on
    each side, as a received halo lies apart from the shard's rows: a load
    through the wrong pointer, or past an end, changes the bits."""
    buf = torch.full((t.shape[0] + 2 * pad, t.shape[1]), float("nan"),
                     dtype=t.dtype, device=t.device)
    buf[pad:-pad] = t
    return buf[pad:-pad]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m", [1, 20, 64, 130])
@pytest.mark.parametrize("bw", [1, 3])
def test_remote_kernel_matches_plain_and_kernel_6(cuda_device, dtype, m, bw):
    # 37 block rows (ragged against every tile); the halos and the shard's
    # rows in three buffers. Kernel 6 on their concatenation sees the same
    # values: the same products summed in the same order, the same bits.
    nbr, bs = 37, 16
    store = torch.float32 if dtype == torch.bfloat16 else dtype
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=11, dtype=store,
                                  device=cuda_device)
    blocks, halo = op.blocks.to(dtype), bw * bs
    x_ext = torch.randn(((nbr + 2 * bw) * bs, m),
                        device=cuda_device).to(dtype)
    prev, x, nxt = (_apart(t, halo) for t in
                    (x_ext[:halo], x_ext[halo:-halo], x_ext[-halo:]))
    acc = kernels.acc_dtype(dtype)
    before = kernels.banded_remote_halo_spmm.launches
    y = kernels.banded_remote_halo_spmm(blocks, x, prev, nxt, bandwidth=bw,
                                        out_dtype=acc)
    assert kernels.banded_remote_halo_spmm.launches == before + 2
    assert y.dtype == acc and y.shape == (nbr * bs, m)
    ext = torch.cat([prev, x, nxt])
    # Kernel 1 on the same rows: the slab framed by bw zero block rows on
    # each side, over x_ext, reads every shard row's window unmasked from
    # the same values and sums it in the same order (kernel 8 is kernel 1's
    # template): the same bits in every type.
    frame = torch.zeros((bw, bs, blocks.shape[2]), dtype=dtype,
                        device=cuda_device)
    assert torch.equal(y, kernels.banded_bsr_spmm(
        torch.cat([frame, blocks, frame]), ext, bw,
        out_dtype=acc)[halo:-halo])
    # Kernel 6 is kernel 1's products in kernel 1's order too.
    assert torch.equal(y, kernels.banded_ext_bsr_spmm(
        blocks, ext, bandwidth=bw, out_dtype=acc))
    torch.testing.assert_close(
        y, kernels.banded_remote_halo_spmm_plain(blocks, x, prev, nxt,
                                                 bandwidth=bw, out_dtype=acc),
        **_tol(store))


@pytest.mark.parametrize("nbr,bw", [(5, 3), (4, 2), (3, 3)])
def test_remote_kernel_all_edge_rows(cuda_device, nbr, bw):
    # nbr_l <= 2·bw: no interior launch, one edge launch over every row.
    # (The generator needs nbr >= 2·bw + 1: random slabs stand in, nonzero
    # in every slot.)
    bs, m = 16, 7
    blocks = torch.randn((nbr, bs, (2 * bw + 1) * bs), dtype=torch.float64,
                         device=cuda_device)
    halo = bw * bs
    prev, x, nxt = (_apart(torch.randn((rows, m), dtype=torch.float64,
                                       device=cuda_device), halo)
                    for rows in (halo, nbr * bs, halo))
    before = kernels.banded_remote_halo_spmm.launches
    y = kernels.banded_remote_halo_spmm(blocks, x, prev, nxt, bandwidth=bw)
    assert kernels.banded_remote_halo_spmm.launches == before + 1
    assert torch.equal(y, kernels.banded_ext_bsr_spmm(
        blocks, torch.cat([prev, x, nxt]), bandwidth=bw))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("bs", [16, 128])
def test_four_slabs_through_their_neighbours_rows(cuda_device, dtype, bs):
    # Four shards on one card, each slab's rows in a buffer of its own and
    # its kernel 8 reading its ring neighbours' rows there (no x_ext): put
    # together, kernel 1 on the whole matrix, bit for bit, in every storage
    # type (at the ring's ends the wrapped rows meet zero blocks).
    slabs, nbr, bw = 4, 64, 2
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=9,
                                  device=cuda_device)
    nl, halo = nbr // slabs, bw * bs
    blocks = op.blocks.to(dtype)
    acc = kernels.acc_dtype(dtype)
    x = torch.randn((op.shape[0], 20), dtype=torch.float64,
                    device=cuda_device).to(dtype)
    rows = [_apart(t, halo) for t in x.split(nl * bs)]
    parts = [kernels.banded_remote_halo_spmm(
        blocks[s * nl:(s + 1) * nl], rows[s], rows[s - 1][-halo:],
        rows[(s + 1) % slabs][:halo], bandwidth=bw, out_dtype=acc)
        for s in range(slabs)]
    assert torch.equal(torch.cat(parts),
                       kernels.banded_bsr_spmm(blocks, x, bw, out_dtype=acc))


def test_remote_kernel_refuses_what_it_does_not_take(cuda_device):
    dev = cuda_device
    blocks = torch.zeros((8, 4, 12), dtype=torch.float64, device=dev)
    x = torch.zeros((32, 3), dtype=torch.float64, device=dev)
    halo = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    call = kernels.banded_remote_halo_spmm
    before = call.launches
    with pytest.raises(ValueError, match="from_prev must be"):
        call(blocks, x, halo[:2], halo, bandwidth=1)
    with pytest.raises(ValueError, match="from_next is"):
        call(blocks, x, halo, halo.cpu(), bandwidth=1)
    with pytest.raises(ValueError, match="contiguous"):
        call(blocks, x, halo, torch.zeros((3, 4), dtype=torch.float64,
                                          device=dev).T, bandwidth=1)
    with pytest.raises(NotImplementedError):
        call(blocks.float(), x.float().half(), halo.half(), halo.half(),
             bandwidth=1)
    assert call.launches == before


def test_remote_solve_world_size_one_over_nccl(cuda_device, tmp_path,
                                               monkeypatch):
    # "pallas-remote" at world size 1 takes the push route: kernel 8's one
    # launch a counted apply pushes the halos into the rank's own window,
    # its two-launch form and kernels 1 and 6 never run, no NCCL
    # point-to-point call is made, and the solve is the single-device one.
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     eigensolve_sharded,
                                                     multihost)
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    single = fdtt.eigensolve(op, 3, max_dim_sub=12)
    mesh = multihost.initialize(init_method=f"file://{tmp_path}/rendezvous",
                                world_size=1, rank=0, device=cuda_device)
    applies, p2p = [0], [0]
    matmat = HaloBSROperator.matmat

    def counted(self, block):
        applies[0] += 1
        return matmat(self, block)
    batch = dist.batch_isend_irecv

    def p2p_call(ops):
        p2p[0] += 1
        return batch(ops)
    monkeypatch.setattr(HaloBSROperator, "matmat", counted)
    monkeypatch.setattr(dist, "batch_isend_irecv", p2p_call)
    try:
        assert dist.get_backend() == "nccl" and mesh.size == 1
        H = HaloBSROperator.from_bsr(op, 1, mesh, backend="pallas-remote")
        assert H.route == "push"
        kernels.reset_launch_counts()
        res = eigensolve_sharded(H, 3, mesh, max_dim_sub=12)
        assert applies[0] > 0 and p2p[0] == 0
        assert kernels.banded_remote_push_spmm.launches == applies[0]
        assert (kernels.banded_remote_halo_spmm.launches
                == kernels.banded_bsr_spmm.launches
                == kernels.banded_ext_bsr_spmm.launches == 0)
    finally:
        dist.destroy_process_group()
    assert res.converged and res.iterations == single.iterations
    torch.testing.assert_close(res.eigenvalues, single.eigenvalues, rtol=0,
                               atol=1e-10)


def test_remote_solve_on_the_exchange_route_over_nccl(cuda_device, tmp_path,
                                                      monkeypatch):
    # The "exchange" route, which meshes that span hosts take, run on one
    # card through the operator's own branch (an instance set to it): the
    # ring exchange, then kernel 8's two launches a counted apply, no push,
    # and the solve is the single-device one.
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     eigensolve_sharded,
                                                     multihost)
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    single = fdtt.eigensolve(op, 3, max_dim_sub=12)
    mesh = multihost.initialize(init_method=f"file://{tmp_path}/rendezvous",
                                world_size=1, rank=0, device=cuda_device)
    applies = [0]
    matmat = HaloBSROperator.matmat

    def counted(self, block):
        applies[0] += 1
        return matmat(self, block)
    monkeypatch.setattr(HaloBSROperator, "matmat", counted)
    try:
        H = HaloBSROperator.from_bsr(op, 1, mesh, backend="pallas-remote")
        H.route = "exchange"
        kernels.reset_launch_counts()
        res = eigensolve_sharded(H, 3, mesh, max_dim_sub=12)
        assert applies[0] > 0
        assert kernels.banded_remote_halo_spmm.launches == 2 * applies[0]
        assert (kernels.banded_remote_push_spmm.launches
                == kernels.banded_ext_bsr_spmm.launches == 0)
        assert H._push["window"] is None
    finally:
        dist.destroy_process_group()
    assert res.converged and res.iterations == single.iterations
    torch.testing.assert_close(res.eigenvalues, single.eigenvalues, rtol=0,
                               atol=1e-10)


# -- kernel 8 in one launch: the halos pushed into the window --------------

def _one_rank_window(dev, rows, m, dtype):
    """A world-size-1 mesh's window (cudaMalloc'd, its IPC handle taken; its
    neighbours are the rank itself, so nothing is opened)."""
    from fortran_davidson_tpu_torch.parallel import RowMesh
    mesh = RowMesh(group=None, size=1, rank=0, device=dev)
    return mesh.open_window(kernels.window_slot_bytes(rows, m, dtype))


def _wrapped(x, halo):
    """x_ext of a one-rank ring: the rank's own last and first rows."""
    return torch.cat([x[-halo:], x, x[:halo]])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m", [1, 20, 64, 130])
@pytest.mark.parametrize("bw", [1, 3])
def test_push_kernel_gives_kernel_6s_bits(cuda_device, dtype, m, bw):
    # test_remote_kernel_matches_plain_and_kernel_6's grid (37 block rows,
    # ragged against every tile), at world size 1: the one launch pushes
    # the shard's edge rows into its own window and reads them back as its
    # halos, so kernel 6 on the wrapped x_ext sees the same values: the
    # same bits, on both buffers (epochs 1 and 2).
    nbr, bs = 37, 16
    store = torch.float32 if dtype == torch.bfloat16 else dtype
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=11, dtype=store,
                                  device=cuda_device)
    blocks, halo = op.blocks.to(dtype), bw * bs
    acc = kernels.acc_dtype(dtype)
    window = _one_rank_window(cuda_device, halo, m, dtype)
    before = kernels.banded_remote_push_spmm.launches
    for epoch in (1, 2):
        x = torch.randn((nbr * bs, m), device=cuda_device).to(dtype)
        y = kernels.banded_remote_push_spmm(blocks, x, window, bandwidth=bw,
                                            epoch=epoch, out_dtype=acc)
        assert kernels.banded_remote_push_spmm.launches == before + epoch
        assert y.dtype == acc and y.shape == (nbr * bs, m)
        assert torch.equal(y, kernels.banded_ext_bsr_spmm(
            blocks, _wrapped(x, halo), bandwidth=bw, out_dtype=acc))
        local = kernels.HaloWindow.local(cuda_device, window.slot_bytes)
        torch.testing.assert_close(
            y, kernels.banded_remote_push_spmm_plain(
                blocks, x, local, bandwidth=bw, epoch=1, out_dtype=acc),
            **_tol(store))
    torch.cuda.synchronize()
    window.raise_if_faulted()


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("bs,bw,m", [(256, 5, 480), (128, 9, 530)])
def test_push_kernel_with_more_edge_tiles_than_sms(cuda_device, dtype, bs,
                                                   bw, m):
    # More edge CTAs than the H100's 132 SMs (200 and 162 here): the
    # pushers are the first of them, one an SM at most, and the rest wait
    # for their rows; kernel 6's bits on the wrapped rows, on both buffers.
    nbr = 24
    store = torch.float32 if dtype == torch.bfloat16 else dtype
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=3, dtype=store,
                                  device=cuda_device)
    blocks, halo = op.blocks.to(dtype), bw * bs
    acc = kernels.acc_dtype(dtype)
    window = _one_rank_window(cuda_device, halo, m, dtype)
    for epoch in (1, 2, 3):
        x = torch.randn((nbr * bs, m), device=cuda_device).to(dtype)
        y = kernels.banded_remote_push_spmm(blocks, x, window, bandwidth=bw,
                                            epoch=epoch, out_dtype=acc)
        assert torch.equal(y, kernels.banded_ext_bsr_spmm(
            blocks, _wrapped(x, halo), bandwidth=bw, out_dtype=acc))
    torch.cuda.synchronize()
    window.raise_if_faulted()


def test_push_kernel_over_2000_applies(cuda_device):
    # The reuse race: 2,000 back-to-back applies with x rewritten in place
    # between them, through both buffers in turn, each held bit for bit
    # to kernel 6 on the wrapped rows (the mismatches counted on the card).
    nbr, bs, bw, m = 64, 128, 1, 40
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=4,
                                  device=cuda_device)
    halo = bw * bs
    xs = [torch.randn((nbr * bs, m), dtype=torch.float64, device=cuda_device)
          for _ in range(3)]
    refs = [kernels.banded_ext_bsr_spmm(op.blocks, _wrapped(x, halo),
                                        bandwidth=bw) for x in xs]
    window = _one_rank_window(cuda_device, halo, m, torch.float64)
    x = torch.empty_like(xs[0])
    bad = torch.zeros((), dtype=torch.int64, device=cuda_device)
    before = kernels.banded_remote_push_spmm.launches
    for i in range(2000):
        x.copy_(xs[i % 3])
        y = kernels.banded_remote_push_spmm(op.blocks, x, window,
                                            bandwidth=bw,
                                            epoch=window.next_epoch())
        bad += torch.any(y != refs[i % 3])
    assert int(bad) == 0
    assert kernels.banded_remote_push_spmm.launches == before + 2000
    assert window.epoch == 2000
    window.raise_if_faulted()


_SKIP = """
import sys, time, torch
from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.parallel import RowMesh
from fortran_davidson_tpu_torch.utils.errors import HaloPushFault
dev = torch.device("cuda", 0)
kernels.PUSH_SPIN_LIMIT_NS = 2_000_000_000
mesh = RowMesh(group=None, size=1, rank=0, device=dev)
window = mesh.open_window(kernels.window_slot_bytes(16, 4, torch.float64))
blocks = torch.zeros((8, 16, 48), dtype=torch.float64, device=dev)
x = torch.ones((128, 4), dtype=torch.float64, device=dev)
for epoch in (1, 2):
    kernels.banded_remote_push_spmm(blocks, x, window, bandwidth=1,
                                    epoch=epoch)
torch.cuda.synchronize()
t0 = time.monotonic()
kernels.banded_remote_push_spmm(blocks, x, window, bandwidth=1, epoch=5)
try:
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("sync raised:", str(exc).splitlines()[0])
print(f"waited {time.monotonic() - t0:.2f} s")
try:
    window.raise_if_faulted()
except HaloPushFault as exc:
    print("fault:", exc)
    sys.exit(3)
"""


def test_push_kernel_traps_a_skipped_epoch(cuda_device):
    # Epochs 1, 2, then 5: the pushers wait for the reader's consumed >= 3,
    # which never comes. Within the bound (2 s here) the kernel records
    # rank, epoch and slot in host memory and traps; the window raises with
    # them. A trap loses the CUDA context, so it runs in a process of its
    # own.
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _SKIP], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, (out.stdout, out.stderr[-2000:])
    assert "sync raised" in out.stdout
    assert "rank 0, epoch 5, slot" in out.stdout and "consumed" in out.stdout
    waited = float(out.stdout.split("waited ")[1].split(" s")[0])
    assert 1.9 <= waited <= 30, out.stdout


_SKIP_SOLVE = """
import os, sys, tempfile, torch
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                 eigensolve_sharded,
                                                 multihost)
from fortran_davidson_tpu_torch.utils.errors import HaloPushFault
dev = torch.device("cuda", 0)
kernels.PUSH_SPIN_LIMIT_NS = 1_000_000_000
op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                              device=dev)
mesh = multihost.initialize(
    init_method=f"file://{tempfile.mkdtemp()}/rendezvous", world_size=1,
    rank=0, device=dev)
H = HaloBSROperator.from_bsr(op, 1, mesh, backend="pallas-remote")
step, calls = kernels.HaloWindow.next_epoch, []
def skipping(window):
    e = step(window)
    calls.append(e)
    if len(calls) == 2:
        window.state["epoch"] = e = e + 2
        print(f"skipped to epoch {e}", flush=True)
    return e
kernels.HaloWindow.next_epoch = skipping
try:
    eigensolve_sharded(H, 3, mesh, max_dim_sub=12)
except HaloPushFault as exc:
    print("fault:", exc)
    print("cause:", type(exc.__cause__).__name__)
    sys.stdout.flush()
    os._exit(3)
print("no fault")
"""


def test_push_solve_raises_a_skipped_epoch_by_name(cuda_device):
    # A solve on the push route whose second apply skips an epoch (e + 2
    # for e): its pushers wait for consumed >= e, which never comes, and
    # the kernel traps. The solve raises HaloPushFault with the rank, epoch
    # and slot where the CUDA error surfaces (usually the iteration's
    # synchronisation), unless NCCL's watchdog thread ends the process
    # first on that error; either way the fault watch has written the
    # message to stderr. In a process of its own (the context is lost).
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _SKIP_SOLVE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    both = out.stdout + out.stderr
    assert out.returncode != 0 and "no fault" not in out.stdout, both[-3000:]
    epoch = out.stdout.split("skipped to epoch ")[1].split()[0]
    assert f"halo push: rank 0, epoch {epoch}, slot" in both, both[-3000:]
    assert "the wait for consumed ran out" in both
    if out.returncode == 3:
        assert f"fault: halo push: rank 0, epoch {epoch}" in out.stdout


# -- float64 x on int8 storage (kernels 4, 5, 7) --------------------------

def _q_f64_close(y, yp):
    # The band is summed in float64 in another order, then rounded to
    # float32 as the plain version rounds it: where the two float64 sums
    # straddle a float32 rounding boundary they part by one float32 ulp.
    assert y.dtype == yp.dtype == torch.float64
    assert float((y - yp).abs().max()) <= 2.0 ** -22 * float(yp.abs().max())


def test_float64_solve_on_int8_storage(cuda_device):
    # The default float64 solve on int8 storage runs through the float64
    # int8 kernel (it raised NotImplementedError before that entry), and
    # agrees with the same solve on the CPU. 1e-6: the apply's sums round
    # to float32, as the reference's do, so 1e-8 is out of reach.
    q = fdtt.generate_banded_bsr_quantized(32, 8, bandwidth=1, seed=0,
                                           device=cuda_device)
    before = kernels.banded_q_bsr_spmm.launches
    res = fdtt.eigensolve(q, 3, tolerance=1e-6)
    assert res.converged and res.eigenvalues.dtype == torch.float64
    assert kernels.banded_q_bsr_spmm.launches > before
    q_cpu = fdtt.generate_banded_bsr_quantized(32, 8, bandwidth=1, seed=0,
                                               device="cpu")
    ref = fdtt.eigensolve(q_cpu, 3, tolerance=1e-6)
    assert abs(res.iterations - ref.iterations) <= 1
    torch.testing.assert_close(res.eigenvalues.cpu(), ref.eigenvalues,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("m", [1, 4, 20, 44, 64, 130, 256])
@pytest.mark.parametrize("bw", [1, 2, 3])
def test_int8_kernels_take_float64_x(cuda_device, m, bw):
    dev = cuda_device
    q = fdtt.generate_banded_bsr_quantized(17, 24, bandwidth=bw, seed=7,
                                           device=dev)
    lead = (q.qblocks, q.scale_rows, q.diag)
    halo = bw * 24
    x = _framed(torch.randn((q.shape[0], m), dtype=torch.float64,
                            device=dev), halo)
    y4 = kernels.banded_q_bsr_spmm(*lead, x, bw)
    _q_f64_close(y4, kernels.banded_q_bsr_spmm_plain(*lead, x.clone(), bw))
    for v in (None, torch.randn((q.shape[0], 40), dtype=torch.float64,
                                device=dev)):
        y, g = kernels.banded_q_bsr_spmm_gram(*lead, x, v, bandwidth=bw)
        yp, gp = kernels.banded_q_bsr_spmm_gram_plain(*lead, x.clone(), v,
                                                      bandwidth=bw)
        _q_f64_close(y, yp)
        # Kernel 5's float64-x Y is kernel 4's (the same arithmetic).
        assert torch.equal(y, y4)
        # G sums the float32-valued Y in float64 in another order.
        _assert_gram_close(g, gp, x if v is None else v, yp, rel=1e-6)
    x_ext = _ring_ext(x.clone(), 0, q.shape[0], halo)
    _q_f64_close(kernels.banded_q_ext_bsr_spmm(*lead, x_ext, bandwidth=bw),
                 kernels.banded_q_ext_bsr_spmm_plain(*lead, x_ext,
                                                     bandwidth=bw))


# Kernel 5 with float64 x (csrc/fused_gram_q8f64.cu, the typed template's
# int8 slab): column tiles 8 (m 1, 4), 24 (m 20) and 32 (m 44 on, in
# several tiles: a 64-deep float64 stage at TN = 64 does not fit beside the
# Y tiles); 17 block rows of bs 24 fill no 16-row tile and take the slab by
# cp.async, bs 128 by the copy engine.
Q8_GRAM_WIDTHS = [1, 4, 20, 44, 64, 130, 256]


def _check_q8f64(lead, x, v, bw, clean_x, clean_v):
    """One launch of kernel 5's float64-x entry (counted also in
    f64_launches) against its plain version on clean copies: Y finite and
    kernel 4's Y bit for bit on the same inputs, within 2^-22 of max|Y| of
    the plain version; G within 1e-6 of |V|ᵀ|Y| elementwise; the same bits
    on a second launch, and G alone (write_out=False) the same bits."""
    gram = kernels.banded_q_bsr_spmm_gram
    before = (gram.launches, gram.f64_launches)
    y, g = gram(*lead, x, v, bandwidth=bw)
    assert (gram.launches, gram.f64_launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert bool(torch.all(torch.isfinite(y)))
    assert torch.equal(y, kernels.banded_q_bsr_spmm(*lead, x, bw))
    yp, gp = kernels.banded_q_bsr_spmm_gram_plain(*lead, clean_x, clean_v,
                                                  bandwidth=bw)
    _q_f64_close(y, yp)
    vv = clean_x if clean_v is None else clean_v
    assert g.dtype == torch.float32 and g.shape == (vv.shape[1],
                                                    x.shape[1])
    assert bool(torch.all(torch.isfinite(g)))
    _assert_gram_close(g, gp, vv, yp, rel=1e-6)
    again = gram(*lead, x, v, bandwidth=bw)
    assert torch.equal(again[0], y) and torch.equal(again[1], g)
    assert torch.equal(gram(*lead, x, v, bandwidth=bw, write_out=False), g)


@pytest.mark.parametrize("m", Q8_GRAM_WIDTHS)
@pytest.mark.parametrize("mv", [None, 40, 220])
@pytest.mark.parametrize("bs,bw", [(24, 1), (24, 2), (24, 3), (128, 1),
                                   (128, 2)])
def test_q8f64_gram_kernel(cuda_device, m, mv, bs, bw):
    # x and V inside buffers framed by NaN rows (V also by NaN columns past
    # mv, row stride mv + 3): a read outside the edge windows, past n or
    # past mv brings a NaN into Y or G. On the operator and on its band
    # alone (the diagonal zeroed: with it the band is a small share of Y).
    dev = cuda_device
    q = fdtt.generate_banded_bsr_quantized(17, bs, bandwidth=bw,
                                           seed=m + bs + bw, device=dev)
    n, pad = q.shape[0], bw * bs
    x = torch.randn((n, m), dtype=torch.float64, device=dev)
    v = None if mv is None else torch.randn((n, mv), dtype=torch.float64,
                                            device=dev)
    xf = _framed(x, pad)
    vf = None if v is None else _framed(v, pad, cols=3)
    for diag in (q.diag, torch.zeros_like(q.diag)):
        _check_q8f64((q.qblocks, q.scale_rows, diag), xf, vf, bw, x, v)


@pytest.mark.parametrize("m,mv", [(128, 1408), (64, 1408), (20, 1408)])
def test_q8f64_gram_kernel_at_the_engines_widest(cuda_device, m, mv):
    # The fused engine's widest V (mv = 1408, clusters of 8 blocks) at
    # m <= 128, 33 block rows of bs 128.
    dev = cuda_device
    q = fdtt.generate_banded_bsr_quantized(33, 128, bandwidth=1, seed=m,
                                           device=dev)
    x = torch.randn((q.shape[0], m), dtype=torch.float64, device=dev)
    v = torch.randn((q.shape[0], mv), dtype=torch.float64, device=dev)
    _check_q8f64((q.qblocks, q.scale_rows, q.diag), x, v, 1, x, v)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_q8_gram_kernels_refuse_a_width_past_the_plan(cuda_device, dtype):
    # No layout holds G of mv = 40000 rows: the wrapper raises, naming the
    # entry and the shape, and launches nothing (no fallback).
    dev = cuda_device
    q = fdtt.generate_banded_bsr_quantized(4, 16, bandwidth=1, seed=2,
                                           device=dev)
    lead = (q.qblocks, q.scale_rows, q.diag)
    x = torch.randn((64, 8), device=dev).to(dtype)
    v = torch.randn((64, 40000), device=dev).to(dtype)
    sfx = "bf16" if dtype == torch.bfloat16 else "f64"
    gram = kernels.banded_q_bsr_spmm_gram
    before = gram.launches
    with pytest.raises(RuntimeError, match=f"fdt_fused_gram_q8{sfx}_plan.*"
                       "mv=40000"):
        if dtype == torch.float64:
            gram(*lead, x, v, bandwidth=1)
        else:
            kernels.fused_gram_variant("banded_q_bsr_spmm_gram", lead, x, v,
                                       bandwidth=1, variant="bf16deq")
    assert gram.launches == before


def test_q8_gram_plans_at_the_main_cases(cuda_device):
    # Row 5d's shape (2M rows, bs 128, bw 1, m 20 and 40, mv 220) and rows
    # 10a-c's (the probe: bs 128, bw 2, m = mv = 256): the layouts the
    # wrappers take. At m = 20 one column tile of 24 covers m, so V is read
    # once and no column is padded; at m = 40 two tiles of 32 (a 64-deep
    # float64 stage at TN = 64 does not fit beside the Y tiles).
    plan = kernels.fused_typed_plan(0, torch.float64, 16384, 128, 3, 20, 220,
                                    quant=True)
    assert set(plan) == set(kernels.FUSED_PLAN_KEYS)
    assert plan["TN"] == 24 and plan["C"] * plan["MB"] >= 220
    assert plan["n_groups"] >= 1 and plan["clusters_resident"] >= 1
    plan = kernels.fused_typed_plan(0, torch.float64, 16384, 128, 3, 40, 220,
                                    quant=True)
    assert plan["TN"] == 32 and plan["C"] * plan["MB"] >= 220
    for mv in (256, 1408):
        plan = kernels.fused_typed_plan(0, torch.bfloat16, 4096, 128, 5, 256,
                                        mv, quant=True)
        assert plan["TN"] == 128 and plan["C"] * plan["MB"] >= mv
        assert plan["clusters_resident"] >= 1


# Kernels 4 and 7 with float64 x on kernel 1's template
# (csrc/q_spmm_f64.cu, csrc/q_ext_spmm_f64.cu): column tiles 8 (m 1, 4),
# 24 (m 20, the lowest-20 solve's), 64 (m 44, 64, 256) and 40 (m 130, four
# tiles), on row tiles of 16 (bs 8) and 128 rows (bs 24, 128); 13 block
# rows fill no multiple of a tile.
Q_F64_WIDTHS = [1, 4, 20, 44, 64, 130, 256]


@pytest.mark.parametrize("m", Q_F64_WIDTHS)
@pytest.mark.parametrize("bw", [1, 2, 3])
@pytest.mark.parametrize("bs", [8, 24, 128])
def test_q_f64_kernels_match_plain(cuda_device, bs, bw, m):
    # Against the plain versions within 2**-22 of max|Y| (_q_f64_close), on
    # the operator and on its band alone (the diagonal zeroed, so that a
    # fault in the band is not hidden under d * x). x framed by NaN rows:
    # kernel 4 reads no row outside [0, n), so Y is finite; kernel 7 reads
    # all of x_ext and no row past it. The same bits twice; four slabs of
    # kernel 7, each on its ring-wrapped x_ext, put together give kernel
    # 4's Y bit for bit (its out-of-range slots add +0).
    dev, nbr = cuda_device, 13
    q = fdtt.generate_banded_bsr_quantized(nbr, bs, bandwidth=bw, seed=11,
                                           device=dev)
    n, halo = q.shape[0], bw * bs
    x = _framed(torch.randn((n, m), dtype=torch.float64, device=dev), halo)
    x_ext = _apart(_ring_ext(x, 0, n, halo), halo)
    for diag in (q.diag, torch.zeros_like(q.diag)):
        lead = (q.qblocks, q.scale_rows, diag)
        before = (kernels.banded_q_bsr_spmm.f64_launches,
                  kernels.banded_q_ext_bsr_spmm.f64_launches)
        y4 = kernels.banded_q_bsr_spmm(*lead, x, bw)
        y7 = kernels.banded_q_ext_bsr_spmm(*lead, x_ext, bandwidth=bw)
        assert (kernels.banded_q_bsr_spmm.f64_launches,
                kernels.banded_q_ext_bsr_spmm.f64_launches) == (
                    before[0] + 1, before[1] + 1)
        assert bool(torch.isfinite(y4).all())
        yp = kernels.banded_q_bsr_spmm_plain(*lead, x.clone(), bw)
        _q_f64_close(y4, yp)
        _q_f64_close(y7, kernels.banded_q_ext_bsr_spmm_plain(
            *lead, x_ext.clone(), bandwidth=bw))
        assert torch.equal(y4, kernels.banded_q_bsr_spmm(*lead, x, bw))
        assert torch.equal(y7, kernels.banded_q_ext_bsr_spmm(
            *lead, x_ext, bandwidth=bw))
        cuts = [0, 3, 6, 9, nbr]
        parts = [kernels.banded_q_ext_bsr_spmm(
            *(t[lo:hi] for t in lead),
            _apart(_ring_ext(x, lo * bs, hi * bs, halo), halo), bandwidth=bw)
            for lo, hi in zip(cuts, cuts[1:])]
        assert torch.equal(torch.cat(parts), y4)
        assert torch.equal(y7, y4)
        # Where the two float64 sums round to the same float32 (not held).
        tag = "d" if diag is q.diag else "zero"
        share = float((y4 == yp).double().mean())
        print(f"bs={bs} bw={bw} m={m} diag={tag}: {share:.4f} of Y's bits "
              "equal to the plain version's")


@pytest.mark.parametrize("m", [20, 40])
def test_q_f64_kernels_at_full_size(cuda_device, m):
    # The 2M-row int8 matrix of the solves (chip_smoke.py phases 6 and 8a)
    # at the lowest-20 widths: kernel 4 and kernel 7 (x_ext of one shard at
    # world size 1) against the plain version, and each other bit for bit.
    q = fdtt.generate_banded_bsr_quantized(16384, 128, bandwidth=1, seed=0,
                                           device=cuda_device)
    lead = (q.qblocks, q.scale_rows, q.diag)
    x = torch.randn((q.shape[0], m), dtype=torch.float64, device=cuda_device)
    y4 = kernels.banded_q_bsr_spmm(*lead, x, 1)
    _q_f64_close(y4, kernels.banded_q_bsr_spmm_plain(*lead, x, 1))
    y7 = kernels.banded_q_ext_bsr_spmm(*lead, _ring_ext(x, 0, q.shape[0],
                                                        128), bandwidth=1)
    assert torch.equal(y7, y4)


def test_q_f64_plan(cuda_device):
    # The column tile covers the lowest-20 widths unpadded; the row tile is
    # kernel 1's; two CTAs an SM keep four ring stages at every tile.
    for bs, m, tm, tn in ((8, 1, 16, 8), (128, 20, 128, 24),
                          (128, 40, 128, 40), (24, 44, 128, 64),
                          (128, 130, 128, 40), (128, 256, 128, 64)):
        plan = kernels.q_spmm_f64_plan(0, bs, m)
        assert (plan["TM"], plan["TN"]) == (tm, tn), (bs, m, plan)
        assert plan["stages"] == 4 and plan["smem_bytes"] > 0


# -- kernel 1 (csrc/banded_spmm.cu) and its variants --------------------

def _k1_tol(dtype):
    return 1e-12 if dtype == torch.float64 else 1e-5


def _k1_close(y, yp, dtype):
    assert y.dtype == yp.dtype
    err = float((y.double() - yp.double()).abs().max())
    assert err <= _k1_tol(dtype) * max(float(yp.abs().max()), 1e-300)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 20, 44, 64, 256, 320])
@pytest.mark.parametrize("bw", [1, 2, 3])
@pytest.mark.parametrize("bs", [8, 24, 128])
def test_banded_kernel_matches_plain(cuda_device, dtype, m, bw, bs):
    # nbr = 7: no multiple of any tile; x framed by NaN rows, so a load
    # outside [0, n) brings a NaN into Y.
    dev = cuda_device
    op = fdtt.generate_banded_bsr(7, bs, bandwidth=bw, seed=bs + bw,
                                  device=dev)
    blocks = op.blocks.to(dtype)
    x = _framed(torch.randn((op.shape[0], m), dtype=torch.float64,
                            device=dev).to(dtype), bw * bs)
    acc = kernels.acc_dtype(dtype)
    before = kernels.banded_bsr_spmm.launches
    y = kernels.banded_bsr_spmm(blocks, x, bw, out_dtype=acc)
    assert kernels.banded_bsr_spmm.launches == before + 1
    assert bool(torch.all(torch.isfinite(y)))
    _k1_close(y, kernels.banded_bsr_spmm_plain(blocks, x.clone(), bw,
                                               out_dtype=acc), dtype)
    assert torch.equal(y, kernels.banded_bsr_spmm(blocks, x, bw,
                                                  out_dtype=acc))


_VARIANT_CASES = [
    dict(variant="noy"), dict(variant="copy"), dict(variant="writeonly"),
    dict(variant="full", rows_per_cta=2), dict(variant="full", rows_per_cta=4),
    dict(variant="full", stages=2), dict(variant="full", stages=3),
    dict(variant="full", stages=6), dict(variant="full", store="tma"),
    dict(variant="full", block_policy="evict_first"),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 20, 48, 256])
@pytest.mark.parametrize("case", _VARIANT_CASES,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_banded_variants_match_plain(cuda_device, dtype, m, case):
    dev = cuda_device
    bs, bw = 128, 2
    op = fdtt.generate_banded_bsr(11, bs, bandwidth=bw, seed=4, device=dev)
    blocks = op.blocks.to(dtype)
    x = _framed(torch.randn((op.shape[0], m), dtype=torch.float64,
                            device=dev).to(dtype), bw * bs)
    if (case.get("store") == "tma"
            and m * kernels.acc_dtype(dtype).itemsize % 16):
        with pytest.raises(ValueError):
            kernels.banded_spmm_variant(blocks, x, bw, **case)
        return
    before = (kernels.banded_bsr_spmm.launches,
              kernels.banded_spmm_variant.launches,
              kernels.banded_spmm_variant.copy_launches)
    y = kernels.banded_spmm_variant(blocks, x, bw, **case)
    copy = int(case["variant"] == "copy")
    assert (kernels.banded_bsr_spmm.launches,
            kernels.banded_spmm_variant.launches,
            kernels.banded_spmm_variant.copy_launches) == (
                before[0], before[1] + 1, before[2] + copy)
    plan = kernels.banded_spmm_plan(
        dev.index or 0, dtype, bs, m, case["variant"],
        case.get("rows_per_cta", 1), case.get("store", "direct"),
        case.get("stages"))
    yp = kernels.banded_spmm_variant_plain(blocks, x.clone(), bw,
                                           variant=case["variant"],
                                           row_tile=plan["TM"])
    assert y.shape == yp.shape
    _k1_close(y, yp, dtype)
    assert torch.equal(y, kernels.banded_spmm_variant(blocks, x, bw, **case))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("bs,bw", [(8, 1), (24, 3), (128, 1)])
@pytest.mark.parametrize("m", [1, 20, 256])
def test_copy_variant_every_type(cuda_device, dtype, bs, bw, m):
    dev = cuda_device
    op = fdtt.generate_banded_bsr(9, bs, bandwidth=bw, seed=8, device=dev)
    blocks = op.blocks.to(dtype)
    x = _framed(torch.randn((op.shape[0], m), dtype=torch.float64,
                            device=dev).to(dtype), bw * bs)
    y = kernels.banded_spmm_variant(blocks, x, bw, variant="copy")
    _k1_close(y, kernels.banded_spmm_variant_plain(blocks, x.clone(), bw,
                                                   variant="copy"), dtype)


def test_writeonly_into_x(cuda_device):
    dev = cuda_device
    op = fdtt.generate_banded_bsr(6, 128, bandwidth=1, seed=1, device=dev)
    x = torch.randn((op.shape[0], 48), dtype=torch.float64, device=dev)
    want = kernels.banded_spmm_variant_plain(op.blocks, x, 1,
                                             variant="writeonly")
    out = kernels.banded_spmm_variant(op.blocks, x, 1, variant="writeonly",
                                      out=x)
    assert out is x and torch.equal(x, want)


def test_banded_variant_refusals(cuda_device):
    dev = cuda_device
    op = fdtt.generate_banded_bsr(6, 128, bandwidth=1, seed=1, device=dev)
    x = torch.randn((op.shape[0], 8), dtype=torch.float64, device=dev)
    for kw, err in ((dict(variant="noy", rows_per_cta=2), ValueError),
                    (dict(variant="full", rows_per_cta=2, store="tma"),
                     ValueError),
                    (dict(variant="full", stages=9), ValueError),
                    (dict(variant="bogus"), ValueError)):
        with pytest.raises(err):
            kernels.banded_spmm_variant(op.blocks, x, 1, **kw)
    with pytest.raises(NotImplementedError):
        kernels.banded_spmm_variant(op.blocks.float(), x.float(), 1,
                                    variant="noy")
    small = fdtt.generate_banded_bsr(6, 8, bandwidth=1, seed=1, device=dev)
    with pytest.raises(NotImplementedError):
        kernels.banded_spmm_variant(small.blocks, x[:48], 1, variant="noy")


def test_banded_plan(cuda_device):
    # The layout the launches take, as the header decides it: a row tile of
    # 16 or 128, kernel 1's column tile covering m, a default ring of 2-4
    # stages, and a deeper ring asking for more shared memory.
    idx = cuda_device.index or 0
    for bs, tm in ((8, 16), (16, 16), (24, 128), (128, 128)):
        for m, tn in ((1, 8), (6, 8), (12, 16), (24, 32), (48, 48), (64, 64),
                      (320, 64)):
            plan = kernels.banded_spmm_plan(idx, torch.float64, bs, m)
            assert (plan["TM"], plan["TN"]) == (tm, tn)
            assert 2 <= plan["stages"] <= 4 and plan["smem_bytes"] > 0
    four = kernels.banded_spmm_plan(idx, torch.float64, 128, 48, "full",
                                    stages=4)
    six = kernels.banded_spmm_plan(idx, torch.float64, 128, 48, "full",
                                   stages=6)
    assert six["stages"] == 6 and six["smem_bytes"] == four["smem_bytes"] * 6 / 4
    assert kernels.banded_spmm_plan(idx, torch.bfloat16, 128, 256,
                                    "writeonly")["smem_bytes"] == 0
    with pytest.raises(RuntimeError):
        kernels.banded_spmm_plan(idx, torch.float64, 128, 48, "full",
                                 stages=9)


# -- kernel 2, the general block-ELL SpMM, on kernel 1's template ---------

_GENERAL_WIDTHS = (1, 4, 20, 44, 64, 256)


def _general_table(kind, nbr, bs, K, seed):
    """(cols, blocks, nbc) in numpy float64, with K slots a block row:
    "banded", the clipped DIA table of bandwidth (K - 1) // 2 padded with
    zero-block slots at column r (as ``from_block_coo`` pads); "scrambled",
    random columns of nbr + 3 block columns and random blocks; "coo",
    ``BSROperator.from_block_coo`` of 1 to K random distinct columns a
    row."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "banded":
        bw = (K - 1) // 2
        op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=seed,
                                      device="cpu")
        pad = K - (2 * bw + 1)
        cols = np.concatenate([op.block_cols.numpy(), np.tile(
            np.arange(nbr, dtype=np.int32)[:, None], (1, pad))], axis=1)
        blocks = np.concatenate([op.blocks.numpy(),
                                 np.zeros((nbr, bs, pad * bs))], axis=2)
        return cols, blocks, nbr
    if kind == "scrambled":
        nbc = nbr + 3
        return (rng.integers(0, nbc, (nbr, K)).astype(np.int32),
                rng.standard_normal((nbr, bs, K * bs)), nbc)
    brows, bcols = [], []
    for r in range(nbr):
        c = rng.choice(nbr, int(rng.integers(1, K + 1)), replace=False)
        brows += [r] * len(c)
        bcols += c.tolist()
    op = fdtt.BSROperator.from_block_coo(
        brows, bcols, rng.standard_normal((len(brows), bs, bs)), nbr,
        pad_width=K, device="cpu")
    return op.block_cols.numpy(), op.blocks.numpy(), nbr


def _general_on(dev, cols, blocks, dtype):
    return (torch.from_numpy(cols).to(dev),
            torch.from_numpy(blocks).to(device=dev, dtype=dtype))


def _general_rel(y, yp):
    assert y.dtype == yp.dtype
    err = float((y.double() - yp.double()).abs().max())
    return err / max(float(yp.double().abs().max()), 1e-300)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16, 24, 128])
@pytest.mark.parametrize("K", [1, 3, 4, 12])
@pytest.mark.parametrize("kind", ["banded", "scrambled", "coo"])
def test_general_kernel_matches_plain(cuda_device, dtype, bs, K, kind):
    # 13 block rows: no row count a multiple of the 128-row tile. Limits
    # as chip_smoke.py's: 1e-12 of max|Y| in float64 (the same products
    # summed in another order), 1e-5 in float32 and with bf16 storage
    # (summed in float32 by both).
    cols, blocks, nbc = _general_table(kind, 13, bs, K, seed=bs + K)
    c, b = _general_on(cuda_device, cols, blocks, dtype)
    acc = kernels.acc_dtype(dtype)
    limit = 1e-12 if dtype == torch.float64 else 1e-5
    for m in _GENERAL_WIDTHS:
        x = torch.randn((nbc * bs, m), dtype=torch.float64,
                        device=cuda_device).to(dtype)
        before = kernels.bsr_spmm.launches
        y = kernels.bsr_spmm(c, b, x, out_dtype=acc)
        assert kernels.bsr_spmm.launches == before + 1
        assert _general_rel(y, kernels.bsr_spmm_plain(c, b, x, acc)) <= limit
        assert torch.equal(y, kernels.bsr_spmm(c, b, x, out_dtype=acc))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("bw", [0, 1, 2, 3])
@pytest.mark.parametrize("bs", [8, 24, 128])
def test_general_kernel_on_the_dia_table_gives_kernel_1s_bits(
        cuda_device, dtype, bw, bs):
    # cols[r, k] = r - bw + k, out-of-range columns included: every stage
    # holds kernel 1's bytes, so Y is kernel 1's bit for bit.
    op = fdtt.generate_banded_bsr(11, bs, bandwidth=bw, seed=bs + bw,
                                  device=cuda_device)
    K = 2 * bw + 1
    dia = (torch.arange(11, device=cuda_device)[:, None] - bw
           + torch.arange(K, device=cuda_device)[None, :]).to(torch.int32)
    blocks = op.blocks.to(dtype)
    acc = kernels.acc_dtype(dtype)
    for m in (1, 20, 48, 256):
        x = torch.randn((op.shape[0], m), dtype=torch.float64,
                        device=cuda_device).to(dtype)
        assert torch.equal(
            kernels.bsr_spmm(dia, blocks, x, out_dtype=acc),
            kernels.banded_bsr_spmm(blocks, x, bw, out_dtype=acc))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_general_kernel_reads_zeros_outside_the_columns(cuda_device, dtype):
    # Slots whose column lies outside [0, nbc) add nothing: the same Y as
    # those slots with zero blocks at column 0, bit for bit (0 * x and
    # a * 0 are both zeros), and the plain version's within the limit.
    import numpy as np
    cols, blocks, nbc = _general_table("scrambled", 13, 24, 4, seed=5)
    bad = [-1, -(nbc + 5), nbc, nbc + 9, 2**31 - 1, -2**31]
    where = [(r, r % 4) for r in range(0, 13, 2)]
    for i, (r, k) in enumerate(where):
        cols[r, k] = bad[i % len(bad)]
    safe_cols, zeroed = cols.copy(), blocks.copy()
    for r, k in where:
        safe_cols[r, k] = 0
        zeroed[r, :, k * 24:(k + 1) * 24] = 0.0
    c, b = _general_on(cuda_device, cols, blocks, dtype)
    cs, bz = _general_on(cuda_device, safe_cols, zeroed, dtype)
    assert np.all(safe_cols >= 0)
    acc = kernels.acc_dtype(dtype)
    for m in (1, 20, 256):
        x = torch.randn((nbc * 24, m), dtype=torch.float64,
                        device=cuda_device).to(dtype)
        y = kernels.bsr_spmm(c, b, x, out_dtype=acc)
        assert torch.equal(y, kernels.bsr_spmm(cs, bz, x, out_dtype=acc))
        assert _general_rel(y, kernels.bsr_spmm_plain(cs, bz, x, acc)) <= (
            1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 128])
def test_general_kernel_never_reads_unnamed_rows(cuda_device, dtype, bs):
    # NaN in every x row of a block column that no slot names (inside the
    # table's range and past it): Y is finite and equal to the kernel's on
    # x with those rows zeroed.
    import numpy as np
    rng = np.random.default_rng(bs)
    nbr, K, nbc = 13, 3, 20
    cols = rng.choice(np.arange(0, nbc, 2), (nbr, K)).astype(np.int32)
    c, b = _general_on(cuda_device, cols,
                       rng.standard_normal((nbr, bs, K * bs)), dtype)
    unnamed = torch.ones(nbc, dtype=torch.bool, device=cuda_device)
    unnamed[c.long().flatten()] = False
    rows = unnamed.repeat_interleave(bs)
    acc = kernels.acc_dtype(dtype)
    for m in (1, 20, 256):
        x = torch.randn((nbc * bs, m), dtype=torch.float64,
                        device=cuda_device).to(dtype)
        x[rows] = 0
        want = kernels.bsr_spmm(c, b, x, out_dtype=acc)
        x[rows] = float("nan")
        y = kernels.bsr_spmm(c, b, x, out_dtype=acc)
        assert bool(torch.isfinite(y).all()) and torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["banded", "coo"])
def test_general_kernel_on_a_block_permuted_table(cuda_device, dtype, kind):
    # P A Pᵀ applied to P x is P (A x), bit for bit: block row p[r] stages
    # row r's slabs and the same x slices in the same order.
    cols, blocks, nbc = _general_table(kind, 13, 24, 4, seed=7)
    c, b = _general_on(cuda_device, cols, blocks, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    p = torch.randperm(13, generator=gen, device=cuda_device)
    pc, pb = torch.empty_like(c), torch.empty_like(b)
    pc[p] = p[c.long()].to(torch.int32)
    pb[p] = b
    acc = kernels.acc_dtype(dtype)
    for m in (1, 20, 256):
        x = torch.randn((nbc * 24, m), dtype=torch.float64,
                        device=cuda_device).to(dtype)
        px = torch.empty_like(x).reshape(13, 24, m)
        px[p] = x.reshape(13, 24, m)
        y = kernels.bsr_spmm(c, b, x, out_dtype=acc).reshape(13, 24, m)
        py = kernels.bsr_spmm(pc, pb, px.reshape(-1, m), out_dtype=acc)
        assert torch.equal(py.reshape(13, 24, m)[p], y)


# -- the double-single path and GJD on the card --------------------------

def _exact_pairs(n, lo_exp, hi_exp, seed):
    """float32 pairs (a, b): |a| = m 2**e with m in [1, 2) and e drawn
    from [lo_exp, hi_exp), b within 2**±20 of a, random signs; a + b and
    a * b are then exact in float64."""
    g = torch.Generator().manual_seed(seed)

    def draw(e):
        sign = torch.randint(0, 2, (n,), generator=g).double() * 2 - 1
        return (sign * (1 + torch.rand(n, generator=g, dtype=torch.float64))
                * torch.exp2(e)).float()

    e = torch.randint(lo_exp, hi_exp, (n,), generator=g).double()
    return draw(e), draw(e + torch.randint(-20, 20, (n,), generator=g))


def test_error_free_transforms_exact_on_the_card(cuda_device):
    """two_sum and two_prod on the card: exact against float64, and the
    CPU's bits (eager kernels, one rounding each, no FMA contraction)."""
    from fortran_davidson_tpu_torch.utils import ds
    for fn, (lo_exp, hi_exp), exact in (
            (ds.two_sum, (-100, 100), lambda a, b: a + b),
            (ds.two_prod, (-40, 25), lambda a, b: a * b)):
        a, b = _exact_pairs(200_000, lo_exp, hi_exp, seed=1)
        s, e = fn(a.to(cuda_device), b.to(cuda_device))
        got = s.double() + e.double()
        assert bool(torch.all(got.cpu() == exact(a.double(), b.double())))
        s_cpu, e_cpu = fn(a, b)
        assert torch.equal(s.cpu(), s_cpu) and torch.equal(e.cpu(), e_cpu)


@pytest.mark.parametrize("kind", ["bsr", "general", "int8_offdiag",
                                  "int8_full"])
def test_matmat_ds_on_the_card(cuda_device, kind):
    """The compensated apply on the card against a float64 oracle of the
    same stored matrix (the bounds of tests/test_ds_apply_sparse.py). With
    the exact diagonal (int8_full) it stays two orders below the float32
    apply of both words, whose products of the diagonal round at
    eps*|d x|. On a band alone the DS apply's only error is each slot's
    float32 sum, the same order as the kernels' own float32 sums, so
    there it is held to the bound alone."""
    base = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=1e-3,
                                    dtype=torch.float32, device=cuda_device)
    if kind == "bsr":
        op = base.offdiag()
    elif kind == "general":
        op = fdtt.BSROperator(base.block_cols, base.offdiag().blocks)
    else:
        op = fdtt.quantize_banded_int8(base)
        op = op.offdiag() if kind == "int8_offdiag" else op
    A64 = op.to_dense().double()
    g = torch.Generator(device=cuda_device).manual_seed(2)
    xh = torch.randn((op.shape[0], 4), generator=g, device=cuda_device)
    xh = xh / torch.linalg.vector_norm(xh, dim=0)
    xl = torch.randn((op.shape[0], 4), generator=g, device=cuda_device) * 1e-8
    y64 = A64 @ (xh.double() + xl.double())
    yh, yl = op.matmat_ds(xh, xl)
    err_ds = torch.linalg.vector_norm(yh.double() + yl.double() - y64, dim=0)
    yf = op.matmat(xh).double() + op.matmat(xl).double()
    err_f32 = torch.linalg.vector_norm(yf - y64, dim=0)
    if kind == "int8_full":
        assert float(err_ds.max()) < 1e-9
        assert float(err_ds.max()) < float(err_f32.max()) / 100
    else:
        assert float(err_ds.max()) < 5e-10


def _card_and_cpu(solve):
    return solve(torch.device("cuda")), solve(torch.device("cpu"))


@pytest.mark.parametrize("kw", [
    dict(method="GJD"),
    dict(method="GJD", gjd_preconditioner="dpr", gjd_warm_start=True),
    dict(method="GJD", gjd_preconditioner="olsen", expansion="lowest-k")])
def test_gjd_solve_on_the_card_equals_the_cpu(cuda_device, kw):
    def solve(dev):
        A = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=1e-3,
                                     seed=0, device=dev)
        return fdtt.eigensolve(A, 3, tolerance=1e-9, **kw)
    card, cpu = _card_and_cpu(solve)
    assert card.converged and cpu.converged
    assert abs(card.iterations - cpu.iterations) <= 1
    assert card.inner_iterations > 0
    torch.testing.assert_close(card.eigenvalues.cpu(), cpu.eigenvalues,
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("op_kind", ["int8", "surrogate"])
def test_refined_solve_on_the_card_equals_the_cpu(cuda_device, op_kind):
    def solve(dev):
        if op_kind == "int8":
            A = fdtt.generate_banded_bsr_quantized(256, 16, bandwidth=1,
                                                   coupling=1e-3, seed=0,
                                                   device=dev)
        else:
            from fortran_davidson_tpu_torch.models import generators
            A = generators.surrogate_hamiltonian(4096, dtype=torch.float32,
                                                 device=dev)
        return fdtt.eigensolve(A, 4, dtype="float32", tolerance=1e-8,
                               relative_tolerance=True, expansion="lowest-k",
                               refined=True, final_polish=3,
                               max_iterations=60)
    card, cpu = _card_and_cpu(solve)
    assert card.converged and cpu.converged
    assert abs(card.iterations - cpu.iterations) <= 1
    assert float(card.residual_norms.max()) < 1e-8
    lam_card = card.eigenvalues.double() + card.eigenvalues_lo.double()
    lam_cpu = cpu.eigenvalues.double() + cpu.eigenvalues_lo.double()
    tol = float(card.residual_norms.max() + cpu.residual_norms.max())
    assert float((lam_card.cpu() - lam_cpu).abs().max()) <= max(tol, 1e-12)


def test_polish_eigenpairs_on_the_card(cuda_device):
    A = fdtt.generate_banded_bsr_quantized(256, 16, bandwidth=1,
                                           coupling=1e-3, seed=0,
                                           device=cuda_device)
    res = fdtt.eigensolve(A, 4, dtype="float32", tolerance=1e-4,
                          relative_tolerance=True, expansion="lowest-k")
    before = kernels.banded_q_bsr_spmm.launches
    pol = fdtt.polish_eigenpairs(A, res, iterations=3)
    assert pol.evecs_hi.is_cuda and pol.evecs_hi.dtype == torch.float32
    A64 = A.to_dense().double()
    x = pol.evecs_hi.double() + pol.evecs_lo.double()
    x = x / torch.linalg.vector_norm(x, dim=0)
    lam = pol.evals.double() + pol.evals_lo.double()
    r = torch.linalg.vector_norm(A64 @ x - x * lam[None, :], dim=0)
    assert float(r.max()) < 1e-8
    # The polish applies the off-diagonal words through matmat_ds (plain
    # PyTorch), not kernel 4.
    assert kernels.banded_q_bsr_spmm.launches == before


# -- the ELL family ------------------------------------------------------

def _local_coo(dtype=torch.float64):
    return fdtt.generate_local_sparse(3000, 12, locality=95.0, seed=7,
                                      dtype=dtype)


# The seeds of x in the ELL family's card-against-CPU check.
ELL_SEEDS = range(50)


def _ds_apply_bound(op, x_hi, x_lo):
    """Elementwise limit on |card - CPU| of ``op.matmat_ds`` (hi + lo in
    float64), from the slot-accumulation bound of
    ``BSROperator.matmat_ds`` (``ops/sparse.py``), which ELL's chunk
    combine shares: the pieces' partials combine exactly (``two_sum``), so
    each apply errs by its pieces' own accumulation roundings only. A
    piece of ``L`` terms (a band slot's (bs, bs) @ (bs, m) product, L =
    bs; an ELL chunk, L = chunk) summed in any order errs by at most
    γ_L · (|A_piece| |x|), γ_L = L·u / (1 - L·u), u = eps/2 (Higham,
    Accuracy and Stability, Thm 3.1 and §3.1's dot products), on the hi
    and on the lo words. Card and CPU each err so, in their own order:

        limit = 2 · Σ_pieces γ_L · (|A_piece| (|x_hi| + |x_lo|))

    with |A_piece| from the operator's own blocks and slot tables. The
    error channel's own additions round at u · |lo| ~ u² · |y|, below the
    float64 sum's resolution: they are left out."""
    u = torch.finfo(x_hi.dtype).eps / 2

    def gamma(length: int) -> float:
        return length * u / (1 - length * u)

    ax = x_hi.abs().double().cpu() + x_lo.abs().double().cpu()
    if isinstance(op, fdtt.HybridBandedOperator):
        parts = [(op.band, op.band.block_size)]
        if op.remainder is not None:
            parts.append((op.remainder, op.remainder.chunk))
    else:
        parts = [(op, op.chunk)]
    return 2 * sum(gamma(length) * (p.to_dense().abs().double().cpu() @ ax)
                   for p, length in parts)


@pytest.mark.parametrize("seed", ELL_SEEDS)
@pytest.mark.parametrize("kind", ["ell", "sell", "hybrid_sell", "hybrid_ell"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ell_family_apply_on_the_card_equals_the_cpu(cuda_device, kind,
                                                     dtype, seed):
    # The ELL gathers are plain PyTorch on either device (the same
    # products, summed in another order on the card); the hybrid's band
    # goes through kernel 1 on the card, its plain version on the CPU.
    # x is seeded; the double-single apply is held elementwise to the
    # slot-accumulation bound (_ds_apply_bound).
    rows, cols, vals = _local_coo(dtype)

    def build(dev):
        if kind.startswith("hybrid"):
            return fdtt.split_band_remainder(
                rows, cols, vals, 3000, block_size=128, bandwidth=1,
                dtype=dtype, remainder_format=kind.split("_")[1], device=dev)
        cls = fdtt.ELLOperator if kind == "ell" else fdtt.SlicedELLOperator
        return cls.from_coo(rows, cols, vals, 3000, dtype=dtype, device=dev)
    card, cpu = build(cuda_device), build("cpu")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((cpu.shape[0], 20), dtype=dtype, generator=gen)
    before = kernels.banded_bsr_spmm.launches
    y = card.matmat(x.to(cuda_device))
    assert (kernels.banded_bsr_spmm.launches - before
            == (1 if kind.startswith("hybrid") else 0))
    torch.testing.assert_close(y.cpu(), cpu.matmat(x), **_tol(dtype))
    torch.testing.assert_close(card.diagonal().cpu(), cpu.diagonal(),
                               rtol=0, atol=0)
    if dtype == torch.float32:
        assert not torch.backends.cuda.matmul.allow_tf32
        xh, xl = x, x * 1e-8
        h, lo = card.offdiag().matmat_ds(xh.to(cuda_device),
                                         xl.to(cuda_device))
        ch, cl = cpu.offdiag().matmat_ds(xh, xl)
        got = h.double().cpu() + lo.double().cpu()
        diff = (got - (ch.double() + cl.double())).abs()
        assert bool(torch.all(diff <= _ds_apply_bound(cpu.offdiag(), xh,
                                                      xl))), float(diff.max())


def test_hybrid_solve_on_the_card_runs_kernel_1_and_equals_the_plain_path(
        cuda_device):
    rows, cols, vals = _local_coo()
    hyb = fdtt.split_band_remainder(rows, cols, vals, 3000, block_size=128,
                                    bandwidth=1, device=cuda_device)
    band = hyb.band
    plain = fdtt.MatrixFreeOperator(
        lambda X: (kernels.banded_bsr_spmm_plain(band.blocks, X.contiguous(),
                                                 1)
                   + hyb.remainder.matmat(X)),
        hyb.shape[0], dtype=hyb.dtype, diag=hyb.diagonal(),
        device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    res = fdtt.eigensolve(hyb, 4, tolerance=1e-8)
    launches = kernels.banded_bsr_spmm.launches - before
    ref = fdtt.eigensolve(plain, 4, tolerance=1e-8)
    assert kernels.banded_bsr_spmm.launches - before == launches > 0
    assert res.converged and ref.converged
    assert res.iterations == ref.iterations
    torch.testing.assert_close(res.eigenvalues, ref.eigenvalues, rtol=1e-10,
                               atol=0)
    cpu = fdtt.eigensolve(fdtt.split_band_remainder(
        rows, cols, vals, 3000, block_size=128, bandwidth=1, device="cpu"),
        4, tolerance=1e-8)
    assert abs(cpu.iterations - res.iterations) <= 1
    torch.testing.assert_close(res.eigenvalues.cpu(), cpu.eigenvalues,
                               rtol=1e-10, atol=0)
    # No padded pair (the padded diagonal sits above the spectrum).
    assert float(res.eigenvalues.max()) < float(hyb.diagonal()[-1])


def test_scipy_csr_solve_on_the_card(cuda_device):
    import scipy.sparse as sp
    from fortran_davidson_tpu_torch.ops.sparse import \
        sparse_diagonal_dominant_coo
    rows, cols, vals = sparse_diagonal_dominant_coo(4000, 20, seed=0)
    csr = sp.csr_matrix((vals, (rows, cols)), shape=(4000, 4000))
    res = fdtt.eigensolve(csr, 4)
    assert res.converged and res.eigenvectors.is_cuda
    cpu = fdtt.eigensolve(fdtt.as_operator(csr, device="cpu"), 4)
    assert abs(cpu.iterations - res.iterations) <= 1
    torch.testing.assert_close(res.eigenvalues.cpu(), cpu.eigenvalues,
                               rtol=1e-10, atol=0)


# -- Chebyshev restarts, locking, matmul_precision, eigsh, batched -----------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nbr,bs", [(8192, 128), (37, 16), (5, 24)])
def test_kernel_1_at_one_column(cuda_device, dtype, nbr, bs):
    # The Lanczos bound applies A to one column (m = 1), on the full-size
    # table too; x a view of a vector, as the bound hands it over.
    op = fdtt.generate_banded_bsr(nbr, bs, bandwidth=1, coupling=1e-3,
                                  seed=0, dtype=dtype, device=cuda_device)
    v = torch.randn((op.shape[0],), dtype=dtype, device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    y = op.matmat(v[:, None])
    assert kernels.banded_bsr_spmm.launches == before + 1
    assert y.shape == (op.shape[0], 1)
    torch.testing.assert_close(
        y, kernels.banded_bsr_spmm_plain(op.blocks, v[:, None], 1),
        **_tol(dtype))


def _plain_banded(op):
    return fdtt.MatrixFreeOperator(
        lambda X: kernels.banded_bsr_spmm_plain(op.blocks, X.contiguous(),
                                                op.bandwidth),
        op.shape[0], dtype=op.dtype, diag=op.diagonal(), device=op.device)


def test_filter_and_bound_through_kernel_1(cuda_device):
    from fortran_davidson_tpu_torch.core import chebyshev
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    plain = _plain_banded(op)
    X = torch.randn((op.shape[0], 6), dtype=torch.float64,
                    device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    y = chebyshev.chebyshev_filter(op.matmat, X, 8, 1.2, 64.0, 0.9)
    assert kernels.banded_bsr_spmm.launches == before + 8
    want = chebyshev.chebyshev_filter(plain.matmat, X, 8, 1.2, 64.0, 0.9)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    ub = chebyshev.lanczos_upper_bound(op.matmat, op.shape[0], torch.float64,
                                       device=cuda_device)
    ub_cpu = chebyshev.lanczos_upper_bound(
        _plain_banded(fdtt.generate_banded_bsr(
            64, 16, bandwidth=1, coupling=0.1, seed=0, device="cpu")).matmat,
        op.shape[0], torch.float64)
    assert abs(float(ub) - float(ub_cpu)) <= 1e-10 * abs(float(ub_cpu))
    assert float(ub) >= float(torch.linalg.eigvalsh(op.to_dense().cpu())[-1])


@pytest.mark.parametrize("cheb", [8, "auto"])
def test_filtered_and_locked_solves_on_the_card(cuda_device, cheb):
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    kw = dict(expansion="lowest-k", max_dim_sub=12, cheb_degree=cheb,
              locking=True)
    res = fdtt.eigensolve(op, 3, **kw)
    ref = fdtt.eigensolve(_plain_banded(op), 3, **kw)
    assert res.converged and res.iterations == ref.iterations
    assert res.operator_columns == ref.operator_columns
    torch.testing.assert_close(res.eigenvalues, ref.eigenvalues, rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("precision", [None, "float32", "highest",
                                       "tensorfloat32", "bfloat16_3x",
                                       "bfloat16"])
def test_precision_context_on_the_card(cuda_device, precision):
    from fortran_davidson_tpu_torch.utils.dtypes import (
        REDUCED_PRECISIONS, full_precision_matmuls)
    # The error of each entry of a float32 Gram against |a|ᵀ|a|: ~1e-8 in
    # full float32, ~1e-5 under TF32 (~10 mantissa bits).
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((8192, 64), generator=g, device=cuda_device)
    exact = a.double().T @ a.double()
    scale = a.double().abs().T @ a.double().abs()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    with pytest.raises(RuntimeError, match="inside"):
        with full_precision_matmuls(precision):
            err = float((((a.T @ a).double() - exact).abs() / scale).max())
            raise RuntimeError("inside")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
    assert (err > 1e-6) == (precision in REDUCED_PRECISIONS), err


def test_eigsh_and_batched_on_the_card(cuda_device):
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    before = kernels.banded_bsr_spmm.launches
    w = fdtt.eigsh(op, k=3, which="SA", tol=1e-9, return_eigenvectors=False)
    assert kernels.banded_bsr_spmm.launches > before
    want = torch.linalg.eigvalsh(op.to_dense().cpu()).numpy()
    assert abs(w - want[:3]).max() <= 1e-9
    w, v = fdtt.eigsh(op, k=2, which="LA", tol=1e-9)
    assert abs(w - want[-2:]).max() <= 1e-8
    mats = torch.stack([op.to_dense()[:256, :256]] * 3)
    res = fdtt.eigensolve_batched(mats, 2, tolerance=1e-9)
    one = fdtt.eigensolve(mats[0], 2, tolerance=1e-9)
    assert res.eigenvalues.is_cuda and res.iterations.tolist() == [
        one.iterations] * 3
    assert torch.equal(res.eigenvalues[1], one.eigenvalues)


# -- checkpoint / resume on the card ----------------------------------------

class _Interrupt(RuntimeError):
    """A callback's stand-in for the process dying."""


def _interrupt_once():
    calls = []

    def callback(state):
        calls.append(state["it"])
        if len(calls) == 1:
            raise _Interrupt
    return callback


def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    # Checkpointed, and interrupted after its first save then resumed:
    # the one-shot solve's bits, iterations and kernel 1 launches.
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    kernels.reset_launch_counts()
    ref = fdtt.eigensolve(op, 3, max_dim_sub=12)
    one_shot = kernels.banded_bsr_spmm.launches
    assert one_shot > 0
    res = fdtt.eigensolve_checkpointed(op, 3, str(tmp_path / "a"), every=2,
                                       max_dim_sub=12)
    kernels.reset_launch_counts()
    with pytest.raises(_Interrupt):
        fdtt.eigensolve_checkpointed(op, 3, str(tmp_path / "b"), every=2,
                                     max_dim_sub=12,
                                     callbacks=(_interrupt_once(),))
    resumed = fdtt.eigensolve_checkpointed(op, 3, str(tmp_path / "b"),
                                           every=2, max_dim_sub=12)
    assert kernels.banded_bsr_spmm.launches == one_shot
    for r in (res, resumed):
        assert r.iterations == ref.iterations
        assert r.operator_columns == ref.operator_columns
        assert r.eigenvalues.is_cuda
        assert torch.equal(r.eigenvalues, ref.eigenvalues)
        torch.testing.assert_close(r.residual_history, ref.residual_history,
                                   rtol=0, atol=0, equal_nan=True)


def test_card_checkpoint_resumes_on_the_cpu(cuda_device, tmp_path):
    # Saved on the card, resumed on the CPU (and the other way round): the
    # files map to the resuming device, and the solve ends with the
    # uninterrupted iterations and eigenvalues to 1e-10.
    op = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0,
                                  device=cuda_device)
    op_cpu = fdtt.BSROperator(op.block_cols.cpu(), op.blocks.cpu(),
                              bandwidth=1)
    ref = fdtt.eigensolve(op, 3, max_dim_sub=12)
    for first, second, tag in ((op, op_cpu, "to_cpu"),
                               (op_cpu, op, "to_card")):
        d = str(tmp_path / tag)
        with pytest.raises(_Interrupt):
            fdtt.eigensolve_checkpointed(first, 3, d, every=2,
                                         max_dim_sub=12,
                                         callbacks=(_interrupt_once(),))
        res = fdtt.eigensolve_checkpointed(second, 3, d, every=2,
                                           max_dim_sub=12)
        assert res.eigenvalues.device.type == second.device.type
        assert res.converged and res.iterations == ref.iterations
        torch.testing.assert_close(res.eigenvalues.cpu(),
                                   ref.eigenvalues.cpu(), rtol=0, atol=1e-10)


def test_sum_ds_at_world_size_one_is_the_local_fold(cuda_device, tmp_path):
    # Over a one-rank NCCL group the ranks' cascade is the identity: the
    # sharded compensated Gram, dots and norms have the local tree's bits.
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.core.rows import Rows
    from fortran_davidson_tpu_torch.parallel import (RowShardConstraint,
                                                     multihost)
    from fortran_davidson_tpu_torch.utils import ds as dsm

    class LocalTree(Rows):
        cascade = False

    n = 1 << 19
    g = torch.Generator(device="cpu").manual_seed(5)
    V = torch.randn((n, 20), generator=g).to(cuda_device)
    X = torch.randn((n, 4), generator=g).to(cuda_device)
    mesh = multihost.initialize(init_method=f"file://{tmp_path}/rendezvous",
                                world_size=1, rank=0, device=cuda_device)
    try:
        assert dist.get_backend() == "nccl"
        rows = RowShardConstraint(mesh, n)
        hi, lo = torch.randn(7, device=cuda_device), torch.zeros(7).to(
            cuda_device)
        shi, slo = rows.sum_ds(hi, lo)
        assert torch.equal(shi, hi) and torch.equal(slo, lo)
        for fn in (lambda r: dsm.gram_ds(V, rows=r),
                   lambda r: dsm.dot_cols_ds(X, X, r),
                   lambda r: dsm.col_sumsq_pair_ds(X, 1e-8 * X, r),
                   lambda r: dsm.weighted_dot_cols_ds(X[:, 0], X, rows=r)):
            got, want = fn(rows), fn(LocalTree())
            assert torch.equal(got.hi, want.hi)
            assert torch.equal(got.lo, want.lo)
    finally:
        dist.destroy_process_group()


# -- the banded generators' row builds -------------------------------------

def _same_bits(a, b) -> bool:
    ints = {8: torch.int64, 4: torch.int32, 1: torch.int8}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.element_size()]),
                            b.view(ints[b.element_size()])))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("form", ["float64", "int8"])
def test_rank_rows_on_the_card_equal_the_whole_build(cuda_device, form,
                                                     world, monkeypatch):
    # Each rank's rows, built alone on the card, are those rows of the
    # whole build, bit for bit; chunks of 5 block rows on several host
    # threads, each copied into the tensor on the card.
    from fortran_davidson_tpu_torch.ops import sparse
    from fortran_davidson_tpu_torch.parallel import RowMesh
    nbr, bs, bw = 96, 32, 2
    monkeypatch.setattr(sparse, "ROW_CHUNK_BYTES", 5 * (2 * bw + 1) * bs * bs)
    gen = dict(bandwidth=bw, coupling=1e-3, seed=4, device=cuda_device)
    if form == "int8":
        q = fdtt.generate_banded_bsr_quantized(nbr, bs, **gen)
        whole = (q.qblocks, q.scale_rows, q.diag)
    else:
        A = fdtt.generate_banded_bsr(nbr, bs, dtype=torch.float64, **gen)
        whole = (A.block_cols, A.blocks)
    for rank in range(world):
        rows = RowMesh(group=None, size=world, rank=rank,
                       device=cuda_device).rows(nbr)
        got = (sparse.banded_bsr_quantized_rows(nbr, bs, rows, **gen)
               if form == "int8" else
               sparse.banded_bsr_rows(nbr, bs, rows, dtype=torch.float64,
                                      **gen))
        for g, w in zip(got, whole):
            assert g.device.type == "cuda"
            assert _same_bits(g, w[rows])


def test_push_solve_from_rank_rows_gives_the_global_bits(cuda_device,
                                                         tmp_path):
    # World size 1 over NCCL, kernel 8 on the push route: the operator
    # built from the rank's rows (n_block_rows=) solves to the bits of the
    # one cut from the global tables.
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.ops import sparse
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     eigensolve_sharded,
                                                     multihost)
    nbr, bs = 64, 16
    gen = dict(bandwidth=1, coupling=0.1, seed=0, device=cuda_device)
    op = fdtt.generate_banded_bsr(nbr, bs, **gen)
    mesh = multihost.initialize(init_method=f"file://{tmp_path}/rendezvous",
                                world_size=1, rank=0, device=cuda_device)
    try:
        own = HaloBSROperator(*sparse.banded_bsr_rows(
            nbr, bs, mesh.rows(nbr), **gen), 1, mesh,
            backend="pallas-remote", n_block_rows=nbr)
        cut = HaloBSROperator.from_bsr(op, 1, mesh, backend="pallas-remote")
        assert own.route == cut.route == "push"
        kernels.reset_launch_counts()
        a = eigensolve_sharded(own, 3, mesh, max_dim_sub=12)
        pushes = kernels.banded_remote_push_spmm.launches
        b = eigensolve_sharded(cut, 3, mesh, max_dim_sub=12)
    finally:
        dist.destroy_process_group()
    assert pushes > 0 and a.converged and a.iterations == b.iterations
    assert _same_bits(a.eigenvalues, b.eigenvalues)
    assert _same_bits(a.eigenvectors, b.eigenvectors)
