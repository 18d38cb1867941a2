"""The port's BSR SpMM (``fortran_davidson_tpu_torch.ops.kernels``) against
the JAX package's Pallas kernels, run in interpret mode as
``tests/test_sparse.py`` runs them.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels themselves are compared with those plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fortran_davidson_tpu.ops import pallas_kernels as pk
from fortran_davidson_tpu.ops.sparse import BSROperator as JaxBSR
from fortran_davidson_tpu.ops.sparse import (generate_banded_bsr,
                                             quantize_banded_int8)
from fortran_davidson_tpu_torch.ops import kernels
from tests.torch_parity import to_numpy

# float64: the same products summed in another order; float32 likewise.
RTOL = {jnp.float64: 1e-12, jnp.float32: 1e-5}
TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}


def _x(n, m, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.dtype(dtype))


def _assert_close(out, ref, dtype):
    ref = np.asarray(ref)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(to_numpy(out), ref, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale)


BANDED_CASES = ([(nbr, bw, m, jnp.float64) for nbr, bw in
                 [(16, 2), (24, 1), (32, 7)] for m in (3, 16, 130)]
                + [(nbr, bw, 16, jnp.float32) for nbr, bw in
                   [(16, 2), (24, 1), (32, 7)]])


@pytest.mark.parametrize("nbr,bw,m,dtype", BANDED_CASES)
def test_banded_plain_matches_pallas(nbr, bw, m, dtype):
    op = generate_banded_bsr(nbr, 8, bandwidth=bw, seed=9, dtype=dtype)
    X = _x(op.shape[0], m, dtype)
    ref = pk.banded_bsr_spmm(op.blocks, jnp.asarray(X), bandwidth=bw,
                             interpret=True)
    out = kernels.banded_bsr_spmm(torch.from_numpy(np.array(op.blocks)),
                                  torch.from_numpy(X), bw)
    assert out.dtype == TORCH[dtype]
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_general_plain_matches_pallas_on_clipped_band(dtype):
    # generate_banded_bsr clips the virtual columns of edge rows into range
    # (repeated columns with zero blocks).
    op = generate_banded_bsr(24, 8, bandwidth=2, seed=4, dtype=dtype)
    X = _x(op.shape[0], 16, dtype, seed=1)
    ref = pk.bsr_spmm(op.block_cols, op.blocks, jnp.asarray(X),
                      interpret=True)
    out = kernels.bsr_spmm(torch.from_numpy(np.array(op.block_cols)),
                           torch.from_numpy(np.array(op.blocks)),
                           torch.from_numpy(X))
    _assert_close(out, ref, dtype)


def _scrambled(nbr=13, bs=8, seed=5):
    """Random symmetric block pattern, own-row slot padding (from_block_coo)."""
    rng = np.random.default_rng(seed)
    pairs = {(r, r) for r in range(nbr)}
    while len(pairs) < 4 * nbr:
        i, j = (int(v) for v in rng.integers(0, nbr, 2))
        pairs |= {(i, j), (j, i)}
    brows, bcols = np.array(sorted(pairs)).T
    vals = rng.standard_normal((len(brows), bs, bs))
    return brows, bcols, vals, nbr


@pytest.mark.parametrize("m", [3, 130])
def test_general_plain_matches_pallas_on_scrambled_pattern(m):
    brows, bcols, vals, nbr = _scrambled()
    op = JaxBSR.from_block_coo(brows, bcols, vals, nbr, pad_width=9)
    cols = np.array(op.block_cols)
    # own-row padding: padded slots repeat the row's own block index
    assert np.any(np.sum(cols == np.arange(nbr)[:, None], axis=1) > 1)
    X = _x(op.shape[0], m, jnp.float64, seed=2)
    ref = pk.bsr_spmm(op.block_cols, op.blocks, jnp.asarray(X),
                      interpret=True)
    out = kernels.bsr_spmm(torch.from_numpy(cols),
                           torch.from_numpy(np.array(op.blocks)),
                           torch.from_numpy(X))
    _assert_close(out, ref, jnp.float64)


def test_bf16_storage_accumulates_in_f32():
    op = generate_banded_bsr(16, 8, bandwidth=1, seed=10, dtype=jnp.float32)
    X = _x(op.shape[0], 8, jnp.float32, seed=3)
    ref = pk.banded_bsr_spmm(op.blocks.astype(jnp.bfloat16),
                             jnp.asarray(X).astype(jnp.bfloat16),
                             bandwidth=1, interpret=True,
                             out_dtype=jnp.float32)
    out = kernels.banded_bsr_spmm(
        torch.from_numpy(np.array(op.blocks)).to(torch.bfloat16),
        torch.from_numpy(X).to(torch.bfloat16), 1, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    # Exact products of bf16 values, summed in float32 in another order.
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def test_bf16_storage_general_accumulates_in_f32():
    # As above, for the general kernel on a scrambled pattern.
    brows, bcols, vals, nbr = _scrambled()
    op = JaxBSR.from_block_coo(brows, bcols, vals.astype(np.float32), nbr,
                               pad_width=9)
    X = _x(op.shape[0], 8, jnp.float32, seed=4)
    ref = pk.bsr_spmm(op.block_cols, op.blocks.astype(jnp.bfloat16),
                      jnp.asarray(X).astype(jnp.bfloat16), interpret=True,
                      out_dtype=jnp.float32)
    out = kernels.bsr_spmm(
        torch.from_numpy(np.array(op.block_cols)),
        torch.from_numpy(np.array(op.blocks)).to(torch.bfloat16),
        torch.from_numpy(X).to(torch.bfloat16), out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    op = generate_banded_bsr(16, 8, bandwidth=1, seed=3)
    blocks = torch.from_numpy(np.array(op.blocks))
    cols = torch.from_numpy(np.array(op.block_cols))
    X = torch.from_numpy(_x(op.shape[0], 4, jnp.float64))
    before = (kernels.banded_bsr_spmm.launches, kernels.bsr_spmm.launches)
    y1 = kernels.banded_bsr_spmm(blocks, X, 1)
    y2 = kernels.bsr_spmm(cols, blocks, X)
    assert (kernels.banded_bsr_spmm.launches,
            kernels.bsr_spmm.launches) == before
    torch.testing.assert_close(y1, kernels.banded_bsr_spmm_plain(blocks, X, 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(y2, kernels.bsr_spmm_plain(cols, blocks, X),
                               rtol=0, atol=0)


def test_wrappers_reject_bad_shapes():
    blocks = torch.zeros((4, 2, 6), dtype=torch.float64)
    with pytest.raises(ValueError):
        kernels.banded_bsr_spmm(blocks, torch.zeros((7, 1)), 1)
    with pytest.raises(ValueError):
        kernels.banded_bsr_spmm(blocks, torch.zeros((8, 1)), 2)
    with pytest.raises(ValueError):
        kernels.bsr_spmm(torch.zeros((4, 2), dtype=torch.int32), blocks,
                         torch.zeros((8, 1)))


def test_source_hash_names_the_build(tmp_path, monkeypatch):
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libfdt_kernels_") and path.suffix == ".so"
    assert {p.name for p in kernels.sources()} >= {"bsr_spmm.cu",
                                                   "fused_gram_q8f64.cu"}
    # Every file under csrc/ names the build, headers included.
    for f in kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    assert kernels.library_path() == path
    for name in ("fused_gram_q8f64.cu", "fused_gram_typed.cuh"):
        with open(tmp_path / name, "a") as fh:
            fh.write("\n")
        changed = kernels.library_path()
        assert changed != path
        path = changed


# -- the fused SpMM+Gram and int8 kernels (#3-#5) ------------------------
# Shapes where banded_pallas_supported holds (nbr % 8 == 0, nbr >= 16).

def _gram_bound(v, y, rel):
    """Elementwise bound rel * (|V|ᵀ|Y|): G sums n products with
    cancellation, so max|G| is the wrong yardstick."""
    return rel * (np.abs(np.asarray(v, np.float64)).T
                  @ np.abs(np.asarray(y, np.float64)))


def _split_gram(out, ref, gram_cols, m, write_out, y_rtol=1e-5):
    """Check Y (when written) to ``y_rtol`` of max|Y| and G's type and
    shape; return the port's and the Pallas kernel's G."""
    if write_out:
        y, g = (to_numpy(t) for t in out)
        y_ref, g_ref = (np.asarray(t, np.float32) for t in ref)
        np.testing.assert_allclose(
            y, y_ref, rtol=y_rtol, atol=y_rtol * np.max(np.abs(y_ref)))
    else:
        g, g_ref = to_numpy(out), np.asarray(ref)
    assert g.dtype == np.float32 and g.shape == (gram_cols, m)
    return g, g_ref


GRAM_CASES = [(nbr, bw, m, mv, wo)
              for nbr, bw in [(16, 1), (24, 2)]
              for m, mv in [(4, None), (20, 12)]
              for wo in (True, False)]


@pytest.mark.parametrize("nbr,bw,m,mv,write_out", GRAM_CASES)
def test_gram_plain_matches_pallas(nbr, bw, m, mv, write_out):
    # f32: Y to 1e-5 of max|Y|; G elementwise to 1e-5 of |V|ᵀ|Y| (the same
    # products summed in another order).
    op = generate_banded_bsr(nbr, 8, bandwidth=bw, seed=11, dtype=jnp.float32)
    n = op.shape[0]
    X = _x(n, m, jnp.float32, seed=4)
    V = None if mv is None else _x(n, mv, jnp.float32, seed=5)
    ref = pk.banded_bsr_spmm_gram(
        op.blocks, jnp.asarray(X), None if V is None else jnp.asarray(V),
        bandwidth=bw, write_out=write_out, interpret=True)
    out = kernels.banded_bsr_spmm_gram(
        torch.from_numpy(np.array(op.blocks)), torch.from_numpy(X),
        None if V is None else torch.from_numpy(V), bandwidth=bw,
        write_out=write_out)
    g, g_ref = _split_gram(out, ref, m if V is None else mv, m, write_out)
    Y = np.asarray(op.matmat(jnp.asarray(X)), np.float64)
    assert np.all(np.abs(g - g_ref)
                  <= _gram_bound(X if V is None else V, Y, 1e-5))


@pytest.mark.parametrize("nbr,bw,m,mv,write_out", GRAM_CASES)
def test_gram_plain_matches_pallas_f64(nbr, bw, m, mv, write_out):
    # float64 storage (the plain version of kernel 3's float64 entry). Y to
    # 1e-12 of max|Y| of the Pallas kernel's. G: the port sums in float64
    # and rounds once to float32, so it is held to Vᵀ(A X) taken in float64
    # within 1e-12 of |V|ᵀ|Y| plus one float32 ulp of |G| (the one
    # rounding). The Pallas kernel adds each grid step's product into a
    # float32 G, one float32 rounding a block row at most, so the two G
    # agree within nbr * 2^-24 of |V|ᵀ|Y|.
    op = generate_banded_bsr(nbr, 8, bandwidth=bw, seed=13, dtype=jnp.float64)
    n = op.shape[0]
    X = _x(n, m, jnp.float64, seed=14)
    V = None if mv is None else _x(n, mv, jnp.float64, seed=15)
    ref = pk.banded_bsr_spmm_gram(
        op.blocks, jnp.asarray(X), None if V is None else jnp.asarray(V),
        bandwidth=bw, write_out=write_out, interpret=True)
    out = kernels.banded_bsr_spmm_gram(
        torch.from_numpy(np.array(op.blocks)), torch.from_numpy(X),
        None if V is None else torch.from_numpy(V), bandwidth=bw,
        write_out=write_out)
    Y = np.asarray(op.matmat(jnp.asarray(X)), np.float64)
    if write_out:
        y, g = to_numpy(out[0]), to_numpy(out[1])
        y_ref, g_ref = np.asarray(ref[0]), np.asarray(ref[1])
        assert y.dtype == np.float64
        np.testing.assert_allclose(y, y_ref, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(y_ref)))
    else:
        g, g_ref = to_numpy(out), np.asarray(ref)
    VV = X if V is None else V
    assert g.dtype == np.float32 and g.shape == (VV.shape[1], m)
    g = g.astype(np.float64)
    exact = VV.T @ Y
    assert np.all(np.abs(g - exact) <= _gram_bound(VV, Y, 1e-12)
                  + np.spacing(np.abs(exact).astype(np.float32)))
    assert np.all(np.abs(g - g_ref) <= _gram_bound(VV, Y, nbr * 2.0 ** -24))


@pytest.mark.parametrize("write_out", [True, False])
@pytest.mark.parametrize("mv", [None, 12])
def test_gram_plain_bf16_storage(mv, write_out):
    # bf16 blocks, x and v, f32 sums; Y is staged as bf16 for the gram, as
    # in the TPU kernel. Y to 1e-5 (exact products, another summation
    # order); G to one bf16 ulp (2^-8) of |V|ᵀ|Y|: a Y sum in another
    # order may round to the neighbouring bf16 value.
    op = generate_banded_bsr(16, 8, bandwidth=1, seed=7, dtype=jnp.bfloat16)
    n = op.shape[0]
    X = jnp.asarray(_x(n, 8, jnp.float32, seed=6)).astype(jnp.bfloat16)
    V = (None if mv is None else
         jnp.asarray(_x(n, mv, jnp.float32, seed=8)).astype(jnp.bfloat16))
    ref = pk.banded_bsr_spmm_gram(op.blocks, X, V, bandwidth=1,
                                  write_out=write_out, interpret=True,
                                  out_dtype=jnp.float32)
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16)
    out = kernels.banded_bsr_spmm_gram(
        tb(op.blocks), tb(X), None if V is None else tb(V), bandwidth=1,
        write_out=write_out, out_dtype=torch.float32)
    Xf = np.asarray(X, np.float32)
    Vf = Xf if V is None else np.asarray(V, np.float32)
    g, g_ref = _split_gram(out, ref, Vf.shape[1], 8, write_out)
    if write_out:
        assert out[0].dtype == torch.float32
    y = kernels.banded_bsr_spmm_plain(tb(op.blocks), tb(X), 1,
                                      out_dtype=torch.float32)
    assert np.all(np.abs(g - g_ref)
                  <= _gram_bound(Vf, to_numpy(y), 2.0 ** -8))


def _quantized(nbr, bw, seed):
    return quantize_banded_int8(generate_banded_bsr(
        nbr, 8, bandwidth=bw, coupling=1e-3, seed=seed, dtype=jnp.float32))


def _q_torch(q):
    return tuple(torch.from_numpy(np.array(a))
                 for a in (q.qblocks, q.scale_rows, q.diag))


@pytest.mark.parametrize("nbr,bw,m", [(16, 1, 4), (24, 2, 20), (32, 3, 7)])
def test_int8_plain_matches_pallas(nbr, bw, m):
    # f32 sums of the same dequantized products in another order: 1e-5 of
    # max|Y|.
    q = _quantized(nbr, bw, seed=nbr)
    X = _x(q.shape[0], m, jnp.float32, seed=9)
    ref = pk.banded_q_bsr_spmm(q.qblocks, q.scale_rows, q.diag,
                               jnp.asarray(X), bandwidth=bw, interpret=True)
    out = kernels.banded_q_bsr_spmm(*_q_torch(q), torch.from_numpy(X), bw)
    assert out.dtype == torch.float32
    _assert_close(out, ref, jnp.float32)


@pytest.mark.parametrize("nbr,bw,m,mv,write_out", GRAM_CASES)
def test_int8_gram_plain_matches_pallas(nbr, bw, m, mv, write_out):
    # As test_gram_plain_matches_pallas, on int8 storage.
    q = _quantized(nbr, bw, seed=nbr + 1)
    n = q.shape[0]
    X = _x(n, m, jnp.float32, seed=10)
    V = None if mv is None else _x(n, mv, jnp.float32, seed=11)
    ref = pk.banded_q_bsr_spmm_gram(
        q.qblocks, q.scale_rows, q.diag, jnp.asarray(X),
        None if V is None else jnp.asarray(V), bandwidth=bw,
        write_out=write_out, interpret=True)
    out = kernels.banded_q_bsr_spmm_gram(
        *_q_torch(q), torch.from_numpy(X),
        None if V is None else torch.from_numpy(V), bandwidth=bw,
        write_out=write_out)
    g, g_ref = _split_gram(out, ref, m if V is None else mv, m, write_out)
    Y = np.asarray(q.matmat(jnp.asarray(X)), np.float64)
    assert np.all(np.abs(g - g_ref)
                  <= _gram_bound(X if V is None else V, Y, 1e-5))


def test_new_wrappers_take_the_plain_version_on_the_cpu():
    q = _quantized(16, 1, seed=3)
    lead = _q_torch(q)
    X = torch.from_numpy(_x(q.shape[0], 4, jnp.float32))
    counts = [fn.launches for fn in kernels.KERNELS]
    y = kernels.banded_q_bsr_spmm(*lead, X, 1)
    y2, g = kernels.banded_q_bsr_spmm_gram(*lead, X, bandwidth=1)
    assert [fn.launches for fn in kernels.KERNELS] == counts
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(g, X.T @ y, rtol=0, atol=0)
    with pytest.raises(ValueError):
        kernels.banded_q_bsr_spmm(lead[0], lead[1][:, :8], lead[2], X, 1)
    with pytest.raises(ValueError):
        kernels.banded_bsr_spmm_gram(torch.zeros((16, 8, 24)), X,
                                     torch.zeros((5, 2)), bandwidth=1)


@pytest.mark.parametrize("variant", ["nov", "nogram", "full", "rowgram",
                                     "bf16deq", "tg_bf16deq", "nov_bf16"])
def test_gram_variants_refuse_what_no_kernel_takes(variant):
    # The measurement variants of kernels 3 and 5 exist only as CUDA
    # kernels: a CPU tensor, or a name that is not a variant, raises
    # before anything launches (there is no plain version to fall back on).
    # The bf16-dequant ones are kernel 5's alone and take v only where the
    # probe's mode has one: kernel 3's name, or v missing, is a ValueError.
    q = _quantized(16, 1, seed=3)
    lead = _q_torch(q)
    X = torch.from_numpy(_x(q.shape[0], 4, jnp.float32))
    counts = [fn.launches for fn in kernels.KERNELS]
    for name, args in (("banded_q_bsr_spmm_gram", lead),
                       ("banded_bsr_spmm_gram", (torch.zeros((16, 8, 24)),))):
        kernel5 = name == "banded_q_bsr_spmm_gram"
        err = (NotImplementedError
               if variant in ("nov", "nogram")
               or (variant == "nov_bf16" and kernel5) else ValueError)
        with pytest.raises(err):
            kernels.fused_gram_variant(name, args, X, None, bandwidth=1,
                                       variant=variant)
        if variant in kernels.BF16_VARIANTS and kernel5:
            # bf16 x and v on the CPU: no kernel, no fallback.
            xb = X.to(torch.bfloat16)
            with pytest.raises(NotImplementedError):
                kernels.fused_gram_variant(
                    name, args, xb, None if variant == "nov_bf16" else xb,
                    bandwidth=1, variant=variant)
    assert [fn.launches for fn in kernels.KERNELS] == counts


# -- kernel 5's bf16-dequant variants: plain versions against the probe ---

def _probe_module():
    """``experiments/fused_probe.py``, loaded as a module (its row function
    runs on jnp arrays on the CPU)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "experiments" / \
        "fused_probe.py"
    spec = importlib.util.spec_from_file_location("fused_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_quantized(nbr, bs, bw):
    """The probe's operator (``fused_probe.py:208-214``) at a small size:
    coupling 1e-3, scaled by 1 / (nbr * bs * 2), int8-quantized."""
    base = generate_banded_bsr(nbr, bs, bandwidth=bw, coupling=1e-3,
                               dtype=jnp.float32)
    scale = 1.0 / (nbr * bs * 2.0)
    base = type(base)(base.block_cols, base.blocks * scale,
                      backend=base.backend, bandwidth=base.bandwidth)
    return quantize_banded_int8(base)


def _bf16_values(n, m, seed):
    """bf16 values as float32 numpy (exact in both packages' bf16)."""
    x = np.random.default_rng(seed).standard_normal((n, m)).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)


@pytest.mark.parametrize("nbr,bw", [(16, 1), (24, 2)])
def test_bf16_dequant_blocks_match_the_probe(nbr, bw):
    # bf16(q) * bf16(s), rounded to bf16 (fused_probe.py:67-69), bit for bit.
    q = _probe_quantized(nbr, 16, bw)
    ref = (q.qblocks.astype(jnp.bfloat16)
           * q.scale_rows[:, None, :].astype(jnp.bfloat16))
    out = kernels.q_dequant_bf16(*_q_torch(q)[:2])
    assert out.dtype == torch.bfloat16
    ref_bits = np.asarray(ref).view(np.uint16)
    assert np.array_equal(out.view(torch.int16).numpy().view(np.uint16),
                          ref_bits)


@pytest.mark.parametrize("variant", ["bf16deq", "tg_bf16deq", "nov_bf16"])
@pytest.mark.parametrize("nbr,bw,m", [(16, 1, 20), (24, 2, 7), (16, 1, 1),
                                      (16, 2, 4), (16, 3, 44), (24, 1, 64),
                                      (16, 3, 256)])
def test_bf16_variant_plain_matches_the_probe(variant, nbr, bw, m):
    # fused_gram_variant_plain against fused_probe._spmm_row(...,
    # dequant="bf16") on the zero-padded x as a one-slot window buffer, and
    # the probe's gram: per block row (bf16deq, :92-95), per tile of two
    # block rows (tg_bf16deq, :109-112), or Y's column sums (nov_bf16,
    # :161-165). Y within 1e-6 of max|Y| (float32 sums in another order).
    # G within 2^-7 of |V|ᵀ|Y| elementwise: a Y sum in another order can
    # round to the neighbouring bf16 value before the gram.
    import jax
    probe = _probe_module()
    bs = 16
    q = _probe_quantized(nbr, bs, bw)
    K = 2 * bw + 1
    n = nbr * bs
    X = _bf16_values(n, m, seed=nbr + m)
    V = _bf16_values(n, 12, seed=nbr + m + 1)
    xb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (X, V))
    xbuf = jnp.pad(xb, ((bw * bs, bw * bs), (0, 0)))[None]
    rows = [probe._spmm_row(q.qblocks, q.scale_rows, q.diag, xbuf, i, 0, K=K,
                            bw=bw, dequant="bf16") for i in range(nbr)]
    y_ref = np.concatenate([np.asarray(r) for r in rows])

    def vty(v, y):
        return jax.lax.dot_general(
            v, y.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)

    if variant == "bf16deq":
        g_ref = sum(vty(vb[i * bs:(i + 1) * bs], rows[i]) for i in range(nbr))
    elif variant == "tg_bf16deq":
        g_ref = sum(vty(vb[i * bs:(i + 2) * bs],
                        jnp.concatenate(rows[i:i + 2]))
                    for i in range(0, nbr, 2))
    else:
        g_ref = jnp.zeros((m, m), jnp.float32).at[0].set(
            sum(jnp.sum(r, axis=0) for r in rows))
    g_ref = np.asarray(g_ref, np.float64)

    lead = _q_torch(q)
    xt = torch.from_numpy(X).to(torch.bfloat16)
    vt = torch.from_numpy(V).to(torch.bfloat16)
    y = to_numpy(kernels.q_bf16_apply_plain(*lead, xt, bw))
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-6 * np.max(np.abs(y_ref)))
    g = kernels.fused_gram_variant_plain(
        "banded_q_bsr_spmm_gram", lead, xt,
        None if variant == "nov_bf16" else vt, bandwidth=bw, variant=variant)
    assert g.dtype == torch.float32
    g = to_numpy(g)
    if variant == "nov_bf16":
        assert g.shape == (m, m) and not np.any(g[1:])
        bound = 1e-6 * np.sum(np.abs(y_ref), axis=0)
        assert np.all(np.abs(g[0] - g_ref[0]) <= bound)
    else:
        assert g.shape == (12, m)
        assert np.all(np.abs(g - g_ref) <= _gram_bound(V, y_ref, 2.0 ** -7))


# -- float64 x on int8 storage (kernels 4, 5, 7) --------------------------

def _x64(n, m, seed):
    return np.random.default_rng(seed).standard_normal((n, m))


def _assert_f64_int8_close(out, ref):
    # Both sum float32-dequantized blocks against float64 x into float32
    # (the JAX package: preferred_element_type=float32): the same float32
    # values up to the order of the sums, one float32 ulp where the two
    # sums straddle a rounding boundary.
    ref = np.asarray(ref, np.float64)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(out), ref, rtol=0,
                               atol=2.0 ** -22 * np.max(np.abs(ref)))


@pytest.mark.parametrize("nbr,bw,m", [(16, 1, 4), (24, 2, 20)])
def test_int8_float64_x_plain_matches_pallas_and_fallback(nbr, bw, m):
    q = _quantized(nbr, bw, seed=nbr + 5)
    X = _x64(q.shape[0], m, seed=12)
    out = kernels.banded_q_bsr_spmm(*_q_torch(q), torch.from_numpy(X), bw)
    _assert_f64_int8_close(out, pk.banded_q_bsr_spmm(
        q.qblocks, q.scale_rows, q.diag, jnp.asarray(X), bandwidth=bw,
        interpret=True))
    _assert_f64_int8_close(out, q.with_backend("xla").matmat(jnp.asarray(X)))


@pytest.mark.parametrize("mv,write_out", [(None, True), (12, True),
                                          (12, False)])
def test_int8_float64_x_gram_plain_matches_pallas(mv, write_out):
    q = _quantized(16, 1, seed=21)
    n = q.shape[0]
    X = _x64(n, 6, seed=13)
    V = None if mv is None else _x64(n, mv, seed=14)
    ref = pk.banded_q_bsr_spmm_gram(
        q.qblocks, q.scale_rows, q.diag, jnp.asarray(X),
        None if V is None else jnp.asarray(V), bandwidth=1,
        write_out=write_out, interpret=True)
    out = kernels.banded_q_bsr_spmm_gram(
        *_q_torch(q), torch.from_numpy(X),
        None if V is None else torch.from_numpy(V), bandwidth=1,
        write_out=write_out)
    if write_out:
        _assert_f64_int8_close(out[0], ref[0])
    g, g_ref = (out[1], ref[1]) if write_out else (out, ref)
    Y = to_numpy(kernels.banded_q_bsr_spmm_plain(*_q_torch(q),
                                                 torch.from_numpy(X), 1))
    # G of the same float32-valued Y, summed in another order and type.
    assert np.all(np.abs(to_numpy(g) - np.asarray(g_ref, np.float64))
                  <= _gram_bound(X if V is None else V, Y, 1e-5))


@pytest.mark.parametrize("m", [1, 4, 20, 44, 64, 256])
@pytest.mark.parametrize("bw", [1, 3])
def test_int8_float64_x_gram_plain_matches_pallas_by_width(m, bw):
    # The widths of kernel 5's float64-x entry on the card, v None and
    # given, against the JAX package's kernel in interpret mode, as above.
    q = _quantized(16, bw, seed=m + bw)
    n = q.shape[0]
    X = _x64(n, m, seed=m)
    Y = to_numpy(kernels.banded_q_bsr_spmm_plain(*_q_torch(q),
                                                 torch.from_numpy(X), bw))
    for V in (None, _x64(n, 12, seed=m + 1)):
        y_ref, g_ref = pk.banded_q_bsr_spmm_gram(
            q.qblocks, q.scale_rows, q.diag, jnp.asarray(X),
            None if V is None else jnp.asarray(V), bandwidth=bw,
            interpret=True)
        y, g = kernels.banded_q_bsr_spmm_gram(
            *_q_torch(q), torch.from_numpy(X),
            None if V is None else torch.from_numpy(V), bandwidth=bw)
        _assert_f64_int8_close(y, y_ref)
        assert np.all(np.abs(to_numpy(g) - np.asarray(g_ref, np.float64))
                      <= _gram_bound(X if V is None else V, Y, 1e-5))


def test_int8_float64_x_ext_plain_matches_pallas():
    q = _quantized(16, 2, seed=22)
    bs, bw = 8, 2
    X_ext = _x64(q.shape[0] + 2 * bw * bs, 5, seed=15)
    out = kernels.banded_q_ext_bsr_spmm(*_q_torch(q), torch.from_numpy(X_ext),
                                        bandwidth=bw)
    _assert_f64_int8_close(out, pk.banded_q_ext_bsr_spmm(
        q.qblocks, q.scale_rows, q.diag, jnp.asarray(X_ext), bandwidth=bw,
        interpret=True))


# -- kernel 1's measurement variants: plain versions -----------------------

def _variant_numpy(blocks, X, bw, variant, tm):
    """numpy transcriptions of the variants' definitions, row by row
    (``noy``: column sums over row tiles of ``tm`` rows)."""
    nbr, bs, kbs = blocks.shape
    K = kbs // bs
    n, m = X.shape
    if variant == "writeonly":
        return np.repeat(np.arange(n, dtype=np.float64)[:, None], m, axis=1)
    Y = np.zeros((n, m))
    for r in range(nbr):
        for k in range(K):
            c = r - bw + k
            if not 0 <= c < nbr:
                continue  # an edge window's masked rows are zero
            xk = X[c * bs:(c + 1) * bs]
            if variant == "copy":
                Y[r * bs:(r + 1) * bs] += xk
            else:
                Y[r * bs:(r + 1) * bs] += blocks[r, :, k * bs:(k + 1) * bs] @ xk
        if variant == "copy":
            Y[r * bs:(r + 1) * bs] += blocks[r].sum(axis=1)[:, None]
    if variant == "noy":
        tiles = -(-bs // tm)
        Y = np.stack([Y[r * bs + t * tm:min((r + 1) * bs, r * bs + (t + 1) * tm)]
                      .sum(axis=0) for r in range(nbr) for t in range(tiles)])
    return Y


@pytest.mark.parametrize("variant", ["full", "noy", "copy", "writeonly"])
@pytest.mark.parametrize("nbr,bs,bw,m", [(5, 8, 1, 3), (7, 24, 3, 20),
                                         (3, 140, 1, 2)])
def test_variant_plain_versions_match_numpy(variant, nbr, bs, bw, m):
    rng = np.random.default_rng(nbr * bs)
    # Nonzero blocks in the out-of-range slots too: copy sums every stored
    # entry, the products see only masked (zero) x rows there.
    blocks = rng.standard_normal((nbr, bs, (2 * bw + 1) * bs))
    X = rng.standard_normal((nbr * bs, m))
    # A row tile that divides no bs here: the last tile of a block row is
    # ragged.
    tm = 16
    out = kernels.banded_spmm_variant_plain(
        torch.from_numpy(blocks), torch.from_numpy(X), bw, variant=variant,
        row_tile=tm)
    np.testing.assert_allclose(to_numpy(out),
                               _variant_numpy(blocks, X, bw, variant, tm),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("variant", ["full", "noy", "copy", "writeonly",
                                     "dma"])
def test_banded_variant_refuses_cpu_tensors_and_unknown_variants(variant):
    # The variants exist only as CUDA kernels: a CPU tensor raises (there
    # is no fallback), and so does a name that is no variant; nothing is
    # counted as launched.
    blocks = torch.zeros((4, 8, 24))
    X = torch.zeros((32, 4))
    before = (kernels.banded_spmm_variant.launches,
              kernels.banded_bsr_spmm.launches)
    err = ValueError if variant == "dma" else NotImplementedError
    with pytest.raises(err):
        kernels.banded_spmm_variant(blocks, X, 1, variant=variant)
    with pytest.raises(ValueError):
        kernels.banded_spmm_variant_plain(blocks, X, 1, variant="dma")
    with pytest.raises(ValueError):  # noy's sums need the launch's row tile
        kernels.banded_spmm_variant_plain(blocks, X, 1, variant="noy")
    assert (kernels.banded_spmm_variant.launches,
            kernels.banded_bsr_spmm.launches) == before
