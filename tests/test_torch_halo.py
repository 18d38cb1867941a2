"""Kernels 6, 7 and 8 of the port (the shard-local contractions of the
row-sharded solve) against the JAX package's Pallas kernels, which run in
interpret mode on the CPU (their default off the TPU). Kernel 8's JAX
form runs under ``shard_map`` on a ring of one or two CPU devices; its
remote copies go to the ring neighbours (at one device, to itself), so
the port's wrapper gets the neighbours' rows as its two halos.

On the CPU the port's wrappers take their plain versions (an unfold of
the halo-extended input into (nbr, K*bs, m) windows and a ``torch.bmm``);
the CUDA kernels are held to those plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Inputs are numpy,
seeded. Tolerances relative to max|Y|: 1e-12 in float64 (summation order
only), 1e-5 in float32 and for bf16 storage summed in float32; the int8
kernel rtol = atol = 2e-5, as ``tests/test_quantized.py`` holds the JAX
halo operator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from fortran_davidson_tpu.ops import pallas_kernels as jk
from fortran_davidson_tpu_torch.ops import kernels
from tests.torch_parity import to_numpy

BS = 8
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 20])
@pytest.mark.parametrize("bw", [1, 2, 3])
@pytest.mark.parametrize("nbr", [8, 16])
def test_banded_ext_plain_matches_jax(nbr, bw, m, dtype):
    rng = np.random.default_rng(100 * nbr + 10 * bw + m)
    K = 2 * bw + 1
    blocks = rng.standard_normal((nbr, BS, K * BS))
    x_ext = rng.standard_normal(((nbr + 2 * bw) * BS, m))
    # bf16 storage returns the float32 sums (the halo operator's use).
    out = jnp.float32 if dtype == "bfloat16" else None
    jdt = getattr(jnp, dtype)
    yj = np.asarray(jk.banded_ext_bsr_spmm(
        jnp.asarray(blocks, jdt), jnp.asarray(x_ext, jdt), bandwidth=bw,
        out_dtype=out), np.float64)
    tdt = getattr(torch, dtype)
    yt = kernels.banded_ext_bsr_spmm(
        torch.from_numpy(blocks).to(tdt), torch.from_numpy(x_ext).to(tdt),
        bandwidth=bw, out_dtype=None if out is None else torch.float32)
    assert yt.dtype == (torch.float32 if out is not None else tdt)
    assert yt.shape == (nbr * BS, m)
    err = np.max(np.abs(to_numpy(yt.double()) - yj)) / np.max(np.abs(yj))
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("m", [1, 4, 20])
@pytest.mark.parametrize("bw", [1, 2])
def test_banded_q_ext_plain_matches_jax(bw, m):
    rng = np.random.default_rng(10 * bw + m)
    nbr, K = 16, 2 * bw + 1
    q = rng.integers(-127, 128, (nbr, BS, K * BS)).astype(np.int8)
    scales = (rng.random((nbr, K)) * 1e-3).astype(np.float32)
    scale_rows = np.repeat(scales, BS, axis=1)
    diag = (1.0 + rng.random((nbr, BS))).astype(np.float32)
    x_ext = rng.standard_normal(((nbr + 2 * bw) * BS, m)).astype(np.float32)
    yj = np.asarray(jk.banded_q_ext_bsr_spmm(
        jnp.asarray(q), jnp.asarray(scale_rows), jnp.asarray(diag),
        jnp.asarray(x_ext), bandwidth=bw))
    yt = kernels.banded_q_ext_bsr_spmm(
        torch.from_numpy(q), torch.from_numpy(scale_rows),
        torch.from_numpy(diag), torch.from_numpy(x_ext), bandwidth=bw)
    assert yt.dtype == torch.float32 and yt.shape == (nbr * BS, m)
    np.testing.assert_allclose(to_numpy(yt), yj, rtol=2e-5, atol=2e-5)


def _slab_case(kind, bw, m, nbr):
    """Seeded numpy tables of a whole banded matrix (out-of-range slots hold
    zero blocks, as the generators emit) and its x: dense blocks, or int8
    blocks with per-slot scales and an exact diagonal."""
    rng = np.random.default_rng(1000 * bw + m)
    K = 2 * bw + 1
    col = np.arange(nbr)[:, None] - bw + np.arange(K)[None, :]
    keep = np.repeat((col >= 0) & (col < nbr), BS, axis=1)[:, None, :]
    x = rng.standard_normal((nbr * BS, m))
    if kind == "int8":
        q = (rng.integers(-127, 128, (nbr, BS, K * BS)) * keep).astype(np.int8)
        scales = rng.random((nbr, K)) * 1e-3 + 1e-4
        scale_rows = np.repeat(scales, BS, axis=1).astype(np.float32)
        diag = (1.0 + rng.random((nbr, BS))).astype(np.float32)
        return (q, scale_rows, diag), x.astype(np.float32)
    return (rng.standard_normal((nbr, BS, K * BS)) * keep,), x


@pytest.mark.parametrize("kind", ["float64", "float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m", [1, 5, 20])
@pytest.mark.parametrize("bw", [1, 2, 3])
def test_four_slabs_of_ext_plain_are_the_whole_matrix(kind, bw, m):
    # Four shards: each slab's kernel 6/7 (plain on the CPU) over its
    # ring-wrapped x_ext, put together, is kernel 1/4 over the whole matrix
    # exactly (the wrapped rows meet zero blocks at the ring's ends), and
    # that is the JAX package's Pallas kernel (interpret mode) on the whole
    # matrix. The card holds the kernels to the same identity
    # (tests/test_torch_cuda.py, chip_smoke.py).
    nbr, slabs = 16, 4
    tables_np, x_np = _slab_case(kind, bw, m, nbr)
    quant = kind == "int8"
    tdt = torch.float32 if quant else getattr(torch, kind)
    tables = [torch.from_numpy(t) for t in tables_np]
    if not quant:
        tables = [tables[0].to(tdt)]
    x = torch.from_numpy(x_np).to(tdt)
    # bf16 storage returns the float32 sums (the halo operator's use).
    out = torch.float32 if kind == "bfloat16" else None
    nl, halo = nbr // slabs, bw * BS

    def x_ext(s):
        rows = torch.arange(s * nl * BS - halo, (s + 1) * nl * BS + halo)
        return x[rows % x.shape[0]]

    if quant:
        whole = kernels.banded_q_bsr_spmm(*tables, x, bw)
        parts = [kernels.banded_q_ext_bsr_spmm(
            *(t[s * nl:(s + 1) * nl] for t in tables), x_ext(s),
            bandwidth=bw) for s in range(slabs)]
    else:
        whole = kernels.banded_bsr_spmm(tables[0], x, bw, out_dtype=out)
        parts = [kernels.banded_ext_bsr_spmm(
            tables[0][s * nl:(s + 1) * nl], x_ext(s), bandwidth=bw,
            out_dtype=out) for s in range(slabs)]
    assert torch.equal(torch.cat(parts), whole)
    if quant:
        yj = np.asarray(jk.banded_q_bsr_spmm(
            *(jnp.asarray(t) for t in tables_np), jnp.asarray(x_np),
            bandwidth=bw))
        np.testing.assert_allclose(to_numpy(whole), yj, rtol=2e-5, atol=2e-5)
        return
    jdt = getattr(jnp, kind)
    yj = np.asarray(jk.banded_bsr_spmm(
        jnp.asarray(tables_np[0], jdt), jnp.asarray(x_np, jdt), bandwidth=bw,
        out_dtype=None if out is None else jnp.float32), np.float64)
    err = np.max(np.abs(to_numpy(whole.double()) - yj)) / np.max(np.abs(yj))
    assert err <= TOL[kind], err


# (dtype, bs, m, blocks_ptr, x_ext_ptr) -> kernel 6's route: the TMA route
# where bs is a multiple of the row tile (16 up to bs = 16, else 128) and
# of the chunk depth (16 elements, 32 in bf16), m * itemsize a multiple of
# 16 bytes, and both bases 16-byte aligned.
ROUTES = [
    (torch.float64, 128, 40, 0, 0, "tma"),
    (torch.float64, 128, 1, 0, 0, "cp.async"),
    (torch.float64, 128, 2, 0, 0, "tma"),
    (torch.float64, 16, 6, 0, 0, "tma"),
    (torch.float64, 24, 40, 0, 0, "cp.async"),
    (torch.float64, 32, 40, 0, 0, "cp.async"),
    (torch.float64, 256, 40, 0, 0, "tma"),
    (torch.float64, 128, 40, 8, 0, "cp.async"),
    (torch.float64, 128, 40, 0, 8, "cp.async"),
    (torch.float32, 128, 4, 0, 0, "tma"),
    (torch.float32, 128, 6, 0, 0, "cp.async"),
    (torch.float32, 16, 20, 0, 0, "tma"),
    (torch.bfloat16, 128, 64, 0, 0, "tma"),
    (torch.bfloat16, 128, 20, 0, 0, "cp.async"),
    (torch.bfloat16, 16, 64, 0, 0, "cp.async"),
    (torch.bfloat16, 128, 256, 48, 1024, "tma"),
]


@pytest.mark.parametrize("dtype,bs,m,bptr,xptr,route", ROUTES)
def test_ext_route_rule(dtype, bs, m, bptr, xptr, route):
    assert kernels.ext_spmm_route(dtype, bs, m, bptr, xptr) == route


def test_ext_route_is_chosen_before_any_launch():
    # On the CPU the wrapper takes the plain version (the route is the
    # rule's, decided inside it on the card). The measurement launcher
    # takes a route by name: one that does not exist raises before
    # anything runs, and it has no CPU form.
    blocks = torch.zeros((8, BS, 3 * BS), dtype=torch.float64)
    x_ext = torch.zeros((10 * BS, 2), dtype=torch.float64)
    y = kernels.banded_ext_bsr_spmm(blocks, x_ext, bandwidth=1)
    assert y.shape == (8 * BS, 2)
    with pytest.raises(ValueError, match="route must be"):
        kernels.banded_ext_bsr_spmm_at("dma", blocks, x_ext, bandwidth=1)
    for route in kernels.EXT_ROUTES:
        with pytest.raises(NotImplementedError, match="CUDA tensors only"):
            kernels.banded_ext_bsr_spmm_at(route, blocks, x_ext, bandwidth=1)


def test_ext_kernels_check_shapes():
    blocks = torch.zeros((8, BS, 3 * BS), dtype=torch.float64)
    with pytest.raises(ValueError, match="rows"):
        kernels.banded_ext_bsr_spmm(blocks, torch.zeros((8 * BS, 2),
                                                        dtype=torch.float64),
                                    bandwidth=1)
    with pytest.raises(ValueError, match="K == 2"):
        kernels.banded_ext_bsr_spmm(blocks, torch.zeros((12 * BS, 2),
                                                        dtype=torch.float64),
                                    bandwidth=2)
    q = torch.zeros((8, BS, 3 * BS), dtype=torch.int8)
    with pytest.raises(ValueError, match="scale_rows"):
        kernels.banded_q_ext_bsr_spmm(q, torch.zeros((8, 2 * BS)),
                                      torch.zeros((8, BS)),
                                      torch.zeros((10 * BS, 2)), bandwidth=1)


# -- kernel 8: a shard's rows and its two halos through three pointers ----

def _remote_case(rng, nbr, bw, m, dtype):
    K = 2 * bw + 1
    tdt = getattr(torch, dtype)
    blocks = torch.from_numpy(rng.standard_normal((nbr, BS, K * BS))).to(tdt)
    x = torch.from_numpy(rng.standard_normal((nbr * BS, m))).to(tdt)
    prev, nxt = (torch.from_numpy(rng.standard_normal((bw * BS, m))).to(tdt)
                 for _ in range(2))
    return blocks, x, prev, nxt


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 20])
@pytest.mark.parametrize("bw,nbr", [(1, 1), (1, 7), (2, 3), (2, 4), (3, 5),
                                    (2, 16)])
def test_remote_plain_is_ext_plain_over_the_spliced_rows(nbr, bw, m, dtype):
    # Every nbr_l against 2·bw: fewer (all rows are edge rows), equal
    # (no interior), more. The wrapper's interior and edge launches into
    # one output, and its default of both, give kernel 6's plain version
    # over [from_prev; x; from_next].
    rng = np.random.default_rng(1000 * nbr + 10 * bw + m)
    blocks, x, prev, nxt = _remote_case(rng, nbr, bw, m, dtype)
    out = torch.float32 if dtype == "bfloat16" else None
    want = kernels.banded_ext_bsr_spmm_plain(
        blocks, torch.cat([prev, x, nxt]), bandwidth=bw, out_dtype=out)
    plain = kernels.banded_remote_halo_spmm_plain(blocks, x, prev, nxt,
                                                  bandwidth=bw, out_dtype=out)
    assert torch.equal(plain, want)
    whole = kernels.banded_remote_halo_spmm(blocks, x, prev, nxt,
                                            bandwidth=bw, out_dtype=out)
    assert whole.dtype == want.dtype and whole.shape == (nbr * BS, m)
    y = torch.empty(want.shape, dtype=kernels.acc_dtype(x.dtype))
    for rows in ("interior", "edge"):
        assert kernels.banded_remote_halo_spmm(
            blocks, x, prev, nxt, bandwidth=bw, rows=rows, out=y) is y
    scale = float(want.abs().max())
    for got in (whole, y):
        err = float((got.double() - want.double()).abs().max())
        assert err <= 1e-12 * scale if dtype == "float64" else \
            err <= 1e-6 * scale, err


@pytest.mark.parametrize("bw,nbr", [(1, 8), (2, 3)])
def test_remote_interior_reads_no_halo(nbr, bw):
    # The interior launch runs while the halos travel: NaN in them must not
    # reach its rows, and the edge launch then fills the rest.
    rng = np.random.default_rng(nbr + bw)
    blocks, x, prev, nxt = _remote_case(rng, nbr, bw, 4, "float64")
    y = torch.full(x.shape, float("nan"), dtype=torch.float64)
    nan = torch.full_like(prev, float("nan"))
    kernels.banded_remote_halo_spmm(blocks, x, nan, nan, bandwidth=bw,
                                    rows="interior", out=y)
    ranges = kernels.remote_row_ranges(nbr, bw, "interior")
    assert ranges == ([] if nbr <= 2 * bw else [(bw, nbr - bw)])
    for lo, hi in ranges:
        assert bool(torch.all(torch.isfinite(y[lo * BS:hi * BS])))
    kernels.banded_remote_halo_spmm(blocks, x, prev, nxt, bandwidth=bw,
                                    rows="edge", out=y)
    torch.testing.assert_close(
        y, kernels.banded_remote_halo_spmm_plain(blocks, x, prev, nxt,
                                                 bandwidth=bw),
        rtol=0, atol=1e-12)


def _jax_remote(blocks, x, bw, ndev, out_dtype):
    """JAX's kernel 8 over ``ndev`` CPU devices in a ring, each holding
    ``blocks.shape[0] // ndev`` block rows (interpret mode)."""
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
    fn = jax.shard_map(
        lambda b, xl: jk.banded_remote_halo_spmm(
            b, xl, bandwidth=bw, ndev=ndev, axis_name="rows",
            out_dtype=out_dtype),
        mesh=mesh, in_specs=(P("rows", None, None), P("rows", None)),
        out_specs=P("rows", None), check_vma=False)
    return np.asarray(fn(blocks, x), np.float64)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("bw", [1, 2])
@pytest.mark.parametrize("ndev", [1, 2])
def test_banded_remote_matches_jax(ndev, bw, dtype):
    # 16 block rows per device (JAX's kernel needs nbr_l % 8 == 0 and
    # nbr_l >= 16); the port's wrapper gets each shard's ring neighbours'
    # rows as its halos, the rows JAX's remote copies deliver.
    nbr_l, m = 16, 5
    rng = np.random.default_rng(100 * ndev + 10 * bw)
    K, halo, n_l = 2 * bw + 1, bw * BS, nbr_l * BS
    blocks = rng.standard_normal((ndev * nbr_l, BS, K * BS))
    x = rng.standard_normal((ndev * n_l, m))
    out = jnp.float32 if dtype == "bfloat16" else None
    jdt = getattr(jnp, dtype)
    yj = _jax_remote(jnp.asarray(blocks, jdt), jnp.asarray(x, jdt), bw, ndev,
                     out)
    tdt = getattr(torch, dtype)
    tb, tx = torch.from_numpy(blocks).to(tdt), torch.from_numpy(x).to(tdt)
    parts = []
    for s in range(ndev):
        xl = tx[s * n_l:(s + 1) * n_l]
        prev = tx[((s - 1) % ndev + 1) * n_l - halo:][:halo]
        nxt = tx[((s + 1) % ndev) * n_l:][:halo]
        parts.append(kernels.banded_remote_halo_spmm(
            tb[s * nbr_l:(s + 1) * nbr_l], xl, prev, nxt, bandwidth=bw,
            out_dtype=None if out is None else torch.float32))
    yt = to_numpy(torch.cat(parts).double())
    err = np.max(np.abs(yt - yj)) / np.max(np.abs(yj))
    assert err <= TOL[dtype], err


def test_remote_kernel_checks_its_arguments():
    blocks = torch.zeros((8, BS, 3 * BS), dtype=torch.float64)
    x = torch.zeros((8 * BS, 2), dtype=torch.float64)
    halo = torch.zeros((BS, 2), dtype=torch.float64)
    call = kernels.banded_remote_halo_spmm
    with pytest.raises(ValueError, match="from_prev must be"):
        call(blocks, x, torch.zeros((2 * BS, 2), dtype=torch.float64), halo,
             bandwidth=1)
    with pytest.raises(ValueError, match="from_next must be"):
        call(blocks, x, halo, torch.zeros((BS, 3), dtype=torch.float64),
             bandwidth=1)
    with pytest.raises(ValueError, match="from_prev is"):
        call(blocks, x, halo.float(), halo, bandwidth=1)
    with pytest.raises(ValueError, match="K == 2"):
        call(blocks, x, torch.zeros((2 * BS, 2), dtype=torch.float64),
             torch.zeros((2 * BS, 2), dtype=torch.float64), bandwidth=2)
    with pytest.raises(ValueError, match="out must be"):
        call(blocks, x, halo, halo, bandwidth=1, out=torch.zeros((8 * BS, 2)))
    with pytest.raises(ValueError, match="rows must be"):
        call(blocks, x, halo, halo, bandwidth=1, rows="middle")
    with pytest.raises(ValueError, match="rows must be"):
        kernels.remote_row_ranges(8, 1, "all")
    for rows in ("interior", "edge"):
        # One launch writes part of Y: the output it shares is required.
        with pytest.raises(ValueError, match="pass the output"):
            call(blocks, x, halo, halo, bandwidth=1, rows=rows)
