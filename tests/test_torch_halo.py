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

Kernel 8's one-launch form (the halos pushed into the ring neighbours'
windows) runs its plain version here: ranks simulated in one process, on
threads of their own, each pushing into its neighbours' window tensors
and waiting for theirs, as the kernel's CTAs do on the card. Its
protocol (``kernels.push_plan``) is model-checked over interleavings, and
its route rule (``parallel.mesh.halo_route``) is a pure function of the
ranks' (host, GPU, peers) tuples.
"""

import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import Mesh, PartitionSpec as P

from fortran_davidson_tpu.ops import pallas_kernels as jk
from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.parallel import HaloBSROperator, RowMesh
from fortran_davidson_tpu_torch.parallel import mesh as tmesh
from fortran_davidson_tpu_torch.parallel import scaling
from fortran_davidson_tpu_torch.utils.errors import HaloPushFault
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


# -- kernel 8 in one launch: the halos pushed into the neighbours' windows -

def _ring_windows(ndev, slot_bytes):
    """One window of tensor memory a simulated rank, each reaching its ring
    predecessor's and successor's (at one rank, its own)."""
    mems = [torch.zeros(kernels.window_bytes(slot_bytes), dtype=torch.uint8)
            for _ in range(ndev)]
    return [kernels.HaloWindow(
        rank=r, slot_bytes=slot_bytes,
        ptrs=[mems[q].data_ptr() for q in (r, r - 1, (r + 1) % ndev)],
        fault=kernels.new_fault_record("cpu"), device="cpu",
        mems=(mems[r], mems[r - 1], mems[(r + 1) % ndev]))
        for r in range(ndev)]


def _pushed(blocks, xs, windows, bw, epoch, out=None):
    """Every simulated rank's push apply at ``epoch``, each on a thread
    of its own (each waits for its neighbours' pushes)."""
    ndev = len(windows)
    nl = blocks.shape[0] // ndev
    with concurrent.futures.ThreadPoolExecutor(ndev) as pool:
        jobs = [pool.submit(kernels.banded_remote_push_spmm,
                            blocks[r * nl:(r + 1) * nl], xs[r], windows[r],
                            bandwidth=bw, epoch=epoch, out_dtype=out)
                for r in range(ndev)]
        return [job.result(timeout=60) for job in jobs]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ndev,bw", [(1, 2), (2, 1), (4, 2)])
def test_push_plain_matches_jax(ndev, bw, dtype):
    # The same inputs as test_banded_remote_matches_jax: JAX's kernel 8 on
    # a ring of ndev CPU devices (its remote copies in interpret mode)
    # against the push form's plain version, ndev ranks pushing into each
    # other's windows; then three more epochs on fresh x through the same
    # buffers (both parities, each reused), held to kernel 6's plain
    # version on each rank's ring-wrapped rows.
    nbr_l, m = 16, 5
    rng = np.random.default_rng(100 * ndev + 10 * bw + 7)
    K, halo, n_l = 2 * bw + 1, bw * BS, nbr_l * BS
    blocks = rng.standard_normal((ndev * nbr_l, BS, K * BS))
    xs_np = [rng.standard_normal((ndev * n_l, m)) for _ in range(4)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    yj = _jax_remote(jnp.asarray(blocks, jdt), jnp.asarray(xs_np[0], jdt),
                     bw, ndev, None)
    tb = torch.from_numpy(blocks).to(tdt)
    windows = _ring_windows(ndev, kernels.window_slot_bytes(halo, m, tdt))
    before = kernels.banded_remote_push_spmm.launches
    for epoch, x_np in enumerate(xs_np, start=1):
        tx = torch.from_numpy(x_np).to(tdt)
        ys = _pushed(tb, list(tx.split(n_l)), windows, bw, epoch)
        assert all(y.dtype == tdt and y.shape == (n_l, m) for y in ys)
        y = torch.cat(ys)
        if epoch == 1:
            err = np.max(np.abs(to_numpy(y.double()) - yj)) / np.max(
                np.abs(yj))
            assert err <= TOL[dtype], err
        idx = [torch.arange(s * n_l - halo, (s + 1) * n_l + halo) % tx.shape[0]
               for s in range(ndev)]
        want = torch.cat([kernels.banded_ext_bsr_spmm_plain(
            tb[s * nbr_l:(s + 1) * nbr_l], tx[idx[s]], bandwidth=bw)
            for s in range(ndev)])
        assert torch.equal(y, want), epoch
    # The plain version is no launch; every rank's flags read the last
    # epoch: its slots' arrived (parity 0 and 1) and its consumed.
    assert kernels.banded_remote_push_spmm.launches == before
    for w in windows:
        assert w.flags(0).tolist() == [4, 3, 4, 3, 4, 4]


def _model_run(ranks, calls, choices, plan=kernels.push_plan):
    """Run ``ranks`` ranks of the push protocol for ``calls`` epochs each,
    interleaved by ``choices`` (each picks one of the actors that may
    step), with the buffers, flags and waits of ``plan``. Each rank has two
    actors, freer than a launch's CTAs (whose pushes of an epoch follow the
    reads of the one before): a pusher that, epoch after epoch, writes its
    rows into the predecessor's bot slot and the successor's top slot, each
    once the receiver's consumed allows; and a reader that, epoch after
    epoch, reads its own two slots once both arrived flags hold the epoch,
    then sets the senders' consumed flags. Returns the violations: a push
    over rows whose reader has not read them, a read of rows of another
    epoch or sender, or no actor able to step."""
    bad = []
    # buf[r][slot][parity] = (sender, epoch) of the rows it holds
    buf = [[[None, None], [None, None]] for _ in range(ranks)]
    arrived = [[[0, 0], [0, 0]] for _ in range(ranks)]
    consumed = [[0, 0] for _ in range(ranks)]
    read = [[0, 0] for _ in range(ranks)]   # last epoch read, a slot
    # (epoch, step) of each rank's pusher and reader
    at = {(kind, r): [1, 0] for r in range(ranks) for kind in ("push", "read")}
    choices = iter(choices)

    def can_step(actor):
        (kind, r), (e, step) = actor, at[actor]
        if e > calls:
            return False
        p = plan(e)
        if kind == "push":
            slot = kernels.BOT if step == 0 else kernels.TOP
            return consumed[r][slot] >= p.reuse_after
        return step == 1 or all(arrived[r][s][p.parity] == e for s in (0, 1))

    while any(e <= calls for e, _ in at.values()):
        ready = [a for a in at if can_step(a)]
        if not ready:
            return bad + ["no actor can step"]
        actor = ready[next(choices, 0) % len(ready)]
        (kind, r), (e, step) = actor, at[actor]
        p = plan(e)
        left, right = (r - 1) % ranks, (r + 1) % ranks
        if kind == "push":
            q, slot = (left, kernels.BOT) if step == 0 else (right, kernels.TOP)
            held = buf[q][slot][p.parity]
            if held is not None and read[q][slot] < held[1]:
                bad.append(f"rank {r} epoch {e} overwrote rank {q}'s unread "
                           f"slot {slot} rows of epoch {held[1]}")
            buf[q][slot][p.parity] = (r, e)
            arrived[q][slot][p.parity] = e
        elif step == 0:
            for slot, sender in ((kernels.TOP, left), (kernels.BOT, right)):
                if buf[r][slot][p.parity] != (sender, e):
                    bad.append(f"rank {r} epoch {e} read slot {slot} rows "
                               f"{buf[r][slot][p.parity]}")
                read[r][slot] = e
        else:
            consumed[left][kernels.TOP] = e
            consumed[right][kernels.BOT] = e
        at[actor] = [e + (step == 1), 1 - step]
    return bad


@settings(max_examples=150, deadline=None)
@given(ranks=st.integers(1, 4), calls=st.integers(1, 8),
       choices=st.lists(st.integers(0, 7), max_size=200))
def test_push_protocol_over_interleavings(ranks, calls, choices):
    # Every interleaving of up to 4 ranks x 8 applies: no buffer is
    # overwritten before its reader has read it, every read sees its own
    # epoch's rows from the right neighbour, and some actor can always
    # step.
    assert _model_run(ranks, calls, choices) == []


def test_push_protocol_model_finds_a_missing_wait():
    # The model has teeth: pushers that wait on no consumed flag overwrite
    # rows not yet read when rank 0's pusher runs two epochs ahead.
    def no_wait(epoch):
        return kernels.PushPlan(epoch % 2, -1)
    bad = _model_run(2, 3, [0] * 24, plan=no_wait)
    assert _model_run(2, 3, [0] * 24) == []
    assert any("unread" in b for b in bad), bad
    assert kernels.push_plan(1) == (1, -1) and kernels.push_plan(6) == (0, 4)
    for epoch in (0, -1, 1.0, True):
        with pytest.raises(ValueError, match="epoch"):
            kernels.push_plan(epoch)


GPU = ("h", "gpu-a", ("gpu-b", "gpu-c", "gpu-d"))


@pytest.mark.parametrize("tuples,route", [
    ([GPU], "push"),
    ([("h", None, ())], "exchange"),
    ([("h", None, ()), ("h", None, ())], "exchange"),
    ([("h", "a", ("b",)), ("h", "b", ("a",))], "push"),
    ([("h", "a", ()), ("h", "b", ("a",))], "exchange"),
    ([("h", "a", ("b",)), ("g", "b", ("a",))], "exchange"),
    # Ring neighbours only: ranks 0 and 2 of four need no peer access.
    ([("h", "a", ("b", "d")), ("h", "b", ("a", "c")), ("h", "c", ("b", "d")),
      ("h", "d", ("c", "a"))], "push"),
    ([("h", "a", ("b", "c")), ("h", "b", ("a", "c")), ("h", "c", ("b", "d")),
      ("h", "d", ("c", "a"))], "exchange"),
    # Two ranks on one GPU reach each other's memory.
    ([("h", "a", ()), ("h", "a", ())], "push"),
])
def test_halo_route_rule(tuples, route):
    assert tmesh.halo_route(tuples) == route


def test_cpu_mesh_takes_the_exchange_route():
    # A CPU rank's memory is no GPU's peer memory: "exchange" at every
    # world size, decided without a collective (the mesh has no group).
    bsr = fdtt_banded(16, 1)
    for size in (1, 2):
        h = HaloBSROperator.from_bsr(bsr, 1, RowMesh(None, size, 0,
                                                     torch.device("cpu")),
                                     backend="pallas-remote")
        assert h.route == "exchange"
    assert HaloBSROperator.from_bsr(bsr, 1, RowMesh(
        None, 1, 0, torch.device("cpu")), backend="pallas").route == "exchange"


def fdtt_banded(nbr, bw, seed=1):
    from fortran_davidson_tpu_torch.ops.sparse import generate_banded_bsr
    return generate_banded_bsr(nbr, BS, bandwidth=bw, seed=seed, device="cpu")


def test_push_route_regrows_its_window(monkeypatch):
    # The push route on a one-rank CPU mesh whose topology reads as a GPU's
    # (the route rule sees a GPU tuple): each apply is one push, recorded
    # as the exchange's two sends; a wider block regrows the window to
    # twice its slots at least and starts its epochs again; offdiag shares
    # it.
    monkeypatch.setattr(tmesh, "peer_tuple", lambda device: GPU)
    bsr = fdtt_banded(16, 2)
    mesh = RowMesh(None, 1, 0, torch.device("cpu"))
    h = HaloBSROperator.from_bsr(bsr, 2, mesh, backend="pallas-remote")
    assert h.route == "push"
    rng = np.random.default_rng(5)
    sizes = []
    for m in (3, 3, 6, 20, 5):
        x = torch.from_numpy(rng.standard_normal((bsr.shape[0], m)))
        with scaling.record_collectives() as records:
            y = h.matmat(x)
        assert [r.kind for r in records] == ["collective-permute"] * 2
        assert records[0].shape == (2 * BS, m) and not records[0].moved
        torch.testing.assert_close(y, bsr.matmat(x), rtol=0, atol=1e-12)
        w = h._push["window"]
        sizes.append((w.slot_bytes, w.epoch))
    assert sizes == [(512, 1), (512, 2), (1024, 1), (2560, 1), (2560, 2)]
    off = h.offdiag()
    x = torch.from_numpy(rng.standard_normal((bsr.shape[0], 2)))
    torch.testing.assert_close(off.matmat(x), bsr.offdiag().matmat(x),
                               rtol=0, atol=1e-12)
    assert h._push["window"].epoch == 3


def test_a_rank_left_alone_faults_by_name(monkeypatch):
    # Two ranks, one of which never applies: the other's wait for its
    # pushed rows runs out and raises with its rank, epoch and slot.
    monkeypatch.setattr(kernels, "PUSH_SPIN_LIMIT_NS", 50_000_000)
    bw, m = 1, 3
    blocks = torch.zeros((4, BS, 3 * BS), dtype=torch.float64)
    windows = _ring_windows(2, kernels.window_slot_bytes(BS, m,
                                                         torch.float64))
    x = torch.ones((4 * BS, m), dtype=torch.float64)
    with pytest.raises(HaloPushFault, match="rank 1, epoch 1, slot top") as e:
        kernels.banded_remote_push_spmm(blocks, x, windows[1], bandwidth=bw,
                                        epoch=1)
    assert (e.value.rank, e.value.epoch, e.value.slot, e.value.wait) == (
        1, 1, "top", "arrived")
    assert windows[1].fault.tolist()[:5] == [1, 1, 1, kernels.TOP, 1]
    # A later call on that window raises at once, before anything runs.
    with pytest.raises(HaloPushFault):
        windows[1].raise_if_faulted()


@pytest.fixture
def one_rank_push(monkeypatch):
    """A one-rank gloo group in this process (no spawn) whose topology reads
    as a GPU's, so that "pallas-remote" takes the push route on the CPU;
    torn down after."""
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.parallel import multihost
    monkeypatch.setattr(tmesh, "peer_tuple", lambda device: GPU)
    assert not dist.is_initialized()
    mesh = multihost.initialize(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_a_skipped_epoch_in_a_solve_faults_by_name(one_rank_push,
                                                   monkeypatch):
    # A solve on the push route whose second apply skips an epoch (e + 2
    # for e): its pushers wait for consumed >= e, which never comes, and
    # the solve raises with the rank, epoch and slot instead of hanging.
    from fortran_davidson_tpu_torch.parallel import eigensolve_sharded
    monkeypatch.setattr(kernels, "PUSH_SPIN_LIMIT_NS", 50_000_000)
    step, calls = kernels.HaloWindow.next_epoch, []

    def skipping(window):
        e = step(window)
        calls.append(e)
        if len(calls) == 2:
            window.state["epoch"] = e = e + 2
            calls.append(e)
        return e
    monkeypatch.setattr(kernels.HaloWindow, "next_epoch", skipping)
    h = HaloBSROperator.from_bsr(fdtt_banded(16, 1), 1, one_rank_push,
                                 backend="pallas-remote")
    assert h.route == "push"
    with pytest.raises(HaloPushFault, match="rank 0, epoch") as e:
        eigensolve_sharded(h, 3, one_rank_push, max_dim_sub=12)
    assert len(calls) == 3
    assert (e.value.rank, e.value.epoch, e.value.wait) == (0, calls[-1],
                                                           "consumed")


@pytest.mark.parametrize("faulted", [True, False])
def test_a_cuda_error_after_a_trap_is_raised_by_name(one_rank_push,
                                                     monkeypatch, faulted):
    # On the card a trapped wait loses the context, and the error surfaces
    # at the next CUDA call, usually the loop's synchronisation: there the
    # solve raises the HaloPushFault of the window's record, from the CUDA
    # error. Without a record the error passes unchanged.
    from fortran_davidson_tpu_torch.core import loop
    from fortran_davidson_tpu_torch.parallel import eigensolve_sharded
    h = HaloBSROperator.from_bsr(fdtt_banded(16, 1), 1, one_rank_push,
                                 backend="pallas-remote")
    lost = RuntimeError("CUDA error: unspecified launch failure")

    def sync(st):
        if faulted:
            h._push["window"].fault.copy_(torch.tensor(
                [1, 0, 5, kernels.BOT, 1, 3, 0, 0]))
        raise lost
    monkeypatch.setattr(loop, "settle", sync)
    with pytest.raises(RuntimeError) as e:
        eigensolve_sharded(h, 3, one_rank_push, max_dim_sub=12)
    if faulted:
        assert isinstance(e.value, HaloPushFault)
        assert (e.value.rank, e.value.epoch, e.value.slot, e.value.wait) == (
            0, 5, "bot", "arrived")
        assert e.value.__cause__ is lost
    else:
        assert e.value is lost


def test_a_fault_record_is_told_on_stderr(monkeypatch, capfd):
    # The fault watch (started by the first card window) writes a record's
    # message to stderr as soon as it is set, once, without waiting for an
    # error: NCCL's watchdog may end a process before the solve raises.
    monkeypatch.setattr(kernels, "FAULT_WATCH_S", 0.001)
    kernels._watch_faults()
    window = kernels.HaloWindow.local("cpu", 256)
    window.fault.copy_(torch.tensor([1, 2, 7, kernels.TOP, 2, 5, 0, 0]))
    told = ""
    for _ in range(500):
        told += capfd.readouterr().err
        if "HaloPushFault" in told:
            break
        time.sleep(0.002)
    time.sleep(0.02)
    told += capfd.readouterr().err
    assert told.count("HaloPushFault: halo push: rank 2, epoch 7, slot top: "
                      "the wait for consumed ran out") == 1
    window.fault.zero_()


def test_push_kernel_checks_its_arguments():
    blocks = torch.zeros((8, BS, 3 * BS), dtype=torch.float64)
    x = torch.zeros((8 * BS, 2), dtype=torch.float64)
    window = kernels.HaloWindow.local("cpu", kernels.window_slot_bytes(
        BS, 2, torch.float64))
    call = kernels.banded_remote_push_spmm
    with pytest.raises(ValueError, match="too small"):
        call(blocks, torch.zeros((8 * BS, 40), dtype=torch.float64), window,
             bandwidth=1, epoch=1)
    with pytest.raises(ValueError, match="epoch must be"):
        call(blocks, x, window, bandwidth=1, epoch=0)
    with pytest.raises(ValueError, match="window must be a HaloWindow"):
        call(blocks, x, object(), bandwidth=1, epoch=1)
    with pytest.raises(ValueError, match="K == 2"):
        call(blocks, x, window, bandwidth=2, epoch=1)
    with pytest.raises(ValueError, match="x has"):
        call(blocks, x[:-1], window, bandwidth=1, epoch=1)
    meta = kernels.HaloWindow(rank=0, slot_bytes=window.slot_bytes,
                              ptrs=window.ptrs, fault=window.fault,
                              device="meta")
    with pytest.raises(ValueError, match="window on meta"):
        call(blocks, x, meta, bandwidth=1, epoch=1)
    with pytest.raises(ValueError, match="tensor memory"):
        kernels.banded_remote_push_spmm_plain(blocks, x, meta, bandwidth=1,
                                              epoch=1)
    assert window.epoch == 0 and window.flags(0).tolist() == [0] * 6


def _allocated_bytes(fn) -> int:
    """Bytes the ops inside ``fn()`` allocate on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as p:
        fn()
    return sum(max(e.cpu_memory_usage, 0) for e in p.key_averages())


@pytest.mark.parametrize("kind", ["xla", "pallas", "pallas-remote",
                                  "general"])
def test_sharded_diagonal_copies_no_block(kind):
    # A solve takes the operator's diagonal every iteration: the rank's
    # diagonal reads each slot's diagonal entries, never a copy of its
    # block table (at 10M rows in float64 that copy was 30.7 GB and ran
    # the world-size-1 solve out of memory), with the global diagonal's
    # bits.
    from fortran_davidson_tpu_torch.ops.sparse import generate_banded_bsr
    from fortran_davidson_tpu_torch.parallel.sharded import (
        ShardedBSROperator)
    A = generate_banded_bsr(64, 32, bandwidth=2, seed=3, device="cpu")
    for rank in range(2):
        mesh = RowMesh(group=None, size=2, rank=rank,
                       device=torch.device("cpu"))
        op = (ShardedBSROperator(A, mesh) if kind == "general"
              else HaloBSROperator.from_bsr(A, 2, mesh, backend=kind))
        assert _allocated_bytes(op.diagonal) < op.blocks.nbytes // 8
        assert torch.equal(op.diagonal(), A.diagonal()[mesh.rows(A.shape[0])])
