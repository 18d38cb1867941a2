"""Kernels 6 and 7 of the port (the shard-local contractions of the
row-sharded solve) against the JAX package's Pallas kernels, which run in
interpret mode on the CPU (their default off the TPU).

On the CPU the port's wrappers take their plain versions (an unfold of
the halo-extended input into (nbr, K*bs, m) windows and a ``torch.bmm``);
the CUDA kernels are held to those plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Inputs are numpy,
seeded. Tolerances relative to max|Y|: 1e-12 in float64 (summation order
only), 1e-5 in float32 and for bf16 storage summed in float32; the int8
kernel rtol = atol = 2e-5, as ``tests/test_quantized.py`` holds the JAX
halo operator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
