"""Text I/O helpers (counterpart of ``fortran_davidson_tpu/utils/io.py``).

The reference's test harness persists vectors and matrices as whitespace
text files and reads them back (``src/tests/test_utils.f90:118-167``:
``read_matrix``, ``write_vector``, ``write_matrix``). The port keeps the
same plain-text interchange format (one matrix row per line, whitespace
separated, C ordering), so a file written by either package reads back
bit for bit through the other. Tensors are written from the host; the
readers return numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def write_vector(path, vector) -> None:
    """Write a 1-D vector as whitespace-separated text (one line)."""
    np.savetxt(path, _host(vector).reshape(1, -1))


def write_matrix(path, matrix) -> None:
    """Write a 2-D matrix as text, one row per line."""
    np.savetxt(path, _host(matrix))


def read_vector(path, dtype=np.float64) -> np.ndarray:
    return np.loadtxt(path, dtype=dtype).reshape(-1)


def read_matrix(path, dtype=np.float64) -> np.ndarray:
    """Read a whitespace-text matrix (``src/tests/test_utils.f90:118-135``)."""
    return np.atleast_2d(np.loadtxt(path, dtype=dtype))
