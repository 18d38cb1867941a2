"""fortran_davidson_tpu_torch — the block-Davidson eigensolver in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``fortran_davidson_tpu`` (JAX on a TPU), module path for module
path. It runs the default solve, ``eigensolve(A, k)`` with default
options (DPR, float64, doubling expansion, CholeskyQR2, sticky
convergence), plus Olsen and GJD (block MINRES) corrections, the refined
double-single path with its final polish (``refined``, ``final_polish``,
:func:`polish_eigenpairs`), lowest-k expansion, generalized pencils, warm
starts and the incremental-H engine (``fused_gram``), on dense, diagonal,
matrix-free, block-sparse (BSR, f64/f32/bf16 storage), int8 banded,
padded and sliced ELL and hybrid band+remainder operators (scipy sparse
input becomes ELL), and the row-sharded solve over ``torch.distributed``
(:mod:`fortran_davidson_tpu_torch.parallel`). Their SpMM (and fused
SpMM+Gram) runs in the CUDA kernels of ``csrc/`` on a GPU and in their
plain PyTorch versions on the CPU. Entry points build on the GPU unless
given ``device="cpu"``. Options of later slices raise
:class:`InvalidOptionsError`.

Command line: ``python -m fortran_davidson_tpu_torch
{solve,demo,benchmark,northstar}`` (``__main__.py``, the drivers in
``examples/``), on the GPU unless given ``--platform cpu``.
"""

from fortran_davidson_tpu_torch.config import DavidsonOptions, DavidsonResult
from fortran_davidson_tpu_torch.ops.operators import (
    DenseOperator,
    DiagonalOperator,
    LinearOperator,
    MatrixFreeOperator,
    SubtractDiagOperator,
    as_operator,
    from_element_fn,
    probe_diagonal,
)
from fortran_davidson_tpu_torch.ops.sparse import (
    BSROperator,
    ELLOperator,
    HybridBandedOperator,
    QuantizedBandedOperator,
    SlicedELLOperator,
    generate_banded_bsr,
    generate_banded_bsr_quantized,
    generate_local_sparse,
    generate_sparse_diagonal_dominant,
    quantize_banded_int8,
    split_band_remainder,
)
from fortran_davidson_tpu_torch.solver import (eigensolve,
                                               generalized_eigensolver,
                                               polish_eigenpairs)
from fortran_davidson_tpu_torch.utils.dtypes import default_device
from fortran_davidson_tpu_torch.utils.errors import (DavidsonError,
                                                     DeviceUnavailableError,
                                                     InvalidOptionsError,
                                                     NumericalError,
                                                     OperatorError)

__version__ = "0.1.0"

__all__ = [
    "BSROperator",
    "DavidsonError",
    "DavidsonOptions",
    "DavidsonResult",
    "DenseOperator",
    "DeviceUnavailableError",
    "DiagonalOperator",
    "ELLOperator",
    "HybridBandedOperator",
    "InvalidOptionsError",
    "LinearOperator",
    "MatrixFreeOperator",
    "NumericalError",
    "OperatorError",
    "QuantizedBandedOperator",
    "SlicedELLOperator",
    "SubtractDiagOperator",
    "as_operator",
    "default_device",
    "eigensolve",
    "from_element_fn",
    "generalized_eigensolver",
    "generate_banded_bsr",
    "generate_banded_bsr_quantized",
    "generate_local_sparse",
    "generate_sparse_diagonal_dominant",
    "polish_eigenpairs",
    "probe_diagonal",
    "quantize_banded_int8",
    "split_band_remainder",
    "__version__",
]
