"""fortran_davidson_tpu_torch — the block-Davidson eigensolver in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``fortran_davidson_tpu`` (JAX on a TPU), module path for module
path. This first slice runs the default solve, ``eigensolve(A, k)`` with
default options (DPR, float64, doubling expansion, CholeskyQR2, sticky
convergence), plus Olsen, lowest-k expansion, generalized pencils and
warm starts, on dense, diagonal, matrix-free and block-sparse (BSR)
operators. The BSR operator's SpMM runs in the CUDA kernels of
``csrc/bsr_spmm.cu`` on a GPU and in their plain PyTorch versions on the
CPU. Options of later slices raise :class:`InvalidOptionsError`.
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
from fortran_davidson_tpu_torch.ops.sparse import (BSROperator,
                                                  generate_banded_bsr)
from fortran_davidson_tpu_torch.solver import eigensolve, generalized_eigensolver
from fortran_davidson_tpu_torch.utils.errors import (DavidsonError,
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
    "DiagonalOperator",
    "InvalidOptionsError",
    "LinearOperator",
    "MatrixFreeOperator",
    "NumericalError",
    "OperatorError",
    "SubtractDiagOperator",
    "as_operator",
    "eigensolve",
    "from_element_fn",
    "generalized_eigensolver",
    "generate_banded_bsr",
    "probe_diagonal",
    "__version__",
]
