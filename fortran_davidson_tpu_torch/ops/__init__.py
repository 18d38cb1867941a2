"""Linear operators and the CUDA kernels of the block-sparse operators."""

from fortran_davidson_tpu_torch.ops.operators import (
    DenseOperator,
    DiagonalOperator,
    LinearOperator,
    MatrixFreeOperator,
    as_operator,
    probe_diagonal,
)
from fortran_davidson_tpu_torch.ops.sparse import (
    BSROperator,
    QuantizedBandedOperator,
    generate_banded_bsr,
    generate_banded_bsr_quantized,
    quantize_banded_int8,
)

__all__ = [
    "BSROperator",
    "QuantizedBandedOperator",
    "quantize_banded_int8",
    "DenseOperator",
    "DiagonalOperator",
    "LinearOperator",
    "MatrixFreeOperator",
    "as_operator",
    "generate_banded_bsr",
    "generate_banded_bsr_quantized",
    "probe_diagonal",
]
