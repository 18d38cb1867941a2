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

__all__ = [
    "BSROperator",
    "HybridBandedOperator",
    "QuantizedBandedOperator",
    "SlicedELLOperator",
    "quantize_banded_int8",
    "generate_local_sparse",
    "split_band_remainder",
    "DenseOperator",
    "DiagonalOperator",
    "ELLOperator",
    "LinearOperator",
    "MatrixFreeOperator",
    "as_operator",
    "generate_banded_bsr",
    "generate_banded_bsr_quantized",
    "generate_sparse_diagonal_dominant",
    "probe_diagonal",
]
