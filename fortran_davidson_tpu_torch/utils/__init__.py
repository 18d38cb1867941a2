"""Error contract, dtype policy and small dense linear algebra."""
from fortran_davidson_tpu_torch.utils import (debugging, dtypes, errors, io,
                                              linalg, observability)
from fortran_davidson_tpu_torch.utils.dtypes import (canonical_dtype,
                                                     ensure_x64,
                                                     safe_denominator)
from fortran_davidson_tpu_torch.utils.errors import (
    DavidsonError,
    InvalidOptionsError,
    NumericalError,
    OperatorError,
    require,
)

__all__ = [
    "debugging",
    "dtypes",
    "errors",
    "io",
    "linalg",
    "observability",
    "canonical_dtype",
    "ensure_x64",
    "safe_denominator",
    "DavidsonError",
    "InvalidOptionsError",
    "NumericalError",
    "OperatorError",
    "require",
]
