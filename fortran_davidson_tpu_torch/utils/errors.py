"""Error contract for the PyTorch port.

The same exception classes as ``fortran_davidson_tpu.utils.errors``: the
reference aborts with the failing routine's name on any LAPACK
``info /= 0`` (``src/lapack_wrapper.f90:395-408``); the port raises named
Python exceptions at validation time and guards runtime numerics in the
tensor code (see ``utils.dtypes.safe_denominator``).
"""

from __future__ import annotations


class DavidsonError(RuntimeError):
    """Base class for solver errors."""


class InvalidOptionsError(DavidsonError, ValueError):
    """Raised when solver options are inconsistent, or name a feature the
    port does not have yet (the message names the option)."""


class OperatorError(DavidsonError, ValueError):
    """Raised for malformed linear operators (shape/dtype/symmetry issues)."""


class NumericalError(DavidsonError, ArithmeticError):
    """Raised when a numerical routine produced non-finite results — the
    eager equivalent of the reference's ``check_lapack_call`` abort
    (``src/lapack_wrapper.f90:395-408``)."""


def require(cond: bool, exc_type: type, msg: str) -> None:
    if not cond:
        raise exc_type(msg)
