"""Problem generators."""
from fortran_davidson_tpu_torch.models.generators import (  # noqa: F401
    bse_surrogate, low_rank_offdiag_apply_ds, low_rank_plus_diag_apply, surrogate_hamiltonian,
    surrogate_overlap)
