"""Row-sharded solves over ``torch.distributed`` (counterpart of
``fortran_davidson_tpu/parallel/``): one process per device, the rows of
the operator and of the tall basis partitioned over the ranks, NCCL on
GPUs and gloo on the CPU.

Every collective is a call of ``RowMesh`` (``parallel/mesh.py``):
``parallel/scaling.py`` records them (the counterpart of the JAX
package's HLO inventory) for its row-locality audit and N-GPU
projection. Row-local (no collective grows with n): the halo operators
(``"xla"``, ``"pallas"``, ``"pallas-remote"``, the int8 one) and the
per-rank matrix-free rule. The dense, general BSR, ELL, sliced ELL and
hybrid rules all-gather x in every apply (n-scale by design).
"""

from fortran_davidson_tpu_torch.parallel.halo import (HaloBSROperator,
                                                     HaloQuantizedOperator)
from fortran_davidson_tpu_torch.parallel.mesh import (ROWS_AXIS, RowMesh,
                                                     default_mesh,
                                                     replicated, row_sharding)
from fortran_davidson_tpu_torch.parallel.sharded import (RowShardConstraint,
                                                        eigensolve_sharded,
                                                        shard_operator)

__all__ = [
    "HaloBSROperator",
    "HaloQuantizedOperator",
    "ROWS_AXIS",
    "RowMesh",
    "RowShardConstraint",
    "default_mesh",
    "eigensolve_sharded",
    "replicated",
    "row_sharding",
    "shard_operator",
]
