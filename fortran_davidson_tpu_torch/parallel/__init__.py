"""Row-sharded solves over ``torch.distributed`` (counterpart of
``fortran_davidson_tpu/parallel/``): one process per device, the rows of
the operator and of the tall basis partitioned over the ranks, NCCL on
GPUs and gloo on the CPU.

``fortran_davidson_tpu/parallel/scaling.py`` has no counterpart: it
audits the collectives of XLA's compiled HLO, and here the collectives
are the explicit calls of ``parallel/mesh.py`` and ``parallel/halo.py``.
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
