"""The card's peaks and the least time of a piece of work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit): HBM3 at 3.35 TB/s, and the operations
of each type. A roofline share is the least time (the larger of the
bytes over the bandwidth and the operations over the type's rate)
divided by the time measured; it cannot pass 100% unless the work is
counted too high or the time leaves part of the work out.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {
    "float64": 67e12,     # FP64 tensor cores (DMMA)
    "float32": 67e12,     # FP32 on the CUDA cores
    "tensorfloat32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}


def least_seconds(moved_bytes: float, flops: float, dtype: str) -> float:
    """The least time of work that moves ``moved_bytes`` through HBM and
    performs ``flops`` operations of ``dtype``."""
    return max(moved_bytes / HBM_BYTES_S, flops / PEAK_FLOP_S[dtype])
