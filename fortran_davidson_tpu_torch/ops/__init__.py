"""Linear operators and the CUDA SpMM kernels of the BSR operator."""
