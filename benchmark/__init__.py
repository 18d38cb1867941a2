"""The benchmark of ``fortran_davidson_tpu_torch`` on NVIDIA H100s: timed
complete solves of the cells of the repository's ``BENCHMARK.json``
(``python3 -m benchmark.run``; see ``README.md`` in this folder). It
imports the port only, never JAX or the JAX package."""
