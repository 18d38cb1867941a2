#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fortran_davidson_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: requires CUDA (exit 1 without it); prints torch, CUDA and the
   card's name and power limit.
2. Build: compiles every source under ``csrc/`` with nvcc for sm_90a (one
   nvcc per source, started together); prints ptxas's registers of every
   instantiation of csrc/fused_gram_typed.cuh (``typed_gram_kernel``:
   kernel 3's bf16 and float64 entries, kernel 5's int8 ones with float64
   x, row 5d, and bf16 x, the bf16-dequant variants), of kernel 1, its
   variants and kernels 8 and 2 on kernel 1's template (with their
   static shared memory and their ring's bytes), of the float64-x entries
   of kernels 4 and 7 on the same template (int8 slab; with their ring),
   of the fused kernels 3 and 5, and of kernel 4's float32 entry (with its
   layout).
3. Kernels against their plain PyTorch versions on the same tensors on
   the card, with CUDA-event times (median of 7) of both:
   - the SpMM kernels (1, 2): max relative error <= 1e-12 in float64 and
     <= 1e-5 in float32 and with bf16 storage (summed in float32 by both);
     kernel 1 (``csrc/banded_spmm.cu``) also on ragged shapes (bs 24, bw
     3, m 1-320), on x framed by NaN rows, and giving the same bits twice;
     kernel 2 (``csrc/bsr_spmm.cu``, kernel 1's template with a column
     table) giving the same bits twice and, on the DIA table (out-of-range
     columns included), kernel 1's bits in every type; and on the
     block-permuted 1M-row matrix P A Pᵀ (``PERM_SEED``, the tables
     permuted on the card), whose columns have no band, at f64 m = 6, 24,
     48, 320: against its plain version, bit for bit against P (kernel 2
     on A) Pᵀ, timed beside the plain version and cuSPARSE (the permuted
     matrix as a ``torch.sparse_bsr_tensor``), with its bound for x read
     once and for x gathered K times;
   - kernel 1's variants (``kernels.banded_spmm_variant``) against their
     plain versions, then its split timed in turns at the main case (f64
     m=48) and at the probes' shape (``PROBE``, bf16): kernel 1, ``noy``,
     ``copy``, ``writeonly`` (fresh and into x's own buffer),
     ``torch.Tensor.fill_``, ``rows_per_cta`` 2/4, ``stages`` 2/3/6,
     ``store="tma"``, ``block_policy="evict_first"``, and at the probes'
     shape kernel 4 on its int8 quantization; the copy variant (kernel 9,
     ``bench.py:85``) with its GB/s against 3.35 TB/s at f64 m=48 and 320,
     bench.py's f32 shape and the probes' bf16; kernel 5 with v=None,
     full against ``nogram`` (``r4_visx_probe2.py``'s modes);
   - kernels 4, 5 and 7 with float64 x, ragged and at full size, within
     ``Q64_TOL`` of their plain versions, each timed at full size (int8
     m = 20, 40; kernel 5 at mv = 220, also beside its unfused yardstick,
     kernel 4 then ``torch.matmul(v.T, y)``) beside its plain version;
     kernels 4 and 7 (``csrc/q_spmm_f64.cu``, ``csrc/q_ext_spmm_f64.cu``)
     also on x framed by NaN
     rows (kernel 4's Y finite), the same bits twice, kernel 7 over the
     one slab's x_ext equal to kernel 4 bit for bit, and on the band alone
     within ``Q64_TOL`` of max|Y_band|, a limit the band faults exceed;
   - kernel 3's bf16 and float64 entries (rows 3b, 3d:
     ``csrc/fused_gram_typed.cuh``) at its main case's shape (m=128,
     mv=1408) against the plain version (Y within TOL; G within GRAM_TOL
     of |V|ᵀ|Y|; the same bits twice), timed beside it, the unfused
     yardstick (kernel 1 + matmul) and their measurement variants
     (``nov``, ``nogram``), with the plan the wrapper takes;
   - the new kernels (3: banded SpMM+Gram, 4: int8 banded SpMM, 5: int8
     SpMM+Gram) in every variant (``v`` given or None, ``write_out``),
     on a ragged small matrix, on the 2,097,152-row int8 matrix (4, 5)
     and on the 1,048,576-row matrix in float32 (3): Y within 1e-5 of
     max|Y|, and G elementwise within 1e-5 * (|V|ᵀ|Y|) (G sums ~10⁶
     products with cancellation, so max|G| is the wrong yardstick); the
     G reduction must give the same bits twice. Float32 kernel 3 and
     kernel 5 are the tensor-core kernels of ``csrc/fused_gram.cu``; at
     their main cases (f32 m=128 mv=1408, int8 m=20 mv=220) they are
     also timed beside their measurement variants ``nov`` (no V) and
     ``nogram`` (V streamed, no gram product), which split their time
     into apply, V stream and gram, and beside the unfused yardstick
     (kernel 1 or 4, then ``torch.matmul(v.T, y)`` in full float32).
     Kernel 4's float32 entry is kernel 5's apply (``csrc/q_spmm.cu``);
     it is also held on the int8 band alone (the diagonal zeroed: with it,
     the band is ~1e-6 of max|Y|, under the limit), ragged and at full
     size, within 1e-5 of max|Y_band|, a limit that outputs with a fault in
     the band (dropped, a slot dropped, the slots reversed, one scale a
     block row; made by the plain version) must exceed;
   - kernel 5's bf16-dequant variants (``experiments/fused_probe.py``'s
     ``bf16deq``, ``tg_bf16deq``, ``nov_bf16``) against their plain
     versions, on the operator and on its band alone, G within 1e-5 of
     |V|ᵀ|Y| (a limit that a G of zeros, a G over half the rows and, on
     the band alone, the band faults above must exceed), the same bits
     twice, and timed in turns beside kernel 5, ``nov`` and ``nogram`` at
     the probe's shape (``PROBE``, m = mv = 256) and at kernel 5's main
     case (int8 m=20 mv=220);
   - the halo kernels (6: banded SpMM over a shard's halo-extended rows,
     on kernel 1's design, its TMA route where ``kernels.ext_spmm_route``
     allows, else kernel 1's cp.async template; 7: its int8 form, float32
     x on kernel 4's apply), ragged and at full size (f64 m = 6-160 beside
     kernels 1 and 8 at the same widths, with each width's route; int8
     m = 20, 40), x_ext framed by NaN rows; kernel 6's two routes timed in
     turns at its main case (f64 m=40), each call alone and 10 calls back
     to back, beside the one-call bmm yardstick, with the host time of a
     call on each route; both kernels on the band alone (kernel 6's centre
     slot zeroed, kernel 7's diagonal zeroed, the tables rolled by half
     the shard so that its edge rows read the halos), ragged and at the
     main case, within TOL of max|Y_band|, a limit that outputs with a
     fault (band dropped, slot 0 dropped, slots reversed, halo rows
     zeroed; made by the plain version) must exceed; and four shards on
     one card: both matrices cut into four row slabs, each applied by
     kernel 6/7 to its ring-wrapped x_ext; put together they must equal
     kernel 1 on the whole matrix bit for bit in f64, f32 and bf16
     storage, and kernel 4's Y exactly.
   - kernel 8 (kernel 1's template over a shard's rows and its two halos
     through three pointers, in the halo operator's interior and edge
     launches, each part in a buffer of its own framed by NaN rows), ragged
     and at full size (m = 6-160) in f64, f32 and bf16 storage, against its
     plain version and bit for bit against kernel 1 on the same rows and
     kernel 6; and in the four-slab check, each slab's rows
     in a buffer of its own and its halos pointing into its ring
     neighbours' buffers (no x_ext), equal to kernel 1 bit for bit in f64,
     f32 and bf16;
   - kernel 8's one-launch form (``banded_remote_push_spmm``) at world
     size 1, its edge rows pushed into its own window (``RowMesh.
     open_window``: cudaMalloc'd, its IPC handle taken), at the same
     shapes and types: against its plain version (the same dataflow on a
     window of tensor memory), bit for bit against kernel 6 on the
     wrapped x_ext and against itself on the other buffer, timed beside
     kernel 8's two launches;
   - double-single on the card: ``two_sum`` and ``two_prod`` on
     ``DS_PAIRS`` float32 pairs from 2**-100 to 2**100 (two_prod from
     2**-40, its partial products normal) exact against float64 and
     equal to the CPU's bits; the int8 ``offdiag().matmat_ds`` at m=20
     (plain PyTorch, no kernel) within 5e-10 of a float64 oracle on
     ``DS_ORACLE_ROWS`` (unit columns), timed beside kernel 4's
     ``matmat``.
4. Main path: ``eigensolve(A, 3)`` and ``eigensolve(A, 20)`` with default
   options on the 1,048,576-row banded BSR matrix
   ``generate_banded_bsr(8192, 128, bandwidth=1, coupling=1e-3, seed=0)``
   in float64. Each converges at 1e-8 with a true residual (taken with the
   plain SpMM) <= 1e-8, and matches the same solve run through the plain
   versions: same iteration count, eigenvalues to 1e-9; prints the warm
   walls of both paths (the median of ``WARM_SOLVES`` each, in turns)
   beside those of kernel 1 on the shared SIMT tile, before its rebuild
   (``TILE_K1_WALLS_MS``), and one more kernel-path solve under
   ``torch.profiler``: the device's busy time, its idle share of the
   wall, and the device ops that took the most time. Every solve prints
   the host events inside it (cudaMalloc / cudaFree, allocator retries,
   garbage collections).
4b. GJD through kernel 1 on phase 4's matrix (``GJD_CASES``): lowest-3
   with default GJD options and lowest-20 with
   ``gjd_preconditioner="dpr"``, every outer and MINRES apply a launch of
   kernel 1. Each converges at 1e-8 with a true residual <= 1e-8,
   eigenvalues within 1e-9 of phase 4's DPR solve, and the plain path's
   outer iterations, its inner totals within one step per corrected
   column per outer iteration; prints cold and warm walls (the median of
   ``WARM_GJD`` in turns), kernel 1's launches, ``inner_iterations``
   and the host reads a solve (one an outer iteration plus MINRES's
   polls), and one profiled solve.
5. Collapse and generalized legs at the same size: coupling 0.1 with
   ``max_dim_sub=12`` (must collapse), a pencil with a diagonal B, and a
   BSR without a declared bandwidth (the general kernel); the
   block-permuted matrix P A Pᵀ of phase 3 through the general kernel,
   lowest-3, which must take phase 4's iterations to phase 4's
   eigenvalues within 1e-9 with a true residual <= 1e-8 (its warm wall,
   the median of ``WARM_SOLVES``, beside phase 4's); plus a small solve
   checked against a dense ``eigvalsh``.
6. The int8 loose stage of the JAX package's sparse north star
   (``bench.py:615-672``): lowest-20 of
   ``generate_banded_bsr_quantized(16384, 128, bandwidth=1,
   coupling=1e-3, seed=0)`` (n = 2,097,152) in float32, lowest-k,
   relative tolerance 1e-3. It converges through kernel 4, with a true
   relative residual (float64, dequantized blocks plus the diagonal)
   <= 1e-3, and the same solve through the plain version takes the same
   iterations, eigenvalues to 1e-4 relative; prints the warm walls beside
   the iterations. Then the float64 leg: the
   default float64 type at relative 1e-6 through kernel 4's float64-x
   entry (``banded_q_bsr_spmm_f64``), the plain path's iterations, a true
   relative residual <= 1e-6; the launches of kernels 4, 5 and 7 on it.
6b. The refined stage of that north star (``REFINED``, bench.py:663-668:
   ``refined=True, final_polish=3`` at relative 1e-8, lowest-20) from
   phase 6's loose eigenvectors: every ``matmat`` through kernel 4 (the
   true residuals apply ``offdiag()``), the polish through ``matmat_ds``.
   It converges with an oracle relative residual <= 1e-8 (float64,
   dequantized blocks plus the diagonal, normalized vectors, eigenvalues
   ``eigenvalues + eigenvalues_lo``); the same stage on a
   ``QuantizedBandedOperator`` whose applies take kernel 4's plain
   version takes iterations within ±2, eigenvalues within the sum of the
   two residuals; prints the iterations beside the JAX package's TPU
   run's 8, cold and warm walls, loose + refined, the memory above the
   operator, one profiled solve.
6c. The JAX package's ``slow`` noise-gate tests (tests/test_noise_gate.py)
   on ``surrogate_hamiltonian(1_000_448, float32)``, matrix-free, no
   kernel: lowest-4 refined with final_polish=3 at absolute 1e-8
   (converged, max residual < 1e-8, eigenvalues 1-4 within 1e-6), and at
   relative 1e-7 without the polish the stall exit within 40 iterations.
7. The fused SpMM+Gram engine, on the 1M-row matrix at coupling 3 in
   float32 (at coupling 1e-3 lowest-128 converges on its initial basis,
   with no expansion to fuse): (a) ``fused_gram="auto"`` engages at
   lowest-128 through kernel 3 over several expansions, at m_max = 1408
   and with a collapse (``max_dim_sub=256``), converges with a true
   relative residual <= 1e-3, and matches ``fused_gram="off"``:
   iterations ±2, and each eigenvalue pair within the sum of the two
   solves' true residuals (the float32 H of the two engines parts at
   roundoff, ~1e-4 here, so that is what the residuals certify); (b)
   fixed-iteration A/Bs against ``"off"``, per-iteration walls printed:
   k=128 on the same matrix (``"auto"``, four iterations) and, as
   ``bench.py:701-716`` runs it, k=20 on the int8 matrix (``"on"``,
   kernel 5, eight iterations, eigenvalues to 1e-5 relative).
7c. The solve that ``fused_gram="auto"`` sends to row 3b: phase 7's
   lowest-128 on ``A3.astype(torch.bfloat16)``. ``"off"`` at phase 7's
   relative 1e-3 decides the tolerance (1e-3 if its true residual reaches
   it, else ``BF16_SOLVE_TOL`` = 1e-2); ``"auto"`` at 1e-3 must stall
   (ROADMAP Queue 3's open fault, shown); those were the cold solves;
   then ``"auto"`` and ``"off"`` in turns at that tolerance, two warm
   solves each: both converge
   with true residuals (float64, the bf16 blocks) within it, iterations
   ±2, eigenvalues within the sum of the residuals, row 3b launched under
   "auto" only; every wall and one profiled split (kernel 3's share, the V
   casts' share) printed.
8. The row-sharded solve at world size 1 over a one-rank NCCL group
   (``parallel.multihost.initialize``, ``file://`` store), a cold and
   two warm solves of each case, each held to phase 4's or 6's
   single-device solve (same iterations, eigenvalues to 1e-10 / 1e-5
   relative, true residuals); the shards are views of the global tables.
   (a) Lowest-3 and lowest-20 on the 1M-row matrix as a
   ``HaloBSROperator(backend="pallas")`` (kernel 6), the int8 loose
   stage through ``shard_operator`` (kernel 7), and phase 6's float64
   leg sharded (kernel 7's float64-x entry, ``banded_q_ext_bsr_spmm_f64``,
   which must launch; phase 6's float64 iterations, eigenvalues and true
   relative residual within 1e-6); kernels 1 and 4 never launch; times the
   ring exchange. (b) Lowest-3 and lowest-20
   through ``backend="pallas-remote"`` (kernel 8 on its ``"push"``
   route: one launch an apply pushes the halos into the rank's own
   window, no x_ext, no ring exchange); kernels 1 and 6 and kernel 8's
   two-launch form never launch.
9. One halo apply of the ``"pallas-remote"`` path (the push route)
   against the
   ``"pallas"`` path at m = 20, 40, 160: the same bits; CUDA-event and
   host-clock times of both, in turns, of the ring exchange alone and of
   the all-gather exchange it replaced, and of the ``"pallas"`` path's
   two other parts alone: the ``torch.cat`` into x_ext and kernel 6.
10. The north stars at 10M rows and the entry points, each a solve phase
   counted as phases 4-8 are, run once A, A32 and q are freed:
   (a) ROADMAP item 14: lowest-20 of ``surrogate_hamiltonian(10_000_384,
   float32)`` through ``examples/northstar.py``'s progressive recipe
   (``NORTHSTAR_ARGV``, bench.py:574-612's), a cold, a warm and (the
   12 GB budget's width) a profiled run, first under the JAX package's 12 GB
   budget (``FDT_CARRY_BUDGET_BYTES``; the width must resolve to its 44),
   then at the port's own width; each converges with an oracle relative
   residual <= 1e-8 (float64 promotion of the stored float32 operator,
   the polish's hi + lo vectors and eigenvalues; the float32 words alone
   and the float64 surrogate are printed beside it), and its eigenvalues
   within 1e-8 relative of a plain float64 DPR solve of the float64
   surrogate at the 12 GB budget's width (the A/B; cold, warm and
   profiled; at the port's own width that solve stops at a fixed point above 1e-8,
   ROADMAP Queue 3: shown, not gated). Prints the resolved widths, the
   refined iterations beside the JAX package's 17, walls, peak memory,
   the idle share. (b) ROADMAP item 15: lowest-20 of
   ``generate_banded_bsr_quantized(78_125, 128)`` (n = 10,000,000, int8,
   built on the host, its time apart) through ``--mode banded --quantize
   --progressive``: cold, warm and profiled runs through kernel 4, the
   oracle relative residual of phase 6b (over ``ORACLE_ROWS`` block rows
   at a time) <= 1e-8. (c) ``python -m fortran_davidson_tpu_torch
   solve`` on a 200-row .npy in a subprocess (its JSON line within 1e-9
   of scipy), and ``examples/northstar.py --mode banded`` at 1,048,576
   rows (bf16 storage, kernel 1), which must exit 0.
12. The ELL family at 1M rows, after phase 10 (each sub-phase a solve
   phase counted as the others; every build on the host timed apart):
   (a) BASELINE config 3, ``generate_sparse_diagonal_dominant(1_000_000,
   50, seed=0)``'s COO as a scipy CSR matrix handed to
   ``fdtt.eigensolve(csr, 10)`` with default options: ``as_operator``
   assembles an ``ELLOperator`` natively (the ELL width, the native
   library's state and calls printed), plain PyTorch gathers, no kernel;
   converged, true residual (float64, through the operator) <= 1e-8; the
   same solve on the card machine's CPU within 1e-10 relative and ±1
   iteration (at ``CONFIG3_CUT_N`` rows, printed as cut, when one CPU
   apply says the CPU solve would take over ``CPU_BUDGET_S``, 10 s,
   which keeps the run's time with phase 15 in it); one ELL
   apply at m = 10 against one ``SlicedELLOperator.from_ell`` apply.
   (b) ``split_band_remainder`` of ``generate_local_sparse(1_000_000, 12,
   locality=95, seed=7)`` (bs 128, bw 1, sliced-ELL remainder, n_pad
   1,000,064), lowest-10 in float64 to 1e-8 on the kernels and on the
   plain path in turns: kernel 1 launched on the kernel path only, the
   same iterations, eigenvalues within 1e-10 relative, no padding pair;
   the band fraction; the unsplit ``ELLOperator``: the same eigenvalues,
   iterations ±1, its walls beside the hybrid's. (c) That COO scrambled
   by ``np.random.default_rng(8).permutation``: the band fraction
   without a reordering and with ``reorder="rcm"`` (native RCM timed),
   the reordered solve at 12b's eigenvalues, kernel 1 launched, the
   ``unpermute``d eigenvectors' true residuals against the scrambled COO
   <= 1e-8. (d) ``eigensolve_sharded`` of 12b's operator at world size 1
   over NCCL: kernel 2 launched (kernel 1 not), 12b's iterations and
   eigenvalues. (e) The refined recipe of
   tests/test_ds_apply_sparse.py:141-164 on the float32 hybrid of the
   same COO (``dtype=float32``): lowest-4, relative 1e-8, ``refined=True,
   final_polish=3`` from a loose warm start, through kernel 1's float32
   entry; oracle relative residual against the float64 promotion <= 1e-8.
   Each prints iterations, true residual, cold and warm walls, peak
   memory and host build time.
13. Chebyshev restarts, locking, eigsh, matmul_precision and the batched
   solve, after phase 12, on phase 4's matrix A rebuilt, phase 7's
   coupling-3 float32 storage C32 and its float64 promotion C (each
   sub-phase a solve phase; cold and warm walls): (a) lowest-20 of C,
   lowest-k, ``max_dim_sub=80``, unfiltered, ``cheb_degree=8`` and
   ``"auto"``: converged, true residuals <= 1e-8, eigenvalues within
   1e-9 relative of the unfiltered solve's, the unfiltered solve
   collapsing twice or more and the filtered ones once or more; a
   counted solve of each (the operator behind a wrapper) holds kernel
   1's launches to the applies, 1 + 12 single-column Lanczos applies
   (filtered only) + one an expansion + degree + 1 a filtered collapse,
   and ``operator_columns`` to the nonzero columns applied less the
   bound's 12. (b) lowest-20 DPR on C (lowest-k) and lowest-3 GJD on A,
   each without and with ``locking=True``: the same eigenvalues within
   1e-9, not stalled, true residuals <= 1e-8, locking's
   ``operator_columns`` no more. (c) ``eigsh`` on A: "SA" k=6 within
   1e-9 of phase 4's lowest-6, "LA" k=6, "BE" k=6 and ``sigma`` the
   median of the diagonal, k=4 (the spectral fold), each with true
   residuals <= 1e-8 on the card; kernel 1's launches a call. (d) a
   float32 lowest-20 on C32 at relative 1e-2 under the default,
   ``"tensorfloat32"``, ``"bfloat16"`` and the default again:
   eigenvalues within 1e-2 relative of (a)'s float64 solve, every CUDA
   matmul flag the same before and after each solve and after a solve
   made to raise, the default's bits the same before and after; one
   (n, 20)ᵀ(n, 20) float32 GEMM's error against float64 under each
   ``matmul_precision`` name. (e) ``eigensolve_batched`` of 64
   ``generate_diagonal_dominant(1024, 1e-3)`` matrices (seeds 0-63),
   lowest-3 to 1e-9, and with diagonal B's: each problem's eigenvalues
   within 1e-12 of its single solve's, its iterations equal; the batch
   wall beside the sum of the single walls (no kernel).
14. Checkpoint and resume, observability, debugging and the sharded
   refined path, right after phase 8b (each sub-phase a solve phase;
   checkpoints under ``chiprun_out/``, deleted at the end): (a)
   ``eigensolve_checkpointed`` of phase 4's matrix, lowest-3 and
   lowest-20 every 2 iterations (a callback keeps the newest step only):
   the one-shot ``eigensolve``'s eigenvalues, residual history,
   iterations and operator columns bit for bit; the same solve
   interrupted by a callback after its first save, then resumed: the same
   bits, and kernel 1's launches of both runs equal to the one-shot
   solve's; bytes a save, each save's and the restore's seconds, the
   walls; ``ConvergenceLogger`` one record a chunk, as
   the residual history; ``profile_trace`` around a warm lowest-3 solve
   writes a trace holding kernel 1's events and an ``annotate`` span;
   ``nan_trap`` raises ``FloatingPointError`` with one diagonal block of
   the matrix set to NaN (restored after). (b) phase 6b's refined stage
   row-sharded at world size 1 over NCCL: kernel 7's float32-x entry
   launched, iterations within ±2 of 6b's, the oracle <= 1e-8,
   eigenvalues within 1e-9 relative of 6b's; walls and the idle share.
   (c) ``eigensolve_checkpointed(..., mesh=mesh)`` through
   ``HaloBSROperator(A, "pallas")``, lowest-3, interrupted after its
   first save and resumed: phase 8a's iterations and eigenvalue bits,
   kernel 6's launches of both runs the one-shot sharded solve's.
15. The rest of ROADMAP item 19 at world size 1 over NCCL (each
   sub-phase a solve phase): (c) right after 14c,
   ``orthonormalization="qr"`` (the TSQR) through ``HaloBSROperator(A,
   "pallas")``, lowest-3 and lowest-20, beside the one-device ``"qr"``
   solve through kernel 1: the same iterations and eigenvalue bits,
   kernel 6's launches the counted applies; (d) the float64 surrogate
   pencil (``surrogate_overlap``) at 1,000,448 rows, lowest-4, through
   the per-rank callables: the one-device iterations and eigenvalue
   bits, true residual <= 1e-8, no kernel; (a) right after 10a, on a
   fresh one-rank group, 10a's surrogate through ``northstar --mode free
   --sharded --polish 2`` at the 12 GB budget's width and the float64
   DPR solve: 10a's iterations (refined and plain), the float64
   eigenvalues within 1e-12 relative of 10a's, the oracle after the
   per-rank polish <= 1e-8, no kernel; walls, idle share and peak memory
   beside 10a's; (b) right after 10b, 10b's operator (not built again)
   through ``--mode banded --quantize --sharded --progressive --polish
   2`` at 10b's width: kernel 7 on the ring exchange's x_ext, its
   launches the counted applies, refined iterations within ±2 of 10b's,
   eigenvalues within 1e-10 relative, the oracle after the polish <=
   1e-8, and one kernel 7 call at m = 20 against its plain version.
16. The scaling audit (``parallel/scaling.py``) at world size 1 over
   NCCL (each sub-phase a solve phase): (a) after 15d, the collective
   inventory of one refined iteration (the probe's options: lowest-20,
   float32, max_dim_sub 44) of phase 6's int8 matrix (2,097,152 rows,
   kernel 7), and after 15b the same of 10b's 10,000,000-row matrix (the
   same object, on a fresh group): byte-identical, no tall collective,
   kernel 7's launches the ring exchanges; (b) after 16a, the per-rule
   report (``scaling.rule_report``): the f64 halo operator through
   ``"pallas"`` (kernel 6) and ``"pallas-remote"`` (kernel 8's push) on
   phase 4's matrix and a 524,288-row sibling, and 15a's surrogate at
   5,000,192 and 10,000,384 rows, row-local (one launch an exchange;
   the two halo rules' inventories byte-identical to each other and to
   the exchange's 73,760 B in 12 calls, ``P16_HALO_BYTES``); dense, general BSR (kernel 2), ELL, sliced ELL and the
   hybrid gather x and must read n-scale, their bytes a row printed;
   (c) after the 10M-row 16a, the projected efficiency on 2, 4 and 8
   GPUs (a model: NVLink 4's published 450 GB/s, the median host time
   of one all_reduce of the iteration's largest payload measured in
   16a, this run's one-device iteration times of 15b and 8a's
   lowest-20); (d) with two or more GPUs, 8b's lowest-20 (kernel 8 on
   the push route, which the ranks' route rule must pick: NVLink peers
   on one host) and 14b's refined stage at world sizes 2 (and 4) over
   NCCL in spawned ranks, held to world 1 (iterations, the refined stage
   ±1; eigenvalues within 1e-12 relative; each rank's inventory,
   printed), the measured efficiency beside the model's, and one apply
   at f64 m = 40 of the push route and of the exchange route through its
   own functions, in turns, on every rank; with one GPU a line says it
   did not run; (e) 6b's refined stage on one device under
   ``sum_strategy("tree")`` beside the default cascade, in turns:
   iterations, oracle, warm wall, idle share, device ops (no default
   changes).
17. Kernel 8's push route at world size 1 (after 16e, on the one-rank
   NCCL group and the 1M-row f64 matrix): ``route == "push"``; lowest-3
   and lowest-20 give phase 4's iterations and eigenvalues within 1e-10,
   with one ``banded_remote_push_spmm`` launch a counted apply, no NCCL
   point-to-point call and no launch of kernel 8's two-launch form; at
   m = 20, 40, 160 the push apply gives ``"pallas"``'s bits and the
   exchange route's (timed through its own functions: ``ring_exchange``,
   then the interior and the edge launch), CUDA-event times of both in
   turns (push, exchange, exchange, push) beside the push's bound.
11. Prints the run's time and the shares of phases 12-17, the
   solves' and kernels' JSON lines (launch counts of the solve
   phases 4-16, each counted from 0 over its own phase; kernel 9, the copy
   variant, and kernel 5's three bf16-dequant variants are listed with
   the rest and no phase launches them (nor kernel 3's and kernel 5's
   float64 entries); for
   kernels 3 and 5, ``max_abs_err`` is Y's and ``max_gram_err_rel`` the worst
   |G_k - G_p| / (|V|ᵀ|Y|), and ``unfused_ms``, ``nov_ms`` and
   ``nogram_ms`` the split above; each kernel's ``bound_ms``, the larger
   of its bytes over 3.35 TB/s and its operations over the H100's peak
   for their type at that type's accuracy (float32: 3xTF32, 165 TFLOP/s),
   and ``library_ms``, one PyTorch call that computes the same function:
   ``torch.sparse_bsr_tensor @ x`` (cuSPARSE) for kernels 1 and 2, and
   for kernel 6 ``torch.bmm`` over the window view of x_ext (cuSPARSE
   beside it); the bounds of the probes' rows at their shapes; kernel 2's
   P A Pᵀ times and bounds by width; the float64-x entries of kernels 4
   and 7 as kernels of their own, ``banded_q_bsr_spmm_f64`` and
   ``banded_q_ext_bsr_spmm_f64``, launched in phases 6 and 8a, with their
   times at m = 20 and 40; kernel 5's float64-x entry as a kernel of its
   own, ``banded_q_bsr_spmm_gram_f64`` (no path), with its times, unfused
   yardstick, split, layout and bounds at m = 20 and 40; kernel 3's
   bf16 and float64 entries as kernels of their own,
   ``banded_bsr_spmm_gram_bf16`` (launched in phase 7c) and
   ``banded_bsr_spmm_gram_f64`` (no path: the fused engine is float32),
   with their plans, unfused yardsticks and splits), the card's name and
   power limit, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Imports nothing of JAX. Builds into ``fortran_davidson_tpu_torch/_build/``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

SOURCES = {
    "banded_bsr_spmm": "fortran_davidson_tpu_torch/csrc/banded_spmm.cu",
    "bsr_spmm": "fortran_davidson_tpu_torch/csrc/bsr_spmm.cu",
    # The float32 entry (the main case's); bf16 and float64 storage are
    # rows of their own, on csrc/fused_gram_typed.cuh.
    "banded_bsr_spmm_gram": "fortran_davidson_tpu_torch/csrc/fused_gram.cu",
    "banded_bsr_spmm_gram_bf16":
        "fortran_davidson_tpu_torch/csrc/fused_gram_bf16.cu",
    "banded_bsr_spmm_gram_f64":
        "fortran_davidson_tpu_torch/csrc/fused_gram_f64.cu",
    # The float32-x entry (the main case's, kernel 5's apply).
    "banded_q_bsr_spmm": "fortran_davidson_tpu_torch/csrc/q_spmm.cu",
    # The float64-x entries of kernels 4 and 7, on kernel 1's template.
    "banded_q_bsr_spmm_f64": "fortran_davidson_tpu_torch/csrc/q_spmm_f64.cu",
    "banded_q_ext_bsr_spmm_f64":
        "fortran_davidson_tpu_torch/csrc/q_ext_spmm_f64.cu",
    "banded_q_bsr_spmm_gram":
        "fortran_davidson_tpu_torch/csrc/fused_gram.cu",
    # The float64-x entry, on csrc/fused_gram_typed.cuh's int8 slab.
    "banded_q_bsr_spmm_gram_f64":
        "fortran_davidson_tpu_torch/csrc/fused_gram_q8f64.cu",
    "banded_ext_bsr_spmm": "fortran_davidson_tpu_torch/csrc/ext_spmm.cu",
    # The float32-x entry (the main case's, kernel 4's apply).
    "banded_q_ext_bsr_spmm": "fortran_davidson_tpu_torch/csrc/q_spmm.cu",
    "banded_remote_halo_spmm":
        "fortran_davidson_tpu_torch/csrc/remote_halo.cu",
    # Kernel 8's one-launch form, its halos pushed from inside the kernel.
    "banded_remote_push_spmm":
        "fortran_davidson_tpu_torch/csrc/remote_halo.cu",
    # Kernel 9: kernel 1's template (csrc/banded_spmm.cuh) as its "copy"
    # variant, instantiated in csrc/banded_spmm_var_{f64,f32,bf16}.cu.
    "banded_spmm_copy": "fortran_davidson_tpu_torch/csrc/banded_spmm.cuh",
    # Kernel 5's bf16-dequant variants (experiments/fused_probe.py's
    # modes), on csrc/fused_gram_typed.cuh's int8 slab.
    **{f"fused_probe_{v}": "fortran_davidson_tpu_torch/csrc/"
       "fused_gram_q8bf16.cu" for v in ("bf16deq", "tg_bf16deq",
                                        "nov_bf16")},
}
REPLACES = {
    "banded_bsr_spmm": "fortran_davidson_tpu/ops/pallas_kernels.py:438",
    "bsr_spmm": "fortran_davidson_tpu/ops/pallas_kernels.py:101",
    "banded_bsr_spmm_gram": "fortran_davidson_tpu/ops/pallas_kernels.py:592",
    "banded_bsr_spmm_gram_bf16":
        "fortran_davidson_tpu/ops/pallas_kernels.py:592",
    "banded_bsr_spmm_gram_f64":
        "fortran_davidson_tpu/ops/pallas_kernels.py:592",
    "banded_q_bsr_spmm": "fortran_davidson_tpu/ops/pallas_kernels.py:755",
    "banded_q_bsr_spmm_f64": "fortran_davidson_tpu/ops/pallas_kernels.py:755",
    "banded_q_bsr_spmm_gram":
        "fortran_davidson_tpu/ops/pallas_kernels.py:886",
    "banded_q_bsr_spmm_gram_f64":
        "fortran_davidson_tpu/ops/pallas_kernels.py:886",
    "banded_ext_bsr_spmm": "fortran_davidson_tpu/ops/pallas_kernels.py:1190",
    "banded_q_ext_bsr_spmm":
        "fortran_davidson_tpu/ops/pallas_kernels.py:1059",
    "banded_q_ext_bsr_spmm_f64":
        "fortran_davidson_tpu/ops/pallas_kernels.py:1059",
    "banded_remote_halo_spmm":
        "fortran_davidson_tpu/ops/pallas_kernels.py:1416",
    "banded_remote_push_spmm":
        "fortran_davidson_tpu/ops/pallas_kernels.py:1416",
    "banded_spmm_copy": "bench.py:85",
    "fused_probe_bf16deq": "experiments/fused_probe.py:191",
    "fused_probe_tg_bf16deq": "experiments/fused_probe.py:191",
    "fused_probe_nov_bf16": "experiments/fused_probe.py:170",
}
# The case whose times stand in the kernels line: the main path's shape.
MAIN_CASE = {
    "banded_bsr_spmm": ("float64", 48, None, True, "nbr=8192"),
    "bsr_spmm": ("float64", 48, None, True, "nbr=8192"),
    "banded_bsr_spmm_gram": ("float32", 128, 1408, True, "nbr=8192"),
    "banded_bsr_spmm_gram_bf16": ("bfloat16", 128, 1408, True, "nbr=8192"),
    "banded_bsr_spmm_gram_f64": ("float64", 128, 1408, True, "nbr=8192"),
    "banded_q_bsr_spmm": ("float32", 20, None, True, "nbr=16384"),
    "banded_q_bsr_spmm_f64": ("float64", 20, None, True, "nbr=16384"),
    "banded_q_bsr_spmm_gram": ("float32", 20, 220, True, "nbr=16384"),
    "banded_q_bsr_spmm_gram_f64": ("float64", 20, 220, True, "nbr=16384"),
    "banded_ext_bsr_spmm": ("float64", 40, None, True, "nbr=8192"),
    "banded_q_ext_bsr_spmm": ("float32", 20, None, True, "nbr=16384"),
    "banded_q_ext_bsr_spmm_f64": ("float64", 20, None, True, "nbr=16384"),
    "banded_remote_halo_spmm": ("float64", 40, None, True, "nbr=8192"),
    "banded_remote_push_spmm": ("float64", 40, None, True, "nbr=8192"),
    "banded_spmm_copy": ("float64", 48, None, True, "nbr=8192"),
    # The probe's own shape (PROBE, m = mv = 256; fused_probe.py:206-219).
    "fused_probe_bf16deq": ("bfloat16", 256, 256, False, "nbr=4096"),
    "fused_probe_tg_bf16deq": ("bfloat16", 256, 256, False, "nbr=4096"),
    "fused_probe_nov_bf16": ("bfloat16", 256, None, False, "nbr=4096"),
}
# bench.py's bench_bsr_spmm shape (bench.py:178-198), the shape of the
# experiments/spmm_probe*.py probes: nbr 4096, bs 128, bw 2, m 256.
PROBE = dict(nbr=4096, bs=128, bw=2, m=256)
# The f64 widths of kernel 1 at full size (the solver's: lowest-3 6-12,
# lowest-20 40-80, up to m_max 320).
K1_WIDTHS = (6, 12, 24, 40, 48, 80, 160, 320)
# Phase 4's warm walls with kernel 1 on the shared SIMT tile, before its
# rebuild (PERF.md §6), printed beside this run's.
TILE_K1_WALLS_MS = {3: 16, 20: 67}
# Warm solves of each path a phase-4 case, timed in turns.
WARM_SOLVES = 6
# The live widths of the sharded solves: f64 lowest-3 and lowest-20 (the
# same as phase 4's), the int8 lowest-20 loose stage.
EXT_WIDTHS = (6, 12, 24, 40, 80, 160)
EXT_WIDTHS_Q = (20, 40)
SLABS = 4
# Phase 3's scattered case and phase 5's permuted leg: P A Pᵀ of the 1M-row
# matrix for the permutation of its 8192 block indices seeded here, kernel
# 2 timed at the lowest-3, lowest-20 and m_max widths.
PERM_SEED = 2024
PERM_WIDTHS = (6, 24, 48, 320)
# The least time the card could take (H100 SXM data sheet, dense, at
# 700 W): HBM bytes/s, and FLOP/s by the type the operations run in, at
# that type's accuracy: float64 at the FP64 tensor-core rate (67
# TFLOP/s); float32 at 3xTF32 on the tensor cores, a third of the 495
# TFLOP/s TF32 rate (three TF32 products keep float32 accuracy), which is
# above the 67 TFLOP/s of the CUDA cores; bf16 at its tensor-core rate.
# int8 storage runs float32 operations.
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float64": 67e12, "float32": 495e12 / 3, "bfloat16": 989e12}
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}
GRAM_TOL = 1e-5
SOLVE_TOL = 1e-8
# (m, mv) of the gram cases at full size; mv None is G = XᵀAX. The k=20
# engine's widths (m=20, mv from its first expansion's 60 up to m_max =
# 220), the k=128 engine's (m=128, mv from 384 up to m_max = 1408), and
# both initial blocks (m=40, m=256) in the v=None form.
GRAM_WIDTHS = [(20, None), (20, 40), (20, 60), (20, 220), (40, None),
               (40, 220), (128, None), (128, 384), (128, 1408), (256, None)]


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def phase_kernels(A, A32, q, probe, dev, record, slab_checks, gram_splits,
                  k1_info, variant_info, band_checks, ext_info, permuted_info,
                  q64_info):
    """Phase 3: every kernel against its plain version on the card, the
    time split of kernels 3 and 5 (into ``gram_splits``), kernel 5's
    bf16-dequant variants beside it (into ``variant_info``), kernels 4, 6
    and 7 and those variants on the band alone (into ``band_checks``),
    kernel 1's variants and split (into ``k1_info``), kernel 6's two routes
    (into ``ext_info``), kernel 2 on the block-permuted matrix (into
    ``permuted_info``), the float64-x entries of kernels 4, 5 and 7 (into
    ``q64_info``), and the four-slab check of kernels 6-8 (into
    ``slab_checks``)."""
    import numpy as np
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.ops.sparse import (
        BSROperator, generate_banded_bsr, generate_banded_bsr_quantized)
    from fortran_davidson_tpu_torch.parallel import RowMesh

    gen = torch.Generator(device=dev).manual_seed(1)
    clock = [time.perf_counter()]

    def lap(section):
        """Print the host time since the last lap: where phase 3 spends
        the smoke run's time limit."""
        now = time.perf_counter()
        print(f"  ({section}: {now - clock[0]:.1f} s)", flush=True)
        clock[0] = now

    def randn(rows, cols, dtype=torch.float32):
        return torch.randn((rows, cols), generator=gen, dtype=torch.float32,
                           device=dev).to(dtype)

    def emit(row, timed):
        t = (f"kernel={row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms"
             if timed else "(not timed)")
        for name, equal in row.get("twins", {}).items():
            t = f"bits == {name}: {equal} {t}"
        mv = "-" if row["mv"] is None else row["mv"]
        y = ("Y -" if row["max_abs_err"] is None else
             f"max_abs_err={row['max_abs_err']:.3e} rel={row['rel_err']:.3e}")
        g = ("" if row["gram_ratio"] is None else
             f" G abs={row['g_abs_err']:.3e} |dG|/(|V|ᵀ|Y|)="
             f"{row['gram_ratio']:.3e}")
        print(f"  {row['name']:22s} {row['dtype']:8s} {row['shape']:26s} "
              f"m={row['m']:<4d} mv={mv!s:<5s} out={int(row['write_out'])} "
              f"{y}{g} {t}", flush=True)
        record.append(row)

    def spmm_case(name, kernel, plain, dtype, m, note, timed, twins=(),
                  frame=0):
        """``twins``: (name, fn) pairs, kernels that must give the same
        bits (the kernel itself: the same bits on a second call).
        ``frame``: the kernel reads x from a buffer of its own between that
        many NaN rows on each side (:func:`_apart`)."""
        n = kernel_rows
        x = randn(n, m, dtype)
        xk = _apart(x, frame) if frame else x
        y_k = kernel(xk)
        y_p = plain(x)
        same = {tn: torch.equal(y_k, fn(xk)) for tn, fn in twins}
        torch.cuda.synchronize()
        _check(y_k.dtype == y_p.dtype, f"{name}: output type {y_k.dtype}")
        err = float(torch.max(torch.abs(y_k.double() - y_p.double())))
        rel = err / max(float(torch.max(torch.abs(y_p.double()))), 1e-300)
        dn = _dname(dtype)
        row = dict(name=name, dtype=dn, m=m, mv=None, write_out=True,
                   shape=note, max_abs_err=err, rel_err=rel, gram_ratio=None,
                   ms=None, plain_ms=None, twins=same)
        if timed:
            row["ms"] = _time_ms(lambda: kernel(xk))
            row["plain_ms"] = _time_ms(lambda: plain(x))
        emit(row, timed)
        _check(rel <= TOL[dn], f"{name} {dn} m={m} {note}: rel err "
               f"{rel:.3e} > {TOL[dn]}")
        for tn, equal in same.items():
            _check(equal, f"{name} {dn} m={m} {note}: other bits than {tn} "
                   "on the same rows")
        return row, x

    def gram_case(name, kernel, plain, lead, n, m, mv, write_out, note, bw,
                  timed):
        x = randn(n, m)
        v = None if mv is None else randn(n, mv)
        vv = x if v is None else v
        kw = dict(bandwidth=bw, write_out=write_out)
        out_k = kernel(*lead, x, v, **kw)
        y_p, g_p = plain(*lead, x, v, bandwidth=bw, write_out=True)
        g_k = out_k[1] if write_out else out_k
        again = kernel(*lead, x, v, **kw)
        torch.cuda.synchronize()
        _check(torch.equal(g_k, again[1] if write_out else again),
               f"{name}: the G reduction gave other bits on a second run")
        del again
        _check(g_k.dtype == torch.float32
               and tuple(g_k.shape) == (vv.shape[1], m),
               f"{name}: G is {g_k.dtype} {tuple(g_k.shape)}")
        # |G_k - G_p| relative to (|V|ᵀ|Y|), elementwise.
        scale = torch.abs(vv).T @ torch.abs(y_p)
        g_err = torch.abs(g_k - g_p)
        ratio = float(torch.max(g_err / (scale + 1e-30)))
        g_abs = float(torch.max(g_err))
        y_err, rel = None, 0.0
        if write_out:
            y_err = float(torch.max(torch.abs(out_k[0] - y_p)))
            rel = y_err / float(torch.max(torch.abs(y_p)))
        del out_k, scale, g_err
        row = dict(name=name, dtype="float32", m=m, mv=mv,
                   write_out=write_out, shape=note, max_abs_err=y_err,
                   g_abs_err=g_abs, rel_err=rel, gram_ratio=ratio, ms=None,
                   plain_ms=None)
        if timed:
            row["ms"] = _time_ms(lambda: kernel(*lead, x, v, **kw))
            row["plain_ms"] = _time_ms(lambda: plain(*lead, x, v, **kw))
        emit(row, timed)
        _check(rel <= TOL["float32"], f"{name} m={m} mv={mv} {note}: Y rel "
               f"err {rel:.3e}")
        _check(ratio <= GRAM_TOL, f"{name} m={m} mv={mv} {note}: G error "
               f"{ratio:.3e} of |V|ᵀ|Y| > {GRAM_TOL}")
        del x, v, vv, y_p, g_p, g_k
        torch.cuda.empty_cache()

    # -- kernels 1, 2 (f64, f32, and bf16 storage summed in f32) --------
    rag = generate_banded_bsr(17, 8, bandwidth=2, seed=9, device=dev)
    rng = np.random.default_rng(3)
    nbr_s, bs_s = 61, 16
    pairs = {(r, r) for r in range(nbr_s)}
    while len(pairs) < 5 * nbr_s:
        i, j = (int(v) for v in rng.integers(0, nbr_s, 2))
        pairs |= {(i, j), (j, i)}
    brows, bcols = np.array(sorted(pairs)).T
    scr = BSROperator.from_block_coo(
        brows, bcols, rng.standard_normal((len(brows), bs_s, bs_s)), nbr_s,
        pad_width=12, device=dev)
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    rag24 = generate_banded_bsr(13, 24, bandwidth=3, seed=11, device=dev)
    # Kernel 2 on the DIA table, out-of-range columns included
    # (cols[r, k] = r - bw + k): kernel 1's bits in every type.
    dia = "DIA table (kernel 1's bits)"
    # The band-dropped case stands in the kernels line (MAIN_CASE): its f64
    # m=48 row comes first among kernel 2's nbr=8192 rows.
    cases = [
        ("banded_bsr_spmm", rag, "nbr=17 bs=8 bw=2", (f64, f32, bf16), (3,)),
        ("banded_bsr_spmm", rag24, "nbr=13 bs=24 bw=3", (f64, f32, bf16),
         (1, 20, 44, 130, 320)),
        ("bsr_spmm", rag, "nbr=17 bs=8 K=5 clipped cols", (f64, f32, bf16),
         (3,)),
        ("bsr_spmm", rag, f"nbr=17 bs=8 K=5 {dia}", (f64, f32, bf16),
         (3, 20)),
        ("bsr_spmm", rag24, f"nbr=13 bs=24 K=7 {dia}", (f64, f32, bf16),
         (1, 44, 320)),
        ("bsr_spmm", scr, "nbr=61 bs=16 K=12 scrambled", (f64, f32, bf16),
         (3, 48)),
        ("banded_bsr_spmm", A, "nbr=8192 bs=128 bw=1", (f64,), K1_WIDTHS),
        ("banded_bsr_spmm", A, "nbr=8192 bs=128 bw=1", (f32,), (6, 48, 320)),
        ("banded_bsr_spmm", A, "nbr=8192 bs=128 bw=1", (bf16,), (48, 320)),
        ("bsr_spmm", A, "nbr=8192 bs=128 K=3 (band dropped)", (f64,),
         (6, 24, 48, 320)),
        ("bsr_spmm", A, "nbr=8192 bs=128 K=3 (band dropped)", (f32,),
         (6, 48, 320)),
        ("bsr_spmm", A, "nbr=8192 bs=128 K=3 (band dropped)", (bf16,),
         (48, 320)),
        ("bsr_spmm", A, f"nbr=8192 bs=128 K=3 {dia}", (f64, f32, bf16),
         (6, 40)),
    ]
    for name, op, note, dtypes, widths in cases:
        kernel_rows = op.shape[0]
        # The full-size matrix; the DIA-table cases are checks only.
        timed = op.n_block_rows >= 8192 and dia not in note
        for dtype in dtypes:
            blocks = op.blocks.to(dtype)
            # bf16 storage returns the float32 sums (the solver's use).
            out = torch.float32 if dtype == bf16 else dtype
            bw = op.bandwidth
            k1 = (lambda x, b=blocks, bw=bw, o=out:
                  kernels.banded_bsr_spmm(b, x, bw, out_dtype=o))
            if name == "banded_bsr_spmm":
                kernel = k1
                plain = (lambda x, b=blocks, bw=bw, o=out:
                         kernels.banded_bsr_spmm_plain(b, x, bw, out_dtype=o))
                # Kernel 1: x framed by NaN rows, and the same bits twice.
                extra = dict(twins=[("itself", kernel)],
                             frame=bw * op.block_size)
            else:
                cols = (_dia_table(op.n_block_rows, bw, dev) if dia in note
                        else op.block_cols)
                kernel = (lambda x, b=blocks, c=cols, o=out:
                          kernels.bsr_spmm(c, b, x, out_dtype=o))
                # The plain version takes columns in range (the clipped
                # table; the out-of-range slots hold zero blocks).
                plain = (lambda x, b=blocks, c=op.block_cols, o=out:
                         kernels.bsr_spmm_plain(c, b, x, out_dtype=o))
                # Kernel 2: the same bits twice; on the DIA table kernel
                # 1's.
                extra = dict(twins=[("itself", kernel)]
                             + ([("banded_bsr_spmm", k1)] if dia in note
                                else []))
            for m in widths:
                spmm_case(name, kernel, plain, dtype, m, note, timed,
                          **extra)
            del blocks
    del rag24
    torch.cuda.empty_cache()
    kernel_rows = A.shape[0]
    lap("kernels 1, 2")
    permuted_info.update(permuted_case(A, spmm_case))
    lap("kernel 2 on P A Pᵀ")
    k1_info.update(kernel1_variants(A, probe, q, dev, randn, record))

    # -- kernels 3-5: ragged first, then the full-size matrices ---------
    rag32 = generate_banded_bsr(17, 24, bandwidth=2, seed=9,
                                dtype=torch.float32, device=dev)
    ragq = generate_banded_bsr_quantized(17, 24, bandwidth=2, seed=9,
                                         device=dev)
    gram_sets = [
        ("banded_bsr_spmm_gram", rag32, (rag32.blocks,),
         "nbr=17 bs=24 bw=2", [(m, mv) for m in (20, 40, 128)
                               for mv in (None, 40, 220, 1408)], False),
        ("banded_q_bsr_spmm_gram", ragq,
         (ragq.qblocks, ragq.scale_rows, ragq.diag), "nbr=17 bs=24 bw=2",
         [(m, mv) for m in (20, 40, 128) for mv in (None, 40, 220, 1408)],
         False),
        ("banded_bsr_spmm_gram", A32, (A32.blocks,), "nbr=8192 bs=128 bw=1",
         GRAM_WIDTHS, True),
        ("banded_q_bsr_spmm_gram", q, (q.qblocks, q.scale_rows, q.diag),
         "nbr=16384 bs=128 bw=1", GRAM_WIDTHS, True),
    ]
    lap("kernel 1's variants and split")
    for name, op, lead, note, widths, timed in gram_sets:
        if name == "banded_q_bsr_spmm_gram":
            kernel_rows = op.shape[0]
            for m in sorted({m for m, _ in widths}):
                spmm_case(
                    "banded_q_bsr_spmm",
                    lambda x, ql=lead, bw=op.bandwidth:
                        kernels.banded_q_bsr_spmm(*ql, x, bw),
                    lambda x, ql=lead, bw=op.bandwidth:
                        kernels.banded_q_bsr_spmm_plain(*ql, x, bw),
                    f32, m, note, timed)
            int8_band_only(op, note, randn, sorted({m for m, _ in widths}),
                           band_checks)
        kernel = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        for m, mv in widths:
            for write_out in (True, False):
                gram_case(name, kernel, plain, lead, op.shape[0], m, mv,
                          write_out, note, op.bandwidth, timed)
    del rag32
    lap("kernels 3-5 against their plain versions")
    gram_splits.update(gram_split(A32, q, randn))
    lap("kernels 3, 5 split")
    gram_splits["typed"] = typed_gram_rows(A, randn, record)
    lap("kernel 3's bf16 and float64 entries")
    variant_info.update(bf16_variant_split(q, probe, randn, record,
                                           band_checks))
    lap("kernel 5's bf16-dequant variants")

    # -- kernels 6, 7: a shard's halo-extended input ((nbr + 2bw) * bs
    #    rows), ragged first, then the full-size matrices at world size 1;
    #    x_ext in a buffer framed by NaN rows, the same bits twice
    ext_sets = [
        (rag, "nbr=17 bs=8 bw=2", (f64, f32, bf16), (1, 3, 20, 130), False),
        (A, "nbr=8192 bs=128 bw=1", (f64,), EXT_WIDTHS, True),
        (ragq, "nbr=17 bs=24 bw=2", (f32,), (1, 20, 130), False),
        (q, "nbr=16384 bs=128 bw=1", (f32,), EXT_WIDTHS_Q, True),
    ]
    for op, note, dtypes, widths, timed in ext_sets:
        bw = op.bandwidth
        kernel_rows = op.shape[0] + 2 * bw * op.block_size
        for dtype in dtypes:
            if hasattr(op, "qblocks"):
                name = "banded_q_ext_bsr_spmm"
                lead = (op.qblocks, op.scale_rows, op.diag)
                kernel = (lambda x, ql=lead, bw=bw:
                          kernels.banded_q_ext_bsr_spmm(*ql, x, bandwidth=bw))
                plain = (lambda x, ql=lead, bw=bw:
                         kernels.banded_q_ext_bsr_spmm_plain(*ql, x,
                                                             bandwidth=bw))
            else:
                name = "banded_ext_bsr_spmm"
                blocks = op.blocks.to(dtype)
                out = torch.float32 if dtype == bf16 else dtype
                kernel = (lambda x, b=blocks, bw=bw, o=out:
                          kernels.banded_ext_bsr_spmm(b, x, bandwidth=bw,
                                                      out_dtype=o))
                plain = (lambda x, b=blocks, bw=bw, o=out:
                         kernels.banded_ext_bsr_spmm_plain(b, x, bandwidth=bw,
                                                           out_dtype=o))
            for m in widths:
                spmm_case(name, kernel, plain, dtype, m, note, timed,
                          twins=[("itself", kernel)],
                          frame=bw * op.block_size)
    lap("kernels 6, 7")
    for op, note in ((ragq, "nbr=17 bs=24 bw=2"), (q, "nbr=16384 bs=128 bw=1")):
        int8_float64_x(op, note, randn, op is q, record, q64_info,
                       band_checks)
    lap("float64 x on int8 storage")
    ext_band_only([(rag, "nbr=17 bs=8 bw=2", dtype, 20)
                   for dtype in (f64, f32, bf16)]
                  + [(A, "nbr=8192 bs=128 bw=1", f64, 40),
                     (ragq, "nbr=17 bs=24 bw=2", f32, 20),
                     (q, "nbr=16384 bs=128 bw=1", f32, 20)],
                  randn, band_checks)
    lap("kernels 6, 7 on the band alone")
    ext_info.update(ext_route_split(A, randn))
    lap("kernel 6's routes")
    print("  kernel 6's TMA route under repetition, bit for bit against its "
          "cp.async route", flush=True)
    ext_info["tma_stress"] = tma_stress(A, randn)
    del ragq
    torch.cuda.empty_cache()

    # -- kernel 8 (kernel 1's template): the shard's rows and its two halos
    #    through three pointers, each part of an x_ext of (nbr + 2bw) * bs
    #    rows in a buffer of its own, in the interior and edge launches of
    #    the halo operator; held to its plain version and, bit for bit, to
    #    kernel 1 on the same rows (the slab framed by bw zero block rows on
    #    each side, over x_ext) and to kernel 6 on that x_ext, in every type
    #    (kernel 1's products in kernel 1's order, all three)
    remote_sets = [
        (rag, "nbr=17 bs=8 bw=2", (1, 3, 20, 130)),
        (A, "nbr=8192 bs=128 bw=1", EXT_WIDTHS),
    ]
    name = "banded_remote_halo_spmm"
    lap("kernel 6's TMA stress")
    for op, note, widths in remote_sets:
        bw = op.bandwidth
        halo = bw * op.block_size
        kernel_rows = op.shape[0] + 2 * halo
        for dtype in (f64, f32, bf16):
            blocks = op.blocks.to(dtype)
            acc = kernels.acc_dtype(dtype)
            kernel = _remote_apart(blocks, bw, halo, acc)
            plain = (lambda x, b=blocks, bw=bw, h=halo, o=acc:
                     kernels.banded_remote_halo_spmm_plain(
                         b, x[h:-h], x[:h], x[-h:], bandwidth=bw,
                         out_dtype=o))
            pad = torch.zeros((bw, *blocks.shape[1:]), dtype=dtype,
                              device=dev)
            framed = torch.cat([pad, blocks, pad])
            twins = [("banded_bsr_spmm on the same rows",
                      lambda x, b=framed, bw=bw, h=halo, o=acc:
                          kernels.banded_bsr_spmm(b, x, bw, out_dtype=o)[h:-h]),
                     ("banded_ext_bsr_spmm",
                      lambda x, b=blocks, bw=bw, o=acc:
                          kernels.banded_ext_bsr_spmm(b, x, bandwidth=bw,
                                                      out_dtype=o))]
            timed = op.n_block_rows >= 8192 and dtype == f64
            for m in widths:
                spmm_case(name, kernel, plain, dtype, m, note, timed, twins)
            del blocks, pad, framed
    lap("kernel 8")

    # -- kernel 8 in one launch: at world size 1 the shard pushes its edge
    #    rows into its own window (cudaMalloc'd, RowMesh.open_window) and
    #    reads them back as its halos; held to its plain version (the same
    #    dataflow on a window of tensor memory) and, bit for bit, to kernel
    #    6 on the wrapped x_ext, and to itself on a second call (the other
    #    buffer), in every type
    name = "banded_remote_push_spmm"
    for op, note, widths in remote_sets:
        bw = op.bandwidth
        halo = bw * op.block_size
        kernel_rows = op.shape[0]
        for dtype in (f64, f32, bf16):
            blocks = op.blocks.to(dtype)
            acc = kernels.acc_dtype(dtype)
            window = RowMesh(group=None, size=1, rank=0,
                             device=dev).open_window(
                kernels.window_slot_bytes(halo, max(widths), dtype))
            local = kernels.HaloWindow.local(dev, window.slot_bytes)
            kernel = (lambda x, b=blocks, bw=bw, w=window, o=acc:
                      kernels.banded_remote_push_spmm(
                          b, x, w, bandwidth=bw, epoch=w.next_epoch(),
                          out_dtype=o))
            plain = (lambda x, b=blocks, bw=bw, w=local, o=acc:
                     kernels.banded_remote_push_spmm_plain(
                         b, x, w, bandwidth=bw, epoch=w.next_epoch(),
                         out_dtype=o))
            twins = [("banded_ext_bsr_spmm on the wrapped rows",
                      lambda x, b=blocks, bw=bw, h=halo, o=acc:
                          kernels.banded_ext_bsr_spmm(
                              b, torch.cat([x[-h:], x, x[:h]]),
                              bandwidth=bw, out_dtype=o)),
                     ("itself on the other buffer", kernel)]
            timed = op.n_block_rows >= 8192 and dtype == f64
            for m in widths:
                spmm_case(name, kernel, plain, dtype, m, note, timed, twins)
            torch.cuda.synchronize()
            window.raise_if_faulted()
            del blocks, window, local
    del rag
    torch.cuda.empty_cache()

    # Kernels 6 and 7 side by side with kernels 1 and 4, kernel 8 with
    # kernels 6 and 1, and its push form with kernel 8, at the same widths.
    def ms_of(name, dtype, m, shape):
        return next(r["ms"] for r in record if r["name"] == name
                    and r["dtype"] == dtype and r["m"] == m and r["mv"] is None
                    and r["ms"] is not None and shape in r["shape"])
    for ext, base, dtype, shape, widths in (
            ("banded_ext_bsr_spmm", "banded_bsr_spmm", "float64", "nbr=8192",
             EXT_WIDTHS),
            ("banded_q_ext_bsr_spmm", "banded_q_bsr_spmm", "float32",
             "nbr=16384", EXT_WIDTHS_Q),
            ("banded_remote_halo_spmm", "banded_ext_bsr_spmm", "float64",
             "nbr=8192", EXT_WIDTHS),
            ("banded_remote_halo_spmm", "banded_bsr_spmm", "float64",
             "nbr=8192", EXT_WIDTHS),
            ("banded_remote_push_spmm", "banded_remote_halo_spmm", "float64",
             "nbr=8192", EXT_WIDTHS)):
        pairs = ", ".join(f"m={m}: {ms_of(ext, dtype, m, shape):.4f} / "
                          f"{ms_of(base, dtype, m, shape):.4f}"
                          for m in widths)
        print(f"  {ext} / {base} ms: {pairs}", flush=True)
    routes = {m: kernels.ext_spmm_route(torch.float64, A.block_size, m)
              for m in EXT_WIDTHS}
    print(f"  banded_ext_bsr_spmm f64 routes by width (bs=128, aligned): "
          f"{routes}", flush=True)

    lap("kernel 8's push form and the side-by-side widths")
    slab_checks.update(four_slab_check(A, q, randn))
    lap("the four-slab check")


def _dia_table(nbr: int, bw: int, dev):
    """cols[r, k] = r - bw + k, out-of-range columns included: the block
    columns of DIA-aligned storage, unclipped."""
    import torch
    r = torch.arange(nbr, device=dev)[:, None]
    return (r - bw + torch.arange(2 * bw + 1, device=dev)[None, :]).to(
        torch.int32)


def _permuted(op, seed: int):
    """P A Pᵀ of a BSR operator, built on its device, for a permutation p
    of the block indices seeded by ``seed``: block row p[r] takes row r's
    slabs, and its columns become p[cols[r, k]]. Returns (p, cols,
    blocks)."""
    import torch
    dev = op.blocks.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randperm(op.n_block_rows, generator=gen, device=dev)
    cols = torch.empty_like(op.block_cols)
    cols[p] = p[op.block_cols.long()].to(torch.int32)
    blocks = torch.empty_like(op.blocks)
    blocks[p] = op.blocks
    return p, cols, blocks


def _gathered_bound_ms(op, m: int, nnz_blocks: int) -> float:
    """Kernel 2's bound where x does not stay in L2: every slot's x slice
    read from HBM (K times in all, as the TPU kernel's cost estimate counts
    it, pallas_kernels.py:158-161), the blocks and cols once, Y once; the
    operations on DMMA (float64)."""
    nbr, bs, kbs = op.blocks.shape
    moved = (nbr * bs * kbs * 8 + nbr * (kbs // bs) * 4   # blocks, cols
             + nbr * kbs * m * 8 + nbr * bs * m * 8)      # x K times, Y
    ops = 2 * nnz_blocks * bs * bs * m
    return max(moved / HBM_BYTES_S, ops / PEAK_FLOP_S["float64"]) * 1e3


def permuted_case(A, spmm_case) -> dict:
    """Kernel 2 on P A Pᵀ, the 1M-row matrix permuted blockwise
    (:func:`_permuted`, ``PERM_SEED``), so that a block row's x slices lie
    far apart and x (400 MB at m = 48) cannot stay in L2: against its
    plain version and bit for bit against P (kernel 2 on A) Pᵀ, timed at
    ``PERM_WIDTHS`` beside the plain version and cuSPARSE (the same
    permuted matrix, columns sorted in each row), with both bounds."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    nbr, bs = A.n_block_rows, A.block_size
    p, cols, blocks = _permuted(A, PERM_SEED)
    S = _library_bsr(A, False, p)
    nnz = _nonzero_blocks(A.blocks, 3)

    def kernel(x):
        return kernels.bsr_spmm(cols, blocks, x)

    def plain(x):
        return kernels.bsr_spmm_plain(cols, blocks, x)

    def unpermuted(x):
        # P (A (Pᵀ x)): (Pᵀ x)[r] = x[p[r]], (P y)[p[r]] = y[r].
        m = x.shape[1]
        xa = x.view(nbr, bs, m)[p].reshape(-1, m)
        ya = kernels.bsr_spmm(A.block_cols, A.blocks, xa)
        y = torch.empty_like(ya)
        y.view(nbr, bs, m)[p] = ya.view(nbr, bs, m)
        return y

    out = {}
    for m in PERM_WIDTHS:
        row, x = spmm_case("bsr_spmm", kernel, plain, torch.float64, m,
                           "nbr=8192 bs=128 K=3 block-permuted", True,
                           twins=[("itself", kernel),
                                  ("P (kernel 2 on A) Pᵀ", unpermuted)])
        yp = plain(x)
        lib = float(torch.max(torch.abs((S @ x) - yp))
                    / torch.max(torch.abs(yp)))
        _check(lib <= TOL["float64"], f"cuSPARSE on P A Pᵀ differs by "
               f"{lib:.3e}")
        del yp
        once = _bound("bsr_spmm", "float64", m, None, A, nnz)[0]
        out[f"m={m}"] = dict(
            ms=row["ms"], plain_ms=row["plain_ms"],
            library_ms=_time_ms(lambda: S @ x), bound_ms=once,
            bound_gathered_ms=_gathered_bound_ms(A, m, nnz),
            max_abs_err=row["max_abs_err"], rel_err=row["rel_err"])
        e = out[f"m={m}"]
        print(f"    P A Pᵀ f64 m={m}: kernel 2 {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f}, cuSPARSE {e['library_ms']:.4f}; bound "
              f"{e['bound_ms']:.4f} (x once) / {e['bound_gathered_ms']:.4f} "
              f"(x gathered K times): {e['bound_ms'] / e['ms']:.1%} / "
              f"{e['bound_gathered_ms'] / e['ms']:.1%}", flush=True)
        del x
    del S, cols, blocks
    torch.cuda.empty_cache()
    return out


def gram_split(A32, q, randn) -> dict:
    """Kernels 3 and 5 at their main cases beside their measurement
    variants and the unfused yardstick, each timed twice in turns (full,
    nov, nogram, unfused, then back), the mean of the two medians:
    ``nov`` reads no V and ``nogram`` streams V without the gram product
    (both reduce Y to its column sums, held here to the plain Y's), so
    full - nogram is the gram, nogram - nov the V stream, nov the apply.
    ``unfused`` is kernel 1 (kernel 4) then one float32 cuBLAS product
    ``torch.matmul(v.T, y)``: the work the recomputed engine does instead.
    Returns name -> {variant: ms}."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    out = {}
    for name, op, lead, apply in (
            ("banded_bsr_spmm_gram", A32, (A32.blocks,),
             kernels.banded_bsr_spmm),
            ("banded_q_bsr_spmm_gram", q, (q.qblocks, q.scale_rows, q.diag),
             kernels.banded_q_bsr_spmm)):
        _, m, mv, _, _ = MAIN_CASE[name]
        bw = op.bandwidth
        x, v = randn(op.shape[0], m), randn(op.shape[0], mv)
        kernel = getattr(kernels, name)
        y = getattr(kernels, f"{name}_plain")(*lead, x, v, bandwidth=bw)[0]
        want = y.double().sum(0)
        bound = 1e-5 * y.double().abs().sum(0)
        for variant in ("nov", "nogram"):
            g = kernels.fused_gram_variant(name, lead, x, v, bandwidth=bw,
                                           variant=variant)
            err = float(torch.max((g[0].double() - want).abs() - bound))
            _check(err <= 0.0 and not bool(torch.any(g[1:])),
                   f"{name} {variant}: G row 0 is not Y's column sums")
        del y, want, bound, g
        fns = {
            "full": lambda: kernel(*lead, x, v, bandwidth=bw),
            "nov": lambda: kernels.fused_gram_variant(
                name, lead, x, v, bandwidth=bw, variant="nov"),
            "nogram": lambda: kernels.fused_gram_variant(
                name, lead, x, v, bandwidth=bw, variant="nogram"),
            "unfused": lambda: torch.matmul(v.T, apply(*lead, x, bw)),
        }
        order = list(fns) + list(fns)[::-1]
        times = {key: [] for key in fns}
        for key in order:
            times[key].append(_time_ms(fns[key]))
        row = {key: statistics.mean(t) for key, t in times.items()}
        print(f"  {name} m={m} mv={mv} split (ms, mean of two turns): "
              f"full {row['full']:.4f}, nov (apply) {row['nov']:.4f}, "
              f"nogram (apply + V stream) {row['nogram']:.4f}, unfused "
              f"({apply.__name__} + cuBLAS vᵀy) {row['unfused']:.4f}; "
              f"turns {times}", flush=True)
        plan = kernels.fused_gram_plan(
            x.device.index or 0, int(name == "banded_q_bsr_spmm_gram"),
            "full", op.n_block_rows, op.block_size, 2 * bw + 1, m, mv)
        print(f"    layout: {plan} (one block an SM, 256 threads)", flush=True)
        out[name] = dict(row, plan=plan)
        del x, v
        torch.cuda.empty_cache()
    return out


def _int8_faults(qblocks, scale_rows, diag) -> dict:
    """Int8 operands with a fault put in, for the plain versions: the band
    dropped, slot 0 dropped, the slots in reverse order, every slot scaled
    by the diagonal slot's scale (one scale a block row). A kernel with
    such a fault would give what the plain version gives on these."""
    import torch
    nbr, bs, kbs = qblocks.shape
    K = kbs // bs
    q4 = qblocks.reshape(nbr, bs, K, bs)
    s3 = scale_rows.reshape(nbr, K, bs)
    drop0 = q4.clone()
    drop0[:, :, 0] = 0
    return {
        "band dropped": (torch.zeros_like(qblocks), scale_rows, diag),
        "slot 0 dropped": (drop0.reshape(nbr, bs, kbs), scale_rows, diag),
        "slots reversed": (q4.flip(2).reshape(nbr, bs, kbs).contiguous(),
                           s3.flip(1).reshape(nbr, kbs).contiguous(), diag),
        "one scale a row": (qblocks, s3[:, K // 2:K // 2 + 1].expand(
            nbr, K, bs).reshape(nbr, kbs).contiguous(), diag),
    }


def _note_band(band_checks, name, reading, faults) -> None:
    """Keep a kernel's worst sound reading on the band alone and its
    smallest reading with a fault, for the kernels line."""
    entry = band_checks.setdefault(name, dict(
        band_only_max_err_rel=0.0, band_fault_min_rel=float("inf")))
    entry["band_only_max_err_rel"] = max(entry["band_only_max_err_rel"],
                                         reading)
    entry["band_fault_min_rel"] = min(entry["band_fault_min_rel"],
                                      *faults.values())


def int8_band_only(op, note, randn, widths, band_checks) -> None:
    """Kernel 4 (float32 x) on the band alone: the operator's diagonal
    zeroed, so Y is the int8 band's product and nothing else (with the
    diagonal in, the band is ~1e-6 of max|Y|, under the limit). Y within
    TOL["float32"] of max|Y_band| of its plain version; and each of
    :func:`_int8_faults`, given to the plain version, must read above that
    limit, or the check could not see it."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    lead = (op.qblocks, op.scale_rows, torch.zeros_like(op.diag))
    bw, n = op.bandwidth, op.shape[0]
    faults = _int8_faults(*lead)
    limit = TOL["float32"]
    plain = kernels.banded_q_bsr_spmm_plain
    for m in widths:
        x = randn(n, m)
        y = kernels.banded_q_bsr_spmm(*lead, x, bw)
        yp = plain(*lead, x, bw)
        top = float(torch.max(torch.abs(yp)))
        rel = float(torch.max(torch.abs(y - yp))) / top
        read = {f: float(torch.max(torch.abs(plain(*fl, x, bw) - yp))) / top
                for f, fl in faults.items()}
        # What the band dropped reads with the diagonal in: Y = d ∘ x.
        y_all = plain(op.qblocks, op.scale_rows, op.diag, x, bw)
        hidden = float(torch.max(torch.abs(
            op.diag.reshape(-1, 1) * x - y_all))) / float(
                torch.max(torch.abs(y_all)))
        print(f"  banded_q_bsr_spmm      band only {note:24s} m={m:<4d} "
              f"|dY|/max|Y_band|={rel:.3e} (limit {limit:.0e}); with a "
              "fault: " + ", ".join(f"{f} {r:.3e}" for f, r in read.items())
              + f" (band dropped, diagonal in: {hidden:.3e} of max|Y|)",
              flush=True)
        _check(rel <= limit, f"kernel 4 band only {note} m={m}: {rel:.3e}")
        _check(min(read.values()) > limit, f"kernel 4 band only {note} "
               f"m={m}: a fault reads {read}, within the limit")
        _note_band(band_checks, "banded_q_bsr_spmm", rel, read)
        del x, y, yp, y_all
    del faults
    torch.cuda.empty_cache()


def _dense_faults(blocks) -> dict:
    """Dense banded blocks with a fault put in, for the plain version: the
    band dropped, slot 0 dropped, the slots in reverse order."""
    import torch
    nbr, bs, kbs = blocks.shape
    b4 = blocks.reshape(nbr, bs, kbs // bs, bs)
    drop0 = b4.clone()
    drop0[:, :, 0] = 0
    return {"band dropped": (torch.zeros_like(blocks),),
            "slot 0 dropped": (drop0.reshape(nbr, bs, kbs),),
            "slots reversed": (b4.flip(2).reshape(nbr, bs, kbs).contiguous(),)}


def _halo_band(op, dtype):
    """A shard's tables whose Y is the band's product alone and whose edge
    rows read their halos: ``op``'s tables rolled by half its block rows
    (so the shard's first and last block rows hold blocks in their outer
    slots), with the centre slot's blocks zeroed (dense, in ``dtype``) or
    the diagonal zeroed (int8)."""
    import torch
    nbr, bs, bw = op.n_block_rows, op.block_size, op.bandwidth
    if hasattr(op, "qblocks"):
        return (torch.roll(op.qblocks, nbr // 2, 0),
                torch.roll(op.scale_rows, nbr // 2, 0),
                torch.zeros_like(op.diag))
    b = torch.roll(op.blocks, nbr // 2, 0).to(dtype)
    b.reshape(nbr, bs, 2 * bw + 1, bs)[:, :, bw] = 0
    return (b,)


def ext_band_only(cases, randn, band_checks) -> None:
    """Kernels 6 and 7 on the band alone (:func:`_halo_band`), each case
    (op, note, dtype, m) on x_ext framed by NaN rows: Y within TOL of
    max|Y_band| of the plain version. With the diagonal blocks in, the
    coupling-1e-3 band is ~1e-9-1e-5 of max|Y|, under every limit. Each
    fault, given to the plain version (:func:`_dense_faults` or
    :func:`_int8_faults`, and the halo rows zeroed), must read above the
    limit, or the check could not see it."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    for op, note, dtype, m in cases:
        quant = hasattr(op, "qblocks")
        name = "banded_q_ext_bsr_spmm" if quant else "banded_ext_bsr_spmm"
        kernel = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        bw, halo = op.bandwidth, op.bandwidth * op.block_size
        kw = dict(bandwidth=bw, out_dtype=kernels.acc_dtype(dtype))
        lead = _halo_band(op, dtype)
        x_ext = randn(op.shape[0] + 2 * halo, m, dtype)
        y = kernel(*lead, _apart(x_ext, halo), **kw)
        yp = plain(*lead, x_ext, **kw)
        top = float(torch.max(torch.abs(yp)))
        rel = float(torch.max(torch.abs(y - yp))) / top
        del y
        read = {}
        for f, fl in (_int8_faults(*lead) if quant
                      else _dense_faults(lead[0])).items():
            read[f] = float(torch.max(torch.abs(plain(*fl, x_ext, **kw)
                                                - yp))) / top
            del fl
        cut = x_ext.clone()
        cut[:halo] = 0
        cut[-halo:] = 0
        read["halo rows zeroed"] = float(torch.max(torch.abs(
            plain(*lead, cut, **kw) - yp))) / top
        limit = TOL[_dname(dtype)]
        print(f"  {name:22s} band only {note:24s} {_dname(dtype)} m={m:<4d} "
              f"|dY|/max|Y_band|={rel:.3e} (limit {limit:.0e}); with a "
              "fault: " + ", ".join(f"{f} {r:.3e}" for f, r in read.items()),
              flush=True)
        _check(rel <= limit, f"{name} band only {note} {_dname(dtype)} "
               f"m={m}: {rel:.3e}")
        _check(min(read.values()) > limit, f"{name} band only {note} "
               f"m={m}: a fault reads {read}, within the limit")
        _note_band(band_checks, name, rel, read)
        del lead, x_ext, yp, cut
        torch.cuda.empty_cache()


def _time_queued_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Median CUDA-event time of ``calls`` calls of ``fn`` back to back,
    over ``calls``: the host's work between launches stays hidden behind
    the queue, where :func:`_time_ms` (one call between the events) counts
    it whenever the card finishes first."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def ext_route_split(A, randn) -> dict:
    """Kernel 6 at its main case (f64 m=40, the 1M-row matrix) on its two
    routes (``kernels.banded_ext_bsr_spmm_at``), the TMA stream and kernel
    1's cp.async template (the same bits: :func:`tma_stress`), beside the
    one-call bmm yardstick (``torch.bmm`` over the window view
    of x_ext), timed in turns (tma, cp.async, bmm, then back), each call
    alone (:func:`_time_ms`, as every kernel here) and 10 calls back to
    back (:func:`_time_queued_ms`); and the host time of one call of each
    route (checks, the route, on the TMA route the tensor maps' encoding,
    the launch), over 50 calls on the host clock. Returns the numbers."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    _, m, _, _, _ = MAIN_CASE["banded_ext_bsr_spmm"]
    nbr, bs, bw = A.n_block_rows, A.block_size, A.bandwidth
    K = 2 * bw + 1
    x_ext = randn(A.shape[0] + 2 * bw * bs, m, torch.float64)
    window = x_ext.as_strided((nbr, K * bs, m), (bs * m, m, 1))
    fns = {route: (lambda route=route: kernels.banded_ext_bsr_spmm_at(
        route, A.blocks, x_ext, bandwidth=bw))
        for route in ("tma", "cp.async")}
    fns["bmm"] = lambda: torch.bmm(A.blocks, window)
    _check(kernels.ext_spmm_route(torch.float64, bs, m, A.blocks.data_ptr(),
                                  x_ext.data_ptr()) == "tma",
           "kernel 6's main case does not take the TMA route")
    order = list(fns) + list(fns)[::-1]
    single = {key: [] for key in fns}
    queued = {key: [] for key in fns}
    for key in order:
        single[key].append(_time_ms(fns[key]))
        queued[key].append(_time_queued_ms(fns[key]))
    host_us = {}
    for route in ("tma", "cp.async"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fns[route]()
        host_us[route] = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
    out = {f"{key}_ms": statistics.mean(single[key]) for key in fns}
    out.update({f"{key}_queued_ms": statistics.mean(queued[key])
                for key in fns})
    out.update({f"{route}_host_us": us for route, us in host_us.items()})
    out["plans"] = {route: kernels.ext_spmm_plan(0, torch.float64, bs, m,
                                                 route)
                    for route in ("tma", "cp.async")}
    print(f"  banded_ext_bsr_spmm f64 m={m} nbr={nbr} by route (ms, mean of "
          f"two turns; one call / 10 back to back): " + ", ".join(
              f"{key} {out[key + '_ms']:.4f} / {out[key + '_queued_ms']:.4f}"
              for key in fns)
          + f"; host per call: tma {host_us['tma']:.1f} us, cp.async "
          f"{host_us['cp.async']:.1f} us; turns {single} / {queued}; "
          f"layouts {out['plans']}", flush=True)
    del x_ext, window
    torch.cuda.empty_cache()
    return out


# Kernel 6's TMA route under repetition: (dtype, m, calls) on the 1M-row
# matrix, the main case first.
TMA_STRESS = [("float64", 40, 600),
              *(("float64", m, 120) for m in (6, 12, 24, 80, 160)),
              *(("float32", m, 120) for m in (12, 40, 160)),
              *(("bfloat16", m, 120) for m in (24, 40, 160))]


def tma_stress(A, randn) -> dict:
    """Kernel 6's TMA route called again and again (:data:`TMA_STRESS`),
    every output held bit for bit to the cp.async route's on the same
    operands (the same products in the same order). A fault of the TMA
    pipeline (a stage freed while a lane's loads of it are in flight, so
    that the next TMA write lands under them: csrc/ext_spmm.cu's proxy
    fence, scripts/tma_stress.py) shows as a few wrong rows or columns of
    one warp tile now and then, not on every call. Fails on any differing
    output; returns the calls and the seconds."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    bw, bs = A.bandwidth, A.block_size
    calls, t0 = 0, time.perf_counter()
    for dname, m, n in TMA_STRESS:
        dtype = getattr(torch, dname)
        blocks = A.blocks.to(dtype)
        x_ext = randn(A.shape[0] + 2 * bw * bs, m, dtype)
        _check(kernels.ext_spmm_route(dtype, bs, m, blocks.data_ptr(),
                                      x_ext.data_ptr()) == "tma",
               f"kernel 6 {dname} m={m} does not take the TMA route")
        acc = kernels.acc_dtype(dtype)   # bf16: compare the float32 sums
        want = kernels.banded_ext_bsr_spmm_at("cp.async", blocks, x_ext,
                                              bandwidth=bw, out_dtype=acc)
        bad = [i for i in range(n) if not torch.equal(
            kernels.banded_ext_bsr_spmm_at("tma", blocks, x_ext,
                                           bandwidth=bw, out_dtype=acc),
            want)]
        calls += n
        tail = f" {bad[:10]}" if bad else ""
        print(f"  kernel 6 TMA route {dname} m={m}: {n} calls, {len(bad)} "
              f"with other bits than the cp.async route{tail}", flush=True)
        _check(not bad, f"kernel 6's TMA route gave other bits than its "
               f"cp.async route on {len(bad)} of {n} calls ({dname} m={m})")
        del blocks, x_ext, want
    torch.cuda.empty_cache()
    return {"calls": calls, "s": time.perf_counter() - t0}


def bf16_variant_split(q, probe, randn, record, band_checks) -> dict:
    """Kernel 5's bf16-dequant variants (``kernels.fused_gram_variant``,
    csrc/fused_gram_q8bf16.cu) at two shapes: the probe's
    (``quantize_banded_int8`` of the probe matrix, m = mv = 256) and kernel
    5's main case (the 2M-row int8 matrix, m = 20, mv = 220). Each variant
    against its plain version, on the operator and on its band alone (the
    diagonal zeroed): G within GRAM_TOL of |V|ᵀ|Y| elementwise (nov_bf16:
    row 0 within GRAM_TOL of the column sums of |Y|, the rest zeros), the
    same bits twice. The same limit must see a G of zeros and a G over half
    the rows, and on the band alone each of :func:`_int8_faults`. Then
    timed in turns (the list, then back) beside kernel 5 on float32 x and
    v and its nov and nogram: does the one-product bf16 apply beat the two
    TF32 products, and how much of the sweep is the gram. Records the
    operator's rows (the probe's shape is the variants' main case); returns
    {shape: {mode: ms}} and the operators' sizes for the bounds."""
    import types
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels
    qp = fdtt.quantize_banded_int8(probe)
    out = {"ops": {"nbr=4096": (types.SimpleNamespace(
        n_block_rows=qp.n_block_rows, block_size=qp.block_size,
        bandwidth=qp.bandwidth), _nonzero_blocks(qp.qblocks, 2 * qp.bandwidth
                                                 + 1))}}
    name5 = "banded_q_bsr_spmm_gram"
    for tag, op, m, mv, shape in (
            ("probe", qp, PROBE["m"], PROBE["m"], "nbr=4096 bs=128 bw=2"),
            ("main", q, 20, 220, "nbr=16384 bs=128 bw=1")):
        bw, n, h = op.bandwidth, op.shape[0], op.shape[0] // 2
        x32, v32 = randn(n, m), randn(n, mv)
        xb, vb = x32.to(torch.bfloat16), v32.to(torch.bfloat16)
        full = (op.qblocks, op.scale_rows, op.diag)
        band = (op.qblocks, op.scale_rows, torch.zeros_like(op.diag))
        fns = {}
        for lead, label in ((full, ""), (band, "band only")):
            y = kernels.q_bf16_apply_plain(*lead, xb, bw)
            scale = torch.abs(vb.float()).T @ torch.abs(y)
            colsum = torch.abs(y.double()).sum(0)
            faults = _int8_faults(*lead) if label else {}
            for variant in kernels.BF16_VARIANTS:
                nov = variant == "nov_bf16"
                v = None if nov else vb
                kernel = (lambda ld=lead, v=v, var=variant:
                          kernels.fused_gram_variant(
                              name5, ld, xb, v, bandwidth=bw, variant=var))
                plain = (lambda ld=lead, x=xb, v=v, var=variant:
                         kernels.fused_gram_variant_plain(
                             name5, ld, x, v, bandwidth=bw, variant=var))

                def ratio(g, gp):
                    err = torch.abs(g - gp)
                    if nov:
                        return float(torch.max(err[0].double()
                                               / (colsum + 1e-30)))
                    return float(torch.max(err / (scale + 1e-30)))
                g, gp = kernel(), plain()
                again = kernel()
                torch.cuda.synchronize()
                _check(torch.equal(g, again), f"{variant} {shape} {label}: "
                       "the G reduction gave other bits on a second run")
                r = ratio(g, gp)
                ok = r <= GRAM_TOL and not (nov and bool(torch.any(g[1:])))
                half = plain(tuple(t[:op.n_block_rows // 2] for t in lead),
                             xb[:h], None if nov else vb[:h])
                read = {"G zeros": ratio(torch.zeros_like(gp), gp),
                        "half the rows": ratio(half, gp),
                        **{f: ratio(plain(fl), gp)
                           for f, fl in faults.items()}}
                del half
                row = dict(name=f"fused_probe_{variant}", dtype="bfloat16",
                           m=m, mv=None if nov else mv, write_out=False,
                           shape=shape, max_abs_err=float(torch.max(
                               torch.abs(g - gp))), rel_err=0.0,
                           gram_ratio=r, ms=None, plain_ms=None)
                row["g_abs_err"] = row["max_abs_err"]
                t = ""
                if not label:
                    fns[variant] = kernel
                    row["ms"], row["plain_ms"] = (_time_ms(kernel),
                                                  _time_ms(plain))
                    record.append(row)
                    t = (f" kernel={row['ms']:.4f} ms "
                         f"plain={row['plain_ms']:.4f} ms")
                else:
                    _note_band(band_checks, row["name"], r, read)
                print(f"  {row['name']:22s} bfloat16 {shape:24s} {label:9s} "
                      f"m={m:<4d} mv={row['mv']!s:<5s} G abs="
                      f"{row['g_abs_err']:.3e} ratio={r:.3e} (limit "
                      f"{GRAM_TOL:.0e}); with a fault: "
                      + ", ".join(f"{f} {r_:.3e}" for f, r_ in read.items())
                      + t, flush=True)
                _check(ok, f"{variant} {shape} {label}: G error {r:.3e}")
                _check(min(read.values()) > GRAM_TOL, f"{variant} {shape} "
                       f"{label}: a fault reads {read}, within the limit")
                del g, gp, again
            del y, scale, colsum, faults
        del band
        split = {
            "kernel 5": lambda: kernels.banded_q_bsr_spmm_gram(
                *full, x32, v32, bandwidth=bw, write_out=False),
            "nov": lambda: kernels.fused_gram_variant(
                name5, full, x32, v32, bandwidth=bw, variant="nov"),
            "nogram": lambda: kernels.fused_gram_variant(
                name5, full, x32, v32, bandwidth=bw, variant="nogram"),
            **fns}
        order = list(split) + list(split)[::-1]
        times = {key: [] for key in split}
        for key in order:
            times[key].append(_time_ms(split[key]))
        row = {key: statistics.mean(t) for key, t in times.items()}
        print(f"  kernel 5 and its variants, int8 {shape} m={m} mv={mv} (ms, "
              f"mean of two turns; kernel 5, nov, nogram on float32 x and v, "
              f"the bf16-dequant variants on bf16): "
              + ", ".join(f"{k} {t:.4f}" for k, t in row.items())
              + f"; turns {times}", flush=True)
        plans = {var: kernels.fused_typed_plan(
            x32.device.index or 0, torch.bfloat16, op.n_block_rows,
            op.block_size, 2 * bw + 1, m, m if var == "nov_bf16" else mv,
            quant=True) for var in ("bf16deq", "nov_bf16")}
        print(f"    layouts: {plans}", flush=True)
        out[tag] = dict(row, shape=shape)
        del x32, v32, xb, vb, fns, split
        torch.cuda.empty_cache()
    del qp
    return out


# Float64 x on int8 storage: the band is summed in float64 and rounded to
# float32 as the plain version rounds it, so the two part by one float32
# ulp where their float64 sums straddle a rounding boundary.
Q64_TOL = 2.0 ** -22


def int8_float64_x(op, note, randn, timed, record, info, band_checks):
    """Kernels 4, 5 and 7 with float64 x (and v) against their plain
    versions: Y within Q64_TOL of max|Y|, G within GRAM_TOL of |V|ᵀ|Y|;
    kernel 5's Y (``csrc/fused_gram_q8f64.cu``, row
    ``banded_q_bsr_spmm_gram_f64`` of ``record``) kernel 4's bits, the
    same bits twice, its ``nov`` variant Y's column sums.
    Kernels 4 and 7 (``csrc/q_spmm_f64.cu``, rows ``banded_q_bsr_spmm_f64``
    and ``banded_q_ext_bsr_spmm_f64`` of ``record``) also: x framed by NaN
    rows (kernel 4's Y finite), the same bits twice, kernel 7 over the one
    slab's ring-wrapped x_ext equal to kernel 4 bit for bit, and on the
    band alone (the diagonal zeroed) within Q64_TOL of max|Y_band|, a limit
    that each fault of :func:`_int8_faults` must exceed (into
    ``band_checks``); the share of Y's bits equal to the plain version's is
    printed and not held. ``timed``: each timed beside its plain version,
    and kernel 5 (mv = 220) in turns beside its plain version, its unfused
    yardstick (kernel 4, then ``torch.matmul(v.T, y)`` in float64) and its
    ``nov`` and ``nogram`` variants, with its layout, into
    ``info["banded_q_bsr_spmm_gram_f64"][m]``."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    lead = (op.qblocks, op.scale_rows, op.diag)
    band = (op.qblocks, op.scale_rows, torch.zeros_like(op.diag))
    faults = _int8_faults(*band)
    bw, halo = op.bandwidth, op.bandwidth * op.block_size
    n = op.shape[0]
    f64 = torch.float64

    def rel_err(y, yp):
        return (float(torch.max(torch.abs(y - yp)))
                / float(torch.max(torch.abs(yp))))

    def close(label, y, yp):
        rel = rel_err(y, yp)
        _check(y.dtype == yp.dtype == f64 and rel <= Q64_TOL,
               f"{label} {note}: {y.dtype} rel err {rel:.3e} > {Q64_TOL}")
        return rel

    for m in (20, 40):
        x = randn(n, m, f64)
        xf = _apart(x, halo)
        x_ext = _apart(_ring_ext(x, 0, n, halo), halo)
        pairs = {
            "banded_q_bsr_spmm_f64": (
                lambda t=lead: kernels.banded_q_bsr_spmm(*t, xf, bw),
                lambda t=lead: kernels.banded_q_bsr_spmm_plain(*t, x, bw)),
            "banded_q_ext_bsr_spmm_f64": (
                lambda t=lead: kernels.banded_q_ext_bsr_spmm(
                    *t, x_ext, bandwidth=bw),
                lambda t=lead: kernels.banded_q_ext_bsr_spmm_plain(
                    *t, x_ext, bandwidth=bw)),
        }
        ys, line = {}, []
        for name, (kern, plain) in pairs.items():
            y, yp = kern(), plain()
            _check(bool(torch.all(torch.isfinite(y))),
                   f"{name} {note} m={m}: Y not finite on NaN-framed x")
            _check(torch.equal(y, kern()),
                   f"{name} {note} m={m}: other bits on a second call")
            rel = close(name, y, yp)
            same = float(torch.mean((y == yp).double()))
            yb = plain(band)
            top = float(torch.max(torch.abs(yb)))
            rb = float(torch.max(torch.abs(kern(band) - yb))) / top
            read = {f: float(torch.max(torch.abs(plain(t) - yb))) / top
                    for f, t in faults.items()}
            _check(rb <= Q64_TOL, f"{name} band only {note} m={m}: {rb:.3e}")
            _check(min(read.values()) > Q64_TOL, f"{name} band only {note} "
                   f"m={m}: a fault reads {read}, within the limit")
            _note_band(band_checks, name, rb, read)
            row = dict(name=name, dtype="float64", m=m, mv=None,
                       write_out=True, shape=note,
                       max_abs_err=float(torch.max(torch.abs(y - yp))),
                       rel_err=rel, gram_ratio=None, same_bits_share=same,
                       ms=None, plain_ms=None)
            if timed:
                row["ms"], row["plain_ms"] = _time_ms(kern), _time_ms(plain)
            record.append(row)
            ys[name] = y
            t = (f" {row['ms']:.4f} ms (plain {row['plain_ms']:.4f})"
                 if timed else "")
            line.append(f"{name} rel {rel:.3e}, band only {rb:.3e} (faults "
                        f">= {min(read.values()):.3e}), {same:.4f} of Y's "
                        f"bits the plain version's;{t}")
            del y, yp, yb
        _check(torch.equal(ys["banded_q_ext_bsr_spmm_f64"],
                           ys["banded_q_bsr_spmm_f64"]),
               f"kernel 7 f64 {note} m={m}: one slab is not kernel 4's Y")
        del ys
        # Kernel 5's float64-x entry (row 5d): Y kernel 4's bits, G
        # within GRAM_TOL of |V|ᵀ|Y|, the same bits twice.
        name5 = "banded_q_bsr_spmm_gram_f64"
        v220 = randn(n, 220, f64)
        y4 = kernels.banded_q_bsr_spmm(*lead, xf, bw)
        r5 = g5 = 0.0
        for v in (None, v220):
            y, g = kernels.banded_q_bsr_spmm_gram(*lead, xf, v, bandwidth=bw)
            yp, gp = kernels.banded_q_bsr_spmm_gram_plain(*lead, x, v,
                                                          bandwidth=bw)
            rel = close("banded_q_bsr_spmm_gram f64", y, yp)
            r5 = max(r5, rel)
            _check(torch.equal(y, y4), f"kernel 5 f64 {note} m={m} mv="
                   f"{None if v is None else 220}: Y is not kernel 4's")
            again = kernels.banded_q_bsr_spmm_gram(*lead, xf, v, bandwidth=bw)
            _check(torch.equal(again[0], y) and torch.equal(again[1], g),
                   f"kernel 5 f64 {note} m={m}: other bits on a second call")
            vv = x if v is None else v
            ratio = float(torch.max(torch.abs(g - gp) / (
                (torch.abs(vv).T @ torch.abs(yp)).float() + 1e-30)))
            g5 = max(g5, ratio)
            _check(ratio <= GRAM_TOL, f"kernel 5 f64 {note} m={m}: G error "
                   f"{ratio:.3e}")
            row = dict(name=name5, dtype="float64", m=m,
                       mv=None if v is None else 220, write_out=True,
                       shape=note, max_abs_err=float(torch.max(
                           torch.abs(y - yp))), rel_err=rel,
                       gram_ratio=ratio, g_abs_err=float(torch.max(
                           torch.abs(g - gp))), ms=None, plain_ms=None)
            if timed and v is not None:
                fns = {
                    "ms": lambda: kernels.banded_q_bsr_spmm_gram(
                        *lead, x, v220, bandwidth=bw),
                    "plain_ms": lambda: kernels.banded_q_bsr_spmm_gram_plain(
                        *lead, x, v220, bandwidth=bw),
                    "unfused_ms": lambda: torch.matmul(
                        v220.T, kernels.banded_q_bsr_spmm(*lead, x, bw)),
                    **{f"{var}_ms": lambda var=var: kernels.fused_gram_variant(
                        "banded_q_bsr_spmm_gram", lead, x, v220,
                        bandwidth=bw, variant=var)
                       for var in ("nov", "nogram")},
                }
                order = list(fns) + list(fns)[::-1]
                times = {key: [] for key in fns}
                for key in order:
                    times[key].append(_time_ms(fns[key]))
                row5 = {key: statistics.mean(t) for key, t in times.items()}
                row5["plan"] = kernels.fused_typed_plan(
                    x.device.index or 0, f64, op.n_block_rows,
                    op.block_size, 2 * bw + 1, m, 220, quant=True)
                row.update(ms=row5["ms"], plain_ms=row5["plain_ms"])
                info.setdefault(name5, {})[m] = row5
            record.append(row)
            del y, g, yp, gp, again, vv
        # Its "nov" variant: G's row 0 the column sums of Y.
        ysum = y4.sum(0)
        g = kernels.fused_gram_variant("banded_q_bsr_spmm_gram", lead, xf,
                                       v220, bandwidth=bw, variant="nov")
        _check(not bool(torch.any(g[1:])) and bool(torch.all(
            torch.abs(g[0].double() - ysum) <= GRAM_TOL
            * torch.abs(y4).sum(0) + 1e-30)),
               f"kernel 5 f64 nov {note} m={m}: G row 0 is not Y's column "
               "sums")
        del y4, ysum, g
        t5 = ""
        if timed:
            row5 = info[name5][m]
            t5 = (f" {row5['ms']:.4f} ms (plain {row5['plain_ms']:.4f}, "
                  f"unfused: kernel 4 + matmul(v.T, y) "
                  f"{row5['unfused_ms']:.4f}; nov {row5['nov_ms']:.4f}, "
                  f"nogram {row5['nogram_ms']:.4f}; mean of two turns) "
                  f"layout {row5['plan']}")
        print(f"  float64 x on int8 storage, {note} m={m}: "
              + " ".join(line) + f" kernel 5 (csrc/fused_gram_q8f64.cu) Y "
              f"kernel 4's bits, rel {r5:.3e}, G |dG|/(|V|ᵀ|Y|) {g5:.3e};"
              f"{t5}", flush=True)
        del x, xf, x_ext, v220
        torch.cuda.empty_cache()
    del faults, band


def typed_gram_rows(A, randn, record) -> dict:
    """Kernel 3's bf16 and float64 entries (rows 3b, 3d:
    ``csrc/fused_gram_typed.cuh``) at row 3's shape, the 1M-row matrix at
    m = 128, mv = 1408: Y and G against the plain version (Y within TOL of
    max|Y|; G within GRAM_TOL of |V|ᵀ|Y| in both types: where a Y sum in
    another order rounds to the neighbouring bf16 value, that one term of
    G's million moves it by ~2^-8 / n of |V|ᵀ|Y|), the same bits twice,
    each timed beside the plain version and the unfused yardstick (kernel
    1 in the same type, then ``torch.matmul(v.T, y)``), with the plan the
    wrapper takes (``kernels.fused_typed_plan``) and its time split into
    the measurement variants (``kernels.typed_gram_variant``: ``nov`` no
    V, ``nogram`` V streamed without the gram's products). Appends each
    row to ``record`` (as
    ``banded_bsr_spmm_gram_bf16`` / ``_f64``). Returns dtype -> the row."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    _, m, mv, _, _ = MAIN_CASE["banded_bsr_spmm_gram"]
    bw, n, nbr = A.bandwidth, A.shape[0], A.n_block_rows
    out = {}
    for dtype in (torch.bfloat16, torch.float64):
        dn = _dname(dtype)
        name = f"banded_bsr_spmm_gram_{'bf16' if dn == 'bfloat16' else 'f64'}"
        blocks = A.blocks.to(dtype)
        x, v = randn(n, m, dtype), randn(n, mv, dtype)
        # Y in the sums' type (bf16 storage: the float32 sums).
        acc = kernels.acc_dtype(dtype)
        y, g = kernels.banded_bsr_spmm_gram(blocks, x, v, bandwidth=bw,
                                            out_dtype=acc)
        again = kernels.banded_bsr_spmm_gram(blocks, x, v, bandwidth=bw,
                                             out_dtype=acc)
        same = torch.equal(y, again[0]) and torch.equal(g, again[1])
        del again
        yp, gp = kernels.banded_bsr_spmm_gram_plain(blocks, x, v,
                                                    bandwidth=bw,
                                                    out_dtype=acc)
        err = float(torch.max(torch.abs(y.double() - yp.double())))
        rel = err / float(torch.max(torch.abs(yp.double())))
        g_err = torch.abs(g.double() - gp.double())
        ratio = float(torch.max(g_err / (
            torch.abs(v).double().T @ torch.abs(yp).double() + 1e-30)))
        _check(rel <= TOL[dn] and ratio <= GRAM_TOL and same,
               f"kernel 3 {dn} m={m} mv={mv}: Y rel {rel:.3e}, G {ratio:.3e} "
               f"(limit {GRAM_TOL:.0e}), same bits twice {same}")
        g_abs = float(torch.max(g_err))
        del y, g, yp, gp, g_err
        dev = x.device.index or 0
        plan = kernels.fused_typed_plan(dev, dtype, nbr, A.block_size,
                                        2 * bw + 1, m, mv)
        fns = {
            "ms": lambda: kernels.banded_bsr_spmm_gram(blocks, x, v,
                                                       bandwidth=bw),
            "plain_ms": lambda: kernels.banded_bsr_spmm_gram_plain(
                blocks, x, v, bandwidth=bw),
            "unfused_ms": lambda: torch.matmul(
                v.T, kernels.banded_bsr_spmm(blocks, x, bw)),
            **{f"{var}_ms": (lambda var=var: kernels.typed_gram_variant(
                blocks, x, v, bandwidth=bw, variant=var))
               for var in ("nov", "nogram")},
        }
        row = {key: _time_ms(fn) for key, fn in fns.items()}
        row.update(plan=plan, max_err_rel=rel, max_gram_err_rel=ratio)
        print(f"  {name} (fused_gram_typed.cuh) m={m} mv={mv}, plan {plan}: "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, unfused "
              f"(kernel 1 + matmul(v.T, y)) {row['unfused_ms']:.4f}; split "
              f"nov {row['nov_ms']:.4f} nogram {row['nogram_ms']:.4f}; Y rel "
              f"{rel:.3e} G |dG|/(|V|ᵀ|Y|) {ratio:.3e}", flush=True)
        record.append(dict(name=name, dtype=dn, m=m, mv=mv, write_out=True,
                           shape=f"nbr={nbr} bs={A.block_size} bw={bw}",
                           max_abs_err=err, rel_err=rel, g_abs_err=g_abs,
                           gram_ratio=ratio, ms=row["ms"],
                           plain_ms=row["plain_ms"]))
        out[dn] = row
        del blocks, x, v
        torch.cuda.empty_cache()
    return out


def _copy_bytes(op, m, dtype) -> int:
    """The bytes kernel 1 and its copy variant move: every block once, x
    once, Y (the accumulation type) once."""
    isz = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    n = op.n_block_rows * op.block_size
    return (op.blocks.numel() * isz + n * m * isz
            + n * m * max(isz, 4))


def _probe_operator(dev):
    """bench.py's bench_bsr_spmm matrix (bench.py:182-192: float32, scaled
    to spectral radius < 1), the probes' shape."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    op = fdtt.generate_banded_bsr(PROBE["nbr"], PROBE["bs"],
                                  bandwidth=PROBE["bw"], coupling=1e-3,
                                  seed=0, dtype=torch.float32, device=dev)
    scale = 1.0 / (PROBE["nbr"] * PROBE["bs"] * 2.0)
    return fdtt.BSROperator(op.block_cols, op.blocks * scale,
                            bandwidth=PROBE["bw"])


# The split of kernel 1: each entry one launch of a variant (or of kernel
# 1, or a PyTorch call) on the same blocks and x.
K1_SPLIT = (
    ("full", dict(variant="full")),
    ("noy", dict(variant="noy")),
    ("copy", dict(variant="copy")),
    ("writeonly", dict(variant="writeonly")),
    ("writeonly_into_x", None),
    ("fill_", None),
    ("rows_per_cta=2", dict(variant="full", rows_per_cta=2)),
    ("rows_per_cta=4", dict(variant="full", rows_per_cta=4)),
    ("stages=2", dict(variant="full", stages=2)),
    ("stages=3", dict(variant="full", stages=3)),
    ("stages=6", dict(variant="full", stages=6)),
    ("store=tma", dict(variant="full", store="tma")),
    ("block_policy=evict_first", dict(variant="full",
                                      block_policy="evict_first")),
)


def kernel1_variants(A, probe, q, dev, randn, record) -> dict:
    """Phase 3, kernel 1's variants (``kernels.banded_spmm_variant``):
    each against its plain version, then the split, timed in turns (the
    list, then back) at the main case (f64 m=48, the 1M-row matrix) and at
    the probes' shape in bf16 (m=256): kernel 1 itself, every variant, and
    ``torch.Tensor.fill_`` on a Y-sized tensor (writeonly's library call);
    at the probes' shape also kernel 4 on ``quantize_banded_int8`` of the
    probe matrix (``spmm_probe2.py``'s int8, ``spmm_probe3.py``'s
    manwrite-int8). Then the copy variant (kernel 9) at its shapes, with
    its GB/s against 3.35 TB/s; and kernel 5's v=None modes
    (``r4_visx_probe2.py``). Returns the numbers for the summary."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels
    variant = kernels.banded_spmm_variant
    out = {"split": {}, "copy": []}

    def check(label, dtype, y, yp):
        tol = TOL[_dname(dtype)]
        err = float(torch.max(torch.abs(y.double() - yp.double())))
        rel = err / max(float(torch.max(torch.abs(yp.double()))), 1e-300)
        print(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e}", flush=True)
        _check(tuple(y.shape) == tuple(yp.shape) and rel <= tol,
               f"{label}: rel err {rel:.3e} > {tol}")
        return err

    copy_errs = []
    for op, dtype, m, tag in ((A, torch.float64, 48, "main"),
                              (probe, torch.bfloat16, PROBE["m"], "probe")):
        bw = op.bandwidth
        blocks = op.blocks.to(dtype)
        x = _apart(randn(op.shape[0], m, dtype), bw * op.block_size)
        shape = (f"{_dname(dtype)} m={m} nbr={op.n_block_rows} "
                 f"bw={bw}")
        for key, kw in K1_SPLIT:
            if kw is None:
                continue
            y = variant(blocks, x, bw, **kw)
            again = variant(blocks, x, bw, **kw)
            _check(torch.equal(y, again), f"{key} {shape}: other bits on a "
                   "second call")
            tm = kernels.banded_spmm_plan(0, dtype, op.block_size, m,
                                          kw["variant"])["TM"]
            err = check(f"banded_spmm_variant {key} {shape}", dtype, y,
                        kernels.banded_spmm_variant_plain(
                            blocks, x, bw, variant=kw["variant"],
                            row_tile=tm))
            if key == "copy":
                copy_errs.append(err)
            del y, again
        acc = kernels.acc_dtype(dtype)
        fresh = torch.empty((op.shape[0], m), dtype=acc, device=dev)
        own = x.clone() if dtype == acc else None
        fns = {"full": lambda: kernels.banded_bsr_spmm(blocks, x, bw,
                                                       out_dtype=acc)}
        for key, kw in K1_SPLIT[1:]:
            if kw is not None:
                fns[key] = lambda kw=kw: variant(blocks, x, bw, **kw)
        # writeonly allocates its Y (a fresh buffer from the caching
        # allocator each call); writeonly_into_x writes into x's own.
        if own is not None:
            fns["writeonly_into_x"] = lambda: variant(
                blocks, own, bw, variant="writeonly", out=own)
        fns["fill_"] = lambda: fresh.fill_(1.0)
        if tag == "probe":
            qp = fdtt.quantize_banded_int8(op)
            xq = randn(op.shape[0], m)
            lead = (qp.qblocks, qp.scale_rows, qp.diag)
            fns["kernel 4 (int8)"] = lambda: kernels.banded_q_bsr_spmm(
                *lead, xq, bw)
            check(f"banded_q_bsr_spmm {shape} int8", torch.float32,
                  kernels.banded_q_bsr_spmm(*lead, xq, bw),
                  kernels.banded_q_bsr_spmm_plain(*lead, xq, bw))
        order = list(fns) + list(fns)[::-1]
        times = {key: [] for key in fns}
        for key in order:
            times[key].append(_time_ms(fns[key]))
        row = {key: statistics.mean(t) for key, t in times.items()}
        nbytes = _copy_bytes(op, m, _dname(dtype))
        plan = kernels.banded_spmm_plan(0, dtype, op.block_size, m)
        print(f"  kernel 1 split, {shape} (ms, mean of two turns; "
              f"{nbytes / 1e9:.3f} GB moved by kernel 1, bound "
              f"{nbytes / HBM_BYTES_S * 1e3:.4f} ms; kernel 1's launch "
              f"{plan}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"; turns {times}", flush=True)
        out["split"][tag] = dict(row, shape=shape, gb=nbytes / 1e9)
        del blocks, x, fresh, own, fns
        if tag == "probe":
            del qp, xq, lead
        torch.cuda.empty_cache()

    # The copy variant (kernel 9) at its shapes: kernel 1's main case at
    # m = 48 and 320, bench.py's shape in f32, the probes' shape in bf16.
    for op, dtype, m in ((A, torch.float64, 48), (A, torch.float64, 320),
                         (probe, torch.float32, PROBE["m"]),
                         (probe, torch.bfloat16, PROBE["m"])):
        bw = op.bandwidth
        blocks = op.blocks.to(dtype)
        x = randn(op.shape[0], m, dtype)
        shape = f"{_dname(dtype)} m={m} nbr={op.n_block_rows} bw={bw}"

        def plain(blocks=blocks, x=x, bw=bw):
            return kernels.banded_spmm_variant_plain(blocks, x, bw,
                                                     variant="copy")
        copy_errs.append(check(f"copy {shape}", dtype,
                               variant(blocks, x, bw, variant="copy"),
                               plain()))
        acc = kernels.acc_dtype(dtype)
        ms = _time_ms(lambda: variant(blocks, x, bw, variant="copy"))
        k1 = _time_ms(lambda: kernels.banded_bsr_spmm(blocks, x, bw,
                                                      out_dtype=acc))
        plain_ms = _time_ms(plain)
        nbytes = _copy_bytes(op, m, _dname(dtype))
        gbs = nbytes / ms / 1e6
        print(f"  copy (kernel 9) {shape}: {ms:.4f} ms, {gbs:.1f} GB/s "
              f"({gbs / (HBM_BYTES_S / 1e9):.1%} of 3.35 TB/s); kernel 1 "
              f"{k1:.4f} ms ({nbytes / k1 / 1e6:.1f} GB/s); plain "
              f"{plain_ms:.4f} ms", flush=True)
        out["copy"].append(dict(shape=shape, ms=ms, plain_ms=plain_ms,
                                kernel1_ms=k1, gb=nbytes / 1e9, gb_s=gbs))
        del blocks, x
        torch.cuda.empty_cache()
    main = out["copy"][0]
    record.append(dict(name="banded_spmm_copy", dtype="float64", m=48,
                       mv=None, write_out=True, shape="nbr=8192",
                       max_abs_err=max(copy_errs), rel_err=None,
                       gram_ratio=None, ms=main["ms"],
                       plain_ms=main["plain_ms"]))

    # Kernel 5 with v = None at the int8 main case (m = 20): the modes of
    # experiments/r4_visx_probe2.py. visx: the full kernel, G = Xᵀ A X;
    # nogram: the sweep without the gram (fused_gram_variant); visx_f32acc
    # (the gram from float32 sums) is what the port's kernel 5 always does.
    x = randn(q.shape[0], 20)
    lead = (q.qblocks, q.scale_rows, q.diag)
    visx = {
        "visx": lambda: kernels.banded_q_bsr_spmm_gram(
            *lead, x, None, bandwidth=q.bandwidth, write_out=False),
        "nogram": lambda: kernels.fused_gram_variant(
            "banded_q_bsr_spmm_gram", lead, x, None, bandwidth=q.bandwidth,
            variant="nogram"),
    }
    g = visx["visx"]()
    gp = kernels.banded_q_bsr_spmm_gram_plain(*lead, x, None,
                                              bandwidth=q.bandwidth,
                                              write_out=False)
    yp = kernels.banded_q_bsr_spmm_plain(*lead, x, q.bandwidth)
    ratio = float(torch.max(torch.abs(g - gp)
                            / (torch.abs(x).T @ torch.abs(yp) + 1e-30)))
    _check(ratio <= GRAM_TOL, f"kernel 5 v=None: G error {ratio:.3e}")
    row = {k: _time_ms(f) for k, f in visx.items()}
    print(f"  kernel 5 v=None int8 m=20 (r4_visx_probe2 modes): visx "
          f"{row['visx']:.4f} ms, nogram {row['nogram']:.4f} ms; G within "
          f"{ratio:.3e} of |X|ᵀ|Y|", flush=True)
    out["visx"] = row
    del x, g, gp, yp
    torch.cuda.empty_cache()
    return out


def _apart(t, pad: int):
    """``t`` copied into a buffer of its own between ``pad`` NaN rows on
    each side, as a received halo lies apart from the shard's rows: a load
    through the wrong pointer, or past an end, changes the bits."""
    import torch
    buf = torch.full((t.shape[0] + 2 * pad, t.shape[1]), float("nan"),
                     dtype=t.dtype, device=t.device)
    buf[pad:-pad] = t
    return buf[pad:-pad]


def _remote_apart(blocks, bw: int, halo: int, out_dtype):
    """Kernel 8 on a halo-extended x_ext: its shard rows and its two halos
    go to the kernel as three buffers (:func:`_apart`). The buffers of the
    last x_ext are kept, so that a timed call times the kernel alone."""
    from fortran_davidson_tpu_torch.ops import kernels
    kept = []

    def apply(x_ext):
        if not kept or kept[0] is not x_ext:
            kept[:] = [x_ext, [_apart(t, halo) for t in (
                x_ext[halo:-halo], x_ext[:halo], x_ext[-halo:])]]
        return kernels.banded_remote_halo_spmm(blocks, *kept[1], bandwidth=bw,
                                               out_dtype=out_dtype)
    return apply


def _ring_ext(x, lo: int, hi: int, halo: int):
    """Rows [lo - halo, hi + halo) of x, wrapped around the ring: the
    halo-extended input that the exchange gives the slab [lo, hi)."""
    import torch
    idx = torch.arange(lo - halo, hi + halo, device=x.device) % x.shape[0]
    return x[idx]


def four_slab_check(A, q, randn) -> dict:
    """Four shards on one card: cut A's and q's tables into SLABS row slabs
    and hold the rows put together against kernels 1 and 4 on the whole
    matrix. Kernels 6 and 8 compute kernel 1's products in kernel 1's
    order, whatever the source of the x rows (kernel 6 on each slab's
    ring-wrapped x_ext, by the route the width takes; kernel 8 on each
    slab's rows in a buffer of its own, its halos pointing into the ring
    neighbours' buffers, no x_ext): the same bits in f64, f32 and bf16
    storage (at the ring's ends the wrapped rows meet zero blocks). Kernel
    7 is kernel 4's apply with the out-of-range slots' +0 added: the same
    Y. Returns name -> worst error."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    worst = {}

    def hold(key, parts, whole, label):
        err = float(torch.max(torch.abs(torch.cat(parts) - whole)))
        print(f"  {SLABS} slabs of {key} vs the whole matrix, {label}: "
              f"max_abs_err={err:.3e}", flush=True)
        _check(err == 0.0, f"{key} {label}: {SLABS} slabs differ from the "
               f"whole matrix by {err:.3e}")
        worst[key] = max(worst.get(key, 0.0), err)

    bs, bw = A.block_size, A.bandwidth
    nl, halo = A.n_block_rows // SLABS, A.bandwidth * A.block_size
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        blocks = A.blocks.to(dtype)
        acc = kernels.acc_dtype(dtype)
        for m in (20, 40):
            x = randn(A.shape[0], m, dtype)
            whole = kernels.banded_bsr_spmm(blocks, x, bw, out_dtype=acc)
            route = kernels.ext_spmm_route(dtype, bs, m)
            hold("banded_ext_bsr_spmm", [kernels.banded_ext_bsr_spmm(
                blocks[s * nl:(s + 1) * nl],
                _ring_ext(x, s * nl * bs, (s + 1) * nl * bs, halo),
                bandwidth=bw, out_dtype=acc) for s in range(SLABS)], whole,
                f"{_dname(dtype)} m={m} ({route} route)")
            rows = [_apart(t, halo) for t in x.split(nl * bs)]
            hold("banded_remote_halo_spmm", [kernels.banded_remote_halo_spmm(
                blocks[s * nl:(s + 1) * nl], rows[s], rows[s - 1][-halo:],
                rows[(s + 1) % SLABS][:halo], bandwidth=bw, out_dtype=acc)
                for s in range(SLABS)], whole, f"{_dname(dtype)} m={m}")
            del x, whole, rows
        del blocks
        torch.cuda.empty_cache()
    tables = (q.qblocks, q.scale_rows, q.diag)
    bs, bw = q.block_size, q.bandwidth
    nl, halo = q.n_block_rows // SLABS, q.bandwidth * q.block_size
    for m in (20, 40):
        x = randn(q.shape[0], m)
        hold("banded_q_ext_bsr_spmm", [kernels.banded_q_ext_bsr_spmm(
            *(t[s * nl:(s + 1) * nl] for t in tables),
            _ring_ext(x, s * nl * bs, (s + 1) * nl * bs, halo), bandwidth=bw)
            for s in range(SLABS)], kernels.banded_q_bsr_spmm(*tables, x, bw),
            f"int8 f32 m={m}")
        del x
    torch.cuda.empty_cache()
    return worst


def _true_residual(op_blocks, bw, cols, X, lam, b_diag=None):
    """max_j ||A x_j - lam_j B x_j|| with the plain SpMM."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    AX = (kernels.banded_bsr_spmm_plain(op_blocks, X, bw) if bw is not None
          else kernels.bsr_spmm_plain(cols, op_blocks, X))
    BX = X if b_diag is None else b_diag[:, None] * X
    return float(torch.max(torch.linalg.vector_norm(AX - BX * lam[None, :],
                                                    dim=0)))


# Host events that stall a solve: the caching allocator's device
# allocations and frees (cudaMalloc / cudaFree, which synchronise), its
# retries after a failed allocation (which free every cached block), and
# Python's garbage collections (their time, from ``gc.callbacks``).
_GC = {"start": 0.0, "ms": 0.0, "runs": 0}


def _gc_timer(phase, info) -> None:
    if phase == "start":
        _GC["start"] = time.perf_counter()
    else:
        _GC["ms"] += (time.perf_counter() - _GC["start"]) * 1e3
        _GC["runs"] += 1


def _host_events() -> tuple:
    import torch
    s = torch.cuda.memory_stats()
    return (s.get("segment.all.allocated", 0), s.get("segment.all.freed", 0),
            s.get("num_alloc_retries", 0), _GC["runs"], _GC["ms"])


def _solve(label, A, k, B=None, solver=None, **kw):
    """One solve (``fdtt.eigensolve``, or ``solver`` with its signature)
    timed on the host clock, synchronised on both ends; prints the host
    events (``_host_events``) that fell inside it."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    solver = fdtt.eigensolve if solver is None else solver
    torch.cuda.synchronize()
    before = _host_events()
    t0 = time.perf_counter()
    res = solver(A, k, second_matrix=B, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mallocs, frees, retries, gcs, gc_ms = (
        b - a for a, b in zip(before, _host_events()))
    dims = res.subspace_dims[:res.iterations].tolist()
    print(f"  {label}: converged={res.converged} iterations={res.iterations} "
          f"wall={wall * 1e3:.1f} ms dims={dims} "
          f"max_loop_residual={float(res.residual_norms.max()):.3e}; "
          f"cudaMalloc {mallocs}, cudaFree {frees}, alloc retries {retries}, "
          f"gc {gcs} ({gc_ms:.1f} ms)", flush=True)
    _check(bool(torch.all(torch.isfinite(res.eigenvalues)))
           and tuple(res.eigenvectors.shape) == (A.shape[0], k),
           f"{label}: bad output")
    return res, wall


def _solve_converged(label, A, k, B=None, solver=None, **kw):
    res, wall = _solve(label, A, k, B=B, solver=solver, **kw)
    _check(res.converged, f"{label}: did not converge")
    return res, wall


def phase_main(A, dev, solves, refs):
    """Phase 4: the default solve at k=3 and k=20, kernel vs plain path;
    ``refs[k]`` keeps each kernel-path result and its warm wall."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    plain_A = fdtt.MatrixFreeOperator(
        lambda X: kernels.banded_bsr_spmm_plain(A.blocks, X.contiguous(), 1),
        A.shape[0], dtype=A.dtype, diag=A.diagonal(), device=dev)
    for k in (3, 20):
        # The first solve of each path pays one-time costs (allocator
        # growth, solver handles) and is left out of the walls; then
        # WARM_SOLVES of each in turns (kernel, plain, plain, kernel, ...),
        # so that order does not decide the comparison. A path's wall is
        # the median of its warm solves.
        walls = {"kernels": [], "plain": []}
        order = (("kernels", "plain")
                 + ("kernels", "plain", "plain", "kernels")
                 * (WARM_SOLVES // 2))
        for i, path in enumerate(order):
            before = kernels.banded_bsr_spmm.launches
            torch.cuda.reset_peak_memory_stats()
            res, wall = _solve_converged(f"eigensolve(A, {k}) [{path}]",
                                         A if path == "kernels" else plain_A,
                                         k)
            if i >= 2:
                walls[path].append(wall)
            launches = kernels.banded_bsr_spmm.launches - before
            if path == "plain":
                _check(launches == 0, "the plain path launched a kernel")
                ref = res
                continue
            _check(launches > 0, f"k={k}: the banded kernel never launched")
            peak = torch.cuda.max_memory_allocated() / 1e9
            true_res = _true_residual(A.blocks, 1, None, res.eigenvectors,
                                      res.eigenvalues)
            _check(true_res <= SOLVE_TOL,
                   f"k={k}: true residual {true_res:.3e}")
            out = res
        dev_eval = float(torch.max(torch.abs(out.eigenvalues
                                             - ref.eigenvalues)))
        med = {p: statistics.median(w) * 1e3 for p, w in walls.items()}
        print(f"  k={k}: kernel launches per solve={launches} true_residual="
              f"{true_res:.3e} |eig - eig_plain|={dev_eval:.3e} "
              f"peak_mem={peak:.2f} GB; warm wall, median of "
              f"{WARM_SOLVES}: {med['kernels']:.1f} ms (min "
              f"{min(walls['kernels']) * 1e3:.1f}; SIMT-tile kernel 1: "
              f"{TILE_K1_WALLS_MS[k]} ms), plain path "
              f"{med['plain']:.1f} ms (min "
              f"{min(walls['plain']) * 1e3:.1f})", flush=True)
        _check(out.iterations == ref.iterations,
               f"k={k}: {out.iterations} iterations vs {ref.iterations} plain")
        _check(dev_eval <= 1e-9, f"k={k}: eigenvalues differ by {dev_eval:.3e}")
        busy = _device_busy(f"eigensolve(A, {k}) [kernels]",
                            lambda: fdtt.eigensolve(A, k))
        refs[k] = dict(iterations=out.iterations,
                       eigenvalues=out.eigenvalues.clone(),
                       wall=med["kernels"] / 1e3)
        solves.append(dict(solve=f"banded f64 lowest-{k}", n=A.shape[0],
                           iterations=out.iterations, wall_s=walls["kernels"],
                           plain_wall_s=walls["plain"],
                           true_residual=true_res, launches=launches,
                           peak_mem_gb=peak, **busy))
        del res, ref, out
        torch.cuda.empty_cache()


def _device_busy(label, run, shapes: bool = False) -> dict:
    """``run()`` once under ``torch.profiler``: its host wall (profiled),
    the device's busy time (the union of its kernels' and copies'
    intervals), the idle share of the wall, and the device ops that took
    the most time. With ``shapes``, the input shapes are recorded, and the
    result also holds ``by_name_ms`` (device time by kernel name) and
    ``prof``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_read = time.perf_counter()
    # The raw events: building the profiler's FunctionEvent list
    # (``prof.events()``) takes minutes at the 10M-row phases' ~480k
    # device ops.
    events = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA
                    and not e.is_user_annotation())
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, f, name in events:
        busy_us += max(0.0, f - max(s, end))
        end = max(end, f)
        by_name[name] = by_name.get(name, 0.0) + (f - s)
    busy_ms = busy_us / 1e3
    idle = 1.0 - busy_ms / wall_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  profiled {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms over {len(events)} device ops, idle share "
          f"{idle:.1%}; most device time: "
          + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms" for n, t in top)
          + f" (the trace read in {time.perf_counter() - t_read:.1f} s)",
          flush=True)
    out = dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=idle, device_ops=len(events))
    if shapes:
        out.update(by_name_ms={k: v / 1e3 for k, v in by_name.items()},
                   prof=prof)
    return out


def _cast_ms(prof, inside: str, min_cols: int) -> float:
    """Device time (ms) of the ``aten::_to_copy`` ops run inside a
    ``record_function(inside)`` range whose input is 2-D and wider than
    ``min_cols`` columns."""
    total = 0.0
    for e in prof.events():
        dims = e.input_shapes[0] if e.input_shapes else []
        if e.name != "aten::_to_copy" or len(dims) != 2 or dims[1] <= min_cols:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != inside:
            parent = parent.cpu_parent
        if parent is not None:
            total += (e.device_time_total if hasattr(e, "device_time_total")
                      else e.cuda_time_total)
    return total / 1e3


def phase_legs(A, dev, solves, refs):
    """Phase 5: collapse, generalized and general-kernel legs (the general
    kernel also on the block-permuted matrix, held to phase 4's lowest-3
    in ``refs``), and a small solve against a dense reference."""
    import numpy as np
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    n = A.shape[0]
    strong = fdtt.generate_banded_bsr(A.n_block_rows, A.block_size,
                                      bandwidth=1, coupling=0.1, seed=0,
                                      device=dev)
    res, wall = _solve_converged("coupling 0.1, k=3, max_dim_sub=12", strong,
                                 3, max_dim_sub=12)
    dims = res.subspace_dims[:res.iterations].tolist()
    _check(any(b < a for a, b in zip(dims, dims[1:])),
           f"expected a collapse, dims={dims}")
    tr = _true_residual(strong.blocks, 1, None, res.eigenvectors,
                        res.eigenvalues)
    _check(tr <= SOLVE_TOL, f"collapse leg: true residual {tr:.3e}")
    solves.append(dict(solve="banded f64 coupling 0.1 lowest-3 max_dim 12",
                       n=n, iterations=res.iterations, wall_s=wall,
                       true_residual=tr))
    del strong, res
    torch.cuda.empty_cache()

    b_diag = torch.from_numpy(
        1.0 + 0.5 * np.random.default_rng(7).random(n)).to(dev)
    res, wall = _solve_converged("pencil A x = lam B x, B diagonal, k=3", A,
                                 3, B=fdtt.DiagonalOperator(b_diag))
    tr = _true_residual(A.blocks, 1, None, res.eigenvectors, res.eigenvalues,
                        b_diag)
    _check(tr <= SOLVE_TOL, f"pencil leg: true residual {tr:.3e}")
    solves.append(dict(solve="banded f64 pencil (diagonal B) lowest-3", n=n,
                       iterations=res.iterations, wall_s=wall,
                       true_residual=tr))
    del res

    general = fdtt.BSROperator(A.block_cols, A.blocks)  # no bandwidth
    before = kernels.bsr_spmm.launches
    res, wall = _solve_converged("BSR without bandwidth (general kernel), k=3",
                                 general, 3)
    _check(kernels.bsr_spmm.launches > before, "bsr_spmm never launched")
    tr = _true_residual(A.blocks, None, A.block_cols, res.eigenvectors,
                        res.eigenvalues)
    _check(tr <= SOLVE_TOL, f"general leg: true residual {tr:.3e}")
    solves.append(dict(solve="general BSR f64 lowest-3", n=n,
                       iterations=res.iterations, wall_s=wall,
                       true_residual=tr,
                       launches=kernels.bsr_spmm.launches - before))
    del res, general

    # P A Pᵀ has A's spectrum: phase 4's lowest-3 in phase 4's iterations,
    # through the general kernel on a table whose columns have no band.
    _, cols, blocks = _permuted(A, PERM_SEED)
    permuted = fdtt.BSROperator(cols, blocks)
    ref = refs[3]
    walls = []
    for i in range(1 + WARM_SOLVES):
        before = kernels.bsr_spmm.launches
        res, wall = _solve_converged(
            f"P A Pᵀ (block-permuted, general kernel), k=3 "
            f"[{'warm' if i else 'cold'}]", permuted, 3)
        launches = kernels.bsr_spmm.launches - before
        _check(launches > 0, "bsr_spmm never launched on P A Pᵀ")
        if i:
            walls.append(wall)
    tr = _true_residual(blocks, None, cols, res.eigenvectors,
                        res.eigenvalues)
    diff = float(torch.max(torch.abs(res.eigenvalues - ref["eigenvalues"])))
    warm = statistics.median(walls)
    print(f"  P A Pᵀ lowest-3: iterations {res.iterations} (phase 4: "
          f"{ref['iterations']}), |eig - eig_phase4| = {diff:.3e}, true "
          f"residual {tr:.3e}, launches per solve {launches}; warm wall, "
          f"median of {WARM_SOLVES}: {warm * 1e3:.1f} ms (min "
          f"{min(walls) * 1e3:.1f}; phase 4 through kernel 1: "
          f"{ref['wall'] * 1e3:.1f} ms)", flush=True)
    _check(res.iterations == ref["iterations"],
           f"P A Pᵀ: {res.iterations} iterations vs {ref['iterations']}")
    _check(diff <= 1e-9, f"P A Pᵀ: eigenvalues differ by {diff:.3e}")
    _check(tr <= SOLVE_TOL, f"P A Pᵀ leg: true residual {tr:.3e}")
    solves.append(dict(solve="block-permuted general BSR f64 lowest-3", n=n,
                       iterations=res.iterations, wall_s=walls,
                       phase4_wall_s=ref["wall"], true_residual=tr,
                       eig_diff_phase4=diff, launches=launches))
    del res, permuted, cols, blocks
    torch.cuda.empty_cache()

    small = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1,
                                     seed=0, device=dev)
    res, _ = _solve_converged("small banded (n=1024), k=3, vs dense eigvalsh",
                              small, 3)
    want = torch.linalg.eigvalsh(small.to_dense().cpu())[:3]
    diff = float(torch.max(torch.abs(res.eigenvalues.cpu() - want)))
    print(f"  small solve vs dense eigvalsh: {diff:.3e}", flush=True)
    _check(diff <= 1e-8, f"small solve: eigenvalues off by {diff:.3e}")


# The int8 loose stage of bench.py:660-666.
LOOSE = dict(method="DPR", tolerance=1e-3, relative_tolerance=True,
             dtype="float32", expansion="lowest-k", max_iterations=30)


# Block rows of the int8 oracle's chunks: 1.6 GB of float64 blocks each
# (all 78,125 at 10M rows would take 30.7 GB).
ORACLE_ROWS = 4096


def _int8_true_residual(q, X, lam) -> float:
    """max_j ||A x_j - lam_j x_j|| / max(|lam_j|, 1) in float64, with the
    dequantized blocks and the exact diagonal; ``ORACLE_ROWS`` block rows
    at a time, each with its x window (``bw`` halo block rows on each
    side, as ``kernels.banded_bsr_spmm_plain`` pads them)."""
    import torch
    X = X.double()
    lam = lam.double()
    nbr, bs, kbs = q.qblocks.shape
    K, bw, m = kbs // bs, q.bandwidth, X.shape[1]
    xp = torch.nn.functional.pad(X.reshape(nbr, bs, m), (0, 0, 0, 0, bw, bw))
    sq = torch.zeros(m, dtype=torch.float64, device=X.device)
    for r0 in range(0, nbr, ORACLE_ROWS):
        r1 = min(r0 + ORACLE_ROWS, nbr)
        deq = (q.qblocks[r0:r1].float()
               * q.scale_rows[r0:r1, None, :]).double()
        window = torch.cat([xp[r0 + k:r1 + k] for k in range(K)], dim=1)
        xr = xp[r0 + bw:r1 + bw]
        R = (torch.bmm(deq, window) + q.diag[r0:r1, :, None].double() * xr
             - xr * lam)
        del deq, window
        sq += torch.sum(R * R, dim=(0, 1))
    res = torch.sqrt(sq)
    return float(torch.max(res / torch.clamp(torch.abs(lam), min=1.0)))


def phase_int8(q, dev, solves, refs):
    """Phase 6: the int8 loose stage at the JAX package's single-chip
    north-star shape, kernel path against the plain path; ``refs["int8"]``
    keeps the kernel-path result and its warm wall."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    plain_q = fdtt.MatrixFreeOperator(
        lambda X: kernels.banded_q_bsr_spmm_plain(
            q.qblocks, q.scale_rows, q.diag, X.contiguous(), q.bandwidth),
        q.shape[0], dtype=torch.float32, diag=q.diagonal(), device=dev)
    walls = {"kernels": [], "plain": []}
    for path in ("kernels", "plain", "kernels"):
        before = kernels.banded_q_bsr_spmm.launches
        torch.cuda.reset_peak_memory_stats()
        res, wall = _solve_converged(
            f"int8 n={q.shape[0]} lowest-20 loose [{path}]",
            q if path == "kernels" else plain_q, 20, **LOOSE)
        walls[path].append(wall)
        launches = kernels.banded_q_bsr_spmm.launches - before
        if path == "plain":
            _check(launches == 0, "the plain int8 path launched a kernel")
            ref = res
        else:
            _check(launches > 0, "banded_q_bsr_spmm never launched")
            peak = torch.cuda.max_memory_allocated() / 1e9
            out = res
    true_res = _int8_true_residual(q, out.eigenvectors, out.eigenvalues)
    rel = float(torch.max(torch.abs(out.eigenvalues - ref.eigenvalues)
                          / torch.abs(ref.eigenvalues)))
    print(f"  int8: launches per solve={launches} true relative residual="
          f"{true_res:.3e} max |eig - eig_plain| / |eig_plain|={rel:.3e} "
          f"iterations {out.iterations} vs plain {ref.iterations}; warm "
          f"wall {walls['kernels'][-1]:.4f} s (plain path "
          f"{walls['plain'][-1]:.4f} s, first kernel-path solve "
          f"{walls['kernels'][0]:.4f} s) peak_mem={peak:.2f} GB",
          flush=True)
    _check(true_res <= 1e-3, f"int8: true relative residual {true_res:.3e}")
    _check(out.iterations == ref.iterations,
           f"int8: {out.iterations} iterations vs {ref.iterations} plain")
    _check(rel <= 1e-4, f"int8: eigenvalues differ by {rel:.3e} relative")
    refs["int8"] = dict(iterations=out.iterations,
                        eigenvalues=out.eigenvalues.clone(),
                        eigenvectors=out.eigenvectors.clone(),
                        wall=walls["kernels"][-1])
    solves.append(dict(solve="int8 banded f32 lowest-20 loose (1e-3 rel)",
                       n=q.shape[0], iterations=out.iterations,
                       wall_s=walls["kernels"], plain_wall_s=walls["plain"],
                       true_residual_rel=true_res, launches=launches,
                       peak_mem_gb=peak))
    del res, ref, out
    torch.cuda.empty_cache()
    int8_float64_solve(q, dev, solves, refs)


# The float64 leg of phase 6: the default float64 type on int8 storage,
# at 1e-6 (the apply's sums round to float32, as the reference's do, so
# 1e-8 is out of reach).
F64_INT8 = dict(tolerance=1e-6, relative_tolerance=True)


def int8_float64_solve(q, dev, solves, refs):
    """Phase 6, float64 leg: lowest-20 on the int8 matrix in float64
    through kernel 4's float64-x entry (a cold solve, then a warm one after
    the plain path's), against the same solve through the plain version:
    the same iterations, eigenvalues within the tolerance, a true relative
    residual (as the float32 leg takes it) within it. ``refs["int8_f64"]``
    keeps the kernel-path result and its warm wall for phase 8a."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels
    plain_q = fdtt.MatrixFreeOperator(
        lambda X: kernels.banded_q_bsr_spmm_plain(
            q.qblocks, q.scale_rows, q.diag, X.contiguous(), q.bandwidth),
        q.shape[0], dtype=torch.float64, diag=q.diagonal().double(),
        device=dev)
    runs, walls = {}, {"kernels": [], "plain": []}
    # The int8 kernels' launches a solve on the kernel path (PERF.md rows
    # 4d, 5d, 7d): kernel 4's float64-x entry; kernels 5 and 7 are not on
    # this path.
    int8_kernels = (kernels.banded_q_bsr_spmm, kernels.banded_q_bsr_spmm_gram,
                    kernels.banded_q_ext_bsr_spmm)
    for path in ("kernels", "plain", "kernels"):
        before = [fn.launches for fn in int8_kernels]
        f64_before = kernels.banded_q_bsr_spmm.f64_launches
        res, wall = _solve_converged(
            f"int8 n={q.shape[0]} lowest-20 float64 [{path}]",
            q if path == "kernels" else plain_q, 20, **F64_INT8)
        counts = {fn.__name__: fn.launches - b
                  for fn, b in zip(int8_kernels, before)}
        counts.pop("banded_q_bsr_spmm")
        walls[path].append(wall)
        runs[path] = (res, kernels.banded_q_bsr_spmm.f64_launches - f64_before,
                      counts)
    (out, launches, others), (ref, plain_launches, _) = (
        runs["kernels"], runs["plain"])
    wall = walls["kernels"][-1]
    _check(launches > 0 and plain_launches == 0,
           f"float64 int8: launches {launches} (plain {plain_launches})")
    _check(out.eigenvalues.dtype == torch.float64, "float64 int8: "
           f"eigenvalues are {out.eigenvalues.dtype}")
    true_res = _int8_true_residual(q, out.eigenvectors, out.eigenvalues)
    diff = float(torch.max(torch.abs(out.eigenvalues - ref.eigenvalues)
                           / torch.clamp(torch.abs(ref.eigenvalues), min=1)))
    print(f"  int8 float64: launches {launches} iterations {out.iterations} "
          f"vs plain {ref.iterations}; true relative residual "
          f"{true_res:.3e}; max |eig - eig_plain| / max(|eig|, 1) = "
          f"{diff:.3e}; warm wall {wall:.4f} s (first solve "
          f"{walls['kernels'][0]:.4f} s, plain path "
          f"{walls['plain'][0]:.4f} s)", flush=True)
    _check(out.iterations == ref.iterations, f"float64 int8: "
           f"{out.iterations} iterations vs {ref.iterations} plain")
    _check(true_res <= F64_INT8["tolerance"],
           f"float64 int8: true relative residual {true_res:.3e}")
    _check(diff <= F64_INT8["tolerance"],
           f"float64 int8: eigenvalues differ by {diff:.3e}")
    solves.append(dict(solve="int8 banded float64 lowest-20 (1e-6 rel)",
                       n=q.shape[0], iterations=out.iterations,
                       wall_s=walls["kernels"], plain_wall_s=walls["plain"],
                       true_residual_rel=true_res, launches=launches,
                       other_int8_launches=others, eig_diff_plain=diff))
    refs["int8_f64"] = dict(iterations=out.iterations,
                            eigenvalues=out.eigenvalues.clone(), wall=wall)
    del runs, out, ref
    torch.cuda.empty_cache()


# Phase 4b: GJD on phase 4's matrix. (lowest, options): default GJD
# options at lowest-3, the DPR-scaled inner solve at lowest-20.
GJD_CASES = ((3, dict(method="GJD")),
             (20, dict(method="GJD", gjd_preconditioner="dpr")))
# Warm GJD solves of each path, in turns (kernel, plain, plain, kernel).
WARM_GJD = 2


def phase_gjd(A, dev, solves, refs):
    """Phase 4b: GJD through kernel 1 on phase 4's matrix, every outer and
    inner (MINRES) apply a launch of kernel 1, against the same solve
    through the plain version: the same outer iterations, inner totals
    within one step per corrected column per outer iteration, eigenvalues
    within 1e-9 of phase 4's DPR solve, a true residual <= 1e-8."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.core.krylov import minres_block
    from fortran_davidson_tpu_torch.ops import kernels

    plain_A = fdtt.MatrixFreeOperator(
        lambda X: kernels.banded_bsr_spmm_plain(A.blocks, X.contiguous(), 1),
        A.shape[0], dtype=A.dtype, diag=A.diagonal(), device=dev)
    for k, opts in GJD_CASES:
        walls = {"kernels": [], "plain": []}
        runs = {}
        order = (("kernels", "plain")
                 + ("kernels", "plain", "plain", "kernels") * (WARM_GJD // 2))
        for i, path in enumerate(order):
            before = kernels.banded_bsr_spmm.launches
            polls = minres_block.polls
            torch.cuda.reset_peak_memory_stats()
            res, wall = _solve_converged(
                f"eigensolve(A, {k}, {opts}) [{path}]",
                A if path == "kernels" else plain_A, k, **opts)
            walls[path].append(wall)
            launches = kernels.banded_bsr_spmm.launches - before
            runs[path] = (res, launches, minres_block.polls - polls,
                          torch.cuda.max_memory_allocated() / 1e9)
            _check((launches > 0) == (path == "kernels"),
                   f"GJD k={k} [{path}]: {launches} kernel 1 launches")
        (out, launches, polls, peak), (ref, _, plain_polls, _) = (
            runs["kernels"], runs["plain"])
        true_res = _true_residual(A.blocks, 1, None, out.eigenvectors,
                                  out.eigenvalues)
        eig_diff = float(torch.max(torch.abs(out.eigenvalues
                                             - refs[k]["eigenvalues"])))
        # One MINRES step per corrected column per outer iteration: the
        # doubling schedule corrects every column of the basis.
        corrected = int(out.subspace_dims[:out.iterations].sum())
        inner_diff = abs(out.inner_iterations - ref.inner_iterations)
        cold = walls["kernels"].pop(0)
        walls["plain"].pop(0)
        med = {p: statistics.median(w) for p, w in walls.items()}
        print(f"  GJD k={k} {opts}: iterations {out.iterations} (plain "
              f"{ref.iterations}; phase 4 DPR {refs[k]['iterations']}), "
              f"inner_iterations {out.inner_iterations} (plain "
              f"{ref.inner_iterations}), kernel 1 launches a solve "
              f"{launches}; host reads a solve: {out.iterations} outer + "
              f"{polls} MINRES polls (plain {plain_polls}); true residual "
              f"{true_res:.3e}; |eig - eig_phase4| {eig_diff:.3e}; cold "
              f"wall {cold:.4f} s, warm median of {len(walls['kernels'])} "
              f"{med['kernels']:.4f} s (plain {med['plain']:.4f} s; phase "
              f"4 DPR {refs[k]['wall']:.4f} s); peak_mem={peak:.2f} GB",
              flush=True)
        _check(out.iterations == ref.iterations,
               f"GJD k={k}: {out.iterations} iterations vs {ref.iterations}"
               " plain")
        _check(inner_diff <= corrected, f"GJD k={k}: inner iterations "
               f"{out.inner_iterations} vs {ref.inner_iterations} plain")
        _check(true_res <= SOLVE_TOL, f"GJD k={k}: true residual "
               f"{true_res:.3e}")
        _check(eig_diff <= 1e-9, f"GJD k={k}: eigenvalues {eig_diff:.3e} "
               "from phase 4's")
        busy = _device_busy(f"eigensolve(A, {k}, {opts}) [kernels]",
                            lambda: fdtt.eigensolve(A, k, **opts))
        solves.append(dict(
            solve=f"banded f64 lowest-{k} GJD {opts}", n=A.shape[0],
            iterations=out.iterations, inner_iterations=out.inner_iterations,
            plain_inner_iterations=ref.inner_iterations,
            launches=launches, minres_polls=polls, cold_wall_s=cold,
            wall_s=walls["kernels"], plain_wall_s=walls["plain"],
            true_residual=true_res, eig_diff_phase4=eig_diff,
            peak_mem_gb=peak, **busy))
        del runs, out, ref, res
        torch.cuda.empty_cache()


# Phase 6b: the refined stage of the JAX package's sparse north star
# (bench.py:663-668), from phase 6's loose eigenvectors.
REFINED = dict(method="DPR", tolerance=1e-8, relative_tolerance=True,
               dtype="float32", expansion="lowest-k", refined=True,
               final_polish=3, max_iterations=120)
# The JAX package's TPU run of the same stage (BENCH_r05.json's tail):
# iterations only; its times say nothing of the card.
TPU_REFINED_ITERATIONS = 8


def _plain_quantized(q):
    """``q`` whose ``matmat`` (and its ``offdiag()``'s) takes kernel 4's
    plain version; ``matmat_ds`` is the same plain PyTorch either way."""
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    class PlainQuantized(fdtt.QuantizedBandedOperator):
        def matmat(self, block):
            return kernels.banded_q_bsr_spmm_plain(
                self.qblocks, self.scale_rows, self.diag,
                block.contiguous(), self.bandwidth, out_dtype=block.dtype)

        def offdiag(self):
            return PlainQuantized(self.qblocks, self.scale_rows,
                                  self.diag * 0, self.bandwidth)

    return PlainQuantized(q.qblocks, q.scale_rows, q.diag, q.bandwidth)


def _int8_oracle_residual(q, X, lam) -> float:
    """The north-star contract's check (tests/test_ds_apply_sparse.py):
    max_j ||A x_j - lam_j x_j|| / max(|lam_j|, 1) in float64 on the
    normalized columns, with the dequantized blocks and the diagonal;
    ``lam`` the float64 eigenvalues (hi + lo words)."""
    import torch
    X = X.double()
    X = X / torch.linalg.vector_norm(X, dim=0)
    return _int8_true_residual(q, X, lam.double())


def phase_refined(q, dev, solves, refs):
    """Phase 6b: the refined stage (``REFINED``) on the 2M-row int8
    matrix from phase 6's loose eigenvectors: every ``matmat`` through
    kernel 4, the polish's applies through ``matmat_ds``; against the
    same stage through the plain versions (iterations within ±2, kernel
    4's float32 sums differ from the plain version's by design;
    eigenvalues within the sum of the two oracle residuals)."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    X0 = refs["int8"]["eigenvectors"]
    plain_q = _plain_quantized(q)
    walls, runs = {"kernels": [], "plain": []}, {}
    for path in ("kernels", "plain", "kernels"):
        before = kernels.banded_q_bsr_spmm.launches
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        res, wall = _solve_converged(
            f"int8 n={q.shape[0]} lowest-20 refined [{path}]",
            q if path == "kernels" else plain_q, 20, initial_vectors=X0,
            **REFINED)
        walls[path].append(wall)
        launches = kernels.banded_q_bsr_spmm.launches - before
        _check((launches > 0) == (path == "kernels"),
               f"refined [{path}]: {launches} kernel 4 launches")
        lam = res.eigenvalues.double() + res.eigenvalues_lo.double()
        peak_abs = torch.cuda.max_memory_allocated()
        runs[path] = (res, lam, launches,
                      ((peak_abs - mem0) / 1e9, peak_abs / 1e9))
    (out, lam, launches, (peak, peak_abs)), (ref, lam_ref, _, _) = (
        runs["kernels"], runs["plain"])
    true_res = _int8_oracle_residual(q, out.eigenvectors, lam)
    ref_res = _int8_oracle_residual(q, ref.eigenvectors, lam_ref)
    diff = float(torch.max(torch.abs(lam - lam_ref)
                           / torch.clamp(torch.abs(lam_ref), min=1.0)))
    loose = refs["int8"]["wall"]
    print(f"  refined: iterations {out.iterations} (plain {ref.iterations};"
          f" the JAX package on a TPU: {TPU_REFINED_ITERATIONS}, iterations "
          f"only), stalled={out.stalled}, kernel 4 launches {launches}; "
          f"oracle relative residual {true_res:.3e} (plain {ref_res:.3e}); "
          f"max |eig - eig_plain| / max(|eig|, 1) {diff:.3e}; cold wall "
          f"{walls['kernels'][0]:.4f} s, warm {walls['kernels'][1]:.4f} s "
          f"(plain {walls['plain'][0]:.4f} s); loose + refined (warm) "
          f"{loose + walls['kernels'][1]:.4f} s; max_memory_allocated "
          f"{peak_abs:.2f} GB, {peak:.2f} GB above the operator and the "
          "start", flush=True)
    _check(true_res <= REFINED["tolerance"],
           f"refined: oracle relative residual {true_res:.3e}")
    _check(abs(out.iterations - ref.iterations) <= 2, f"refined: "
           f"{out.iterations} iterations vs {ref.iterations} plain")
    _check(diff <= true_res + ref_res, f"refined: eigenvalues differ by "
           f"{diff:.3e} (residuals {true_res:.3e} + {ref_res:.3e})")
    busy = _device_busy("int8 lowest-20 refined [kernels]",
                        lambda: fdtt.eigensolve(q, 20, initial_vectors=X0,
                                                **REFINED))
    # Phase 14b holds the sharded refined stage to this one.
    refs["refined"] = dict(iterations=out.iterations, eigenvalues=lam.clone(),
                           wall=walls["kernels"][1])
    solves.append(dict(
        solve="int8 banded f32 lowest-20 refined + final_polish=3 (1e-8 "
        "rel)", n=q.shape[0], iterations=out.iterations,
        plain_iterations=ref.iterations, stalled=out.stalled,
        tpu_iterations=TPU_REFINED_ITERATIONS, wall_s=walls["kernels"],
        plain_wall_s=walls["plain"], loose_plus_refined_s=(
            loose + walls["kernels"][1]),
        oracle_residual_rel=true_res, plain_oracle_residual_rel=ref_res,
        launches=launches, peak_mem_gb=peak_abs, peak_mem_above_gb=peak,
        **busy))
    del runs, out, ref, res
    torch.cuda.empty_cache()


def phase_noise_gate(dev, solves):
    """Phase 6c: the JAX package's ``slow`` tests of the refined path at
    scale (tests/test_noise_gate.py), matrix-free, no kernel: on
    ``surrogate_hamiltonian(1_000_448, float32)``, absolute 1e-8 with
    final_polish=3 (converged, max residual < 1e-8, eigenvalues 1-4 within
    1e-6), and the stall exit at relative 1e-7 within 40 iterations."""
    import torch
    from fortran_davidson_tpu_torch.models import generators

    op = generators.surrogate_hamiltonian(1_000_448, dtype=torch.float32,
                                          device=dev)
    common = dict(method="DPR", dtype="float32", expansion="lowest-k",
                  refined=True)
    res, wall = _solve_converged(
        "surrogate n=1,000,448 lowest-4 refined + final_polish=3 (1e-8 abs)",
        op, 4, tolerance=1e-8, max_iterations=40, final_polish=3, **common)
    worst = float(res.residual_norms.max())
    eig_err = float(torch.max(torch.abs(
        res.eigenvalues.double()
        - torch.arange(1, 5, dtype=torch.float64, device=dev))))
    _check(worst < 1e-8, f"noise gate: residual {worst:.3e}")
    _check(eig_err <= 1e-6, f"noise gate: eigenvalues {eig_err:.3e} from 1-4")
    stall, stall_wall = _solve(
        "surrogate n=1,000,448 lowest-4 refined (1e-7 rel), the stall exit",
        op, 4, tolerance=1e-7, relative_tolerance=True, max_iterations=60,
        **common)
    print(f"  noise gate: converged at 1e-8 in {res.iterations} iterations "
          f"(stalled={res.stalled}), max residual {worst:.3e}, |eig - "
          f"(1..4)| {eig_err:.3e}, wall {wall:.3f} s; relative 1e-7: "
          f"{stall.iterations} iterations, converged={stall.converged}, "
          f"stalled={stall.stalled}, wall {stall_wall:.3f} s", flush=True)
    _check(stall.iterations < 40, f"stall exit: {stall.iterations} "
           "iterations")
    solves.append(dict(solve="surrogate f32 lowest-4 refined 1e-8 abs",
                       n=op.shape[0], iterations=res.iterations,
                       stalled=res.stalled, wall_s=wall,
                       max_residual=worst))
    solves.append(dict(solve="surrogate f32 lowest-4 refined 1e-7 rel",
                       n=op.shape[0], iterations=stall.iterations,
                       converged=stall.converged, stalled=stall.stalled,
                       wall_s=stall_wall))
    del op, res, stall
    torch.cuda.empty_cache()


# Phase 3's DS line: the pairs of the transforms (magnitudes from 2**-100
# to 2**100 for two_sum, 2**-40 to 2**25 for two_prod, whose partial
# products must stay normal), and the block rows of the matmat_ds oracle.
DS_PAIRS = 1_000_000
DS_ORACLE_ROWS = slice(8000, 8064)


def _ds_pairs(n, lo_exp, hi_exp, gen):
    """float32 pairs with |a| = m 2**e (m in [1, 2)), b within 2**±20 of
    a: their exact sum and product are float64 values."""
    import torch

    def draw(e):
        sign = torch.randint(0, 2, (n,), generator=gen).double() * 2 - 1
        return (sign * (1 + torch.rand(n, generator=gen, dtype=torch.float64))
                * torch.exp2(e)).float()

    e = torch.randint(lo_exp, hi_exp, (n,), generator=gen).double()
    return draw(e), draw(e + torch.randint(-20, 20, (n,), generator=gen))


def ds_card_checks(q, dev) -> dict:
    """Phase 3, double-single on the card: two_sum and two_prod exact on
    ``DS_PAIRS`` pairs (every error against float64 zero, the CPU's bits),
    and the int8 ``offdiag().matmat_ds`` at m = 20 against a float64
    oracle on ``DS_ORACLE_ROWS`` block rows, timed beside ``matmat``."""
    import torch
    from fortran_davidson_tpu_torch.utils import ds

    gen = torch.Generator().manual_seed(13)
    out = {}
    for name, fn, (lo_exp, hi_exp), exact in (
            ("two_sum", ds.two_sum, (-100, 100), lambda a, b: a + b),
            ("two_prod", ds.two_prod, (-40, 25), lambda a, b: a * b)):
        a, b = _ds_pairs(DS_PAIRS, lo_exp, hi_exp, gen)
        hi, lo = fn(a.to(dev), b.to(dev))
        errors = int(torch.count_nonzero(
            (hi.double() + lo.double()).cpu() - exact(a.double(),
                                                      b.double())))
        hi_cpu, lo_cpu = fn(a, b)
        same = bool(torch.equal(hi.cpu(), hi_cpu)
                    and torch.equal(lo.cpu(), lo_cpu))
        print(f"  DS {name}: {DS_PAIRS} pairs, |a| from "
              f"{float(a.abs().min()):.2e} to {float(a.abs().max()):.2e}: "
              f"{errors} errors against float64, CPU's bits {same}",
              flush=True)
        _check(errors == 0 and same, f"DS {name} on the card: {errors} "
               f"errors, CPU bits {same}")
        out[name] = dict(pairs=DS_PAIRS, errors=errors, cpu_bits=same)

    off = q.offdiag()
    nbr, bs, kbs = q.qblocks.shape
    bw = q.bandwidth
    g = torch.Generator(device=dev).manual_seed(14)
    xh = torch.randn((q.shape[0], 20), generator=g, device=dev)
    xh = xh / torch.linalg.vector_norm(xh, dim=0)
    xl = torch.randn((q.shape[0], 20), generator=g, device=dev) * 1e-8
    yh, yl = off.matmat_ds(xh, xl)
    yf = off.matmat(xh).double() + off.matmat(xl).double()
    # The oracle on the slice's block rows: sum over slots of the
    # dequantized blocks (float64) times x's neighbour block rows.
    r = DS_ORACLE_ROWS
    xb = (xh.double() + xl.double()).reshape(nbr, bs, 20)
    y64 = torch.zeros((r.stop - r.start, bs, 20), dtype=torch.float64,
                      device=dev)
    for k in range(2 * bw + 1):
        cols = torch.arange(r.start, r.stop, device=dev) - bw + k
        blk = (q.qblocks[r, :, k * bs:(k + 1) * bs].double()
               * q.scale_rows[r, None, k * bs:(k + 1) * bs].double())
        y64 += torch.bmm(blk, xb[cols])
    rows = slice(r.start * bs, r.stop * bs)
    y64 = y64.reshape(-1, 20)
    err_ds = torch.linalg.vector_norm(
        yh[rows].double() + yl[rows].double() - y64, dim=0)
    err_f32 = torch.linalg.vector_norm(yf[rows] - y64, dim=0)
    scale = torch.linalg.vector_norm(y64, dim=0)
    ds_ms = _time_ms(lambda: off.matmat_ds(xh, xl), reps=5)
    mm_ms = _time_ms(lambda: off.matmat(xh), reps=5)
    rel = float(torch.max(err_ds / scale))
    print(f"  DS int8 offdiag().matmat_ds m=20 on block rows {r.start}-"
          f"{r.stop - 1}: error (column norm) {float(err_ds.max()):.3e}, "
          f"{rel:.3e} of |y| (float32 apply of both words "
          f"{float(err_f32.max()):.3e}); {ds_ms:.3f} ms against kernel 4's "
          f"matmat {mm_ms:.3f} ms (CUDA events, median of 5)", flush=True)
    # The bound of tests/test_ds_apply_sparse.py (unit columns). On the
    # band alone the DS apply's only error is each slot's float32 sum of
    # integer products, as in kernel 4's float32 apply: the two are the
    # same order here, and are printed side by side.
    _check(float(err_ds.max()) <= 5e-10,
           f"matmat_ds: error {float(err_ds.max()):.3e} (float32 "
           f"{float(err_f32.max()):.3e})")
    out["matmat_ds"] = dict(m=20, err=float(err_ds.max()), err_rel=rel,
                            err_f32=float(err_f32.max()), ms=ds_ms,
                            matmat_ms=mm_ms)
    del yh, yl, yf, xh, xl
    torch.cuda.empty_cache()
    return out


def _banded_residuals(op, X, lam):
    """||A x_j - lam_j x_j|| per column in float64, with the plain SpMM."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    X, lam = X.double(), lam.double()
    AX = kernels.banded_bsr_spmm_plain(op.blocks.double(), X, op.bandwidth)
    return torch.linalg.vector_norm(AX - X * lam[None, :], dim=0)


def _certified_agreement(a, b, op) -> tuple[float, float]:
    """Each Ritz value lies within its true residual of an eigenvalue, so two
    float32 solves agree to the sum of their residuals: returns the worst
    |lam_a - lam_b| / (||r_a|| + ||r_b||) (must be <= 1) and the worst true
    relative residual max(||r||) / max(|lam|, 1) of the two."""
    import torch
    r_a = _banded_residuals(op, a.eigenvectors, a.eigenvalues)
    r_b = _banded_residuals(op, b.eigenvectors, b.eigenvalues)
    diff = torch.abs(a.eigenvalues.double() - b.eigenvalues.double())
    ratio = float(torch.max(diff / (r_a + r_b)))
    rel = max(float(torch.max(r / torch.clamp(torch.abs(x.eigenvalues.double()),
                                              min=1.0)))
              for r, x in ((r_a, a), (r_b, b)))
    return ratio, rel


def phase_fused(q, dev, solves):
    """Phase 7: (a) the "auto" gate engages the incremental-H engine at
    lowest-128 on a 1M-row f32 matrix that needs several expansions,
    converges, and matches "off", at the default m_max = 1408 and with a
    collapse (m_max = 384); (b) fixed-iteration fused/off A/Bs at k=128 on
    that matrix and at k=20 on the int8 matrix."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    # Coupling 3: at 1e-3 the coupling-1e-3 matrix converges on its initial
    # basis, so no expansion, and no gram launch, would run.
    A3 = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, coupling=3.0,
                                  seed=0, dtype=torch.float32, device=dev)
    n = A3.shape[0]
    kw = dict(dtype="float32", expansion="lowest-k", relative_tolerance=True,
              tolerance=1e-3)
    gram = kernels.banded_bsr_spmm_gram
    for tag, extra in (("m_max 1408", {}),
                       ("max_dim_sub 256 (collapse)", dict(max_dim_sub=256))):
        runs = {}
        for option in ("auto", "off"):
            before = gram.launches
            torch.cuda.reset_peak_memory_stats()
            res, wall = _solve_converged(
                f"f32 n={n} coupling 3 lowest-128 {tag} fused_gram="
                f"{option!r}", A3, 128, fused_gram=option, **kw, **extra)
            runs[option] = (res, wall, gram.launches - before,
                            torch.cuda.max_memory_allocated() / 1e9)
        (on, on_wall, on_l, on_peak), (off, off_wall, off_l, off_peak) = \
            runs["auto"], runs["off"]
        _check(on_l > 0, f"{tag}: fused_gram='auto' did not launch "
               "banded_bsr_spmm_gram at lowest-128")
        _check(off_l == 0, f"{tag}: fused_gram='off' launched the gram kernel")
        dims = on.subspace_dims[:on.iterations].tolist()
        _check(len(dims) >= 3, f"{tag}: expected several expansions, "
               f"dims={dims}")
        if extra:
            _check(any(b < a for a, b in zip(dims, dims[1:])),
                   f"{tag}: expected a collapse, dims={dims}")
        ratio, true_rel = _certified_agreement(on, off, A3)
        rel = float(torch.max(torch.abs(on.eigenvalues - off.eigenvalues)
                              / torch.abs(off.eigenvalues)))
        print(f"  lowest-128 {tag}: gram launches={on_l} iterations "
              f"{on.iterations} (off: {off.iterations}) true relative "
              f"residual {true_rel:.3e}; |eig diff| / (r_auto + r_off) = "
              f"{ratio:.3e}, max rel eig diff={rel:.3e}; walls "
              f"{on_wall:.3f} s / {off_wall:.3f} s, peak {on_peak:.2f} / "
              f"{off_peak:.2f} GB", flush=True)
        _check(abs(on.iterations - off.iterations) <= 2,
               f"{tag}: fused {on.iterations} vs {off.iterations} iterations")
        _check(true_rel <= kw["tolerance"],
               f"{tag}: true relative residual {true_rel:.3e}")
        _check(ratio <= 1.0, f"{tag}: fused and off eigenvalues differ by "
               f"{ratio:.3f} x the sum of their residuals")
        solves.append(dict(
            solve=f"f32 banded coupling 3 lowest-128 {tag}, fused auto vs off",
            n=n, iterations=[on.iterations, off.iterations],
            wall_s=[on_wall, off_wall], launches=on_l,
            peak_mem_gb=[on_peak, off_peak], true_residual_rel=true_rel,
            eig_diff_over_residuals=ratio, eig_rel_diff=rel))
        del runs, on, off
        torch.cuda.empty_cache()

    # Fixed-iteration A/Bs (unreachable tolerance), in turns: k=128 on the
    # coupling-3 matrix ("auto" engages there) and k=20 on the int8 matrix
    # ("on" forces it), as bench.py:701-716 runs the latter.
    for label, op, k, fused, kernel, iters in (
            ("f32 coupling 3 k=128", A3, 128, "auto", gram, 4),
            ("int8 k=20", q, 20, "on", kernels.banded_q_bsr_spmm_gram, 8)):
        ab = {fused: [], "off": []}
        last = {}
        kw_ab = dict(LOOSE, tolerance=1e-30, max_iterations=iters)
        for option in (fused, "off", "off", fused):
            before = kernel.launches
            res, wall = _solve(f"{label} A/B fused_gram={option!r}", op, k,
                               fused_gram=option, **kw_ab)
            launches = kernel.launches - before
            _check((launches > 0) == (option == fused),
                   f"{label} fused_gram={option!r}: {launches} gram launches")
            ab[option].append(wall / max(res.iterations, 1))
            last[option] = res
        rel = float(torch.max(torch.abs(last[fused].eigenvalues
                                        - last["off"].eigenvalues)
                              / torch.abs(last["off"].eigenvalues)))
        row = dict(solve=f"{label} fused {fused}/off A/B, {iters} iterations",
                   n=op.shape[0], per_iter_s_fused=ab[fused],
                   per_iter_s_off=ab["off"], eig_rel_diff=rel)
        if op is A3:
            ratio, _ = _certified_agreement(last[fused], last["off"], A3)
            row["eig_diff_over_residuals"] = ratio
            note = f"; |eig diff| / (r_{fused} + r_off) = {ratio:.3e}"
            ok, why = ratio <= 1.0, f"{ratio:.3f} x the sum of their residuals"
        else:
            note = ""
            ok, why = rel <= 1e-5, f"{rel:.3e} relative"
        print(f"  {label} A/B per-iteration walls (s): {fused} {ab[fused]} "
              f"off {ab['off']}; off/{fused} (warm) = "
              f"{ab['off'][1] / ab[fused][1]:.3f}; max rel eig diff "
              f"{rel:.3e}{note}", flush=True)
        _check(ok, f"{label} A/B: eigenvalues differ by {why}")
        solves.append(row)
        del res, last
        torch.cuda.empty_cache()
    del A3
    torch.cuda.empty_cache()


# Phase 7c's tolerances (relative): phase 7's 1e-3, which the "off" engine
# must reach with a true residual within it for the engines to be compared
# there; else BF16_SOLVE_TOL. BF16_STALL_ITERS caps the "auto" solve at
# 1e-3 (Queue 3: it stalls there; "off" stops in 3-4 iterations).
STRICT_TOL = 1e-3
BF16_SOLVE_TOL = 1e-2
BF16_STALL_ITERS = 20


def phase_bf16_storage(dev, solves) -> dict:
    """Phase 7c: the solve that ``fused_gram="auto"`` sends to kernel 3's
    bf16 entry (row 3b): phase 7's float32 lowest-128 (lowest-k, relative
    tolerance, m_max 1408) on bf16 storage of phase 7's coupling-3 matrix,
    ``A3.astype(torch.bfloat16)``.

    The tolerance, by the rule of the phase: first ``"off"`` at phase 7's
    relative ``STRICT_TOL`` = 1e-3. If it converges there with a true
    relative residual (float64, the bf16 blocks, which are exact in
    float64) within 1e-3, both engines are compared at 1e-3; else at
    ``BF16_SOLVE_TOL`` = 1e-2. Bf16 storage rounds x to bf16 on every
    apply (2^-9), so the loop's residual is not the true one: on a
    16-block-row CPU solve of the same matrix "off" stops at 1e-3 with a
    true residual of 1.18e-3 (the JAX package's default operator 1.11e-3);
    at this size it admits no new direction after 5 iterations and stops
    unconverged, at 1.13e-3 (H100). Then ``"auto"`` at 1e-3, capped at
    ``BF16_STALL_ITERS``: checked not to converge, the open fault of ROADMAP
    Queue 3 (its fused bf16 gram rounds V and Y to bf16, as the TPU kernel
    does, and the carried H stalls, at a worse true residual than "off");
    a run where it converges means that entry is out of date.

    At the chosen tolerance, ``"auto"`` and ``"off"`` in turns, two warm
    solves each (the solves at 1e-3 were their cold ones). Checks: every
    solve at that tolerance converges; the true relative
    residual within the tolerance; iterations within ±2; each eigenvalue
    pair within the sum of the two solves' true residuals; row 3b launched
    under "auto", never under "off". Prints every wall and one
    ``torch.profiler`` split of a warm "auto" solve: kernel 3's share, and
    the share of the float32 -> bf16 casts of V (n, mv) that
    ``matmat_with_gram`` makes every call."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    A3 = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, coupling=3.0,
                                  seed=0, dtype=torch.float32, device=dev)
    Ab = A3.astype(torch.bfloat16)
    del A3
    torch.cuda.empty_cache()
    n = Ab.shape[0]
    label = f"f32 on bf16 storage n={n} coupling 3 lowest-128"
    gram = kernels.banded_bsr_spmm_gram

    def rel_residual(res):
        r = _banded_residuals(Ab, res.eigenvectors, res.eigenvalues)
        return float(torch.max(r / torch.clamp(
            torch.abs(res.eigenvalues.double()), min=1.0)))

    strict = dict(dtype="float32", expansion="lowest-k",
                  relative_tolerance=True, tolerance=STRICT_TOL)
    off3, off3_wall = _solve(f"{label} fused_gram='off' at "
                             f"{STRICT_TOL:.0e} (cold)", Ab, 128,
                             fused_gram="off", **strict)
    off3_rel = rel_residual(off3)
    tol = (STRICT_TOL if off3.converged and off3_rel <= STRICT_TOL
           else BF16_SOLVE_TOL)
    before = gram.bf16_launches
    auto3, auto3_wall = _solve(f"{label} fused_gram='auto' at "
                               f"{STRICT_TOL:.0e} (cold), at most "
                               f"{BF16_STALL_ITERS} iterations", Ab, 128,
                               fused_gram="auto",
                               max_iterations=BF16_STALL_ITERS, **strict)
    auto3_launches = gram.bf16_launches - before
    auto3_rel = rel_residual(auto3)
    print(f"  at {STRICT_TOL:.0e}: 'off' converged={off3.converged} "
          f"stalled={off3.stalled} in {off3.iterations} iterations, true "
          f"relative residual {off3_rel:.3e}; 'auto' converged="
          f"{auto3.converged} stalled={auto3.stalled} in {auto3.iterations} "
          f"iterations, true relative residual {auto3_rel:.3e}, row 3b "
          f"launches {auto3_launches}; the engines are compared at "
          f"{tol:.0e}", flush=True)
    _check(not auto3.converged, f"bf16 storage 'auto' converged at "
           f"{STRICT_TOL:.0e}: ROADMAP Queue 3's open stall is out of date")
    _check(auto3_launches > 0, "bf16 storage 'auto' at 1e-3: row 3b never "
           "launched")
    off3_conv, auto3_conv = bool(off3.converged), bool(auto3.converged)
    off3_iters, auto3_iters = int(off3.iterations), int(auto3.iterations)
    del off3, auto3
    kw = dict(strict, tolerance=tol)
    # The solves at 1e-3 were each engine's cold one; two warm each here.
    runs = {"auto": [], "off": []}
    for option in ("auto", "off") * 2:
        before = gram.bf16_launches
        res, wall = _solve_converged(
            f"{label} fused_gram={option!r} at {tol:.0e}", Ab, 128,
            fused_gram=option, **kw)
        runs[option].append((res, wall, gram.bf16_launches - before))
    for option, launched in (("auto", True), ("off", False)):
        counts = [r[2] for r in runs[option]]
        _check(all((c > 0) == launched for c in counts),
               f"bf16 storage fused_gram={option!r}: row 3b launches {counts}")
    on, off = runs["auto"][-1][0], runs["off"][-1][0]
    ratio, true_rel = _certified_agreement(on, off, Ab)
    walls = {o: [r[1] for r in runs[o]] for o in runs}
    print(f"  bf16 storage lowest-128: row 3b launches "
          f"{[r[2] for r in runs['auto']]} (off: "
          f"{[r[2] for r in runs['off']]}), iterations {on.iterations} "
          f"(off: {off.iterations}), true relative residual {true_rel:.3e}; "
          f"|eig diff| / (r_auto + r_off) = {ratio:.3e}; walls (s) cold (at "
          f"{STRICT_TOL:.0e}) auto {auto3_wall}, off {off3_wall}; warm auto "
          f"{walls['auto']}, off {walls['off']}", flush=True)
    _check(abs(on.iterations - off.iterations) <= 2,
           f"bf16 storage: fused {on.iterations} vs {off.iterations} "
           "iterations")
    _check(true_rel <= tol,
           f"bf16 storage: true relative residual {true_rel:.3e}")
    _check(ratio <= 1.0, f"bf16 storage: fused and off eigenvalues differ by "
           f"{ratio:.3f} x the sum of their residuals")

    # One warm "auto" solve under the profiler: kernel 3's bf16 entry, and
    # the casts of V to bf16 inside matmat_with_gram (those whose input is
    # wider than the block: (n, mv), mv > 128).
    real = Ab.matmat_with_gram

    def labelled(*args, **kwargs):
        with torch.profiler.record_function("matmat_with_gram"):
            return real(*args, **kwargs)

    Ab.matmat_with_gram = labelled
    split = _device_busy("bf16 storage lowest-128 'auto' (warm)",
                         lambda: fdtt.eigensolve(Ab, 128, fused_gram="auto",
                                                 **kw),
                         shapes=True)
    del Ab.matmat_with_gram
    busy = max(split["device_busy_ms"], 1e-9)
    kernel_ms = sum(t for name, t in split["by_name_ms"].items()
                    if "typed_gram_kernel" in name)
    cast_ms = _cast_ms(split.pop("prof"), "matmat_with_gram", 128)
    print(f"  profiled split: kernel 3 (bf16) {kernel_ms:.3f} ms "
          f"({kernel_ms / busy:.1%} of {busy:.1f} busy ms), the V casts "
          f"{cast_ms:.3f} ms ({cast_ms / busy:.1%})", flush=True)
    row = dict(solve="f32 on bf16 storage coupling 3 lowest-128, fused auto "
               "vs off", n=n, tolerance=tol,
               strict=dict(tolerance=STRICT_TOL, off_converged=off3_conv,
                           off_iterations=off3_iters,
                           off_true_residual_rel=off3_rel,
                           auto_converged=auto3_conv,
                           auto_iterations=auto3_iters,
                           auto_true_residual_rel=auto3_rel),
               iterations=[on.iterations, off.iterations],
               wall_s=walls, cold_wall_s=dict(auto=auto3_wall,
                                              off=off3_wall),
               launches=[r[2] for r in runs["auto"]],
               true_residual_rel=true_rel, eig_diff_over_residuals=ratio,
               profile=dict(device_busy_ms=busy,
                            device_idle_share=split["device_idle_share"],
                            kernel_ms=kernel_ms, v_cast_ms=cast_ms))
    solves.append(row)
    del runs, on, off, Ab
    torch.cuda.empty_cache()
    return row


def _one_rank_mesh(rendezvous: str, dev):
    """The one-rank NCCL group of phases 8-9 (started by the first call;
    later calls return the same mesh)."""
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.parallel import multihost
    mesh = multihost.initialize(init_method=rendezvous, world_size=1, rank=0,
                                device=dev)
    backend = dist.get_backend(mesh.group)
    _check(backend == "nccl", f"the mesh runs {backend}, not nccl")
    return mesh


def _device_and_host_ms(fn) -> tuple[float, float]:
    """(CUDA-event median ms, host-clock ms per call over 20 calls that end
    in a synchronize) of ``fn``: a collective's host cost leaves the card
    idle, which the events do not see."""
    import torch
    ms = _time_ms(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    return ms, (time.perf_counter() - t0) * 50


def _sharded_solves(A, q, mesh, cases, refs, solves):
    """Each case (k, op, options, label): a cold and two warm sharded
    solves, the collectives of the last counted by kind, held to the
    single-device solve ``refs[k]`` of phase 4 or 6: the same iterations,
    eigenvalues to 1e-10 (int8: 1e-5 relative; int8 in float64: F64_INT8's
    tolerance relative), true residuals."""
    import torch
    from fortran_davidson_tpu_torch.parallel import RowMesh, eigensolve_sharded

    def sharded(op, k, second_matrix=None, **kw):
        return eigensolve_sharded(op, k, mesh, second_matrix=second_matrix,
                                  **kw)

    for k, op, kw, label in cases:
        ref = refs[k]
        walls = []
        for turn in ("cold", "warm", "warm"):
            with _counting_collectives(RowMesh) as calls:
                res, wall = _solve_converged(
                    f"eigensolve_sharded({label}, {k}) [{turn}]", op,
                    20 if k in ("int8", "int8_f64") else k, solver=sharded,
                    **kw)
            walls.append(wall)
        if k in ("int8", "int8_f64"):
            true_res = _int8_true_residual(q, res.eigenvectors,
                                           res.eigenvalues)
            diff = float(torch.max(torch.abs(res.eigenvalues
                                             - ref["eigenvalues"])
                                   / torch.abs(ref["eigenvalues"])))
            limits = ((1e-5, 1e-3) if k == "int8"
                      else (F64_INT8["tolerance"],) * 2)
        else:
            true_res = _true_residual(A.blocks, 1, None, res.eigenvectors,
                                      res.eigenvalues)
            diff = float(torch.max(torch.abs(res.eigenvalues
                                             - ref["eigenvalues"])))
            limits = (1e-10, SOLVE_TOL)
        print(f"  sharded {label} {k}: iterations {res.iterations} (single "
              f"device {ref['iterations']}) eigenvalue diff {diff:.3e} true "
              f"residual {true_res:.3e}; warm wall {min(walls[1:]):.4f} s "
              f"(single device {ref['wall']:.4f} s); collectives per solve "
              f"{calls}", flush=True)
        _check(res.iterations == ref["iterations"],
               f"sharded {label} {k}: {res.iterations} iterations vs "
               f"{ref['iterations']} on one device")
        _check(diff <= limits[0],
               f"sharded {label} {k}: eigenvalues differ by {diff:.3e}")
        _check(true_res <= limits[1],
               f"sharded {label} {k}: true residual {true_res:.3e}")
        # Phase 14c holds a sharded checkpoint to these bits.
        refs.setdefault("sharded", {})[(label, k)] = dict(
            iterations=res.iterations, eigenvalues=res.eigenvalues.clone(),
            wall=min(walls[1:]))
        solves.append(dict(
            solve=(f"sharded (world 1, nccl) {label} "
                   + {"int8": "int8 f32 lowest-20 loose",
                      "int8_f64": "int8 float64 lowest-20 (1e-6 rel)"}.get(
                          k, f"f64 lowest-{k}")),
            n=op.shape[0], iterations=res.iterations, wall_s=walls,
            single_device_wall_s=ref["wall"], true_residual=true_res,
            eig_diff_single=diff, collectives=calls))
        del res


def phase_sharded(A, q, dev, rendezvous, solves, refs):
    """Phase 8a: the row-sharded solve at world size 1 over a one-rank NCCL
    group through kernels 6 and 7 (float32 x, and float64 x in phase 6's
    float64 leg), held to phases 4 and 6; then the all-gather halo
    exchange's time."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     HaloQuantizedOperator,
                                                     shard_operator)

    mesh = _one_rank_mesh(rendezvous, dev)
    print(f"  mesh: {mesh.size} rank over nccl on {mesh.device}", flush=True)
    H = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas")
    _check(H.blocks.data_ptr() == A.blocks.data_ptr(),
           "the world-size-1 shard copied the blocks")
    hq = shard_operator(q, mesh)
    _check(isinstance(hq, HaloQuantizedOperator)
           and hq.qblocks.data_ptr() == q.qblocks.data_ptr(),
           "shard_operator(int8) is not a view HaloQuantizedOperator")
    f64 = dict(tolerance=SOLVE_TOL)
    _sharded_solves(A, q, mesh, [(3, H, f64, "Halo(A, pallas)"),
                                 (20, H, f64, "Halo(A, pallas)"),
                                 ("int8", q, LOOSE, "q loose")], refs, solves)
    # The float64 leg of phase 6, sharded: kernel 7's float64-x entry.
    before = kernels.banded_q_ext_bsr_spmm.f64_launches
    _sharded_solves(A, q, mesh, [("int8_f64", q, F64_INT8, "q")],
                    refs, solves)
    launches = kernels.banded_q_ext_bsr_spmm.f64_launches - before
    print(f"  sharded q float64: kernel 7 float64-x launches {launches}",
          flush=True)
    _check(launches > 0, "the sharded float64 int8 solve never launched "
           "kernel 7's float64-x entry")

    # The exchange alone (the ring exchange of the bw*bs boundary rows;
    # views at world size 1), with the concatenation into x_ext, which
    # copies x, and one all_reduce of a Gram-sized matrix.
    halo = A.bandwidth * A.block_size

    def extend(x):
        prev, nxt, _ = mesh.ring_exchange(x, halo)
        return torch.cat([prev, x, nxt])

    for m in (20, 40, 160):
        x = torch.randn((A.shape[0], m), dtype=torch.float64, device=dev)
        G = torch.randn((m, m), dtype=torch.float64, device=dev)
        row = dict(solve=f"collectives f64 m={m}")
        for key, fn in (("exchange", lambda: mesh.ring_exchange(x, halo)),
                        ("extend", lambda: extend(x)),
                        ("all_reduce", lambda: mesh.all_reduce(G))):
            row[f"{key}_ms"], row[f"{key}_host_ms"] = _device_and_host_ms(fn)
        print("  " + ", ".join(f"{k_}={v:.4f}" if isinstance(v, float)
                               else f"{v}" for k_, v in row.items()),
              flush=True)
        solves.append(row)
        del x, G
    del H, hq
    torch.cuda.empty_cache()
    _check(kernels.banded_bsr_spmm.launches == 0
           and kernels.banded_q_bsr_spmm.launches == 0,
           "the sharded solves launched a single-device kernel")


def phase_remote(A, dev, rendezvous, solves, refs):
    """Phase 8b: lowest-3 and lowest-20 through ``backend="pallas-remote"``
    (kernel 8 on the route the topology gives one card, ``"push"``: one
    launch an apply pushes the halos into the rank's own window, no x_ext)
    at world size 1 over the same NCCL group, held to phase 4; kernels 1
    and 6 and kernel 8's two-launch form must not launch."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import HaloBSROperator

    mesh = _one_rank_mesh(rendezvous, dev)
    R = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas-remote")
    print(f"  route: {R.route}", flush=True)
    _check(R.route == "push", f"one card's route is {R.route!r}")
    _check(R.blocks.data_ptr() == A.blocks.data_ptr(),
           "the world-size-1 shard copied the blocks")
    f64 = dict(tolerance=SOLVE_TOL)
    _sharded_solves(A, None, mesh, [(3, R, f64, "Halo(A, pallas-remote)"),
                                    (20, R, f64, "Halo(A, pallas-remote)")],
                    refs, solves)
    _check(kernels.banded_bsr_spmm.launches == 0
           and kernels.banded_ext_bsr_spmm.launches == 0
           and kernels.banded_remote_halo_spmm.launches == 0,
           "the pallas-remote solves launched kernel 1, kernel 6 or kernel "
           "8's two-launch form")
    del R
    torch.cuda.empty_cache()


def _all_gather_halos(mesh, x, halo: int):
    """The halo exchange of ``"xla"``, ``"pallas"`` and the int8 operator
    before they took the ring exchange: one ``all_gather`` of every
    rank's ``2 * halo`` boundary rows. Phase 9 times it beside the ring
    exchange; no path runs it."""
    import torch
    edges = mesh.all_gather_rows(torch.cat([x[:halo], x[-halo:]]))
    edges = edges.reshape(mesh.size, 2 * halo, *x.shape[1:])
    return (edges[(mesh.rank - 1) % mesh.size, halo:],
            edges[(mesh.rank + 1) % mesh.size, :halo])


def remote_vs_pallas_apply(A, dev, rendezvous, solves):
    """Phase 9: one apply of the ``"pallas-remote"`` path (one card's
    route, ``"push"``: kernel 8's one launch) against the
    ``"pallas"`` path (the ring exchange, the x_ext concatenation, kernel
    6), f64 on the 1M-row matrix at world size 1: the same bits, and the
    CUDA-event and host-clock times of each path, in turns (pallas,
    remote, remote, pallas), of the ring exchange alone and of the
    all-gather exchange it replaced (``_all_gather_halos``), and of the
    ``"pallas"`` path's copy into x_ext and its kernel 6 alone."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import HaloBSROperator

    mesh = _one_rank_mesh(rendezvous, dev)
    ops = {b: HaloBSROperator.from_bsr(A, 1, mesh, backend=b)
           for b in ("pallas", "pallas-remote")}
    print(f"  pallas-remote route: {ops['pallas-remote'].route}", flush=True)
    halo = A.bandwidth * A.block_size
    for m in (20, 40, 160):
        x = torch.randn((A.shape[0], m), dtype=torch.float64, device=dev)
        same = torch.equal(ops["pallas"].matmat(x),
                           ops["pallas-remote"].matmat(x))
        row = dict(solve=f"halo apply f64 m={m}: pallas-remote vs pallas",
                   same_bits=same)
        for turn, backend in enumerate(("pallas", "pallas-remote",
                                        "pallas-remote", "pallas")):
            key = f"{backend}_apply_{turn}"
            row[f"{key}_ms"], row[f"{key}_host_ms"] = _device_and_host_ms(
                lambda op=ops[backend]: op.matmat(x))
        prev, nxt, _ = mesh.ring_exchange(x, halo)
        x_ext = torch.cat([prev, x, nxt])
        blocks = ops["pallas"].blocks
        for key, fn in (("ring_exchange",
                         lambda: mesh.ring_exchange(x, halo)),
                        ("all_gather_exchange",
                         lambda: _all_gather_halos(mesh, x, halo)),
                        ("x_ext_cat", lambda: torch.cat([prev, x, nxt])),
                        ("kernel6", lambda: kernels.banded_ext_bsr_spmm(
                            blocks, x_ext, bandwidth=A.bandwidth,
                            out_dtype=x.dtype))):
            row[f"{key}_ms"], row[f"{key}_host_ms"] = _device_and_host_ms(fn)
        print("  " + ", ".join(f"{k_}={v:.4f}" if isinstance(v, float)
                               else f"{k_}={v}" for k_, v in row.items()),
              flush=True)
        _check(same, f"m={m}: the pallas-remote apply gave other bits than "
               "the pallas apply")
        solves.append(row)
        del x, prev, nxt, x_ext
    del ops
    torch.cuda.empty_cache()


# Phases 10a-10c: the north stars at 10M rows and the entry points, run
# through ``examples/northstar.py`` and ``python -m
# fortran_davidson_tpu_torch``. The recipe of ``bench.py:574-612``.
NORTHSTAR_ARGV = ["--lowest", "20", "--progressive", "--tolerance", "1e-8",
                  "--expansion", "lowest-k"]
NS_FREE_N = 10_000_384
# The JAX package's run of the same recipe (docs/BENCHMARKS.md:103-110):
# its width under its 12 GB budget, and its refined iterations (iterations
# only: float32 trajectories part by summation order).
JAX_NS_BUDGET = "12e9"
JAX_NS_WIDTH = 44
JAX_NS_ITERATIONS = 17
# Phase 10a's A/B: plain float64 DPR on the float64 surrogate.
F64_NORTHSTAR = dict(method="DPR", tolerance=1e-8, relative_tolerance=True,
                     expansion="lowest-k", dtype="float64")
# Phase 10b: 78,125 block rows of 128, n = 10,000,000.
NS_BSR_N = 10_000_000


@contextlib.contextmanager
def _env(name: str, value):
    """``os.environ[name]`` set to ``value`` (unset for None) inside."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _resolved_width(op, args) -> tuple:
    """(max_dim_sub, m_max) the northstar solve's options resolve to on
    ``op`` now (the budget reads the card's free memory)."""
    from fortran_davidson_tpu_torch import config
    from fortran_davidson_tpu_torch.examples import northstar
    common, _ = northstar.solve_options(args)
    cfg = config.resolve_options(config.merge_options(None, common),
                                 args.lowest, op.shape[0], generalized=False,
                                 device=op.device)
    return cfg.max_dim, cfg.m_max


def _surrogate_oracle(op, X, lam) -> float:
    """max_j ||A x_j - lam_j x_j|| / max(|lam_j|, 1) in float64 on the
    normalized columns, A the float64 promotion of the matrix-free
    surrogate ``op`` (its diagonal, factors and weights)."""
    import torch
    from fortran_davidson_tpu_torch.models.generators import \
        low_rank_plus_diag_apply
    d, U, w = (t.double() for t in op.captured)
    X = X.double()
    X = X / torch.linalg.vector_norm(X, dim=0)
    R = low_rank_plus_diag_apply(X, d, U, w) - X * lam
    res = torch.linalg.vector_norm(R, dim=0)
    return float(torch.max(res / torch.clamp(torch.abs(lam), min=1.0)))


def _northstar_run(label, op, args, profile: bool = False,
                   mesh=None) -> dict:
    """A cold and a warm run of the northstar example's recipe
    (``northstar.solve_timed``, row-sharded over ``mesh`` when given),
    with the peak memory above the start and (``profile``) one more run
    under the profiler."""
    import torch
    from fortran_davidson_tpu_torch.examples import northstar
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    res, cold, warm = northstar.solve_timed(op, args, mesh)
    peak = torch.cuda.max_memory_allocated()
    out = dict(res=res, cold_s=cold, warm_s=warm, peak_mem_gb=peak / 1e9,
               peak_mem_above_gb=(peak - mem0) / 1e9,
               max_subspace_dim=int(res.subspace_dims.max()))
    print(f"  {label}: iterations {res.iterations} (refined stage), "
          f"converged={res.converged}, stalled={res.stalled}, cold "
          f"{cold:.3f} s, warm {warm:.3f} s, largest subspace "
          f"{out['max_subspace_dim']}, max_memory_allocated "
          f"{out['peak_mem_gb']:.2f} GB ({out['peak_mem_above_gb']:.2f} "
          "above the start)", flush=True)
    _check(bool(res.converged), f"{label}: did not converge")
    _check(bool(torch.all(torch.isfinite(res.eigenvalues)))
           and tuple(res.eigenvectors.shape) == (op.shape[0], args.lowest),
           f"{label}: bad output")
    if profile:
        out.update(_device_busy(label, lambda: northstar.run(op, args, mesh)))
    return out


def phase_northstar_free(dev, solves, ns):
    """Phase 10a (ROADMAP item 14): lowest-20 of
    ``surrogate_hamiltonian(10_000_384, float32)`` to relative 1e-8
    through ``examples/northstar.py``'s progressive recipe, at the JAX
    package's width (its 12 GB budget, which must resolve to 44) and at
    the port's own; then the plain float64 DPR solve of the float64
    surrogate. Each converges; the refined eigenpairs (hi + lo words of
    the final polish) hold a float64 oracle of the stored float32
    operator to 1e-8, and their eigenvalues the float64 solve's (at the
    12 GB budget's width; at its own width it stalls, shown) to 1e-8
    relative. ``ns["free"]`` keeps the parity leg's and the float64
    solve's numbers for phase 15a."""
    import torch
    from fortran_davidson_tpu_torch import eigensolve
    from fortran_davidson_tpu_torch.examples import northstar
    from fortran_davidson_tpu_torch.models import generators

    args = northstar.parse_args(["--n", str(NS_FREE_N), *NORTHSTAR_ARGV])
    op = northstar.build_operator(args, device=dev)
    op64 = generators.surrogate_hamiltonian(NS_FREE_N, dtype=torch.float64,
                                            device=dev)
    runs = {}
    for leg, budget in (("parity", JAX_NS_BUDGET), ("own", None)):
        with _env("FDT_CARRY_BUDGET_BYTES", budget):
            torch.cuda.empty_cache()
            width, m_max = _resolved_width(op, args)
            print(f"  [{leg}] FDT_CARRY_BUDGET_BYTES={budget}: max_dim_sub "
                  f"resolves to {width} (m_max {m_max})", flush=True)
            if budget is not None:
                _check(width == JAX_NS_WIDTH, f"the 12 GB budget resolves "
                       f"width {width}, the JAX package's {JAX_NS_WIDTH}")
            run = _northstar_run(
                f"surrogate n={NS_FREE_N} lowest-20 progressive [{leg}]",
                op, args, profile=leg == "parity")
        res = run["res"]
        lam = res.eigenvalues.double() + res.eigenvalues_lo.double()
        X = res.eigenvectors.double() + res.eigenvectors_lo.double()
        run.update(width=width, m_max=m_max, lam=lam,
                   oracle=_surrogate_oracle(op, X, lam),
                   oracle_hi=_surrogate_oracle(op, res.eigenvectors, lam),
                   oracle_f64_surrogate=_surrogate_oracle(op64, X, lam))
        print(f"  [{leg}] oracle relative residual (float64 promotion of "
              f"the stored operator): {run['oracle']:.3e} with the polish's "
              f"low words, {run['oracle_hi']:.3e} from the float32 words "
              f"alone; against the float64 surrogate "
              f"{run['oracle_f64_surrogate']:.3e}; refined iterations "
              f"{res.iterations} (the JAX package's: {JAX_NS_ITERATIONS}, "
              "iterations only)", flush=True)
        _check(run["oracle"] <= SOLVE_TOL,
               f"[{leg}] oracle residual {run['oracle']:.3e}")
        runs[leg] = run
        del res, X

    # The A/B: the same problem in plain float64 (the card has float64),
    # at the JAX package's width. At the port's own width the solve stops
    # at a fixed point above the tolerance (ROADMAP Queue 3): shown, and
    # left out of the gates.
    torch.cuda.empty_cache()
    own64, _ = _solve(f"float64 surrogate n={NS_FREE_N} lowest-20 plain DPR "
                      "[own width, observed]", op64, 20, **F64_NORTHSTAR)
    own64 = dict(converged=own64.converged, stalled=own64.stalled,
                 iterations=own64.iterations,
                 residual_norms=own64.residual_norms.tolist(),
                 max_subspace_dim=int(own64.subspace_dims.max()))
    print(f"  float64 plain at its own width: {own64}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    walls64 = []
    with _env("FDT_CARRY_BUDGET_BYTES", JAX_NS_BUDGET):
        for tag in ("cold", "warm"):
            res64, wall = _solve_converged(
                f"float64 surrogate n={NS_FREE_N} lowest-20 plain DPR "
                f"[parity width, {tag}]", op64, 20, **F64_NORTHSTAR)
            walls64.append(wall)
        peak64 = torch.cuda.max_memory_allocated()
        busy64 = _device_busy("float64 surrogate lowest-20 [parity width]",
                              lambda: eigensolve(op64, 20, **F64_NORTHSTAR))
    lam64 = res64.eigenvalues
    oracle64 = _surrogate_oracle(op64, res64.eigenvectors, lam64)
    width64 = int(res64.subspace_dims.max())
    print(f"  float64 plain: iterations {res64.iterations}, largest "
          f"subspace {width64}, oracle {oracle64:.3e}, cold "
          f"{walls64[0]:.3f} s, warm {walls64[1]:.3f} s, "
          f"max_memory_allocated {peak64 / 1e9:.2f} GB "
          f"({(peak64 - mem0) / 1e9:.2f} above the start)", flush=True)
    _check(oracle64 <= SOLVE_TOL, f"float64 oracle residual {oracle64:.3e}")
    ns["free"] = dict(
        parity={key: runs["parity"][key] for key in (
            "cold_s", "warm_s", "peak_mem_gb", "peak_mem_above_gb",
            "device_idle_share")},
        parity_iterations=runs["parity"]["res"].iterations,
        f64=dict(iterations=res64.iterations, eigenvalues=lam64.clone(),
                 wall_s=walls64, peak_mem_gb=peak64 / 1e9,
                 peak_mem_above_gb=(peak64 - mem0) / 1e9, **busy64))
    for leg, run in runs.items():
        run["eig_rel_f64"] = float(torch.max(
            torch.abs(run.pop("lam") - lam64)
            / torch.clamp(torch.abs(lam64), min=1.0)))
        print(f"  [{leg}] max |eig - eig_f64| / max(|eig_f64|, 1) = "
              f"{run['eig_rel_f64']:.3e}", flush=True)
        _check(run["eig_rel_f64"] <= SOLVE_TOL,
               f"[{leg}] eigenvalues {run['eig_rel_f64']:.3e} from float64")
        res = run.pop("res")
        solves.append(dict(
            solve=f"northstar surrogate f32 lowest-20 progressive 1e-8 rel "
            f"[{leg} width]", n=NS_FREE_N, iterations=res.iterations,
            jax_iterations=JAX_NS_ITERATIONS, stalled=res.stalled, **run))
    solves.append(dict(
        solve="northstar surrogate f64 lowest-20 plain DPR 1e-8 rel [parity "
        "width]", n=NS_FREE_N, iterations=res64.iterations, wall_s=walls64,
        max_subspace_dim=width64, oracle=oracle64,
        peak_mem_gb=peak64 / 1e9, peak_mem_above_gb=(peak64 - mem0) / 1e9,
        own_width_observed=own64, **busy64))
    del op, op64, res64, runs
    torch.cuda.empty_cache()


def phase_northstar_bsr(dev, solves, ns):
    """Phase 10b (ROADMAP item 15): lowest-20 of the 10,000,000-row int8
    banded matrix (``generate_banded_bsr_quantized(78_125, 128)``, built
    on the host, its time kept apart) to relative 1e-8 through
    ``examples/northstar.py --mode banded --quantize --progressive``, a
    cold and a warm run: converged, kernel 4 launched, the oracle relative
    residual (float64, dequantized blocks plus the diagonal) <= 1e-8.
    ``ns["bsr"]`` keeps the operator, its width and the result for phase
    15b, which runs the same matrix row-sharded."""
    import torch
    from fortran_davidson_tpu_torch.examples import northstar
    from fortran_davidson_tpu_torch.ops import kernels

    args = northstar.parse_args(["--mode", "banded", "--quantize", "--n",
                                 str(NS_BSR_N), *NORTHSTAR_ARGV])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    q = northstar.build_operator(args, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    op_gb = torch.cuda.memory_allocated() / 1e9
    print(f"  built q on the host and moved it: n={q.shape[0]}, int8 blocks "
          f"{tuple(q.qblocks.shape)} ({q.qblocks.numel() / 1e9:.2f} GB) in "
          f"{gen_s:.1f} s (kept out of every wall); allocated {op_gb:.2f} GB",
          flush=True)
    before = kernels.banded_q_bsr_spmm.launches
    width, m_max = _resolved_width(q, args)
    print(f"  max_dim_sub resolves to {width} (m_max {m_max})", flush=True)
    run = _northstar_run(f"int8 banded n={NS_BSR_N} lowest-20 progressive",
                         q, args, profile=True)
    launches = kernels.banded_q_bsr_spmm.launches - before
    res = run.pop("res")
    lam = res.eigenvalues.double() + res.eigenvalues_lo.double()
    oracle = _int8_oracle_residual(q, res.eigenvectors, lam)
    print(f"  int8 10M: oracle relative residual {oracle:.3e}, kernel 4 "
          f"launches {launches} (three runs), refined iterations "
          f"{res.iterations}, stalled={res.stalled}", flush=True)
    _check(launches > 0, "banded_q_bsr_spmm never launched at 10M rows")
    _check(oracle <= SOLVE_TOL, f"int8 10M: oracle residual {oracle:.3e}")
    solves.append(dict(
        solve="northstar int8 banded f32 lowest-20 progressive 1e-8 rel",
        n=NS_BSR_N, iterations=res.iterations, stalled=res.stalled,
        host_generation_s=gen_s, operator_gb=op_gb, width=width,
        m_max=m_max, oracle_residual_rel=oracle, launches=launches, **run))
    ns["bsr"] = dict(q=q, width=width, iterations=res.iterations, lam=lam,
                     run={key: run[key] for key in (
                         "cold_s", "warm_s", "peak_mem_gb",
                         "peak_mem_above_gb", "device_idle_share")})
    del q, res
    torch.cuda.empty_cache()


# Phase 10c: the CLI's solve on a small dense matrix (the reference's
# demo fixture's size class) and the northstar's bf16 banded mode at
# 1,048,576 rows.
CLI_N = 200
BANDED_ARGV = ["--mode", "banded", "--n", "1048576", "--tolerance", "1e-2"]


def phase_entry_points(dev, solves):
    """Phase 10c: ``python -m fortran_davidson_tpu_torch solve`` on a
    small .npy in a subprocess on the card (its JSON line within 1e-9 of
    scipy), and ``examples/northstar.py --mode banded`` at 1M rows, which
    must converge on bf16 storage through kernel 1."""
    import numpy as np
    import scipy.linalg
    import torch
    from fortran_davidson_tpu_torch.examples import northstar
    from fortran_davidson_tpu_torch.models import generators
    from fortran_davidson_tpu_torch.ops import kernels

    A = generators.generate_diagonal_dominant(CLI_N, 1e-3,
                                              device="cpu").numpy()
    want = scipy.linalg.eigh(A, eigvals_only=True)[:3]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "A.npy")
        np.save(path, A)
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "fortran_davidson_tpu_torch", "solve",
             path, "-k", "3"], cwd=root, capture_output=True, text=True,
            timeout=300)
    cli_s = time.perf_counter() - t0
    _check(p.returncode == 0, f"CLI solve exited {p.returncode}: "
           f"{p.stderr[-2000:]}")
    out = json.loads(p.stdout.strip().splitlines()[-1])
    diff = float(np.max(np.abs(np.asarray(out["eigenvalues"]) - want)))
    print(f"  CLI solve (subprocess, {cli_s:.1f} s): iterations "
          f"{out['iterations']}, converged={out['converged']}, |eig - "
          f"scipy| {diff:.3e}", flush=True)
    _check(out["converged"] and diff <= 1e-9,
           f"CLI solve: converged={out['converged']}, |eig - scipy| {diff:.3e}")

    built = []
    build = northstar.build_operator
    northstar.build_operator = lambda *a, **kw: built.append(
        build(*a, **kw)) or built[-1]
    before = kernels.banded_bsr_spmm.launches
    try:
        rc = northstar.main(BANDED_ARGV)
    finally:
        northstar.build_operator = build
    launches = kernels.banded_bsr_spmm.launches - before
    blocks = built[0].blocks.dtype
    print(f"  northstar {' '.join(BANDED_ARGV)}: exit {rc}, blocks {blocks}, "
          f"kernel 1 launches {launches}", flush=True)
    _check(rc == 0, f"northstar --mode banded exited {rc}")
    _check(blocks == torch.bfloat16, f"--mode banded stored {blocks}")
    _check(launches > 0, "kernel 1 never launched in --mode banded")
    solves.append(dict(solve="CLI solve, dense n=200 lowest-3", wall_s=cli_s,
                       iterations=out["iterations"], eig_diff_scipy=diff))
    solves.append(dict(solve="northstar --mode banded bf16 n=1048576",
                       exit=rc, launches=launches))
    del built
    torch.cuda.empty_cache()


# Phase 12: the ELL family at BASELINE config 3's size (BASELINE.json
# config 3: CSR, diagonal-dominant, 1M rows, ~50 nnz a row, DPR,
# lowest-10) and the 1M-row hybrid band + remainder at bench.py:444-449's
# locality.
CONFIG3_N = 1_000_000
CONFIG3_NNZ = 50
# 12a's card-against-CPU comparison runs at CONFIG3_N when the CPU solve
# is estimated to take at most CPU_BUDGET_S, else at CONFIG3_CUT_N.
CONFIG3_CUT_N = 262_144
CPU_BUDGET_S = 10.0
LOCAL_N = 1_000_000
LOCAL_ARGS = dict(nnz_per_row=12, locality=95.0, seed=7)
HYB = dict(block_size=128, bandwidth=1)
SCRAMBLE_SEED = 8
SPARSE_K = 10
SPARSE_EIG_RTOL = 1e-10
HYB_REFINED = dict(method="DPR", tolerance=1e-8, relative_tolerance=True,
                   dtype="float32", expansion="lowest-k", refined=True,
                   final_polish=3, max_iterations=60)


def _max_residual(op, X, lam) -> float:
    """max_j ||A x_j - lam_j x_j|| through ``op`` (float64)."""
    import torch
    R = op.matmat(X) - X * lam[None, :]
    return float(torch.max(torch.linalg.vector_norm(R, dim=0)))


def _eig_rel(a, b) -> float:
    """max_j |a_j - b_j| / |b_j|, on the host in float64."""
    import torch
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.max(torch.abs(a - b) / torch.abs(b)))


def _native_calls(before: dict) -> dict:
    """The native assembler's calls by function since ``before``."""
    from fortran_davidson_tpu_torch import native
    return {k: v - before.get(k, 0)
            for k, v in native.status()["used"].items()}


def _config3_csr(n: int):
    """(BASELINE config 3 at ``n`` rows as a scipy CSR matrix, its host
    build time): the COO of ``generate_sparse_diagonal_dominant(n, 50,
    seed=0)``, duplicates summed by scipy."""
    import scipy.sparse as sp
    from fortran_davidson_tpu_torch.ops.sparse import \
        sparse_diagonal_dominant_coo
    t0 = time.perf_counter()
    rows, cols, vals = sparse_diagonal_dominant_coo(n, CONFIG3_NNZ, seed=0)
    csr = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return csr, time.perf_counter() - t0


def phase_config3(dev, solves):
    """Phase 12a: BASELINE config 3, handed to ``fdtt.eigensolve`` as a
    scipy CSR matrix with default options (DPR, float64, 1e-8), lowest-10:
    ``as_operator`` assembles an ``ELLOperator`` on the host (native C++)
    and its applies are plain PyTorch gathers. A cold solve (the host
    assembly inside) and two warm ones on the built operator: converged,
    max true residual (float64, through the operator) <= 1e-8; the same
    solve on the card machine's CPU within 1e-10 relative and ±1
    iteration (at ``CONFIG3_CUT_N`` rows when the CPU would take over
    ``CPU_BUDGET_S``); one ELL apply at m = 10 timed against one
    ``SlicedELLOperator.from_ell`` apply."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch import native

    csr, gen_s = _config3_csr(CONFIG3_N)
    print(f"  config 3 CSR: n={CONFIG3_N}, nnz={csr.nnz} "
          f"({csr.nnz / CONFIG3_N:.2f} a row), generated on the host in "
          f"{gen_s:.1f} s", flush=True)
    before = dict(native.status()["used"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cold, cold_s = _solve_converged(
        f"eigensolve(csr, {SPARSE_K}) [cold, host assembly inside]", csr,
        SPARSE_K)
    t0 = time.perf_counter()
    op = fdtt.as_operator(csr)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    calls = _native_calls(before)
    walls = [cold_s]
    for _ in range(2):
        res, wall = _solve_converged(f"eigensolve(ELL, {SPARSE_K}) [warm]",
                                     op, SPARSE_K)
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated() / 1e9
    true_res = _max_residual(op, res.eigenvectors, res.eigenvalues)
    width = op.nnz_per_row
    ell_gb = (op.indices.numel() * 4 + op.values.numel() * 8) / 1e9
    print(f"  ELL width {width} ({ell_gb:.2f} GB of indices and values), "
          f"native library built {native.status()['built']}, native calls "
          f"{calls}; host build {build_s:.1f} s (as_operator, the transfer "
          f"included); iterations {res.iterations} (cold "
          f"{cold.iterations}), true residual {true_res:.3e}; walls: cold "
          f"{cold_s:.3f} s (assembly inside), warm {walls[1]:.3f} / "
          f"{walls[2]:.3f} s; peak {peak:.2f} GB", flush=True)
    _check(calls["ell_from_coo"] >= 2,
           "config 3 was not assembled by the native library")
    _check(true_res <= SOLVE_TOL, f"config 3: true residual {true_res:.3e}")
    _check(res.iterations == cold.iterations,
           "config 3: the warm solve took other iterations than the cold")

    x = torch.randn((CONFIG3_N, 10), dtype=torch.float64, device=dev)
    ell_ms = _time_ms(lambda: op.matmat(x))
    t0 = time.perf_counter()
    sell = fdtt.SlicedELLOperator.from_ell(op)
    torch.cuda.synchronize()
    sell_build_s = time.perf_counter() - t0
    sell_ms = _time_ms(lambda: sell.matmat(x))
    y, ys = op.matmat(x), sell.matmat(x)
    sell_err = float(torch.max(torch.abs(ys - y)) / torch.max(torch.abs(y)))
    slots = dict(ell=CONFIG3_N * width, sell=sell.gather_slots,
                 buckets=len(sell.bucket_rows))
    print(f"  one apply at m=10: ELL {ell_ms:.3f} ms ({slots['ell']} slots), "
          f"sliced ELL {sell_ms:.3f} ms ({slots['sell']} slots in "
          f"{slots['buckets']} buckets; from_ell {sell_build_s:.1f} s on the "
          f"host), max rel diff {sell_err:.2e}", flush=True)
    _check(sell_err <= 1e-12, f"sliced ELL apply differs by {sell_err:.2e}")
    del sell, y, ys

    # The card machine's CPU: one CPU apply at m = 10 sizes the CPU solve
    # (operator columns / 10 applies); over the budget, both run cut.
    t0 = time.perf_counter()
    op_cpu = fdtt.as_operator(csr, device="cpu")
    cpu_build_s = time.perf_counter() - t0
    xc = x.cpu()
    t0 = time.perf_counter()
    op_cpu.matmat(xc)
    apply_cpu_s = time.perf_counter() - t0
    estimate_s = res.operator_columns / 10 * apply_cpu_s
    cut = estimate_s > CPU_BUDGET_S
    n_cmp = CONFIG3_CUT_N if cut else CONFIG3_N
    print(f"  CPU ({torch.get_num_threads()} threads): build "
          f"{cpu_build_s:.1f} s, one apply at m=10 {apply_cpu_s:.2f} s, "
          f"solve estimated at {estimate_s:.0f} s ({res.operator_columns} "
          f"operator columns) -> comparison at n={n_cmp}"
          + (f" (CUT from {CONFIG3_N}: the CPU solve would take over "
             f"{CPU_BUDGET_S:.0f} s)" if cut else ""), flush=True)
    del x, xc
    card = res
    if cut:
        del op_cpu
        csr_c, _ = _config3_csr(n_cmp)
        card, _ = _solve_converged(f"config 3 n={n_cmp} [card]", csr_c,
                                   SPARSE_K)
        op_cpu = fdtt.as_operator(csr_c, device="cpu")
    t0 = time.perf_counter()
    cpu = fdtt.eigensolve(op_cpu, SPARSE_K)
    cpu_s = time.perf_counter() - t0
    diff = _eig_rel(card.eigenvalues, cpu.eigenvalues)
    print(f"  card against CPU at n={n_cmp}: iterations {card.iterations} / "
          f"{cpu.iterations}, converged {card.converged} / {cpu.converged}, "
          f"max rel eigenvalue diff {diff:.3e}, CPU solve {cpu_s:.1f} s",
          flush=True)
    _check(cpu.converged and abs(cpu.iterations - card.iterations) <= 1,
           f"config 3 on the CPU: {cpu.iterations} iterations, converged "
           f"{cpu.converged}")
    _check(diff <= SPARSE_EIG_RTOL, f"config 3 card vs CPU: {diff:.3e}")
    solves.append(dict(
        solve=f"config 3 ELL f64 lowest-{SPARSE_K} (scipy CSR in)",
        n=CONFIG3_N, nnz=int(csr.nnz), ell_width=width, ell_gb=ell_gb,
        native_calls=calls, host_generation_s=gen_s, host_build_s=build_s,
        iterations=res.iterations, true_residual=true_res, wall_s=walls,
        peak_mem_gb=peak, apply_ms_m10=ell_ms, sell_apply_ms_m10=sell_ms,
        slots=slots, cpu_n=n_cmp, cpu_cut=cut,
        cpu_iterations=cpu.iterations, cpu_eig_rel=diff, cpu_solve_s=cpu_s,
        cpu_estimate_s=estimate_s))
    del op, op_cpu, csr, res, cold, card, cpu
    gc.collect()
    torch.cuda.empty_cache()


def _local_coo(dtype):
    """(12b's COO, its host generation time)."""
    import fortran_davidson_tpu_torch as fdtt
    t0 = time.perf_counter()
    coo = fdtt.generate_local_sparse(LOCAL_N, dtype=dtype, **LOCAL_ARGS)
    return coo, time.perf_counter() - t0


def _split(coo, dev, dtype, **kw):
    """(``split_band_remainder`` of ``coo`` on ``dev``, its host build
    time, the transfer included)."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    t0 = time.perf_counter()
    op = fdtt.split_band_remainder(*coo, LOCAL_N, dtype=dtype, device=dev,
                                   **HYB, **kw)
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return op, time.perf_counter() - t0


def _describe(op) -> dict:
    rem = op.remainder
    return dict(n_pad=op.shape[0], block_rows=op.band.n_block_rows,
                band_gb=op.band.blocks.numel()
                * op.band.blocks.element_size() / 1e9,
                band_fraction=op.band_fraction,
                remainder=type(rem).__name__, remainder_nnz=rem.nnz,
                remainder_slots=getattr(rem, "gather_slots", None))


def _plain_hybrid(op):
    """``op`` with its band applied by kernel 1's plain version."""
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels
    band, rem = op.band, op.remainder
    return fdtt.MatrixFreeOperator(
        lambda X: (kernels.banded_bsr_spmm_plain(band.blocks, X.contiguous(),
                                                 band.bandwidth)
                   + rem.matmat(X)),
        op.shape[0], dtype=op.dtype, diag=op.diagonal(), device=op.device)


def phase_hybrid(dev, solves, shared):
    """Phase 12b: ``split_band_remainder`` of
    ``generate_local_sparse(1_000_000, 12, locality=95, seed=7)`` (bs 128,
    bw 1, sliced-ELL remainder; n_pad = 1,000,064), lowest-10 in float64
    to 1e-8, on the kernels and on the plain path in turns: kernel 1
    launched on the kernel path and never on the plain one, the same
    iterations, eigenvalues within 1e-10 relative, no padding pair; and
    the unsplit ``ELLOperator`` of the same COO: the same eigenvalues,
    iterations ±1. ``shared`` keeps the operator and its solve for 12c,
    12d."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    coo, gen_s = _local_coo(torch.float64)
    op, build_s = _split(coo, dev, torch.float64)
    desc = _describe(op)
    pad = float(op.diagonal()[-1])
    print(f"  hybrid: {desc}, padded diagonal {pad:.6e}; COO "
          f"{len(coo[0])} entries generated in {gen_s:.1f} s, split in "
          f"{build_s:.1f} s", flush=True)
    plain = _plain_hybrid(op)
    walls, runs = {"kernels": [], "plain": []}, {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for path in ("kernels", "plain", "kernels", "plain"):
        before = kernels.banded_bsr_spmm.launches
        res, wall = _solve_converged(
            f"eigensolve(hybrid, {SPARSE_K}) [{path}]",
            op if path == "kernels" else plain, SPARSE_K)
        launches = kernels.banded_bsr_spmm.launches - before
        walls[path].append(wall)
        runs[path] = (res, launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    res, launches = runs["kernels"]
    ref, plain_launches = runs["plain"]
    true_res = _max_residual(op, res.eigenvectors, res.eigenvalues)
    diff = _eig_rel(res.eigenvalues, ref.eigenvalues)
    pad_rows = float(torch.max(torch.abs(res.eigenvectors[LOCAL_N:])))
    print(f"  kernel 1 launches {launches} (plain path {plain_launches}), "
          f"iterations {res.iterations} (plain {ref.iterations}), max rel "
          f"eigenvalue diff {diff:.3e}, true residual {true_res:.3e}, "
          f"largest eigenvalue {float(res.eigenvalues.max()):.6f}, max "
          f"|x| on the padded rows {pad_rows:.1e}; walls kernels "
          f"{walls['kernels']}, plain {walls['plain']} s (cold first); peak "
          f"{peak:.2f} GB", flush=True)
    _check(launches > 0 and plain_launches == 0,
           f"kernel 1 launches {launches} / plain {plain_launches}")
    _check(res.iterations == ref.iterations,
           f"hybrid: {res.iterations} iterations vs {ref.iterations} plain")
    _check(diff <= SPARSE_EIG_RTOL, f"hybrid vs plain: {diff:.3e}")
    _check(true_res <= SOLVE_TOL, f"hybrid: true residual {true_res:.3e}")
    _check(float(res.eigenvalues.max()) < pad and pad_rows <= 1e-8,
           "hybrid: a padding pair among the lowest")
    del plain, ref, runs

    t0 = time.perf_counter()
    ell = fdtt.ELLOperator.from_coo(*coo, LOCAL_N, device=dev)
    torch.cuda.synchronize()
    ell_build_s = time.perf_counter() - t0
    ell_walls = []
    for tag in ("cold", "warm"):
        eres, wall = _solve_converged(
            f"eigensolve(unsplit ELL, {SPARSE_K}) [{tag}]", ell, SPARSE_K)
        ell_walls.append(wall)
    ell_diff = _eig_rel(eres.eigenvalues, res.eigenvalues)
    print(f"  unsplit ELL (width {ell.nnz_per_row}, built in "
          f"{ell_build_s:.1f} s): iterations {eres.iterations}, max rel "
          f"eigenvalue diff from the hybrid {ell_diff:.3e}; warm wall ELL "
          f"{ell_walls[1]:.3f} s against the hybrid's "
          f"{walls['kernels'][1]:.3f} s", flush=True)
    _check(abs(eres.iterations - res.iterations) <= 1
           and ell_diff <= SPARSE_EIG_RTOL,
           f"unsplit ELL: {eres.iterations} iterations, {ell_diff:.3e}")
    solves.append(dict(
        solve=f"hybrid f64 lowest-{SPARSE_K} n={LOCAL_N}", **desc,
        host_generation_s=gen_s, host_build_s=build_s,
        iterations=res.iterations, launches=launches,
        true_residual=true_res, eig_rel_plain=diff, wall_s=walls["kernels"],
        plain_wall_s=walls["plain"], peak_mem_gb=peak,
        ell_width=ell.nnz_per_row, ell_iterations=eres.iterations,
        ell_wall_s=ell_walls, ell_eig_rel=ell_diff))
    shared.update(coo=coo, op=op, res=res, wall=walls["kernels"][1])
    del ell, eres
    torch.cuda.empty_cache()


def phase_rcm(dev, solves, shared):
    """Phase 12c: 12b's COO scrambled by
    ``np.random.default_rng(8).permutation``: its band fraction without a
    reordering and with ``reorder="rcm"`` (the native RCM timed alone),
    and the lowest-10 solve of the reordered operator: 12b's eigenvalues
    within 1e-10 relative, kernel 1 launched, and the ``unpermute``d
    eigenvectors' true residuals against the scrambled COO (float64) <=
    1e-8."""
    import numpy as np
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch import native
    from fortran_davidson_tpu_torch.ops import kernels

    rows, cols, vals = shared["coo"]
    p = np.random.default_rng(SCRAMBLE_SEED).permutation(LOCAL_N)
    scrambled = (p[rows], p[cols], vals)
    raw, raw_s = _split(scrambled, "cpu", torch.float64)
    raw_fraction = raw.band_fraction
    del raw
    before = dict(native.status()["used"])
    t0 = time.perf_counter()
    native.rcm_order(scrambled[0], scrambled[1], LOCAL_N)
    rcm_s = time.perf_counter() - t0
    op, build_s = _split(scrambled, dev, torch.float64, reorder="rcm")
    calls = _native_calls(before)
    desc = _describe(op)
    print(f"  band fraction without a reordering {raw_fraction:.4f} (split "
          f"on the host in {raw_s:.1f} s), with RCM {desc['band_fraction']:.4f}"
          f" (12b's unscrambled: {shared['op'].band_fraction:.4f}); native "
          f"RCM {rcm_s:.2f} s, native calls {calls}; split with RCM "
          f"{build_s:.1f} s; {desc}", flush=True)
    _check(calls["rcm_order"] >= 2, "the RCM ordering did not run natively")
    before = kernels.banded_bsr_spmm.launches
    walls = []
    for tag in ("cold", "warm"):
        res, wall = _solve_converged(
            f"eigensolve(RCM hybrid, {SPARSE_K}) [{tag}]", op, SPARSE_K)
        walls.append(wall)
    launches = kernels.banded_bsr_spmm.launches - before
    diff = _eig_rel(res.eigenvalues, shared["res"].eigenvalues)
    X = op.unpermute(res.eigenvectors)
    scr = fdtt.ELLOperator.from_coo(*scrambled, LOCAL_N, device=dev)
    true_res = _max_residual(scr, X, res.eigenvalues)
    print(f"  RCM hybrid: iterations {res.iterations} (12b "
          f"{shared['res'].iterations}), kernel 1 launches {launches}, max "
          f"rel eigenvalue diff from 12b {diff:.3e}, true residual of the "
          f"unpermuted eigenvectors against the scrambled COO "
          f"{true_res:.3e}; walls {walls} s", flush=True)
    _check(launches > 0, "the RCM hybrid never launched kernel 1")
    _check(diff <= SPARSE_EIG_RTOL, f"RCM hybrid vs 12b: {diff:.3e}")
    _check(tuple(X.shape) == (LOCAL_N, SPARSE_K) and true_res <= SOLVE_TOL,
           f"RCM hybrid: unpermuted true residual {true_res:.3e}")
    solves.append(dict(
        solve=f"RCM hybrid f64 lowest-{SPARSE_K} n={LOCAL_N} (scrambled)",
        **desc, band_fraction_unordered=raw_fraction, rcm_s=rcm_s,
        native_calls=calls, host_build_s=build_s, iterations=res.iterations,
        launches=launches, eig_rel_12b=diff, true_residual=true_res,
        wall_s=walls))
    del op, res, X, scr
    torch.cuda.empty_cache()


def phase_sparse_sharded(dev, solves, shared):
    """Phase 12d: ``eigensolve_sharded`` of 12b's operator at world size 1
    over a one-rank NCCL group: the band through kernel 2 (which must
    launch; kernel 1 must not), the remainder through the ELL rule; 12b's
    iterations and eigenvalues within 1e-10 relative, true residual <=
    1e-8."""
    import torch
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import (eigensolve_sharded,
                                                     shard_operator)

    op, ref = shared["op"], shared["res"]
    tmp = tempfile.TemporaryDirectory()
    try:
        mesh = _one_rank_mesh(f"file://{tmp.name}/rendezvous", dev)
        t0 = time.perf_counter()
        sh = shard_operator(op, mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _check(type(sh).__name__ == "ShardedHybridOperator",
               f"shard_operator(hybrid) gave {type(sh).__name__}")
        k1, k2 = kernels.banded_bsr_spmm.launches, kernels.bsr_spmm.launches
        walls = []
        for tag in ("cold", "warm"):
            res, wall = _solve_converged(
                f"eigensolve_sharded(hybrid, {SPARSE_K}) [{tag}]", sh,
                SPARSE_K, solver=lambda A, k, second_matrix=None, **kw:
                eigensolve_sharded(A, k, mesh, second_matrix=second_matrix,
                                   **kw))
            walls.append(wall)
        k1 = kernels.banded_bsr_spmm.launches - k1
        k2 = kernels.bsr_spmm.launches - k2
        diff = _eig_rel(res.eigenvalues, ref.eigenvalues)
        true_res = _max_residual(op, res.eigenvectors, res.eigenvalues)
        print(f"  sharded hybrid (world 1, nccl; shard_operator "
              f"{build_s:.1f} s, the remainder to ELL on the host): "
              f"iterations {res.iterations} (12b {ref.iterations}), kernel "
              f"2 launches {k2}, kernel 1 launches {k1}, max rel eigenvalue "
              f"diff {diff:.3e}, true residual {true_res:.3e}; walls {walls}"
              f" s (12b warm {shared['wall']:.3f} s)", flush=True)
        _check(k2 > 0 and k1 == 0, f"kernel 2 launches {k2}, kernel 1 {k1}")
        _check(res.iterations == ref.iterations,
               f"sharded hybrid: {res.iterations} iterations vs "
               f"{ref.iterations}")
        _check(diff <= SPARSE_EIG_RTOL, f"sharded hybrid vs 12b: {diff:.3e}")
        _check(true_res <= SOLVE_TOL,
               f"sharded hybrid: true residual {true_res:.3e}")
        solves.append(dict(
            solve=f"sharded (world 1, nccl) hybrid f64 lowest-{SPARSE_K}",
            n=op.shape[0], host_build_s=build_s, iterations=res.iterations,
            launches_k2=k2, eig_rel_12b=diff, true_residual=true_res,
            wall_s=walls, single_device_wall_s=shared["wall"]))
        del sh, res
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()
    torch.cuda.empty_cache()


def phase_hybrid_refined(dev, solves):
    """Phase 12e: the refined recipe of tests/test_ds_apply_sparse.py:141-164
    on a float32 hybrid of 12b's COO drawn in float32: a loose lowest-4
    warm start, then ``refined=True, final_polish=3`` at relative 1e-8
    through kernel 1's float32 entry; the oracle relative residual against
    the float64 promotion of the stored matrix (eigenvalues hi + lo) <=
    1e-8."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    coo, gen_s = _local_coo(torch.float32)
    op, build_s = _split(coo, dev, torch.float32)
    del coo
    before = kernels.banded_bsr_spmm.launches
    loose, loose_s = _solve_converged("hybrid f32 lowest-4 [loose]", op, 4,
                                      **LOOSE)
    res, wall = _solve_converged("hybrid f32 lowest-4 [refined, polish 3]",
                                 op, 4, initial_vectors=loose.eigenvectors,
                                 **HYB_REFINED)
    launches = kernels.banded_bsr_spmm.launches - before
    rem = op.remainder
    A64 = fdtt.HybridBandedOperator(
        fdtt.BSROperator(op.band.block_cols, op.band.blocks.double(),
                         bandwidth=op.band.bandwidth),
        fdtt.SlicedELLOperator(rem.bucket_rows, rem.bucket_indices,
                               [v.double() for v in rem.bucket_values],
                               rem.gather_map, chunk=rem.chunk))
    lam = res.eigenvalues.double()
    if res.eigenvalues_lo is not None:
        lam = lam + res.eigenvalues_lo.double()
    oracle = {}
    for words in ("hi", "hi+lo"):
        X = res.eigenvectors.double()
        if words == "hi+lo" and res.eigenvectors_lo is not None:
            X = X + res.eigenvectors_lo.double()
        X = X / torch.linalg.vector_norm(X, dim=0)
        R = torch.linalg.vector_norm(A64.matmat(X) - X * lam, dim=0)
        oracle[words] = float(torch.max(R / torch.clamp(torch.abs(lam),
                                                        min=1.0)))
    print(f"  refined hybrid f32 (COO {gen_s:.1f} s, split {build_s:.1f} "
          f"s): loose {loose.iterations} iterations {loose_s:.3f} s, refined "
          f"{res.iterations} iterations {wall:.3f} s, stalled={res.stalled}, "
          f"kernel 1 launches {launches}, oracle relative residual "
          f"{oracle}", flush=True)
    _check(launches > 0, "the refined hybrid never launched kernel 1")
    _check(min(oracle.values()) <= SOLVE_TOL,
           f"refined hybrid: oracle residual {oracle}")
    solves.append(dict(
        solve="hybrid f32 lowest-4 refined + polish 3, 1e-8 rel",
        n=op.shape[0], loose_iterations=loose.iterations,
        iterations=res.iterations, stalled=res.stalled, launches=launches,
        oracle_residual_rel=oracle, wall_s=[loose_s, wall],
        host_build_s=build_s))
    del op, A64, res, loose
    torch.cuda.empty_cache()


# Phase 13 (ROADMAP 18a-18b): Chebyshev-filtered restarts, locking, eigsh,
# the reduced matmul precisions and the batched solve, after phase 12.
# 13a's and 13b's DPR cases run on phase 7's coupling-3 matrix promoted to
# float64: lowest-20 there collapses every fourth iteration at
# max_dim_sub=80, where phase 4's matrix converges after one collapse.
CHEB_OPTS = dict(expansion="lowest-k", max_dim_sub=80)
CHEB_CASES = (("unfiltered", 0), ("degree 8", 8), ("auto", "auto"))
LANCZOS_APPLIES = 12
EIGSH_CASES = (("SA", dict(k=6, which="SA")), ("LA", dict(k=6, which="LA")),
               ("BE", dict(k=6, which="BE")), ("sigma", dict(k=4)))
PRECISIONS = (None, "float32", "highest", "tensorfloat32", "bfloat16_3x",
              "bfloat16")
REDUCED_TOL = 1e-2
BATCH, BATCH_N = 64, 1024


def phase13_operators(dev) -> dict:
    """Phase 4's matrix (float64), phase 7's coupling-3 float32 storage and
    its float64 promotion, built on the host as phases 4 and 7 build
    them."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    t0 = time.perf_counter()
    A = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, coupling=1e-3,
                                 seed=0, dtype=torch.float64, device=dev)
    C32 = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, coupling=3.0,
                                   seed=0, dtype=torch.float32, device=dev)
    C = fdtt.BSROperator(C32.block_cols, C32.blocks.double(), bandwidth=1)
    torch.cuda.synchronize()
    print(f"  phase 13's matrices (phase 4's A in float64, phase 7's "
          f"coupling-3 float32 storage and its float64 promotion C) built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(A=A, C32=C32, C=C)


@contextlib.contextmanager
def _recording_degrees():
    """The filter degrees ``chebyshev.auto_degree`` picks in the block."""
    from fortran_davidson_tpu_torch.core import chebyshev
    degrees, auto = [], chebyshev.auto_degree

    def record(*args, **kwargs):
        degrees.append(auto(*args, **kwargs))
        return degrees[-1]

    chebyshev.auto_degree = record
    try:
        yield degrees
    finally:
        chebyshev.auto_degree = auto


def _counted(op):
    """``op`` behind a wrapper that counts its applies (``calls``, each
    block's width) and the nonzero columns they took (``columns``)."""
    import torch
    import fortran_davidson_tpu_torch as fdtt

    class Counted(fdtt.LinearOperator):
        shape = property(lambda self: op.shape)
        dtype = property(lambda self: op.dtype)
        device = property(lambda self: op.device)

        def __init__(self):
            self.calls, self.columns = [], 0

        def matmat(self, block):
            self.calls.append(block.shape[1])
            self.columns += int(torch.count_nonzero(
                torch.sum(torch.abs(block), dim=0)))
            return op.matmat(block)

        def diagonal(self):
            return op.diagonal()

    return Counted()


def _collapses(res) -> int:
    dims = res.subspace_dims[:res.iterations]
    return int((dims[1:] < dims[:-1]).sum())


def _rel_diff(a, b) -> float:
    import torch
    return float(torch.max(torch.abs(a.double() - b.double())
                           / torch.clamp(torch.abs(b.double()), min=1.0)))


def phase_cheb(ops, dev, solves, shared):
    """Phase 13a: lowest-20 of C (``CHEB_OPTS``) unfiltered, with
    ``cheb_degree=8`` and ``"auto"``, through kernel 1: each converges, a
    true residual <= 1e-8, eigenvalues within 1e-9 relative of the
    unfiltered solve's, the unfiltered solve collapses twice or more and
    the filtered ones once or more. A counted solve of each (the operator
    behind a wrapper) holds kernel 1's launches to its applies: one for
    the initial basis, ``LANCZOS_APPLIES`` single-column ones for the
    bound (filtered only), one an expansion and ``degree + 1`` a filtered
    collapse; and ``operator_columns`` to the nonzero columns applied less
    the bound's."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels
    C = ops["C"]
    k1 = kernels.banded_bsr_spmm
    ref = None
    for label, cheb in CHEB_CASES:
        walls, launches = [], []
        torch.cuda.reset_peak_memory_stats()
        for tag in ("cold", "warm"):
            before = k1.launches
            res, wall = _solve_converged(
                f"C lowest-20 {CHEB_OPTS} {label} [{tag}]", C, 20,
                cheb_degree=cheb, **CHEB_OPTS)
            walls.append(wall)
            launches.append(k1.launches - before)
        peak = torch.cuda.max_memory_allocated() / 1e9
        counted = _counted(C)
        before = k1.launches
        with _recording_degrees() as degrees:
            cres = fdtt.eigensolve(counted, 20, cheb_degree=cheb,
                                   **CHEB_OPTS)
        counted_launches = k1.launches - before
        collapses = _collapses(res)
        filtered = cheb != 0
        if cheb != "auto":
            _check(degrees == [], f"13a {label}: auto_degree was called")
            degrees = [cheb] * collapses if filtered else []
        lanczos = LANCZOS_APPLIES if filtered else 0
        expansions = res.iterations - 1 - collapses
        applies = 1 + lanczos + expansions + sum(d + 1 for d in degrees)
        true_res = _true_residual(C.blocks, 1, None, res.eigenvectors,
                                  res.eigenvalues)
        print(f"  13a {label}: iterations {res.iterations}, collapses "
              f"{collapses}, degrees {degrees}, operator_columns "
              f"{res.operator_columns}; kernel 1 launches a solve "
              f"{launches} (counted solve {counted_launches}, its applies "
              f"{len(counted.calls)}, predicted {applies}; nonzero columns "
              f"{counted.columns}, less the bound's {lanczos}); true "
              f"residual {true_res:.3e}; walls cold {walls[0]:.4f} s, warm "
              f"{walls[1]:.4f} s; peak {peak:.2f} GB", flush=True)
        _check(true_res <= SOLVE_TOL, f"13a {label}: true residual "
               f"{true_res:.3e}")
        _check(cres.iterations == res.iterations
               and launches[0] == launches[1] == counted_launches,
               f"13a {label}: the counted solve took {cres.iterations} "
               f"iterations and {counted_launches} launches")
        _check(counted_launches == len(counted.calls) == applies,
               f"13a {label}: {counted_launches} launches, "
               f"{len(counted.calls)} applies, {applies} predicted")
        _check(counted.calls[1:1 + lanczos] == [1] * lanczos,
               f"13a {label}: the bound's applies are not single columns")
        _check(cres.operator_columns == counted.columns - lanczos,
               f"13a {label}: operator_columns {cres.operator_columns}, "
               f"{counted.columns} columns applied")
        if filtered:
            _check(collapses > 0, f"13a {label}: no collapse")
            eig = _rel_diff(res.eigenvalues, ref.eigenvalues)
            print(f"    max |eig - eig_unfiltered| / max(|eig|, 1) = "
                  f"{eig:.3e}", flush=True)
            _check(eig <= 1e-9, f"13a {label}: eigenvalues {eig:.3e} from "
                   "the unfiltered solve's")
        else:
            _check(collapses >= 2, f"13a: the unfiltered solve collapsed "
                   f"{collapses} times")
            ref = res
        solves.append(dict(
            solve=f"phase 13a coupling-3 f64 lowest-20 lowest-k max_dim_sub "
            f"80 cheb_degree={cheb!r}", n=C.shape[0],
            iterations=res.iterations, collapses=collapses, degrees=degrees,
            operator_columns=res.operator_columns, launches=launches[1],
            cold_wall_s=walls[0], wall_s=walls[1], true_residual=true_res,
            peak_mem_gb=peak))
        del counted, cres
    shared["C_lowest20"] = ref.eigenvalues.clone()
    del ref, res
    torch.cuda.empty_cache()


def phase_locking(ops, dev, solves):
    """Phase 13b: lowest-20 DPR on C (lowest-k, the default width) and
    lowest-3 GJD on phase 4's matrix, each without and with
    ``locking=True``: both converge, not stalled, eigenvalues within 1e-9
    relative of each other, true residuals <= 1e-8, and locking applies no
    more operator columns."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    k1 = kernels.banded_bsr_spmm
    for label, op, k, opts in (
            ("C DPR lowest-20 lowest-k", ops["C"], 20,
             dict(expansion="lowest-k")),
            ("A GJD lowest-3", ops["A"], 3, dict(method="GJD"))):
        runs = {}
        for lock in (False, True):
            walls = []
            for tag in ("cold", "warm"):
                before = k1.launches
                res, wall = _solve_converged(
                    f"{label} locking={lock} [{tag}]", op, k, locking=lock,
                    **opts)
                walls.append(wall)
            true_res = _true_residual(op.blocks, 1, None, res.eigenvectors,
                                      res.eigenvalues)
            runs[lock] = (res, walls, k1.launches - before, true_res)
        (off, off_walls, off_l, off_r), (on, on_walls, on_l, on_r) = (
            runs[False], runs[True])
        eig = _rel_diff(on.eigenvalues, off.eigenvalues)
        print(f"  13b {label}: operator_columns {off.operator_columns} "
              f"without locking, {on.operator_columns} with; iterations "
              f"{off.iterations} / {on.iterations}; kernel 1 launches a "
              f"solve {off_l} / {on_l}; inner iterations "
              f"{off.inner_iterations} / {on.inner_iterations}; max rel "
              f"eigenvalue diff {eig:.3e}; true residuals {off_r:.3e} / "
              f"{on_r:.3e}; walls (cold, warm) {off_walls} / {on_walls} s",
              flush=True)
        _check(not off.stalled and not on.stalled, f"13b {label}: stalled")
        _check(eig <= 1e-9, f"13b {label}: eigenvalues {eig:.3e} apart")
        _check(max(off_r, on_r) <= SOLVE_TOL, f"13b {label}: true residuals "
               f"{off_r:.3e} / {on_r:.3e}")
        _check(on.operator_columns <= off.operator_columns,
               f"13b {label}: locking applied {on.operator_columns} columns "
               f"against {off.operator_columns}")
        solves.append(dict(
            solve=f"phase 13b {label} locking", n=op.shape[0],
            iterations=[off.iterations, on.iterations],
            operator_columns=[off.operator_columns, on.operator_columns],
            launches=[off_l, on_l], wall_s=[off_walls, on_walls],
            true_residual=[off_r, on_r], eig_rel=eig))
        del runs, off, on
    torch.cuda.empty_cache()


def phase_eigsh(ops, dev, solves, shared):
    """Phase 13c: ``eigsh`` on phase 4's matrix through kernel 1: "SA"
    k=6 equal to phase 4's lowest-6 within 1e-9; "LA" k=6, "BE" k=6 and
    ``sigma`` = the median of the diagonal, k=4 (the spectral fold, two
    applies a block), each certified by true residuals <= 1e-8 on the
    card; kernel 1's launches a call."""
    import numpy as np
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels
    A = ops["A"]
    k1 = kernels.banded_bsr_spmm
    diag = A.diagonal()
    sigma = float(torch.median(diag))
    for label, kw in EIGSH_CASES:
        if label == "sigma":
            kw = dict(kw, sigma=sigma)
        walls, launches = [], []
        for tag in ("cold", "warm"):
            torch.cuda.synchronize()
            before = k1.launches
            t0 = time.perf_counter()
            w, v = fdtt.eigsh(A, **kw)
            walls.append(time.perf_counter() - t0)
            launches.append(k1.launches - before)
        lam = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
        X = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        true_res = _true_residual(A.blocks, 1, None, X, lam)
        print(f"  13c eigsh {kw}: eigenvalues {w.tolist()}; kernel 1 "
              f"launches a call {launches}; true residual {true_res:.3e}; "
              f"walls (cold, warm) {walls} s", flush=True)
        _check(w.shape == (kw["k"],) and v.shape == (A.shape[0], kw["k"])
               and bool(np.all(np.isfinite(w))), f"13c {label}: bad output")
        _check(launches[0] > 0, f"13c {label}: kernel 1 never launched")
        _check(true_res <= SOLVE_TOL, f"13c {label}: true residual "
               f"{true_res:.3e}")
        extra = {}
        if label == "SA":
            diff = float(torch.max(torch.abs(
                lam - shared["phase4_lowest20"][:6].to(dev))))
            print(f"    |eig - phase 4's lowest-6| = {diff:.3e}", flush=True)
            _check(diff <= 1e-9, f"13c SA: {diff:.3e} from phase 4's")
            extra["eig_diff_phase4"] = diff
        if label == "sigma":
            near = torch.sort(torch.abs(diag - sigma))[0][:4]
            got = torch.sort(torch.abs(lam - sigma))[0]
            _check(float(torch.max(torch.abs(got - near))) <= 1e-2,
                   f"13c sigma: not the eigenvalues nearest {sigma}")
            extra["sigma"] = sigma
        solves.append(dict(
            solve=f"phase 13c eigsh {label} k={kw['k']}", n=A.shape[0],
            launches=launches, wall_s=walls, true_residual=true_res,
            eigenvalues=w.tolist(), **extra))
        del X, v
    torch.cuda.empty_cache()


def _matmul_flags() -> tuple:
    import torch
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, torch.backends.cudnn.allow_tf32,
            m.allow_fp16_reduced_precision_reduction,
            m.allow_bf16_reduced_precision_reduction,
            torch.get_float32_matmul_precision())


def phase_precision(ops, dev, solves, shared):
    """Phase 13d: float32 lowest-20 on phase 7's float32 storage at
    relative ``REDUCED_TOL`` under the default, ``"tensorfloat32"`` and
    ``"bfloat16"`` (then the default again): eigenvalues within 1e-2
    relative of 13a's float64 solve of the same stored matrix; every CUDA
    matmul flag the same before and after each solve, and after a solve
    made to raise; the default's eigenvalues bit for bit the same before
    and after. Prints one (n, 20)ᵀ(n, 20) float32 GEMM's error against
    float64 under each ``matmul_precision`` name."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.utils.dtypes import full_precision_matmuls
    C32 = ops["C32"]
    n = C32.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    V = torch.randn((n, 20), generator=g, device=dev)
    exact = V.double().T @ V.double()
    scale = torch.abs(V.double()).T @ torch.abs(V.double())
    gemm = {}
    for name in PRECISIONS:
        with full_precision_matmuls(name):
            err = (V.T @ V).double() - exact
        gemm[str(name)] = dict(
            rel_to_max=float(torch.max(torch.abs(err))
                             / torch.max(torch.abs(exact))),
            rel_to_abs=float(torch.max(torch.abs(err) / scale)))
    print("  13d (n, 20)ᵀ(n, 20) float32 GEMM against float64 by "
          "matmul_precision (max |err| / max |G|; max |err| / (|V|ᵀ|V|)): "
          + "; ".join(f"{k} {v['rel_to_max']:.3e} {v['rel_to_abs']:.3e}"
                      for k, v in gemm.items()), flush=True)
    del V, exact, scale
    kw = dict(dtype="float32", expansion="lowest-k", relative_tolerance=True,
              tolerance=REDUCED_TOL)
    ref = shared["C_lowest20"]
    runs = []
    for precision in (None, "tensorfloat32", "bfloat16", None):
        flags = _matmul_flags()
        res, wall = _solve_converged(
            f"C32 float32 lowest-20 rel {REDUCED_TOL} matmul_precision="
            f"{precision!r}", C32, 20, matmul_precision=precision, **kw)
        _check(_matmul_flags() == flags, f"13d {precision}: the flags "
               f"{flags} became {_matmul_flags()}")
        eig = _rel_diff(res.eigenvalues, ref)
        print(f"    eigenvalues within {eig:.3e} relative of the float64 "
              "solve's", flush=True)
        _check(eig <= REDUCED_TOL, f"13d {precision}: {eig:.3e} from float64")
        runs.append(dict(precision=precision, iterations=res.iterations,
                         wall_s=wall, eig_rel_f64=eig,
                         eigenvalues=res.eigenvalues.clone()))
    _check(torch.equal(runs[0]["eigenvalues"], runs[-1]["eigenvalues"]),
           "13d: the default solve's bits moved after the reduced ones")

    calls = [0]

    def failing(X):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("the third apply fails on purpose")
        return C32.matmat(X)

    flags = _matmul_flags()
    try:
        fdtt.eigensolve(fdtt.MatrixFreeOperator(
            failing, n, dtype=torch.float32, diag=C32.diagonal(), device=dev),
            20, matmul_precision="tensorfloat32", **kw)
    except RuntimeError as exc:
        _check("on purpose" in str(exc), f"13d: {exc}")
    else:
        _check(False, "13d: the failing solve did not raise")
    _check(_matmul_flags() == flags, "13d: the flags moved after a solve "
           "that raised")
    print(f"    flags before and after each solve and after the raise: "
          f"{flags}; the default's bits equal before and after", flush=True)
    solves.append(dict(
        solve=f"phase 13d C32 f32 lowest-20 rel {REDUCED_TOL} "
        "matmul_precision", n=n, gemm_error=gemm,
        runs=[{k: v for k, v in r.items() if k != "eigenvalues"}
              for r in runs], flags=list(flags)))


def phase_batched(dev, solves):
    """Phase 13e (no kernel): ``eigensolve_batched`` of ``BATCH``
    ``generate_diagonal_dominant(BATCH_N, 1e-3)`` matrices (seeds 0-63),
    lowest-3 to 1e-9, and of the same with diagonal B's: each problem's
    eigenvalues within 1e-12 of its single solve's, and its iterations."""
    import numpy as np
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.models import generators
    mats = torch.stack([generators.generate_diagonal_dominant(
        BATCH_N, 1e-3, seed=s, device=dev) for s in range(BATCH)])
    diag_b = torch.from_numpy(np.stack([
        1.0 + 0.05 * np.random.default_rng(s).random(BATCH_N)
        for s in range(BATCH)])).to(dev)
    for label, B in (("standard", None), ("diagonal-B pencil", diag_b)):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fdtt.eigensolve_batched(mats, 3, second_matrices=B,
                                          tolerance=1e-9)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        singles, diff, same_its = 0.0, 0.0, True
        for i in range(BATCH):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = fdtt.eigensolve(mats[i], 3, second_matrix=None if B is None
                                  else B[i], tolerance=1e-9)
            torch.cuda.synchronize()
            singles += time.perf_counter() - t0
            diff = max(diff, float(torch.max(torch.abs(
                res.eigenvalues[i] - one.eigenvalues))))
            same_its &= int(res.iterations[i]) == one.iterations
        its = res.iterations.tolist()
        print(f"  13e batched {label}: {BATCH} x n={BATCH_N} lowest-3, "
              f"iterations {min(its)}-{max(its)}, all converged "
              f"{bool(torch.all(res.converged))}; max |eig - single| "
              f"{diff:.3e}; batch walls (cold, warm) {walls} s, the "
              f"{BATCH} single solves {singles:.3f} s", flush=True)
        _check(bool(torch.all(res.converged)), f"13e {label}: not converged")
        _check(tuple(res.eigenvalues.shape) == (BATCH, 3)
               and tuple(res.iterations.shape) == (BATCH,),
               f"13e {label}: leaves without the batch axis")
        _check(diff <= 1e-12 and same_its, f"13e {label}: {diff:.3e} from "
               "the single solves, or other iterations")
        solves.append(dict(
            solve=f"phase 13e batched {label} {BATCH} x n={BATCH_N} "
            "lowest-3", iterations=its, wall_s=walls,
            single_walls_sum_s=singles, eig_diff_single=diff))
    del mats, diag_b
    torch.cuda.empty_cache()


# Phase 14 (ROADMAP 18c, item 19): checkpoint and resume, the chunked
# driver's callbacks, the profiler hooks and the NaN trap on phase 4's
# matrix (kernel 1); the sharded refined stage of phase 6b (kernel 7) and
# a sharded checkpoint through "pallas" (kernel 6), at world size 1 over
# phase 8's NCCL group. Every checkpoint goes under chiprun_out/ and is
# deleted at the phase's end.
CKPT_EVERY = 2
_STEP_NAME = r"^step_\d+$"


class _Interrupt(RuntimeError):
    """Raised by a chunk callback: the process dying after a save."""


def _interrupt_once():
    """A chunk callback that raises at its first call (after the first
    save) only."""
    calls = []

    def callback(state):
        calls.append(state["it"])
        if len(calls) == 1:
            raise _Interrupt
    return callback


def _keep_latest(directory, sizes=None):
    """A chunk callback that removes every step but the newest (a
    lowest-20 save of the 1M-row basis is ~5.5 GB), and appends the
    newest step's bytes on disk to ``sizes``."""
    import re
    import shutil

    def callback(state):
        steps = sorted(int(name[5:]) for name in os.listdir(directory)
                       if re.match(_STEP_NAME, name))
        for it in steps[:-1]:
            shutil.rmtree(os.path.join(directory, f"step_{it}"))
        if sizes is not None:
            path = os.path.join(directory, f"step_{steps[-1]}")
            sizes.append(sum(os.path.getsize(os.path.join(path, f))
                             for f in os.listdir(path)))
    return callback


@contextlib.contextmanager
def _timed_calls(module, names):
    """Seconds of each call of ``module.<name>`` for each name (host
    clock, synchronised on both ends) inside the ``with`` block."""
    import torch
    times = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out
        return call

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    try:
        yield times
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _ckpt_root() -> str:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chiprun_out", f"phase14_{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    return root


def _same_solve(res, ref) -> bool:
    """Bit for bit: eigenvalues, residual history (NaN past the exit),
    iterations, operator columns."""
    import torch
    hist = torch.equal(torch.nan_to_num(res.residual_history, nan=-1.0),
                       torch.nan_to_num(ref.residual_history, nan=-1.0))
    return (res.iterations == ref.iterations
            and res.operator_columns == ref.operator_columns
            and torch.equal(res.eigenvalues, ref.eigenvalues) and hist)


def _checkpointed(directory, every, callbacks=(), mesh=None):
    """``eigensolve_checkpointed`` into ``directory``, with ``_solve``'s
    signature."""
    import fortran_davidson_tpu_torch as fdtt

    def solver(op, k, second_matrix=None, **kw):
        return fdtt.eigensolve_checkpointed(op, k, directory, every=every,
                                            second_matrix=second_matrix,
                                            mesh=mesh, callbacks=callbacks,
                                            **kw)
    return solver


def phase_checkpoint(A, dev, solves, refs):
    """Phase 14a: ``eigensolve_checkpointed`` on phase 4's matrix through
    kernel 1, lowest-3 and lowest-20 every ``CKPT_EVERY`` iterations:
    uninterrupted, the one-shot solve's bits; interrupted after its first
    save and resumed, the same bits, and kernel 1's launches of both runs
    the one-shot solve's. Every save and restore is timed, and its bytes
    on disk counted. The logger's records, a profiled solve's trace and
    the NaN trap."""
    import json as json_mod
    import shutil
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch import checkpoint
    from fortran_davidson_tpu_torch.checkpoint import latest_step
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.utils.debugging import nan_trap
    from fortran_davidson_tpu_torch.utils.observability import (
        ConvergenceLogger, annotate, profile_trace)

    k1 = kernels.banded_bsr_spmm
    root = _ckpt_root()
    try:
        for k in (3, 20):
            before = k1.launches
            ref, ref_wall = _solve_converged(f"eigensolve(A, {k}) [one-shot]",
                                             A, k)
            one_shot = k1.launches - before
            full = os.path.join(root, f"lowest{k}_full")
            log, sizes = ConvergenceLogger(), []
            with _timed_calls(checkpoint, ("save_state",
                                           "restore_state")) as times:
                res, full_wall = _solve_converged(
                    f"eigensolve_checkpointed(A, {k}, every={CKPT_EVERY})",
                    A, k, solver=_checkpointed(
                        full, CKPT_EVERY, (_keep_latest(full, sizes), log)))
            hist = res.residual_history
            log_ok = (len(log.records) == -(-res.iterations // CKPT_EVERY)
                      and all(rec["max_residual"]
                              == float(hist[rec["iteration"] - 1].max())
                              for rec in log.records))
            _check(_same_solve(res, ref), f"14a lowest-{k}: the checkpointed "
                   "solve is not the one-shot solve bit for bit")
            _check(latest_step(full) == ref.iterations,
                   f"14a lowest-{k}: latest step {latest_step(full)}")
            _check(log_ok, f"14a lowest-{k}: the logger's records "
                   f"{log.records} against the history")
            shutil.rmtree(full)

            cut = os.path.join(root, f"lowest{k}_cut")
            before = k1.launches
            try:
                fdtt.eigensolve_checkpointed(A, k, cut, every=CKPT_EVERY,
                                             callbacks=(_interrupt_once(),))
                interrupted = False
            except _Interrupt:
                interrupted = True
            saved = latest_step(cut)
            with _timed_calls(checkpoint, ("save_state",
                                           "restore_state")) as more:
                resumed, resume_wall = _solve_converged(
                    f"eigensolve_checkpointed(A, {k}) resumed from "
                    f"step_{saved}", A, k, solver=_checkpointed(
                        cut, CKPT_EVERY, (_keep_latest(cut, sizes),)))
            launches = k1.launches - before
            shutil.rmtree(cut)
            saves = times["save_state"] + more["save_state"]
            restores = more["restore_state"]
            print(f"  14a lowest-{k}: {ref.iterations} iterations, "
                  f"checkpointed and resumed bit for bit "
                  f"{_same_solve(res, ref)} / {_same_solve(resumed, ref)}; "
                  f"kernel 1 launches one-shot {one_shot}, interrupted + "
                  f"resumed {launches}; bytes a save {sizes} (max "
                  f"{max(sizes) / 1e9:.3f} GB); saves "
                  f"{[round(t, 3) for t in saves]} s, restore "
                  f"{[round(t, 3) for t in restores]} s; warm walls: "
                  f"one-shot {ref_wall:.4f} s, checkpointed {full_wall:.4f} s "
                  f"({len(log.records)} saves), resumed {resume_wall:.4f} s "
                  f"(from step_{saved}); logger records "
                  f"{[(r['iteration'], r['subspace_dim']) for r in log.records]}",
                  flush=True)
            _check(interrupted and saved == min(CKPT_EVERY, ref.iterations),
                   f"14a lowest-{k}: interrupted {interrupted} at {saved}")
            _check(_same_solve(resumed, ref), f"14a lowest-{k}: the resumed "
                   "solve is not the one-shot solve bit for bit")
            _check(launches == one_shot, f"14a lowest-{k}: {launches} kernel "
                   f"1 launches interrupted + resumed, {one_shot} one-shot")
            _check(len(restores) == 1, f"14a lowest-{k}: {len(restores)} "
                   "restores in the resumed solve")
            solves.append(dict(
                solve=f"phase 14a checkpointed banded f64 lowest-{k} "
                f"every={CKPT_EVERY}", n=A.shape[0],
                iterations=ref.iterations, one_shot_wall_s=ref_wall,
                checkpointed_wall_s=full_wall, resumed_wall_s=resume_wall,
                resumed_from=saved, launches_one_shot=one_shot,
                launches_interrupted_and_resumed=launches, save_bytes=sizes,
                save_s=saves, restore_s=restores))
            del ref, res, resumed
            torch.cuda.empty_cache()

        # The profiler hooks around a warm lowest-3 solve.
        trace_dir = os.path.join(root, "trace")
        with profile_trace(trace_dir):
            with annotate("phase14-eigensolve"):
                fdtt.eigensolve(A, 3)
        files = os.listdir(trace_dir)
        _check(len(files) == 1, f"14a: trace files {files}")
        path = os.path.join(trace_dir, files[0])
        with open(path) as f:
            events = json_mod.load(f)["traceEvents"]
        k1_events = sum(1 for e in events if e.get("cat") == "kernel"
                        and "banded_spmm_kernel" in str(e.get("name")))
        spans = sum(1 for e in events
                    if e.get("name") == "phase14-eigensolve")
        print(f"  14a profile_trace: {os.path.getsize(path)} bytes, "
              f"{len(events)} events, {k1_events} of kernel 1, {spans} "
              "annotate spans", flush=True)
        _check(k1_events > 0 and spans > 0,
               "14a: the trace holds no kernel 1 event or no annotate span")

        # The NaN trap: one diagonal block of A set to NaN, then restored.
        r, s, bs = A.blocks.shape[0] // 2, A.bandwidth, A.blocks.shape[1]
        cols = slice(s * bs, (s + 1) * bs)
        kept = A.blocks[r, :, cols].clone()
        trapped = None
        A.blocks[r, :, cols] = float("nan")
        try:
            with nan_trap():
                fdtt.eigensolve(A, 3)
        except FloatingPointError as exc:
            trapped = str(exc)
        finally:
            A.blocks[r, :, cols] = kept
        print(f"  14a nan_trap on A with block ({r}, {s}) NaN: "
              f"FloatingPointError {trapped!r}", flush=True)
        _check(trapped is not None, "14a: the NaN trap did not raise")
        _check(torch.equal(A.blocks[r, :, cols], kept),
               "14a: A's block was not restored")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_sharded_refined(q, dev, rendezvous, solves, refs):
    """Phase 14b: phase 6b's refined stage (``REFINED`` from phase 6's
    loose vectors) row-sharded at world size 1 over NCCL: every apply,
    and each word of the polish's off-diagonal apply, through kernel 7's
    float32-x entry; iterations within ±2 of 6b's (the rank's fold is the
    tree, not the single-device cascade), the float64 oracle <= 1e-8,
    eigenvalues within 1e-9 relative of 6b's."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import eigensolve_sharded

    mesh = _one_rank_mesh(rendezvous, dev)
    X0, six = refs["int8"]["eigenvectors"], refs["refined"]
    k7 = kernels.banded_q_ext_bsr_spmm

    def sharded(op, k, second_matrix=None, **kw):
        return eigensolve_sharded(op, k, mesh, second_matrix=second_matrix,
                                  **kw)

    walls = []
    for turn in ("cold", "warm"):
        before = k7.launches - k7.f64_launches
        res, wall = _solve_converged(
            f"eigensolve_sharded(q, 20) refined [{turn}]", q, 20,
            solver=sharded, initial_vectors=X0, **REFINED)
        launches = k7.launches - k7.f64_launches - before
        walls.append(wall)
    lam = res.eigenvalues.double() + res.eigenvalues_lo.double()
    oracle = _int8_oracle_residual(q, res.eigenvectors, lam)
    diff = float(torch.max(torch.abs(lam - six["eigenvalues"])
                           / torch.clamp(torch.abs(six["eigenvalues"]),
                                         min=1.0)))
    busy = _device_busy("eigensolve_sharded(q, 20) refined",
                        lambda: sharded(q, 20, initial_vectors=X0,
                                        **REFINED))
    print(f"  14b sharded refined: iterations {res.iterations} (6b "
          f"{six['iterations']}), stalled={res.stalled}, kernel 7 float32-x "
          f"launches {launches} a solve; oracle relative residual "
          f"{oracle:.3e}; max |eig - eig_6b| / max(|eig|, 1) {diff:.3e}; "
          f"walls cold {walls[0]:.4f} s, warm {walls[1]:.4f} s (6b on one "
          f"device: {six['wall']:.4f} s here, 1.194 s in PR 13)", flush=True)
    _check(launches > 0, "14b: kernel 7's float32-x entry never launched")
    _check(abs(res.iterations - six["iterations"]) <= 2,
           f"14b: {res.iterations} iterations vs 6b's {six['iterations']}")
    _check(oracle <= REFINED["tolerance"],
           f"14b: oracle relative residual {oracle:.3e}")
    _check(diff <= 1e-9, f"14b: eigenvalues {diff:.3e} from 6b's")
    # Phase 16d holds the multi-GPU refined stage to this one.
    refs["sharded_refined"] = dict(iterations=res.iterations,
                                   eigenvalues=lam.clone(), wall=walls[1])
    solves.append(dict(
        solve="phase 14b sharded (world 1, nccl) int8 f32 lowest-20 "
        "refined + final_polish=3", n=q.shape[0], iterations=res.iterations,
        single_device_iterations=six["iterations"], stalled=res.stalled,
        wall_s=walls, single_device_wall_s=six["wall"],
        oracle_residual_rel=oracle, eig_diff_6b=diff, launches=launches,
        **busy))
    del res
    torch.cuda.empty_cache()


def phase_sharded_checkpoint(A, dev, rendezvous, solves, refs):
    """Phase 14c: ``eigensolve_checkpointed(..., mesh=mesh)`` through
    ``HaloBSROperator(A, "pallas")`` (kernel 6) at world size 1 over NCCL,
    lowest-3, interrupted after its first save and resumed: phase 8a's
    sharded lowest-3 iterations and eigenvalue bits, and kernel 6's
    launches of both runs those of the one-shot sharded solve."""
    import shutil
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.checkpoint import latest_step
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     eigensolve_sharded)

    mesh = _one_rank_mesh(rendezvous, dev)
    H = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas")
    eight = refs["sharded"][("Halo(A, pallas)", 3)]
    k6 = kernels.banded_ext_bsr_spmm

    def sharded(op, k, second_matrix=None, **kw):
        return eigensolve_sharded(op, k, mesh, second_matrix=second_matrix,
                                  **kw)

    before = k6.launches
    one, one_wall = _solve_converged("eigensolve_sharded(Halo(A), 3) "
                                     "[one-shot]", H, 3, solver=sharded,
                                     tolerance=SOLVE_TOL)
    one_shot = k6.launches - before
    root = _ckpt_root()
    cut = os.path.join(root, "sharded_cut")
    try:
        before = k6.launches
        try:
            fdtt.eigensolve_checkpointed(H, 3, cut, every=CKPT_EVERY,
                                         mesh=mesh, tolerance=SOLVE_TOL,
                                         callbacks=(_interrupt_once(),))
            interrupted = False
        except _Interrupt:
            interrupted = True
        saved = latest_step(cut)
        res, wall = _solve_converged(
            f"eigensolve_checkpointed(Halo(A), 3, mesh) resumed from "
            f"step_{saved}", H, 3,
            solver=_checkpointed(cut, CKPT_EVERY, mesh=mesh),
            tolerance=SOLVE_TOL)
        launches = k6.launches - before
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = (res.iterations == eight["iterations"]
            and torch.equal(res.eigenvalues, eight["eigenvalues"]))
    print(f"  14c sharded checkpoint: interrupted {interrupted} at "
          f"step_{saved}, resumed: {res.iterations} iterations (8a "
          f"{eight['iterations']}), 8a's eigenvalue bits {same}, one-shot "
          f"{_same_solve(res, one)}; kernel 6 launches one-shot {one_shot}, "
          f"interrupted + resumed {launches}; walls one-shot "
          f"{one_wall:.4f} s, resumed {wall:.4f} s", flush=True)
    _check(interrupted and saved == min(CKPT_EVERY, one.iterations),
           f"14c: interrupted {interrupted} at {saved}")
    _check(same, "14c: not phase 8a's iterations and eigenvalue bits")
    _check(_same_solve(res, one), "14c: not the one-shot sharded solve")
    _check(launches == one_shot, f"14c: {launches} kernel 6 launches "
           f"interrupted + resumed, {one_shot} one-shot")
    solves.append(dict(
        solve="phase 14c sharded (world 1, nccl) checkpoint Halo(A, pallas) "
        "f64 lowest-3", n=A.shape[0], iterations=res.iterations,
        resumed_from=saved, one_shot_wall_s=one_wall, resumed_wall_s=wall,
        launches_one_shot=one_shot, launches_interrupted_and_resumed=launches))
    del H, res, one
    torch.cuda.empty_cache()



# Phase 15: the rest of ROADMAP item 19 on one card, at world size 1.
# 15d: the matrix-free pencil at phase 6c's size.
FREE_PENCIL_N = 1_000_448
FREE_PENCIL_K = 4
NS_POLISH = 2


@contextlib.contextmanager
def _counting_applies(cls):
    """Count the calls of ``cls.matmat`` (every instance, ``offdiag()``'s
    too) inside the ``with`` block: ``calls[0]``."""
    calls = [0]
    matmat = cls.matmat

    def counted(self, block):
        calls[0] += 1
        return matmat(self, block)

    cls.matmat = counted
    try:
        yield calls
    finally:
        cls.matmat = matmat


def _no_launches(label) -> None:
    """Fail when any kernel launched since the last reset (a matrix-free
    phase runs no kernel)."""
    from fortran_davidson_tpu_torch.ops import kernels
    counts = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    print(f"  {label}: kernel launches {counts}", flush=True)
    _check(not any(counts.values()), f"{label}: a kernel launched")


def _sharded_solver(mesh):
    from fortran_davidson_tpu_torch.parallel import eigensolve_sharded

    def sharded(op, k, second_matrix=None, **kw):
        return eigensolve_sharded(op, k, mesh, second_matrix=second_matrix,
                                  **kw)
    return sharded


def phase_sharded_qr(A, dev, rendezvous, solves):
    """Phase 15c: ``orthonormalization="qr"`` row-sharded (the TSQR; at
    world size 1 its second stage is skipped) through
    ``HaloBSROperator(A, "pallas")`` (kernel 6), lowest-3 and lowest-20,
    beside the one-device ``"qr"`` solve through kernel 1: the same
    iterations and eigenvalue bits, kernel 6's launches the sharded
    solve's counted applies, true residuals <= 1e-8."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import HaloBSROperator

    mesh = _one_rank_mesh(rendezvous, dev)
    H = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas")
    k6 = kernels.banded_ext_bsr_spmm
    qr = dict(tolerance=SOLVE_TOL, orthonormalization="qr")
    for k in (3, 20):
        one, one_wall = _solve_converged(f"eigensolve(A, {k}) qr [one "
                                         "device, kernel 1]", A, k, **qr)
        before = k6.launches
        with _counting_applies(HaloBSROperator) as applies:
            res, wall = _solve_converged(
                f"eigensolve_sharded(Halo(A, pallas), {k}) qr", H, k,
                solver=_sharded_solver(mesh), **qr)
        launches = k6.launches - before
        same = torch.equal(res.eigenvalues, one.eigenvalues)
        true_res = _true_residual(A.blocks, 1, None, res.eigenvectors,
                                  res.eigenvalues)
        print(f"  15c sharded qr lowest-{k}: iterations {res.iterations} "
              f"(one device {one.iterations}), the one-device eigenvalue "
              f"bits {same}, kernel 6 launches {launches} for "
              f"{applies[0]} applies, true residual {true_res:.3e}; walls "
              f"{wall:.4f} s (one device {one_wall:.4f} s)", flush=True)
        _check(res.iterations == one.iterations,
               f"15c lowest-{k}: {res.iterations} iterations vs "
               f"{one.iterations}")
        _check(same, f"15c lowest-{k}: not the one-device qr bits")
        _check(launches == applies[0] > 0,
               f"15c lowest-{k}: {launches} kernel 6 launches for "
               f"{applies[0]} applies")
        _check(true_res <= SOLVE_TOL,
               f"15c lowest-{k}: true residual {true_res:.3e}")
        solves.append(dict(
            solve=f"phase 15c sharded (world 1, nccl) Halo(A, pallas) f64 "
            f"lowest-{k} orthonormalization=qr", n=A.shape[0],
            iterations=res.iterations, wall_s=wall, one_device_wall_s=one_wall,
            launches=launches, applies=applies[0], true_residual=true_res))
        del res, one
    del H
    torch.cuda.empty_cache()


def phase_free_pencil(dev, rendezvous, solves):
    """Phase 15d: the generalized matrix-free pencil (the float64
    surrogate and its overlap at ``FREE_PENCIL_N`` rows, lowest-4)
    row-sharded through the per-rank callables: the one-device pencil's
    iterations and eigenvalue bits, true residual <= 1e-8, no kernel."""
    import torch
    from fortran_davidson_tpu_torch.models import generators

    mesh = _one_rank_mesh(rendezvous, dev)
    A = generators.surrogate_hamiltonian(FREE_PENCIL_N, device=dev)
    B = generators.surrogate_overlap(FREE_PENCIL_N, device=dev)
    k = FREE_PENCIL_K
    one, one_wall = _solve_converged(
        f"eigensolve(surrogate, {k}, B=overlap) [one device]", A, k, B=B,
        tolerance=SOLVE_TOL)
    walls = []
    for tag in ("cold", "warm"):
        res, wall = _solve_converged(
            f"eigensolve_sharded(surrogate, {k}, B=overlap) [{tag}]", A, k,
            B=B, solver=_sharded_solver(mesh), tolerance=SOLVE_TOL)
        walls.append(wall)
    X = res.eigenvectors
    R = A.matmat(X) - B.matmat(X) * res.eigenvalues[None, :]
    true_res = float(torch.max(torch.linalg.vector_norm(R, dim=0)))
    same = torch.equal(res.eigenvalues, one.eigenvalues)
    print(f"  15d sharded matrix-free pencil n={FREE_PENCIL_N}: iterations "
          f"{res.iterations} (one device {one.iterations}), the one-device "
          f"eigenvalue bits {same}, true residual {true_res:.3e}; walls "
          f"cold {walls[0]:.4f} s, warm {walls[1]:.4f} s (one device "
          f"{one_wall:.4f} s)", flush=True)
    _check(res.iterations == one.iterations,
           f"15d: {res.iterations} iterations vs {one.iterations}")
    _check(same, "15d: not the one-device pencil's eigenvalue bits")
    _check(true_res <= SOLVE_TOL, f"15d: true residual {true_res:.3e}")
    _no_launches("15d")
    solves.append(dict(
        solve=f"phase 15d sharded (world 1, nccl) matrix-free pencil f64 "
        f"lowest-{k}", n=FREE_PENCIL_N, iterations=res.iterations,
        wall_s=walls, one_device_wall_s=one_wall, true_residual=true_res))
    del A, B, res, one, X, R
    torch.cuda.empty_cache()


def phase_northstar_free_sharded(dev, solves, ns):
    """Phase 15a: the surrogate north star row-sharded at full size
    (``examples/northstar.py --mode free --sharded``, a fresh one-rank
    NCCL group) under 10a's 12 GB budget (width 44): the float32
    ``--progressive --polish 2`` recipe (cold, warm, profiled) and the
    plain float64 DPR solve (cold, warm, profiled), through the
    per-rank callables: 10a's iterations (4; the refined 17), the float64
    eigenvalues within 1e-12 relative of 10a's, the oracle after the
    per-rank polish <= 1e-8, no kernel launched. Walls, idle shares and
    peak memory beside 10a's."""
    import torch
    import torch.distributed as dist
    from fortran_davidson_tpu_torch import polish_eigenpairs
    from fortran_davidson_tpu_torch.examples import northstar
    from fortran_davidson_tpu_torch.models import generators

    ten = ns["free"]
    tmp = tempfile.TemporaryDirectory()
    try:
        mesh = _one_rank_mesh(f"file://{tmp.name}/rendezvous", dev)
        args = northstar.parse_args(["--n", str(NS_FREE_N), *NORTHSTAR_ARGV,
                                     "--sharded", "--polish",
                                     str(NS_POLISH)])
        op = northstar.build_operator(args, device=mesh.device)
        with _env("FDT_CARRY_BUDGET_BYTES", JAX_NS_BUDGET):
            torch.cuda.empty_cache()
            width, m_max = _resolved_width(op, args)
            _check(width == JAX_NS_WIDTH, f"15a: width {width}")
            run = _northstar_run(f"sharded surrogate n={NS_FREE_N} lowest-20 "
                                 "progressive [parity width]", op, args,
                                 profile=True, mesh=mesh)
        res = run.pop("res")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pol = polish_eigenpairs(op, res, iterations=NS_POLISH, mesh=mesh)
        torch.cuda.synchronize()
        polish_s = time.perf_counter() - t0
        lam = pol.evals.double() + pol.evals_lo.double()
        oracle = _surrogate_oracle(
            op, pol.evecs_hi.double() + pol.evecs_lo.double(), lam)
        print(f"  15a f32: refined iterations {res.iterations} (10a "
              f"{ten['parity_iterations']}); cold / warm {run['cold_s']:.3f} "
              f"/ {run['warm_s']:.3f} s (10a {ten['parity']['cold_s']:.3f} / "
              f"{ten['parity']['warm_s']:.3f}), idle "
              f"{run['device_idle_share']:.1%} (10a "
              f"{ten['parity']['device_idle_share']:.1%}), peak "
              f"{run['peak_mem_gb']:.2f} GB (10a "
              f"{ten['parity']['peak_mem_gb']:.2f}); per-rank polish "
              f"({NS_POLISH} iterations) {polish_s:.3f} s, oracle "
              f"{oracle:.3e}, polished residuals "
              f"{[f'{float(e):.2e}' for e in pol.errors]}", flush=True)
        iterations = res.iterations
        _check(iterations == ten["parity_iterations"],
               f"15a f32: {iterations} refined iterations vs 10a's "
               f"{ten['parity_iterations']}")
        _check(oracle <= SOLVE_TOL, f"15a f32: oracle {oracle:.3e}")
        del res, pol
        op64 = generators.surrogate_hamiltonian(NS_FREE_N,
                                                dtype=torch.float64,
                                                device=mesh.device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        walls64 = []
        sharded = _sharded_solver(mesh)
        with _env("FDT_CARRY_BUDGET_BYTES", JAX_NS_BUDGET):
            for tag in ("cold", "warm"):
                res64, wall = _solve_converged(
                    f"sharded float64 surrogate n={NS_FREE_N} lowest-20 plain "
                    f"DPR [parity width, {tag}]", op64, 20, solver=sharded,
                    **F64_NORTHSTAR)
                walls64.append(wall)
            peak64 = torch.cuda.max_memory_allocated()
            busy64 = _device_busy(
                "sharded float64 surrogate lowest-20 [parity width]",
                lambda: sharded(op64, 20, **F64_NORTHSTAR))
        f64 = ten["f64"]
        rel64 = float(torch.max(torch.abs(res64.eigenvalues
                                          - f64["eigenvalues"])
                                / torch.abs(f64["eigenvalues"])))
        oracle64 = _surrogate_oracle(op64, res64.eigenvectors,
                                     res64.eigenvalues)
        print(f"  15a f64: iterations {res64.iterations} (10a "
              f"{f64['iterations']}), max relative eigenvalue diff from 10a "
              f"{rel64:.3e} (bits equal "
              f"{torch.equal(res64.eigenvalues, f64['eigenvalues'])}), "
              f"oracle {oracle64:.3e}; cold / warm {walls64[0]:.3f} / "
              f"{walls64[1]:.3f} s (10a {f64['wall_s'][0]:.3f} / "
              f"{f64['wall_s'][1]:.3f}), idle "
              f"{busy64['device_idle_share']:.1%} (10a "
              f"{f64['device_idle_share']:.1%}), peak {peak64 / 1e9:.2f} GB "
              f"(10a {f64['peak_mem_gb']:.2f})", flush=True)
        _check(res64.iterations == f64["iterations"],
               f"15a f64: {res64.iterations} iterations vs "
               f"{f64['iterations']}")
        _check(rel64 <= 1e-12, f"15a f64: eigenvalues {rel64:.3e} from 10a's")
        _check(oracle64 <= SOLVE_TOL, f"15a f64: oracle {oracle64:.3e}")
        _no_launches("15a")
        solves.append(dict(
            solve="phase 15a sharded (world 1, nccl) northstar surrogate f32 "
            f"lowest-20 progressive + polish {NS_POLISH} [parity width]",
            n=NS_FREE_N, iterations=iterations,
            ten_a_iterations=ten["parity_iterations"], polish_s=polish_s,
            oracle=oracle, ten_a=ten["parity"], **run))
        solves.append(dict(
            solve="phase 15a sharded (world 1, nccl) northstar surrogate f64 "
            "lowest-20 plain DPR [parity width]", n=NS_FREE_N,
            iterations=res64.iterations, wall_s=walls64,
            peak_mem_gb=peak64 / 1e9, peak_mem_above_gb=(peak64 - mem0) / 1e9,
            eig_rel_10a=rel64, oracle=oracle64, **busy64))
        del op, op64, res64
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()
    torch.cuda.empty_cache()


def phase_northstar_bsr_sharded(dev, solves, ns):
    """Phase 15b: phase 10b's 10,000,000-row int8 matrix (the same
    operator, not built again) row-sharded (``examples/northstar.py
    --mode banded --quantize --sharded --progressive --polish 2``, 10b's
    width, a fresh one-rank NCCL group): every apply through kernel 7
    (float32 x) on the ring exchange's x_ext, its launches the counted
    applies of the solves and the per-rank polish; refined iterations
    within ±2 of 10b's (the sharded path folds by the tree, 10b by the
    cascade), the oracle after the polish <= 1e-8, the solve's
    eigenvalues within 1e-10 relative of 10b's; then one kernel 7 call at
    the solve's shape (m = 20) against its plain version, within its
    phase-3 limit."""
    import torch
    import torch.distributed as dist
    from fortran_davidson_tpu_torch import polish_eigenpairs
    from fortran_davidson_tpu_torch.examples import northstar
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import HaloQuantizedOperator

    ten = ns.pop("bsr")
    q = ten["q"]
    k7 = kernels.banded_q_ext_bsr_spmm
    tmp = tempfile.TemporaryDirectory()
    try:
        mesh = _one_rank_mesh(f"file://{tmp.name}/rendezvous", dev)
        args = northstar.parse_args(
            ["--mode", "banded", "--quantize", "--n", str(NS_BSR_N),
             *NORTHSTAR_ARGV, "--sharded", "--polish", str(NS_POLISH),
             "--max-dim-sub", str(ten["width"])])
        before, before64 = k7.launches, k7.f64_launches
        with _counting_applies(HaloQuantizedOperator) as applies:
            run = _northstar_run(f"sharded int8 banded n={NS_BSR_N} "
                                 "lowest-20 progressive", q, args,
                                 profile=True, mesh=mesh)
            res = run.pop("res")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pol = polish_eigenpairs(q, res, iterations=NS_POLISH, mesh=mesh)
            torch.cuda.synchronize()
            polish_s = time.perf_counter() - t0
        launches = k7.launches - before
        f64_launches = k7.f64_launches - before64
        lam_solve = res.eigenvalues.double() + res.eigenvalues_lo.double()
        rel = float(torch.max(torch.abs(lam_solve - ten["lam"])
                              / torch.abs(ten["lam"])))
        lam = pol.evals.double() + pol.evals_lo.double()
        oracle = _int8_oracle_residual(
            q, pol.evecs_hi.double() + pol.evecs_lo.double(), lam)
        print(f"  15b: refined iterations {res.iterations} (10b "
              f"{ten['iterations']}), stalled={res.stalled}; kernel 7 "
              f"launches {launches} for {applies[0]} counted applies (three "
              f"runs and the polish; float64-x {f64_launches}); eigenvalues "
              f"{rel:.3e} relative from 10b's; per-rank polish "
              f"({NS_POLISH} iterations) {polish_s:.3f} s, oracle "
              f"{oracle:.3e}; cold / warm {run['cold_s']:.3f} / "
              f"{run['warm_s']:.3f} s (10b {ten['run']['cold_s']:.3f} / "
              f"{ten['run']['warm_s']:.3f}), idle "
              f"{run['device_idle_share']:.1%} (10b "
              f"{ten['run']['device_idle_share']:.1%}), peak "
              f"{run['peak_mem_gb']:.2f} GB (10b "
              f"{ten['run']['peak_mem_gb']:.2f})", flush=True)
        _check(launches == applies[0] > 0 and f64_launches == 0,
               f"15b: {launches} kernel 7 launches ({f64_launches} float64-x) "
               f"for {applies[0]} applies")
        _check(abs(res.iterations - ten["iterations"]) <= 2,
               f"15b: {res.iterations} iterations vs 10b's "
               f"{ten['iterations']}")
        _check(rel <= 1e-10, f"15b: eigenvalues {rel:.3e} from 10b's")
        _check(oracle <= SOLVE_TOL, f"15b: oracle {oracle:.3e}")
        # Phase 16c's one-device iteration time: the example's own
        # ms/iter, the warm run over its refined iterations.
        ns["t_iter_15b"] = run["warm_s"] / res.iterations
        solves.append(dict(
            solve="phase 15b sharded (world 1, nccl) northstar int8 banded f32 "
            f"lowest-20 progressive + polish {NS_POLISH}", n=NS_BSR_N,
            iterations=res.iterations, ten_b_iterations=ten["iterations"],
            stalled=res.stalled, launches=launches, applies=applies[0],
            eig_rel_10b=rel, polish_s=polish_s, oracle_residual_rel=oracle,
            ten_b=ten["run"], **run))
        del res, pol
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()
    # Kept for the kernel 7 check at this size (``kernel7_at_10m``), which
    # runs outside the counted path, and for phase 16a's inventory.
    ns["q"] = q
    del q, ten
    torch.cuda.empty_cache()


def kernel7_at_10m(q, dev, solves) -> None:
    """One kernel 7 call at phase 15b's shape (10b's operator, float32 x,
    m = 20, the x_ext the ring exchange builds at world size 1) against
    its plain version, within its phase-3 limit; outside every counted
    path, as phase 3's comparisons are."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import (HaloQuantizedOperator,
                                                     RowMesh)

    # World size 1: the exchange calls no collective, so no group is needed.
    mesh = RowMesh(group=None, size=1, rank=0, device=dev)
    h = HaloQuantizedOperator.from_quantized(q, mesh)
    x = torch.randn((q.shape[0], 20), dtype=torch.float32, device=dev)
    prev, nxt, _ = mesh.ring_exchange(x, q.bandwidth * q.block_size)
    x_ext = torch.cat([prev, x, nxt])
    del x
    lead = (h.qblocks, h.scale_rows, h.diag)
    y = kernels.banded_q_ext_bsr_spmm(*lead, x_ext, bandwidth=q.bandwidth)
    y_p = kernels.banded_q_ext_bsr_spmm_plain(*lead, x_ext,
                                              bandwidth=q.bandwidth)
    err = float(torch.max(torch.abs(y.double() - y_p.double())))
    rel = err / float(torch.max(torch.abs(y_p.double())))
    print(f"  15b kernel 7 at n={q.shape[0]} m=20 against its plain version: "
          f"max abs err {err:.3e}, relative {rel:.3e} (limit "
          f"{TOL['float32']})", flush=True)
    _check(rel <= TOL["float32"], f"15b: kernel 7 rel err {rel:.3e}")
    solves.append(dict(solve="phase 15b kernel 7 at n=10,000,000 m=20 "
                       "against its plain version", max_abs_err=err,
                       rel_err=rel))
    del h, x_ext, y, y_p
    torch.cuda.empty_cache()


# Phase 16 (parallel/scaling.py): the collective inventory of one solver
# iteration (``scaling.iteration_inventory``) of each sharding rule at two
# row counts on the one-rank NCCL group, the N-GPU projection from it, the
# run on two and four GPUs where the host has them, and the one-device
# sum_strategy A/B. The probe's options (lowest-20, float32, refined,
# max_dim_sub 44: the JAX probe's) for the int8 and matrix-free rules;
# P16_F64 for the float64 ones.
P16_LOWEST = 20
P16_F64 = dict(method="DPR", tolerance=SOLVE_TOL, expansion="lowest-k",
               max_dim_sub=44)
# Phase 4's matrix's sibling: 4,096 block rows of 128, n = 524,288.
P16_SIBLING_NBR = 4096
# The gathering rules' row counts: dense; ELL, sliced ELL and the hybrid
# from phase 12's COO recipe (LOCAL_ARGS) at these orders.
P16_DENSE_N = (4096, 8192)
P16_COO_N = (65536, 131072)
# all_reduce calls timed for the latency of one, and the GPU counts of the
# projection.
P16_LATENCY_CALLS = 50
P16_CHIPS = (2, 4, 8)
# Phase 16d's matrices: phase 4's (f64, kernel 8) and phase 6's (int8).
P16_MULTI = dict(nbr=8192, bs=128, q_nbr=16384)
# The f64 halo rules' iteration at both row counts, as the ring exchange
# recorded it before the push route existed: bytes and calls, each rank's
# at any world size.
P16_HALO_BYTES = [73760, 73760]
P16_HALO_CALLS = [12, 12]
# Phase 17's widths (phase 9's).
P17_WIDTHS = (20, 40, 160)


def _print_inventory(label, stats) -> None:
    kinds = ", ".join(f"{k} {v['count']} x, {v['bytes']} B"
                      for k, v in stats["by_kind"].items())
    print(f"  16 {label}: n={stats['n']} width {stats['width']} m_max "
          f"{stats['m_max']}: {stats['total_bytes']} B in "
          f"{stats['total_count']} calls ({kinds}); m_max ceiling "
          f"{stats['m_max_ceiling_bytes']} B; largest "
          f"{stats['largest'][:2]}; ring exchanges {stats['exchanges']}, "
          f"kernel launches {stats['launches']}", flush=True)


def _hold_launches(label, launches: dict, exchanges: int, kernel: str,
                   per_exchange: int) -> None:
    """A halo rule's iteration: ``per_exchange`` launches of ``kernel`` an
    exchange (one exchange an apply), and no other kernel."""
    _check(exchanges > 0 and launches == {kernel: per_exchange * exchanges},
           f"16 {label}: launches {launches} for {exchanges} exchanges")


def _all_reduce_latency(mesh, stats) -> float:
    """Median host seconds of one ``mesh.all_reduce`` (synchronised) of
    the inventory's largest payload."""
    import torch
    rec = max(stats["records"], key=lambda r: r.bytes)
    t = torch.zeros(rec.shape, dtype=rec.dtype, device=mesh.device)
    stats["latency_payload"] = f"{rec.bytes} B {rec.dtype} {rec.shape}"
    for _ in range(5):
        mesh.all_reduce(t)
    times = []
    for _ in range(P16_LATENCY_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.all_reduce(t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase16_int8(q, dev, rendezvous, solves, p16):
    """Phase 16a at 2,097,152 rows: one refined iteration of phase 6's
    int8 matrix row-sharded (kernel 7) recorded; kernel 7's launches the
    ring exchanges; the latency of one all_reduce of its largest payload
    (16c's)."""
    from fortran_davidson_tpu_torch.parallel import scaling
    mesh = _one_rank_mesh(rendezvous, dev)
    stats = scaling.iteration_inventory(q, mesh, P16_LOWEST,
                                        **scaling.probe_options())
    _print_inventory("a int8 (kernel 7)", stats)
    _hold_launches("a int8", stats["launches"], stats["exchanges"],
                   "banded_q_ext_bsr_spmm", 1)
    latency = _all_reduce_latency(mesh, stats)
    print(f"  16c latency: {latency * 1e6:.1f} us median host time of one "
          f"all_reduce of the largest payload ({stats['latency_payload']}) "
          f"over {P16_LATENCY_CALLS} calls on the one-rank NCCL group (a "
          "lower bound: nothing crosses a wire)", flush=True)
    p16.update(int8_2m=stats, latency_s=latency)
    solves.append(dict(solve="phase 16a inventory int8 refined iteration",
                       **_inventory_json(stats),
                       all_reduce_latency_s=latency))


def _inventory_json(stats) -> dict:
    return {k: v for k, v in stats.items() if k != "records"}


def phase16_rules(A, dev, rendezvous, solves, refs, p16):
    """Phase 16b: the per-rule report (``scaling.rule_report``) on the
    one-rank NCCL group: row-local the f64 halo operator through
    ``"pallas"`` (kernel 6) and ``"pallas-remote"`` (kernel 8's push, one
    launch an exchange; the two rules' inventories one, the exchange's),
    phase
    4's matrix and its 524,288-row sibling, each launch a ring
    exchange's, and
    15a's surrogate at 5,000,192 and 10,000,384 rows (no kernel); n-scale
    the rules that gather x: dense, general BSR (phase 4's matrix, kernel
    2), ELL, sliced ELL and the hybrid's remainder (phase 12's recipe)."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.models import generators
    from fortran_davidson_tpu_torch.ops import sparse
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     scaling)
    mesh = _one_rank_mesh(rendezvous, dev)
    sib = fdtt.generate_banded_bsr(P16_SIBLING_NBR, 128, bandwidth=1,
                                   coupling=1e-3, seed=0,
                                   dtype=torch.float64, device=dev)
    probe = scaling.probe_options()

    def halo(backend):
        return lambda op: HaloBSROperator.from_bsr(op, 1, mesh,
                                                   backend=backend)

    def coo(n, build):
        return build(*sparse.generate_local_sparse(n, **LOCAL_ARGS), n)

    def free(n):
        return generators.surrogate_hamiltonian(n, dtype=torch.float32,
                                                device=dev)
    rules = [
        ("halo f64 pallas (kernel 6)", halo("pallas"), (sib, A), True,
         P16_F64, ("banded_ext_bsr_spmm", 1)),
        ("halo f64 pallas-remote (kernel 8's push)", halo("pallas-remote"),
         (sib, A), True, P16_F64, ("banded_remote_push_spmm", 1)),
        ("matrix-free surrogate (15a)", free,
         (NS_FREE_N // 2, NS_FREE_N), True, probe, None),
        ("dense", lambda n: fdtt.generate_banded_bsr(
            n // 128, 128, bandwidth=1, coupling=1e-3, seed=0,
            dtype=torch.float64, device=dev).to_dense(), P16_DENSE_N, False,
         P16_F64, None),
        ("general BSR (kernel 2)", lambda op: op, (sib, A), False, P16_F64,
         None),
        ("ELL", lambda n: coo(n, lambda *c: fdtt.ELLOperator.from_coo(
            *c, device=dev)), P16_COO_N, False, P16_F64, None),
        ("sliced ELL", lambda n: coo(n, lambda *c: (
            fdtt.SlicedELLOperator.from_coo(*c, device=dev))), P16_COO_N,
         False, P16_F64, None),
        ("hybrid band + remainder (kernel 2)", lambda n: coo(
            n, lambda *c: fdtt.split_band_remainder(
                *c, block_size=128, bandwidth=1, device=dev)), P16_COO_N,
         False, P16_F64, None),
    ]
    reports = []
    for rule, build, sizes, local, opts, held in rules:
        t0 = time.perf_counter()
        rep = scaling.rule_report(rule, build(sizes[0]), build(sizes[1]),
                                  mesh, local, P16_LOWEST, **opts)
        torch.cuda.empty_cache()
        kinds = "; ".join(", ".join(f"{k} {v['count']} x {v['bytes']} B"
                                    for k, v in bk.items())
                          for bk in rep["by_kind"])
        print(f"  16b {rule}: n={rep['n']} "
              f"{'row-local' if rep['row_local'] else 'n-scale'}, "
              f"{rep['total_bytes']} B an iteration, "
              f"{rep['bytes_per_row']:.1f} B a row more; by kind {kinds}; "
              f"exchanges {rep['exchanges']}, launches {rep['launches']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if held is not None:
            for launches, exchanges in zip(rep["launches"],
                                           rep["exchanges"]):
                _hold_launches(f"b {rule}", launches, exchanges, *held)
        reports.append(rep)
    del sib
    torch.cuda.empty_cache()
    # The push moves the rows the exchange moved and is recorded as it:
    # the two halo rules' inventories are one, ``P16_HALO_BYTES``.
    pallas, remote = reports[0], reports[1]
    _check(remote["by_kind"] == pallas["by_kind"]
           and remote["total_bytes"] == P16_HALO_BYTES
           and remote["total_count"] == P16_HALO_CALLS,
           f"16b: the push route's inventory {remote['by_kind']} "
           f"({remote['total_bytes']} B in {remote['total_count']} calls) is "
           f"not the exchange's {pallas['by_kind']}")
    one = refs["sharded"][("Halo(A, pallas)", 20)]
    p16.update(rules=reports, t_iter_8a=one["wall"] / one["iterations"])
    solves.append(dict(solve="phase 16b per-rule inventory",
                       rules=reports))


def _projections(t_iter, total_bytes, total_count, latency) -> list:
    from fortran_davidson_tpu_torch.parallel import scaling
    return [scaling.projected_efficiency(t_iter, total_bytes, total_count, c,
                                         latency_s=latency)
            for c in P16_CHIPS]


def phase16_northstar(dev, solves, ns, p16):
    """Phase 16a at 10,000,000 rows: one refined iteration of 10b's int8
    matrix (the same object) row-sharded on a fresh one-rank NCCL group
    (kernel 7): the 2,097,152-row inventory's bytes and calls, no tall
    collective, kernel 7's launches the exchanges; then 16c: the projected
    efficiency on 2, 4 and 8 GPUs of 15b's north star and of 8a's
    lowest-20 from this run's one-device iteration times, the latency 16a
    measured and NVLink 4's published 450 GB/s (a model)."""
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.parallel import scaling
    q = ns.pop("q")
    tmp = tempfile.TemporaryDirectory()
    try:
        mesh = _one_rank_mesh(f"file://{tmp.name}/rendezvous", dev)
        stats = scaling.iteration_inventory(q, mesh, P16_LOWEST,
                                            **scaling.probe_options())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()
    del q
    _print_inventory("a int8 (kernel 7)", stats)
    _hold_launches("a int8 10M", stats["launches"], stats["exchanges"],
                   "banded_q_ext_bsr_spmm", 1)
    small = p16["int8_2m"]
    scaling.assert_n_independent(small, stats)
    scaling.audit_no_tall_collectives(small, small["n_local"],
                                      small["m_max"])
    scaling.audit_no_tall_collectives(stats, stats["n_local"],
                                      stats["m_max"])
    print(f"  16a: the inventories at n={small['n']} and n={stats['n']} are "
          f"byte-identical ({stats['total_bytes']} B in "
          f"{stats['total_count']} calls an iteration), no tall collective",
          flush=True)
    pallas = next(r for r in p16["rules"] if "pallas (" in r["rule"])
    cases = [("15b int8 north star n=10,000,000", ns["t_iter_15b"],
              stats["total_bytes"], stats["total_count"]),
             ("8a f64 lowest-20 n=1,048,576 (pallas)", p16["t_iter_8a"],
              pallas["total_bytes"][1], pallas["total_count"][1])]
    out = []
    for label, t_iter, b, count in cases:
        proj = _projections(t_iter, b, count, p16["latency_s"])
        print(f"  16c projection (a model: NVLink 4 at "
              f"{scaling.NVLINK_GBPS_PER_GPU:.0f} GB/s published, latency "
              f"{p16['latency_s'] * 1e6:.1f} us measured on one rank) of "
              f"{label}: t_iter {t_iter * 1e3:.2f} ms measured, {b} B in "
              f"{count} calls an iteration: efficiency "
              + ", ".join(f"{p['chips']} GPUs {p['efficiency']:.4f} (comm "
                          f"{p['comm_s'] * 1e3:.3f} ms)" for p in proj),
              flush=True)
        out.append(dict(case=label, t_iter_s=t_iter, bytes=b, calls=count,
                        projections=proj))
    solves.append(dict(solve="phase 16a inventory int8 refined iteration",
                       **_inventory_json(stats)))
    solves.append(dict(solve="phase 16c projection (model)",
                       latency_s=p16["latency_s"],
                       nvlink_gbps=scaling.NVLINK_GBPS_PER_GPU, cases=out))


def phase_sum_strategy(q, dev, solves, refs):
    """Phase 16e: phase 6b's refined stage on one device under
    ``sum_strategy("tree")`` beside the default cascade, warm solves in
    turns (cascade, tree, tree, cascade) and one profiled each:
    iterations, the oracle, the warm wall, the idle share and the device
    ops. It measures; no default changes."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.utils import ds
    X0 = refs["int8"]["eigenvectors"]
    runs = {"cascade": [], "tree": []}
    out = {}
    for strategy in ("tree", "cascade", "tree", "tree", "cascade"):
        with ds.sum_strategy(strategy):
            res, wall = _solve_converged(
                f"int8 refined lowest-20 [sum_strategy {strategy}]", q, 20,
                initial_vectors=X0, **REFINED)
        runs[strategy].append(wall)
        lam = res.eigenvalues.double() + res.eigenvalues_lo.double()
        out[strategy] = dict(iterations=res.iterations, lam=lam,
                             oracle=_int8_oracle_residual(
                                 q, res.eigenvectors, lam))
        del res
    for strategy in ("cascade", "tree"):
        with ds.sum_strategy(strategy):
            out[strategy].update(_device_busy(
                f"int8 refined lowest-20 [sum_strategy {strategy}]",
                lambda: fdtt.eigensolve(q, 20, initial_vectors=X0,
                                        **REFINED)))
    diff = float(torch.max(torch.abs(out["tree"]["lam"]
                                     - out["cascade"]["lam"])
                           / torch.clamp(torch.abs(out["cascade"]["lam"]),
                                         min=1.0)))
    for strategy, o in out.items():
        warm = statistics.median(runs[strategy][-2:])
        print(f"  16e {strategy}: iterations {o['iterations']}, oracle "
              f"{o['oracle']:.3e}, warm wall {warm:.4f} s (runs "
              f"{[round(w, 4) for w in runs[strategy]]}), idle share "
              f"{o['device_idle_share']:.1%}, device ops {o['device_ops']}",
              flush=True)
        _check(o["oracle"] <= REFINED["tolerance"],
               f"16e {strategy}: oracle {o['oracle']:.3e}")
        solves.append(dict(
            solve=f"phase 16e int8 refined lowest-20 sum_strategy "
            f"{strategy}", n=q.shape[0], iterations=o["iterations"],
            wall_s=runs[strategy], oracle_residual_rel=o["oracle"],
            **{k: v for k, v in o.items()
               if k not in ("lam", "iterations", "oracle")}))
    print(f"  16e: max |eig_tree - eig_cascade| / max(|eig|, 1) {diff:.3e}",
          flush=True)
    _check(diff <= out["tree"]["oracle"] + out["cascade"]["oracle"],
           f"16e: eigenvalues differ by {diff:.3e}")
    torch.cuda.empty_cache()


def phase17_push(A, dev, rendezvous, solves, refs):
    """Phase 17: kernel 8's push route at world size 1 on the one-rank NCCL
    group. ``HaloBSROperator(A, backend="pallas-remote")`` must take
    ``"push"`` (one card: the rank is its own neighbour); its lowest-3 and
    lowest-20 give phase 4's iterations and eigenvalues within 1e-10, with
    one ``banded_remote_push_spmm`` launch a counted apply, no NCCL
    point-to-point call and no launch of kernel 8's two-launch form. The
    exchange route, which meshes that span hosts take, runs its own branch
    (``HaloBSROperator._apply_exchange``) through the lowest-3 on an
    instance set to it (no argument selects a route): phase 4's iterations
    and eigenvalues, two launches of kernel 8's two-launch form a counted
    apply and no push. At ``P17_WIDTHS`` one apply gives the ``"pallas"``
    apply's bits and the exchange route's, and both are timed with CUDA
    events in turns (push, exchange, exchange, push) beside the push's
    bound."""
    import torch
    import torch.distributed as dist
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     eigensolve_sharded)

    mesh = _one_rank_mesh(rendezvous, dev)
    R = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas-remote")
    P = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas")
    print(f"  route: {R.route} (pallas: {P.route})", flush=True)
    _check(R.route == "push", f"one card's route is {R.route!r}")
    p2p = [0]
    batch = dist.batch_isend_irecv

    def counted_p2p(ops):
        p2p[0] += 1
        return batch(ops)
    for k in (3, 20):
        dist.batch_isend_irecv = counted_p2p
        before = (kernels.banded_remote_push_spmm.launches,
                  kernels.banded_remote_halo_spmm.launches)
        try:
            with _counting_applies(HaloBSROperator) as applies:
                res, wall = _solve_converged(
                    f"eigensolve_sharded(Halo(A, pallas-remote, push), {k})",
                    R, k, solver=_sharded_solver(mesh), tolerance=SOLVE_TOL)
        finally:
            dist.batch_isend_irecv = batch
        pushes = kernels.banded_remote_push_spmm.launches - before[0]
        halo = kernels.banded_remote_halo_spmm.launches - before[1]
        diff = float(torch.max(torch.abs(res.eigenvalues
                                         - refs[k]["eigenvalues"])))
        print(f"  17 lowest-{k}: iterations {res.iterations} (phase 4 "
              f"{refs[k]['iterations']}), eigenvalue diff {diff:.3e}; "
              f"{applies[0]} applies, {pushes} push launches, {halo} "
              f"two-launch launches, {p2p[0]} NCCL p2p calls; wall "
              f"{wall:.4f} s", flush=True)
        _check(res.iterations == refs[k]["iterations"] and diff <= 1e-10,
               f"17 lowest-{k}: {res.iterations} iterations, eigenvalues "
               f"{diff:.3e} from phase 4's")
        _check(applies[0] > 0 and pushes == applies[0] and halo == 0
               and p2p[0] == 0, f"17 lowest-{k}: {applies[0]} applies, "
               f"{pushes} pushes, {halo} two-launch launches, {p2p[0]} p2p")
        solves.append(dict(solve=f"phase 17 push route f64 lowest-{k}",
                           iterations=res.iterations, wall_s=wall,
                           eig_diff_phase4=diff, applies=applies[0],
                           push_launches=pushes, p2p_calls=p2p[0]))
        del res
    E = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas-remote")
    E.route = "exchange"
    before = (kernels.banded_remote_push_spmm.launches,
              kernels.banded_remote_halo_spmm.launches)
    with _counting_applies(HaloBSROperator) as applies:
        res, wall = _solve_converged(
            "eigensolve_sharded(Halo(A, pallas-remote, exchange), 3)", E, 3,
            solver=_sharded_solver(mesh), tolerance=SOLVE_TOL)
    pushes = kernels.banded_remote_push_spmm.launches - before[0]
    halo = kernels.banded_remote_halo_spmm.launches - before[1]
    diff = float(torch.max(torch.abs(res.eigenvalues - refs[3]["eigenvalues"])))
    print(f"  17 exchange route lowest-3: iterations {res.iterations} (phase "
          f"4 {refs[3]['iterations']}), eigenvalue diff {diff:.3e}; "
          f"{applies[0]} applies, {halo} two-launch launches, {pushes} push "
          f"launches; wall {wall:.4f} s", flush=True)
    _check(res.iterations == refs[3]["iterations"] and diff <= 1e-10,
           f"17 exchange route lowest-3: {res.iterations} iterations, "
           f"eigenvalues {diff:.3e} from phase 4's")
    _check(applies[0] > 0 and halo == 2 * applies[0] and pushes == 0,
           f"17 exchange route: {applies[0]} applies, {halo} two-launch "
           f"launches, {pushes} pushes")
    solves.append(dict(solve="phase 17 exchange route f64 lowest-3",
                       iterations=res.iterations, wall_s=wall,
                       eig_diff_phase4=diff, applies=applies[0],
                       two_launch_launches=halo))
    del res, E
    nnz = _nonzero_blocks(A.blocks, 2 * A.bandwidth + 1)
    for m in P17_WIDTHS:
        x = torch.randn((A.shape[0], m), dtype=torch.float64, device=dev)
        y = R.matmat(x)
        same = (torch.equal(y, P.matmat(x)),
                torch.equal(y, R._apply_exchange(x, R.blocks)))
        row = dict(solve=f"phase 17 apply f64 m={m}: push vs exchange",
                   same_bits_pallas=same[0], same_bits_exchange=same[1])
        for turn, (key, fn) in enumerate((
                ("push", lambda: R.matmat(x)),
                ("exchange", lambda: R._apply_exchange(x, R.blocks)),
                ("exchange", lambda: R._apply_exchange(x, R.blocks)),
                ("push", lambda: R.matmat(x)))):
            row[f"{key}_{turn}_ms"] = _time_ms(fn)
        row["bound_ms"], row["bound_by"] = _bound(
            "banded_remote_push_spmm", "float64", m, None, _shape_of(A), nnz)
        print("  " + ", ".join(f"{k_}={v:.4f}" if isinstance(v, float)
                               else f"{k_}={v}" for k_, v in row.items()),
              flush=True)
        _check(all(same), f"17 m={m}: the push apply's bits differ from "
               f"pallas's / the exchange route's: {same}")
        solves.append(row)
        del x, y
    R._push["window"].raise_if_faulted()
    del R, P
    torch.cuda.empty_cache()


def _rank16(rank: int, world: int, tmp: str, cfg: dict) -> None:
    """A rank of phase 16d: phase 8b's lowest-20 through
    ``"pallas-remote"`` (kernel 8 on the route the ranks' topology gives:
    ``"push"`` over NVLink peers) and phase 14b's refined stage through
    kernel 7 on ``world`` GPUs over NCCL, two solves each, then one
    recorded iteration of each, and one f64 apply at m = 40 of the push
    route and of the exchange route (``HaloBSROperator._apply_exchange``)
    timed in turns;
    each rank writes its results to ``tmp/world<W>_rank<r>.json``."""
    import torch
    import torch.distributed as dist
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     eigensolve_sharded,
                                                     multihost, scaling)
    dev = torch.device(cfg["device"], rank)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else lambda: None)
    mesh = multihost.initialize(
        init_method=f"file://{tmp}/rendezvous{world}", world_size=world,
        rank=rank, device=dev)
    out = {}

    def timed(op, **kw):
        walls = []
        for _ in range(2):
            mesh.barrier()
            sync()
            t0 = time.perf_counter()
            res = eigensolve_sharded(op, P16_LOWEST, mesh, **kw)
            sync()
            mesh.barrier()
            walls.append(time.perf_counter() - t0)
        return res, walls

    try:
        A = fdtt.generate_banded_bsr(cfg["nbr"], cfg["bs"], bandwidth=1,
                                     coupling=1e-3, seed=0,
                                     dtype=torch.float64, device=dev)
        R = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas-remote")
        del A
        res, walls = timed(R, tolerance=SOLVE_TOL)
        stats = scaling.iteration_inventory(R, mesh, P16_LOWEST, **P16_F64)
        out["remote"] = dict(iterations=res.iterations, walls=walls,
                             eigenvalues=res.eigenvalues.tolist(),
                             by_kind=stats["by_kind"], route=R.route,
                             launches={fn.__name__: fn.launches
                                       for fn in kernels.KERNELS})
        # One apply of each route in turns (every rank the same calls).
        x = torch.randn((R.blocks.shape[0] * R.block_size, 40),
                        dtype=torch.float64, device=dev)
        same = torch.equal(R.matmat(x), R._apply_exchange(x, R.blocks))
        apply_ms = {}
        for turn, (key, fn) in enumerate((
                ("push", lambda: R.matmat(x)),
                ("exchange", lambda: R._apply_exchange(x, R.blocks)),
                ("exchange", lambda: R._apply_exchange(x, R.blocks)),
                ("push", lambda: R.matmat(x)))):
            mesh.barrier()
            apply_ms[f"{key}_{turn}"] = _time_ms(fn)
        out["apply_m40"] = dict(same_bits=same, ms=apply_ms)
        R._push["window"].raise_if_faulted()
        del R, res, x
        q = fdtt.generate_banded_bsr_quantized(cfg["q_nbr"], cfg["bs"],
                                               device=dev)
        X0 = torch.load(os.path.join(tmp, "x0.pt")).to(dev)
        res, walls = timed(q, initial_vectors=X0, **REFINED)
        stats = scaling.iteration_inventory(q, mesh, P16_LOWEST,
                                            **scaling.probe_options())
        lam = res.eigenvalues.double() + res.eigenvalues_lo.double()
        out["refined"] = dict(iterations=res.iterations, walls=walls,
                              eigenvalues=lam.tolist(),
                              by_kind=stats["by_kind"])
        out["launches"] = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"world{world}_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _same_per_rank(by_kind, one, world) -> bool:
    """A rank's inventory at ``world`` ranks (``by_kind``) is ``one``'s
    (one rank): the same calls of each kind, the same bytes, but the
    all-gathers of the ranks' partials, ``world`` times as large."""
    return by_kind.keys() == one.keys() and all(
        by_kind[k]["count"] == one[k]["count"]
        and by_kind[k]["bytes"] == (world if k == "all-gather" else 1)
        * one[k]["bytes"] for k in one)


def phase16_multi_gpu(dev, solves, refs, p16) -> None:
    """Phase 16d: with two or more GPUs visible, phase 8b's lowest-20
    (kernel 8 on the push route, which the route rule must pick) and phase
    14b's refined stage (kernel 7) at world size 2 (and 4 with four GPUs)
    over NCCL: world 1's iterations (the refined stage ±1), eigenvalues
    within 1e-12 relative, each rank's recorded bytes 16b's and 16a's
    inventories (the partials' all-gathers W times as large; printed a
    rank), the measured efficiency beside the projection, kernel 8's push
    launched and its two-launch form not, and one apply of each route
    (rank 0's times). With one GPU it prints that it did not run."""
    import torch
    import torch.multiprocessing as mp
    count = torch.cuda.device_count()
    if count < 2:
        print(f"  16d did not run: {count} GPU visible "
              f"({torch.cuda.get_device_name(0)}); it needs two or more",
              flush=True)
        solves.append(dict(solve="phase 16d multi-GPU", ran=False,
                           gpus=count))
        return
    remote = next(r for r in p16["rules"] if "remote" in r["rule"])
    one = {"remote": (refs["sharded"][("Halo(A, pallas-remote)", 20)],
                      remote["by_kind"][1]),
           "refined": (refs["sharded_refined"],
                       p16["int8_2m"]["by_kind"])}
    cfg = dict(device=dev.type, **P16_MULTI)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(refs["int8"]["eigenvectors"].cpu(),
                   os.path.join(tmp, "x0.pt"))
        for world in (2, 4) if count >= 4 else (2,):
            mp.spawn(_rank16, args=(world, tmp, cfg), nprocs=world,
                     join=True)
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"world{world}_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            got = ranks[0]
            for r, g_r in enumerate(ranks):
                for case in one:
                    kinds = ", ".join(f"{k} {v['count']} x {v['bytes']} B"
                                      for k, v in g_r[case]["by_kind"].items())
                    print(f"  16d world {world} rank {r} {case}: {kinds}",
                          flush=True)
                    _check(_same_per_rank(g_r[case]["by_kind"], one[case][1],
                                          world),
                           f"16d world {world} rank {r} {case}: inventory")
                launches = g_r["remote"]["launches"]
                print(f"  16d world {world} rank {r}: route "
                      f"{g_r['remote']['route']}, the solves' launches "
                      f"{launches}; one apply f64 m=40 (ms) "
                      f"{g_r['apply_m40']}", flush=True)
                _check(g_r["remote"]["route"] == "push"
                       and launches["banded_remote_push_spmm"] > 0
                       and launches["banded_remote_halo_spmm"] == 0
                       and g_r["apply_m40"]["same_bits"],
                       f"16d world {world} rank {r}: route "
                       f"{g_r['remote']['route']}, launches {launches}")
            for case, (ref, kinds1) in one.items():
                g = got[case]
                lam = torch.tensor(g["eigenvalues"], dtype=torch.float64)
                lam1 = ref["eigenvalues"].double().cpu()
                rel = float(torch.max(torch.abs(lam - lam1)
                                      / torch.abs(lam1)))
                t_w = min(g["walls"])
                eff = ref["wall"] / (world * t_w)
                t_iter = ref["wall"] / ref["iterations"]
                stats = p16["int8_2m"] if case == "refined" else dict(
                    total_bytes=remote["total_bytes"][1],
                    total_count=remote["total_count"][1])
                proj = _projections(t_iter, stats["total_bytes"],
                                    stats["total_count"],
                                    p16["latency_s"])
                proj_w = next((p["efficiency"] for p in proj
                               if p["chips"] == world), None)
                same = _same_per_rank(g["by_kind"], kinds1, world)
                print(f"  16d world {world} {case}: iterations "
                      f"{g['iterations']} (world 1 {ref['iterations']}), "
                      f"eigenvalues {rel:.3e} relative from world 1's, "
                      f"inventory per rank as world 1's: {same}; warm wall "
                      f"{t_w:.4f} s (world 1 {ref['wall']:.4f} s): measured "
                      f"efficiency {eff:.4f}, projected {proj_w}",
                      flush=True)
                slack = 1 if case == "refined" else 0
                _check(abs(g["iterations"] - ref["iterations"]) <= slack,
                       f"16d world {world} {case}: {g['iterations']} "
                       "iterations")
                _check(rel <= 1e-12, f"16d world {world} {case}: "
                       f"eigenvalues {rel:.3e}")
                _check(same, f"16d world {world} {case}: inventory")
                solves.append(dict(
                    solve=f"phase 16d world {world} {case}",
                    iterations=g["iterations"], walls=g["walls"],
                    eig_rel_world1=rel, efficiency=eff,
                    projected_efficiency=proj_w,
                    route=got["remote"]["route"],
                    apply_m40_ms=got["apply_m40"]["ms"]))
            _check(got["launches"]["banded_q_ext_bsr_spmm"] > 0,
                   f"16d world {world}: launches {got['launches']}")


@contextlib.contextmanager
def _counting_collectives(cls):
    """Count the calls of the collectives of ``cls`` (a RowMesh) by name
    inside the ``with`` block."""
    counts = dict.fromkeys(("all_reduce", "all_gather_rows", "ring_exchange",
                            "ring_push"), 0)
    saved = {name: getattr(cls, name) for name in counts}

    def counted(name, fn):
        def call(self, *args):
            counts[name] += 1
            return fn(self, *args)
        return call
    for name, fn in saved.items():
        setattr(cls, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def _shape_of(op):
    """The block shape of a banded operator, as ``_bound`` reads it."""
    return types.SimpleNamespace(n_block_rows=op.n_block_rows,
                                 block_size=op.block_size,
                                 bandwidth=op.bandwidth)


def _nonzero_blocks(blocks, K: int) -> int:
    """Stored blocks with a nonzero entry: the work this data needs."""
    import torch
    nbr, bs, _ = blocks.shape
    return int(torch.sum(torch.any(torch.any(
        blocks.reshape(nbr, bs, K, bs) != 0, dim=3), dim=1)))


def _bound(name, dtype, m, mv, op, nnz_blocks):
    """(bound_ms, bound_by) of one call of kernel ``name``: each input read
    once and each output written once over HBM_BYTES_S, against 2
    operations per multiply-add of the nonzero blocks (plus the int8
    diagonal and the gram) over the peak of the operations' type."""
    nbr, bs, bw = op.n_block_rows, op.block_size, op.bandwidth
    K = 2 * bw + 1
    n = nbr * bs
    if name.startswith("fused_probe_"):
        # Kernel 5's bf16-dequant variants: int8 blocks, scales and diagonal,
        # bf16 x and v (none for nov_bf16) in, G out; the apply's and the
        # gram's products on the bf16 tensor cores, plus d∘x (and nov_bf16's
        # column sums).
        moved = (nbr * bs * K * bs + nbr * K * bs * 4 + n * 4 + n * m * 2
                 + (n * mv * 2 if mv else 0) + (mv or m) * m * 4)
        ops = (2 * nnz_blocks * bs * bs * m + 2 * n * m
               + (2 * n * mv * m if mv else n * m))
        t_bytes = moved / HBM_BYTES_S * 1e3
        t_ops = ops / PEAK_FLOP_S["bfloat16"] * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))
    quant = "_q_" in name
    isz = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    # The halo kernels read 2*bw*bs more x rows (kernel 8: the two halos).
    x_rows = n + 2 * bw * bs if "_ext_" in name or "remote" in name else n
    moved = nbr * bs * K * bs * (1 if quant else isz)
    if quant:
        moved += nbr * K * bs * 4 + n * 4            # scale_rows, diag
    if name == "bsr_spmm":
        moved += nbr * K * 4                          # block_cols
    moved += x_rows * m * isz + n * m * max(isz, 4)   # x in, Y out
    if name == "banded_remote_push_spmm":
        moved += 2 * bw * bs * m * isz                # the halos written
    ops = 2 * nnz_blocks * bs * bs * m + (2 * n * m if quant else 0)
    if name == "banded_spmm_copy":
        # Adds only, on the CUDA cores (f64 34 TFLOP/s, f32 67): every
        # stored entry once, every window row of x once.
        adds = nbr * bs * K * bs + n * K * m
        t_ops = adds / (34e12 if dtype == "float64" else 67e12) * 1e3
        t_bytes = moved / HBM_BYTES_S * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))
    if "_gram" in name:
        width = m if mv is None else mv
        moved += (0 if mv is None else n * mv * isz) + width * m * 4
        ops += 2 * n * width * m
    t_bytes = moved / HBM_BYTES_S * 1e3
    # int8 storage with float32 x runs float32 operations; with float64 x
    # float64 ones.
    t_ops = ops / PEAK_FLOP_S["float32" if quant and isz == 4 else dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k1_split_bounds(op, nnz_blocks, m, dtype) -> dict:
    """Bounds (ms) of kernel 1's split (``K1_SPLIT``) at (m, dtype), as
    :func:`_bound` counts: the full kernel and its launch options compute
    kernel 1's function; ``noy`` reads the blocks and x (its column sums
    are a few bytes); ``copy`` (kernel 9) reads them and writes Y with adds
    alone; ``writeonly`` and ``fill_`` write Y alone; kernel 4 on the int8
    form of the same matrix, with float32 x."""
    isz = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    nbr, bs, bw = op.n_block_rows, op.block_size, op.bandwidth
    n = nbr * bs
    full = _bound("banded_bsr_spmm", dtype, m, None, op, nnz_blocks)[0]
    read = (nbr * bs * (2 * bw + 1) * bs + n * m) * isz
    noy = max(read / HBM_BYTES_S * 1e3, 2 * nnz_blocks * bs * bs * m
              / PEAK_FLOP_S[dtype] * 1e3)
    write = n * m * max(isz, 4) / HBM_BYTES_S * 1e3
    out = {key: full for key, _ in K1_SPLIT}
    out.update({"noy": noy, "writeonly": write, "writeonly_into_x": write,
                "fill_": write,
                "copy": _bound("banded_spmm_copy", dtype, m, None, op,
                               nnz_blocks)[0],
                "kernel 4 (int8)": _bound("banded_q_bsr_spmm", "float32", m,
                                          None, op, nnz_blocks)[0]})
    return out


def _split_bounds(op, nnz_blocks, m, mv) -> dict:
    """Bounds (ms) of kernel 5's measurement variants at (m, mv), as
    :func:`_bound` counts: ``nov`` reads the int8 tables, the diagonal and
    x and writes one row of column sums; ``nogram`` also reads V; both do
    the apply's operations and the column sums (float32)."""
    nbr, bs, bw = op.n_block_rows, op.block_size, op.bandwidth
    K, n = 2 * bw + 1, op.n_block_rows * op.block_size
    moved = nbr * bs * K * bs + nbr * K * bs * 4 + n * 4 + n * m * 4 + m * 4
    t_ops = ((2 * nnz_blocks * bs * bs * m + 3 * n * m)
             / PEAK_FLOP_S["float32"] * 1e3)
    return {f"{variant}_bound_ms": max((moved + extra) / HBM_BYTES_S * 1e3,
                                       t_ops)
            for variant, extra in (("nov", 0), ("nogram", n * mv * 4))}


def _library_bsr(op, ext: bool, p=None):
    """``op``'s in-range blocks as a ``torch.sparse_bsr_tensor``: the whole
    matrix, or with ``ext`` a shard's rows over its halo-extended columns
    (slot k of block row r at block column r + k); with a permutation
    ``p`` of the block indices, P A Pᵀ (:func:`_permuted`), columns sorted
    in each row."""
    import torch
    nbr, bs, kbs = op.blocks.shape
    K, bw, dev = kbs // bs, op.bandwidth, op.blocks.device
    r = torch.arange(nbr, device=dev)[:, None]
    k = torch.arange(K, device=dev)[None, :]
    col = r + k if ext else r - bw + k
    ncols = nbr + 2 * bw if ext else nbr
    keep = (col >= 0) & (col < ncols)
    values = op.blocks.reshape(nbr, bs, K, bs).permute(0, 2, 1, 3)[keep]
    rows, col = r.expand(nbr, K)[keep], col[keep]
    if p is not None:
        rows, col = p[rows], p[col]
        order = torch.argsort(rows * nbr + col)
        rows, col, values = rows[order], col[order], values[order]
    crow = torch.zeros(nbr + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nbr), 0)
    return torch.sparse_bsr_tensor(crow, col, values,
                                   size=(nbr * bs, ncols * bs))


def library_times(A) -> dict:
    """Kernel name -> {"ms", "rel", "call"}: one PyTorch call that computes
    the kernel's function at its main case, its time and its max relative
    error against the plain version; "ms" None with the reason where the
    call fails. A yardstick; the port never calls it.
    - Kernels 1 and 2: ``torch.sparse_bsr_tensor(...) @ x`` (cuSPARSE).
    - Kernel 6: ``torch.bmm(blocks, window)``, window the (nbr, K*bs, m)
      view of x_ext at strides (bs*m, m, 1) (no copy), one cuBLAS batched
      GEMM; beside it ("cusparse_ms") the shard as a BSR over x_ext's
      block columns, ``@ x_ext``.
    - Kernel 8: none, its x comes from three buffers; kernels 3, 4, 5 and
      7: none (a fused gram, int8 blocks with scales)."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    out = {}

    def measure(fn, plain, dtype):
        try:
            y = fn().reshape(plain.shape)
            rel = float(torch.max(torch.abs(y - plain))
                        / torch.max(torch.abs(plain)))
            del y
            return _time_ms(fn), rel
        except (RuntimeError, NotImplementedError) as exc:
            return None, f"{type(exc).__name__}: {exc}"[:200]

    bw, bs, nbr = A.bandwidth, A.block_size, A.n_block_rows
    for names, ext in ((("banded_bsr_spmm", "bsr_spmm"), False),
                       (("banded_ext_bsr_spmm",), True)):
        dtype, m = MAIN_CASE[names[0]][:2]
        rows = A.shape[0] + (2 * bw * bs if ext else 0)
        x = torch.randn((rows, m), dtype=getattr(torch, dtype),
                        device=A.blocks.device)
        plain = (kernels.banded_ext_bsr_spmm_plain(A.blocks, x, bandwidth=bw)
                 if ext else kernels.banded_bsr_spmm_plain(A.blocks, x, bw))
        S = _library_bsr(A, ext)
        sparse = measure(lambda: S @ x, plain, dtype)
        entry = dict(ms=sparse[0], rel=sparse[1],
                     call="torch.sparse_bsr_tensor(...) @ x (cuSPARSE)")
        if ext:
            window = x.as_strided((nbr, (2 * bw + 1) * bs, m), (bs * m, m, 1))
            bmm = measure(lambda: torch.bmm(A.blocks, window), plain, dtype)
            entry = dict(ms=bmm[0], rel=bmm[1],
                         call="torch.bmm(blocks, window view of x_ext)",
                         cusparse_ms=sparse[0], cusparse_rel=sparse[1])
        print(f"  one-call yardstick ({'shard, x_ext' if ext else 'whole'}, "
              f"{dtype} m={m}): {entry}", flush=True)
        for key in ("rel", "cusparse_rel"):
            if isinstance(entry.get(key), float):
                _check(entry[key] <= TOL[dtype],
                       f"the library call differs from the plain version by "
                       f"{entry[key]:.3e}")
        for name in names:
            out[name] = entry
        del x, plain, S
        torch.cuda.empty_cache()
    out["banded_remote_halo_spmm"] = dict(
        ms=None, rel=None, call="none: x comes from three buffers (the "
        "shard's rows and two received halos); no PyTorch call takes them")
    out["banded_remote_push_spmm"] = dict(
        ms=None, rel=None, call="none: it also writes the halos into the "
        "ring neighbours' windows; no PyTorch call does both")
    return out


def _ptxas_entries(log: str):
    """(mangled entry name, registers, spill store bytes, static shared
    bytes) of every kernel in ptxas's report of a build."""
    import re
    name, spill = None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            yield name, int(m.group(1)), spill, int(smem.group(1)) if smem else 0
            name = None


def _typed_entries(log: str) -> dict:
    """The entries of csrc/fused_gram_typed.cuh (``typed_gram_kernel``):
    kernel 3's bf16 and float64 ones (csrc/fused_gram_bf16.cu,
    csrc/fused_gram_f64.cu) and kernel 5's int8 ones with float64 and bf16
    x (csrc/fused_gram_q8f64.cu, csrc/fused_gram_q8bf16.cu): "bf16 TN=128",
    "q8f64 TN=32" -> (registers, spill store bytes, static shared
    bytes)."""
    import re
    out = {}
    for name, n, spill, smem in _ptxas_entries(log):
        m = re.search(r"typed_gram_kernelINS_\d+T(Q8Bf16|Q8F64|Bf16|F64)E"
                      r"Li(\d+)E", name)
        if m:
            out[f"{m.group(1).lower()} TN={m.group(2)}"] = (n, spill, smem)
    return out


def _q_f64_entries(log: str) -> dict:
    """The float64-x entries of kernels 4 and 7 (``banded_spmm_kernel`` of
    csrc/banded_spmm.cuh on the int8 slab QInt8, sources Quant<Masked> and
    Quant<Inside>, instantiated in csrc/q_spmm_f64.cu and
    csrc/q_ext_spmm_f64.cu): "kernel 4 TM=128
    TN=24" -> (registers, spill store bytes, static shared bytes)."""
    import re
    out = {}
    for name, n, spill, smem in _ptxas_entries(log):
        m = re.search(r"banded_spmm_kernelINS_5QInt8ELi(\d+)ELi(\d+)E.*?"
                      r"NS_5QuantINS_\d+(Masked|Inside)", name)
        if m:
            kernel = 4 if m.group(3) == "Masked" else 7
            out[f"kernel {kernel} TM={m.group(1)} TN={m.group(2)}"] = (
                n, spill, smem)
    return out


_K1_TYPES = {"d": "f64", "f": "f32", "13__nv_bfloat16": "bf16"}


def _k1_entries(log: str) -> dict:
    """Kernel 1, its variants, kernel 8 and kernel 2 (``banded_spmm_kernel``
    of csrc/banded_spmm.cuh, by x-row source: kernel 1's masked one, kernel
    8's inside and split ones and its push form's, kernel 2's column
    table): "f64 TM=128 TN=48
    RPC=1 full direct normal Masked" -> (registers, spill store bytes,
    static shared bytes), from the build's report. The ring is dynamic shared memory (``_k1_plan``)."""
    import re
    out = {}
    for name, n, spill, smem in _ptxas_entries(log):
        m = re.search(r"banded_spmm_kernelI(d|f|13__nv_bfloat16)Li(\d+)ELi"
                      r"(\d+)ELi(\d)ELi(\d)ELi(\d)ELb(\d)ENS_\d+"
                      r"(Masked|Inside|Split|Table|Push)", name)
        if m:
            t, tm, tn, rpc, var, store, ev, src = m.groups()
            key = (f"{_K1_TYPES[t]} TM={tm} TN={tn} RPC={rpc} "
                   f"{('full', 'noy', 'copy', 'writeonly')[int(var)]} "
                   f"{('direct', 'tma')[int(store)]} "
                   f"{('normal', 'evict_first')[int(ev)]} {src}")
            out[key] = (n, spill, smem)
    return out


def _k1_plan(key: str) -> dict:
    """The launch layout (``kernels.banded_spmm_plan``, the header's own
    choice) of one kernel-1 instantiation, at bs = TM and m = TN, with the
    default ring; checks that the launch picks that instantiation's tiles."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    f = key.split()
    tm, tn, rpc = (int(v.split("=")[1]) for v in f[1:4])
    dtype = {"f64": torch.float64, "f32": torch.float32,
             "bf16": torch.bfloat16}[f[0]]
    plain = f[4:7] == ["full", "direct", "normal"] and rpc == 1
    plan = kernels.banded_spmm_plan(0, dtype, tm, tn,
                                    None if plain else f[4], rpc, f[5])
    _check((plan["TM"], plan["TN"]) == (tm, tn),
           f"{key}: the launch at bs={tm}, m={tn} takes {plan}")
    return plan


def _new_entries(log: str) -> dict:
    """The float32-x entries of kernels 4 and 7 (``q_spmm_kernel`` of
    csrc/q_spmm.cu, kAll 0 and 1) and kernel 6's TMA route
    (``ext_tma_kernel`` of csrc/ext_spmm.cu): "kernel 4 TN=24" / "kernel 6
    tma f64 TM=128 TN=48" -> (registers, spill store bytes, static shared
    bytes)."""
    import re
    out = {}
    for name, n, spill, smem in _ptxas_entries(log):
        m = re.search(r"q_spmm_kernelILi(\d+)ELb(\d)E", name)
        if m:
            kernel = 7 if m.group(2) == "1" else 4
            out[f"kernel {kernel} TN={m.group(1)}"] = (n, spill, smem)
        m = re.search(r"ext_tma_kernelI(d|f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                      name)
        if m:
            out[f"kernel 6 tma {_K1_TYPES[m.group(1)]} TM={m.group(2)} "
                f"TN={m.group(3)}"] = (n, spill, smem)
    return out


def _fused_registers(log: str) -> dict:
    """ptxas's register count of each fused kernel instantiation of
    ``csrc/fused_gram.cu`` ("f32 TN=128 full", "int8 TN=24 nov", ...), from
    the build's report."""
    import re
    regs, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"fused_gram_kernelINS_\d+(DenseF32|Int8)ELi(\d+)"
                          r"ELi(\d)E", line)
            key = (f"{'f32' if m.group(1) == 'DenseF32' else 'int8'} "
                   f"TN={m.group(2)} "
                   f"{('full', 'nov', 'nogram')[int(m.group(3))]}"
                   if m else None)
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            regs[key] = int(m.group(1))
    return regs


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()
    # Float32 products in full float32 (PyTorch's default, stated): the
    # plain versions and the unfused yardstick are float32-accurate.
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.callbacks.append(_gc_timer)
    smi = _smi()
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    path, log = kernels.build()
    build_s = time.perf_counter() - t0
    print(f"[2] built {path.name} from {len(kernels.sources())} sources in "
          f"{build_s:.1f} s")
    for line in log.splitlines():
        if "error" in line.lower():
            print("   ", line.strip())
    if log:
        import re
        secs = sorted(((float(m.group(2)), m.group(1)) for m in re.finditer(
            r"^nvcc (\S+): ([0-9.]+) s$", log, re.M)), reverse=True)
        print("    compile time by source (s from the common start): "
              + ", ".join(f"{name} {t:.1f}" for t, name in secs))
        print("    csrc/fused_gram_typed.cuh: kernel 3's bf16 and float64 "
              "entries, kernel 5's int8 ones with float64 x (row 5d) and "
              "bf16 x (rows 10a-c): ptxas registers, spill stores, static "
              "smem")
        for key, (regs, spill, smem) in _typed_entries(log).items():
            print(f"      {key}: {regs} registers, {spill} B spill, {smem} B "
                  "static smem")
        print("    kernel 1, its variants (source Masked), kernel 8 (sources "
              "Inside and Split; its push form, Push), kernel 6's cp.async "
              "route (Inside) and "
              "kernel 2 (Table) on csrc/banded_spmm.cuh: ptxas "
              "registers, spill stores, static smem; the default ring "
              "(kernels.banded_spmm_plan)")
        for key, (regs, spill, smem) in _k1_entries(log).items():
            plan = _k1_plan(key)
            print(f"      {key}: {regs} registers, {spill} B spill, "
                  f"{smem} B static smem, {plan['smem_bytes']} B ring of "
                  f"{plan['stages']} stages")
        print("    the float64-x entries of kernels 4 and 7 "
              "(csrc/q_spmm_f64.cu, csrc/q_ext_spmm_f64.cu, int8 slab on "
              "csrc/banded_spmm.cuh): "
              "ptxas registers, spill stores, static smem; the default ring "
              "(kernels.q_spmm_f64_plan)")
        for key, (regs, spill, smem) in _q_f64_entries(log).items():
            tm, tn = (int(f.split("=")[1]) for f in key.split()[2:4])
            plan = kernels.q_spmm_f64_plan(0, 8 if tm == 16 else 128, tn)
            _check((plan["TM"], plan["TN"]) == (tm, tn),
                   f"{key}: the launch at m={tn} takes {plan}")
            print(f"      {key}: {regs} registers, {spill} B spill, "
                  f"{smem} B static smem, {plan['smem_bytes']} B ring of "
                  f"{plan['stages']} stages")
        print(f"    ptxas registers of the fused float32 kernels (3, 5) by "
              f"loader, column tile and variant: {_fused_registers(log)}")
        print("    the float32-x entries of kernels 4 and 7 (csrc/q_spmm.cu) "
              "and kernel 6's TMA route (csrc/ext_spmm.cu): ptxas "
              "registers, spill stores, static smem")
        for key, (regs, spill, smem) in _new_entries(log).items():
            print(f"      {key}: {regs} registers, {spill} B spill, {smem} B "
                  "static smem")
        for m in (1, 20, 44, 256):
            print(f"      kernel 4 layout at m={m}: "
                  f"{kernels.q_spmm_plan(0, 16384, m)}")
        for m in EXT_WIDTHS:
            print(f"      kernel 6 TMA layout, f64 bs=128 m={m}: "
                  f"{kernels.ext_spmm_plan(0, torch.float64, 128, m, 'tma')}")
    sys.stdout.flush()

    t0 = time.perf_counter()
    A = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, coupling=1e-3,
                                 seed=0, dtype=torch.float64, device=dev)
    A32 = fdtt.BSROperator(A.block_cols, A.blocks.float(), bandwidth=1)
    torch.cuda.synchronize()
    print(f"    built A: n={A.shape[0]}, blocks {tuple(A.blocks.shape)} "
          f"float64 ({A.blocks.numel() * 8 / 1e9:.2f} GB) and float32 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    q = fdtt.generate_banded_bsr_quantized(16384, 128, bandwidth=1,
                                           coupling=1e-3, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"    built q: n={q.shape[0]}, int8 blocks "
          f"{tuple(q.qblocks.shape)} ({q.qblocks.numel() / 1e6:.0f} MB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    probe = _probe_operator(dev)
    print(f"    built the probes' matrix: n={probe.shape[0]}, blocks "
          f"{tuple(probe.blocks.shape)} float32", flush=True)

    print("[3] kernels vs plain versions", flush=True)
    record, slab_checks, gram_splits, k1_info, variant_info = [], {}, {}, {}, {}
    band_checks, ext_info, permuted_info, q64_info = {}, {}, {}, {}
    phase_kernels(A, A32, q, probe, dev, record, slab_checks, gram_splits,
                  k1_info, variant_info, band_checks, ext_info, permuted_info,
                  q64_info)
    # Kernel 1's variants at the probes' shape (row 10 of PERF.md's table).
    probe_case = (_shape_of(probe),
                  _nonzero_blocks(probe.blocks, 2 * probe.bandwidth + 1))
    del probe
    library = library_times(A)
    ds_info = ds_card_checks(q, dev)

    solves, refs = [], {}
    counts = {fn.__name__: 0 for fn in kernels.KERNELS}
    # Kernels 4 and 7 with float64 x: their own kernel, counted apart.
    f64_names = {f"{fn.__name__}_f64": fn for fn in kernels.F64_X_KERNELS}
    counts.update(dict.fromkeys(f64_names, 0))
    # Kernel 3's bf16 and float64 entries and kernel 5's float64-x entry:
    # kernels of their own, counted apart (the wrappers' launches less
    # theirs are the float32 kernels').
    typed_names = ("banded_bsr_spmm_gram_bf16", "banded_bsr_spmm_gram_f64")
    # Kernel 9 and kernel 5's bf16-dequant variants: no path launches them;
    # nor kernel 3's and kernel 5's float64 entries (the fused engine is
    # float32 only).
    counts.update(dict.fromkeys(
        ("banded_spmm_copy", *typed_names, "banded_q_bsr_spmm_gram_f64",
         *(f"fused_probe_{v}" for v in kernels.BF16_VARIANTS)),
        0))
    # The one-rank NCCL group of phases 8-9 meets at a file in here.
    tmp = tempfile.TemporaryDirectory()
    # What phase 16 carries from 16a-16b to 16c and 16d.
    p16 = {}
    rendezvous = f"file://{tmp.name}/rendezvous"
    paths = [
        ("[4] main path", lambda: phase_main(A, dev, solves, refs),
         ("banded_bsr_spmm",)),
        ("[4b] GJD through kernel 1", lambda: phase_gjd(A, dev, solves, refs),
         ("banded_bsr_spmm",)),
        ("[5] collapse and generalized legs",
         lambda: phase_legs(A, dev, solves, refs),
         ("banded_bsr_spmm", "bsr_spmm")),
        ("[6] int8 loose stage, n=2,097,152, lowest-20",
         lambda: phase_int8(q, dev, solves, refs),
         ("banded_q_bsr_spmm", "banded_q_bsr_spmm_f64")),
        ("[6b] refined stage of the sparse north star, lowest-20",
         lambda: phase_refined(q, dev, solves, refs),
         ("banded_q_bsr_spmm",)),
        ("[6c] noise gate and stall exit at 1,000,448 rows (matrix-free)",
         lambda: phase_noise_gate(dev, solves), ()),
        ("[7] fused SpMM+Gram engine", lambda: phase_fused(q, dev, solves),
         ("banded_bsr_spmm_gram", "banded_q_bsr_spmm_gram")),
        ("[7c] the fused engine on bf16 storage (row 3b)",
         lambda: phase_bf16_storage(dev, solves),
         ("banded_bsr_spmm_gram_bf16",)),
        ("[8a] sharded path, world size 1 (NCCL), pallas",
         lambda: phase_sharded(A, q, dev, rendezvous, solves, refs),
         ("banded_ext_bsr_spmm", "banded_q_ext_bsr_spmm",
          "banded_q_ext_bsr_spmm_f64")),
        ("[8b] sharded path, world size 1 (NCCL), pallas-remote",
         lambda: phase_remote(A, dev, rendezvous, solves, refs),
         ("banded_remote_push_spmm",)),
        ("[14a] checkpoint and resume, the logger, the profiler hooks and "
         "the NaN trap on A, kernel 1",
         lambda: phase_checkpoint(A, dev, solves, refs),
         ("banded_bsr_spmm",)),
        ("[14b] sharded refined stage, world size 1 (NCCL), kernel 7",
         lambda: phase_sharded_refined(q, dev, rendezvous, solves, refs),
         ("banded_q_ext_bsr_spmm",)),
        ("[14c] sharded checkpoint, world size 1 (NCCL), kernel 6",
         lambda: phase_sharded_checkpoint(A, dev, rendezvous, solves, refs),
         ("banded_ext_bsr_spmm",)),
        ("[15c] sharded orthonormalization='qr' (TSQR), world size 1 "
         "(NCCL), kernel 6 beside kernel 1",
         lambda: phase_sharded_qr(A, dev, rendezvous, solves),
         ("banded_ext_bsr_spmm", "banded_bsr_spmm")),
        (f"[15d] matrix-free pencil, n={FREE_PENCIL_N}, row-sharded, world "
         "size 1 (NCCL)", lambda: phase_free_pencil(dev, rendezvous, solves),
         ()),
        ("[16a] collective inventory of one refined iteration, int8, "
         "n=2,097,152, world size 1 (NCCL), kernel 7",
         lambda: phase16_int8(q, dev, rendezvous, solves, p16),
         ("banded_q_ext_bsr_spmm",)),
        ("[16b] collective inventory of each sharding rule at two row "
         "counts, world size 1 (NCCL)",
         lambda: phase16_rules(A, dev, rendezvous, solves, refs, p16),
         ("banded_ext_bsr_spmm", "banded_remote_push_spmm", "bsr_spmm")),
        ("[16d] world sizes 2 and 4 over NCCL, where the GPUs are",
         lambda: phase16_multi_gpu(dev, solves, refs, p16), ()),
        ("[16e] phase 6b's refined stage under sum_strategy('tree') beside "
         "the cascade, one device, kernel 4",
         lambda: phase_sum_strategy(q, dev, solves, refs),
         ("banded_q_bsr_spmm",)),
        ("[17] kernel 8's push route, world size 1 (NCCL), beside its "
         "exchange route",
         lambda: phase17_push(A, dev, rendezvous, solves, refs),
         ("banded_remote_push_spmm", "banded_remote_halo_spmm")),
    ]
    elapsed = {}

    def run_path(title, run, expected):
        """Run one solve phase with every launch count set to 0, add its
        launches to ``counts``, and check that it launched ``expected``."""
        print(title, flush=True)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run()
        phase_counts = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        phase_counts["banded_spmm_copy"] = (
            kernels.banded_spmm_variant.copy_launches)
        phase_counts.update({name: fn.f64_launches
                             for name, fn in f64_names.items()})
        gram = kernels.banded_bsr_spmm_gram
        phase_counts.update(zip(typed_names, (gram.bf16_launches,
                                              gram.f64_launches)))
        phase_counts["banded_bsr_spmm_gram"] -= (gram.bf16_launches
                                                 + gram.f64_launches)
        qgram = kernels.banded_q_bsr_spmm_gram
        phase_counts["banded_q_bsr_spmm_gram_f64"] = qgram.f64_launches
        phase_counts["banded_q_bsr_spmm_gram"] -= qgram.f64_launches
        elapsed[title] = time.perf_counter() - t0
        print(f"    phase launches {phase_counts} in {elapsed[title]:.1f} s",
              flush=True)
        for name in expected:
            _check(phase_counts[name] > 0,
                   f"{name} was never launched on the path of {title}")
        for name, count in phase_counts.items():
            counts[name] += count

    try:
        for title, run, expected in paths:
            run_path(title, run, expected)
        for name in (*(fn.__name__ for fn in kernels.KERNELS), *f64_names,
                     "banded_bsr_spmm_gram_bf16"):
            _check(counts[name] > 0,
                   f"{name} was never launched on a solve path")
        print("[9] one halo apply: pallas-remote against pallas", flush=True)
        remote_vs_pallas_apply(A, dev, rendezvous, solves)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()

    # The 10M-row phases want the card to themselves: keep what the
    # kernels line needs of A and q (their shapes, their nonzero blocks).
    nnz = {"nbr=8192": (_shape_of(A), _nonzero_blocks(A.blocks, 3)),
           "nbr=16384": (_shape_of(q), _nonzero_blocks(q.qblocks, 3)),
           **variant_info["ops"]}
    # Phase 13c holds eigsh's lowest-6 to phase 4's lowest-20.
    shared13 = {"phase4_lowest20": refs[20]["eigenvalues"].cpu()}
    del A, A32, q, refs
    gc.collect()
    torch.cuda.empty_cache()
    # 10a and 10b keep what 15a and 15b run beside (10b its operator).
    ns = {}
    for title, run, expected in [
            ("[10a] matrix-free north star, n=10,000,384, lowest-20",
             lambda: phase_northstar_free(dev, solves, ns), ()),
            ("[15a] matrix-free north star row-sharded, world size 1 "
             "(NCCL), --polish 2",
             lambda: phase_northstar_free_sharded(dev, solves, ns), ()),
            ("[10b] sparse north star, int8, n=10,000,000, lowest-20",
             lambda: phase_northstar_bsr(dev, solves, ns),
             ("banded_q_bsr_spmm",)),
            ("[15b] sparse north star row-sharded, world size 1 (NCCL), "
             "--polish 2, kernel 7",
             lambda: phase_northstar_bsr_sharded(dev, solves, ns),
             ("banded_q_ext_bsr_spmm",)),
            ("[16a] collective inventory of one refined iteration, int8, "
             "n=10,000,000 (10b's matrix), world size 1 (NCCL), kernel 7; "
             "[16c] the N-GPU projection",
             lambda: phase16_northstar(dev, solves, ns, p16),
             ("banded_q_ext_bsr_spmm",)),
            ("[10c] entry points: the CLI's solve, northstar --mode banded",
             lambda: phase_entry_points(dev, solves),
             ("banded_bsr_spmm",))]:
        run_path(title, run, expected)
        if title.startswith("[15b]"):
            kernel7_at_10m(ns["q"], dev, solves)
    ns.clear()

    # Phase 12: the ELL family at 1M rows, each sub-phase counted from 0.
    t12 = time.perf_counter()
    shared = {}
    for title, run, expected in [
            (f"[12a] BASELINE config 3: scipy CSR, n={CONFIG3_N}, "
             f"lowest-{SPARSE_K} (ELL, no kernel)",
             lambda: phase_config3(dev, solves), ()),
            (f"[12b] hybrid band + remainder, n={LOCAL_N}, "
             f"lowest-{SPARSE_K}, kernel 1",
             lambda: phase_hybrid(dev, solves, shared),
             ("banded_bsr_spmm",)),
            ("[12c] RCM on the scrambled COO", lambda: phase_rcm(
                dev, solves, shared), ("banded_bsr_spmm",)),
            ("[12d] sharded hybrid, world size 1 (NCCL), kernel 2",
             lambda: phase_sparse_sharded(dev, solves, shared),
             ("bsr_spmm",)),
            ("[12e] refined float32 hybrid, lowest-4",
             lambda: phase_hybrid_refined(dev, solves),
             ("banded_bsr_spmm",))]:
        run_path(title, run, expected)
    shared.clear()
    phase12_s = time.perf_counter() - t12

    # Phase 13: Chebyshev restarts, locking, eigsh, matmul_precision and
    # the batched solve, each sub-phase counted from 0.
    t13 = time.perf_counter()
    ops13 = phase13_operators(dev)
    for title, run, expected in [
            ("[13a] Chebyshev-filtered restarts, lowest-20 on C",
             lambda: phase_cheb(ops13, dev, solves, shared13),
             ("banded_bsr_spmm",)),
            ("[13b] locking: DPR lowest-20 on C, GJD lowest-3 on A",
             lambda: phase_locking(ops13, dev, solves),
             ("banded_bsr_spmm",)),
            ("[13c] eigsh on A: SA, LA, BE, sigma",
             lambda: phase_eigsh(ops13, dev, solves, shared13),
             ("banded_bsr_spmm",)),
            ("[13d] matmul_precision: float32 lowest-20 on C32",
             lambda: phase_precision(ops13, dev, solves, shared13),
             ("banded_bsr_spmm",)),
            (f"[13e] eigensolve_batched, {BATCH} x n={BATCH_N} (no kernel)",
             lambda: phase_batched(dev, solves), ())]:
        run_path(title, run, expected)
    del ops13
    shared13.clear()
    torch.cuda.empty_cache()
    phase13_s = time.perf_counter() - t13

    summary = []
    for name in REPLACES:
        rows = [r for r in record if r["name"] == name]
        dtype, m, mv, write_out, shape = MAIN_CASE[name]
        main_row = next(r for r in rows if r["dtype"] == dtype
                        and r["m"] == m and r["mv"] == mv
                        and r["write_out"] == write_out
                        and shape in r["shape"])
        bound_ms, bound_by = _bound(name, dtype, m, mv, *nnz[shape])
        entry = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=counts[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["max_abs_err"] is not None),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library.get(name, {}).get("ms"),
            main_case=f"{dtype} m={m} mv={mv} {shape}")
        if name in library:
            entry.update(library_call=library[name]["call"],
                         library_rel_err=library[name]["rel"])
            if "cusparse_ms" in library[name]:
                entry["library_cusparse_ms"] = library[name]["cusparse_ms"]
        if name == "banded_ext_bsr_spmm":
            entry["routes"] = ext_info
        if "_gram" in name:
            # max_abs_err is Y's; G is held elementwise to its bound.
            entry.update(
                max_abs_err_G=max(r["g_abs_err"] for r in rows),
                max_gram_err_rel=max(r["gram_ratio"] for r in rows),
                gram_tol=GRAM_TOL)
        if name in gram_splits:
            split = gram_splits[name]
            entry.update(unfused_ms=split["unfused"], nov_ms=split["nov"],
                         nogram_ms=split["nogram"], layout=split["plan"])
        if name in slab_checks:
            entry["four_slab_max_abs_err"] = slab_checks[name]
        if name in band_checks:
            # The band alone (the diagonal zeroed), to the same limit.
            entry.update(band_checks[name])
        if name == "bsr_spmm":
            # P A Pᵀ, by width (phase 3).
            entry["permuted"] = permuted_info
        if name in f64_names:
            # The float64-x entries of kernels 4 and 7 at int8 m = 20 and
            # 40; the share of Y's bits equal to the plain version's.
            entry["widths"] = {
                f"m={r['m']}": dict(
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    same_bits_share=r["same_bits_share"],
                    **dict(zip(("bound_ms", "bound_by"), _bound(
                        name, "float64", r["m"], None, *nnz["nbr=16384"]))))
                for r in rows if r["ms"] is not None}
        if name in q64_info:
            # Kernel 5's float64-x entry at int8 m = 20 and 40, mv = 220,
            # with its unfused yardstick (kernel 4 + matmul), its split and
            # its layout.
            entry["widths"] = {
                f"m={m_x}": dict(t, **dict(zip(("bound_ms", "bound_by"),
                                               _bound(name, "float64", m_x,
                                                      220,
                                                      *nnz["nbr=16384"]))))
                for m_x, t in q64_info[name].items()}
            entry.update(unfused_ms=q64_info[name][m]["unfused_ms"],
                         nov_ms=q64_info[name][m]["nov_ms"],
                         nogram_ms=q64_info[name][m]["nogram_ms"],
                         layout=q64_info[name][m]["plan"])
        if name in typed_names:
            # Rows 3b, 3d: the plan, the unfused yardstick and the split.
            typed = gram_splits["typed"][dtype]
            entry.update({k: typed[k] for k in typed if k not in (
                "ms", "plain_ms", "max_err_rel", "max_gram_err_rel")})
        if name == "banded_bsr_spmm":
            entry.update(split_ms=k1_info["split"], probe_bound_ms=_bound(
                name, "bfloat16", PROBE["m"], None, *probe_case)[0],
                probe_split_bounds_ms=_k1_split_bounds(
                    *probe_case, PROBE["m"], "bfloat16"))
        if name == "banded_q_bsr_spmm_gram":
            entry.update(_split_bounds(*nnz["nbr=16384"], m, mv))
        if name == "banded_spmm_copy":
            entry.update(variant="banded_spmm_variant(variant='copy')",
                         shapes=k1_info["copy"])
        if name.startswith("fused_probe_"):
            # max_abs_err is G's; the split at both shapes beside kernel 5.
            variant = name.removeprefix("fused_probe_")
            entry.update(
                variant=f"fused_gram_variant(variant={variant!r})",
                max_gram_err_rel=max(r["gram_ratio"] for r in rows),
                gram_tol=GRAM_TOL,
                split_ms={tag: variant_info[tag] for tag in ("probe", "main")},
                main_case_ms=next(r["ms"] for r in rows
                                  if "nbr=16384" in r["shape"]))
        summary.append(entry)
    total_s = time.perf_counter() - t_run
    phase14_s, phase15_s, phase16_s, phase17_s = (
        sum(t for title, t in elapsed.items() if title.startswith(f"[{p}"))
        for p in (14, 15, 16, 17))
    print(f"[11] ran {total_s:.1f} s, the build {build_s:.1f} s of it, "
          f"phase 12 {phase12_s:.1f} s ({100 * phase12_s / total_s:.1f}%), "
          f"phase 13 {phase13_s:.1f} s ({100 * phase13_s / total_s:.1f}%), "
          f"phase 14 {phase14_s:.1f} s ({100 * phase14_s / total_s:.1f}%), "
          f"phase 15 {phase15_s:.1f} s ({100 * phase15_s / total_s:.1f}%), "
          f"phase 16 {phase16_s:.1f} s ({100 * phase16_s / total_s:.1f}%), "
          f"phase 17 {phase17_s:.1f} s ({100 * phase17_s / total_s:.1f}%)",
          flush=True)
    print(json.dumps({"solves": solves, "ds": ds_info}))
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
