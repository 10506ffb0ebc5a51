"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (nvidia-smi), and the native host
   engine (g++), which must load;
2. build every CUDA kernel (one nvcc per source, in parallel) and print
   the build seconds and the ptxas resource lines, each under its
   function's name; every instantiation of ``schur``, and every complex
   instantiation of ``diag_lu``, ``trsm`` (complex128's
   ``zband_times_inverse`` on the FP64 tensor cores named apart),
   ``schur``, ``solve_gemm``, ``diag_apply`` and of ``rdma.cu``'s six
   entries, and every bf16-pass instantiation of ``clk.cu``
   (``waves.cuh``'s ``wave_mma_kernel``, and ``panel.cuh``'s
   ``trsm_mma_kernel``), and of ``tck.cu`` and
   ``flk.cu`` (``passes.cuh``'s ``chunks_mma_kernel``, ``sum_mma_kernel``
   and their bodies ``chunk_band_mma``, ``sum_band_mma``), must spill no
   registers;
3. the main path through the user entry point:
   ``gssvx(A, b, Options(dtype="float32", block_size=128))`` on
   ``laplacian_3d(32)`` (n = 32,768), with every launch count set to 0
   just before and read just after; berr <= 1e-12 and
   ||Ax - b||inf / ||b||inf <= 1e-10 are required and every kernel of
   the path must have been launched: on the card ``gemm_precision="auto"``
   factors bf16-first, so the path is diag_lu, clk_update_bf16,
   clk_trsm_bf16 and the sweep (the FP32 clk entries must not launch,
   the counter must read "default" and no escalation may fire); a
   second, warm call is timed the same way, and one refinement is
   profiled (device busy and idle share); then the same call at
   ``gemm_precision="highest"``, driven the same way (the FP32 clk
   entries only), whose launches the FP32 clk rows report;
4. every clk-path kernel against its plain PyTorch version on the card,
   level by level on the main path's own inputs (both get the same input;
   the run goes on with the kernel's output), timed with CUDA events,
   with clk_update's costliest levels (waves, targets, CTAs, the longest
   per-wave list) and clk_trsm's and diag_lu's launches by size, diag_lu
   beside its library yardstick (``lu_factor_ex`` without pivoting and
   two ``solve_triangular`` per level); the NOTRANS sweep is ``solve_gemm.cu``'s two passes
   with ``transpose=False`` (counted as "sweep"), one timed call per level
   against ``sweep_level_plain``; then the whole clk factor against the
   independent right-looking float64 reference ``blocklu.factor_plain``;
5. the other factor executors on the same matrix, each driven and
   checked like the main path, flk, ILU(1) and tck at
   ``gemm_precision="highest"`` (their FP32 entries; phase 13b drives
   their bf16 pass): ``executor="flk"`` (flk and diag_lu, no
   clk_update), ILU(1) (flk; its slots and refinement steps printed) and
   ``executor="pallas"`` (diag_lu, trsm, schur), ILU(1)'s two calls held
   to bit-equal x and equal refinement steps, both flk passes launched;
   then flk, schur and trsm against their plain versions level by level
   on their paths' inputs (flk's costliest target groups with their
   chunks, pass-2 targets and band width, and its critical path before
   and after the cut; schur's costliest levels with their bands and
   share of the CUDA cores' peak), and each whole factor against ``factor_plain`` on its plan; then
   ``executor="tck"`` on the same matrix (tck_update, diag_lu, clk_trsm),
   driven the same way, with tck_update's two phases (A: the U blocks in
   waves; B: the tiles) against their plain versions level by level,
   their costliest levels (waves, tiles, products, chains, ms of each
   phase), beside clk_update's time; and ``SparseLU.profile_levels`` on
   the level executor's factor (its six costliest levels), with the
   solve checked after it;
6. the transposed path on ``lap3d32u`` (``laplacian_3d(32)`` with
   unsymmetric off-diagonal values, the same plan):
   ``gssvx(A, b, Options(dtype="float32", block_size=128,
   trans=Trans.TRANS, condition_number=True))``, driven and checked like
   the main path in Aᵀ (solve_gemm and diag_apply must launch, rcond must
   lie in (0, 1], two transposed solves of one b must be bit-equal); then
   the reuse modes on perturbed values (SamePattern_SameRowPerm,
   SamePattern, FACTORED), each held to the same limits with the phases
   and launches that its mode implies; then the fused ``solve_level``
   (pass 1, solve_gemm, over chunks of the chains; pass 2, diag_apply,
   per row) against ``solve_level_plain`` level by level on the
   transposed tapes, each pass timed beside its library call, with the
   costliest levels' chunks and CTAs; the pair against the library pair
   at 32 right-hand sides; and the main path's NOTRANS L+U solve as the
   driver runs it, its device ms beside the host seconds of its launch
   loop (printed); and at block size 64 on ``laplacian_3d_unsym(16)``:
   x against scipy's
   ``spsolve(A.T, b)``, rcond against the dense 1-norm truth, ``logdet``
   against the plain CPU factor and ``numpy.linalg.slogdet``, and a
   ``save_factors`` / ``load_factors`` round trip;
7. the same checks at the Options default block size 64 on
   ``laplacian_3d(16)``, whose solution (by each executor, ``"tck"`` and
   ``"xla"`` included, under "auto") is held against scipy's, with the
   bf16 entries of clk, tck and flk against their plain versions too;
8. the tiled column factor at full width:
   ``gssvx(A, b, Options(dtype="float32", block_size=128,
   executor="tck", gemm_precision="highest"))`` on ``laplacian_3d(50)``
   (n = 125,000, the matrix
   with many columns taller than the TPU clk's 104-block panel), driven
   like the main path (tck_update, diag_lu, clk_trsm and sweep must
   launch, clk_update, flk and schur must not), a warm call,
   ``tck_update``'s two phases against their plain versions level by
   level (the costliest levels printed as on lap3d32) and the whole
   factor against the float64 reference; its NOTRANS L+U solve's
   device ms and host launch loop (printed);
   then clk, flk and the level executor on the same plan
   (SamePattern_SameRowPerm refactors), each held to the same limits,
   with clk_update's costliest levels, clk_trsm, diag_lu, flk (its
   groups as on lap3d32), and the level executor's trsm and schur
   against their plain versions on lap3d50's inputs (their launches and
   levels as on lap3d32), and flk's warm comparison of "auto" and
   "highest" there (as phase 13b's);
9. float64 on the card, which runs the level executor:
   ``Options(dtype="float64", block_size=128)`` on lap3d32, and TRANS +
   ``condition_number`` on lap3d32u, each held to the same limits; every
   float64 kernel (diag_lu, trsm, schur, sweep, solve_gemm, diag_apply)
   against its plain version, each bound taken at the FP64 peak;
10. complex on the card, which runs the level executor in its complex64
   and complex128 instantiations: ``gssvx(A, b, Options(dtype=...,
   block_size=128))`` on ``helmholtz_3d(32)`` (lap3d32's plan) with a
   complex b, driven like the main path (diag_lu, trsm, schur and sweep
   must launch in their ``_c64``/``_c128`` entries only, no fused kernel
   may), a warm call bit-equal to the first with equal refinement steps,
   every kernel against its plain version level by level (tolerance
   REL_TOL for complex64, REL_TOL_F64 for complex128, on the modulus) and
   the whole factor against ``factor_plain`` in complex128, bounds at 8
   real flops a complex multiply-add; then TRANS and CONJ with
   ``condition_number`` on a complex unsymmetric matrix of the same
   pattern (lap3d32u shifted as helmholtz_3d, off-diagonals times seeded
   unit phases), held in Aᵀ and Aᴴ, rcond in (0, 1], two transposed
   solves of one b bit-equal, solve_gemm and diag_apply against their
   plain versions (BSR ``addmm`` as solve_gemm's library call where torch
   serves it in that dtype); and at block size 64 on ``helmholtz_3d(16)``
   x against scipy's complex ``spsolve``, ``logdet`` (phase and
   log-modulus) against ``numpy.linalg.slogdet`` and a ``save_factors`` /
   ``load_factors`` round trip;
11. the 2D block-cyclic driver with every rank of a 2x2 grid on the card:
   ``gssvx_dist(A, b, Grid2D(2, 2), Options(dtype="float32",
   block_size=128, dist_executor="rdma"))`` on lap3d32, driven like the
   main path (every entry of rdma_factor and rdma_solve must launch, no
   single-device factor, sweep or solve kernel may), the receive counters
   against the TPU's receive tapes, a warm call beside the level
   executor's FACT, each entry against its plain version level by level
   on the path's inputs (rdma_panel and rdma_schur by launch, with the
   launches of fewer than 66 panels or targets; the solve's three:
   rdma_solve_chunks, rdma_solve_sum, rdma_solve_diag, with their ms per
   L+U solve and the sweeps' chains and chunks), the gathered factor against the float64
   reference, the warm call's x and refinement steps equal to the first
   call's, one refinement profiled (device busy and idle share);
   ``dist_executor="xla"``, which runs the same entries; and at
   block size 64 on lap3d16 the grids 2x2, 1x4, 4x1 and 2x4, x against
   scipy's; then the grid in the other element types, float64 on lap3d32
   and complex64 and complex128 on ``helmholtz_3d(32)``, each driven like
   the main path through its ``_f64``/``_c64``/``_c128`` entries only
   (every one launched), the receive counters against the tapes, a warm
   call bit-equal with equal refinement steps, every entry against its
   plain version level by level (REL_TOL_F64 in float64 and complex128)
   and the gathered factor against the float64 (complex128) reference;
   ``DistributedSparseLU.profile_levels`` on the float64 grid (its
   costliest levels, the solve checked after it); and the transposed
   grid: TRANS with ``condition_number`` on lap3d32u in float32 and CONJ
   on its complex twin in complex64 and complex128 (rcond in (0, 1], a
   warm call and two transposed solves bit-equal, the Uᵀ and Lᵀ sweeps'
   receive counters
   against their tapes and the solve entries with ``transpose=1``
   against their plain versions); ptxas must report no spill in any
   complex instantiation of ``rdma.cu``;
   and then the 3D communication-avoiding driver with every rank of a
   ``Grid3D(2, 2, 2)`` on the card: ``gssvx3d(A, b, grid,
   Options(dtype="float32", block_size=128, col_perm=MY_PERMC,
   user_colperm=geometric_nd((32, 32, 32)), anc25d=...))`` on lap3d32
   (the JAX package's production 3D case, whose plan must come out
   aligned) under ``"replicated"`` and ``"zsplit"``, each driven like
   the main path (every ``_f32`` entry of rdma_factor and rdma_solve
   launched, no single-device kernel), x against the single-device
   port's on the same ordering (1e-10), berr and refinement steps, the
   receive counters against the 3D receive tapes, the DIST counters
   against the partition, a warm call bit-equal to the first (its FACT /
   SOLVE / REFINE ms), every entry against its plain version level by
   level on the 3D tapes (each entry's ms, the ancestor reduction's and
   zsplit's delta's), the gathered factor against the float64 reference,
   and zsplit's x against replicated's;
12. the batch and the ring embedding:
   a. ``BatchedSparseLU`` of four float32 members on lap3d32's pattern
      (bs 128, member i's values ``A.data·(1 + 0.1·N(0, 1))`` of seed i),
      driven with every launch count set to 0 just before and read just
      after: the batched factor must make one member's launches (one per
      level per phase, the ``_batch`` entries, the member on
      ``blockIdx.z``), every member's x berr <= 1e-12; the batched FACT,
      SOLVE and REFINE ms, the refinement steps per member, the warm
      batched factor beside eight ``SparseLU`` refactors
      (SamePattern_SameRowPerm, ``executor="pallas"``) of the same
      members in the same run, one batched refinement profiled (device
      idle share); each batched kernel (diag_lu, trsm, schur, sweep)
      level by level bit-equal to its unbatched entry on every member
      and within REL_TOL of its plain version beyond an allowance, in
      float32 and complex64, of twice the plain version's own distance
      from its float64 (complex128) run in the same bs×bs tile of the
      same member (the sweep: beyond a first-order rounding bound), as
      these members have tiles with pivot growth;
   b. the same in float64, 64 members on lap3d16's pattern (bs 64);
   c. the same in complex64 and complex128, 4 members on
      helmholtz_3d(16)'s pattern (bs 64);
   d. ``gssvx_batch`` of laplacian_3d(24), fem3d_delaunay(4000) (3 dof a
      node), circuit_graph(20000) and kkt_system(10000), on the card and
      on a 2x2 grid, berr <= 1e-12 for every matrix;
   e. helmholtz_3d(32) in complex64 through the ring embedding
      (``SLU_TPU_COMPLEX=embed``): gssvx under clk, flk and the level
      executor, each in NOTRANS, TRANS and CONJ with the condition
      estimate (the float32 entries only, rcond in (0, 1]), logdet
      against the native complex64 factor's, a checkpoint round trip,
      each executor's float32 kernels against their plain versions on the
      embedded inputs, the FACT / SOLVE / REFINE ms beside the native
      complex64 rows; then gssvx_dist on a 2x2 grid the same way
      (rdma.cu's float32 entries only);
13. the pass precision (gemm_precision; the phases that pin FP32
   behaviour above, 5's flk, ILU(1) and tck, 6, 8's rows and 12e, run
   ``"highest"``): both
   bf16 entries against their plain versions at "default" level by level
   on the main path's inputs (clk_update_bf16 within BF16_TOL, four bf16
   ulps of scale, clk_trsm_bf16 within REL_TOL, each over the factor
   closer to the bf16 plain version than the FP32 plain pass is, by ten
   times; their costliest levels, bounds at the dense bf16 tensor-core
   peak); the main path's warm FACT / SOLVE / REFINE under "auto" and
   "highest" in turns (SamePattern_SameRowPerm refactors: the resolved
   precision, whether the escalation fired, the refinement steps, berr)
   and clk's kernels inside one warm factor at each precision, with
   which of the two makes FACT + REFINE shorter; the same on lap3d50
   (run inside phase 8 on its plan, the bf16 entries against their
   plain versions there too; there the bf16 factor's refinement may
   stall and escalate, and the counter and the FP32 launches must then
   say so) and the bf16 entries at bs 64 on lap3d16
   (phase 7); the ring-embedded complex64 helmholtz_3d(32) under "auto"
   (the bf16 entries only); and one escalation: ``aniso2d(128)``, whose
   bf16 factor leaves refinement stalled, must re-factor at "highest"
   (``precision_escalated``, both passes' entries launched, berr <=
   1e-12), a SamePattern_SameRowPerm refactor must then run the FP32
   entries only, and an explicit "bf16" factor must not escalate;
   13b. tck's and flk's bf16 pass (ROADMAP.md item 2b) on lap3d32:
   gssvx under "auto" through tck, flk and ILU(1) (SamePattern_SameRowPerm
   refactors of phase 5's plans), driven like the main path
   (tck_update_bf16 and clk_trsm_bf16, or flk_bf16, must launch, as
   often as the tapes say; the FP32 entries only after an escalation,
   which the counter must report), each twice with bit-equal x and equal
   refinement steps; tck_update_bf16 (phase B on the positions' chains
   cut into chunks) and flk_bf16 against their plain versions at
   "default" level by level (BF16_TOL, and closer to the bf16 plain
   version than the FP32 pass is, by ten times; their costliest levels
   and groups, bounds at the dense bf16 tensor-core peak, phase B's
   beside its time); and per
   executor FACT / SOLVE / REFINE, the steps, berr and the escalation
   under "auto" and "highest" in turns, with the executor's kernels
   inside one warm factor at each precision;
14. the package surface from outside the process, at the main path's
   width (lap3d32, bs 128, float32, "auto", refined): lap3d32 written by
   ``utils.testing.write_hb`` (.rua) and ``scipy.io.mmwrite`` (.mtx) reads
   back as one matrix through ``utils.io.read_matrix``; the C bridge
   (``libsuperlu_dist_tpu_torch``, ``superlu_dist_tpu_torch.h``) linked
   into a plain C program (``ops/host/native/bridge_solve.c``, run with
   only PYTHONPATH set: the checkout and site-packages) that reads the
   .rua, factors on the card, solves A x = A·1 with refinement and writes
   x, held to the in-process ``SparseLU`` x within 1e-12 (relative
   ∞-norm; bit-equality printed), with the link's ``sysconfig`` values,
   the subprocess's wall and its first calls' seconds; a fresh
   interpreter's gssvx under ``SLU_TPU_XPROF``, whose trace must hold the
   slu:FACT / SOLVE / REFINE spans and device-kernel events of diag_lu.cu,
   clk.cu and solve_gemm.cu (its first-call phase times printed);
   ``python -m superlu_dist_tpu_torch.utils.prewarm`` on the .rua
   (``build_s`` at most 5 s, everything being built; ``escalation_warm_s``
   > 0 after the bf16-first factor); and ``SLU_TPU_CHECKLU`` /
   ``SLU_TPU_WRITELU`` on lap3d12 in float32 under "auto" and "highest"
   (two factors' dumps equal by ``compare_lu``, the FP32 factor's
   residual below 1e-4, the bf16-first one's below the bf16 unit
   roundoff 2^-8);
15. two processes on the one card (``multiproc_phase``): the smoke
   starts two children of itself (``--child``), joined by
   ``multihost.initialize`` (gloo on 127.0.0.1), each owning half the
   ranks of the grid on ``cuda`` at the main path's width (lap3d32, bs
   128, float32); in turn: a. ``gssvx_dist`` on ``Grid2D(2, 2)`` with the
   whole A given to both; b. the same with ``local=True`` chunks of half
   the rows each; c. b under ``dist_planning`` with the user ordering
   ``geometric_nd((32, 32, 32))`` (MY_PERMC), no equilibration and no
   row permutation; d. ``gssvx3d`` on ``Grid3D(2, 2, 2)``, one layer a
   process, ``anc25d="replicated"``, as c; e. a SamePattern_SameRowPerm
   refactor of a and ``save_factors`` (written by process 0). Each child
   counts launches from 0 per case (every ``_f32`` entry of rdma_factor
   and rdma_solve must launch, no single-device kernel), holds the
   receive counters to the tapes and berr <= 1e-12, and reports FACT /
   SOLVE / REFINE device ms, its fences (count and ms) and sha256
   digests of x and of its ranks' pools. The parent runs the same cases
   in one process first (c and d with ``align_blocks="off"``, which
   builds the distributed plan) and holds both children's digests, and
   the checkpoint's arrays, to its own; it prints the per-process times
   beside the one-process ones. A child that fails or outlives its
   timeout fails the phase;
16. one JSON line of per-kernel results (the float64, complex64 and
   complex128 instantiations in rows of their own, with a ``dtype``
   field, the RDMA rows among them; the grid's transposed solves as
   ``rdma_solve_trans_*`` rows with ``"transpose": true``; the tck and
   RDMA rows with their launches per entry; the 3D grid's as
   ``rdma_factor_3d_<mode>`` and ``rdma_solve_3d_<mode>`` rows with
   ``"grid": "2x2x2"`` and their ``anc25d``; the batched kernels as
   ``<kernel>_batch[_f64|_c64|_c128]`` rows with their ``members``; the
   fused executors' rows with their ``precision``, the bf16 pass as
   ``clk_update_bf16``, ``clk_trsm_bf16``, ``tck_update_bf16`` and
   ``flk_bf16``), the
   nvidia-smi line, the seconds the run held the card, and the final
   ``{"ok": true, "device": ...}`` line.

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

#: the best IEEE rate of an H100 SXM for each type and its memory rate
#: (NVIDIA data sheet): FP32 67 TFLOP/s on the CUDA cores (TF32 is not
#: FP32); FP64 67 TFLOP/s on the tensor cores (DMMA), twice the CUDA
#: cores' 34
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "complex64": 67e12,
              "complex128": 67e12}
PEAK_BYTES = 3.35e12
#: the CUDA cores' rate for each type (the same data sheet), on which the
#: kernels run their FMAs: the share that schur's levels reach
CORE_FLOPS = {"float32": 67e12, "float64": 34e12, "complex64": 67e12,
              "complex128": 34e12}
#: real operations per real operation count of a block product (2·bs³):
#: a complex multiply-add is 8 real flops, four times a real one
FLOP_MUL = {"float32": 1, "float64": 1, "complex64": 4, "complex128": 4}
#: kernel against plain version: max |difference| <= REL_TOL * max(1,
#: max |plain output|). Both compute in float32 from the same input but
#: sum in other orders (128-long dot products, a 128-step elimination
#: whose inverses carry the tile's conditioning); 1e-4 is ~840 float32
#: ulp, while a wrong block or index gives errors of order 1. The float64
#: instantiations are held to REL_TOL_F64, ~4,500 float64 ulp.
REL_TOL = 1e-4
REL_TOL_F64 = 1e-12
#: clk's bf16 pass (gemm_precision "default") against its plain version:
#: both round the same float32 operands to bf16 (nearest even) and sum
#: exact products in float32, in other orders. clk_trsm_bf16's operands
#: are its inputs, so it is held to REL_TOL. In clk_update_bf16 a U block
#: finalized in the level, and the target sum that a finalize reads, are
#: rounded to bf16 again: where the two orders leave such a value within a
#: few float32 ulps of the midpoint of two bf16 values (about one value in
#: 2^14), they round it apart, which moves the outputs that read it by up
#: to a bf16 ulp (2^-8) of that product. So clk_update_bf16 is held to
#: BF16_TOL of scale (four bf16 ulps), which a wrong index or fragment
#: exceeds by orders of magnitude. And each bf16 kernel's summed distance
#: from its bf16 plain version must stay below BF16_FRACTION of the FP32
#: plain pass's distance from it: the kernel computes the low pass, not
#: the FP32 one.
BF16_TOL = 2.0 ** -6
BF16_FRACTION = 0.1
#: the dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet), the
#: bound of the bf16 pass's operations
BF16_PEAK_FLOPS = 989e12
#: a whole factor against the float64 right-looking reference: 512
#: float32 ulp at the pool scale, the tolerance tests/test_clk.py gives
#: random patterns (the top separator blocks of lap3d32 sum hundreds of
#: products)
FACTOR_ULPS = 512

#: the TPU kernel each port kernel replaces (file:line of its body)
REPLACES = {
    # tck's and flk's TPU kernels at precision "default" (their dot(),
    # tck.py:226 and flk.py:439 there)
    "tck_update_bf16": "superlu_dist_tpu/ops/kernels/tck.py:220",
    "flk_bf16": "superlu_dist_tpu/ops/kernels/flk.py:434",
    "diag_lu": "superlu_dist_tpu/ops/kernels/flk.py:339",
    "clk_update": "superlu_dist_tpu/ops/kernels/clk.py:248",
    "clk_trsm": "superlu_dist_tpu/ops/kernels/clk.py:248",
    # the same TPU kernel at precision "default" (its dot(), clk.py:257)
    "clk_update_bf16": "superlu_dist_tpu/ops/kernels/clk.py:248",
    "clk_trsm_bf16": "superlu_dist_tpu/ops/kernels/clk.py:248",
    "sweep": "superlu_dist_tpu/ops/kernels/pallas_exec.py:680",
    "flk": "superlu_dist_tpu/ops/kernels/flk.py:434",
    # _schur_kernel_db (on the executor's path) and _schur_kernel compute
    # the same function; one CUDA kernel stands for both
    "schur": "superlu_dist_tpu/ops/kernels/pallas_exec.py:942",
    "trsm": "superlu_dist_tpu/ops/kernels/pallas_exec.py:93",
    "solve_gemm": "superlu_dist_tpu/ops/kernels/pallas_exec.py:433",
    "diag_apply": "superlu_dist_tpu/ops/kernels/pallas_exec.py:513",
    "tck_update": "superlu_dist_tpu/ops/kernels/tck.py:220",
    "rdma_factor": "superlu_dist_tpu/parallel/dist2d_rdma.py:120",
    "rdma_solve": "superlu_dist_tpu/parallel/dist2d_rdma.py:534",
}
ALSO_REPLACES = {"schur": "superlu_dist_tpu/ops/kernels/pallas_exec.py:52"}
#: where a kernel's body lives when it is not in the source that builds it
SOURCE = {"trsm": "panel.cuh", "clk_trsm": "panel.cuh",
          "clk_trsm_bf16": "panel.cuh", "flk": "passes.cuh",
          "flk_bf16": "passes.cuh"}
#: the pass precision of each fused executor's row (the others run the
#: working type)
PRECISION = {"clk_update": "highest", "clk_trsm": "highest",
             "clk_update_bf16": "default", "clk_trsm_bf16": "default",
             "tck_update": "highest", "flk": "highest",
             "tck_update_bf16": "default", "flk_bf16": "default"}
#: clk's bf16-pass kernels, and their FP32 counterparts
BF16_KERNELS = ("clk_update_bf16", "clk_trsm_bf16")
#: tck's and flk's bf16-pass kernels (their TRSM jobs are clk_trsm_bf16)
FUSED_BF16 = ("tck_update_bf16", "flk_bf16")
#: each fused bf16 kernel's FP32 entries (which launch only after an
#: escalation) and the executor whose path it serves
FUSED_OF = {"tck_update_bf16": (("tck_update", "clk_trsm"), "tck"),
            "flk_bf16": (("flk",), "flk")}
#: the kernels with a float64 instantiation, which the float64 path runs
F64_KERNELS = ("diag_lu", "trsm", "schur", "sweep", "solve_gemm",
               "diag_apply")
#: the kernels with complex instantiations (the same), and the suffix of
#: their rows and C entries
COMPLEX_KERNELS = F64_KERNELS
CSFX = {"complex64": "c64", "complex128": "c128"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scipy.sparse.linalg as spla

    from superlu_dist_tpu_torch import Options
    from superlu_dist_tpu_torch.ops.kernels import cuda_kernels
    from superlu_dist_tpu_torch.ops import blocklu
    from superlu_dist_tpu_torch.ops.host.native import get_lib
    from superlu_dist_tpu_torch.ops.kernels import (_build, clk, diag_lu, flk,
                                                    schur, solve_gemm, sweep,
                                                    tck)
    from superlu_dist_tpu_torch.parallel import dist2d_rdma as rdma
    from superlu_dist_tpu_torch.parallel import dist3d
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    if get_lib() is None:
        fail("the native host engine did not load")
    print("native host engine: loaded", flush=True)

    # the port's one list of kernels (the driver's, which prewarm builds)
    every = cuda_kernels()
    kernels = {k: v for k, v in every.items() if k not in BATCH_OF}
    build_s = _build.build_all(list(every.values()))
    print(f"kernels built in {build_s:.1f} s", flush=True)
    for k in (diag_lu.KERNEL, clk.UPDATE, flk.KERNEL, schur.SCHUR,
              solve_gemm.SOLVE_GEMM, tck.UPDATE, rdma.RDMA_FACTOR):
        print(f"ptxas {k.source}:\n{_build.ptxas_report(k)}", end="")
    check_spills(_build.ptxas_report(schur.SCHUR), "schur_kernel")
    check_spills(_build.ptxas_report(schur.SCHUR), "schur_batch_kernel")
    for k in (diag_lu.KERNEL, schur.SCHUR, solve_gemm.SOLVE_GEMM,
              rdma.RDMA_FACTOR):
        # a complex element type, demangled or mangled (slu_cplx::real_of
        # names the real instantiations too)
        check_spills(_build.ptxas_report(k), ("cplx<", "4cplxI"), k.source)
    # complex128's trsm on the FP64 tensor cores (panel.cuh's
    # zband_times_inverse and its _batch, every block size and band)
    check_spills(_build.ptxas_report(schur.SCHUR), "zband_times_inverse",
                 "schur.cu (complex128 trsm)")
    # the bf16 pass's instantiations: waves.cuh's wave_mma_kernel (every
    # block size and strip width), and panel.cuh's trsm_mma_kernel (every
    # block size and band)
    check_spills(_build.ptxas_report(clk.UPDATE), "wave_mma_kernel",
                 "clk.cu (the bf16 waves)")
    check_spills(_build.ptxas_report(clk.UPDATE), "trsm_mma_kernel",
                 "clk.cu (the bf16 TRSM)")
    # tck's phase B and flk's chain in the bf16 pass, passes.cuh's
    # kernels and their bodies (tck.cu's wave_mma_kernel is clk.cu's,
    # checked above)
    for k in (tck.UPDATE, flk.KERNEL):
        check_spills(_build.ptxas_report(k), ("mma_kernel", "band_mma"),
                     f"{k.source} (the bf16 pass)")
    ctx = dict(torch=torch, blocklu=blocklu, clk=clk, diag_lu=diag_lu,
               flk=flk, schur=schur, sweep=sweep, solve_gemm=solve_gemm,
               tck=tck, rdma=rdma, kernels=kernels, entry_launches={},
               batch_kernels={k: every[k] for k in BATCH_OF})

    # ---- 3. the main path ---------------------------------------------
    A = laplacian_3d(32)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    b = np.asarray(A @ rng.standard_normal(n))
    opts = Options(dtype="float32", block_size=128)
    res, lu, launches = drive(ctx, "main path", A, b, opts,
                              ("diag_lu", "clk_update_bf16", "clk_trsm_bf16",
                               "sweep"), ("clk_update", "clk_trsm"))
    if res.stat.counters["gemm_precision"] != "default" or \
            "precision_escalated" in res.stat.counters:
        fail(f"main path: gemm_precision "
             f"{res.stat.counters['gemm_precision']}, escalated "
             f"{res.stat.counters.get('precision_escalated')}: not the "
             "bf16-first factor")
    plan = lu.plan
    print(f"main path: lap3d32 n={n} aligned to {plan.n} rows, "
          f"{plan.nb} block columns, {plan.nslots} slots, pool "
          f"{plan.pool_bytes(np.float32) / 2**20:.0f} MiB, "
          f"{plan.n_flevels} factor levels, {plan.lsol_nlvl}+"
          f"{plan.usol_nlvl} solve levels, {len(plan.g_l)} Schur triples, "
          f"{plan.factor_flops / 1e9:.1f} GFLOP (padded block model)")
    warm_call(ctx, "main path", A, b, opts)
    profile_refine(torch, lu, b, res.x)
    # the FP32 pass of the same path, whose launches the FP32 clk rows take
    _, lu_hi, got = drive(ctx, "main path at highest", A, b,
                          opts.replace(gemm_precision="highest"),
                          ("diag_lu", "clk_update", "clk_trsm", "sweep"),
                          BF16_KERNELS)
    launches["clk_update"] = got["clk_update"]
    launches["clk_trsm"] = got["clk_trsm"]

    # ---- 4. clk-path kernels against plain versions --------------------
    checks = check_kernels(lu_hi, ctx, launches)
    del lu_hi

    # ---- 5. the flk, ILU(1), level and tck executors -------------------
    # the FP32 pass of flk, ILU(1) and tck (their rows; "auto" factors
    # them bf16-first on the card, which phase 13b drives)
    low = BF16_KERNELS + FUSED_BF16
    paths = {
        "flk": (Options(dtype="float32", block_size=128, executor="flk",
                        gemm_precision="highest"),
                ("flk", "diag_lu", "sweep"), ("clk_update",) + low),
        "ilu1": (Options(dtype="float32", block_size=128, ilu_level=1,
                         max_refine_steps=60, refine_rthresh=1.0,
                         gemm_precision="highest"),
                 ("flk", "diag_lu", "sweep"), ("clk_update",) + low),
        "pallas": (Options(dtype="float32", block_size=128,
                           executor="pallas"),
                   ("schur", "trsm", "diag_lu", "sweep"),
                   ("clk_update", "flk") + low),
        "tck": (Options(dtype="float32", block_size=128, executor="tck",
                        gemm_precision="highest"),
                ("tck_update", "diag_lu", "clk_trsm", "sweep"),
                ("clk_update", "flk", "schur") + low),
    }
    lus, got = {}, {}
    for name, (o, need, zero) in paths.items():
        r, lus[name], got[name] = drive(ctx, name, A, b, o, need, zero)
        if name == "flk":   # its passes' launches, before the warm call
            e = ctx["entry_launches"]["flk"] = dict(
                flk.KERNEL.entry_launches)
            if not all(e.values()):
                fail(f"an entry of flk was not launched on its path: {e}")
        print(f"{name}: {lus[name].plan.nslots} slots, {r.stat.refine_steps}"
              f" refinement steps, executor {r.stat.counters['executor']}",
              flush=True)
        r2 = warm_call(ctx, name, A, b, o)
        if name == "pallas":
            ctx["level_fact_ms"] = r2.stat.device_ms["FACT"]
        if name == "ilu1":
            check_repeat("ILU(1) lap3d32", r, r2)
    # each new kernel's launches come from the path that it serves
    launches["flk"] = got["flk"]["flk"]
    launches["schur"] = got["pallas"]["schur"]
    launches["trsm"] = got["pallas"]["trsm"]
    checks.update(check_flk(lus["flk"], ctx, report=True))
    o = check_flk(lus["ilu1"], ctx, report=False)["flk"]
    print(f"ILU(1) flk: max_abs_err {o['max_abs_err']:.3e} (tolerance "
          f"{o['tol']:.3e}), {got['ilu1']['flk']} launches on its path",
          flush=True)
    checks.update(check_level(lus["pallas"], ctx, report=True))
    for name in ("flk", "schur", "trsm"):
        print_check(name, checks[name], launches[name])
    o = check_tck(lus["tck"], ctx, report=True)["tck_update"]
    print(f"lap3d32 tck_update: max_abs_err {o['max_abs_err']:.3e} "
          f"(tolerance {o['tol']:.3e}); kernel {o['ms']:.3f} ms, plain "
          f"{o['plain_ms']:.3f} ms, bound {o['bound_ms']:.4f} ms "
          f"({o['bound_by']}); clk_update on the same plan "
          f"{checks['clk_update']['ms']:.3f} ms; {got['tck']['tck_update']}"
          f" launches on its path", flush=True)
    profile_phase(lus["pallas"], A, b)
    del lus["pallas"]

    # ---- 6. the transposed path, the condition estimate, reuse ---------
    got = trans_phase(ctx, rng, lu, checks)
    launches["solve_gemm"] = got["solve_gemm"]
    launches["diag_apply"] = got["diag_apply"]
    for name in ("solve_gemm", "diag_apply"):
        print_check(name, checks[name], launches[name])

    # ---- 7. the Options default block size ----------------------------
    A2 = laplacian_3d(16)
    b2 = np.asarray(A2 @ rng.standard_normal(A2.shape[0]))
    x_ref = spla.spsolve(A2.tocsc(), b2)
    for executor in ("clk", "flk", "pallas", "tck", "xla"):
        res2, lu2, _ = drive(ctx, f"bs=64 {executor}", A2, b2, Options(
            dtype="float32", block_size=64, executor=executor), ())
        err2 = float(np.abs(res2.x - x_ref).max() / np.abs(x_ref).max())
        print(f"bs=64 {executor}: lap3d16 |x - scipy|/|x| {err2:.3e} "
              f"(tolerance 1e-10)", flush=True)
        if err2 > 1e-10:
            fail(f"bs=64 {executor} solution disagrees with scipy")
        c64 = {"clk": check_kernels, "flk": check_flk, "pallas": check_level,
               "tck": check_tck, "xla": check_level}[executor](lu2, ctx,
                                                                None)
        if executor == "clk":
            c64.update(check_bf16(lu2, ctx))
        if executor in ("tck", "flk"):
            c64.update(check_fused_bf16(lu2, ctx))
        for name, c in c64.items():
            print(f"bs=64 {name}: max_abs_err {c['max_abs_err']:.3e} "
                  f"(tolerance {c['tol']:.3e})", flush=True)

    # ---- 8. tck at full width on lap3d50 -------------------------------
    tck_phase(ctx, rng, checks, launches)

    # ---- 9. float64 on the card ---------------------------------------
    f64_phase(ctx, rng, checks, launches)

    # ---- 10. complex on the card ---------------------------------------
    complex_phase(ctx, rng, checks, launches)

    # ---- 11. the 2D and 3D grids on one card ----------------------------
    dist_phase(ctx, rng, checks, launches)
    grid_types_phase(ctx, rng, checks, launches)

    dist3d_phase(ctx, rng, checks, launches)

    # ---- 12. the batch and the ring embedding ---------------------------
    batch_phase(ctx, rng, checks, launches)
    embed_phase(ctx, rng, checks, launches)

    # ---- 13. the pass precision ---------------------------------------
    precision_phase(ctx, rng, checks, launches, A, b, opts, lu)
    fused_precision_phase(ctx, checks, launches, A, b, lus)
    del lus

    # ---- 14. the package surface from outside the process -------------
    surface_phase(smi)

    # ---- 15. two processes on the one card ------------------------------
    two = multiproc_phase(smi)

    rows = []
    for name, dtype, key in \
            [(k, "float32", k) for k in kernels] + \
            [(k, "float64", f"{k}_f64") for k in F64_KERNELS + GRID_NEED] + \
            [(k, d, f"{k}_{CSFX[d]}") for d in CSFX
             for k in COMPLEX_KERNELS + GRID_NEED] + \
            [("rdma_solve", d, f"rdma_solve_trans_{SFX[d]}")
             for d, _, _ in GRID_TRANS]:
        c = checks[key]
        row = dict(
            name=key, route="cuda",
            source=("superlu_dist_tpu_torch/ops/kernels/csrc/"
                    f"{SOURCE.get(name, kernels[name].source)}"),
            replaces=REPLACES[name], launches=launches[key],
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            per=c["per"], dtype=dtype)
        if key in ctx["entry_launches"]:
            row["entry_launches"] = ctx["entry_launches"][key]
        if key in PRECISION:
            row["precision"] = PRECISION[key]
        if key.startswith("rdma_solve_trans"):
            row["transpose"] = True
        if key in two:
            # each child's launches per entry over phase 15's cases
            row["two_process_launches"] = two[key]
        if name in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[name]
        rows.append(row)
    for mode in dist3d.ANC25D:
        for name in GRID_NEED:
            key = f"{name}_3d_{mode}"
            c = checks[key]
            rows.append(dict(
                name=key, route="cuda",
                source=("superlu_dist_tpu_torch/ops/kernels/csrc/"
                        f"{kernels[name].source}"),
                replaces=REPLACES[name], launches=launches[key],
                max_abs_err=c["max_abs_err"], ms=c["ms"],
                plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                bound_by=c["bound_by"], library_ms=c["library_ms"],
                per=c["per"], dtype="float32", grid="2x2x2", anc25d=mode,
                entry_launches=ctx["entry_launches"][key]))
    for dtype, sfx in BATCH_SFX.items():
        for name, base in BATCH_OF.items():
            key = name + sfx
            c = checks[key]
            rows.append(dict(
                name=key, route="cuda",
                source=("superlu_dist_tpu_torch/ops/kernels/csrc/"
                        f"{SOURCE.get(base, kernels[base].source)}"),
                replaces=REPLACES[base], launches=launches[key],
                max_abs_err=c["max_abs_err"], excess=c["excess"],
                ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                bound_by=c["bound_by"], library_ms=c["library_ms"],
                per=c["per"], dtype=dtype, members=c["members"]))
    print(json.dumps({"kernels": rows}))
    print(f"smoke held the card {time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_spills(report, name, what=""):
    """Fail unless ptxas lists functions whose name holds ``name`` (or
    one of a tuple of names) in ``report`` and none of them spills
    registers."""
    names = (name,) if isinstance(name, str) else name
    fn, seen = None, 0
    for line in report.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1]
        elif "spill stores" in line and fn is not None and \
                any(n in fn for n in names):
            seen += 1
            if ", 0 bytes spill stores, 0 bytes spill loads" not in line:
                fail(f"{names[0]} spills: {fn.strip()}: {line.strip()}")
    if not seen:
        fail(f"ptxas lists no {names[0]} {what}")
    print(f"ptxas: {seen} functions of {names[0]} {what}, none spills",
          flush=True)


def on_grid(A, b, grid, opts):
    """``gssvx_dist`` over a 2D grid, ``gssvx3d`` over a 3D one."""
    from superlu_dist_tpu_torch import gssvx3d, gssvx_dist
    return (gssvx3d if len(grid.shape) == 3 else gssvx_dist)(A, b, grid,
                                                             opts)


def drive(ctx, what, A, b, opts, need, zero=(), lu=None, grid=None):
    """One ``gssvx`` call (``gssvx_dist`` or ``gssvx3d`` over ``grid``)
    with every launch count set to 0 just before and read just after;
    checks the accuracy limits (in Aᵀ under ``opts.trans``), that every
    kernel of ``need`` launched and that none of ``zero`` did. ``lu`` is
    passed on for the reuse modes."""
    from superlu_dist_tpu_torch import Trans, gssvx
    torch = ctx["torch"]
    for k in ctx["kernels"].values():
        k.reset_counts()
    t0 = time.perf_counter()
    if grid is None:
        res, lu = gssvx(A, b, opts, lu=lu)
    else:
        res, lu = on_grid(A, b, grid, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ctx["kernels"].items()}
    op, tag = {Trans.NOTRANS: (A, "A"), Trans.TRANS: (A.T, "A^T"),
               Trans.CONJ: (A.conj().T, "A^H")}[Trans(opts.trans)]
    resid = float(np.abs(op @ res.x - b).max() / np.abs(b).max())
    berr = float(np.max(res.berr))
    print_phases(what, wall, res.stat)
    print(f"{what}: berr {berr:.3e}, ||{tag}x-b||/||b|| {resid:.3e}, tiny "
          f"pivots {res.stat.tiny_pivots}, launches {launches}", flush=True)
    if not np.all(np.isfinite(res.x)) or res.x.shape != (A.shape[0],):
        fail(f"{what}: solution not finite or of the wrong shape")
    if berr > 1e-12 or resid > 1e-10:
        fail(f"{what} accuracy: berr {berr:.3e} (<= 1e-12), residual "
             f"{resid:.3e} (<= 1e-10)")
    for name in need:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {what} path")
    for name in zero:
        if launches[name] != 0:
            fail(f"kernel {name} was launched on the {what} path")
    return res, lu, launches


def warm_call(ctx, what, A, b, opts, grid=None):
    """The same call again, with kernels loaded and allocator warm: the
    first call's phases also hold one-time module loads. Returns its
    result."""
    from superlu_dist_tpu_torch import gssvx
    t0 = time.perf_counter()
    res, _ = gssvx(A, b, opts) if grid is None else on_grid(A, b, grid,
                                                            opts)
    ctx["torch"].cuda.synchronize()
    print_phases(f"{what}, second call", time.perf_counter() - t0, res.stat)
    if float(np.max(res.berr)) > 1e-12:
        fail(f"{what} second call: berr {np.max(res.berr):.3e} > 1e-12")
    return res


def check_repeat(what, first, second):
    """Two calls of one system give bit-equal x and the same refinement
    steps (every sum of the path has a fixed order on the card)."""
    same = np.array_equal(first.x, second.x)
    steps = (first.stat.refine_steps, second.stat.refine_steps)
    print(f"{what}: two calls bit-equal x {same}, refinement steps "
          f"{steps[0]} / {steps[1]}", flush=True)
    if not same or steps[0] != steps[1]:
        fail(f"{what}: two calls of the same system differ")


def print_phases(what, wall, st):
    """A gssvx call's wall seconds, its phases' CUDA-event ms (the stream's
    elapsed time, host gaps included; SOLVE also counts the solves inside
    RCOND) and its host seconds per phase."""
    rc = (f", rcond {st.device_ms['RCOND']:.3f}" if "RCOND" in st.device_ms
          else "")
    print(f"{what}: gssvx wall {wall:.2f} s; device ms: factor "
          f"{st.device_ms['FACT']:.3f}, solve {st.device_ms['SOLVE']:.3f}, "
          f"refine {st.device_ms['REFINE']:.3f} ({st.refine_steps} steps)"
          f"{rc}; host s: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in sorted(st.utime.items())),
          flush=True)


def profile_refine(torch, lu, b, x, what=""):
    """Where the time of one refinement goes: ``torch.profiler`` over a
    refine call from the f32 solution (one SpMV residual, one L+U solve
    per step), summed by device kernel; the device's idle share is 1 -
    busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    x0 = lu.solve(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lu.refine(b, x0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device kernels and copies only: a CPU operator carries the device
    # time of the kernels it launched, and the ``slu:`` phase spans show a
    # device range, so either would count the same time twice
    rows = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0
            and not e.key.startswith("slu:")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"{what}profile of one refine ({lu.stat.refine_steps} steps): "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:90]}")


#: device buffer written before each timed call, five times the H100's
#: 50 MB L2, so that no call finds its inputs left in L2 by the one before
#: (the library call of a level reads the same blocks as its kernel)
_FLUSH = []
FLUSH_BYTES = 256 << 20


def _flush(torch):
    """Write the flush buffer (made on first use)."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    _FLUSH[0].zero_()


def _timed(torch, fn):
    """Device ms of ``fn`` by CUDA events, with L2 flushed before."""
    _flush(torch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


#: the wider type a float32 (complex64) plain version's own error is read
#: against
WIDER = {"float32": "float64", "complex64": "complex128"}


def own_slack(torch, plain):
    """The allowance of a batched level kernel in float32 (complex64):
    twice the plain version's own error, bs×bs tile by tile. The plain
    version runs again on the same input in float64 (complex128); in
    each tile of each member the allowance is twice the largest distance
    between its float32 and its float64 outputs there. A tile with pivot
    growth makes that distance larger than REL_TOL of scale for any
    float32 algorithm; every other tile keeps its own, small allowance,
    so an error of order 1 in it still fails. Returns ``slack(state,
    want)`` for ``Checker.compare``: None in float64 and complex128,
    which have no wider type on the card (REL_TOL_F64 holds there)."""
    def fl(t):
        return t.is_floating_point() or t.is_complex()

    def slack(state, want):
        wide = WIDER.get(str(want[0].dtype)[6:])
        if wide is None:
            return None
        wide = getattr(torch, wide)
        q = [t.to(wide) if fl(t) else t.clone() for t in state]
        plain(*q)
        out = []
        for x, y in zip(want, q):
            if fl(x) and x.dim() >= 2:
                # member by member: a float64 copy of a whole stacked pool
                # is large enough
                e = torch.stack([(x[m].to(wide) - y[m]).abs().amax(
                    dim=(-2, -1), keepdim=True) for m in range(x.shape[0])])
                out.append(2 * e.to(x.real.dtype))
            elif fl(x):
                out.append(2 * (x.to(wide) - y).abs().to(x.real.dtype))
            else:
                out.append(torch.zeros((), device=x.device))
            del y
        del q
        return out
    return slack


class Checker:
    """Kernel-against-plain comparisons of one factor (or solve): per
    kernel the max abs error, its tolerance and the summed kernel and
    plain ms."""

    def __init__(self, torch, bs, names, library=()):
        self.torch = torch
        self.bs = bs
        self.out = {k: dict(max_abs_err=0.0, tol=0.0, ms=0.0, plain_ms=0.0,
                            library_ms=0.0 if k in library else None)
                    for k in names}

    def compare(self, name, kern, plain, state, slack=None):
        """Run kernel and plain on copies of ``state``; keep the kernel's
        copy. Returns it and the kernel's ms. ``slack(state, want)``
        gives, for the plain outputs ``want``, allowances that broadcast
        to the outputs' shapes (or None): the kernel is then held within
        the tolerance beyond them (:meth:`record`)."""
        torch = self.torch
        a = [t.clone() for t in state]
        p = [t.clone() for t in state]
        ms = _timed(torch, lambda: kern(*a))
        plain_ms = _timed(torch, lambda: plain(*p))
        self.record(name, ms, plain_ms, a, p, slack and slack(state, p))
        return a, ms

    def record(self, name, ms, plain_ms, got, want, slack=None, rel=None):
        """Add a kernel's and its plain version's ms to ``name`` and hold
        the kernel's outputs ``got`` to the plain ones ``want``: within
        the type's relative tolerance of their scale (``rel`` where it is
        given), beyond the elementwise allowance ``slack`` where it is
        given. ``excess`` is the worst distance beyond the allowance,
        ``max_slack`` the largest allowance."""
        o = self.out[name]
        o["ms"] += ms
        o["plain_ms"] += plain_ms
        diffs = [(x - y).abs() for x, y in zip(got, want)]
        err = max(float(d.max()) for d in diffs)
        over, big = err, 0.0
        if slack is not None:
            if any(self.torch.broadcast_shapes(d.shape, s.shape) != d.shape
                   for d, s in zip(diffs, slack)):
                fail(f"{name}: an allowance that does not fit its output")
            over = max(float((d - s).clamp(min=0).max())
                       for d, s in zip(diffs, slack))
            big = max(float(s.max()) for s in slack)
        scale = max(1.0, max(float(y.abs().max()) for y in want))
        dtype = want[0].dtype
        if rel is None:
            rel = REL_TOL_F64 if dtype in (self.torch.float64,
                                           self.torch.complex128) \
                else REL_TOL
        tol = rel * scale
        o["max_abs_err"] = max(o["max_abs_err"], err)
        o["tol"] = max(o["tol"], tol)
        o["excess"] = max(o.get("excess", 0.0), over)
        o["max_slack"] = max(o.get("max_slack", 0.0), big)
        if over > tol:
            fail(f"{name} (bs={self.bs}, {dtype}) disagrees with its "
                 f"plain version: {over:.3e} > {tol:.3e} (beyond the "
                 f"allowance where one is given; the largest {big:.3e})")

    def library(self, name, fn):
        """One untimed call first: the kernels ran warm on their path, so
        cuBLAS's first call at a shape is left out too."""
        fn()
        self.out[name]["library_ms"] += _timed(self.torch, fn)


def _state(lu, torch, blocklu):
    plan, dev = lu.plan, lu.device
    bs, nb = plan.bs, plan.nb
    pool = blocklu.init_pool(plan, lu._a3_data, lu._fdtype, dev)
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=dev)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    return pool, linv, uinv, tiny


def check_whole_factor(what, lu, ctx, pool, tiny):
    """A whole factor against the right-looking reference on its plan,
    in float64 (complex128 for a complex factor)."""
    blocklu = ctx["blocklu"]
    plan = lu.plan
    rdt = np.complex128 if lu._fdtype.kind == "c" else np.float64
    ref, _, _, _ = blocklu.factor_plain(
        plan, blocklu.init_pool(plan, lu._a3_data, rdt, lu.device),
        lu._thresh())
    ns = plan.nslots
    scale = max(1.0, float(ref[:ns].abs().max()))
    ferr = float((pool[:ns].to(ref.dtype) - ref[:ns]).abs().max())
    ftol = FACTOR_ULPS * float(np.finfo(lu._fdtype).eps) * scale
    print(f"bs={plan.bs}: {what} factor vs {np.dtype(rdt).name} "
          "right-looking reference:"
          f" max abs err {ferr:.3e} (tolerance {ftol:.3e}); tiny pivots "
          f"{int(tiny.item())}", flush=True)
    if ferr > ftol:
        fail(f"{what} factor disagrees with the float64 reference")


def print_check(name, o, launches):
    lib = "none" if o["library_ms"] is None else f"{o['library_ms']:.3f} ms"
    own = (f", {o['excess']:.3e} beyond its allowance (largest "
           f"{o['max_slack']:.3e})" if o.get("max_slack") else "")
    print(f"{name}: max_abs_err {o['max_abs_err']:.3e}{own} (tolerance "
          f"{o['tol']:.3e}); kernel {o['ms']:.3f} ms, plain "
          f"{o['plain_ms']:.3f} ms, library {lib}, bound "
          f"{o['bound_ms']:.4f} ms ({o['bound_by']}) per {o['per']}; "
          f"{launches} launches on its path", flush=True)


def check_kernels(lu, ctx, launches, levels=False):
    """Each clk-path kernel against its plain version on ``lu``'s plan,
    level by level: both get the same input and the factor goes on with
    the kernel's output. Returns per kernel the max abs error, its
    tolerance, the summed kernel and plain ms of one factor (one L+U solve
    for the sweep) and the bound of that work. With ``launches`` (or
    ``levels``) it prints clk_update's costliest levels."""
    torch, clk, diag_lu, sweep = (ctx[k] for k in
                                  ("torch", "clk", "diag_lu", "sweep"))
    plan, tp, dev = lu.plan, lu._ftapes, lu.device
    bs, nb = plan.bs, plan.nb
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    # library_ms: clk_trsm is a batched product per level, timed as one
    # torch.bmm on the level's gathered L blocks and U inverses; diag_lu as
    # three calls per level on the gathered tiles (diag_library), which do
    # not replace tiny pivots. No one PyTorch call computes clk_update (a
    # chain of dependent products per column) or the sweep (a level of a
    # block-sparse triangular solve), so theirs stays None.
    ck = Checker(torch, bs, ("diag_lu", "clk_update", "clk_trsm", "sweep"),
                 library=("clk_trsm", "diag_lu"))

    per_level, per_panel, per_diag = [], [], []
    for lvl in range(tp.nlvl):
        (pool,), ms = ck.compare(
            "clk_update", lambda p: clk.clk_update(p, linv, tp, lvl),
            lambda p: clk.clk_update_plain(p, linv, tp, lvl), [pool])
        per_level.append((ms, lvl))
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        ds, dk = tp.dslot[lo:hi], tp.dstep[lo:hi]
        diag_library(ck, pool, ds)
        (pool, linv, uinv, tiny), ms = ck.compare(
            "diag_lu",
            lambda p, li, ui, t: diag_lu.diag_lu(p, li, ui, ds, dk, th, t),
            lambda p, li, ui, t: diag_lu.diag_lu_plain(
                p, li, ui, ds.long(), dk.long(), th, t),
            [pool, linv, uinv, tiny])
        per_diag.append((ms, hi - lo, f"level {lvl}"))
        lo, hi = int(tp.lptr[lvl]), int(tp.lptr[lvl + 1])
        if hi > lo:
            Lg = pool[tp.lslot[lo:hi].long()]
            Ug = uinv[tp.lstep[lo:hi].long()]
            C = torch.empty_like(Lg)
            ck.library("clk_trsm", lambda: torch.bmm(Lg, Ug, out=C))
            del Lg, Ug, C
        (pool,), ms = ck.compare(
            "clk_trsm", lambda p: clk.clk_trsm(p, uinv, tp, lvl),
            lambda p: clk.clk_trsm_plain(p, uinv, tp, lvl), [pool])
        if hi > lo:
            per_panel.append((ms, hi - lo, f"level {lvl}"))
    if levels or launches is not None:
        print_update_levels(tp, per_level, bs)
        print_panel_levels("clk_trsm", per_panel)
        print_panel_levels("diag_lu", per_diag, "tiles", small=5)
    check_whole_factor("clk", lu, ctx, pool, tiny)
    check_sweep(lu, ctx, ck)

    out = ck.out
    bounds = work_bounds(plan, tp, lu)
    for name, o in out.items():
        o.update(bounds[name])
        if launches is not None:
            print_check(name, o, launches[name])
    return out


def diag_library(ck, pool, ds, name="diag_lu"):
    """diag_lu's library time on one level: ``lu_factor_ex`` without
    pivoting, then L⁻¹ and U⁻¹ by ``solve_triangular`` against I, each
    reading its triangle of the compact LU: three calls on the gathered
    tiles (of every member of a stacked pool), with no tiny-pivot
    replacement; added to ``name``."""
    torch = ck.torch
    if len(ds) == 0:
        return
    G = pool[ds.long()] if pool.dim() == 3 else \
        pool[:, ds.long()].reshape(-1, *pool.shape[-2:])
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device).expand_as(G)

    def lib():
        LU = torch.linalg.lu_factor_ex(G, pivot=False).LU
        torch.linalg.solve_triangular(LU, eye, upper=False,
                                      unitriangular=True)
        torch.linalg.solve_triangular(LU, eye, upper=True)
    ck.library(name, lib)


def check_sweep(lu, ctx, ck):
    """The NOTRANS sweep (both passes of ``solve_level`` with
    ``transpose=False``, one timed call per level) against its plain
    version ``sweep_level_plain`` over one L+U solve of a right-hand side,
    level by level, into ``ck``'s "sweep" entry; an untimed solve first
    loads the kernels."""
    torch, sweep, sg = ctx["torch"], ctx["sweep"], ctx["solve_gemm"]
    plan = lu.plan
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.standard_normal((plan.nb, plan.bs, 1)),
                        dtype=lu.pool.dtype, device=lu.device)
    tapes = ((lu._ltape, lu.linv), (lu._utape, lu.uinv))
    warm_solve(sg, lu.pool, tapes, X, False)
    for tape, dinv in tapes:
        for lvl in range(tape.nlvl):
            (X,), _ = ck.compare(
                "sweep", lambda x: sg.solve_level(lu.pool, dinv, x, tape,
                                                  lvl, False),
                lambda x: sweep.sweep_level_plain(lu.pool, dinv, x, tape,
                                                  lvl), [X])


def check_tck(lu, ctx, report):
    """tck_update against its plain version on ``lu``'s tck plan, level by
    level and phase by phase (phase A, the U blocks in waves; phase B, the
    tiles), diag_lu and clk_trsm running as kernels after them, then the
    whole factor against the float64 reference. No one PyTorch call
    computes tck_update (per column a chain of dependent products), so
    its library_ms stays None. It computes clk_update's function, so its
    bound is clk_update's on the same plan."""
    torch, tck, clk, diag_lu = (ctx[k] for k in ("torch", "tck", "clk",
                                                 "diag_lu"))
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    ck = Checker(torch, plan.bs, ("tck_update",))
    per_level = []
    for lvl in range(tp.nlvl):
        (pool,), ms_a = ck.compare(
            "tck_update", lambda p: tck.tck_waves(p, linv, tp, lvl),
            lambda p: tck.tck_waves_plain(p, linv, tp, lvl), [pool])
        (pool,), ms_b = ck.compare(
            "tck_update", lambda p: tck.tck_tiles(p, tp, lvl),
            lambda p: tck.tck_tiles_plain(p, tp, lvl), [pool])
        per_level.append((ms_a + ms_b, ms_a, ms_b, lvl))
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        th, tiny)
        clk.clk_trsm(pool, uinv, tp, lvl)
    if report:
        print_tck_levels(tp, per_level)
    check_whole_factor("tck", lu, ctx, pool, tiny)
    ck.out["tck_update"].update(update_bound(
        plan, clk.build_clk_tapes(plan, "cpu"), lu._fdtype))
    return ck.out


def check_flk(lu, ctx, report):
    """flk_update against its plain version on ``lu``'s flk plan, level by
    level (diag_lu runs as the kernel between the two groups). No one
    PyTorch call computes flk (per target a chain of products, then a
    product by a stored inverse), so its library_ms stays None."""
    torch, flk, diag_lu = ctx["torch"], ctx["flk"], ctx["diag_lu"]
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    ck = Checker(torch, plan.bs, ("flk",))
    per_group = []
    for lvl in range(tp.nlvl):
        for g in (2 * lvl, 2 * lvl + 1):
            (pool,), ms = ck.compare(
                "flk", lambda p: flk.flk_update(p, linv, uinv, tp, g),
                lambda p: flk.flk_update_plain(p, linv, uinv, tp, g), [pool])
            per_group.append((ms, g))
            if g == 2 * lvl:
                lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
                diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                                tp.dstep[lo:hi], th, tiny)
    what = "ILU(1) flk" if lu.options.ilu_level is not None else "flk"
    if report:
        print_flk_groups(tp, per_group, plan.bs)
    check_whole_factor(what, lu, ctx, pool, tiny)
    ck.out["flk"].update(flk_bounds(plan, tp, flk))
    return ck.out


def check_level(lu, ctx, report, full=False):
    """trsm (both flags) and schur against their plain versions on
    ``lu``'s plan, level by level (diag_lu runs as the kernel; with
    ``full`` it is compared too, and so is the sweep over one L+U solve).
    library_ms: trsm is a batched product, timed as one torch.bmm per
    panel list per level on the gathered panels and inverses; no one
    PyTorch call computes schur (per target a sum of products of gathered
    blocks; an ``index_add_`` of batched products is two calls and a
    temporary of every product), so its library_ms stays None."""
    torch, schur, diag_lu = ctx["torch"], ctx["schur"], ctx["diag_lu"]
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    ck = Checker(torch, plan.bs, ("schur", "trsm") + (
        ("diag_lu", "sweep") if full else ()),
        library=("trsm", "diag_lu") if full else ("trsm",))
    per_level, per_panel, per_diag = [], [], []
    for lvl in range(tp.nlvl):
        d = slice(int(tp.dptr[lvl]), int(tp.dptr[lvl + 1]))
        ds, dk = tp.dslot[d], tp.dstep[d]
        if full:
            diag_library(ck, pool, ds)
            (pool, linv, uinv, tiny), ms = ck.compare(
                "diag_lu",
                lambda p, li, ui, t: diag_lu.diag_lu(p, li, ui, ds, dk, th,
                                                     t),
                lambda p, li, ui, t: diag_lu.diag_lu_plain(
                    p, li, ui, ds.long(), dk.long(), th, t),
                [pool, linv, uinv, tiny])
            per_diag.append((ms, d.stop - d.start, f"level {lvl}"))
        else:
            diag_lu.diag_lu(pool, linv, uinv, ds, dk, th, tiny)
        for left, dinv, sl, st, ptr in (
                (False, uinv, tp.lslot, tp.lstep, tp.lptr),
                (True, linv, tp.uslot, tp.ustep, tp.uptr)):
            s = slice(int(ptr[lvl]), int(ptr[lvl + 1]))
            if s.stop > s.start:
                Xg, Dg = pool[sl[s].long()], dinv[st[s].long()]
                C = torch.empty_like(Xg)
                ck.library("trsm", (lambda: torch.bmm(Dg, Xg, out=C)) if left
                           else (lambda: torch.bmm(Xg, Dg, out=C)))
                del Xg, Dg, C
            (pool,), ms = ck.compare(
                "trsm", lambda p: schur.trsm(p, dinv, sl[s], st[s], left),
                lambda p: schur.trsm_plain(p, dinv, sl[s], st[s], left),
                [pool])
            if s.stop > s.start:
                per_panel.append((ms, s.stop - s.start,
                                  f"level {lvl} {'U' if left else 'L'}"))
        (pool,), ms = ck.compare(
            "schur", lambda p: schur.schur(p, tp, lvl),
            lambda p: schur.schur_plain(p, tp, lvl), [pool])
        per_level.append((ms, lvl))
    if report:
        print_schur_levels(tp, per_level, plan.bs, lu._fdtype)
        print_panel_levels("trsm", per_panel)
        if full:
            print_panel_levels("diag_lu", per_diag, "tiles", small=5)
    check_whole_factor("level executor", lu, ctx, pool, tiny)
    b = level_bounds(plan, tp, lu._fdtype)
    if full:
        check_sweep(lu, ctx, ck)
        b.update(diag_bound(plan, lu._fdtype), sweep=sweep_bound(plan, lu))
    for name, o in ck.out.items():
        o.update(b[name])
    return ck.out


def trans_phase(ctx, rng, lu_main, checks):
    """Phase 6: the TRANS + condition_number path on lap3d32u, the reuse
    modes, solve_gemm and diag_apply against their plain versions, and
    the block size 64 checks. Adds the two kernels to ``checks``; returns
    the launches of the TRANS call."""
    from superlu_dist_tpu_torch import Fact, Options, Trans
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d_unsym
    A = laplacian_3d_unsym(32)
    n = A.shape[0]
    b = rng.standard_normal(n)
    # the FP32 pass, as before the bf16 pass existed: the FP32 clk
    # kernels, rcond's and the refinement's steps (phase 13 runs bf16-first)
    opts = Options(dtype="float32", block_size=128, trans=Trans.TRANS,
                   condition_number=True, gemm_precision="highest")
    res, lu, got = drive(ctx, "trans", A, b, opts, (
        "solve_gemm", "diag_apply", "diag_lu", "clk_update", "clk_trsm",
        "sweep"))
    st = res.stat
    if res.rcond is None or not 0 < res.rcond <= 1 or "RCOND" not in \
            st.utime:
        fail(f"trans: rcond {res.rcond} not in (0, 1] or no RCOND phase")
    print(f"trans: rcond {res.rcond:.6e} after {st.counters['rcond_iters']}"
          f" Hager steps (converged {st.counters['rcond_converged']}), "
          f"{st.refine_steps} refinement steps; lap3d32u {lu.plan.nslots} "
          f"slots (main path {lu_main.plan.nslots})", flush=True)
    for name, tape in zip(("U^T", "L^T"), lu._ttapes):
        chain = np.diff(tape.host["rowptr"])
        print(f"{name} sweep: {tape.nlvl} levels, {len(tape.host['cslot'])}"
              f" triples, longest destination chain {chain.max()}",
              flush=True)
    warm_call(ctx, "trans", A, b, opts)
    check_trans_repeat("trans", lu, b)

    # the reuse modes (pddrive1/2/3), on values perturbed from a seed
    pr = np.random.default_rng(7)

    def perturb(M):
        M = M.copy()
        M.data = M.data * (1.0 + 0.05 * pr.standard_normal(M.nnz))
        return M

    ropts = opts.replace(condition_number=False)
    A2, plan0 = perturb(A), lu.plan
    r, lu, _ = drive(ctx, "SamePattern_SameRowPerm", A2, b, ropts.replace(
        fact=Fact.SAME_PATTERN_SAME_ROWPERM), ("clk_update", "diag_lu",
                                               "solve_gemm", "diag_apply"),
        lu=lu)
    if set(r.stat.utime) & {"EQUIL", "ROWPERM", "COLPERM"} \
            or lu.plan is not plan0:
        fail("SamePattern_SameRowPerm redid preprocessing or the plan")
    A3, colperm0 = perturb(A2), lu.colperm.copy()
    r, lu, _ = drive(ctx, "SamePattern", A3, b, ropts.replace(
        fact=Fact.SAME_PATTERN), ("clk_update", "diag_lu", "solve_gemm",
                                  "diag_apply"), lu=lu)
    if "ROWPERM" not in r.stat.utime or not np.array_equal(lu.colperm,
                                                          colperm0):
        fail("SamePattern skipped row matching or changed the column order")
    drive(ctx, "FACTORED", A3, rng.standard_normal(n), ropts.replace(
        fact=Fact.FACTORED), ("solve_gemm", "diag_apply"),
        ("clk_update", "diag_lu"), lu=lu)

    checks.update(check_solve(lu, ctx, lu_main))
    trans_bs64(ctx, rng)
    return got


def check_trans_repeat(what, lu, b, trans=None):
    """Two transposed solves (``trans``, TRANS by default) of one b give
    bit-equal x."""
    from superlu_dist_tpu_torch import Trans
    trans = trans or Trans.TRANS
    same = np.array_equal(lu.solve(b, trans=trans), lu.solve(b, trans=trans))
    print(f"{what}: two transposed solves of one b bit-equal {same}",
          flush=True)
    if not same:
        fail(f"{what}: two transposed solves of one b differ")


def check_solve(lu, ctx, lu_main):
    """The transposed solve's kernels against their plain versions on
    ``lu``, level by level from the same X over one transposed solve (Uᵀ,
    then Lᵀ) of one right-hand side, the solve going on with the kernel's
    output: solve_level (pass 1 over the level's chunks, then the fused
    pass 2) against solve_level_plain; pass 1's time is solve_gemm's,
    pass 2's diag_apply's, and the plain versions are timed phase by
    phase. library_ms, each timed warm into a preallocated output:
    solve_gemm is X − M·X with M the level's block-sparse matrix of
    op(pool[slot]) at (dst, src), one ``torch.addmm`` of a BSR tensor
    (cuSPARSE), held against the plain solve_gemm's output too;
    diag_apply is a batched product per level, one ``torch.bmm`` on the
    gathered Dinv[I]ᵀ and X[I]. Returns these numbers; then prints the
    pair against the library pair at 32 right-hand sides, and
    ``lu_main``'s NOTRANS L+U solve (:func:`notrans_solve`)."""
    torch, sg = ctx["torch"], ctx["solve_gemm"]
    plan = lu.plan
    tu, tl = lu._ttapes
    tapes = ((tu, lu.uinv), (tl, lu.linv))
    bsr = bsr_served(torch, lu.pool.dtype)
    ck = Checker(torch, plan.bs, ("solve_gemm", "diag_apply"),
                 library=("solve_gemm", "diag_apply") if bsr
                 else ("diag_apply",))
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.standard_normal((plan.nb, plan.bs, 1)),
                        dtype=lu.pool.dtype, device=lu.device)
    per_level = []
    for name, (tape, dinv) in zip(("U^T", "L^T"), tapes):
        for lvl in range(tape.nlvl):
            M = level_bsr(torch, lu.pool, tape, lvl, True, plan.nb) if bsr \
                else None
            if M is not None:
                X2 = X.view(-1, X.shape[2])
                C = torch.empty_like(X2)
                ck.library("solve_gemm", lambda: torch.addmm(
                    X2, M, X2, alpha=-1, out=C))
                ref = X.clone()
                sg.solve_gemm_plain(lu.pool, ref, tape, lvl, True)
                lerr = float((C.view_as(ref) - ref).abs().max())
                if lerr > REL_TOL * max(1.0, float(ref.abs().max())):
                    fail(f"solve_gemm's library call (BSR addmm) "
                         f"disagrees with the plain version: {lerr:.3e}")
                del M, X2, C, ref
            r = tape.rows[int(tape.dptr[lvl]):int(tape.dptr[lvl + 1])].long()
            Dg, Xg = dinv[r].mT, X[r]
            C = torch.empty_like(Xg)
            ck.library("diag_apply", lambda: torch.bmm(Dg, Xg, out=C))
            del Dg, Xg, C
            X, ms = compare_level(ck, sg, lu.pool, dinv, X, tape, lvl)
            per_level.append(ms + (name, lvl, tape))
    bounds = solve_bounds(plan, [t for t, _ in tapes], lu._fdtype)
    for name, o in ck.out.items():
        o.update(bounds[name])
        print(f"bs={plan.bs} {lu._fdtype} {name} transpose=True: "
              f"max_abs_err {o['max_abs_err']:.3e} (tolerance "
              f"{o['tol']:.3e}); kernel {o['ms']:.3f} ms, plain "
              f"{o['plain_ms']:.3f} ms, library {_ms(o['library_ms'])} "
              f"per solve", flush=True)
    print_solve_levels(per_level)
    wide_pair(lu, ctx, 32)
    notrans_solve(lu_main, ctx)
    return ck.out


#: dtype -> whether torch's BSR ``addmm`` runs on CUDA in it, probed once
_BSR = {}


def bsr_served(torch, dtype):
    """Whether ``torch.addmm`` of a BSR matrix runs on CUDA in ``dtype``
    (solve_gemm's library call); probed once on a 2-block matrix, the
    reason printed when it does not."""
    if dtype not in _BSR:
        crow = torch.tensor([0, 1, 1], dtype=torch.int32, device="cuda")
        col = torch.tensor([1], dtype=torch.int32, device="cuda")
        V = torch.ones((1, 4, 4), dtype=dtype, device="cuda")
        X = torch.ones((8, 1), dtype=dtype, device="cuda")
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "Sparse BSR tensor")
                M = torch.sparse_bsr_tensor(crow, col, V, size=(8, 8))
                torch.addmm(X, M, X, alpha=-1)
            torch.cuda.synchronize()
            _BSR[dtype] = True
        except (RuntimeError, NotImplementedError) as e:
            print(f"BSR addmm in {dtype} on CUDA: not served by torch "
                  f"{torch.__version__} ({str(e).splitlines()[0][:160]}); "
                  "solve_gemm's library time is none", flush=True)
            _BSR[dtype] = False
    return _BSR[dtype]


def _ms(v):
    return "none" if v is None else f"{v:.3f} ms"


def compare_level(ck, sg, pool, dinv, X, tape, lvl):
    """One level of a transposed sweep: solve_chunks then solve_rows (the
    fused solve_level) and the two plain phases on copies of X, each timed
    alone; holds the kernels' X to the plain one and returns it with
    (pass 1 ms, pass 2 ms)."""
    torch = ck.torch
    a, p = X.clone(), X.clone()
    held = []
    ms1 = _timed(torch, lambda: held.append(
        sg.solve_chunks(pool, a, tape, lvl, True)))
    ms2 = _timed(torch, lambda: sg.solve_rows(dinv, a, held[0], tape, lvl,
                                              True))
    pm1 = _timed(torch, lambda: sg.solve_gemm_plain(pool, p, tape, lvl, True))
    pm2 = _timed(torch, lambda: sg.diag_apply_plain(dinv, p, tape, lvl,
                                                    True))
    ck.record("solve_gemm", ms1, pm1, [a], [p])
    ck.record("diag_apply", ms2, pm2, [a], [p])
    return a, (ms1, ms2)


def wide_pair(lu, ctx, nrhs):
    """One transposed solve of ``nrhs`` right-hand sides: the kernel pair
    (pass 1, pass 2) against the library pair (BSR addmm, bmm) level by
    level, each timed warm with L2 flushed (printed)."""
    torch, sg = ctx["torch"], ctx["solve_gemm"]
    plan = lu.plan
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (plan.nb, plan.bs, nrhs)), dtype=lu.pool.dtype, device=lu.device)
    warm_solve(sg, lu.pool, zip(lu._ttapes, (lu.uinv, lu.linv)), X, True)
    t = dict(p1=0.0, p2=0.0, addmm=0.0, bmm=0.0)

    def lib(key, fn):
        fn()
        t[key] += _timed(torch, fn)

    bsr = bsr_served(torch, lu.pool.dtype)
    for tape, dinv in zip(lu._ttapes, (lu.uinv, lu.linv)):
        for lvl in range(tape.nlvl):
            M = level_bsr(torch, lu.pool, tape, lvl, True, plan.nb) if bsr \
                else None
            if M is not None:
                X2 = X.view(-1, nrhs)
                C = torch.empty_like(X2)
                lib("addmm", lambda: torch.addmm(X2, M, X2, alpha=-1, out=C))
                del M, X2, C
            r = tape.rows[int(tape.dptr[lvl]):int(tape.dptr[lvl + 1])].long()
            Dg, Xg = dinv[r].mT, X[r]
            C = torch.empty_like(Xg)
            lib("bmm", lambda: torch.bmm(Dg, Xg, out=C))
            del Dg, Xg, C
            held = []
            t["p1"] += _timed(torch, lambda: held.append(
                sg.solve_chunks(lu.pool, X, tape, lvl, True)))
            t["p2"] += _timed(torch, lambda: sg.solve_rows(
                dinv, X, held[0], tape, lvl, True))
    if not bool(torch.isfinite(X).all()):
        fail(f"the transposed solve at nrhs={nrhs} is not finite")
    addmm = f"{t['addmm']:.3f}" if bsr else "none"
    print(f"bs={plan.bs} {lu._fdtype} transposed solve at nrhs={nrhs}: kernel "
          f"pair {t['p1'] + t['p2']:.3f} ms (solve_gemm {t['p1']:.3f}, "
          f"diag_apply {t['p2']:.3f}), library pair "
          f"{t['addmm'] + t['bmm']:.3f} ms (BSR addmm {addmm}, bmm "
          f"{t['bmm']:.3f}) per solve", flush=True)


def warm_solve(sg, pool, tapes, X, transpose):
    """One untimed solve_level sweep over ``tapes`` on a copy of X: the
    card loads a kernel on its first launch, which no timed call should
    hold."""
    W = X.clone()
    for tape, dinv in tapes:
        for lvl in range(tape.nlvl):
            sg.solve_level(pool, dinv, W, tape, lvl, transpose)


def notrans_solve(lu, ctx, what=""):
    """The NOTRANS L+U solve of one right-hand side as the driver runs it
    (``solve_gemm.solve``: both sweeps, two launches per level, counted on
    "sweep"), after one untimed solve: the host seconds of its launch loop
    (no synchronisation inside it), its device ms by CUDA events (L2
    flushed before), both over three calls; the result held to the plain
    levels (REL_TOL). Printed only; returns (host s, device ms) of the
    last call."""
    torch, sg, sweep = ctx["torch"], ctx["solve_gemm"], ctx["sweep"]
    plan = lu.plan
    B = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (plan.nb, plan.bs, 1)), dtype=lu.pool.dtype, device=lu.device)
    tapes = ((lu._ltape, lu.linv), (lu._utape, lu.uinv))
    sg.solve(lu.pool, lu.linv, lu.uinv, lu._ltape, lu._utape, B.clone())
    host, dev = [], []
    for _ in range(3):
        X = B.clone()
        _flush(torch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        t0 = time.perf_counter()
        sg.solve(lu.pool, lu.linv, lu.uinv, lu._ltape, lu._utape, X)
        host.append(time.perf_counter() - t0)
        ev[1].record()
        torch.cuda.synchronize()
        dev.append(ev[0].elapsed_time(ev[1]))
    P = B.clone()
    for tape, dinv in tapes:
        for lvl in range(tape.nlvl):
            sweep.sweep_level_plain(lu.pool, dinv, P, tape, lvl)
    err = float((X - P).abs().max())
    rel = REL_TOL_F64 if X.dtype == torch.float64 else REL_TOL
    nl = sum(2 * t.nlvl for t, _ in tapes)
    print(f"bs={plan.bs} {lu._fdtype} {what}NOTRANS L+U solve: device "
          f"{' / '.join(f'{m:.3f}' for m in dev)} ms, host launch loop "
          f"{' / '.join(f'{h * 1e3:.3f}' for h in host)} ms (up to {nl} "
          f"launches); max abs difference from the plain levels "
          f"{err:.3e}", flush=True)
    if err > rel * max(1.0, float(P.abs().max())):
        fail(f"{what}NOTRANS solve disagrees with its plain version: "
             f"{err:.3e}")
    return host[-1], dev[-1]


def level_bsr(torch, pool, tape, lvl, transpose, nb):
    """The level's contributions as one BSR matrix (nb·bs)² with block
    (dst, src) = op(pool[slot]), so that solve_gemm is X − M·X; None for
    a level without contributions. Built outside any timed window."""
    h = tape.host
    lo, hi = int(tape.dptr[lvl]), int(tape.dptr[lvl + 1])
    rp = h["rowptr"]
    c0, c1 = int(rp[lo]), int(rp[hi])
    if c1 == c0:
        return None
    bs = pool.shape[-1]
    dst = np.repeat(h["rows"][lo:hi], np.diff(rp[lo:hi + 1]))
    src, slot = h["csrc"][c0:c1], h["cslot"][c0:c1]
    order = np.lexsort((src, dst))
    crow = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=nb), out=crow[1:])
    V = pool[torch.as_tensor(slot[order], device=pool.device).long()]
    V = (V.mT if transpose else V).contiguous()
    idx = dict(dtype=torch.int32, device=pool.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse BSR tensor support")
        return torch.sparse_bsr_tensor(
            torch.as_tensor(crow, **idx), torch.as_tensor(src[order], **idx),
            V, size=(nb * bs, nb * bs), check_invariants=True)


def print_solve_levels(per_level, top=6):
    """Where one transposed solve's time goes: the costliest levels by
    pass 1 + pass 2, with their destination rows, products, longest
    chain, chunks (pass 1's CTAs at one right-hand side; pass 2 runs one
    CTA per row)."""
    t1 = sum(m1 for m1, *_ in per_level)
    t2 = sum(m2 for _, m2, *_ in per_level)
    print(f"transposed solve by level (pass 1 {t1:.3f} ms, pass 2 "
          f"{t2:.3f} ms over {len(per_level)} levels; top {top}):")
    for m1, m2, name, lvl, tape in sorted(per_level,
                                          key=lambda t: -t[0] - t[1])[:top]:
        lo, hi = int(tape.dptr[lvl]), int(tape.dptr[lvl + 1])
        chain = np.diff(tape.host["rowptr"][lo:hi + 1])
        nq = int(tape.qptr[lvl + 1] - tape.qptr[lvl])
        print(f"  {name} level {lvl:3d}: pass 1 {m1:8.3f} ms, pass 2 "
              f"{m2:8.3f} ms; {hi - lo} rows, {int(chain.sum())} products, "
              f"longest chain {int(chain.max(initial=0))}, {nq} chunks "
              f"(pass 1 CTAs), {hi - lo} pass 2 CTAs", flush=True)


def solve_bounds(plan, tapes, dtype):
    """Least time of one solve's solve_gemm and diag_apply launches (two
    sweeps, one right-hand side): 2·bs² operations per triple (per
    diagonal inverse); bytes: each stored block (inverse) read once per
    sweep, and X read and written once per sweep."""
    bs = plan.bs
    blk = _blk(plan, dtype)
    xb = 2 * 2 * float(np.dtype(dtype).itemsize) * plan.n_pad
    ntrip = sum(len(t.host["cslot"]) for t in tapes)
    nblk = sum(len(np.unique(t.host["cslot"])) for t in tapes)
    ninv = sum(len(t.host["rows"]) for t in tapes)
    return {"solve_gemm": _bound(2.0 * bs * bs * ntrip, blk * nblk + xb,
                                 "solve", dtype),
            "diag_apply": _bound(2.0 * bs * bs * ninv, blk * ninv + xb,
                                 "solve", dtype)}


def trans_bs64(ctx, rng):
    """At block size 64 on laplacian_3d_unsym(16): the TRANS solution
    against scipy's, rcond against the dense truth (the 30x bound of
    tests/test_trans_cond.py), logdet, a save_factors / load_factors
    round trip, and the two kernels against their plain versions.

    logdet is held to 1e-8 relative against the same plan factored on
    the CPU by the plain versions (float32 both, so the bias of the
    float32 pivots, which both carry, cancels), and against numpy's
    slogdet to the sign and n·eps32 absolute in log|det| (one float32 ulp of
    relative error per pivot; the float32 factor's pivots carry a bias
    that reaches ~1e-8 relative of log|det| here)."""
    import tempfile

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from superlu_dist_tpu_torch import (Options, SparseLU, Trans,
                                        load_factors, save_factors)
    from superlu_dist_tpu_torch.utils.norms import langs
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d_unsym
    A = laplacian_3d_unsym(16).tocsc()
    n = A.shape[0]
    b = rng.standard_normal(n)
    # the FP32 pass: logdet is held to the CPU factor's at 1e-8
    opts = Options(dtype="float32", block_size=64, trans=Trans.TRANS,
                   condition_number=True, gemm_precision="highest")
    res, lu, _ = drive(ctx, "bs=64 trans", A, b, opts,
                       ("solve_gemm", "diag_apply"))
    x_ref = spla.spsolve(sp.csc_matrix(A.T), b)
    err = float(np.abs(res.x - x_ref).max() / np.abs(x_ref).max())
    Ad = A.toarray()
    truth = 1.0 / (langs("1", A) * np.abs(np.linalg.inv(Ad)).sum(
        axis=0).max())
    sign, logabs = lu.logdet()
    csign, clog = SparseLU(A, opts, device="cpu").logdet()
    ds, dl = np.linalg.slogdet(Ad)
    cerr = abs(logabs - clog) / abs(clog)
    derr, dtol = abs(logabs - dl), n * float(np.finfo(np.float32).eps)
    print(f"bs=64 trans: lap3d16u |x - scipy|/|x| {err:.3e} (tolerance "
          f"1e-10); rcond {res.rcond:.6e}, dense {truth:.6e} (within 30x); "
          f"logdet sign {sign:+.0f} (CPU {csign:+.0f}, slogdet {ds:+.0f}), "
          f"log|det| {logabs:.10f}: vs the CPU factor's {clog:.10f} rel "
          f"err {cerr:.3e} (tolerance 1e-8), vs slogdet's {dl:.10f} abs "
          f"err {derr:.3e} (tolerance {dtol:.3e})", flush=True)
    if err > 1e-10:
        fail("bs=64 TRANS solution disagrees with scipy")
    if not truth / 30 < res.rcond < 30 * truth:
        fail("bs=64 rcond outside 30x of the dense truth")
    if sign != csign or cerr > 1e-8:
        fail("bs=64 logdet disagrees with the CPU factor's")
    if sign != ds or derr > dtol:
        fail("bs=64 logdet disagrees with slogdet")
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = os.path.join(d, "factors.npz")
        save_factors(lu, path)
        lu2 = load_factors(path, device="cuda")
        for trans, op in ((Trans.NOTRANS, A), (Trans.TRANS, A.T)):
            x, berr = lu2.refine(b, lu2.solve(b, trans=trans), trans=trans)
            resid = float(np.abs(op @ x - b).max() / np.abs(b).max())
            print(f"bs=64 load_factors {trans.name}: berr {berr.max():.3e},"
                  f" residual {resid:.3e}", flush=True)
            if berr.max() > 1e-12 or resid > 1e-10:
                fail(f"bs=64 loaded factors miss the limits in {trans.name}")
    check_solve(lu, ctx, lu)


def tck_phase(ctx, rng, checks, launches):
    """Phase 8: ``executor="tck"`` on lap3d50 at block size 128, its warm
    call, tck_update against its plain version and the whole factor
    against the float64 reference; then clk, flk and the level executor
    on the same plan through SamePattern_SameRowPerm refactors (the host
    phases are not redone), with clk_update's costliest levels."""
    from superlu_dist_tpu_torch import Fact, Options
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d
    A = laplacian_3d(50)
    n = A.shape[0]
    b = np.asarray(A @ rng.standard_normal(n))
    # the FP32 pass (its rows)
    opts = Options(dtype="float32", block_size=128, executor="tck",
                   gemm_precision="highest")
    res, lu, got = drive(ctx, "tck lap3d50", A, b, opts, (
        "tck_update", "diag_lu", "clk_trsm", "sweep"),
        ("clk_update", "flk", "schur") + BF16_KERNELS + FUSED_BF16)
    launches["tck_update"] = got["tck_update"]
    ctx["entry_launches"]["tck_update"] = dict(
        ctx["tck"].UPDATE.entry_launches)
    plan, tp = lu.plan, lu._ftapes
    colptr = np.searchsorted(plan.slot_col, np.arange(plan.nb + 1))
    height = np.diff(colptr)
    dpos = np.asarray(plan.diag_slot) - colptr[:-1]
    c = tp.host["counts"]
    print(f"lap3d50: n={n} aligned to {plan.n} rows, {plan.nb} block "
          f"columns, {plan.nslots} slots, pool "
          f"{plan.pool_bytes(np.float32) / 2**20:.0f} MiB, {plan.n_flevels} "
          f"factor levels, {len(plan.g_l)} Schur triples, "
          f"{plan.factor_flops / 1e9:.1f} GFLOP (padded block model); "
          f"tallest column {height.max()} blocks, {(height > 104).sum()} "
          f"columns > 104 and {(height > 64).sum()} > 64 blocks, at most "
          f"{dpos.max()} U / {(height - dpos - 1).max()} L blocks in a "
          f"column; tck: phase A {int(tp.lwave[-1])} waves over "
          f"{len(tp.host['tslot'])} U targets, phase B "
          f"{len(tp.host['tiles'])} tiles of up to {tp.w} rows; the TPU "
          f"stream at {tp.w} rows: {c['tiles']} tiles, {c['gemm']} GEMM "
          f"chunks, {c['finu']} FINU jobs", flush=True)
    pb = phase_b_bound(plan, tp)
    print(f"lap3d50 tck_update_bf16 phase B (its chains): bound "
          f"{pb['bound_ms']:.4f} ms ({pb['bound_by']}) per factor",
          flush=True)
    warm_call(ctx, "tck lap3d50", A, b, opts)
    checks.update(check_tck(lu, ctx, report=True))
    print_check("tck_update", checks["tck_update"], launches["tck_update"])
    notrans_solve(lu, ctx, "lap3d50 ")

    ssr = Fact.SAME_PATTERN_SAME_ROWPERM
    for exc, need, zero in (
            ("clk", ("clk_update", "diag_lu", "clk_trsm", "sweep"),
             ("tck_update", "flk", "schur")),
            ("flk", ("flk", "diag_lu", "sweep"),
             ("clk_update", "tck_update", "schur")),
            ("pallas", ("schur", "trsm", "diag_lu", "sweep"),
             ("clk_update", "tck_update", "flk"))):
        # the FP32 pass (the rows; phase 13's bf16 pass follows below)
        _, lu, got = drive(ctx, f"{exc} lap3d50", A, b,
                           opts.replace(executor=exc, fact=ssr,
                                        gemm_precision="highest"),
                           need, zero + BF16_KERNELS + FUSED_BF16, lu=lu)
        if lu.plan is not plan:
            fail(f"{exc} lap3d50: the refactor rebuilt the plan")
        if exc == "clk":
            c = check_kernels(lu, ctx, None, levels=True)
            o = c["clk_update"]
            print(f"lap3d50 clk_update: max_abs_err {o['max_abs_err']:.3e} "
                  f"(tolerance {o['tol']:.3e}); kernel {o['ms']:.3f} ms, "
                  f"plain {o['plain_ms']:.3f} ms, bound {o['bound_ms']:.4f}"
                  f" ms ({o['bound_by']})", flush=True)
            print_check("lap3d50 clk_trsm", c["clk_trsm"], got["clk_trsm"])
            print_check("lap3d50 diag_lu", c["diag_lu"], got["diag_lu"])
            precision_lap3d50(ctx, A, b, opts.replace(executor="clk"), lu)
        if exc == "flk":
            o = check_flk(lu, ctx, report=True)["flk"]
            print(f"lap3d50 flk: max_abs_err {o['max_abs_err']:.3e} "
                  f"(tolerance {o['tol']:.3e}); kernel {o['ms']:.3f} ms, "
                  f"plain {o['plain_ms']:.3f} ms, bound {o['bound_ms']:.4f}"
                  f" ms ({o['bound_by']}); {got['flk']} launches on its "
                  f"path", flush=True)
            w = fused_bf16_bound(lu.plan, lu._ftapes, lu, ctx)
            print(f"lap3d50 flk_bf16: bound {w['bound_ms']:.4f} ms "
                  f"({w['bound_by']}) per factor", flush=True)
            # phase 13b on lap3d50: flk bf16-first against "highest"
            precision_compare(ctx, "lap3d50 flk", A, b,
                              opts.replace(executor="flk"), lu)
        if exc == "pallas":
            c = check_level(lu, ctx, report=True)
            for name in ("trsm", "schur"):
                print_check(f"lap3d50 {name}", c[name], got[name])


def f64_phase(ctx, rng, checks, launches):
    """Phase 9: float64 on the card. lap3d32 NOTRANS and lap3d32u TRANS +
    condition_number run the level executor whatever ``executor`` says;
    every float64 kernel against its plain version on their inputs."""
    from superlu_dist_tpu_torch import Options, Trans
    from superlu_dist_tpu_torch.utils.testing import (laplacian_3d,
                                                      laplacian_3d_unsym)
    level = ("diag_lu", "trsm", "schur", "sweep")
    fused = ("clk_update", "clk_trsm", "tck_update", "flk")
    A = laplacian_3d(32)
    n = A.shape[0]
    b = np.asarray(A @ rng.standard_normal(n))
    opts = Options(dtype="float64", block_size=128)
    res, lu, got = drive(ctx, "float64", A, b, opts, level, fused)
    if res.stat.counters["executor"] != "pallas" or \
            lu.pool.dtype != ctx["torch"].float64:
        fail("float64 did not run the level executor in float64")
    warm_call(ctx, "float64", A, b, opts)
    c = check_level(lu, ctx, report=True, full=True)
    for name in level:
        checks[f"{name}_f64"] = c[name]
        launches[f"{name}_f64"] = got[name]
        print_check(f"{name}_f64", c[name], got[name])

    Au = laplacian_3d_unsym(32)
    bu = rng.standard_normal(Au.shape[0])
    topts = Options(dtype="float64", block_size=128, trans=Trans.TRANS,
                    condition_number=True, executor="tck")
    res, lut, got = drive(ctx, "float64 trans", Au, bu, topts,
                          ("solve_gemm", "diag_apply") + level, fused)
    if res.rcond is None or not 0 < res.rcond <= 1:
        fail(f"float64 trans: rcond {res.rcond} not in (0, 1]")
    print(f"float64 trans: rcond {res.rcond:.6e}, executor "
          f"{res.stat.counters['executor']} (asked for tck)", flush=True)
    check_trans_repeat("float64 trans", lut, bu)
    c = check_solve(lut, ctx, lu)
    for name in ("solve_gemm", "diag_apply"):
        checks[f"{name}_f64"] = c[name]
        launches[f"{name}_f64"] = got[name]
        print_check(f"{name}_f64", c[name], got[name])


def complex_unsym(k, seed=1):
    """``laplacian_3d_unsym(k)`` with ``helmholtz_3d``'s shift -(2 + 0.5i)
    on the diagonal and every off-diagonal entry times a seeded unit
    phase: the 7-point pattern (lap3d32's plan at k = 32), with A, Aᵀ and
    Aᴴ all different."""
    import scipy.sparse as sp

    from superlu_dist_tpu_torch.utils.testing import laplacian_3d_unsym
    A = sp.coo_matrix(laplacian_3d_unsym(k, seed=seed)).astype(np.complex128)
    off = A.row != A.col
    data = A.data.copy()
    data[off] *= np.exp(1j * np.random.default_rng(seed).uniform(
        0, 2 * np.pi, int(off.sum())))
    data[~off] -= 2.0 + 0.5j
    return sp.csc_matrix((data, (A.row, A.col)), shape=A.shape)


def check_entries(ctx, what, names, sfx):
    """After a drive: each kernel of ``names`` launched through its
    ``sfx`` entries only."""
    for name in names:
        k = ctx["kernels"][name]
        got = {e: v for e, v in k.entry_launches.items() if v}
        if not got or any(not e.endswith(f"_{sfx}") for e in got):
            fail(f"{what}: {name} launched {got}, not only its _{sfx} "
                 "instantiation")


def complex_phase(ctx, rng, checks, launches):
    """Phase 10: complex64 and complex128 on the card. helmholtz_3d(32)
    NOTRANS with a warm call held bit-equal; every complex kernel against
    its plain version and the factor against factor_plain in complex128;
    TRANS and CONJ with the condition estimate on complex_unsym(32); then
    the block size 64 checks on helmholtz_3d(16)."""
    import tempfile

    import scipy.sparse.linalg as spla

    from superlu_dist_tpu_torch import (Options, Trans, load_factors,
                                        save_factors)
    from superlu_dist_tpu_torch.utils.testing import helmholtz_3d
    torch = ctx["torch"]
    level = ("diag_lu", "trsm", "schur", "sweep")
    fused = ("clk_update", "clk_trsm", "tck_update", "flk")
    A = helmholtz_3d(32).tocsc()
    Au = complex_unsym(32)
    n = A.shape[0]
    for dt, sfx in CSFX.items():
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        opts = Options(dtype=dt, block_size=128)
        res, lu, got = drive(ctx, dt, A, b, opts, level, fused)
        check_entries(ctx, dt, level, sfx)
        if res.stat.counters["executor"] != "pallas" or \
                lu.pool.dtype != getattr(torch, dt):
            fail(f"{dt} did not run the level executor in {dt}")
        plan = lu.plan
        print(f"{dt}: helmholtz_3d(32) n={n}, {plan.nb} block columns, "
              f"{plan.nslots} slots, pool {plan.pool_bytes(lu._fdtype) / 2**20:.0f}"
              f" MiB, {res.stat.refine_steps} refinement steps, "
              f"rcond not asked", flush=True)
        warm = warm_call(ctx, dt, A, b, opts)
        check_repeat(dt, res, warm)
        if dt == "complex64":   # beside the embedded rows of phase 12e
            ctx["native_c64_ms"] = dict(warm.stat.device_ms)
        c = check_level(lu, ctx, report=True, full=True)
        for name in level:
            checks[f"{name}_{sfx}"] = c[name]
            launches[f"{name}_{sfx}"] = got[name]
            print_check(f"{name}_{sfx}", c[name], got[name])
        del lu, res, c
        bu = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        for trans in (Trans.TRANS, Trans.CONJ):
            topts = Options(dtype=dt, block_size=128, trans=trans,
                            condition_number=True)
            what = f"{dt} {trans.name}"
            res, lut, got = drive(ctx, what, Au, bu, topts,
                                  ("solve_gemm", "diag_apply") + level,
                                  fused)
            check_entries(ctx, what, ("solve_gemm", "diag_apply") + level,
                          sfx)
            if res.rcond is None or not 0 < res.rcond <= 1:
                fail(f"{what}: rcond {res.rcond} not in (0, 1]")
            print(f"{what}: rcond {res.rcond:.6e}, {res.stat.refine_steps} "
                  "refinement steps", flush=True)
            check_trans_repeat(what, lut, bu, trans)
        c = check_solve(lut, ctx, lut)
        for name in ("solve_gemm", "diag_apply"):
            checks[f"{name}_{sfx}"] = c[name]
            launches[f"{name}_{sfx}"] = got[name]
            print_check(f"{name}_{sfx}", c[name], got[name])
        del lut, res, c
        torch.cuda.empty_cache()

    # block size 64 on helmholtz_3d(16): scipy, slogdet, a checkpoint
    A2 = helmholtz_3d(16).tocsc()
    n2 = A2.shape[0]
    b2 = rng.standard_normal(n2) + 1j * rng.standard_normal(n2)
    x_ref = spla.spsolve(A2.astype(np.complex128), b2)
    ds, dl = np.linalg.slogdet(A2.toarray().astype(np.complex128))
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    for dt in CSFX:
        res, lu, _ = drive(ctx, f"bs=64 {dt}", A2, b2,
                           Options(dtype=dt, block_size=64), level)
        err = float(np.abs(res.x - x_ref).max() / np.abs(x_ref).max())
        phase, logabs = lu.logdet()
        # a rounding per pivot, and the sum's own at its magnitude
        eps = float(np.finfo(np.dtype(dt)).eps)
        tol = n2 * eps + 4 * eps * abs(dl)
        perr, lerr = abs(phase - ds), abs(logabs - dl)
        print(f"bs=64 {dt}: helmholtz_3d(16) |x - scipy|/|x| {err:.3e} "
              f"(tolerance 1e-10); logdet phase {phase:.10f} (slogdet "
              f"{complex(ds):.10f}, err {perr:.3e}), log|det| "
              f"{logabs:.10f} (slogdet {dl:.10f}, err {lerr:.3e}); "
              f"tolerance {tol:.3e}", flush=True)
        if err > 1e-10:
            fail(f"bs=64 {dt} solution disagrees with scipy")
        if perr > tol or lerr > tol:
            fail(f"bs=64 {dt} logdet disagrees with slogdet")
        with tempfile.TemporaryDirectory(dir=build) as d:
            path = os.path.join(d, "factors.npz")
            save_factors(lu, path)
            lu2 = load_factors(path, device="cuda")
            for trans, op in ((Trans.NOTRANS, A2), (Trans.CONJ,
                                                    A2.conj().T)):
                x, berr = lu2.refine(b2, lu2.solve(b2, trans=trans),
                                     trans=trans)
                resid = float(np.abs(op @ x - b2).max() / np.abs(b2).max())
                print(f"bs=64 {dt} load_factors {trans.name}: berr "
                      f"{berr.max():.3e}, residual {resid:.3e}", flush=True)
                if berr.max() > 1e-12 or resid > 1e-10:
                    fail(f"bs=64 {dt} loaded factors miss the limits in "
                         f"{trans.name}")


#: the single-device factor, sweep and solve kernels, none of which the
#: grid path may launch
SINGLE_DEVICE = ("clk_update", "clk_trsm", "tck_update", "flk", "schur",
                 "trsm", "diag_lu", "sweep", "solve_gemm", "diag_apply")
GRID_NEED = ("rdma_factor", "rdma_solve")


def dist_phase(ctx, rng, checks, launches):
    """Phase 10: ``gssvx_dist`` over a 2x2 grid of ranks on the card, on
    lap3d32 at block size 128: driven like the main path, the receive
    counters against the tapes, a warm call beside the level executor's
    FACT, every entry against its plain version level by level, the
    gathered factor against the float64 reference; then
    ``dist_executor="xla"`` and the bs 64 grids against scipy."""
    import scipy.sparse.linalg as spla

    from superlu_dist_tpu_torch import Grid2D, Options
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d
    torch = ctx["torch"]
    A = laplacian_3d(32)
    n = A.shape[0]
    b = np.asarray(A @ rng.standard_normal(n))
    opts = Options(dtype="float32", block_size=128, dist_executor="rdma")
    grid = Grid2D(2, 2)
    torch.cuda.reset_peak_memory_stats()
    res, lu, got = drive(ctx, "grid 2x2 rdma", A, b, opts, GRID_NEED,
                         SINGLE_DEVICE, grid=grid)
    peak = torch.cuda.max_memory_allocated() / 2**20
    entries = grid_entries(ctx, "grid 2x2 rdma", "f32")
    ctx["entry_launches"].update(entries)
    for k in GRID_NEED:
        launches[k] = got[k]
    print_grid(lu, peak, entries)
    check_recv(lu, "grid 2x2 rdma")
    r2 = warm_call(ctx, "grid 2x2 rdma", A, b, opts, grid=grid)
    check_repeat("grid 2x2 rdma lap3d32", res, r2)
    profile_refine(torch, lu, b, res.x, "grid 2x2 rdma: ")
    st = r2.stat
    print(f"grid 2x2 rdma, second call: device ms FACT "
          f"{st.device_ms['FACT']:.3f}, SOLVE {st.device_ms['SOLVE']:.3f}, "
          f"REFINE {st.device_ms['REFINE']:.3f} ({st.refine_steps} steps); "
          f"the level executor's FACT on one rank "
          f"{ctx['level_fact_ms']:.3f} ms", flush=True)
    checks.update(check_dist(lu, ctx))
    for k in GRID_NEED:
        print_check(k, checks[k], launches[k])
    pool, _, _ = lu._export_factors()
    tiny = torch.tensor([res.stat.tiny_pivots])
    check_whole_factor("grid 2x2 rdma (gathered)", lu, ctx, pool, tiny)

    _, _, gx = drive(ctx, "grid 2x2 xla", A, b,
                     opts.replace(dist_executor="xla"), GRID_NEED,
                     SINGLE_DEVICE, grid=grid)
    ex = grid_entries(ctx, "grid 2x2 xla", "f32")
    print(f"grid 2x2 xla: launches per entry {ex}", flush=True)
    if ex != entries:
        fail("dist_executor='xla' did not run the same launches as 'rdma'")

    A2 = laplacian_3d(16)
    b2 = np.asarray(A2 @ rng.standard_normal(A2.shape[0]))
    x_ref = spla.spsolve(A2.tocsc(), b2)
    for pr, pc in ((2, 2), (1, 4), (4, 1), (2, 4)):
        what = f"bs=64 grid {pr}x{pc}"
        r2, lu2, _ = drive(ctx, what, A2, b2, Options(
            dtype="float32", block_size=64, dist_executor="rdma"),
            GRID_NEED, SINGLE_DEVICE, grid=Grid2D(pr, pc))
        err = float(np.abs(r2.x - x_ref).max() / np.abs(x_ref).max())
        print(f"{what}: lap3d16 |x - scipy|/|x| {err:.3e} (tolerance "
              f"1e-10)", flush=True)
        if err > 1e-10:
            fail(f"{what} solution disagrees with scipy")
        check_recv(lu2, what)


def grid_entries(ctx, what, sfx):
    """After a grid drive: every ``_{sfx}`` entry of rdma_factor and
    rdma_solve launched and no entry of another element type; returns the
    launches per entry of that type."""
    out = {}
    for k in GRID_NEED:
        e = ctx["kernels"][k].entry_launches
        mine = {n: v for n, v in e.items() if n.endswith(f"_{sfx}")}
        if not all(mine.values()) or any(
                v for n, v in e.items() if n not in mine):
            fail(f"{what}: {k} launched {e}, not every _{sfx} entry and "
                 "only those")
        out[k] = mine
    return out


#: the grid's element types beside float32: (dtype, matrix)
GRID_TYPES = (("float64", "lap3d32"), ("complex64", "helmholtz_3d(32)"),
              ("complex128", "helmholtz_3d(32)"))
#: the grid's transposed drives: (dtype, trans, matrix)
GRID_TRANS = (("float32", "TRANS", "lap3d32u"),
              ("complex64", "CONJ", "complex_unsym(32)"),
              ("complex128", "CONJ", "complex_unsym(32)"))
SFX = {"float32": "f32", "float64": "f64", **CSFX}


def grid_types_phase(ctx, rng, checks, launches):
    """Phase 11, the grid in float64, complex64 and complex128 on a 2x2
    grid of ranks on the card: each driven like the main path through its
    ``_f64``/``_c64``/``_c128`` entries only, the receive counters against
    the tapes, a warm call bit-equal to the first with equal refinement
    steps, every entry against its plain version level by level, the
    gathered factor against the float64 (complex128) reference; then
    ``profile_levels`` on the float64 grid; then TRANS with
    ``condition_number`` on lap3d32u in float32 and CONJ on its complex
    twin in complex64 and complex128: rcond in (0, 1], a warm call
    bit-equal to the first, two transposed solves of one b bit-equal,
    the Uᵀ and Lᵀ sweeps' receive counters
    against their tapes and each solve entry with its transpose flag
    against its plain version."""
    from superlu_dist_tpu_torch import Grid2D, Options, Trans
    from superlu_dist_tpu_torch.utils.testing import (helmholtz_3d,
                                                      laplacian_3d,
                                                      laplacian_3d_unsym)
    torch = ctx["torch"]
    grid = Grid2D(2, 2)
    mats = {"lap3d32": lambda: laplacian_3d(32),
            "helmholtz_3d(32)": lambda: helmholtz_3d(32).tocsc(),
            "lap3d32u": lambda: laplacian_3d_unsym(32),
            "complex_unsym(32)": lambda: complex_unsym(32)}

    def rhs(dt, n):
        b = rng.standard_normal(n)
        return b + 1j * rng.standard_normal(n) if dt[0] == "c" else b

    for dt, mat in GRID_TYPES:
        sfx = SFX[dt]
        A = mats[mat]()
        b = rhs(dt, A.shape[0])
        opts = Options(dtype=dt, block_size=128, dist_executor="rdma")
        what = f"grid 2x2 {dt}"
        res, lu, got = drive(ctx, what, A, b, opts, GRID_NEED,
                             SINGLE_DEVICE, grid=grid)
        if lu.pool[0].dtype != getattr(torch, dt):
            fail(f"{what}: the ranks' pools are not {dt}")
        entries = grid_entries(ctx, what, sfx)
        for k in GRID_NEED:
            launches[f"{k}_{sfx}"] = got[k]
            ctx["entry_launches"][f"{k}_{sfx}"] = entries[k]
        print(f"{what}: {mat}, {res.stat.refine_steps} refinement steps, "
              f"tiny pivots {res.stat.tiny_pivots}; launches per entry "
              f"{entries}", flush=True)
        check_recv(lu, what)
        r2 = warm_call(ctx, what, A, b, opts, grid=grid)
        check_repeat(what, res, r2)
        st = r2.stat
        print(f"{what}, second call: device ms FACT "
              f"{st.device_ms['FACT']:.3f}, SOLVE "
              f"{st.device_ms['SOLVE']:.3f}, REFINE "
              f"{st.device_ms['REFINE']:.3f}", flush=True)
        c = check_dist(lu, ctx)
        for k in GRID_NEED:
            checks[f"{k}_{sfx}"] = c[k]
            print_check(f"{k}_{sfx}", c[k], got[k])
        pool, _, _ = lu._export_factors()
        check_whole_factor(f"{what} (gathered)", lu, ctx, pool,
                           torch.tensor([res.stat.tiny_pivots]))
        if dt == "float64":
            grid_profile(lu, A, b)
        del lu, res, r2, c, pool
        torch.cuda.empty_cache()

    for dt, tname, mat in GRID_TRANS:
        sfx = SFX[dt]
        trans = getattr(Trans, tname)
        A = mats[mat]()
        b = rhs(dt, A.shape[0])
        opts = Options(dtype=dt, block_size=128, dist_executor="rdma",
                       trans=trans, condition_number=True)
        what = f"grid 2x2 {dt} {tname}"
        res, lu, got = drive(ctx, what, A, b, opts, GRID_NEED,
                             SINGLE_DEVICE, grid=grid)
        grid_entries(ctx, what, sfx)
        if res.rcond is None or not 0 < res.rcond <= 1:
            fail(f"{what}: rcond {res.rcond} not in (0, 1]")
        print(f"{what}: {mat}, rcond {res.rcond:.6e}, "
              f"{res.stat.refine_steps} refinement steps", flush=True)
        check_recv(lu, what)
        check_repeat(what, res, warm_call(ctx, what, A, b, opts, grid=grid))
        check_trans_repeat(what, lu, b, trans)
        c = check_dist(lu, ctx, factor=False, trans=True)["rdma_solve"]
        key = f"rdma_solve_trans_{sfx}"
        checks[key] = c
        launches[key] = got["rdma_solve"]
        print_check(key, c, got["rdma_solve"])
        del lu, res, c
        torch.cuda.empty_cache()


def dist3d_phase(ctx, rng, checks, launches):
    """Phase 11's end, the 3D communication-avoiding driver with every
    rank of a Grid3D(2, 2, 2) on the card, on the JAX package's production
    3D case
    (its tests/test_anc25d.py): lap3d32 at block size 128, ordered by
    ``geometric_nd((32, 32, 32))`` through ``col_perm=MY_PERMC`` (the
    plan must come out aligned), in float32 under ``anc25d="replicated"``
    and ``"zsplit"``. Each mode is driven like the main path (every
    ``_f32`` entry of rdma_factor and rdma_solve launched, no single-
    device kernel); x against the single-device port's on the same
    ordering, berr and the refinement steps; the receive counters against
    the 3D receive tapes; the DIST counters against the partition; a warm
    call bit-equal to the first, whose FACT / SOLVE / REFINE ms are
    printed; every entry against its plain version level by level on the
    3D tapes, with each entry's ms, the ancestor reduction's and zsplit's
    delta's ms; and the gathered factor against the float64 reference.
    Then zsplit's x against replicated's."""
    from superlu_dist_tpu_torch import ColPerm, Grid3D, Options, gssvx
    from superlu_dist_tpu_torch.ops.host.ordering import geometric_nd
    from superlu_dist_tpu_torch.parallel.dist3d import ANC25D
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d
    torch = ctx["torch"]
    k = 32
    A = laplacian_3d(k)
    n = A.shape[0]
    b = np.asarray(A @ rng.standard_normal(n))
    base = Options(dtype="float32", block_size=128, col_perm=ColPerm.MY_PERMC,
                   user_colperm=geometric_nd((k, k, k)))
    one, _ = gssvx(A, b, base.replace(gemm_precision="highest"))
    grid = Grid3D(2, 2, 2)
    xs, anc = {}, {}
    for mode in ANC25D:
        what = f"grid 2x2x2 {mode}"
        opts = base.replace(anc25d=mode)
        torch.cuda.reset_peak_memory_stats()
        res, lu, got = drive(ctx, what, A, b, opts, GRID_NEED,
                             SINGLE_DEVICE, grid=grid)
        peak = torch.cuda.max_memory_allocated() / 2**20
        if lu._expand is None:
            fail(f"{what}: the plan is not aligned")
        entries = grid_entries(ctx, what, "f32")
        for name in GRID_NEED:
            launches[f"{name}_3d_{mode}"] = got[name]
            ctx["entry_launches"][f"{name}_3d_{mode}"] = entries[name]
        err = float(np.abs(res.x - one.x).max() / np.abs(one.x).max())
        dp, st = lu.dplan, res.stat
        print(f"{what}: lap3d32 aligned to {lu.plan.n} rows, {lu.plan.nb} "
              f"block columns; layers' steps "
              f"{[int((dp.step_layer == z).sum()) for z in range(dp.pz)]}, "
              f"top {int((dp.step_layer < 0).sum())} steps; {dp.max_p1} "
              f"subtree + {dp.ntop} top levels; n_local {dp.n_local}, "
              f"max_anc {dp.max_anc}, max_tact {dp.max_tact}; peak device "
              f"memory {peak:.0f} MiB; |x - single device|/|x| {err:.3e} "
              f"(tolerance 1e-10); {st.refine_steps} refinement steps "
              f"(single device {one.stat.refine_steps}); tiny pivots "
              f"{st.tiny_pivots}; launches per entry {entries}", flush=True)
        if err > 1e-10:
            fail(f"{what}: x disagrees with the single-device port's")
        check_recv(lu, what)
        check_dist3d_counters(lu, st, what)
        anc[mode] = st.counters["anc_reduce_bytes"]
        r2 = warm_call(ctx, what, A, b, opts, grid=grid)
        check_repeat(what, res, r2)
        w = r2.stat
        print(f"{what}, second call: device ms FACT "
              f"{w.device_ms['FACT']:.3f}, SOLVE {w.device_ms['SOLVE']:.3f},"
              f" REFINE {w.device_ms['REFINE']:.3f} ({w.refine_steps} "
              f"steps)", flush=True)
        c = check_dist(lu, ctx)
        for name in GRID_NEED:
            key = f"{name}_3d_{mode}"
            checks[key] = c[name]
            print_check(key, c[name], got[name])
        pool, _, _ = lu._export_factors()
        check_whole_factor(f"{what} (gathered)", lu, ctx, pool,
                           torch.tensor([res.stat.tiny_pivots]))
        xs[mode] = res.x
        del lu, res, r2, c, pool
        torch.cuda.empty_cache()
    err = float(np.abs(xs["zsplit"] - xs["replicated"]).max()
                / np.abs(xs["replicated"]).max())
    print(f"grid 2x2x2: |x zsplit - x replicated|/|x| {err:.3e} (tolerance "
          f"1e-10); anc_reduce_bytes {anc}", flush=True)
    if err > 1e-10 or not anc["zsplit"] > anc["replicated"]:
        fail("grid 2x2x2: the two anc25d modes disagree")


def check_dist3d_counters(lu, st, what):
    """The DIST counters of a 3D drive against its partition: the steps
    of the layers and of the top add up to the plan's, the comm volume is
    the partition's, and zsplit reports its z-sum bytes."""
    dp = lu.dplan
    want = dict(dp.comm_volume(np.dtype(lu._fdtype).itemsize),
                anc_steps=float((dp.step_layer < 0).sum()),
                **{f"layer{z}_steps": float((dp.step_layer == z).sum())
                   for z in range(dp.pz)})
    if dp.anc25d == "zsplit":
        want["anc25d_zsplit_psum_bytes"] = int(
            dp.ntop * (dp.max_tact + 1) * dp.bs ** 2
            * np.dtype(lu._fdtype).itemsize)
    got = {k: st.counters.get(k) for k in want}
    steps = got["anc_steps"] + sum(got[f"layer{z}_steps"]
                                   for z in range(dp.pz))
    print(f"{what}: DIST counters {got}", flush=True)
    if got != want or steps != lu.plan.nb or (
            dp.anc25d == "zsplit") != ("anc25d_zsplit_psum_bytes"
                                       in st.counters):
        fail(f"{what}: DIST counters {got}, the partition's {want}")


def grid_profile(lu, A, b):
    """``DistributedSparseLU.profile_levels``: the six costliest levels;
    the solve after it must still meet the limits."""
    rows = lu.profile_levels()
    total = sum(r["ms"] for r in rows)
    print(f"grid profile_levels ({lu._fdtype}, bs={lu.plan.bs}): {len(rows)} "
          f"levels, {total:.3f} ms in all; the six costliest:")
    for r in sorted(rows, key=lambda r: -r["ms"])[:6]:
        print(f"  level {r['level']:3d}: {r['ms']:8.3f} ms; {r['steps']} "
              f"steps, {r['lpanels']} + {r['upanels']} panels, "
              f"{r['gemms']} Schur products", flush=True)
    if len(rows) != lu.dplan.nlvl or \
            sum(r["steps"] for r in rows) != lu.plan.nb:
        fail("grid profile_levels: rows or steps do not cover the plan")
    x, berr = lu.refine(b, lu.solve(b))
    resid = float(np.abs(A @ x - b).max() / np.abs(b).max())
    print(f"grid profile_levels: the solve after it: berr {berr.max():.3e}, "
          f"residual {resid:.3e}", flush=True)
    if berr.max() > 1e-12 or resid > 1e-10:
        fail("grid profile_levels left factors that miss the limits")


def print_grid(lu, peak_mib, entries):
    """The grid path's sizes: per-rank slots, Schur products and state,
    the broadcast buffers' heights and the puts of one factor."""
    dp, ft = lu.dplan, lu._ft
    nd = ft.ndev
    gemms = np.asarray(dp.gptr).reshape(nd, -1)[:, -1]
    puts = {k: int(v.sum()) for k, v in ft.recv.items()}
    rows = (dp.n_local + 2 * (ft.dlen + 1) + 2 * dp.max_dlvl + dp.max_lbuf
            + dp.max_ubuf)
    mib = rows * lu.plan.bs ** 2 * 4 / 2**20
    print(f"grid {dp.pr}x{dp.pc}: {dp.nlvl} levels, n_local {dp.n_local}, "
          f"Schur products per rank {gemms.min()}-{gemms.max()} "
          f"({gemms.sum()} in all), max_lbuf {dp.max_lbuf}, max_ubuf "
          f"{dp.max_ubuf}, max_dlvl {dp.max_dlvl}, dlen {ft.dlen}; factor "
          f"state {mib:.0f} MiB per rank; factor puts {puts} "
          f"({sum(puts.values())} blocks, "
          f"{sum(puts.values()) * lu.plan.bs ** 2 * 4 / 2**20:.0f} MiB); "
          f"peak device memory of the first call {peak_mib:.0f} MiB; "
          f"launches per entry {entries}", flush=True)


def check_recv(lu, what):
    """The receive counters that the puts tallied against the TPU's
    receive tapes: the factor's, the last solve's L and U sweeps', and
    the last transposed solve's Lᵀ and Uᵀ sweeps' (against their tapes)
    where one ran."""
    bad = [k for k, v in lu.factor_recv().items()
           if not np.array_equal(v, lu._ft.recv[k])]
    solves = [(lu.solve_recv(), (lu._lt, lu._ut))]
    if lu._ttapes is not None:
        solves.append((lu.solve_recv(transpose=True), lu._ttapes))
    for recvs, tapes in solves:
        for got, tp in zip(recvs, tapes):
            bad += [f"{tp.which}:{k}" for k, v in got.items()
                    if not np.array_equal(v, tp.recv[k])]
    print(f"{what}: receive counters equal the tapes: {not bad}", flush=True)
    if bad:
        fail(f"{what}: receive counters differ from the tapes in {bad}")


def compare_state(torch, o, state, kern, plain, of, flat, table):
    """Run an RDMA entry and its plain version on copies of ``state`` (a
    FactorState or SweepState; ``of`` rebuilds one from ``flat``'s tensor
    list), time both, hold the float buffers to REL_TOL and the receive
    counters to equality, and keep the kernel's copy. ``table`` makes the
    copy's pointer table before the timed call, as a factor or a sweep
    makes it once. float64 and complex128 buffers are held to
    REL_TOL_F64. Returns the kernel's copy and its ms."""
    ts = flat(state)
    a = [t.clone() for t in ts]
    p = [t.clone() for t in ts]
    sa = of(a)
    if a[0].is_cuda:
        table(sa)
    ms = _timed(torch, lambda: kern(sa))
    o["ms"] += ms
    o["plain_ms"] += _timed(torch, lambda: plain(of(p)))
    fl = [(x, y) for x, y in zip(a, p)
          if x.is_floating_point() or x.is_complex()]
    err = max(float((x - y).abs().max()) for x, y in fl)
    scale = max(1.0, max(float(y.abs().max()) for _, y in fl))
    rel = REL_TOL_F64 if fl[0][0].dtype in (torch.float64,
                                            torch.complex128) else REL_TOL
    o["max_abs_err"] = max(o["max_abs_err"], err)
    o["tol"] = max(o["tol"], rel * scale)
    if err > rel * scale:
        fail(f"an RDMA entry ({fl[0][0].dtype}) disagrees with its plain "
             f"version: {err:.3e} > {rel * scale:.3e}")
    if any(not torch.equal(x, y) for x, y in zip(a, p)
           if not (x.is_floating_point() or x.is_complex())):
        fail("an RDMA entry's receive counters differ from its plain "
             "version's")
    return sa, ms


def check_dist(lu, ctx, factor=True, trans=False):
    """rdma_factor's three entries over one factor (with ``factor``) and
    rdma_solve's three over the L and U sweeps of one solve of a
    right-hand side of the factor's dtype (with ``trans``, over the Uᵀ
    and Lᵀ sweeps of one transposed solve), each against its plain
    version level by level from the same state (the run goes on with the
    kernel's output). On a 3D grid the ancestor reduction runs before the
    first top level and zsplit's delta after each top level, on the
    kernel's state only (the plain version starts from a copy of it), each
    timed apart. No one PyTorch call does a rank's level with its puts, so
    library_ms stays None."""
    from collections import defaultdict

    from superlu_dist_tpu_torch.parallel import dist3d
    torch, rdma = ctx["torch"], ctx["rdma"]
    plan, ft = lu.plan, lu._ft
    out = {k: dict(max_abs_err=0.0, tol=0.0, ms=0.0, plain_ms=0.0,
                   library_ms=None) for k in GRID_NEED}
    per_entry = defaultdict(float)
    # the panel and Schur entries by launch: (ms, panels or targets, what)
    by_launch = defaultdict(list)
    jobs = {"rdma_panel": ft.bptr, "rdma_schur": ft.sptr}
    th = lu._thresh()
    st = rdma.new_factor_state(lu._pools0(), ft)
    layered = isinstance(ft, dist3d.FactorTapes3D)
    for lvl in range(ft.nlvl if factor else 0):
        if layered and lvl == ft.max_p1:
            per_entry["ancestor_reduce"] += _timed(
                torch, lambda: dist3d.before_level(st, ft, lvl))
        for entry, kern, plain in (
                ("rdma_diag", lambda s: rdma.rdma_diag(s, th, ft, lvl),
                 lambda s: rdma.rdma_diag_plain(s, th, ft, lvl)),
                ("rdma_panel", lambda s: rdma.rdma_panel(s, ft, lvl),
                 lambda s: rdma.rdma_panel_plain(s, ft, lvl)),
                ("rdma_schur", lambda s: rdma.rdma_schur(s, ft, lvl),
                 lambda s: rdma.rdma_schur_plain(s, ft, lvl))):
            st, ms = compare_state(
                torch, out["rdma_factor"], st, kern, plain,
                lambda ts: rdma.FactorState.of(ts, ft.ndev),
                rdma.FactorState.tensors, rdma.FactorState.table)
            per_entry[entry] += ms
            if entry in jobs:
                n = int(jobs[entry][lvl, -1] - jobs[entry][lvl, 0])
                by_launch[entry].append((ms, n, f"level {lvl}"))
        if layered and ft.zsplit and lvl >= ft.max_p1:
            per_entry["zsplit_delta"] += _timed(
                torch, lambda: dist3d.after_level(st, ft, lvl))
    del st
    rng = np.random.default_rng(1)
    fdt = lu.pool[0].dtype
    B = rng.standard_normal((plan.nb, plan.bs, 1))
    if fdt.is_complex:
        B = B + 1j * rng.standard_normal((plan.nb, plan.bs, 1))
    B = torch.as_tensor(B, device=lu.device).to(fdt)
    if trans:   # the tapes of the drive's transposed solves
        lt, ut = lu._ttapes
        sweeps = [(ut, lu.uinv), (lt, lu.linv)]
    else:
        sweeps = [(lu._lt, lu.linv), (lu._ut, lu.uinv)]
    X = [B.clone() for _ in range(ft.ndev)]
    for tp, dinv in sweeps:
        ss = rdma.new_sweep_state(X, tp)
        for lvl in range(tp.nlvl):
            for entry, kern, plain, M in (
                    ("rdma_solve_chunks", rdma.rdma_solve_chunks,
                     rdma.rdma_solve_chunks_plain, lu.pool),
                    ("rdma_solve_sum", rdma.rdma_solve_sum,
                     rdma.rdma_solve_sum_plain, lu.pool),
                    ("rdma_solve_diag", rdma.rdma_solve_diag,
                     rdma.rdma_solve_diag_plain, dinv)):
                ss, ms = compare_state(
                    torch, out["rdma_solve"], ss,
                    lambda s: kern(M, s, tp, lvl),
                    lambda s: plain(M, s, tp, lvl),
                    lambda ts: rdma.SweepState.of(ts, ft.ndev),
                    rdma.SweepState.tensors, lambda s: s.table(M))
                per_entry[entry] += ms
        X = ss.X
    print(f"RDMA entries ({fdt}), kernel ms summed over the levels ("
          + ("one factor, " if factor else "")
          + ("one transposed solve" if trans else "one L+U solve") + "): "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_entry.items()),
          flush=True)
    if factor:
        print_panel_levels("rdma_panel", by_launch["rdma_panel"], top=3)
        print_panel_levels("rdma_schur", by_launch["rdma_schur"],
                           "targets", top=3)
    for tp, _ in sweeps:
        h = tp.host
        nk = np.diff(h["chunkptr"])
        print(f"grid {tp.which} sweep: {tp.nlvl} levels, "
              f"{len(h['p_pos'])} partial jobs, {len(h['c_loc'])} products "
              f"in {len(h['q_rank'])} chunks (longest chain "
              f"{int(np.diff(h['cptr']).max(initial=0))}, most chunks of "
              f"one chain {int(nk.max(initial=0))}, most chunks of one "
              f"level {int(np.diff(tp.qptr).max(initial=0))}), "
              f"{len(h['d_row'])} solved rows", flush=True)
    out["rdma_factor"].update(grid_factor_bound(lu))
    out["rdma_solve"].update(grid_solve_bound(
        lu, tapes=[t for t, _ in sweeps] if trans else None))
    out["rdma_solve"]["per_entry_ms"] = {
        k: v for k, v in per_entry.items() if k.startswith("rdma_solve")}
    out["rdma_factor"]["per_entry_ms"] = {
        k: v for k, v in per_entry.items()
        if not k.startswith("rdma_solve")}
    return out


def grid_factor_bound(lu):
    """Least time of one 2D factor: 2·bs³ per Schur product and per panel,
    (4/3)·bs³ per tile (operations); bytes: each tile read and written,
    its two inverses stored and put into Pr + Pc broadcast rows, each
    panel read, written and put into its Pc (L) or Pr (U) buffer rows,
    each rank's inverses read once per level by its panels, and per level
    and rank the distinct targets read and written and the distinct
    broadcast rows read once. On a 3D grid every job of the tapes counts:
    a replicated top's tiles, panels and Schur products once per layer,
    as the run does them (zsplit's Schur products once); the ancestor
    reduction and zsplit's delta, torch ops between the launches, are
    not in it."""
    plan, ft = lu.plan, lu._ft
    h, bs = ft.host, plan.bs
    blk = _blk(plan, lu._fdtype)
    nprod, npanel, ntile = len(h["c_l"]), len(h["b_loc"]), len(h["a_loc"])
    flops = 2.0 * bs ** 3 * (nprod + npanel) + (4.0 / 3.0) * bs ** 3 * ntile
    side = h["b_side"]
    nblk = ntile * (4 + ft.pr + ft.pc) + int(
        ((side == 0) * (2 + ft.pc) + (side == 1) * (2 + ft.pr)).sum())
    for lvl in range(ft.nlvl):
        b = slice(ft.bptr[lvl, 0], ft.bptr[lvl, -1])
        nblk += len(set(zip(h["b_rank"][b], h["b_pil"][b], side[b])))
        s = slice(ft.sptr[lvl, 0], ft.sptr[lvl, -1])
        c = slice(h["cptr"][s.start], h["cptr"][s.stop])
        rk = np.repeat(h["s_rank"][s], np.diff(h["cptr"][s.start:s.stop + 1]))
        nblk += 2 * (s.stop - s.start) + len(set(zip(rk, h["c_l"][c]))) \
            + len(set(zip(rk, h["c_u"][c])))
    return _bound(flops, blk * nblk, "factor", lu._fdtype)


def grid_solve_bound(lu, nrhs=1, tapes=None):
    """Least time of one 2D L+U solve of one right-hand side (the sweeps
    of ``tapes``, the L and U sweeps by default; the Uᵀ and Lᵀ sweeps of a
    transposed solve read the same blocks), in the factor's dtype:
    2·bs²·nrhs per product and per diagonal inverse (operations); bytes:
    per sweep each rank's distinct pool blocks and the inverses read once,
    the partials written, put (non-owners) and read by the owner, the
    solved rows read by their owner and written into every rank's X."""
    plan = lu.plan
    blk = _blk(plan, lu._fdtype)
    xrow = float(lu._fdtype.itemsize) * plan.bs * nrhs
    flops = nbytes = 0.0
    for tp in tapes or (lu._lt, lu._ut):
        h = tp.host
        rk = np.repeat(h["p_rank"], np.diff(h["cptr"]))
        flops += 2.0 * plan.bs ** 2 * nrhs * (len(h["c_loc"]) + plan.nb)
        nbytes += blk * (len(set(zip(rk, h["c_loc"]))) + plan.nb)
        nsend = int(h["p_send"].sum())
        nbytes += xrow * (2 * len(h["p_pos"]) + 2 * nsend
                          + plan.nb * (1 + tp.ndev))
    return _bound(flops, nbytes, "transposed solve" if tapes else "solve",
                  lu._fdtype)


def profile_phase(lu, A, b):
    """``SparseLU.profile_levels`` on a level-executor factor: the six
    costliest levels; the solve after it must still meet the limits."""
    rows = lu.profile_levels()
    total = sum(r["ms"] for r in rows)
    print(f"profile_levels (level executor, bs={lu.plan.bs}): {len(rows)} "
          f"levels, {total:.3f} ms in all; the six costliest:")
    for r in sorted(rows, key=lambda r: -r["ms"])[:6]:
        print(f"  level {r['level']:3d}: {r['ms']:8.3f} ms; {r['steps']} "
              f"steps, {r['lpanels']}+{r['upanels']} panels, {r['gemms']} "
              f"Schur triples, {r['gflops_model']:.1f} GFLOP/s (model)",
              flush=True)
    x, berr = lu.refine(b, lu.solve(b))
    resid = float(np.abs(A @ x - b).max() / np.abs(b).max())
    print(f"after profile_levels: berr {berr.max():.3e}, residual "
          f"{resid:.3e}", flush=True)
    if len(rows) != lu.plan.n_flevels or berr.max() > 1e-12 \
            or resid > 1e-10:
        fail("profile_levels: wrong row count, or the solve after it "
             "misses the limits")


def print_tck_levels(tp, per_level, top=6, name="tck_update"):
    """Where tck_update's time goes: the costliest levels, each with
    phase A (waves, U targets, L·U products, critical path: the longest
    per-wave lists summed) and phase B (FP32: tiles, their rows, L·U
    products, the longest tile's list; bf16: positions, L·U products, the
    longest chain of one position, which the tiles could not cut, chunks
    and the longest, positions of several chunks), and each phase's
    ms."""
    h = tp.host
    cnt = np.diff(h["pptr"])
    tcnt = h["tiles"][:, 3] - h["tiles"][:, 2]
    bf16 = name.endswith("_bf16")
    c = tp.chains
    total = sum(r[0] for r in per_level)
    nb_ = (f"{int(c.qptr[-1])} chunks of {len(c.host['tslot'])} positions"
           if bf16 else f"{len(tcnt)} tiles")
    print(f"{name} by level (kernel {total:.3f} ms over {tp.nlvl} "
          f"levels: phase A {sum(r[1] for r in per_level):.3f} ms in "
          f"{int(tp.lwave[-1])} waves, phase B "
          f"{sum(r[2] for r in per_level):.3f} ms in {nb_}; top {top}):")
    for ms, ms_a, ms_b, lvl in sorted(per_level, reverse=True)[:top]:
        w0, w1 = int(tp.lwave[lvl]), int(tp.lwave[lvl + 1])
        t0, t1 = int(tp.wptr[w0]), int(tp.wptr[w1])
        crit = sum(int(cnt[tp.wptr[w]:tp.wptr[w + 1]].max(initial=0))
                   for w in range(w0, w1))
        b0, b1 = int(tp.tptr[lvl]), int(tp.tptr[lvl + 1])
        if bf16:
            p0, p1 = int(c.tptr[lvl]), int(c.tptr[lvl + 1])
            q0, q1 = int(c.qptr[lvl]), int(c.qptr[lvl + 1])
            qn = np.diff(c.host["qcptr"][q0:q1 + 1])
            pb = (f"{p1 - p0} positions, {int(qn.sum())} L·U products, "
                  f"longest chain of one position "
                  f"{int(np.diff(c.host['cptr'][p0:p1 + 1]).max(initial=0))}"
                  f" ({b1 - b0} tiles); {q1 - q0} chunks (longest "
                  f"{int(qn.max(initial=0))}), "
                  f"{int(c.mptr[lvl + 1] - c.mptr[lvl])} positions of "
                  "several")
        else:
            pb = (f"{b1 - b0} tiles of up to {int(h['trows'][lvl])} rows "
                  f"(tallest {int(tp.hmax[lvl])}), "
                  f"{int(tcnt[b0:b1].sum())} L·U products, longest tile "
                  f"{int(tcnt[b0:b1].max(initial=0))}")
        print(f"  level {lvl:3d}: kernel {ms:9.3f} ms; phase A {ms_a:.3f} "
              f"ms: {w1 - w0} waves, {t1 - t0} U targets, "
              f"{int(cnt[t0:t1].sum())} L·U products, critical path {crit} "
              f"({1e3 * ms_a / max(crit, 1):.2f} us a product);"
              f" phase B {ms_b:.3f} ms: {pb}", flush=True)


def print_update_levels(tp, per_level, bs, top=6, name="clk_update"):
    """Where clk_update's time goes: the costliest levels, with their
    columns, waves (one launch each), targets and CTAs (a target has bs/16
    strips; in the bf16 pass bs over each wave's strip width) over the
    level's waves, L·U products, the longest product list of one wave's
    target, and the critical path (the longest lists summed over the
    waves) with the time per product on it; in the bf16 pass also the
    waves of each (strip width, ring depth) that the host chose."""
    h = tp.host
    cnt = np.diff(h["pptr"])
    bf16 = name.endswith("_bf16")
    total = sum(ms for ms, _ in per_level)
    print(f"{name} by level (kernel {total:.3f} ms over {tp.nlvl} "
          f"levels, {int(tp.lwave[-1])} waves; top {top}):")
    for ms, lvl in sorted(per_level, reverse=True)[:top]:
        w0, w1 = int(tp.lwave[lvl]), int(tp.lwave[lvl + 1])
        t0, t1 = int(tp.wptr[w0]), int(tp.wptr[w1])
        longest = [int(cnt[tp.wptr[w]:tp.wptr[w + 1]].max(initial=0))
                   for w in range(w0, w1)]
        crit = sum(longest)
        ctas, geo = (t1 - t0) * (bs // 16), ""
        if bf16:
            from superlu_dist_tpu_torch.ops.kernels.clk import wave_geoms
            g = wave_geoms(tp, bs)[w0:w1]
            ntgt = np.diff(np.asarray(tp.wptr[w0:w1 + 1]))
            ctas = int((ntgt * (bs // (g >> 8))).sum())
            kinds = collections.Counter(
                (int(c) >> 8, int(c) & 255) for c in g)
            geo = "; geometry (strip width x ring depth: waves) " + ", ".join(
                f"{tn}x{st}: {n}" for (tn, st), n in sorted(kinds.items()))
        print(f"  level {lvl:3d}: kernel {ms:9.3f} ms; "
              f"{int(tp.uptr[lvl + 1] - tp.uptr[lvl])} columns, {w1 - w0} "
              f"waves, {t1 - t0} targets ({ctas} CTAs), "
              f"{int(cnt[t0:t1].sum())} L·U products, longest per-wave "
              f"list {max(longest, default=0)}, critical path {crit} "
              f"products ({1e3 * ms / max(crit, 1):.2f} us each){geo}",
              flush=True)


def print_flk_groups(tp, per_group, bs, top=6, name="flk"):
    """Where flk's time goes: the critical path (the sum over the groups
    of the longest chain, and of the longest chunk after the cut), then
    the costliest target groups, with their targets, products, longest
    chain, chunks (pass 1 CTAs per band), targets of several chunks (pass
    2) and the band width of pass 1 (``csrc/chain.cuh``'s rule)."""
    import torch

    from superlu_dist_tpu_torch.ops.kernels import flk
    h = tp.host
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    total = sum(ms for ms, _ in per_group)
    lens, qlen = np.diff(h["cptr"]), np.diff(h["qcptr"])

    def longest(a, lo, hi):
        return int(a[lo:hi].max(initial=0))

    crit = sum(longest(lens, tp.tptr[g], tp.tptr[g + 1]) for _, g in
               per_group)
    crit_q = sum(longest(qlen, tp.qptr[g], tp.qptr[g + 1]) for _, g in
                 per_group)
    print(f"{name} by target group (kernel {total:.3f} ms over "
          f"{len(per_group)} groups, {len(qlen)} chunks, "
          f"{len(h['mtgt'])} pass-2 targets; critical path {crit} chained "
          f"products, {crit_q} after the cut; top {top}):")
    for ms, g in sorted(per_group, reverse=True)[:top]:
        lo, hi = tp.tptr[g], tp.tptr[g + 1]
        q0, q1 = tp.qptr[g], tp.qptr[g + 1]
        band = flk.band_width(bs, q1 - q0, sms)
        print(f"  level {g // 2:3d} {'panels' if g % 2 else 'diagonal'}: "
              f"kernel {ms:9.3f} ms; {hi - lo} targets, "
              f"{int(lens[lo:hi].sum())} L·U products, longest chain "
              f"{longest(lens, lo, hi)}; {q1 - q0} chunks (longest "
              f"{longest(qlen, q0, q1)}), {tp.mptr[g + 1] - tp.mptr[g]} "
              f"pass-2 targets, bands of {band}", flush=True)


def print_panel_levels(name, per_launch, unit="panels", small=66, top=6):
    """Where a per-level kernel's time goes: the launches of fewer than
    ``small`` ``unit`` (for the panel TRSMs 66 panels, one partial wave of
    64-row bands on 132 SMs; for diag_lu 5 tiles, the top levels) against
    the rest, and the costliest launches with their ``unit``."""
    total = sum(ms for ms, _, _ in per_launch)
    few = [ms for ms, n, _ in per_launch if n < small]
    print(f"{name} by launch (kernel {total:.3f} ms over {len(per_launch)} "
          f"launches; {len(few)} launches of < {small} {unit} take "
          f"{sum(few):.3f} ms; top {top}):")
    for ms, n, what in sorted(per_launch, reverse=True)[:top]:
        print(f"  {what}: kernel {ms:.3f} ms; {n} {unit}", flush=True)


def print_schur_levels(tp, per_level, bs, dtype, top=6):
    """Where schur's time goes: the costliest levels, with their targets,
    products, longest per-target chain, the band width that
    ``csrc/chain.cuh`` takes (``flk.band_width``: 4x4 tiles in bands of
    16, else 4x8) and the share of the CUDA cores' peak for the type
    (CORE_FLOPS) that 2·bs³ per product reaches."""
    import torch

    from superlu_dist_tpu_torch.ops.kernels import flk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = np.dtype(dtype).name
    h = tp.host

    def share(nprod, ms):
        return 100 * 2.0 * FLOP_MUL[name] * bs ** 3 * nprod \
            / max(ms * 1e-3, 1e-12) / CORE_FLOPS[name]

    def bands(ntgt):   # complex128 takes bands of 16 always (chain.cuh)
        return 16 if np.dtype(dtype).itemsize == 16 else \
            flk.band_width(bs, ntgt, sms)

    total = sum(ms for ms, _ in per_level)
    print(f"schur by level (kernel {total:.3f} ms over {tp.nlvl} levels, "
          f"{share(len(h['cl']), total):.1f}% of the {name} CUDA cores' "
          f"peak; top {top}):")
    for ms, lvl in sorted(per_level, reverse=True)[:top]:
        lo, hi = tp.sptr[lvl], tp.sptr[lvl + 1]
        chain = np.diff(h["cptr"][lo:hi + 1])
        print(f"  level {lvl:3d}: kernel {ms:9.3f} ms; {hi - lo} targets, "
              f"{int(chain.sum())} L·U products, longest chain "
              f"{int(chain.max(initial=0))}; "
              f"bands of {bands(int(hi - lo))}, "
              f"{share(int(chain.sum()), ms):.1f}% of peak", flush=True)


# ---- 12. the batch and the ring embedding ---------------------------------

#: the batched kernels (a member axis on the level executor's kernels and
#: the NOTRANS sweep), each beside the unbatched kernel it runs per member
BATCH_OF = {"diag_lu_batch": "diag_lu", "trsm_batch": "trsm",
            "schur_batch": "schur", "sweep_batch": "sweep"}
#: the suffix of the batched rows of each type
BATCH_SFX = {"float32": "", "float64": "_f64", "complex64": "_c64",
             "complex128": "_c128"}


def batch_phase(ctx, rng, checks, launches):
    """Phase 12a-c: ``BatchedSparseLU`` in every type, driven through the
    user entry point, each batched kernel bit-equal to its unbatched entry
    on every member and within REL_TOL of its plain version; then 12d,
    ``gssvx_batch`` on the card and on a 2x2 grid."""
    from superlu_dist_tpu_torch.utils.testing import (helmholtz_3d,
                                                      laplacian_3d)
    batch_case(ctx, "12a batch float32", laplacian_3d(32).tocsc(), 4,
               "float32", 128, checks, launches, refactors=True,
               profile=True)
    batch_case(ctx, "12b batch float64", laplacian_3d(16).tocsc(), 64,
               "float64", 64, checks, launches)
    H = helmholtz_3d(16).tocsc()
    for dt in CSFX:
        batch_case(ctx, f"12c batch {dt}", H, 4, dt, 64, checks, launches)
    gssvx_batch_case(ctx, rng)


def batch_case(ctx, what, A, count, dtype, bs, checks, launches,
               refactors=False, profile=False):
    """``count`` members of A's pattern, member i's values A.data·(1 +
    0.1·N(0, 1)) of seed i, factored, solved and refined together by
    ``BatchedSparseLU`` with every launch count set to 0 just before and
    read just after: the batched factor must make one member's launches
    (one per level per phase) and no unbatched kernel launch, every
    member's x berr <= 1e-12. Then the warm batched factor, (with
    ``refactors``) ``count`` SparseLU refactors of the same members on
    the level executor in the same run, (with ``profile``) one batched
    refinement profiled, and every batched kernel against its unbatched
    entry and its plain version (:func:`check_batch`)."""
    import scipy.sparse as sp

    from superlu_dist_tpu_torch import (BatchedSparseLU, Fact, Options,
                                        SparseLU, Stats)
    from superlu_dist_tpu_torch.utils.norms import backward_error
    torch, schur = ctx["torch"], ctx["schur"]
    cplx = np.dtype(dtype).kind == "c"
    As = []
    for i in range(count):
        Ai = A.astype(np.complex128 if cplx else np.float64)
        Ai.data = Ai.data * (1 + 0.1 * np.random.default_rng(i)
                             .standard_normal(A.nnz))
        As.append(sp.csc_matrix(Ai))
    n = A.shape[0]
    r = np.random.default_rng(7)
    Xt = r.standard_normal((count, n))
    if cplx:
        Xt = Xt + 1j * r.standard_normal((count, n))
    B = np.stack([As[i] @ Xt[i] for i in range(count)])
    bk = ctx["batch_kernels"]
    for k in list(ctx["kernels"].values()) + list(bk.values()):
        k.reset_counts()
    t0 = time.perf_counter()
    blu = BatchedSparseLU(As, Options(dtype=dtype, block_size=bs),
                          device="cuda")
    fact = {k: bk[k].launches for k in bk}
    X, _ = blu.refine(B, blu.solve(B))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: bk[k].launches for k in bk}
    proto = {k: ctx["kernels"][BATCH_OF[k]].launches for k in bk}
    p = blu._proto
    plan, tp = p.plan, p._ftapes
    want = {"diag_lu_batch": int((np.diff(tp.dptr) > 0).sum()),
            "trsm_batch": int((np.diff(tp.lptr) > 0).sum()
                              + (np.diff(tp.uptr) > 0).sum()),
            "schur_batch": int((np.diff(tp.sptr) > 0).sum()),
            "sweep_batch": 0}
    berr = [backward_error(As[i], X[i], B[i]) for i in range(count)]
    xerr = float(np.abs(X - Xt).max() / np.abs(Xt).max())
    st = blu.stat
    pool_gib = count * plan.pool_bytes(np.dtype(dtype)) / 2**30
    print(f"{what}: {count} members of n={n} (bs {bs}, {plan.nslots} slots,"
          f" {plan.n_flevels} levels), pools {pool_gib:.2f} GiB; wall "
          f"{wall:.2f} s; device ms: factor {st.device_ms['FACT']:.3f}, "
          f"solve {st.device_ms['SOLVE']:.3f}, refine "
          f"{st.device_ms['REFINE']:.3f} ({st.refine_steps} steps); "
          f"refinement steps per member {blu.refine_steps.tolist()}; "
          f"launches per batched factor {sum(fact.values())} {fact} "
          f"(one member's factor: {sum(want.values())}); sweep_batch "
          f"{got['sweep_batch']} launches over the solve and refinement; "
          f"unbatched launches {proto}; max berr {max(berr):.3e}, "
          f"|x - x_true|/|x_true| {xerr:.3e}, tiny pivots "
          f"{blu.tiny.tolist()}", flush=True)
    if not np.all(np.isfinite(X)) or X.shape != (count, n):
        fail(f"{what}: solutions not finite or of the wrong shape")
    if max(berr) > 1e-12:
        fail(f"{what}: a member's berr {max(berr):.3e} > 1e-12")
    if fact != want:
        fail(f"{what}: the batched factor made {fact} launches, one "
             f"member's factor makes {want}")
    if any(proto.values()):
        fail(f"{what}: the batch made unbatched launches {proto} (its "
             "prototype launches none, its solves only sweep_batch)")
    if not got["sweep_batch"]:
        fail(f"{what}: the solves did not run sweep_batch")
    sfx = BATCH_SFX[dtype]
    for k in bk:
        launches[k + sfx] = got[k]
    # the warm batched factor, timed alone
    P0 = blu.initial_pools()
    fact_ms = _timed(torch, lambda: schur.factor_batch(
        P0, blu.thresh, tp, plan.nb))
    del P0
    print(f"{what}: warm batched factor {fact_ms:.3f} ms (L2 flushed), "
          f"{fact_ms / count:.3f} ms a member", flush=True)
    if refactors:
        lu = SparseLU(As[0], Options(dtype=dtype, block_size=bs,
                                     executor="pallas"), device="cuda")
        tot, nl = 0.0, 0
        for i in range(count):
            for k in ("diag_lu", "trsm", "schur"):
                ctx["kernels"][k].reset_counts()
            lu.stat = Stats()
            lu.stat.device = lu.device
            lu.refactor(As[i], Fact.SAME_PATTERN_SAME_ROWPERM)
            tot += lu.stat.device_ms["FACT"]
            nl += sum(ctx["kernels"][k].launches
                      for k in ("diag_lu", "trsm", "schur"))
        print(f"{what}: {count} SparseLU refactors (SamePattern_SameRowPerm,"
              f" executor='pallas') in the same run: FACT {tot:.3f} ms in "
              f"all ({tot / count:.3f} each), {nl} launches; the batched "
              f"factor {st.device_ms['FACT']:.3f} ms (first call), "
              f"{fact_ms:.3f} (warm), {sum(fact.values())} launches",
              flush=True)
        del lu
    if profile:
        profile_refine(torch, blu, B, X, f"{what}: batched ")
    c = check_batch(blu, ctx, what)
    for k in bk:
        checks[k + sfx] = c[k]
        print_check(k + sfx, c[k], launches[k + sfx])
    del blu, c
    torch.cuda.empty_cache()


def batch_compare(ck, name, kern, plain, single, state, slack=None):
    """``Checker.compare`` of a batched kernel (``kern``) with its plain
    version on the stacked ``state`` (beyond the plain version's own
    error tile by tile, :func:`own_slack`, or beyond the rounding bound
    ``slack``), then the unbatched
    entry (``single(m, *member m's state)``) on each member, bit-equal to
    the batched kernel's output there."""
    torch = ck.torch
    got, ms = ck.compare(name, kern, plain, state,
                         slack=slack or own_slack(torch, plain))

    def member(t, m):
        return t[m:m + 1] if t.dim() == 1 else t[m]
    for m in range(state[0].shape[0]):
        one = [member(t, m).clone() for t in state]
        single(m, *one)
        if not all(torch.equal(a, member(g, m)) for a, g in zip(one, got)):
            fail(f"{name}: member {m} of the batched launch differs from "
                 "the unbatched entry on that member")
    return got, ms


def sweep_slack(torch, tape, plain):
    """A first-order bound on how far two float32 (complex64) evaluations
    of one sweep level, from the same input, can lie apart: each output
    row X[I] = D·(X[I] − Σ P·X[src]) is within γ·|D|·(|X[I]| + Σ |P|·|X[src]|)
    of its exact value, γ = (2·bs + the longest chain)·eps, so two are
    within twice that. The magnitudes are the plain level run in float64
    on |X|, −|P| and |D|. Returns ``slack(state, want)`` for
    ``Checker.compare`` (no slack in float64 and complex128, where
    REL_TOL_F64 holds)."""
    def slack(state, want):
        X, P, D = state
        if X.dtype in (torch.float64, torch.complex128):
            return None
        chain = int(np.diff(tape.host["rowptr"]).max(initial=0))
        gamma = (2 * X.shape[2] + chain) * torch.finfo(X.real.dtype).eps
        mag = [X.abs().double(), -P.abs().double(), D.abs().double()]
        plain(*mag)
        return [2 * gamma * mag[0], torch.zeros_like(P.real),
                torch.zeros_like(D.real)]
    return slack


def check_batch(blu, ctx, what):
    """Each batched kernel over one factor (the sweep over one L+U solve
    of one right-hand side per member) level by level from the members'
    initial pools: against its plain version (the unbatched plain version
    member by member) and, on each member, bit-equal to the unbatched
    entry. library_ms: diag_lu_batch as the three calls of diag_library
    on every member's tiles of the level, trsm_batch as one torch.bmm of
    every member's panels of the level; no one call computes schur or the
    sweep. The bound is the members' count times one member's."""
    torch, schur, diag_lu, sg = (ctx[k] for k in ("torch", "schur",
                                                  "diag_lu", "solve_gemm"))
    p = blu._proto
    plan, tp = p.plan, p._ftapes
    bs, nb, count = plan.bs, plan.nb, blu.count
    P = blu.initial_pools()
    dev = P.device
    L = torch.zeros((count, nb, bs, bs), dtype=P.dtype, device=dev)
    U = torch.zeros_like(L)
    tiny = torch.zeros(count, dtype=torch.int32, device=dev)
    th = blu.thresh
    ck = Checker(torch, bs, tuple(BATCH_OF),
                 library=("diag_lu_batch", "trsm_batch"))
    for lvl in range(tp.nlvl):
        d = slice(int(tp.dptr[lvl]), int(tp.dptr[lvl + 1]))
        ds, dk = tp.dslot[d], tp.dstep[d]
        diag_library(ck, P, ds, "diag_lu_batch")
        (P, L, U, tiny), _ = batch_compare(
            ck, "diag_lu_batch",
            lambda p_, l_, u_, t_: diag_lu.diag_lu_batch(p_, l_, u_, ds, dk,
                                                         th, t_),
            lambda p_, l_, u_, t_: diag_lu.diag_lu_batch_plain(
                p_, l_, u_, ds.long(), dk.long(), th, t_),
            lambda m, p_, l_, u_, t_: diag_lu.diag_lu(
                p_, l_, u_, ds, dk, float(th[m]), t_),
            [P, L, U, tiny])
        for left, dinv, sl, sk, ptr in (
                (False, U, tp.lslot, tp.lstep, tp.lptr),
                (True, L, tp.uslot, tp.ustep, tp.uptr)):
            s = slice(int(ptr[lvl]), int(ptr[lvl + 1]))
            if s.stop > s.start:
                Xg = P[:, sl[s].long()].reshape(-1, bs, bs)
                Dg = dinv[:, sk[s].long()].reshape(-1, bs, bs)
                C = torch.empty_like(Xg)
                ck.library("trsm_batch",
                           (lambda: torch.bmm(Dg, Xg, out=C)) if left
                           else (lambda: torch.bmm(Xg, Dg, out=C)))
                del Xg, Dg, C
            (P, _), _ = batch_compare(
                ck, "trsm_batch",
                lambda p_, d_: schur.trsm_batch(p_, d_, sl[s], sk[s], left),
                lambda p_, d_: schur.trsm_batch_plain(p_, d_, sl[s], sk[s],
                                                      left),
                lambda m, p_, d_: schur.trsm(p_, d_, sl[s], sk[s], left),
                [P, dinv])
        (P,), _ = batch_compare(
            ck, "schur_batch", lambda p_: schur.schur_batch(p_, tp, lvl),
            lambda p_: schur.schur_batch_plain(p_, tp, lvl),
            lambda m, p_: schur.schur(p_, tp, lvl), [P])
    r = np.random.default_rng(1)
    X = torch.as_tensor(r.standard_normal((count, nb, bs, 1)),
                        dtype=P.dtype, device=dev)
    tl, tu = p._ltape, p._utape
    sg.solve_batch(P, L, U, tl, tu, X.clone())     # loads, allocates
    for tape, D in ((tl, L), (tu, U)):
        for lvl in range(tape.nlvl):
            def plain(x, p_, d_):
                for m in range(count):
                    sg.solve_level_plain(p_[m], d_[m], x[m], tape, lvl,
                                         False)
            (X, _, _), _ = batch_compare(
                ck, "sweep_batch",
                lambda x, p_, d_: sg.solve_level_batch(p_, d_, x, tape, lvl),
                plain,
                lambda m, x, p_, d_: sg.solve_level(p_, d_, x, tape, lvl,
                                                    False),
                [X, P, D], slack=sweep_slack(torch, tape, plain))
    dt = p._fdtype
    bounds = dict(diag_bound(plan, dt), **level_bounds(plan, tp, dt),
                  sweep=sweep_bound(plan, p))
    out = {}
    for k, base in BATCH_OF.items():
        o = dict(ck.out[k])
        b = bounds[base]
        o.update(b, bound_ms=b["bound_ms"] * count, flops=b["flops"] * count,
                 bytes=b["bytes"] * count, members=count)
        out[k] = o
    print(f"{what}: every batched kernel bit-equal to its unbatched entry "
          f"on each of the {count} members", flush=True)
    return out


def gssvx_batch_case(ctx, rng):
    """Phase 12d: ``gssvx_batch`` of four generated matrices (a 3D
    Laplacian, a 3D FEM mesh with 3 dof a node, a circuit and a KKT
    system), once on the card and once on a 2x2 grid: every matrix's x to
    berr <= 1e-12, and the path's kernels launched."""
    import scipy.sparse as sp

    from superlu_dist_tpu_torch import Grid2D, Options, gssvx_batch
    from superlu_dist_tpu_torch.utils.testing import (circuit_graph,
                                                      fem3d_delaunay,
                                                      kkt_system,
                                                      laplacian_3d)
    torch = ctx["torch"]
    As = {"laplacian_3d(24)": laplacian_3d(24),
          "fem3d_delaunay(4000)": fem3d_delaunay(4000),
          "circuit_graph(20000)": circuit_graph(20000),
          "kkt_system(10000)": kkt_system(10000)}
    names = list(As)
    mats = [sp.csc_matrix(A) for A in As.values()]
    bs_ = [np.asarray(A @ rng.standard_normal(A.shape[0])) for A in mats]
    print("12d gssvx_batch: " + ", ".join(
        f"{k} n={A.shape[0]} nnz={A.nnz}" for k, A in zip(names, mats)),
        flush=True)
    for grid, need in ((None, ("diag_lu", "clk_update", "clk_trsm",
                                "sweep")),
                       (Grid2D(2, 2), GRID_NEED)):
        where = "the card" if grid is None else "a 2x2 grid"
        for k in ctx["kernels"].values():
            k.reset_counts()
        t0 = time.perf_counter()
        res, lu = gssvx_batch(mats, bs_, Options(dtype="float32",
                                                 block_size=128),
                              grid=grid, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: k.launches for name, k in ctx["kernels"].items()}
        berr = [float(r.berr.max()) for r in res]
        print(f"12d gssvx_batch on {where}: composite n={lu.n}, "
              f"{lu.plan.nslots} slots, executor {lu.executor}; wall "
              f"{wall:.2f} s; device ms factor "
              f"{lu.stat.device_ms['FACT']:.3f}; refinement steps "
              f"{res[0].stat.refine_steps}; berr per matrix "
              + ", ".join(f"{b:.3e}" for b in berr), flush=True)
        if max(berr) > 1e-12 or not all(np.all(np.isfinite(r.x))
                                        for r in res):
            fail(f"12d gssvx_batch on {where}: berr {max(berr):.3e} > "
                 "1e-12 or x not finite")
        for name in need:
            if got[name] <= 0:
                fail(f"12d gssvx_batch on {where}: {name} not launched")
        del res, lu
        torch.cuda.empty_cache()


def embed_phase(ctx, rng, checks, launches):
    """Phase 12e: helmholtz_3d(32) in complex64 through the ring embedding
    (``SLU_TPU_COMPLEX=embed``): gssvx under clk (the default), flk and
    the level executor, each in NOTRANS, TRANS and CONJ with the
    condition estimate, logdet against the native complex64 factor's, a
    save_factors / load_factors round trip, and the float32 kernels of
    each executor against their plain versions on the embedded inputs;
    then gssvx_dist on a 2x2 grid, which runs rdma.cu's float32 entries,
    the same way."""
    import tempfile

    from superlu_dist_tpu_torch import (Grid2D, Options, SparseLU, Stats,
                                        Trans, load_factors, save_factors)
    from superlu_dist_tpu_torch.utils.testing import helmholtz_3d
    torch = ctx["torch"]
    A = helmholtz_3d(32).tocsc()
    n = A.shape[0]
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    if os.environ.get("SLU_TPU_COMPLEX"):
        fail("SLU_TPU_COMPLEX is set before phase 12e")
    native = SparseLU(A, Options(dtype="complex64", block_size=128),
                      device="cuda")
    nphase, nlog = native.logdet()
    del native
    eps = float(np.finfo(np.float32).eps)
    ltol = n * eps + 4 * eps * abs(nlog)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    nat = ctx.get("native_c64_ms", {})
    os.environ["SLU_TPU_COMPLEX"] = "embed"
    try:
        for exc, need in ((None, ("diag_lu", "clk_update", "clk_trsm",
                                  "sweep")),
                          ("flk", ("flk", "diag_lu", "sweep")),
                          ("pallas", ("diag_lu", "trsm", "schur",
                                      "sweep"))):
            name = exc or "clk"
            for trans in (Trans.NOTRANS, Trans.TRANS, Trans.CONJ):
                what = f"12e embedded complex64 {name} {trans.name}"
                extra = () if trans == Trans.NOTRANS else ("solve_gemm",
                                                           "diag_apply")
                # the FP32 pass (logdet is held to the native factor's at
                # float32 rounding); phase 13 drives the bf16 pass
                res, lu, _ = drive(ctx, what, A, b, Options(
                    dtype="complex64", block_size=128, executor=exc,
                    trans=trans, condition_number=True,
                    gemm_precision="highest"), need + extra)
                check_entries(ctx, what, tuple(
                    k for k in need + extra if k in F64_KERNELS), "f32")
                if not lu._embed or lu.pool.dtype != torch.float32 or \
                        lu.executor != name:
                    fail(f"{what}: not the embedded float32 factor under "
                         f"{name}")
                if res.rcond is None or not 0 < res.rcond <= 1:
                    fail(f"{what}: rcond {res.rcond} not in (0, 1]")
                if trans == Trans.NOTRANS:
                    lu_n, st = lu, res.stat
                print(f"{what}: rcond {res.rcond:.6e}", flush=True)
            lu_n.stat = Stats()     # one warm NOTRANS solve and refine
            lu_n.stat.device = lu_n.device
            lu_n.refine(b, lu_n.solve(b))
            sw = lu_n.stat
            print(f"12e embedded {name}: device ms factor "
                  f"{st.device_ms['FACT']:.3f} (NOTRANS call), solve "
                  f"{sw.device_ms['SOLVE']:.3f}, refine "
                  f"{sw.device_ms['REFINE']:.3f} ({sw.refine_steps} steps)"
                  f" (a warm NOTRANS solve and refine; the calls' SOLVE "
                  f"{st.device_ms['SOLVE']:.3f} holds rcond's solves)"
                  f"; native complex64 (phase 10, warm): factor "
                  f"{nat.get('FACT', float('nan')):.3f}, solve "
                  f"{nat.get('SOLVE', float('nan')):.3f}, refine "
                  f"{nat.get('REFINE', float('nan')):.3f}", flush=True)
            embed_logdet(f"12e embedded {name}", lu_n, nphase, nlog, ltol)
            with tempfile.TemporaryDirectory(dir=build) as d:
                path = os.path.join(d, "factors.npz")
                save_factors(lu_n, path)
                embed_reload(f"12e embedded {name}", load_factors(
                    path, device="cuda"), A, b)
            c = {"clk": check_kernels, "flk": check_flk,
                 "pallas": check_level}[name](lu_n, ctx, None)
            for k, o in c.items():
                print(f"12e embedded {name} {k}: max_abs_err "
                      f"{o['max_abs_err']:.3e} (tolerance {o['tol']:.3e}); "
                      f"kernel {o['ms']:.3f} ms, plain {o['plain_ms']:.3f} "
                      "ms", flush=True)
            del lu, lu_n, res, c
            torch.cuda.empty_cache()
        grid = Grid2D(2, 2)
        for trans in (Trans.NOTRANS, Trans.TRANS, Trans.CONJ):
            what = f"12e embedded complex64 2x2 grid {trans.name}"
            res, lu, _ = drive(ctx, what, A, b, Options(
                dtype="complex64", block_size=128, trans=trans,
                condition_number=True), GRID_NEED, SINGLE_DEVICE, grid=grid)
            grid_entries(ctx, what, "f32")
            if not lu._embed or lu.pool[0].dtype != torch.float32:
                fail(f"{what}: not the embedded float32 grid factor")
            if res.rcond is None or not 0 < res.rcond <= 1:
                fail(f"{what}: rcond {res.rcond} not in (0, 1]")
            print(f"{what}: rcond {res.rcond:.6e}", flush=True)
            if trans == Trans.NOTRANS:
                lu_n, st = lu, res.stat
        lu_n.stat = Stats()
        lu_n.stat.device = lu_n.device
        lu_n.refine(b, lu_n.solve(b))
        sw = lu_n.stat
        print(f"12e embedded 2x2 grid: device ms factor "
              f"{st.device_ms['FACT']:.3f} (NOTRANS call), solve "
              f"{sw.device_ms['SOLVE']:.3f}, refine "
              f"{sw.device_ms['REFINE']:.3f} ({sw.refine_steps} steps) (a "
              "warm NOTRANS solve and refine)", flush=True)
        embed_logdet("12e embedded 2x2 grid", lu_n, nphase, nlog, ltol)
        with tempfile.TemporaryDirectory(dir=build) as d:
            path = os.path.join(d, "factors.npz")
            save_factors(lu_n, path)
            embed_reload("12e embedded 2x2 grid", load_factors(
                path, device="cuda"), A, b)
        del lu, lu_n, res
    finally:
        del os.environ["SLU_TPU_COMPLEX"]
    torch.cuda.empty_cache()


def embed_logdet(what, lu, nphase, nlog, tol):
    """An embedded factor's logdet against the native complex64 one's:
    phase and log|det| within a rounding per pivot and the sum's own."""
    phase, logabs = lu.logdet()
    perr, lerr = abs(phase - nphase), abs(logabs - nlog)
    print(f"{what}: logdet phase {phase:.8f} (native {nphase:.8f}, err "
          f"{perr:.3e}), log|det| {logabs:.8f} (native {nlog:.8f}, err "
          f"{lerr:.3e}); tolerance {tol:.3e}", flush=True)
    if perr > tol or lerr > tol:
        fail(f"{what}: logdet disagrees with the native complex64 factor")


def embed_reload(what, lu, A, b):
    """A loaded embedded checkpoint solves and refines NOTRANS and CONJ
    to berr <= 1e-12."""
    from superlu_dist_tpu_torch import Trans
    if not lu._embed:
        fail(f"{what}: the checkpoint did not load as embedded")
    for trans, op in ((Trans.NOTRANS, A), (Trans.CONJ, A.conj().T)):
        x, berr = lu.refine(b, lu.solve(b, trans=trans), trans=trans)
        resid = float(np.abs(op @ x - b).max() / np.abs(b).max())
        print(f"{what} load_factors {trans.name}: berr {berr.max():.3e}, "
              f"residual {resid:.3e}", flush=True)
        if berr.max() > 1e-12 or resid > 1e-10:
            fail(f"{what}: loaded factors miss the limits in {trans.name}")


def _bound(flops, nbytes, per, dtype=np.float32, peak=None):
    """``flops`` counts 2·bs³ a block product; a complex one does four
    times as many real operations (FLOP_MUL). ``peak`` replaces the
    type's peak (the bf16 pass's tensor cores)."""
    flops = flops * FLOP_MUL[np.dtype(dtype).name]
    tf = flops / (peak or PEAK_FLOPS[np.dtype(dtype).name])
    tb = nbytes / PEAK_BYTES
    return dict(bound_ms=max(tf, tb) * 1e3,
                bound_by="operations" if tf >= tb else "bytes",
                per=per, flops=flops, bytes=nbytes)


def _blk(plan, dtype):
    """Bytes of one stored block."""
    return float(np.dtype(dtype).itemsize) * plan.bs * plan.bs


def work_bounds(plan, tp, lu):
    """Least time for each clk-path kernel's work in one factor (one L+U
    solve for the sweep) on this plan: the larger of its operations at the
    peak of its type and its bytes (each input read once, each output
    written once) at the memory rate."""
    bs = plan.bs
    h = tp.host
    nl = len(h["lslot"])
    return {"diag_lu": diag_bound(plan, lu._fdtype)["diag_lu"],
            "clk_update": update_bound(plan, tp, lu._fdtype),
            "clk_trsm": _bound(2.0 * bs ** 3 * nl,
                               _blk(plan, lu._fdtype) * (2 * nl + plan.nb),
                               "factor", lu._fdtype),
            "sweep": sweep_bound(plan, lu)}


def diag_bound(plan, dtype):
    """diag_lu: (4/3)·bs³ per tile; the tile in and out, both inverses
    out."""
    nd, bs = plan.nb, plan.bs
    return {"diag_lu": _bound(nd * (4.0 / 3.0) * bs ** 3,
                              nd * 4 * _blk(plan, dtype), "factor", dtype)}


def sweep_bound(plan, lu):
    """One L+U solve: 2·bs² per contribution and per diagonal inverse;
    each stored block and inverse read once, X read and written once per
    sweep."""
    bs = plan.bs
    ncon = len(lu._ltape.host["cslot"]) + len(lu._utape.host["cslot"])
    nslots_read = len(np.unique(lu._ltape.host["cslot"])) + \
        len(np.unique(lu._utape.host["cslot"]))
    esz = np.dtype(lu._fdtype).itemsize
    return _bound(2.0 * bs * bs * (ncon + 2 * plan.nb),
                  _blk(plan, lu._fdtype) * (nslots_read + 2 * plan.nb)
                  + 2 * 2 * esz * plan.n_pad, "solve", lu._fdtype)


def update_bound(plan, tp, dtype):
    """The left-looking update of one factor (clk_update, and tck_update,
    which computes the same function), from the clk tapes ``tp``: 2·bs³
    per U finalize and per L·U product; per level the distinct U blocks,
    L sources and targets read once, the U blocks and targets written
    once, each source's inverse read once."""
    bs = plan.bs
    blk = _blk(plan, dtype)
    h = tp.host
    flops = nbytes = 0.0
    for lvl in range(tp.nlvl):
        cols = h["ucols"][tp.uptr[lvl]:tp.uptr[lvl + 1]]
        if not len(cols):
            continue
        jobs = np.concatenate([np.arange(h["col_job0"][k],
                                         h["col_job0"][k] + h["col_dpos"][k])
                               for k in cols])
        uslots = np.concatenate([np.arange(h["col_base"][k],
                                           h["col_base"][k]
                                           + h["col_dpos"][k])
                                 for k in cols])
        lsrc = np.unique(np.concatenate(
            [np.arange(h["job_la0"][q], h["job_la0"][q] + h["job_lm"][q])
             for q in jobs]))
        tgt = np.unique(np.concatenate(
            [h["dst"][h["job_dst0"][q]:h["job_dst0"][q] + h["job_lm"][q]]
             for q in jobs]))
        reads = len(np.union1d(np.union1d(uslots, lsrc), tgt))
        writes = len(np.union1d(uslots, tgt))
        nlinv = len(np.unique(h["job_src"][jobs]))
        flops += 2.0 * bs ** 3 * (len(jobs) + h["job_lm"][jobs].sum())
        nbytes += blk * (reads + writes + nlinv)
    return _bound(flops, nbytes, "factor", dtype)


def flk_bounds(plan, tp, flk):
    """flk's least time per factor: 2·bs³ per Schur triple and per panel
    finalize; per launch (target group), the distinct target and source
    blocks read once, the targets written once and the inverses read
    once."""
    bs = plan.bs
    blk = _blk(plan, np.float32)
    h = tp.host
    nfin = int(np.count_nonzero(h["tfin"] != flk.FIN_NONE))
    flops = 2.0 * bs ** 3 * (len(h["cl"]) + nfin)
    nbytes = 0.0
    for g in range(2 * tp.nlvl):
        lo, hi = tp.tptr[g], tp.tptr[g + 1]
        if hi == lo:
            continue
        c = slice(h["cptr"][lo], h["cptr"][hi])
        t = h["tslot"][lo:hi]
        src = np.union1d(h["cl"][c], h["cu"][c])
        fin = h["tfin"][lo:hi] != flk.FIN_NONE
        ninv = len(np.unique(h["tstep"][lo:hi][fin]))
        nbytes += blk * (len(np.union1d(t, src)) + len(t) + ninv)
    return _bound(flops, nbytes, "factor")


def level_bounds(plan, tp, dtype):
    """schur: 2·bs³ per Schur triple; per level the distinct targets and
    sources read once and the targets written once. trsm: 2·bs³ per panel
    block; panels in and out, each step's two inverses read once."""
    bs = plan.bs
    blk = _blk(plan, dtype)
    h = tp.host
    nbytes = 0.0
    for lvl in range(tp.nlvl):
        lo, hi = tp.sptr[lvl], tp.sptr[lvl + 1]
        c = slice(h["cptr"][lo], h["cptr"][hi])
        t = h["tslot"][lo:hi]
        src = np.union1d(h["cl"][c], h["cu"][c])
        nbytes += blk * (len(np.union1d(t, src)) + len(t))
    npanel = len(h["lslot"]) + len(h["uslot"])
    return {"schur": _bound(2.0 * bs ** 3 * len(h["cl"]), nbytes, "factor",
                            dtype),
            "trsm": _bound(2.0 * bs ** 3 * npanel,
                           blk * (2 * npanel + 2 * plan.nb), "factor",
                           dtype)}


# ---------------------------------------------------------------------------
# 13. the pass precision: clk's bf16 pass and the escalation
# ---------------------------------------------------------------------------


def check_bf16(lu, ctx, report=False):
    """clk's bf16 pass (``slu_clk_waves_bf16``, ``slu_clk_trsm_bf16``)
    against its plain version at "default" on ``lu``'s plan, level by
    level: both get the same input and the factor goes on with the
    kernel's output (diag_lu runs as the kernel between them). Each is held
    to its tolerance (BF16_TOL for the update, REL_TOL for the TRSM), and
    over the factor its summed distance from the bf16 plain version to
    BF16_FRACTION of the FP32 plain pass's (the plain version at
    "highest" on the same input). library_ms: clk_trsm_bf16 as one
    ``torch.bmm`` per level on the level's L blocks and U inverses cast
    to bf16 beforehand (cuBLAS's bf16 product, bf16 out); none for
    clk_update_bf16, as for clk_update. With ``report`` it prints the
    update's costliest levels."""
    torch, clk, diag_lu = ctx["torch"], ctx["clk"], ctx["diag_lu"]
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    ck = Checker(torch, plan.bs, BF16_KERNELS, library=("clk_trsm_bf16",))
    dist = {k: [0.0, 0.0] for k in BF16_KERNELS}

    def step(name, kern, plain, rel):
        a, p, h = pool.clone(), pool.clone(), pool.clone()
        ms = _timed(torch, lambda: kern(a))
        plain_ms = _timed(torch, lambda: plain(p, "default"))
        plain(h, "highest")
        ck.record(name, ms, plain_ms, [a], [p], rel=rel)
        dist[name][0] += float((a - p).abs().sum())
        dist[name][1] += float((h - p).abs().sum())
        del p, h
        return a, ms

    per_level = []
    for lvl in range(tp.nlvl):
        pool, ms = step(
            "clk_update_bf16",
            lambda p: clk.clk_update(p, linv, tp, lvl, "default"),
            lambda p, pr: clk.clk_update_plain(p, linv, tp, lvl, pr),
            BF16_TOL)
        per_level.append((ms, lvl))
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        th, tiny)
        lo, hi = int(tp.lptr[lvl]), int(tp.lptr[lvl + 1])
        if hi > lo:
            Lg = pool[tp.lslot[lo:hi].long()].to(torch.bfloat16)
            Ug = uinv[tp.lstep[lo:hi].long()].to(torch.bfloat16)
            C = torch.empty_like(Lg)
            ck.library("clk_trsm_bf16", lambda: torch.bmm(Lg, Ug, out=C))
            del Lg, Ug, C
        pool, _ = step(
            "clk_trsm_bf16",
            lambda p: clk.clk_trsm(p, uinv, tp, lvl, "default"),
            lambda p, pr: clk.clk_trsm_plain(p, uinv, tp, lvl, pr), REL_TOL)
    if report:
        print_update_levels(tp, per_level, plan.bs, name="clk_update_bf16")
    out = ck.out
    b = bf16_bounds(plan, tp, lu)
    for name, (kern, fp32) in dist.items():
        o = out[name]
        o.update(b[name], dist=kern, fp32_dist=fp32)
        if fp32 > 0 and kern > BF16_FRACTION * fp32:
            fail(f"{name} (bs={plan.bs}): summed distance {kern:.3e} from "
                 f"its bf16 plain version, not below {BF16_FRACTION} of the "
                 f"FP32 pass's {fp32:.3e}: not the low pass")
    return out


def bf16_bounds(plan, tp, lu):
    """The bf16 pass's least time: the FP32 pass's operations (2·bs³ a
    block product) at the dense bf16 tensor-core peak, and its bytes (the
    float32 pool and inverses, each input read once and each output
    written once) at the memory rate."""
    w = work_bounds(plan, tp, lu)
    return {f"{k}_bf16": _bound(w[k]["flops"], w[k]["bytes"], "factor",
                                peak=BF16_PEAK_FLOPS)
            for k in ("clk_update", "clk_trsm")}


def factor_kernel_ms(ctx, lu, precision):
    """Device ms of the fused executor's kernels (clk, tck or flk:
    ``lu.executor``) inside one warm factor of ``lu``'s values at
    ``precision``, in the factor's own order (CUDA events around each
    launch, no flush, one synchronisation at the end), summed by kernel:
    per level clk_update, diag_lu, clk_trsm; tck_update, diag_lu,
    clk_trsm; or flk (both groups) and diag_lu."""
    torch, clk, tck, flk, diag_lu = (ctx[k] for k in (
        "torch", "clk", "tck", "flk", "diag_lu"))
    tp = lu._ftapes
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    marks = []
    for lvl in range(tp.nlvl):
        d = slice(int(tp.dptr[lvl]), int(tp.dptr[lvl + 1]))
        diag = ("diag_lu", lambda: diag_lu.diag_lu(
            pool, linv, uinv, tp.dslot[d], tp.dstep[d], th, tiny))
        trsm = ("clk_trsm", lambda: clk.clk_trsm(pool, uinv, tp, lvl,
                                                 precision))
        steps = {
            "clk": (("clk_update", lambda: clk.clk_update(
                pool, linv, tp, lvl, precision)), diag, trsm),
            "tck": (("tck_update", lambda: tck.tck_update(
                pool, linv, tp, lvl, precision)), diag, trsm),
            "flk": (("flk", lambda: flk.flk_update(
                pool, linv, uinv, tp, 2 * lvl, precision=precision)), diag,
                    ("flk", lambda: flk.flk_update(
                        pool, linv, uinv, tp, 2 * lvl + 1,
                        precision=precision)))}[lu.executor]
        for name, fn in steps:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            marks.append((name, ev))
    torch.cuda.synchronize()
    ms = {}
    for name, ev in marks:
        ms[name] = ms.get(name, 0.0) + ev[0].elapsed_time(ev[1])
    return ms


def precision_compare(ctx, what, A, b, opts, lu):
    """The warm factor and refinement of ``lu``'s plan under "auto"
    (bf16-first) and "highest", by SamePattern_SameRowPerm refactors in
    turns (auto, highest, highest, auto): per call the resolved precision,
    whether the escalation fired, FACT / SOLVE / REFINE device ms (FACT
    holds both factors of an escalation), the refinement steps, berr and
    the residual (each held to the limits); then the executor's kernels
    (clk's, tck's or flk's) inside one warm factor at each precision; and
    which of the two makes FACT + REFINE shorter. An escalation's sticky "highest" is cleared before
    each "auto" call, so that each pays a fresh bf16-first attempt, as a
    new SparseLU of the matrix does."""
    from superlu_dist_tpu_torch import Fact, gssvx
    torch = ctx["torch"]
    ssr = Fact.SAME_PATTERN_SAME_ROWPERM
    fr = {"auto": [], "highest": []}
    for prec in ("auto", "highest", "highest", "auto"):
        lu._prec_sticky = False
        res, _ = gssvx(A, b, opts.replace(fact=ssr, gemm_precision=prec),
                       lu=lu)
        torch.cuda.synchronize()
        st, dm = res.stat, res.stat.device_ms
        berr = float(np.max(res.berr))
        resid = float(np.abs(A @ res.x - b).max() / np.abs(b).max())
        fr[prec].append(dm["FACT"] + dm["REFINE"])
        print(f"{what} {prec}: gemm_precision "
              f"{st.counters['gemm_precision']}, escalated "
              f"{bool(st.counters.get('precision_escalated'))}; device ms "
              f"FACT {dm['FACT']:.3f}, SOLVE {dm['SOLVE']:.3f}, REFINE "
              f"{dm['REFINE']:.3f} ({st.refine_steps} steps), FACT + REFINE "
              f"{dm['FACT'] + dm['REFINE']:.3f}; berr {berr:.3e}, residual "
              f"{resid:.3e}", flush=True)
        if berr > 1e-12 or resid > 1e-10:
            fail(f"{what} {prec}: berr {berr:.3e}, residual {resid:.3e}")
    for prec in ("default", "highest"):
        k = factor_kernel_ms(ctx, lu, prec)
        each = ", ".join(f"{name} {v:.3f} ms" for name, v in k.items())
        print(f"{what}: {lu.executor} inside one warm factor at {prec}: "
              f"{each} (sum {sum(k.values()):.3f})", flush=True)
    a, h = float(np.mean(fr["auto"])), float(np.mean(fr["highest"]))
    print(f"{what}: FACT + REFINE (mean of two warm calls) auto {a:.3f} ms, "
          f"highest {h:.3f} ms: bf16-first is "
          f"{'shorter' if a < h else 'longer'} by {abs(a - h):.3f} ms",
          flush=True)


def check_fused_bf16(lu, ctx, report=False):
    """tck's or flk's bf16 pass (``lu.executor``: ``slu_tck_waves_bf16``,
    then ``slu_tck_chunks_bf16`` and ``slu_tck_sum_bf16`` on phase B's
    chains, or ``slu_flk_chunks_bf16`` and ``slu_flk_sum_bf16``) against
    its plain version at "default" on ``lu``'s plan, tck phase by phase
    and flk group by group, level by level: both get the same input and
    the factor goes on with the kernel's output (diag_lu, and for tck
    clk_trsm_bf16, run as kernels between them). Held to BF16_TOL (a finalize inside a launch rounds a
    sum that the two order differently), and over the factor its summed
    distance from the bf16 plain version to BF16_FRACTION of the FP32
    plain pass's. No one PyTorch call computes either (library_ms None).
    With ``report`` it prints the costliest levels (tck, with phase B's
    time beside its own bound, :func:`phase_b_bound`) or groups (flk)."""
    torch, tck, flk, clk, diag_lu = (ctx[k] for k in (
        "torch", "tck", "flk", "clk", "diag_lu"))
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    name = "tck_update_bf16" if lu.executor == "tck" else "flk_bf16"
    ck = Checker(torch, plan.bs, (name,))
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    dist = [0.0, 0.0]

    def step(kern, plain):
        nonlocal pool
        a, p, h = pool.clone(), pool.clone(), pool.clone()
        ms = _timed(torch, lambda: kern(a))
        plain_ms = _timed(torch, lambda: plain(p, "default"))
        plain(h, "highest")
        ck.record(name, ms, plain_ms, [a], [p], rel=BF16_TOL)
        dist[0] += float((a - p).abs().sum())
        dist[1] += float((h - p).abs().sum())
        pool = a
        return ms

    per = []
    for lvl in range(tp.nlvl):
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        if name == "tck_update_bf16":
            ms_a = step(lambda p: tck.tck_waves(p, linv, tp, lvl, "default"),
                        lambda p, pr: tck.tck_waves_plain(p, linv, tp, lvl,
                                                          pr))
            ms_b = step(lambda p: tck.tck_chains(p, tp, lvl),
                        lambda p, pr: tck.tck_chains_plain(p, tp, lvl, pr))
            per.append((ms_a + ms_b, ms_a, ms_b, lvl))
            diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                            tp.dstep[lo:hi], th, tiny)
            clk.clk_trsm(pool, uinv, tp, lvl, "default")
            continue
        for g in (2 * lvl, 2 * lvl + 1):
            per.append((step(
                lambda p: flk.flk_update(p, linv, uinv, tp, g,
                                         precision="default"),
                lambda p, pr: flk.flk_update_plain(p, linv, uinv, tp, g,
                                                   pr)), g))
            if g == 2 * lvl:
                diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                                tp.dstep[lo:hi], th, tiny)
    if report and name == "tck_update_bf16":
        print_tck_levels(tp, per, name=name)
        for ph, pb, i in (("A", phase_a_bound(plan, tp), 1),
                          ("B", phase_b_bound(plan, tp), 2)):
            print(f"{name} phase {ph}: kernel {sum(r[i] for r in per):.3f} "
                  f"ms, bound {pb['bound_ms']:.4f} ms ({pb['bound_by']}) "
                  "per factor", flush=True)
    elif report:
        print_flk_groups(tp, per, plan.bs, name=name)
    o = ck.out[name]
    o.update(fused_bf16_bound(plan, tp, lu, ctx), dist=dist[0],
             fp32_dist=dist[1])
    if dist[1] > 0 and dist[0] > BF16_FRACTION * dist[1]:
        fail(f"{name} (bs={plan.bs}): summed distance {dist[0]:.3e} from "
             f"its bf16 plain version, not below {BF16_FRACTION} of the "
             f"FP32 pass's {dist[1]:.3e}: not the low pass")
    return ck.out


def fused_bf16_bound(plan, tp, lu, ctx):
    """tck's or flk's bf16 pass: the FP32 pass's operations (2·bs³ a
    block product and a finalize, tck's from the clk tapes of the same
    plan, as it computes clk_update's function) at the dense bf16
    tensor-core peak, and its bytes at the memory rate (as
    :func:`bf16_bounds` for clk)."""
    w = (update_bound(plan, ctx["clk"].build_clk_tapes(plan, "cpu"),
                      np.float32) if lu.executor == "tck"
         else flk_bounds(plan, tp, ctx["flk"]))
    return _bound(w["flops"], w["bytes"], "factor", peak=BF16_PEAK_FLOPS)


def phase_a_bound(plan, tp):
    """tck's phase A in the bf16 pass (the U blocks' waves), counted as
    :func:`update_bound` counts: 2·bs³ per product and per U finalize at
    the dense bf16 tensor-core peak; per level the distinct L sources, U
    sources and targets read once, the targets written once and the
    finalizes' inverses read once, at the memory rate."""
    from superlu_dist_tpu_torch.ops.kernels.flk import FIN_NONE
    blk = _blk(plan, np.float32)
    h = tp.host
    nbytes = 0.0
    for lvl in range(tp.nlvl):
        w0, w1 = int(tp.lwave[lvl]), int(tp.lwave[lvl + 1])
        t0, t1 = int(tp.wptr[w0]), int(tp.wptr[w1])
        if t1 == t0:
            continue
        p = slice(int(h["pptr"][t0]), int(h["pptr"][t1]))
        tgt = np.unique(h["tslot"][t0:t1])
        reads = np.union1d(np.union1d(h["cl"][p], h["cu"][p]), tgt)
        fin = h["tfin"][t0:t1] != FIN_NONE
        ninv = len(np.unique(h["tstep"][t0:t1][fin]))
        nbytes += blk * (len(reads) + len(tgt) + ninv)
    nfin = int(np.count_nonzero(h["tfin"] != FIN_NONE))
    return _bound(2.0 * plan.bs ** 3 * (len(h["cl"]) + nfin), nbytes,
                  "factor", peak=BF16_PEAK_FLOPS)


def phase_b_bound(plan, tp):
    """tck's phase B in the bf16 pass (its chains), counted as
    :func:`update_bound` counts: 2·bs³ per product at the dense bf16
    tensor-core peak; per level the distinct L sources, U blocks and
    targets read once and the targets written once, at the memory
    rate."""
    blk = _blk(plan, np.float32)
    c = tp.chains.host
    nbytes = 0.0
    for lvl in range(tp.nlvl):
        t0, t1 = int(c["tptr"][lvl]), int(c["tptr"][lvl + 1])
        if t1 == t0:
            continue
        p = slice(int(c["cptr"][t0]), int(c["cptr"][t1]))
        tgt = c["tslot"][t0:t1]
        reads = np.union1d(np.union1d(c["cl"][p], c["cu"][p]), tgt)
        nbytes += blk * (len(reads) + len(tgt))
    return _bound(2.0 * plan.bs ** 3 * len(c["cl"]), nbytes, "factor",
                  peak=BF16_PEAK_FLOPS)


def fused_launches(lu, name):
    """The launches of one bf16 factor of ``lu`` on its tapes: for tck one
    a wave, one a level with chunks and one a level with positions of
    several chunks; for flk one a group with chunks and one a group with
    targets of several chunks."""
    tp = lu._ftapes
    if name == "tck_update_bf16":
        c = tp.chains
        return int(tp.lwave[-1]) + int((np.diff(c.qptr) > 0).sum()) + \
            int((np.diff(c.mptr) > 0).sum())
    return int((np.diff(tp.qptr) > 0).sum()) + \
        int((np.diff(tp.mptr) > 0).sum())


def fused_precision_phase(ctx, checks, launches, A, b, lus):
    """Phase 13b: tck's and flk's bf16 pass (ROADMAP.md item 2b) on
    lap3d32, on the plans of phase 5 (``lus``, factored there at
    "highest"): gssvx under "auto" through tck, flk and ILU(1) by
    SamePattern_SameRowPerm refactors, driven like the main path (the
    bf16 entries must launch, the FP32 ones only after an escalation,
    which the counter must then report; the tck and flk calls' launches
    are those rows'), each twice with bit-equal x and equal refinement
    steps; tck_update_bf16 and flk_bf16 against their plain versions
    level by level (their rows); and per executor the warm comparison of
    "auto" and "highest" (:func:`precision_compare`: FACT, SOLVE and
    REFINE, the steps, berr, the escalation, and the executor's kernels
    inside one warm factor at each precision)."""
    from superlu_dist_tpu_torch import Fact
    ssr = Fact.SAME_PATTERN_SAME_ROWPERM
    for name, key, need in (
            ("tck", "tck_update_bf16",
             ("tck_update_bf16", "clk_trsm_bf16", "diag_lu", "sweep")),
            ("flk", "flk_bf16", ("flk_bf16", "diag_lu", "sweep")),
            ("ilu1", "flk_bf16", ("flk_bf16", "diag_lu", "sweep"))):
        lu = lus[name]
        what = f"13b {name} lap3d32 auto"
        opts = lu.options.replace(fact=ssr, gemm_precision="auto")
        fp32 = FUSED_OF[key][0]
        r1, lu, got = drive(ctx, what, A, b, opts, need,
                            ("clk_update", "schur"), lu=lu)
        c = r1.stat.counters
        esc = c.get("precision_escalated") == 1
        print(f"{what}: gemm_precision {c['gemm_precision']}, escalated "
              f"{esc}, {r1.stat.refine_steps} refinement steps", flush=True)
        if (c["gemm_precision"] == "highest") != esc or \
                any((got[k] > 0) != esc for k in fp32):
            fail(f"{what}: the counter or the FP32 launches disagree with "
                 "the escalation")
        want = fused_launches(lu, key)
        if got[key] != want:
            fail(f"{what}: {got[key]} launches of {key}, the tapes give "
                 f"{want} a factor")
        if name != "ilu1":
            launches[key] = got[key]
            e = ctx["entry_launches"][key] = dict(
                ctx["kernels"][key].entry_launches)
            if not all(e.values()):
                fail(f"an entry of {key} was not launched on its path: {e}")
        lu._prec_sticky = False
        r2, lu, _ = drive(ctx, f"{what}, second call", A, b, opts, need,
                          lu=lu)
        check_repeat(what, r1, r2)
        if name != "ilu1":
            c = check_fused_bf16(lu, ctx, report=True)
            checks.update(c)
            o = c[key]
            print_check(key, o, launches[key])
            print(f"{key}: summed distance from the bf16 plain version "
                  f"{o['dist']:.3e}, the FP32 pass's {o['fp32_dist']:.3e} "
                  f"(at most {BF16_FRACTION} of it)", flush=True)
        precision_compare(ctx, f"13b {name} lap3d32", A, b, opts, lu)


def precision_lap3d50(ctx, A, b, opts, lu):
    """Phase 13 on lap3d50 (called from phase 8 on its plan): clk under
    "auto" by a SamePattern_SameRowPerm refactor, driven like the main
    path (the bf16 kernels must launch; where the bf16 factor's
    refinement stalls, the escalation's FP32 factor too, and the counter
    must then read "highest"), the bf16 pass against its plain version
    level by level, and the warm comparison with "highest"."""
    from superlu_dist_tpu_torch import Fact
    res, lu, got = drive(ctx, "clk lap3d50 auto", A, b, opts.replace(
        fact=Fact.SAME_PATTERN_SAME_ROWPERM, gemm_precision="auto"), (
        "clk_update_bf16", "clk_trsm_bf16", "diag_lu", "sweep"),
        ("tck_update", "flk", "schur"), lu=lu)
    c = res.stat.counters
    esc = c.get("precision_escalated") == 1
    print(f"clk lap3d50 auto: escalated {esc}, gemm_precision "
          f"{c['gemm_precision']}", flush=True)
    if (c["gemm_precision"] == "highest") != esc or \
            (got["clk_update"] > 0) != esc or (got["clk_trsm"] > 0) != esc:
        fail("clk lap3d50 auto: the counter or the FP32 launches disagree "
             "with the escalation")
    c = check_bf16(lu, ctx, report=True)
    for name, o in c.items():
        print_check(f"lap3d50 {name}", o, got[name])
        print(f"lap3d50 {name}: summed distance from the bf16 plain "
              f"version {o['dist']:.3e}, the FP32 pass's {o['fp32_dist']:.3e}",
              flush=True)
    precision_compare(ctx, "lap3d50 clk", A, b, opts, lu)


def precision_phase(ctx, rng, checks, launches, A, b, opts, lu):
    """Phase 13: the bf16 pass on the main path (lap3d32, ``lu`` from
    phase 3): both bf16 kernels against their plain versions level by
    level (their rows), the warm comparison of "auto" and "highest", the
    ring-embedded complex64 factor under "auto", and one escalation."""
    from superlu_dist_tpu_torch import Options
    from superlu_dist_tpu_torch.utils.testing import helmholtz_3d
    c = check_bf16(lu, ctx, report=True)
    checks.update(c)
    for name, o in c.items():
        print_check(name, o, launches[name])
        print(f"{name}: summed distance from the bf16 plain version "
              f"{o['dist']:.3e}, the FP32 pass's {o['fp32_dist']:.3e} "
              f"(at most {BF16_FRACTION} of it)", flush=True)
    precision_compare(ctx, "main path lap3d32", A, b, opts, lu)

    Ah = helmholtz_3d(32).tocsc()
    bh = rng.standard_normal(Ah.shape[0]) + \
        1j * rng.standard_normal(Ah.shape[0])
    os.environ["SLU_TPU_COMPLEX"] = "embed"
    try:
        res, lu_e, _ = drive(
            ctx, "13 embedded complex64 helmholtz_3d(32) auto", Ah, bh,
            Options(dtype="complex64", block_size=128), (
                "clk_update_bf16", "clk_trsm_bf16", "diag_lu", "sweep"),
            ("clk_update", "clk_trsm"))
    finally:
        del os.environ["SLU_TPU_COMPLEX"]
    if not lu_e._embed or res.stat.counters["gemm_precision"] != "default":
        fail("13 embedded complex64: not the embedded bf16-first factor")
    del lu_e, res
    escalation_phase(ctx, rng)


def escalation_phase(ctx, rng):
    """Phase 13, the escalation on the card: ``aniso2d(128)`` (n = 16,384,
    anisotropy 1e-3), whose bf16 factor leaves refinement stalled (berr
    4.6e-3 after two steps, on the CPU's plain versions). gssvx under "auto"
    must escalate: ``precision_escalated`` 1, ``gemm_precision``
    "highest", both passes' clk kernels launched, berr ≤ 1e-12; a
    SamePattern_SameRowPerm refactor then factors at "highest" directly
    (the sticky choice: the FP32 kernels only); and an explicit "bf16"
    factor never escalates."""
    from superlu_dist_tpu_torch import Fact, Options, SparseLU
    from superlu_dist_tpu_torch.utils.testing import aniso2d
    A = aniso2d(128).tocsc()
    n = A.shape[0]
    b = np.asarray(A @ np.random.default_rng(1).standard_normal(n))
    opts = Options(dtype="float32", block_size=128)
    res, lu, got = drive(ctx, "13 escalation aniso2d(128)", A, b, opts, (
        "clk_update_bf16", "clk_trsm_bf16", "clk_update", "clk_trsm",
        "diag_lu", "sweep"))
    st = res.stat
    print(f"13 escalation aniso2d(128): precision_escalated "
          f"{st.counters.get('precision_escalated')}, gemm_precision "
          f"{st.counters['gemm_precision']}, sticky {lu._prec_sticky}; "
          f"FACT (both factors) {st.device_ms['FACT']:.3f} ms", flush=True)
    if st.counters.get("precision_escalated") != 1 or \
            st.counters["gemm_precision"] != "highest" or not lu._prec_sticky:
        fail("13 escalation aniso2d(128): the stalled bf16 factor did not "
             "escalate to a sticky \"highest\"")
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * rng.standard_normal(A2.nnz))
    b2 = np.asarray(A2 @ rng.standard_normal(n))
    res, lu, _ = drive(ctx, "13 escalation aniso2d(128), SamePattern_"
                       "SameRowPerm refactor", A2, b2, opts.replace(
                           fact=Fact.SAME_PATTERN_SAME_ROWPERM),
                       ("clk_update", "clk_trsm", "diag_lu", "sweep"),
                       BF16_KERNELS, lu=lu)
    if res.stat.counters["gemm_precision"] != "highest" or \
            "precision_escalated" in res.stat.counters:
        fail("13 escalation: the refactor did not start at \"highest\"")
    del lu, res
    lb = SparseLU(A, opts.replace(gemm_precision="bf16"), device="cuda")
    x, berr = lb.refine(b, lb.solve(b))
    print(f"13 explicit bf16 on aniso2d(128): berr {np.max(berr):.3e} after "
          f"{lb.stat.refine_steps} steps, gemm_precision "
          f"{lb.stat.counters['gemm_precision']}, escalated "
          f"{lb.stat.counters.get('precision_escalated')}", flush=True)
    if lb._gemm_prec_used != "default" or \
            "precision_escalated" in lb.stat.counters:
        fail("13 explicit bf16: escalated")


#: the C consumer's options: the main path's dtype and block size, on the
#: card (no "device" key)
BRIDGE_OPTIONS = '{"dtype": "float32", "block_size": 128}'

#: a fresh interpreter's gssvx on a matrix file, under SLU_TPU_XPROF: its
#: first-call phases as one JSON line
TRACE_RUN = r"""
import time
t0 = time.perf_counter()
import json, sys
import numpy as np
from superlu_dist_tpu_torch import Options, gssvx
from superlu_dist_tpu_torch.utils.io import read_matrix
import_s = time.perf_counter() - t0
A = read_matrix(sys.argv[1])
b = np.asarray(A @ np.ones(A.shape[0]))
res, lu = gssvx(A, b, Options(dtype="float32", block_size=128))
st = res.stat
print(json.dumps(dict(
    import_s=import_s, berr=float(np.max(res.berr)), steps=st.refine_steps,
    gemm_precision=st.counters["gemm_precision"],
    escalated=st.counters.get("precision_escalated", 0),
    host_s={k: st.utime[k] for k in ("FACT", "SOLVE", "REFINE")},
    device_ms={k: st.device_ms[k] for k in ("FACT", "SOLVE", "REFINE")})))
"""

#: the device-kernel names (``__global__`` functions) by which a trace of
#: the main path shows each of its kernels: diag_lu.cu's, clk.cu's update
#: waves in the bf16 pass (waves.cuh) and panel TRSM in the bf16 pass
#: (panel.cuh's trsm_mma_kernel), solve_gemm.cu's two passes
TRACE_KERNELS = {"diag_lu": ("diag_lu_kernel",),
                 "clk": ("wave_mma_kernel", "trsm_mma_kernel"),
                 "solve_gemm": ("chunk_kernel", "rows_kernel")}


def _subprocess(what, cmd, env, cwd, timeout=600):
    """Run ``cmd``; fail unless it exits 0. Returns (stdout, seconds)."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"14 {what}: no exit within {timeout} s")
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"14 {what} exited {out.returncode}:\n{out.stdout[-2000:]}\n"
             f"{out.stderr[-4000:]}")
    return out.stdout, wall


def surface_phase(smi):
    """Phase 14: the package surface from outside the process, at the
    main path's width (lap3d32, bs 128, float32, "auto", refined).

    1. the readers: lap3d32 written by ``utils.testing.write_hb`` (.rua) and
       ``scipy.io.mmwrite`` (.mtx) reads back from both as one matrix;
    2. the C bridge: ``libsuperlu_dist_tpu_torch`` built and a plain C
       program (``bridge_solve.c``) compiled against it and the header,
       run with only PYTHONPATH set (the checkout and site-packages): it
       reads the .rua, factors on the card, solves A x = A·1 with
       refinement and writes x, which must match the in-process
       ``SparseLU`` x to 1e-12 (relative ∞-norm; bit-equality printed);
    3. a fresh interpreter's gssvx under ``SLU_TPU_XPROF``: the written
       trace must hold the slu:FACT / SOLVE / REFINE spans and device
       kernels of diag_lu.cu, clk.cu and solve_gemm.cu;
    4. ``python -m superlu_dist_tpu_torch.utils.prewarm`` on the .rua:
       ``build_s`` small (everything is built), ``escalation_warm_s`` > 0
       (the factor ran bf16-first);
    5. ``SLU_TPU_CHECKLU`` / ``SLU_TPU_WRITELU`` on lap3d12 in float32,
       bf16-first ("auto") and FP32 ("highest"): two factors' dumps
       compare equal, and the residual is below 1e-4 for the FP32 factor
       and below 2^-8 (the bf16 unit roundoff) for the bf16-first one."""
    import tempfile

    import scipy.io

    from superlu_dist_tpu_torch import Options, SparseLU
    from superlu_dist_tpu_torch.utils import cbridge, debug
    from superlu_dist_tpu_torch.utils.io import read_matrix
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d, write_hb
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    site = [p for p in sys.path if "site-packages" in p]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([root] + site)
    with tempfile.TemporaryDirectory(dir=build) as d:
        # ---- 1. readers
        A = laplacian_3d(32).astype(np.float32)
        rua, mtx = os.path.join(d, "lap3d32.rua"), os.path.join(d, "l.mtx")
        write_hb(rua, A)
        scipy.io.mmwrite(mtx, A)
        t0 = time.perf_counter()
        Ah = read_matrix(rua)
        t_hb = time.perf_counter() - t0
        t0 = time.perf_counter()
        Am = read_matrix(mtx)
        t_mm = time.perf_counter() - t0
        if (Ah != Am).nnz or (Ah != A).nnz or Ah.shape != A.shape:
            fail("14 readers: the .rua and .mtx of lap3d32 read back as "
                 "different matrices")
        print(f"14 readers: lap3d32 n={Ah.shape[0]} nnz={Ah.nnz} from .rua "
              f"in {t_hb:.2f} s and .mtx in {t_mm:.2f} s (host), the same "
              f"matrix ({smi})", flush=True)

        # ---- 2. the C bridge on the card
        link = cbridge.python_link()
        print(f"14 bridge link: LIBDIR={link['LIBDIR']} LDVERSION="
              f"{link['LDVERSION']} Py_ENABLE_SHARED="
              f"{link['Py_ENABLE_SHARED']} flags {' '.join(link['flags'])} "
              f"({smi})", flush=True)
        t0 = time.perf_counter()
        exe = cbridge.compile_program(cbridge.consumer_source(),
                                      os.path.join(d, "bridge_solve"))
        t_build = time.perf_counter() - t0
        xbin = os.path.join(d, "x.bin")
        out, wall = _subprocess("C bridge", [exe, rua, BRIDGE_OPTIONS, xbin],
                                env, d)
        line = [ln for ln in out.splitlines() if ln.startswith("CBRIDGE OK")]
        if not line:
            fail(f"14 C bridge printed no CBRIDGE OK line:\n{out}")
        print(f"14 C bridge: {line[0]} (consumer built in {t_build:.1f} s, "
              f"subprocess wall {wall:.2f} s; {smi})", flush=True)
        xc = np.fromfile(xbin)
        lu = SparseLU(Ah, Options(dtype="float32", block_size=128))
        b = np.asarray(Ah @ np.ones(Ah.shape[0]))
        x, berr = lu.refine(b, lu.solve(b))
        st = lu.stat
        rel = float(np.abs(xc - x).max() / np.abs(x).max()) \
            if xc.shape == x.shape else float("inf")
        print(f"14 C bridge x against the in-process SparseLU x: relative "
              f"{rel:.3e} (tolerance 1e-12), bit-equal "
              f"{bool(np.array_equal(xc, x))}; in-process gemm_precision "
              f"{st.counters['gemm_precision']}, {st.refine_steps} "
              f"refinement steps, berr {float(np.max(berr)):.3e} ({smi})",
              flush=True)
        if not rel <= 1e-12:
            fail("14 C bridge: x differs from the in-process port's")
        del lu

        # ---- 3. the SLU_TPU_XPROF trace of a fresh interpreter
        tdir = os.path.join(d, "trace")
        out, wall = _subprocess(
            "SLU_TPU_XPROF gssvx", [sys.executable, "-c", TRACE_RUN, rua],
            dict(env, SLU_TPU_XPROF=tdir), d)
        first = json.loads(out.strip().splitlines()[-1])
        print(f"14 fresh-process gssvx under SLU_TPU_XPROF (first call, "
              f"profiler on; {smi}): wall {wall:.2f} s, {json.dumps(first)}",
              flush=True)
        files = [f for f in os.listdir(tdir) if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            fail(f"14 SLU_TPU_XPROF wrote {files}, not one trace")
        with open(os.path.join(tdir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        spans = [f"slu:{p}" for p in ("FACT", "SOLVE", "REFINE")]
        kern = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        found = {g: {k: sum(k in nm for nm in kern) for k in ks}
                 for g, ks in TRACE_KERNELS.items()}
        print(f"14 trace: {len(events)} events, {len(kern)} device-kernel "
              f"events, spans {[s_ for s_ in spans if s_ in names]}, kernel "
              f"events by name {found} ({smi})", flush=True)
        if not all(s_ in names for s_ in spans):
            fail("14 trace: a slu: phase span is missing")
        if not all(v > 0 for g in found.values() for v in g.values()):
            fail("14 trace: a kernel of the main path has no device event")

        # ---- 4. prewarm
        out, wall = _subprocess(
            "prewarm", [sys.executable, "-m",
                        "superlu_dist_tpu_torch.utils.prewarm", rua,
                        "--block-size", "128", "--dtype", "float32"],
            env, root)
        info = json.loads(out.strip().splitlines()[-1])
        rest = wall - sum(info[k] for k in ("build_s", "factor_s", "solve_s",
                                            "escalation_warm_s"))
        print(f"14 prewarm (subprocess wall {wall:.2f} s, {rest:.2f} s of it "
              f"outside the timed work: interpreter start, imports, read; "
              f"{smi}): {json.dumps(info)}", flush=True)
        if info["build_s"] > 5.0:
            fail("14 prewarm: build_s above 5 s with every library built")
        if not info["escalation_warm_s"] > 0:
            fail("14 prewarm: no escalation warm-up after a bf16-first "
                 "factor")

        # ---- 5. CHECKLU / WRITELU
        A12 = laplacian_3d(12)
        keep = {k: os.environ.get(k)
                for k in ("SLU_TPU_CHECKLU", "SLU_TPU_WRITELU")}
        os.environ["SLU_TPU_CHECKLU"] = "1"
        try:
            for prec in ("auto", "highest"):
                dumps, resid = [], []
                for i in range(2):
                    dumps.append(os.path.join(d, f"lu_{prec}_{i}.npz"))
                    os.environ["SLU_TPU_WRITELU"] = dumps[-1]
                    lu = SparseLU(A12, Options(dtype="float32",
                                               gemm_precision=prec))
                    resid.append(lu.stat.counters["checklu_max_resid"])
                same = debug.compare_lu(*dumps)
                print(f"14 CHECKLU lap3d12 float32 {prec} (gemm_precision "
                      f"{lu.stat.counters['gemm_precision']}): "
                      f"checklu_max_resid {resid[0]:.3e}, {resid[1]:.3e}; "
                      f"WRITELU dumps compare_lu {same} ({smi})", flush=True)
                if not same or not all(np.isfinite(resid)):
                    fail(f"14 CHECKLU/WRITELU {prec}: dumps differ or the "
                         "residual is not finite")
                # FP32 products: 1e-4; bf16 products (an 8-bit
                # significand): below the bf16 unit roundoff 2^-8
                if max(resid) >= (1e-4 if prec == "highest" else 2.0 ** -8):
                    fail(f"14 CHECKLU {prec}: the factor's residual is not "
                         "below its bound")
        finally:
            for k, v in keep.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    print(f"14 package surface phase: {time.perf_counter() - t_phase:.1f} s "
          f"wall ({smi})", flush=True)


# ---------------------------------------------------------------------------
# phase 15: two processes on the one card
# ---------------------------------------------------------------------------

#: phase 15's cases, in the order each process runs them
MP_CASES = ("a", "b", "c", "d", "e")
#: seconds a child of phase 15 may take
MP_TIMEOUT = 420


def mp_system():
    """Phase 15's matrix (lap3d32), right-hand side, the refactor's
    matrix and its right-hand side."""
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d
    A = laplacian_3d(32).tocsc()
    n = A.shape[0]
    b = np.asarray(A @ np.random.default_rng(15).standard_normal(n))
    A2 = A.copy()
    A2.data = A2.data * 1.5
    b2 = np.asarray(A2 @ np.random.default_rng(16).standard_normal(n))
    return A, b, A2, b2


def mp_options(case, one_process):
    """Options of case ``case``; c and d plan from the user ordering with
    neither scaling nor row permutation, and in one process without
    alignment (the distributed plan is never aligned)."""
    from superlu_dist_tpu_torch import ColPerm, Equil, Options, RowPerm
    from superlu_dist_tpu_torch.ops.host.ordering import geometric_nd
    opts = Options(dtype="float32", block_size=128, dist_executor="rdma")
    if case in ("c", "d"):
        opts = opts.replace(
            dist_planning=True, equil=Equil.NO, row_perm=RowPerm.NOROWPERM,
            col_perm=ColPerm.MY_PERMC,
            user_colperm=geometric_nd((32, 32, 32)),
            anc25d="replicated")
        if one_process:
            opts = opts.replace(align_blocks="off")
    return opts


def mp_run(case, A, b, A2, b2, pid, state, ckpt):
    """Run case ``case`` in this process (``pid`` None: alone; else
    process ``pid`` of two, whose input for b, c and d is its half of the
    rows); returns (SolveResult, the driver)."""
    import scipy.sparse as sp
    from superlu_dist_tpu_torch import (Fact, Grid2D, Grid3D, NRLocMatrix,
                                        Stats, gssvx3d, gssvx_dist,
                                        save_factors)
    from superlu_dist_tpu_torch.models.driver import SolveResult
    opts = mp_options(case, pid is None)
    if case == "e":
        lu = state["a"]
        lu.stat = Stats()           # the refactor's own phases
        lu.stat.device = lu.device
        lu.refactor(A2, fact=Fact.SAME_PATTERN_SAME_ROWPERM)
        x, berr = lu.refine(b2, lu.solve(b2))
        save_factors(lu, ckpt)
        return SolveResult(x=x, berr=berr, stat=lu.stat), lu
    M = A
    if pid is not None and case != "a":
        n, half = A.shape[0], A.shape[0] // 2
        lo, hi = (0, half) if pid == 0 else (half, n)
        M = NRLocMatrix([(lo, sp.csr_matrix(A)[lo:hi])], n, local=True)
    if case == "d":
        return gssvx3d(M, b, Grid3D(2, 2, 2), opts)
    return gssvx_dist(M, b, Grid2D(2, 2), opts)


def _digest(*arrays) -> str:
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def mp_cases(pid, ckpt):
    """Run phase 15's cases in this process; returns per case: device ms
    of FACT / SOLVE / REFINE, refinement steps, berr, fences, launches
    per entry of the grid's kernels and of the others, and digests of x
    and of each process share's pools (``pools`` by share)."""
    import torch
    from superlu_dist_tpu_torch.ops.kernels import cuda_kernels
    from superlu_dist_tpu_torch.parallel import window
    kernels = cuda_kernels()
    A, b, A2, b2 = mp_system()
    state, out = {}, {}
    for case in MP_CASES:
        for k in kernels.values():
            k.reset_counts()
        window.FENCES.reset()
        window.ALLOCS.reset()
        t0 = time.perf_counter()
        res, lu = mp_run(case, A, b, A2, b2, pid, state, ckpt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        state[case] = lu
        op = (A2, b2) if case == "e" else (A, b)
        resid = float(np.abs(op[0] @ res.x - op[1]).max()
                      / np.abs(op[1]).max())
        st = res.stat
        pools = [p.cpu().numpy() for p in lu.pool]
        half = len(pools) // 2
        rec = dict(
            wall_s=wall, berr=float(np.max(res.berr)), resid=resid,
            steps=st.refine_steps, fences=window.FENCES.count,
            fence_ms=window.FENCES.seconds * 1e3,
            allocs=window.ALLOCS.count,
            alloc_ms=window.ALLOCS.seconds * 1e3,
            fact_fences=st.counters.get("fact_window_fences", 0),
            fact_fence_ms=st.counters.get("fact_window_fence_ms", 0.0),
            fact_alloc_ms=st.counters.get("fact_window_alloc_ms", 0.0),
            fact_ms=st.device_ms["FACT"], solve_ms=st.device_ms["SOLVE"],
            refine_ms=st.device_ms["REFINE"], x=_digest(res.x),
            pools=[_digest(*pools[:half]), _digest(*pools[half:])],
            entries={n: v for g in GRID_NEED
                     for n, v in kernels[g].entry_launches.items()},
            others={n: k.launches for n, k in kernels.items()
                    if n not in GRID_NEED and k.launches})
        bad = [k for k, v in lu.factor_recv().items()
               if not np.array_equal(v, lu._ft.recv[k])]
        for got, tp in zip(lu.solve_recv(), (lu._lt, lu._ut)):
            bad += [f"{tp.which}:{k}" for k, v in got.items()
                    if not np.array_equal(v, tp.recv[k])]
        rec["recv_ok"] = not bad
        out[case] = rec
    return out


def multiproc_child(pid: int, port: str, outdir: str) -> None:
    """A child of phase 15: process ``pid`` of two on the one card."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from superlu_dist_tpu_torch.parallel import multihost
    if not torch.cuda.is_available():
        fail("the child of phase 15 has no CUDA device")
    multihost.initialize(f"127.0.0.1:{port}", num_processes=2,
                         process_id=pid)
    out = mp_cases(pid, os.path.join(outdir, "two.npz"))
    multihost.barrier()
    with open(os.path.join(outdir, f"child{pid}.json"), "w") as f:
        json.dump(out, f)
    print(f"child {pid} done", flush=True)


def _mp_line(tag, r):
    return (f"{tag}: FACT {r['fact_ms']:.3f} ms, SOLVE {r['solve_ms']:.3f} "
            f"ms, REFINE {r['refine_ms']:.3f} ms ({r['steps']} steps), "
            f"fences {r['fences']} ({r['fence_ms']:.3f} ms; in FACT "
            f"{r['fact_fences']}, {r['fact_fence_ms']:.3f} ms), shared "
            f"allocations {r['allocs']} ({r['alloc_ms']:.3f} ms; in FACT "
            f"{r['fact_alloc_ms']:.3f} ms), wall {r['wall_s']:.2f} s, berr "
            f"{r['berr']:.3e}")


def multiproc_phase(smi):
    """Phase 15 (see the module doc). Returns each child's launches per
    entry of rdma_factor and rdma_solve over its cases, by row name."""
    import socket
    import tempfile
    t_phase = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="slu_smoke15_")
    one = mp_cases(None, os.path.join(outdir, "one.npz"))
    for case in MP_CASES:
        print(_mp_line(f"15{case} one process", one[case]), flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, TMPDIR=outdir)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(pid),
         str(port), outdir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        fail(f"15: a child outlived {MP_TIMEOUT} s")
    wall = time.perf_counter() - t0
    for pid, (p, text) in enumerate(zip(procs, outs)):
        print(f"15 child {pid} (exit {p.returncode}), its output's end:\n"
              + "\n".join(text.splitlines()[-12:]), flush=True)
        if p.returncode != 0:
            fail(f"15: child {pid} failed")
    kids = []
    for pid in range(2):
        with open(os.path.join(outdir, f"child{pid}.json")) as f:
            kids.append(json.load(f))
    launched = {}
    for case in MP_CASES:
        ref = one[case]
        for pid, kid in enumerate(kids):
            r = kid[case]
            print(_mp_line(f"15{case} process {pid} of 2", r), flush=True)
            f32 = {n: v for n, v in r["entries"].items()
                   if n.endswith("_f32")}
            if not all(f32.values()) or r["others"]:
                fail(f"15{case} process {pid}: launched {r['entries']} "
                     f"and {r['others']}: not every _f32 entry of the "
                     "grid's kernels, or a single-device kernel")
            if r["berr"] > 1e-12 or r["resid"] > 1e-10 or not r["recv_ok"]:
                fail(f"15{case} process {pid}: berr {r['berr']:.3e}, "
                     f"residual {r['resid']:.3e}, receive counters equal "
                     f"the tapes {r['recv_ok']}")
            same = r["x"] == ref["x"] and r["pools"][pid] ==                 ref["pools"][pid] and r["steps"] == ref["steps"]
            print(f"15{case} process {pid}: x {r['x']}, its pools "
                  f"{r['pools'][pid]}; one process: x {ref['x']}, the "
                  f"share's pools {ref['pools'][pid]}; equal {same}",
                  flush=True)
            if not same:
                fail(f"15{case} process {pid}: x, pools or refinement "
                     "steps differ from the one-process run")
            for n, v in r["entries"].items():
                g = "rdma_factor" if "solve" not in n else "rdma_solve"
                launched.setdefault(g, [0, 0])[pid] += v
    ckpt = [np.load(os.path.join(outdir, f)) for f in ("one.npz",
                                                       "two.npz")]
    differ = [k for k in ckpt[0].files
              if not np.array_equal(ckpt[0][k], ckpt[1][k])]
    print(f"15e checkpoint of two processes equals one process's, array "
          f"for array: {not differ}", flush=True)
    if differ or sorted(ckpt[0].files) != sorted(ckpt[1].files):
        fail(f"15e: the checkpoints differ in {differ}")
    print(f"15 two processes on one card: {time.perf_counter() - t_phase:.1f}"
          f" s wall, the children {wall:.1f} s ({smi})", flush=True)
    return {g: v for g, v in launched.items()}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        multiproc_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
