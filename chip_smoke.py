#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (suitesparse_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``suitesparse_tpu_torch/kernels/csrc``.
2. Kernel phase: builds the plans of the 3-D Laplacian model problem
   ``laplacian_3d(50)`` (n = 125,000, nested dissection) and of a forest of
   512 independent ``laplacian_3d(6)`` blocks (n = 110,592), the factor's
   plan and the coarse solve plan that the solves take, and runs each
   kernel and its plain PyTorch version on the card at the shapes those
   plans give it (the solve kernels at the coarse solve plans'), from a
   numpy seed: potrf_trsm (K1) at the three largest
   groups of its gate (after checking that the plan sends the 24 groups of
   ``K1_GROUPS`` to it), each timed beside the factor's library route for
   the groups K1 does not take (``cholesky_ex`` + ``solve_triangular``),
   and at four shapes off the plan (``K1_OFF_PLAN``: C = 1, C = 96 in two
   chunks, an odd C > 32, C = 64), each K1 row called twice and under two
   forced splits of RU for bit-equal results and printed with its launch
   plan, then 11 tiles with one indefinite among them at C = 8, 16, 32 and
   48, which must leave the other 10 finite; the tiled extend-add (K2) on the largest tile
   manifest, the solve steps (K3, forward and backward) at the four largest
   groups of their gate at 1 and 64 right-hand sides and at three shapes
   off the plan (``K3_OFF_PLAN``: an odd C at NR 5, RU far above 720, RU =
   0), each K3 row with NaN above L11's diagonal, called twice for bit-equal
   results and printed with its launch plan, after the count of the model
   problem's solve-plan groups that take K3 (``K3_GROUPS``, at nrhs 1 and
   64), the batched
   trisolve
   (K4) at the forest's (512, 64) root group and the (45, 48) L11 shape,
   plain and transposed, at 1 and 64 right-hand sides, and at three
   shapes off the plans (``K4_OFF_PLAN``: the widest tile at the most
   right-hand sides its gate admits, many tiny tiles packed two a block at
   NR 3, an odd tile width at NR 5), every K4 tile with NaN above its
   diagonal, which the kernel must not read; the two-piece
   extend-add (K2b) on the two-piece manifest of K2's group, timed in turns
   with K2 on the same inputs, each printed with its launch plan, called
   twice for bit-equal F, the two forms bit-equal; K2 and K2b also on three
   manifests off the plan (``K2_OFF_PLAN``: a few tiles, an odd R whose F
   moves by 4-byte copies, runs of five steps), held and checked the same
   way; the streaming panel matvec (K5) at the four
   largest groups of its w2 route, with M = W2^T and M = W2, and the
   batched matvec (K6) at the four largest groups of its route, forward and
   transposed, both at 1 and 8 right-hand sides; K5 also at four shapes off
   the plan (``K5_OFF_PLAN``: N % 4 != 0, a tiny panel, the smallest plan
   group's backward panel), each K5 row called twice for a bit-equal Z and
   printed with its launch plan; K6 also at three shapes off
   the plan's ladders at 1 and 3 (``K6_OFF_PLAN``: one whose rows take K6's
   plain-load path, one of few long panels that takes its cluster and its
   ring of stages, one of wide panels whose forward X (at NR 3) stays in
   device memory and whose transposed columns span several blocks); the
   extend-add (K7) in the group form the factor launches (one launch for
   all classes of a group, ``extend_add_group``) on the (B, R) = (114,
   224) group's work list in fp32 and fp64 and on the fp64 factor's
   largest tile group (R = 3912, RU_c up to 2624), each call twice
   bit-equal and equal bit for bit to one launch a class; then in its
   one-class form on three pair classes of the (114, 224) group, in the
   factor's form (each pair reads its child out of the source group's
   update block through ``src``) in fp32 and fp64, two calls bit-equal,
   and padded by ``pad_pairs``. Tolerances, relative to the largest plain entry (sums
   in another order): 1e-5 in fp32, 1e-6 for K2 and K2b, 1e-12 for K7 in
   fp64. Each kernel's time is
   printed beside its plain version's, the least time the card could take
   (bytes at 3.35 TB/s or fp32 flops at 67 TFLOP/s, fp64 at 34, whichever
   is larger; a triangular tile counts its lower triangle only; K7 counts
   what its maps reach) and one PyTorch call
   that computes the same function where there is one (and the kernel's
   time over that call's):
   ``torch.linalg.solve_triangular`` for K4, ``torch.bmm`` for K5 and K6,
   for K3 the two calls of the classic sweep's library route
   (``solve_triangular`` and ``baddbmm``, checked against K3's plain),
   for K1 the factor's two (``cholesky_ex`` and ``solve_triangular``,
   checked against K1's plain),
   ``extend_add_library`` (one ``index_put_`` a class, the placement the
   factor made before K7) for K7. K5, K6 and their library calls are timed with
   the L2 cache
   flushed before each call, as a sweep finds its panels. Every call is
   timed on the device alone: a spin kernel holds the device while the
   host enqueues the call.
3. Main path: ``analyze`` -> ``factorize`` -> ``solve`` (1 and 64
   right-hand sides, w2 sweep) through the package's entry points on the
   card. K1 must launch once for each of its 24 groups, K2 must launch
   and K7 once for each group with a pair class that no tile manifest
   folds (41 groups, 381 classes) during the factorization, and a second factorization must give the
   same bits; residuals must
   stay below 1e-5; the solves must take the coarse solve plan.
   ``solve_mode="auto"`` must pick w2 on the fresh factor and classic once
   the reported free memory leaves no room for the coarse plan's W2 and
   the factor's copy relaid into it. Also a
   small problem whose card factor must match the
   CPU factor entry by entry and whose solution must match the host
   simplicial solve.
4. Classic sweep: the same factor solved with ``solve_mode="classic"`` at 1
   and 64 right-hand sides; K3 must launch, residuals below 1e-5, x within
   1e-4 * max|x| of the w2 solve's x.
5. Forest: the 512-block forest through ``cholsol`` with
   ``solve_mode="classic"`` and ``factor_kind=SUPERNODAL_LL`` (its
   flops per nonzero of L, 28.6, sit below the automatic supernodal switch
   of 40); K3 and K4 must launch, and K7 once a group with pair classes,
   residual below 1e-5. Then the forest factored once more through
   ``factorize`` (reusing the kernel phase's analysis; K7 again once a
   group) and solved by the classic sweep at 64 right-hand sides: K4
   must launch, columns 0 and 63 below 1e-5, x within 1e-4 * max|x| of a
   w2 solve of the same factor.
6. Refinement: ``solve_refined`` on the model problem, residual below 1e-12.
   Then the model problem factored and solved in fp64
   (``compute_dtype="float64"``): K7's double instance must launch once
   for every group with pair classes (114 groups, 800 classes: the fp64
   factor runs no tile manifest), residual below 1e-12.
7. Kernel path: the model problem factored with ``tile_pair=True`` (K2b,
   K1 and K7 must launch, K7 as often as in the default factor, L within
   1e-5 * max|L| of the default factor's), then
   solved through the w2 sweep with ``solve_pmv=True, solve_bmv=True`` at
   1 and 8 right-hand sides (K5 and both K6 kernels must launch, residuals
   below 1e-5, x within 1e-4 * max|x| of the default w2 solve's x), each
   timed beside the default.
7b. bfloat16 child updates (``bf16_phase``, after step 7's timings, on
   the main path's A, analysis and plan): the model problem factored with
   ``update_dtype="bfloat16"`` through ``factorize``: K1 must launch for
   its 24 groups, K2, K2b and K7's fp32 and fp64 instances never, K7's
   (float, bfloat16) instance once a group with pair classes (114
   launches, all 800 classes: the tile path is off under bfloat16
   updates, as in the reference); two such factors bit-equal. It prints
   the first call, the steady factor (min of 3) timed in turns with the
   fp32 factor (fp32, bf16, bf16, fp32), the peak of each
   (``max_memory_allocated`` above the allocation at its reset), the
   profiler's busy time, ops and K7 device ms a factor (``prof.profile_
   phase``, tables in ``prof_out/``); one w2 solve below 1e-1 and
   ``solve_refined`` (2 steps) below 1e-5 and no worse (the reference's
   gates, ``tests/test_supernodal.py:160-179``), ``lx_host()`` against
   the fp32 factor's (printed, no gate); the same with fp64 fronts (K7's
   (double, bfloat16) instance once a group, 114 launches); the bfloat16
   factor forced into at least 4 segments bit-equal to the one-piece one;
   K7's two bfloat16 instances in the group form on the (114, 224) group
   and the fp64 factor's (1, 3912) group, each bit-equal to its same-type
   instance on the widened U, to one launch a class and to itself, within
   1e-5 (1e-12 in fp64) of the plain version, timed beside it, its bound
   (child cells at 2 bytes) and ``extend_add_library``
   (``extend_add_bf16`` and ``extend_add_f64_bf16`` on the kernel line),
   and the bfloat16 ``roofline_report`` TOTAL. Its JSON line (``bf16``)
   comes before the kernel line.
8. Multifrontal QR: ``qrsol`` on ``local_coupling_ls(6000, 2000)`` (the
   fixture of ``demos/bench_qr.py``) and ``grid_gradient_3d(32)`` (95,559
   x 32,768), fp32 and fp64 at one right-hand side (seed 7), the grid also
   at 4 in fp32 (``qr_phase``). Each call must take the device route (a
   non-finite factor raises); normal-equations residual below 1e-4 (fp32) and 1e-12
   (fp64), x within 1e-4 / 1e-10 of a dense ``lstsq`` at 6000 x 2000, the
   grid's fp32 x within 1e-4 of its fp64 x. It prints the analysis and
   plan times, the first call, the steady ``qrsol`` (min of 3), the factor
   and the solve apart, the Householder GFLOP/s, the groups and the peak
   memory; ``qr_s`` (the grid, fp32) and the gates join the metrics line.
   The QR path runs no hand-written kernel (the reference's reaches no
   Pallas kernel): ``torch.linalg.qr``, ``solve_triangular``, gathers.
   Then F11 (``qr_rank_check``): ``local_coupling_ls(6000, 2000)`` with
   column 7 a copy of column 5, fp32 and fp64: the device factor's rank
   estimate must equal the host ``qr_host``'s (n - 1), ``qrsol`` must give
   exactly zero x at one of the two columns, a residual within 1e-5
   (fp32) / 1e-10 (fp64) of the least-squares minimum (dense ``lstsq``),
   and an x no larger than 10 times the host QR's.
9. Unsymmetric multifrontal LU (``lu_phase``): ``lu_fem``, the fixture of
   ``demos/bench_unsym.py`` (``fem_unsym(30)``: n = 27,000, b = ones)
   through ``mflu_unsym.mflusol_unsym`` in fp32 and fp64, residual below
   1e-10 after the ladder and answered on the LU rung (no QR, no host LU),
   one ``lu_unsym_solve_device`` below 1e-4 (fp32) and 1e-12 (fp64);
   ``lu_upwind`` (``upwind_unsym(30)``, structural symmetry 0.40) through
   the router ``multifrontal_lu.mflusol`` in fp32, which must take the
   device strategy, residual below 1e-10; ``lu_repair``, the
   singular-home-block matrices of ``tests/test_mflu_unsym.py:96`` (n = 60,
   seeds 0-5), each below 1e-12, the device QR rung answering at least one
   and the host LU none. It prints the first call, the analysis and plan
   seconds, the steady ``lu_unsym_solve_device`` (min of 3) and its factor
   and sweep apart, the whole ``mflusol_unsym``, the device factors a call
   runs, the front-LU flops and GFLOP/s, the peak memory, the sizes and the
   rungs; ``lu_s``, ``lu64_s``, ``lu_upwind_s`` and the gates join the
   metrics line. No hand-written kernel runs there either
   (``lu_factor_ex``, ``solve_triangular``, ``baddbmm``, gathers).
10. Complex input (``complex_phase``, with ``ComplexWarning`` an error):
   the magnetic Laplacian of a 40^3 grid (``laplacian_3d(40)``, each
   strictly-upper entry times e^{i theta}, theta ~ U(-pi, pi) from seed 0;
   n = 64,000, 128,000 real unknowns embedded), b = 1 + i k/n, through
   ``cholsol``, which must take the 2x2 real embedding: the embedded
   factor must launch K1, K2 and K7, residual below 1e-5 and max|Hx -
   b| / max|b| below 1e-4; then K1, K2, K3 and K7 (fp32 and fp64) held
   against their plain versions at the embedded plan's shapes
   (``embedded_kernels``: its largest groups, the kernel phase's
   tolerances), and the embedded factor of a small magnetic Laplacian
   (k = 10) on the card equal to the CPU factor within 1e-5, its solve
   within 1e-4 of the host LL^H (``small_complex_check``); the first
   call with its parts (the n-node and
   the embedded analysis, the plan, the factor, the solve; the sweep
   ``solve_mode="auto"`` picked), the steady ``cholsol_complex_device``
   (analysis cached, min of 3), whose factor must replay its captured
   group loop bit-equal to the eager loop (``replay_check``), one classic
   solve (K3 must launch, below 1e-5) and one fp64 call (K7's double
   instance, below 1e-12, the fp32 x within 1e-4 of its x), then two
   more fp64 factors, the second a replay bit-equal to the eager loop;
   ``upwind_unsym(30)`` with its values times e^{i theta}, theta ~
   U(-pi/4, pi/4) from seed 5, through ``multifrontal_lu.mflusol`` (the
   unsymmetric strategy on the embedding, n = 54,000 real) under the auto
   segment budget, residual below 1e-10 after the ladder, its rungs, wall,
   peak and which way it ran (in one piece or in segments);
   ``local_coupling_ls(6000, 2000)`` and ``grid_gradient_3d(24)`` times
   e^{i theta} from seed 7 through ``qrsol`` in fp32 (the device QR of the
   embedding), the complex normal-equations residual below 1e-4 and, at
   6000 x 2000, x within 1e-4 of a dense ``lstsq``. Parts are the seconds
   spent in each step over the call, the device synchronized around each;
   a line gives the seconds of each step of the phase. Its JSON line
   (``complex``) comes before the kernel line.
11. Segmented execution (``segmented_phase``): four cells, each factored
   in one piece under the auto budget and then forced into at least 4
   segments by ``Config.segment_bytes`` (an eighth of the one-piece
   estimate): the model problem ``laplacian_3d(50)`` in fp32 (the same K1,
   K2 and K7 launch counts as the one-piece factor, ``Lx`` within 1e-6 *
   max|Lx| of it, a w2 solve below 1e-5), the QR grid
   ``grid_gradient_3d(32)`` (x within 1e-4 of the one-piece x, the
   normal-equations residual below 1e-4), the LU ``fem_unsym(30)`` and the
   complex LU on the embedded rotated ``upwind_unsym(30)`` (x within 1e-4
   of the one-piece x, one factor's residual below 1e-4; the complex cell
   also through the whole ``mflusol`` ladder in segments, below 1e-10, and
   its segmented peak below the one-piece peak by at least half of its
   gather indices). Each cell prints the segment count, the walls of the
   segmented and the one-piece factor (min of 3), the peak memory of each
   (``max_memory_allocated`` after ``reset_peak_memory_stats``, the
   one-piece upload let go before each), the byte estimate and budget, the
   largest difference and the residual. Its JSON line (``segmented``)
   comes before the kernel line.
12. Checkpoint/restart (``persist_phase``, run after step 7's timings):
   the model problem written to Matrix Market in a temporary directory and
   read back (the arrays equal), ``report.info_from_factor`` of the main
   path's factor printed, the factor saved (seconds and bytes) and loaded
   onto the card (``load_factor``: a px-layout factor whose panels equal
   ``lx_host()`` bit for bit, F1), ``check_factor`` on it, then solved through ``solve`` (the px sweep) at
   1 and 64 right-hand sides: K4 must launch once a gated group in each
   direction and nothing else must, residuals below 1e-5, x within 1e-4 *
   max|x| of the w2 solve's. K4 is held against its plain version at the
   px plan's largest gated group at NR 1 and 64 (the loaded factor's own
   L11, NaN above its diagonal), beside its bound and
   ``solve_triangular``. It prints the px plan's seconds, the bytes the
   restart path holds (the loaded ``Lx`` and the gathered panels on the
   card, the plan's gather maps on the host), the first px solve, and the steady px, w2 and classic solves of the same factor (min
   of 3, CUDA events, collector off) at 1 and 64 right-hand sides. Its
   JSON line (``persist``) comes before the kernel line.
13. Inverse panels without W2 (``inv_phase``, after step 12, on the main
   path's factor): ``solve_mode="inv"`` at 1 and 8 right-hand sides, with
   ``solve_bmv`` on (K6 must launch once a panel of each gated group, W
   and L21, in each direction, and nothing else) and off (no kernel);
   residuals below 1e-5 (and the bench gates), x within 1e-4 * max|x| of
   the w2 and the classic x; ``solve_dispatch``'s sweep must give the
   solve's x within 1e-6 * max|x| (the card's ``index_add_`` sums in no
   fixed order; its own wall printed). K6 is held against its
   plain version at the largest gated W (C, C) and L21 (RU, C) panels (the
   solve plan's own), each way, at 1 and 8 right-hand sides, beside its bound
   and ``torch.bmm`` (L2 flushed). It prints the bytes of the inv state (W
   and the K6 groups' L21 copies) against W2's and the steady inv, inv
   with K6, w2 and classic solves (min of 3, collector off).
14. Symmetric-strategy device LU (``mflu_sym_phase``): ``fem_unsym(30)``
   analysed by ``analyze_mflu``, ``factorize_lu_device`` and
   ``solve_mflu_device`` in fp32 and fp64, residual below 1e-4 / 1e-8, x
   within 1e-4 / 1e-10 of the host KLU ``lusol``'s, and the fp64 x of
   ``fem_unsym(16)`` within 1e-10 of the host ``mflusol``'s; first and
   steady factor and solve seconds and the peak memory. No hand-written
   kernel runs there (``lu_factor_ex``, ``solve_triangular``, ``baddbmm``,
   ``index_add_``). Both phases print one JSON line (``inv``,
   ``mflu_sym``) before the kernel line, which gains ``bmatvec_inv`` and
   ``bmatvec_t_inv`` (K6 on the inv path).
15. Distributed factor and solve (``dist_phase``): the parent
   builds the kernels, then spawns the ranks of four runs: (a) world 1
   over NCCL, flat, the model problem; (b) 4 ranks sharing the card over
   gloo, (host, chip) = (2, 2), the model problem; (c) 4 flat ranks in
   fp64 on ``laplacian_3d(30)``; (d) 2 ranks on ``laplacian_3d(12)`` with
   one negative diagonal entry in a leaf subtree of rank 1. Every rank's
   ``Lx`` and x must be bit-equal to rank 0's, ``lx_host()`` within 1e-5
   (fp64 1e-12) of the single-card factor on the same analysis, the
   distributed solve's residual at nrhs 1 and 8 and the single-card
   solve of the distributed factor below 1e-5 (fp64 1e-12), (d)'s minor
   on every rank the single-card factor's, the census one halo sum (or
   one host and one world sum) before the crown, one assembly sum and
   two sums a solve, and K1 and K7 launched on every fp32 rank as often
   as its rank plan predicts. On (b)'s rank 0, K1 at its largest gated
   leaf group and K7 on its cut placement with the most cells are held
   against their plain versions and timed (``potrf_trsm_dist``,
   ``extend_add_dist`` on the kernel line). A rank that fails, or
   outlasts DIST_JOIN_S, fails the run. It prints each run's phase
   seconds (rank 0), sums, launches and peaks, and a JSON line
   (``dist``) before the kernel line.
16. The sharded (tree, panel) factor (``mesh_phase``, last): the ranks
   of four runs, as ``dist_phase`` spawns them: (a) world 1 over NCCL,
   mesh (1, 1), the model problem; (b) 4 ranks over gloo on the card,
   mesh (2, 2), the model problem; (c) 4 ranks, mesh (1, 4), fp64,
   ``laplacian_3d(30)`` (the panel axis alone); (d) mesh (2, 1) on
   ``dist_phase``'s indefinite ``laplacian_3d(12)``. Every rank's ``Lx``
   must be bit-equal to rank 0's, ``lx_host()`` within 1e-5 (fp64
   1e-12) of the single-card factor on the same analysis, the single-card
   solve of every rank's factor below 1e-5 (fp64 1e-12), (d)'s minor on
   every rank the single-card factor's, the census one assembly sum, the
   tree gathers over the tree group's ranks and an L21 and a U gather a
   panel-sharded group, and K1 and K7 launched on every rank as often as
   its share of the plan predicts. On (b)'s rank 0, K1 at its largest
   tree share and K7 on its group with the most cells are held against
   their plain versions and timed (``potrf_trsm_mesh``,
   ``extend_add_mesh`` on the kernel line). It prints each run's steady
   factor (min of 3) beside the single card's, the first call, the sums
   by kind (bytes, seconds), launches and peaks, and a JSON line
   (``mesh``) before the kernel line. The main path also prints the
   TOTAL lines of ``roofline_report`` and ``solve_report`` beside the
   measured ``factor_s`` and ``solve_s``.
17. The coarse solve plan (``ladder_phase``, after step 13, on the main
   path's factor): the groups, pair classes and cells of the factor's
   plan and of the coarse solve plan that the solves take, with the
   ``solve_report`` TOTAL of each; the relayout of ``Lx`` into the coarse
   plan, its first and steady time, equal bit for bit on the card to
   ``relayout_map``'s gather and to the main path's copy; each sweep (w2,
   classic, inv) on the coarse plan and on the factor's own plan (which a
   solve takes where the copy does not fit in the card's free memory;
   here ``solve_ladder`` is held at "fine") at 1 and 64 right-hand sides:
   its first call, its steady wall (min of 3, all six in turns), its
   K3-K6 launches (K3 on classic, ``K3_GROUPS`` a sweep on the coarse
   plan; none on w2 and inv), the state built from the copy or from
   ``Lx``, residual below 1e-5 (columns 0 and 63 at 64), x within 1e-4 *
   max|x| of the main path's w2 x. Its JSON line (``ladder``) comes
   before the kernel line; it drops the factor plan's states at its end.
18. The solve routes (``route_phase``, after step 17, on the main path's
   factor): the w2 and inv sweeps at 1, 8 and 64 right-hand sides on the
   coarse plan, and w2 at 1 on the factor's own plan, each under the
   three pass-up routings of ``supernodal_solve.ROUTES`` (class-sorted,
   fused, the one the sweeps take: one placement a parent group, merged:
   one an RU_c bucket with one rhs gather a sweep), through the private
   ``supernodal_solve._mf_dispatch`` that ``solve_dispatch`` calls on
   ``ROUTE``: the routing's
   first call, the sweep's wall (min of 3 rounds, each round sorted,
   fused, merged, merged, fused, sorted) and, at nrhs 1, its device ops
   and busy time under the profiler (as ``prof.solve_profile`` counts
   them); x within 1e-5 * max|x| of the sorted route's x, residual below
   1e-5 (columns 0 and nrhs - 1). No kernel of K3-K7 runs in these
   sweeps but K5 and K6 where routed (none here). JSON line ``route``.
19. 256-wide tiles (``wide_tile_phase``, after step 18): the model
   problem's plan with ``tile_big=2048`` (``WIDE_GROUPS`` groups with R >=
   2048 get 256-wide manifests): its steps and tiles beside the default
   plan's on those groups; K2 at T = 256 on its largest manifest against
   its plain version (1e-6), two calls bit-equal, the two-piece form
   (K2b at T = 256) bit-equal to it, the kernel, plain and bound ms; both
   forms also off the plan (``K2_WIDE_OFF_PLAN``: an odd R whose F moves
   by 4-byte copies, and R % 4 == 0); then the factor through
   ``factorize_device(..., tile_big=2048)``: K2 at T = 256 once a wide
   group, ``Lx`` within 1e-6 * max|Lx| of the main path's factor,
   residual below 1e-5, its wall in turns with the default factor (min of
   3) and K2's device time a factor on both sides (the profiler). JSON
   line ``wide``; its K2 row joins the kernel line.

Every kernel count is set to 0 just before each path and read just after.
Any failure raises (exit code != 0). Without a CUDA device the script exits
with code 2 before doing anything. The last line is the device JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

K1_TOL = 1e-5
K2_TOL = 1e-6
K34_TOL = 1e-5
K567_TOL = 1e-5
K7_F64_TOL = 1e-12
RESID_TOL = 1e-5
REFINED_TOL = 1e-12
SEED = 0
SIZE = 50          # laplacian_3d(50): n = 125,000, the model problem
FOREST = (512, 6)  # 512 blocks of laplacian_3d(6): n = 110,592
NRHS = 64
NRHS_K = 8         # right-hand sides of the w2 kernel routes (K5, K6)
QR_LC = (6000, 2000)   # demos/bench_qr.py's local_coupling_ls(6000, 2000)
QR_GRID = 32           # grid_gradient_3d(32): 95,559 x 32,768
QR_SEED = 7
QR_NRHS = 4
QR_NE_TOL = {"float32": 1e-4, "float64": 1e-12}   # normal-equations residual
QR_LSTSQ_TOL = {"float32": 1e-4, "float64": 1e-10}  # x vs dense lstsq
QR_GRID_TOL = 1e-4     # grid x: fp32 against fp64
LU_NX = 30             # demos/bench_unsym.py's fem_unsym(30): n = 27,000
LU_TOL = 1e-10         # residual after the LU ladder
LU_ONE_TOL = {"float32": 1e-4, "float64": 1e-12}   # one factor + solve
LU_REPAIR = (60, 6)    # tests/test_mflu_unsym.py:96: n and seeds
LU_REPAIR_TOL = 1e-12
CPLX_K = 40            # the magnetic Laplacian of a 40^3 grid: n = 64,000
CPLX_SEED = 0          # (128,000 real unknowns embedded)
CPLX_TOL = {"float32": 1e-5, "float64": 1e-12}   # residual_norm
CPLX_GATE = 1e-4       # max|Hx - b| / max|b|, tests/test_complex_device.py:40
CPLX_X_TOL = 1e-4      # the fp32 x against the fp64 x
# upwind_unsym(30) rotated: n = 27,000 (54,000 real unknowns embedded); its
# embedded plan holds 2.284e9 front cells by the reference's estimate, past
# the reference's segmented switch at 2e9, and about 2 GB by the port's
CPLX_LU_NX = 30
CPLX_LU_SEED = 5
CPLX_LU_TOL = 1e-10    # residual after the LU ladder
CPLX_QR_LC = (6000, 2000)
CPLX_QR_GRID = 24      # grid_gradient_3d(24) rotated: about 80k x 27.6k real
CPLX_QR_SEED = 7
CPLX_QR_NE_TOL = 1e-4  # complex normal-equations residual
CPLX_QR_LSTSQ_TOL = 1e-4   # x vs dense lstsq at 6000 x 2000
SEG_MIN = 4            # segments each cell of segmented_phase must run in
SEG_SHARE = 8          # its budget: the one-piece estimate over this
SEG_LX_TOL = 1e-6      # segmented Lx against the one-piece Lx (fp32)
PX_X_TOL = 1e-4        # the reloaded factor's px solve against the w2 x
INV_X_TOL = 1e-4       # the inv sweep's x against the w2 and classic x
LADDER_X_TOL = 1e-4    # every sweep on each plan against the main w2 x
ROUTE_X_TOL = 1e-5     # each route's x against the sorted route's
ROUTE_TURNS = ("sorted", "fused", "merged", "merged", "fused", "sorted")
WIDE_BIG = 2048        # tile_big of the wide-tile factor (the reference's
#                        benched SSTPU_TILE_BIG)
WIDE_GROUPS = 11       # groups of the model plan with R >= WIDE_BIG: one
#                        K2 launch at T = 256 each a factor
WIDE_LX_TOL = 1e-6     # the wide-tile factor's Lx against the default's
# (B, R, classes) of K2 at T = 256 off the plan: an odd R over two tile
# rows whose F moves by 4-byte copies, a class wider than a tile; R % 4 ==
# 0 (16-byte F traffic, two words a lane) over three tile rows
K2_WIDE_OFF_PLAN = ((2, 301, ((3, 290), (2, 40))),
                    (1, 600, ((4, 300), (3, 100))))
BENCH_GATES = (1e-2, 1e-4)   # bench.py:122,144: residual, residual64
QR_RANK = (6000, 2000, (5, 7))  # local_coupling_ls(6000, 2000), column 7
#                                 made a copy of column 5 (F11)
QR_RANK_TOL = {"float32": 1e-5, "float64": 1e-10}   # vs the lstsq minimum
LU_SYM_TOL = {"float32": 1e-4, "float64": 1e-8}     # tests/test_mflu.py:37
LU_SYM_X_TOL = {"float32": 1e-4, "float64": 1e-10}  # x vs the host LU's
LU_SYM_HOST_NX = 16    # fem_unsym(16): x against the host mflusol's
DIST_LX_TOL = {"float32": 1e-5, "float64": 1e-12}     # vs the single card
DIST_RESID_TOL = {"float32": 1e-5, "float64": 1e-12}
DIST_NEG = -50.0       # the negative diagonal entry of dist run (d)
DIST_TIMEOUT_S = 300.0  # a rank's collectives fail after this
DIST_JOIN_S = 300.0     # a run whose ranks outlast this fails
K7_GROUP = (114, 224)   # (B, R) of the factor's slowest placement group
K7_CLASSES = ((75, 128), (15, 168), (59, 64))   # its (npairs, RU) classes
K7_F64_GROUP = 3912     # R of the fp64 factor's largest tile group
# (B, R, classes) of K2 and K2b off the plan, each class (npairs, RU_c) of
# random children: a manifest of under 10 tiles; R % 4 != 0 (4-byte F
# traffic); one front that takes 5 children, so its tiles have runs of 5
# steps
K2_OFF_PLAN = ((2, 200, ((3, 90),)), (3, 301, ((6, 120), (4, 60))),
               (1, 384, ((5, 200),)))
# (B, R, C) of K6 off the plan's ladders, at 1 and 3 right-hand sides: rows
# that are not 16-byte multiples (plain loads); few long panels
# (transposed: a cluster of 8 blocks a panel, a ring of stages); wide
# panels (forward: slices of each row, a ring, X read from device memory
# at NR 3; transposed: 24 column tiles)
K6_OFF_PLAN = ((37, 45, 13), (4, 6000, 52), (16, 16, 6000))
# (B, C, NR) of K4 off the plans: three rows a lane and 64 column chunks
# of 8 a tile, over 8 blocks; many tiny tiles, two a block, each with 3
# warps of one column; an odd width at NR 5, whose X moves by 4-byte loads
# and stores
K4_OFF_PLAN = ((37, 96, 508), (8735, 8, 3), (33, 45, 5))
# (B, K, N, NR) of K5 off the plan: N % 4 != 0 (4-byte loads) at NR 5; a
# tiny panel at NR 8; the smallest plan group's backward panel, W2 of
# (1, 2168, 504), at 1 and 8
K5_OFF_PLAN = ((2, 1001, 333, 5), (1, 40, 24, 8), (1, 2168, 504, 1),
               (1, 2168, 504, 8))
# (B, C, RU) of K1 off the plan: C = 1 (4-byte copies, the instance of 8);
# C = 96 (the rolled instance; its forced single part is staged in two
# chunks); an odd C > 32; C = 64 at an odd RU
K1_OFF_PLAN = ((5, 1, 3), (7, 96, 500), (2, 37, 101), (9, 64, 77))
# (B, C, RU, NR) of K3 off the plan: an odd C (L21 and the vectors by
# 4-byte copies) at NR 5; RU far above 720 (a part staged in several
# chunks, a cluster of 8 backward); no rows below (RU = 0, v is None)
K3_OFF_PLAN = ((3, 37, 101, 5), (1, 96, 4000, 64), (8, 8, 0, 1))
K3_GROUPS = 15     # groups of the n = 125k coarse solve plan that take K3,
#                    nrhs 1 and 64
L2_FLUSH_BYTES = 64 << 20   # more than the H100's 50 MB L2 cache
SPIN_CYCLES = 2_000_000  # about 1 ms of device spin before each timed call
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOP_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
FP64_FLOP_S = 34e12     # H100 SXM fp64 rate outside the tensor cores
SRC = "suitesparse_tpu_torch/kernels/csrc/"
BF16_ONE_TOL = 1e-1     # tests/test_supernodal.py:160-179: one solve with
BF16_REFINED_TOL = 1e-5  # bfloat16 updates, then two refinement steps
BF16_STEPS = 2



def _cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device milliseconds per call of fn(*setup()) (after one warm
    call), timed with CUDA events around each call. A spin kernel queued
    just before the start event keeps the device busy while the host
    enqueues the call, so a call whose host side takes less than the spin
    is timed without its launch overhead. Python's garbage collector is
    held off meanwhile: a host stall between the two events that outlasts
    the spin would be timed as device time."""
    import torch

    fn(*(setup() if setup else ()))
    total = 0.0
    gc.disable()
    try:
        for _ in range(reps):
            args = setup() if setup else ()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
    finally:
        gc.enable()
    return total / reps


def _best_s(fn, reps: int = 3) -> float:
    """Minimum seconds of reps calls (CUDA events, after a warm call)."""
    import torch

    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _bound(nbytes: float, flops: float,
           flop_s: float = FP32_FLOP_S) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel_err(got, ref) -> tuple[float, float]:
    """(max abs difference, that over the largest plain entry)."""
    d = (got - ref).abs().max().item()
    return d, d / ref.abs().max().item()


def _record(rec, name, shape, err, dabs, ms, plain_ms, nbytes, flops,
            library_ms=None, tol=K34_TOL, flop_s=FP32_FLOP_S):
    """Print one kernel measurement, check it against ``tol`` and fold it
    into ``rec[name]`` (largest errors; the first shape is the reported
    one)."""
    bound_ms, bound_by = _bound(nbytes, flops, flop_s)
    lib = "" if library_ms is None else \
        f" library_ms={library_ms:.4f} kernel/library={ms / library_ms:.2f}"
    print(f"{name} {shape} rel_err={err:.3e} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({bound_by}){lib}", flush=True)
    assert np.isfinite(err) and err <= tol, \
        f"{name} disagrees at {shape}: {err}"
    r = rec.setdefault(name, {"err": 0.0, "abs": 0.0})
    r["err"], r["abs"] = max(r["err"], err), max(r["abs"], dabs)
    if "ms" not in r:
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms, shape=shape)


def forest(k: int, nx: int):
    """k independent copies of laplacian_3d(nx) on the block diagonal: the
    many-subdomain systems (block Jacobi, domain decomposition) whose
    solve tree is a forest."""
    import suitesparse_tpu_torch as sstt

    A = sstt.fixtures.laplacian_3d(nx)
    n = A.ncol
    cols = np.repeat(np.arange(n), np.diff(A.indptr))
    return sstt.from_triplets(
        k * n, k * n, np.concatenate([A.indices + i * n for i in range(k)]),
        np.concatenate([cols + i * n for i in range(k)]), np.tile(A.data, k),
        sym=1)


def factor_kernels(dp, dpp, dev, rng):
    """K1, K2 and K2b against their plain versions on the model plan
    (``dpp``: the same plan with two-piece manifests)."""
    import torch

    from suitesparse_tpu_torch.kernels.extend_add_tiles import (
        extend_add_tiles, extend_add_tiles_plain, manifest_work,
        tile_geometry)
    from suitesparse_tpu_torch.kernels.potrf import (
        _launch, potrf_geometry, potrf_trsm, potrf_trsm_plain)
    from suitesparse_tpu_torch.kernels.potrf_sweep import (
        K1_GROUPS, library_route)
    from suitesparse_tpu_torch.kernels.potrf_sweep import \
        bound_ms as k1_bound_ms
    from suitesparse_tpu_torch.kernels.potrf_sweep import tiles as k1_tiles
    from suitesparse_tpu_torch.numeric.supernodal_device import \
        _use_potrf_kernel

    groups = [g for gl in dp.plan.groups for g in gl]
    plan_k1 = [(g.B, g.C, g.R - g.C) for g in groups
               if _use_potrf_kernel(torch.float32, g.B, g.C)]
    assert tuple(plan_k1) == K1_GROUPS, plan_k1
    print(f"K1 groups: {len(plan_k1)} of the plan's {len(groups)}",
          flush=True)
    k1_groups = sorted((g for g in groups
                        if _use_potrf_kernel(torch.float32, g.B, g.C)),
                       key=lambda g: g.B * g.R * g.C, reverse=True)[:3]
    k1 = {"err": 0.0, "abs": 0.0}
    shapes = [(g.B, g.C, g.R - g.C) for g in k1_groups] + list(K1_OFF_PLAN)
    for i, (B, C, RU) in enumerate(shapes):
        f11, f21 = k1_tiles(rng, B, C, RU, dev)
        L11, L21 = potrf_trsm(f11, f21)
        P11, P21 = potrf_trsm_plain(f11, f21)
        torch.cuda.synchronize()
        d11, err = _rel_err(L11, P11)
        if RU:
            d21, e21 = _rel_err(L21, P21)
            err, d11 = max(err, e21), max(d11, d21)
        assert np.isfinite(err) and err <= K1_TOL, \
            f"potrf_trsm disagrees at (B,C,RU)=({B},{C},{RU}): {err}"
        assert torch.equal(torch.triu(L11, 1), torch.zeros_like(L11))
        # a second call, and two forced splits of RU, give the same bits
        g = potrf_geometry(B, C, RU)
        runs = [(L11, L21)]
        for split in {1, max(RU, 1)}:
            G11 = torch.empty_like(f11)
            G21 = None if f21 is None else torch.empty_like(f21)
            _launch(f11, f21, G11, G21, potrf_geometry(B, C, RU, split=split))
            runs.append((G11, G21))
        runs.append(potrf_trsm(f11, f21))
        same = all(torch.equal(a, L11) and (RU == 0 or torch.equal(b, L21))
                   for a, b in runs[1:])
        assert same, f"potrf_trsm not bit-equal at ({B},{C},{RU})"
        k1["err"] = max(k1["err"], err)
        k1["abs"] = max(k1["abs"], d11)
        if i >= len(k1_groups):
            print(f"potrf_trsm off the plan (B,C,RU)=({B},{C},{RU}) "
                  f"rel_err={err:.3e} {g} bit-equal reruns and splits",
                  flush=True)
            continue
        ms = _cuda_ms(lambda: potrf_trsm(f11, f21), 10)
        plain_ms = _cuda_ms(lambda: potrf_trsm_plain(f11, f21), 2)
        library_ms = _cuda_ms(lambda: library_route(f11, f21), 10)
        Ll, Ll21 = library_route(f11, f21)
        lib_err = max(_rel_err(Ll, P11)[1],
                      _rel_err(Ll21, P21)[1] if RU else 0.0)
        assert lib_err <= K1_TOL, f"library route off: {lib_err}"
        bound_ms, bound_by = k1_bound_ms(B, C, RU)
        print(f"potrf_trsm (B,C,RU)=({B},{C},{RU}) rel_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) "
              f"library_ms={library_ms:.4f} kernel/library="
              f"{ms / library_ms:.2f} {g} bit-equal reruns and splits",
              flush=True)
        if i == 0:
            k1.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms)
    # packed tiles: one indefinite tile among its neighbours (4, 2 and 1 a
    # warp, and a block's tile) turns only itself non-finite
    for C, RU in ((8, 8), (16, 24), (32, 40), (48, 100)):
        f11, f21 = k1_tiles(rng, 11, C, RU, dev)
        f11[5] -= 4.0 * C * torch.eye(C, device=dev)
        L11, L21 = potrf_trsm(f11, f21)
        fin = torch.isfinite(L11).flatten(1).all(1) & \
            torch.isfinite(L21).flatten(1).all(1)
        assert fin.tolist() == [i != 5 for i in range(11)], (C, RU, fin)
    print("potrf_trsm: an indefinite tile turns only itself non-finite "
          "(C = 8, 16, 32, 48)", flush=True)

    # K2 on the largest one-piece manifest, K2b on the two-piece manifest of
    # the same group, same inputs; timed in turns (K2, K2b, K2b, K2)
    ti = max((i for i, g in enumerate(groups) if g._tile is not None),
             key=lambda i: groups[i]._tile.man.shape[0])
    tg = groups[ti]
    pg = [g for gl in dpp.plan.groups for g in gl][ti]
    tm, pm = tg._tile, pg._tile
    assert (pg.B, pg.R, pm.nslots, pm.RUp) == (tg.B, tg.R, tm.nslots, tm.RUp)
    assert tm.man.shape[1] == 10 and pm.man.shape[1] == 14
    F0 = torch.as_tensor(rng.standard_normal((tg.B, tg.R, tg.R),
                                             dtype=np.float32), device=dev)
    U = rng.standard_normal((max(tm.nslots, 1), tm.RUp, tm.RUp),
                            dtype=np.float32)
    upper = np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)
    U[(rng.random(U.shape, dtype=np.float32) < 0.05) & upper] = np.nan
    U = torch.as_tensor(U, device=dev)
    pieces = {"extend_add_tiles": tg, "extend_add_tiles_pair": pg}
    rec, args, out = {}, {}, {}
    for name, g in pieces.items():
        args[name] = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                           for a in (g._tile.man, g._tile.rowmap,
                                     g._tile.colmap, g._tile_runs))
        out[name] = extend_add_tiles(F0.clone(), U, *args[name])
        Fp = extend_add_tiles_plain(F0.clone(), U, *args[name][:3])
        torch.cuda.synchronize()
        d, e = _rel_err(out[name], Fp)
        assert np.isfinite(e) and e <= K2_TOL, f"{name} disagrees: {e}"
        bound_ms, bound_by = _bound(*manifest_work(g._tile, g._tile_runs,
                                                   g.R))
        rec[name] = {"err": e, "abs": d, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "plain_ms": _cuda_ms(
                         lambda F: extend_add_tiles_plain(
                             F, U, *args[name][:3]), 3,
                         setup=lambda: (F0.clone(),))}
    ms = {name: [] for name in pieces}
    for name in ("extend_add_tiles", "extend_add_tiles_pair",
                 "extend_add_tiles_pair", "extend_add_tiles"):
        ms[name].append(_cuda_ms(
            lambda F: extend_add_tiles(F, U, *args[name]), 10,
            setup=lambda: (F0.clone(),)))
    for name, g in pieces.items():
        r = rec[name]
        r["ms"] = sum(ms[name]) / len(ms[name])
        nruns = len(g._tile_runs) - 1
        geo = tile_geometry(nruns, g.R, g._tile.RUp, g._tile.rowmap.shape[1])
        print(f"{name} (B,R)=({g.B},{g.R}) steps={g._tile.man.shape[0]} "
              f"tiles={nruns} RUp={g._tile.RUp} {geo} "
              f"rel_err={r['err']:.3e} kernel_ms={r['ms']:.4f} "
              f"(in turns: {ms[name][0]:.4f}, {ms[name][1]:.4f}) "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    same = torch.equal(*out.values())
    print(f"two-piece result equals one-piece result bit for bit: {same}",
          flush=True)
    assert same, "the two-piece result differs from the one-piece result"
    for name in pieces:
        again = extend_add_tiles(F0.clone(), U, *args[name])
        assert torch.equal(again, out[name]), f"{name}: two calls differ"
    tile_off_plan(rec, dev, rng)
    return k1, rec["extend_add_tiles"], rec["extend_add_tiles_pair"]


def tile_off_plan(rec, dev, rng) -> None:
    """K2 and K2b on the K2_OFF_PLAN manifests: each within K2_TOL of the
    plain version, two calls bit-equal, the two forms bit-equal; errors
    folded into ``rec``."""
    import torch

    from suitesparse_tpu_torch.kernels.extend_add_tiles import (
        build_group_manifest, extend_add_tiles, extend_add_tiles_plain,
        run_ptr, synthetic_group, tile_geometry)

    shapes = []     # (tiles, R, longest run) of each one-piece manifest
    for B, R, classes in K2_OFF_PLAN:
        g = synthetic_group(rng, B, R, classes)
        tms = {name: build_group_manifest(g, ru_min_frac=0.0, npiece=npiece)
               for name, npiece in (("extend_add_tiles", 1),
                                    ("extend_add_tiles_pair", 2))}
        tm = tms["extend_add_tiles"]
        F0 = torch.as_tensor(rng.standard_normal((B, R, R), dtype=np.float32),
                             device=dev)
        U = rng.standard_normal((tm.nslots, tm.RUp, tm.RUp), dtype=np.float32)
        U[(rng.random(U.shape) < 0.05)
          & np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)] = np.nan
        U = torch.as_tensor(U, device=dev)
        out = {}
        for name, tm in tms.items():
            runs = run_ptr(tm.man)
            args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                         for a in (tm.man, tm.rowmap, tm.colmap, runs))
            got = [extend_add_tiles(F0.clone(), U, *args) for _ in range(2)]
            Fp = extend_add_tiles_plain(F0.clone(), U, *args[:3])
            torch.cuda.synchronize()
            d, e = _rel_err(got[0], Fp)
            assert np.isfinite(e) and e <= K2_TOL, \
                f"{name} disagrees off the plan at (B,R)=({B},{R}): {e}"
            assert torch.equal(*got), f"{name}: two calls differ at {R}"
            out[name] = got[0]
            r = rec[name]
            r["err"], r["abs"] = max(r["err"], e), max(r["abs"], d)
            geo = tile_geometry(len(runs) - 1, R, tm.RUp,
                                tm.rowmap.shape[1])
            print(f"{name} off plan (B,R)=({B},{R}) classes={classes} "
                  f"steps={tm.man.shape[0]} tiles={len(runs) - 1} "
                  f"longest_run={int(np.diff(runs).max())} RUp={tm.RUp} "
                  f"{geo} rel_err={e:.3e} two calls bit-equal", flush=True)
        assert torch.equal(*out.values()), \
            f"two-piece differs from one-piece off the plan at {R}"
        runs = run_ptr(tms["extend_add_tiles"].man)
        shapes.append((len(runs) - 1, R, int(np.diff(runs).max())))
    assert min(t for t, _, _ in shapes) < 10 and \
        any(R % 4 for _, R, _ in shapes) and \
        max(n for _, _, n in shapes) >= 4, shapes


def _tri_tiles(rng, B, C, dev):
    """B well-conditioned lower tiles: diagonal in [1, 2], off-diagonal
    entries below 1/C."""
    import torch

    L = np.tril(rng.uniform(-1.0, 1.0, (B, C, C)) / C, -1)
    L += np.eye(C) * rng.uniform(1.0, 2.0, (B, 1, C))
    return torch.as_tensor(L.astype(np.float32), device=dev)


def _k3_rows(rec, r, B, C, RU, nrs, where, dev):
    """K3 both ways against the plain versions and the library route,
    two calls bit-equal, NaN above L11's diagonal (K3 reads its lower
    triangle only; the plain versions and the library take a copy
    without it); L21 and the (B, RU, NR) vectors as the sweep passes
    them, views into a packed (B, R, C) panel and a (B, R, NR)
    buffer."""
    import torch

    from suitesparse_tpu_torch.kernels.solve_step import (
        solve_step_bwd, solve_step_bwd_plain, solve_step_fwd,
        solve_step_fwd_plain, solve_step_geometry)
    from suitesparse_tpu_torch.kernels.step_sweep import (library_bwd,
                                                          library_fwd)

    R = C + RU
    P = torch.empty(B, R, C, device=dev)
    L11 = _tri_tiles(r, B, C, dev)
    P[:, C:] = torch.as_tensor(r.uniform(-1.0, 1.0, (B, RU, C))
                               .astype(np.float32) / C, device=dev)
    L21 = P[:, C:]
    Ln = L11.clone()
    iu = torch.triu_indices(C, C, 1, device=dev)
    Ln[:, iu[0], iu[1]] = float("nan")
    for nr in nrs:
        Y = torch.as_tensor(r.standard_normal((B, C, nr),
                                              dtype=np.float32),
                            device=dev)
        W = torch.as_tensor(r.standard_normal((B, R, nr),
                                              dtype=np.float32),
                            device=dev)
        WB = W[:, C:]
        shape = f"(B,C,RU,NR)=({B},{C},{RU},{nr}) {where}"
        # L11's lower triangle and L21, read once
        io = 4.0 * B * (C * (C + 1) / 2 + RU * C)
        flops = float(B * nr * (C * C + 2 * RU * C))
        for name in ("solve_step_fwd", "solve_step_bwd"):
            tr = name == "solve_step_bwd"
            g = solve_step_geometry(B, C, RU, nr, tr)
            plan = " ".join(f"{k}={v}" for k, v in g._asdict().items())
            kern = solve_step_bwd if tr else solve_step_fwd
            plain = solve_step_bwd_plain if tr else solve_step_fwd_plain
            lib = library_bwd if tr else library_fwd
            out = kern(Ln, L21, Y, WB)
            out2 = kern(Ln, L21, Y, WB)
            ref = plain(L11, L21, Y, WB)
            if not tr:
                out, out2, ref = [o for o in out if o is not None], \
                    [o for o in out2 if o is not None], \
                    [o for o in ref if o is not None]
            else:
                out, out2, ref = [out], [out2], [ref]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, out2)), \
                f"two {name} calls differ at {shape}"
            errs = [_rel_err(a, b) for a, b in zip(out, ref)]
            d, e = max(x[0] for x in errs), max(x[1] for x in errs)
            lib_ms = None
            if RU:
                lo = lib(L11, L21, Y, WB)
                lo = list(lo) if not tr else [lo]
                torch.cuda.synchronize()
                e_lib = max(_rel_err(a, b)[1] for a, b in zip(lo, ref))
                assert e_lib <= K34_TOL, \
                    f"K3's library route disagrees: {e_lib}"
                lib_ms = _cuda_ms(lambda: lib(L11, L21, Y, WB), 10)
            # bytes: the panel, y, wb or xb read; xc and v written
            nbytes = io + (8.0 * (B * C * nr + B * RU * nr) if not tr
                           else 4.0 * (2 * B * C * nr + B * RU * nr))
            _record(rec, name, f"{shape} plan: {plan}", e, d,
                    _cuda_ms(lambda: kern(Ln, L21, Y, WB), 10),
                    _cuda_ms(lambda: plain(L11, L21, Y, WB), 2),
                    nbytes, flops, library_ms=lib_ms)


def solve_kernels(splan, fplan, dev, rng):
    """K3 (forward, backward) and K4 against their plain versions at the
    shapes of the model problem's and the forest's coarse solve plans
    (``splan``, ``fplan``: the plans their solves take). Returns the
    records and K4's device ms by (B, C, NR, transpose)."""
    import torch

    from suitesparse_tpu_torch.kernels.trisolve import (
        batched_trisolve, batched_trisolve_plain)
    from suitesparse_tpu_torch.numeric.supernodal_solve import classic_route

    rec: dict = {}
    groups = [g for gl in splan.groups for g in gl]
    taken = {nr: [g for g in groups if classic_route(
        torch.float32, g.B, g.C, g.R - g.C, nr) == "solve_step"]
        for nr in (1, NRHS)}
    print(f"K3 groups of the model solve plan: {len(taken[1])} at nrhs 1, "
          f"{len(taken[NRHS])} at nrhs {NRHS}", flush=True)
    assert len(taken[1]) == len(taken[NRHS]) == K3_GROUPS, \
        {nr: len(g) for nr, g in taken.items()}
    k3 = sorted(taken[1], key=lambda g: g.B * g.R * g.C, reverse=True)[:4]

    for g in k3:
        _k3_rows(rec, rng, g.B, g.C, g.R - g.C, (1, NRHS), "plan", dev)
    # the off-plan shapes draw from a stream of their own, so that the
    # inputs of the later phases stay as they were
    off3 = np.random.default_rng(SEED + 3)
    for B, C, RU, nr in K3_OFF_PLAN:
        _k3_rows(rec, off3, B, C, RU, (nr,), "off-plan", dev)

    root = [g for gl in fplan.groups for g in gl
            if classic_route(torch.float32, g.B, g.C, g.R - g.C, 1)
            == "trisolve"]
    assert [(g.B, g.C) for g in root] == [(FOREST[0], 64)], root
    k4_ms = {}

    def k4_row(L, Y, transpose):
        B, C, nr = Y.shape
        X = batched_trisolve(L, Y, transpose)
        PX = batched_trisolve_plain(L, Y, transpose)
        torch.cuda.synchronize()
        d, e = _rel_err(X, PX)
        A_ = L.mT if transpose else L
        ms = k4_ms[B, C, nr, transpose] = _cuda_ms(
            lambda: batched_trisolve(L, Y, transpose), 10)
        _record(
            rec, "batched_trisolve",
            f"(B,C,NR)=({B},{C},{nr}) transpose={transpose}", e, d, ms,
            _cuda_ms(lambda: batched_trisolve_plain(L, Y, transpose), 2),
            4.0 * B * (C * (C + 1) / 2 + 2 * C * nr), float(B * nr * C * C),
            library_ms=_cuda_ms(lambda: torch.linalg.solve_triangular(
                A_, Y, upper=transpose), 10))

    def k4_tiles(r, B, C):
        L = _tri_tiles(r, B, C, dev)
        iu = torch.triu_indices(C, C, 1, device=dev)
        L[:, iu[0], iu[1]] = float("nan")   # K4 reads the lower triangle
        return L

    def randn(r, *shape):
        return torch.as_tensor(r.standard_normal(shape, dtype=np.float32),
                               device=dev)

    for B, C in ((FOREST[0], 64), (45, 48)):
        L = k4_tiles(rng, B, C)
        for nr in (1, NRHS):
            Y = randn(rng, B, C, nr)
            for transpose in (False, True):
                k4_row(L, Y, transpose)
    # the off-plan shapes draw from a stream of their own, so that the
    # inputs of the later phases stay as they were
    off_rng = np.random.default_rng(SEED + 4)
    for B, C, nr in K4_OFF_PLAN:
        L, Y = k4_tiles(off_rng, B, C), randn(off_rng, B, C, nr)
        for transpose in (False, True):
            k4_row(L, Y, transpose)
    return rec, k4_ms


def w2_kernels(splan, dev, rng):
    """K5 and K6 against their plain versions at the four largest groups
    (B * R * C) that the w2 kernel routes send to each in the model
    problem's coarse solve plan ``splan``,
    with the L2 cache flushed before every timed call. K5 also off the plan
    (``K5_OFF_PLAN``), every K5 row called twice for a bit-equal Z, its
    launch plan printed with it."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels.bmatvec import bmatvec, bmatvec_plain
    from suitesparse_tpu_torch.kernels.pmatvec import (
        pmatvec_t, pmatvec_t_plain, pmv_geometry)
    from suitesparse_tpu_torch.numeric.supernodal_solve import w2_route

    cfg = sstt.DEFAULT.replace(solve_pmv=True, solve_bmv=True)
    groups = [g for gl in splan.groups for g in gl]
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)

    def cold():
        flush.zero_()
        return ()

    def top(route):
        gs = sorted((g for g in groups
                     if w2_route(g.B, g.R, g.C, 1, cfg) == route),
                    key=lambda g: g.B * g.R * g.C, reverse=True)[:4]
        assert len(gs) == 4, f"fewer than four groups on the {route} route"
        return gs

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=dev)

    rec: dict = {}

    def k5_row(M, X, orient):
        B, K, N = M.shape
        nr = X.shape[2]
        Z, P = pmatvec_t(M, X), pmatvec_t_plain(M, X)
        Z2 = pmatvec_t(M, X)
        torch.cuda.synchronize()
        assert torch.equal(Z, Z2), \
            f"two K5 calls differ at (B,K,N,NR)=({B},{K},{N},{nr})"
        d, e = _rel_err(Z, P)
        plan = " ".join(f"{k}={v}" for k, v in
                        pmv_geometry(B, K, N, nr)._asdict().items())
        _record(
            rec, "pmatvec_t",
            f"(B,K,N,NR)=({B},{K},{N},{nr}) M={orient} plan: {plan}", e, d,
            _cuda_ms(lambda: pmatvec_t(M, X), 10, cold),
            _cuda_ms(lambda: pmatvec_t_plain(M, X), 2, cold),
            4.0 * B * (K * N + K * nr + N * nr), 2.0 * B * K * N * nr,
            library_ms=_cuda_ms(lambda: torch.bmm(M.mT, X), 10, cold),
            tol=K567_TOL)

    for g in top("pmv"):
        W2 = randn(g.B, g.R, g.C)
        for M, orient in ((W2.mT.contiguous(), "W2^T"), (W2, "W2")):
            for nr in (1, NRHS_K):
                k5_row(M, randn(M.shape[0], M.shape[1], nr), orient)
    # the off-plan shapes draw from a stream of their own, so that the
    # inputs of the later phases stay as they were
    off_rng = np.random.default_rng(SEED + 5)
    for B, K, N, nr in K5_OFF_PLAN:
        M = torch.as_tensor(off_rng.standard_normal((B, K, N),
                                                    dtype=np.float32),
                            device=dev)
        X = torch.as_tensor(off_rng.standard_normal((B, K, nr),
                                                    dtype=np.float32),
                            device=dev)
        k5_row(M, X, "off-plan")
    k6 = [((g.B, g.R, g.C), (1, NRHS_K)) for g in top("bmv")] + \
        [(shape, (1, 3)) for shape in K6_OFF_PLAN]
    for (B, R, C), nrs in k6:
        W2 = randn(B, R, C)
        for transpose in (False, True):
            K, N = (R, C) if transpose else (C, R)
            Mk = W2.mT if transpose else W2
            for nr in nrs:
                X = randn(B, K, nr)
                Z = bmatvec(W2, X, transpose)
                P = bmatvec_plain(W2, X, transpose)
                torch.cuda.synchronize()
                d, e = _rel_err(Z, P)
                _record(
                    rec, "bmatvec_t" if transpose else "bmatvec",
                    f"(B,R,C,NR)=({B},{R},{C},{nr}) transpose={transpose}",
                    e, d,
                    _cuda_ms(lambda: bmatvec(W2, X, transpose), 10, cold),
                    _cuda_ms(lambda: bmatvec_plain(W2, X, transpose), 2,
                             cold),
                    4.0 * B * (R * C + K * nr + N * nr),
                    2.0 * B * R * C * nr,
                    library_ms=_cuda_ms(lambda: torch.bmm(Mk, X), 10, cold),
                    tol=K567_TOL)
    return rec


def _k7_group_row(rec, name, g, work, dp, dev, rng, dtype, tol, label,
                  skip=(), udtype=None):
    """K7's group form (one launch for all classes of ``work``, the
    factor's call: the classes of ``g`` outside ``skip``) against its plain
    version, two calls bit-equal and equal bit for bit to the same kernel
    launched one class at a time; timed beside the plain version and the
    library scatter, class by class (``extend_add_library``, one call a
    class). ``udtype`` (bfloat16): the children in that dtype, the result
    also equal bit for bit to the ``dtype`` instance on the children
    widened, the bound's child cells at its itemsize."""
    import torch

    from suitesparse_tpu_torch.kernels.extend_add import (
        _INSTANCES, build_work, class_maps, extend_add, extend_add_group,
        extend_add_group_plain, extend_add_library, group_work)
    from suitesparse_tpu_torch.numeric.supernodal_device import k7_classes

    B, R = g.B, g.R
    udtype = dtype if udtype is None else udtype
    Us = []
    for key, (RU, *_rest) in zip(work.keys, work.meta):
        B_c = dp.plan.groups[key[0]][key[1]].B
        Us.append(torch.as_tensor(rng.standard_normal((B_c, RU, RU)),
                                  device=dev).to(udtype))
    F0 = torch.as_tensor(rng.standard_normal((B, R, R)), device=dev).to(dtype)
    maps = [class_maps(work, c) for c in range(len(Us))]
    counter = _INSTANCES[dtype, udtype][1]
    before = getattr(extend_add, counter)
    Fk = extend_add_group(F0.clone(), Us, work)
    assert getattr(extend_add, counter) == before + len(work.parts)
    Fk2 = extend_add_group(F0.clone(), Us, work)
    Fc = F0.clone()
    for U, (idx, dst, src) in zip(Us, maps):
        extend_add(Fc, U, idx, dst, src)
    Fs = extend_add_group(F0.clone(), [U.to(dtype) for U in Us], work)
    Fp = extend_add_group_plain(F0.clone(), Us, work)
    Fl = torch.cat([F0.reshape(-1), F0.new_zeros(1)])
    for U, (idx, dst, src) in zip(Us, maps):
        extend_add_library(Fl, U, idx, dst, R, src)
    torch.cuda.synchronize()
    assert torch.equal(Fk, Fk2), f"{name} {label}: two calls differ"
    assert torch.equal(Fk, Fc), \
        f"{name} {label}: the group form differs from one launch a class"
    assert torch.equal(Fk, Fs), \
        f"{name} {label}: differs from the {dtype} instance on the widened U"
    d, e = _rel_err(Fk, Fp)
    e_lib = _rel_err(Fl[:-1].view(B, R, R), Fp)[1]
    assert e_lib <= tol, f"library disagrees with plain: {e_lib}"
    itemsize = F0.element_size()
    classes = k7_classes(g, skip)
    assert len(work.keys) == len(classes)
    nbytes, adds = group_work(build_work(B, R, classes), itemsize,
                              Us[0].element_size())

    def library(F):
        for U, (idx, dst, src) in zip(Us, maps):
            extend_add_library(F, U, idx, dst, R, src)

    _record(
        rec, name,
        f"{label} (B,R)=({B},{R}) classes={len(Us)} "
        f"RU_c={sorted({int(m[0]) for m in work.meta})} band={work.geom.rows} "
        f"blocks={sum(p[2].numel() for p in work.parts)} cells={adds:.0f} "
        f"U {str(udtype)[6:]}, group form, two calls bit-equal, equal to one "
        f"launch a class and to the {str(dtype)[6:]} instance on U widened",
        e, d,
        _cuda_ms(lambda F: extend_add_group(F, Us, work), 10,
                 setup=lambda: (F0.clone(),)),
        _cuda_ms(lambda F: extend_add_group_plain(F, Us, work), 3,
                 setup=lambda: (F0.clone(),)),
        nbytes, adds,
        library_ms=_cuda_ms(library, 3, setup=lambda: (Fl.clone(),)),
        tol=tol, flop_s=FP64_FLOP_S if itemsize == 8 else FP32_FLOP_S)


def extend_add_kernel(dp, dev, rng):
    """K7 in the group form the factor launches (``extend_add_group``, one
    launch a group) on the K7_GROUP group's work list, fp32 and fp64, and
    on the fp64 factor's largest tile group (``K7_F64_GROUP``); then the
    one-class form on the K7_CLASSES pair classes of K7_GROUP, with their
    real row maps and destinations: in the factor's form (each pair reads
    its child out of the source group's whole update block through
    ``src``), fp32 and fp64, two calls bit-equal; then padded by
    ``pad_pairs`` with the children gathered, as the reference's kernel
    takes them. The library call is ``extend_add_library`` (one
    ``index_put_(accumulate=True)`` a class) on the same inputs; beside the
    padded form it is not timed again."""
    import torch

    from suitesparse_tpu_torch.kernels.extend_add import (
        class_work, extend_add, extend_add_library, extend_add_plain,
        pad_pairs)

    walk = [(g, ix) for gl, il in zip(dp.plan.groups, dp.groups)
            for g, ix in zip(gl, il)]
    ((g, ix),) = [(g, ix) for g, ix in walk if (g.B, g.R) == K7_GROUP]
    g64, ix64 = max(((g, ix) for g, ix in walk if g._tile is not None),
                    key=lambda gi: gi[0].R)
    assert g64.R == K7_F64_GROUP, (g64.B, g64.R)
    rec: dict = {}
    for name, dtype, tol in (("extend_add", torch.float32, K567_TOL),
                             ("extend_add_f64", torch.float64, K7_F64_TOL)):
        _k7_group_row(rec, name, g, ix.k7, dp, dev, rng, dtype, tol,
                      "factor group")
    _k7_group_row(rec, "extend_add_f64", g64, ix64.k7_all, dp, dev, rng,
                  torch.float64, K7_F64_TOL,
                  "fp64 factor's largest tile group")
    B, R = g.B, g.R
    shapes = [(pc.npairs, pc.RU_c) for pc in g.pairs]
    for ci in [shapes.index(c) for c in K7_CLASSES]:
        pc = g.pairs[ci]
        src, dst, idx = g._pair_arrays[ci]
        npairs, RU = idx.shape
        B_c = dp.plan.groups[pc.src_level][pc.src_gi].B
        it, dt, st = (torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                      device=dev) for a in (idx, dst, src))
        for name, dtype, tol in (("extend_add", torch.float32, K567_TOL),
                                 ("extend_add_f64", torch.float64,
                                  K7_F64_TOL)):
            F0 = torch.as_tensor(rng.standard_normal((B, R, R)),
                                 device=dev).to(dtype)
            U = torch.as_tensor(rng.standard_normal((B_c, RU, RU)),
                                device=dev).to(dtype)
            Fk = extend_add(F0.clone(), U, it, dt, st)
            Fk2 = extend_add(F0.clone(), U, it, dt, st)
            Fp = extend_add_plain(F0.clone(), U, it, dt, st)
            Fl = torch.cat([F0.reshape(-1), F0.new_zeros(1)])
            extend_add_library(Fl, U, it, dt, R, st)
            torch.cuda.synchronize()
            assert torch.equal(Fk, Fk2), f"{name}: two calls differ"
            d, e = _rel_err(Fk, Fp)
            e_lib = _rel_err(Fl[:-1].view(B, R, R), Fp)[1]
            assert e_lib <= tol, f"library disagrees with plain: {e_lib}"
            itemsize = F0.element_size()
            nbytes, adds = class_work(R, idx, dst, itemsize, src)
            _record(
                rec, name,
                f"one class (B,R)=({B},{R}) (np,RU)=({npairs},{RU}) "
                f"B_c={B_c} src form, two calls bit-equal",
                e, d,
                _cuda_ms(lambda F: extend_add(F, U, it, dt, st), 10,
                         setup=lambda: (F0.clone(),)),
                _cuda_ms(lambda F: extend_add_plain(F, U, it, dt, st), 3,
                         setup=lambda: (F0.clone(),)),
                nbytes, adds,
                library_ms=_cuda_ms(
                    lambda F: extend_add_library(F, U, it, dt, R, st), 10,
                    setup=lambda: (Fl.clone(),)),
                tol=tol, flop_s=FP64_FLOP_S if itemsize == 8 else FP32_FLOP_S)
        # the padded form: children gathered in dst order, a dummy pair for
        # every slot without one
        dstf, idxf, order = pad_pairs(B, dst, idx)
        child = np.zeros((dstf.size, RU, RU), np.float32)
        child[order >= 0] = rng.standard_normal((npairs, RU, RU),
                                                dtype=np.float32)[
                                                    order[order >= 0]]
        F0 = torch.as_tensor(rng.standard_normal((B, R, R), dtype=np.float32),
                             device=dev)
        ch = torch.as_tensor(child, device=dev)
        it = torch.as_tensor(np.ascontiguousarray(idxf, np.int32), device=dev)
        dt = torch.as_tensor(np.ascontiguousarray(dstf, np.int32), device=dev)
        Fk = extend_add(F0.clone(), ch, it, dt)
        Fp = extend_add_plain(F0.clone(), ch, it, dt)
        torch.cuda.synchronize()
        d, e = _rel_err(Fk, Fp)
        _record(
            rec, "extend_add",
            f"one class (B,R)=({B},{R}) (np,RU)=({npairs},{RU}) padded "
            f"np={dstf.size}",
            e, d,
            _cuda_ms(lambda F: extend_add(F, ch, it, dt), 10,
                     setup=lambda: (F0.clone(),)),
            _cuda_ms(lambda F: extend_add_plain(F, ch, it, dt), 3,
                     setup=lambda: (F0.clone(),)),
            *class_work(R, idxf, dstf), tol=K567_TOL)
    return rec


def k7_launches(dp, dtype: str) -> int:
    """K7 launches of one factor on ``dp``: one a part of each group's work
    list (fp32: the classes no manifest folds; fp64: all), one a group
    with K7 classes on these plans."""
    attr = "k7" if dtype == "float32" else "k7_all"
    return sum(len(getattr(ix, attr).parts) for ix in dp.host
               if getattr(ix, attr) is not None)


def small_check(dev):
    """Card factor == CPU factor entry by entry, and the card solve matches
    the host simplicial (fp64) solve, on a problem small enough to check."""
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import (supernodal,
                                               supernodal_device,
                                               supernodal_solve)

    A = sstt.fixtures.laplacian_3d(12)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    S = supernodal.supernodal_symbolic(A, sstt.analyze(A, cfg), cfg)
    Fg = supernodal_device.factorize_device(A, S, cfg, dev, tile_rmin=32)
    Fc = supernodal_device.factorize_device(A, S, cfg, "cpu", tile_rmin=32)
    assert Fg.ok and Fc.ok
    lg, lc = Fg.Lx.cpu().numpy(), Fc.Lx.numpy()
    lx_err = np.abs(lg - lc).max() / np.abs(lc).max()
    assert lx_err <= 1e-5, f"card factor differs from CPU factor: {lx_err}"
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    x = supernodal_solve.solve_device(Fg, b, cfg)
    host = sstt.factorize(A, sstt.analyze(A, cfg), cfg.replace(
        factor_kind=sstt.FactorKind.SIMPLICIAL_LL), device="cpu")
    x_ref = sstt.solve(host, b)
    x_err = np.abs(x - x_ref).max() / np.abs(x_ref).max()
    assert x.shape == (n,) and x_err <= 1e-4, f"small solve off: {x_err}"
    # an indefinite matrix: the non-finite pivots must name the same minor
    Ai = sstt.fixtures.laplacian_3d(8, shift=-3.0)
    Si = supernodal.supernodal_symbolic(Ai, sstt.analyze(Ai, cfg), cfg)
    mg = supernodal_device.factorize_device(Ai, Si, cfg, dev).minor
    mc = supernodal_device.factorize_device(Ai, Si, cfg, "cpu").minor
    assert mg == mc < Ai.ncol, (mg, mc)
    print(f"small check n={n}: lx_rel_err={lx_err:.3e} "
          f"x_rel_err_vs_host={x_err:.3e} indefinite_minor={mg}", flush=True)


def replay_check(M, S, cfg, dev, calls: int = 1) -> dict:
    """``calls`` factors of ``M`` on the analysis ``S`` under ``cfg``, the
    last a replay of the key's captured group loop (a key's second factor
    captures, later ones replay): its factor bit-equal to the eager loop
    on the same values."""
    import torch

    from suitesparse_tpu_torch import stats
    from suitesparse_tpu_torch.device import fp32_precision
    from suitesparse_tpu_torch.numeric import supernodal_device as sd

    for _ in range(calls):
        before = stats.GLOBAL_STATS.counters.get("factor.graph.replay", 0)
        F = sd.factorize_device(M, S, cfg, dev)
    replays = stats.GLOBAL_STATS.counters.get("factor.graph.replay", 0) \
        - before
    dtype = sd.compute_dtype(cfg)
    Cdata = torch.as_tensor(sd._clow_data(M, S), device=dev).to(dtype)
    with fp32_precision(cfg.precision):
        eager = sd._run_plan(
            F.dplan.plan, enumerate(ix for il in F.dplan.groups for ix in il),
            Cdata, dtype, sd.update_dtype(cfg, dtype))
    equal = bool(torch.equal(F.Lx, eager))
    assert replays == 1 and equal, (replays, equal)
    return {"replayed": replays, "bit_equal": equal}


def auto_fallback(F) -> None:
    """solve_mode="auto" on a card factor with no W2 built yet: w2 with the
    card's real free memory, classic once the free memory reported by
    ``torch.cuda.mem_get_info`` leaves no room for the coarse plan's W2 and
    the factor's copy relaid into it (the capacity gate's own arithmetic,
    PyTorch's cached blocks included, less the free blocks of live graphs'
    pools); the coarse plan either way."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.device import free_bytes
    from suitesparse_tpu_torch.numeric import supernodal_solve

    dev_F = F.F if isinstance(F, sstt.SupernodalFactorAdapter) else F
    assert not dev_F._solve, "the factor already holds a solve state"
    assert supernodal_solve.solve_mode(dev_F, sstt.DEFAULT) == "w2"
    torch.cuda.empty_cache()
    need = supernodal_solve._w2_need(
        supernodal_solve._coarse_plan(dev_F.S), torch.float32,
        sstt.DEFAULT) + supernodal_solve._coarse_need(dev_F)
    real = torch.cuda.mem_get_info
    cached = free_bytes(dev_F.Lx.device) - real(dev_F.Lx.device)[0]
    short = max(need - 1 - cached, 0)     # one byte short of W2's room
    torch.cuda.mem_get_info = lambda device=None: (short, real(device)[1])
    try:
        mode = supernodal_solve.solve_mode(dev_F, sstt.DEFAULT)
        ladder = supernodal_solve.solve_ladder(dev_F)
    finally:
        torch.cuda.mem_get_info = real
    assert cached < need and mode == "classic" and ladder == "coarse", \
        (cached, need, mode, ladder)
    print(f"auto solve_mode: w2 with the card's free memory, classic with "
          f"{short} B free and {cached} B cached (W2 and the copy need "
          f"{need} B)", flush=True)


def _counters() -> dict:
    """kernel -> (wrapper, attribute holding its launch count): every
    kernel module's ``COUNTERS``."""
    import importlib

    return {name: c for mod in ("potrf", "extend_add_tiles", "solve_step",
                                "trisolve", "pmatvec", "bmatvec",
                                "extend_add")
            for name, c in importlib.import_module(
                f"suitesparse_tpu_torch.kernels.{mod}").COUNTERS.items()}


def zero_counts() -> None:
    for w, attr in _counters().values():
        setattr(w, attr, 0)


def counts() -> dict:
    return {k: getattr(w, attr) for k, (w, attr) in _counters().items()}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def _normal_residual(A, x, b) -> float:
    """max|A'r| / (max|A| max|r|), r = b - Ax (``demos/bench_qr.py``'s
    least-squares optimality measure), the worst column of a block."""
    r = b - A.matvec(x)
    atr = np.abs(A.rmatvec(r)).max(axis=0)
    return float((atr / (np.abs(A.data).max()
                         * np.maximum(np.abs(r).max(axis=0), 1e-30))).max())


def qr_phase() -> dict:
    """The multifrontal QR through ``qrsol`` on ``local_coupling_ls(6000,
    2000)`` and ``grid_gradient_3d(32)``, fp32 and fp64 at nrhs 1 (b from
    seed 7), and the grid at nrhs 4 in fp32. Each call must take the device
    route (the count of device factors goes up; a device failure raises)
    and pass its gates: the normal-equations residual (1e-4 fp32, 1e-12 fp64), x
    against a dense ``np.linalg.lstsq`` at 6000 x 2000 (1e-4 and 1e-10 of
    max|x|), and the grid's fp32 x against its fp64 x (1e-4). Times: the
    first ``qrsol`` of each problem (analysis, plan, factor, solve), the
    analysis and the plan alone, the minimum of 3 pattern-cached ``qrsol``
    calls (CUDA events, garbage collector held off), and the factor and
    the solve apart."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import mfqr_device as md
    from suitesparse_tpu_torch.numeric import multifrontal_qr as mq

    dev = torch.device("cuda", 0)
    problems = {"lc": sstt.fixtures.local_coupling_ls(*QR_LC),
                "grid": sstt.fixtures.grid_gradient_3d(QR_GRID)}
    out, xs = {}, {}
    gc.disable()
    try:
        for name, A in problems.items():
            b = np.random.default_rng(QR_SEED).standard_normal(A.nrow)
            cases = [("float32", b), ("float64", b)]
            if name == "grid":
                cases.append(("float32", np.random.default_rng(
                    QR_SEED).standard_normal((A.nrow, QR_NRHS))))
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for dtype, rhs in cases:
                nrhs = 1 if rhs.ndim == 1 else rhs.shape[1]
                key = f"{name}{'' if dtype == 'float32' else '64'}" + \
                    ("" if nrhs == 1 else f"_nrhs{nrhs}")
                cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
                calls = md.device_factors
                t0 = time.perf_counter()
                x = sstt.qrsol(A, rhs, cfg)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                assert md.device_factors == calls + 1, md.device_factors
                assert x.shape == (A.ncol,) + rhs.shape[1:] and \
                    np.isfinite(x).all()
                ne = _normal_residual(A, x, rhs)
                assert ne < QR_NE_TOL[dtype], (key, ne)
                xs[key] = x
                SQ = md._SQ_CACHE[md._analysis_key(A, cfg)]
                flops = md.householder_flops(SQ, nrhs)
                qr_s = _best_s(lambda: sstt.qrsol(A, rhs, cfg))
                F = md.factorize_qr_device(A, SQ, rhs, cfg, dev)
                factor_s = _best_s(
                    lambda: md.factorize_qr_device(A, SQ, rhs, cfg, dev))
                solve_s = _best_s(lambda: md.qr_solve_device(F))
                del F
                rec = {"qr_first_s": first_s, "qr_s": qr_s,
                       "factor_s": factor_s, "solve_s": solve_s,
                       "flops": flops, "gflops": flops / qr_s / 1e9,
                       "factor_gflops": flops / factor_s / 1e9,
                       "normal_residual": ne,
                       "groups": sum(len(gl) for gl in
                                     SQ._torch_qr[1].plan.groups)}
                if name == "lc" and nrhs == 1:
                    D = A.to_dense()
                    x_ref = np.linalg.lstsq(D, rhs, rcond=None)[0]
                    err = np.abs(x - x_ref).max() / np.abs(x_ref).max()
                    assert err < QR_LSTSQ_TOL[dtype], (key, err)
                    rec["lstsq_err"] = err
                out[key] = rec
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            # the analysis and the plan alone, on a fresh analysis
            t0 = time.perf_counter()
            SQ2 = mq.analyze_mfqr(A, sstt.DEFAULT)
            analyze_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            plan = md.device_plan(SQ2, A.permuted(None, SQ2.q), 1, dev).plan
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            for key in [k for k in out if k.startswith(name)]:
                out[key].update(analyze_s=analyze_s, plan_s=plan_s,
                                peak_mem_gb=peak)
            groups = [g for gl in plan.groups for g in gl]
            print(f"qr {name}: {A.nrow} x {A.ncol}, nnz {A.nnz}, "
                  f"supernodes {SQ2.S.nsuper}, levels {len(plan.groups)}, "
                  f"groups {len(groups)}, pair classes "
                  f"{sum(len(g.pairs) for g in groups)}, front cells "
                  f"{sum(g.B * g.M * g.N for g in groups)}, panel cells "
                  f"{plan.pool_size - plan.pool_data}, largest front "
                  f"{int(SQ2.front_m.max())} x "
                  f"{max(len(r) for r in SQ2.S.rows)}, "
                  f"analyze_s={analyze_s:.3f} plan_s={plan_s:.3f} "
                  f"peak_mem_gb={peak:.3f}", flush=True)
            del SQ2, plan
            for key in [k for k in out if k.startswith(name)]:
                r = out[key]
                print(f"qr {key}: first {r['qr_first_s']:.4f} s, qrsol "
                      f"{r['qr_s']:.4f} s (factor {r['factor_s']:.4f}, "
                      f"solve {r['solve_s']:.4f}), "
                      f"{r['flops'] / 1e9:.6g} GFLOP, {r['gflops']:.2f} "
                      f"GFLOP/s ({r['factor_gflops']:.2f} in the factor), "
                      f"normal residual {r['normal_residual']:.3e}"
                      + (f", x vs lstsq {r['lstsq_err']:.3e}"
                         if "lstsq_err" in r else ""), flush=True)
    finally:
        gc.enable()
    grid_err = np.abs(xs["grid"] - xs["grid64"]).max() / \
        np.abs(xs["grid64"]).max()
    assert grid_err < QR_GRID_TOL, grid_err
    out["grid"]["fp32_vs_fp64"] = grid_err
    print(f"qr grid: fp32 x vs fp64 x {grid_err:.3e}; device factors "
          f"{md.device_factors}", flush=True)
    out["rank"] = qr_rank_check()
    return out


def qr_rank_check() -> dict:
    """F11: the device QR of ``local_coupling_ls(6000, 2000)`` with column
    7 a copy of column 5. The factor must report the host ``qr_host``'s
    rank estimate; ``qrsol`` must take the device route, give exactly
    zero x at one of the two columns and the least-squares minimum of the
    residual (dense ``lstsq``) within ``QR_RANK_TOL``, and an x no larger
    than 10 times the host QR's; the host's residual is printed beside it
    (its basic x drops the dead pivot's row of R)."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import mfqr_device as md
    from suitesparse_tpu_torch.numeric import qr as hqr

    m, n, (j0, j1) = QR_RANK
    A0 = sstt.fixtures.local_coupling_ls(m, n)
    D = A0.to_dense()
    D[:, j1] = D[:, j0]
    r, c = np.nonzero(D)
    A = sstt.from_triplets(m, n, r, c, D[r, c])
    b = np.random.default_rng(QR_SEED).standard_normal(m)
    Fh = hqr.qr_host(A, hqr.symbolic_qr(A, sstt.DEFAULT))
    xh = hqr.qr_solve(Fh, b)
    x_min = np.linalg.lstsq(D, b, rcond=None)[0]
    rmin = np.linalg.norm(D @ x_min - b)
    rh = np.linalg.norm(D @ xh - b)
    out = {"host_rank": Fh.rank_est, "host_resid_rel": rh / rmin - 1}
    for dtype in ("float32", "float64"):
        cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
        SQ = md.analyze_mfqr(A, cfg)
        F = md.factorize_qr_device(A, SQ, b, cfg, "cuda")
        assert F.ok and F.rank_est == Fh.rank_est == n - 1, \
            (dtype, F.rank_est, Fh.rank_est)
        dead = md.dead_columns(F)
        calls = md.device_factors
        x = sstt.qrsol(A, b, cfg)
        torch.cuda.synchronize()
        assert md.device_factors == calls + 2, md.device_factors
        assert np.isfinite(x).all() and (x[j0] == 0.0) != (x[j1] == 0.0) \
            and x[dead[0]] == 0.0, (dtype, x[j0], x[j1], dead)
        rx = np.linalg.norm(D @ x - b)
        rel = abs(rx / rmin - 1)
        assert rel <= QR_RANK_TOL[dtype], (dtype, rel)
        assert np.abs(x).max() <= 10 * np.abs(xh).max()
        out[dtype] = {"rank_est": F.rank_est, "tol": F.tol,
                      "dead": dead.tolist(), "resid_rel": rel,
                      "xmax_over_host": np.abs(x).max() / np.abs(xh).max()}
    print(f"qr rank (F11): {m} x {n} with column {j1} a copy of column "
          f"{j0}: rank {out['float64']['rank_est']} (host "
          f"{out['host_rank']}), dead columns {out['float64']['dead']}; "
          f"||Ax-b|| over the least-squares minimum - 1: device "
          f"{out['float32']['resid_rel']:.3e} (fp32) / "
          f"{out['float64']['resid_rel']:.3e} (fp64), host QR "
          f"{out['host_resid_rel']:.3e}", flush=True)
    return out


def _singular_home_block(seed: int):
    """``tests/test_mflu_unsym.py:96``'s matrix for ``seed``: random sparse
    n = 60 with a strong diagonal, then two home rows of the last mid-tree
    front of 3 or more columns made multiples of a third on that front's
    pivot columns (its home block exactly singular); None where the seed
    gives no such front or a condition number over 1e10."""
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import mflu_unsym as mu

    n = LU_REPAIR[0]
    rng = np.random.default_rng(seed)
    M = np.where(rng.random((n, n)) < 0.08, rng.standard_normal((n, n)),
                 0.0) + np.diag(rng.random(n) + 1)
    SL = mu.analyze_mflu_unsym(sstt.sparse.from_dense(M))
    S = SL.SQ.S
    fronts = [s for s in range(S.nsuper)
              if S.ncols(s) >= 3 and S.sparent[s] != -1]
    if not fronts:
        return None
    s = fronts[-1]
    rows = [SL.rowpre[int(r)] for r in SL.front_rows[s][:S.ncols(s)]]
    cols = [int(SL.SQ.q[S.super_first[s] + k]) for k in range(S.ncols(s))]
    M[rows[1], cols] = 2.0 * M[rows[0], cols]
    M[rows[2], cols] = -3.0 * M[rows[0], cols]
    return None if np.linalg.cond(M) > 1e10 else M


def lu_phase() -> dict:
    """The unsymmetric multifrontal LU on the card (see the module
    docstring, item 9). Every gate raises; the times are CUDA events
    around synchronized calls, the garbage collector held off."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import mflu_unsym as mu
    from suitesparse_tpu_torch.numeric import multifrontal_lu as ml

    dev = torch.device("cuda", 0)

    def ladder(call):
        """(x, seconds, rung deltas, device factors) of one call."""
        rungs0, f0 = dict(mu.rungs), mu.device_factors
        t0 = time.perf_counter()
        x = call()
        torch.cuda.synchronize()
        return (x, time.perf_counter() - t0,
                {k: mu.rungs[k] - rungs0[k] for k in rungs0},
                mu.device_factors - f0)

    out = {}
    gc.disable()
    try:
        A = sstt.fixtures.fem_unsym(LU_NX)
        b = np.ones(A.ncol)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for dtype in ("float32", "float64"):
            key = "fem" if dtype == "float32" else "fem64"
            cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
            x, first_s, rungs, factors = ladder(
                lambda: mu.mflusol_unsym(A, b, cfg))
            resid = sstt.residual_norm(A, x, b)
            assert x.shape == (A.ncol,) and resid < LU_TOL, (key, resid)
            assert rungs == {"lu": 1, "relaxed": 0, "qr": 0, "klu": 0}, \
                (key, rungs)
            _x, mflusol_s, _r, _f = ladder(
                lambda: mu.mflusol_unsym(A, b, cfg))
            t0 = time.perf_counter()
            SL = mu.analyze_mflu_unsym(A, cfg)
            analyze_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dp = mu.device_plan(SL, A, 1, dev)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            x1 = mu.lu_unsym_solve_device(A, b, cfg, SL)
            one = sstt.residual_norm(A, x1, b)
            assert np.isfinite(x1).all() and one < LU_ONE_TOL[dtype], \
                (key, one)
            lu_s = _best_s(lambda: mu.lu_unsym_solve_device(A, b, cfg, SL))
            factor_s = _best_s(
                lambda: mu.factorize_lu_unsym_device(A, SL, b, cfg))
            F = mu.factorize_lu_unsym_device(A, SL, b, cfg)
            sweep_s = _best_s(lambda: mu.qr_solve_device(F))
            del F
            flops = mu.lu_flops(SL)
            out[key] = {"first_s": first_s, "mflusol_s": mflusol_s,
                        "analyze_s": analyze_s, "plan_s": plan_s,
                        "lu_s": lu_s, "factor_s": factor_s,
                        "sweep_s": sweep_s, "flops": flops,
                        "gflops": flops / lu_s / 1e9,
                        "factor_gflops": flops / factor_s / 1e9,
                        "residual": resid, "residual_one": one,
                        "factors_per_call": factors, "rungs": rungs}
            print(f"lu {key}: first mflusol_unsym {first_s:.3f} s (again "
                  f"{mflusol_s:.3f} s, {factors} device factors a call, "
                  f"rungs {rungs}), residual {resid:.3e}; analyze "
                  f"{analyze_s:.3f} s, plan {plan_s:.3f} s; "
                  f"lu_unsym_solve_device {lu_s:.4f} s (factor "
                  f"{factor_s:.4f}, sweep {sweep_s:.4f}), residual "
                  f"{one:.3e}; {flops / 1e9:.6g} GFLOP, "
                  f"{flops / lu_s / 1e9:.2f} GFLOP/s "
                  f"({flops / factor_s / 1e9:.2f} in the factor)",
                  flush=True)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        groups = [g for gl in dp.plan.groups for g in gl]
        S = SL.SQ.S
        big = int(np.argmax([S.ncols(s) + SL.nforeign[s]
                             for s in range(S.nsuper)]))
        sizes = {"n": A.ncol, "nnz": A.nnz, "supernodes": S.nsuper,
                 "levels": len(dp.plan.groups),
                 "groups": len(groups),
                 "pair_classes": sum(len(g.pairs) for g in groups),
                 "front_cells": sum(g.B * g.M * g.N for g in groups),
                 "panel_cells": dp.plan.pool_size
                 - dp.plan.pool_data,
                 "largest_front": [int(S.ncols(big) + SL.nforeign[big]),
                                   len(S.rows[big])],
                 "peak_mem_gb": peak}
        out["fem"].update(sizes)
        print(f"lu fem: {sizes}", flush=True)
        del SL, dp

        # the router on a structurally unsymmetric pattern
        Au = sstt.fixtures.upwind_unsym(LU_NX)
        sym = Au.symmetry()["structural"]
        xu, first_s, rungs, factors = ladder(lambda: ml.mflusol(Au, b))
        resid = sstt.residual_norm(Au, xu, b)
        assert factors > 0, "the router kept the upwind matrix on the host"
        assert resid < LU_TOL and rungs["klu"] == 0, (resid, rungs)
        SLu = mu.analyze_mflu_unsym(Au)
        mu.lu_unsym_solve_device(Au, b, sstt.DEFAULT, SLu)
        upwind_s = _best_s(
            lambda: mu.lu_unsym_solve_device(Au, b, sstt.DEFAULT, SLu))
        out["upwind"] = {"first_s": first_s, "lu_s": upwind_s,
                         "residual": resid, "structural_symmetry": sym,
                         "nnz": Au.nnz, "supernodes": SLu.SQ.S.nsuper,
                         "flops": mu.lu_flops(SLu),
                         "factors_per_call": factors, "rungs": rungs}
        print(f"lu upwind: nnz {Au.nnz}, structural symmetry {sym:.3f}, "
              f"supernodes {SLu.SQ.S.nsuper}; first mflusol {first_s:.3f} s "
              f"({factors} device factors, rungs {rungs}), residual "
              f"{resid:.3e}; lu_unsym_solve_device {upwind_s:.4f} s",
              flush=True)
        del SLu

        # a truly deficient front: the device QR repairs it
        repair = {"lu": 0, "relaxed": 0, "qr": 0, "klu": 0}
        worst, cases = 0.0, 0
        for seed in range(LU_REPAIR[1]):
            M = _singular_home_block(seed)
            if M is None:
                continue
            Ar = sstt.sparse.from_dense(M)
            br = M @ np.ones(M.shape[0])
            xr, _s, rungs, _f = ladder(lambda: mu.mflusol_unsym(Ar, br))
            rr = sstt.residual_norm(Ar, xr, br)
            assert rr < LU_REPAIR_TOL, (seed, rr, rungs)
            repair = {k: repair[k] + rungs[k] for k in repair}
            worst, cases = max(worst, rr), cases + 1
        assert cases >= 3 and repair["qr"] >= 1 and repair["klu"] == 0, \
            repair
        out["repair"] = {"cases": cases, "residual": worst, "rungs": repair}
        print(f"lu repair: {cases} singular-home-block matrices, worst "
              f"residual {worst:.3e}, rungs {repair}", flush=True)
    finally:
        gc.enable()
    return out


@contextlib.contextmanager
def _step(steps: dict, name: str):
    """Seconds of the block, the device synchronized at its end, into
    ``steps[name]``."""
    import torch

    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    steps[name] = time.perf_counter() - t0


@contextlib.contextmanager
def _spans(targets: dict):
    """Seconds spent in each of ``targets`` (name -> (module, function
    name)) while the block runs, the device synchronized before and after
    each call; yields the dict it fills, and puts the functions back."""
    import torch

    out, saved = {}, []
    for name, (mod, attr) in targets.items():
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def timed(*args, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _fn(*args, **kw)
            torch.cuda.synchronize()
            out[_name] = out.get(_name, 0.0) + time.perf_counter() - t0
            return res

        setattr(mod, attr, timed)
    try:
        yield out
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def magnetic_laplacian(k: int, seed: int = CPLX_SEED):
    """``laplacian_3d(k)`` with each strictly-upper entry times e^{i theta},
    theta ~ U(-pi, pi) from ``default_rng(seed)`` in storage order: a
    connection Laplacian plus the Dirichlet boundary, Hermitian positive
    definite; the diagonal's imaginary parts are explicit zeros."""
    import suitesparse_tpu_torch as sstt

    A = sstt.fixtures.laplacian_3d(k)
    cols = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    off = A.indices < cols
    theta = np.random.default_rng(seed).uniform(-np.pi, np.pi,
                                                int(off.sum()))
    data = A.data.astype(np.complex128)
    data[off] *= np.exp(1j * theta)
    return sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, 1)


def embedded_kernels(dp, dev, rng) -> dict:
    """K1, K2, K3 and K7 against their plain versions at the shapes of the
    embedded magnetic Laplacian's plan ``dp`` (even-width supernodes, maps
    of 2x2 blocks), at the kernel phase's tolerances: K1 on the three
    largest groups of its gate, K2 on the manifest with the most steps and
    on the widest tile group (NaN above U's diagonal, which K2 must not
    read), K3 both ways at one right-hand side on the four largest groups
    of its classic route (which sends no group of this plan to K4), K7's
    group form on the fp32 and the fp64 work list with the most cells.
    Each kernel call is made twice for bit-equal results. Returns each
    kernel's largest error."""
    import torch

    from suitesparse_tpu_torch.kernels.extend_add_tiles import (
        extend_add_tiles, extend_add_tiles_plain)
    from suitesparse_tpu_torch.kernels.potrf import (potrf_trsm,
                                                     potrf_trsm_plain)
    from suitesparse_tpu_torch.kernels.potrf_sweep import tiles as k1_tiles
    from suitesparse_tpu_torch.numeric.supernodal_device import \
        _use_potrf_kernel
    from suitesparse_tpu_torch.numeric.supernodal_solve import classic_route

    walk = [(g, ix) for gl, il in zip(dp.plan.groups, dp.groups)
            for g, ix in zip(gl, il)]
    groups = [g for g, _ix in walk]
    rec: dict = {}

    def check(name, shape, d, e, tol):
        print(f"{name} embedded plan {shape} rel_err={e:.3e}", flush=True)
        assert np.isfinite(e) and e <= tol, \
            f"{name} disagrees on the embedded plan at {shape}: {e}"
        fold(name, {"err": e, "abs": d})

    def fold(name, r):
        k = rec.setdefault(name, {"err": 0.0, "abs": 0.0})
        k["err"], k["abs"] = max(k["err"], r["err"]), max(k["abs"], r["abs"])

    def largest(gs):
        return sorted(gs, key=lambda g: g.B * g.R * g.C, reverse=True)

    for g in largest(g for g in groups
                     if _use_potrf_kernel(torch.float32, g.B, g.C))[:3]:
        B, C, RU = g.B, g.C, g.R - g.C
        f11, f21 = k1_tiles(rng, B, C, RU, dev)
        L11, L21 = potrf_trsm(f11, f21)
        again = potrf_trsm(f11, f21)
        P11, P21 = potrf_trsm_plain(f11, f21)
        torch.cuda.synchronize()
        assert torch.equal(again[0], L11) and \
            (RU == 0 or torch.equal(again[1], L21)), (B, C, RU)
        d, e = _rel_err(L11, P11)
        if RU:
            d21, e21 = _rel_err(L21, P21)
            d, e = max(d, d21), max(e, e21)
        check("potrf_trsm", f"(B,C,RU)=({B},{C},{RU})", d, e, K1_TOL)

    tiled = [g for g in groups if g._tile is not None]
    k2_groups = (max(tiled, key=lambda g: g._tile.man.shape[0]),
                 max(tiled, key=lambda g: g.R))
    for tg in {id(g): g for g in k2_groups}.values():
        tm = tg._tile
        F0 = torch.as_tensor(rng.standard_normal((tg.B, tg.R, tg.R),
                                                 dtype=np.float32), device=dev)
        U = rng.standard_normal((max(tm.nslots, 1), tm.RUp, tm.RUp),
                                dtype=np.float32)
        U[(rng.random(U.shape, dtype=np.float32) < 0.05)
          & np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)] = np.nan
        U = torch.as_tensor(U, device=dev)
        args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                     for a in (tm.man, tm.rowmap, tm.colmap, tg._tile_runs))
        Fk = extend_add_tiles(F0.clone(), U, *args)
        Fk2 = extend_add_tiles(F0.clone(), U, *args)
        Fp = extend_add_tiles_plain(F0.clone(), U, *args[:3])
        torch.cuda.synchronize()
        assert torch.equal(Fk, Fk2), (tg.B, tg.R)
        check("extend_add_tiles", f"(B,R)=({tg.B},{tg.R}) "
              f"steps={tm.man.shape[0]} RUp={tm.RUp}", *_rel_err(Fk, Fp),
              K2_TOL)
        del F0, U, Fk, Fk2, Fp

    rows: dict = {}     # the rows of _k3_rows and _k7_group_row
    for g in largest(g for g in groups if classic_route(
            torch.float32, g.B, g.C, g.R - g.C, 1) == "solve_step")[:4]:
        _k3_rows(rows, rng, g.B, g.C, g.R - g.C, (1,), "embedded plan",
                 dev)
    for name, dtype, tol, attr in (
            ("extend_add", torch.float32, K567_TOL, "k7"),
            ("extend_add_f64", torch.float64, K7_F64_TOL, "k7_all")):
        g, ix = max(((g, ix) for g, ix in walk
                     if getattr(ix, attr) is not None),
                    key=lambda gi: getattr(gi[1], attr).cells)
        skip = set(g._tile.folded) if attr == "k7" and g._tile is not None \
            else ()
        _k7_group_row(rows, name, g, getattr(ix, attr), dp, dev, rng, dtype,
                      tol, "embedded plan", skip)
    for name, r in rows.items():
        fold(name, r)
    return rec


def small_complex_check(dev):
    """The embedded factor of a small magnetic Laplacian (k = 10: 2,000
    real unknowns, tiles from R = 32 so that K2 runs) on the card equal to
    the CPU factor entry by entry, and the card solve equal to the host
    LL^H solve."""
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import complex_embed as ce
    from suitesparse_tpu_torch.numeric import (supernodal_device,
                                               supernodal_solve)

    H = magnetic_laplacian(10)
    cfg = sstt.DEFAULT
    S = ce.embedded_analysis(H, cfg)
    M = ce.embed_matrix(H)
    Fg = supernodal_device.factorize_device(M, S, cfg, dev, tile_rmin=32)
    Fc = supernodal_device.factorize_device(M, S, cfg, "cpu", tile_rmin=32)
    assert Fg.ok and Fc.ok
    lg, lc = Fg.Lx.cpu().numpy(), Fc.Lx.numpy()
    lx_err = np.abs(lg - lc).max() / np.abs(lc).max()
    assert lx_err <= 1e-5, f"card factor differs from CPU factor: {lx_err}"
    n = H.ncol
    b = 1 + 1j * np.arange(n) / n
    x = ce.unembed_vec(supernodal_solve.solve_device(Fg, ce.embed_vec(b),
                                                     cfg))
    x_ref = sstt.solve(sstt.factorize(H, sstt.analyze(H, cfg), cfg,
                                      device="cpu"), b)
    x_err = np.abs(x - x_ref).max() / np.abs(x_ref).max()
    assert x.shape == (n,) and x_err <= 1e-4, f"small solve off: {x_err}"
    print(f"small embedded check n={n} ({S.n} real): lx_rel_err="
          f"{lx_err:.3e} x_rel_err_vs_host_llh={x_err:.3e}", flush=True)
    return {"lx_err": float(lx_err), "x_err": float(x_err)}


def _rotated(A, seed: int, spread: float):
    """A general CSC with each value times e^{i theta}, theta ~ U(-spread,
    spread) from ``default_rng(seed)`` in storage order."""
    import suitesparse_tpu_torch as sstt

    theta = np.random.default_rng(seed).uniform(-spread, spread, A.nnz)
    return sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices,
                    A.data * np.exp(1j * theta), 0)


def _complex_normal_residual(A, x, b) -> float:
    """max|A^H r| / (max|A| max|r|), r = b - Ax: the least-squares
    optimality measure of ``_normal_residual`` for complex A."""
    r = b - A.matvec(x)
    ahr = np.conj(A.rmatvec(np.conj(r)))
    return float(np.abs(ahr).max()
                 / (np.abs(A.data).max() * max(np.abs(r).max(), 1e-30)))


def complex_phase() -> dict:
    """Complex input on the card through the 2x2 real embedding (see the
    module docstring, item 10). Every gate raises; ``ComplexWarning`` is an
    error throughout; times are CUDA events or the host clock around
    synchronized calls, the garbage collector held off."""
    import warnings

    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import complex_embed as ce
    from suitesparse_tpu_torch.numeric import mflu_unsym as mu
    from suitesparse_tpu_torch.numeric import mfqr_device as md
    from suitesparse_tpu_torch.numeric import multifrontal_lu as ml
    from suitesparse_tpu_torch.numeric import (supernodal_device,
                                               supernodal_solve)

    dev = torch.device("cuda", 0)
    card = _card()
    out = {"card": card}
    steps: dict = {}     # seconds of each step of the phase
    chol_parts = {"analyze_n": (sstt, "analyze"),
                  "analyze_embedded": (ce, "_embedded"),
                  "plan": (supernodal_device, "_plan_entry"),
                  "factor": (supernodal_device, "factorize_device"),
                  "solve": (supernodal_solve, "solve_device")}
    with warnings.catch_warnings():
        warnings.simplefilter("error", np.exceptions.ComplexWarning)
        gc.disable()
        try:
            # ---- Hermitian: the magnetic Laplacian, k = 40 ----
            with _step(steps, "build_h"):
                H = magnetic_laplacian(CPLX_K)
            n = H.ncol
            b = 1 + 1j * np.arange(n) / n
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            with _spans(chol_parts) as sp, _step(steps, "first_cholsol"):
                t0 = time.perf_counter()
                x = sstt.cholsol(H, b)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            launches = counts()
            cache = getattr(H, "_embed_chol", None)
            assert cache is not None and cache[1][0].n == 2 * n, \
                "cholsol kept the complex Hermitian cell off the embedding"
            assert launches["potrf_trsm"] > 0 and \
                launches["extend_add_tiles"] > 0 and \
                launches["extend_add"] > 0, launches
            S, P, _src = cache[1]
            with _step(steps, "analyze_again"):
                perm = sstt.analyze(H).perm
            assert ce.embedded_analysis(H, sstt.DEFAULT, perm) is S
            resid = sstt.residual_norm(H, x, b)
            gate = np.abs(H.matvec(x) - b).max() / np.abs(b).max()
            assert x.shape == (n,) and np.isfinite(x).all()
            assert resid < CPLX_TOL["float32"] and gate < CPLX_GATE, \
                (resid, gate)
            parts = {"analyze_s": sp["analyze_n"] + sp["analyze_embedded"],
                     "plan_s": sp["plan"],
                     "factor_s": sp["factor"] - sp["plan"],
                     "solve_s": sp["solve"]}
            dp = supernodal_device.device_plan(P, S, dev)
            groups = [g for gl in dp.plan.groups for g in gl]
            k1 = sum(supernodal_device._use_potrf_kernel(
                torch.float32, g.B, g.C) for g in groups)
            widths = np.diff(S.super_first)
            with _step(steps, "embedded_kernels"):
                kernel_check = embedded_kernels(
                    dp, dev, np.random.default_rng(CPLX_SEED))
            with _step(steps, "small_complex_check"):
                small = small_complex_check(dev)
            with _step(steps, "auto_sweep_factor"):
                F = supernodal_device.factorize_device(
                    ce.embed_matrix(H), S, sstt.DEFAULT, dev)
                sweep = supernodal_solve.solve_mode(F, sstt.DEFAULT)
                del F
            with _step(steps, "steady_cholsol"):
                chol_s = _best_s(lambda: ce.cholsol_complex_device(
                    H, b, perm=perm))
            with _step(steps, "replay_check"):
                replay = replay_check(ce.embed_matrix(H), S, sstt.DEFAULT,
                                      dev)
            zero_counts()
            classic = sstt.DEFAULT.replace(solve_mode="classic")
            with _step(steps, "classic_cholsol"):
                xc = ce.cholsol_complex_device(H, b, classic, perm=perm)
            classic_launches = counts()
            assert classic_launches["solve_step_fwd"] > 0 and \
                classic_launches["solve_step_bwd"] > 0, classic_launches
            cresid = sstt.residual_norm(H, xc, b)
            assert cresid < CPLX_TOL["float32"], cresid
            cfg64 = sstt.DEFAULT.replace(compute_dtype="float64")
            zero_counts()
            with _step(steps, "fp64_cholsol"):
                x64 = ce.cholsol_complex_device(H, b, cfg64, perm=perm)
            chol64_s = steps["fp64_cholsol"]
            launches64 = counts()
            with _step(steps, "replay_check64"):
                replay64 = replay_check(ce.embed_matrix(H), S, cfg64, dev,
                                        calls=2)
            resid64 = sstt.residual_norm(H, x64, b)
            gate64 = np.abs(H.matvec(x64) - b).max() / np.abs(b).max()
            assert np.isfinite(x64).all() and launches64["extend_add_f64"] > 0
            assert resid64 < CPLX_TOL["float64"] and gate64 < CPLX_GATE, \
                (resid64, gate64)
            dx = np.abs(x - x64).max() / np.abs(x64).max()
            assert dx <= CPLX_X_TOL, f"fp32 x differs from fp64 x: {dx}"
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            out["chol"] = {
                "n": n, "n_embedded": S.n, "nnz": H.nnz,
                "nnz_embedded": P.nnz, "fl": S.fl, "lnz": S.lnz,
                "supernodes": S.nsuper, "levels": len(S.levels),
                "odd_supernodes": int(np.count_nonzero(widths % 2)),
                "groups": len(groups), "k1_groups": int(k1),
                "tile_groups": sum(g._tile is not None for g in groups),
                "first_s": first_s, **parts, "sweep": sweep,
                "cplx_chol_s": chol_s, "gflops": S.fl / chol_s / 1e9,
                "cplx_chol64_s": chol64_s, "residual": resid,
                "gate": gate, "classic_residual": cresid,
                "residual64": resid64, "gate64": gate64,
                "fp32_vs_fp64": dx, "peak_mem_gb": peak,
                "kernel_check": kernel_check, "small_check": small,
                "replay_check": replay, "replay_check64": replay64,
                "launches": launches, "classic_launches": classic_launches,
                "launches64": launches64}
            print(f"complex chol: {out['chol']}", flush=True)
            del dp, S, P, cache, H      # the plan on the analysis

            # ---- LU: upwind_unsym(30), rotated by U(-pi/4, pi/4) ----
            Au = _rotated(sstt.fixtures.upwind_unsym(CPLX_LU_NX),
                          CPLX_LU_SEED, np.pi / 4)
            bu = 1 + 1j * np.arange(Au.ncol) / Au.ncol
            rungs0, f0 = dict(mu.rungs), mu.device_factors
            seg0 = mu.segmented_factors
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with _spans({"analyze": (mu, "analyze_mflu_unsym"),
                         "plan": (mu, "_plan_entry"),
                         "factor": (mu, "factorize_lu_unsym_device"),
                         "solve": (mu, "qr_solve_device")}) as sp, \
                    _step(steps, "lu_mflusol"):
                t0 = time.perf_counter()
                xu = ml.mflusol(Au, bu)
                torch.cuda.synchronize()
                lu_s = time.perf_counter() - t0
            rungs = {k: mu.rungs[k] - rungs0[k] for k in rungs0}
            factors = mu.device_factors - f0
            seg_factors = mu.segmented_factors - seg0
            lresid = sstt.residual_norm(Au, xu, bu)
            assert factors > 0, "the complex LU cell stayed off the card"
            assert np.isfinite(xu).all() and lresid < CPLX_LU_TOL, \
                (lresid, rungs)
            out["lu"] = {"n": Au.ncol, "n_embedded": 2 * Au.ncol,
                         "nnz": Au.nnz,
                         "structural_symmetry": Au.symmetry()["structural"],
                         "cplx_lu_s": lu_s, "analyze_s": sp["analyze"],
                         "plan_s": sp["plan"],
                         "factor_s": sp["factor"] - sp["plan"],
                         "solve_s": sp["solve"], "residual": lresid,
                         "rungs": rungs, "device_factors": factors,
                         "ran": "segmented" if seg_factors else "one-piece",
                         "segmented_factors": seg_factors,
                         "peak_mem_gb": (torch.cuda.max_memory_allocated()
                                         - base) / 1e9}
            print(f"complex lu ({card}): ran {out['lu']['ran']} under the "
                  f"auto budget, peak {out['lu']['peak_mem_gb']:.4f} GB "
                  f"above the phase's base; {out['lu']}", flush=True)

            # ---- QR: local_coupling_ls(6000, 2000), grid_gradient_3d(24) ----
            out["qr"] = {}
            for name, A0 in (("lc", sstt.fixtures.local_coupling_ls(
                                 *CPLX_QR_LC)),
                             ("grid", sstt.fixtures.grid_gradient_3d(
                                 CPLX_QR_GRID))):
                A = _rotated(A0, CPLX_QR_SEED, np.pi)
                rng = np.random.default_rng(CPLX_QR_SEED)
                bq = rng.standard_normal(A.nrow) + \
                    1j * rng.standard_normal(A.nrow)
                calls = md.device_factors
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t_qr = time.perf_counter()
                with _spans({"analyze": (md, "analyze_mfqr"),
                             "plan": (md, "_plan_entry"),
                             "factor": (md, "factorize_qr_device"),
                             "solve": (md, "qr_solve_device")}) as sp:
                    t0 = time.perf_counter()
                    xq = sstt.qrsol(A, bq)
                    torch.cuda.synchronize()
                    first_q = time.perf_counter() - t0
                assert md.device_factors == calls + 1, md.device_factors
                assert xq.shape == (A.ncol,) and np.isfinite(xq).all()
                ne = _complex_normal_residual(A, xq, bq)
                assert ne < CPLX_QR_NE_TOL, (name, ne)
                qr_s = _best_s(lambda: sstt.qrsol(A, bq))
                rec = {"m": A.nrow, "n": A.ncol, "nnz": A.nnz,
                       "first_s": first_q, "analyze_s": sp["analyze"],
                       "plan_s": sp["plan"],
                       "factor_s": sp["factor"] - sp["plan"],
                       "solve_s": sp["solve"], "cplx_qr_s": qr_s,
                       "normal_residual": ne,
                       "peak_mem_gb": (torch.cuda.max_memory_allocated()
                                       - base) / 1e9}
                if name == "lc":
                    x_ref = np.linalg.lstsq(A.to_dense(), bq,
                                            rcond=None)[0]
                    err = np.abs(xq - x_ref).max() / np.abs(x_ref).max()
                    assert err < CPLX_QR_LSTSQ_TOL, err
                    rec["lstsq_err"] = err
                steps[f"qr_{name}"] = time.perf_counter() - t_qr
                out["qr"][name] = rec
                print(f"complex qr {name}: {rec}", flush=True)
        finally:
            gc.enable()
    out["steps_s"] = steps
    print(f"complex phase steps ({card}), seconds: {steps}", flush=True)
    return out


def segmented_phase(A=None, S=None) -> dict:
    """Segmented execution on the card (see the module docstring, item
    11): each cell factored in one piece under the auto budget, then
    forced into segments; every gate raises. ``A`` and ``S``: the model
    problem and its supernodal analysis, when the caller has them. Times
    are CUDA events (min of 3 after a warm call), the garbage collector
    held off; each peak is ``max_memory_allocated`` above the allocation
    at its reset, the plan's one-piece upload let go before."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import complex_embed as ce
    from suitesparse_tpu_torch.numeric import mflu_unsym as mu
    from suitesparse_tpu_torch.numeric import mfqr_device as md
    from suitesparse_tpu_torch.numeric import multifrontal_lu as ml
    from suitesparse_tpu_torch.numeric import segmented, supernodal
    from suitesparse_tpu_torch.numeric import supernodal_device as sd

    dev = torch.device("cuda", 0)
    card = _card()
    cfg = sstt.DEFAULT
    out = {"card": card}

    def measure(dp, run):
        """(result, seconds, peak GB above the base, launches) of the
        first call of ``run``, the plan's one-piece upload let go."""
        dp.groups = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - base) / 1e9, counts())

    def cell(name, dp, factor, nseg, gate, key=torch.float32):
        """``factor(config)`` in one piece under the auto budget, then
        forced into segments; ``nseg(F)`` its segment count; ``gate(F1,
        Fs, launches1, launches_s)`` the cell's gates (raise past a
        tolerance) and the numbers they read; ``key`` the factor's entry
        of ``dp.costs``."""
        F1, first1, peak1, l1 = measure(dp, lambda: factor(cfg))
        assert nseg(F1) == 1, (name, "the auto budget segmented it")
        est = segmented.one_piece_bytes(dp.index_bytes, dp.costs[key])
        seg_cfg = cfg.replace(segment_bytes=max(1, est // SEG_SHARE))
        Fs, first_s, peak_s, ls = measure(dp, lambda: factor(seg_cfg))
        segs = nseg(Fs)
        assert segs >= SEG_MIN, (name, segs)
        rec = {"segments": segs, "groups": len(dp.host),
               "estimate_bytes": est, "budget_bytes": seg_cfg.segment_bytes,
               "index_bytes": dp.index_bytes,
               "one_piece_s": _best_s(lambda: factor(cfg)),
               "segmented_s": _best_s(lambda: factor(seg_cfg)),
               "one_piece_first_s": first1, "segmented_first_s": first_s,
               "one_piece_peak_gb": peak1, "segmented_peak_gb": peak_s,
               **gate(F1, Fs, l1, ls)}
        print(f"segmented {name} ({card}): {segs} segments of "
              f"{len(dp.host)} groups at a budget of "
              f"{rec['budget_bytes']} B (one-piece estimate {est} B); "
              f"factor {rec['segmented_s']:.4f} s segmented, "
              f"{rec['one_piece_s']:.4f} s one-piece; peak "
              f"{peak_s:.4f} / {peak1:.4f} GB; {rec}", flush=True)
        return rec, seg_cfg

    gc.disable()
    try:
        # ---- Cholesky: the model problem, fp32 ----
        if S is None:
            A = sstt.fixtures.laplacian_3d(SIZE)
            mcfg = cfg.replace(ordering=sstt.Ordering.METIS)
            S = supernodal.supernodal_symbolic(A, sstt.analyze(A, mcfg),
                                               mcfg)
        dp = sd._plan_entry(A, S, dev, sd.TILE_RMIN, False)
        b = 1.0 + np.arange(A.ncol) / A.ncol

        def chol_gate(F1, Fs, l1, ls):
            lx_err = ((Fs.Lx - F1.Lx).abs().max()
                      / F1.Lx.abs().max()).item()
            assert Fs.ok and lx_err <= SEG_LX_TOL, lx_err
            kern = ("potrf_trsm", "extend_add_tiles", "extend_add")
            assert all(l1[k] == ls[k] > 0 for k in kern), (l1, ls)
            x = sstt.solve(supernodal.SupernodalFactorAdapter(Fs), b, cfg)
            resid = sstt.residual_norm(A, x, b)
            assert np.isfinite(x).all() and resid < RESID_TOL, resid
            return {"lx_rel_err": lx_err, "residual": resid,
                    "launches": {k: ls[k] for k in kern}}

        out["chol"], _c = cell(
            "chol", dp, lambda c: sd.factorize_device(A, S, c, dev),
            lambda F: F.segments, chol_gate,
            key=(torch.float32, torch.float32))
        del S, dp, A

        # ---- QR: grid_gradient_3d(32), fp32 ----
        A = sstt.fixtures.grid_gradient_3d(QR_GRID)
        bq = np.random.default_rng(QR_SEED).standard_normal(A.nrow)
        SQ = md._SQ_CACHE.get(md._analysis_key(A, cfg)) or \
            md.analyze_mfqr(A, cfg)
        dp = md._plan_entry(SQ, A.permuted(None, SQ.q), 1, dev)

        def x_gate(A, b, resid_fn, tol, resid_tol):
            """The QR's and the LU's gates: x against the one-piece x
            (relative to its largest entry) and the residual."""
            def gate(F1, Fs, _l1, _ls):
                x1, xs = md.qr_solve_device(F1), md.qr_solve_device(Fs)
                err = np.abs(xs - x1).max() / np.abs(x1).max()
                resid = resid_fn(A, xs[:, 0], b)
                assert np.isfinite(xs).all() and err <= tol and \
                    resid < resid_tol, (err, resid)
                return {"x_rel_err": err, "residual": resid}
            return gate

        out["qr"], _c = cell(
            "qr", dp, lambda c: md.factorize_qr_device(A, SQ, bq, c, dev),
            lambda F: 1 if F.segments is None else len(F.segments),
            x_gate(A, bq, _normal_residual, QR_GRID_TOL,
                   QR_NE_TOL["float32"]))
        del SQ, dp, A

        # ---- LU: fem_unsym(30), fp32 ----
        def lu_cell(name, A, b):
            SL = mu.analyze_mflu_unsym(A, cfg)
            dp = mu._plan_entry(SL, A, 1, dev)
            rec, seg_cfg = cell(
                name, dp,
                lambda c: mu.factorize_lu_unsym_device(A, SL, b, c, dev),
                lambda F: 1 if F.segments is None else len(F.segments),
                x_gate(A, b, sstt.residual_norm, LU_ONE_TOL["float32"],
                       LU_ONE_TOL["float32"]))
            gidx = sum(h.gidx.numel() * h.gidx.element_size()
                       for h in dp.host)
            rec["gather_index_bytes"] = gidx
            return rec, seg_cfg, gidx

        A = sstt.fixtures.fem_unsym(LU_NX)
        out["lu"], _c, _g = lu_cell("lu", A, np.ones(A.ncol))

        # ---- the complex LU: the embedded rotated upwind_unsym(30) ----
        Au = _rotated(sstt.fixtures.upwind_unsym(CPLX_LU_NX), CPLX_LU_SEED,
                      np.pi / 4)
        bu = 1 + 1j * np.arange(Au.ncol) / Au.ncol
        M = ce.embed_matrix(Au.to_full_storage())
        rec, seg_cfg, gidx = lu_cell("complex lu", M, ce.embed_vec(bu))
        gap = rec["one_piece_peak_gb"] - rec["segmented_peak_gb"]
        assert gap * 1e9 >= 0.5 * gidx, (gap, gidx)
        seg0 = mu.segmented_factors
        t0 = time.perf_counter()
        xu = ml.mflusol(Au, bu, seg_cfg)
        torch.cuda.synchronize()
        rec["mflusol_s"] = time.perf_counter() - t0
        rec["mflusol_segmented_factors"] = mu.segmented_factors - seg0
        rec["mflusol_residual"] = lresid = sstt.residual_norm(Au, xu, bu)
        assert rec["mflusol_segmented_factors"] > 0 and \
            np.isfinite(xu).all() and lresid < CPLX_LU_TOL, rec
        rec["peak_gap_gb"] = gap
        out["complex_lu"] = rec
        print(f"segmented complex lu ({card}): peak {gap:.4f} GB below the "
              f"one-piece's ({gidx / 1e9:.4f} GB of gather indices); "
              f"mflusol in segments {rec['mflusol_s']:.3f} s, "
              f"{rec['mflusol_segmented_factors']} segmented factors, "
              f"residual {lresid:.3e}", flush=True)
    finally:
        gc.enable()
    return out


def _quiet_best_s(fn, reps: int = 3) -> float:
    """:func:`_best_s` with Python's garbage collector held off."""
    gc.disable()
    try:
        return _best_s(fn, reps)
    finally:
        gc.enable()


def persist_phase(A=None, Ssim=None) -> tuple[dict, dict]:
    """The checkpoint/restart path on the model problem (module docstring,
    item 12). ``A`` and ``Ssim``: the model problem and its analysis, when
    the caller has them (the kernel phase's); the phase factors A once on
    the card and solves it by the w2 sweep for the reference x. Returns
    (the phase's numbers, K4's record at the px plan's shapes); every gate
    raises."""
    import tempfile

    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch import check, report, serialize
    from suitesparse_tpu_torch.kernels.trisolve import (
        batched_trisolve, batched_trisolve_plain)
    from suitesparse_tpu_torch.numeric import supernodal_solve as ss
    from suitesparse_tpu_torch.numeric.supernodal import TorchPxFactor

    dev = torch.device("cuda", 0)
    card = _card()
    out = {"card": card}
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    classic = cfg.replace(solve_mode="classic")
    if A is None:
        A = sstt.fixtures.laplacian_3d(SIZE)
        Ssim = sstt.analyze(A, cfg)
    F = sstt.factorize(A, Ssim, cfg, device="cuda")
    assert F.ok, f"factorization failed at column {F.minor}"
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    B64 = np.tile(b.reshape(-1, 1), (1, NRHS)) * (1.0 + np.arange(NRHS) / NRHS)
    x, x64 = sstt.solve(F, b, cfg), sstt.solve(F, B64, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/A.mtx"
        t0 = time.perf_counter()
        sstt.io.write_matrix_market(path, A)
        out["mm_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        A2 = sstt.io.read_matrix_market(path)
        out["mm_read_s"] = time.perf_counter() - t0
        assert (A2.nrow, A2.ncol, A2.sym) == (A.nrow, A.ncol, A.sym) and \
            all(np.array_equal(u, v) for u, v in (
                (A2.indptr, A.indptr), (A2.indices, A.indices),
                (A2.data, A.data))), "Matrix Market round trip differs"
        info = report.info_from_factor(F, A2)
        print(report.report_info(info), flush=True)
        out["info"] = dataclasses.asdict(info)

        fpath = f"{tmp}/F.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serialize.save_factor(fpath, F)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        G = serialize.load_factor(fpath, device="cuda", config=cfg)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(fpath)
    P = G.F
    assert isinstance(P, TorchPxFactor) and P.Lx.device.type == "cuda" \
        and P.Lx.dtype == torch.float32, (type(P), P.Lx)
    assert torch.equal(P.Lx.cpu().double(), torch.from_numpy(
        F.F.lx_host())), "F1: the loaded panels differ from lx_host()"
    assert P.Lx.numel() == F.F.S.lnz != F.F.Lx.numel()
    t0 = time.perf_counter()
    check.check_factor(G)
    out["check_factor_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    plan = ss.px_plan(P.S)
    out["plan_s"] = time.perf_counter() - t0
    groups = [g for gl in plan.groups for g in gl]
    gated = {nr: [g for g in groups if ss.px_route(
        torch.float32, g.B, g.C, nr) == "trisolve"] for nr in (1, NRHS)}
    out.update(groups=len(groups), levels=len(plan.groups),
               panel_cells=sum(g.B * g.R * g.C for g in groups),
               k4_groups={nr: len(v) for nr, v in gated.items()})
    assert gated[1] and gated[NRHS], out["k4_groups"]

    xs, launches = {}, {}
    for nr, rhs, ref in ((1, b, x), (NRHS, B64, x64)):
        zero_counts()
        t0 = time.perf_counter()
        xp = sstt.solve(G, rhs, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches[nr] = c = counts()
        # both directions: one launch a gated group each way
        assert c["batched_trisolve"] == 2 * len(gated[nr]) and \
            sum(c.values()) == c["batched_trisolve"], (nr, c)
        assert xp.shape == rhs.shape and np.isfinite(xp).all()
        cols = [(xp, rhs)] if nr == 1 else \
            [(xp[:, k], rhs[:, k]) for k in (0, nr - 1)]
        resid = max(sstt.residual_norm(A, xc, bc) for xc, bc in cols)
        dx = np.abs(xp - ref).max() / np.abs(ref).max()
        assert resid < RESID_TOL and dx <= PX_X_TOL, (nr, resid, dx)
        out[f"nrhs{nr}"] = {"first_solve_s": first_s, "residual": resid,
                            "vs_w2": dx, "launches": c}
        xs[nr] = xp
    # what the restart path holds: the loaded Lx and the gathered panels
    # on the card, the plan's int64 gather maps on the host
    panels = P._solve[("px", torch.float32)][1]
    # (L21 is a view: count each storage once)
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for row in panels for pair in row for t in pair}
    out["device_bytes"] = {
        "Lx": P.Lx.untyped_storage().nbytes(), "panels": sum(held.values())}
    out["panel_src_host_bytes"] = sum(g.panel_src.nbytes for g in groups)
    print(f"persist: px plan {out['plan_s']:.3f} s, {len(groups)} groups "
          f"on {len(plan.groups)} levels, {out['panel_cells']} panel cells; "
          f"K4 groups {out['k4_groups']}; launches {launches}", flush=True)

    # K4 at the px plan's largest gated group, the loaded factor's own L11
    # with NaN above its diagonal (K4 reads the lower triangle only)
    rec: dict = {}
    rng = np.random.default_rng(SEED + 17)
    where = {id(g): (d, gi) for d, gl in enumerate(plan.groups)
             for gi, g in enumerate(gl)}
    for nr in (1, NRHS):
        g = max(gated[nr], key=lambda g: g.B * g.C * g.C)
        d, gi = where[id(g)]
        L11 = panels[d][gi][0]
        Ln = L11.clone()
        iu = torch.triu_indices(g.C, g.C, 1, device=dev)
        Ln[:, iu[0], iu[1]] = float("nan")
        Y = torch.as_tensor(rng.standard_normal((g.B, g.C, nr),
                                                dtype=np.float32), device=dev)
        for transpose in (False, True):
            X = batched_trisolve(Ln, Y, transpose)
            PX = batched_trisolve_plain(L11, Y, transpose)
            torch.cuda.synchronize()
            dabs, err = _rel_err(X, PX)
            A_ = L11.mT if transpose else L11
            _record(
                rec, "batched_trisolve_px",
                f"(B,C,NR)=({g.B},{g.C},{nr}) transpose={transpose}", err,
                dabs, _cuda_ms(lambda: batched_trisolve(Ln, Y, transpose),
                               10),
                _cuda_ms(lambda: batched_trisolve_plain(L11, Y, transpose),
                         2),
                4.0 * g.B * (g.C * (g.C + 1) / 2 + 2 * g.C * nr),
                float(g.B * nr * g.C * g.C),
                library_ms=_cuda_ms(lambda: torch.linalg.solve_triangular(
                    A_, Y, upper=transpose), 10))

    walls = {}
    for nr, rhs in ((1, b), (NRHS, B64)):
        walls[nr] = {
            "px": _quiet_best_s(lambda: sstt.solve(G, rhs, cfg)),
            "w2": _quiet_best_s(lambda: sstt.solve(F, rhs, cfg)),
            "classic": _quiet_best_s(lambda: sstt.solve(F, rhs, classic))}
    out["steady_s"] = walls
    print(f"persist on {card}: Matrix Market write / read "
          f"{out['mm_write_s']:.3f} / {out['mm_read_s']:.3f} s; save / load "
          f"{out['save_s']:.3f} / {out['load_s']:.3f} s "
          f"({out['file_bytes']} bytes); px plan {out['plan_s']:.3f} s; "
          f"held: Lx {out['device_bytes']['Lx']} and panels "
          f"{out['device_bytes']['panels']} bytes on the card, panel_src "
          f"{out['panel_src_host_bytes']} bytes on the host; first px solve "
          f"{out['nrhs1']['first_solve_s']:.3f} s; steady px / w2 / classic "
          f"solve {walls[1]['px']:.4f} / {walls[1]['w2']:.4f} / "
          f"{walls[1]['classic']:.4f} s at nrhs 1, {walls[NRHS]['px']:.4f} / "
          f"{walls[NRHS]['w2']:.4f} / {walls[NRHS]['classic']:.4f} s at nrhs "
          f"{NRHS}; residuals {out['nrhs1']['residual']:.3e} / "
          f"{out['nrhs' + str(NRHS)]['residual']:.3e}, x vs w2 "
          f"{out['nrhs1']['vs_w2']:.3e} / "
          f"{out['nrhs' + str(NRHS)]['vs_w2']:.3e}", flush=True)
    del G, P, panels, F
    return out, rec


def inv_phase(A, F, refs: dict) -> tuple[dict, dict]:
    """The inverse-panel sweep without W2 (``solve_mode="inv"``) on the
    main path's factor ``F`` of the model problem (module docstring, item
    13). ``refs``: {nrhs: (b, w2 x, classic x)} of the main path. Returns
    (the phase's numbers, K6's record at the inv shapes); every gate
    raises."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels.bmatvec import bmatvec, bmatvec_plain
    from suitesparse_tpu_torch.numeric import supernodal_solve as ss

    dev = torch.device("cuda", 0)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    inv = cfg.replace(solve_mode="inv")
    inv_k = inv.replace(solve_bmv=True)
    classic = cfg.replace(solve_mode="classic")
    P = F.F
    # the plan the solves take: the coarse solve plan
    assert ss.solve_ladder(P) == "coarse"
    splan = ss._coarse_entry(P.S, P.dplan)[0].plan
    groups = [g for gl in splan.groups for g in gl]
    k6 = {nr: [g for g in groups if ss.inv_route(g.B, g.C, g.R - g.C, nr,
                                                   inv_k) == "bmv"]
          for nr in refs}
    out = {"card": _card(), "k6_groups": {nr: len(v) for nr, v in k6.items()}}
    launches, xs = {}, {}
    for nr, (rhs, xw2, xcl) in refs.items():
        for bmv, c in (("on", inv_k), ("off", inv)):
            zero_counts()
            t0 = time.perf_counter()
            x = sstt.solve(F, rhs, c)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            got = counts()
            panels = sum(1 + (g.R > g.C) for g in k6[nr])
            want = panels if bmv == "on" else 0
            # K6 takes both panels of each gated group, both ways; nothing
            # else launches
            assert got["bmatvec"] == got["bmatvec_t"] == want > 0 or \
                bmv == "off" and got["bmatvec"] == got["bmatvec_t"] == 0, \
                (nr, bmv, got, want)
            assert sum(got.values()) == got["bmatvec"] + got["bmatvec_t"], \
                got
            assert x.shape == rhs.shape and np.isfinite(x).all()
            cols = [(x, rhs)] if nr == 1 else \
                [(x[:, k], rhs[:, k]) for k in (0, nr - 1)]
            resid = max(sstt.residual_norm(A, xc, bc) for xc, bc in cols)
            dw2 = np.abs(x - xw2).max() / np.abs(xw2).max()
            dcl = np.abs(x - xcl).max() / np.abs(xcl).max()
            assert resid < RESID_TOL and resid < min(BENCH_GATES), resid
            assert dw2 <= INV_X_TOL and dcl <= INV_X_TOL, (nr, bmv, dw2, dcl)
            out[f"nrhs{nr}_bmv_{bmv}"] = {
                "first_solve_s": first_s, "residual": resid, "vs_w2": dw2,
                "vs_classic": dcl, "launches": got}
            launches[(nr, bmv)] = got
            xs[(nr, bmv)] = x
    assert ss.solve_mode(P, inv) == "inv"
    # solve_dispatch: the sweep and its device arguments, every cache full
    b1 = refs[1][0]
    fn, args = ss.solve_dispatch(P, b1, inv_k)
    y = fn(*args)
    xd = np.empty(y.shape, dtype=np.float64)
    xd[P.S.perm] = y.cpu().numpy()
    # the same sweep; the card's index_add_ sums in no fixed order
    x1 = xs[(1, "on")]
    out["dispatch_vs_solve"] = dd = \
        np.abs(xd[:, 0] - x1).max() / np.abs(x1).max()
    assert dd <= 1e-6, f"solve_dispatch differs from solve: {dd}"
    out["dispatch_sweep_s"] = _quiet_best_s(lambda: fn(*args))

    # the state: W and the L21 copies of the K6 groups, against W2
    def nbytes(obj):
        seen = {}
        stack = [obj]
        while stack:
            o = stack.pop()
            if isinstance(o, torch.Tensor):
                seen[o.untyped_storage().data_ptr()] = \
                    o.untyped_storage().nbytes()
            elif isinstance(o, (list, tuple)):
                stack.extend(o)
        return sum(seen.values())

    winv = P._solve[ss._inv_key(torch.float32, inv_k)][1]
    out["state_bytes"] = {
        "inv_bmv": nbytes(winv),
        "inv": nbytes(P._solve[ss._inv_key(torch.float32, inv)][1]),
        "w2": nbytes(P._solve[("w2", torch.float32)][1])}

    # K6 at the largest gated (C, C) and (RU, C) panels, the factor's own
    # W and L21 copies, each way, at 1 and 8 right-hand sides
    rec: dict = {}
    rng = np.random.default_rng(SEED + 19)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)

    def cold():
        flush.zero_()
        return ()

    where = {id(g): (d, gi) for d, gl in enumerate(splan.groups)
             for gi, g in enumerate(gl)}
    gW = max(k6[1], key=lambda g: g.B * g.C * g.C)
    gL = max((g for g in k6[1] if g.R > g.C),
             key=lambda g: g.B * (g.R - g.C) * g.C)
    shapes = []
    for g, which in ((gW, 0), (gL, 1)):
        d, gi = where[id(g)]
        shapes.append((winv[d][gi][which], "W" if which == 0 else "L21"))
    for M, what in shapes:
        B, I, J = M.shape
        for transpose in (False, True):
            K, N = (I, J) if transpose else (J, I)
            Mk = M.mT if transpose else M
            for nr in (1, NRHS_K):
                X = torch.as_tensor(rng.standard_normal((B, K, nr),
                                                        dtype=np.float32),
                                    device=dev)
                Z = bmatvec(M, X, transpose)
                PZ = bmatvec_plain(M, X, transpose)
                torch.cuda.synchronize()
                d_, e = _rel_err(Z, PZ)
                _record(
                    rec, "bmatvec_t_inv" if transpose else "bmatvec_inv",
                    f"{what} (B,I,J,NR)=({B},{I},{J},{nr}) "
                    f"transpose={transpose}", e, d_,
                    _cuda_ms(lambda: bmatvec(M, X, transpose), 10, cold),
                    _cuda_ms(lambda: bmatvec_plain(M, X, transpose), 2,
                             cold),
                    4.0 * B * (I * J + K * nr + N * nr),
                    2.0 * B * I * J * nr,
                    library_ms=_cuda_ms(lambda: torch.bmm(Mk, X), 10, cold),
                    tol=K567_TOL)

    walls = {}
    for nr, (rhs, _xw2, _xcl) in refs.items():
        walls[nr] = {
            "inv": _quiet_best_s(lambda: sstt.solve(F, rhs, inv)),
            "inv_bmv": _quiet_best_s(lambda: sstt.solve(F, rhs, inv_k)),
            "w2": _quiet_best_s(lambda: sstt.solve(F, rhs, cfg)),
            "classic": _quiet_best_s(lambda: sstt.solve(F, rhs, classic))}
    out["steady_s"] = walls
    out["launches"] = {f"{nr}_{bmv}": c for (nr, bmv), c in launches.items()}
    w = ", ".join(f"nrhs {nr}: inv {v['inv']:.4f} / inv+K6 "
                  f"{v['inv_bmv']:.4f} / w2 {v['w2']:.4f} / classic "
                  f"{v['classic']:.4f} s" for nr, v in walls.items())
    print(f"inv on {out['card']}: K6 groups {out['k6_groups']}, launches "
          f"{out['launches']}; residuals "
          + ", ".join(f"{k} {v['residual']:.3e} (vs w2 {v['vs_w2']:.3e})"
                      for k, v in out.items() if k.startswith("nrhs"))
          + f"; state bytes {out['state_bytes']}; dispatched sweep "
          f"{out['dispatch_sweep_s']:.4f} s; steady {w}", flush=True)
    for key in list(P._solve):
        if key[0] == "inv":
            del P._solve[key]
    return out, rec


def _turns_s(fns: dict, reps: int = 3) -> dict:
    """{name: minimum seconds of reps calls of fns[name]} (CUDA events,
    collector off), the calls taken in turns, one of each a round, after
    one warm call each."""
    import torch

    for fn in fns.values():
        fn()
    best = {k: float("inf") for k in fns}
    gc.disable()
    try:
        for _ in range(reps):
            for k, fn in fns.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                best[k] = min(best[k], start.elapsed_time(end) / 1e3)
    finally:
        gc.enable()
    return best


def _plan_stats(plan) -> dict:
    groups = [g for gl in plan.groups for g in gl]
    return {"groups": len(groups), "classes": sum(len(g.pairs)
                                                  for g in groups),
            "cells": plan.dev_size}


def ladder_phase(A, S, F, refs: dict) -> dict:
    """The coarse solve plan (module docstring, item 17) on the main path's
    factor ``F`` of the model problem: the plans' sizes, the relayout of
    ``Lx`` (first and steady, bit-equal on the card to ``relayout_map``'s
    gather), and every sweep (w2, classic, inv) on the coarse plan and on
    the factor's own at 1 and 64 right-hand sides (``refs``: {nrhs: (b,
    the main path's w2 x)}). Returns the phase's numbers; every gate
    raises."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import supernodal_solve as ss

    dev = torch.device("cuda", 0)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    P = F.F
    out: dict = {"card": _card()}
    t_phase = time.perf_counter()
    assert ss.solve_ladder(P) == "coarse"
    dpc, relayout = ss._coarse_entry(S, P.dplan)
    plans = {"fine": P.dplan.plan, "coarse": dpc.plan}
    out["plans"] = {k: _plan_stats(p) for k, p in plans.items()}
    for k in plans:
        # the two sweeps' bound at nrhs 1 (steps, panel MB, rhs MB, MFLOP,
        # bound_ms)
        out["plans"][k]["solve_report"] = ss.solve_report(
            S, 1, 4, k).splitlines()[-1]
    print(f"solve plans on {out['card']}: {out['plans']}", flush=True)

    # the relayout of Lx, bit-equal to the reference's map on the card and
    # to the main path's copy
    t0 = time.perf_counter()
    lx2 = relayout(P.Lx)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    m = torch.as_tensor(ss.relayout_map(S, P.dplan.plan, dpc.plan),
                        device=dev).long()
    same = torch.equal(lx2, torch.cat([P.Lx, P.Lx.new_zeros(1)])[m])
    del m
    assert same, "the relayout differs from relayout_map"
    assert torch.equal(lx2, P._solve[("relayout",)][2])
    out["relayout"] = {
        "first_s": first, "steady_s": _best_s(lambda: relayout(P.Lx)),
        "bytes": lx2.numel() * lx2.element_size(), "equals_map": same}
    del lx2
    print(f"relayout: {out['relayout']}", flush=True)

    real = ss.solve_ladder

    def on_fine(call):
        """``call()`` with the solves held on the factor's own plan."""
        ss.solve_ladder = lambda _F: "fine"
        try:
            return call()
        finally:
            ss.solve_ladder = real

    modes = {"w2": "auto", "classic": "classic", "inv": "inv"}
    kern3_6 = ("solve_step_fwd", "solve_step_bwd", "batched_trisolve",
               "pmatvec_t", "bmatvec", "bmatvec_t")
    sweeps: dict = {}
    for nr, (rhs, x_ref) in refs.items():
        calls = {}
        for sw, mode in modes.items():
            c = cfg.replace(solve_mode=mode)
            calls[f"{sw}_coarse_{nr}"] = \
                lambda c=c, rhs=rhs: sstt.solve(F, rhs, c)
            calls[f"{sw}_fine_{nr}"] = \
                lambda c=c, rhs=rhs: on_fine(lambda: sstt.solve(F, rhs, c))
        for key, call in calls.items():
            sw, lad = key.split("_")[:2]
            zero_counts()
            t0 = time.perf_counter()
            x = call()
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            got = counts()
            k = {name: got[name] for name in kern3_6}
            assert sum(got.values()) == sum(k.values()), got
            if sw == "classic":
                assert k["solve_step_fwd"] == k["solve_step_bwd"] > 0, k
                assert lad == "fine" or k["solve_step_fwd"] == K3_GROUPS, k
            else:
                assert sum(k.values()) == 0, (key, k)
            # the sweep's state, built from the panels of its plan
            skey = {"w2": ("w2", torch.float32),
                    "classic": ("classic", torch.float32),
                    "inv": ss._inv_key(torch.float32, cfg)}[sw]
            src = P._solve[("relayout",)][2] if lad == "coarse" else P.Lx
            skey = skey if lad == "coarse" else skey + ("fine",)
            assert P._solve[skey][0] is src, key
            cols = [(x, rhs)] if nr == 1 else \
                [(x[:, j], rhs[:, j]) for j in (0, nr - 1)]
            resid = max(sstt.residual_norm(A, xc, bc) for xc, bc in cols)
            dx = np.abs(x - x_ref).max() / np.abs(x_ref).max()
            assert np.isfinite(x).all() and resid < RESID_TOL and \
                dx <= LADDER_X_TOL, (key, resid, dx)
            sweeps[key] = {"first_s": first, "residual": resid,
                           "vs_main_w2": dx, "launches": k}
        for key, sec in _turns_s(calls).items():
            sweeps[key]["steady_s"] = sec
    out["sweeps"] = sweeps
    for key, v in sweeps.items():
        print(f"solve plan sweep {key}: steady {v['steady_s']:.4f} s, first "
              f"{v['first_s']:.4f} s, residual {v['residual']:.3e}, x vs "
              f"main w2 {v['vs_main_w2']:.3e}, K3-K6 {v['launches']}",
              flush=True)
    for key in [k for k in P._solve if k[-1] == "fine"]:
        del P._solve[key]
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _sweep_ops(fn) -> tuple[float, int]:
    """(device busy seconds, device ops) of one call of ``fn`` under the
    profiler, counted as ``prof.solve_profile`` counts them."""
    import torch

    from suitesparse_tpu_torch import prof

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as p:
        fn()
        torch.cuda.synchronize()
    return prof._busy_s(p.events())


def route_phase(A, F, rhs: dict) -> dict:
    """The solve routes (module docstring, item 18) on the main path's
    factor ``F`` of the model problem; ``rhs``: {nrhs: b}. Returns the
    phase's numbers; every gate raises."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import supernodal_solve as ss

    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    P = F.F
    out: dict = {"card": _card()}
    t_phase = time.perf_counter()
    real = ss.solve_ladder
    cells = [(sw, "coarse", nr) for sw in ("w2", "inv") for nr in sorted(rhs)]
    cells.append(("w2", "fine", 1))
    for sw, ladder, nr in cells:
        c = cfg.replace(solve_mode="auto" if sw == "w2" else "inv")
        b = rhs[nr]
        key = f"{sw}_{ladder}_{nr}"
        calls, xs, first = {}, {}, {}
        for route in ss.ROUTES:
            if ladder == "fine":
                ss.solve_ladder = lambda _F: "fine"
            try:
                t0 = time.perf_counter()
                fn, args = ss._mf_dispatch(P, ss._rhs(b)[0], c, route)
                y = fn(*args)
                torch.cuda.synchronize()
                first[route] = time.perf_counter() - t0
            finally:
                ss.solve_ladder = real
            calls[route] = (lambda fn=fn, args=args: fn(*args))
            xs[route] = ss._finish(P, y, b.ndim == 1)
        cell = {}
        for route, x in xs.items():
            cols = [(x, b)] if nr == 1 else \
                [(x[:, j], b[:, j]) for j in (0, nr - 1)]
            resid = max(sstt.residual_norm(A, xc, bc) for xc, bc in cols)
            dx = np.abs(x - xs["sorted"]).max() / np.abs(xs["sorted"]).max()
            assert np.isfinite(x).all() and resid < RESID_TOL and \
                dx <= ROUTE_X_TOL, (key, route, resid, dx)
            cell[route] = {"first_s": first[route], "residual": resid,
                           "vs_sorted": dx}
        best = {route: float("inf") for route in ss.ROUTES}
        gc.disable()
        try:
            for _ in range(3):
                for route in ROUTE_TURNS:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    calls[route]()
                    end.record()
                    torch.cuda.synchronize()
                    best[route] = min(best[route],
                                      start.elapsed_time(end) / 1e3)
        finally:
            gc.enable()
        for route in ss.ROUTES:
            cell[route]["wall_s"] = best[route]
            if nr == 1:
                busy, nops = _sweep_ops(calls[route])
                cell[route].update(device_busy_s=busy, device_ops=nops)
            print(f"route {key} {route}: wall {best[route]:.5f} s, first "
                  f"{first[route]:.4f} s, "
                  + (f"device ops {cell[route]['device_ops']}, busy "
                     f"{cell[route]['device_busy_s']:.5f} s, " if nr == 1
                     else "")
                  + f"residual {cell[route]['residual']:.3e}, x vs sorted "
                  f"{cell[route]['vs_sorted']:.3e}", flush=True)
        out[key] = cell
    # the rule for the default route: a route at or below sorted's wall in
    # every w2 and inv cell of the coarse plan
    coarse = [k for k in out if "_coarse_" in k]
    out["at_or_below_sorted"] = {
        route: all(out[k][route]["wall_s"] <= out[k]["sorted"]["wall_s"]
                   for k in coarse) for route in ("fused", "merged")}
    print(f"routes at or below sorted's wall in all {len(coarse)} coarse "
          f"cells: {out['at_or_below_sorted']}", flush=True)
    for key in [k for k in P._solve if k[-1] == "fine"]:
        del P._solve[key]
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _k2_device_ms(fn) -> dict:
    """K2's device milliseconds in one call of ``fn``, by tile width, from
    the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as p:
        fn()
        torch.cuda.synchronize()
    ms = {"128": 0.0, "256": 0.0}
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "extend_add_tiles_kernel" in e.name:
            width = "256" if "extend_add_tiles_kernel<256" in e.name \
                else "128"
            ms[width] += (e.time_range.end - e.time_range.start) / 1e3
    return ms


def wide_tile_phase(A, S, F, dev, rng) -> tuple[dict, dict, dict]:
    """256-wide tiles (module docstring, item 19) on the model problem's
    analysis ``S`` and the main path's factor ``F``. Returns (the phase's
    numbers, K2's kernel row at T = 256, the wide factor's launches);
    every gate raises."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels.extend_add_tiles import (
        build_group_manifest, extend_add_tiles, extend_add_tiles_plain,
        manifest_work, run_ptr, synthetic_group, tile_geometry)
    from suitesparse_tpu_torch.numeric import supernodal_device as sd
    from suitesparse_tpu_torch.numeric import supernodal_solve as ss

    out: dict = {"card": _card()}
    t_phase = time.perf_counter()
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    t0 = time.perf_counter()
    dpw = sd.device_plan(A, S, dev, tile_big=WIDE_BIG)
    out["plan_s"] = time.perf_counter() - t0
    dp = F.F.dplan
    pairs = [(g0, g) for g0, g in zip(
        (g for gl in dp.plan.groups for g in gl),
        (g for gl in dpw.plan.groups for g in gl))
        if g._tile is not None and g._tile.rowmap.shape[-1] == 256]
    assert len(pairs) == WIDE_GROUPS and \
        all(g.R >= WIDE_BIG for _g0, g in pairs), len(pairs)
    out["groups"] = [(g.B, g.R, g.C) for _g0, g in pairs]
    for name, gs in (("t128", [g0 for g0, _g in pairs]),
                     ("t256", [g for _g0, g in pairs])):
        out[name] = {
            "steps": sum(g._tile.man.shape[0] for g in gs),
            "tiles": sum(len(g._tile_runs) - 1 for g in gs),
            "ucat_cells": sum(max(g._tile.nslots, 1) * g._tile.RUp ** 2
                              for g in gs),
            # K2's bound on these groups, summed (ms)
            "bound_ms": sum(_bound(*manifest_work(g._tile, g._tile_runs,
                                                  g.R))[0] for g in gs)}
    print(f"wide tiles on {out['card']}: {WIDE_GROUPS} groups with R >= "
          f"{WIDE_BIG} {out['groups']}; T = 128 {out['t128']}, T = 256 "
          f"{out['t256']}; plan_s {out['plan_s']:.2f}", flush=True)

    # K2 at T = 256 on the largest wide manifest, its two-piece form
    g = max((g for _g0, g in pairs), key=lambda g: g._tile.man.shape[0])
    tm = g._tile
    pm = build_group_manifest(g, T=256, ru_min_frac=0.0, npiece=2)
    F0 = torch.as_tensor(rng.standard_normal((g.B, g.R, g.R),
                                             dtype=np.float32), device=dev)
    U = rng.standard_normal((max(tm.nslots, 1), tm.RUp, tm.RUp),
                            dtype=np.float32)
    U[(rng.random(U.shape, dtype=np.float32) < 0.05)
      & np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)] = np.nan
    U = torch.as_tensor(U, device=dev)
    args = {k: tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                     for a in (m.man, m.rowmap, m.colmap, run_ptr(m.man)))
            for k, m in (("one", tm), ("pair", pm))}
    got = [extend_add_tiles(F0.clone(), U, *args[k])
           for k in ("one", "one", "pair")]
    Fp = extend_add_tiles_plain(F0.clone(), U, *args["one"][:3])
    torch.cuda.synchronize()
    dabs, err = _rel_err(got[0], Fp)
    assert np.isfinite(err) and err <= K2_TOL, f"K2 at T = 256: {err}"
    assert torch.equal(got[0], got[1]), "K2 at T = 256: two calls differ"
    assert torch.equal(got[0], got[2]), \
        "K2b at T = 256 differs from K2 at T = 256"
    ms = _cuda_ms(lambda F: extend_add_tiles(F, U, *args["one"]), 10,
                  setup=lambda: (F0.clone(),))
    pair_ms = _cuda_ms(lambda F: extend_add_tiles(F, U, *args["pair"]), 10,
                       setup=lambda: (F0.clone(),))
    plain_ms = _cuda_ms(lambda F: extend_add_tiles_plain(
        F, U, *args["one"][:3]), 3, setup=lambda: (F0.clone(),))
    pair_plain_ms = _cuda_ms(lambda F: extend_add_tiles_plain(
        F, U, *args["pair"][:3]), 3, setup=lambda: (F0.clone(),))
    bound_ms, bound_by = _bound(*manifest_work(tm, g._tile_runs, g.R))
    pair_bound_ms = _bound(*manifest_work(pm, run_ptr(pm.man), g.R))[0]
    nruns = len(g._tile_runs) - 1
    geo = tile_geometry(nruns, g.R, tm.RUp, 1, T=256)
    print(f"extend_add_tiles_wide (B,R)=({g.B},{g.R}) steps="
          f"{tm.man.shape[0]} tiles={nruns} RUp={tm.RUp} {geo} "
          f"rel_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}); two-piece "
          f"steps={pm.man.shape[0]} kernel_ms={pair_ms:.4f} plain_ms="
          f"{pair_plain_ms:.4f} bound_ms={pair_bound_ms:.4f}, bit-equal",
          flush=True)
    k2w = {"err": err, "abs": dabs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "pair_ms": pair_ms, "pair_plain_ms": pair_plain_ms,
           "pair_bound_ms": pair_bound_ms,
           "shape": (g.B, g.R, tm.man.shape[0])}

    # both forms off the plan
    for B, R, classes in K2_WIDE_OFF_PLAN:
        sg = synthetic_group(rng, B, R, classes)
        ms_ = {k: build_group_manifest(sg, T=256, ru_min_frac=0.0,
                                       npiece=n) for k, n in (("one", 1),
                                                              ("pair", 2))}
        m1 = ms_["one"]
        G0 = torch.as_tensor(rng.standard_normal((B, R, R),
                                                 dtype=np.float32),
                             device=dev)
        V = rng.standard_normal((m1.nslots, m1.RUp, m1.RUp),
                                dtype=np.float32)
        V[(rng.random(V.shape) < 0.05)
          & np.triu(np.ones((m1.RUp, m1.RUp), bool), 1)] = np.nan
        V = torch.as_tensor(V, device=dev)
        res = []
        for k in ("one", "one", "pair", "pair"):
            m = ms_[k]
            a = tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                      for x in (m.man, m.rowmap, m.colmap, run_ptr(m.man)))
            res.append(extend_add_tiles(G0.clone(), V, *a))
        Vp = extend_add_tiles_plain(G0.clone(), V, *a[:3])
        torch.cuda.synchronize()
        d, e = _rel_err(res[0], Vp)
        assert np.isfinite(e) and e <= K2_TOL, (B, R, e)
        assert all(torch.equal(res[0], r) for r in res[1:]), (B, R)
        k2w["err"], k2w["abs"] = max(k2w["err"], e), max(k2w["abs"], d)
        runs = run_ptr(m1.man)
        print(f"extend_add_tiles_wide off plan (B,R)=({B},{R}) classes="
              f"{classes} steps={m1.man.shape[0]} tiles={len(runs) - 1} "
              f"{tile_geometry(len(runs) - 1, R, m1.RUp, 1, T=256)} "
              f"rel_err={e:.3e}; reruns and both forms bit-equal",
              flush=True)

    # the factor with tile_big, in turns with the default factor
    n128 = sum(g._tile is not None and g._tile.rowmap.shape[-1] == 128
               for gl in dpw.plan.groups for g in gl)
    zero_counts()
    Fw = sd.factorize_device(A, S, cfg, dev, tile_big=WIDE_BIG)
    torch.cuda.synchronize()
    launches = counts()
    assert Fw.ok, f"wide-tile factor failed at column {Fw.minor}"
    assert launches["extend_add_tiles_wide"] == WIDE_GROUPS and \
        launches["extend_add_tiles"] == n128 and \
        launches["extend_add_tiles_pair_wide"] == 0, launches
    lx = F.F.Lx
    lx_err = ((Fw.Lx - lx).abs().max() / lx.abs().max()).item()
    assert lx_err <= WIDE_LX_TOL, lx_err
    b = 1.0 + np.arange(A.ncol) / A.ncol
    x = ss.solve_device(Fw, b, cfg)
    resid = sstt.residual_norm(A, x, b)
    assert np.isfinite(x).all() and resid < RESID_TOL, resid
    walls = _turns_s({
        "default": lambda: sd.factorize_device(A, S, cfg, dev),
        "wide": lambda: sd.factorize_device(A, S, cfg, dev,
                                            tile_big=WIDE_BIG)})
    k2_ms = {"default": _k2_device_ms(
        lambda: sd.factorize_device(A, S, cfg, dev)),
        "wide": _k2_device_ms(lambda: sd.factorize_device(
            A, S, cfg, dev, tile_big=WIDE_BIG))}
    out.update(factor={"launches": launches, "lx_rel_err": lx_err,
                       "lx_bit_equal": bool(torch.equal(Fw.Lx, lx)),
                       "residual": resid, "wall_s": walls,
                       "k2_device_ms": k2_ms},
               phase_s=time.perf_counter() - t_phase)
    print(f"wide-tile factor: launches={launches}, Lx vs default "
          f"{lx_err:.3e} (bit-equal {out['factor']['lx_bit_equal']}), "
          f"residual {resid:.3e}, wall default {walls['default']:.4f} s / "
          f"wide {walls['wide']:.4f} s, K2 device ms a factor default "
          f"{k2_ms['default']} / wide {k2_ms['wide']}", flush=True)
    del Fw
    return out, k2w, launches


def mflu_sym_phase() -> dict:
    """The symmetric-strategy device LU (``numeric/mflu_device.py``) on
    the LU phase's ``fem_unsym(30)`` (module docstring, item 14): the
    analysis, then ``factorize_lu_device`` and ``solve_mflu_device`` in
    fp32 and fp64, each factor's residual under ``LU_SYM_TOL`` and its x
    against the host KLU ``lusol``'s within ``LU_SYM_X_TOL``; the fp64 x
    of ``fem_unsym(LU_SYM_HOST_NX)`` against the host ``mflusol``'s (the
    symmetric strategy on the host, a Python loop over the supernodes: too
    slow for the phase at n = 27,000).
    Prints the analysis, the first and steady factor and solve seconds and
    the peak memory."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import mflu_device, multifrontal_lu

    dev = torch.device("cuda", 0)
    out = {"card": _card()}
    A = sstt.fixtures.fem_unsym(LU_NX)
    n = A.ncol
    b = np.ones(n)
    t0 = time.perf_counter()
    S = multifrontal_lu.analyze_mflu(A)
    out["analyze_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xk = sstt.lusol(A, b)
    out["host_lusol_s"] = time.perf_counter() - t0
    for dtype in ("float32", "float64"):
        cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        F = mflu_device.factorize_lu_device(A, S, cfg, dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        assert F.ok and F.Lpanels.device.type == dev.type, F.minor
        t0 = time.perf_counter()
        x = mflu_device.solve_mflu_device(F, b)
        torch.cuda.synchronize()
        first_solve_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        resid = sstt.residual_norm(A, x, b)
        dx = np.abs(x - xk).max() / np.abs(xk).max()
        assert np.isfinite(x).all() and resid < LU_SYM_TOL[dtype] and \
            dx < LU_SYM_X_TOL[dtype], (dtype, resid, dx)
        factor_s = _quiet_best_s(
            lambda: mflu_device.factorize_lu_device(A, S, cfg, dev))
        solve_s = _quiet_best_s(lambda: mflu_device.solve_mflu_device(F, b))
        groups = F.groups
        out[dtype] = {"first_factor_s": first_s, "first_solve_s": first_solve_s,
                      "factor_s": factor_s, "solve_s": solve_s,
                      "residual": resid, "vs_lusol": dx, "peak_mem_gb": peak}
        del F
    out.update(n=n, nsuper=S.nsuper, levels=len(S.levels),
               groups=len(groups),
               panel_cells=S._mflu_dev_plan.dev_size,
               largest_front=max(g.R for g in groups))
    Ah = sstt.fixtures.fem_unsym(LU_SYM_HOST_NX)
    bh = np.ones(Ah.ncol)
    t0 = time.perf_counter()
    xh = multifrontal_lu.mflusol(Ah, bh)
    out["host_mflusol_s"] = time.perf_counter() - t0
    Fh = mflu_device.factorize_lu_device(
        Ah, multifrontal_lu.analyze_mflu(Ah),
        sstt.DEFAULT.replace(compute_dtype="float64"), dev)
    xd = mflu_device.solve_mflu_device(Fh, bh)
    out["small_vs_host_mflusol"] = dh = \
        np.abs(xd - xh).max() / np.abs(xh).max()
    assert dh < LU_SYM_X_TOL["float64"], dh
    print(f"mflu_sym on {out['card']}: fem_unsym({LU_NX}) n={n}, "
          f"{out['nsuper']} supernodes, {out['groups']} groups, "
          f"{out['panel_cells']} panel cells, largest front "
          f"{out['largest_front']}; analyze {out['analyze_s']:.3f} s, host "
          f"lusol {out['host_lusol_s']:.3f} s; "
          + "; ".join(f"{k}: first factor {v['first_factor_s']:.3f} s, "
                      f"factor {v['factor_s']:.4f} s, solve "
                      f"{v['solve_s']:.4f} s, residual {v['residual']:.3e}, "
                      f"x vs lusol {v['vs_lusol']:.3e}, peak "
                      f"{v['peak_mem_gb']:.3f} GB"
                      for k, v in out.items() if k.startswith("float"))
          + f"; fem_unsym({LU_SYM_HOST_NX}) x vs host mflusol {dh:.3e} "
          f"(host {out['host_mflusol_s']:.3f} s)", flush=True)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sha(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _with_negative_diagonal(A, col: int, value: float):
    """A copy of upper-stored A whose diagonal entry at ``col`` is
    ``value``."""
    import suitesparse_tpu_torch as sstt

    lo, hi = A.indptr[col], A.indptr[col + 1]
    data = A.data.copy()
    data[lo + int(np.flatnonzero(A.indices[lo:hi] == col)[0])] = value
    return sstt.sparse.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, A.sym)


def _dist_kernels(rp, dev) -> dict:
    """K1 at the rank's largest gated leaf group and K7 on its cut work
    list with the most cells (:func:`_k1_k7_rows`)."""
    import torch

    from suitesparse_tpu_torch.numeric.supernodal_device import \
        _use_potrf_kernel

    st = max((s for s in rp.leaf
              if _use_potrf_kernel(torch.float32, s.shape.B, s.shape.C)),
             key=lambda s: s.shape.B * s.shape.R * s.shape.C)
    shape_of = {s.key: s.shape for s in rp.leaf + rp.mid}
    _base, _B, _R, work = max(rp.f1_cut + rp.f0_cut,
                              key=lambda c: c[3].cells)
    return _k1_k7_rows("dist", (st.shape.B, st.shape.C,
                                st.shape.R - st.shape.C), work,
                       {k: (shape_of[k].B, shape_of[k].R - shape_of[k].C)
                        for k in work.keys}, "cut placement", dev)


def _k1_k7_rows(tag: str, k1_shape, work, u_shape: dict, where: str,
                dev) -> dict:
    """K1 at ``k1_shape`` (B, C, RU) and K7 on ``work`` (its classes'
    update blocks of ``u_shape[key]`` = (B, RU), random) against their
    plain versions (the kernel phase's tolerances), timed beside them, the
    library call and the bound: the records ``potrf_trsm_<tag>`` and
    ``extend_add_<tag>``."""
    import dataclasses as dc

    import torch

    from suitesparse_tpu_torch.kernels.extend_add import (
        class_maps, extend_add_group, extend_add_group_plain,
        extend_add_library, group_work)
    from suitesparse_tpu_torch.kernels.potrf import potrf_trsm, \
        potrf_trsm_plain
    from suitesparse_tpu_torch.kernels.potrf_sweep import (
        bound_ms as k1_bound_ms, library_route, tiles as k1_tiles)

    rng = np.random.default_rng(SEED)
    rec: dict = {}
    B, C, RU = k1_shape
    f11, f21 = k1_tiles(rng, B, C, RU, dev)
    L11, L21 = potrf_trsm(f11, f21)
    P11, P21 = potrf_trsm_plain(f11, f21)
    d, err = _rel_err(L11, P11)
    if RU:
        d21, e21 = _rel_err(L21, P21)
        d, err = max(d, d21), max(err, e21)
    assert np.isfinite(err) and err <= K1_TOL, err
    ms = _cuda_ms(lambda: potrf_trsm(f11, f21), 10)
    plain_ms = _cuda_ms(lambda: potrf_trsm_plain(f11, f21), 2)
    library_ms = _cuda_ms(lambda: library_route(f11, f21), 10)
    bound, by = k1_bound_ms(B, C, RU)
    name = f"potrf_trsm_{tag}"
    print(f"{name} (B,C,RU)=({B},{C},{RU}) rel_err={err:.3e} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} "
          f"({by}) library_ms={library_ms:.4f}", flush=True)
    rec[name] = {"err": err, "abs": d, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
                 "shape": [B, C, RU]}

    B, R = work.B, work.R
    Us = [torch.as_tensor(rng.standard_normal(
        (u_shape[k][0], u_shape[k][1], u_shape[k][1]), dtype=np.float32),
        device=dev) for k in work.keys]
    F0 = torch.as_tensor(rng.standard_normal((B, R, R), dtype=np.float32),
                         device=dev)
    Fk = extend_add_group(F0.clone(), Us, work)
    Fp = extend_add_group_plain(F0.clone(), Us, work)
    assert torch.equal(Fk, extend_add_group(F0.clone(), Us, work))
    d, err = _rel_err(Fk, Fp)
    host = dc.replace(work, idx=work.idx.cpu().numpy(),
                      dst=work.dst.cpu().numpy(), src=work.src.cpu().numpy(),
                      parts=[(c0, c1, b.cpu().numpy())
                             for c0, c1, b in work.parts])
    maps = [class_maps(work, c) for c in range(len(Us))]

    def library(Fl):
        for U, (idx, dst, src) in zip(Us, maps):
            extend_add_library(Fl, U, idx, dst, R, src)

    Fl0 = torch.cat([F0.reshape(-1), F0.new_zeros(1)])
    Fl = Fl0.clone()
    library(Fl)
    assert _rel_err(Fl[:-1].view(B, R, R), Fp)[1] <= K567_TOL
    name = f"extend_add_{tag}"
    _record(rec, name,
            f"{where} (B,R)=({B},{R}) classes={len(Us)} "
            f"band={work.geom.rows} cells={work.cells}, two calls bit-equal",
            err, d,
            _cuda_ms(lambda F: extend_add_group(F, Us, work), 10,
                     setup=lambda: (F0.clone(),)),
            _cuda_ms(lambda F: extend_add_group_plain(F, Us, work), 3,
                     setup=lambda: (F0.clone(),)),
            *group_work(host, 4),
            library_ms=_cuda_ms(library, 3, setup=lambda: (Fl0.clone(),)),
            tol=K567_TOL)
    rec[name]["shape"] = [B, R, len(Us), work.cells]
    return rec


def _dist_rank(spec: dict, rank: int, out_dir: str) -> None:
    """One rank of a ``dist_phase`` run (spawned): the distributed factor
    and solves, every gate this rank can check, its record as JSON."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels import _build
    from suitesparse_tpu_torch.numeric import (supernodal_device,
                                               supernodal_solve)
    from suitesparse_tpu_torch.parallel import diag, dist2
    from suitesparse_tpu_torch.parallel import multihost as mh
    from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

    mh.initialize(f"tcp://localhost:{spec['port']}", spec["world"], rank,
                  spec["backend"], timeout=DIST_TIMEOUT_S)
    _build.load()       # built by the parent before it spawned the ranks
    topo = mh.host_chip_mesh(*spec["layout"])
    dev = topo.device
    A = sstt.fixtures.laplacian_3d(spec["nx"])
    if spec.get("neg") is not None:
        A = _with_negative_diagonal(A, spec["neg"], DIST_NEG)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS,
                               compute_dtype=spec["dtype"])
    S = analyze_supernodal(A, spec["perm"], cfg)
    dtype = torch.float64 if spec["dtype"] == "float64" else torch.float32
    rec = {"rank": rank, "device": str(dev), "host": topo.host,
           "chip": topo.chip}
    t0 = time.perf_counter()
    rp = dist2.rank_plan(A, S, topo)
    rec["plan_s"] = time.perf_counter() - t0
    zero_counts()
    F = dist2.dist_factorize_v2(A, S, topo, cfg)
    torch.cuda.synchronize(dev)
    c = counts()
    rec["launches"] = {"potrf_trsm": c["potrf_trsm"],
                       "extend_add": c["extend_add"] + c["extend_add_f64"]}
    pred = dist2.predicted_launches(rp, dtype)
    rec["predicted"] = {"potrf_trsm": pred["potrf_trsm"],
                        "extend_add": pred.get("extend_add",
                                               pred.get("extend_add_f64"))}
    rec["minor"] = int(F.minor)
    rec["first_factor_s"] = F.dist.seconds
    rec["lx_sha"] = _sha(F.Lx.cpu().numpy())
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    if F.ok:
        F = dist2.dist_factorize_v2(A, S, topo, cfg)     # steady phases
        rec["factor_s"] = F.dist.seconds
        rec["census"] = diag.collective_census(F)["factor"]
        B8 = np.tile(b.reshape(-1, 1), (1, NRHS_K)) * \
            (1.0 + np.arange(NRHS_K) / NRHS_K)
        x1 = dist2.dist_solve_v2(F, b, cfg)     # builds routing, panels
        rec["first_solve_s"] = F.dist.solve_seconds
        x1 = dist2.dist_solve_v2(F, b, cfg)
        rec["solve1_s"] = F.dist.solve_seconds
        x8 = dist2.dist_solve_v2(F, B8, cfg)
        rec["solve8_s"] = F.dist.solve_seconds
        rec["solve_census"] = diag.collective_census(F)["solve"]
        rec["x_sha"] = [_sha(x1), _sha(x8)]
        if rank == 0:
            rec["residual"] = max(
                [sstt.residual_norm(A, x1, b)]
                + [sstt.residual_norm(A, x8[:, k], B8[:, k])
                   for k in (0, NRHS_K - 1)])
            xd = supernodal_solve.solve_device(F, b, cfg)
            rec["solve_device_residual"] = sstt.residual_norm(A, xd, b)
            Fs = supernodal_device.factorize_device(A, S, cfg, dev)
            ref = Fs.lx_host()
            rec["lx_err"] = float(np.abs(F.lx_host() - ref).max()
                                  / np.abs(ref).max())
            del Fs
    elif rank == 0:
        rec["single_minor"] = int(
            supernodal_device.factorize_device(A, S, cfg, dev).minor)
    if rank == 0 and spec.get("kernels"):
        rec["kernels"] = _dist_kernels(rp, dev)
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f, default=float)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


def _spawn_ranks(spec: dict, world: int, out_dir: str,
                 target=None) -> list:
    """Run ``world`` ranks of ``target`` (default :func:`_dist_rank`;
    spawn: CUDA cannot fork); a rank that fails or outlasts DIST_JOIN_S
    fails the run, and every rank is stopped. Returns the ranks'
    records."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or _dist_rank,
                         args=(spec, r, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_JOIN_S
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            assert not bad, f"dist run {spec['name']}: rank(s) {bad} failed"
            assert time.monotonic() < deadline, \
                f"dist run {spec['name']}: ranks hung past {DIST_JOIN_S} s"
            time.sleep(0.2)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, \
            f"dist run {spec['name']}: exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    recs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def dist_phase(perm50) -> tuple[dict, dict, dict]:
    """The distributed factor and solve on the card (``parallel/``).

    The parent builds the kernels; ranks start by ``spawn``. Runs:
    (a) world 1 over NCCL, flat, the model problem; (b) 4 ranks over gloo
    on cuda:0, (host, chip) = (2, 2), the model problem; (c) 4 ranks
    flat, fp64, ``laplacian_3d(30)``; (d) 2 ranks on ``laplacian_3d(12)``
    with one negative diagonal entry in a leaf subtree of rank 1. Gates:
    lx_host() within DIST_LX_TOL of the single-card factor on the same
    analysis, every rank's Lx and x bit-equal to rank 0's, the distributed
    solve's residual at nrhs 1 and 8 and the single-card solve of the
    distributed factor below DIST_RESID_TOL, (d)'s minor on every rank
    equal to the single-card factor's, the census (one halo sum, or one
    host and one world sum, before the crown; one assembly sum; two sums
    a solve), and K1 and K7 launched on every rank as often as its plan
    predicts. K1 and K7 are held against their plain versions on (b)'s
    rank 0. Returns (summary, kernel records, launches)."""
    import tempfile

    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.parallel import multihost as mh
    from suitesparse_tpu_torch.parallel.schedule import partition_tree
    from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

    from suitesparse_tpu_torch.kernels import _build

    _build.load()       # before any rank starts: the ranks only load it
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"dist: compute mode {mode}", flush=True)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        mh.initialize("tcp://localhost:1", 4, 0, "nccl")
        raise AssertionError("NCCL with four ranks on one card was accepted")
    except ValueError as e:
        print(f"dist: NCCL with ranks sharing the card raises: {e}",
              flush=True)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    perm30 = sstt.analyze(sstt.fixtures.laplacian_3d(30), cfg).perm
    A12 = sstt.fixtures.laplacian_3d(12)
    perm12 = sstt.analyze(A12, cfg).perm
    S12 = analyze_supernodal(A12, perm12, cfg)
    s = int(np.flatnonzero(partition_tree(S12, 2).own == 1)[0])
    neg = int(S12.perm[S12.super_first[s]])
    runs = [
        dict(name="a", world=1, backend="nccl", layout=(None, None),
             nx=SIZE, perm=perm50, dtype="float32"),
        dict(name="b", world=4, backend="gloo", layout=(2, 2), nx=SIZE,
             perm=perm50, dtype="float32", kernels=True),
        dict(name="c", world=4, backend="gloo", layout=(1, 4),
             nx=30, perm=perm30, dtype="float64"),
        dict(name="d", world=2, backend="gloo", layout=(1, 2), nx=12,
             perm=perm12, dtype="float32", neg=neg),
    ]
    torch.cuda.empty_cache()
    summary, krec = {}, {}
    launches = {"potrf_trsm": 0, "extend_add": 0}
    for spec in runs:
        spec["port"] = _free_port()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out_dir:
            recs = _spawn_ranks(spec, spec["world"], out_dir)
        wall = time.perf_counter() - t0
        r0 = recs[0]
        for r in recs:
            assert r["launches"] == r["predicted"], (spec["name"], r)
            assert r["lx_sha"] == r0["lx_sha"], (spec["name"], r["rank"])
        if spec["name"] == "d":
            minors = [r["minor"] for r in recs]
            assert minors == [r0["single_minor"]] * 2 and minors[0] < \
                spec["nx"] ** 3, minors
            summary["d"] = {"minor": minors, "wall_s": wall}
            print(f"dist (d) indefinite, 2 ranks: minor {minors} on every "
                  f"rank = the single-card factor's, wall {wall:.2f} s",
                  flush=True)
            continue
        fp64 = spec["dtype"] == "float64"
        for r in recs:
            assert r["x_sha"] == r0["x_sha"], (spec["name"], r["rank"])
            if spec["dtype"] == "float32":
                assert r["launches"]["potrf_trsm"] > 0 and \
                    r["launches"]["extend_add"] > 0, (spec["name"], r)
                for k in launches:
                    launches[k] += r["launches"][k]
            want = {"halo": ("world", 1), "assembly": ("world", 1)}
            if spec["layout"] == (2, 2):
                want = {"mid_halo": ("host", 1), "crown_halo": ("world", 1),
                        "assembly": ("world", 1)}
            assert {k: (v["group"], v["count"])
                    for k, v in r["census"].items()} == want, r["census"]
            assert {k: (v["group"], v["count"])
                    for k, v in r["solve_census"].items()} == \
                {"solve_up": ("world", 1), "solve_x": ("world", 1)}
        lx_tol = DIST_LX_TOL[spec["dtype"]]
        rtol = DIST_RESID_TOL[spec["dtype"]]
        assert r0["lx_err"] <= lx_tol and r0["residual"] < rtol and \
            r0["solve_device_residual"] < (rtol if fp64 else RESID_TOL), r0
        summary[spec["name"]] = {
            k: r0[k] for k in ("plan_s", "first_factor_s", "factor_s",
                               "first_solve_s", "solve1_s", "solve8_s",
                               "census",
                               "solve_census", "lx_err", "residual",
                               "solve_device_residual")}
        summary[spec["name"]].update(
            wall_s=wall, peaks_gb=[r["peak_gb"] for r in recs],
            launches=[r["launches"] for r in recs])
        print(f"dist ({spec['name']}) world {spec['world']} "
              f"{spec['backend']} layout {spec['layout']} nx {spec['nx']} "
              f"{spec['dtype']}: lx_err {r0['lx_err']:.3e} residual "
              f"{r0['residual']:.3e} (solve_device "
              f"{r0['solve_device_residual']:.3e}); rank 0 seconds plan "
              f"{r0['plan_s']:.3f}, factor {r0['factor_s']} (first "
              f"{r0['first_factor_s']}), solve nrhs 1 {r0['solve1_s']:.4f} "
              f"(first {r0['first_solve_s']:.4f}) / {NRHS_K} "
              f"{r0['solve8_s']:.4f}; sums {r0['census']} / "
              f"{r0['solve_census']}; launches {[r['launches'] for r in recs]}"
              f"; peaks GB {[round(r['peak_gb'], 3) for r in recs]}; wall "
              f"{wall:.2f} s", flush=True)
        if "kernels" in r0:
            krec = r0["kernels"]
    return summary, krec, launches


def _mesh_rank(spec: dict, rank: int, out_dir: str) -> None:
    """One rank of a ``mesh_phase`` run (spawned): the (tree, panel) mesh
    factor, first call and steady (min of 3), its sums, launches and
    peak, the single-card solve of its factor, and on rank 0 the
    single-card factor on the same analysis; its record as JSON."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels import _build
    from suitesparse_tpu_torch.numeric import (supernodal_device,
                                               supernodal_solve)
    from suitesparse_tpu_torch.parallel import diag, dist
    from suitesparse_tpu_torch.parallel import multihost as mh
    from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

    mh.initialize(f"tcp://localhost:{spec['port']}", spec["world"], rank,
                  spec["backend"], timeout=DIST_TIMEOUT_S)
    _build.load()       # built by the parent before it spawned the ranks
    mesh = dist.make_solver_mesh(*spec["mesh"])
    dev = mesh.device
    A = sstt.fixtures.laplacian_3d(spec["nx"])
    if spec.get("neg") is not None:
        A = _with_negative_diagonal(A, spec["neg"], DIST_NEG)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS,
                               compute_dtype=spec["dtype"])
    S = analyze_supernodal(A, spec["perm"], cfg)
    dtype = torch.float64 if spec["dtype"] == "float64" else torch.float32
    rec = {"rank": rank, "device": str(dev), "tp": [mesh.t, mesh.p]}
    t0 = time.perf_counter()
    mp = dist.mesh_plan(A, S, mesh)
    rec["plan_s"] = time.perf_counter() - t0
    rec["axes"] = {ax or "replicated": sum(st.axis == ax for st in mp.steps)
                   for ax in ("tree", "panel", None)}
    zero_counts()
    t0 = time.perf_counter()
    F = dist.dist_factorize_device(A, S, mesh, cfg)
    torch.cuda.synchronize(dev)
    rec["first_s"] = time.perf_counter() - t0
    c = counts()
    rec["launches"] = {"potrf_trsm": c["potrf_trsm"],
                       "extend_add": c["extend_add"] + c["extend_add_f64"]}
    pred = dist.predicted_launches(mp, dtype)
    rec["predicted"] = {"potrf_trsm": pred["potrf_trsm"],
                        "extend_add": pred.get("extend_add",
                                               pred.get("extend_add_f64"))}
    rec["minor"] = int(F.minor)
    rec["lx_sha"] = _sha(F.Lx.cpu().numpy())
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    if F.ok:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            F = dist.dist_factorize_device(A, S, mesh, cfg)
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        rec["factor_s"] = min(walls)
        rec["seconds"] = F.dist.seconds
        rec["census"] = diag.collective_census(F)["factor"]
        x = supernodal_solve.solve_device(F, b, cfg)
        rec["residual"] = sstt.residual_norm(A, x, b)
        if rank == 0:
            Fs = supernodal_device.factorize_device(A, S, cfg, dev)
            ref = Fs.lx_host()
            rec["lx_err"] = float(np.abs(F.lx_host() - ref).max()
                                  / np.abs(ref).max())
            rec["single_factor_s"] = _best_s(
                lambda: supernodal_device.factorize_device(A, S, cfg, dev))
            del Fs
    elif rank == 0:
        rec["single_minor"] = int(
            supernodal_device.factorize_device(A, S, cfg, dev).minor)
    if rank == 0 and spec.get("kernels"):
        from suitesparse_tpu_torch.numeric.supernodal_device import \
            _use_potrf_kernel

        g_of = {st.key: st.g for st in mp.steps}
        k1 = max((st for st in mp.steps if st.axis == "tree" and
                  st.ix is not None and
                  _use_potrf_kernel(torch.float32, st.g.B, st.g.C)),
                 key=lambda st: st.shape.B * st.g.R * st.g.C)
        k7 = max((st for st in mp.steps
                  if st.ix is not None and st.ix.k7_all is not None),
                 key=lambda st: st.ix.k7_all.cells)
        work = k7.ix.k7_all
        rec["kernels"] = _k1_k7_rows(
            "mesh", (k1.shape.B, k1.g.C, k1.g.R - k1.g.C), work,
            {k: (g_of[k].B, g_of[k].R - g_of[k].C) for k in work.keys},
            f"{k7.axis or 'replicated'} group", dev)
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f, default=float)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


def mesh_phase(perm50) -> tuple[dict, dict, dict]:
    """The sharded (tree, panel) factor on the card (``parallel/dist.py``).

    The parent builds the kernels; ranks start by ``spawn``. Runs: (a)
    world 1 over NCCL, mesh (1, 1), the model problem; (b) 4 ranks over
    gloo on cuda:0, mesh (2, 2), the model problem; (c) 4 ranks, mesh (1,
    4), fp64, ``laplacian_3d(30)`` (the panel axis alone); (d) mesh (2,
    1) on ``dist_phase``'s indefinite ``laplacian_3d(12)``. Gates:
    ``lx_host()`` within DIST_LX_TOL of the single-card factor on the same
    analysis, every rank's ``Lx`` bit-equal to rank 0's, the single-card
    solve of each rank's factor below DIST_RESID_TOL, (d)'s minor on every
    rank the single-card factor's, the census (one assembly sum; a tree
    gather a tree-sharded group with a parent; an L21 and a U gather a
    panel-sharded one), and K1 and K7 launched on every rank as often as
    its share of the plan predicts. K1 and K7 are held against their plain
    versions on (b)'s rank 0. Returns (summary, kernel records,
    launches)."""
    import tempfile

    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels import _build
    from suitesparse_tpu_torch.parallel.schedule import partition_tree
    from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

    _build.load()       # before any rank starts: the ranks only load it
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    perm30 = sstt.analyze(sstt.fixtures.laplacian_3d(30), cfg).perm
    A12 = sstt.fixtures.laplacian_3d(12)
    perm12 = sstt.analyze(A12, cfg).perm
    S12 = analyze_supernodal(A12, perm12, cfg)
    s = int(np.flatnonzero(partition_tree(S12, 2).own == 1)[0])
    neg = int(S12.perm[S12.super_first[s]])
    runs = [
        dict(name="a", world=1, backend="nccl", mesh=(1, 1), nx=SIZE,
             perm=perm50, dtype="float32"),
        dict(name="b", world=4, backend="gloo", mesh=(2, 2), nx=SIZE,
             perm=perm50, dtype="float32", kernels=True),
        dict(name="c", world=4, backend="gloo", mesh=(1, 4), nx=30,
             perm=perm30, dtype="float64"),
        dict(name="d", world=2, backend="gloo", mesh=(2, 1), nx=12,
             perm=perm12, dtype="float32", neg=neg),
    ]
    torch.cuda.empty_cache()
    summary, krec = {}, {}
    launches = {"potrf_trsm": 0, "extend_add": 0}
    for spec in runs:
        spec["port"] = _free_port()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out_dir:
            recs = _spawn_ranks(spec, spec["world"], out_dir, _mesh_rank)
        wall = time.perf_counter() - t0
        r0 = recs[0]
        assert sorted(tuple(r["tp"]) for r in recs) == sorted(
            (t, p) for t in range(spec["mesh"][0])
            for p in range(spec["mesh"][1])), recs
        for r in recs:
            assert r["launches"] == r["predicted"], (spec["name"], r)
            assert r["lx_sha"] == r0["lx_sha"], (spec["name"], r["rank"])
        if spec["name"] == "d":
            minors = [r["minor"] for r in recs]
            assert minors == [r0["single_minor"]] * 2 and minors[0] < \
                spec["nx"] ** 3, minors
            summary["d"] = {"minor": minors, "wall_s": wall,
                            "launches": [r["launches"] for r in recs]}
            print(f"mesh (d) indefinite, mesh (2, 1): minor {minors} on "
                  f"every rank = the single-card factor's, wall {wall:.2f} s",
                  flush=True)
            continue
        fp64 = spec["dtype"] == "float64"
        tree, panel = spec["mesh"]
        for r in recs:
            assert r["residual"] < DIST_RESID_TOL[spec["dtype"]], r
            if not fp64:
                assert r["launches"]["potrf_trsm"] > 0 and \
                    r["launches"]["extend_add"] > 0, (spec["name"], r)
                for k in launches:
                    launches[k] += r["launches"][k]
            cen = r["census"]
            assert cen["assembly"]["count"] == 1 and \
                cen["assembly"]["ranks"] == spec["world"], cen
            assert cen["tree_u"]["ranks"] == tree and \
                cen["tree_u"]["count"] > 0, cen
            if r["axes"]["panel"]:
                assert cen["panel_u"]["ranks"] == panel and \
                    cen["panel_u"]["count"] == cen["panel_l21"]["count"] > 0
        assert r0["lx_err"] <= DIST_LX_TOL[spec["dtype"]], r0
        summary[spec["name"]] = {
            k: r0[k] for k in ("plan_s", "first_s", "factor_s", "seconds",
                               "census", "lx_err", "residual", "axes",
                               "single_factor_s")}
        summary[spec["name"]].update(
            wall_s=wall, peaks_gb=[r["peak_gb"] for r in recs],
            launches=[r["launches"] for r in recs],
            residuals=[r["residual"] for r in recs])
        sums = {k: (round(v["bytes"] / 1e6, 1), round(v["seconds"], 4),
                    v["count"]) for k, v in r0["census"].items()}
        print(f"mesh ({spec['name']}) world {spec['world']} "
              f"{spec['backend']} mesh {spec['mesh']} nx {spec['nx']} "
              f"{spec['dtype']}: groups {r0['axes']}; lx_err "
              f"{r0['lx_err']:.3e}, residuals "
              f"{max(r['residual'] for r in recs):.3e}; rank 0 plan "
              f"{r0['plan_s']:.3f} s, factor {r0['factor_s']:.4f} s steady "
              f"(min of 3; {r0['seconds']}), first {r0['first_s']:.4f} s, "
              f"single card {r0['single_factor_s']:.4f} s; sums (MB, s, "
              f"count) {sums}; launches {[r['launches'] for r in recs]}; "
              f"peaks GB {[round(r['peak_gb'], 3) for r in recs]}; wall "
              f"{wall:.2f} s", flush=True)
        if "kernels" in r0:
            krec = r0["kernels"]
    return summary, krec, launches


def bf16_phase(A, Ssim, dp) -> tuple[dict, dict, dict]:
    """bfloat16 child updates (``Config.update_dtype="bfloat16"``) on the
    main path's ``A``, analysis ``Ssim`` and device plan ``dp`` (see the
    module docstring, item 7b). Returns (the phase's record, K7's rows of
    the bfloat16 instances, their launches in the factors driven through
    ``factorize``). Every gate raises."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch import prof
    from suitesparse_tpu_torch.kernels.potrf_sweep import K1_GROUPS
    from suitesparse_tpu_torch.numeric import segmented, supernodal
    from suitesparse_tpu_torch.numeric import supernodal_device as sd

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    bcfg = cfg.replace(update_dtype="bfloat16")
    b64cfg = bcfg.replace(compute_dtype="float64")
    S = supernodal.supernodal_symbolic(A, Ssim, cfg)
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    # every class of every group through K7, one launch a group with
    # classes (the work lists the fp64 factor reads)
    n_k7_all = k7_launches(dp, "float64")
    others = ("extend_add_tiles", "extend_add_tiles_pair", "extend_add",
              "extend_add_f64")
    steps: dict = {}

    def measure(c):
        """(factor, seconds, peak GB above the allocation at the reset,
        launches) of one factor under ``c``."""
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        Fx = sstt.factorize(A, Ssim, c, device="cuda")
        torch.cuda.synchronize()
        return (Fx, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - base) / 1e9, counts())

    # ---- the first bfloat16 factor, its launches, the fp32 factor's peak --
    with _step(steps, "first_and_peaks"):
        Fb, first_s, peak_bf16, launches = measure(bcfg)
        assert Fb.ok, f"bf16 factorization failed at column {Fb.minor}"
        assert Fb.F.Lx.dtype == torch.float32
        assert launches["potrf_trsm"] == len(K1_GROUPS) and \
            launches["extend_add_bf16"] == n_k7_all > 0 and \
            launches["extend_add_f64_bf16"] == 0 and \
            all(launches[k] == 0 for k in others), launches
        F32, _first32, peak_fp32, _l32 = measure(cfg)
        assert torch.equal(Fb.F.Lx, sstt.factorize(A, Ssim, bcfg).F.Lx), \
            "two bf16 factors differ"
    # ---- steady walls in turns: fp32, bf16, bf16, fp32 ----
    walls: dict = {"fp32": [], "bf16": []}
    with _step(steps, "walls"):
        for name in ("fp32", "bf16", "bf16", "fp32"):
            c = bcfg if name == "bf16" else cfg
            walls[name].append(_best_s(
                lambda: sstt.factorize(A, Ssim, c, device="cuda")))
    # ---- device time by kernel (profiler), K7 a factor ----
    with _step(steps, "profiles"):
        os.makedirs(prof.OUT_DIR, exist_ok=True)
        p32 = prof.profile_phase(
            "factor", lambda: sstt.factorize(A, Ssim, cfg, device="cuda"))
        p16 = prof.profile_phase(
            "factor_bf16",
            lambda: sstt.factorize(A, Ssim, bcfg, device="cuda"))
    # ---- one solve, then refinement ----
    with _step(steps, "solves"):
        x0 = sstt.solve(Fb, b, bcfg)
        r0 = sstt.residual_norm(A, x0, b)
        xr = sstt.solve_refined(Fb, A, b, iters=BF16_STEPS, config=bcfg)
        r = sstt.residual_norm(A, xr, b)
        assert np.isfinite(x0).all() and np.isfinite(xr).all()
        assert r0 < BF16_ONE_TOL and r < BF16_REFINED_TOL and r <= r0, \
            (r0, r)
    with _step(steps, "lx_host"):
        l16, l32 = Fb.F.lx_host(), F32.F.lx_host()
        lx_diff = float(np.abs(l16 - l32).max() / np.abs(l32).max())
        del F32, l16, l32
    # ---- fp64 fronts, bfloat16 updates ----
    with _step(steps, "fp64_fronts"):
        zero_counts()
        F64 = sstt.factorize(A, Ssim, b64cfg, device="cuda")
        torch.cuda.synchronize()
        l64 = counts()
        assert F64.ok and F64.F.Lx.dtype == torch.float64
        assert l64["extend_add_f64_bf16"] == n_k7_all and \
            l64["extend_add_bf16"] == 0 and l64["potrf_trsm"] == 0 and \
            all(l64[k] == 0 for k in others), l64
        x064 = sstt.solve(F64, b, b64cfg)
        r064 = sstt.residual_norm(A, x064, b)
        xr64 = sstt.solve_refined(F64, A, b, iters=BF16_STEPS,
                                  config=b64cfg)
        r64 = sstt.residual_norm(A, xr64, b)
        assert r064 < BF16_ONE_TOL and r64 < BF16_REFINED_TOL and \
            r64 <= r064, (r064, r64)
        factor64_s = _best_s(lambda: sstt.factorize(A, Ssim, b64cfg,
                                                    device="cuda"))
        del F64
    # ---- K7's bfloat16 instances at the plan's groups ----
    rec: dict = {}
    with _step(steps, "k7_rows"):
        rng = np.random.default_rng(SEED)
        groups = [g for gl in dp.plan.groups for g in gl]
        (i,) = [i for i, g in enumerate(groups) if (g.B, g.R) == K7_GROUP]
        i64 = max((i for i, g in enumerate(groups) if g._tile is not None),
                  key=lambda i: groups[i].R)
        assert groups[i64].R == K7_F64_GROUP, groups[i64].R
        _k7_group_row(rec, "extend_add_bf16", groups[i],
                      dp.host[i].k7_all.to(dev), dp, dev, rng, torch.float32,
                      K567_TOL, "bf16 factor group", udtype=bf)
        _k7_group_row(rec, "extend_add_f64_bf16", groups[i64],
                      dp.host[i64].k7_all.to(dev), dp, dev, rng,
                      torch.float64, K7_F64_TOL,
                      "fp64 factor's largest tile group", udtype=bf)
    # ---- forced into segments: the one-piece bits ----
    with _step(steps, "segmented"):
        est = segmented.one_piece_bytes(dp.index_bytes,
                                        dp.costs[torch.float32, bf])
        seg_cfg = bcfg.replace(segment_bytes=max(1, est // SEG_SHARE))
        zero_counts()
        Fs = sd.factorize_device(A, S, seg_cfg, dev)
        torch.cuda.synchronize()
        ls = counts()
        assert Fs.segments >= SEG_MIN, Fs.segments
        assert torch.equal(Fs.Lx, Fb.F.Lx), "segmented bf16 factor differs"
        assert ls["extend_add_bf16"] == launches["extend_add_bf16"], ls
        segments = Fs.segments
        del Fs, Fb
    roof = sd.roofline_report(S, 4, 2).splitlines()
    k7_ms, k7_n = p16["hand_kernels"]["extend_add_kernel"]
    out = {
        "card": _card(), "first_factor_s": first_s,
        "factor_s": min(walls["bf16"]), "fp32_factor_s": min(walls["fp32"]),
        "walls": walls, "factor64_s": factor64_s,
        "peak_gb": peak_bf16, "fp32_peak_gb": peak_fp32,
        "launches": launches, "launches_f64": l64,
        "residual_one_solve": r0, "residual_refined": r,
        "residual_one_solve_f64": r064, "residual_refined_f64": r64,
        "lx_host_vs_fp32": lx_diff, "segments": segments,
        "segment_budget": seg_cfg.segment_bytes, "one_piece_estimate": est,
        "k7_ms_per_factor": k7_ms, "k7_launches_profiled": k7_n,
        "fp32_hand_kernels": p32["hand_kernels"],
        "busy_s": p16["device_busy_s"], "idle_share": p16["device_idle_share"],
        "ops": p16["n_device_ops"], "fp32_busy_s": p32["device_busy_s"],
        "fp32_ops": p32["n_device_ops"], "roofline": roof[-1],
        "steps_s": steps}
    print(f"bf16 updates: first factor {first_s:.4f} s, steady "
          f"{out['factor_s']:.4f} s against fp32 {out['fp32_factor_s']:.4f} "
          f"s (in turns {walls}), fp64 fronts {factor64_s:.4f} s; peak "
          f"{peak_bf16:.3f} GB against fp32 {peak_fp32:.3f} GB; K7 "
          f"{k7_ms:.4f} ms a factor in {k7_n} launches; busy "
          f"{out['busy_s']:.4f} s, idle {out['idle_share']:.3f}, "
          f"{out['ops']} ops (fp32 {out['fp32_busy_s']:.4f} s, "
          f"{out['fp32_ops']} ops); residual {r0:.3e} after one solve, "
          f"{r:.3e} after {BF16_STEPS} steps (fp64 fronts {r064:.3e}, "
          f"{r64:.3e}); lx_host vs fp32 {lx_diff:.3e}; {segments} segments "
          f"bit-equal; launches {launches}, fp64 {l64}; roofline "
          f"({roof[0]}): {roof[-1]}; step seconds {steps}", flush=True)
    return out, rec, {"extend_add_bf16": launches["extend_add_bf16"],
                      "extend_add_f64_bf16": l64["extend_add_f64_bf16"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels import _build
    from suitesparse_tpu_torch.kernels.potrf_sweep import K1_GROUPS
    from suitesparse_tpu_torch.numeric import (supernodal, supernodal_device,
                                               supernodal_solve)

    card = _card()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"linalg {torch.backends.cuda.preferred_linalg_library()}",
          flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build and load {time.perf_counter() - t0:.2f} s",
          flush=True)

    A = sstt.fixtures.laplacian_3d(SIZE)
    n = A.ncol
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    classic = cfg.replace(solve_mode="classic")
    t0 = time.perf_counter()
    Ssim = sstt.analyze(A, cfg)
    S = supernodal.supernodal_symbolic(A, Ssim, cfg)
    analyze_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = supernodal_device.device_plan(A, S, dev)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dpp = supernodal_device.device_plan(A, S, dev, tile_pair=True)
    pair_plan_s = time.perf_counter() - t0
    groups = [g for gl in dp.plan.groups for g in gl]
    steps = [sum(g._tile.man.shape[0] for gl in p.plan.groups for g in gl
                 if g._tile is not None) for p in (dp, dpp)]
    print(f"n={n} fl={S.fl:.4g} lnz={S.lnz} dev_size={dp.plan.dev_size} "
          f"groups={len(groups)} "
          f"tile_groups={sum(g._tile is not None for g in groups)} "
          f"tile_steps={steps[0]} two_piece_steps={steps[1]} "
          f"analyze_s={analyze_s:.2f} (first call: includes building the "
          f"host C++ library) plan_s={plan_s:.2f} "
          f"pair_plan_s={pair_plan_s:.2f}", flush=True)
    Af = forest(*FOREST)
    t0 = time.perf_counter()
    Ssf = sstt.analyze(Af, cfg)
    Sf = supernodal.supernodal_symbolic(Af, Ssf, cfg)
    dpf = supernodal_device.device_plan(Af, Sf, dev)
    print(f"forest {FOREST[0]} x laplacian_3d({FOREST[1]}): n={Af.ncol} "
          f"fl={Sf.fl:.4g} groups={sum(len(gl) for gl in dpf.plan.groups)} "
          f"analyze_and_plan_s={time.perf_counter() - t0:.2f}", flush=True)

    # the plans the solves take: the coarse solve plans
    t0 = time.perf_counter()
    splan = supernodal_solve._coarse_plan(S)
    splan_s = time.perf_counter() - t0
    fplan = supernodal_solve._coarse_plan(Sf)
    print(f"coarse solve plan: groups={sum(len(gl) for gl in splan.groups)} "
          f"cells={splan.dev_size} plan_s={splan_s:.2f}; forest groups="
          f"{sum(len(gl) for gl in fplan.groups)}", flush=True)

    rng = np.random.default_rng(SEED)
    k1, k2, k2b = factor_kernels(dp, dpp, dev, rng)
    ks, k4_ms = solve_kernels(splan, fplan, dev, rng)
    kw = w2_kernels(splan, dev, rng)
    k7 = extend_add_kernel(dp, dev, rng)
    small_check(dev)
    # pair classes of the plan, and those no tile manifest folds: the fp32
    # factor places the latter through K7, the fp64 factor (which runs no
    # manifest) all of them, one launch a group with such classes
    n_classes = sum(len(g.pairs) for g in groups)
    n_unfolded = n_classes - sum(len(g._tile.folded) for g in groups
                                 if g._tile is not None)
    n_k7, n_k7_f64 = k7_launches(dp, "float32"), k7_launches(dp, "float64")

    # ---- main path, through the package's entry points ----
    zero_counts()
    t0 = time.perf_counter()
    F = sstt.factorize(A, Ssim, cfg, device="cuda")
    torch.cuda.synchronize()
    first_factor_s = time.perf_counter() - t0
    factor_launches = counts()
    assert F.ok, f"factorization failed at column {F.minor}"
    assert factor_launches["potrf_trsm"] == len(K1_GROUPS) and \
        factor_launches["extend_add_tiles"] > 0 and \
        factor_launches["extend_add"] == n_k7 and \
        factor_launches["extend_add_f64"] == 0, factor_launches
    F2 = sstt.factorize(A, Ssim, cfg, device="cuda")
    same = torch.equal(F.F.Lx, F2.F.Lx)
    print(f"factor: {n_unfolded} of the plan's {n_classes} pair classes "
          f"through K7 in {n_k7} launches (one a group), "
          f"launches={factor_launches}; a second factor equals the first "
          f"bit for bit: {same}", flush=True)
    assert same, "two factors of the model problem differ"
    del F2
    auto_fallback(F)
    b = 1.0 + np.arange(n) / n
    B64 = np.tile(b.reshape(-1, 1), (1, NRHS)) * (1.0 + np.arange(NRHS) / NRHS)
    x = sstt.solve(F, b, cfg)
    x64 = sstt.solve(F, B64, cfg)
    resid = sstt.residual_norm(A, x, b)
    resid64 = sstt.residual_norm(A, x64[:, 0], B64[:, 0])
    assert x.shape == (n,) and x64.shape == (n, NRHS)
    assert np.isfinite(x).all() and np.isfinite(x64).all()
    assert resid < RESID_TOL and resid64 < RESID_TOL, (resid, resid64)
    assert supernodal_solve.solve_ladder(F.F) == "coarse" and \
        F.F.dplan.coarse[0].plan is splan, "the solve left the coarse plan"

    # ---- classic sweep on the same factor ----
    zero_counts()
    xc = sstt.solve(F, b, classic)
    xc64 = sstt.solve(F, B64, classic)
    torch.cuda.synchronize()
    classic_launches = counts()
    assert classic_launches["solve_step_fwd"] > 0 and \
        classic_launches["solve_step_bwd"] > 0, classic_launches
    cresid = sstt.residual_norm(A, xc, b)
    cresid64 = max(sstt.residual_norm(A, xc64[:, k], B64[:, k])
                   for k in (0, NRHS - 1))
    assert np.isfinite(xc).all() and np.isfinite(xc64).all()
    assert cresid < RESID_TOL and cresid64 < RESID_TOL, (cresid, cresid64)
    dx = np.abs(xc - x).max() / np.abs(x).max()
    dx64 = np.abs(xc64 - x64).max() / np.abs(x64).max()
    assert dx <= 1e-4 and dx64 <= 1e-4, (dx, dx64)

    # ---- forest through cholsol, classic sweep ----
    bf = 1.0 + np.arange(Af.ncol) / Af.ncol
    forest_cfg = classic.replace(factor_kind=sstt.FactorKind.SUPERNODAL_LL)
    zero_counts()
    t0 = time.perf_counter()
    xf = sstt.cholsol(Af, bf, forest_cfg, device="cuda")
    torch.cuda.synchronize()
    forest_s = time.perf_counter() - t0
    forest_launches = counts()
    n_k7_forest = k7_launches(dpf, "float32")
    assert forest_launches["extend_add"] == n_k7_forest > 0 and \
        forest_launches["batched_trisolve"] > 0 and \
        forest_launches["solve_step_fwd"] > 0 and \
        forest_launches["solve_step_bwd"] > 0, forest_launches
    fresid = sstt.residual_norm(Af, xf, bf)
    assert np.isfinite(xf).all() and fresid < RESID_TOL, fresid

    # ---- forest at 64 right-hand sides, classic sweep (K4 at NR 64) ----
    zero_counts()
    Ff = sstt.factorize(Af, Ssf, forest_cfg, device="cuda")
    torch.cuda.synchronize()
    assert Ff.ok, f"forest factorization failed at column {Ff.minor}"
    assert counts()["extend_add"] == n_k7_forest, counts()
    Bf64 = np.tile(bf.reshape(-1, 1), (1, NRHS)) * \
        (1.0 + np.arange(NRHS) / NRHS)
    zero_counts()
    xf64 = sstt.solve(Ff, Bf64, forest_cfg)
    torch.cuda.synchronize()
    forest64_launches = counts()
    assert forest64_launches["batched_trisolve"] > 0, forest64_launches
    assert xf64.shape == (Af.ncol, NRHS) and np.isfinite(xf64).all()
    fresid64 = max(sstt.residual_norm(Af, xf64[:, k], Bf64[:, k])
                   for k in (0, NRHS - 1))
    assert fresid64 < RESID_TOL, fresid64
    xw64 = sstt.solve(Ff, Bf64, cfg)
    fdx64 = np.abs(xf64 - xw64).max() / np.abs(xw64).max()
    assert fdx64 <= 1e-4, fdx64
    # K4's device time per forest solve: its launches (forward and
    # transposed alike) times its kernel rows at the root group's shape
    k4_per_solve = {
        nr: c["batched_trisolve"] / 2 * sum(
            k4_ms[FOREST[0], 64, nr, tr] for tr in (False, True))
        for nr, c in ((1, forest_launches), (NRHS, forest64_launches))}
    print(f"forest classic solve at nrhs {NRHS}: residual {fresid64:.3e}, "
          f"x vs w2 {fdx64:.3e}, launches={forest64_launches}, K4 device "
          f"ms per solve {k4_per_solve[1]:.4f} / {k4_per_solve[NRHS]:.4f} "
          f"at nrhs 1 / {NRHS}", flush=True)

    # ---- refinement ----
    xr = sstt.solve_refined(F, A, b, config=cfg)
    rresid = sstt.residual_norm(A, xr, b)
    assert rresid < REFINED_TOL, rresid

    # ---- fp64 factor and solve (K7's double instance, every class) ----
    cfg64 = cfg.replace(compute_dtype="float64")
    zero_counts()
    t0 = time.perf_counter()
    F64 = sstt.factorize(A, Ssim, cfg64, device="cuda")
    torch.cuda.synchronize()
    first_factor64_s = time.perf_counter() - t0
    f64_launches = counts()
    assert F64.ok, f"fp64 factorization failed at column {F64.minor}"
    assert F64.F.Lx.dtype == torch.float64
    assert f64_launches["extend_add_f64"] == n_k7_f64 and \
        f64_launches["extend_add"] == 0, f64_launches
    x_f64 = sstt.solve(F64, b, cfg64)
    f64_resid = sstt.residual_norm(A, x_f64, b)
    assert x_f64.shape == (n,) and np.isfinite(x_f64).all()
    assert f64_resid < REFINED_TOL, f64_resid
    factor64_s = _best_s(lambda: sstt.factorize(A, Ssim, cfg64,
                                                device="cuda"))
    print(f"fp64 factor: launches={f64_launches}, residual {f64_resid:.3e}, "
          f"first factor {first_factor64_s:.4f} s, steady {factor64_s:.4f} "
          f"s", flush=True)
    del F64

    # ---- kernel path: two-piece tile steps, then the w2 kernel routes ----
    pair_cfg = cfg.replace(tile_pair=True)
    kern_cfg = cfg.replace(solve_pmv=True, solve_bmv=True)
    zero_counts()
    Fk = sstt.factorize(A, Ssim, pair_cfg, device="cuda")
    torch.cuda.synchronize()
    pair_launches = counts()
    assert Fk.ok, f"two-piece factorization failed at column {Fk.minor}"
    assert pair_launches["extend_add_tiles_pair"] > 0 and \
        pair_launches["potrf_trsm"] == len(K1_GROUPS) and \
        pair_launches["extend_add"] == k7_launches(dpp, "float32") and \
        pair_launches["extend_add_tiles"] == 0, pair_launches
    lx = F.F.Lx
    pair_lx_err = ((Fk.F.Lx - lx).abs().max() / lx.abs().max()).item()
    assert pair_lx_err <= 1e-5, pair_lx_err
    B8 = np.ascontiguousarray(B64[:, :NRHS_K])
    x8 = sstt.solve(F, B8, cfg)
    w2k_launches, w2k_resid, w2k_dx = {}, {}, {}
    for nr, rhs, ref in ((1, b, x), (NRHS_K, B8, x8)):
        zero_counts()
        xk = sstt.solve(Fk, rhs, kern_cfg)
        torch.cuda.synchronize()
        w2k_launches[nr] = c = counts()
        assert c["pmatvec_t"] > 0 and c["bmatvec"] > 0 and \
            c["bmatvec_t"] > 0, (nr, c)
        assert xk.shape == rhs.shape and np.isfinite(xk).all()
        cols = [(xk, rhs)] if nr == 1 else \
            [(xk[:, k], rhs[:, k]) for k in (0, nr - 1)]
        w2k_resid[nr] = max(sstt.residual_norm(A, xc_, bc_)
                            for xc_, bc_ in cols)
        w2k_dx[nr] = np.abs(xk - ref).max() / np.abs(ref).max()
        assert w2k_resid[nr] < RESID_TOL and w2k_dx[nr] <= 1e-4, \
            (nr, w2k_resid[nr], w2k_dx[nr])
    print(f"kernel path: two-piece factor lx_rel_err={pair_lx_err:.3e} "
          f"launches={pair_launches}; w2 kernel routes residual "
          f"{w2k_resid[1]:.3e} / {w2k_resid[NRHS_K]:.3e}, x vs default w2 "
          f"{w2k_dx[1]:.3e} / {w2k_dx[NRHS_K]:.3e} at nrhs 1 / {NRHS_K}",
          flush=True)

    factor_s = _best_s(lambda: sstt.factorize(A, Ssim, cfg, device="cuda"))
    pair_factor_s = _best_s(lambda: sstt.factorize(A, Ssim, pair_cfg,
                                                   device="cuda"))
    solve_s = _best_s(lambda: sstt.solve(F, b, cfg))
    w2k_solve_s = _best_s(lambda: sstt.solve(Fk, b, kern_cfg))
    solve8_s = _best_s(lambda: sstt.solve(F, B8, cfg))
    w2k_solve8_s = _best_s(lambda: sstt.solve(Fk, B8, kern_cfg))
    solve64_s = _best_s(lambda: sstt.solve(F, B64, cfg))
    classic_solve_s = _best_s(lambda: sstt.solve(F, b, classic))
    classic_solve64_s = _best_s(lambda: sstt.solve(F, B64, classic))
    forest_classic_solve_s = _best_s(lambda: sstt.solve(Ff, bf, forest_cfg))
    forest_classic_solve64_s = _best_s(
        lambda: sstt.solve(Ff, Bf64, forest_cfg))
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    roof = supernodal_device.roofline_report(S).splitlines()
    print(f"roofline of the model factor ({roof[0]}; MFLOP, MB, flop/byte, "
          f"bound_ms): {roof[-1]}; measured factor_s {factor_s:.4f} s",
          flush=True)
    srep = supernodal_solve.solve_report(S, ladder="coarse")
    print(f"solve bound on the coarse solve plan (steps, panel MB, rhs MB, "
          f"MFLOP, bound_ms): {srep.splitlines()[-1]}; measured solve_s "
          f"{solve_s:.4f} s", flush=True)

    # ---- bfloat16 child updates on the same problem ----
    t0 = time.perf_counter()
    bf16, k7b, bf16_launches = bf16_phase(A, Ssim, dp)
    bf16_phase_s = time.perf_counter() - t0
    print(f"bf16_phase {bf16_phase_s:.2f} s", flush=True)

    # ---- checkpoint/restart: Matrix Market, Info, save, load, px sweep ----
    t0 = time.perf_counter()
    persist, kpx = persist_phase(A, Ssim)
    persist_phase_s = time.perf_counter() - t0
    # ---- the inverse-panel sweep without W2, on the same factor ----
    t0 = time.perf_counter()
    inv, k6inv = inv_phase(A, F, {1: (b, x, xc), NRHS_K: (
        B8, x8, sstt.solve(F, B8, classic))})
    inv_phase_s = time.perf_counter() - t0
    # ---- the coarse solve plan against the factor's own, every sweep ----
    t0 = time.perf_counter()
    ladder = ladder_phase(A, S, F, {1: (b, x), NRHS: (B64, x64)})
    ladder_phase_s = time.perf_counter() - t0
    print(f"ladder_phase {ladder_phase_s:.2f} s", flush=True)
    # ---- the fused and merged solve routes beside the sorted one ----
    route = route_phase(A, F, {1: b, NRHS_K: B8, NRHS: B64})
    print(f"route_phase {route['phase_s']:.2f} s", flush=True)
    # ---- 256-wide tile manifests (K2 at T = 256) ----
    wide, k2w, wide_launches = wide_tile_phase(A, S, F, dev, rng)
    print(f"wide_tile_phase {wide['phase_s']:.2f} s", flush=True)
    # ---- multifrontal QR through qrsol ----
    t0 = time.perf_counter()
    qr = qr_phase()
    qr_phase_s = time.perf_counter() - t0
    # ---- unsymmetric multifrontal LU ----
    t0 = time.perf_counter()
    lu = lu_phase()
    lu_phase_s = time.perf_counter() - t0
    # ---- complex input through the 2x2 real embedding ----
    t0 = time.perf_counter()
    cplx = complex_phase()
    cplx_phase_s = time.perf_counter() - t0
    # ---- the symmetric-strategy device LU ----
    t0 = time.perf_counter()
    mflu_sym = mflu_sym_phase()
    mflu_sym_phase_s = time.perf_counter() - t0
    # ---- segmented execution of the three device factors ----
    t0 = time.perf_counter()
    seg = segmented_phase(A, S)
    seg_phase_s = time.perf_counter() - t0
    # ---- the distributed factor and solve, ranks on the card ----
    del F, Fk, Ff
    gc.collect()
    t0 = time.perf_counter()
    dist, kdist, dist_launches = dist_phase(Ssim.perm)
    dist_phase_s = time.perf_counter() - t0
    print(f"dist_phase {dist_phase_s:.2f} s", flush=True)
    # ---- the sharded (tree, panel) factor, ranks on the card ----
    t0 = time.perf_counter()
    mesh, kmesh, mesh_launches = mesh_phase(Ssim.perm)
    mesh_phase_s = time.perf_counter() - t0
    print(f"mesh_phase {mesh_phase_s:.2f} s", flush=True)
    print(json.dumps({
        "card": card, "n": n, "flops": S.fl,
        "factor_s": factor_s, "gflops": S.fl / factor_s / 1e9,
        "first_factor_s": first_factor_s, "pair_factor_s": pair_factor_s,
        "factor64_s": factor64_s, "residual_f64": f64_resid,
        "solve_s": solve_s, "solve8_s": solve8_s,
        "w2k_solve_s": w2k_solve_s, "w2k_solve8_s": w2k_solve8_s,
        "solve64_s": solve64_s, "classic_solve_s": classic_solve_s,
        "classic_solve64_s": classic_solve64_s,
        # panel bytes the two classic sweeps must read at least
        "classic_floor_s": 2 * 4 * splan.dev_size / HBM_BYTES_S,
        "residual": resid, "residual64": resid64,
        "classic_residual": cresid, "classic_residual64": cresid64,
        "classic_vs_w2": max(dx, dx64), "refined_residual": rresid,
        "pair_lx_err": pair_lx_err, "w2k_residual": w2k_resid[1],
        "w2k_residual8": w2k_resid[NRHS_K],
        "w2k_vs_w2": max(w2k_dx.values()),
        "forest_n": Af.ncol, "forest_cholsol_s": forest_s,
        "forest_residual": fresid,
        "forest_classic_solve_s": forest_classic_solve_s,
        "forest_classic_solve64_s": forest_classic_solve64_s,
        "forest_residual64": fresid64, "forest_classic_vs_w2": fdx64,
        "forest_k4_ms_per_solve": k4_per_solve[1],
        "forest_k4_ms_per_solve64": k4_per_solve[NRHS],
        "launches": {"factor": factor_launches, "classic": classic_launches,
                     "forest": forest_launches, "forest64": forest64_launches,
                     "factor_f64": f64_launches,
                     "pair_factor": pair_launches,
                     "w2k1": w2k_launches[1],
                     "w2k8": w2k_launches[NRHS_K]},
        "peak_mem_gb": peak_mem_gb,
        "qr_s": qr["grid"]["qr_s"], "qr_gflops": qr["grid"]["gflops"],
        "qr64_s": qr["grid64"]["qr_s"],
        "qr_lc_s": qr["lc"]["qr_s"], "qr_lc64_s": qr["lc64"]["qr_s"],
        "qr_normal_residual": max(qr[k]["normal_residual"]
                                  for k in ("lc", "grid", "grid_nrhs4")),
        "qr_normal_residual64": max(qr[k]["normal_residual"]
                                    for k in ("lc64", "grid64")),
        "qr_lstsq_err": qr["lc"]["lstsq_err"],
        "qr_lstsq_err64": qr["lc64"]["lstsq_err"],
        "qr_grid_fp32_vs_fp64": qr["grid"]["fp32_vs_fp64"],
        "qr_phase_s": qr_phase_s, "qr": qr,
        "lu_s": lu["fem"]["lu_s"], "lu_gflops": lu["fem"]["gflops"],
        "lu64_s": lu["fem64"]["lu_s"], "lu_upwind_s": lu["upwind"]["lu_s"],
        "lu_residual": max(lu[k]["residual"]
                           for k in ("fem", "fem64", "upwind")),
        "lu_residual_one": lu["fem"]["residual_one"],
        "lu_residual_one64": lu["fem64"]["residual_one"],
        "lu_repair_residual": lu["repair"]["residual"],
        "lu_phase_s": lu_phase_s, "lu": lu}), flush=True)
    print(json.dumps({"complex": cplx, "complex_phase_s": cplx_phase_s}),
          flush=True)
    print(json.dumps({"bf16": bf16, "bf16_phase_s": bf16_phase_s},
                     default=str), flush=True)
    print(json.dumps({"segmented": seg, "segmented_phase_s": seg_phase_s}),
          flush=True)
    print(json.dumps({"persist": persist, "persist_phase_s": persist_phase_s},
                     default=str), flush=True)
    print(json.dumps({"dist": dist, "dist_phase_s": dist_phase_s},
                     default=str), flush=True)
    print(json.dumps({"mesh": mesh, "mesh_phase_s": mesh_phase_s},
                     default=str), flush=True)
    print(json.dumps({"ladder": ladder, "ladder_phase_s": ladder_phase_s},
                     default=str), flush=True)
    print(json.dumps({"route": route}, default=str), flush=True)
    print(json.dumps({"wide": wide, "k2_wide": k2w}, default=str),
          flush=True)
    print(json.dumps({"inv": inv, "inv_phase_s": inv_phase_s,
                      "mflu_sym": mflu_sym,
                      "mflu_sym_phase_s": mflu_sym_phase_s}, default=str),
          flush=True)

    def entry(name, replaces, src, k, launches):
        return {"name": name, "route": "cuda", "source": SRC + src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["abs"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms")}

    print(json.dumps({"kernels": [
        entry("potrf_trsm", "suitesparse_tpu/kernels/potrf.py:108",
              "potrf_trsm.cu", k1, factor_launches["potrf_trsm"]),
        entry("extend_add_tiles",
              "suitesparse_tpu/kernels/extend_add_tiles.py:381",
              "extend_add_tiles.cu", k2, factor_launches["extend_add_tiles"]),
        entry("extend_add_tiles_pair",
              "suitesparse_tpu/kernels/extend_add_tiles.py:359",
              "extend_add_tiles.cu", k2b,
              pair_launches["extend_add_tiles_pair"]),
        entry("extend_add_tiles_wide",
              "suitesparse_tpu/kernels/extend_add_tiles.py:381",
              "extend_add_tiles.cu", k2w,
              wide_launches["extend_add_tiles_wide"]),
        entry("solve_step_fwd", "suitesparse_tpu/kernels/solve_step.py:96",
              "solve_step.cu", ks["solve_step_fwd"],
              classic_launches["solve_step_fwd"]),
        entry("solve_step_bwd", "suitesparse_tpu/kernels/solve_step.py:108",
              "solve_step.cu", ks["solve_step_bwd"],
              classic_launches["solve_step_bwd"]),
        entry("batched_trisolve", "suitesparse_tpu/kernels/trisolve.py:89",
              "trisolve.cu", ks["batched_trisolve"],
              forest_launches["batched_trisolve"]
              + forest64_launches["batched_trisolve"]),
        entry("batched_trisolve_px", "suitesparse_tpu/kernels/trisolve.py:89",
              "trisolve.cu", kpx["batched_trisolve_px"],
              sum(persist[f"nrhs{nr}"]["launches"]["batched_trisolve"]
                  for nr in (1, NRHS))),
        entry("pmatvec_t", "suitesparse_tpu/kernels/pmatvec.py:91",
              "pmatvec.cu", kw["pmatvec_t"],
              sum(c["pmatvec_t"] for c in w2k_launches.values())),
        entry("bmatvec", "suitesparse_tpu/kernels/bmatvec.py:138",
              "bmatvec.cu", kw["bmatvec"],
              sum(c["bmatvec"] for c in w2k_launches.values())),
        entry("bmatvec_t", "suitesparse_tpu/kernels/bmatvec.py:138",
              "bmatvec.cu", kw["bmatvec_t"],
              sum(c["bmatvec_t"] for c in w2k_launches.values())),
        entry("bmatvec_inv", "suitesparse_tpu/kernels/bmatvec.py:138",
              "bmatvec.cu", k6inv["bmatvec_inv"],
              sum(c["bmatvec"] for c in inv["launches"].values())),
        entry("bmatvec_t_inv", "suitesparse_tpu/kernels/bmatvec.py:138",
              "bmatvec.cu", k6inv["bmatvec_t_inv"],
              sum(c["bmatvec_t"] for c in inv["launches"].values())),
        entry("extend_add", "suitesparse_tpu/kernels/extend_add.py:110",
              "extend_add.cu", k7["extend_add"],
              factor_launches["extend_add"]),
        entry("extend_add_f64", "suitesparse_tpu/kernels/extend_add.py:110",
              "extend_add.cu", k7["extend_add_f64"],
              f64_launches["extend_add_f64"]),
        entry("extend_add_bf16", "suitesparse_tpu/kernels/extend_add.py:110",
              "extend_add.cu", k7b["extend_add_bf16"],
              bf16_launches["extend_add_bf16"]),
        entry("extend_add_f64_bf16",
              "suitesparse_tpu/kernels/extend_add.py:110", "extend_add.cu",
              k7b["extend_add_f64_bf16"],
              bf16_launches["extend_add_f64_bf16"]),
        entry("potrf_trsm_dist", "suitesparse_tpu/kernels/potrf.py:108",
              "potrf_trsm.cu", kdist["potrf_trsm_dist"],
              dist_launches["potrf_trsm"]),
        entry("extend_add_dist", "suitesparse_tpu/kernels/extend_add.py:110",
              "extend_add.cu", kdist["extend_add_dist"],
              dist_launches["extend_add"]),
        entry("potrf_trsm_mesh", "suitesparse_tpu/kernels/potrf.py:108",
              "potrf_trsm.cu", kmesh["potrf_trsm_mesh"],
              mesh_launches["potrf_trsm"]),
        entry("extend_add_mesh", "suitesparse_tpu/kernels/extend_add.py:110",
              "extend_add.cu", kmesh["extend_add_mesh"],
              mesh_launches["extend_add"]),
    ]}))
    leaked = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in ("jax", "jaxlib", "suitesparse_tpu")]
    assert not leaked, f"the port imported {leaked}"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
