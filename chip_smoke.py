#!/usr/bin/env python3
"""Smoke test of the PyTorch port (decomp_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``decomp_tpu_torch/csrc`` with nvcc
for sm_90a (one nvcc per source, all at once), and then:

1. prints the card's name and power limit (nvidia-smi), the build time
   and ptxas' register-spill report, and fails where an instance of the
   wgmma chain (``csrc/kl_dense_packed.cu``, ``csrc/grad_dict_packed.cu``,
   ``csrc/mu_dense_packed.cu``, ``csrc/mu_masked_f32.cu``), of
   ``csrc/lasso_grad_packed.cu``, of ``csrc/grad_wide.cu``, of
   ``csrc/mu_wide.cu``, of ``csrc/lasso_fista_wide.cu`` or of either
   ``bcd_sweep`` kernel
   (``csrc/dl_bcd_sm90.cu``, ``csrc/dl_bcd_cluster.cu``) spills;
2. holds the kernel ``mu_stats_dense`` against its plain PyTorch twin on
   the card and checks that two runs give the same bits: f32 data on
   ``csrc/mu_dense_packed.cu``, and bf16 data with f32 or bf16 x on the
   route to ``csrc/mu_dense_tma.cu`` (TMA ring, wgmma) at 1000 x 1000
   K = 100 (inner_iter 1 and 3) and K = 64, a ragged 333 x 257 K = 7,
   65,537 x 10,112 and 65,536 x 10,112 K = 128;
3. holds ``mu_stats_masked`` (on a dense mask), ``kl_stats_dense`` (bf16
   data on ``csrc/mu_kl_stats.cu``, and f32 data on that kernel through
   the private ``cuda_mu._kl_dense_mu_launch``, which no path takes) and
   ``kl_stats_masked`` (on a dense mask: bf16 data, and f32 data with a
   weighted mask) against their twins the same way, at 1000 x 1000
   K = 100, 100,000 x 1,000 K = 50 and 65,536 x 10,112 K = 128; then
   (3b) ``mu_stats_masked`` on a packed mask (``cuda_mu.pack_mask``, the
   kernel of ``csrc/mu_masked_packed.cu``) with bf16 data and f32 or bf16
   x at those shapes, a ragged 333 x 257 K = 7 and 1000 x 1000 K = 64;
   and (3c) ``kl_stats_masked`` on a packed mask (the kernel of
   ``csrc/kl_masked_packed.cu``, bf16x6 products on the tensor cores)
   with f32 data at those shapes and 1000 x 1000 K = 1, with eps = 0 at
   333 x 257 K = 7, and on log-normal my, x and d over six decades at
   65,536 x 1,024 K = 128, within the f32 limit of the full-f32 twin, and
   the dense-mask KL kernel at the same ragged shapes, K = 1 and eps = 0;
   and (3d) ``kl_stats_dense`` on f32 data (the kernel of
   ``csrc/kl_dense_packed.cu``, bf16x6 products on wgmma) at 1000 x 1000
   K = 100, 100,000 x 1,000 K = 50, 65,536 x 10,112 K = 128, 333 x 257
   K = 7 with eps = EPS and eps = 0, 1000 x 1000 K = 64 and K = 1, and on
   log-normal my, x and d over six decades at 65,536 x 1,024 K = 128,
   and at 1000 x 1000 K = 1 with x d above 2^126 (E's division scales
   such divisors), within the f32 limit of the full-f32 twin, each with a
   bit-identical rerun; and (3e) ``mu_stats_dense`` on f32 data (the
   kernel of ``csrc/mu_dense_packed.cu``, bf16x6 products on wgmma) at
   1000 x 1000 K = 100 with inner_iter 1 and 3, 100,000 x 1,024 K = 128,
   65,536 x 10,112 K = 128, 333 x 257 K = 7 with eps = EPS and eps = 0,
   1000 x 1000 K = 1 and K = 64, and on log-normal y, x and d over six
   decades at 65,536 x 1,024 K = 128 (kernel and twin also against f64),
   within the f32 limit of the full-f32 twin, each with a bit-identical
   rerun and d's limbs from the kernel's split launch held bit for bit to
   ``cuda_mu.column_limbs``; and (3f) ``mu_stats_masked`` on f32 data with
   the mask's bits (the kernel of ``csrc/mu_masked_f32.cu``, bf16x6
   products on wgmma) at phase 3c's shapes, 333 x 257 K = 7 with eps =
   EPS and eps = 0, 1000 x 1000 K = 1, 64 and 128, and on log-normal my,
   x and d over six decades at 65,536 x 1,024 K = 128 (kernel and twin
   also against f64), within the f32 limit of the full-f32 twin, each
   call counted in ``.f32_launches`` with a bit-identical rerun;
4. drives the dense main path, ``decomp_tpu_torch.nmf.solve`` on a
   1,048,576 x 10,112 bf16 matrix at rank 128 with f32 factors, 20
   iterations, and checks that every iteration went through the TMA
   kernel, that the factors are finite and nonnegative and that the
   reconstruction error fell; it times the solve, and one kernel call in
   turns with one call of ``csrc/mu_stats_dense.cu`` on the same inputs,
   against one twin call, and prints each pass of the TMA kernel from
   ``torch.profiler`` with the bytes it moves; then (4b) the f32 dense
   path, ``nmf.solve(y, rank=128, method='mu', tol=0)`` on a 262,144 x
   10,112 f32 matrix, 20 iterations: one launch per iteration on
   ``csrc/mu_dense_packed.cu``, none on the TMA route or on the first design,
   ``csrc/mu_stats_dense.cu``, finite nonnegative factors and a falling
   reconstruction error, with one kernel call against the twin, the kernel
   timed in turns with ``csrc/mu_stats_dense.cu`` on the same inputs and
   once against the twin, and its passes from ``torch.profiler``; then
   (4c) MU above rank 128 on its wide route (``csrc/mu_wide.cu``): each
   instance (dense f32 and bf16 with f32 and bf16 x, inner_iter 1 and 3;
   masked f32 and bf16 on a 0/1 mask's bits and on weights in [0.5, 1))
   against its twin at 1,000 x 1,000, K = 256, 200 and 129 and a ragged
   333 x 257, K = 129, and f32 at the gate's corners
   (``cuda_mu.rank_fits``: K = 1,280 dense and 640 masked at N = 1,024;
   10,624 and 6,272 at N = 128, on 512 rows), within GRAD_LIMIT of its
   dtype with a bit-identical rerun and both calls counted in
   ``.wide_launches``; each instance per call at 100,000 x 1,024, K = 256,
   against its twin and beside its bound, the masked ones with their six
   launches from ``torch.profiler``; and the path there:
   ``nmf.solve(method='mu')`` on f32 and on bf16 data with f32 factors,
   20 iterations at tol 0, each in ms an iteration in turns with
   ``use_kernel=False``, ``nmf.masked_completion`` on planted rank-256
   data with 30% missing, f32 (``mixed=False``) and bf16, to the held-out
   stop at tol 1e-3 or 2,000 iterations, held-out error < 5e-2, and 5
   iterations on weights, f32 and bf16, every launch on the wide route;
   and (4d) KL-MU above rank 128 on the same route's KL entries: each
   instance (dense f32 and bf16; masked f32 on bits and on weights, bf16
   on a dense 0/1 mask and on weights) against its twin at 1,000 x 1,000,
   K = 256 and 200, and a ragged 333 x 257, K = 129, with eps = EPS and
   eps = 0, f32 on log-normal my, x and d over six decades at 65,536 x
   1,024, K = 200, and f32 at the KL gate's corners (K = 4,480 dense and
   3,456 masked at N = 128 on 4,096 rows; 512 and 384 at N = 1,024 on
   32,768), within LIMIT (X_BF16_LIMIT for bf16 x_new) with a
   bit-identical rerun and both calls counted in ``.wide_launches``; each
   instance per call at 100,000 x 1,024, K = 256, against its twin and
   beside its bound; and the path there: ``nmf.solve(method='kl-mu')``,
   f32, dense and with 30% missing, 20 iterations at tol 0, each in ms
   an iteration in turns with ``use_kernel=False``, the KL objective
   falling, and 5 iterations each of bf16 data (dense, a 0/1 mask) and
   of weights (f32, bf16), every launch on the wide route;
5. solves a planted rank-10 problem (config 1) to convergence and
   restarts from it, every launch on ``csrc/mu_dense_packed.cu``, and
   times that kernel per call on it in turns with
   ``csrc/mu_stats_dense.cu``, with each launch's device time;
6. drives masked completion at BASELINE config 4,
   ``nmf.masked_completion`` on a planted 100,000 x 1,000 rank-50 matrix
   with 30% missing (bf16 data, f32 factors, held-out stopping), and
   checks one ``mu_stats_masked`` launch per iteration, all on the packed
   route and none on the dense one, convergence, the held-out error and
   the factors; then (6b) the same call on the same f32 data with
   ``mixed=False`` at a shallower held-out stop (tol 1e-3), every launch on ``csrc/mu_masked_f32.cu`` (none on
   ``csrc/mu_masked_packed.cu`` or ``csrc/mu_kl_stats.cu``), its time to
   stop and ms an iteration beside phase 6's;
7. drives KL-MU, ``nmf.solve(method='kl-mu')`` at 100,000 x 1,024 rank
   128 f32, dense and masked, 20 iterations each, and checks one kernel
   launch per iteration (dense: all on ``csrc/kl_dense_packed.cu``, none
   on ``csrc/mu_kl_stats.cu``; masked: all on the packed route, none on
   the dense one) and a falling KL objective;
8. times each new kernel against its twin per call at its path's shape;
   masked MU's packed-mask kernel in turns with the dense-mask kernel on
   the same inputs, at config 4 and at 262,144 x 10,112 K = 128 bf16, and
   its f32 route (``csrc/mu_masked_f32.cu``) in turns with the dense-mask
   kernel on f32 data at config 4, 100,000 x 1,024 K = 128 and 262,144 x
   10,112 K = 128, with each pass from ``torch.profiler``; masked KL's
   packed-mask kernel in turns with its dense-mask kernel at phase 7's
   shape, with each pass from ``torch.profiler``; dense KL's f32 kernel
   (``csrc/kl_dense_packed.cu``) in turns with ``csrc/mu_kl_stats.cu``'s
   f32 path on the same inputs at phase 7's shape, with each pass, dense
   MU's f32 kernel (``csrc/mu_dense_packed.cu``) in turns with
   ``csrc/mu_stats_dense.cu`` at that shape, with each pass, and dense
   KL's bf16 route (``csrc/mu_kl_stats.cu``) at that shape, and masked
   KL's routes on ``csrc/mu_kl_stats.cu`` (bf16 data on a 0/1 mask, f32
   data on a weighted mask) there;
9. holds the lasso kernel ``solve_rows`` against its twin at a ragged
   1,000 x 200 and 300 x 1,000, at 10,000 x 512, at 7 x 200 (fewer rows
   than one block's slots) and at 4,229 x 200 (a queue ragged past one
   round of slots) (ista, fista, acc_ista; scalar and per-feature step;
   precision 'highest' and 'high'; exact and fixed-budget mode; one row
   that resumes done), with bit-identical reruns at 16 rows a block;
   every 'high' call goes to ``csrc/lasso_fista_tma.cu`` and gives the
   bits of ``csrc/lasso_fista.cu``'s 'high' path in x, z, t, done and
   niter; then its complex mode the same way on complex64 data at 1,000
   x 100, 300 x 500, 10,000 x 512, 7 x 100 and 2,117 x 512 complex
   features, every call counted on the complex route, and
   ``masked_grad_rows`` (``csrc/lasso_grad_packed.cu`` on wgmma, f32 data
   as bf16x6 products, bf16 data in one limb) on a dense 0/1 mask (its
   weighted instance) at 1,000 x 1,000 F = 100 and a ragged 333 x 257 F = 7
   in f32 and bf16, on a packed mask (its bits instance) and on weights in
   [0.5, 1) (its weighted instance) with f32 and bf16 data at 1,000 x
   1,000 F = 100, 333 x 257 F = 7 (N % 4 != 0: my's and the weights'
   padded copies), 7 x 1,000 F = 100 (fewer rows than a stripe), F = 1,
   F = 64 (the 64-feature tile) and on log-normal my, x and a at 100,000 x
   1,024 F = 128 (the weighted route with log-normal weights over four
   decades, also against f64), each within the limit of its dtype (f32,
   bf16) of the twin with a bit-identical rerun, bf16 bits also against
   the weighted instance on the same 0/1 mask, every weighted call also
   against the first design (``csrc/lasso_grad.cu``, on no route); then
   above 128 features its wide route (``csrc/grad_wide.cu``), each of its
   four instances (f32 and bf16; the mask's bits, and weights in [0.5, 1))
   at 1,000 x 1,000 F = 256, a ragged 333 x 257 F = 129, the gate's
   corners of its dtype (``cuda_lasso.grad_fits``: 32,768 x 1,024 at F =
   1,152 f32 and 2,432 bf16, 16,384 x 128 at F = 10,112 f32 and 20,352
   bf16) and on log-normal data at 100,000 x 1,024 F = 256 (log-normal
   weights on the weighted instances; also against f64), each within the
   limit of its dtype with a bit-identical rerun, every call counted on
   the wide route;
9b. holds ``solve_rows`` above 1,024 features, its wide route
   (``csrc/lasso_fista_wide.cu``: a thread-block cluster a group of 16
   row slots, 'high' as bf16x3 and 'highest' as bf16x6), against its twin
   as phase 9 holds the narrow kernels, at 300 x 1,025, 1,000 x 1,408
   (the momentum gate's corner), 1,000 x 1,536 (ista alone, the gate
   without momentum), 7 x 1,152 and 4,229 x 1,152, and in the complex mode
   at 300 x 513, 1,000 x 640 and 7 x 640 complex features, within
   SOLVE_LIMITS with a bit-identical rerun, every call counted on
   ``.wide_launches``; and 'highest' on a dictionary whose features span
   three decades against f64 (within 4x the full-f32 twin's error, where
   bf16x3 is not);
10. drives batch lasso at BASELINE config 2, ``lasso.solve`` on 10,000
    problems of 256 channels over 512 features (acc_ista, precision
    'high', per-problem stopping, tol 1e-4), and checks one
    ``solve_rows`` launch (on ``csrc/lasso_fista_tma.cu``), every row
    converged, the KKT conditions and the agreement with the 'highest'
    kernel run and the composition run, and prints the slot waste;
    it prints the time to tol and the marginal time per solve over a
    chain of 6, beside the bound, and times the kernel path against the
    composition path at three small batches, real and complex64;
10c. drives complex batch lasso at the JAX package's config-2-complex
    (``benchmarks/bench_split_complex.py``: 10,000 problems of 256
    complex channels over 512 complex features, complex64, acc_ista,
    'high', per-problem stopping, tol 1e-4) through ``lasso.solve``'s
    'auto' route, and checks one ``solve_rows`` launch on the complex
    route (on ``csrc/lasso_fista_tma.cu``), every row converged, the
    complex KKT conditions and the agreement with the 'highest' kernel run
    and the composition run; it
    prints the time to tol, the marginal per solve over a chain of 6 and
    the bound, and checks that ``lasso.solve_streaming`` takes the same
    kernel once per chunk;
10d. drives batch lasso on the wide route at config 2's recipe over
    1,408 features (704 channels; F = 2N at the momentum gate's corner)
    and over 640 complex features (320 channels), acc_ista, 'high',
    per-problem stopping, tol 1e-4: one ``solve_rows`` launch each on
    ``csrc/lasso_fista_wide.cu``, every row converged, the KKT
    conditions, the agreement with the 'highest' kernel run and the
    composition run, the time to tol, the marginal per solve over a chain
    of 6 beside the bound, the slot waste and ``solve_rows`` per call
    against its twin on the path's inputs; ``lasso.solve_streaming`` on
    the wide route once a chunk; and ``dictionary_learning.solve(
    use_kernel=True)`` with 1,152 atoms, its inner coding on the wide
    route in the fixed budget, once an outer iteration;
11. drives the masked lasso, ``lasso.solve(mask=...)`` at 100,000 x
    1,024, F = 128, 30% missing, 50 FISTA iterations in f32 and in bf16,
    and checks one ``masked_grad_rows`` launch per iteration (f32 and
    bf16: all on the packed route), a falling objective and the agreement
    with the composition run; then 10 iterations in f32 and in bf16 on a
    weighted mask, all on the dense route (the weighted instances), all
    under the default ``use_kernel='auto'``, each timed against
    ``use_kernel=False`` (the f32 pair is the measurement behind 'auto''s
    gate for weighted f32 masks) with the same checks;
12. times the lasso kernels against their twins: ``solve_rows`` per
    config-2 solve ('high', and 'highest' on ``csrc/lasso_fista.cu``) and
    at 262,144 x 512 for 100 fixed-budget iterations,
    its complex mode per config-2-complex solve, each in turns with
    ``csrc/lasso_fista.cu``'s 'high' path on the same inputs (bit for
    bit first) and with the slot waste (slot-iterations over the
    iterations the rows needed); both designs at 100 fixed-budget
    iterations on one block's rows, one full wave's and (complex) 262,144
    rows; both designs at the narrower shapes that 'high' also sends to
    the new kernel (the crossover's batches, real and complex, 1,000 x
    200, 300 x 1,000 and 300 x 500 complex, dictionary learning's 'whole'
    inner coding at config 3's shape); ``masked_grad_rows`` at 100,000 x
    1,024, F = 128, f32 and bf16, on the packed route (a 0/1 mask's bits)
    and on the weighted one (weights in [0.5, 1)), each held to its twin
    and f64 and timed in turns with the first design (``csrc/lasso_grad.cu``)
    on the same inputs, beside its bound; and its wide route at 100,000 x
    1,024, F = 256 (f32 and bf16, bits and weights), at the f32 corner
    32,768 x 1,024, F = 1,152, at config 3's 20,000 x 64, F = 256 (f32
    and bf16) and at the f32 corner at N = 128, 16,384 x 128, F = 10,112,
    each in turns with the composition that
    use_kernel=False runs, beside its bound and, apart, E's round trip to
    device memory;
13. holds the dictionary-learning kernels against their twins:
    ``bcd_sweep``'s register route (``csrc/dl_bcd_sm90.cu``) at K = 256,
    N = 64 (config 3, and the largest K x N of its one instance), a
    ragged K = 37, N = 50, ragged 256 x 61 and 250 x 64, 256 x 64 with one
    all-zero atom, which must be kept, and (after phase 14) on config 3's
    final statistics, and bit for bit where its division leaves the fast
    path (subnormal quotients, a tie at the least subnormal, an infinite
    norm); its cluster route (``csrc/dl_bcd_cluster.cu``, one
    thread-block cluster) just past the register route (256 x 65, 257 x
    64), at phase 14b's 256 x 208, at 256 x 1,024, at the TPU gate's
    three corners (256 x 3,712, 8 x 98,176, 1,736 x 128), at a ragged 300
    x 777, and at 40 x 20,000 and 16 x 50,000, with an all-zero atom on
    every instance of the kernel and every home of d (256 x 208, 256 x
    3,712, 8 x 98,176 and the last two); the first design, ``csrc/dl_bcd.cu``
    (on no route), on 256 x 64 through its private launch; each launch
    checked on its route;
    ``masked_grad_dict`` on a dense 0/1 mask (the weighted instance of
    ``csrc/grad_dict_packed.cu``) at 1,000 x 1,000 K = 100 and a ragged 333
    x 257 K = 7, in f32 and bf16, and on a packed mask with f32 data
    (``csrc/grad_dict_packed.cu``, bf16x6 products on wgmma) at 1,000 x
    1,000 K = 100, 333 x 257 K = 7 (the KT = 64 instance) and on
    log-normal my, x and d at 100,000 x 1,024 K = 128, within the f32
    limit of the full-f32 twin, with x's limbs from its split launch
    held bit for bit to ``cuda_mu.column_limbs``, and on a packed mask with
    bf16 data (its one-limb instance) at phase 9's packed shapes (K = 100,
    7 and 1: x's padded copy) and log-normal data, within the bf16 limit
    of the twin and against the weighted instance; and on weights (the
    weighted instances, f32 and bf16) as phase 9's, each also against the
    first design (``csrc/mu_kl_stats.cu``'s GRAD_DICT, on no route); each
    with a bit-identical rerun; above 128 atoms its wide route
    (``csrc/grad_wide.cu``) as phase 9's, and x's limbs from its split
    launch at K = 300 and 1,152, bit for bit against ``column_limbs``;
14. drives dictionary learning at BASELINE config 3,
    ``dictionary_learning.solve`` on bench.py's 20,000 x 64 patches with
    256 atoms (alpha 0.05, tol 1e-5, 60 outer iterations, lasso_iter 15,
    precision 'high'), and checks one ``bcd_sweep`` launch per outer
    iteration, all on the register route and none on the cluster one,
    none of the masked kernels, unit atoms, a falling objective and
    the agreement with the composition run; it prints the time per solve,
    the marginal per solve over a chain of 6 beside the sweep's share of
    it, and the device's busy share from one ``torch.profiler`` run; then
    (14b) dictionary learning on 20,000 x 208 data, 256 atoms, 5 outer
    iterations, whose every sweep takes the cluster route; and (14c)
    ``dictionary_learning.solve`` on 100,000 x 1,024 f32 (masked DL's data
    width, config 3's 256 atoms), 5 outer x 15 inner iterations at tol 0,
    'high': every sweep on the cluster route, d against the same run with
    ``_bcd_kernel=False`` (the host loop), unit atoms, both runs timed;
15. drives masked dictionary learning at 100,000 x 1,024, 128 atoms, 30%
    missing (planted: unit atoms, truth 10% sparse, 0.01 noise), 20 outer
    iterations at tol 0 with lasso_iter 15 in f32, then 10 in bf16, and
    checks ``niter`` launches of ``masked_grad_dict`` and ``niter x 15``
    of ``masked_grad_rows`` (f32 and bf16: both on the packed route), a
    falling objective and the agreement with the composition run; then 2
    outer iterations in f32 and in bf16 on a weighted mask, both gradients
    on the dense routes (the weighted instances), each timed against the
    composition with the same checks;
15b. times the dictionary-learning kernels against their twins per call,
    with their bounds: ``bcd_sweep`` on config 3's statistics, the
    register route in turns with the first design (``csrc/dl_bcd.cu``) on
    the same inputs (old, new, new, old), each per sweep, per atom and as a
    share of config 3's marginal per solve; the cluster route in turns
    with the first design at 256 x 208, and against the twin at 256 x
    1,024 and the gate's three corners, each per sweep and per atom
    beside its bound; ``masked_grad_dict`` at 100,000 x 1,024, K = 128 on
    phase 15's factors as phase 12's ``masked_grad_rows`` (f32 and bf16,
    packed and weighted, each in turns with the first design,
    ``csrc/mu_kl_stats.cu``'s GRAD_DICT), with the f32 packed route's
    passes from ``torch.profiler``; and its wide route as phase 12's;
15c. drives masked dictionary learning at phase 15's 100,000 x 1,024,
    30% missing, with config 3's 256 atoms (planted as phase 15's data): 5
    outer x 15 inner iterations at tol 0 in f32 and in bf16, then 2 in f32
    and in bf16 on weights in [0.5, 1), each under 'auto' where its rule
    takes the dtype (``lasso._auto_width``) and use_kernel=True where it
    does not, every gradient launch on the wide route
    (``csrc/grad_wide.cu``), with phase 15's checks (a falling objective,
    the agreement with the composition run), each timed against it;
16. drives ``nmf.solve(method='hals')``: at BASELINE config 1 (planted
    1000 x 500 rank 10 f32) HALS and MU from the same factors, each to its
    own stop at tol 1e-4 and at equal iteration counts, with their
    objectives (BASELINE.md:110's claim; MU's launches all on
    ``csrc/mu_dense_packed.cu``), and HALS on the card against
    HALS on the CPU from the same inputs; then 100,000 x 1,024 f32, rank
    128, 10 iterations at tol 0: ms per iteration by CUDA events, split
    into the products A, B, C, E and the two component sweeps, the device's
    busy share and the launches per iteration from ``torch.profiler``,
    and checks a falling objective, nonnegative finite factors and a
    bit-identical rerun;
17. drives minibatch NMF at 100,000 x 1,024 f32, rank 128, minibatch
    8,192, forget 0.9, 50 iterations at tol 0, MU and KL-MU, dense and 30%
    missing: ms per iteration, a falling objective and a bit-identical
    seeded rerun;
18. drives ``utils.checkpoint.checkpointed_solve`` into a temporary
    directory: config 4's masked MU (bf16 data, f32 factors, the packed
    ``mu_stats_masked`` route) for 100 iterations as four chunks of 25 and
    as an interrupted run resumed by a second call, and config 2's
    per-problem acc_ista on ``solve_rows`` in chunks of 100, each equal to
    its straight run bit for bit (row for row in x and niter), with the
    routes and the ms a snapshot costs;
19. drives config 5' (bench.py:232-291) out of core:
    ``nmf.solve_streaming`` in loader mode over 16 chunks of 65,536 rows of
    a 1,048,576 x 10,112 bf16 matrix that a loader makes on the card from a
    generator seeded by the chunk's offset (relu(x_t d_true)), rank 128,
    f32 factors: the streamed run against the in-core ``nmf.solve`` from
    the same x0 and d0 on the same y (materialised from the loader), 2
    iterations; a seeded 5-epoch run with one ``mu_stats_dense`` launch per
    chunk, all on the TMA route, finite nonnegative factors, ms per epoch
    split into loader, kernels and the rest against in-core ms per
    iteration, and the peak device memory;
20. drives ``nmf.masked_completion_streaming`` at config 4's shape (f32
    loaders as bf16 chunks of 16,384 rows, a ragged 1,696-row tail, f32
    factors), uncached and with every chunk cached (the same trajectory):
    every launch on the packed route, held-out error < 5e-2, the time to
    stop against phase 6's, and the device's busy share and launches per
    epoch from ``torch.profiler``; KL-MU in loader mode at 100,000 x 1,024
    f32, rank 128, dense and 30% missing, 5 epochs (one ``kl_stats_dense``
    or packed ``kl_stats_masked`` launch per chunk, a falling objective);
    and a host-array (numpy) run with the host-to-device copy of a chunk;
21. drives ``dictionary_learning.solve_streaming``: config 3 in chunks of
    4,096 at lasso_tol 0 for 5 outer iterations, host-array path and
    loader mode (one ``bcd_sweep`` launch per outer iteration on the
    register route, d against the in-core solve, ms per outer iteration
    against in-core); masked DL at 100,000 x 1,024, 128 atoms, 30%
    missing, chunks of 16,384, 3 outer iterations in loader mode (every
    ``masked_grad_rows`` and ``masked_grad_dict`` launch on the packed
    route, a falling objective) and one ``stop='heldout'`` run; then the
    same 3 outer iterations on a weighted mask under ``use_kernel='auto'``
    (every gradient on the dense route, the weighted instances), in turns
    with ``use_kernel=False`` and against it;
22. drives the sharded solves of ``decomp_tpu_torch.parallel``: (a) a
    world of 1 over NCCL in this process (a ``FileStore`` in a temporary
    directory, no network): ``parallel.nmf.solve`` at the main path's
    1,048,576 x 10,112 from phase 4's start must give phase 4's x and d
    bit for bit with 20 TMA launches, and ``masked_completion(mesh=)`` at
    config 4 phase 6's stop and bits, each timed against its phase; (b)
    a world of 2 over gloo on the one card (NCCL takes one rank per
    device), spawned by ``parallel._spawn`` after the kernels are built
    and phase 4's matrix is freed: each rank makes only its own rows from
    a seed per row chunk, and dense MU at the main path's width, config
    4, KL-MU dense and masked, config 2 on the whole-solve kernel, config
    3 and masked DL are held against the in-core solve on the same data
    (the limits ``SHARD_*``; config 2's rows bit for bit against a
    one-process solve of them), with each rank's launches per route, d
    the same bits on both ranks (``all_gather``), config 4's held-out
    reserve against the global draw's, and the time per iteration or
    solve a rank with the all-reduce's share (``torch.profiler``, and
    each all-reduce timed alone). A ``{"sharded": [...]}`` line holds it.
    Phase 23, on the same worlds, drives the sharded out-of-core solvers;
24. drives the solver artifacts of ``utils.aot``: (24a) on phase 22's
    world of 2, ``parallel.nmf.solve`` at the main path's width exported
    on each rank, serialized and loaded back, equal to the rank's live
    solve bit for bit with 20 TMA launches, pinned to the rank's block;
    then the main path's ``nmf.solve`` (phase 4's data and call) exported
    and saved, its size and carried libraries printed (it must carry
    ``mu_dense_tma``), and loaded in this process: equal to the live solve
    bit for bit, every launch on the TMA route; a cold serving process (a
    subprocess on a copy of ``decomp_tpu_torch/`` without ``_build/``,
    after this process freed its data) loads the artifact and serves the
    same seeded data: d and x equal by SHA-256, its ``_build/`` holding
    only the artifact's libraries and no nvcc log, the time to load plus
    the first call beside phase 1's build time; and config 4's
    ``masked_completion`` (packed ``mu_stats_masked``) and config 2's
    ``lasso.solve`` (``solve_rows``) round trips, bit-equal, and a masked
    ``lasso.solve`` with 256 features (4,096 x 1,024 f32), whose artifact
    carries ``grad_wide`` and whose every launch takes the wide route,
    bit-equal. An ``{"aot": {...}}`` line holds it.

Each path runs with every launch count set to 0 just before it and read
just after. It exits non-zero on any failure, without a CUDA device, and
where the package is absent. The line before the last is a JSON summary
of the kernels (the eight, and ``solve_rows``' complex mode, the packed
and weighted routes of ``masked_grad_rows`` and ``masked_grad_dict`` in
f32 and in bf16, f32 dense MU's
``csrc/mu_dense_packed.cu``, f32 masked MU's ``csrc/mu_masked_f32.cu``,
the wide routes of the masked gradients, of MU and of KL-MU
(``csrc/grad_wide.cu``, ``csrc/mu_wide.cu``) and the cluster route of
``bcd_sweep`` as entries of
their own),
each with
its bound: the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its operations
over the H100's peak for their type: 989 TFLOP/s for bf16 on the tensor
cores; f32 products at f32 accuracy as bf16x6 limb products on the
tensor cores (6 passes each, 3 against a 0/1 mask, at 989 TFLOP/s; the
full-f32-FMA bound at 67 TFLOP/s is printed beside it). The last line
is ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Relative Frobenius error of each output, kernel vs twin on the card. Both
# quantise the operands at the same points and sum in f32, in another
# order (the kernel's tensor-core sums are added stage by stage). Measured
# on an H100 80GB HBM3 at 700 W: at most 1.05e-5 for bf16 (bf16-stored x,
# where a one-ulp f32 difference can flip a bf16 rounding) and 3.8e-7
# for f32; the limits keep a 5x margin over those.
LIMIT = {torch.bfloat16: 5e-5, torch.float32: 2e-6}
# The masked-MU and KL kernels' x_new stored in bf16: the same one-ulp
# flips, but more of them (the masked denominator and the KL ratio are
# themselves rounded to bf16 before the x update's products). Measured on
# an H100 80GB HBM3 at 700 W: up to 4.63e-5 (masked MU, 65,536 x 10,112
# K = 128) and 4.33e-5 (KL masked); the limit keeps a 4.3x margin. Their
# statistics, and x_new stored in f32, keep LIMIT (measured <= 2.8e-6
# with bf16 data, <= 4.1e-7 f32).
X_BF16_LIMIT = 2e-4
# solve_rows against its twin on the card, relative Frobenius of x.
# 'highest' (full f32 FMAs) gave the twin's bits at F = 200 and 512; at
# F = 1,000 (two 512-column chunks) cuBLAS sums in another order, and
# a row may stop an iteration apart. 'high' (bf16x3) sums its three
# products per 16-deep tile in another order than the twin's three whole
# products, so a row whose relative change hovers at tol may stop an
# iteration apart, and an acc_ista restart may flip. Measured on an H100
# 80GB HBM3 at 700 W over three runs at 1,000 x 200, 300 x 1,000 and
# 10,000 x 512: niter equal on >= 98.7% of rows, those rows within
# 1.13e-5, all rows within 1.10e-4, and the fixed budget (37 iterations,
# no stopping) within 1.65e-4 for x and z. The limits keep a margin of
# 4x or more (6% of rows for niter).
SOLVE_LIMITS = {"nit_eq": 0.94, "eq_rows": 5e-5, "all_rows": 5e-4,
                "fixed": 7e-4}
# The complex mode holds the same limits. Measured on an H100 80GB HBM3 at
# 700 W at 1,000 x 100c, 300 x 500c and 10,000 x 512c (Fc complex
# features, 2 Fc reals): niter equal on >= 98.6% of rows, those rows within
# 5.99e-6, all rows within 5.36e-5, and the fixed budget within 1.19e-4
# for x and z (an acc_ista restart that flips in one row); 'highest' gave
# the twin's bits at Fc = 100 and 512. A margin of 4x or more.
# Phase 9b's wide route of solve_rows (csrc/lasso_fista_wide.cu), (M, F,
# N): a ragged F just past the narrow kernels, the momentum gate's corner,
# the gate without momentum (ista alone), fewer rows than one cluster's 16
# slots, and a queue ragged past six rounds of 44 clusters' slots (4,229 =
# 6 x 704 + 5); complex (M, Fc, Nc): just past 512, the gate's 640, 7 rows.
# Held to SOLVE_LIMITS: no kernel has bits to match above 1,024 features.
WIDE_SOLVE_SHAPES = ((300, 1025, 700), (1000, 1408, 704), (1000, 1536, 768),
                     (7, 1152, 576), (4229, 1152, 576))
WIDE_SOLVE_COMPLEX = ((300, 513, 350), (1000, 640, 320), (7, 640, 320))
# Phase 9b's log-normal check of 'highest' (bf16x6) against f64: 37 ista
# steps at 1,000 x 1,152 on a dictionary whose features span three decades
# (the Gram six); x within 4x the full-f32 twin's own error against f64.
WIDE_F64_SHAPE = (1000, 1152, 576)
# masked_grad_rows against its twin (measured on the H100: 4.6e-7 f32,
# 5.6e-5 bf16, where the residual is rounded to bf16 before the second
# product and a one-ulp f32 difference flips a rounding); 4x margin. The
# packed route's bf16x6 products are held to the same f32 limit.
GRAD_LIMIT = {torch.float32: 2e-6, torch.bfloat16: 2.5e-4}
# The packed-mask gradients' shapes in phases 9 and 13, (M, N, F or K):
# N = 257 needs my's padded copy, 7 rows are fewer than a stripe, F = 1
# and 64 take the 64-wide tile; bf16 x (dictionary) is padded where K % 8.
GRAD_PACKED_SHAPES = ((1000, 1000, 100), (333, 257, 7), (7, 1000, 100),
                      (1000, 1000, 1), (1000, 1000, 64))
# The wide route's shapes in phases 9 and 13 (M, N, F or K): 256 wide, a
# ragged 333 x 257 at 129 (the first width past the fused tile), and the
# gate's corners (cuda_lasso.grad_fits) for each dtype, M cut so that x
# fits: f32 F <= 1,152 and bf16 F <= 2,432 at N = 1,024, 10,112 and 20,352
# at N = 128.
WIDE_SHAPES = ((1000, 1000, 256), (333, 257, 129))
WIDE_CORNERS = {torch.float32: ((32768, 1024, 1152), (16384, 128, 10112)),
                torch.bfloat16: ((32768, 1024, 2432), (16384, 128, 20352))}
# Phases 12 and 15b's wide times: 256 wide at phase 15c's 100,000 x 1,024
# (the kernels line's entries), the f32 corner at N = 1,024, config 3's
# 20,000 x 64 with 256 atoms, and the f32 corner at N = 128 (M cut to
# 16,384): the shapes behind 'auto''s rule (lasso._auto_width).
WIDE_TIME_SHAPES = (((100_000, 1024, 256), (torch.float32, torch.bfloat16)),
                    ((32768, 1024, 1152), (torch.float32,)),
                    ((20_000, 64, 256), (torch.float32, torch.bfloat16)),
                    ((16384, 128, 10112), (torch.float32,)))
# Phase 4c's wide-rank MU (csrc/mu_wide.cu) against its twins, (M, N, K,
# inner_iter): ragged shapes at K in {129, 200, 256} (masked: inner 1), and
# the gate's corners in f32 (cuda_mu.rank_fits: K = 1,280 dense and 640
# masked at N = 1,024; 10,624 and 6,272 at N <= 128, on few rows).
WIDE_RANK_SHAPES = ((1000, 1000, 256, 1), (1000, 1000, 200, 3),
                    (333, 257, 129, 1), (1000, 1000, 129, 3))
WIDE_RANK_CORNERS = {"dense": ((2048, 1024, 1280), (512, 128, 10_624)),
                     "masked": ((2048, 1024, 640), (512, 128, 6272))}
# Phase 4c's path: 100,000 x 1,024 at rank 256, inside every gate; the
# masked run's held-out stop (tol, iteration cap).
WIDE_RANK_PATH = (100_000, 1024, 256)
WIDE_RANK_STOP = (1e-3, 2000)
# Phase 4d's wide-rank KL-MU (csrc/mu_wide.cu's KL entries) against its
# twins, (M, N, K): K = 256 and 200, and a ragged 333 x 257 at 129 (also
# with eps = 0); log-normal data at 65,536 x 1,024, K = 200; the KL gate's
# f32 corners (cuda_mu.rank_fits with kl_dense / kl_masked), (M, N) ->
# (dense K, masked K on bits, on weights).
KL_WIDE_SHAPES = ((1000, 1000, 256), (1000, 1000, 200), (333, 257, 129))
KL_WIDE_LOGNORMAL = (65536, 1024, 200)
KL_WIDE_CORNERS = {(4096, 128): (4480, 3456, 3456),
                   (32768, 1024): (512, 384, 384)}
# Config 2 (acc_ista, tol 1e-4, 'high'), measured on the H100: x of
# solve_rows against its twin on config 2's inputs 6.8e-4 (their niter
# agree on only ~56% of rows: config 2's unnormalised dictionary, L ~
# 1,400, leaves many rows' relative change near tol for several
# iterations); x of the lasso.solve run against the 'highest' kernel run
# and the composition run 8.8e-4 (two stopping points a relative change
# of 1e-4 apart); the KKT residual per row over L tol |x| at most 0.96
# (0.96 for the composition run too). Limits with a margin of 4x or more.
C2_TWIN_LIMIT = 3e-3
C2_X_LIMIT = 4e-3
C2_KKT_LIMIT = 4.0
# Config-2-complex (the same call on complex64 data), measured on the H100:
# x of solve_rows against its twin 8.8e-4 (niter equal on 98% of rows);
# x of the lasso.solve run against the 'highest' kernel run and the
# composition run 5.2e-3 (two stopping points a relative change of 1e-4
# apart, on a dictionary with L ~ 3,000); the KKT residual per row over L
# tol |x| at most 1.0 (1.0 for the composition run too). Limits with a
# margin of 4x or more.
C2C_TWIN_LIMIT = 4e-3
C2C_X_LIMIT = 3e-2
C2C_KKT_LIMIT = 4.0
# Phase 10d: config 2's recipe at the wide route's corners, (M, F, N):
# 10,000 problems over 1,408 features (F = 2N, the momentum gate's corner),
# and over 640 complex features, held to the KKT limits above and to x
# limits of their own. Measured on an H100 80GB HBM3 at 700 W over seeds 1
# to 5 (tools/solve_wide_turns.py): two runs of f32 accuracy stop a
# relative change of 1e-4 apart on dictionaries with L ~ 4,100 (config 2's
# ~1,400), so config 2's x limits do not carry over. Real: x of the
# lasso.solve run against the 'highest' kernel run and the composition run
# at most 9.40e-3 ('highest' against the composition 4.53e-3), solve_rows
# against its twin 4.51e-3 (niter equal on 56-58% of rows). Complex: x
# against those runs at most 2.38e-2 ('highest' against the composition
# 1.46e-2), against the twin 1.21e-2 (niter equal on 98%). Limits with a
# margin of 2x or more. Stopping noise hides a kernel's precision at tol
# 1e-4; what the limits do catch, a stopping fault (the twin at tol 1e-3)
# lands 0.30 to 0.50 away, and a Gram cut to one bf16 limb diverges. The
# products' precision is held on the same inputs in the fixed budget
# (WIDE_PATH_FIXED_ITERS iterations): within 1.9e-4 of the twin, under
# SOLVE_LIMITS, while the twin on a one-limb Gram lands 0.12 away.
C2W_SHAPE = (10_000, 1408, 704)
C2WC_SHAPE = (10_000, 640, 320)
C2W_TWIN_LIMIT = 1e-2
C2W_X_LIMIT = 2e-2
C2WC_TWIN_LIMIT = 3e-2
C2WC_X_LIMIT = 5e-2
WIDE_PATH_FIXED_ITERS = 50
# Phase 10d's dictionary learning with 1,152 atoms against the composition
# (d and x after 2 outer iterations; measured 1.33e-6 d, 1.83e-6 x over
# three seeds on the H100).
WIDE_DL_LIMIT = 2e-5
# The masked lasso's x, kernel path against composition path after 50
# iterations (measured 7.1e-8 f32; 2.7e-3 bf16, where the composition
# rounds each product to bf16 and the kernel forms the residual in f32).
MASKED_X_LIMIT = {torch.float32: 5e-7, torch.bfloat16: 2e-2}
# bcd_sweep against its twin (relative Frobenius of d after one sweep on
# unit atoms, A = x^T x from random x): the kernels sum a_k d in another
# order than cuBLAS. Measured on the H100 at 700 W: csrc/dl_bcd.cu at most
# 7.3e-7 over K x N = 256 x 64, 37 x 50, 256 x 208, 16 x 3,000 and 1,024 x
# 52; csrc/dl_bcd_sm90.cu at most 7.9e-7 over 256 x 64, 37 x 50, 256 x
# 61, 250 x 64, 32 x 64 and 200 x 16 (2.2e-6 to 3.6e-6 at 5 x 3, where
# one rounding is a large share of 15 entries); csrc/dl_bcd_cluster.cu
# at most 7.5e-7 over 256 x 65, 257 x 64, 256 x 208, 256 x 1,024, 300 x
# 777 and the TPU gate's corners.
BCD_LIMIT = 5e-6
# Config 3: d of the kernel run against the composition run after 60
# outer iterations (measured 2.5e-6, x 1.0e-5), and the atoms' norms;
# phase 14c's d against its host-loop run after 5 (measured 6.7e-7).
C3_D_LIMIT = 2.5e-5
UNIT_LIMIT = 1e-5
# Masked dictionary learning, kernel path against composition path (d and
# x after 20 f32 / 10 bf16 outer iterations; measured 1.7e-7 f32, 8.2e-3
# bf16, where the composition rounds each product to bf16).
MASKED_DL_LIMIT = {torch.float32: 2e-6, torch.bfloat16: 5e-2}
# HALS on the card against HALS on the CPU, config 1 from the same
# factors, HALS_CPU_ITERS iterations: f32 products summed in other orders
# (cuBLAS against the CPU's BLAS); the limit is the f32 parity limit of
# tests/test_torch_nmf_hals.py, where 30 iterations measured 2.6e-6.
HALS_CPU_ITERS = 20
HALS_CPU_LIMIT = 1e-4
# Config 5' streamed against in-core from the same start, 2 iterations:
# the chunks' f32 statistics sum in another order than the in-core
# kernel's partials (relative Frobenius of d and x; measured on an H100
# 80GB HBM3 at 700 W: 4.1e-7 d, 3.6e-7 x).
STREAM_LIMIT = 1e-5
# Config 3 streamed (host-array path and loader mode) against in-core, 5
# outer iterations at lasso_tol 0: per-chunk products and statistic sums
# in other orders (relative Frobenius of d; measured on the H100: 1.09e-6).
DL_STREAM_LIMIT = 1e-5
EPS = 1e-6
SOURCES = ("mu_stats_dense", "mu_dense_tma", "mu_kl_stats", "mu_masked_packed",
           "kl_masked_packed", "kl_dense_packed", "lasso_fista",
           "lasso_fista_tma", "lasso_grad", "lasso_grad_packed", "dl_bcd",
           "dl_bcd_sm90", "dl_bcd_cluster", "grad_dict_packed",
           "mu_dense_packed", "mu_masked_f32", "grad_wide", "mu_wide",
           "lasso_fista_wide")
# name -> (source, masked, the TPU kernel it replaces)
NEW_KERNELS = {
    "mu_stats_masked": ("mu_masked_packed", True, "pallas_mu.py:522"),
    "kl_stats_dense": ("kl_dense_packed", False, "pallas_mu.py:603"),
    "kl_stats_masked": ("kl_masked_packed", True, "pallas_mu.py:678"),
}
# The H100's data-sheet rates (SXM, dense) that bound a kernel.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound(nbytes, ops, dtype):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` and do ``ops`` operations of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_bounds(nbytes, ops, mask_ops=0.0):
    """The two bounds of f32 work, (bf16x6, f32 FMA): ``ops`` counts its
    products' operations (2MNK for each M x N x K product), ``mask_ops``
    those of the products whose one operand is a 0/1 mask. At f32 accuracy
    the products run as bf16x6 limb products on the tensor cores (the
    TPU's Precision.HIGHEST): 6 bf16 passes each, 3 against a 0/1 mask
    (exact in bf16), at 989 TFLOP/s; the second bound is full-f32 FMAs at
    67 TFLOP/s. The first is the least time, so it is the kernels' bound."""
    return (bound(nbytes, 6.0 * ops - 3.0 * mask_ops, torch.bfloat16),
            bound(nbytes, ops, torch.float32))


def dtype_bounds(nbytes, ops, dtype):
    """(bound, f32-FMA bound or None) of ``ops`` product operations on
    ``dtype`` operands: bf16 on the tensor cores, f32 as ``f32_bounds``."""
    if dtype == torch.float32:
        return f32_bounds(nbytes, ops)
    return bound(nbytes, ops, dtype), None


def bound_text(b, fma):
    return (f"{b[0]:.3f} ms ({b[1]})"
            + (f", f32-FMA bound {fma[0]:.3f} ms" if fma else ""))


def stats_bound(name, m, n, k, ydt, xdt, packed=False, fma=False):
    """The bound of one NMF statistics kernel call: y (and the mask) read
    once, x read and x_new written, d read, the statistics written; its
    products on the data's type, f32 as bf16x6 (``f32_bounds``; ``fma``:
    as full-f32 FMAs instead). ``packed``: the mask is read as its bits,
    4 bytes per row per ``packed_words`` word."""
    from decomp_tpu_torch.ops.cuda_mu import packed_words

    masked = name.endswith("masked")
    mask_bytes = (m * packed_words(n) * 4 if packed
                  else m * n * ydt.itemsize if masked else 0)
    nbytes = (m * n * ydt.itemsize + mask_bytes
              + 2 * m * k * xdt.itemsize + k * n * ydt.itemsize
              + (2 if masked else 1) * k * n * 4)
    mask_ops = 0.0
    if name == "mu_stats_dense":   # y d^T, x_new^T y; x ddt, x_new^T x_new
        ops = 4.0 * m * n * k + 4.0 * m * k * k
        if ydt == torch.float32 and not fma:
            # bf16x6: y d^T, x_new^T y and x_new^T x_new, 24 MNK + 12 MK^2;
            # x ddt stays f32 FMAs (csrc/mu_dense_packed.cu)
            return bound(nbytes, 6.0 * (ops - 2.0 * m * k * k),
                         torch.bfloat16)
    else:                          # 2MNK for each M x N x K product
        ops = {"mu_stats_masked": 12, "kl_stats_dense": 8,
               "kl_stats_masked": 12}[name] * float(m) * n * k
        if name == "kl_stats_masked":   # mask d^T and x_new^T mask
            mask_ops = 4.0 * m * n * k
    if ydt != torch.float32:
        return bound(nbytes, ops, ydt)
    return f32_bounds(nbytes, ops, mask_ops)[1 if fma else 0]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def wide(t):
    """``t`` in f64, or complex128 for complex data."""
    return t.to(torch.complex128) if t.is_complex() else t.double()


def rel_fro(a, b):
    a, b = wide(a), wide(b)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def max_abs(outs, refs):
    return max(float((wide(a) - wide(b)).abs().max())
               for a, b in zip(outs, refs))


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def flops_per_iter(m, n, k):
    """One MU iteration: 4MNK + 4MK^2 + 4NK^2 (as bench.py counts it)."""
    return 4.0 * m * n * k + 4.0 * m * k * k + 4.0 * n * k * k


def phase(name, t0):
    print(f"[phase {name}: {time.perf_counter() - t0:.1f} s wall]",
          flush=True)
    return time.perf_counter()


def compare(cuda_mu, gen, dev, m, n, k, inner, ydt, xdt):
    """mu_stats_dense against its twin: bf16 data take the TMA route
    (csrc/mu_dense_tma.cu), f32 data csrc/mu_dense_packed.cu."""
    y = torch.rand((m, n), generator=gen, device=dev, dtype=ydt)
    x = 0.1 + torch.rand((m, k), generator=gen, device=dev, dtype=xdt)
    d = 0.1 + torch.rand((k, n), generator=gen, device=dev, dtype=ydt)
    w = cuda_mu.mu_stats_dense
    before = (w.tma_launches, w.packed_launches)
    out = cuda_mu.mu_stats_dense(y, x, d, EPS, inner_iter=inner)
    again = cuda_mu.mu_stats_dense(y, x, d, EPS, inner_iter=inner)
    ref = cuda_mu.mu_stats_dense_plain(y, x, d, EPS, inner_iter=inner)
    torch.cuda.synchronize()
    tma = w.tma_launches - before[0]
    packed = w.packed_launches - before[1]
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    limits = [X_BF16_LIMIT if xdt == torch.bfloat16 else LIMIT[ydt]]
    limits += [LIMIT[ydt]] * 2
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    tag = (f"{m}x{n} K={k} inner={inner} y={str(ydt)[6:]} "
           f"x={str(xdt)[6:]} ({'TMA' if tma else 'mu_dense_packed.cu'})")
    print(f"kernel vs twin {tag}: rel_fro " + " ".join(
        f"{name}={e:.3e} (limit {lim:.0e})" for name, e, lim
        in zip(("x_new", "numd", "gram"), errs, limits))
        + f"; bit-identical rerun: {same}", flush=True)
    check((tma, packed) == ((2, 0) if ydt == torch.bfloat16 else (0, 2)),
          f"{tag}: (TMA, packed) route launches {(tma, packed)}")
    check(all(np.isfinite(errs)), f"{tag}: non-finite outputs")
    check(all(e <= lim for e, lim in zip(errs, limits)),
          f"{tag}: kernel disagrees with twin")
    check(same, f"{tag}: two kernel runs differ")
    return errs


def dense_f64(y, x, d, eps, inner=1):
    """Dense MU's statistics in f64: (x_new, numd, gram)."""
    y, x, d = y.double(), x.double(), d.double()
    num, ddt = y @ d.T, d @ d.T
    for _ in range(inner):
        x = x * num / (x @ ddt + eps)
    return x, x.T @ y, x.T @ x


def compare_dense_packed(cuda_mu, args, eps=EPS, inner=1, tag="",
                         f64=False):
    """mu_stats_dense on f32 data (csrc/mu_dense_packed.cu, bf16x6 on
    wgmma) against its full-f32 twin on ``args`` = (y, x, d): both calls
    counted on the packed route, LIMIT[f32], a bit-identical rerun, and
    d's limbs from the kernel's split launch equal to
    ``cuda_mu.column_limbs`` bit for bit. ``f64``: kernel and twin are
    also printed against f64. Returns the outputs' max abs error."""
    y, x, d = args
    w = cuda_mu.mu_stats_dense
    before = (w.packed_launches, w.tma_launches)
    out = w(y, x, d, eps, inner_iter=inner)
    again = w(y, x, d, eps, inner_iter=inner)
    ref = cuda_mu.mu_stats_dense_plain(y, x, d, eps, inner_iter=inner)
    torch.cuda.synchronize()
    moved = (w.packed_launches - before[0], w.tma_launches - before[1])
    (m, n), k = y.shape, d.shape[0]
    kt = 64 if k <= 64 else 128
    limbs = torch.equal(cuda_mu._dense_packed_limbs(d, kt),
                        cuda_mu.column_limbs(d, kt))
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    tag = (f"mu_stats_dense f32 (mu_dense_packed.cu) {m}x{n} K={k} "
           f"inner={inner}" + (f" eps={eps}" if eps != EPS else "")
           + (f" {tag}" if tag else ""))
    extra = ""
    if f64:
        wide_ref = dense_f64(y, x, d, eps, inner)
        extra = "; against f64: kernel " + " ".join(
            f"{rel_fro(a, b):.3e}" for a, b in zip(out, wide_ref)) + \
            ", twin " + " ".join(f"{rel_fro(a, b):.3e}"
                                 for a, b in zip(ref, wide_ref))
        del wide_ref
    print(f"kernel vs twin {tag}: rel_fro " + " ".join(
        f"{name}={e:.3e}" for name, e in zip(("x_new", "numd", "gram"),
                                              errs))
        + f" (limit {LIMIT[torch.float32]:.0e}); bit-identical rerun: "
        f"{same}; d's limbs == column_limbs: {limbs}{extra}", flush=True)
    check(moved == (2, 0), f"{tag}: (packed, TMA) route launches {moved}")
    check(all(np.isfinite(errs)), f"{tag}: non-finite outputs")
    check(all(e <= LIMIT[torch.float32] for e in errs),
          f"{tag}: kernel disagrees with twin")
    check(same, f"{tag}: two kernel runs differ")
    check(limbs, f"{tag}: the split launch's limbs of d differ")
    return max_abs(out, ref)


def dense_packed_passes(cuda_mu, y, x, d, card):
    """The packed dense kernel's four launches: the split reads d and
    writes its limbs (N x 3 KT bf16); the x update reads y, x and d's
    limbs and writes x_new and its limbs xc (M x 3 KT bf16); the
    statistics read y and xc and write the partials; the reduction reads
    the partials and writes numd and gram. Each data pass issues 12 MN'KT
    bf16 MMA operations (six limb products of 2 MN'KT; N' the issued
    columns, the statistics' gram tile included)."""
    (m, n), k = y.shape, d.shape[0]
    kt = 64 if k <= 64 else 128
    chunks = -(-m // cuda_mu.dense_packed_block_rows(m, n))
    mn, xb, limbs, xc = m * n * 4, m * k * 4, n * 3 * kt * 2, m * 3 * kt * 2
    size = (k * n + k * k) * 4
    nbytes = {"split_cols": k * n * 4 + limbs,
              "mu_x_update": mn + 2 * xb + limbs + xc,
              "mu_stats": mn + xc + chunks * size,
              "reduce_kernel": chunks * size + size}
    ops = {"mu_x_update": 12.0 * m * (-(-n // 32) * 32) * kt,
           "mu_stats": 12.0 * m * (-(-n // 128) + 1) * 128 * kt}
    pass_times(lambda: cuda_mu.mu_stats_dense(y, x, d, EPS), nbytes,
               f"{m}x{n} K={k} f32 ({chunks} chunks)", card, ops=ops)


def time_dense_packed(cuda_mu, args, reps, card, err_abs, tag=""):
    """f32 dense MU per call on ``args`` = (y, x, d): csrc/mu_dense_packed.cu
    in turns with the first design, csrc/mu_stats_dense.cu (old, new, new,
    old; each figure the mean of its two), the twin once, beside the
    bf16x6 and f32-FMA bounds; then each launch's device time. Returns
    (ms, the old design's ms, the twin's ms, bound)."""
    (m, n), k = args[0].shape, args[2].shape[0]
    f32 = torch.float32

    def new():
        return cuda_mu.mu_stats_dense(*args, EPS)

    def old():
        return cuda_mu._dense_mma_launch(*args, EPS)

    t = [cuda_ms(f, reps) for f in (old, new, new, old)]
    kernel_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    plain_ms = cuda_ms(lambda: cuda_mu.mu_stats_dense_plain(*args, EPS),
                       min(reps, 10))
    b = stats_bound("mu_stats_dense", m, n, k, f32, f32)
    b_fma = stats_bound("mu_stats_dense", m, n, k, f32, f32, fma=True)
    print(f"mu_stats_dense {m}x{n} K={k} data=float32 x=float32{tag}: "
          f"mu_dense_packed.cu (bf16x6, wgmma) {kernel_ms:.4f} ms "
          f"({t[1]:.4f}, {t[2]:.4f}), mu_stats_dense.cu (f32 FMA) "
          f"{old_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), plain twin "
          f"{plain_ms:.4f} ms per call; new / old {kernel_ms / old_ms:.3f}; "
          f"bound bf16x6 {b[0]:.4f} ms ({b[1]}, {b[0] / kernel_ms:.1%} of "
          f"it), f32-FMA {b_fma[0]:.4f} ms ({card}); max_abs_err "
          f"{err_abs:.3e}", flush=True)
    dense_packed_passes(cuda_mu, *args, card)
    return kernel_ms, old_ms, plain_ms, b


def stats_inputs(gen, dev, m, n, k, ydt, xdt, masked):
    """Data, mask and factors for a masked-MU or KL kernel: my = mask * y
    with y uniform in [0, 1) and 30% of the entries missing."""
    mask = (torch.rand((m, n), generator=gen, device=dev) >= 0.3).to(ydt)
    my = torch.rand((m, n), generator=gen, device=dev).to(ydt)
    if masked:
        my *= mask
    x = (0.1 + torch.rand((m, k), generator=gen, device=dev)).to(xdt)
    d = (0.1 + torch.rand((k, n), generator=gen, device=dev)).to(ydt)
    return (my, mask, x, d) if masked else (my, x, d)


def compare_new(cuda_mu, name, args, packed=False, eps=EPS, tag="", fn=None,
                route=None):
    """One of the masked-MU / KL kernels against its twin on ``args``;
    returns the outputs' max abs error. ``packed``: ``mu_stats_masked`` or
    ``kl_stats_masked`` takes the mask as its bits (the kernel of
    csrc/mu_masked_packed.cu or csrc/kl_masked_packed.cu), the twin the
    dense mask; a masked wrapper given the dense mask must take its dense
    route. ``route``: the wrapper's counter of the route the call must
    take (by default the packed or dense mask's). ``fn``: a private launch
    helper called instead of the wrapper, which must count nothing.
    ``tag`` names the inputs in the printed line."""
    wrapper = getattr(cuda_mu, name)
    kargs = args
    route = route or ("packed_launches" if packed else "dense_launches")
    if packed:
        bits = cuda_mu.pack_mask(args[1])
        check(bits is not None, "pack_mask refused a 0/1 mask")
        kargs = (args[0], bits) + tuple(args[2:])
    before = getattr(wrapper, route, 0)
    out = (fn or wrapper)(*kargs, eps)
    again = (fn or wrapper)(*kargs, eps)
    ref = getattr(cuda_mu, f"{name}_plain")(*args, eps)
    torch.cuda.synchronize()
    if hasattr(wrapper, route):
        check(getattr(wrapper, route) == before + (0 if fn else 2),
              f"{name}: {route} moved by "
              f"{getattr(wrapper, route) - before}, the call did not take "
              "its route")
    my, x = args[0], args[-2]
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    limits = [X_BF16_LIMIT if x.dtype == torch.bfloat16 else LIMIT[my.dtype]]
    limits += [LIMIT[my.dtype]] * 2
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    tag = (f"{name}{' packed mask' if packed else ''} "
           f"{my.shape[0]}x{my.shape[1]} K={x.shape[1]} "
           f"data={str(my.dtype)[6:]} x={str(x.dtype)[6:]}"
           + (f" eps={eps}" if eps != EPS else "")
           + (f" {tag}" if tag else ""))
    print(f"kernel vs twin {tag}: rel_fro " + " ".join(
        f"{e:.3e} (limit {lim:.0e})" for e, lim in zip(errs, limits))
        + f"; bit-identical rerun: {same}", flush=True)
    check(all(np.isfinite(errs)), f"{tag}: non-finite outputs")
    check(all(e <= lim for e, lim in zip(errs, limits)),
          f"{tag}: kernel disagrees with twin")
    check(same, f"{tag}: two kernel runs differ")
    return max_abs(out, ref)


def time_packed(cuda_mu, name, args, reps=10):
    """Per-call ms of the masked wrapper ``name``'s packed-mask kernel, its
    dense-mask kernel on the dense mask and its twin, on the same inputs,
    in turns (dense, packed, packed, dense; each figure the mean of its
    two)."""
    my, mask, x, d = args
    bits = cuda_mu.pack_mask(mask)
    wrapper = getattr(cuda_mu, name)

    def dense():
        return wrapper(my, mask, x, d, EPS)

    def packed():
        return wrapper(my, bits, x, d, EPS)

    t = [cuda_ms(f, reps) for f in (dense, packed, packed, dense)]
    plain = cuda_ms(lambda: getattr(cuda_mu, f"{name}_plain")(
        my, mask, x, d, EPS), 2)
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, plain


def pass_times(fn, nbytes, tag, card, calls=5, ops=None):
    """Each launch of ``fn`` whose kernel is named by a key of ``nbytes``
    (``namespace)::key`` in the profiler's name: the port's kernels live in
    anonymous namespaces, so that neither cuBLAS's splitKreduce_kernel nor
    PyTorch's at::native::reduce_kernel is taken for reduce_kernel), timed
    apart by torch.profiler over
    ``calls`` calls, beside the HBM bytes it must move and the rate that
    makes; ``ops``: the bf16 MMA operations of some of the launches, by
    the same keys, and the rate those make."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        name = next((p for p in nbytes if f"namespace)::{p}" in e.key),
                    None)
        if name is None or not str(e.device_type).endswith("CUDA"):
            continue
        ms = e.self_device_time_total / calls / 1e3
        rate = ""
        if ops and name in ops:
            rate = f", {ops[name] / ms / 1e9:.2f} TFLOP/s of bf16 MMA"
        print(f"  pass {name} {tag}: {ms:.4f} ms per call, "
              f"{nbytes[name] / 1e6:.1f} MB, {nbytes[name] / ms / 1e9:.3f} "
              f"TB/s{rate} ({card})", flush=True)


def packed_passes(cuda_mu, args, card):
    """The packed-mask kernel's three launches (x update, statistics,
    reduction): the x update reads my, the mask bits, x and d and writes
    x_new and xc = bf16(x_new) (M x KT); the statistics read my, the bits,
    xc and each N tile's d and write the partials; the reduction reads the
    partials and writes numd and dend."""
    my, mask, x, d = args
    bits = cuda_mu.pack_mask(mask)
    (m, n), k = my.shape, d.shape[0]
    kt = 64 if k <= 64 else 128
    chunks = -(-m // cuda_mu.packed_block_rows(m, n, k))
    mn, xb, words = m * n * 2, m * k * x.element_size(), bits.numel() * 4
    part = chunks * 2 * k * n * 4
    nbytes = {"x_update_packed": mn + words + 2 * xb + k * n * 2 + m * kt * 2,
              "stats_packed": mn + words + m * kt * 2 + k * n * 2 + part,
              "reduce_kernel": part + 2 * k * n * 4}
    pass_times(lambda: cuda_mu.mu_stats_masked(my, bits, x, d, EPS), nbytes,
               f"{m}x{n} K={k}", card)


def kl_packed_passes(cuda_mu, args, card):
    """The packed KL kernel's three launches: the x update reads my, the
    mask bits, x and d's three limbs and writes x_new and its limbs xc (M
    x 3 KT bf16); the statistics read my, the bits, xc and each N tile's
    limbs of d and write the partials; the reduction reads the partials
    and writes numd and dend."""
    my, mask, x, d = args
    bits = cuda_mu.pack_mask(mask)
    (m, n), k = my.shape, d.shape[0]
    kt = 64 if k <= 64 else 128
    chunks = -(-m // cuda_mu.kl_packed_block_rows(m, n))
    mn, xb, words = m * n * 4, m * k * 4, bits.numel() * 4
    limbs, xc = 3 * k * n * 2, m * 3 * kt * 2
    part = chunks * 2 * k * n * 4
    nbytes = {"kl_x_update": mn + words + 2 * xb + limbs + xc,
              "kl_stats": mn + words + xc + limbs + part,
              "reduce_kernel": part + 2 * k * n * 4}
    # Each pass: 6 + 6 + 3 bf16 passes of 2MNK at the rank tile KT.
    per_pass = 15 * 2.0 * m * n * kt
    pass_times(lambda: cuda_mu.kl_stats_masked(my, bits, x, d, EPS), nbytes,
               f"{m}x{n} K={k} ({chunks} chunks)", card,
               ops={"kl_x_update": per_pass, "kl_stats": per_pass})


def kl_dense_passes(cuda_mu, args, card):
    """The dense KL kernel's four launches: the x update reads my, x and
    d's three limbs and writes x_new, its limbs xc (M x 3 KT bf16) and the
    16-row groups' column sums; the statistics read my, xc and each N
    tile's limbs of d and write the partials; the reductions read the
    partials and write numd, and the column sums and write xsum."""
    my, x, d = args
    (m, n), k = my.shape, d.shape[0]
    kt = 64 if k <= 64 else 128
    chunks, groups = cuda_mu.kl_dense_partials(m, n)
    mn, xb = m * n * 4, m * k * 4
    limbs, xc = 3 * kt * n * 2, m * 3 * kt * 2
    part, xpart = chunks * k * n * 4, groups * k * 4
    nbytes = {"dense_x_update": mn + 2 * xb + limbs + xc + xpart,
              "dense_stats": mn + xc + limbs + part,
              "reduce_kernel": part + k * n * 4,
              "reduce_long_kernel": xpart + k * 4}
    # Each data pass: 6 + 6 bf16 passes of 2MNK at the rank tile KT.
    per_pass = 12 * 2.0 * m * n * kt
    pass_times(lambda: cuda_mu.kl_stats_dense(my, x, d, EPS), nbytes,
               f"{m}x{n} K={k} ({chunks} chunks, {groups} row groups)", card,
               ops={"dense_x_update": per_pass, "dense_stats": per_pass})


def masked_f64(my, mask, x, d, eps):
    """mu_stats_masked's function in f64: (x_new, numd, dend)."""
    my, mask, x, d = my.double(), mask.double(), x.double(), d.double()
    x_new = x * (my @ d.T) / ((mask * (x @ d)) @ d.T + eps)
    return x_new, x_new.T @ my, x_new.T @ (mask * (x_new @ d))


def compare_masked_f32(cuda_mu, args, eps=EPS, tag="", f64=False):
    """mu_stats_masked on f32 data with the mask's bits
    (csrc/mu_masked_f32.cu, bf16x6 on wgmma) against its full-f32 twin on
    ``args`` = (my, mask, x, d): ``compare_new`` with both calls counted
    in ``.f32_launches`` (LIMIT[f32], a bit-identical rerun); ``f64``:
    kernel and twin also against the function in f64, the kernel held to
    LIMIT[f32] there too. Returns the outputs' max abs error."""
    err = compare_new(cuda_mu, "mu_stats_masked", args, packed=True,
                      eps=eps, tag=tag, route="f32_launches")
    if f64:
        my, mask, x, d = args
        out = cuda_mu.mu_stats_masked(my, cuda_mu.pack_mask(mask), x, d, eps)
        ref = cuda_mu.mu_stats_masked_plain(my, mask, x, d, eps)
        wide_ref = masked_f64(my, mask, x, d, eps)
        e_k = [rel_fro(a, b) for a, b in zip(out, wide_ref)]
        e_t = [rel_fro(a, b) for a, b in zip(ref, wide_ref)]
        del out, ref, wide_ref
        print(f"  against f64 ({tag}): kernel " + " ".join(
            f"{e:.3e}" for e in e_k) + ", twin " + " ".join(
            f"{e:.3e}" for e in e_t) + f" (limit {LIMIT[torch.float32]:.0e})",
            flush=True)
        check(all(e <= LIMIT[torch.float32] for e in e_k),
              f"mu_stats_masked f32 {tag}: kernel disagrees with f64")
    return err


def masked_f32_passes(cuda_mu, args, card):
    """csrc/mu_masked_f32.cu's five launches: the split reads d and writes
    its limbs; num reads my and d's limbs and writes num (into x_new); the
    x update reads the bits, x, num and d's limbs and writes x_new and its
    limbs xc; the statistics read my, the bits, xc and the N tiles' limbs
    and write the partials; the reduction reads the partials and writes
    numd and dend. The bf16 MMA operations each pass issues: six limb
    products of 2 M N' KT a product (N' the issued columns), one product
    in num, two in the x update, three in the statistics."""
    my, mask, x, d = args
    bits = cuda_mu.pack_mask(mask)
    (m, n), k = my.shape, d.shape[0]
    kt = 64 if k <= 64 else 128
    chunks = -(-m // cuda_mu.masked_f32_block_rows(m, n))
    mn, xb, words = m * n * 4, m * k * 4, bits.numel() * 4
    limbs, xc = n * 3 * kt * 2, m * 3 * kt * 2
    part = chunks * 2 * k * n * 4
    nbytes = {"split_cols": k * n * 4 + limbs,
              "masked_num": mn + limbs + xb,
              "masked_x_update": words + 3 * xb + limbs + xc,
              "masked_stats": mn + words + xc + limbs + part,
              "reduce_kernel": part + 2 * k * n * 4}
    per = 12.0 * m * kt
    ops = {"masked_num": per * (-(-n // 32) * 32),
           "masked_x_update": 2 * per * (-(-n // 32) * 32),
           "masked_stats": 3 * per * (-(-n // 128) * 128)}
    pass_times(lambda: cuda_mu.mu_stats_masked(my, bits, x, d, EPS), nbytes,
               f"{m}x{n} K={k} f32 ({chunks} chunks)", card, ops=ops)


def time_masked_f32(cuda_mu, args, reps, card, err_abs):
    """f32 masked MU per call on ``args`` = (my, mask, x, d): the f32 route
    (csrc/mu_masked_f32.cu, the mask's bits) in turns with the dense-mask
    kernel of csrc/mu_kl_stats.cu (the wrapper given the dense mask; dense,
    f32, f32, dense; each figure the mean of its two), the twin once,
    beside the bf16x6 and f32-FMA bounds; then each launch's device time.
    Returns (ms, the dense-mask kernel's ms, the twin's ms, bound)."""
    my, mask, x, d = args
    (m, n), k = my.shape, d.shape[0]
    f32 = torch.float32
    w = cuda_mu.mu_stats_masked
    before = (w.f32_launches, w.dense_launches)
    t = time_packed(cuda_mu, "mu_stats_masked", args, reps)
    moved = (w.f32_launches - before[0], w.dense_launches - before[1])
    check(moved[0] == moved[1] == 2 * reps + 2,
          f"f32 masked MU turns: (f32, dense) route launches {moved}")
    b = stats_bound("mu_stats_masked", m, n, k, f32, f32, packed=True)
    b_dense = stats_bound("mu_stats_masked", m, n, k, f32, f32)
    b_fma = stats_bound("mu_stats_masked", m, n, k, f32, f32, fma=True)
    print(f"mu_stats_masked {m}x{n} K={k} data=float32 x=float32: "
          f"mu_masked_f32.cu (bf16x6, wgmma, packed mask) {t[0]:.4f} ms, "
          f"mu_kl_stats.cu (f32 FMA, dense mask) {t[1]:.4f} ms, plain twin "
          f"{t[2]:.4f} ms per call; new / old {t[0] / t[1]:.3f}; bound "
          f"bf16x6 {b[0]:.4f} ms ({b[1]}, {b[0] / t[0]:.1%} of it; dense "
          f"mask {b_dense[0]:.4f} ms), f32-FMA {b_fma[0]:.4f} ms ({card}); "
          f"max_abs_err {err_abs:.3e}", flush=True)
    masked_f32_passes(cuda_mu, args, card)
    return t[0], t[1], t[2], b


def lognormal_inputs(gen, dev, m, n, k, missing=0.3):
    """Masked KL (and masked lasso gradient: d is a) inputs whose my, x
    and d are log-normal, e^(ln 10 z) for standard normal z: 99.7% of the
    values within 10^-3 .. 10^3, about six decades; a share ``missing`` of
    the entries missing (none: dense KL's). A product split into two bf16
    limbs (bf16x3) breaks LIMIT[f32] on such data, one of three limbs
    (bf16x6) does not."""
    ln10 = float(np.log(10.0))
    mask = (torch.rand((m, n), generator=gen, device=dev)
            >= missing).float()
    my = mask * torch.exp(ln10 * torch.randn((m, n), generator=gen,
                                             device=dev))
    x = torch.exp(ln10 * torch.randn((m, k), generator=gen, device=dev))
    d = torch.exp(ln10 * torch.randn((k, n), generator=gen, device=dev))
    return my, mask, x, d


def weighted(gen, args, lognormal=False):
    """Masked inputs with the observed entries weighted in [0.5, 1), or
    (``lognormal``) by e^(ln 10 z / 1.5) for standard normal z, 99.7% of
    them within 10^-2 .. 10^2, four decades: ``pack_mask`` refuses such a
    mask, which keeps the dense route (the weighted instances)."""
    my, mask, x, d = args
    if lognormal:
        w = torch.exp(float(np.log(10.0)) / 1.5
                      * torch.randn(mask.shape, generator=gen,
                                    device=mask.device))
    else:
        w = 0.5 + 0.5 * torch.rand(mask.shape, generator=gen,
                                   device=mask.device)
    w = w.to(mask.dtype)
    return my * w, mask * w, x, d


def dense_passes(cuda_mu, y, x, d, card):
    """The dense TMA kernel's three launches: the x update reads y, x and d
    and writes x_new and xc = bf16(x_new) (M x 128); the statistics read y
    and xc and write the partials; the reduction reads the partials and
    writes numd and gram."""
    (m, n), k = y.shape, d.shape[0]
    chunks = -(-m // cuda_mu.dense_tma_block_rows(m, n))
    mn, xb, xc = m * n * 2, m * k * x.element_size(), m * 128 * 2
    size = (k * n + k * k) * 4
    nbytes = {"x_update_tma": mn + 2 * xb + k * n * 2 + xc,
              "stats_tma": mn + xc + chunks * size,
              "reduce_kernel": chunks * size + size}
    pass_times(lambda: cuda_mu.mu_stats_dense(y, x, d, EPS), nbytes,
               f"{m}x{n} K={k} ({chunks} chunks)", card)


def time_new(cuda_mu, name, args, reps=5):
    """Per-call ms of a kernel and of its twin, with CUDA events."""
    kernel_ms = cuda_ms(lambda: getattr(cuda_mu, name)(*args, EPS), reps)
    plain_ms = cuda_ms(
        lambda: getattr(cuda_mu, f"{name}_plain")(*args, EPS), 2)
    return kernel_ms, plain_ms


LASSO_METHODS = {"ista": (False, False), "fista": (True, False),
                 "acc_ista": (True, True)}   # (momentum, restart)


def rows_problem(gen, dev, m, f, n, complex_=False):
    """(yah, gram, 1/L) of a planted batch made on the card: a normal /
    sqrt(N), truth 10% sparse, 1% noise; ``complex_``: complex64 with
    normal real and imaginary parts (a over sqrt(2N))."""
    from decomp_tpu_torch.ops.spectral import spectral_norm_psd

    dt = torch.complex64 if complex_ else torch.float32
    scale = (2 * n) ** 0.5 if complex_ else n ** 0.5
    a = torch.randn((f, n), generator=gen, device=dev, dtype=dt) / scale
    xt = torch.randn((m, f), generator=gen, device=dev, dtype=dt) * (
        torch.rand((m, f), generator=gen, device=dev) < 0.1)
    y = xt @ a + 0.01 * torch.randn((m, n), generator=gen, device=dev,
                                    dtype=dt)
    ah = a.conj().T
    gram = a @ ah
    return y @ ah, gram, 1.0 / float(spectral_norm_psd(gram))


def rows_start(m, f, dev, dtype=torch.float32):
    """x0, t0, done0, nit0 of a fresh batch in which row 5 resumes done
    (after 9 iterations, at x = 1)."""
    x0 = torch.zeros((m, f), device=dev, dtype=dtype)
    t0 = torch.ones((m, 1), device=dev)
    d0 = torch.zeros((m, 1), device=dev)
    n0 = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    x0[5], d0[5], n0[5] = 1.0, 1.0, 9
    return x0, t0, d0, n0


def compare_rows_exact(out, ref, tag, share=True):
    """solve_rows against its twin in exact mode: niter equal on most
    rows, x of those rows and of all rows within SOLVE_LIMITS. ``share``
    False drops the share of rows with equal niter (a batch of a few rows,
    where one row that stops an iteration apart is a share no limit on
    shares can hold)."""
    eq = (out[4] == ref[4])[:, 0]
    nit_eq = float(eq.float().mean())
    err_eq = rel_fro(out[0][eq], ref[0][eq]) if bool(eq.any()) else 0.0
    err_all = rel_fro(out[0], ref[0])
    limit = SOLVE_LIMITS["nit_eq"] if share else "none, few rows"
    print(f"kernel vs twin {tag}: niter equal on {nit_eq:.4f} of rows "
          f"(limit {limit}), rel_fro x on those "
          f"{err_eq:.3e} (limit {SOLVE_LIMITS['eq_rows']:.0e}), all rows "
          f"{err_all:.3e} (limit {SOLVE_LIMITS['all_rows']:.0e})", flush=True)
    check(np.isfinite(err_all), f"{tag}: non-finite x")
    check((nit_eq >= SOLVE_LIMITS["nit_eq"] or not share) and
          err_eq <= SOLVE_LIMITS["eq_rows"] and
          err_all <= SOLVE_LIMITS["all_rows"],
          f"{tag}: kernel disagrees with twin")


def same_bits(outs, refs):
    return all(torch.equal(u, v) for u, v in zip(outs, refs))


def compare_solve_rows(cl, gen, dev, m, f, n, complex_=False):
    """solve_rows against its twin at M x F for every method, step form
    and precision, in exact mode (tol 1e-4, 300 iterations) and in the
    fixed-budget mode (37 iterations), with a row that resumes done;
    ``complex_``: F complex64 features through the complex mode, every
    kernel call counted on its route. Under 'high' every call goes to
    csrc/lasso_fista_tma.cu, and each output must carry the bits of
    csrc/lasso_fista.cu's 'high' path (the private ``_solve_rows_mma``)
    at the default rows per block and at 16."""
    yah, gram, step = rows_problem(gen, dev, m, f, n, complex_)
    x0, t0, d0, n0 = rows_start(m, f, dev, yah.dtype)
    ramp = torch.linspace(0.5, 1.0, f, device=dev)
    for method, (mom, rst) in LASSO_METHODS.items():
        for hi_lo in (False, True):
            for vec in (False, True):
                s = step * ramp if vec else step
                args = (yah, gram, x0, x0, t0, d0, n0, s, 0.05 * s)
                kw = dict(momentum=mom, restart=rst, hi_lo=hi_lo)
                tag = (f"solve_rows {m}x{f}{'c' if complex_ else ''} "
                       f"{method} {'high' if hi_lo else 'highest'} "
                       f"{'per-feature' if vec else 'scalar'} step")
                before = cl.solve_rows.complex_launches
                tma_before = cl.solve_rows.tma_launches
                out = cl.solve_rows(*args, 1e-4, maxiter=300, **kw)
                # A rerun, with 16-row stripes where 32 is the default.
                again = cl.solve_rows(*args, 1e-4, maxiter=300,
                                      block_rows=16, **kw)
                ref = cl.solve_rows_plain(*args, 1e-4, maxiter=300, **kw)
                fixed = cl.solve_rows(*args, 0.0, maxiter=37, fixed=True,
                                      **kw)
                exact0 = cl.solve_rows(*args, 0.0, maxiter=37, **kw)
                fref = cl.solve_rows_plain(*args, 0.0, maxiter=37,
                                           fixed=True, **kw)
                torch.cuda.synchronize()
                routed = cl.solve_rows.complex_launches - before
                tma = cl.solve_rows.tma_launches - tma_before
                check(routed == (4 if complex_ else 0),
                      f"{tag}: {routed} launches on the complex route")
                check(tma == (4 if hi_lo else 0),
                      f"{tag}: {tma} launches of lasso_fista_tma.cu")
                if hi_lo:
                    old = cl._solve_rows_mma(*args, 1e-4, maxiter=300, **kw)
                    old_fixed = cl._solve_rows_mma(*args, 0.0, maxiter=37,
                                                   fixed=True, **kw)
                    bits = (same_bits(out, old) and same_bits(again, old)
                            and same_bits(fixed, old_fixed))
                    print(f"  lasso_fista_tma.cu bit-identical to "
                          f"lasso_fista.cu's 'high' path (exact, 16 rows a "
                          f"block, fixed budget): {bits}", flush=True)
                    check(bits, f"{tag}: lasso_fista_tma.cu differs from "
                          "lasso_fista.cu's 'high' path")
                # Below one block's slots the share of rows with equal
                # niter is a count of one or two rows; x is still held.
                compare_rows_exact(out, ref, tag, share=not hi_lo or m >= (
                    cl.stripe_rows(None, f * (2 if complex_ else 1))))
                err_fixed = max(rel_fro(fixed[0], fref[0]),
                                rel_fro(fixed[1], fref[1]))
                same = same_bits(out, again)
                fixed_is_exact = same_bits(fixed, exact0)
                kept = (torch.equal(out[0][5], x0[5])
                        and int(out[4][5, 0]) == 9)
                print(f"  fixed budget: rel_fro x, z {err_fixed:.3e} (limit "
                      f"{SOLVE_LIMITS['fixed']:.0e}); bit-identical rerun "
                      f"(16 rows a block) {same}; fixed mode == exact mode "
                      f"at tol 0 {fixed_is_exact}; done row kept {kept}",
                      flush=True)
                check(err_fixed <= SOLVE_LIMITS["fixed"],
                      f"{tag}: fixed-budget kernel disagrees with twin")
                check(same, f"{tag}: two kernel runs differ")
                check(fixed_is_exact, f"{tag}: fixed mode differs from exact "
                      "mode at tol 0")
                check(kept, f"{tag}: the row that resumed done moved")


def compare_solve_rows_wide(cl, gen, dev, m, f, n, complex_=False):
    """Phase 9b: solve_rows' wide route (csrc/lasso_fista_wide.cu) against
    its twin at M x F (F > 1,024 reals) as ``compare_solve_rows`` holds the
    narrow kernels: every method that the gate takes at F, both precisions
    and step forms, exact mode (tol 1e-4, 300 iterations) and the fixed
    budget (37), a row that resumes done, a rerun with 16 rows a block
    given (the default) that must give the same bits, and the fixed mode
    against the exact mode at tol 0; every call counted on
    ``.wide_launches`` (and, complex, ``.complex_launches``)."""
    yah, gram, step = rows_problem(gen, dev, m, f, n, complex_)
    x0, t0, d0, n0 = rows_start(m, f, dev, yah.dtype)
    ramp = torch.linspace(0.5, 1.0, f, device=dev)
    reals = 2 * f if complex_ else f
    w = cl.solve_rows
    for method, (mom, rst) in LASSO_METHODS.items():
        if not cl.solve_fits(reals, mom, group=complex_):
            continue
        for hi_lo in (False, True):
            for vec in (False, True):
                s = step * ramp if vec else step
                args = (yah, gram, x0, x0, t0, d0, n0, s, 0.05 * s)
                kw = dict(momentum=mom, restart=rst, hi_lo=hi_lo)
                tag = (f"wide solve_rows {m}x{f}{'c' if complex_ else ''} "
                       f"{method} {'high' if hi_lo else 'highest'} "
                       f"{'per-feature' if vec else 'scalar'} step")
                before = (w.wide_launches, w.complex_launches, w.launches)
                out = w(*args, 1e-4, maxiter=300, **kw)
                again = w(*args, 1e-4, maxiter=300, block_rows=16, **kw)
                ref = cl.solve_rows_plain(*args, 1e-4, maxiter=300, **kw)
                fixed = w(*args, 0.0, maxiter=37, fixed=True, **kw)
                exact0 = w(*args, 0.0, maxiter=37, **kw)
                fref = cl.solve_rows_plain(*args, 0.0, maxiter=37,
                                           fixed=True, **kw)
                torch.cuda.synchronize()
                got = (w.wide_launches - before[0],
                       w.complex_launches - before[1],
                       w.launches - before[2])
                check(got == (4, 4 if complex_ else 0, 4),
                      f"{tag}: launches (wide, complex, all) {got}")
                compare_rows_exact(out, ref, tag, share=m >= 16)
                err_fixed = max(rel_fro(fixed[0], fref[0]),
                                rel_fro(fixed[1], fref[1]))
                same = same_bits(out, again)
                fixed_is_exact = same_bits(fixed, exact0)
                kept = (torch.equal(out[0][5], x0[5])
                        and int(out[4][5, 0]) == 9)
                print(f"  fixed budget: rel_fro x, z {err_fixed:.3e} (limit "
                      f"{SOLVE_LIMITS['fixed']:.0e}); bit-identical rerun "
                      f"(16 rows a block given) {same}; fixed mode == exact "
                      f"mode at tol 0 {fixed_is_exact}; done row kept "
                      f"{kept}", flush=True)
                check(err_fixed <= SOLVE_LIMITS["fixed"],
                      f"{tag}: fixed-budget kernel disagrees with twin")
                check(same, f"{tag}: two kernel runs differ")
                check(fixed_is_exact, f"{tag}: fixed mode differs from exact "
                      "mode at tol 0")
                check(kept, f"{tag}: the row that resumed done moved")


def wide_highest_f64(cl, gen, dev):
    """Phase 9b: the wide route's 'highest' (bf16x6) on a log-normal
    dictionary against f64: 37 fixed ista steps at WIDE_F64_SHAPE on a
    whose features span three decades, x of the kernel and of the full-f32
    twin against an f64 run of the same steps; the kernel within 4x the
    twin's error (a two-limb product, 'high', is printed beside it)."""
    m, f, n = WIDE_F64_SHAPE
    scale = 10.0 ** (3.0 * torch.rand((f, 1), generator=gen, device=dev)
                     - 1.5)
    a = torch.randn((f, n), generator=gen, device=dev) * scale / n ** 0.5
    xt = torch.randn((m, f), generator=gen, device=dev) / scale.T * (
        torch.rand((m, f), generator=gen, device=dev) < 0.1)
    y = xt @ a + 0.01 * torch.randn((m, n), generator=gen, device=dev)
    gram, yah = a @ a.T, y @ a.T
    g64, yah64 = a.double() @ a.double().T, y.double() @ a.double().T
    step = 1.0 / float(torch.linalg.matrix_norm(g64, 2))
    thr = 1e-3 * step
    x = torch.zeros((m, f), dtype=torch.float64, device=dev)
    for _ in range(37):
        u = x - step * (x @ g64 - yah64)
        x = torch.sign(u) * torch.clamp(u.abs() - thr, min=0.0)
    x0, t0, d0, n0 = rows_start(m, f, dev)
    x0[5], d0[5], n0[5] = 0.0, 0.0, 0
    args = (yah, gram, x0, x0, t0, d0, n0, step, thr, 0.0)
    kw = dict(momentum=False, restart=False, maxiter=37, fixed=True)
    errs = {}
    for name, fn, hi_lo in (("highest", cl.solve_rows, False),
                            ("high", cl.solve_rows, True),
                            ("twin", cl.solve_rows_plain, False)):
        errs[name] = rel_fro(fn(*args, hi_lo=hi_lo, **kw)[0], x)
    print(f"wide solve_rows {m}x{f}, log-normal features over three "
          f"decades, 37 ista steps, x against f64: 'highest' (bf16x6) "
          f"{errs['highest']:.3e}, full-f32 twin {errs['twin']:.3e} (limit "
          f"4x), 'high' (bf16x3) {errs['high']:.3e}", flush=True)
    check(errs["highest"] <= 4 * errs["twin"], "wide 'highest' is no f32 "
          "product on log-normal data")


def grad_inputs(gen, dev, m, n, f, dt):
    """my = mask * y, mask (30% missing), x and a for masked_grad_rows."""
    mask = (torch.rand((m, n), generator=gen, device=dev) >= 0.3).to(dt)
    my = torch.randn((m, n), generator=gen, device=dev).to(dt) * mask
    x = torch.randn((m, f), generator=gen, device=dev).to(dt)
    a = (torch.randn((f, n), generator=gen, device=dev) / n ** 0.5).to(dt)
    return my, mask, x, a


def compare_grad(module, name, args, packed=False, tag="", f64=False,
                 dense=False, first=False):
    """The masked gradient ``name`` of ``module`` (masked_grad_rows, or
    cuda_dl's masked_grad_dict) against its twin; ``packed``: on the
    mask's bits (the packed route), else on the dense mask (the dense
    route: the weighted instance), each call counted on that route;
    ``f64``: also both against the function in f64; ``dense``: the packed
    route also against the weighted instance on the same 0/1 mask;
    ``first``: the kernel also against the first design of the dense-mask
    gradient (csrc/lasso_grad.cu, or csrc/mu_kl_stats.cu's GRAD_DICT,
    through its private launch) on the same inputs (each within the limit
    of the twin, so within twice the limit of each other). Above 128
    features (or atoms) either mask form takes the wide route
    (csrc/grad_wide.cu), counted in ``.wide_launches``. Returns the max
    abs error."""
    from decomp_tpu_torch.ops.cuda_lasso import grad_route
    from decomp_tpu_torch.ops.cuda_mu import pack_mask

    my, mask, x, a = args
    fn = getattr(module, name)
    kargs = (my, pack_mask(mask), x, a) if packed else args
    route = ("wide_launches" if grad_route(x.shape[1]) == "wide"
             else "packed_launches" if packed else "dense_launches")
    before = getattr(fn, route, 0)
    out = fn(*kargs)
    again = fn(*kargs)
    ref = getattr(module, f"{name}_plain")(*args)
    other = None
    if dense:
        other = ("the weighted instance", fn(*args))
    elif first:
        launch = ("_grad_dict_dense_mma_launch" if name.endswith("dict")
                  else "_grad_dense_mma_launch")
        other = ("the first design", getattr(module, launch)(*args))
    torch.cuda.synchronize()
    err = rel_fro(out, ref)
    same = torch.equal(out, again)
    lim = GRAD_LIMIT[my.dtype]
    tag = (f"{name}{' packed' if packed else ' weighted'}"
           f"{' (wide route)' if route == 'wide_launches' else ''} "
           f"{my.shape[0]}x{my.shape[1]} "
           f"{'K' if name.endswith('dict') else 'F'}={x.shape[1]} "
           f"{str(my.dtype)[6:]}{', ' + tag if tag else ''}")
    exact = ""
    if f64:
        xd, ad = x.double(), a.double()
        r64 = mask.double() * (xd @ ad) - my.double()
        g64 = xd.T @ r64 if name.endswith("dict") else r64 @ ad.T
        exact = (f"; against f64: kernel {rel_fro(out, g64):.3e}, twin "
                 f"{rel_fro(ref, g64):.3e}")
        del xd, ad, r64, g64
    err_d = rel_fro(out, other[1]) if other else 0.0
    if other:
        exact += (f"; against {other[0]} {err_d:.3e} (limit {2 * lim:g})")
    print(f"kernel vs twin {tag}: rel_fro {err:.3e} (limit {lim:g}); "
          f"bit-identical rerun: {same}{exact}", flush=True)
    check(np.isfinite(err_d) and err_d <= 2 * lim,
          f"{tag}: the kernel and {other and other[0]} disagree")
    if hasattr(fn, route):
        check(getattr(fn, route) == before + 2,
              f"{tag}: not on the {route[:-len('_launches')]} route")
    check(np.isfinite(err) and err <= lim, f"{tag}: kernel disagrees with "
          "twin")
    check(same, f"{tag}: two kernel runs differ")
    return max_abs([out], [ref])


def compare_split(cd, cuda_mu, x):
    """x's limbs as the f32 dictionary kernels' split launch writes them
    (``split_rows`` of csrc/sm90_common.cuh, which csrc/grad_dict_packed.cu
    and csrc/grad_wide.cu share), bit for bit against
    ``cuda_mu.column_limbs(x^T, KT)``: (M, 3 KT) bf16,
    split_bf16x3's round-to-nearest limbs, zero past K; KT =
    ``cuda_lasso.grad_width(K)``."""
    from decomp_tpu_torch.ops.cuda_lasso import grad_width

    kt = grad_width(x.shape[1])
    got = cd._split_rows(x, kt)
    same = torch.equal(got, cuda_mu.column_limbs(x.T, kt))
    print(f"masked_grad_dict: x's limbs {tuple(got.shape)} from the split "
          f"launch equal column_limbs(x^T, {kt}): {same}", flush=True)
    check(same, f"the split launch at width {kt}: x's limbs differ")


def wide_checks(module, name, gen, dev):
    """Phases 9 and 13: the wide route of the masked gradient ``name`` of
    ``module`` (csrc/grad_wide.cu), each of its four instances (f32 and
    bf16 data; the mask's bits, and weights in [0.5, 1)) against its twin
    at WIDE_SHAPES and at the gate's corners of its dtype, and on
    log-normal my, x and a (or d) over six decades at 100,000 x 1,024, 256
    wide (with log-normal weights over four decades on the weighted
    instances), also against f64: within GRAD_LIMIT, each with a
    bit-identical rerun and both calls counted on the wide route
    (``compare_grad``)."""
    for dt in (torch.float32, torch.bfloat16):
        for m, n, f in WIDE_SHAPES + WIDE_CORNERS[dt]:
            tag = ("the gate's corner" if (m, n, f) in WIDE_CORNERS[dt]
                   else "")
            args = grad_inputs(gen, dev, m, n, f, dt)
            compare_grad(module, name, args, packed=True, tag=tag)
            compare_grad(module, name, weighted(gen, args), tag=tag)
            del args
        args = lognormal_inputs(gen, dev, 100_000, 1024, 256)
        compare_grad(module, name, tuple(t.to(dt) for t in args),
                     packed=True, tag="log-normal", f64=True)
        args = weighted(gen, args, lognormal=True)
        compare_grad(module, name, tuple(t.to(dt) for t in args),
                     tag="log-normal, log-normal weights", f64=True)
        del args


def wide_times(module, name, gen, dev, card):
    """Phases 12 and 15b: the wide route of ``name`` (csrc/grad_wide.cu)
    per call at WIDE_TIME_SHAPES, each instance (the bits of a 0/1 mask,
    and weights in [0.5, 1)) held to its twin and timed in turns with the
    composition that use_kernel=False runs (composition, kernel, kernel,
    composition), beside its bound (the TPU kernel's own work,
    ``grad_bytes``: no E) and, apart, E's round trip to device
    memory (the route's own bytes). Returns {entry: (max_abs_err, ms,
    plain_ms, bound_ms, bound_by)} at the first shape (100,000 x 1,024,
    256 wide), the entries ``name`` + _wide, + _weighted, + _bf16."""
    from decomp_tpu_torch.ops import cuda_mu

    rows = name == "masked_grad_rows"
    fn, plain = getattr(module, name), getattr(module, f"{name}_plain")
    out = {}
    for (m, n, f), dts in WIDE_TIME_SHAPES:
        for dt in dts:
            base = grad_inputs(gen, dev, m, n, f, dt)
            for route in ("bits", "weights"):
                args = base if route == "bits" else weighted(gen, base)
                my, mask, x, a = args
                kargs = ((my, cuda_mu.pack_mask(mask), x, a)
                         if route == "bits" else args)
                kw = dict(a_limbs=module.grad_limbs(a)) if rows else {}

                def call():
                    return fn(*kargs, **kw)

                def comp():
                    if rows:
                        return (mask * (x @ a) - my) @ a.T
                    return x.T @ (mask * (x @ a) - my)

                before = fn.wide_launches
                got, ref = call(), plain(*args)
                err, rel = max_abs([got], [ref]), rel_fro(got, ref)
                check(fn.wide_launches == before + 1 and rel <= GRAD_LIMIT[dt],
                      f"{name} wide {m}x{n} {f}: rel_fro {rel:.3e}, or not "
                      "on the wide route")
                t = [cuda_ms(comp, 10), cuda_ms(call, 10)]
                t += [cuda_ms(call, 10), cuda_ms(comp, 10)]
                k_ms, c_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                p_ms = cuda_ms(lambda: plain(*args), 2)
                e_b = dt.itemsize
                nbytes = grad_bytes(rows, m, n, f, dt, route == "bits")
                b, fma = dtype_bounds(nbytes, 4.0 * m * n * f, dt)
                e_ms = 2 * e_b * m * n / HBM_BYTES_PER_S * 1e3
                print(f"{name} wide route (grad_wide.cu) {m}x{n} "
                      f"{'F' if rows else 'K'}={f} {str(dt)[6:]}, {route}: "
                      f"{k_ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), composition "
                      f"{c_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}) in turns, "
                      f"kernel / composition {k_ms / c_ms:.3f}; plain twin "
                      f"{p_ms:.3f} ms per call; bound {bound_text(b, fma)} "
                      f"({nbytes / 1e6:.1f} MB), kernel at "
                      f"{b[0] / k_ms * 100:.1f}% of it; E's round trip "
                      f"{2 * e_b * m * n / 1e6:.1f} MB, {e_ms:.4f} ms of "
                      f"bytes beside it; rel_fro vs twin {rel:.3e} ({card})",
                      flush=True)
                if (m, n, f) == WIDE_TIME_SHAPES[0][0]:
                    entry = (f"{name}_wide"
                             f"{'_weighted' if route == 'weights' else ''}"
                             f"{'' if dt == torch.float32 else '_bf16'}")
                    out[entry] = (err, k_ms, p_ms) + b
                del args, kargs, kw, got, ref
            del base
    return out


def config2_data(m=10_000, f=512, n=256, seed=1):
    """BASELINE config 2 as bench.py:157-163 makes it (numpy, seed 1):
    10,000 problems, 512 features, 256 channels, 5%-sparse truth, 0.01
    noise, or its recipe at M problems over F features and N channels
    (and another seed); returns (y, a) as f32 arrays and the generator,
    which config 3 continues."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(f, n)).astype(np.float32)
    x_true = (rng.normal(size=(m, f))
              * (rng.random((m, f)) < 0.05)).astype(np.float32)
    y = x_true @ a + 0.01 * rng.normal(size=(m, n)).astype(np.float32)
    return y.astype(np.float32), a, rng


def config3_data():
    """BASELINE config 3 as bench.py:187-195 makes it, after config 2's
    draws: 20,000 8x8 patches (64 channels) over 256 unit atoms, 10%-sparse
    truth, 0.01 noise, and a normal initial dictionary; returns (y, d0) as
    f32 arrays."""
    rng = config2_data()[2]
    d_true = rng.normal(size=(256, 64))
    d_true /= np.linalg.norm(d_true, axis=1, keepdims=True)
    xs = rng.normal(size=(20_000, 256)) * (rng.random((20_000, 256)) < 0.1)
    y = (xs @ d_true + 0.01 * rng.normal(size=(20_000, 64))).astype(
        np.float32)
    return y, rng.normal(size=(256, 64)).astype(np.float32)


def kkt_residual(x, y, a, alpha, lip, tol):
    """Per row, the distance of 0 from the lasso's subdifferential at x
    (|grad + alpha x / |x|| on the support, max(|grad| - alpha, 0) off it;
    x / |x| is sign x for real data), over L tol ||x_row||: the scale a
    relative change of tol leaves."""
    xd, ad = wide(x), wide(a)
    ah = ad.conj().T
    g = xd @ (ad @ ah) - wide(y) @ ah
    r = torch.where(xd != 0, g + alpha * torch.sgn(xd),
                    (g.abs() - alpha).clamp_min(0.0).to(g.dtype))
    return (torch.linalg.vector_norm(r, dim=1)
            / (lip * tol * torch.linalg.vector_norm(xd, dim=1)))


def marginal_ms(fn, k=6, repeats=4):
    """bench.py:92-117's marginal time per call, in ms: (time of k chained
    calls - time of one) / (k - 1), best of ``repeats``, each fenced by a
    synchronise."""
    fn()
    torch.cuda.synchronize()
    best_1 = best_k = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best_1 = min(best_1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
        best_k = min(best_k, time.perf_counter() - t0)
    if best_k > best_1:
        return (best_k - best_1) / (k - 1) * 1e3
    return best_k / k * 1e3


def event_ms(fn):
    """(ms, result) of one call between CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def slot_waste(solve_rows, niter, nit0=None):
    """The schedule's waste of the last lasso_fista_tma.cu launch: its
    blocks' slot-iterations (empty slots included) over the iterations the
    rows needed, sum(niter - nit0)."""
    need = niter.double().sum() - (0 if nit0 is None else
                                   nit0.double().sum())
    return float(solve_rows.slot_iters.double().sum() / need)


def solve_rows_bound(m, f, sum_niter, hi_lo):
    """The bound of one solve_rows call: yah, x0 and z0 read and x, z
    written (the Gram's bytes are negligible), and 2F^2 operations per
    product per row-iteration this run needed: three bf16 products under
    'high', one f32 product under 'highest'."""
    nbytes = 5 * m * f * 4 + 2 * f * f * 2
    if hi_lo:
        return bound(nbytes, 6.0 * f * f * sum_niter, torch.bfloat16)
    return bound(nbytes, 2.0 * f * f * sum_niter, torch.float32)


def config2_phase(lasso, dev, card, reset_counts, read_counts):
    """Phase 10: BASELINE config 2 end to end through ``lasso.solve``.
    Returns the main run's solve_rows launches and the data (y, a) on the
    card."""
    from decomp_tpu_torch.ops import cuda_lasso as cl
    from decomp_tpu_torch.ops.spectral import spectral_norm_psd

    y_np, a_np, _ = config2_data()
    cfg = dict(tol=1e-4, maxiter=4000, method="acc_ista", per_problem=True)
    # Host arrays go to the card unless the caller asks for the CPU.
    check(lasso.solve(y_np[:64], a_np, 0.1, **cfg).x.is_cuda,
          "a numpy y did not run on the card")
    y, a = (torch.from_numpy(v).to(dev) for v in (y_np, a_np))
    m, f = y.shape[0], a.shape[0]

    def solve(**kw):
        return lasso.solve(y, a, 0.1, **cfg, **kw)

    solve(precision="high")   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ms, res = event_ms(lambda: solve(precision="high"))
    launches = read_counts("solve_rows", 1)
    waste = slot_waste(cl.solve_rows, res.niter)
    check(cl.solve_rows.tma_launches == 1, "config 2: the "
          "'high' launch did not go to lasso_fista_tma.cu")
    highest_ms, top = event_ms(lambda: solve(precision="highest"))
    comp_ms, comp = event_ms(lambda: solve(use_kernel=False))
    marg = marginal_ms(lambda: solve(precision="high"))
    nit = res.niter.double()
    sum_nit = int(nit.sum())
    b_ms, b_by = solve_rows_bound(m, f, sum_nit, True)
    lip = float(spectral_norm_psd(a @ a.T))
    kkt = kkt_residual(res.x, y, a, 0.1, lip, 1e-4)
    kkt_comp = kkt_residual(comp.x, y, a, 0.1, lip, 1e-4)
    err_top = rel_fro(res.x, top.x)
    err_comp = rel_fro(res.x, comp.x)
    print(f"config 2 lasso.solve {m} problems x {f} features x "
          f"{y.shape[1]} channels, acc_ista, precision 'high', per_problem, "
          f"tol 1e-4 ({card}): time to tol {ms:.3f} ms, marginal per solve "
          f"(chain of 6) {marg:.3f} ms, bound of its solve_rows "
          f"{b_ms:.3f} ms ({b_by}); niter min/median/max "
          f"{int(nit.min())}/{int(nit.median())}/{int(nit.max())}, sum "
          f"{sum_nit}; converged rows {int(res.converged.sum())}/{m}; "
          f"solve_rows launches {launches} (lasso_fista_tma.cu 1; slot "
          f"waste {waste:.4f})", flush=True)
    print(f"  precision 'highest' {highest_ms:.3f} ms (niter sum "
          f"{int(top.niter.double().sum())}), use_kernel=False "
          f"{comp_ms:.3f} ms ({card}); rel_fro x vs 'highest' "
          f"{err_top:.3e}, vs composition {err_comp:.3e} (limit "
          f"{C2_X_LIMIT:.0e}); KKT residual / (L tol |x|) max "
          f"{float(kkt.max()):.3f}, median {float(kkt.median()):.3f} "
          f"(composition max {float(kkt_comp.max()):.3f}; limit "
          f"{C2_KKT_LIMIT})", flush=True)
    check(bool(res.converged.all()), "config 2: not every row converged")
    check(res.x.shape == (m, f) and bool(torch.isfinite(res.x).all()),
          "config 2: x is not finite or has the wrong shape")
    check(err_top <= C2_X_LIMIT and err_comp <= C2_X_LIMIT,
          "config 2: x disagrees with the 'highest' or composition run")
    check(float(kkt.max()) <= C2_KKT_LIMIT,
          "config 2: the KKT conditions do not hold")
    return launches, y, a


def config2_complex_data(m=10_000, f=512, c=256, seed=1):
    """The JAX package's config-2-complex as
    ``benchmarks/bench_split_complex.py:56-63`` makes it (numpy, seed 1):
    10,000 problems, 512 complex features, 256 complex channels, 5%-sparse
    truth, 0.01 noise, or its recipe at M x F over C channels (and another
    seed); returns (y, a) as complex64 arrays."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(f, c))
         + 1j * rng.normal(size=(f, c))).astype(np.complex64)
    xt = ((rng.normal(size=(m, f)) + 1j * rng.normal(size=(m, f)))
          * (rng.random((m, f)) < 0.05)).astype(np.complex64)
    y = (xt @ a + 0.01 * (rng.normal(size=(m, c))
                          + 1j * rng.normal(size=(m, c)))).astype(np.complex64)
    return y, a


def config2_complex_phase(lasso, cl, dev, card, reset_counts, read_counts):
    """Phase 10c: config-2-complex end to end through ``lasso.solve`` on
    complex64 data (acc_ista, 'high', per_problem, tol 1e-4, maxiter
    3,000, alpha 0.1). Returns the main run's solve_rows launches and the
    data (y, a) on the card."""
    from torch.profiler import ProfilerActivity, profile

    from decomp_tpu_torch.ops.spectral import spectral_norm_psd

    y_np, a_np = config2_complex_data()
    cfg = dict(tol=1e-4, maxiter=3000, method="acc_ista", per_problem=True)
    y, a = (torch.from_numpy(v).to(dev) for v in (y_np, a_np))
    m, f = y.shape[0], a.shape[0]

    def solve(**kw):
        return lasso.solve(y, a, 0.1, **cfg, **kw)

    solve(precision="high")   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ms, res = event_ms(lambda: solve(precision="high"))
    launches = read_counts("solve_rows", 1)
    routed = cl.solve_rows.complex_launches
    check(routed == 1, f"config-2-complex: {routed} solve_rows launches on "
          "the complex route, expected 1")
    check(cl.solve_rows.tma_launches == 1, "config-2-complex: the 'high' "
          "launch did not go to lasso_fista_tma.cu")
    waste = slot_waste(cl.solve_rows, res.niter)
    # 'auto' keeps 'highest' at Fc = 512 on the composition; ask for the
    # kernel.
    highest_ms, top = event_ms(lambda: solve(precision="highest",
                                             use_kernel=True))
    comp_ms, comp = event_ms(lambda: solve(use_kernel=False))
    marg = marginal_ms(lambda: solve(precision="high"), repeats=2)
    nit = res.niter.double()
    sum_nit = int(nit.sum())
    b_ms, b_by = solve_rows_bound(m, 2 * f, sum_nit, True)
    lip = float(spectral_norm_psd(a @ a.conj().T))
    kkt = kkt_residual(res.x, y, a, 0.1, lip, 1e-4)
    kkt_comp = kkt_residual(comp.x, y, a, 0.1, lip, 1e-4)
    err_top = rel_fro(res.x, top.x)
    err_comp = rel_fro(res.x, comp.x)
    print(f"config-2-complex lasso.solve {m} problems x {f} complex features "
          f"x {y.shape[1]} complex channels, complex64, acc_ista, precision "
          f"'high', per_problem, tol 1e-4 ({card}): time to tol {ms:.3f} ms, "
          f"marginal per solve (chain of 6) {marg:.3f} ms, bound of its "
          f"solve_rows {b_ms:.3f} ms ({b_by}); niter min/median/max "
          f"{int(nit.min())}/{int(nit.median())}/{int(nit.max())}, sum "
          f"{sum_nit}; converged rows {int(res.converged.sum())}/{m}; "
          f"solve_rows launches {launches} (complex route {routed}, "
          f"lasso_fista_tma.cu 1; slot waste {waste:.4f})", flush=True)
    print(f"  precision 'highest' {highest_ms:.3f} ms (niter sum "
          f"{int(top.niter.double().sum())}), use_kernel=False "
          f"{comp_ms:.3f} ms (max niter {int(comp.niter.max())}) ({card}); "
          f"rel_fro x vs 'highest' {err_top:.3e}, vs composition "
          f"{err_comp:.3e} (limit {C2C_X_LIMIT:.0e}); KKT residual / (L tol "
          f"|x|) max {float(kkt.max()):.3f}, median {float(kkt.median()):.3f} "
          f"(composition max {float(kkt_comp.max()):.3f}; limit "
          f"{C2C_KKT_LIMIT})", flush=True)
    check(bool(res.converged.all()), "config-2-complex: not every row "
          "converged")
    check(res.x.shape == (m, f) and res.x.dtype == torch.complex64
          and bool(torch.isfinite(torch.view_as_real(res.x)).all()),
          "config-2-complex: x is not finite complex64 of the right shape")
    check(err_top <= C2C_X_LIMIT and err_comp <= C2C_X_LIMIT,
          "config-2-complex: x disagrees with the 'highest' or composition "
          "run")
    check(float(kkt.max()) <= C2C_KKT_LIMIT,
          "config-2-complex: the KKT conditions do not hold")
    # Where one solve's device time goes.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve(precision="high")
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  device time of one solve {busy_ms:.3f} ms ({card}):",
          flush=True)
    for e in kernels[:5]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms in {e.count:5d} "
              f"launches: {e.key[:70]}", flush=True)
    # solve_streaming takes the same route through 'auto': one launch per
    # chunk of host rows.
    reset_counts()
    st = lasso.solve_streaming(y_np[:2000], a_np, 0.1, chunk_rows=1000,
                               precision="high", **cfg)
    read_counts("solve_rows", 2)
    check(cl.solve_rows.tma_launches == 2, "config-2-complex: a "
          "solve_streaming chunk did not go to lasso_fista_tma.cu")
    err_st = rel_fro(torch.from_numpy(st.x), res.x[:2000].cpu())
    print(f"  solve_streaming of its first 2,000 rows in 2 chunks: "
          f"solve_rows launches 2 (complex route "
          f"{cl.solve_rows.complex_launches}); rel_fro x vs the batch run "
          f"{err_st:.3e} (limit {C2C_X_LIMIT:.0e})", flush=True)
    check(cl.solve_rows.complex_launches == 2 and err_st <= C2C_X_LIMIT,
          "config-2-complex: solve_streaming did not take the kernel, or "
          "its rows disagree with the batch run's")
    return launches, y, a


def one_limb(gram):
    """``gram`` rounded to one bf16 limb (real and imaginary parts): the
    twin's 'high' products on it are those of a kernel that drops the
    hi.lo product."""
    def cut(t):
        return t.bfloat16().float()
    return (torch.complex(cut(gram.real), cut(gram.imag)) if gram.is_complex()
            else cut(gram))


def wide_dl_data(dev, seed=28):
    """Phase 10d's dictionary learning problem (torch, on ``dev``): 2,000 x
    64 data over 1,152 unit atoms, 1%-sparse truth, 0.01 noise; returns
    (y, d0) with a normal initial dictionary."""
    k, n, m = 1152, 64, 2000
    g = torch.Generator(device=dev).manual_seed(seed)
    d_true = torch.nn.functional.normalize(
        torch.randn((k, n), generator=g, device=dev), dim=1)
    xs = torch.randn((m, k), generator=g, device=dev) * (
        torch.rand((m, k), generator=g, device=dev) < 0.01)
    y = xs @ d_true + 0.01 * torch.randn((m, n), generator=g, device=dev)
    return y, torch.randn((k, n), generator=g, device=dev)


def wide_config2_phase(lasso, dl, cl, dev, card, reset_counts, read_counts):
    """Phase 10d: ``lasso.solve`` on the wide route of solve_rows
    (csrc/lasso_fista_wide.cu) at config 2's recipe over 1,408 features
    and over 640 complex features (acc_ista, 'high', per_problem, tol
    1e-4, alpha 0.1): one launch each on the wide route, every row
    converged, the KKT conditions, the agreement with the 'highest' kernel
    run and the composition run, the time to tol, the marginal per solve
    over a chain of 6 beside the bound, the slot waste, and solve_rows per
    call against its twin on the path's inputs, to tol and in the fixed
    budget, each limit beside a control that must fail it; then
    ``lasso.solve_streaming`` (one launch a chunk) and
    ``dictionary_learning.solve(use_kernel=True)`` with 1,152 atoms (its
    inner coding on the wide route in the fixed budget) against the same
    solve on the composition. Returns the
    kernels line's entries {name: (max_abs_err, ms, plain_ms, bound_ms,
    bound_by)} and the main runs' launches."""
    from decomp_tpu_torch.ops import cuda_dl
    from decomp_tpu_torch.ops.spectral import spectral_norm_psd

    stats, launches = {}, {}
    cfg = dict(tol=1e-4, maxiter=4000, method="acc_ista", per_problem=True)
    for complex_ in (False, True):
        y_np, a_np = (config2_complex_data(*C2WC_SHAPE) if complex_
                      else config2_data(*C2W_SHAPE)[:2])
        y, a = (torch.from_numpy(v).to(dev) for v in (y_np, a_np))
        m, f = y.shape[0], a.shape[0]
        reals = 2 * f if complex_ else f
        name = "solve_rows_wide" + ("_complex" if complex_ else "")
        tag = (f"wide {'config-2-complex' if complex_ else 'config 2'} "
               f"{m} x {f}{'c' if complex_ else ''}")
        x_limit, kkt_limit, twin_limit = (
            (C2WC_X_LIMIT, C2C_KKT_LIMIT, C2WC_TWIN_LIMIT) if complex_
            else (C2W_X_LIMIT, C2_KKT_LIMIT, C2W_TWIN_LIMIT))

        def solve(**kw):
            return lasso.solve(y, a, 0.1, **cfg, **kw)

        solve(precision="high")   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        ms, res = event_ms(lambda: solve(precision="high"))
        launches[name] = read_counts("solve_rows", 1)
        w = cl.solve_rows
        check((w.wide_launches, w.complex_launches, w.tma_launches)
              == (1, int(complex_), 0),
              f"{tag}: the launch did not go to lasso_fista_wide.cu")
        waste = slot_waste(w, res.niter)
        highest_ms, top = event_ms(lambda: solve(precision="highest",
                                                 use_kernel=True))
        comp_ms, comp = event_ms(lambda: solve(use_kernel=False))
        marg = marginal_ms(lambda: solve(precision="high"), repeats=2)
        nit = res.niter.double()
        sum_nit = int(nit.sum())
        b_ms, b_by = solve_rows_bound(m, reals, sum_nit, True)
        lip = float(spectral_norm_psd(a @ a.conj().T))
        kkt = kkt_residual(res.x, y, a, 0.1, lip, 1e-4)
        kkt_comp = kkt_residual(comp.x, y, a, 0.1, lip, 1e-4)
        err_top, err_comp = rel_fro(res.x, top.x), rel_fro(res.x, comp.x)
        err_tc = rel_fro(top.x, comp.x)
        print(f"{tag} features x {y.shape[1]} channels, acc_ista, precision "
              f"'high', per_problem, tol 1e-4 ({card}): time to tol "
              f"{ms:.3f} ms, marginal per solve (chain of 6) {marg:.3f} ms, "
              f"bound of its solve_rows {b_ms:.3f} ms ({b_by}); niter "
              f"min/median/max {int(nit.min())}/{int(nit.median())}/"
              f"{int(nit.max())}, sum {sum_nit}; converged rows "
              f"{int(res.converged.sum())}/{m}; solve_rows launches "
              f"{launches[name]} (lasso_fista_wide.cu 1; slot waste "
              f"{waste:.4f})", flush=True)
        print(f"  precision 'highest' (bf16x6) {highest_ms:.3f} ms (niter "
              f"sum {int(top.niter.double().sum())}), use_kernel=False "
              f"{comp_ms:.3f} ms (max niter {int(comp.niter.max())}) "
              f"({card}); rel_fro x vs 'highest' {err_top:.3e}, vs "
              f"composition {err_comp:.3e} (limit {x_limit:.0e}); 'highest' "
              f"vs composition {err_tc:.3e}; KKT "
              f"residual / (L tol |x|) max {float(kkt.max()):.3f}, median "
              f"{float(kkt.median()):.3f} (composition max "
              f"{float(kkt_comp.max()):.3f}; limit {kkt_limit})", flush=True)
        check(bool(res.converged.all()), f"{tag}: not every row converged")
        check(res.x.shape == (m, f) and res.x.dtype == y.dtype
              and bool(torch.isfinite(torch.view_as_real(res.x) if complex_
                                      else res.x).all()),
              f"{tag}: x is not finite or has the wrong shape or dtype")
        check(err_top <= x_limit and err_comp <= x_limit,
              f"{tag}: x disagrees with the 'highest' or composition run")
        check(float(kkt.max()) <= kkt_limit,
              f"{tag}: the KKT conditions do not hold")
        # solve_rows per call on the path's inputs, against its twin.
        ah = a.conj().T
        gram, yah = a @ ah, y @ ah
        step = 1.0 / float(spectral_norm_psd(gram))
        x0 = torch.zeros((m, f), dtype=y.dtype, device=dev)
        ones, zeros = (torch.ones((m, 1), device=dev),
                       torch.zeros((m, 1), device=dev))
        n0 = torch.zeros((m, 1), dtype=torch.int32, device=dev)
        args = (yah, gram, x0, x0, ones, zeros, n0, step, 0.1 * step, 1e-4)
        kw = dict(momentum=True, restart=True, maxiter=4000, hi_lo=True)
        k_ms, got = event_ms(lambda: w(*args, **kw))
        p_ms, ref = event_ms(lambda: cl.solve_rows_plain(*args, **kw))
        err = rel_fro(got[0], ref[0])
        eq = float((got[4] == ref[4]).float().mean())
        # A stopping fault (the twin at tol 1e-3) must fail both x limits.
        early = cl.solve_rows_plain(*args[:-1], 1e-3, **kw)
        early_twin, early_x = rel_fro(early[0], ref[0]), rel_fro(early[0],
                                                                 comp.x)
        # The fixed budget on the same inputs: no row stops, so no stopping
        # noise hides the products' precision; the twin on a one-limb Gram
        # (a kernel that drops the hi.lo product) must fail the limit.
        fargs = args[:-1] + (0.0,)
        fkw = dict(kw, maxiter=WIDE_PATH_FIXED_ITERS, fixed=True)
        fixed = w(*fargs, **fkw)
        fref = cl.solve_rows_plain(*fargs, **fkw)
        ctl = cl.solve_rows_plain(yah, one_limb(gram), *fargs[2:], **fkw)
        err_fixed, err_ctl = (max(rel_fro(o[0], fref[0]), rel_fro(o[1], fref[1]))
                              for o in (fixed, ctl))
        print(f"  solve_rows per call {k_ms:.3f} ms, plain twin {p_ms:.3f} "
              f"ms ({card}); niter equal on {eq:.4f} of rows, rel_fro x "
              f"{err:.3e} (limit {twin_limit:.0e}); the twin at tol 1e-3 "
              f"{early_twin:.3e} from the twin, {early_x:.3e} from the "
              f"composition run (must exceed the limits); "
              f"{WIDE_PATH_FIXED_ITERS} fixed-budget iterations: rel_fro x, z "
              f"{err_fixed:.3e} (limit {SOLVE_LIMITS['fixed']:.0e}), the twin "
              f"on a one-limb Gram {err_ctl:.3e} (must exceed the limit)",
              flush=True)
        check(err <= twin_limit, f"{tag}: solve_rows disagrees with twin")
        check(early_twin > twin_limit and early_x > x_limit, f"{tag}: the "
              "x limits do not tell a stopping fault from the twin")
        check(err_fixed <= SOLVE_LIMITS["fixed"],
              f"{tag}: fixed-budget solve_rows disagrees with twin")
        check(err_ctl > SOLVE_LIMITS["fixed"], f"{tag}: the fixed-budget "
              "limit does not tell a one-limb Gram from the twin")
        stats[name] = (max_abs(got[:1], ref[:1]), k_ms, p_ms,
                       *solve_rows_bound(m, reals, int(got[4].double().sum()),
                                         True))
        del gram, yah, args, fargs, got, ref, early, top, comp, fixed, fref
        del ctl
        # solve_streaming: one wide launch a chunk of host rows.
        reset_counts()
        st = lasso.solve_streaming(y_np[:2000], a_np, 0.1, chunk_rows=1000,
                                   precision="high", **cfg)
        read_counts("solve_rows", 2)
        err_st = rel_fro(torch.from_numpy(st.x), res.x[:2000].cpu())
        print(f"  solve_streaming of its first 2,000 rows in 2 chunks: "
              f"solve_rows launches 2 (wide {w.wide_launches}); rel_fro x vs "
              f"the batch run {err_st:.3e} (limit {x_limit:.0e})", flush=True)
        check(w.wide_launches == 2 and err_st <= x_limit,
              f"{tag}: solve_streaming did not take the wide route, or its "
              "rows disagree with the batch run's")
        del y, a, res
    # Dictionary learning with 1,152 atoms: the inner coding in solve_rows'
    # fixed budget on the wide route, once an outer iteration; d and x
    # against the same solve on the composition.
    y, d0 = wide_dl_data(dev)

    def solve_dl(kernel):
        return dl.solve(y, d0, 0.05, maxiter=2, lasso_iter=8, lasso_tol=0.0,
                        use_kernel=kernel)

    reset_counts()
    res = solve_dl(True)
    torch.cuda.synchronize()
    w, sweeps = cl.solve_rows, cuda_dl.bcd_sweep.launches
    read_counts({"solve_rows": 2, "bcd_sweep": sweeps})
    wide_n = w.wide_launches
    comp = solve_dl(False)
    unit = float((res.d.norm(dim=1) - 1).abs().max())
    err_d, err_x = rel_fro(res.d, comp.d), rel_fro(res.x, comp.x)
    print(f"dictionary_learning.solve {y.shape[0]} x {y.shape[1]}, "
          f"{d0.shape[0]} atoms, use_kernel=True, 2 outer iterations x 8 "
          f"inner at lasso_tol 0: solve_rows launches {w.launches} (wide "
          f"{wide_n}), bcd_sweep {sweeps}; atoms' norms within {unit:.2e} of "
          f"1; rel_fro vs use_kernel=False d {err_d:.3e}, x {err_x:.3e} "
          f"(limit {WIDE_DL_LIMIT:.0e})", flush=True)
    check(wide_n == 2 and bool(torch.isfinite(res.d).all())
          and unit <= UNIT_LIMIT,
          "wide dictionary learning: the inner coding left the wide route, "
          "or the atoms are not finite unit vectors")
    check(err_d <= WIDE_DL_LIMIT and err_x <= WIDE_DL_LIMIT,
          "wide dictionary learning: d or x disagrees with the composition")
    return stats, launches


def lasso_crossover(lasso, gen, dev, card):
    """Whole-solve kernel against the composition path (per-problem
    acc_ista, tol 1e-4) at small batches: real f32 under 'highest',
    complex64 under 'highest' and 'high' (the composition's products are
    full f32 under both): where ``use_kernel='auto'`` would want a gate."""
    for (m, f, n), dt in itertools.product(
            ((64, 64, 48), (1000, 128, 96), (4000, 256, 128)),
            (torch.float32, torch.complex64)):
        a = torch.randn((f, n), generator=gen, device=dev, dtype=dt)
        xt = torch.randn((m, f), generator=gen, device=dev, dtype=dt) * (
            torch.rand((m, f), generator=gen, device=dev) < 0.05)
        y = xt @ a + 0.01 * torch.randn((m, n), generator=gen, device=dev,
                                        dtype=dt)
        for precision in (("highest", "high") if dt.is_complex
                          else ("highest",)):
            ms = {}
            for kernel in (True, False):
                def solve():
                    return lasso.solve(y, a, 0.1, tol=1e-4, maxiter=4000,
                                       method="acc_ista", per_problem=True,
                                       precision=precision,
                                       use_kernel=kernel)
                solve()
                torch.cuda.synchronize()
                ms[kernel], res = event_ms(solve)
            print(f"lasso.solve {m}x{f}x{n} {str(dt)[6:]} '{precision}' "
                  f"per-problem acc_ista: kernel path {ms[True]:.3f} ms, "
                  f"composition {ms[False]:.3f} ms (max niter "
                  f"{int(res.niter.max())}) ({card})", flush=True)


def masked_lasso_phase(lasso, dev, card, reset_counts, read_counts,
                       grad_routes, m, n, f):
    """Phase 11: the masked lasso at M x N, F features, 30% missing, 50
    FISTA iterations in f32 and in bf16 (both on the packed route), then
    10 in f32 and in bf16 on a weighted mask (the dense route, the weighted
    instances), all under the default use_kernel='auto', so the route
    checks hold its gate, each timed against use_kernel=False. Returns the
    masked_grad_rows launches, {dtype: launches} for the packed route and
    for the weighted one."""
    alpha = 0.05
    g = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn((f, n), generator=g, device=dev) / n ** 0.5
    xt = torch.randn((m, f), generator=g, device=dev) * (
        torch.rand((m, f), generator=g, device=dev) < 0.1)
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    my = (xt @ a + 0.01 * torch.randn((m, n), generator=g, device=dev)) * mask
    del xt
    # Observed entries weighted in [0.5, 1): pack_mask refuses such a mask
    # and every gradient takes the dense route; 'auto' sends weighted f32
    # and bf16 there (lasso._auto_takes_masked), and the f32 weighted run's
    # time against the composition's is the measurement behind that gate.
    w = 0.5 + 0.5 * torch.rand(mask.shape, generator=g, device=dev)

    def objective(x, my_, mask_, a_):
        r = mask_.float() * (x.float() @ a_.float()) - my_.float()
        return (0.5 * float(torch.sum(r.double() ** 2))
                + alpha * float(x.double().abs().sum()))

    launches = {False: {}, True: {}}
    for weighted_, iters in ((False, 50), (True, 10)):
        for dt in (torch.float32, torch.bfloat16):
            my_, mask_ = (my * w, mask * w) if weighted_ else (my, mask)
            my_, mask_, a_ = my_.to(dt), mask_.to(dt), a.to(dt)

            def solve(maxiter=iters, **kw_):
                return lasso.solve(my_, a_, alpha, mask=mask_,
                                   method="fista", tol=0.0, maxiter=maxiter,
                                   **kw_)

            solve(maxiter=2)   # warm-up
            torch.cuda.synchronize()
            reset_counts()
            ms, res = event_ms(solve)
            launches[weighted_][dt] = read_counts("masked_grad_rows", iters)
            routes = grad_routes()
            want = (0, iters) if weighted_ else (iters, 0)
            comp_ms, comp = event_ms(lambda: solve(use_kernel=False))
            obj0 = objective(torch.zeros((m, f), device=dev), my_, mask_, a_)
            obj1 = objective(res.x, my_, mask_, a_)
            err = rel_fro(res.x, comp.x)
            tag = (f"masked lasso {m}x{n} F={f} {str(dt)[6:]}, "
                   f"{'weighted mask' if weighted_ else '30% missing'}")
            print(f"{tag}, fista, {iters} iterations ({card}): "
                  f"{iters / ms * 1e3:.1f} iterations/s ({ms:.3f} ms), "
                  f"use_kernel=False {iters / comp_ms * 1e3:.1f} "
                  f"iterations/s ({comp_ms:.3f} ms), kernel / composition "
                  f"{ms / comp_ms:.3f}; objective {obj0:.6e} -> {obj1:.6e}; "
                  f"rel_fro x vs composition {err:.3e} (limit "
                  f"{MASKED_X_LIMIT[dt]:.0e}); masked_grad_rows launches "
                  f"{iters} (packed, dense route {routes})", flush=True)
            check(routes == want, f"{tag}: masked_grad_rows routes {routes}, "
                  f"expected {want}")
            check(res.niter == iters, f"{tag}: niter {res.niter} != {iters}")
            check(bool(torch.isfinite(res.x).all()), f"{tag}: non-finite x")
            check(np.isfinite(obj1) and obj1 < obj0,
                  f"{tag}: the objective did not fall")
            check(err <= MASKED_X_LIMIT[dt], f"{tag}: x disagrees with the "
                  "composition run")
            del my_, mask_, a_, res, comp
    return launches[False], launches[True]


def lasso_times(cl, gen, dev, card, y, a, fixed_shape, grad_shape):
    """Phase 12: the lasso kernels against their twins per call, with
    their bounds: solve_rows on config 2's data (y, a) and in the fixed
    budget at ``fixed_shape`` (M, F), masked_grad_rows at ``grad_shape``
    (M, N, F) as ``grad_times``. Returns {name: (max_abs_err, ms, plain_ms,
    bound_ms, bound_by)} at the main path's shapes."""
    from decomp_tpu_torch.ops.spectral import spectral_norm_psd

    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    # solve_rows on config 2's inputs, as lasso.solve calls it.
    gram = a @ a.T
    yah = y @ a.T
    step = 1.0 / float(spectral_norm_psd(gram))
    m, f = yah.shape
    x0, t0, d0, n0 = rows_start(m, f, dev)
    x0[5], d0[5], n0[5] = 0.0, 0.0, 0
    args = (yah, gram, x0, x0, t0, d0, n0, step, 0.1 * step, 1e-4)
    kw = dict(momentum=True, restart=True, maxiter=4000, hi_lo=True)
    got, old_ms, k_ms, waste = tma_against_mma(cl, args, kw, "config 2")
    ref = cl.solve_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    eq = (got[4] == ref[4])[:, 0]
    err = rel_fro(got[0], ref[0])
    print(f"kernel vs twin solve_rows config 2 ('high', tol 1e-4): niter "
          f"equal on {float(eq.float().mean()):.4f} of rows, rel_fro x "
          f"{err:.3e} (limit {C2_TWIN_LIMIT:.0e})", flush=True)
    check(err <= C2_TWIN_LIMIT, "config 2: solve_rows disagrees with twin")
    p_ms = cuda_ms(lambda: cl.solve_rows_plain(*args, **kw), 1)
    b = solve_rows_bound(m, f, int(got[4].double().sum()), True)
    out["solve_rows"] = (max_abs(got[:1], ref[:1]), k_ms, p_ms) + b
    print(f"solve_rows config 2 ({m}x{f}, 'high', acc_ista, tol 1e-4): "
          f"lasso_fista_tma.cu {k_ms:.3f} ms, lasso_fista.cu {old_ms:.3f} ms "
          f"(in turns; new / old {k_ms / old_ms:.3f}), plain twin "
          f"{p_ms:.3f} ms per call, bound {b[0]:.3f} ms ({b[1]}), slot "
          f"waste {waste:.4f} ({card})", flush=True)
    # 'highest' (full f32 FMAs, csrc/lasso_fista.cu) on the same inputs.
    kw_h = dict(kw, hi_lo=False)
    got_h = cl.solve_rows(*args, **kw_h)
    ref_h = cl.solve_rows_plain(*args, **kw_h)
    h_ms = cuda_ms(lambda: cl.solve_rows(*args, **kw_h), 2)
    ph_ms = cuda_ms(lambda: cl.solve_rows_plain(*args, **kw_h), 1)
    bh = solve_rows_bound(m, f, int(got_h[4].double().sum()), False)
    print(f"solve_rows config 2 ({m}x{f}, 'highest', acc_ista, tol 1e-4): "
          f"lasso_fista.cu {h_ms:.3f} ms, plain twin {ph_ms:.3f} ms per "
          f"call, bound {bh[0]:.3f} ms ({bh[1]}: full-f32 FMAs) ({card}); "
          f"rel_fro x vs twin {rel_fro(got_h[0], ref_h[0]):.3e}, niter equal "
          f"on {float((got_h[4] == ref_h[4]).float().mean()):.4f} of rows",
          flush=True)
    del gram, yah, args, got, ref, got_h, ref_h

    # solve_rows' fixed budget, 100 iterations.
    (m, f), iters = fixed_shape, 100
    yah, gram, step = rows_problem(gen, dev, m, f, 256)
    x0, t0, d0, n0 = rows_start(m, f, dev)
    args = (yah, gram, x0, x0, t0, d0, n0, step, 0.05 * step, 0.0)
    kw = dict(momentum=True, restart=True, maxiter=iters, hi_lo=True,
              fixed=True)
    got, old_ms, k_ms, waste = tma_against_mma(cl, args, kw, "fixed budget",
                                               reps=2)
    ref = cl.solve_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(rel_fro(got[0], ref[0]), rel_fro(got[1], ref[1]))
    check(err <= SOLVE_LIMITS["fixed"], f"fixed budget at {m}x{f}: "
          "solve_rows disagrees with twin")
    p_ms = cuda_ms(lambda: cl.solve_rows_plain(*args, **kw), 1)
    b = solve_rows_bound(m, f, int((got[4] - n0).double().sum()), True)
    print(f"solve_rows fixed budget {m}x{f}, {iters} iterations, 'high', "
          f"acc_ista: lasso_fista_tma.cu {k_ms:.3f} ms, lasso_fista.cu "
          f"{old_ms:.3f} ms (in turns; new / old {k_ms / old_ms:.3f}; "
          f"{k_ms * 1e6 / (m * iters):.3f} / {old_ms * 1e6 / (m * iters):.3f} "
          f"ns per row-iteration), plain twin {p_ms:.3f} ms per call, bound "
          f"{b[0]:.3f} ms ({b[1]}), slot waste {waste:.4f} ({card}); "
          f"rel_fro x, z {err:.3e} (limit {SOLVE_LIMITS['fixed']:.0e})",
          flush=True)
    del yah, gram, args, got, ref, x0

    # masked_grad_rows at the masked lasso's shape, f32 and bf16, on the
    # packed route (a 0/1 mask's bits) and on the weighted one (weights in
    # [0.5, 1)), each in turns with the first design of the dense-mask
    # gradient, csrc/lasso_grad.cu, on the same inputs.
    m, n, f = grad_shape
    for dt in (f32, bf16):
        args = grad_inputs(gen, dev, m, n, f, dt)
        limbs = cl.grad_limbs(args[3])
        out.update(grad_times(cl, "masked_grad_rows", args, card,
                              lambda my, mk, x, a: cl.masked_grad_rows(
                                  my, mk, x, a, a_limbs=limbs)))
        del args, limbs
    return out


def grad_bytes(rows, m, n, f, dt, bits):
    """The bytes a masked gradient must move at M x N, F features (or K
    atoms) of ``dt`` data: my and the mask (its bits, or weights in the
    data's dtype), x, and a (d), read once, and g in the data's dtype or G
    in f32 written once; the rows gradient reads a as its limbs (f32: 3
    bf16)."""
    e_b = dt.itemsize
    mask_b = 4 * m * (-(-n // 128) * 4) if bits else e_b * m * n
    if rows:
        return (e_b * (m * n + 2 * m * f) + mask_b
                + 2 * f * n * (3 if dt == torch.float32 else 1))
    return e_b * (m * n + m * f + f * n) + mask_b + 4 * f * n


def grad_times(module, name, args, card, call):
    """Phase 12 and 15b's per-call times of the masked gradient ``name`` of
    ``module`` on ``args`` = (my, 0/1 mask, x, a or d): its packed route
    on the mask's bits, then its weighted route on ``weighted(args)``,
    each held to its twin (and f64) and timed in turns with the first
    design on the same inputs (first, new, new, first), each beside its
    bound and its plain twin's time. ``call(my, mask, x, a)`` launches the
    route. Returns {entry name: (max_abs_err, ms, plain_ms, bound_ms,
    bound_by)}, the entries ``name`` + _packed or _weighted, + _bf16 for
    bf16 data."""
    from decomp_tpu_torch.ops import cuda_mu

    rows = name == "masked_grad_rows"
    first = getattr(module, "_grad_dense_mma_launch" if rows
                    else "_grad_dict_dense_mma_launch")
    plain = getattr(module, f"{name}_plain")
    my, mask, x, a = args
    dt = my.dtype
    (m, n), f = my.shape, x.shape[1]
    bits = cuda_mu.pack_mask(mask)
    out = {}
    g = torch.Generator(device=my.device).manual_seed(24)
    for route, kargs, targs in (
            ("packed", (my, bits, x, a), args),
            ("weighted",) + 2 * (weighted(g, args),)):
        e = compare_grad(module, name, targs, packed=route == "packed",
                         f64=True, first=True)
        t = [cuda_ms(fn, 10) for fn in (lambda: first(*targs),
                                        lambda: call(*kargs))]
        t += [cuda_ms(fn, 10) for fn in (lambda: call(*kargs),
                                         lambda: first(*targs))]
        k_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        p_ms = cuda_ms(lambda: plain(*targs), 2)
        nbytes = grad_bytes(rows, m, n, f, dt, route == "packed")
        b, fma = dtype_bounds(nbytes, 4.0 * m * n * f, dt)
        entry = f"{name}_{route}{'' if dt == torch.float32 else '_bf16'}"
        out[entry] = (e, k_ms, p_ms) + b
        print(f"{name} {m}x{n} {'F' if rows else 'K'}={f} {str(dt)[6:]}, "
              f"{route} route: {k_ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), first "
              f"design {old_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}) in turns, new "
              f"/ first {k_ms / old_ms:.3f}; plain twin {p_ms:.3f} ms per "
              f"call; bound {bound_text(b, fma)} ({nbytes / 1e6:.1f} MB), new "
              f"kernel at {b[0] / k_ms * 100:.1f}% of it, first design at "
              f"{b[0] / old_ms * 100:.1f}% ({card})", flush=True)
    return out


def tma_against_mma(cl, args, kw, tag, reps=3):
    """solve_rows 'high' on csrc/lasso_fista_tma.cu against
    csrc/lasso_fista.cu's 'high' path on the same inputs: bit for bit, then
    timed in turns (old, new, new, old). Returns (the new kernel's
    outputs, old ms, new ms, slot waste)."""
    got = cl.solve_rows(*args, **kw)
    waste = slot_waste(cl.solve_rows, got[4], args[6])
    old = cl._solve_rows_mma(*args, **kw)
    torch.cuda.synchronize()
    bits = same_bits(got, old)
    print(f"{tag}: lasso_fista_tma.cu bit-identical to lasso_fista.cu's "
          f"'high' path in x, z, t, done and niter: {bits}", flush=True)
    check(bits, f"{tag}: lasso_fista_tma.cu differs from lasso_fista.cu")
    del old
    t = [cuda_ms(fn, reps) for fn in (
        lambda: cl._solve_rows_mma(*args, **kw),
        lambda: cl.solve_rows(*args, **kw),
        lambda: cl.solve_rows(*args, **kw),
        lambda: cl._solve_rows_mma(*args, **kw))]
    return got, (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, waste


def solve_rows_scaling(cl, gen, dev, card):
    """Phase 12's diagnostic: both designs at 100 fixed-budget iterations
    ('high', acc_ista), F = 512 and complex 2Fc = 1,024, on one block's rows
    alone, on one full wave (132 blocks' rows) and (complex) at 262,144
    rows (the real one is the fixed-budget line above). One block alone
    much faster per row-iteration than a block in a full wave says that
    the card's aggregate L2 rate sets the pace; as fast, that one SM's copy
    latency does."""
    iters = 100
    for complex_, r in ((False, 32), (True, 16)):
        for m in (r, 132 * r) + ((262_144,) if complex_ else ()):
            yah, gram, step = rows_problem(gen, dev, m, 512, 256, complex_)
            x0, t0, d0, n0 = rows_start(m, 512, dev, yah.dtype)
            d0[5], n0[5] = 0.0, 0
            args = (yah, gram, x0, x0, t0, d0, n0, step, 0.05 * step, 0.0)
            kw = dict(momentum=True, restart=True, maxiter=iters,
                      hi_lo=True, fixed=True)
            reps = 1 if m > 100_000 else 3
            _, old_ms, k_ms, waste = tma_against_mma(
                cl, args, kw, f"scaling {m}x512{'c' if complex_ else ''}",
                reps=reps)
            print(f"solve_rows scaling, {m} rows x 512 "
                  f"{'complex (2Fc = 1,024 reals)' if complex_ else 'real'}, "
                  f"{iters} fixed iterations, 'high': lasso_fista.cu "
                  f"{old_ms:.3f} ms = {old_ms * 1e6 / (m * iters):.3f} ns per "
                  f"row-iteration; lasso_fista_tma.cu {k_ms:.3f} ms = "
                  f"{k_ms * 1e6 / (m * iters):.3f} ns; slot waste "
                  f"{waste:.4f} ({card})", flush=True)
            del yah, gram, args, x0


def solve_rows_routes(cl, gen, dev, card):
    """Phase 12: both 'high' designs, in turns on the same inputs and bit for
    bit, at the narrower shapes that 'high' also sends to
    csrc/lasso_fista_tma.cu: the crossover's batches (64 x 64, 1,000 x 128,
    4,000 x 256, real and complex features), phase 9's 1,000 x 200 and
    300 x 1,000 (complex 300 x 500), and dictionary learning's 'whole'
    inner coding at config 3's shape (20,000 patches, 256 atoms, fista, 15
    iterations, tol 1e-6). Acc_ista to tol 1e-4 elsewhere. Returns the
    shapes at which the new kernel was slower."""
    shapes = [(m, f, n, c) for c in (False, True)
              for m, f, n in ((64, 64, 48), (1000, 128, 96),
                              (4000, 256, 128))]
    shapes += [(1000, 200, 160, False), (300, 1000, 700, False),
               (300, 500, 350, True), (20_000, 256, 64, False)]
    slower = []
    for m, f, n, complex_ in shapes:
        dl = m == 20_000
        yah, gram, step = rows_problem(gen, dev, m, f, n, complex_)
        x0, t0, d0, n0 = rows_start(m, f, dev, yah.dtype)
        x0[5], d0[5], n0[5] = 0.0, 0.0, 0
        args = (yah, gram, x0, x0, t0, d0, n0, step, 0.1 * step,
                1e-6 if dl else 1e-4)
        kw = dict(momentum=True, restart=not dl, maxiter=15 if dl else 4000,
                  hi_lo=True)
        tag = (f"route {m}x{f}{'c' if complex_ else ''} "
               f"{'fista 15 iterations (DL whole)' if dl else 'acc_ista'}")
        got, old_ms, k_ms, waste = tma_against_mma(cl, args, kw, tag)
        print(f"solve_rows {tag}, 'high': lasso_fista_tma.cu {k_ms:.3f} ms, "
              f"lasso_fista.cu {old_ms:.3f} ms (in turns; new / old "
              f"{k_ms / old_ms:.3f}), niter sum "
              f"{int(got[4].double().sum())}, slot waste {waste:.4f} "
              f"({card})", flush=True)
        if k_ms >= old_ms:
            slower.append(tag)
        del yah, gram, args, got, x0
    print(f"solve_rows 'high': lasso_fista_tma.cu slower than lasso_fista.cu "
          f"at {slower or 'no shape'}", flush=True)
    return slower


def complex_times(cl, dev, card, y, a):
    """Phase 12, complex: solve_rows' complex mode against its twin per
    call on config-2-complex's data (y, a) as lasso.solve calls it
    ('high', acc_ista, tol 1e-4, maxiter 3,000). Returns (max_abs_err, ms,
    plain_ms, bound_ms, bound_by)."""
    from decomp_tpu_torch.ops.spectral import spectral_norm_psd

    ah = a.conj().T
    gram = a @ ah
    yah = y @ ah
    step = 1.0 / float(spectral_norm_psd(gram))
    m, f = yah.shape
    x0, t0, d0, n0 = rows_start(m, f, dev, yah.dtype)
    x0[5], d0[5], n0[5] = 0.0, 0.0, 0
    args = (yah, gram, x0, x0, t0, d0, n0, step, 0.1 * step, 1e-4)
    kw = dict(momentum=True, restart=True, maxiter=3000, hi_lo=True)
    got, old_ms, k_ms, waste = tma_against_mma(cl, args, kw,
                                               "config-2-complex")
    p_ms, ref = event_ms(lambda: cl.solve_rows_plain(*args, **kw))
    eq = (got[4] == ref[4])[:, 0]
    err = rel_fro(got[0], ref[0])
    print(f"kernel vs twin solve_rows config-2-complex ('high', tol 1e-4): "
          f"niter equal on {float(eq.float().mean()):.4f} of rows, rel_fro x "
          f"{err:.3e} (limit {C2C_TWIN_LIMIT:.0e})", flush=True)
    check(err <= C2C_TWIN_LIMIT, "config-2-complex: solve_rows disagrees "
          "with twin")
    b = solve_rows_bound(m, 2 * f, int(got[4].double().sum()), True)
    print(f"solve_rows config-2-complex ({m}x{f} complex, 2F = {2 * f} "
          f"reals, 'high', acc_ista, tol 1e-4): lasso_fista_tma.cu "
          f"{k_ms:.3f} ms, lasso_fista.cu {old_ms:.3f} ms (in turns; new / "
          f"old {k_ms / old_ms:.3f}), plain twin {p_ms:.3f} ms per call, "
          f"bound {b[0]:.3f} ms ({b[1]}), kernel / bound {k_ms / b[0]:.1f}, "
          f"slot waste {waste:.4f} ({card})", flush=True)
    return (max_abs(got[:1], ref[:1]), k_ms, p_ms) + b


def bcd_inputs(gen, dev, k, n, dead=None):
    """A = x^T x and B = x^T y of random x and y, and unit atoms d; atom
    ``dead`` gets all-zero statistics."""
    x = torch.randn((2000, k), generator=gen, device=dev)
    y = torch.randn((2000, n), generator=gen, device=dev)
    if dead is not None:
        x[:, dead] = 0
    d = torch.randn((k, n), generator=gen, device=dev)
    return x.T @ x, x.T @ y, d / torch.linalg.vector_norm(d, dim=1,
                                                          keepdim=True)


BCD_SOURCES = {"registers": "dl_bcd_sm90.cu", "cluster": "dl_bcd_cluster.cu",
               "shared": "dl_bcd.cu"}


def compare_bcd(cd, a, b, d, tag, dead=None, route=None):
    """bcd_sweep against its twin, with a bit-identical rerun; atom
    ``dead`` must be kept. ``route``: None, the public wrapper, whose two
    launches must take ``cd.bcd_route``'s route; 'shared', the first
    design (``csrc/dl_bcd.cu``, on no route) through its private launch.
    Returns the max abs error."""
    if route == "shared":
        sweep = cd._bcd_shared_launch
    else:
        sweep, route = cd.bcd_sweep, cd.bcd_route(*d.shape)
        counter = {"registers": "register_launches",
                   "cluster": "cluster_launches"}[route]
        before = getattr(cd.bcd_sweep, counter)
    out = sweep(a, b, d)
    again = sweep(a, b, d)
    ref = cd.bcd_sweep_plain(a, b, d)
    torch.cuda.synchronize()
    err = rel_fro(out, ref)
    same = torch.equal(out, again)
    kept = dead is None or torch.equal(out[dead], d[dead])
    tag = f"bcd_sweep {tag} ({route} route, {BCD_SOURCES[route]})"
    print(f"kernel vs twin {tag}: rel_fro {err:.3e} (limit {BCD_LIMIT:g}); "
          f"bit-identical rerun: {same}; dead atom kept: {kept}", flush=True)
    if sweep is cd.bcd_sweep:
        check(getattr(cd.bcd_sweep, counter) - before == 2,
              f"{tag}: the launches did not take the {route} route")
    check(np.isfinite(err) and err <= BCD_LIMIT, f"{tag}: kernel disagrees "
          "with twin")
    check(same, f"{tag}: two kernel runs differ")
    check(kept, f"{tag}: the dead atom moved")
    return max_abs([out], [ref])


def compare_bcd_edges(cd, dev):
    """The register route's division where it leaves div.rn's fast path,
    against the twin bit for bit: K = 1, A = [[1]] and d = 0, so u = b and
    the row comes back b / ||b||, with a subnormal quotient (3e-40 /
    sqrt(10)), one exactly halfway between 0 and the least subnormal
    (1e-45 / 2), and an infinite norm (||b||^2 overflows: every quotient
    is 0)."""
    a, d = torch.ones((1, 1), device=dev), torch.zeros((1, 4), device=dev)
    for row in ([3.0, 3e-40, 0.0, 1.0], [0.0, 1e-45, 2.0, 0.0],
                [3e38, 3e38, -1.0, 0.0]):
        b = torch.tensor([row], device=dev)
        out, ref = cd.bcd_sweep(a, b, d), cd.bcd_sweep_plain(a, b, d)
        same = torch.equal(out.view(torch.int32), ref.view(torch.int32))
        print(f"bcd_sweep (registers route, dl_bcd_sm90.cu) b = {row}: "
              f"{out.tolist()[0]}; the twin's bits: {same}", flush=True)
        check(same, f"bcd_sweep b = {row}: the division differs from the "
              "twin's")


def config3_phase(dl, dev, card, reset_counts, read_counts, bcd_routes):
    """Phase 14: BASELINE config 3 end to end through
    ``dictionary_learning.solve``. Returns the main run's bcd_sweep
    launches, its final statistics (A, B, d) and the marginal ms per
    solve."""
    from torch.profiler import ProfilerActivity, profile

    y_np, d0_np = config3_data()
    cfg = dict(tol=1e-5, maxiter=60, lasso_iter=15, precision="high")
    # Host arrays go to the card unless the caller asks for the CPU.
    small = dl.solve(y_np[:500], d0_np, 0.05, maxiter=2, lasso_iter=2)
    check(small.d.is_cuda, "a numpy y did not run on the card")
    y, d0 = (torch.from_numpy(v).to(dev) for v in (y_np, d0_np))

    def solve(**kw):
        return dl.solve(y, d0, 0.05, **cfg, **kw)

    solve()   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ms, res = event_ms(solve)
    launches = read_counts("bcd_sweep", res.niter)
    routes = bcd_routes()
    check(routes == (launches, 0), f"config 3: bcd_sweep routes {routes} "
          f"(register, cluster), expected ({launches}, 0)")
    comp_ms, comp = event_ms(lambda: solve(use_kernel=False))
    rec = solve(record_objective=True)
    obj = rec.objective[:rec.niter]
    marg = marginal_ms(solve, repeats=2)
    # Device activity only: host-side events would slow the host loop,
    # whose pace sets this solve's wall.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    unit = float((torch.linalg.vector_norm(res.d, dim=1) - 1).abs().max())
    err_d, err_x = rel_fro(res.d, comp.d), rel_fro(res.x, comp.x)
    print(f"config 3 dictionary_learning.solve {y.shape[0]}x{y.shape[1]}, "
          f"{d0.shape[0]} atoms, tol 1e-5, 60 outer x 15 inner, 'high' "
          f"({card}): {ms:.3f} ms per solve, marginal per solve (chain of 6) "
          f"{marg:.3f} ms; niter {res.niter}, converged {res.converged}; "
          f"bcd_sweep launches {launches} (register, cluster route "
          f"{routes}); use_kernel=False {comp_ms:.3f} ms",
          flush=True)
    print(f"  objective {float(obj[0]):.6e} -> {float(obj[-1]):.6e}; max "
          f"| ||d_k|| - 1 | {unit:.2e} (limit {UNIT_LIMIT:g}); rel_fro d vs "
          f"composition {err_d:.3e} (limit {C3_D_LIMIT:g}), x {err_x:.3e}; "
          f"device busy {busy_ms:.3f} ms of a {prof_ms:.3f} ms profiled solve "
          f"({busy_ms / prof_ms:.3f}; {busy_ms / ms:.3f} of the unprofiled "
          "solve)", flush=True)
    for e in kernels[:6]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms in {e.count:5d} "
              f"launches: {e.key[:70]}", flush=True)
    check(res.d.shape == d0.shape and bool(torch.isfinite(res.d).all())
          and bool(torch.isfinite(res.x).all()), "config 3: non-finite "
          "factors or the wrong shape")
    check(unit <= UNIT_LIMIT, "config 3: atoms are not unit norm")
    check(bool(torch.isfinite(obj).all()) and float(obj[-1]) < float(obj[0]),
          "config 3: the objective did not fall")
    check(err_d <= C3_D_LIMIT, "config 3: d disagrees with the composition")
    x = res.x
    return launches, (x.T @ x, x.T @ y, res.d), marg


def cluster_route_phase(dl, dev, card, reset_counts, read_counts,
                        bcd_routes, m=20_000, n=208, k=256, iters=5):
    """Phase 14b: dictionary learning whose sweep takes bcd_sweep's
    cluster route (csrc/dl_bcd_cluster.cu): M x N data with N above the
    register route's 64 channels, K atoms (256 x 208 was the largest K x N
    of the first design, csrc/dl_bcd.cu), ``iters`` outer iterations at
    tol 0 ('high'). Returns the run's cluster-route launches."""
    g = torch.Generator(device=dev).manual_seed(141)
    y = torch.randn((m, n), generator=g, device=dev)
    d0 = torch.randn((k, n), generator=g, device=dev)

    def solve():
        return dl.solve(y, d0, 0.05, tol=0.0, maxiter=iters, lasso_iter=15,
                        precision="high")

    solve()   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ms, res = event_ms(solve)
    launches = read_counts("bcd_sweep", iters)
    routes = bcd_routes()
    unit = float((torch.linalg.vector_norm(res.d, dim=1) - 1).abs().max())
    print(f"dictionary_learning.solve {m}x{n}, {k} atoms, {iters} outer x 15 "
          f"inner, 'high' ({card}): {ms:.3f} ms; bcd_sweep launches "
          f"{launches} (register, cluster route {routes}); max | ||d_k|| - 1 "
          f"| {unit:.2e}", flush=True)
    check(routes == (0, iters), f"phase 14b: bcd_sweep routes {routes}, "
          f"expected (0, {iters})")
    check(bool(torch.isfinite(res.d).all()) and unit <= UNIT_LIMIT,
          "phase 14b: non-finite or non-unit atoms")
    return launches


def wide_dictionary_phase(dl, dev, card, reset_counts, read_counts,
                          bcd_routes, m=100_000, n=1024, k=256, iters=5):
    """Phase 14c: ``dictionary_learning.solve`` on M x N f32 data (masked
    DL's width) with config 3's K atoms, ``iters`` outer x 15 inner
    iterations at tol 0, 'high': a dictionary (K x N = 262,144) that the
    first design did not take, so 'auto' sent it to the host loop. Every
    sweep must take the cluster route; d is held against the same run with
    ``_bcd_kernel=False`` (the twin, a host loop of launches per atom);
    unit atoms. Both runs are timed. Returns the run's cluster launches."""
    g = torch.Generator(device=dev).manual_seed(142)
    y = torch.randn((m, n), generator=g, device=dev)
    d0 = torch.randn((k, n), generator=g, device=dev)

    def solve(**kw):
        return dl.solve(y, d0, 0.05, tol=0.0, maxiter=iters, lasso_iter=15,
                        precision="high", **kw)

    solve()   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ms, res = event_ms(solve)
    launches = read_counts("bcd_sweep", iters)
    routes = bcd_routes()
    loop_ms, loop = event_ms(lambda: solve(_bcd_kernel=False))
    unit = float((torch.linalg.vector_norm(res.d, dim=1) - 1).abs().max())
    err_d = rel_fro(res.d, loop.d)
    print(f"dictionary_learning.solve {m}x{n} f32, {k} atoms, {iters} outer "
          f"x 15 inner, 'high' ({card}): {ms:.3f} ms ({ms / iters:.3f} ms an "
          f"outer iteration); _bcd_kernel=False (the host loop) "
          f"{loop_ms:.3f} ms ({loop_ms / iters:.3f}); bcd_sweep launches "
          f"{launches} (register, cluster route {routes}); rel_fro d vs the "
          f"host loop's {err_d:.3e} (limit {C3_D_LIMIT:g}); max | ||d_k|| - "
          f"1 | {unit:.2e}", flush=True)
    check(routes == (0, iters), f"phase 14c: bcd_sweep routes {routes}, "
          f"expected (0, {iters})")
    check(bool(torch.isfinite(res.d).all()) and unit <= UNIT_LIMIT,
          "phase 14c: non-finite or non-unit atoms")
    check(err_d <= C3_D_LIMIT, "phase 14c: d disagrees with the host loop")
    return launches


# Phase 15's runs, (weighted mask, dtype, outer iterations); phase 15c's.
MASKED_DL_RUNS = ((False, torch.float32, 20), (False, torch.bfloat16, 10),
                  (True, torch.float32, 2), (True, torch.bfloat16, 2))
WIDE_DL_RUNS = ((False, torch.float32, 5), (False, torch.bfloat16, 5),
                (True, torch.float32, 2), (True, torch.bfloat16, 2))


def masked_dl_phase(dl, dev, card, reset_counts, read_counts, mask_routes,
                    m, n, k, runs=MASKED_DL_RUNS, kernel_kw=None,
                    name="15"):
    """Phase 15 (and 15c): masked dictionary learning at M x N, K atoms,
    30% missing, planted; ``runs`` at tol 0, 15 inner iterations each
    (lasso_tol 0: a fixed inner budget): phase 15's 20 outer iterations in
    f32 and 10 in bf16 (both gradients on the packed route), then 2 in f32
    and in bf16 on a weighted mask (both on the dense route, the weighted
    instances), all under the default use_kernel='auto', so the route
    checks hold its gate; above 128 atoms every gradient on the wide route
    (csrc/grad_wide.cu), under ``kernel_kw(dtype)`` (use_kernel=True where
    'auto' does not take it). Each run timed against the composition.
    ``mask_routes()``: the (packed, dense, wide) launches since the reset of
    masked_grad_rows and of masked_grad_dict. Returns {dtype: (rows,
    dictionary) launches} of the runs on a 0/1 mask and of those on a
    weighted one, and the first f32 run's (my, mask, x, d)."""
    alpha, inner = 0.05, 15
    g = torch.Generator(device=dev).manual_seed(15)
    d_true = torch.randn((k, n), generator=g, device=dev)
    d_true /= torch.linalg.vector_norm(d_true, dim=1, keepdim=True)
    xt = torch.randn((m, k), generator=g, device=dev) * (
        torch.rand((m, k), generator=g, device=dev) < 0.1)
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    my = (xt @ d_true + 0.01 * torch.randn((m, n), generator=g, device=dev)
          ) * mask
    d0 = torch.randn((k, n), generator=g, device=dev)
    del xt, d_true

    def objective(x, d, my_, mask_):
        r = mask_.float() * (x.float() @ d.float()) - my_.float()
        return (0.5 * float(torch.sum(r.double() ** 2))
                + alpha * float(x.double().abs().sum()))

    # Observed entries weighted in [0.5, 1): pack_mask refuses such a mask
    # and both gradients take the dense routes, where 'auto' sends them.
    w = 0.5 + 0.5 * torch.rand(mask.shape, generator=g, device=dev)
    launches, kept = {False: {}, True: {}}, None
    wide = k > 128
    for weighted_, dt, iters in runs:
        my_, mask_ = (my * w, mask * w) if weighted_ else (my, mask)
        my_, mask_, d0_ = my_.to(dt), mask_.to(dt), d0.to(dt)
        kw = kernel_kw(dt) if kernel_kw else {}

        def solve(maxiter=iters, **kw_):
            return dl.solve(my_, d0_, alpha, mask=mask_, tol=0.0,
                            maxiter=maxiter, lasso_iter=inner, lasso_tol=0.0,
                            **{**kw, **kw_})

        first = solve(maxiter=1)   # warm-up, and the objective it leaves
        torch.cuda.synchronize()
        reset_counts()
        ms, res = event_ms(solve)
        read_counts({"masked_grad_dict": iters,
                     "masked_grad_rows": iters * inner})
        routes, d_routes = mask_routes()
        launches[weighted_][dt] = (iters * inner, iters)
        comp_ms, comp = event_ms(lambda: solve(use_kernel=False))
        obj1 = objective(first.x, first.d, my_, mask_)
        obj = objective(res.x, res.d, my_, mask_)
        err_d, err_x = rel_fro(res.d, comp.d), rel_fro(res.x, comp.x)
        lim = MASKED_DL_LIMIT[dt]
        tag = (f"phase {name}: masked dictionary learning {m}x{n} K={k} "
               f"{str(dt)[6:]}, "
               f"{'weighted mask' if weighted_ else '30% missing'}")
        how = kw or {"use_kernel": "auto"}
        print(f"{tag}, {iters} outer x {inner} inner, {how} ({card}): "
              f"{ms / iters:.3f} ms per outer iteration, use_kernel=False "
              f"{comp_ms / iters:.3f} ms, kernel / composition "
              f"{ms / comp_ms:.3f}; objective after 1 iteration "
              f"{obj1:.6e}, after {iters} {obj:.6e}; rel_fro vs composition "
              f"d {err_d:.3e}, x {err_x:.3e} (limit {lim:g}); launches "
              f"masked_grad_dict {iters} (packed, dense, wide route "
              f"{d_routes}), masked_grad_rows {iters * inner} (packed, "
              f"dense, wide route {routes})", flush=True)

        def want(count):
            return ((0, 0, count) if wide else (0, count, 0) if weighted_
                    else (count, 0, 0))

        r_want, d_want = want(iters * inner), want(iters)
        check(routes == r_want and d_routes == d_want, f"{tag}: routes "
              f"{routes} and {d_routes}, expected {r_want} and {d_want}")
        check(res.niter == iters, f"{tag}: niter {res.niter} != {iters}")
        check(bool(torch.isfinite(res.d).all())
              and bool(torch.isfinite(res.x).all()), f"{tag}: non-finite "
              "factors")
        check(np.isfinite(obj) and obj < obj1, f"{tag}: the objective did "
              "not fall")
        check(err_d <= lim and err_x <= lim, f"{tag}: the kernel path "
              "disagrees with the composition")
        if kept is None and not weighted_ and dt == torch.float32:
            kept = (my_, mask_, res.x, res.d)
        del first, res, comp
    return launches[False], launches[True], kept


def grad_dict_passes(cd, cuda_mu, args, card):
    """csrc/grad_dict_packed.cu's three launches: the split reads x and
    writes its limbs xc (M x 3 KT bf16); the statistics read my, the bits,
    xc and each N tile's limbs of d and write the partials; the reduction
    reads the partials and writes G."""
    my, mask, x, d = args
    bits = cuda_mu.pack_mask(mask)
    (m, n), k = my.shape, d.shape[0]
    kt = 64 if k <= 64 else 128
    rows = cd.grad_dict_packed_rows(m, n)
    chunks = -(-m // rows)
    xc, part = m * 3 * kt * 2, chunks * k * n * 4
    nbytes = {"split_rows": m * k * 4 + xc,
              "grad_dict_stats": (m * n * 4 + bits.numel() * 4 + xc
                                  + 3 * kt * n * 2 + part),
              "reduce_kernel": part + k * n * 4}
    # Two products, 6 bf16 passes of 2MNK each at the rank tile KT.
    pass_times(lambda: cd.masked_grad_dict(my, bits, x, d), nbytes,
               f"{m}x{n} K={k} ({chunks} chunks of {rows} rows)", card,
               ops={"grad_dict_stats": 12 * 2.0 * m * n * kt})


def dl_times(cd, card, c3, c3_marg, c3_niter, masked):
    """Phase 15b: the dictionary-learning kernels against their twins per
    call, with their bounds: bcd_sweep on config 3's statistics ``c3`` =
    (A, B, d), masked_grad_dict on phase 15's (my, mask, x, d) as
    ``grad_times``, in f32 and bf16. Returns {name: (max_abs_err, ms,
    plain_ms, bound_ms, bound_by)}."""
    from decomp_tpu_torch.ops import cuda_mu

    out = {}
    a, b, d = c3
    k, n = d.shape
    # Phase 13's check on phase 14's final statistics, both routes.
    e = compare_bcd(cd, a, b, d, "on config 3's final statistics")
    e_old = compare_bcd(cd, a, b, d, "on config 3's final statistics",
                        route="shared")
    t = [cuda_ms(fn, 20) for fn in (
        lambda: cd._bcd_shared_launch(a, b, d),
        lambda: cd.bcd_sweep(a, b, d))]
    t += [cuda_ms(fn, 20) for fn in (
        lambda: cd.bcd_sweep(a, b, d),
        lambda: cd._bcd_shared_launch(a, b, d))]
    k_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    p_ms = cuda_ms(lambda: cd.bcd_sweep_plain(a, b, d), 2)
    bnd = bound(4 * (k * k + 3 * k * n), 2.0 * k * k * n, torch.float32)
    out["bcd_sweep"] = (e, k_ms, p_ms) + bnd
    print(f"bcd_sweep config 3 (K={k}, N={n}), in turns on the same inputs: "
          f"register route (dl_bcd_sm90.cu) {k_ms:.4f} ms per sweep "
          f"({t[1]:.4f}, {t[2]:.4f}; {k_ms * 1e3 / k:.3f} us per atom), "
          f"first design (dl_bcd.cu) {old_ms:.4f} ms ({t[0]:.4f}, "
          f"{t[3]:.4f}; {old_ms * 1e3 / k:.3f} us per atom), new / old "
          f"{k_ms / old_ms:.3f}; plain twin {p_ms:.3f} ms, bound "
          f"{bnd[0] * 1e3:.4f} us ({bnd[1]}) ({card}); {c3_niter} sweeps = "
          f"{c3_niter * k_ms / c3_marg * 100:.1f}% of config 3's marginal "
          f"per solve ({c3_niter * old_ms / c3_marg * 100:.1f}% with the "
          "first design)", flush=True)
    out["bcd_sweep_cluster"] = cluster_times(cd, card, e_old)
    # masked_grad_dict on phase 15's factors, f32 and bf16, as phase 12's
    # masked_grad_rows; the f32 packed route's passes from torch.profiler.
    for dt in (torch.float32, torch.bfloat16):
        args = tuple(v.to(dt) for v in masked)
        out.update(grad_times(cd, "masked_grad_dict", args, card,
                              cd.masked_grad_dict))
        if dt == torch.float32:
            grad_dict_passes(cd, cuda_mu, args, card)
            limbs_ms = cuda_ms(lambda: cuda_mu.column_limbs(args[3], 128), 10)
            print(f"  d's limbs (cuda_mu.column_limbs, torch ops, once per "
                  f"call): {limbs_ms:.4f} ms per call ({card})", flush=True)
        del args
    return out


def cluster_times(cd, card, e_first):
    """bcd_sweep's cluster route (csrc/dl_bcd_cluster.cu): at phase 14b's
    256 x 208 in turns with the first design, csrc/dl_bcd.cu, on the same
    inputs (old, new, new, old), then at 256 x 1,024 and the TPU gate's
    corners against the twin; each per sweep and per atom beside its bytes
    bound (4 (K^2 + 3 K N) over 3.35 TB/s). ``e_first``: the first
    design's error, printed beside. Returns the kernels-line entry of
    256 x 208: (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    gen = torch.Generator(device="cuda").manual_seed(1515)
    dev = torch.device("cuda", torch.cuda.current_device())
    entry = None
    for k, n in ((256, 208), (256, 1024), (256, 3712), (8, 98176),
                 (1736, 128)):
        a, b, d = bcd_inputs(gen, dev, k, n)
        plan = cd.bcd_cluster_plan(k, n)
        e = compare_bcd(cd, a, b, d, f"K={k} N={n} (timed)")
        bnd = bound(4 * (k * k + 3 * k * n), 2.0 * k * k * n, torch.float32)
        p_ms = cuda_ms(lambda: cd.bcd_sweep_plain(a, b, d), 2)
        if (k, n) == (256, 208):
            t = [cuda_ms(fn, 20) for fn in (
                lambda: cd._bcd_shared_launch(a, b, d),
                lambda: cd.bcd_sweep(a, b, d))]
            t += [cuda_ms(fn, 20) for fn in (
                lambda: cd.bcd_sweep(a, b, d),
                lambda: cd._bcd_shared_launch(a, b, d))]
            k_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            turns = (f"{t[1]:.4f}, {t[2]:.4f}; first design (dl_bcd.cu) "
                     f"{old_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}; "
                     f"{old_ms * 1e3 / k:.3f} us per atom; rel_fro "
                     f"{e_first:.3e} at config 3's shape) in turns, new / old "
                     f"{k_ms / old_ms:.3f}")
            entry = (e, k_ms, p_ms) + bnd
        else:
            t = [cuda_ms(lambda: cd.bcd_sweep(a, b, d), 10) for _ in range(2)]
            k_ms = sum(t) / 2
            turns = f"{t[0]:.4f}, {t[1]:.4f}"
        print(f"bcd_sweep K={k} N={n}, cluster route (dl_bcd_cluster.cu, "
              f"{plan.clusters} blocks of {plan.threads} threads, "
              f"{plan.sets - plan.on_sets} of {plan.sets} sets a block off "
              f"chip): {k_ms:.4f} ms per sweep ({turns}), "
              f"{k_ms * 1e3 / k:.3f} us per atom; plain twin {p_ms:.3f} ms "
              f"({p_ms / k_ms:.1f}x); bound {bnd[0] * 1e3:.4f} us ({bnd[1]}), "
              f"kernel / bound {k_ms / bnd[0]:.1f} ({card})", flush=True)
        del a, b, d
    return entry


def profiled(fn):
    """(device busy ms, kernel launches, wall ms) of one call of ``fn``
    under ``torch.profiler`` (device activity only: host-side events would
    slow a host loop, whose pace sets the wall)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels), wall)


def f32_dense_phase(nmf, nmf_mod, cuda_mu, dev, card, reset_counts,
                    read_counts):
    """Phase 4b: dense MU on f32 data at the main path's width,
    ``nmf.solve(y, rank=128, method='mu', tol=0)`` on a 262,144 x 10,112
    f32 matrix (10.6 GB), 20 iterations: one launch per iteration on the
    packed route (csrc/mu_dense_packed.cu), none on the TMA route or on
    csrc/mu_stats_dense.cu (``cuda_mu._dense_mma_launch``, spied),
    finite nonnegative factors and a falling reconstruction error. Before
    the solve, one kernel call against the twin at this shape, the kernel
    timed in turns with the first design on the same inputs and once against
    the twin, and its passes from ``torch.profiler``. Returns the kernels
    line's figures: (launches, max_abs_err, ms, plain_ms, bound)."""
    f32 = torch.float32
    m, n, k, iters = 262_144, 10112, 128, 20
    g = torch.Generator(device=dev).manual_seed(41)
    y = torch.rand((m, n), generator=g, device=dev)
    d0, x0 = nmf_mod._init_factors(torch.Generator(device=dev).manual_seed(0),
                                   y, None, None, k)
    err_abs = compare_dense_packed(cuda_mu, (y, x0, d0),
                                   tag="(the f32 path's inputs)")
    kernel_ms, _, plain_ms, b = time_dense_packed(cuda_mu, (y, x0, d0), 5,
                                                  card, err_abs)

    rows = torch.arange(0, m, 1024, device=dev)
    ys = y[rows]

    def recon_err(x, d):
        return float(torch.linalg.vector_norm(ys - x[rows] @ d)
                     / torch.linalg.vector_norm(ys))

    err0 = recon_err(x0, d0)
    del x0, d0
    kw = dict(rank=k, method="mu", tol=0.0, eps=EPS, random_seed=0)
    nmf.solve(y, maxiter=2, **kw)  # warm-up
    old_calls = []
    pr1 = cuda_mu._dense_mma_launch

    def spy(*a, **kwargs):
        old_calls.append(1)
        return pr1(*a, **kwargs)

    torch.cuda.synchronize()
    reset_counts()
    cuda_mu._dense_mma_launch = spy
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    try:
        e0.record()
        res = nmf.solve(y, maxiter=iters, **kw)
        e1.record()
        torch.cuda.synchronize()
    finally:
        cuda_mu._dense_mma_launch = pr1
    launches = read_counts("mu_stats_dense", iters)
    routes = (cuda_mu.mu_stats_dense.packed_launches,
              cuda_mu.mu_stats_dense.tma_launches, len(old_calls))
    check(routes == (iters, 0, 0), f"f32 dense path: (packed, TMA, mma) "
          f"route launches {routes}, expected ({iters}, 0, 0)")
    solve_s = e0.elapsed_time(e1) / 1e3
    check(res.niter == iters, f"niter {res.niter} != {iters}")
    check(res.x.shape == (m, k) and res.d.shape == (k, n), "factor shapes")
    check(res.x.dtype == f32 and res.d.dtype == f32, "factor dtypes")
    for name, v in (("x", res.x), ("d", res.d)):
        check(bool(torch.isfinite(v).all()), f"{name} has non-finite values")
        check(bool((v >= 0).all()), f"{name} has negative values")
    err1 = recon_err(res.x, res.d)
    check(err1 < err0, f"f32 dense path: reconstruction error did not "
          f"fall: {err0} -> {err1}")
    tflops = flops_per_iter(m, n, k) * iters / solve_s / 1e12
    print(f"f32 dense path nmf.solve(method='mu') {m}x{n} f32, rank {k}: "
          f"{iters} iterations in {solve_s:.3f} s = {iters / solve_s:.3f} "
          f"iters/s, {solve_s * 1e3 / iters:.3f} ms per iteration, "
          f"{tflops:.2f} TFLOP/s ({card}); mu_stats_dense launches "
          f"{launches} (mu_dense_packed.cu {routes[0]}, TMA {routes[1]}, "
          f"mu_stats_dense.cu {routes[2]}); sampled relative reconstruction "
          f"error {err0:.4f} -> {err1:.4f}", flush=True)
    del res, y, ys
    return launches, err_abs, kernel_ms, plain_ms, b


def compare_wide_rank(cuda_mu, kind, args, inner=1, tag=""):
    """Phase 4c: one instance of the wide-rank MU route (csrc/mu_wide.cu)
    against its twin on ``args`` = (y or my, mask, x, d): ``kind`` dense
    (``mu_stats_dense``, ``inner`` x updates), bits (``mu_stats_masked`` on
    the mask's bits) or weights (on the dense mask), both calls counted in
    ``.wide_launches``, a bit-identical rerun, every output within
    GRAD_LIMIT of its dtype. Returns the outputs' max abs error."""
    y, mask, x, d = args
    if kind == "dense":
        w = cuda_mu.mu_stats_dense

        def call():
            return w(y, x, d, EPS, inner_iter=inner)

        ref = cuda_mu.mu_stats_dense_plain(y, x, d, EPS, inner_iter=inner)
    else:
        w = cuda_mu.mu_stats_masked
        km = cuda_mu.pack_mask(mask) if kind == "bits" else mask
        check(km is not None, "pack_mask refused a 0/1 mask")

        def call():
            return w(y, km, x, d, EPS)

        ref = cuda_mu.mu_stats_masked_plain(y, mask, x, d, EPS)
    before = w.wide_launches
    out = call()
    again = call()
    torch.cuda.synchronize()
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    lim = GRAD_LIMIT[y.dtype]
    tag = (f"{w.__name__} wide route, {kind} {y.shape[0]}x{y.shape[1]} "
           f"K={d.shape[0]}{f' inner={inner}' if inner > 1 else ''} "
           f"data={str(y.dtype)[6:]} x={str(x.dtype)[6:]}"
           + (f", {tag}" if tag else ""))
    print(f"kernel vs twin {tag}: rel_fro " + " ".join(
        f"{nm}={e:.3e}" for nm, e in zip(
            ("x_new", "numd", "gram" if kind == "dense" else "dend"), errs))
        + f" (limit {lim:g}); bit-identical rerun: {same}", flush=True)
    check(w.wide_launches == before + 2, f"{tag}: not on the wide route")
    check(all(np.isfinite(errs)), f"{tag}: non-finite outputs")
    check(max(errs) <= lim, f"{tag}: kernel disagrees with twin")
    check(same, f"{tag}: two kernel runs differ")
    return max_abs(out, ref)


def wide_rank_inputs(gen, dev, m, n, k, ydt, xdt, kind):
    """(y or my, mask, x, d) for phase 4c: y uniform in [0, 1), 30% of
    the entries missing (masked kinds: my = mask y; weights: the observed
    entries weighted in [0.5, 1)), x and d uniform in [0.1, 1.1)."""
    args = stats_inputs(gen, dev, m, n, k, ydt, xdt, kind != "dense")
    if kind == "dense":
        y, x, d = args
        return y, None, x, d
    return weighted(gen, args) if kind == "weights" else args


def wide_rank_bound(kind, m, n, k, ydt):
    """(ms, by) of the TPU kernel's own work at one call: the data (and the
    mask: bits or weights) read once, f32 x read and x_new written, d
    read, the statistics written; dense 4MNK + 4MK^2, masked 12MNK
    operations, as six bf16 passes at f32 (bf16x6: the wide route runs
    every f32 product so, x G included) and one at bf16."""
    from decomp_tpu_torch.ops.cuda_mu import packed_words

    e = ydt.itemsize
    if kind == "dense":
        ops, stats, mask_b = 4.0 * m * n * k + 4.0 * m * k * k, k * n + k * k, 0
    else:
        ops, stats = 12.0 * m * n * k, 2 * k * n
        mask_b = (e * m * n if kind == "weights"
                  else 4 * m * packed_words(n))
    nbytes = e * (m * n + k * n) + mask_b + 8 * m * k + 4 * stats
    return bound(nbytes, (6.0 if ydt == torch.float32 else 1.0) * ops,
                 torch.bfloat16)


def wide_masked_passes(cuda_mu, args, kind, card):
    """The masked wide route's six launches at one call (csrc/mu_wide.cu):
    the prep reads x and writes cdt(x)'s limbs; E1 and E2 (wide_resid, two
    launches) each read the limbs and the mask and write E; the x update
    (mask_xupd) reads my, E1 and x and writes x_new and its limbs; the
    statistics (mask_stats) read my, E2 and x_new's limbs and write the
    partials; the reduction reads them and writes numd and dend. Each
    beside its bytes, and the products beside their bf16 MMA rate."""
    my, mask, x, d = args
    km = cuda_mu.pack_mask(mask) if kind == "bits" else mask
    (m, n), k = my.shape, d.shape[0]
    e, kp = my.element_size(), -(-k // 128) * 128
    limbs = cuda_mu.limb_count(my.dtype)
    xl = 2 * limbs * m * kp
    mask_b = 4 * km.numel() if kind == "bits" else e * m * n
    chunks = -(-m // cuda_mu.wide_mstats_rows(m, n, kp))
    part = 4 * chunks * 2 * k * n
    prod = 2.0 * m * n * k * (6 if limbs == 3 else 1)
    nbytes = {"prep_x": 4 * m * k + xl,
              "wide_resid": 2 * (xl + mask_b + e * m * n),
              "mask_xupd": 2 * e * m * n + 8 * m * k + xl,
              "mask_stats": 2 * e * m * n + xl + part,
              "reduce_kernel": part + 8 * k * n}
    ops = {"wide_resid": 2 * prod, "mask_xupd": 2 * prod,
           "mask_stats": 2 * prod}
    pass_times(lambda: cuda_mu.mu_stats_masked(my, km, x, d, EPS), nbytes,
               f"masked wide {kind} {m}x{n} K={k} {str(my.dtype)[6:]}", card,
               ops=ops)


def wide_rank_phase(nmf, nmf_mod, cuda_mu, dev, card, reset_counts,
                    read_counts):
    """Phase 4c: MU above rank 128 on the wide route (csrc/mu_wide.cu).
    Each instance against its twin (``compare_wide_rank``): dense f32 and
    bf16 with f32 and bf16 x, masked f32 and bf16 on bits and on weights,
    at WIDE_RANK_SHAPES, and f32 at the gate's corners (WIDE_RANK_CORNERS);
    each instance per call at WIDE_RANK_PATH against its twin and beside
    its bound (the kernels line's figures); then the path at 100,000 x
    1,024, rank 256: ``nmf.solve(method='mu')`` dense, f32 and bf16 data
    with f32 factors, 20 iterations at tol 0, each in ms an iteration in
    turns with ``use_kernel=False`` (kernel, composition, composition,
    kernel); ``nmf.masked_completion`` on planted rank-256 data with 30%
    missing, f32 (``mixed=False``) and bf16 (``mixed=True``), to the
    held-out stop (WIDE_RANK_STOP), held-out error < 5e-2; and
    ``nmf.solve`` on weights in [0.5, 1), f32 and bf16, 5 iterations. Each
    path under 'auto' where ``nmf._auto_rank`` takes its dtype and width,
    else with use_kernel=True, every launch counted on the wide route.
    Returns ({entry: (max_abs_err, ms, plain_ms, bound_ms, bound_by)},
    {entry: launches})."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(426)
    for ydt, xdts in ((f32, (f32,)), (bf16, (f32, bf16))):
        for xdt in xdts:
            for m, n, k, inner in WIDE_RANK_SHAPES:
                compare_wide_rank(cuda_mu, "dense", wide_rank_inputs(
                    gen, dev, m, n, k, ydt, xdt, "dense"), inner)
                if inner == 1:
                    for kind in ("bits", "weights"):
                        compare_wide_rank(cuda_mu, kind, wide_rank_inputs(
                            gen, dev, m, n, k, ydt, xdt, kind))
    for kind, corners in WIDE_RANK_CORNERS.items():
        for m, n, k in corners:
            for sub in (("dense",) if kind == "dense"
                        else ("bits", "weights")):
                compare_wide_rank(cuda_mu, sub, wide_rank_inputs(
                    gen, dev, m, n, k, f32, f32, sub), tag="the gate's corner")
                torch.cuda.empty_cache()

    m, n, k = WIDE_RANK_PATH
    stats = {}
    for kind in ("dense", "bits", "weights"):
        for ydt in (f32, bf16):
            args = wide_rank_inputs(gen, dev, m, n, k, ydt, f32, kind)
            err = compare_wide_rank(cuda_mu, kind, args,
                                    tag="the path's shape")
            y, mask, x, d = args
            if kind == "dense":
                def call():
                    return cuda_mu.mu_stats_dense(y, x, d, EPS)

                def plain():
                    return cuda_mu.mu_stats_dense_plain(y, x, d, EPS)
            else:
                km = cuda_mu.pack_mask(mask) if kind == "bits" else mask

                def call():
                    return cuda_mu.mu_stats_masked(y, km, x, d, EPS)

                def plain():
                    return cuda_mu.mu_stats_masked_plain(y, mask, x, d, EPS)
            ms, p_ms = cuda_ms(call, 5), cuda_ms(plain, 2)
            b = wide_rank_bound(kind, m, n, k, ydt)
            entry = ("mu_stats_dense_wide" if kind == "dense"
                     else "mu_stats_masked_wide"
                     + ("_weighted" if kind == "weights" else ""))
            entry += "" if ydt == f32 else "_bf16"
            stats[entry] = (err, ms, p_ms) + b
            print(f"{entry} {m}x{n} K={k} data={str(ydt)[6:]} x=float32: "
                  f"{ms:.4f} ms per call, plain twin {p_ms:.3f} ms, bound "
                  f"{b[0]:.4f} ms ({b[1]}), kernel at {b[0] / ms:.1%} of it; "
                  f"max_abs_err {err:.3e} ({card})", flush=True)
            if kind != "dense":
                wide_masked_passes(cuda_mu, args, kind, card)
            del args, y, mask, x, d
    torch.cuda.empty_cache()

    def kernel_kw(dt, masked):
        return ({} if nmf_mod._auto_rank("mu", n, k, dt, masked, f32)
                else {"use_kernel": True})

    launches = {}
    g = torch.Generator(device=dev).manual_seed(43)
    y = torch.rand((m, n), generator=g, device=dev)
    rows = torch.arange(0, m, 256, device=dev)
    for dt in (f32, bf16):
        yy = y if dt == f32 else y.to(bf16)
        ys = yy[rows].float()
        kw = dict(rank=k, method="mu", tol=0.0, eps=EPS, random_seed=0,
                  factor_dtype=None if dt == f32 else f32)
        kkw = kernel_kw(dt, False)
        nmf.solve(yy, maxiter=2, **kw, **kkw)   # warm-up
        nmf.solve(yy, maxiter=2, use_kernel=False, **kw)
        times, res = [], {}
        for path in ("kernel", "composition", "composition", "kernel"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            r = nmf.solve(yy, maxiter=20, **kw,
                          **(kkw if path == "kernel" else
                             {"use_kernel": False}))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / 20)
            want = 20 if path == "kernel" else 0
            got = read_counts("mu_stats_dense", want)
            check(cuda_mu.mu_stats_dense.wide_launches == want,
                  f"wide dense path {dt}: {path} run launched "
                  f"{cuda_mu.mu_stats_dense.wide_launches} wide, expected "
                  f"{want}")
            if path not in res:
                res[path] = r
                if path == "kernel":
                    launches["mu_stats_dense_wide"
                             + ("" if dt == f32 else "_bf16")] = got
        rk, rc = res["kernel"], res["composition"]
        for name, t in (("x", rk.x), ("d", rk.d)):
            check(bool(torch.isfinite(t).all()) and bool((t >= 0).all()),
                  f"wide dense path {dt}: {name} not finite and nonnegative")
        d0, x0 = nmf_mod._init_factors(
            torch.Generator(device=dev).manual_seed(0), yy, None, None, k,
            f32)
        err0 = float(torch.linalg.vector_norm(ys - x0[rows] @ d0)
                     / torch.linalg.vector_norm(ys))
        del d0, x0
        err1 = float(torch.linalg.vector_norm(ys - rk.x[rows] @ rk.d)
                     / torch.linalg.vector_norm(ys))
        check(err1 < err0 and rk.niter == 20, f"wide dense path {dt}: "
              f"reconstruction error {err1}, niter {rk.niter}")
        k_ms, c_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        print(f"wide dense path nmf.solve(method='mu') {m}x{n} "
              f"{str(dt)[6:]} data, f32 factors, rank {k}, "
              f"{'auto' if not kkw else 'use_kernel=True'}: kernel path "
              f"{k_ms:.4f} ms an iteration ({times[0]:.4f}, {times[3]:.4f}), "
              f"use_kernel=False {c_ms:.4f} ms ({times[1]:.4f}, "
              f"{times[2]:.4f}) in turns, kernel / composition "
              f"{k_ms / c_ms:.3f} ({card}); sampled relative reconstruction "
              f"error {err0:.4f} -> {err1:.4f}; d against the composition run "
              f"{rel_fro(rk.d, rc.d):.3e}, x {rel_fro(rk.x, rc.x):.3e}",
              flush=True)
        del res, rk, rc, yy, ys
    del y

    g = torch.Generator(device=dev).manual_seed(44)
    y = (torch.rand((m, k), generator=g, device=dev)
         @ torch.rand((k, n), generator=g, device=dev))
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    miss = 1.0 - mask
    tol, cap = WIDE_RANK_STOP
    for mixed in (False, True):
        dt = bf16 if mixed else f32
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = nmf.masked_completion(y, mask, rank=k, tol=tol, maxiter=cap,
                                    random_seed=4, mixed=mixed,
                                    **kernel_kw(dt, True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts("mu_stats_masked", res.niter)
        check(cuda_mu.mu_stats_masked.wide_launches == res.niter,
              f"wide masked completion {dt}: "
              f"{cuda_mu.mu_stats_masked.wide_launches} of {res.niter} "
              "launches on the wide route")
        launches["mu_stats_masked_wide" + ("_bf16" if mixed else "")] = got
        ho = float(res.aux["heldout_rel_err"])
        true_err = float(torch.linalg.vector_norm(miss * (res.x @ res.d - y))
                         / torch.linalg.vector_norm(miss * y))
        print(f"wide masked completion nmf.masked_completion(mixed={mixed}) "
              f"{m}x{n} planted rank {k}, 30% missing ({str(dt)[6:]} data, "
              f"f32 factors): converged={res.converged} after {res.niter} "
              f"iterations in {wall:.3f} s ({wall * 1e3 / res.niter:.4f} ms "
              f"an iteration; {card}); held-out relative error {ho:.4e}, "
              f"true error on the missing entries {true_err:.4e}; "
              f"mu_stats_masked launches {got}, all on the wide route",
              flush=True)
        check(ho < 5e-2, f"wide masked completion {dt}: held-out relative "
              f"error {ho} >= 5e-2")
        for name, t in (("x", res.x), ("d", res.d)):
            check(bool(torch.isfinite(t).all()) and bool((t >= 0).all()),
                  f"wide masked completion {dt}: {name} not finite and "
                  "nonnegative")
        del res
    w = mask * (0.5 + 0.5 * torch.rand((m, n), generator=g, device=dev))
    for dt in (f32, bf16):
        torch.cuda.synchronize()
        reset_counts()
        res = nmf.solve(y.to(dt), mask=w.to(dt), rank=k, method="mu",
                        tol=0.0, maxiter=5, random_seed=0, use_kernel=True,
                        factor_dtype=None if dt == f32 else f32)
        torch.cuda.synchronize()
        got = read_counts("mu_stats_masked", 5)
        check(cuda_mu.mu_stats_masked.wide_launches == 5
              and cuda_mu.mu_stats_masked.dense_launches == 0,
              f"weighted wide path {dt}: not every launch on the wide route")
        check(bool(torch.isfinite(res.d).all()), f"weighted wide path {dt}: "
              "non-finite d")
        launches["mu_stats_masked_wide_weighted"
                 + ("" if dt == f32 else "_bf16")] = got
        print(f"weighted wide path nmf.solve(mask=weights in [0.5, 1)) "
              f"{m}x{n} rank {k} {str(dt)[6:]} data: 5 launches, all on the "
              f"wide route ({card})", flush=True)
        del res
    del y, mask, miss, w
    torch.cuda.empty_cache()
    return stats, launches


def compare_kl_wide(cuda_mu, kind, args, eps=EPS, tag=""):
    """Phase 4d: one instance of the wide-rank KL-MU route (csrc/mu_wide.cu's
    KL entries) against its twin on ``args`` = (my, mask, x, d): ``kind``
    dense (``kl_stats_dense``), bits (``kl_stats_masked`` on the mask's
    bits), 0/1 (on the dense 0/1 mask) or weights, both calls counted in
    ``.wide_launches``, a bit-identical rerun, x_new within LIMIT of its
    dtype (X_BF16_LIMIT where bf16) and the statistics within LIMIT.
    Returns the outputs' max abs error."""
    y, mask, x, d = args
    if kind == "dense":
        w = cuda_mu.kl_stats_dense

        def call():
            return w(y, x, d, eps)

        ref = cuda_mu.kl_stats_dense_plain(y, x, d, eps)
    else:
        w = cuda_mu.kl_stats_masked
        km = cuda_mu.pack_mask(mask) if kind == "bits" else mask
        check(km is not None, "pack_mask refused a 0/1 mask")

        def call():
            return w(y, km, x, d, eps)

        ref = cuda_mu.kl_stats_masked_plain(y, mask, x, d, eps)
    before = w.wide_launches
    out = call()
    again = call()
    torch.cuda.synchronize()
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    limits = [X_BF16_LIMIT if x.dtype == torch.bfloat16 else LIMIT[y.dtype]]
    limits += [LIMIT[y.dtype]] * 2
    tag = (f"{w.__name__} wide route, {kind} {y.shape[0]}x{y.shape[1]} "
           f"K={d.shape[0]} {str(y.dtype)[6:]} eps={eps:g}"
           + (f", {tag}" if tag else ""))
    print(f"kernel vs twin {tag}: rel_fro " + " ".join(
        f"{nm}={e:.3e} (limit {lim:g})" for nm, e, lim in zip(
            ("x_new", "numd", "xsum" if kind == "dense" else "dend"), errs,
            limits))
        + f"; bit-identical rerun: {same}", flush=True)
    check(w.wide_launches == before + 2, f"{tag}: not on the wide route")
    check(all(np.isfinite(errs)), f"{tag}: non-finite outputs")
    check(all(e <= lim for e, lim in zip(errs, limits)),
          f"{tag}: kernel disagrees with twin")
    check(same, f"{tag}: two kernel runs differ")
    return max_abs(out, ref)


def kl_wide_inputs(gen, dev, m, n, k, dt, kind, lognormal=False):
    """(my, mask, x, d) for phase 4d, all in ``dt`` (the KL kernels take x
    in the data's dtype): ``stats_inputs``' uniform data (30% missing),
    weighted in [0.5, 1) for ``weights``, or ``lognormal_inputs``' six
    decades; dense: my = y, no mask."""
    if lognormal:
        args = lognormal_inputs(gen, dev, m, n, k,
                                0.0 if kind == "dense" else 0.3)
    else:
        args = stats_inputs(gen, dev, m, n, k, dt, dt, True)
        if kind == "dense":   # y itself: no entry missing
            args = (torch.rand((m, n), generator=gen, device=dev).to(dt),
                    None) + args[2:]
    if kind == "weights":
        args = weighted(gen, args)
    return tuple(None if t is None else t.to(dt) for t in args)


def kl_wide_bound(kind, m, n, k, ydt):
    """(ms, by) of the TPU kernel's own work at one call: my (and the mask:
    bits or a dense mask in the data's dtype) read once, x read and x_new
    written, d read, the statistics written; dense 8MNK and masked 12MNK
    operations, at f32 six bf16 passes each (bf16x6), the two products with
    a 0/1 mask (mask d^T, x_new^T mask) at three; at bf16 one."""
    from decomp_tpu_torch.ops.cuda_mu import packed_words

    e = ydt.itemsize
    masked = kind != "dense"
    mask_b = (4 * m * packed_words(n) if kind == "bits"
              else e * m * n if masked else 0)
    nbytes = (e * (m * n + k * n + 2 * m * k) + mask_b
              + 4 * (2 * k * n if masked else k * n + k))
    ops = (12.0 if masked else 8.0) * m * n * k
    if ydt == torch.float32:
        ops = 6.0 * ops - (12.0 * m * n * k if kind == "bits" else 0.0)
    return bound(nbytes, ops, torch.bfloat16)


def kl_wide_phase(nmf, nmf_mod, cuda_mu, dev, card, reset_counts,
                  read_counts):
    """Phase 4d: KL-MU above rank 128 on the wide route (csrc/mu_wide.cu's
    KL entries). Each instance against its twin (``compare_kl_wide``):
    dense f32 and bf16, masked f32 on bits and on weights, masked bf16 on a
    dense 0/1 mask and on weights, at KL_WIDE_SHAPES with eps = EPS and at
    the ragged one with eps = 0, f32 on log-normal my, x and d at
    KL_WIDE_LOGNORMAL, and f32 at the KL gate's corners (KL_WIDE_CORNERS);
    each instance per call at WIDE_RANK_PATH against its twin and beside
    its bound (the kernels line's figures); then the path there:
    ``nmf.solve(method='kl-mu')``, f32, dense and with 30% missing (the
    mask as bits), 20 iterations at tol 0, each in ms an iteration in
    turns with ``use_kernel=False`` (kernel, composition, composition,
    kernel), the KL objective falling; and 5 iterations each of bf16 data
    (dense and a 0/1 mask) and of weights in [0.5, 1) (f32 and bf16). Each
    path under 'auto' where ``nmf._auto_rank`` takes it, else with
    use_kernel=True, every launch counted on the wide route. Returns
    ({entry: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}, {entry:
    launches})."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(427)
    kinds = {f32: ("dense", "bits", "weights"),
             bf16: ("dense", "0/1", "weights")}
    for dt, ks in kinds.items():
        for m, n, k in KL_WIDE_SHAPES:
            for kind in ks:
                compare_kl_wide(cuda_mu, kind, kl_wide_inputs(
                    gen, dev, m, n, k, dt, kind))
        m, n, k = KL_WIDE_SHAPES[-1]
        for kind in ks:
            compare_kl_wide(cuda_mu, kind, kl_wide_inputs(
                gen, dev, m, n, k, dt, kind), eps=0.0)
    m, n, k = KL_WIDE_LOGNORMAL
    for kind in ("dense", "bits"):
        compare_kl_wide(cuda_mu, kind, kl_wide_inputs(
            gen, dev, m, n, k, f32, kind, lognormal=True),
            tag="log-normal, six decades")
        torch.cuda.empty_cache()
    for (m, n), ks in KL_WIDE_CORNERS.items():
        for kind, k in zip(("dense", "bits", "weights"), ks):
            compare_kl_wide(cuda_mu, kind, kl_wide_inputs(
                gen, dev, m, n, k, f32, kind), tag="the gate's corner")
            torch.cuda.empty_cache()

    m, n, k = WIDE_RANK_PATH
    stats = {}
    for dt, ks in kinds.items():
        for kind in ks:
            args = kl_wide_inputs(gen, dev, m, n, k, dt, kind)
            err = compare_kl_wide(cuda_mu, kind, args, tag="the path's shape")
            y, mask, x, d = args
            if kind == "dense":
                def call():
                    return cuda_mu.kl_stats_dense(y, x, d, EPS)

                def plain():
                    return cuda_mu.kl_stats_dense_plain(y, x, d, EPS)
            else:
                km = cuda_mu.pack_mask(mask) if kind == "bits" else mask

                def call():
                    return cuda_mu.kl_stats_masked(y, km, x, d, EPS)

                def plain():
                    return cuda_mu.kl_stats_masked_plain(y, mask, x, d, EPS)
            ms, p_ms = cuda_ms(call, 5), cuda_ms(plain, 2)
            b = kl_wide_bound(kind, m, n, k, dt)
            entry = ("kl_stats_dense_wide" if kind == "dense"
                     else "kl_stats_masked_wide"
                     + ("_weighted" if kind == "weights" else ""))
            entry += "" if dt == f32 else "_bf16"
            stats[entry] = (err, ms, p_ms) + b
            print(f"{entry} {m}x{n} K={k} {str(dt)[6:]} ({kind}): "
                  f"{ms:.4f} ms per call, plain twin {p_ms:.3f} ms, bound "
                  f"{b[0]:.4f} ms ({b[1]}), kernel at {b[0] / ms:.1%} of it; "
                  f"max_abs_err {err:.3e} ({card})", flush=True)
            del args, y, mask, x, d
    torch.cuda.empty_cache()

    def kernel_kw(dt, masked):
        return ({} if nmf_mod._auto_rank("kl-mu", n, k, dt, masked, dt)
                else {"use_kernel": True})

    launches = {}
    g = torch.Generator(device=dev).manual_seed(45)
    y = torch.rand((m, n), generator=g, device=dev)
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    eps_t = torch.tensor(EPS, dtype=f32)
    for name, mk in (("kl_stats_dense", None), ("kl_stats_masked", mask)):
        w = getattr(cuda_mu, name)
        my = y if mk is None else mk * y
        kw = dict(rank=k, mask=mk, method="kl-mu", tol=0.0, eps=EPS,
                  random_seed=0)
        kkw = kernel_kw(f32, mk is not None)
        d0, x0 = nmf_mod._init_factors(
            torch.Generator(device=dev).manual_seed(0), my, None, None, k)
        obj0 = float(nmf_mod._kl_objective(my, x0, d0, mk, eps_t))
        del d0, x0
        nmf.solve(y, maxiter=2, **kw, **kkw)   # warm-up
        nmf.solve(y, maxiter=2, use_kernel=False, **kw)
        times, res = [], {}
        for path in ("kernel", "composition", "composition", "kernel"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            r = nmf.solve(y, maxiter=20, **kw,
                          **(kkw if path == "kernel" else
                             {"use_kernel": False}))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / 20)
            want = 20 if path == "kernel" else 0
            got = read_counts(name, want)
            check(w.wide_launches == want, f"wide KL path {name}: {path} "
                  f"run launched {w.wide_launches} wide, expected {want}")
            if path not in res:
                res[path] = r
                if path == "kernel":
                    launches[name + "_wide"] = got
        rk, rc = res["kernel"], res["composition"]
        obj1 = float(nmf_mod._kl_objective(my, rk.x, rk.d, mk, eps_t))
        check(rk.niter == 20 and np.isfinite(obj1) and obj1 < obj0,
              f"wide KL path {name}: KL objective {obj0} -> {obj1}, niter "
              f"{rk.niter}")
        for nm, t in (("x", rk.x), ("d", rk.d)):
            check(bool(torch.isfinite(t).all()) and bool((t >= 0).all()),
                  f"wide KL path {name}: {nm} not finite and nonnegative")
        k_ms, c_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        print(f"wide KL path nmf.solve(method='kl-mu') {m}x{n} f32, rank "
              f"{k}, {'30% missing' if mk is not None else 'dense'}, "
              f"{'auto' if not kkw else 'use_kernel=True'}: kernel path "
              f"{k_ms:.4f} ms an iteration ({times[0]:.4f}, {times[3]:.4f}), "
              f"use_kernel=False {c_ms:.4f} ms ({times[1]:.4f}, "
              f"{times[2]:.4f}) in turns, kernel / composition "
              f"{k_ms / c_ms:.3f} ({card}); KL objective {obj0:.6e} -> "
              f"{obj1:.6e}; d against the composition run "
              f"{rel_fro(rk.d, rc.d):.3e}, x {rel_fro(rk.x, rc.x):.3e}; "
              f"{name} launches {launches[name + '_wide']}, all on the wide "
              "route", flush=True)
        del res, rk, rc, r, my
    w8 = mask * (0.5 + 0.5 * torch.rand((m, n), generator=g, device=dev))
    for dt, mk, entry in ((bf16, None, "kl_stats_dense_wide_bf16"),
                          (bf16, mask, "kl_stats_masked_wide_bf16"),
                          (f32, w8, "kl_stats_masked_wide_weighted"),
                          (bf16, w8, "kl_stats_masked_wide_weighted_bf16")):
        name = "kl_stats_dense" if mk is None else "kl_stats_masked"
        w = getattr(cuda_mu, name)
        yy = y.to(dt)
        torch.cuda.synchronize()
        reset_counts()
        res = nmf.solve(yy, mask=None if mk is None else mk.to(dt), rank=k,
                        method="kl-mu", tol=0.0, maxiter=5, random_seed=0,
                        **kernel_kw(dt, mk is not None))
        torch.cuda.synchronize()
        launches[entry] = read_counts(name, 5)
        check(w.wide_launches == 5, f"{entry} path: {w.wide_launches} of 5 "
              "launches on the wide route")
        check(bool(torch.isfinite(res.d).all()), f"{entry} path: non-finite d")
        what = ("dense" if mk is None else "a 0/1 mask" if mk is mask
                else "weights in [0.5, 1)")
        print(f"{entry} path nmf.solve(method='kl-mu') {m}x{n} rank {k} "
              f"{str(dt)[6:]} data, {what}: 5 launches, all on the wide "
              f"route ({card})", flush=True)
        del res, yy
    del y, mask, w8
    torch.cuda.empty_cache()
    return stats, launches


def planted_config1(dev):
    """BASELINE config 1 as benchmarks/run_configs.py:112-118 (and phase 5)
    make it: 1000 x 500, planted rank 10, 0.01 noise, f32 on the card."""
    rng = np.random.default_rng(0)
    xt, dt = rng.uniform(0, 1, (1000, 10)), rng.uniform(0, 1, (10, 500))
    yp = np.maximum(xt @ dt + 0.01 * rng.normal(size=(1000, 500)), 0.0)
    return torch.from_numpy(yp.astype(np.float32)).to(dev)


def hals_phase(nmf, nmf_mod, dev, card, reset_counts, read_counts):
    """Phase 16: nmf.solve(method='hals'), a composition of torch products
    and a host loop over the components (no kernel of the port)."""
    f32 = torch.float32
    # (a) Config 1: HALS and MU from the same factors, each to its own
    # stop (tol 1e-4, as benchmarks/run_configs.py:119-142 ran them) and at
    # equal iteration counts; then HALS on the card against HALS on the
    # CPU from the same inputs.
    yp = planted_config1(dev)
    d0, x0 = nmf_mod._init_factors(torch.Generator(device=dev).manual_seed(1),
                                   yp, None, None, 10)

    def obj(r):
        return float(0.5 * nmf_mod._sq_resid(yp.double(), r.x.double(),
                                             r.d.double(), torch.float64))

    def run(method, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = nmf.solve(yp, d0, x=x0, method=method, **kw)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    from decomp_tpu_torch.ops import cuda_mu

    w = cuda_mu.mu_stats_dense
    before = (w.launches, w.packed_launches)
    own = {m: run(m, tol=1e-4, maxiter=5000) for m in ("mu", "hals")}
    eq = {m: run(m, tol=0.0, maxiter=own[o][0].niter)[0]
          for m, o in (("hals", "mu"), ("mu", "hals"))}
    mu_launches = (w.launches - before[0], w.packed_launches - before[1])
    print(f"config 1 planted 1000x500 rank 10 f32, same x0 and d0 "
          f"(torch seed 1) ({card}): to tol 1e-4: MU {own['mu'][0].niter} "
          f"iterations, {own['mu'][1]:.3f} ms, objective "
          f"{obj(own['mu'][0]):.4f}; HALS {own['hals'][0].niter} iterations, "
          f"{own['hals'][1]:.3f} ms, objective {obj(own['hals'][0]):.4f}; at "
          f"equal iterations: HALS after MU's {own['mu'][0].niter} "
          f"{obj(eq['hals']):.4f}, MU after HALS's {own['hals'][0].niter} "
          f"{obj(eq['mu']):.4f}; MU's mu_stats_dense launches "
          f"{mu_launches[0]}, on mu_dense_packed.cu {mu_launches[1]}",
          flush=True)
    for m in ("mu", "hals"):
        check(own[m][0].converged, f"config 1: {m} did not converge")
    check(mu_launches[0] == mu_launches[1] > 0, "config 1: MU's launches "
          f"{mu_launches} did not all take the packed route")
    print(f"  the claim of BASELINE.md:110 (HALS's objective below MU's at "
          f"config 1) holds on the card: "
          f"{obj(own['hals'][0]) < obj(own['mu'][0])} at each one's stop, "
          f"{obj(eq['hals']) < obj(own['mu'][0])} at MU's iterations",
          flush=True)
    card_r = nmf.solve(yp, d0, x=x0, method="hals", tol=0.0,
                       maxiter=HALS_CPU_ITERS)
    cpu_r = nmf.solve(yp.cpu(), d0.cpu(), x=x0.cpu(), method="hals",
                      tol=0.0, maxiter=HALS_CPU_ITERS)
    errs = [rel_fro(a.cpu(), b) for a, b in ((card_r.x, cpu_r.x),
                                             (card_r.d, cpu_r.d))]
    print(f"  HALS {HALS_CPU_ITERS} iterations on the card vs the CPU: "
          f"rel_fro x {errs[0]:.3e}, d {errs[1]:.3e} (limit "
          f"{HALS_CPU_LIMIT:g})", flush=True)
    check(max(errs) <= HALS_CPU_LIMIT, "config 1: HALS on the card "
          "disagrees with HALS on the CPU")
    del yp

    # (b) 100,000 x 1,024 f32, rank 128, tol 0, 10 iterations.
    m, n, k, iters = 100_000, 1024, 128, 10
    y = torch.rand((m, n), generator=torch.Generator(device=dev)
                   .manual_seed(16), device=dev)
    d0, x0 = nmf_mod._init_factors(torch.Generator(device=dev).manual_seed(0),
                                   y, None, None, k)

    def solve():
        return nmf.solve(y, d0, x=x0, method="hals", tol=0.0, maxiter=iters)

    solve()   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ms, res = event_ms(solve)
    read_counts({})
    again = solve()
    obj0 = float(0.5 * nmf_mod._sq_resid(y, x0, d0, f32))
    obj1 = float(0.5 * nmf_mod._sq_resid(y, res.x, res.d, f32))
    # The split: the four products and the two sweeps on the result's
    # factors, each by CUDA events (a sweep repeated on its own buffer).
    dd, xt = res.d, res.x.T.contiguous()
    a, bt = dd @ dd.T, dd @ y.T
    c, e = xt @ xt.T, xt @ y
    xw, dw = xt.clone(), dd.clone()
    split = {"A = d d^T": cuda_ms(lambda: dd @ dd.T, 10),
             "B = d y^T": cuda_ms(lambda: dd @ y.T, 5),
             "x sweep": cuda_ms(lambda: nmf_mod._hals_sweep(xw, a.T, bt), 3),
             "C = x^T x": cuda_ms(lambda: xt @ xt.T, 10),
             "E = x^T y": cuda_ms(lambda: xt @ y, 5),
             "d sweep": cuda_ms(lambda: nmf_mod._hals_sweep(dw, c, e), 3)}
    # The profiles last: the split's timings are taken without them.
    busy, launches, prof_ms = profiled(solve)
    sweep_busy, sweep_launches, sweep_ms = profiled(
        lambda: nmf_mod._hals_sweep(xw, a.T, bt))
    per = ms / iters
    print(f"HALS nmf.solve(method='hals') {m}x{n} rank {k} f32, tol 0, "
          f"{iters} iterations ({card}): {per:.3f} ms per iteration "
          f"(CUDA events); objective {obj0:.6e} -> {obj1:.6e}; kernel "
          f"launches per iteration {launches / iters:.1f}; device busy "
          f"{busy:.3f} ms of a {prof_ms:.3f} ms profiled solve "
          f"({busy / prof_ms:.3f}); no launch of the port's kernels",
          flush=True)
    print("  split per iteration (ms, CUDA events): " + ", ".join(
        f"{name} {t:.3f}" for name, t in split.items())
          + f"; sum {sum(split.values()):.3f}; one x sweep alone: "
          f"{sweep_launches} launches, device busy {sweep_busy:.3f} of "
          f"{sweep_ms:.3f} ms ({sweep_busy / sweep_ms:.3f})", flush=True)
    for name, t in (("x", res.x), ("d", res.d)):
        check(bool(torch.isfinite(t).all()), f"HALS: {name} is not finite")
        check(bool((t >= 0).all()), f"HALS: {name} has negative values")
    check(obj1 < obj0, f"HALS: the objective did not fall: {obj0} -> {obj1}")
    check(torch.equal(res.x, again.x) and torch.equal(res.d, again.d),
          "HALS: a rerun is not bit-identical")
    return {"ms_per_iter": per, "launches_per_iter": launches / iters,
            "busy": busy / prof_ms, "split": split}


def minibatch_phase(nmf, nmf_mod, dev, card, reset_counts, read_counts):
    """Phase 17: nmf.solve(minibatch=8192, forget=0.9) at 100,000 x 1,024
    f32, rank 128, 50 iterations at tol 0: MU and KL-MU, dense and 30%
    missing; a composition (no kernel of the port)."""
    m, n, k, iters, batch = 100_000, 1024, 128, 50, 8192
    g = torch.Generator(device=dev).manual_seed(17)
    y = torch.rand((m, n), generator=g, device=dev)
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    eps = torch.tensor(EPS, dtype=torch.float32)
    out = {}
    for method, mk in itertools.product(("mu", "kl-mu"), (None, mask)):
        kw = dict(rank=k, tol=0.0, eps=EPS, method=method, mask=mk,
                  minibatch=batch, forget=0.9, random_seed=0)
        my = y if mk is None else mk * y
        d0, x0 = nmf_mod._init_factors(
            torch.Generator(device=dev).manual_seed(0), my, None, None, k)
        if method == "mu":
            def objective(x, d):
                return float(0.5 * nmf_mod._sq_resid(my, x, d, torch.float32,
                                                     mk))
        else:
            def objective(x, d):
                return float(nmf_mod._kl_objective(my, x, d, mk, eps))
        obj0 = objective(x0, d0)
        del d0, x0
        nmf.solve(y, maxiter=2, **kw)   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        ms, res = event_ms(lambda: nmf.solve(y, maxiter=iters, **kw))
        read_counts({})
        again = nmf.solve(y, maxiter=iters, **kw)
        obj1 = objective(res.x, res.d)
        tag = f"{method}, {'30% missing' if mk is not None else 'dense'}"
        out[tag] = ms / iters
        print(f"minibatch nmf.solve {m}x{n} rank {k} f32, {tag}, minibatch "
              f"{batch}, forget 0.9, tol 0, {iters} iterations ({card}): "
              f"{ms / iters:.3f} ms per iteration (CUDA events); objective "
              f"{obj0:.6e} -> {obj1:.6e}", flush=True)
        check(res.niter == iters, f"minibatch {tag}: niter {res.niter}")
        check(np.isfinite(obj1) and obj1 < obj0,
              f"minibatch {tag}: the objective did not fall: {obj0} -> "
              f"{obj1}")
        check(torch.equal(res.x, again.x) and torch.equal(res.d, again.d),
              f"minibatch {tag}: a seeded rerun is not bit-identical")
        del res, again, my
    return out


def checkpoint_phase(nmf, lasso, cuda_mu, cuda_lasso, dev, card, y2, a2,
                     reset_counts, read_counts):
    """Phase 18: utils.checkpoint.checkpointed_solve on the card, written
    to a temporary directory: config 4's masked MU on the packed
    mu_stats_masked route (four chunks of 25 iterations, and an interrupted
    run resumed by a second call) and config 2's per-problem acc_ista on
    the solve_rows route (chunks of 100), each against its straight run
    bit for bit."""
    import tempfile

    from decomp_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                   checkpointed_solve)

    out = {}
    m4, n4, k4, iters = 100_000, 1000, 50, 100
    g = torch.Generator(device=dev).manual_seed(3)
    y4 = (torch.rand((m4, k4), generator=g, device=dev)
          @ torch.rand((k4, n4), generator=g, device=dev))
    mask4 = (torch.rand((m4, n4), generator=g, device=dev) >= 0.3).float()
    # masked_completion's mixed point: bf16 data, f32 factors.
    yb = (y4 * mask4).to(torch.bfloat16)
    del y4
    kw = dict(rank=k4, mask=mask4, tol=0.0, factor_dtype=torch.float32,
              precision="default", random_seed=4)

    def routes(want):
        got = (cuda_mu.mu_stats_masked.packed_launches,
               cuda_mu.mu_stats_masked.dense_launches)
        check(got == (want, 0), f"config 4 checkpoint: (packed, dense) "
              f"route launches {got}, expected ({want}, 0)")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    nmf.solve(yb, maxiter=2, **kw)   # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        straight, straight_ms = timed(lambda: nmf.solve(yb, maxiter=iters,
                                                        **kw))
        read_counts("mu_stats_masked", iters)
        routes(iters)
        mgr = CheckpointManager(tmp + "/config4")
        reset_counts()
        (chunked, total), chunked_ms = timed(lambda: checkpointed_solve(
            nmf.solve, yb, manager=mgr, chunk_iters=25, maxiter=iters,
            **kw))
        read_counts("mu_stats_masked", iters)
        routes(iters)
        check(total == iters, f"config 4 checkpoint: {total} iterations")
        mgr2 = CheckpointManager(tmp + "/config4_interrupted")
        reset_counts()
        checkpointed_solve(nmf.solve, yb, manager=mgr2, chunk_iters=25,
                           maxiter=iters // 2, **kw)
        resumed, total2 = checkpointed_solve(
            nmf.solve, yb, manager=mgr2, chunk_iters=25, maxiter=iters, **kw)
        read_counts("mu_stats_masked", iters)
        routes(iters)
        same = [torch.equal(r.x, straight.x) and torch.equal(r.d, straight.d)
                for r in (chunked, resumed)]
        save_ms = sorted(timed(lambda: mgr.save(
            iters, {"x": straight.x, "d": straight.d}))[1] for _ in range(3))
        snap_mb = os.path.getsize(mgr.path) / 1e6
        print(f"checkpointed_solve config 4 nmf.solve {m4}x{n4} rank {k4}, "
              f"30% missing, bf16 data, f32 factors, tol 0, {iters} "
              f"iterations ({card}): straight {straight_ms:.3f} ms; four "
              f"chunks of 25 {chunked_ms:.3f} ms; route: every run's "
              f"{iters} mu_stats_masked launches on the packed route "
              f"(csrc/mu_masked_packed.cu); chunked == straight bit for bit "
              f"{same[0]}, interrupted at {iters // 2} and resumed "
              f"({total2}) == straight {same[1]}; one snapshot "
              f"({snap_mb:.1f} MB .npz, x and d) {save_ms[1]:.3f} ms "
              f"(median of 3)", flush=True)
        check(all(same), "config 4 checkpoint: a chunked run differs from "
              "the straight one")
        out["config4_save_ms"] = save_ms[1]
        del yb, mask4, straight, chunked, resumed

        # Config 2: per-problem acc_ista, 'high', tol 1e-4 on the whole-
        # solve kernel; each chunk is one solve_rows launch.
        cfg = dict(tol=1e-4, method="acc_ista", per_problem=True,
                   precision="high")
        lasso.solve(y2, a2, 0.1, maxiter=4000, **cfg)   # warm-up
        reset_counts()
        st, st_ms = timed(lambda: lasso.solve(y2, a2, 0.1, maxiter=4000,
                                              **cfg))
        read_counts("solve_rows", 1)
        check(cuda_lasso.solve_rows.tma_launches == 1, "config 2 "
              "checkpoint: the straight run left lasso_fista_tma.cu")
        mgr3 = CheckpointManager(tmp + "/config2")
        reset_counts()
        (ch, total3), ch_ms = timed(lambda: checkpointed_solve(
            lasso.solve, y2, a2, 0.1, manager=mgr3, chunk_iters=100,
            maxiter=4000, warm_fields=("x",), **cfg))
        chunks = cuda_lasso.solve_rows.launches
        read_counts("solve_rows", chunks)
        check(cuda_lasso.solve_rows.tma_launches == chunks, "config 2 "
              "checkpoint: a chunk left lasso_fista_tma.cu")
        rows_x = bool((ch.x == st.x).all(dim=1).all())
        rows_nit = torch.equal(ch.niter, st.niter)
        rows_conv = torch.equal(ch.converged, st.converged)
        save2 = sorted(timed(lambda: mgr3.save(total3, {
            "x": ch.x, "__decomp_tpu_aux_z": ch.aux["z"],
            "__decomp_tpu_aux_t": ch.aux["t"]}))[1] for _ in range(3))
        print(f"checkpointed_solve config 2 lasso.solve {y2.shape[0]} "
              f"problems x {a2.shape[0]} features, acc_ista, 'high', "
              f"per_problem, tol 1e-4 ({card}): straight {st_ms:.3f} ms (one "
              f"solve_rows launch); chunks of 100: {chunks} launches, all on "
              f"lasso_fista_tma.cu, {ch_ms:.3f} ms, {total3} iterations "
              f"charged (max niter {int(st.niter.max())}); chunked == "
              f"straight row for row: x {rows_x}, niter {rows_nit}, "
              f"converged {rows_conv}; one snapshot (x, z, t) "
              f"{save2[1]:.3f} ms (median of 3)", flush=True)
        check(rows_x and rows_nit and rows_conv, "config 2 checkpoint: a "
              "chunked per-problem run differs from the straight one")
        check(total3 == int(st.niter.max()), f"config 2 checkpoint: "
              f"{total3} iterations charged")
        out["config2_save_ms"] = save2[1]
    return out


def per_epoch_ms(run, lo=1, hi=6):
    """(ms per epoch, ms of the ``hi``-epoch call): the difference of a
    ``hi``-epoch and a ``lo``-epoch call of ``run(epochs)`` over the extra
    epochs, each between CUDA events, which cancels the call's set-up."""
    t_lo = event_ms(lambda: run(lo))[0]
    t_hi = event_ms(lambda: run(hi))[0]
    return (t_hi - t_lo) / (hi - lo), t_hi


def config5_loader(dev, n=10112, k=128):
    """Config 5′'s loader on ``dev``: rows [lo, hi) of relu(x_t d_true)
    in bf16 (bf16 operands, f32 sums), x_t from a generator seeded by the
    offset ``lo`` and d_true from seed 7, so that any process makes any
    chunk alone."""
    bf16 = torch.bfloat16
    d_true = torch.rand((k, n), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev, dtype=bf16)

    def loader(lo, hi):
        g = torch.Generator(device=dev).manual_seed(1_000_003 + lo)
        xt = torch.rand((hi - lo, k), generator=g, device=dev, dtype=bf16)
        return torch.relu(xt @ d_true)

    return loader


def x_digest(t):
    """The SHA-256 of a tensor's bytes: whether two runs' x hold the same
    bits, without keeping either."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def config5_phase(nmf, nmf_mod, cuda_mu, dev, card, reset_counts,
                  read_counts, m=1 << 20, n=10112, k=128, chunk=65_536,
                  epochs=5):
    """Phase 19: config 5' (bench.py:232-291) on the card: out-of-core MU
    over chunks that a loader makes on the card from a generator seeded by
    the chunk's offset, relu(x_t d_true) in bf16 (bf16 operands, f32 sums),
    in loader mode with f32 factors. The streamed run against the in-core
    nmf.solve from the same x0 and d0 on the same y, materialised from the
    loader; a seeded run of ``epochs`` epochs checked for one
    mu_stats_dense launch per chunk, all on the TMA route; ms per epoch
    split into loader, kernels and the rest, against in-core ms per
    iteration; peak device memory. Returns the seeded run's d and the
    digest of its x, which phase 23 holds a world of 1 to."""
    bf16, f32 = torch.bfloat16, torch.float32
    loader = config5_loader(dev, n, k)
    n_chunks = -(-m // chunk)
    skw = dict(chunk_rows=chunk, n_samples=m, n_channels=n, dtype=bf16,
               factor_dtype=f32, precision="default", eps=EPS, tol=0.0,
               x_device=True, jit_loader=True)
    # The same y in-core, and both from the same start for 2 iterations.
    y = torch.empty((m, n), dtype=bf16, device=dev)
    for lo in range(0, m, chunk):
        y[lo:lo + chunk] = loader(lo, min(lo + chunk, m))
    d0, x0 = nmf_mod._init_factors(torch.Generator(device=dev).manual_seed(0),
                                   y, None, None, k, f32)
    ckw = dict(tol=0.0, eps=EPS, precision="default", factor_dtype=f32)
    core = nmf.solve(y, d0, x=x0, maxiter=2, **ckw)
    stream = nmf.solve_streaming(loader, d0, x=x0, maxiter=2, **skw)
    err_d, err_x = rel_fro(stream.d, core.d), rel_fro(stream.x, core.x)
    core_ms, _ = per_epoch_ms(lambda it: nmf.solve(y, d0, x=x0, maxiter=it,
                                                   **ckw))
    del core, stream, y
    print(f"config 5' nmf.solve_streaming {m}x{n} bf16 chunks of {chunk} "
          f"from a loader, rank {k}, f32 factors, against the in-core "
          f"nmf.solve on the same y from the same x0, d0, 2 iterations "
          f"({card}): rel_fro d {err_d:.3e} (limit {STREAM_LIMIT:g}), x "
          f"{err_x:.3e}; in-core {core_ms:.3f} ms per iteration", flush=True)
    check(err_d <= STREAM_LIMIT and err_x <= STREAM_LIMIT,
          "config 5': the streamed run disagrees with the in-core one")
    del d0, x0

    def run(epochs_):
        return nmf.solve_streaming(loader, rank=k, maxiter=epochs_,
                                   random_seed=11, **skw)

    run(1)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    ms, res = event_ms(lambda: run(epochs))
    launches = read_counts("mu_stats_dense", n_chunks * epochs)
    tma = cuda_mu.mu_stats_dense.tma_launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(tma == n_chunks * epochs, f"config 5': {tma} of {launches} "
          "mu_stats_dense launches took the TMA route")
    check(res.niter == epochs, f"config 5': niter {res.niter}")
    for name, t in (("x", res.x), ("d", res.d)):
        check(t.dtype == f32 and bool(torch.isfinite(t).all())
              and bool((t >= 0).all()), f"config 5': {name} is not finite "
              "and nonnegative f32")
    epoch_ms, _ = per_epoch_ms(run)
    # The split: the loader's calls and the kernel's, each alone on one
    # epoch's worth of chunks; the rest (copies of x, sums, the epilogue).
    offsets = [min(i * chunk, m - chunk) for i in range(n_chunks)]

    def load_all():
        for lo in offsets:   # each chunk freed before the next, as in
            loader(lo, lo + chunk)   # the epoch

    load_ms = cuda_ms(load_all, 2)
    yc = loader(0, chunk)
    xc, db = res.x[:chunk].contiguous(), res.d.to(bf16)

    def kernels():
        for _ in offsets:
            cuda_mu.mu_stats_dense(yc, xc, db, EPS)

    kern_ms = cuda_ms(kernels, 2)
    print(f"config 5' streamed, seeded, {epochs} epochs of {n_chunks} "
          f"chunks ({card}): {ms:.3f} ms for the call; {epoch_ms:.3f} ms per "
          f"epoch (differential, 6 - 1 epochs) against {core_ms:.3f} ms per "
          f"in-core iteration ({epoch_ms / core_ms:.3f}x): loader "
          f"{load_ms:.3f} ms, mu_stats_dense {kern_ms:.3f} ms, the rest "
          f"{epoch_ms - load_ms - kern_ms:.3f} ms; mu_stats_dense launches "
          f"{launches} (TMA route {tma}); peak device memory {peak_gb:.2f} "
          "GB", flush=True)
    return {"d": res.d, "x": x_digest(res.x)}


def config4_stream_data(dev, m4=100_000, n4=1000, k4=50):
    """Phase 20's config-4 data on ``dev``: the planted y and the 0/1 mask
    (30% missing) from seed 3."""
    g = torch.Generator(device=dev).manual_seed(3)
    y4 = (torch.rand((m4, k4), generator=g, device=dev)
          @ torch.rand((k4, n4), generator=g, device=dev))
    mask4 = (torch.rand((m4, n4), generator=g, device=dev) >= 0.3).float()
    return y4, mask4


def kl_stream_data(dev, m7=100_000, n7=1024):
    """Phase 20's KL-MU data on ``dev``: y and a 0/1 mask (30% missing)
    from seed 7."""
    g = torch.Generator(device=dev).manual_seed(7)
    y7 = torch.rand((m7, n7), generator=g, device=dev)
    mask7 = (torch.rand((m7, n7), generator=g, device=dev) >= 0.3).float()
    return y7, mask7


def masked_dl_stream_data(dev, m=100_000, n=1024, k=128):
    """Phase 21's masked-DL data on ``dev`` from seed 15: the masked y
    (unit atoms, 10%-sparse codes, 0.01 noise), the 0/1 mask (30% missing)
    and the start d0."""
    g = torch.Generator(device=dev).manual_seed(15)
    d_true = torch.randn((k, n), generator=g, device=dev)
    d_true /= torch.linalg.vector_norm(d_true, dim=1, keepdim=True)
    xt = torch.randn((m, k), generator=g, device=dev) * (
        torch.rand((m, k), generator=g, device=dev) < 0.1)
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    my = (xt @ d_true + 0.01 * torch.randn((m, n), generator=g, device=dev)
          ) * mask
    return my, mask, torch.randn((k, n), generator=g, device=dev)


def streaming_masked_kl_phase(nmf, nmf_mod, cuda_mu, dev, card, reset_counts,
                              read_counts, wall6, m4=100_000, n4=1000, k4=50,
                              m7=100_000, n7=1024, k7=128, chunk=16_384,
                              epochs=5):
    """Phase 20: masked_completion_streaming at config 4's shape (f32
    loaders cast to bf16 chunks, f32 factors, chunks of ``chunk`` rows, a
    ragged tail), uncached and with every chunk cached; then KL-MU in
    loader mode at ``m7 x n7``, rank ``k7``, f32, dense and 30% missing,
    ``epochs`` epochs; then one host-array (numpy) run, with the
    host-to-device copy of a chunk timed. Returns the uncached config-4
    run's stop, d and the digest of its x, which phase 23 holds a world of
    1 to."""
    f32 = torch.float32
    y4, mask4 = config4_stream_data(dev, m4, n4, k4)
    ym4 = y4 * mask4
    n_chunks = -(-m4 // chunk)
    kw = dict(rank=k4, n_samples=m4, n_channels=n4, dtype=f32,
              chunk_rows=chunk, tol=1e-4, maxiter=4000, random_seed=4)
    results = {}
    for cached in (0, n_chunks):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = nmf.masked_completion_streaming(
            lambda lo, hi: ym4[lo:hi], lambda lo, hi: mask4[lo:hi],
            hbm_cache_chunks=cached, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts("mu_stats_masked", n_chunks * res.niter)
        routes = (cuda_mu.mu_stats_masked.packed_launches,
                  cuda_mu.mu_stats_masked.dense_launches)
        ho = float(res.aux["heldout_rel_err"])
        miss = 1.0 - mask4
        true_err = float(torch.linalg.vector_norm(miss * (res.x @ res.d - y4))
                         / torch.linalg.vector_norm(miss * y4))
        print(f"config 4 nmf.masked_completion_streaming {m4}x{n4} rank "
              f"{k4}, 30% missing, f32 loaders as bf16 chunks of {chunk} "
              f"(ragged tail {m4 - (n_chunks - 1) * chunk}), f32 factors, "
              f"{cached} chunks cached ({card}): converged={res.converged} "
              f"after {res.niter} epochs in {wall:.3f} s "
              f"({wall * 1e3 / res.niter:.3f} ms per epoch; in-core "
              f"masked_completion, "
              f"phase 6: {wall6:.3f} s, {wall / wall6:.2f}x); held-out "
              f"error {ho:.4e}, true error on the missing entries "
              f"{true_err:.4e}; mu_stats_masked launches {launches} (packed "
              f"route {routes[0]}, dense route {routes[1]})", flush=True)
        check(routes == (launches, 0), f"masked streaming: (packed, dense) "
              f"routes {routes}, expected ({launches}, 0)")
        check(res.converged and ho < 5e-2, f"masked streaming: converged "
              f"{res.converged}, held-out error {ho}")
        check(res.x.dtype == f32 and res.d.dtype == f32
              and bool(torch.isfinite(res.d).all()), "masked streaming: "
              "factors")
        results[cached] = res
    check(results[0].niter == results[n_chunks].niter
          and torch.equal(results[0].d, results[n_chunks].d),
          "masked streaming: the cached run differs from the uncached one")
    phase20 = {"niter": results[0].niter, "d": results[0].d,
               "x": x_digest(results[0].x),
               "heldout": float(results[0].aux["heldout_rel_err"])}
    # Where an epoch's time goes: 20 epochs (no check falls in them).
    for cached in (0, n_chunks):
        busy, nl, wall = profiled(lambda: nmf.masked_completion_streaming(
            lambda lo, hi: ym4[lo:hi], lambda lo, hi: mask4[lo:hi],
            hbm_cache_chunks=cached, **{**kw, "maxiter": 20}))
        print(f"  {cached} chunks cached, 20 epochs under torch.profiler: "
              f"{wall / 20:.3f} ms per epoch, device busy {busy / 20:.3f} ms "
              f"({busy / wall:.1%}), {nl / 20:.0f} launches per epoch",
              flush=True)
    del results, res, y4, ym4, mask4, miss

    y7, mask7 = kl_stream_data(dev, m7, n7)
    n_chunks = -(-m7 // chunk)
    eps7 = torch.tensor(EPS, dtype=f32)
    for name, mk in (("kl_stats_dense", None), ("kl_stats_masked", mask7)):
        my7 = y7 if mk is None else mk * y7
        d0, x0 = nmf_mod._init_factors(
            torch.Generator(device=dev).manual_seed(0), my7, None, None, k7)
        obj0 = float(nmf_mod._kl_objective(my7, x0, d0, mk, eps7))
        reset_counts()
        ms, res = event_ms(lambda: nmf.solve_streaming(
            lambda lo, hi: my7[lo:hi], d0, x=x0, method="kl-mu",
            mask=None if mk is None else (lambda lo, hi: mk[lo:hi]),
            tol=0.0, maxiter=epochs, chunk_rows=chunk, n_samples=m7,
            n_channels=n7, dtype=f32, x_device=True, jit_loader=True,
            eps=EPS))
        launches = read_counts(name, n_chunks * epochs)
        w = getattr(cuda_mu, name)
        got = (w.packed_launches,
               w.mu_kl_launches if mk is None else w.dense_launches)
        obj1 = float(nmf_mod._kl_objective(my7, res.x, res.d, mk, eps7))
        print(f"KL-MU nmf.solve_streaming {m7}x{n7} rank {k7} f32 "
              f"{'dense' if mk is None else '30% missing'}, loader mode, "
              f"chunks of {chunk}, {epochs} epochs ({card}): "
              f"{ms / epochs:.3f} ms per epoch; KL objective {obj0:.6e} -> "
              f"{obj1:.6e}; {name} launches {launches} (packed route "
              f"{got[0]}, other {got[1]})", flush=True)
        check(got == (launches, 0), f"KL streaming: {name} routes {got}")
        check(np.isfinite(obj1) and obj1 < obj0, "KL streaming: the "
              "objective did not fall")
        del res, d0, x0
    # The host-array path: y in host memory, each chunk copied per epoch.
    y_host = y7.cpu().numpy()
    d0, x0 = nmf_mod._init_factors(torch.Generator(device=dev).manual_seed(0),
                                   y7, None, None, k7)
    copy_ms = cuda_ms(lambda: torch.from_numpy(y_host[:chunk]).to(dev), 5)
    reset_counts()
    ms, res = event_ms(lambda: nmf.solve_streaming(
        y_host, d0, x=x0.cpu().numpy(), method="kl-mu", tol=0.0,
        maxiter=3, chunk_rows=chunk, eps=EPS))
    read_counts({})
    obj0 = float(nmf_mod._kl_objective(y7, x0, d0, None, eps7))
    obj1 = float(nmf_mod._kl_objective(y7, torch.from_numpy(res.x).to(dev),
                                       res.d, None, eps7))
    print(f"KL-MU nmf.solve_streaming from a numpy array {m7}x{n7} rank "
          f"{k7} f32, chunks of {chunk}, 3 epochs ({card}): {ms / 3:.3f} ms "
          f"per epoch; host-to-device copy of one chunk "
          f"({chunk * n7 * 4 / 1e6:.1f} MB) {copy_ms:.3f} ms "
          f"({chunk * n7 * 4 / copy_ms / 1e6:.2f} GB/s); KL objective "
          f"{obj0:.6e} -> {obj1:.6e}", flush=True)
    check(isinstance(res.x, np.ndarray) and obj1 < obj0, "host-array "
          "streaming: x is not a host array or the objective did not fall")
    return phase20


def dl_streaming_phase(dl, dev, card, reset_counts, read_counts, bcd_routes,
                       grad_routes, dict_routes, chunk3=4096, iters=5,
                       m=100_000, n=1024, k=128, chunk=16_384, miters=3):
    """Phase 21: dictionary_learning.solve_streaming. Config 3 (bench.py's
    data) in chunks of ``chunk3`` at lasso_tol 0 for ``iters`` outer
    iterations, on the host-array path and in loader mode: one bcd_sweep
    launch per outer iteration on the register route, d against the
    in-core solve's; then masked DL at m x n, k atoms, 30% missing, chunks
    of ``chunk``, ``miters`` outer iterations in loader mode (every
    gradient on the packed routes, a falling objective) and one held-out
    run, then on a weighted mask under 'auto' in turns with the
    composition (every gradient on the dense routes). Returns config 3's loader-mode d, which phase 23 holds a world of
    2 to."""
    f32 = torch.float32
    y_np, d0_np = config3_data()
    cfg = dict(tol=0.0, maxiter=iters, lasso_iter=15, lasso_tol=0.0,
               precision="high")
    y, d0 = (torch.from_numpy(v).to(dev) for v in (y_np, d0_np))
    dl.solve(y, d0, 0.05, **cfg)   # warm-up
    core_ms, core = event_ms(lambda: dl.solve(y, d0, 0.05, **cfg))
    m3, n3 = y.shape
    runs = {"host-array": lambda: dl.solve_streaming(
                y_np, d0_np, 0.05, chunk_rows=chunk3, **cfg),
            "loader mode": lambda: dl.solve_streaming(
                lambda lo, hi: y[lo:hi], d0, 0.05, chunk_rows=chunk3,
                jit_loader=True, n_samples=m3, n_channels=n3, dtype=f32,
                **cfg)}
    for name, run in runs.items():
        run()   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        ms, res = event_ms(run)
        launches = read_counts("bcd_sweep", iters)
        routes = bcd_routes()
        err = rel_fro(res.d, core.d)
        unit = float((torch.linalg.vector_norm(res.d, dim=1) - 1).abs().max())
        print(f"config 3 dictionary_learning.solve_streaming, {name}, "
              f"{m3}x{n3}, {d0.shape[0]} atoms, chunks of {chunk3}, {iters} "
              f"outer x 15 inner, lasso_tol 0, 'high' ({card}): "
              f"{ms / iters:.3f} ms per outer iteration against "
              f"{core_ms / iters:.3f} in-core; bcd_sweep launches "
              f"{launches} (register, shared route {routes}); rel_fro d vs "
              f"in-core {err:.3e} (limit {DL_STREAM_LIMIT:g}); max | ||d_k|| "
              f"- 1 | {unit:.2e}", flush=True)
        check(routes == (iters, 0), f"DL streaming {name}: bcd_sweep routes "
              f"{routes}")
        check(err <= DL_STREAM_LIMIT and unit <= UNIT_LIMIT,
              f"DL streaming {name}: d disagrees with the in-core solve")
    phase21 = res.d
    del y, core, res

    alpha, inner = 0.05, 15
    my, mask, d0 = masked_dl_stream_data(dev, m, n, k)
    n_chunks = -(-m // chunk)
    kw = dict(mask=lambda lo, hi: mask[lo:hi], lasso_iter=inner,
              lasso_tol=0.0, chunk_rows=chunk, jit_loader=True, n_samples=m,
              n_channels=n, dtype=f32)
    reset_counts()
    ms, res = event_ms(lambda: dl.solve_streaming(
        lambda lo, hi: my[lo:hi], d0, alpha, tol=0.0, maxiter=miters,
        record_objective=True, **kw))
    launches = read_counts({"masked_grad_dict": miters * n_chunks,
                            "masked_grad_rows": miters * n_chunks * inner})
    routes, d_routes = grad_routes(), dict_routes()
    obj = res.objective
    print(f"masked dictionary_learning.solve_streaming {m}x{n} K={k}, 30% "
          f"missing, loader mode, chunks of {chunk}, {miters} outer x "
          f"{inner} inner ({card}): {ms / miters:.3f} ms per outer "
          f"iteration; objective {float(obj[0]):.6e} -> "
          f"{float(obj[-1]):.6e}; launches masked_grad_dict "
          f"{launches['masked_grad_dict']} (packed, dense route {d_routes}), "
          f"masked_grad_rows {launches['masked_grad_rows']} (packed, dense "
          f"route {routes})", flush=True)
    check(routes == (miters * n_chunks * inner, 0)
          and d_routes == (miters * n_chunks, 0), "masked DL streaming: a "
          "gradient left the packed route")
    check(bool(torch.isfinite(obj).all()) and float(obj[-1]) < float(obj[0]),
          "masked DL streaming: the objective did not fall")
    reset_counts()
    ms, res = event_ms(lambda: dl.solve_streaming(
        lambda lo, hi: my[lo:hi], d0, alpha, tol=1e-3, maxiter=12,
        stop="heldout", check_every=3, **kw))
    ho = float(res.aux["heldout_rel_err"])
    read_counts({"masked_grad_dict": res.niter * n_chunks,
                 "masked_grad_rows": res.niter * n_chunks * inner})
    print(f"masked dictionary_learning.solve_streaming, stop='heldout', "
          f"check_every 3 ({card}): {res.niter} outer iterations in "
          f"{ms:.3f} ms, converged={res.converged}, held-out error "
          f"{ho:.4e}", flush=True)
    check(np.isfinite(ho) and bool(torch.isfinite(res.d).all()),
          "masked DL streaming: held-out run not finite")

    # The same data on a weighted mask (observed entries weighted in
    # [0.5, 1)) under the default use_kernel='auto': both gradients on the
    # dense routes (the weighted instances), after a warm-up of each in
    # turns with use_kernel=False (kernels, composition, composition,
    # kernels, twice: this path is paced by the host and its times spread).
    g = torch.Generator(device=dev).manual_seed(21)
    w = 0.5 + 0.5 * torch.rand(mask.shape, generator=g, device=dev)
    wmy, wmask = my * w, mask * w
    del w, my, mask
    kw["mask"] = lambda lo, hi: wmask[lo:hi]

    def weighted_run(**kw_):
        return dl.solve_streaming(
            lambda lo, hi: wmy[lo:hi], d0, alpha, tol=0.0, maxiter=miters,
            record_objective=True, **kw, **kw_)

    weighted_run()   # warm-up
    weighted_run(use_kernel=False)
    times, seq = {True: [], False: []}, []
    for kernel in 2 * (True, False, False, True):
        reset_counts()
        ms, out = event_ms(lambda: weighted_run(
            **({} if kernel else {"use_kernel": False})))
        times[kernel].append(ms / miters)
        seq.append(ms / miters)
        if kernel:
            read_counts({"masked_grad_dict": miters * n_chunks,
                         "masked_grad_rows": miters * n_chunks * inner})
            routes, d_routes, res = grad_routes(), dict_routes(), out
        else:
            read_counts({})
            comp = out
    obj = res.objective
    err_d, err_x = rel_fro(res.d, comp.d), rel_fro(res.x, comp.x)
    lim = MASKED_DL_LIMIT[f32]
    tag = (f"masked dictionary_learning.solve_streaming {m}x{n} K={k} "
           "float32, weighted mask, use_kernel='auto'")
    turns = " / ".join(f"{t:.3f}" for t in seq)
    print(f"{tag}, loader mode, chunks of {chunk}, {miters} outer x {inner} "
          f"inner ({card}): ms per outer iteration in turns, kernels / "
          f"composition / composition / kernels, twice: {turns}; kernels "
          f"/ composition {sum(times[True]) / sum(times[False]):.3f}; "
          f"objective {float(obj[0]):.6e} -> "
          f"{float(obj[-1]):.6e}; rel_fro vs composition d {err_d:.3e}, x "
          f"{err_x:.3e} (limit {lim:g}); launches masked_grad_dict "
          f"{miters * n_chunks} (packed, dense route {d_routes}), "
          f"masked_grad_rows {miters * n_chunks * inner} (packed, dense "
          f"route {routes})", flush=True)
    check(routes == (0, miters * n_chunks * inner)
          and d_routes == (0, miters * n_chunks), f"{tag}: a gradient left "
          "the dense route")
    check(bool(torch.isfinite(obj).all()) and float(obj[-1]) < float(obj[0]),
          f"{tag}: the objective did not fall")
    check(err_d <= lim and err_x <= lim, f"{tag}: the kernel path disagrees "
          "with the composition")
    return phase21



# Phase 22: the sharded solves (decomp_tpu_torch.parallel). (b) runs two
# ranks on the one card over gloo; each generates only its own rows, chunk
# by chunk from a seed per chunk, so no rank holds the global matrix.
# Against the in-core solve from the same start on the same data
# (relative Frobenius): SHARD_LIMIT after 2 iterations of the fixed
# budgets (MU, KL-MU, masked DL: each statistic sums the two ranks'
# partials in another order, as PR 16's streamed chunks do; its limit),
# SHARD_RUN_LIMIT after their 20 (measured on an H100 80GB HBM3 at 700 W:
# x 7.4e-5 after 20 dense-MU iterations, where a one-ulp f32 difference
# flips a bf16 rounding of x in the statistics and the flips add up; KL
# and masked DL <= 7.6e-7); SHARD_DL_LIMIT for config 3's 60 outer
# iterations, whose inner lasso stops on an all-reduced scalar that may
# cross lasso_tol an iteration apart (measured 1.9e-6); config 4's
# ~3,000 iterations stop where the held-out error's improvement per check
# crosses tol, which sums in another order move by a few checks
# (measured on the H100: 2,700 against 2,750 in core, d 1.4e-3 apart),
# so its stop is held to 5% of the in-core iteration, its held-out error
# to 5% of the in-core one and its factors to SHARD_C4_LIMIT.
SHARD_LIMIT = 1e-5
SHARD_RUN_LIMIT = 1e-3
SHARD_DL_LIMIT = 1e-3
SHARD_C4_LIMIT = 5e-2
# name -> (rows, chunk rows) of the world-of-2 cases.
SHARD_CASES = {"mu": (1 << 20, 65_536), "c4": (100_000, 10_000),
               "kl": (100_000, 10_000), "lasso": (10_000, 1_000),
               "dl3": (20_000, 2_000), "mdl": (100_000, 10_000)}


def _chunked(make, seed, lo, hi, chunk, dev):
    """Rows lo..hi of a matrix made chunk by chunk: chunk c is
    ``make(generator, chunk)`` from a generator seeded with ``seed`` and
    c, so that any rank makes its own rows alone (a chunk that its rows
    only cut is made whole and cut)."""
    out = None
    for c in range(lo // chunk, -(-hi // chunk)):
        g = torch.Generator(device=dev).manual_seed(seed * 100_003 + c)
        part = make(g, chunk)
        if out is None:
            out = torch.empty((hi - lo,) + part.shape[1:], dtype=part.dtype,
                              device=dev)
        a, b = max(lo, c * chunk), min(hi, (c + 1) * chunk)
        out[a - lo:b - lo] = part[a - c * chunk:b - c * chunk]
    return out


def _seeded(seed, dev):
    return torch.Generator(device=dev).manual_seed(seed)


def shard_data(case, lo, hi, dev):
    """Rows lo..hi of the data of a world-of-2 case, and what every rank
    shares (the dictionary, d0), as a dict of tensors on ``dev``."""
    f32, bf16 = torch.float32, torch.bfloat16
    chunk = SHARD_CASES[case][1]

    def rows(seed, make):
        return _chunked(make, seed, lo, hi, chunk, dev)

    if case == "mu":
        n, k = 10_112, 128
        return dict(
            y=rows(21, lambda g, c: torch.rand((c, n), generator=g,
                                               device=dev, dtype=bf16)),
            x=rows(22, lambda g, c: 0.088 * torch.rand(
                (c, k), generator=g, device=dev)),
            d=0.088 * torch.rand((k, n), generator=_seeded(23, dev),
                                 device=dev))
    if case == "c4":
        n, k = 1000, 50
        dt = torch.rand((k, n), generator=_seeded(42, dev), device=dev)

        def planted(g, c):
            y = torch.rand((c, k), generator=g, device=dev) @ dt
            return y * (torch.rand((c, n), generator=g, device=dev) >= 0.3)

        def mask(g, c):
            torch.rand((c, k), generator=g, device=dev)
            return (torch.rand((c, n), generator=g, device=dev)
                    >= 0.3).float()

        return dict(y=rows(41, planted), mask=rows(41, mask),
                    x=rows(44, lambda g, c: 0.7 * torch.rand(
                        (c, k), generator=g, device=dev)),
                    d=0.7 * torch.rand((k, n), generator=_seeded(45, dev),
                                       device=dev))
    if case == "kl":
        n, k = 1024, 128
        return dict(
            y=rows(51, lambda g, c: torch.rand((c, n), generator=g,
                                               device=dev)),
            mask=rows(52, lambda g, c: (torch.rand(
                (c, n), generator=g, device=dev) >= 0.3).float()),
            x=rows(53, lambda g, c: 0.088 * torch.rand(
                (c, k), generator=g, device=dev)),
            d=0.088 * torch.rand((k, n), generator=_seeded(54, dev),
                                 device=dev))
    if case == "lasso":
        f, n = 512, 256
        a = torch.randn((f, n), generator=_seeded(61, dev), device=dev)

        def planted(g, c):
            xt = torch.randn((c, f), generator=g, device=dev) * (
                torch.rand((c, f), generator=g, device=dev) < 0.05)
            return xt @ a + 0.01 * torch.randn((c, n), generator=g,
                                               device=dev)

        return dict(y=rows(62, planted), a=a)
    if case == "dl3":
        k, n = 256, 64
        dt = torch.randn((k, n), generator=_seeded(71, dev), device=dev)
        dt /= torch.linalg.vector_norm(dt, dim=1, keepdim=True)

        def planted(g, c):
            xs = torch.randn((c, k), generator=g, device=dev) * (
                torch.rand((c, k), generator=g, device=dev) < 0.1)
            return xs @ dt + 0.01 * torch.randn((c, n), generator=g,
                                                device=dev)

        return dict(y=rows(72, planted),
                    d=torch.randn((k, n), generator=_seeded(73, dev),
                                  device=dev))
    n, k = 1024, 128   # "mdl"
    dt = torch.randn((k, n), generator=_seeded(81, dev), device=dev)
    dt /= torch.linalg.vector_norm(dt, dim=1, keepdim=True)

    def masked(g, c, want_mask=False):
        xt = torch.randn((c, k), generator=g, device=dev) * (
            torch.rand((c, k), generator=g, device=dev) < 0.1)
        noise = 0.01 * torch.randn((c, n), generator=g, device=dev)
        mask = (torch.rand((c, n), generator=g, device=dev) >= 0.3).float()
        return mask if want_mask else (xt @ dt + noise) * mask

    return dict(y=rows(82, masked),
                mask=rows(82, lambda g, c: masked(g, c, True)),
                d=torch.randn((k, n), generator=_seeded(83, dev), device=dev))


def shard_solve(case, data, **kw):
    """The case's solve on ``data``: in core, or sharded with ``mesh=``
    (parallel.*). Returns the result, or for 'kl' the dense and masked
    results."""
    from decomp_tpu_torch import dictionary_learning, lasso, nmf, parallel
    from decomp_tpu_torch.models import nmf as nmf_mod

    mesh = kw.get("mesh")
    f32 = torch.float32
    if case == "mu":
        fn = nmf.solve if mesh is None else parallel.nmf.solve
        return fn(data["y"], data["d"], x=data["x"], eps=EPS,
                  precision="default", factor_dtype=f32,
                  **{"tol": 0.0, "maxiter": 20, **kw})
    if case == "c4":
        return nmf_mod.masked_completion(
            data["y"], data["mask"], d=data["d"], x=data["x"], rank=50,
            random_seed=4, **{"tol": 1e-4, "maxiter": 4000, **kw})
    if case == "kl":
        fn = nmf.solve if mesh is None else parallel.nmf.solve
        return [fn(data["y"], data["d"], x=data["x"], mask=mk,
                   method="kl-mu", eps=EPS,
                   **{"tol": 0.0, "maxiter": 20, **kw})
                for mk in (None, data["mask"])]
    if case == "lasso":
        fn = lasso.solve if mesh is None else parallel.lasso.solve
        return fn(data["y"], data["a"], 0.1, method="acc_ista",
                  per_problem=True, precision="high",
                  **{"tol": 1e-4, "maxiter": 4000, **kw})
    fn = (dictionary_learning.solve if mesh is None
          else parallel.dictionary_learning.solve)
    if case == "dl3":
        return fn(data["y"], data["d"], 0.05, precision="high",
                  **{"tol": 1e-5, "maxiter": 60, "lasso_iter": 15, **kw})
    return fn(data["y"], data["d"], 0.05, mask=data["mask"], lasso_iter=15,
              lasso_tol=0.0, **{"tol": 0.0, "maxiter": 20, **kw})


def _shard_counts():
    """The launch counters phase 22 reads, by name."""
    from decomp_tpu_torch.ops import cuda_dl, cuda_lasso, cuda_mu

    return {"mu_stats_dense.tma": (cuda_mu.mu_stats_dense, "tma_launches"),
            "mu_stats_masked.packed": (cuda_mu.mu_stats_masked,
                                       "packed_launches"),
            "mu_stats_masked.dense": (cuda_mu.mu_stats_masked,
                                      "dense_launches"),
            "kl_stats_dense.packed": (cuda_mu.kl_stats_dense,
                                      "packed_launches"),
            "kl_stats_masked.packed": (cuda_mu.kl_stats_masked,
                                       "packed_launches"),
            "solve_rows.tma": (cuda_lasso.solve_rows, "tma_launches"),
            "masked_grad_rows.packed": (cuda_lasso.masked_grad_rows,
                                        "packed_launches"),
            "bcd_sweep.register": (cuda_dl.bcd_sweep, "register_launches"),
            "masked_grad_dict.packed": (cuda_dl.masked_grad_dict,
                                        "packed_launches")}


def shard_read(reset=False):
    """The nonzero launch counts (after setting them all to 0 if
    ``reset``)."""
    out = {}
    for name, (w, attr) in _shard_counts().items():
        if reset:
            setattr(w, attr, 0)
            w.launches = 0
        elif getattr(w, attr):
            out[name] = getattr(w, attr)
    return out


def _digest(val, row0):
    """A digest of a 0/1 held-out block: its count and the sum of its
    entries' global linear indices."""
    r, c = torch.nonzero(val, as_tuple=True)
    return (int(r.numel()),
            int(((r + row0).to(torch.int64) * val.shape[1] + c).sum()))


def shard_expect(case, res):
    """The launch counts a case's run must show."""
    if case == "mu":
        return {"mu_stats_dense.tma": 20}
    if case == "c4":
        return {"mu_stats_masked.packed": res.niter}
    if case == "kl":
        return {"kl_stats_dense.packed": 20, "kl_stats_masked.packed": 20}
    if case == "lasso":
        return {"solve_rows.tma": 1}
    if case == "dl3":
        return {"bcd_sweep.register": res.niter}
    return {"masked_grad_dict.packed": res.niter,
            "masked_grad_rows.packed": 15 * res.niter}


def _profile_run(fn):
    """(wall ms, device busy ms, all-reduce host ms) of one call of ``fn``
    under ``torch.profiler`` with host and device activity; the
    all-reduce's time is that of the ``*all_reduce*`` host ops (gloo's
    copies the data through the host and waits for it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ka
               if str(e.device_type).endswith("CUDA")) / 1e3
    reduce_ms = sum(e.cpu_time_total for e in ka
                    if "all_reduce" in e.key.lower()
                    and not str(e.device_type).endswith("CUDA")) / 1e3
    dev_reduce = sum(e.self_device_time_total for e in ka
                     if str(e.device_type).endswith("CUDA")
                     and "allreduce" in e.key.lower()) / 1e3
    return wall, busy, reduce_ms, dev_reduce


def shard_rank(rank, n, case, tmp):
    """One rank of a world-of-2 case: its rows of the data, the sharded
    solve timed and profiled, its launches, and its factors against the
    in-core reference that the parent saved in ``tmp``."""
    from decomp_tpu_torch import parallel
    from decomp_tpu_torch.models import nmf as nmf_mod
    from decomp_tpu_torch.parallel import _spawn

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = SHARD_CASES[case][0]
    lo, hi = rank * rows // n, (rank + 1) * rows // n
    data = shard_data(case, lo, hi, dev)
    mesh = parallel.make_mesh((n,), ("rows",))
    ref = torch.load(os.path.join(tmp, f"{case}.pt"))
    out = {"rank": rank, "rows": hi - lo}
    if case == "c4":
        val = nmf_mod._heldout_block(data["mask"].to(torch.bfloat16), 0.05,
                                     4, (rows, data["y"].shape[1]), lo)
        out["reserve"] = _digest(val, lo)
        del val
    short = {"mu": 20, "c4": 200, "kl": 20, "lasso": None, "dl3": 10,
             "mdl": 5}[case]
    # The warm-up; for the fixed budgets (MU, KL-MU, masked DL) also the
    # 2-iteration run held to SHARD_LIMIT, as PR 16's streamed runs are.
    first = shard_solve(case, data, mesh=mesh,
                        **({} if case == "lasso" else {"maxiter": 2}))
    torch.cuda.synchronize()
    if "results2" in ref:
        out["errs2"] = []
        for r, rr in zip(first if isinstance(first, list) else [first],
                         ref["results2"]):
            out["errs2"] += [("d", rel_fro(r.d, rr["d"].to(dev))),
                             ("x", rel_fro(r.x, rr["x"][lo:hi].to(dev)))]
    del first
    shard_read(reset=True)
    t0 = time.perf_counter()
    res = shard_solve(case, data, mesh=mesh)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    out["launches"] = shard_read()
    res_all = res if isinstance(res, list) else [res]
    out["niter"] = [r.niter if isinstance(r.niter, int)
                    else int(r.niter.max()) for r in res_all]
    out["expect"] = shard_expect(case, res if case != "kl" else None)
    out["ms"] = wall / (1 if case == "lasso" else sum(out["niter"]))
    errs = []
    for r, rr in zip(res_all, ref["results"]):
        if "d" in rr:
            errs.append(("d", rel_fro(r.d, rr["d"].to(dev))))
            out.setdefault("d_same", []).append(
                _spawn.same_on_all_ranks(r.d))
        errs.append(("x", rel_fro(r.x, rr["x"][lo:hi].to(dev))))
        if case == "lasso":
            alone = shard_solve(case, data)
            out["x_bits_equal_own_rows"] = bool(torch.equal(r.x, alone.x))
            out["x_bits_equal_full"] = bool(torch.equal(
                r.x, rr["x"][lo:hi].to(dev)))
            out["niter_equal"] = float(
                (r.niter.cpu() == rr["niter"][lo:hi]).float().mean())
        if r.aux:
            out["heldout"] = float(r.aux["heldout_rel_err"])
    out["errs"] = errs
    out["converged"] = [bool(r.converged) if isinstance(r.converged, bool)
                        else bool(r.converged.all()) for r in res_all]
    prof_kw = {} if short is None else {"maxiter": short}
    if case == "c4":
        prof_kw["tol"] = 0.0
    wall_p, busy, reduce_ms, _ = _profile_run(
        lambda: shard_solve(case, data, mesh=mesh, **prof_kw))
    out["profile"] = {"iters": short, "wall_ms": wall_p, "busy_ms": busy,
                      "all_reduce_ms": reduce_ms}
    out["reductions"] = _timed_reductions(
        lambda: shard_solve(case, data, mesh=mesh, **prof_kw))
    return out


def _timed_reductions(fn):
    """One call of ``fn`` with every all-reduce of the solvers timed alone
    (the device synchronised before and after each): (wall ms, all-reduce
    ms, all-reduces). The profiler's all-reduce host time also holds the
    wait for the kernel that made the statistic."""
    from decomp_tpu_torch.parallel import mesh as pmesh

    plain, spent = pmesh.reducer, [0.0, 0]

    def timed(mesh, axis):
        red = plain(mesh, axis)

        def reduce(t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = red(t)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return t

        return reduce

    pmesh.reducer = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pmesh.reducer = plain
    return {"wall_ms": wall * 1e3, "all_reduce_ms": spent[0] * 1e3,
            "all_reduces": spent[1], "share": spent[0] / wall}


def _rank_ready(rank, n):
    return torch.cuda.current_device()


def sharded_phase(nmf_mod, cuda_mu, dev, card, reset_counts, read_counts,
                  main4, phase6, then):
    """Phase 22: the sharded solves. (a) a world of 1 over NCCL in this
    process: ``parallel.nmf.solve`` at the main path's width from phase 4's
    start must give phase 4's bits, with one TMA launch per iteration, and
    ``masked_completion(mesh=)`` at config 4 phase 6's stop and bits; (b) a
    world of 2 over gloo on the one card (NCCL takes one rank per device):
    each case against the in-core solve on the same data, the launches and
    routes per rank, d the same bits on both ranks, and the time per
    iteration or solve with the all-reduce's share from ``torch.profiler``.
    Then ``then(world, tmp)`` runs with the world of 2 still up and the
    directory of its store (phase 23). Returns the JSON summary's entries
    and what ``then`` returned."""
    import tempfile

    import torch.distributed as dist

    from decomp_tpu_torch import parallel
    from decomp_tpu_torch.parallel import _spawn

    f32, bf16 = torch.float32, torch.bfloat16
    report = []
    with tempfile.TemporaryDirectory() as tmp:
        # (a) a world of 1 over NCCL: the reduction is a copy.
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "nccl"), 1), rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh((1,), ("rows",))
            m, n, k, iters = 1 << 20, 10112, 128, 20
            g = torch.Generator(device=dev).manual_seed(0)
            y = torch.rand((m, n), generator=g, device=dev, dtype=bf16)
            d0, x0 = nmf_mod._init_factors(
                torch.Generator(device=dev).manual_seed(0), y, None, None, k,
                f32)
            kw = dict(tol=0.0, eps=EPS, precision="default", factor_dtype=f32,
                      mesh=mesh)
            parallel.nmf.solve(y, d0, x=x0, maxiter=2, **kw)   # warm-up
            torch.cuda.synchronize()
            reset_counts()
            ms, res = event_ms(lambda: parallel.nmf.solve(
                y, d0, x=x0, maxiter=iters, **kw))
            launches = read_counts("mu_stats_dense", iters)
            tma = cuda_mu.mu_stats_dense.tma_launches
            check(tma == iters, f"phase 22a: {tma} of {iters} launches on "
                  "the TMA route")
            same = (torch.equal(res.x, main4[0]), torch.equal(res.d, main4[1]))
            check(all(same), f"phase 22a: a world of 1 did not give phase "
                  f"4's bits (x, d equal: {same})")
            wall, busy, _, nccl_ms = _profile_run(lambda: parallel.nmf.solve(
                y, d0, x=x0, maxiter=iters, **kw))
            print(f"phase 22a: parallel.nmf.solve, a world of 1 over NCCL, "
                  f"{m}x{n} bf16 rank {k} f32 factors, {iters} iterations "
                  f"from phase 4's start: x and d equal phase 4's bit for "
                  f"bit; {ms / iters:.3f} ms per iteration against phase "
                  f"4's {main4[2]:.3f} ({card}); mu_stats_dense launches "
                  f"{launches} (TMA route {tma}); profiled: wall "
                  f"{wall:.1f} ms, device busy {busy:.1f} ms, of which NCCL "
                  f"all-reduce kernels {nccl_ms:.3f} ms", flush=True)
            report.append({"case": "main path, world of 1 (NCCL)",
                           "ms_per_iter": ms / iters,
                           "phase4_ms_per_iter": main4[2],
                           "bits_equal_phase4": True,
                           "launches": {"mu_stats_dense.tma": tma},
                           "nccl_all_reduce_ms": nccl_ms,
                           "busy_ms": busy, "wall_ms": wall})
            del y, d0, x0, res
            # Config 4 from phase 6's start: its held-out reserve, its
            # training mask, its init.
            m4, n4, k4 = 100_000, 1000, 50
            g = torch.Generator(device=dev).manual_seed(3)
            y4 = (torch.rand((m4, k4), generator=g, device=dev)
                  @ torch.rand((k4, n4), generator=g, device=dev))
            mask4 = (torch.rand((m4, n4), generator=g, device=dev)
                     >= 0.3).float()
            ym4 = y4 * mask4
            del y4
            yb, mb = ym4.to(bf16), mask4.to(bf16)
            val = nmf_mod._heldout_reserve(mb, 0.05, 4)
            d0, x0 = nmf_mod._init_factors(
                torch.Generator(device=dev).manual_seed(4), (mb - val) * yb,
                None, None, k4, f32)
            del yb, mb, val
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = nmf_mod.masked_completion(
                ym4, mask4, d=d0, x=x0, rank=k4, tol=1e-4, maxiter=4000,
                random_seed=4, mesh=mesh)
            torch.cuda.synchronize()
            wall4 = time.perf_counter() - t0
            launches4 = read_counts("mu_stats_masked", res.niter)
            packed = cuda_mu.mu_stats_masked.packed_launches
            check(packed == res.niter, f"phase 22a config 4: {packed} of "
                  f"{res.niter} launches packed")
            same = (res.niter == phase6[0], torch.equal(res.x, phase6[1]),
                    torch.equal(res.d, phase6[2]))
            check(all(same), f"phase 22a config 4: not phase 6's stop and "
                  f"bits (niter, x, d equal: {same}; niter {res.niter} "
                  f"against {phase6[0]})")
            print(f"phase 22a: masked_completion(mesh=) at config 4, a "
                  f"world of 1: stopped on phase 6's iteration "
                  f"{res.niter} with phase 6's bits, in {wall4:.3f} s "
                  f"against phase 6's {phase6[3]:.3f} s ({card}); "
                  f"mu_stats_masked launches {launches4}, all packed",
                  flush=True)
            report.append({"case": "config 4 masked_completion(mesh=), "
                           "world of 1 (NCCL)", "niter": res.niter,
                           "s": wall4, "phase6_s": phase6[3],
                           "bits_equal_phase6": True,
                           "launches": {"mu_stats_masked.packed": packed}})
            del res, ym4, mask4, d0, x0
        finally:
            dist.destroy_process_group()

        # (b) a world of 2 on the one card over gloo. The references first,
        # in core on the global data; then the data is freed, so that the
        # two ranks' halves and partials fit.
        for case in SHARD_CASES:
            shard_reference(case, 2, dev, tmp)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        t0 = time.perf_counter()
        with _spawn.World(2, tmp, backend="gloo", device=dev.index,
                          timeout=120) as world:
            check(world.run(_rank_ready) == [dev.index] * 2, "phase 22b: "
                  "the ranks are not on the card")
            spawn_s = time.perf_counter() - t0
            failures = []
            for case in SHARD_CASES:
                outs = world.run(shard_rank, case, tmp)
                ref = torch.load(os.path.join(tmp, f"{case}.pt"))
                limit = shard_limit(case)
                failures += shard_failures(case, outs, ref, limit)
                entry = {"case": case, "world": 2, "backend": "gloo",
                         "rows_per_rank": outs[0]["rows"], "limit": limit,
                         "limit_2_iterations": SHARD_LIMIT,
                         "in_core_niter": ref["niter"],
                         "ranks": [{k_: o[k_] for k_ in o if k_ != "expect"}
                                   for o in outs]}
                report.append(entry)
                print(f"phase 22b {case}: " + json.dumps(entry), flush=True)
            print(f"phase 22b: two gloo ranks spawned and joined in "
                  f"{spawn_s:.1f} s "
                  f"({card})", flush=True)
            check(not failures, "phase 22b: " + "; ".join(failures))
            after = then(world, tmp)
    return report, after


def shard_reference(case, n, dev, tmp):
    """The in-core solve of a world-of-n case on the whole data, saved in
    ``tmp`` for the ranks: the factors (and after 2 iterations for the
    fixed budgets), niter, and for config 4 the held-out error and the
    digests of the n ranks' blocks of the reserve. Returns the solve's
    wall seconds (synchronised). The data is freed after it."""
    from decomp_tpu_torch.models import nmf as nmf_mod

    rows = SHARD_CASES[case][0]
    data = shard_data(case, 0, rows, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = shard_solve(case, data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = res if isinstance(res, list) else [res]
    results = []
    for r in res:
        keep = {"x": r.x.cpu()}
        if hasattr(r, "d"):
            keep["d"] = r.d.cpu()
        if case == "lasso":
            keep["niter"] = r.niter.cpu()
        results.append(keep)
    saved = {"results": results,
             "niter": [r.niter if isinstance(r.niter, int)
                       else int(r.niter.max()) for r in res]}
    if case in ("mu", "kl", "mdl"):
        res2 = shard_solve(case, data, maxiter=2)
        saved["results2"] = [{"x": r.x.cpu(), "d": r.d.cpu()}
                             for r in (res2 if isinstance(res2, list)
                                       else [res2])]
        del res2
    if case == "c4":
        saved["heldout"] = float(res[0].aux["heldout_rel_err"])
        val = nmf_mod._heldout_reserve(data["mask"].to(torch.bfloat16), 0.05,
                                       4)
        saved["reserve"] = [_digest(val[r * rows // n:(r + 1) * rows // n],
                                    r * rows // n) for r in range(n)]
        del val
    torch.save(saved, os.path.join(tmp, f"{case}.pt"))
    del data, res
    torch.cuda.empty_cache()
    return wall


def shard_limit(case):
    """The limit a case's factors are held to against the in-core solve
    (see SHARD_LIMIT)."""
    return {"dl3": SHARD_DL_LIMIT, "c4": SHARD_C4_LIMIT,
            "lasso": C2_X_LIMIT}.get(case, SHARD_RUN_LIMIT)


def shard_failures(case, outs, ref, limit):
    """What phase 22b's case ``case`` got wrong, as messages; each rank's
    profile gains its all-reduce share."""
    bad = []
    for o in outs:
        who = f"{case} rank {o['rank']}"
        o["profile"]["all_reduce_share"] = (o["profile"]["all_reduce_ms"]
                                            / o["profile"]["wall_ms"])
        if o["launches"] != o["expect"]:
            bad.append(f"{who}: launches {o['launches']}, expected "
                       f"{o['expect']}")
        if not all(o.get("d_same", [True])):
            bad.append(f"{who}: d differs between the ranks")
        over = [(w, e) for w, e in o["errs"] if not e <= limit]
        over += [(w + " (2 iterations)", e) for w, e in o.get("errs2", [])
                 if not e <= SHARD_LIMIT]
        if over:
            bad.append(f"{who}: {over} beyond the limit")
        if case == "c4":
            if o["reserve"] != ref["reserve"][o["rank"]]:
                bad.append(f"{who}: the held-out reserve is not the global "
                           "draw's")
            if abs(o["niter"][0] - ref["niter"][0]) > 0.05 * ref["niter"][0]:
                bad.append(f"{who}: stopped at {o['niter'][0]}, in core at "
                           f"{ref['niter'][0]}")
            if not (o["heldout"] < 5e-2 and abs(o["heldout"] - ref["heldout"])
                    <= 0.05 * ref["heldout"]):
                bad.append(f"{who}: held-out error {o['heldout']} (in core "
                           f"{ref['heldout']})")
        if case == "lasso" and not o["x_bits_equal_own_rows"]:
            bad.append(f"{who}: x is not the bits of a one-process solve of "
                       "its rows")
        if case in ("mu", "kl", "mdl") and o["niter"] != ref["niter"]:
            bad.append(f"{who}: niter {o['niter']}")
    return bad


# Phase 23: the sharded out-of-core solvers (parallel.nmf.solve_streaming,
# masked_completion_streaming(mesh=), parallel.dictionary_learning
# .solve_streaming, parallel.lasso.solve_streaming). (a) A world of 1 over
# NCCL in this process must give phase 19's and phase 20's bits from their
# starts, and each is timed in turns with the one-process streamer. (b)
# Phase 22's world of 2 over gloo on the one card: config 5′, each rank
# streaming its 524,288 rows in 8 chunks, d within SHARD_LIMIT of the
# one-process streamer's after 2 epochs from phase 19's start; config 4's
# preset, d within SHARD_LIMIT of the one-process streamer's after 2 epochs
# from phase 20's start, and its stop and held-out error within 5% of phase
# 20's, as phase 22 holds config 4's (the plateau test on f32 sums in
# another order moves the stop by a few checks: measured on the H100 80GB
# HBM3 at 700 W, 3,625 epochs against 3,775, six checks of 25); config 3
# in chunks of 4,096, d within SHARD_LIMIT of phase 21's after its 5 outer
# iterations; KL-MU at phase 20's 100,000 x 1,024, rank 128, dense ('kl')
# and 30% missing ('klm'), and masked DL at phase 21's 100,000 x 1,024, 128
# atoms ('mdl'), each in chunks of 16,384 (4 a rank), d within SHARD_LIMIT
# of the one-process streamer's from the same start after 5 epochs (KL) or
# 3 outer iterations (masked DL); config 2 per problem in chunks of 4,096:
# x the in-core run's bits, or else within C2_X_LIMIT of them with the KKT
# criterion of phase 10. A rank's ms per epoch, launches per route and the
# all-reduce's share (profiler, and each all-reduce timed alone) are
# printed.
STREAM_CASES = ("c5", "c4", "kl", "klm", "dl3", "mdl", "lasso")
C4_STREAM_CHUNK = 16_384


def stream_kw(case):
    """The keywords of a phase-23 case's solve (phases 19, 20, 21, 10)."""
    f32 = torch.float32
    if case == "c5":
        return dict(chunk_rows=65_536, n_samples=1 << 20, n_channels=10112,
                    dtype=torch.bfloat16, factor_dtype=f32,
                    precision="default", eps=EPS, tol=0.0)
    if case == "c4":
        return dict(rank=50, n_samples=100_000, n_channels=1000, dtype=f32,
                    chunk_rows=C4_STREAM_CHUNK, tol=1e-4, maxiter=4000,
                    random_seed=4)
    if case == "dl3":
        return dict(tol=0.0, maxiter=5, lasso_iter=15, lasso_tol=0.0,
                    precision="high", chunk_rows=4096, n_samples=20_000,
                    n_channels=64, dtype=f32)
    if case in ("kl", "klm"):
        return dict(method="kl-mu", tol=0.0, maxiter=5, eps=EPS,
                    chunk_rows=C4_STREAM_CHUNK, n_samples=100_000,
                    n_channels=1024, dtype=f32)
    if case == "mdl":
        return dict(tol=0.0, maxiter=3, lasso_iter=15, lasso_tol=0.0,
                    chunk_rows=C4_STREAM_CHUNK, n_samples=100_000,
                    n_channels=1024, dtype=f32)
    return dict(tol=1e-4, maxiter=4000, method="acc_ista", per_problem=True,
                precision="high")


def _stream_path(tmp, case):
    return os.path.join(tmp, f"stream_{case}.pt")


def stream_rank(rank, n, case, tmp):
    """One rank of a phase-23b case: the sharded streamed solve from the
    reference the parent saved in ``tmp``, timed, profiled and held to the
    reference; its launches per route."""
    from decomp_tpu_torch import parallel
    from decomp_tpu_torch.models import nmf_streaming as ns
    from decomp_tpu_torch.parallel import _spawn

    torch.cuda.empty_cache()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = parallel.make_mesh((n,), ("rows",))
    ref = torch.load(_stream_path(tmp, case))
    kw = stream_kw(case)
    if case == "c5":
        loader, d0 = config5_loader(dev), ref["d0"].to(dev)

        def run(**over):
            return parallel.nmf.solve_streaming(
                loader, d0, x=ref["x0"], mesh=mesh, **{**kw, **over})

        main, short, warm = dict(maxiter=2), dict(maxiter=2), dict(maxiter=1)
        per_epoch = (1, 3)
    elif case == "c4":
        y4, mask4 = config4_stream_data(dev)
        ym4 = y4 * mask4
        del y4
        d0 = ref["d0"].to(dev)
        n_local = -(-kw["n_samples"] // (n * C4_STREAM_CHUNK))

        def run(**over):
            return ns.masked_completion_streaming(
                lambda lo, hi: ym4[lo:hi], lambda lo, hi: mask4[lo:hi],
                d=d0, x=ref["x0"], mesh=mesh, hbm_cache_chunks=n_local,
                **{**kw, **over})

        main, short = {}, dict(maxiter=50, tol=0.0)
        warm, per_epoch = dict(maxiter=2, tol=0.0), None
    elif case in ("kl", "klm"):
        y7, mask7 = kl_stream_data(dev)
        mk = mask7 if case == "klm" else None
        my7 = y7 if mk is None else mk * y7
        del y7
        d0 = ref["d0"].to(dev)

        def run(**over):
            return parallel.nmf.solve_streaming(
                lambda lo, hi: my7[lo:hi], d0, x=ref["x0"], mesh=mesh,
                mask=None if mk is None else (lambda lo, hi: mk[lo:hi]),
                **{**kw, **over})

        main, short, warm = {}, dict(maxiter=2), dict(maxiter=1)
        per_epoch = (1, 3)
    elif case == "mdl":
        my, mask, d0 = masked_dl_stream_data(dev)

        def run(**over):
            return parallel.dictionary_learning.solve_streaming(
                lambda lo, hi: my[lo:hi], d0, 0.05,
                mask=lambda lo, hi: mask[lo:hi], mesh=mesh,
                **{**kw, **over})

        main, short, warm = {}, dict(maxiter=2), dict(maxiter=1)
        per_epoch = (1, 3)
    elif case == "dl3":
        y_np, d0_np = config3_data()
        y = torch.from_numpy(y_np).to(dev)

        def run(**over):
            return parallel.dictionary_learning.solve_streaming(
                lambda lo, hi: y[lo:hi], d0_np, 0.05, mesh=mesh,
                **{**kw, **over})

        main, short, warm = {}, dict(maxiter=2), dict(maxiter=1)
        per_epoch = (1, 3)
    else:
        y_np, a_np, _ = config2_data()

        def run(**over):
            return parallel.lasso.solve_streaming(
                y_np, a_np, 0.1, mesh=mesh, chunk_rows=4096,
                **{**kw, **over})

        main, short, warm, per_epoch = {}, {}, {}, None
    first = run(**warm)
    torch.cuda.synchronize()
    shard_read(reset=True)
    t0 = time.perf_counter()
    res = run(**main)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    out = {"rank": rank, "launches": shard_read(), "wall_ms": wall}
    if case == "c4":
        # The 2-epoch warm-up against one process from the same start.
        out["d2_rel_fro"] = rel_fro(first.d, ref["d2"].to(dev))
    del first
    if case == "lasso":
        niter = np.asarray(res.niter)
        out.update(niter_max=int(niter.max()),
                   converged=bool(np.asarray(res.converged).all()),
                   ms_per_solve=wall)
        x = torch.from_numpy(res.x)
        out["x_bits_equal_in_core"] = bool(torch.equal(x, ref["x"]))
        out["x_rel_fro"] = rel_fro(x, ref["x"])
        out["niter_equal"] = float((torch.from_numpy(niter)
                                    == ref["niter"]).float().mean())
        if not out["x_bits_equal_in_core"]:
            from decomp_tpu_torch.ops.spectral import spectral_norm_psd

            a = torch.from_numpy(a_np).to(dev)
            lip = float(spectral_norm_psd(a @ a.T))
            out["kkt_max"] = float(kkt_residual(
                x.to(dev), torch.from_numpy(y_np).to(dev), a, 0.1, lip,
                kw["tol"]).max())
    else:
        out.update(niter=res.niter, converged=bool(res.converged),
                   ms_per_epoch=(wall / res.niter if per_epoch is None
                                 else per_epoch_ms(
                                     lambda e: run(maxiter=e),
                                     *per_epoch)[0]),
                   rows=int(res.x.shape[0]),
                   d_same=_spawn.same_on_all_ranks(res.d),
                   finite=bool(torch.isfinite(res.d).all()
                               and torch.isfinite(res.x).all()))
        if case == "c4":
            out["heldout"] = float(res.aux["heldout_rel_err"])
        else:
            out["d_rel_fro"] = rel_fro(res.d, ref["d"].to(dev))
    wall_p, busy, reduce_ms, _ = _profile_run(lambda: run(**short))
    out["profile"] = {"run": short or main, "wall_ms": wall_p,
                      "busy_ms": busy, "all_reduce_ms": reduce_ms,
                      "all_reduce_share": reduce_ms / wall_p}
    out["reductions"] = _timed_reductions(lambda: run(**short))
    del res
    torch.cuda.empty_cache()
    return out


def stream_expect(case, o):
    """The launches a rank of a phase-23b case must show: one kernel per
    chunk (8 a rank for config 5′, 4 at 100,000 rows) per epoch, and per
    inner step for the masked lasso gradient, one sweep per outer
    iteration, one whole solve per chunk (3)."""
    niter = o.get("niter", 0)
    return {"c5": {"mu_stats_dense.tma": 8 * niter},
            "c4": {"mu_stats_masked.packed": 4 * niter},
            "kl": {"kl_stats_dense.packed": 4 * niter},
            "klm": {"kl_stats_masked.packed": 4 * niter},
            "dl3": {"bcd_sweep.register": niter},
            "mdl": {"masked_grad_dict.packed": 4 * niter,
                    "masked_grad_rows.packed": 4 * 15 * niter},
            "lasso": {"solve_rows.tma": 3}}[case]


def stream_failures(case, outs, phase20):
    """What phase 23b's case got wrong, as messages."""
    bad = []
    for o in outs:
        who = f"{case} rank {o['rank']}"
        if o["launches"] != stream_expect(case, o):
            bad.append(f"{who}: launches {o['launches']}, expected "
                       f"{stream_expect(case, o)}")
        if case == "lasso":
            if not o["converged"]:
                bad.append(f"{who}: not every row converged")
            if not o["x_bits_equal_in_core"] and not (
                    o["x_rel_fro"] <= C2_X_LIMIT
                    and o["kkt_max"] <= C2_KKT_LIMIT):
                bad.append(f"{who}: x {o['x_rel_fro']} from the in-core "
                           f"run's, KKT {o.get('kkt_max')}")
            continue
        if not (o["d_same"] and o["finite"]):
            bad.append(f"{who}: d differs between the ranks or is not "
                       "finite")
        if case == "c4":
            if abs(o["niter"] - phase20["niter"]) > 0.05 * phase20["niter"]:
                bad.append(f"{who}: stopped at {o['niter']}, phase 20 at "
                           f"{phase20['niter']}")
            if not (o["converged"] and o["heldout"] < 5e-2
                    and abs(o["heldout"] - phase20["heldout"])
                    <= 0.05 * phase20["heldout"]):
                bad.append(f"{who}: held-out error {o['heldout']} (phase "
                           f"20: {phase20['heldout']})")
            if not o["d2_rel_fro"] <= SHARD_LIMIT:
                bad.append(f"{who}: d {o['d2_rel_fro']} from one process "
                           "after 2 epochs")
        elif not o["d_rel_fro"] <= SHARD_LIMIT:
            bad.append(f"{who}: d {o['d_rel_fro']} from the reference")
    if case != "lasso" and len({o["niter"] for o in outs}) != 1:
        bad.append(f"{case}: the ranks stopped apart")
    return bad


def sharded_streaming_phase(nmf, nmf_mod, lasso, dl, cuda_mu, dev, card,
                            reset_counts, read_counts, world, tmp, phase19,
                            phase20, phase21):
    """Phase 23 (see STREAM_CASES): (a) a world of 1 over NCCL in this
    process, config 5′ for 5 epochs and config 4's preset to its stop, each
    from the start of phase 19's or 20's seeded run (the one-process
    streamer at maxiter 0) and held to its bits; (b) the cases on phase
    22's world of 2 over gloo, after the references are saved in ``tmp``.
    Returns the JSON summary's entries."""
    import torch.distributed as dist

    from decomp_tpu_torch import parallel
    from decomp_tpu_torch.models import nmf_streaming as ns

    report = []
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "nccl23"), 1), rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh((1,), ("rows",))
        loader, kw = config5_loader(dev), stream_kw("c5")
        start = nmf.solve_streaming(loader, rank=128, maxiter=0,
                                    random_seed=11, x_device=True,
                                    jit_loader=True, **kw)

        def run5(epochs):
            return parallel.nmf.solve_streaming(loader, start.d, x=start.x,
                                                maxiter=epochs, mesh=mesh,
                                                **kw)

        def one5(epochs):
            return nmf.solve_streaming(loader, start.d, x=start.x,
                                       maxiter=epochs, x_device=True,
                                       jit_loader=True, **kw)

        run5(1)   # warm-up: the first NCCL call makes its communicator
        reset_counts()
        ms, res = event_ms(lambda: run5(5))
        launches = read_counts("mu_stats_dense", 80)
        tma = cuda_mu.mu_stats_dense.tma_launches
        check(tma == 80, f"phase 23a: {tma} of 80 launches on the TMA route")
        same = (torch.equal(res.d, phase19["d"]),
                x_digest(res.x) == phase19["x"])
        check(all(same), f"phase 23a: a world of 1 did not give phase 19's "
              f"bits (d, x equal: {same})")
        turns = [per_epoch_ms(f)[0] for f in (one5, run5, run5, one5)]
        wall, busy, _, nccl_ms = _profile_run(lambda: run5(2))
        print(f"phase 23a: parallel.nmf.solve_streaming, a world of 1 over "
              f"NCCL, config 5' (16 chunks of 65536 from the loader), 5 "
              f"epochs from phase 19's start: d and x equal phase 19's bit "
              f"for bit; the call {ms:.3f} ms; ms per epoch (differential, "
              f"6 - 1 epochs) in turns, one process / world of 1 / world "
              f"of 1 / one process: {turns[0]:.3f} / {turns[1]:.3f} / "
              f"{turns[2]:.3f} / {turns[3]:.3f} ({card}); mu_stats_dense "
              f"launches {launches} (TMA route {tma}); 2 epochs profiled: "
              f"wall {wall:.1f} ms, device busy {busy:.1f} ms, of which "
              f"NCCL all-reduce kernels {nccl_ms:.3f} ms", flush=True)
        report.append({"case": "config 5', world of 1 (NCCL)",
                       "call_ms": ms, "ms_per_epoch_turns": turns,
                       "bits_equal_phase19": True,
                       "launches": {"mu_stats_dense.tma": tma},
                       "nccl_all_reduce_ms": nccl_ms, "busy_ms": busy,
                       "wall_ms": wall})
        two = nmf.solve_streaming(loader, start.d, x=start.x, maxiter=2,
                                  x_device=True, jit_loader=True, **kw)
        torch.save({"d0": start.d.cpu(), "x0": start.x.cpu(),
                    "d": two.d.cpu()}, _stream_path(tmp, "c5"))
        del start, res, two
        y4, mask4 = config4_stream_data(dev)
        ym4 = y4 * mask4
        del y4
        kw = stream_kw("c4")
        n_chunks = -(-kw["n_samples"] // C4_STREAM_CHUNK)
        loaders = (lambda lo, hi: ym4[lo:hi], lambda lo, hi: mask4[lo:hi])
        start = nmf.masked_completion_streaming(*loaders,
                                                **{**kw, "maxiter": 0})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = nmf.masked_completion_streaming(
            *loaders, d=start.d, x=start.x, mesh=mesh,
            hbm_cache_chunks=n_chunks, **kw)
        torch.cuda.synchronize()
        wall4 = time.perf_counter() - t0
        launches4 = read_counts("mu_stats_masked", n_chunks * res.niter)
        packed = cuda_mu.mu_stats_masked.packed_launches
        check(packed == launches4, f"phase 23a config 4: {packed} of "
              f"{launches4} launches packed")
        same = (res.niter == phase20["niter"],
                torch.equal(res.d, phase20["d"]),
                x_digest(res.x) == phase20["x"])
        check(all(same), f"phase 23a config 4: not phase 20's stop and bits "
              f"(niter, d, x equal: {same}; niter {res.niter} against "
              f"{phase20['niter']})")
        print(f"phase 23a: masked_completion_streaming(mesh=) at config 4, "
              f"a world of 1, every chunk cached: stopped on phase 20's "
              f"epoch {res.niter} with phase 20's bits, in {wall4:.3f} s "
              f"({wall4 * 1e3 / res.niter:.3f} ms per epoch, {card}); "
              f"mu_stats_masked launches {launches4}, all packed",
              flush=True)
        del res

        def run4(sharded, epochs):
            return nmf.masked_completion_streaming(
                *loaders, d=start.d, x=start.x, hbm_cache_chunks=n_chunks,
                **{**kw, "maxiter": epochs, "tol": 0.0},
                **({"mesh": mesh} if sharded else {}))

        turns = [per_epoch_ms(lambda e, sh=sh: run4(sh, e), 20, 220)[0]
                 for sh in (False, True, True, False)]
        prof = [_profile_run(lambda sh=sh: run4(sh, 200))[:2]
                for sh in (False, True)]
        # The one step a sharded epoch adds, alone: the statistics laid
        # into one buffer and all-reduced, and the same without the call.
        stats = [torch.rand((50, 1000), device=dev) for _ in range(2)]
        red = parallel.mesh.reducer(mesh, "rows")
        step_ms = [cuda_ms(lambda r=r: ns.reduce_together(r, *stats, None,
                                                          None, None), 500)
                   for r in (red, lambda t: t)]
        print(f"  config 4 cached, ms per epoch (differential, 220 - 20 "
              f"epochs) in turns, one process / world of 1 / world of 1 / "
              f"one process: {turns[0]:.4f} / {turns[1]:.4f} / "
              f"{turns[2]:.4f} / {turns[3]:.4f}; 200 epochs profiled, one "
              f"process wall {prof[0][0]:.1f} ms, busy {prof[0][1]:.1f} "
              f"ms; world of 1 wall {prof[1][0]:.1f} ms, busy "
              f"{prof[1][1]:.1f} ms; reduce_together of numd and dend "
              f"alone {step_ms[0]:.4f} ms a call, without the NCCL call "
              f"{step_ms[1]:.4f} ms ({card})", flush=True)
        report.append({"case": "config 4 masked_completion_streaming(mesh="
                       "), world of 1 (NCCL)", "niter": phase20["niter"],
                       "s": wall4, "bits_equal_phase20": True,
                       "ms_per_epoch_turns": turns,
                       "profile_200": {"one_process": prof[0],
                                       "world_of_1": prof[1]},
                       "reduce_together_ms": step_ms,
                       "launches": {"mu_stats_masked.packed": packed}})
        torch.save({"d0": start.d.cpu(), "x0": start.x.cpu(),
                    "d2": run4(False, 2).d.cpu()}, _stream_path(tmp, "c4"))
        del start, ym4, mask4
    finally:
        dist.destroy_process_group()

    torch.save({"d": phase21.cpu()}, _stream_path(tmp, "dl3"))
    y7, mask7 = kl_stream_data(dev)
    for case, mk in (("kl", None), ("klm", mask7)):
        my7 = y7 if mk is None else mk * y7
        d0, x0 = nmf_mod._init_factors(
            torch.Generator(device=dev).manual_seed(0), my7, None, None, 128)
        one = nmf.solve_streaming(
            lambda lo, hi: my7[lo:hi], d0, x=x0, x_device=True,
            jit_loader=True,
            mask=None if mk is None else (lambda lo, hi: mk[lo:hi]),
            **stream_kw(case))
        torch.save({"d0": d0.cpu(), "x0": x0.cpu(), "d": one.d.cpu()},
                   _stream_path(tmp, case))
        del my7, d0, x0, one
    del y7, mask7
    my, mask, d0 = masked_dl_stream_data(dev)
    one = dl.solve_streaming(lambda lo, hi: my[lo:hi], d0, 0.05,
                             mask=lambda lo, hi: mask[lo:hi],
                             jit_loader=True, **stream_kw("mdl"))
    torch.save({"d": one.d.cpu()}, _stream_path(tmp, "mdl"))
    del my, mask, d0, one
    y2, a2, _ = config2_data()
    core = lasso.solve(torch.from_numpy(y2).to(dev),
                       torch.from_numpy(a2).to(dev), 0.1,
                       **stream_kw("lasso"))
    torch.save({"x": core.x.cpu(), "niter": core.niter.cpu()},
               _stream_path(tmp, "lasso"))
    del core
    torch.cuda.empty_cache()
    failures = []
    for case in STREAM_CASES:
        outs = world.run(stream_rank, case, tmp)
        failures += stream_failures(case, outs, phase20)
        entry = {"case": case, "world": 2, "backend": "gloo",
                 "limit": C2_X_LIMIT if case == "lasso" else SHARD_LIMIT,
                 "ranks": outs}
        if case == "c4":
            entry.update(phase20_niter=phase20["niter"],
                         phase20_heldout=phase20["heldout"])
        report.append(entry)
        print(f"phase 23b {case}: " + json.dumps(entry), flush=True)
    check(not failures, "phase 23b: " + "; ".join(failures))
    return report


# Phase 24's cold serving process, run from a copy of decomp_tpu_torch/
# whose _build/ is empty: it loads the headline artifact (argv[1]), makes
# the headline's data from its seed and serves a first call and a second.
# It prints one JSON line: its times, its launches and digests of d and x.
SERVE_SCRIPT = r"""
import hashlib, json, os, sys, time
t_start = time.perf_counter()
import torch
import decomp_tpu_torch
from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.utils import aot
import_s = time.perf_counter() - t_start
dev = torch.device("cuda", 0)
y = torch.rand((1 << 20, 10112), generator=torch.Generator(
    device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
torch.cuda.synchronize()
t0 = time.perf_counter()
art = aot.load_solver(sys.argv[1])
load_s = time.perf_counter() - t0
res = art(y)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
t0 = time.perf_counter()
again = art(y)
torch.cuda.synchronize()
second_s = time.perf_counter() - t0


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


print(json.dumps({
    "package": os.path.dirname(os.path.abspath(decomp_tpu_torch.__file__)),
    "import_s": import_s, "load_s": load_s,
    "load_and_first_call_s": first_s, "second_call_s": second_s,
    "same_again": torch.equal(again.d, res.d), "niter": res.niter,
    "launches": cuda_mu.mu_stats_dense.launches,
    "tma_launches": cuda_mu.mu_stats_dense.tma_launches,
    "d_sha256": digest(res.d), "x_sha256": digest(res.x)}))
"""


def result_bits(res, live):
    """Whether each of x, d (where the family has it), niter and
    converged holds the same bits in ``res`` as in ``live``."""
    out = {}
    for field in ("x", "d", "niter", "converged"):
        if hasattr(live, field):
            a, b = getattr(res, field), getattr(live, field)
            out[field] = (torch.equal(a, b) if isinstance(b, torch.Tensor)
                          else a == b)
    return out


def aot_roundtrip(aot, solve, args, kw, path):
    """A live solve, its artifact exported, saved to ``path`` and loaded
    in this process: (live result, loaded artifact, export seconds, the
    artifact's bytes)."""
    live = solve(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aot.export_solver(solve, *args, **kw).save(path)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    return live, aot.load_solver(path), export_s, os.path.getsize(path)


def aot_rank(rank, n):
    """One rank of phase 24's sharded artifact: ``parallel.nmf.solve`` on
    the rank's rows of phase 22's "mu" case, seeded factors, 20
    iterations, live and through an artifact exported on every rank,
    serialized and loaded back; the artifact's launches per route."""
    from decomp_tpu_torch import parallel
    from decomp_tpu_torch.utils import aot

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = SHARD_CASES["mu"][0]
    lo, hi = rank * rows // n, (rank + 1) * rows // n
    data = shard_data("mu", lo, hi, dev)
    y, d = data["y"], data["d"]
    del data
    kw = dict(tol=0.0, maxiter=20, eps=EPS, precision="default",
              factor_dtype=torch.float32,
              mesh=parallel.make_mesh((n,), ("rows",)))
    live = parallel.nmf.solve(y, d, **kw)
    blob = aot.export_solver(parallel.nmf.solve, y, d, **kw).serialize()
    loaded = aot.load_solver(blob)
    torch.cuda.synchronize()
    shard_read(reset=True)
    res = loaded(y, d)
    torch.cuda.synchronize()
    return {"rank": rank, "bits": result_bits(res, live),
            "launches": shard_read(), "bytes": len(blob),
            "pinned": list(loaded.in_avals[0].shape),
            "libraries": list(loaded.libraries)}


def sharded_aot(world, card):
    """Phase 24a, on phase 22's world of 2: each rank's artifact gives its
    live solve's bits, every launch on the TMA route."""
    outs = world.run(aot_rank)
    rows = SHARD_CASES["mu"][0] // 2
    for o in outs:
        check(all(o["bits"].values()), f"phase 24a rank {o['rank']}: the "
              f"artifact's result differs from the live solve {o['bits']}")
        check(o["launches"] == {"mu_stats_dense.tma": 20}, f"phase 24a rank "
              f"{o['rank']}: launches {o['launches']}")
        check(o["pinned"] == [rows, 10112], f"phase 24a: pinned "
              f"{o['pinned']}, not the rank's block")
    print(f"phase 24a: parallel.nmf.solve artifacts on two gloo ranks "
          f"({card}): each rank's round trip equals its live solve bit for "
          f"bit, 20 launches on the TMA route; " + json.dumps(outs),
          flush=True)
    return outs


def aot_phase(nmf, lasso, cuda_mu, cuda_lasso, dev, card, build_s,
              reset_counts, read_counts, shard_aot):
    """Phase 24: solver artifacts (``utils.aot``). (a) The headline path at
    full width exported, saved and loaded in this process: bit-equal to the
    live solve, every launch on the TMA route; (b) a cold serving process
    on a copy of the package with an empty ``_build/``: it serves the
    headline's call on the same seeded data with the same bits, and its
    ``_build/`` then holds the artifact's libraries and no nvcc log; (c)
    config 4's ``masked_completion`` (the packed ``mu_stats_masked``) and
    config 2's ``lasso.solve`` (``solve_rows``), each round trip bit-equal;
    (d) a masked ``lasso.solve`` with 256 features (``masked_grad_rows``'
    wide route, ``csrc/grad_wide.cu``), its artifact carrying that library,
    every launch on the wide route and the round trip bit-equal. Returns the
    JSON summary's entry."""
    import shutil
    import tempfile

    import decomp_tpu_torch
    from decomp_tpu_torch.utils import aot

    f32, bf16 = torch.float32, torch.bfloat16
    report = {"card": card, "build_s": build_s, "sharded": shard_aot}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the headline path: 1,048,576 x 10,112 bf16, rank 128, f32
        # factors, tol 0, 20 iterations (21.2 GB of data).
        m, n, k, iters = 1 << 20, 10112, 128, 20
        y = torch.rand((m, n), generator=_seeded(0, dev), device=dev,
                       dtype=bf16)
        kw = dict(rank=k, tol=0.0, eps=EPS, precision="default",
                  factor_dtype=f32, random_seed=0, maxiter=iters)
        path = os.path.join(tmp, "headline.dttaot")
        live, loaded, export_s, size = aot_roundtrip(aot, nmf.solve, (y,),
                                                     kw, path)
        check(any(lib.startswith("libmu_dense_tma-")
                  for lib in loaded.libraries),
              f"the headline artifact lacks mu_dense_tma: {loaded.libraries}")
        torch.cuda.synchronize()
        reset_counts()
        res = loaded(y)
        torch.cuda.synchronize()
        launches = read_counts("mu_stats_dense", iters)
        tma = cuda_mu.mu_stats_dense.tma_launches
        check(tma == iters, f"phase 24: {tma} of {iters} launches of the "
              "artifact on the TMA route")
        bits = result_bits(res, live)
        check(all(bits.values()), f"phase 24: the headline artifact's "
              f"result differs from the live solve {bits}")
        digests = {"d": x_digest(live.d), "x": x_digest(live.x)}
        print(f"phase 24: headline artifact (nmf.solve {m}x{n} bf16, rank "
              f"{k}, f32 factors, {iters} iterations): {size} bytes, "
              f"libraries {list(loaded.libraries)}, exported and saved in "
              f"{export_s:.2f} s; loaded in this process it equals the live "
              f"solve bit for bit ({bits}); mu_stats_dense launches "
              f"{launches}, TMA route {tma} ({card})", flush=True)
        report["headline"] = {"bytes": size, "libraries":
                              list(loaded.libraries), "export_s": export_s,
                              "bits_equal": True, "launches": launches,
                              "tma_launches": tma}
        libraries = set(loaded.libraries)
        del y, live, res, loaded
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        # (b) a cold serving process: the package copied without _build/.
        root = os.path.realpath(os.path.join(tmp, "serve"))
        copy = os.path.join(root, "decomp_tpu_torch")
        shutil.copytree(os.path.dirname(os.path.abspath(
            decomp_tpu_torch.__file__)), copy,
            ignore=shutil.ignore_patterns("_build", "__pycache__"))
        build = os.path.join(copy, "_build")
        check(not os.path.exists(build), "the copy holds a _build/")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_SCRIPT, path], cwd=root,
            env={**os.environ, "PYTHONPATH": root}, capture_output=True,
            text=True, timeout=600)
        wall_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 24: the cold serving process "
              f"failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        served = json.loads(proc.stdout.strip().splitlines()[-1])
        held = sorted(os.listdir(build)) if os.path.isdir(build) else []
        check(os.path.realpath(served["package"]) == copy,
              f"the serving process imported {served['package']}")
        check(set(held) == libraries and not any(
            f.endswith(".log") for f in held), f"phase 24: the copy's "
              f"_build/ holds {held}, not the artifact's {sorted(libraries)}")
        check(served["d_sha256"] == digests["d"]
              and served["x_sha256"] == digests["x"], "phase 24: the cold "
              "serving process's d or x differs from the live solve's")
        check(served["niter"] == iters and served["same_again"]
              and served["tma_launches"] == 2 * iters
              == served["launches"], f"phase 24: the cold calls ran "
              f"{served['niter']} iterations, {served['tma_launches']} of "
              f"{served['launches']} launches on the TMA route, the second "
              f"call's d {'equal' if served['same_again'] else 'not equal'}")
        print(f"phase 24: cold serving process on a copy of the package "
              f"with an empty _build/: import {served['import_s']:.2f} s, "
              f"load_solver {served['load_s']:.3f} s, load plus first call "
              f"{served['load_and_first_call_s']:.3f} s, a second call "
              f"{served['second_call_s']:.3f} s (phase 1 built the "
              f"{len(SOURCES)} sources in {build_s:.1f} s); d equal bit for "
              f"bit, x sha256 {served['x_sha256'][:16]} equal; its _build/ "
              f"holds {held}, no nvcc log; process wall {wall_s:.1f} s "
              f"({card})", flush=True)
        report["cold"] = {k_: served[k_] for k_ in (
            "import_s", "load_s", "load_and_first_call_s", "second_call_s",
            "x_sha256")}
        report["cold"].update({"process_s": wall_s, "build_dir": held,
                               "d_bits_equal": True})

        # (c) config 4's preset (phase 6's data and call) and config 2.
        m4, n4, k4 = 100_000, 1000, 50
        g = _seeded(3, dev)
        y4 = (torch.rand((m4, k4), generator=g, device=dev)
              @ torch.rand((k4, n4), generator=g, device=dev))
        mask4 = (torch.rand((m4, n4), generator=g, device=dev) >= 0.3).float()
        ym4 = y4 * mask4
        del y4
        live, loaded, _, size4 = aot_roundtrip(
            aot, nmf.masked_completion, (ym4, mask4),
            dict(rank=k4, tol=1e-4, maxiter=4000, random_seed=4),
            os.path.join(tmp, "config4.dttaot"))
        torch.cuda.synchronize()
        reset_counts()
        res = loaded(ym4, mask4)
        torch.cuda.synchronize()
        launches4 = read_counts("mu_stats_masked", res.niter)
        packed = cuda_mu.mu_stats_masked.packed_launches
        bits4 = result_bits(res, live)
        check(packed == res.niter and all(bits4.values()), f"phase 24 "
              f"config 4: bits {bits4}, {packed} of {res.niter} launches "
              "packed")
        print(f"phase 24: config 4 masked_completion artifact: {size4} "
              f"bytes, libraries {list(loaded.libraries)}; equals the live "
              f"solve bit for bit ({bits4}), stop at {res.niter}; "
              f"mu_stats_masked launches {launches4}, all packed ({card})",
              flush=True)
        report["config4"] = {"bytes": size4, "libraries":
                             list(loaded.libraries), "niter": res.niter,
                             "bits_equal": True, "packed_launches": packed}
        del ym4, mask4, live, loaded, res

        y2, a2 = (torch.from_numpy(v).to(dev) for v in config2_data()[:2])
        live, loaded, _, size2 = aot_roundtrip(
            aot, lasso.solve, (y2, a2, 0.1),
            dict(tol=1e-4, maxiter=4000, method="acc_ista",
                 per_problem=True, precision="high"),
            os.path.join(tmp, "config2.dttaot"))
        torch.cuda.synchronize()
        reset_counts()
        res = loaded(y2, a2, 0.1)
        torch.cuda.synchronize()
        launches2 = read_counts("solve_rows", 1)
        tma2 = cuda_lasso.solve_rows.tma_launches
        bits2 = result_bits(res, live)
        check(tma2 == 1 and all(bits2.values()), f"phase 24 config 2: bits "
              f"{bits2}, TMA launches {tma2}")
        print(f"phase 24: config 2 lasso.solve artifact: {size2} bytes, "
              f"libraries {list(loaded.libraries)}; equals the live solve "
              f"bit for bit ({bits2}); solve_rows launches {launches2}, on "
              f"lasso_fista_tma.cu {tma2} ({card})", flush=True)
        report["config2"] = {"bytes": size2, "libraries":
                             list(loaded.libraries), "bits_equal": True,
                             "solve_rows_launches": launches2}
        del y2, a2, live, loaded, res

        # (d) a wide masked solve: lasso.solve on f32 data with 256
        # features (every gradient on csrc/grad_wide.cu), 30% missing; the
        # mask is baked into the artifact, so the batch is small.
        m_w, n_w, f_w, it_w = 4096, 1024, 256, 20
        g = _seeded(25, dev)
        a_w = torch.randn((f_w, n_w), generator=g, device=dev) / n_w ** 0.5
        mask_w = (torch.rand((m_w, n_w), generator=g, device=dev)
                  >= 0.3).float()
        y_w = torch.randn((m_w, n_w), generator=g, device=dev) * mask_w
        live, loaded, _, size_w = aot_roundtrip(
            aot, lasso.solve, (y_w, a_w, 0.05),
            dict(mask=mask_w, method="fista", tol=0.0, maxiter=it_w,
                 use_kernel=True), os.path.join(tmp, "wide.dttaot"))
        check(any(lib.startswith("libgrad_wide-") for lib in loaded.libraries),
              f"the wide artifact lacks grad_wide: {loaded.libraries}")
        torch.cuda.synchronize()
        reset_counts()
        res = loaded(y_w, a_w, 0.05)
        torch.cuda.synchronize()
        launches_w = read_counts("masked_grad_rows", it_w)
        wide_w = cuda_lasso.masked_grad_rows.wide_launches
        bits_w = result_bits(res, live)
        check(wide_w == it_w and all(bits_w.values()), f"phase 24 wide: "
              f"bits {bits_w}, {wide_w} of {it_w} launches on the wide route")
        print(f"phase 24: wide masked lasso.solve artifact ({m_w}x{n_w} f32, "
              f"F={f_w}, 30% missing, {it_w} FISTA iterations): {size_w} "
              f"bytes, libraries {list(loaded.libraries)}; equals the live "
              f"solve bit for bit ({bits_w}); masked_grad_rows launches "
              f"{launches_w}, on grad_wide.cu {wide_w} ({card})", flush=True)
        report["wide"] = {"bytes": size_w, "libraries":
                          list(loaded.libraries), "bits_equal": True,
                          "wide_launches": wide_w}
    return report


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from decomp_tpu_torch import dictionary_learning, lasso, nmf
    from decomp_tpu_torch.models import nmf as nmf_mod
    from decomp_tpu_torch.ops import _build, cuda_dl, cuda_lasso, cuda_mu

    check("jax" not in sys.modules, "the port imported jax")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled; the f32 products must be full f32")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wrappers = [getattr(cuda_mu, n)
                for n in ("mu_stats_dense", *NEW_KERNELS)]
    wrappers += [cuda_lasso.solve_rows, cuda_lasso.masked_grad_rows,
                 cuda_dl.bcd_sweep, cuda_dl.masked_grad_dict]

    def reset_counts():
        for w in wrappers:
            w.launches = 0
        for w in (cuda_mu.mu_stats_masked, cuda_mu.kl_stats_masked):
            w.packed_launches = 0
            w.dense_launches = 0
        cuda_mu.mu_stats_masked.f32_launches = 0
        cuda_mu.mu_stats_dense.tma_launches = 0
        cuda_mu.mu_stats_dense.packed_launches = 0
        cuda_mu.mu_stats_dense.wide_launches = 0
        cuda_mu.mu_stats_masked.wide_launches = 0
        cuda_mu.kl_stats_dense.packed_launches = 0
        cuda_mu.kl_stats_dense.mu_kl_launches = 0
        cuda_mu.kl_stats_dense.wide_launches = 0
        cuda_mu.kl_stats_masked.wide_launches = 0
        cuda_lasso.solve_rows.complex_launches = 0
        cuda_lasso.solve_rows.tma_launches = 0
        cuda_lasso.solve_rows.wide_launches = 0
        for w in (cuda_lasso.masked_grad_rows, cuda_dl.masked_grad_dict):
            w.packed_launches = 0
            w.dense_launches = 0
            w.wide_launches = 0
        cuda_dl.bcd_sweep.register_launches = 0
        cuda_dl.bcd_sweep.cluster_launches = 0

    def grad_routes():
        """masked_grad_rows' launches since the reset: (packed, dense)."""
        w = cuda_lasso.masked_grad_rows
        return w.packed_launches, w.dense_launches

    def dict_routes():
        """masked_grad_dict's launches since the reset: (packed, dense)."""
        w = cuda_dl.masked_grad_dict
        return w.packed_launches, w.dense_launches

    def mask_routes():
        """The masked gradients' launches since the reset: (packed, dense,
        wide) of masked_grad_rows and of masked_grad_dict."""
        return tuple((w.packed_launches, w.dense_launches, w.wide_launches)
                     for w in (cuda_lasso.masked_grad_rows,
                               cuda_dl.masked_grad_dict))

    def bcd_routes():
        """bcd_sweep's launches since the reset: (register, cluster)."""
        w = cuda_dl.bcd_sweep
        return w.register_launches, w.cluster_launches

    def read_counts(expected, launches=None):
        """The counts after one path: ``expected`` launched ``launches``
        times (or each kernel of a dict ``expected`` its count), every
        other kernel not at all. Returns the expected count(s)."""
        got = {w.__name__: w.launches for w in wrappers}
        want = {w.__name__: 0 for w in wrappers}
        want.update(expected if isinstance(expected, dict)
                    else {expected: launches})
        check(got == want, f"kernel launches {got}, expected {want}")
        return expected if isinstance(expected, dict) else launches

    # Phase 1: the card, and the kernels built from the checkout.
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = {s: pool.submit(_build.build, s) for s in SOURCES}
        lib_paths = {s: f.result() for s, f in builds.items()}
    for s in SOURCES:
        _build.load(s)
    build_s = time.perf_counter() - t0
    for s, lib_path in lib_paths.items():
        ptxas = open(str(lib_path) + ".log").read()
        spills = [ln.strip() for ln in ptxas.splitlines()
                  if "spill stores" in ln
                  and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"built decomp_tpu_torch/csrc/{s}.cu with nvcc for sm_90a; "
              f"register spills: {spills or 'none'}", flush=True)
        if s in ("kl_dense_packed", "grad_dict_packed", "mu_dense_packed",
                 "mu_masked_f32", "lasso_grad_packed", "grad_wide",
                 "mu_wide"):
            check(not spills, f"{s}.cu: a wgmma kernel's instance spills")
        if s == "lasso_fista_wide":
            check(not spills, f"{s}.cu: an instance of the wide solve "
                  "spills")
        if s == "dl_bcd_sm90":
            check(not spills, f"{s}.cu: d, held in registers, spills")
        if s == "dl_bcd_cluster":
            check(not spills, f"{s}.cu: an instance of the cluster sweep "
                  "spills")
    print(f"{len(SOURCES)} sources built in parallel in {build_s:.1f} s "
          f"(0 s = already built); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t_phase = phase("1 build", t_phase)

    # Phase 2: the dense kernels against their twin on the card: f32 data
    # on csrc/mu_dense_packed.cu, bf16 data on csrc/mu_dense_tma.cu.
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    for inner in (1, 3):
        compare(cuda_mu, gen, dev, 1000, 1000, 100, inner, f32, f32)
    compare(cuda_mu, gen, dev, 65536, 10112, 128, 1, f32, f32)
    for m, n, k, inner in ((1000, 1000, 100, 1), (1000, 1000, 100, 3),
                           (1000, 1000, 64, 1), (333, 257, 7, 1),
                           (65537, 10112, 128, 1), (65536, 10112, 128, 1)):
        for xdt in (f32, bf16):
            compare(cuda_mu, gen, dev, m, n, k, inner, bf16, xdt)
    t_phase = phase("2 dense kernel vs twin", t_phase)

    # Phase 3: the masked-MU and KL kernels against their twins, the masked
    # ones on their dense-mask routes (csrc/mu_kl_stats.cu). f32 data with
    # a 0/1 mask take the packed KL kernel (phase 3c), so the dense-mask
    # KL kernel is held on f32 data with a weighted mask; f32 dense KL
    # takes csrc/kl_dense_packed.cu (phase 3d), so csrc/mu_kl_stats.cu's
    # f32 dense KL is held through its private launch helper.
    variants = {"mu_stats_masked": [(bf16, f32), (bf16, bf16), (f32, f32)],
                "kl_stats_dense": [(bf16, bf16), (f32, f32)],
                "kl_stats_masked": [(bf16, bf16), (f32, f32)]}
    for m, n, k in ((1000, 1000, 100), (100_000, 1000, 50),
                    (65536, 10112, 128)):
        for name, dts in variants.items():
            for ydt, xdt in dts:
                args = stats_inputs(gen, dev, m, n, k, ydt, xdt,
                                    NEW_KERNELS[name][1])
                kw = {}
                if name == "kl_stats_masked" and ydt == f32:
                    args, kw["tag"] = weighted(gen, args), "weighted mask"
                if name == "kl_stats_dense" and ydt == bf16:
                    kw["route"] = "mu_kl_launches"
                if name == "kl_stats_dense" and ydt == f32:
                    kw = dict(fn=cuda_mu._kl_dense_mu_launch,
                              route="packed_launches",
                              tag="csrc/mu_kl_stats.cu (private helper)")
                compare_new(cuda_mu, name, args, **kw)
                del args
    t_phase = phase("3 masked-MU and KL kernels vs twins", t_phase)

    # Phase 3b: the packed-mask masked-MU kernel against its twin, bf16
    # data with f32 and with bf16 x.
    for m, n, k in ((1000, 1000, 100), (100_000, 1000, 50),
                    (65536, 10112, 128), (333, 257, 7), (1000, 1000, 64)):
        for xdt in (f32, bf16):
            args = stats_inputs(gen, dev, m, n, k, bf16, xdt, True)
            compare_new(cuda_mu, "mu_stats_masked", args, packed=True)
            del args
    t_phase = phase("3b packed-mask kernel vs twin", t_phase)

    # Phase 3c: the packed-mask KL kernel (csrc/kl_masked_packed.cu, bf16x6
    # on the tensor cores) against its full-f32 twin, f32 data: phase 3's
    # shapes, ragged ones, eps = 0, and log-normal data over six decades.
    for m, n, k in ((1000, 1000, 100), (100_000, 1000, 50),
                    (65536, 10112, 128), (333, 257, 7), (1000, 1000, 64),
                    (1000, 1000, 1)):
        args = stats_inputs(gen, dev, m, n, k, f32, f32, True)
        compare_new(cuda_mu, "kl_stats_masked", args, packed=True)
        if k == 7:
            compare_new(cuda_mu, "kl_stats_masked", args, packed=True,
                        eps=0.0)
        del args
    args = lognormal_inputs(gen, dev, 65536, 1024, 128)
    lo, hi = (float(q) for q in torch.quantile(
        torch.log10(args[0][args[1] > 0][:1 << 20]),
        torch.tensor([0.0015, 0.9985], device=dev)))
    compare_new(cuda_mu, "kl_stats_masked", args, packed=True,
                tag=f"log-normal, 99.7% of observed my over {hi - lo:.1f} "
                "decades")
    del args
    # The dense-mask KL kernel at the same edges: ragged M, N and K, K = 1
    # and eps = 0, bf16 data and f32 data with a weighted mask.
    for m, n, k, eps in ((333, 257, 7, EPS), (333, 257, 7, 0.0),
                         (1000, 1000, 1, EPS)):
        for ydt in (bf16, f32):
            args = stats_inputs(gen, dev, m, n, k, ydt, ydt, True)
            tag = ""
            if ydt == f32:
                args, tag = weighted(gen, args), "weighted mask"
            compare_new(cuda_mu, "kl_stats_masked", args, eps=eps, tag=tag)
            del args
    t_phase = phase("3c packed-mask KL kernel vs twin", t_phase)

    # Phase 3d: the dense KL kernel on f32 data (csrc/kl_dense_packed.cu,
    # bf16x6 on wgmma) against its full-f32 twin: phase 3's shapes, ragged
    # ones with eps = 0 (no NaN at the edges), K = 64 and 1, and log-normal
    # data over six decades.
    for m, n, k, eps in ((1000, 1000, 100, EPS), (100_000, 1000, 50, EPS),
                         (65536, 10112, 128, EPS), (333, 257, 7, EPS),
                         (333, 257, 7, 0.0), (1000, 1000, 64, EPS),
                         (1000, 1000, 1, EPS)):
        args = stats_inputs(gen, dev, m, n, k, f32, f32, False)
        compare_new(cuda_mu, "kl_stats_dense", args, eps=eps,
                    route="packed_launches")
        del args
    my, _, x, d = lognormal_inputs(gen, dev, 65536, 1024, 128, missing=0.0)
    lo, hi = (float(q) for q in torch.quantile(
        torch.log10(my.flatten()[:1 << 20]),
        torch.tensor([0.0015, 0.9985], device=dev)))
    compare_new(cuda_mu, "kl_stats_dense", (my, x, d),
                route="packed_launches",
                tag=f"log-normal, 99.7% of my over {hi - lo:.1f} decades")
    # x d above 2^126 in the x update: E's division scales such divisors.
    my = 1e30 * (0.5 + torch.rand((1000, 1000), generator=gen, device=dev))
    x = 1e19 * (0.8 + 0.2 * torch.rand((1000, 1), generator=gen, device=dev))
    d = 1e19 * (1.0 + 0.6 * torch.rand((1, 1000), generator=gen, device=dev))
    share = float(((x @ d) > 2.0 ** 126).float().mean())
    compare_new(cuda_mu, "kl_stats_dense", (my, x, d),
                route="packed_launches",
                tag=f"x d above 2^126 in {share:.1%} of the entries")
    del my, x, d
    t_phase = phase("3d dense KL kernel vs twin", t_phase)

    # Phase 3e: dense MU on f32 data (csrc/mu_dense_packed.cu, bf16x6 on
    # wgmma) against its full-f32 twin: inner_iter 1 and 3, dense KL's
    # shape, the f32 path's width, ragged M, N and K with eps = EPS and 0,
    # K = 1 and 64, and log-normal data over six decades.
    for m, n, k, inner, eps in (
            (1000, 1000, 100, 1, EPS), (1000, 1000, 100, 3, EPS),
            (100_000, 1024, 128, 1, EPS), (65536, 10112, 128, 1, EPS),
            (333, 257, 7, 1, EPS), (333, 257, 7, 1, 0.0),
            (1000, 1000, 1, 1, EPS), (1000, 1000, 64, 1, EPS)):
        args = stats_inputs(gen, dev, m, n, k, f32, f32, False)
        compare_dense_packed(cuda_mu, args, eps, inner)
        del args
    y, _, x, d = lognormal_inputs(gen, dev, 65536, 1024, 128, missing=0.0)
    lo, hi = (float(q) for q in torch.quantile(
        torch.log10(y.flatten()[:1 << 20]),
        torch.tensor([0.0015, 0.9985], device=dev)))
    compare_dense_packed(cuda_mu, (y, x, d), f64=True,
                         tag=f"log-normal, 99.7% of y over {hi - lo:.1f} "
                         "decades")
    del y, x, d
    t_phase = phase("3e dense MU f32 kernel vs twin", t_phase)

    # Phase 3f: masked MU on f32 data with the mask's bits
    # (csrc/mu_masked_f32.cu, bf16x6 on wgmma) against its full-f32 twin:
    # phase 3c's shapes, ragged M, N and K with eps = EPS and 0, K = 1, 64
    # and 128, and log-normal data over six decades (also against f64).
    for m, n, k, eps in ((1000, 1000, 100, EPS), (100_000, 1000, 50, EPS),
                         (65536, 10112, 128, EPS), (333, 257, 7, EPS),
                         (333, 257, 7, 0.0), (1000, 1000, 64, EPS),
                         (1000, 1000, 1, EPS), (1000, 1000, 128, EPS)):
        args = stats_inputs(gen, dev, m, n, k, f32, f32, True)
        compare_masked_f32(cuda_mu, args, eps)
        del args
    args = lognormal_inputs(gen, dev, 65536, 1024, 128)
    lo, hi = (float(q) for q in torch.quantile(
        torch.log10(args[0][args[1] > 0][:1 << 20]),
        torch.tensor([0.0015, 0.9985], device=dev)))
    compare_masked_f32(cuda_mu, args, f64=True,
                       tag=f"log-normal, 99.7% of observed my over "
                       f"{hi - lo:.1f} decades")
    del args
    t_phase = phase("3f masked MU f32 kernel vs twin", t_phase)

    # Phase 4: the dense main path at the real size.
    m, n, k, iters = 1 << 20, 10112, 128, 20
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.rand((m, n), generator=g, device=dev, dtype=bf16)
    # The factors solve(random_seed=0) starts from: same seed, same draws.
    d0, x0 = nmf_mod._init_factors(torch.Generator(device=dev).manual_seed(0),
                                   y, None, None, k, f32)
    # One mu_stats_dense call of the kernel against the twin at this shape.
    d0b = d0.to(bf16)
    out = cuda_mu.mu_stats_dense(y, x0, d0b, EPS)
    ref = cuda_mu.mu_stats_dense_plain(y, x0, d0b, EPS)
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    err_abs = max_abs(out, ref)
    check(max(errs) <= LIMIT[bf16], f"main-path shape: kernel disagrees "
          f"with twin {errs}")
    del out, ref

    # The TMA kernel in turns with the mma.sync design (csrc/mu_stats_dense.cu,
    # which the main path no longer runs on bf16) on the same inputs.
    def tma():
        return cuda_mu.mu_stats_dense(y, x0, d0b, EPS)

    def mma():
        return cuda_mu._dense_mma_launch(y, x0, d0b, EPS)

    t = [cuda_ms(f, 5) for f in (mma, tma, tma, mma)]
    kernel_ms, mma_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    plain_ms = cuda_ms(lambda: cuda_mu.mu_stats_dense_plain(
        y, x0, d0b, EPS), 2)
    dense_b = stats_bound("mu_stats_dense", m, n, k, bf16, f32)
    print(f"mu_stats_dense {m}x{n} K={k} bf16 y, f32 x: TMA kernel "
          f"{kernel_ms:.3f} ms, mu_stats_dense.cu {mma_ms:.3f} ms (TMA / "
          f"mma.sync {kernel_ms / mma_ms:.3f}), plain twin {plain_ms:.3f} ms "
          f"per call, bound {dense_b[0]:.3f} ms ({dense_b[1]}) ({card}); "
          f"rel_fro x_new={errs[0]:.3e} numd={errs[1]:.3e} "
          f"gram={errs[2]:.3e}, max_abs_err={err_abs:.3e}", flush=True)
    dense_passes(cuda_mu, y, x0, d0b, card)
    del d0b

    rows = torch.arange(0, m, 4096, device=dev)
    ys = y[rows].float()

    def recon_err(x, d):
        return float(torch.linalg.vector_norm(ys - x[rows] @ d)
                     / torch.linalg.vector_norm(ys))

    err0 = recon_err(x0, d0)
    del x0, d0
    kw = dict(rank=k, tol=0.0, eps=EPS, precision="default",
              factor_dtype=f32, random_seed=0)
    nmf.solve(y, maxiter=2, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = nmf.solve(y, maxiter=iters, **kw)
    e1.record()
    torch.cuda.synchronize()
    launches = read_counts("mu_stats_dense", iters)
    tma_launches = cuda_mu.mu_stats_dense.tma_launches
    check(tma_launches == iters, f"{tma_launches} of {iters} mu_stats_dense "
          "launches took the TMA route")
    solve_s = e0.elapsed_time(e1) / 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(res.niter == iters, f"niter {res.niter} != {iters}")
    check(res.x.shape == (m, k) and res.d.shape == (k, n), "factor shapes")
    check(res.x.dtype == f32 and res.d.dtype == f32, "factor dtypes")
    for name, t in (("x", res.x), ("d", res.d)):
        check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
        check(bool((t >= 0).all()), f"{name} has negative values")
    err1 = recon_err(res.x, res.d)
    check(err1 < err0, f"reconstruction error did not fall: {err0} -> {err1}")
    tflops = flops_per_iter(m, n, k) * iters / solve_s / 1e12
    print(f"main path nmf.solve {m}x{n} bf16, rank {k}, f32 factors: "
          f"{iters} iterations in {solve_s:.3f} s = {iters / solve_s:.3f} "
          f"iters/s, {tflops:.2f} TFLOP/s ({card}); mu_stats_dense "
          f"launches {launches} (TMA route {tma_launches}, "
          f"mu_stats_dense.cu {launches - tma_launches}); sampled relative "
          f"reconstruction error "
          f"{err0:.4f} -> {err1:.4f}; peak device memory {peak_gb:.1f} GB",
          flush=True)
    # Phase 22 holds a world of 1 to these bits.
    main4 = (res.x, res.d, solve_s * 1e3 / iters)
    del res, y, ys
    t_phase = phase("4 dense main path", t_phase)

    # Phase 4b: dense MU on f32 data at the main path's width.
    f32_path = f32_dense_phase(nmf, nmf_mod, cuda_mu, dev, card,
                               reset_counts, read_counts)
    t_phase = phase("4b f32 dense path", t_phase)

    # Phase 4c: MU above rank 128 on the wide route (csrc/mu_wide.cu).
    wide_rank_stats, wide_rank_launches = wide_rank_phase(
        nmf, nmf_mod, cuda_mu, dev, card, reset_counts, read_counts)
    t_phase = phase("4c wide-rank MU", t_phase)

    # Phase 4d: KL-MU above rank 128 on the wide route (csrc/mu_wide.cu).
    kl_wide_stats, kl_wide_launches = kl_wide_phase(
        nmf, nmf_mod, cuda_mu, dev, card, reset_counts, read_counts)
    wide_rank_stats.update(kl_wide_stats)
    wide_rank_launches.update(kl_wide_launches)
    t_phase = phase("4d wide-rank KL-MU", t_phase)

    # Phase 5: a converging run (planted rank 10, 1% noise) and a restart.
    rng = np.random.default_rng(0)
    xt, dt = rng.uniform(0, 1, (1000, 10)), rng.uniform(0, 1, (10, 500))
    yp = np.maximum(xt @ dt + 0.01 * rng.normal(size=(1000, 500)), 0.0)
    yp = torch.from_numpy(yp.astype(np.float32)).to(dev)
    w = cuda_mu.mu_stats_dense
    before = (w.launches, w.packed_launches)
    t0 = time.perf_counter()
    res = nmf.solve(yp, rank=10, tol=1e-4, maxiter=4000)
    wall = time.perf_counter() - t0
    err = float(torch.linalg.vector_norm(yp - res.x @ res.d)
                / torch.linalg.vector_norm(yp))
    warm = nmf.solve(yp, res.d, x=res.x, tol=1e-4, maxiter=4000)
    moved = (w.launches - before[0], w.packed_launches - before[1])
    print(f"planted 1000x500 rank 10 f32: converged={res.converged} in "
          f"{res.niter} iterations ({wall:.2f} s), relative error {err:.4f}; "
          f"warm restart {warm.niter} iterations; kernel launches "
          f"{moved[0]}, on mu_dense_packed.cu {moved[1]}", flush=True)
    check(res.converged, "planted run did not converge")
    check(err <= 2e-2, f"planted relative error {err} > 2e-2")
    check(warm.niter <= 3, f"warm restart took {warm.niter} iterations")
    check(moved[0] == moved[1] >= res.niter, f"planted run: {moved[1]} of "
          f"{moved[0]} launches on the packed route")
    # f32 data take csrc/mu_dense_packed.cu: one call on the solution,
    # timed in turns with csrc/mu_stats_dense.cu on the same inputs.
    args5 = (yp, res.x, res.d)
    err5 = compare_dense_packed(cuda_mu, args5, tag="(config 1's solution)")
    # What sets config 1's pace: each launch's device time (the passes)
    # against the time per call.
    time_dense_packed(cuda_mu, args5, 50, card, err5, " (config 1)")
    t_phase = phase("5 planted dense", t_phase)

    # Phase 6: masked completion at BASELINE config 4 (bench.py:214-220):
    # planted rank 50, 30% missing, made on the card from a seed.
    m4, n4, k4 = 100_000, 1000, 50
    g = torch.Generator(device=dev).manual_seed(3)
    y4 = (torch.rand((m4, k4), generator=g, device=dev)
          @ torch.rand((k4, n4), generator=g, device=dev))
    mask4 = (torch.rand((m4, n4), generator=g, device=dev) >= 0.3).float()
    ym4 = y4 * mask4
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = nmf.masked_completion(ym4, mask4, rank=k4, tol=1e-4, maxiter=4000,
                                random_seed=4)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    launches4 = read_counts("mu_stats_masked", res.niter)
    routes4 = (cuda_mu.mu_stats_masked.packed_launches,
               cuda_mu.mu_stats_masked.dense_launches)
    check(routes4 == (res.niter, 0), f"config 4: (packed, dense) route "
          f"launches {routes4}, expected ({res.niter}, 0)")
    ho = float(res.aux["heldout_rel_err"])
    miss = 1.0 - mask4
    true_err = float(
        torch.linalg.vector_norm(miss * (res.x @ res.d - y4))
        / torch.linalg.vector_norm(miss * y4))
    print(f"config 4 nmf.masked_completion {m4}x{n4} rank {k4}, 30% "
          f"missing (bf16 data, f32 factors): converged={res.converged} "
          f"after {res.niter} iterations in {wall4:.3f} s "
          f"({res.niter / wall4:.1f} iters/s, {card}); held-out relative "
          f"error {ho:.4e}, true error on the missing entries "
          f"{true_err:.4e}; mu_stats_masked launches {launches4} (packed "
          f"route {routes4[0]}, dense route {routes4[1]})",
          flush=True)
    check(res.converged, "masked completion did not converge")
    check(ho < 5e-2, f"held-out relative error {ho} >= 5e-2")
    check(res.x.dtype == f32 and res.d.dtype == f32, "factor dtypes")
    for name, t in (("x", res.x), ("d", res.d)):
        check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
        check(bool((t >= 0).all()), f"{name} has negative values")
    phase6 = (res.niter, res.x, res.d, wall4)   # phase 22's reference
    niter6 = res.niter
    del res
    t_phase = phase("6 masked completion", t_phase)

    # Phase 6b: the f32 masked path, config 4 on phase 6's f32 data with
    # mixed=False: every mu_stats_masked launch on csrc/mu_masked_f32.cu.
    # The held-out stop at tol 1e-3, a shallower depth than phase 6's
    # 1e-4: on these noiseless planted data the f32 run's held-out error
    # keeps falling past the 2,975 iterations where bf16's rounding stops
    # phase 6 (on an H100: 6.99e-3 at 4,000, the stop at tol 1e-4 at
    # 47,750 with 5.21e-3, 64.6 s, an eighth of the script).
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = nmf.masked_completion(ym4, mask4, rank=k4, tol=1e-3,
                                maxiter=60_000, random_seed=4, mixed=False)
    torch.cuda.synchronize()
    wall6b = time.perf_counter() - t0
    launches6b = read_counts("mu_stats_masked", res.niter)
    routes6b = (cuda_mu.mu_stats_masked.f32_launches,
                cuda_mu.mu_stats_masked.packed_launches,
                cuda_mu.mu_stats_masked.dense_launches)
    check(routes6b == (res.niter, 0, 0), f"config 4 f32: (f32, bf16 "
          f"packed, dense) route launches {routes6b}, expected "
          f"({res.niter}, 0, 0)")
    ho6b = float(res.aux["heldout_rel_err"])
    true6b = float(
        torch.linalg.vector_norm(miss * (res.x @ res.d - y4))
        / torch.linalg.vector_norm(miss * y4))
    print(f"config 4 f32 nmf.masked_completion(mixed=False) {m4}x{n4} rank "
          f"{k4}, 30% missing (f32 data and factors): converged="
          f"{res.converged} after {res.niter} iterations in {wall6b:.3f} s "
          f"({wall6b * 1e3 / res.niter:.4f} ms an iteration; phase 6's "
          f"bf16 run {wall4 * 1e3 / niter6:.4f} ms over {niter6}; {card}); "
          f"held-out relative error {ho6b:.4e}, true error on the missing "
          f"entries {true6b:.4e}; mu_stats_masked launches {launches6b} "
          f"(mu_masked_f32.cu {routes6b[0]}, mu_masked_packed.cu "
          f"{routes6b[1]}, mu_kl_stats.cu {routes6b[2]})", flush=True)
    check(res.converged, "f32 masked completion did not converge")
    check(ho6b < 5e-2, f"f32 held-out relative error {ho6b} >= 5e-2")
    check(res.x.dtype == f32 and res.d.dtype == f32, "f32 factor dtypes")
    for name, t in (("x", res.x), ("d", res.d)):
        check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
        check(bool((t >= 0).all()), f"{name} has negative values")
    del res, y4, ym4, miss
    t_phase = phase("6b f32 masked completion", t_phase)

    # Phase 7: KL-MU at 100,000 x 1,024 rank 128 f32 (BASELINE.md's KL
    # rows), dense and masked, 20 iterations at tol = 0.
    m7, n7, k7 = 100_000, 1024, 128
    g = torch.Generator(device=dev).manual_seed(7)
    y7 = torch.rand((m7, n7), generator=g, device=dev)
    mask7 = (torch.rand((m7, n7), generator=g, device=dev) >= 0.3).float()
    kl_launches = {}
    eps7 = torch.tensor(EPS, dtype=f32)
    for name, mk in (("kl_stats_dense", None), ("kl_stats_masked", mask7)):
        my7 = y7 if mk is None else mk * y7
        d0, x0 = nmf_mod._init_factors(
            torch.Generator(device=dev).manual_seed(0), my7, None, None, k7)
        obj0 = float(nmf_mod._kl_objective(my7, x0, d0, mk, eps7))
        del d0, x0
        kw = dict(rank=k7, mask=mk, method="kl-mu", tol=0.0, eps=EPS,
                  random_seed=0)
        nmf.solve(y7, maxiter=2, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        e0.record()
        res = nmf.solve(y7, maxiter=iters, **kw)
        e1.record()
        torch.cuda.synchronize()
        kl_launches[name] = read_counts(name, iters)
        routes = ""
        if mk is None:   # f32 data: csrc/kl_dense_packed.cu
            got = (cuda_mu.kl_stats_dense.packed_launches,
                   cuda_mu.kl_stats_dense.mu_kl_launches)
            check(got == (iters, 0), f"dense KL-MU: (kl_dense_packed.cu, "
                  f"mu_kl_stats.cu) route launches {got}, expected "
                  f"({iters}, 0)")
            routes = (f" (kl_dense_packed.cu route {got[0]}, mu_kl_stats.cu "
                      f"route {got[1]})")
        else:   # f32 data and a 0/1 mask: the packed route
            got = (cuda_mu.kl_stats_masked.packed_launches,
                   cuda_mu.kl_stats_masked.dense_launches)
            check(got == (iters, 0), f"masked KL-MU: (packed, dense) route "
                  f"launches {got}, expected ({iters}, 0)")
            routes = f" (packed route {got[0]}, dense route {got[1]})"
        kl_s = e0.elapsed_time(e1) / 1e3
        obj1 = float(nmf_mod._kl_objective(my7, res.x, res.d, mk, eps7))
        print(f"KL-MU nmf.solve(method='kl-mu') {m7}x{n7} rank {k7} f32, "
              f"{'masked 30% missing' if mk is not None else 'dense'}: "
              f"{iters} iterations in {kl_s:.3f} s = {iters / kl_s:.3f} "
              f"iters/s ({card}); KL objective {obj0:.6e} -> {obj1:.6e}; "
              f"{name} launches {kl_launches[name]}{routes}", flush=True)
        check(res.niter == iters, f"niter {res.niter} != {iters}")
        check(np.isfinite(obj1) and obj1 < obj0,
              f"KL objective did not fall: {obj0} -> {obj1}")
        del res, my7
    t_phase = phase("7 KL-MU", t_phase)

    # Phase 8: each new kernel against its twin, per call, at its path's
    # shape. Masked MU runs its main path's route, the packed mask, timed
    # in turns with the dense-mask kernel on the same inputs, at config 4
    # and at 262,144 x 10,112 K = 128 bf16 (comparable with the dense row
    # above).
    times, errs_abs = {}, {}
    for m_, n_, k_ in ((m4, n4, k4), (262_144, 10112, 128)):
        args = stats_inputs(gen, dev, m_, n_, k_, bf16, f32, True)
        e = compare_new(cuda_mu, "mu_stats_masked", args, packed=True)
        t = time_packed(cuda_mu, "mu_stats_masked", args)
        b = stats_bound("mu_stats_masked", m_, n_, k_, bf16, f32, True)
        b_dense = stats_bound("mu_stats_masked", m_, n_, k_, bf16, f32)
        print(f"mu_stats_masked {m_}x{n_} K={k_} data=bfloat16 x=float32: "
              f"packed-mask kernel {t[0]:.3f} ms (bound {b[0]:.3f} ms, "
              f"{b[1]}), dense-mask kernel {t[1]:.3f} ms (bound "
              f"{b_dense[0]:.3f} ms, {b_dense[1]}), plain twin {t[2]:.3f} ms "
              f"per call; packed / dense {t[0] / t[1]:.3f} ({card}); "
              f"max_abs_err {e:.3e}", flush=True)
        packed_passes(cuda_mu, args, card)
        if m_ == m4:
            errs_abs["mu_stats_masked"] = e
            times["mu_stats_masked"] = (t[0], t[2])
        del args
    # f32 data with a 0/1 mask run csrc/mu_masked_f32.cu (phase 6b's
    # route), timed in turns with the dense-mask kernel of
    # csrc/mu_kl_stats.cu (weighted masks' route) on the same inputs, at
    # config 4, at dense KL's shape and at the f32 path's width.
    for m_, n_, k_, reps in ((m4, n4, k4, 10), (100_000, 1024, 128, 10),
                             (262_144, 10112, 128, 3)):
        args = stats_inputs(gen, dev, m_, n_, k_, f32, f32, True)
        e = compare_masked_f32(cuda_mu, args)
        t = time_masked_f32(cuda_mu, args, reps, card, e)
        if (m_, n_, k_) == (m4, n4, k4):
            errs_abs["mu_stats_masked_f32"] = e
            times["mu_stats_masked_f32"] = (t[0], t[2])
        del args
    # Dense KL on f32 data runs its main path's route, csrc/kl_dense_packed.cu,
    # timed in turns with csrc/mu_kl_stats.cu's f32 path on the same inputs.
    args = stats_inputs(gen, dev, m7, n7, k7, f32, f32, False)
    errs_abs["kl_stats_dense"] = compare_new(cuda_mu, "kl_stats_dense", args,
                                             route="packed_launches")

    def kl_new():
        return cuda_mu.kl_stats_dense(*args, EPS)

    def kl_old():
        return cuda_mu._kl_dense_mu_launch(*args, EPS)

    t = [cuda_ms(f, 10) for f in (kl_old, kl_new, kl_new, kl_old)]
    kl_ms, kl_old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    kl_plain_ms = cuda_ms(lambda: cuda_mu.kl_stats_dense_plain(*args, EPS), 2)
    times["kl_stats_dense"] = (kl_ms, kl_plain_ms)
    b = stats_bound("kl_stats_dense", m7, n7, k7, f32, f32)
    b_fma = stats_bound("kl_stats_dense", m7, n7, k7, f32, f32, fma=True)
    print(f"kl_stats_dense {m7}x{n7} K={k7} data=float32 x=float32: "
          f"kl_dense_packed.cu (bf16x6, wgmma) {kl_ms:.3f} ms ({t[1]:.4f}, "
          f"{t[2]:.4f}), mu_kl_stats.cu (f32 FMA) {kl_old_ms:.3f} ms "
          f"({t[0]:.4f}, {t[3]:.4f}), plain twin {kl_plain_ms:.3f} ms per "
          f"call; new / old {kl_ms / kl_old_ms:.3f}; bound bf16x6 "
          f"{b[0]:.3f} ms ({b[1]}, {b[0] / kl_ms:.1%} of it), f32-FMA "
          f"{b_fma[0]:.3f} ms ({card}); max_abs_err "
          f"{errs_abs['kl_stats_dense']:.3e}", flush=True)
    kl_dense_passes(cuda_mu, args, card)
    del args
    # Dense MU on f32 data at the same shape (so that rows 1 and 3 of the
    # kernels' table compare): csrc/mu_dense_packed.cu in turns with
    # csrc/mu_stats_dense.cu.
    args = stats_inputs(gen, dev, m7, n7, k7, f32, f32, False)
    time_dense_packed(cuda_mu, args, 10, card,
                      compare_dense_packed(cuda_mu, args))
    del args
    # Its bf16 route (csrc/mu_kl_stats.cu) at the same shape.
    args = stats_inputs(gen, dev, m7, n7, k7, bf16, bf16, False)
    e = compare_new(cuda_mu, "kl_stats_dense", args, route="mu_kl_launches")
    t = time_new(cuda_mu, "kl_stats_dense", args)
    b = stats_bound("kl_stats_dense", m7, n7, k7, bf16, bf16)
    nbytes = m7 * n7 * 2 + 2 * m7 * k7 * 2 + n7 * k7 * 2 + n7 * k7 * 4
    print(f"kl_stats_dense {m7}x{n7} K={k7} data=bfloat16 x=bfloat16 "
          f"(csrc/mu_kl_stats.cu): kernel {t[0]:.3f} ms, plain twin "
          f"{t[1]:.3f} ms per call, bound {b[0]:.3f} ms ({b[1]}; bytes "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms, one bf16 pass of 8MNK "
          f"{8.0 * m7 * n7 * k7 / PEAK_OPS[bf16] * 1e3:.3f} ms) ({card}); "
          f"max_abs_err {e:.3e}", flush=True)
    del args
    # Masked KL runs its main path's route, the packed mask, timed in turns
    # with the dense-mask kernel of csrc/mu_kl_stats.cu on the same inputs.
    args = stats_inputs(gen, dev, m7, n7, k7, f32, f32, True)
    e = compare_new(cuda_mu, "kl_stats_masked", args, packed=True)
    t = time_packed(cuda_mu, "kl_stats_masked", args)
    errs_abs["kl_stats_masked"], times["kl_stats_masked"] = e, (t[0], t[2])
    b = stats_bound("kl_stats_masked", m7, n7, k7, f32, f32, packed=True)
    b_fma = stats_bound("kl_stats_masked", m7, n7, k7, f32, f32, fma=True)
    print(f"kl_stats_masked {m7}x{n7} K={k7} data=float32 x=float32: "
          f"packed-mask kernel (bf16x6) {t[0]:.3f} ms, dense-mask kernel "
          f"(f32 FMA) {t[1]:.3f} ms, plain twin {t[2]:.3f} ms per call; "
          f"packed / dense {t[0] / t[1]:.3f}; bound bf16x6 {b[0]:.3f} ms "
          f"({b[1]}), f32-FMA {b_fma[0]:.3f} ms ({b_fma[1]}) ({card}); "
          f"max_abs_err {e:.3e}", flush=True)
    kl_packed_passes(cuda_mu, args, card)
    del args
    # The masked-KL routes still on csrc/mu_kl_stats.cu, on no path, at the
    # same shape: bf16 data and x on a 0/1 mask (bf16 takes the dense
    # mask), and f32 data on a weighted mask.
    for dt, what in ((bf16, "data=bfloat16 x=bfloat16, 0/1 mask"),
                     (f32, "data=float32 x=float32, weighted mask")):
        args = stats_inputs(gen, dev, m7, n7, k7, dt, dt, True)
        if dt == f32:
            args = weighted(gen, args)
        e = compare_new(cuda_mu, "kl_stats_masked", args)
        t = time_new(cuda_mu, "kl_stats_masked", args)
        b = stats_bound("kl_stats_masked", m7, n7, k7, dt, dt)
        b_fma = (stats_bound("kl_stats_masked", m7, n7, k7, dt, dt, fma=True)
                 if dt == f32 else None)
        print(f"kl_stats_masked {m7}x{n7} K={k7} {what} (dense mask, "
              f"csrc/mu_kl_stats.cu): kernel {t[0]:.3f} ms, plain twin "
              f"{t[1]:.3f} ms per call, bound {bound_text(b, b_fma)} "
              f"({card}); max_abs_err {e:.3e}", flush=True)
        del args
    t_phase = phase("8 kernel times", t_phase)

    # Phase 9: the lasso kernels against their twins.
    # 7 rows: fewer than one block's slots; 4,229 = 132 x 32 + 5 and 2,117 =
    # 132 x 16 + 5: a queue that leaves a few rows past one full round.
    for m_, f_, n_ in ((1000, 200, 160), (300, 1000, 700),
                       (10_000, 512, 256), (7, 200, 160), (4229, 200, 160)):
        compare_solve_rows(cuda_lasso, gen, dev, m_, f_, n_)
    # The complex mode: Fc complex features are 2 Fc reals.
    for m_, f_, n_ in ((1000, 100, 80), (300, 500, 350), (10_000, 512, 256),
                       (7, 100, 80), (2117, 512, 256)):
        compare_solve_rows(cuda_lasso, gen, dev, m_, f_, n_, complex_=True)
    for m_, n_, f_ in ((1000, 1000, 100), (333, 257, 7)):
        for dt in (f32, bf16):
            compare_grad(cuda_lasso, "masked_grad_rows",
                         grad_inputs(gen, dev, m_, n_, f_, dt))
    # The packed route (f32 and bf16 data, the mask as bits): N % 4 != 0
    # at 257 (my's padded copy; bf16: N % 8 != 0), 7 rows (fewer than a
    # stripe), F = 1, F = 64 (the 64-feature tile), and log-normal my, x and
    # a over six decades; bf16 also against the dense-mask kernel.
    for dt in (f32, bf16):
        for m_, n_, f_ in GRAD_PACKED_SHAPES:
            compare_grad(cuda_lasso, "masked_grad_rows",
                         grad_inputs(gen, dev, m_, n_, f_, dt), packed=True,
                         dense=dt == bf16)
        args = lognormal_inputs(gen, dev, 100_000, 1024, 128)
        compare_grad(cuda_lasso, "masked_grad_rows",
                     tuple(t.to(dt) for t in args), packed=True,
                     tag="log-normal", f64=True, dense=dt == bf16)
        del args
    # The weighted route (a dense mask: the weighted instances of
    # csrc/lasso_grad_packed.cu) on weights in [0.5, 1) at the packed
    # shapes, and on log-normal my, x and a with log-normal weights, each
    # also against the first design (csrc/lasso_grad.cu).
    for dt in (f32, bf16):
        for m_, n_, f_ in GRAD_PACKED_SHAPES:
            compare_grad(cuda_lasso, "masked_grad_rows",
                         weighted(gen, grad_inputs(gen, dev, m_, n_, f_, dt)),
                         first=True)
        args = weighted(gen, lognormal_inputs(gen, dev, 100_000, 1024, 128),
                        lognormal=True)
        compare_grad(cuda_lasso, "masked_grad_rows",
                     tuple(t.to(dt) for t in args),
                     tag="log-normal, log-normal weights", f64=True,
                     first=True)
        del args
    # Above 128 features: the wide route (csrc/grad_wide.cu), each instance
    # at WIDE_SHAPES, the gate's corners and on log-normal data.
    wide_checks(cuda_lasso, "masked_grad_rows", gen, dev)
    t_phase = phase("9 lasso kernels vs twins", t_phase)

    # Phase 9b: solve_rows above 1,024 features, the wide route
    # (csrc/lasso_fista_wide.cu), against its twin; 'highest' (bf16x6) on
    # log-normal data against f64.
    for m_, f_, n_ in WIDE_SOLVE_SHAPES:
        compare_solve_rows_wide(cuda_lasso, gen, dev, m_, f_, n_)
    for m_, f_, n_ in WIDE_SOLVE_COMPLEX:
        compare_solve_rows_wide(cuda_lasso, gen, dev, m_, f_, n_,
                                complex_=True)
    wide_highest_f64(cuda_lasso, gen, dev)
    t_phase = phase("9b wide solve_rows vs twin", t_phase)

    # Phase 10: batch lasso at BASELINE config 2.
    launches2, y2, a2 = config2_phase(lasso, dev, card, reset_counts,
                                      read_counts)
    check(cuda_lasso.solve_rows.complex_launches == 0,
          "config 2 took the complex route")
    lasso_crossover(lasso, gen, dev, card)
    t_phase = phase("10 config 2", t_phase)

    # Phase 10c: batch lasso on complex data, config-2-complex.
    launches2c, y2c, a2c = config2_complex_phase(
        lasso, cuda_lasso, dev, card, reset_counts, read_counts)
    t_phase = phase("10c config-2-complex", t_phase)

    # Phase 10d: batch lasso on the wide route, config 2's recipe over
    # 1,408 features and 640 complex features.
    wide_stats, wide_launches = wide_config2_phase(
        lasso, dictionary_learning, cuda_lasso, dev, card, reset_counts,
        read_counts)
    t_phase = phase("10d wide batch lasso", t_phase)

    # Phase 11: the masked lasso.
    launches_grad, launches_grad_w = masked_lasso_phase(
        lasso, dev, card, reset_counts, read_counts, grad_routes, 100_000,
        1024, 128)
    t_phase = phase("11 masked lasso", t_phase)

    # Phase 12: the lasso kernels' times against their twins.
    # solve_rows' fixed budget at 262,144 x 512: yah, x and z 0.5 GB each.
    lasso_stats = lasso_times(cuda_lasso, gen, dev, card, y2, a2,
                              (262_144, 512), (100_000, 1024, 128))
    lasso_stats["solve_rows_complex"] = complex_times(cuda_lasso, dev, card,
                                                      y2c, a2c)
    lasso_stats.update(wide_times(cuda_lasso, "masked_grad_rows", gen, dev,
                                  card))
    del y2c, a2c
    solve_rows_scaling(cuda_lasso, gen, dev, card)
    solve_rows_routes(cuda_lasso, gen, dev, card)
    t_phase = phase("12 lasso kernel times", t_phase)

    # Phase 13: the dictionary-learning kernels against their twins.
    # bcd_sweep: the register route at config 3's shape (its instance's
    # largest K x N), ragged shapes and a dead atom; the cluster route just
    # past it, at phase 14b's shape, at 256 x 1,024, at the TPU gate's
    # three corners and at a ragged shape, with a dead atom on each of the
    # kernel's instances (R groups of 4 columns a thread) and on each home
    # of d: 256 x 208 (R = 1, shared memory), 256 x 3,712 (R = 1, partly
    # the global scratch), 40 x 20,000 (R = 2), 16 x 50,000 (R = 4) and
    # 8 x 98,176 (R = 8), the last three partly in the scratch, R = 4 and
    # 8 with u waiting in row k; the first design (on no route) at config
    # 3's shape.
    for k_, n_, dead in ((256, 64, None), (37, 50, None), (256, 61, None),
                         (250, 64, None), (256, 64, 3), (256, 65, None),
                         (257, 64, None), (256, 208, 3), (256, 1024, None),
                         (256, 3712, 3), (8, 98176, 3), (1736, 128, None),
                         (300, 777, None), (40, 20000, 3), (16, 50000, 3)):
        compare_bcd(cuda_dl, *bcd_inputs(gen, dev, k_, n_, dead),
                    f"K={k_} N={n_}", dead)
    compare_bcd(cuda_dl, *bcd_inputs(gen, dev, 256, 64), "K=256 N=64",
                route="shared")
    compare_bcd_edges(cuda_dl, dev)
    for m_, n_, k_ in ((1000, 1000, 100), (333, 257, 7)):
        for dt in (f32, bf16):
            compare_grad(cuda_dl, "masked_grad_dict",
                         grad_inputs(gen, dev, m_, n_, k_, dt))
    # The packed route (csrc/grad_dict_packed.cu: f32 data, the mask as
    # bits): K = 100, a ragged 333 x 257 K = 7 (the KT = 64 instance; my's
    # padded copy) and log-normal my, x and d over six decades at masked
    # DL's shape; x's limbs from its split launch.
    for m_, n_, k_ in ((1000, 1000, 100), (333, 257, 7)):
        args = grad_inputs(gen, dev, m_, n_, k_, f32)
        compare_grad(cuda_dl, "masked_grad_dict", args, packed=True)
        compare_split(cuda_dl, cuda_mu, args[2])
        del args
    args = lognormal_inputs(gen, dev, 100_000, 1024, 128)
    compare_grad(cuda_dl, "masked_grad_dict", args, packed=True,
                 tag="log-normal", f64=True)
    compare_split(cuda_dl, cuda_mu, args[2])
    # The bf16 instance at phase 9's packed shapes (K % 8 != 0 at 100, 7
    # and 1: x's padded copy) and log-normal data, each also against the
    # dense-mask kernel.
    compare_grad(cuda_dl, "masked_grad_dict",
                 tuple(t.to(bf16) for t in args), packed=True,
                 tag="log-normal", f64=True, dense=True)
    del args
    for m_, n_, k_ in GRAD_PACKED_SHAPES:
        compare_grad(cuda_dl, "masked_grad_dict",
                     grad_inputs(gen, dev, m_, n_, k_, bf16), packed=True,
                     dense=True)
    # The weighted route (the weighted instances of
    # csrc/grad_dict_packed.cu), as phase 9's, each also against the first
    # design (csrc/mu_kl_stats.cu's GRAD_DICT).
    for dt in (f32, bf16):
        for m_, n_, k_ in GRAD_PACKED_SHAPES:
            compare_grad(cuda_dl, "masked_grad_dict",
                         weighted(gen, grad_inputs(gen, dev, m_, n_, k_, dt)),
                         first=True)
        args = weighted(gen, lognormal_inputs(gen, dev, 100_000, 1024, 128),
                        lognormal=True)
        compare_grad(cuda_dl, "masked_grad_dict",
                     tuple(t.to(dt) for t in args),
                     tag="log-normal, log-normal weights", f64=True,
                     first=True)
        del args
    # Above 128 atoms: the wide route, as phase 9's, and x's limbs from its
    # split launch at a ragged width and at the f32 corner.
    wide_checks(cuda_dl, "masked_grad_dict", gen, dev)
    for m_, k_ in ((333, 300), (1000, 1152)):
        compare_split(cuda_dl, cuda_mu,
                      torch.randn((m_, k_), generator=gen, device=dev))
    t_phase = phase("13 dictionary-learning kernels vs twins", t_phase)

    # Phase 14: dictionary learning at BASELINE config 3.
    launches3, c3, marg3 = config3_phase(dictionary_learning, dev, card,
                                         reset_counts, read_counts,
                                         bcd_routes)
    t_phase = phase("14 config 3", t_phase)
    launches14b = cluster_route_phase(dictionary_learning, dev, card,
                                      reset_counts, read_counts, bcd_routes)
    t_phase = phase("14b cluster sweep route", t_phase)
    launches14c = wide_dictionary_phase(dictionary_learning, dev, card,
                                        reset_counts, read_counts, bcd_routes)
    t_phase = phase("14c wide dictionary", t_phase)

    # Phase 15: masked dictionary learning.
    launches_gd, launches_gd_w, masked15 = masked_dl_phase(
        dictionary_learning, dev, card, reset_counts, read_counts,
        mask_routes, 100_000, 1024, 128)
    t_phase = phase("15 masked dictionary learning", t_phase)

    # Phase 15b: the dictionary-learning kernels' times against their twins.
    dl_stats = dl_times(cuda_dl, card, c3, marg3, launches3, masked15)
    del masked15
    dl_stats.update(wide_times(cuda_dl, "masked_grad_dict", gen, dev, card))
    t_phase = phase("15b dictionary-learning kernel times", t_phase)

    # Phase 15c: masked dictionary learning with config 3's 256 atoms at
    # phase 15's data width: every gradient on the wide route, under 'auto'
    # where its rule takes the dtype, else use_kernel=True.
    launches_wide, launches_wide_w, _ = masked_dl_phase(
        dictionary_learning, dev, card, reset_counts, read_counts,
        mask_routes, 100_000, 1024, 256, runs=WIDE_DL_RUNS,
        kernel_kw=lambda dt: ({} if lasso._auto_width(1024, 256, dt)
                              else {"use_kernel": True}), name="15c")
    t_phase = phase("15c masked dictionary learning, 256 atoms", t_phase)

    # Phase 16: NMF's HALS method.
    hals_phase(nmf, nmf_mod, dev, card, reset_counts, read_counts)
    t_phase = phase("16 HALS", t_phase)

    # Phase 17: minibatch NMF.
    minibatch_phase(nmf, nmf_mod, dev, card, reset_counts, read_counts)
    t_phase = phase("17 minibatch NMF", t_phase)

    # Phase 18: checkpointed solves on the packed mu_stats_masked and the
    # solve_rows routes.
    checkpoint_phase(nmf, lasso, cuda_mu, cuda_lasso, dev, card, y2, a2,
                     reset_counts, read_counts)
    t_phase = phase("18 checkpointed solves", t_phase)

    # Phase 19: config 5', out-of-core MU from a loader on the card.
    phase19 = config5_phase(nmf, nmf_mod, cuda_mu, dev, card, reset_counts,
                            read_counts)
    t_phase = phase("19 config 5' streaming", t_phase)

    # Phase 20: masked completion and KL-MU streaming, and the host path.
    phase20 = streaming_masked_kl_phase(nmf, nmf_mod, cuda_mu, dev, card,
                                        reset_counts, read_counts, wall4)
    t_phase = phase("20 masked and KL streaming", t_phase)

    # Phase 21: dictionary-learning streaming.
    phase21 = dl_streaming_phase(dictionary_learning, dev, card,
                                 reset_counts, read_counts, bcd_routes,
                                 grad_routes, dict_routes)
    t_phase = phase("21 dictionary-learning streaming", t_phase)

    # Phase 22: the sharded solves, a world of 1 over NCCL and a world of 2
    # over gloo on the card; then, on that world, phase 23: the sharded
    # out-of-core solvers.
    def phase23(world, tmp):
        t_23 = phase("22 sharded solves", t_phase)
        out = sharded_streaming_phase(
            nmf, nmf_mod, lasso, dictionary_learning, cuda_mu, dev, card,
            reset_counts, read_counts, world, tmp, phase19, phase20, phase21)
        t_24 = phase("23 sharded streaming", t_23)
        # Phase 24a: a sharded solve's artifact on the same world.
        shard_aot = sharded_aot(world, card)
        phase("24a sharded AOT artifact", t_24)
        return out, shard_aot

    sharded, (streamed, shard_aot) = sharded_phase(
        nmf_mod, cuda_mu, dev, card, reset_counts, read_counts, main4,
        phase6, phase23)
    del main4, phase6, phase19, phase20, phase21

    # Phase 24: solver artifacts, in this process and in a cold one.
    t_phase = time.perf_counter()
    aot_report = aot_phase(nmf, lasso, cuda_mu, cuda_lasso, dev, card,
                           build_s, reset_counts, read_counts, shard_aot)
    t_phase = phase("24 AOT artifacts", t_phase)

    bounds = {"mu_stats_dense": dense_b,
              "mu_stats_masked": stats_bound("mu_stats_masked", m4, n4, k4,
                                             bf16, f32, packed=True),
              "kl_stats_dense": stats_bound("kl_stats_dense", m7, n7, k7,
                                            f32, f32),
              "kl_stats_masked": stats_bound("kl_stats_masked", m7, n7, k7,
                                             f32, f32, packed=True)}
    stats = {"mu_stats_dense": (err_abs, kernel_ms, plain_ms),
             **{name: (errs_abs[name],) + times[name] for name in NEW_KERNELS}}
    stats = {name: s + bounds[name] for name, s in stats.items()}
    # f32 dense MU at phase 4b's shape, 262,144 x 10,112, K = 128.
    stats["mu_stats_dense_packed"] = f32_path[1:4] + f32_path[4]
    # f32 masked MU at config 4 (phase 8), launched by phase 6b.
    stats["mu_stats_masked_f32"] = (
        (errs_abs["mu_stats_masked_f32"],) + times["mu_stats_masked_f32"]
        + stats_bound("mu_stats_masked", m4, n4, k4, f32, f32, packed=True))
    stats.update(lasso_stats)
    stats.update(wide_stats)
    stats.update(dl_stats)
    stats.update(wide_rank_stats)
    main_launches = {"mu_stats_dense": launches,
                     "mu_stats_dense_packed": f32_path[0],
                     "mu_stats_masked": launches4,
                     "mu_stats_masked_f32": launches6b,
                     **kl_launches, "solve_rows": launches2,
                     "solve_rows_complex": launches2c,
                     "masked_grad_rows_packed": launches_grad[f32],
                     "masked_grad_rows_packed_bf16": launches_grad[bf16],
                     "masked_grad_rows_weighted": launches_grad_w[f32],
                     "masked_grad_rows_weighted_bf16": launches_grad_w[bf16],
                     "bcd_sweep": launches3,
                     "bcd_sweep_cluster": launches14b + launches14c,
                     "masked_grad_dict_packed": launches_gd[f32][1],
                     "masked_grad_dict_packed_bf16": launches_gd[bf16][1],
                     "masked_grad_dict_weighted": launches_gd_w[f32][1],
                     "masked_grad_dict_weighted_bf16": launches_gd_w[bf16][1]}
    main_launches.update(wide_rank_launches)
    main_launches.update(wide_launches)
    for which, runs_ in (("", launches_wide), ("_weighted", launches_wide_w)):
        for dt, (rows_n, dict_n) in runs_.items():
            sfx = f"_wide{which}{'' if dt == f32 else '_bf16'}"
            main_launches[f"masked_grad_rows{sfx}"] = rows_n
            main_launches[f"masked_grad_dict{sfx}"] = dict_n
    kernels = {"mu_stats_dense": ("mu_dense_tma", "pallas_mu.py:438"),
               "mu_stats_dense_packed": ("mu_dense_packed",
                                         "pallas_mu.py:438"),
               **{name: (src, rep) for name, (src, _, rep)
                  in NEW_KERNELS.items()},
               "mu_stats_masked_f32": ("mu_masked_f32", "pallas_mu.py:522"),
               "solve_rows": ("lasso_fista_tma", "pallas_fista.py:349"),
               "solve_rows_complex": ("lasso_fista_tma",
                                      "pallas_fista.py:349 (group_fc)"),
               "solve_rows_wide": ("lasso_fista_wide", "pallas_fista.py:349"),
               "solve_rows_wide_complex": ("lasso_fista_wide",
                                           "pallas_fista.py:349 (group_fc)"),
               **{f"masked_grad_rows_{r}": ("lasso_grad_packed",
                                            "pallas_lasso.py:159")
                  for r in ("packed", "packed_bf16", "weighted",
                            "weighted_bf16")},
               "bcd_sweep": ("dl_bcd_sm90", "pallas_bcd.py:115"),
               "bcd_sweep_cluster": ("dl_bcd_cluster", "pallas_bcd.py:115"),
               **{f"masked_grad_dict_{r}": ("grad_dict_packed",
                                            "pallas_lasso.py:225")
                  for r in ("packed", "packed_bf16", "weighted",
                            "weighted_bf16")},
               **{f"{g_}_{r}": ("grad_wide", rep_) for g_, rep_ in (
                   ("masked_grad_rows", "pallas_lasso.py:159"),
                   ("masked_grad_dict", "pallas_lasso.py:225"))
                  for r in ("wide", "wide_bf16", "wide_weighted",
                            "wide_weighted_bf16")},
               **{f"{name}{r}": ("mu_wide", rep_) for name, rep_, rs in (
                   ("mu_stats_dense_wide", "pallas_mu.py:438", ("", "_bf16")),
                   ("mu_stats_masked_wide", "pallas_mu.py:522",
                    ("", "_bf16", "_weighted", "_weighted_bf16")),
                   ("kl_stats_dense_wide", "pallas_mu.py:603", ("", "_bf16")),
                   ("kl_stats_masked_wide", "pallas_mu.py:678",
                    ("", "_bf16", "_weighted", "_weighted_bf16")))
                  for r in rs}}
    entries = []
    for name, (source, replaces) in kernels.items():
        err, ms, p_ms, b_ms, b_by = stats[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"decomp_tpu_torch/csrc/{source}.cu",
            "replaces": f"decomp_tpu/ops/{replaces}",
            "launches": main_launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            # No one PyTorch call computes any of these functions.
            "library_ms": None,
        })
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"sharded_streaming": streamed}))
    print(json.dumps({"aot": aot_report}))
    print(card, flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
