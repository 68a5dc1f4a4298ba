#!/usr/bin/env python3
"""Smoke test of the PyTorch port (decomp_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``decomp_tpu_torch/csrc`` with nvcc
for sm_90a (one nvcc per source, all at once), and then:

1. prints the card's name and power limit (nvidia-smi), the build time
   and ptxas' register-spill report;
2. holds the kernel ``mu_stats_dense`` against its plain PyTorch twin on
   the card (bf16 data with f32 factors, and f32 data; ragged and
   full-width shapes) and checks that two runs give the same bits;
3. holds ``mu_stats_masked``, ``kl_stats_dense`` and ``kl_stats_masked``
   against their twins the same way, at 1000 x 1000 K = 100,
   100,000 x 1,000 K = 50 and 65,536 x 10,112 K = 128;
4. drives the dense main path, ``decomp_tpu_torch.nmf.solve`` on a
   1,048,576 x 10,112 bf16 matrix at rank 128 with f32 factors, 20
   iterations, and checks that every iteration went through the kernel,
   that the factors are finite and nonnegative and that the
   reconstruction error fell; it times the solve and one kernel call
   against one twin call;
5. solves a planted rank-10 problem to convergence and restarts from it;
6. drives masked completion at BASELINE config 4,
   ``nmf.masked_completion`` on a planted 100,000 x 1,000 rank-50 matrix
   with 30% missing (bf16 data, f32 factors, held-out stopping), and
   checks one ``mu_stats_masked`` launch per iteration, convergence, the
   held-out error and the factors;
7. drives KL-MU, ``nmf.solve(method='kl-mu')`` at 100,000 x 1,024 rank
   128 f32, dense and masked, 20 iterations each, and checks one kernel
   launch per iteration and a falling KL objective;
8. times each new kernel against its twin per call at its path's shape
   (and masked MU also at 262,144 x 10,112 K = 128 bf16).

Each path runs with every launch count set to 0 just before it and read
just after. It exits non-zero on any failure, without a CUDA device, and
where the package is absent. The line before the last is a JSON summary
of the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import json
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
EPS = 1e-6
SOURCES = ("mu_stats_dense", "mu_kl_stats")
# name -> (source, masked, the TPU kernel it replaces)
NEW_KERNELS = {
    "mu_stats_masked": ("mu_kl_stats", True, "pallas_mu.py:522"),
    "kl_stats_dense": ("mu_kl_stats", False, "pallas_mu.py:603"),
    "kl_stats_masked": ("mu_kl_stats", True, "pallas_mu.py:678"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_fro(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def max_abs(outs, refs):
    return max(float((a.double() - b.double()).abs().max())
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
    y = torch.rand((m, n), generator=gen, device=dev, dtype=ydt)
    x = 0.1 + torch.rand((m, k), generator=gen, device=dev, dtype=xdt)
    d = 0.1 + torch.rand((k, n), generator=gen, device=dev, dtype=ydt)
    out = cuda_mu.mu_stats_dense(y, x, d, EPS, inner_iter=inner)
    again = cuda_mu.mu_stats_dense(y, x, d, EPS, inner_iter=inner)
    ref = cuda_mu.mu_stats_dense_plain(y, x, d, EPS, inner_iter=inner)
    torch.cuda.synchronize()
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    tag = (f"{m}x{n} K={k} inner={inner} y={str(ydt)[6:]} "
           f"x={str(xdt)[6:]}")
    print(f"kernel vs twin {tag}: rel_fro x_new={errs[0]:.3e} "
          f"numd={errs[1]:.3e} gram={errs[2]:.3e} (limit {LIMIT[ydt]:.0e}); "
          f"bit-identical rerun: {same}", flush=True)
    check(all(np.isfinite(errs)), f"{tag}: non-finite outputs")
    check(max(errs) <= LIMIT[ydt], f"{tag}: kernel disagrees with twin")
    check(same, f"{tag}: two kernel runs differ")
    return errs


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


def compare_new(cuda_mu, name, args):
    """One of the masked-MU / KL kernels against its twin on ``args``;
    returns the outputs' max abs error."""
    wrapper = getattr(cuda_mu, name)
    out = wrapper(*args, EPS)
    again = wrapper(*args, EPS)
    ref = getattr(cuda_mu, f"{name}_plain")(*args, EPS)
    torch.cuda.synchronize()
    my, x = args[0], args[-2]
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    limits = [X_BF16_LIMIT if x.dtype == torch.bfloat16 else LIMIT[my.dtype]]
    limits += [LIMIT[my.dtype]] * 2
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    tag = (f"{name} {my.shape[0]}x{my.shape[1]} K={x.shape[1]} "
           f"data={str(my.dtype)[6:]} x={str(x.dtype)[6:]}")
    print(f"kernel vs twin {tag}: rel_fro " + " ".join(
        f"{e:.3e} (limit {lim:.0e})" for e, lim in zip(errs, limits))
        + f"; bit-identical rerun: {same}", flush=True)
    check(all(np.isfinite(errs)), f"{tag}: non-finite outputs")
    check(all(e <= lim for e, lim in zip(errs, limits)),
          f"{tag}: kernel disagrees with twin")
    check(same, f"{tag}: two kernel runs differ")
    return max_abs(out, ref)


def time_new(cuda_mu, name, args, reps=5):
    """Per-call ms of a kernel and of its twin, with CUDA events."""
    kernel_ms = cuda_ms(lambda: getattr(cuda_mu, name)(*args, EPS), reps)
    plain_ms = cuda_ms(
        lambda: getattr(cuda_mu, f"{name}_plain")(*args, EPS), 2)
    return kernel_ms, plain_ms


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from decomp_tpu_torch import nmf
    from decomp_tpu_torch.models import nmf as nmf_mod
    from decomp_tpu_torch.ops import _build, cuda_mu

    check("jax" not in sys.modules, "the port imported jax")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled; the f32 products must be full f32")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wrappers = [getattr(cuda_mu, n)
                for n in ("mu_stats_dense", *NEW_KERNELS)]

    def reset_counts():
        for w in wrappers:
            w.launches = 0

    def read_counts(expected, launches):
        """The counts after one path: ``expected`` launched ``launches``
        times, every other kernel not at all."""
        got = {w.__name__: w.launches for w in wrappers}
        want = {w.__name__: 0 for w in wrappers}
        want[expected] = launches
        check(got == want, f"kernel launches {got}, expected {want}")
        return launches

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
    print(f"both sources built in parallel in {build_s:.1f} s (0 s = "
          f"already built); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t_phase = phase("1 build", t_phase)

    # Phase 2: the dense kernel against its twin on the card.
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    for inner in (1, 3):
        compare(cuda_mu, gen, dev, 1000, 1000, 100, inner, bf16, f32)
        compare(cuda_mu, gen, dev, 1000, 1000, 100, inner, f32, f32)
    compare(cuda_mu, gen, dev, 1000, 1000, 100, 1, bf16, bf16)
    compare(cuda_mu, gen, dev, 65536, 10112, 128, 1, bf16, f32)
    compare(cuda_mu, gen, dev, 65536, 10112, 128, 1, f32, f32)
    t_phase = phase("2 dense kernel vs twin", t_phase)

    # Phase 3: the masked-MU and KL kernels against their twins.
    variants = {"mu_stats_masked": [(bf16, f32), (bf16, bf16), (f32, f32)],
                "kl_stats_dense": [(bf16, bf16), (f32, f32)],
                "kl_stats_masked": [(bf16, bf16), (f32, f32)]}
    for m, n, k in ((1000, 1000, 100), (100_000, 1000, 50),
                    (65536, 10112, 128)):
        for name, dts in variants.items():
            for ydt, xdt in dts:
                args = stats_inputs(gen, dev, m, n, k, ydt, xdt,
                                    NEW_KERNELS[name][1])
                compare_new(cuda_mu, name, args)
                del args
    t_phase = phase("3 masked-MU and KL kernels vs twins", t_phase)

    # Phase 4: the dense main path at the real size.
    m, n, k, iters = 1 << 20, 10112, 128, 20
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.rand((m, n), generator=g, device=dev, dtype=bf16)
    # The factors solve(random_seed=0) starts from: same seed, same draws.
    d0, x0 = nmf_mod._init_factors(torch.Generator(device=dev).manual_seed(0),
                                   y, None, None, k, f32)
    # One mu_stats_dense call of the kernel against the twin at this shape.
    out = cuda_mu.mu_stats_dense(y, x0, d0.to(bf16), EPS)
    ref = cuda_mu.mu_stats_dense_plain(y, x0, d0.to(bf16), EPS)
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    err_abs = max_abs(out, ref)
    check(max(errs) <= LIMIT[bf16], f"main-path shape: kernel disagrees "
          f"with twin {errs}")
    del out, ref
    kernel_ms = cuda_ms(lambda: cuda_mu.mu_stats_dense(
        y, x0, d0.to(bf16), EPS), 5)
    plain_ms = cuda_ms(lambda: cuda_mu.mu_stats_dense_plain(
        y, x0, d0.to(bf16), EPS), 2)
    print(f"mu_stats_dense {m}x{n} K={k} bf16 y, f32 x: kernel "
          f"{kernel_ms:.3f} ms, plain twin {plain_ms:.3f} ms per call "
          f"({card}); rel_fro x_new={errs[0]:.3e} numd={errs[1]:.3e} "
          f"gram={errs[2]:.3e}, max_abs_err={err_abs:.3e}", flush=True)

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
          f"launches {launches}; sampled relative reconstruction error "
          f"{err0:.4f} -> {err1:.4f}; peak device memory {peak_gb:.1f} GB",
          flush=True)
    del res, y, ys
    t_phase = phase("4 dense main path", t_phase)

    # Phase 5: a converging run (planted rank 10, 1% noise) and a restart.
    rng = np.random.default_rng(0)
    xt, dt = rng.uniform(0, 1, (1000, 10)), rng.uniform(0, 1, (10, 500))
    yp = np.maximum(xt @ dt + 0.01 * rng.normal(size=(1000, 500)), 0.0)
    yp = torch.from_numpy(yp.astype(np.float32)).to(dev)
    before = cuda_mu.mu_stats_dense.launches
    t0 = time.perf_counter()
    res = nmf.solve(yp, rank=10, tol=1e-4, maxiter=4000)
    wall = time.perf_counter() - t0
    err = float(torch.linalg.vector_norm(yp - res.x @ res.d)
                / torch.linalg.vector_norm(yp))
    warm = nmf.solve(yp, res.d, x=res.x, tol=1e-4, maxiter=4000)
    print(f"planted 1000x500 rank 10 f32: converged={res.converged} in "
          f"{res.niter} iterations ({wall:.2f} s), relative error {err:.4f}; "
          f"warm restart {warm.niter} iterations; kernel launches "
          f"{cuda_mu.mu_stats_dense.launches - before}", flush=True)
    check(res.converged, "planted run did not converge")
    check(err <= 2e-2, f"planted relative error {err} > 2e-2")
    check(warm.niter <= 3, f"warm restart took {warm.niter} iterations")
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
          f"{true_err:.4e}; mu_stats_masked launches {launches4}",
          flush=True)
    check(res.converged, "masked completion did not converge")
    check(ho < 5e-2, f"held-out relative error {ho} >= 5e-2")
    check(res.x.dtype == f32 and res.d.dtype == f32, "factor dtypes")
    for name, t in (("x", res.x), ("d", res.d)):
        check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
        check(bool((t >= 0).all()), f"{name} has negative values")
    del res, y4, ym4, miss
    t_phase = phase("6 masked completion", t_phase)

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
        kl_s = e0.elapsed_time(e1) / 1e3
        obj1 = float(nmf_mod._kl_objective(my7, res.x, res.d, mk, eps7))
        print(f"KL-MU nmf.solve(method='kl-mu') {m7}x{n7} rank {k7} f32, "
              f"{'masked 30% missing' if mk is not None else 'dense'}: "
              f"{iters} iterations in {kl_s:.3f} s = {iters / kl_s:.3f} "
              f"iters/s ({card}); KL objective {obj0:.6e} -> {obj1:.6e}; "
              f"{name} launches {kl_launches[name]}", flush=True)
        check(res.niter == iters, f"niter {res.niter} != {iters}")
        check(np.isfinite(obj1) and obj1 < obj0,
              f"KL objective did not fall: {obj0} -> {obj1}")
        del res, my7
    t_phase = phase("7 KL-MU", t_phase)

    # Phase 8: each new kernel against its twin, per call, at its path's
    # shape; masked MU also at 262,144 x 10,112 K = 128 bf16 (comparable
    # with the dense row above).
    shapes = {"mu_stats_masked": (m4, n4, k4, bf16, f32),
              "kl_stats_dense": (m7, n7, k7, f32, f32),
              "kl_stats_masked": (m7, n7, k7, f32, f32)}
    times, errs_abs = {}, {}
    for name, (m_, n_, k_, ydt, xdt) in shapes.items():
        args = stats_inputs(gen, dev, m_, n_, k_, ydt, xdt,
                            NEW_KERNELS[name][1])
        errs_abs[name] = compare_new(cuda_mu, name, args)
        times[name] = time_new(cuda_mu, name, args)
        print(f"{name} {m_}x{n_} K={k_} data={str(ydt)[6:]} "
              f"x={str(xdt)[6:]}: kernel {times[name][0]:.3f} ms, plain twin "
              f"{times[name][1]:.3f} ms per call ({card}); max_abs_err "
              f"{errs_abs[name]:.3e}", flush=True)
        del args
    args = stats_inputs(gen, dev, 262_144, 10112, 128, bf16, f32, True)
    wide_ms = time_new(cuda_mu, "mu_stats_masked", args)
    print(f"mu_stats_masked 262144x10112 K=128 data=bfloat16 x=float32: "
          f"kernel {wide_ms[0]:.3f} ms, plain twin {wide_ms[1]:.3f} ms per "
          f"call ({card})", flush=True)
    del args
    phase("8 kernel times", t_phase)

    main_launches = {"mu_stats_masked": launches4, **kl_launches}
    entries = [{
        "name": "mu_stats_dense",
        "route": "cuda",
        "source": "decomp_tpu_torch/csrc/mu_stats_dense.cu",
        "replaces": "decomp_tpu/ops/pallas_mu.py:438",
        "launches": launches,
        "max_abs_err": err_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]
    for name, (source, _, replaces) in NEW_KERNELS.items():
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"decomp_tpu_torch/csrc/{source}.cu",
            "replaces": f"decomp_tpu/ops/{replaces}",
            "launches": main_launches[name],
            "max_abs_err": errs_abs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
