#!/usr/bin/env python3
"""Smoke test of the PyTorch port (decomp_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``decomp_tpu_torch/csrc`` with nvcc
for sm_90a, and then:

1. prints the card's name and power limit (nvidia-smi) and the build time;
2. holds the kernel ``mu_stats_dense`` against its plain PyTorch twin on
   the card (bf16 data with f32 factors, and f32 data; ragged and
   full-width shapes) and checks that two runs give the same bits;
3. drives the main path, ``decomp_tpu_torch.nmf.solve`` on a 1,048,576 x
   10,112 bf16 matrix at rank 128 with f32 factors, 20 iterations, and
   checks that every iteration went through the kernel, that the factors
   are finite and nonnegative and that the reconstruction error fell; it
   times the solve and one kernel call against one twin call;
4. solves a planted rank-10 problem to convergence and restarts from it.

It exits non-zero on any failure, without a CUDA device, and where the
package is absent. The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

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
EPS = 1e-6


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

    # Phase 1: the card, and the kernel built from the checkout.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build("mu_stats_dense")
    _build.load("mu_stats_dense")
    build_s = time.perf_counter() - t0
    ptxas = open(str(lib_path) + ".log").read()
    spills = [ln.strip() for ln in ptxas.splitlines() if "spill stores" in ln
              and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"built decomp_tpu_torch/csrc/mu_stats_dense.cu with nvcc for "
          f"sm_90a in {build_s:.1f} s (0 s = already built); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"register spills: {spills or 'none'}", flush=True)

    # Phase 2: kernel against twin on the card.
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    for inner in (1, 3):
        compare(cuda_mu, gen, dev, 1000, 1000, 100, inner, bf16, f32)
        compare(cuda_mu, gen, dev, 1000, 1000, 100, inner, f32, f32)
    compare(cuda_mu, gen, dev, 1000, 1000, 100, 1, bf16, bf16)
    compare(cuda_mu, gen, dev, 65536, 10112, 128, 1, bf16, f32)
    compare(cuda_mu, gen, dev, 65536, 10112, 128, 1, f32, f32)

    # Phase 3: the main path at the real size.
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
    cuda_mu.mu_stats_dense.launches = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = nmf.solve(y, maxiter=iters, **kw)
    e1.record()
    torch.cuda.synchronize()
    launches = cuda_mu.mu_stats_dense.launches
    solve_s = e0.elapsed_time(e1) / 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(launches == iters, f"{launches} kernel launches in {iters} "
          "iterations of the main path")
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

    # Phase 4: a converging run (planted rank 10, 1% noise) and a restart.
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

    print(json.dumps({"kernels": [{
        "name": "mu_stats_dense",
        "route": "cuda",
        "source": "decomp_tpu_torch/csrc/mu_stats_dense.cu",
        "replaces": "decomp_tpu/ops/pallas_mu.py:438",
        "launches": launches,
        "max_abs_err": err_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
