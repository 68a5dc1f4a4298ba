"""Split one dictionary sweep (``bcd_sweep``) into its steps per atom with
``clock64`` counters, for both of its kernels, at BASELINE config 3's
statistics on one CUDA card, and time the two kernels in turns.

The sweep's K atoms run strictly in order, so its time is K times the
latency of one atom. The script builds, in the package's gitignored build
directory under ``_build/steps/``:
  - a counter-instrumented copy of ``csrc/dl_bcd.cu`` (text edits to the
    source that assert that they apply), whose lane 0 of each warp sums
    the cycles per atom of
      (0) issuing the copy of the next rows of A and B;
      (a) the column products and their butterflies of shuffles;
      (b) the first barrier, the sum of the warp partials and the sqrt;
      (c) the division and the row write;
      (d) the wait on the row copy and the second barrier;
  - ``csrc/dl_bcd_sm90.cu`` built with ``-DBCD_STEP_CLOCKS``, whose lane 0
    of each warp sums the cycles per atom of
      (0) the refill issue and the ring wait, once per 8 atoms;
      (a) u, u^2, the partial's write and the arrival on the exchange;
      (b) the next atom's loads, products and column sums (the
          reduce-scatter of shuffles and the gather);
      (c) the wait on the exchange;
      (d) the 16-partial sum;
      (e) the sqrt;
      (f) the division, the update and the next atom's deferred term.

The statistics are config 3's final ones: ``dictionary_learning.solve`` on
bench.py's 20,000 x 64 patches, 256 atoms, 60 outer x 15 inner iterations
('high'), then A = x^T x, B = x^T y and the swept d. Cycles are converted
to microseconds with the clock each instrumented launch ran at (its
cycles over its CUDA-event time). Before that, the register route is held
against the plain twin (relative Frobenius, ``chip_smoke.BCD_LIMIT``) with
a bit-identical rerun at a few shapes, and after it both kernels are timed
in turns on the same inputs (old, new, new, old; CUDA events, 20 sweeps
each).

The design variants of ``csrc/dl_bcd_sm90.cu`` in ``VARIANTS`` (text
edits to the source) and any other version of that source named with
``--other`` (e.g. a ``git show`` of an earlier commit's file under the
gitignored ``.chip_scratch/``) are built beside it and timed in turns with
it on config 3's statistics (source, variant, variant, source), with
whether they give the source's bits.

Run from the repository root on the card's machine:

    python3 tools/bcd_steps.py [--other FILE ...]
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from decomp_tpu_torch.ops import _build, cuda_dl  # noqa: E402

STEPS = ("(0) copy issue", "(a) products + butterflies",
         "(b) barrier 1 + partial sum + sqrt", "(c) division + row write",
         "(d) copy wait + barrier 2")
NEW_STEPS = ("(0) refill issue + ring wait",
             "(a) u, u^2, partial write + arrive",
             "(b) next loads, products, shuffles", "(c) exchange wait",
             "(d) 16-partial sum", "(e) sqrt",
             "(f) division, update, next term")

_OLD_LOOP = """  for (int k = 0; k < K; ++k) {
    const float* a = rows + (k & 1) * (K + N);
    const float* b = a + K;
    if (k + 1 < K) fetch_rows(rows + ((k + 1) & 1) * (K + N), A, B, K, N,
                              k + 1);
    const float akk = a[k];"""
_OLD_LOOP_CLK = """  long long acc[5] = {0, 0, 0, 0, 0};
  const long long t_start = clk64();
  for (int k = 0; k < K; ++k) {
    long long t0 = clk64();
    const float* a = rows + (k & 1) * (K + N);
    const float* b = a + K;
    if (k + 1 < K) fetch_rows(rows + ((k + 1) & 1) * (K + N), A, B, K, N,
                              k + 1);
    long long t1 = clk64();
    acc[0] += t1 - t0;
    const float akk = a[k];"""
_OLD_STEPS = [
    ("    if (lane == 0) part[warp] = sq;\n    __syncthreads();\n",
     "    if (lane == 0) part[warp] = sq;\n    long long t2 = clk64();\n"
     "    acc[1] += t2 - t1;\n    __syncthreads();\n"),
    ("    const float norm = __fsqrt_rn(ss);\n",
     "    const float norm = __fsqrt_rn(ss);\n    long long t3 = clk64();\n"
     "    acc[2] += t3 - t2;\n"),
    ("    asm volatile(\"cp.async.wait_all;\\n\" ::);\n    __syncthreads();\n"
     "  }\n",
     "    long long t4 = clk64();\n    acc[3] += t4 - t3;\n"
     "    asm volatile(\"cp.async.wait_all;\\n\" ::);\n    __syncthreads();\n"
     "    acc[4] += clk64() - t4;\n  }\n"
     "  if (lane == 0)\n    for (int i = 0; i < 5; ++i) clk[warp * 5 + i] = "
     "acc[i];\n  if (threadIdx.x == 0) clk[WARPS * 5] = clk64() - t_start;\n"),
    ("int ld,\n                     float* __restrict__ dout) {",
     "int ld,\n                     float* __restrict__ dout,\n"
     "                     long long* __restrict__ clk) {"),
    ("int K, int N, void* dout, void* stream) {",
     "int K, int N, void* dout, void* clk,\n"
     "                                void* stream) {"),
    ("N | 1, static_cast<float*>(dout));",
     "N | 1, static_cast<float*>(dout),\n"
     "      static_cast<long long*>(clk));"),
    ("namespace {\n",
     "namespace {\n\n__device__ __forceinline__ long long clk64() {\n"
     "  long long t;\n  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) "
     ":: \"memory\");\n  return t;\n}\n"),
]


# Design variants of csrc/dl_bcd_sm90.cu, each a list of text edits to
# the source: name -> (timing only, [(old, new)]). Timing-only variants
# change the result on purpose, to show what a part costs; the others must
# give the source's bits.
_DIV4 = "      div4_rn(u, fmaxf(norm, FLT_MIN), owner);\n"
VARIANTS = {
    # Each quotient by __fdiv_rn, with its branch to a slow path.
    "fdiv": (False, [(_DIV4, "      for (int c = 0; c < 4; ++c) u[c] = "
                             "__fdiv_rn(u[c], fmaxf(norm, FLT_MIN));\n")]),
    "no_sqrt": (True, [("__fsqrt_rn(ss)", "ss")]),
    "no_div": (True, [(_DIV4, "")]),
    "no_gather": (True, [("s[c] = __shfl_sync(~0u, t, 8 * c);",
                          "s[c] = t;")]),
    # Timing only: the quotients' slow path (below FLT_MIN) left out.
    "no_slow": (True, [("  if (__any_sync(~0u, slow)) {\n#pragma unroll\n"
                        "    for (int c = 0; c < 4; ++c) q[c] = "
                        "div_f64(u[c], den);\n  }\n", "")]),
    # The slow path by __fdiv_rn, behind a branch of the lane.
    "fdiv_slow": (False, [("  if (__any_sync(~0u, slow)) {\n#pragma unroll\n"
                           "    for (int c = 0; c < 4; ++c) q[c] = "
                           "div_f64(u[c], den);\n",
                           "  if (slow) {\n#pragma unroll\n"
                           "    for (int c = 0; c < 4; ++c) q[c] = "
                           "__fdiv_rn(u[c], den);\n")]),
    # Every quotient by div_f64, with no branch at all.
    "div_f64": (False, [(_DIV4, "      for (int c = 0; c < 4; ++c) u[c] = "
                                "div_f64(u[c], fmaxf(norm, FLT_MIN));\n")]),
}


def edit(src, old, new):
    assert src.count(old) == 1, f"edit does not apply: {old[:60]!r}"
    return src.replace(old, new)


def old_steps_source():
    src = (_build.SRC_DIR / "dl_bcd.cu").read_text()
    src = edit(src, _OLD_LOOP, _OLD_LOOP_CLK)
    for old, new in _OLD_STEPS:
        src = edit(src, old, new)
    return src


def build(name, src, flags=()):
    """Compile ``src`` with the package's flags into _build/steps/."""
    import ctypes

    out_dir = _build.BUILD_DIR / "steps"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
                           str(_build.SRC_DIR), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    spills = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "spill" in ln or "registers" in ln]
    print(f"built {name}: {spills}", flush=True)
    return ctypes.CDLL(str(so))


def config3_statistics(dev):
    """Config 3's final (A, B, d) on the card (chip_smoke.py's data)."""
    import chip_smoke
    from decomp_tpu_torch import dictionary_learning as dl

    y_np, d0_np = chip_smoke.config3_data()
    y, d0 = (torch.from_numpy(v).to(dev) for v in (y_np, d0_np))
    res = dl.solve(y, d0, 0.05, tol=1e-5, maxiter=60, lasso_iter=15,
                   precision="high")
    x = res.x
    return x.T @ x, x.T @ y, res.d.contiguous()


def event_ms(fn, reps=1):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def report(tag, clk, warps, k, launch_ms, steps=STEPS):
    """Print the per-atom split of one instrumented launch: ``clk`` holds
    len(steps) sums per warp, then the launch's total cycles."""
    per = clk[:warps * len(steps)].reshape(warps, len(steps)) / k
    total = float(clk[warps * len(steps)])
    ghz = total / (launch_ms * 1e6)
    print(f"{tag}: {total / k:.0f} cycles per atom of thread 0, "
          f"{launch_ms * 1e3 / k:.3f} us per atom by CUDA events, clock "
          f"{ghz:.3f} GHz (cycles / event time)", flush=True)
    for i, name in enumerate(steps):
        col = per[:, i]
        print(f"  {name:38s} warp 0 {col[0]:7.0f}  mean {col.mean():7.0f}  "
              f"min {col.min():7.0f}  max {col.max():7.0f} cycles  "
              f"({col.mean() / ghz / 1e3:.3f} us)", flush=True)
    return per, ghz


def c_fn(lib, name, nints, nptrs):
    import ctypes

    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * nints
                   + [ctypes.c_void_p] * nptrs)
    return fn


def check_route(card, dev):
    """The register route against the twin, with a bit-identical rerun."""
    import chip_smoke

    gen = torch.Generator(device=dev).manual_seed(14)
    for k, n, dead in ((256, 64, None), (256, 64, 5), (37, 50, None),
                       (1, 1, None), (5, 3, None), (256, 61, None),
                       (250, 64, None), (32, 64, None), (200, 16, 0)):
        a, b, d = chip_smoke.bcd_inputs(gen, dev, k, n, dead)
        assert cuda_dl.bcd_route(k, n) == "registers"
        before = cuda_dl.bcd_sweep.register_launches
        out, again = cuda_dl.bcd_sweep(a, b, d), cuda_dl.bcd_sweep(a, b, d)
        ref = cuda_dl.bcd_sweep_plain(a, b, d)
        torch.cuda.synchronize()
        print(f"register route K={k} N={n} dead={dead}: rel_fro "
              f"{chip_smoke.rel_fro(out, ref):.3e} (limit "
              f"{chip_smoke.BCD_LIMIT:g}); rerun bit-identical "
              f"{torch.equal(out, again)}; dead atom kept "
              f"{dead is None or torch.equal(out[dead], d[dead])}; launches "
              f"{cuda_dl.bcd_sweep.register_launches - before}", flush=True)


def variants(card, dev, a, b, d, built):
    """Each variant against the source on config 3's statistics: its bits,
    and its time in turns (source, variant, variant, source)."""
    import chip_smoke

    k, n = d.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    src = cuda_dl._bcd_registers_launch(a, b, d)
    # A second input: random statistics with a dead atom.
    a2, b2, d2 = chip_smoke.bcd_inputs(
        torch.Generator(device=dev).manual_seed(7), dev, k, n, 3)
    src2 = cuda_dl._bcd_registers_launch(a2, b2, d2)
    for name, lib in built.items():
        fn = c_fn(lib, "bcd_sweep_sm90_launch", 4, 2)
        out = torch.empty_like(d)

        def run(a=a, b=b, d=d):
            err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), k, n, k, n,
                     out.data_ptr(), stream)
            assert err == 0, f"cudaError {err}"

        run(a2, b2, d2)
        torch.cuda.synchronize()
        same = torch.equal(out, src2)
        run()
        torch.cuda.synchronize()
        same = same and torch.equal(out, src)
        t = [event_ms(lambda: cuda_dl._bcd_registers_launch(a, b, d), 20),
             event_ms(run, 20), event_ms(run, 20),
             event_ms(lambda: cuda_dl._bcd_registers_launch(a, b, d), 20)]
        v_ms, s_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        only = name in VARIANTS and VARIANTS[name][0]
        print(f"variant {name}{' (timing only)' if only else ''}"
              f": {v_ms:.4f} ms per sweep ({v_ms * 1e3 / k:.3f} us per atom) "
              f"against the source's {s_ms:.4f} ms ({s_ms * 1e3 / k:.3f}) in "
              f"turns, variant / source {v_ms / s_ms:.3f}; source's bits: "
              f"{same}, rel_fro vs the source {chip_smoke.rel_fro(out, src):.3e}"
              f" ({card})", flush=True)


def main():
    import chip_smoke

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(12) as pool:
        jobs = [pool.submit(build, "dl_bcd_steps", old_steps_source()),
                pool.submit(build, "dl_bcd_sm90_steps",
                            (_build.SRC_DIR / "dl_bcd_sm90.cu").read_text(),
                            ("-DBCD_STEP_CLOCKS",)),
                pool.submit(_build.build, "dl_bcd_sm90"),
                pool.submit(_build.build, "dl_bcd")]
        src = (_build.SRC_DIR / "dl_bcd_sm90.cu").read_text()
        vjobs = {}
        for name, (_, edits) in VARIANTS.items():
            v = src
            for o, n_ in edits:
                v = edit(v, o, n_)
            vjobs[name] = pool.submit(build, f"dl_bcd_sm90_{name}", v)
        others = sys.argv[sys.argv.index("--other") + 1:] \
            if "--other" in sys.argv else []
        for i, path in enumerate(others):
            vjobs[path] = pool.submit(build, f"dl_bcd_sm90_other{i}",
                                      open(path).read())
        built = {name: j.result() for name, j in vjobs.items()}
        old, new = jobs[0].result(), jobs[1].result()
        for j in jobs[2:]:
            print(open(str(j.result()) + ".log").read().strip()
                  .splitlines()[-1], flush=True)
    check_route(card, dev)
    chip_smoke.compare_bcd_edges(cuda_dl, dev)
    old_fn = c_fn(old, "bcd_sweep_launch", 2, 3)
    new_fn = c_fn(new, "bcd_sweep_sm90_clocks", 4, 3)
    a, b, d = config3_statistics(dev)
    k, n = d.shape
    out = torch.empty_like(d)
    warps = 16
    clk = torch.zeros(warps * max(len(STEPS), len(NEW_STEPS)) + 1,
                      dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch_old():
        err = old_fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), k, n,
                     out.data_ptr(), clk.data_ptr(), stream)
        assert err == 0, f"cudaError {err}"

    def launch_new():
        err = new_fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), k, n, k, n,
                     out.data_ptr(), clk.data_ptr(), stream)
        assert err == 0, f"cudaError {err}"

    for tag, launch, ref_fn, steps in (
            ("dl_bcd.cu", launch_old, cuda_dl._bcd_shared_launch, STEPS),
            ("dl_bcd_sm90.cu", launch_new, cuda_dl._bcd_registers_launch,
             NEW_STEPS)):
        launch()
        torch.cuda.synchronize()
        ref = ref_fn(a, b, d)
        print(f"instrumented {tag} equals the kernel bit for bit: "
              f"{torch.equal(out, ref)}", flush=True)
        for _ in range(3):
            ms = event_ms(launch)
            report(f"{tag} at config 3 (K={k}, N={n}), instrumented",
                   clk.cpu().numpy().astype(np.float64), warps, k, ms, steps)
    variants(card, dev, a, b, d, built)
    twin = cuda_dl.bcd_sweep_plain(a, b, d)
    new_out = cuda_dl._bcd_registers_launch(a, b, d)
    old_out = cuda_dl._bcd_shared_launch(a, b, d)
    import chip_smoke

    print(f"config 3's statistics: rel_fro vs twin: new "
          f"{chip_smoke.rel_fro(new_out, twin):.3e}, old "
          f"{chip_smoke.rel_fro(old_out, twin):.3e}", flush=True)
    t = [event_ms(lambda: cuda_dl._bcd_shared_launch(a, b, d), 20),
         event_ms(lambda: cuda_dl._bcd_registers_launch(a, b, d), 20),
         event_ms(lambda: cuda_dl._bcd_registers_launch(a, b, d), 20),
         event_ms(lambda: cuda_dl._bcd_shared_launch(a, b, d), 20)]
    new_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    print(f"in turns at config 3 (K={k}, N={n}): dl_bcd_sm90.cu "
          f"{new_ms:.4f} ms per sweep ({t[1]:.4f}, {t[2]:.4f}; "
          f"{new_ms * 1e3 / k:.3f} us per atom), dl_bcd.cu {old_ms:.4f} ms "
          f"({t[0]:.4f}, {t[3]:.4f}; {old_ms * 1e3 / k:.3f} us per atom); "
          f"new / old {new_ms / old_ms:.3f} ({card})", flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
