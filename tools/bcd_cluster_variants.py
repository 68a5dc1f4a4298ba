"""Split one sweep of ``bcd_sweep``'s cluster route
(``csrc/dl_bcd_cluster.cu``) into its steps per atom with ``clock64``
counters, and time design variants of the source in turns with it, on one
CUDA card.

Everything is built from text edits to the source (each edit asserts that
it applies) into the package's gitignored build directory under
``_build/cluster_variants/``:
  - ``clocks``: lane 0 of every warp of every block sums the cycles per
    atom of the steps in ``STEPS`` (each read after the step's last value
    is ready), and its launch's total;
  - the variants of ``VARIANTS``, each of which must give the source's
    bits, timed in turns with the source (source, variant, variant,
    source; CUDA events, ``--reps`` sweeps each) at each shape of
    ``SHAPES``;
  - the source on plans with fewer lanes a set (``LANE_CAPS``: more rows a
    lane, fewer butterfly steps), timed the same way; these sum in another
    order, so their distance from the source's d is printed instead.

A = x^T x and B = x^T y of random x (1,000 x K) and y, unit atoms d, made
on the card from a seed per shape. Every line carries the card's name and
power limit.

Run from the repository root on the card's machine:

    python3 tools/bcd_cluster_variants.py [--reps 20]
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from decomp_tpu_torch.ops import _build, cuda_dl  # noqa: E402

SHAPES = [(256, 65), (256, 208), (256, 1024), (1736, 128), (256, 3712),
          (8, 98176)]
STEPS = ("(0) a_kk, d_k, u, u^2", "(1) warp sum of u^2",
         "(2) partial sends (st.async)", "(3) B prefetch + ring wait",
         "(4) next products + butterfly", "(5) exchange wait",
         "(6) 128-slot sum + sqrt", "(7) division, row write, term",
         "(8) refill issue")

LANE_CAPS = (16, 8)
# name -> [(old, new)]
VARIANTS = {
    # Each quotient by __fdiv_rn instead of the shared reciprocal.
    "fdiv": [("      div4_rn(v, den, true);\n",
              "      for (int c = 0; c < 4; ++c)\n"
              "        v[c] = __fdiv_rn(v[c], den);\n")],
    # A ring of 8 rows of A.
    "stages8": [("constexpr int STAGES = 4;", "constexpr int STAGES = 8;")],
    # 2 groups a pass of the products at R = 8, not 4.
    "r8_pass2": [("constexpr int G = R < 4 ? R : 4;",
                  "constexpr int G = R < 4 ? R : R == 4 ? 4 : 2;")],
    # The rows' FMA chains unrolled by 4.
    "unroll4": [("    for (int m = 0, j = p0; m < rows; ++m, j += lanes) {",
                 "#pragma unroll 4\n"
                 "    for (int m = 0, j = p0; m < rows; ++m, j += lanes) {")],
    # The global scratch read through L2 only (ld.global.cg).
    "ldcg": [("    return p[(size_t)j * row + i * slot];",
              "    return __ldcg(p + (size_t)j * row + i * slot);")],
}

_CLOCK_EDITS = [
    ("namespace {\n",
     "namespace {\n\n__device__ long long* g_clk;\n"
     "__device__ __forceinline__ long long clk_after(float v) {\n"
     "  long long t;\n  float sink;\n"
     "  asm volatile(\"{\\nadd.f32 %1, %2, 0f00000000;\\nmov.u64 %0, "
     "%%clock64;\\n}\"\n               : \"=l\"(t), \"=f\"(sink) : \"f\"(v) "
     ": \"memory\");\n  return t;\n}\n"
     "#define STEP(i, v) do { const long long t_ = clk_after(v); "
     "acc_[i] += t_ - last_; last_ = t_; } while (0)\n"),
    ("  for (int k = 0; k < K; ++k) {\n    const float* ak = x.ring",
     "  long long acc_[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long last_ = clk_after(0.f);\n  const long long start_ = last_;\n"
     "  for (int k = 0; k < K; ++k) {\n    const float* ak = x.ring"),
    ("    // The warp's sum of u^2, one lane a set",
     "    STEP(0, q);\n    // The warp's sum of u^2, one lane a set"),
    ("    q = warp_sum(x.p == 0 ? q : 0.f);\n",
     "    q = warp_sum(x.p == 0 ? q : 0.f);\n    STEP(1, q);\n"),
    ("    // While the partials travel",
     "    STEP(2, 0.f);\n    // While the partials travel"),
    ("      mbar_wait(x.full + k1 % STAGES, (k1 / STAGES) & 1);\n",
     "      mbar_wait(x.full + k1 % STAGES, (k1 / STAGES) & 1);\n"
     "      STEP(3, 0.f);\n"),
    ("      products(s, a1, d, p0, rows, lanes, k);\n",
     "      products(s, a1, d, p0, rows, lanes, k);\n"
     "      STEP(4, s[0][0]);\n"),
    ("\n    const float norm = __fsqrt_rn(cluster_norm2(part, x.lane));\n",
     "\n    STEP(5, 0.f);\n"
     "    const float norm = __fsqrt_rn(cluster_norm2(part, x.lane));\n"
     "    STEP(6, norm);\n"),
    ("    // Every warp of the cluster sent atom k's partial",
     "    STEP(7, s[0][0]);\n"
     "    // Every warp of the cluster sent atom k's partial"),
    ("      issue_row(x.A, pl.lda, x.ring, x.full, k % STAGES, k + STAGES);\n"
     "  }\n",
     "      issue_row(x.A, pl.lda, x.ring, x.full, k % STAGES, k + STAGES);\n"
     "    STEP(8, 0.f);\n  }\n"
     "  if (x.lane == 0) {\n"
     "    long long* o_ = g_clk + (x.rank * 16 + x.warp) * 10;\n"
     "    for (int i_ = 0; i_ < 9; ++i_) o_[i_] = acc_[i_];\n"
     "    o_[9] = clk_after(0.f) - start_;\n  }\n"),
]
_SET_CLK = ('\nextern "C" int bcd_set_clk(void* p) {\n'
            '  return (int)cudaMemcpyToSymbol(g_clk, &p, sizeof(p));\n}\n')


def edit(src, edits):
    for old, new in edits:
        assert src.count(old) == 1, f"edit does not apply: {old[:60]!r}"
        src = src.replace(old, new)
    return src


def build(name, src):
    out_dir = _build.BUILD_DIR / "cluster_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.SRC_DIR), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "spill" in ln or "registers" in ln]
    print(f"built {name}: {regs}", flush=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.bcd_sweep_cluster_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    return lib, fn


def lane_capped(k, n, cap):
    """``cuda_dl.bcd_cluster_plan(k, n)`` with at most ``cap`` lanes a set:
    the same split, with the threads, the sets on chip and their row
    stride redone as the plan does them."""
    p = cuda_dl.bcd_cluster_plan(k, n)
    lanes = min(p.lanes, cap)
    fixed = p.smem_bytes - 16 * k * p.l4
    on, per_warp = p.sets, 32 // lanes
    while on and (fixed + 16 * k * cuda_dl._bcd_l4(p.r * on, lanes)
                  > cuda_dl._MAX_BLOCK_SMEM):
        on = (on - 1) // per_warp * per_warp
    l4 = cuda_dl._bcd_l4(p.r * on, lanes)
    return p._replace(lanes=lanes, threads=-(-p.sets * lanes // 32) * 32,
                      on_sets=on, l4=l4, ldw=4 * p.r * (p.sets - on),
                      smem_bytes=fixed + 16 * k * l4)


def launcher(fn, a, b, d, p=None):
    k, n = d.shape
    p = p or cuda_dl.bcd_cluster_plan(k, n)
    ac, bc = cuda_dl._bcd_rows(a, p.lda), cuda_dl._bcd_rows(b, p.ldb)
    out = torch.empty_like(d)
    dw = torch.empty(max(1, p.clusters * k * p.ldw), device=d.device)

    def run():
        err = fn(ac.data_ptr(), bc.data_ptr(), d.data_ptr(), out.data_ptr(),
                 dw.data_ptr(), k, n, p.lda, p.ldb, p.clusters, p.threads,
                 p.nb, p.r, p.sets, p.lanes, p.on_sets, p.l4, p.ldw,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"launch failed: cudaError {err}"
        return out
    return run, p


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bcd_cluster_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    src = (_build.SRC_DIR / "dl_bcd_cluster.cu").read_text()
    _, base = build("source", src)
    clk_lib, clk_fn = build("clocks", edit(src, _CLOCK_EDITS) + _SET_CLK)
    libs = {name: build(name, edit(src, edits))[1]
            for name, edits in VARIANTS.items()}
    dev = torch.device("cuda", 0)
    clk = torch.zeros(128 * 10, dtype=torch.int64, device=dev)
    clk_lib.bcd_set_clk.argtypes = [ctypes.c_void_p]
    assert clk_lib.bcd_set_clk(clk.data_ptr()) == 0
    for i, (k, n) in enumerate(SHAPES):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        x = torch.randn((1000, k), generator=g, device=dev)
        y = torch.randn((1000, n), generator=g, device=dev)
        d = torch.randn((k, n), generator=g, device=dev)
        d /= torch.linalg.vector_norm(d, dim=1, keepdim=True)
        a, b = x.T @ x, x.T @ y
        run, plan = launcher(base, a, b, d)
        ref = run().clone()
        tag = (f"K={k} N={n} ({plan.clusters} blocks x {plan.threads} "
               f"threads, {plan.lanes} lanes a set)")
        crun, _ = launcher(clk_fn, a, b, d)
        clk.zero_()
        ms = event_ms(crun, 1)
        same = torch.equal(crun(), ref)
        c = clk.view(8, 16, 10).cpu().numpy().astype(np.float64)
        warps = plan.threads // 32
        c = c[:plan.clusters, :warps].reshape(-1, 10)
        ghz = c[0, 9] / (ms * 1e6)
        print(f"{tag}, clocks build (same bits: {same}): {c[0, 9] / k:.0f} "
              f"cycles an atom (warp 0 of block 0), {ms * 1e3 / k:.3f} us "
              f"an atom by CUDA events, {ghz:.3f} GHz ({card})", flush=True)
        for s, name in enumerate(STEPS):
            col = c[:, s] / k
            print(f"  {name:34s} mean {col.mean():7.0f} min {col.min():7.0f} "
                  f"max {col.max():7.0f} cycles an atom", flush=True)
        for name, fn in libs.items():
            vrun, _ = launcher(fn, a, b, d)
            got = vrun().clone()
            same = torch.equal(got, ref)
            t = [event_ms(f, args.reps) for f in (run, vrun, vrun, run)]
            src_ms, var_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"{tag}: variant {name} {var_ms:.4f} ms ({t[1]:.4f}, "
                  f"{t[2]:.4f}; {var_ms * 1e3 / k:.3f} us an atom) against "
                  f"the source's {src_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}; "
                  f"{src_ms * 1e3 / k:.3f} us an atom), {var_ms / src_ms:.3f}"
                  f"x; the source's bits: {same} ({card})", flush=True)
        for cap in LANE_CAPS:
            vrun, vplan = launcher(base, a, b, d, lane_capped(k, n, cap))
            if vplan.lanes == plan.lanes:
                continue
            got = vrun().clone()
            diff = float(torch.linalg.vector_norm((got - ref).double())
                         / torch.linalg.vector_norm(ref.double()))
            t = [event_ms(f, args.reps) for f in (run, vrun, vrun, run)]
            src_ms, var_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"{tag}: {vplan.lanes} lanes a set ({vplan.threads} "
                  f"threads) {var_ms:.4f} ms ({var_ms * 1e3 / k:.3f} us an "
                  f"atom) against {src_ms:.4f} ms, {var_ms / src_ms:.3f}x; "
                  f"rel_fro to the source's d {diff:.2e} ({card})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
