"""Time design variants of the dense KL kernel, csrc/kl_dense_packed.cu,
against the kernel as it stands, on one CUDA card.

Each variant is a list of text edits to the source (with the chain it
includes, csrc/wgmma_chain.cuh, inlined); the script applies them to a copy in the package's (gitignored) build directory under
``_build/variants/``, builds every copy with nvcc for
sm_90a (one nvcc each, in parallel, with the package's flags), and then,
at 100,000 x 1,024, K = 128, f32 (the dense KL-MU path's shape), holds
each copy's outputs against the plain twin, times it in turns with the
source as it stands (source, variant, variant, source; CUDA events over
20 calls each) and splits its passes with torch.profiler. Variants marked
timing-only change the result on purpose, to show what a part costs.
The edits assert that they apply, so a variant that no longer fits the
source fails loudly.

Run from the repository root on the card's machine:

    python3 tools/kl_dense_variants.py [name ...]
"""

import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decomp_tpu_torch.ops import _build, cuda_mu  # noqa: E402

_E_DIV = "? div_rn(m, __fadd_rn(__fadd_rn(big, small), p.eps))"
_XC_SMEM = (
    "            *reinterpret_cast<uint32_t*>(rw + (3 * c + l) * kRChunk +\n"
    "                                         row * 128 + ((j ^ gq) << 4) +\n"
    "                                         4 * t) = f[l];")
_XC_TMA = """      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int l = 0; l < 3; ++l)
            tma_store(tm_res, l * KT + 64 * c, it * BR + 64 * cw,
                      rw + (3 * c + l) * kRChunk);
        tma_store_commit();
      }"""
_EPILOGUE = re.compile(
    r"      // x_new = x \* num / \(dsum \+ eps\) from the f32 x.*?"
    r"if \(gq == 0 && col < p\.K\) xp\[col\] = v;\n          }\n",
    re.S)
_ACC_OUT = """      const long long r0 = (long long)it * BR;
#pragma unroll
      for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const long long gr = r0 + rr + 8 * ((i / 2) % 2);
          const int col = 64 * c + 8 * (i / 4) + 2 * t + i % 2;
          if (gr < p.M && col < p.K) p.x_new[gr * p.K + col] = acc[c][i];
        }
"""

# name -> (timing only, [(old, new) or (compiled regex, new)])
VARIANTS = {
    # E by __fdiv_rn: IEEE division with its branch to a slow path.
    "fdiv": (False, [(_E_DIV, "? __fdiv_rn(m, __fadd_rn(__fadd_rn(big, "
                              "small), p.eps))")]),
    # E by div.rn's fast path without scaling the divisor: wrong for
    # divisors below 2^-126 or above 2^126 (the data here has none).
    "fast_unscaled": (False, [(
        "  const uint32_t eb = min(__float_as_uint(b) & 0x7f800000u, "
        "253u << 23);\n  const float s = __uint_as_float((254u << 23) - eb);",
        "  const float s = 1.f;")]),
    # x_new's limbs by 4-byte global stores instead of the resident rows
    # and a TMA store.
    "xc_stores": (False, [
        ("  float* xpart;", "  bf16* xc;\n  float* xpart;"),
        ("static_cast<float*>(a.x_new), static_cast<float*>(a.xpart),",
         "static_cast<float*>(a.x_new), static_cast<bf16*>(a.xc),\n"
         "           static_cast<float*>(a.xpart),"),
        (_XC_SMEM, "            if (gr < p.M)\n"
                   "              *reinterpret_cast<uint32_t*>(\n"
                   "                  p.xc + gr * (3 * KT) + l * KT + col) = "
                   "f[l];"),
        (_XC_TMA, "")]),
    # The x update's stripes in a grid of their own (not persistent).
    "grid": (False, [("stripes < sms ? stripes : sms, p, a.stream);",
                      "stripes, p, a.stream);")]),
    # Each stripe walks its column stages from a rotated start.
    "rotate": (False, [
        ("tma_load(dst, tm_my, s * SS, it * BR, bar);",
         "tma_load(dst, tm_my, ((s + it) % n_st) * SS, it * BR, bar);"),
        ("const int b_row = STATS ? r_begin + s * SS : s * SS;",
         "const int b_row = STATS ? r_begin + s * SS : ((s + it) % n_st) "
         "* SS;"),
        ("const int s_lim = STATS ? r_end - r_begin - s * SS : p.N - s * SS;",
         "const int s_lim = STATS ? r_end - r_begin - s * SS : p.N - "
         "((s + it) % n_st) * SS;")]),
    # Timing only: the x update's epilogue stores num as x_new (no x read,
    # no division, no limbs, no column sums).
    "no_epilogue": (True, [(_EPILOGUE, _ACC_OUT)]),
    # Timing only: x's limbs split for a block's first stripe only.
    "no_refill": (True, [(
        "    if constexpr (!STATS) {\n      // The warpgroup's 64",
        "    if (!STATS && it == item0) {\n      // The warpgroup's 64")]),
}


def variant_source(edits):
    """The source with ``edits`` applied; the chain it includes
    (wgmma_chain.cuh) is inlined first, so that edits reach its text."""
    chain = (_build.SRC_DIR / "wgmma_chain.cuh").read_text()
    src = (_build.SRC_DIR / "kl_dense_packed.cu").read_text().replace(
        '#include "wgmma_chain.cuh"', chain.replace("#pragma once\n", ""))
    for old, new in edits:
        if isinstance(old, re.Pattern):
            src, n = old.subn(lambda _: new, src)
        else:
            n = src.count(old)
            src = src.replace(old, new)
        if n != 1:
            raise RuntimeError(f"edit applies {n} times: {old!r:.80}")
    return src


def build(name, src, out_dir):
    cu = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.SRC_DIR), "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    spills = sorted({ln.strip() for ln in (proc.stdout + proc.stderr)
                     .splitlines() if "spill" in ln})
    return so, spills


def cuda_ms(fn, reps=20):
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


def passes(fn, calls=5):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"namespace\)::(dense_\w+|reduce\w*)", e.key)
        if m and str(e.device_type).endswith("CUDA"):
            out[m.group(1)] = round(e.self_device_time_total / calls / 1e3, 4)
    return out


def main():
    if not torch.cuda.is_available():
        print("kl_dense_variants: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        tree = pool.submit(_build.build, "kl_dense_packed")
        builds = {n: pool.submit(build, n, variant_source(VARIANTS[n][1]),
                                 out_dir) for n in names}
        tree.result()
        libs = {n: f.result() for n, f in builds.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    m, n, k = 100_000, 1024, 128
    my = torch.rand((m, n), generator=g, device=dev)
    x = 0.1 + torch.rand((m, k), generator=g, device=dev)
    d = 0.1 + torch.rand((k, n), generator=g, device=dev)
    ref = cuda_mu.kl_stats_dense_plain(my, x, d, 1e-6)
    orig = cuda_mu._c_function

    def call():
        return cuda_mu._kl_dense_packed_launch(my, x, d, 1e-6, None)

    def use(fn):
        """Launch through the variant's entry point fn (None: the tree's)."""
        cuda_mu._c_function = orig if fn is None else (lambda *a: fn)

    print(f"tree at {m}x{n} K={k} f32: {passes(call)}", flush=True)
    for name in names:
        so, spills = libs[name]
        fn = ctypes.CDLL(so).kl_dense_packed_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_float] + [ctypes.c_int] * 4 + [
                           ctypes.c_void_p] * 7
        use(fn)
        out = call()
        errs = [float((a.double() - b.double()).norm() / b.double().norm())
                for a, b in zip(out, ref)]
        t = []
        for f in (None, fn, fn, None):
            use(f)
            t.append(cuda_ms(call))
        use(fn)
        split = passes(call)
        use(None)
        v, s = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        print(f"variant {name}{' (timing only)' if VARIANTS[name][0] else ''}"
              f": {v:.4f} ms against the source's {s:.4f} ms (variant / "
              f"source {v / s:.3f}); passes {split}; rel_fro to the twin "
              + " ".join(f"{e:.2e}" for e in errs)
              + f"; ptxas {spills} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
