"""Split and time design variants of the bf16 packed-mask gradients,
csrc/lasso_grad_packed.cu's one-limb instance (masked_grad_rows) and
csrc/grad_dict_packed.cu's (masked_grad_dict), against the kernels as they
stand, on one CUDA card.

Each variant is a list of text edits to one source (grad_dict_packed.cu
with the chain it includes, csrc/wgmma_chain.cuh, inlined); the script
applies them to a copy under the package's (gitignored) build directory,
``_build/variants/``, builds every copy with nvcc for sm_90a (one nvcc
each, in parallel, with the package's flags), and then, at 100,000 x
1,024, F = K = 128, bf16 data, 30% missing (chip_smoke.py phases 12 and
15b's shape), launches each copy through the package's wrapper, holds its
output to the source's bit for bit and times it in turns with the source
(source, variant, variant, source; CUDA events over 20 calls each). The
``steps`` variants add clock64 counters and print, for warp 0 of each
consumer warpgroup of a few blocks, the clocks a warp spent on each step
of its stage loop summed over its stages: waiting for a full slot, the
first product (R, its wgmma group issued and waited for), forming E, and
the second product (g or G, issued, waited for and added); the rows
kernel also the split of each stripe's x. The edits assert that they
apply, so a variant that no longer fits the source fails loudly.

Run from the repository root on the card's machine:

    python3 tools/grad_bf16_variants.py [name ...]
"""

import concurrent.futures
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decomp_tpu_torch.ops import _build, cuda_dl, cuda_lasso, cuda_mu  # noqa

_PRINTF = ('#include "sm90_common.cuh"\n',
           '#include <cstdio>\n#include "sm90_common.cuh"\n')

# The rows kernel's steps, per warp: x's split per stripe, then per stage
# the wait for a full slot, R, E and g.
_ROWS_STEPS = [
    _PRINTF,
    ("\n  int q = 0;\n",
     "\n  int q = 0;\n  long long ck[5] = {0, 0, 0, 0, 0};\n"),
    ("    constexpr int NE = KT / 16;",
     "    const long long tx0 = clock64();\n    constexpr int NE = KT / 16;"),
    ("    float acc[KC][32];\n",
     "    ck[0] += clock64() - tx0;\n    float acc[KC][32];\n"),
    ("      mbar_wait(full + slot, (q / S) & 1);\n",
     "      const long long t0_ = clock64();\n"
     "      mbar_wait(full + slot, (q / S) & 1);\n"
     "      const long long t1_ = clock64();\n      ck[1] += t1_ - t0_;\n"),
    ("      // E = f32(mask) R - my, split into limbs",
     "      const long long t2_ = clock64();\n      ck[2] += t2_ - t1_;\n"
     "      // E = f32(mask) R - my, split into limbs"),
    ("      // g += E a_s^T per 64-feature chunk",
     "      const long long t3_ = clock64();\n      ck[3] += t3_ - t2_;\n"
     "      // g += E a_s^T per 64-feature chunk"),
    ("      // This warp's products and reads of the slot are done.\n",
     "      ck[4] += clock64() - t3_;\n"
     "      // This warp's products and reads of the slot are done.\n"),
    ("        if (gr < M && col < F) g[gr * F + col] = from_f32<T>(acc[c][i]);"
     "\n      }\n  }\n",
     "        if (gr < M && col < F) g[gr * F + col] = from_f32<T>(acc[c][i]);"
     "\n      }\n  }\n"
     "  if (L == 1 && (blockIdx.x == 0 || blockIdx.x == 77) && warp == 0 &&"
     " lane == 0)\n"
     "    printf(\"rows block %d warpgroup %d: x %lld, wait %lld, R %lld, "
     "E %lld, g %lld clocks over %d stages\\n\", blockIdx.x, cw, ck[0], "
     "ck[1], ck[2], ck[3], ck[4], q);\n"),
]

# The dictionary kernel's steps, per warp: per stage the wait for a full
# slot, R'^T, E^T and G^T.
_DICT_STEPS = [
    ("  if constexpr (tma_res) mbar_wait(rbar, 0);\n",
     "  long long ck[4] = {0, 0, 0, 0};\n"
     "  if constexpr (tma_res) mbar_wait(rbar, 0);\n"),
    ("      mbar_wait(full + slot, (q / S) & 1);\n",
     "      const long long t0_ = clock64();\n"
     "      mbar_wait(full + slot, (q / S) & 1);\n"
     "      const long long t1_ = clock64();\n      ck[0] += t1_ - t0_;\n"),
    ("      // E from R and my, split into limbs",
     "      const long long t2_ = clock64();\n      ck[1] += t2_ - t1_;\n"
     "      // E from R and my, split into limbs"),
    ("      // acc += E B_s per 64-wide chunk",
     "      const long long t3_ = clock64();\n      ck[2] += t3_ - t2_;\n"
     "      // acc += E B_s per 64-wide chunk"),
    ("      // This warp's products and reads of the slot are done.\n",
     "      ck[3] += clock64() - t3_;\n"
     "      // This warp's products and reads of the slot are done.\n"),
    ("  if constexpr (XRES) {\n    if (tid == 0) tma_store_wait();",
     "  if (P == Pass::GradDict && L == 1 && warp == 0 && lane == 0 &&\n"
     "      blockIdx.y % 16 == 0 && blockIdx.x % 4 == 0)\n"
     "    printf(\"dict block (%d, %d) warpgroup %d: wait %lld, R %lld, "
     "E %lld, G %lld clocks over %d stages\\n\", blockIdx.x, blockIdx.y, "
     "cw, ck[0], ck[1], ck[2], ck[3], q);\n"
     "  if constexpr (XRES) {\n    if (tid == 0) tma_store_wait();"),
]

# The mask's bit as 1.0f or 0.0f by integer operations, not by an
# int-to-float conversion.
_ROWS_BIT = [("            const float m = (float)((word >> u) & 1u);\n",
              "            const float m = __uint_as_float(\n"
              "                (0u - ((word >> u) & 1u)) & 0x3f800000u);\n")]
_DICT_BIT = [(
    "            if constexpr (P == Pass::GradDict && L == 1) {\n"
    "                // bf16 my; E is rounded to bf16 below.\n"
    "                const float m = to_f32(*Swz<128, SS>{\n"
    "                    reinterpret_cast<const bf16*>(myb)}.at(col + u, "
    "row));\n                const float bit = (float)((mw[(col + u) * 4 "
    "+ row / 32] >>\n                                           (row % 32)) "
    "& 1u);\n",
    "            if constexpr (P == Pass::GradDict && L == 1) {\n"
    "                // bf16 my; E is rounded to bf16 below.\n"
    "                const float m = to_f32(*Swz<128, SS>{\n"
    "                    reinterpret_cast<const bf16*>(myb)}.at(col + u, "
    "row));\n                const float bit = __uint_as_float(\n"
    "                    (0u - ((mw[(col + u) * 4 + row / 32] >> (row % 32)) &"
    "\n                           1u)) & 0x3f800000u);\n")]

# The two consumer warpgroups take turns to issue their products (named
# barriers 3 and 4), so that one forms E while the other's products run.
_PP_SYNC = (
    "__device__ __forceinline__ void pp_sync(int id) {\n"
    "  asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(id) : \"memory\");\n}\n"
    "__device__ __forceinline__ void pp_arrive(int id) {\n"
    "  asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(id) : \"memory\");"
    "\n}\n")
_ROWS_PING_PONG = [
    ("constexpr int kXChunk = BM * 128;      // 128 rows x 64 bf16 of x's "
     "limbs\n",
     "constexpr int kXChunk = BM * 128;      // 128 rows x 64 bf16 of x's "
     "limbs\n" + _PP_SYNC),
    ("\n  int q = 0;\n",
     "\n  int q = 0;\n  if constexpr (L == 1) {\n"
     "    if (cw == 1) pp_arrive(3);\n  }\n"),
    ("      asm volatile(\"wgmma.fence.sync.aligned;\\n\" ::: \"memory\");\n"
     "#pragma unroll\n      for (int kk = 0; kk < KT / 16; ++kk) {\n",
     "      if constexpr (L == 1) pp_sync(3 + cw);\n"
     "      asm volatile(\"wgmma.fence.sync.aligned;\\n\" ::: \"memory\");\n"
     "#pragma unroll\n      for (int kk = 0; kk < KT / 16; ++kk) {\n"),
    ("      asm volatile(\"wgmma.commit_group.sync.aligned;\\n\" ::: "
     "\"memory\");\n      asm volatile(\"wgmma.wait_group.sync.aligned 0;"
     "\\n\" ::: \"memory\");\n#pragma unroll\n      for (int c = 0; c < KC; "
     "++c) fence_operand(rb[c]);\n",
     "      asm volatile(\"wgmma.commit_group.sync.aligned;\\n\" ::: "
     "\"memory\");\n      if constexpr (L == 1) pp_arrive(4 - cw);\n"
     "      asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: "
     "\"memory\");\n#pragma unroll\n      for (int c = 0; c < KC; ++c) "
     "fence_operand(rb[c]);\n"),
    ("#pragma unroll\n      for (int c = 0; c < KC; ++c) {\n"
     "        float tb[32], ts[32];\n",
     "      if constexpr (L == 1) {\n        float tb[KC][32];\n"
     "#pragma unroll\n        for (int c = 0; c < KC; ++c) "
     "fence_operand(tb[c]);\n        pp_sync(3 + cw);\n"
     "        asm volatile(\"wgmma.fence.sync.aligned;\\n\" ::: \"memory\");"
     "\n#pragma unroll\n        for (int c = 0; c < KC; ++c)\n"
     "#pragma unroll\n          for (int ks = 0; ks < SC / 16; ++ks)\n"
     "            wgmma_rs(tb[c], ea[ks][0], smem_desc(base + kMy + c * kBox"
     " + ks * 2048, kBox, 1024), ks);\n"
     "        asm volatile(\"wgmma.commit_group.sync.aligned;\\n\" ::: "
     "\"memory\");\n"
     "        if (cw == 0 || s + 1 < n_st || sp + (int)gridDim.x < "
     "n_stripes)\n          pp_arrive(4 - cw);\n"
     "        asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: "
     "\"memory\");\n#pragma unroll\n        for (int c = 0; c < KC; ++c) {\n"
     "          fence_operand(tb[c]);\n#pragma unroll\n"
     "          for (int i = 0; i < 32; ++i) acc[c][i] += tb[c][i];\n"
     "        }\n      } else\n#pragma unroll\n"
     "      for (int c = 0; c < KC; ++c) {\n        float tb[32], ts[32];\n"),
]

# name -> (kernel, edits): "rows" edits csrc/lasso_grad_packed.cu, "dict"
# csrc/grad_dict_packed.cu with the chain inlined.
VARIANTS = {
    "rows_steps": ("rows", _ROWS_STEPS),
    "rows_mask_bit_int": ("rows", _ROWS_BIT),
    "rows_ping_pong": ("rows", _ROWS_PING_PONG),
    "dict_steps": ("dict", [_PRINTF] + _DICT_STEPS),
    "dict_mask_bit_int": ("dict", _DICT_BIT),
    "dict_stages_6": ("dict", [("      L == 1 ? 10\n", "      L == 1 ? 6\n")]),
}
_SOURCE = {"rows": ("lasso_grad_packed", "lasso_grad_packed_launch"),
           "dict": ("grad_dict_packed", "grad_dict_packed_launch")}
# The ctypes signatures of the two entry points, the stream last.
_ARGTYPES = {
    "rows": [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
    "dict": [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p] + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 4,
}


def variant_source(kernel, edits):
    """The kernel's source with ``edits`` applied (the dictionary's chain,
    wgmma_chain.cuh, inlined first, so that edits reach its text)."""
    src = (_build.SRC_DIR / f"{_SOURCE[kernel][0]}.cu").read_text()
    if kernel == "dict":
        chain = (_build.SRC_DIR / "wgmma_chain.cuh").read_text()
        src = src.replace('#include "wgmma_chain.cuh"',
                          chain.replace("#pragma once\n", ""))
    for old, new in edits:
        n = src.count(old)
        if n != 1:
            raise RuntimeError(f"edit applies {n} times: {old!r:.80}")
        src = src.replace(old, new)
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
                     .splitlines() if "spill stores" in ln})
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


def main():
    if not torch.cuda.is_available():
        print("grad_bf16_variants: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(names) + 2) as pool:
        trees = [pool.submit(_build.build, s) for s, _ in _SOURCE.values()]
        builds = {n: pool.submit(build, n, variant_source(*VARIANTS[n]),
                                 out_dir) for n in names}
        for f in trees:
            f.result()
        libs = {n: f.result() for n, f in builds.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(22)
    m, n, f = 100_000, 1024, 128
    bf = torch.bfloat16
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).to(bf)
    my = (torch.randn((m, n), generator=g, device=dev) * mask).to(bf)
    x = torch.randn((m, f), generator=g, device=dev).to(bf)
    a = (torch.randn((f, n), generator=g, device=dev) / n ** 0.5).to(bf)
    bits = cuda_mu.pack_mask(mask)
    limbs = cuda_lasso.grad_limbs(a)
    calls = {"rows": lambda: cuda_lasso.masked_grad_rows(my, bits, x, a,
                                                         a_limbs=limbs),
             "dict": lambda: cuda_dl.masked_grad_dict(my, bits, x, a)}
    modules = {"rows": cuda_lasso, "dict": cuda_dl}
    refs = {k: call().clone() for k, call in calls.items()}
    orig = {k: mod._c_function for k, mod in modules.items()}

    def use(kernel, fn):
        """Launch ``kernel`` through the entry point fn (None: the tree's)."""
        modules[kernel]._c_function = (orig[kernel] if fn is None
                                       else (lambda *args: fn))

    for name in names:
        kernel = VARIANTS[name][0]
        so, spills = libs[name]
        fn = getattr(ctypes.CDLL(str(so)), _SOURCE[kernel][1])
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[kernel]
        use(kernel, fn)
        out = calls[kernel]()
        torch.cuda.synchronize()   # a steps variant prints its split here
        same = torch.equal(out, refs[kernel])
        if name.endswith("_steps"):
            use(kernel, None)
            print(f"variant {name}: the source's bits: {same}; ptxas "
                  f"{spills} ({m}x{n} F=K={f} bf16, {card})", flush=True)
            continue
        t = []
        for h in (None, fn, fn, None):
            use(kernel, h)
            t.append(cuda_ms(calls[kernel]))
        use(kernel, None)
        v, s = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        print(f"variant {name}: {v:.4f} ms against the source's {s:.4f} ms "
              f"(variant / source {v / s:.3f}; {t[1]:.4f}, {t[2]:.4f} "
              f"against {t[0]:.4f}, {t[3]:.4f}); the source's bits: {same};"
              f" ptxas {spills} ({m}x{n} F=K={f} bf16, {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
