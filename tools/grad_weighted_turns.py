"""The weighted-mask gradients on one CUDA card: the weighted instances of
csrc/lasso_grad_packed.cu (masked_grad_rows) and csrc/grad_dict_packed.cu
(masked_grad_dict), f32 data as bf16x6 and bf16 data in one limb, against
their twins and in turns with their first designs (csrc/lasso_grad.cu and
csrc/mu_kl_stats.cu's GRAD_DICT variant, through the private
``_grad_dense_mma_launch`` and ``_grad_dict_dense_mma_launch``), and their
ring's stage count against variants.

1. Builds the four sources (one nvcc each, in parallel) and every variant,
   and prints ptxas' spill lines of each.
2. Holds each weighted instance to its twin (relative Frobenius, limit
   2e-6 f32, 2.5e-4 bf16 as chip_smoke.py's GRAD_LIMIT) at ragged shapes
   and at 100,000 x 1,024, F = K = 128, with weights in [0.5, 1) on the
   observed entries (30% missing), with a bit-identical rerun.
3. Times each weighted instance in turns with its first design on the same
   inputs at 100,000 x 1,024, F = K = 128 (first, new, new, first; CUDA
   events over 20 calls each), and the bits instance on the same 0/1 mask
   beside them.
4. Times each variant (a text edit of the stage count in Cfg, applied to a
   copy of the source under ``_build/variants/``) in turns with the source,
   at F = K = 128 and at F = K = 64 (where the f32 ring has room for 4
   stages), on each data type and width whose count it changes: the stage
   counts the weights' box leaves, against fewer.

Run from the repository root on the card's machine:

    python3 tools/grad_weighted_turns.py [--no-variants]
"""

import concurrent.futures
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decomp_tpu_torch.ops import _build, cuda_dl, cuda_lasso  # noqa: E402

LIMIT = {torch.float32: 2e-6, torch.bfloat16: 2.5e-4}
_ROWS_STAGES = "      W ? (L == 3 ? (KT == 64 ? 4 : 2) : (KT == 64 ? 5 : 4))\n"
_DICT_STAGES = ("      P == Pass::GradDictW ? (L == 1 ? (KT == 64 ? 10 : 8)\n"
                "                                     : (KT == 64 ? 4 : 2))\n")


def _rows_stages(f32_64, f32_128, bf_64, bf_128):
    return [(_ROWS_STAGES, f"      W ? (L == 3 ? (KT == 64 ? {f32_64} : "
             f"{f32_128}) : (KT == 64 ? {bf_64} : {bf_128}))\n")]


def _dict_stages(f32_64, f32_128, bf_64, bf_128):
    return [(_DICT_STAGES, f"      P == Pass::GradDictW ? (L == 1 ? (KT == "
             f"64 ? {bf_64} : {bf_128})\n                                     "
             f": (KT == 64 ? {f32_64} : {f32_128}))\n")]


# The source's stage counts (f32 at KT = 64, f32 at KT = 128, bf16 at KT =
# 64, bf16 at KT = 128).
SOURCE_STAGES = {"rows": (4, 2, 5, 4), "dict": (4, 2, 10, 8)}
# name -> (kernel, stage counts): a variant is timed on the data types and
# widths whose count differs from the source's.
VARIANTS = {
    "rows_f32_1_3": ("rows", (3, 1, 5, 4)),
    "rows_bf16_3_3": ("rows", (4, 2, 3, 3)),
    "rows_bf16_2_2": ("rows", (4, 2, 2, 2)),
    "rows_bf16_4": ("rows", (4, 2, 4, 4)),
    "dict_f32_1_3": ("dict", (3, 1, 10, 8)),
    "dict_bf16_6_6": ("dict", (4, 2, 6, 6)),
    "dict_bf16_4_4": ("dict", (4, 2, 4, 4)),
    "dict_bf16_3_3": ("dict", (4, 2, 3, 3)),
}
_EDITS = {"rows": _rows_stages, "dict": _dict_stages}
_SOURCE = {"rows": ("lasso_grad_packed", "lasso_grad_weighted_launch"),
           "dict": ("grad_dict_packed", "grad_dict_weighted_launch")}
_ARGTYPES = {
    "rows": [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
    "dict": [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int] * 3
    + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4,
}
_MODULES = {"rows": cuda_lasso, "dict": cuda_dl}


def variant_source(kernel, stages):
    """The kernel's source with the weighted instances' stage counts
    ``stages`` (the dictionary's chain, wgmma_chain.cuh, inlined first, so
    that the edit reaches its text)."""
    edits = _EDITS[kernel](*stages)
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
    return so, _spills(proc.stdout + proc.stderr)


def _spills(log):
    return sorted({ln.strip() for ln in log.splitlines()
                   if "spill stores" in ln
                   and " 0 bytes spill stores, 0 bytes spill loads" not in ln})


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


def rel_fro(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def inputs(g, dev, m, n, f, dt):
    """my = w y, the weighted mask w (30% missing, observed entries in
    [0.5, 1)), x and a (or d)."""
    obs = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    w = obs * (0.5 + 0.5 * torch.rand((m, n), generator=g, device=dev))
    my = torch.randn((m, n), generator=g, device=dev) * w
    x = torch.randn((m, f), generator=g, device=dev)
    a = torch.randn((f, n), generator=g, device=dev) / n ** 0.5
    return tuple(t.to(dt) for t in (my, w, x, a)), obs


def main():
    if not torch.cuda.is_available():
        print("grad_weighted_turns: no CUDA device", file=sys.stderr)
        return 1
    names = [] if "--no-variants" in sys.argv else list(VARIANTS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = ("lasso_grad_packed", "grad_dict_packed", "lasso_grad",
               "mu_kl_stats")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 4) as pool:
        trees = {s: pool.submit(_build.build, s) for s in sources}
        builds = {n: pool.submit(build, n, variant_source(*VARIANTS[n]),
                                 out_dir) for n in names}
        for s, fut in trees.items():
            log = open(str(fut.result()) + ".log").read()
            print(f"built {s}.cu; spills: {_spills(log) or 'none'}",
                  flush=True)
        libs = {n: f.result() for n, f in builds.items()}
    for n, (_, spills) in libs.items():
        print(f"built variant {n}; spills: {spills or 'none'}", flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(24)
    fns = {"rows": cuda_lasso.masked_grad_rows,
           "dict": cuda_dl.masked_grad_dict}
    plains = {"rows": cuda_lasso.masked_grad_rows_plain,
              "dict": cuda_dl.masked_grad_dict_plain}
    firsts = {"rows": cuda_lasso._grad_dense_mma_launch,
              "dict": cuda_dl._grad_dict_dense_mma_launch}
    bad = []
    for dt in (torch.float32, torch.bfloat16):
        for m, n, f in ((1000, 1000, 100), (333, 257, 7), (7, 1000, 100),
                        (1000, 1000, 1), (1000, 1000, 64),
                        (100_000, 1024, 128)):
            args, _ = inputs(g, dev, m, n, f, dt)
            for k in ("rows", "dict"):
                before = fns[k].dense_launches
                out, again = fns[k](*args), fns[k](*args)
                ref = plains[k](*args)
                first = firsts[k](*args)
                torch.cuda.synchronize()
                err, err1 = rel_fro(out, ref), rel_fro(first, ref)
                same = torch.equal(out, again)
                routed = fns[k].dense_launches == before + 2
                print(f"{k} weighted {m}x{n} F={f} {str(dt)[6:]}: rel_fro "
                      f"{err:.3e} (limit {LIMIT[dt]:g}), first design "
                      f"{err1:.3e}; bit-identical rerun {same}; on the "
                      f"dense route {routed}", flush=True)
                if not (err <= LIMIT[dt] and same and routed):
                    bad.append(f"{k} {m}x{n} F={f} {dt}")
            del args
    # Per-call times at 100,000 x 1,024, F = K = 128, in turns.
    from decomp_tpu_torch.ops import cuda_mu

    m, n, f = 100_000, 1024, 128
    for dt in (torch.float32, torch.bfloat16):
        args, obs = inputs(g, dev, m, n, f, dt)
        my, w, x, a = args
        bits = cuda_mu.pack_mask(obs)
        limbs = cuda_lasso.grad_limbs(a)
        runs = {
            "rows": (lambda: cuda_lasso.masked_grad_rows(*args,
                                                         a_limbs=limbs),
                     lambda: cuda_lasso._grad_dense_mma_launch(*args),
                     lambda: cuda_lasso.masked_grad_rows(
                         my, bits, x, a, a_limbs=limbs)),
            "dict": (lambda: cuda_dl.masked_grad_dict(*args),
                     lambda: cuda_dl._grad_dict_dense_mma_launch(*args),
                     lambda: cuda_dl.masked_grad_dict(my, bits, x, a))}
        for k, (new, old, packed) in runs.items():
            t = [cuda_ms(fn) for fn in (old, new, new, old)]
            p_ms = cuda_ms(packed)
            k_ms, o_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            print(f"{k} {m}x{n} F={f} {str(dt)[6:]}, weighted: new "
                  f"{k_ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), first design "
                  f"{o_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}) in turns, new / "
                  f"first {k_ms / o_ms:.3f}; the bits instance on the 0/1 "
                  f"mask {p_ms:.4f} ms ({card})", flush=True)
        del args, my, w, x, a, bits, limbs
    # The variants, in turns with the source, at F = K = 128 and 64.
    orig = {k: mod._c_function for k, mod in _MODULES.items()}
    for name in names:
        kernel, stages = VARIANTS[name]
        so, _ = libs[name]
        fn = getattr(ctypes.CDLL(str(so)), _SOURCE[kernel][1])
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[kernel]
        for i, (dt, f) in enumerate(((torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128))):
            if stages[i] != SOURCE_STAGES[kernel][i]:
                args, _ = inputs(g, dev, m, n, f, dt)
                kw = ({"a_limbs": cuda_lasso.grad_limbs(args[3])}
                      if kernel == "rows" else {})
                call = (lambda: fns[kernel](*args, **kw))
                ref = call()

                def use(h):
                    _MODULES[kernel]._c_function = (
                        orig[kernel] if h is None else (lambda *a_: h))

                t = []
                for h in (None, fn, fn, None):
                    use(h)
                    t.append(cuda_ms(call))
                use(fn)
                same = torch.equal(call(), ref)
                use(None)
                v, s = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                print(f"variant {name} {kernel} F={f} {str(dt)[6:]}, "
                      f"{stages[i]} stages against the source's "
                      f"{SOURCE_STAGES[kernel][i]}: {v:.4f} ms against "
                      f"{s:.4f} ms (variant / source {v / s:.3f}; "
                      f"{t[1]:.4f}, {t[2]:.4f} against {t[0]:.4f}, "
                      f"{t[3]:.4f}); the source's bits: {same} ({card})",
                      flush=True)
                del args, ref
    if bad:
        print("FAILED: " + "; ".join(bad), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
