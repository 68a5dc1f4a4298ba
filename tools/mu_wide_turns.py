"""The wide-rank MU route on one CUDA card: csrc/mu_wide.cu, the route of
``cuda_mu.mu_stats_dense`` and ``mu_stats_masked`` above rank 128 (f32 data
as bf16x6, bf16 data in one limb; the mask as bits or as weights), against
its twins, and one solver iteration in turns with the composition that
``use_kernel='auto'`` runs where it does not take the route.

1. Builds mu_wide.cu and prints ptxas' register and spill lines under
   each kernel's name (``mask_xupd<3>``, ``mask_stats<1>``, ...), and its
   performance warnings.
2. Holds each instance (dense f32, dense bf16 with f32 and with bf16 x,
   masked f32 and bf16 on bits and on weights) to its twin (relative
   Frobenius of x_new and of each statistic, limit 2e-6 f32, 2.5e-4 bf16,
   chip_smoke.py's) at ragged shapes (333 x 257, K = 129; 1,000 x 1,000, K
   = 200 and 256; dense with inner_iter 1 and 3), with a bit-identical
   rerun and every call counted in ``.wide_launches``.
3. Unless ``--check-only``: times one iteration of ``nmf.solve``'s kernel
   path (``nmf._kernel_step``: the wrapper and the d epilogue; a 0/1 mask
   packed once, outside the timing) in turns with one of its composition
   path (``nmf._UPDATES``: the x update and the d update) at ``TURNS``'
   shapes: K = 256 at N = 64, 128, 256, 512, 1,024 and 4,096 (M = 100,000; masked
   only where the gate takes it), and each gate corner of ``rank_fits``
   (N = 1,024 with M = 32,768; N = 128 with M cut to 4,096), for f32 data
   with f32 factors and bf16 data with f32 factors (the mixed mode of
   ``factor_dtype``), and bf16 data with bf16 factors at N = 64 and 1,024
   and at N = 128's corner; each beside the TPU kernel's own bound. The kernel
   path's launches per call are timed apart by torch.profiler at 100,000 x
   1,024, K = 256. These turns are the data behind ``nmf._auto_rank``.

``--masked`` keeps steps 2 and 3 to the masked instances; ``--path``
instead times each masked instance at one call at 100,000 x 1,024, K =
256, with its launches from torch.profiler (through the public wrappers
only: the script times the route of whichever tree it stands in, so a
parent tree's route is timed by a copy of it in that tree).

Run from the repository root on the card's machine:

    python3 tools/mu_wide_turns.py [--check-only | --masked | --path]
"""

import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decomp_tpu_torch.models import nmf  # noqa: E402
from decomp_tpu_torch.ops import _build, cuda_mu  # noqa: E402

LIMIT = {torch.float32: 2e-6, torch.bfloat16: 2.5e-4}
EPS = 1e-6
F32, BF16 = torch.float32, torch.bfloat16
# The gate's corners (cuda_mu.rank_fits), (N, K) by (dtype, masked).
CORNERS = {(F32, False): ((1024, 1280), (128, 10_624)),
           (F32, True): ((1024, 640), (128, 6272)),
           (BF16, False): ((1024, 1536), (128, 12_800)),
           (BF16, True): ((1024, 768), (128, 7040))}
WIDTHS = (64, 128, 256, 512, 1024, 4096)
# The masked path's shape (chip_smoke.py's WIDE_RANK_PATH).
PATH = (100_000, 1024, 256)
HBM = 3.35e12
PEAK = 989e12


def cuda_ms(fn, reps=5):
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


def inputs(g, dev, m, n, k, dt, xdt, masked, weighted=False):
    """y (or my = mask y), the mask (30% missing; weighted: observed
    entries in [0.5, 1)), x and d: uniform, x and d in [0.1, 1.1)."""
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    if weighted:
        mask *= 0.5 + 0.5 * torch.rand((m, n), generator=g, device=dev)
    y = torch.rand((m, n), generator=g, device=dev)
    if masked:
        y *= mask
    x = 0.1 + torch.rand((m, k), generator=g, device=dev)
    d = 0.1 + torch.rand((k, n), generator=g, device=dev)
    return y.to(dt), mask.to(dt), x.to(xdt), d.to(dt)


def check(g, dev, m, n, k, dt, xdt, kind, inner=1):
    """One instance against its twin; ``kind``: dense, bits or weights."""
    y, mask, x, d = inputs(g, dev, m, n, k, dt, xdt, kind != "dense",
                           kind == "weights")
    if kind == "dense":
        w = cuda_mu.mu_stats_dense
        before = w.wide_launches

        def call():
            return w(y, x, d, EPS, inner_iter=inner)

        ref = cuda_mu.mu_stats_dense_plain(y, x, d, EPS, inner_iter=inner)
    else:
        w = cuda_mu.mu_stats_masked
        before = w.wide_launches
        km = cuda_mu.pack_mask(mask) if kind == "bits" else mask

        def call():
            return w(y, km, x, d, EPS)

        ref = cuda_mu.mu_stats_masked_plain(y, mask, x, d, EPS)
    out, again = call(), call()
    torch.cuda.synchronize()
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    routed = w.wide_launches - before == 2
    ok = max(errs) <= LIMIT[dt] and same and routed
    print(f"{kind} {m}x{n} K={k} inner={inner} {str(dt)[6:]} data, "
          f"{str(xdt)[6:]} x: rel_fro x_new {errs[0]:.3e}, stats "
          f"{errs[1]:.3e} {errs[2]:.3e} (limit {LIMIT[dt]:g}); bit-identical "
          f"rerun {same}; on the wide route {routed}"
          f"{'' if ok else '  <-- FAIL'}", flush=True)
    return ok


def bound_ms(kind, m, n, k, dt):
    """(ms, by) of the TPU kernel's own work: the data (and the mask: bits
    or weights) read once, x read and x_new written (f32), d read, the
    statistics written; dense 4MNK + 4MK^2, masked 12MNK operations, six
    bf16 passes at f32."""
    e = dt.itemsize
    if kind == "dense":
        ops, stats, mask_b = 4.0 * m * n * k + 4.0 * m * k * k, k * n + k * k, 0
    else:
        ops, stats = 12.0 * m * n * k, 2 * k * n
        mask_b = (e * m * n if kind == "weights"
                  else 4 * m * cuda_mu.packed_words(n))
    nbytes = e * (m * n + k * n) + mask_b + 8 * m * k + 4 * stats
    t_b = nbytes / HBM * 1e3
    t_o = (6 if dt == F32 else 1) * ops / PEAK * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def steps(y, mask, kind, mixed):
    """(kernel step, composition step): one iteration of each of
    nmf.solve's paths on (x, d), the factors in f32; ``y`` is the masked
    data my where masked."""
    eps = torch.tensor(EPS, dtype=torch.float32 if mixed else y.dtype)
    km = None if kind == "dense" else mask
    kstep = nmf._kernel_step(y, km, "mu", EPS, None, 1)
    upd_x, upd_d = nmf._UPDATES["mu", mixed]

    def cstep(state, it):
        x_, d_ = state
        x_ = upd_x(y, x_, d_, km, eps, nmf._identity)
        return x_, upd_d(y, x_, d_, km, eps, nmf._identity)

    return kstep, cstep


def turns(g, dev, m, n, k, dt, kind, card, profile=False, fdt=F32):
    """One iteration of each path in turns; the factors in ``fdt`` (f32:
    bf16 data run in the mixed mode of ``factor_dtype``)."""
    y, mask, x, d = inputs(g, dev, m, n, k, dt, fdt, kind != "dense",
                           kind == "weights")
    d = d.to(fdt)
    kstep, cstep = steps(y, mask, kind, dt != fdt)
    w = cuda_mu.mu_stats_dense if kind == "dense" else cuda_mu.mu_stats_masked
    before = w.wide_launches
    kstep((x, d), 0)
    assert w.wide_launches == before + 1, "not on the wide route"
    t = [cuda_ms(lambda: cstep((x, d), 0)), cuda_ms(lambda: kstep((x, d), 0))]
    t += [cuda_ms(lambda: kstep((x, d), 0)), cuda_ms(lambda: cstep((x, d), 0))]
    k_ms, c_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    b, by = bound_ms(kind, m, n, k, dt)
    print(f"turns {kind} {m}x{n} K={k} {str(dt)[6:]} data, "
          f"{str(fdt)[6:]} factors: "
          f"kernel path {k_ms:.4f} ms an iteration ({t[1]:.4f}, {t[2]:.4f}), "
          f"composition {c_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}) in turns, "
          f"kernel / composition {k_ms / c_ms:.3f}; the TPU kernel's bound "
          f"{b:.4f} ms ({by}), kernel path at {b / k_ms:.1%} of it ({card})",
          flush=True)
    if profile:
        launches(kstep, x, d, kind, m, n, k, dt, card)


def launch_name(key):
    """A profiled kernel's name without its namespaces and arguments:
    ``mask_xupd<3>``, ``wide_resid<3, MaskedResid<3, false, false>>``."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    return key.split("(")[0][:60]


def launches(kstep, x, d, kind, m, n, k, dt, card):
    """Each launch of one kernel-path iteration, timed apart by
    torch.profiler (csrc/mu_wide.cu's kernels by name, torch's own where
    the wrapper or the epilogue launches them)."""
    split(lambda: kstep((x, d), 0),
          f"{kind} iteration {m}x{n} K={k} {str(dt)[6:]}", card)


def kernel_name(mangled):
    """A kernel's name from its mangled one, roughly: the template and its
    first argument (``mask_xupd<3>``), past the anonymous namespace."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    parts = []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group(0)
        parts.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    name = next((p for p in parts if "GLOBAL__N" not in p), mangled[:40])
    arg = re.match(r"ILi(\d+)E", rest)
    return name + (f"<{arg.group(1)}>" if arg else "")


def ptxas_lines(log):
    """ptxas' register and spill lines of each kernel in a build log, each
    under its kernel's name (``kernel_name``), and its warnings."""
    out = []
    for ln in open(log).read().splitlines():
        if "Performance Loss" in ln:
            out.append("warning in " + kernel_name(ln.split("'")[-2])
                       + ": " + ln.split(": ", 1)[1][:110])
        elif "entry function" in ln:
            out.append("kernel " + kernel_name(ln.split("'")[1]))
        elif "registers" in ln or "spill" in ln:
            out.append("  " + ln.strip())
    return "\n".join(out)


def masked_path(g, dev, card, reps=10):
    """Each masked instance (f32 and bf16 data on bits and on weights, f32
    x) at one call at PATH, ``reps`` calls timed by CUDA events, beside the
    TPU kernel's bound, and its launches timed apart by torch.profiler.
    Uses only the public wrappers, so it times any tree's route."""
    m, n, k = PATH
    for dt in (F32, BF16):
        for kind in ("bits", "weights"):
            y, mask, x, d = inputs(g, dev, m, n, k, dt, F32, True,
                                   kind == "weights")
            km = cuda_mu.pack_mask(mask) if kind == "bits" else mask

            def call():
                return cuda_mu.mu_stats_masked(y, km, x, d, EPS)

            ms = cuda_ms(call, reps)
            b, by = bound_ms(kind, m, n, k, dt)
            print(f"masked path {kind} {m}x{n} K={k} {str(dt)[6:]} data, "
                  f"float32 x: {ms:.4f} ms a call ({reps} calls); the TPU "
                  f"kernel's bound {b:.4f} ms ({by}), at {b / ms:.1%} of it "
                  f"({card})", flush=True)
            split(call, f"call, {kind} {str(dt)[6:]}", card)
            del y, mask, x, d, km
            torch.cuda.empty_cache()


def split(call, tag, card, calls=5):
    """The launches of ``call`` timed apart by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        parts.append((e.self_device_time_total / calls / 1e3, e.count // calls,
                      launch_name(e.key)))
    total = sum(p[0] for p in parts)
    print(f"  launches of one {tag} ({total:.4f} ms of device time): "
          + ", ".join(f"{nm} x{c} {ms:.4f} ms"
                      for ms, c, nm in sorted(parts)[::-1])
          + f" ({card})", flush=True)


def main():
    if not torch.cuda.is_available():
        print("mu_wide_turns: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(ptxas_lines(str(_build.build("mu_wide")) + ".log"), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(26)
    if "--path" in sys.argv:
        masked_path(g, dev, card)
        return 0
    masked_only = "--masked" in sys.argv
    kinds = ("bits", "weights") if masked_only else ("dense", "bits",
                                                      "weights")
    ok = True
    for dt, xdts in ((F32, (F32,)), (BF16, (F32, BF16))):
        for xdt in xdts:
            for m, n, k in ((333, 257, 129), (1000, 1000, 200),
                            (1000, 1000, 256)):
                if not masked_only:
                    for inner in (1, 3):
                        ok &= check(g, dev, m, n, k, dt, xdt, "dense", inner)
                for kind in ("bits", "weights"):
                    ok &= check(g, dev, m, n, k, dt, xdt, kind)
    if "--check-only" not in sys.argv:
        for dt in (F32, BF16):
            for kind in kinds:
                for n in WIDTHS:
                    if cuda_mu.rank_fits(n, 256, dt.itemsize, kind != "dense"):
                        turns(g, dev, 100_000, n, 256, dt, kind, card,
                              profile=n == 1024 and dt == F32)
                for n, k in CORNERS[dt, kind != "dense"]:
                    turns(g, dev, 32_768 if n == 1024 else 4096, n, k, dt,
                          kind, card)
                if dt == BF16:   # bf16 factors too (no factor_dtype)
                    for n in (64, 1024):
                        turns(g, dev, 100_000, n, 256, dt, kind, card,
                              fdt=BF16)
                    n, k = CORNERS[dt, kind != "dense"][1]
                    turns(g, dev, 4096, n, k, dt, kind, card, fdt=BF16)
                torch.cuda.empty_cache()
    print("mu_wide_turns:", "all checks passed" if ok else "FAILED",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
