"""The wide-rank MU route on one CUDA card: csrc/mu_wide.cu, the route of
``cuda_mu.mu_stats_dense`` and ``mu_stats_masked`` above rank 128 (f32 data
as bf16x6, bf16 data in one limb; the mask as bits or as weights), against
its twins, and one solver iteration in turns with the composition that
``use_kernel='auto'`` runs where it does not take the route.

1. Builds mu_wide.cu and prints ptxas' register and spill lines.
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

Run from the repository root on the card's machine:

    python3 tools/mu_wide_turns.py [--check-only]
"""

import os
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


def launches(kstep, x, d, kind, m, n, k, dt, card, calls=5):
    """Each launch of one kernel-path iteration, timed apart by
    torch.profiler (csrc/mu_wide.cu's kernels by name, torch's own where
    the wrapper or the epilogue launches them)."""
    from torch.profiler import ProfilerActivity, profile

    kstep((x, d), 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kstep((x, d), 0)
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        name = e.key.split("::")[-1].split("(")[0][:48]
        parts.append((e.self_device_time_total / calls / 1e3, e.count // calls,
                      name))
    total = sum(p[0] for p in parts)
    print(f"  launches of one {kind} iteration {m}x{n} K={k} {str(dt)[6:]} "
          f"({total:.4f} ms of device time): "
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
    log = open(str(_build.build("mu_wide")) + ".log").read()
    print("\n".join(ln for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(26)
    ok = True
    for dt, xdts in ((F32, (F32,)), (BF16, (F32, BF16))):
        for xdt in xdts:
            for m, n, k in ((333, 257, 129), (1000, 1000, 200),
                            (1000, 1000, 256)):
                for inner in (1, 3):
                    ok &= check(g, dev, m, n, k, dt, xdt, "dense", inner)
                for kind in ("bits", "weights"):
                    ok &= check(g, dev, m, n, k, dt, xdt, kind)
    if "--check-only" not in sys.argv:
        for dt in (F32, BF16):
            for kind in ("dense", "bits", "weights"):
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
