"""The wide-rank KL-MU route on one CUDA card: csrc/mu_wide.cu's KL entries,
the route of ``cuda_mu.kl_stats_dense`` and ``kl_stats_masked`` above rank
128 (f32 data as bf16x6, bf16 data in one limb; the mask as bits or as a
dense mask), against its twins, and one solver iteration in turns with the
composition that ``use_kernel='auto'`` runs where it does not take the
route.

1. Builds mu_wide.cu and prints ptxas' register and spill lines.
2. Holds each instance (dense f32 and bf16; masked f32 on bits and on
   weights; masked bf16 on bits, on a dense 0/1 mask and on weights) to
   its twin (relative Frobenius of x_new and of each statistic: 2e-6 f32,
   5e-5 bf16 and 2e-4 for bf16 x_new, chip_smoke.py's LIMIT and
   X_BF16_LIMIT) at ragged shapes (333 x 257, K = 129, with eps = EPS and
   eps = 0; 1,000 x 1,000, K = 200 and 256), and f32 on log-normal my, x
   and d over six decades at 65,536 x 1,024, K = 200, with a bit-identical
   rerun and every call counted in ``.wide_launches``.
3. Unless ``--check-only``: times one iteration of ``nmf.solve``'s kernel
   path (``nmf._kernel_step``: the wrapper and the d epilogue; a 0/1 mask
   packed once where the route takes bits (f32), outside the timing) in
   turns with one of its composition path (``nmf._UPDATES``: the x update
   and the d update) at K = 256 with N = 64, 128, 256, 512 and 1,024 (M =
   100,000), and at each corner of the KL gate (``rank_fits``: the largest
   K at N = 128, 256, 512, 1,024 and, bf16 dense, 2,048; M = 4,096 at N =
   128, 32,768 above), f32 and bf16 (factors in the data's dtype: the KL
   kernels take no ``factor_dtype``), dense, a 0/1 mask and weights; each
   beside the TPU kernel's own bound. The kernel path's launches are timed
   apart by torch.profiler at 100,000 x 1,024, K = 256, f32. These turns
   are the data behind ``nmf._auto_rank``'s KL entries.

Run from the repository root on the card's machine:

    python3 tools/kl_wide_turns.py [--check-only]
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decomp_tpu_torch.models import nmf  # noqa: E402
from decomp_tpu_torch.ops import _build, cuda_mu  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
LIMIT = {F32: 2e-6, BF16: 5e-5}
X_BF16_LIMIT = 2e-4
EPS = 1e-6
WIDTHS = (64, 128, 256, 512, 1024)
HBM = 3.35e12
PEAK = 989e12


def corners(dt, masked):
    """The KL gate's corners (N, largest K) above rank 128."""
    out = []
    for n in (128, 256, 512, 1024, 2048):
        k = max((k for k in range(256, 5120, 128)
                 if cuda_mu.kernel_takes_rank("kl-mu", n, k, dt, masked)),
                default=None)
        if k is not None:
            out.append((n, k))
    return out


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


def inputs(g, dev, m, n, k, dt, kind, lognormal=False):
    """my (= mask y where masked), the mask (30% missing; weights: the
    observed entries in [0.5, 1)), x and d, all in ``dt``: uniform, x and
    d in [0.1, 1.1); or (``lognormal``) my, x and d e^(ln 10 z) for
    standard normal z, six decades."""
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    if kind == "weights":
        mask *= 0.5 + 0.5 * torch.rand((m, n), generator=g, device=dev)
    if lognormal:
        ln10 = float(np.log(10.0))
        y, x, d = (torch.exp(ln10 * torch.randn(s, generator=g, device=dev))
                   for s in ((m, n), (m, k), (k, n)))
    else:
        y = torch.rand((m, n), generator=g, device=dev)
        x = 0.1 + torch.rand((m, k), generator=g, device=dev)
        d = 0.1 + torch.rand((k, n), generator=g, device=dev)
    if kind != "dense":
        y *= mask
    return y.to(dt), mask.to(dt), x.to(dt), d.to(dt)


def check(g, dev, m, n, k, dt, kind, eps=EPS, lognormal=False):
    """One instance against its twin; ``kind``: dense, bits, 0/1 (a dense
    0/1 mask) or weights."""
    y, mask, x, d = inputs(g, dev, m, n, k, dt, kind, lognormal)
    if kind == "dense":
        w = cuda_mu.kl_stats_dense

        def call():
            return w(y, x, d, eps)

        ref = cuda_mu.kl_stats_dense_plain(y, x, d, eps)
    else:
        w = cuda_mu.kl_stats_masked
        km = cuda_mu.pack_mask(mask) if kind == "bits" else mask

        def call():
            return w(y, km, x, d, eps)

        ref = cuda_mu.kl_stats_masked_plain(y, mask, x, d, eps)
    before = w.wide_launches
    out, again = call(), call()
    torch.cuda.synchronize()
    errs = [rel_fro(a, b) for a, b in zip(out, ref)]
    limits = [X_BF16_LIMIT if dt == BF16 else LIMIT[dt]] + [LIMIT[dt]] * 2
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    routed = w.wide_launches - before == 2
    ok = (all(e <= lim for e, lim in zip(errs, limits)) and same and routed)
    print(f"{kind} {m}x{n} K={k} {str(dt)[6:]} eps={eps:g}"
          f"{' log-normal' if lognormal else ''}: rel_fro x_new "
          f"{errs[0]:.3e}, numd {errs[1]:.3e}, "
          f"{'xsum' if kind == 'dense' else 'dend'} {errs[2]:.3e} (limits "
          f"{limits[0]:g}, {limits[1]:g}); bit-identical rerun {same}; on "
          f"the wide route {routed}{'' if ok else '  <-- FAIL'}", flush=True)
    return ok


def bound_ms(kind, m, n, k, dt):
    """(ms, by) of the TPU kernel's own work: my (and the mask: bits or a
    dense mask) read once, x read and x_new written, d read, the
    statistics written; dense 8MNK, masked 12MNK operations, at f32 six
    bf16 passes (three for the two products with a 0/1 mask)."""
    e = dt.itemsize
    masked = kind != "dense"
    mask_b = (4 * m * cuda_mu.packed_words(n) if kind == "bits"
              else e * m * n if masked else 0)
    nbytes = (e * (m * n + k * n + 2 * m * k) + mask_b
              + 4 * (2 * k * n if masked else k * n + k))
    ops = (12.0 if masked else 8.0) * m * n * k
    if dt == F32:
        ops = 6.0 * ops - (3.0 * 4.0 * m * n * k if kind == "bits" else 0.0)
    t_b = nbytes / HBM * 1e3
    t_o = ops / PEAK * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def steps(y, mask, kind):
    """(kernel step, composition step): one iteration of each of
    nmf.solve's paths on (x, d); ``y`` is the masked data my where
    masked."""
    eps = torch.tensor(EPS, dtype=y.dtype)
    km = None if kind == "dense" else mask
    kstep = nmf._kernel_step(y, km, "kl-mu", EPS, None, 1)
    upd_x, upd_d = nmf._UPDATES["kl-mu", False]

    def cstep(state, it):
        x_, d_ = state
        x_ = upd_x(y, x_, d_, km, eps, nmf._identity)
        return x_, upd_d(y, x_, d_, km, eps, nmf._identity)

    return kstep, cstep


def turns(g, dev, m, n, k, dt, kind, card, profile=False):
    """One iteration of each path in turns (composition, kernel, kernel,
    composition); ``kind``: dense, 0/1 (bits on the route at f32, a dense
    0/1 mask at bf16) or weights."""
    y, mask, x, d = inputs(g, dev, m, n, k, dt,
                           "weights" if kind == "weights" else
                           "dense" if kind == "dense" else "bits")
    kstep, cstep = steps(y, mask, kind)
    w = cuda_mu.kl_stats_dense if kind == "dense" else cuda_mu.kl_stats_masked
    before = w.wide_launches
    kstep((x, d), 0)
    assert w.wide_launches == before + 1, "not on the wide route"
    t = [cuda_ms(lambda: cstep((x, d), 0)), cuda_ms(lambda: kstep((x, d), 0))]
    t += [cuda_ms(lambda: kstep((x, d), 0)), cuda_ms(lambda: cstep((x, d), 0))]
    k_ms, c_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    b, by = bound_ms("bits" if kind == "0/1" and dt == F32 else
                     "dense" if kind == "dense" else "weights", m, n, k, dt)
    print(f"turns {kind} {m}x{n} K={k} {str(dt)[6:]}: kernel path "
          f"{k_ms:.4f} ms an iteration ({t[1]:.4f}, {t[2]:.4f}), composition "
          f"{c_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}) in turns, kernel / "
          f"composition {k_ms / c_ms:.3f}; the TPU kernel's bound {b:.4f} ms "
          f"({by}), kernel path at {b / k_ms:.1%} of it ({card})", flush=True)
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
        print("kl_wide_turns: no CUDA device", file=sys.stderr)
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
    g = torch.Generator(device=dev).manual_seed(27)
    ok = True
    for dt, kinds in ((F32, ("dense", "bits", "weights")),
                      (BF16, ("dense", "bits", "0/1", "weights"))):
        for m, n, k in ((333, 257, 129), (1000, 1000, 200),
                        (1000, 1000, 256)):
            for kind in kinds:
                ok &= check(g, dev, m, n, k, dt, kind)
        for kind in kinds:
            ok &= check(g, dev, 333, 257, 129, dt, kind, eps=0.0)
    for kind in ("dense", "bits"):
        ok &= check(g, dev, 65536, 1024, 200, F32, kind, lognormal=True)
    torch.cuda.empty_cache()
    if "--check-only" not in sys.argv:
        for dt in (F32, BF16):
            for kind in ("dense", "0/1", "weights"):
                for n in WIDTHS:
                    turns(g, dev, 100_000, n, 256, dt, kind, card,
                          profile=n == 1024 and dt == F32)
                for n, k in corners(dt, kind != "dense"):
                    turns(g, dev, 4096 if n == 128 else 32_768, n, k, dt,
                          kind, card)
                torch.cuda.empty_cache()
    print("kl_wide_turns:", "all checks passed" if ok else "FAILED",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
