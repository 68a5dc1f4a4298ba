"""The wide route of ``solve_rows`` on one CUDA card: csrc/lasso_fista_wide.cu
(above 1,024 features, up to the TPU kernel's gate; a thread-block cluster
of ceil(F / 512) blocks a group of 16 row slots), in turns with what it is
measured against.

1. Builds lasso_fista_wide.cu and prints ptxas' register and spill lines.
2. The design: at F = 1,024, where the narrow 'high' kernel
   (csrc/lasso_fista_tma.cu: one block a stripe of 16 rows, the whole row
   on chip) also runs, the wide kernel (a cluster of 2) on the same inputs
   in turns (narrow, wide, wide, narrow; CUDA events): 20,000 rows for 50
   fixed-budget iterations (ns per row-iteration) and config 2's recipe at
   10,000 x 1,024 to tol 1e-4 (acc_ista; the slot waste beside it). One
   block a stripe with the row in device memory between chunks (the other
   design) cannot beat the narrow kernel, which keeps it on chip.
3. ``lasso.solve(per_problem=True)`` with ``use_kernel=True`` (the wide
   route) in turns with ``use_kernel=False`` (the composition; composition,
   kernel, kernel, composition), acc_ista, tol 1e-4, alpha 0.1, at 'high'
   and 'highest', on config 2's recipe (numpy, seed 1: a normal
   dictionary, 5%-sparse truth, 0.01 noise) at ``TURNS``' shapes: 10,000
   problems over 1,408 features and 640 complex features (the path of
   chip_smoke.py's phase 10d), each at N = F / 2 and F / 4, 1,152
   features at F / 2, the gate without momentum (1,536 features, ista),
   and small batches (7, 64 and 1,000 problems over 1,152 features and
   640 complex features, where a few clusters run the whole solve); the
   rows' Σ niter of each and the ratio, the measurement behind 'auto''s
   rule (``lasso._auto_whole_width``).
4. The limits of phase 10d, over ``LIMIT_SEEDS`` (config 2's recipe with
   other seeds at the path's two shapes): x of the 'high' run against the
   'highest' run and the composition run, and of 'highest' against the
   composition; solve_rows against its twin to tol 1e-4 and in the fixed
   budget; and two controls that the limits should tell from the twin:
   the twin on a one-limb Gram (a kernel that drops the hi.lo product; at
   most 1,000 iterations to tol) and the twin stopped at tol 1e-3 (a
   stopping fault). Then phase 10d's
   dictionary learning (1,152 atoms) against the composition over three
   seeds.

Run from the repository root on the card's machine:

    python3 tools/solve_wide_turns.py
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (C2W_SHAPE, C2WC_SHAPE,  # noqa: E402
                        WIDE_PATH_FIXED_ITERS, config2_complex_data,
                        config2_data, one_limb, rel_fro, wide_dl_data)
from decomp_tpu_torch import dictionary_learning  # noqa: E402
from decomp_tpu_torch import lasso  # noqa: E402
from decomp_tpu_torch.ops import _build, cuda_lasso  # noqa: E402
from decomp_tpu_torch.ops.spectral import spectral_norm_psd  # noqa: E402

# (M, F, N, complex, method): the path's shapes at N = F / 2 and F / 4,
# the gate without momentum, and small batches.
TURNS = ((10_000, 1408, 704, False, "acc_ista"),
         (10_000, 1408, 352, False, "acc_ista"),
         (10_000, 1152, 576, False, "acc_ista"),
         (10_000, 640, 320, True, "acc_ista"),
         (10_000, 640, 160, True, "acc_ista"),
         (10_000, 1536, 768, False, "ista"),
         (7, 1152, 576, False, "acc_ista"), (64, 1152, 576, False, "acc_ista"),
         (1000, 1152, 576, False, "acc_ista"), (7, 640, 320, True, "acc_ista"),
         (64, 640, 320, True, "acc_ista"), (1000, 640, 320, True, "acc_ista"))
LIMIT_SEEDS = (1, 2, 3, 4, 5)


def event_ms(fn):
    """(ms, result) of one call between CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def turns(fns):
    """Each of two callables once to warm up, then in turns a, b, b, a:
    the mean ms of each and the last results."""
    a, b = fns
    a(), b()
    torch.cuda.synchronize()
    ta1, _ = event_ms(a)
    tb1, _ = event_ms(b)
    tb2, rb = event_ms(b)
    ta2, ra = event_ms(a)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2, ra, rb


def data(m, f, n, complex_, seed=1):
    """Config 2's recipe at M x F over N channels (complex:
    config-2-complex's), as chip_smoke.py makes it (numpy, seed 1)."""
    return (config2_complex_data(m, f, n, seed) if complex_
            else config2_data(m, f, n, seed)[:2])


def design(dev, card):
    """Step 2: the narrow kernel against the wide one at F = 1,024."""
    for fixed in (True, False):
        m, f, n = (20_000, 1024, 512) if fixed else (10_000, 1024, 512)
        y_np, a_np = data(m, f, n, False)
        y, a = (torch.from_numpy(v).to(dev) for v in (y_np, a_np))
        gram, yah = a @ a.T, y @ a.T
        step = 1.0 / float(spectral_norm_psd(gram))
        x0 = torch.zeros((m, f), device=dev)
        t0 = torch.ones((m, 1), device=dev)
        d0 = torch.zeros((m, 1), device=dev)
        n0 = torch.zeros((m, 1), dtype=torch.int32, device=dev)
        args = (yah, gram, x0, x0, t0, d0, n0, step, 0.1 * step,
                0.0 if fixed else 1e-4)
        kw = dict(momentum=True, restart=True, hi_lo=True, fixed=fixed,
                  maxiter=50 if fixed else 4000)
        waste = {}

        def run(launch, name):
            def go():
                out = launch(*args, **kw)
                torch.cuda.synchronize()
                waste[name] = float(cuda_lasso.solve_rows.slot_iters.double()
                                    .sum() / (out[4] - n0).double().sum())
                return out
            return go

        t_n, t_w, r_n, r_w = turns((run(cuda_lasso._solve_rows_tma, "narrow"),
                                    run(cuda_lasso._solve_rows_wide, "wide")))
        its = float((r_n[4] - n0).double().sum())
        err = float((r_w[0] - r_n[0]).double().norm()
                    / r_n[0].double().norm())
        print(f"design, F = 1,024, {m} rows, acc_ista 'high', "
              f"{'50 fixed-budget iterations' if fixed else 'tol 1e-4'} "
              f"({card}): narrow (lasso_fista_tma.cu, one block a stripe) "
              f"{t_n:.3f} ms, wide (lasso_fista_wide.cu, a cluster of 2) "
              f"{t_w:.3f} ms, wide / narrow {t_w / t_n:.3f}; "
              f"{t_n * 1e6 / its:.3f} / {t_w * 1e6 / its:.3f} ns per "
              f"row-iteration; slot waste {waste['narrow']:.4f} / "
              f"{waste['wide']:.4f}; Σ niter {its:.0f} / "
              f"{float((r_w[4] - n0).double().sum()):.0f}; rel_fro x "
              f"{err:.3e}", flush=True)


def limits(dev, card):
    """Step 4: phase 10d's comparisons over seeds, with two controls."""
    cfg = dict(tol=1e-4, maxiter=4000, method="acc_ista", per_problem=True)
    w, plain = cuda_lasso.solve_rows, cuda_lasso.solve_rows_plain
    for complex_, (m, f, n) in ((False, C2W_SHAPE), (True, C2WC_SHAPE)):
        for seed in LIMIT_SEEDS:
            y_np, a_np = data(m, f, n, complex_, seed)
            y, a = (torch.from_numpy(v).to(dev) for v in (y_np, a_np))

            def solve(**kw):
                return lasso.solve(y, a, 0.1, **cfg, **kw)

            hi = solve(precision="high", use_kernel=True)
            top = solve(precision="highest", use_kernel=True)
            comp = solve(use_kernel=False)
            ah = a.conj().T
            gram, yah = a @ ah, y @ ah
            step = 1.0 / float(spectral_norm_psd(gram))
            x0 = torch.zeros((m, f), dtype=y.dtype, device=dev)
            t0 = torch.ones((m, 1), device=dev)
            d0 = torch.zeros((m, 1), device=dev)
            n0 = torch.zeros((m, 1), dtype=torch.int32, device=dev)
            args = (yah, gram, x0, x0, t0, d0, n0, step, 0.1 * step)
            kw = dict(momentum=True, restart=True, maxiter=4000, hi_lo=True)
            got, ref = w(*args, 1e-4, **kw), plain(*args, 1e-4, **kw)
            # The path's rows stop within 600 iterations; a control that
            # has not stopped by 1,000 is read there.
            ctl = plain(yah, one_limb(gram), *args[2:], 1e-4,
                        **dict(kw, maxiter=1000))
            early = plain(*args, 1e-3, **kw)
            fkw = dict(kw, maxiter=WIDE_PATH_FIXED_ITERS, fixed=True)
            fixed, fref = w(*args, 0.0, **fkw), plain(*args, 0.0, **fkw)
            fctl = plain(yah, one_limb(gram), *args[2:], 0.0, **fkw)
            eq = float((got[4] == ref[4]).float().mean())

            def xz(o):
                return max(rel_fro(o[0], fref[0]), rel_fro(o[1], fref[1]))

            print(f"limits {m} x {f}{'c' if complex_ else ''} x {n}, seed "
                  f"{seed} ({card}): rel_fro x 'high' vs 'highest' "
                  f"{rel_fro(hi.x, top.x):.3e}, vs composition "
                  f"{rel_fro(hi.x, comp.x):.3e}, 'highest' vs composition "
                  f"{rel_fro(top.x, comp.x):.3e}, one-limb twin vs "
                  f"composition {rel_fro(ctl[0], comp.x):.3e}, twin at tol "
                  f"1e-3 vs composition {rel_fro(early[0], comp.x):.3e}; "
                  f"solve_rows vs twin: niter equal on {eq:.4f} of rows, x "
                  f"{rel_fro(got[0], ref[0]):.3e}, one-limb twin "
                  f"{rel_fro(ctl[0], ref[0]):.3e}, twin at tol 1e-3 "
                  f"{rel_fro(early[0], ref[0]):.3e}; {WIDE_PATH_FIXED_ITERS} "
                  f"fixed-budget iterations: x, z {xz(fixed):.3e}, one-limb "
                  f"twin {xz(fctl):.3e}", flush=True)
            del y, a, hi, top, comp, gram, yah, args, got, ref, ctl, early
            del fixed, fref, fctl
    for seed in (28, 29, 30):
        y, d0 = wide_dl_data(dev, seed)
        res, comp = (dictionary_learning.solve(
            y, d0, 0.05, maxiter=2, lasso_iter=8, lasso_tol=0.0,
            use_kernel=kernel) for kernel in (True, False))
        print(f"limits dictionary_learning.solve {y.shape[0]} x "
              f"{y.shape[1]}, {d0.shape[0]} atoms, 2 x 8 at lasso_tol 0, "
              f"seed {seed} ({card}): rel_fro vs use_kernel=False d "
              f"{rel_fro(res.d, comp.d):.3e}, x {rel_fro(res.x, comp.x):.3e}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("solve_wide_turns: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = _build.build("lasso_fista_wide")
    for ln in open(str(lib) + ".log").read().splitlines():
        if "registers" in ln or "spill" in ln:
            print("ptxas:", ln.strip(), flush=True)
    design(dev, card)
    cfg = dict(tol=1e-4, maxiter=4000, per_problem=True)
    for m, f, n, complex_, method in TURNS:
        y_np, a_np = data(m, f, n, complex_)
        y, a = (torch.from_numpy(v).to(dev) for v in (y_np, a_np))
        for precision in ("high", "highest"):
            w = cuda_lasso.solve_rows
            before = w.wide_launches

            def solve(kernel):
                return lambda: lasso.solve(y, a, 0.1, precision=precision,
                                           use_kernel=kernel, method=method,
                                           **cfg)

            t_c, t_k, r_c, r_k = turns((solve(False), solve(True)))
            check = w.wide_launches - before == 3
            err = float((r_k.x - r_c.x).abs().pow(2).sum().sqrt()
                        / r_c.x.abs().pow(2).sum().sqrt())
            print(f"lasso.solve {m} x {f}{'c' if complex_ else ''} x {n}, "
                  f"{method}, tol 1e-4, '{precision}' ({card}): wide route "
                  f"{t_k:.3f} ms (Σ niter {int(r_k.niter.double().sum())}, "
                  f"max {int(r_k.niter.max())}), composition {t_c:.3f} ms "
                  f"(max niter {int(r_c.niter.max())}), kernel / "
                  f"composition {t_k / t_c:.3f}; rel_fro x {err:.3e}; "
                  f"every kernel call on the wide route {check}", flush=True)
        del y, a
    limits(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
