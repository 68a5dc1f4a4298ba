"""The wide masked gradients on one CUDA card: csrc/grad_wide.cu, the route
of ``masked_grad_rows`` and ``masked_grad_dict`` above 128 features (f32
data as bf16x6, bf16 data in one limb, on packed and weighted masks),
against their twins, and in turns with the composition that
``use_kernel='auto'`` runs where it does not take them.

1. Builds grad_wide.cu and prints ptxas' spill lines.
2. Holds each of the four instances (f32 / bf16 x bits / weights) of both
   gradients to its twin (relative Frobenius, limit 2e-6 f32, 2.5e-4 bf16
   as chip_smoke.py's GRAD_LIMIT) at ragged shapes (333 x 257, F = 129; 7
   x 1,000, F = 200; 1,000 x 1,000, F = 256 and 300), with a bit-identical
   rerun and every launch counted on the wide route; x's limbs from the
   split launch bit for bit against ``cuda_mu.column_limbs``.
3. Unless ``--check-only``: times each instance per call in turns with the
   composition (composition, kernel, kernel, composition; CUDA events) at
   ``TURNS``' shapes: 100,000 x 1,024, F = K = 256, the gate's corners at
   N = 1,024 (F = K = 1,152 f32, 2,432 bf16; M cut to 32,768), config 3's
   20,000 x 64 with 256 atoms, and f32's corner at N = 128 (F = K =
   10,112, M cut to 16,384), each beside its bound (the TPU kernel's own
   work: no E) and E's round trip, and the twin's error there. The
   composition is the solves' own: ``(mask * (x @ a) - my) @ a^T`` and
   ``x^T @ (mask * (x @ d) - my)`` on the dense mask.
   Each call's launches (x's split, the residual, the product, the
   reduction) are timed apart by torch.profiler over 5 calls at 100,000
   x 1,024, F = K = 256. With ``--rule`` it times instead f32 alone at
   ``RULE``'s grid, between config 3's 20,000 x 64 with 256 atoms and the
   shapes above.

Run from the repository root on the card's machine:

    python3 tools/grad_wide_turns.py [--check-only | --rule]
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decomp_tpu_torch.ops import _build, cuda_dl, cuda_lasso, cuda_mu  # noqa

LIMIT = {torch.float32: 2e-6, torch.bfloat16: 2.5e-4}
# The timed shapes (M, N, F = K): 256 wide at 100,000 x 1,024, the gate's
# corner at N = 1,024 (M cut to 32,768), config 3's 20,000 x 64 with 256
# atoms, and f32's corner at N = 128 (M cut to 16,384).
TURNS = {torch.float32: ((100_000, 1024, 256), (32_768, 1024, 1152),
                         (20_000, 64, 256), (16_384, 128, 10_112)),
         torch.bfloat16: ((100_000, 1024, 256), (32_768, 1024, 2432),
                          (20_000, 64, 256))}
# --rule: f32 alone, between config 3's shape, where the composition is
# faster, and those where the wide route is: the grid behind 'auto''s
# rule (lasso._auto_width).
RULE = ((100_000, 64, 256), (20_000, 128, 256), (100_000, 128, 256),
        (16_384, 128, 1024), (100_000, 256, 256), (20_000, 1024, 256))
HBM = 3.35e12
PEAK = 989e12


def cuda_ms(fn, reps=10):
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


def inputs(g, dev, m, n, f, dt, weighted):
    """my = mask y, the mask (30% missing; weighted: observed entries in
    [0.5, 1)), x and a (or d)."""
    mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
    if weighted:
        mask *= 0.5 + 0.5 * torch.rand((m, n), generator=g, device=dev)
    my = torch.randn((m, n), generator=g, device=dev) * mask
    x = torch.randn((m, f), generator=g, device=dev)
    a = torch.randn((f, n), generator=g, device=dev) / n ** 0.5
    return tuple(t.to(dt) for t in (my, mask, x, a))


def kernel_args(args, weighted):
    my, mask, x, a = args
    return (my, mask if weighted else cuda_mu.pack_mask(mask), x, a)


FNS = {"rows": cuda_lasso.masked_grad_rows, "dict": cuda_dl.masked_grad_dict}
PLAINS = {"rows": cuda_lasso.masked_grad_rows_plain,
          "dict": cuda_dl.masked_grad_dict_plain}


def composition(kind, my, mask, x, a):
    if kind == "rows":
        return (mask * (x @ a) - my) @ a.T
    return x.T @ (mask * (x @ a) - my)


def check(kind, args, weighted, tag):
    fn = FNS[kind]
    kargs = kernel_args(args, weighted)
    before = (fn.wide_launches, fn.launches)
    out, again = fn(*kargs), fn(*kargs)
    ref = PLAINS[kind](*args)
    torch.cuda.synchronize()
    err = rel_fro(out, ref)
    same = torch.equal(out, again)
    routed = (fn.wide_launches - before[0], fn.launches - before[1]) == (2, 2)
    my = args[0]
    ok = err <= LIMIT[my.dtype] and same and routed
    print(f"{kind} {'weighted' if weighted else 'bits'} "
          f"{my.shape[0]}x{my.shape[1]} F={args[2].shape[1]} "
          f"{str(my.dtype)[6:]} {tag}: rel_fro {err:.3e} (limit "
          f"{LIMIT[my.dtype]:g}); bit-identical rerun {same}; on the wide "
          f"route {routed}{'' if ok else '  <-- FAIL'}", flush=True)
    return ok


def bound_ms(kind, m, n, f, dt, weighted):
    """(ms, by, E's round trip ms): the TPU kernel's own work."""
    e = dt.itemsize
    mask_b = e * m * n if weighted else 4 * m * cuda_mu.packed_words(n)
    if kind == "rows":
        nbytes = e * (m * n + 2 * m * f) + mask_b + e * f * n
    else:
        nbytes = e * (m * n + m * f + f * n) + mask_b + 4 * f * n
    passes = 6 if dt == torch.float32 else 1
    t_b, t_o = nbytes / HBM * 1e3, passes * 4.0 * m * n * f / PEAK * 1e3
    return ((t_b, "bytes") if t_b >= t_o else (t_o, "operations"),
            2 * e * m * n / HBM * 1e3)


def turns(kind, args, weighted, card):
    fn = FNS[kind]
    kargs = kernel_args(args, weighted)
    my, mask, x, a = args
    (m, n), f, dt = my.shape, x.shape[1], my.dtype
    err = rel_fro(fn(*kargs), PLAINS[kind](*args))
    t = [cuda_ms(lambda: composition(kind, *args)),
         cuda_ms(lambda: fn(*kargs))]
    t += [cuda_ms(lambda: fn(*kargs)),
          cuda_ms(lambda: composition(kind, *args))]
    k_ms, c_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    (b, by), e_ms = bound_ms(kind, m, n, f, dt, weighted)
    print(f"{kind} {'weighted' if weighted else 'bits'} {m}x{n} F={f} "
          f"{str(dt)[6:]}: wide kernel {k_ms:.4f} ms ({t[1]:.4f}, "
          f"{t[2]:.4f}), composition {c_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}) "
          f"in turns, kernel / composition {k_ms / c_ms:.3f}; bound "
          f"{b:.4f} ms ({by}), kernel at {b / k_ms:.1%} of it; E's round "
          f"trip {e_ms:.4f} ms of bytes beside it; rel_fro against the twin "
          f"{err:.3e} ({card})", flush=True)


def launches(kind, args, weighted, card, calls=5):
    """Each launch of one call, timed apart by torch.profiler (the
    kernels' names in grad_wide.cu's anonymous namespace, and
    torch's own where the wrapper launches them)."""
    from torch.profiler import ProfilerActivity, profile

    fn = FNS[kind]
    kargs = kernel_args(args, weighted)
    fn(*kargs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*kargs)
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        name = e.key.split("::")[-1].split("(")[0].split("<")[0][:40]
        parts.append((e.self_device_time_total / calls / 1e3, name))
    my = args[0]
    print(f"  launches of {kind} {'weighted' if weighted else 'bits'} "
          f"{my.shape[0]}x{my.shape[1]} F={args[2].shape[1]} "
          f"{str(my.dtype)[6:]} per call: "
          + ", ".join(f"{n} {ms:.4f} ms" for ms, n in sorted(parts)[::-1])
          + f" ({card})", flush=True)


def main():
    if not torch.cuda.is_available():
        print("grad_wide_turns: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log = open(str(_build.build("grad_wide")) + ".log").read()
    print(log, flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(25)
    ok = True
    f32, bf16 = torch.float32, torch.bfloat16
    for m, n, k in ((333, 257, 129), (1000, 1000, 129), (333, 257, 300)):
        x = torch.randn((m, k), generator=g, device=dev)
        kp = cuda_lasso.grad_width(k)
        same = torch.equal(cuda_dl._split_rows(x, kp),
                           cuda_mu.column_limbs(x.T, kp))
        print(f"x's limbs {m}x{k} (width {kp}) from the split launch equal "
              f"column_limbs: {same}", flush=True)
        ok &= same
    for dt in (f32, bf16):
        for weighted in (False, True):
            for m, n, f in ((333, 257, 129), (7, 1000, 200),
                            (1000, 1000, 256), (1000, 1000, 300)):
                args = inputs(g, dev, m, n, f, dt, weighted)
                for kind in ("rows", "dict"):
                    ok &= check(kind, args, weighted, "")
    if "--rule" in sys.argv:
        for m, n, f in RULE:
            for weighted in (False, True):
                args = inputs(g, dev, m, n, f, f32, weighted)
                for kind in ("rows", "dict"):
                    turns(kind, args, weighted, card)
                del args
    elif "--check-only" not in sys.argv:
        for dt, shapes in TURNS.items():
            for m, n, f in shapes:
                for weighted in (False, True):
                    args = inputs(g, dev, m, n, f, dt, weighted)
                    for kind in ("rows", "dict"):
                        turns(kind, args, weighted, card)
                        if (m, n, f) == shapes[0]:
                            launches(kind, args, weighted, card)
                    del args
    print("grad_wide_turns:", "all checks passed" if ok else "FAILED",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
