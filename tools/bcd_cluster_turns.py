"""Check and time ``bcd_sweep``'s cluster route (``csrc/dl_bcd_cluster.cu``)
on one CUDA card, at every cluster size it may take.

For each shape of ``SHAPES`` (the TPU gate's corners, the shapes just past
the register route, phase 14b's 256 x 208, ragged ones, and a dead atom
on every instance of the kernel, R = 1, 2, 4 and 8 groups a thread, with
d partly in the global scratch)
the kernel runs at its own cluster size (``cuda_dl.bcd_cluster_size``) and
at each of ``--clusters`` (the private ``_bcd_cluster_plan_at`` and
``_bcd_cluster_run``); each
run is held to the plain twin (relative Frobenius of d within
``chip_smoke.BCD_LIMIT``), rerun for the same bits, and, with ``--time``,
timed with CUDA events (``--reps`` sweeps) in turns with the other sizes
(sizes in order, then in reverse). At 256 x 208 the first design,
``csrc/dl_bcd.cu``, is timed in the same turns; at 256 x 64 the register
route. Each shape runs in a child process under a time limit, so a kernel
that never ends costs that child, not the run. Every line carries the
card's name and power limit; the last line is a JSON list of the times.

A = x^T x and B = x^T y of random x (``--rows`` x K) and y, unit atoms d,
all made on the card from a seed per shape.

Run from the repository root on the card's machine:

    python3 tools/bcd_cluster_turns.py [--time] [--clusters 1,2,4,8]

``--shape i`` runs shape i of ``SHAPES`` alone, in this process (a fresh
process a reading, for repeated readings of one shape).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from decomp_tpu_torch.ops import _build, cuda_dl  # noqa: E402

BCD_LIMIT = 5e-6
# (K, N, dead atom or None)
SHAPES = [(256, 64, None), (256, 65, None), (257, 64, None),
          (256, 208, 3), (300, 777, None), (40, 1500, 5), (37, 3000, None),
          (256, 1024, None), (256, 3712, None), (8, 98176, None),
          (1736, 128, None), (1, 5, None), (1736, 1, None), (3, 98176, 1),
          (256, 3712, 3), (40, 20000, 3), (16, 50000, 3), (8, 98176, 3)]


def inputs(k, n, dead, rows, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, k), generator=g, device=dev)
    y = torch.randn((rows, n), generator=g, device=dev)
    if dead is not None:
        x[:, dead] = 0
    d = torch.randn((k, n), generator=g, device=dev)
    d /= torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return x.T @ x, x.T @ y, d


def rel_fro(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


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


def child(args, card):
    """One shape: check every cluster size, then time them in turns."""
    k, n, dead = SHAPES[args.shape]
    dev = torch.device("cuda", 0)
    a, b, d = inputs(k, n, dead, args.rows, 100 + args.shape, dev)
    own = cuda_dl.bcd_cluster_size(k, n)
    # A size whose blocks would own more than 12,288 columns is refused.
    sizes = sorted(c for c in {own, *args.clusters} if n <= 12_288 * c)
    ref = cuda_dl.bcd_sweep_plain(a, b, d)
    t0 = time.perf_counter()
    ref = cuda_dl.bcd_sweep_plain(a, b, d)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    fns, ok = {}, True
    for c in sizes:
        plan = cuda_dl._bcd_cluster_plan_at(k, n, c)
        fn = (lambda p=plan: cuda_dl._bcd_cluster_run(a, b, d, p))
        out, again = fn(), fn()
        torch.cuda.synchronize()
        err = rel_fro(out, ref)
        same = torch.equal(out, again)
        kept = dead is None or torch.equal(out[dead], d[dead])
        good = err <= BCD_LIMIT and same and kept
        ok &= good
        print(f"K={k} N={n} clusters={c}{' (own)' if c == own else ''} "
              f"{plan}: rel_fro {err:.3e} (limit {BCD_LIMIT:g}), rerun "
              f"bit-identical {same}, dead atom kept {kept}: "
              f"{'ok' if good else 'FAIL'} ({card})", flush=True)
        fns[f"cluster{c}"] = fn
    if (k, n) == (256, 208):
        fns["dl_bcd.cu"] = lambda: cuda_dl._bcd_shared_launch(a, b, d)
    if cuda_dl.bcd_route(k, n) == "registers":
        fns["registers"] = lambda: cuda_dl.bcd_sweep(a, b, d)
    times = {}
    if args.time and ok:
        names = list(fns)
        for name in names + names[::-1]:
            times.setdefault(name, []).append(event_ms(fns[name], args.reps))
        bnd_us = 4 * (k * k + 3 * k * n) / 3.35e12 * 1e6
        for name, t in times.items():
            ms = sum(t) / len(t)
            print(f"K={k} N={n} {name}: {ms:.4f} ms a sweep ({t[0]:.4f}, "
                  f"{t[1]:.4f}), {ms * 1e3 / k:.3f} us an atom; twin "
                  f"{twin_ms:.3f} ms; bytes bound {bnd_us:.4f} us ({card})",
                  flush=True)
    print("RESULT " + json.dumps({"k": k, "n": n, "own": own, "ok": ok,
                                  "twin_ms": twin_ms, "times": times}),
          flush=True)
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--clusters", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--shape", type=int, default=None)
    ap.add_argument("--limit", type=float, default=240.0)
    args = ap.parse_args()
    args.clusters = [int(c) for c in args.clusters.split(",") if c]
    if not torch.cuda.is_available():
        print("bcd_cluster_turns: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.shape is not None:
        return child(args, card)
    print(card, flush=True)
    t0 = time.perf_counter()
    for src in ("dl_bcd_cluster", "dl_bcd", "dl_bcd_sm90"):
        lib = _build.build(src)
        log = open(str(lib) + ".log").read()
        print(f"built {src}.cu in {time.perf_counter() - t0:.1f} s; ptxas:",
              flush=True)
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                print("   ", ln.strip(), flush=True)
    results, failed = [], []
    for i in range(len(SHAPES)):
        cmd = [sys.executable, os.path.abspath(__file__), "--shape", str(i),
               "--clusters", ",".join(map(str, args.clusters)), "--reps",
               str(args.reps), "--rows", str(args.rows)]
        if args.time:
            cmd.append("--time")
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.limit)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        for ln in out.splitlines():
            if ln.startswith("RESULT "):
                results.append(json.loads(ln[7:]))
            else:
                print(ln, flush=True)
        if rc != 0:
            failed.append((SHAPES[i], rc))
            print(f"shape {SHAPES[i]}: exit {rc}\n{err[-3000:]}", flush=True)
    print(f"{len(SHAPES) - len(failed)} of {len(SHAPES)} shapes ok; failed: "
          f"{failed} ({card})", flush=True)
    print(json.dumps(results))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
