"""Masked dictionary learning on f32 data at chip_smoke.py phase 15's shape
(100,000 x 1,024, 128 atoms, 30% missing, 15 inner iterations at lasso_tol
0), timed for two trees of the port in turns on one CUDA card: the other
tree, this checkout, this checkout, the other tree, each in a process of
its own (both packages are named decomp_tpu_torch). Each process times
three runs of 20 outer iterations after a warm-up (CUDA events, ms per
outer iteration) and counts masked_grad_dict's launches; the second and
fourth also split two outer iterations by torch.profiler: device time per
outer iteration and the kernels that take the most of it.

Make the other tree from a commit with git, into a directory that
.gitignore lists, and run from the repository root on the card's machine:

    mkdir -p .chip_scratch/parent
    git archive <commit> decomp_tpu_torch | tar -x -C .chip_scratch/parent
    python3 tools/masked_dl_turns.py .chip_scratch/parent
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, torch
from decomp_tpu_torch import dictionary_learning as dl
from decomp_tpu_torch.ops import cuda_dl
dev = torch.device("cuda", 0)
m, n, k, alpha, inner = 100_000, 1024, 128, 0.05, 15
g = torch.Generator(device=dev).manual_seed(15)
d_true = torch.randn((k, n), generator=g, device=dev)
d_true /= torch.linalg.vector_norm(d_true, dim=1, keepdim=True)
xt = torch.randn((m, k), generator=g, device=dev) * (
    torch.rand((m, k), generator=g, device=dev) < 0.1)
mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
my = (xt @ d_true + 0.01 * torch.randn((m, n), generator=g, device=dev)
      ) * mask
d0 = torch.randn((k, n), generator=g, device=dev)
del xt, d_true


def solve(maxiter):
    return dl.solve(my, d0, alpha, mask=mask, tol=0.0, maxiter=maxiter,
                    lasso_iter=inner, lasso_tol=0.0)


solve(1)
torch.cuda.synchronize()
out = {"ms": []}
for _ in range(3):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    solve(20)
    e1.record()
    torch.cuda.synchronize()
    out["ms"].append(e0.elapsed_time(e1) / 20)
w = cuda_dl.masked_grad_dict
out["masked_grad_dict"] = {"launches": w.launches,
                           "packed": getattr(w, "packed_launches", None)}
if sys.argv[1] == "1":
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve(2)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    out["device_ms_per_iter"] = sum(r[0] for r in rows) / 2e3
    out["top"] = [(round(t / 2e3, 4), c // 2, key[:80])
                  for t, c, key in rows[:8]]
print("RESULT " + json.dumps(out), flush=True)
'''


def run(tree, profiled):
    """One process on ``tree``: its RESULT line as a dict."""
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", CHILD, str(int(profiled))],
                          env=env, cwd=tree, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise SystemExit(f"masked_dl_turns: the run on {tree} failed")
    return json.loads(lines[0][len("RESULT "):])


def main():
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for i, (name, tree) in enumerate((("other", other), ("this", here),
                                      ("this", here), ("other", other))):
        print(f"{name} tree ({tree}): {json.dumps(run(tree, i in (1, 3)))} "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
