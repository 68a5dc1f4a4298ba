"""The packed-mask gradient kernels at chip_smoke.py phases 12 and 15b's
shape (100,000 x 1,024, F = K = 128, 30% missing), for two trees of the
port in turns on one CUDA card: the other tree, this checkout, this
checkout, the other tree, each in a process of its own (both packages are
named decomp_tpu_torch). Every process makes the same inputs from one seed
and, on f32 data with the mask's bits, times masked_grad_rows
(csrc/lasso_grad_packed.cu) and masked_grad_dict (csrc/grad_dict_packed.cu)
per call (CUDA events, 20 calls after a warm-up) and prints a SHA-256 of
each output: two trees whose f32 instances compute the same bits print the
same digests. A tree whose packed route takes bf16 data also times the bf16
instances, in turns with the tree's dense-mask route on the same bf16
inputs.

Make the other tree from a commit with git, into a directory that
.gitignore lists, and run from the repository root on the card's machine:

    mkdir -p .chip_scratch/parent
    git archive <commit> decomp_tpu_torch | tar -x -C .chip_scratch/parent
    python3 tools/grad_packed_turns.py .chip_scratch/parent
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import hashlib, json, torch
from decomp_tpu_torch.ops import cuda_dl, cuda_lasso, cuda_mu
dev = torch.device("cuda", 0)
m, n, f = 100_000, 1024, 128
g = torch.Generator(device=dev).manual_seed(22)
mask = (torch.rand((m, n), generator=g, device=dev) >= 0.3).float()
my = torch.randn((m, n), generator=g, device=dev) * mask
x = torch.randn((m, f), generator=g, device=dev)
a = torch.randn((f, n), generator=g, device=dev) / n ** 0.5
bits = cuda_mu.pack_mask(mask)


def ms(fn, reps=20):
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def sha(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


limbs = cuda_lasso.grad_limbs(a)
rows = lambda: cuda_lasso.masked_grad_rows(my, bits, x, a, a_limbs=limbs)
dic = lambda: cuda_dl.masked_grad_dict(my, bits, x, a)
out = {"f32": {"rows_ms": ms(rows), "dict_ms": ms(dic),
               "rows_sha": sha(rows()), "dict_sha": sha(dic())}}
b16 = [t.to(torch.bfloat16) for t in (my, mask, x, a)]
if cuda_lasso.grad_takes_packed(b16[0]):
    my_, mask_, x_, a_ = b16
    limbs_ = cuda_lasso.grad_limbs(a_)
    runs = {"rows_packed": lambda: cuda_lasso.masked_grad_rows(
                my_, bits, x_, a_, a_limbs=limbs_),
            "rows_dense": lambda: cuda_lasso.masked_grad_rows(
                my_, mask_, x_, a_),
            "dict_packed": lambda: cuda_dl.masked_grad_dict(my_, bits, x_, a_),
            "dict_dense": lambda: cuda_dl.masked_grad_dict(
                my_, mask_, x_, a_)}
    t = {k: [] for k in runs}
    for order in (("rows_dense", "rows_packed", "dict_dense", "dict_packed"),
                  ("dict_packed", "dict_dense", "rows_packed", "rows_dense")):
        for k in order:
            t[k].append(ms(runs[k]))
    out["bf16"] = {k + "_ms": v for k, v in t.items()}
    out["bf16"]["packed_launches"] = (
        cuda_lasso.masked_grad_rows.packed_launches,
        cuda_dl.masked_grad_dict.packed_launches)
print("RESULT " + json.dumps(out), flush=True)
'''


def run(tree):
    """One process on ``tree``: its RESULT line as a dict."""
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=tree,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise SystemExit(f"grad_packed_turns: the run on {tree} failed")
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
    digests = set()
    for name, tree in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        res = run(tree)
        digests.add((res["f32"]["rows_sha"], res["f32"]["dict_sha"]))
        print(f"{name} tree ({tree}): {json.dumps(res)} ({card})",
              flush=True)
    print(f"f32 outputs the same bits in both trees: {len(digests) == 1}",
          flush=True)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
