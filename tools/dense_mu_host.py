"""Where a call of dense MU's f32 kernel spends its time on one CUDA card.

At BASELINE config 1 (a planted 1,000 x 500 f32 matrix, rank 10) the four
launches of csrc/mu_dense_packed.cu take ~0.04 ms of the card, so a call of
cuda_mu.mu_stats_dense is paced by its host work. This script prints, for
that shape, the host time of a call and of each of its parts (the host
clock over many calls, without and with a final synchronise), then the
kernel per call by CUDA events in turns with the first design,
csrc/mu_stats_dense.cu (old, new, new, old), at config 1, 100,000 x 1,024
and 262,144 x 10,112, K = 128, with each launch's device time from
torch.profiler. Run from the repository root on the card's machine:

    python3 tools/dense_mu_host.py
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from decomp_tpu_torch.ops import cuda_mu  # noqa: E402


def per_call(fn, n=3000):
    """(host us, us with the card) a call of fn over n calls."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e6


def host_parts(dev):
    y = cs.planted_config1(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((1000, 10), generator=g, device=dev)
    d = torch.rand((10, 500), generator=g, device=dev)
    (m, n), k, kt = y.shape, 10, 64
    rows = cuda_mu.dense_packed_block_rows(m, n)
    fn = cuda_mu._c_function(
        "mu_dense_packed", "mu_dense_packed_launch",
        (cuda_mu._I, cuda_mu._P, cuda_mu._I, cuda_mu._P, cuda_mu._P,
         cuda_mu._P, cuda_mu._F) + (cuda_mu._I,) * 5
        + (cuda_mu._P, cuda_mu._LL) + (cuda_mu._P,) * 3)
    ddt = cuda_mu.gram_rows(d)
    ws_bytes = cuda_mu._dense_packed_workspace(kt, m, n, k, rows)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    x_new = torch.empty_like(x)
    out = torch.empty(k * n + k * k, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def c_call():
        fn(kt, y.data_ptr(), n, x.data_ptr(), d.data_ptr(), ddt.data_ptr(),
           1e-6, m, n, k, 1, rows, ws.data_ptr(), ws_bytes,
           x_new.data_ptr(), out.data_ptr(), stream)

    def allocations():
        return (torch.empty(ws_bytes, dtype=torch.uint8, device=dev),
                torch.empty_like(x), torch.empty(k * n + k * k, device=dev))

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "mu_stats_dense (the call)": lambda: cuda_mu.mu_stats_dense(
            y, x, d, 1e-6),
        "_dense_mma_launch (the first design)":
            lambda: cuda_mu._dense_mma_launch(y, x, d, 1e-6),
        "the C call (4 launches)": c_call,
        "dense_packed_block_rows": lambda: cuda_mu.dense_packed_block_rows(
            m, n),
        "_check_kernel_args": lambda: cuda_mu._check_kernel_args(
            y, x, d, 1, rows, wide_x=False),
        "gram_rows": lambda: cuda_mu.gram_rows(d),
        "the three allocations": allocations,
        "torch.cuda.device": device_context,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "the outputs' views": lambda: [
            t.view(-1) for t in out.split((k * n, k * k))],
    }
    for name, f in parts.items():
        host, total = per_call(f)
        print(f"config 1, {name}: host {host:.2f} us, with the card "
              f"{total:.2f} us a call", flush=True)


def main():
    if not torch.cuda.is_available():
        print("dense_mu_host: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    host_parts(dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    for m, n, k, reps in ((1000, 500, 10, 50), (100_000, 1024, 128, 10),
                          (262_144, 10112, 128, 5)):
        y = (cs.planted_config1(dev) if m == 1000
             else torch.rand((m, n), generator=gen, device=dev))
        args = (y, 0.1 + torch.rand((m, k), generator=gen, device=dev),
                0.1 + torch.rand((k, n), generator=gen, device=dev))
        err = cs.compare_dense_packed(cuda_mu, args)
        cs.time_dense_packed(cuda_mu, args, reps, card, err)
        del y, args
    return 0


if __name__ == "__main__":
    sys.exit(main())
