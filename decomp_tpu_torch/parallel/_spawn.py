"""A small launcher of process-group worlds on one host, for the tests of
the sharded solvers and for checks on the card. No solver uses it.

``World(n, store_dir)`` spawns ``n`` ranks (the ``spawn`` start method),
each of which joins a process group through a ``FileStore`` in
``store_dir`` (no port, so that worlds started side by side cannot
collide) and then runs the functions it is sent, one at a time:
``world.run(fn, *args)`` calls ``fn(rank, world_size, *args)`` on every
rank and returns the per-rank results in rank order. ``fn`` and its
arguments are pickled, so ``fn`` is a module-level function. A failure on
any rank, or no answer from every rank within ``timeout`` seconds (at most
120), terminates the whole world and raises ``RuntimeError`` with the
rank's traceback; a world that failed runs nothing more. Ranks run with
one intra-op thread each. ``run(fn, n, store_dir, *args)`` is the
one-shot form.
"""

import os
import queue
import traceback
from datetime import timedelta

import multiprocessing as mp

MAX_TIMEOUT = 120.0


def _rank_main(rank, n, store_path, backend, timeout, device, tasks, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device is not None:
        torch.cuda.set_device(device)
    try:
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout))
    except Exception:  # the world is unusable: report, then exit
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(rank, n, *args)))
            except Exception:  # reported to the caller, who ends the world
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``n`` ranks of one process group; see the module docstring.
    ``backend``: 'gloo' (CPU or CUDA tensors) or 'nccl'; ``device``: the
    CUDA device every rank sets (None for CPU worlds)."""

    def __init__(self, n, store_dir, *, backend="gloo", timeout=MAX_TIMEOUT,
                 device=None):
        self.n = int(n)
        self.timeout = min(float(timeout), MAX_TIMEOUT)
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        store = os.path.join(str(store_dir), f"store-{os.getpid()}-{id(self)}")
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.n, store, backend, self.timeout, device,
                              self._tasks[r], self._results))
            for r in range(self.n)]
        for p in self._procs:
            p.start()
        self.alive = True

    def run(self, fn, *args):
        """``fn(rank, n, *args)`` on every rank; the results in rank
        order."""
        if not self.alive:
            raise RuntimeError("this world failed earlier and is closed")
        for q in self._tasks:
            q.put((fn, args))
        out = [None] * self.n
        for _ in range(self.n):
            try:
                rank, ok, value = self._results.get(timeout=self.timeout)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                self.close(force=True)
                raise RuntimeError(
                    f"{fn.__name__}: no answer from every rank within "
                    f"{self.timeout:.0f} s (ranks exited: {dead}); the "
                    "world was terminated") from None
            if not ok:
                self.close(force=True)
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n"
                                   f"{value}")
            out[rank] = value
        return out

    def close(self, force=False):
        """Stop every rank: ask them to leave (or terminate them with
        ``force``) and join them."""
        if not self.alive:
            return
        self.alive = False
        if not force:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)


def run(fn, n, store_dir, *args, **world_kwargs):
    """``World(n, store_dir, **world_kwargs).run(fn, *args)`` in one world
    that is closed afterwards."""
    with World(n, store_dir, **world_kwargs) as world:
        return world.run(fn, *args)


def same_on_all_ranks(t, group=None):
    """Whether ``t`` holds the same bits on every rank of ``group`` (an
    ``all_gather`` and ``torch.equal``; gloo gathers a host copy)."""
    import torch
    import torch.distributed as dist

    t = t.detach().contiguous()
    if dist.get_backend(group) == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return all(torch.equal(p, parts[0]) for p in parts)
