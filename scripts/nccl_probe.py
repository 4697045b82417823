"""The collectives the rung stepper over ranks calls, timed over N ranks
of their own processes (parallel/ranks.Ranks: ``nccl`` on ``cuda:r``, or
``gloo`` with ``--device cpu``), each alone: an all-reduce of one int64
(the stepper's agreed scalars), the ring exchange of parallel/step._ring
(the neighbour planes and halo rows), ``all_to_all_single`` (the slab
FFT's transposes and the layout exchange), at a few sizes; and whether
each pair of cards can reach the other's memory (CUDA peer access).
Prints one JSON line from rank 0: per operation and size the mean ms of
a call over ``--reps`` after a warm-up call, and the GB/s a rank sends.

    python3 scripts/nccl_probe.py --ranks 2 [--device cpu]

On four cards: ``--ranks 4`` (NCCL_DEBUG=INFO in the environment prints
NCCL's transports).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SIZES_MB = (4, 64, 512)


def _timed(fn, reps: int, dev) -> float:
    """Mean ms of fn() over reps calls after a warm-up call, between
    barriers (the slowest rank's time)."""
    import torch
    import torch.distributed as tdist

    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tdist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tdist.barrier()
    return 1e3 * (time.perf_counter() - t0) / reps


def _work(n: int, device: str, reps: int, rank):
    import torch
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution
    from concept_tpu_torch.parallel.ranks import init_rank
    from concept_tpu_torch.parallel.step import _ring

    r, store = rank
    dev = init_rank(r, n, store, torch.device(device))
    dist = GridDistribution()
    out = {"ranks": n, "backend": tdist.get_backend()}
    if dev.type == "cuda":
        out["peer_access"] = {f"{i}-{j}": torch.cuda.can_device_access_peer(i, j)
                              for i in range(n) for j in range(n) if i != j}
    one = torch.ones((), dtype=torch.int64, device=dev)
    out["all_reduce_int_ms"] = _timed(lambda: tdist.all_reduce(one), reps * 10, dev)
    for mb in SIZES_MB:
        x = torch.ones(mb * 2**20 // 4, dtype=torch.float32, device=dev)
        y = torch.empty_like(x)
        ms = _timed(lambda: tdist.all_to_all_single(y, x), reps, dev)
        out[f"all_to_all_{mb}MB_ms"] = ms
        out[f"all_to_all_{mb}MB_GBps"] = mb * 2**20 * (n - 1) / n / (ms * 1e-3) / 1e9
        half = x[: x.numel() // 2]
        ms = _timed(lambda: _ring(half, half, dist), reps, dev)
        out[f"ring_{mb}MB_ms"] = ms
        out[f"ring_{mb}MB_GBps"] = mb * 2**20 / (ms * 1e-3) / 1e9
        del x, y, half
    if r == 0:
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    import torch

    from concept_tpu_torch.parallel.ranks import Ranks

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=5)
    a = p.parse_args(argv)
    with Ranks(a.ranks, torch.device(a.device)) as started:
        started.start(_work, a.ranks, a.device, a.reps)
        _work(a.ranks, a.device, a.reps, rank=(0, started.store))
    return 0


if __name__ == "__main__":
    sys.exit(main())
