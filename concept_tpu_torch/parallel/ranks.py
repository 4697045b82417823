"""The processes of a ``-n N`` run: one a rank, rank r on ``cuda:r`` (or
the CPU when the caller asks for it), joined by a ``torch.distributed``
process group (``nccl`` on the card, ``gloo`` on the CPU) that meets at
a ``FileStore`` in a temporary directory.  No launcher and no network
address are needed: the calling process is rank 0 and spawns ranks
1 … N−1 (``multiprocessing`` 'spawn'), which run the same entry point.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as tdist

# how long a collective waits for a rank that does not come
TIMEOUT = datetime.timedelta(seconds=600)


def visible_devices(device: torch.device) -> int:
    """How many ranks ``-n 0`` means: the visible cards, or the CPU's
    cores for a run on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else os.cpu_count() or 1


def init_rank(rank: int, n: int, store: str, device: torch.device) -> torch.device:
    """Join the process group of ``n`` ranks meeting at ``store`` as
    ``rank``; returns this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    tdist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                             store=tdist.FileStore(store, n), rank=rank, world_size=n,
                             timeout=TIMEOUT)
    return device


class Ranks:
    """Ranks 1 … n−1 of a run as spawned processes, each calling
    ``target(*args, rank=(r, store))``; the caller takes rank 0 (with
    :func:`init_rank` at ``store``).  Used as a context manager: on
    leaving, the process
    group is destroyed, the ranks are joined (terminated where the caller
    failed) and the store removed.  A rank that failed raises here."""

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.dir = tempfile.mkdtemp(prefix="concept_tpu_torch_ranks_")
        self.store = os.path.join(self.dir, "store")
        self.procs = []
        # ranks on the CPU share the caller's threads: each rank running the
        # caller's count made a 2-rank 8³ run 15× slower than one thread each
        self._threads = torch.get_num_threads()
        self.threads = max(1, self._threads // n) if device.type == "cpu" else None

    def start(self, target, *args):
        ctx = multiprocessing.get_context("spawn")
        for r in range(1, self.n):
            p = ctx.Process(target=_rank_main,
                            args=(target, args, r, self.store, self.threads))
            p.start()
            self.procs.append(p)
        return self

    def __enter__(self):
        if self.threads:
            torch.set_num_threads(self.threads)
        return self

    def __exit__(self, exc_type, exc, tb):
        torch.set_num_threads(self._threads)
        try:
            if tdist.is_initialized():
                tdist.destroy_process_group()
            for p in self.procs:
                # a rank blocked on rank 0, which failed, waits no more
                if exc_type is not None and not issubclass(exc_type, SystemExit):
                    p.terminate()
                p.join()
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
        failed = [(r, p.exitcode) for r, p in enumerate(self.procs, 1) if p.exitcode]
        if failed and exc_type is None:
            raise RuntimeError(f"ranks failed (rank, exit code): {failed}")


def _rank_main(target, args, rank: int, store: str, threads: int | None):
    """A spawned rank: its output goes nowhere (rank 0 prints the run's)."""
    sys.stdout = open(os.devnull, "w")  # noqa: SIM115 — for the life of the process
    if threads:
        torch.set_num_threads(threads)
    try:
        target(*args, rank=(rank, store))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
