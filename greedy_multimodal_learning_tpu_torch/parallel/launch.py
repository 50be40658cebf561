"""Ranks in child processes on one machine, as ``torchrun`` starts them:
:func:`run_ranks` spawns ``nprocs`` processes with ``torchrun``'s
environment, calls ``fn(rank, *args)`` in each, and returns what each
returned, in rank order.  A rank that raises, or a run past its deadline,
stops every rank and raises here, so a deadlocked collective fails fast.

``fn`` makes its own process group (a gloo group for ranks that share a
card or run on the CPU) or leaves it to the entries'
:func:`~.multihost.maybe_initialize_distributed`.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, nprocs, local_size, port, out_dir, args):
    os.environ.update(
        RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank % local_size), LOCAL_WORLD_SIZE=str(local_size),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
    )
    result = fn(rank, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, nprocs: int, *args, timeout: float = 300.0, local_size: int = None) -> list:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes, ``local_size``
    ranks a node (all of them by default); returns their results in rank
    order.  ``fn`` and its results must pickle; each rank returns within
    ``timeout`` seconds or every rank is killed and this raises
    ``TimeoutError``."""
    local_size = local_size or nprocs
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_main, args=(fn, nprocs, local_size, free_port(), out_dir, args),
                                 nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks did not finish within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for rank in range(nprocs):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
