"""One process per rank: start them, join them within a deadline.

``spawn(fn, n, args, backend)`` runs ``fn(rank, *args)`` in n fresh
processes (torch.multiprocessing, the spawn method) that form one
torch.distributed group through a ``file://`` rendezvous in a temporary
directory: gloo on the CPU, where every rank runs one torch thread and
one BLAS thread (N ranks each setting up a problem with all of the
host's BLAS threads took 25 times longer); NCCL on the card, where rank
r runs on ``cuda:r``. Every group is made with
a timeout, so a collective that never completes raises instead of
hanging, and the parent kills every rank still running at the deadline.
"""

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a collective may wait before its rank raises
COLLECTIVE_TIMEOUT = 60.0
# the environment of a gloo rank: one thread for numpy's BLAS and OpenMP
# (read when the rank imports numpy, so set before it starts)
ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
              "MKL_NUM_THREADS": "1"}


def init_group(backend, init_method, world_size, rank,
               timeout=COLLECTIVE_TIMEOUT):
    """torch.distributed's default group, with a collective timeout; on
    NCCL, rank r's current device is cuda:r, and torch's NCCL flight
    recorder is off unless the environment sizes it
    (TORCH_FR_BUFFER_SIZE, read when the first NCCL group is made): it
    records every collective with its stack on the host, a cost paid
    once a CG iteration by the distributed solves."""
    if backend == "nccl":
        os.environ.setdefault("TORCH_FR_BUFFER_SIZE", "0")
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def rank_device(backend):
    """This rank's device: cuda:rank under NCCL, else the CPU."""
    if backend == "nccl":
        return torch.device("cuda", dist.get_rank())
    return torch.device("cpu")


def _rank_main(rank, fn, args, world_size, backend, init_method, out_dir):
    if backend == "gloo":
        torch.set_num_threads(1)
    init_group(backend, init_method, world_size, rank)
    try:
        res = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by ``start``; ``join`` collects their results."""

    def __init__(self, fn, nprocs, args, backend):
        self.nprocs = nprocs
        self._tmp = tempfile.TemporaryDirectory()
        env = ONE_THREAD if backend == "gloo" else {}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)  # the children copy it as they start
        try:
            self._ctx = mp.start_processes(
                _rank_main, nprocs=nprocs, join=False, start_method="spawn",
                args=(fn, args, nprocs, backend,
                      "file://" + os.path.join(self._tmp.name, "rendezvous"),
                      self._tmp.name))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v

    def join(self, deadline=120.0):
        """Every rank's result, by rank, once all have exited. A rank's
        exception is raised here (torch.multiprocessing's
        ProcessRaisedException, with the rank's traceback); past
        ``deadline`` seconds (None: no deadline) every rank still
        running is killed and TimeoutError raised."""
        end = None if deadline is None else time.monotonic() + deadline
        try:
            while not self._ctx.join(
                    timeout=None if end is None
                    else max(end - time.monotonic(), 0.0)):
                if end is not None and time.monotonic() >= end:
                    raise TimeoutError(f"{self.nprocs} ranks still running "
                                       f"after {deadline} s")
            out = []
            for r in range(self.nprocs):
                with open(os.path.join(self._tmp.name, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in self._ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
            self._tmp.cleanup()


def start(fn, nprocs, args=(), backend="gloo"):
    """Start ``fn(rank, *args)`` on ``nprocs`` ranks and return at once
    (``Ranks.join`` collects the results). ``fn`` and ``args`` must
    pickle (``fn`` by import path); so must the results."""
    return Ranks(fn, nprocs, args, backend)


def spawn(fn, nprocs, args=(), backend="gloo", deadline=120.0):
    """``start(...).join(deadline)``: every rank's result, by rank."""
    return start(fn, nprocs, args, backend).join(deadline)
