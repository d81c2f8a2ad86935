"""Run a function on `world` ranks of a torch.distributed process group, one
spawned process a rank: the port's counterpart of a JAX mesh of one
process's devices, for tests and smoke runs.

    results = spawn(fn, 4, backend="gloo", device="cpu",
                    store_path=tmpdir, timeout_s=120, args=(...,))

fn(mesh, *args) runs on each rank with the rank's TfMesh and returns a
picklable result; spawn returns them in rank order.  fn must be a
module-level function of a module that a fresh interpreter can import:
the spawn start method pickles it by name and each rank imports its
module anew (a forked child could not use CUDA once the parent has, and
a module that imports JAX at its top would load JAX in every rank).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time

from torch.multiprocessing import (ProcessExitedException,
                                   ProcessRaisedException, start_processes)

POLL_S = 0.2          # how often the parent reads results and exits


def _rank_main(rank, fn, world, backend, device, store_file, timeout_s,
               args, results):
    import torch
    import torch.distributed as dist

    from .sharding import make_mesh, rank_device
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(store_file, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    try:
        results.put((rank, fn(make_mesh(device=dev), *args)))
    finally:
        dist.destroy_process_group()


def _drain(results, done: dict, wait_s: float = 0.0):
    """Move the results that have arrived into done (waiting up to wait_s
    for each further one)."""
    while True:
        try:
            rank, out = results.get(timeout=wait_s) if wait_s \
                else results.get_nowait()
        except queue.Empty:
            return
        done[rank] = out


def _tracebacks(ctx) -> str:
    """The tracebacks of every rank that raised (a rank that fails first
    can make the others fail in a collective after it), in rank order."""
    out = ""
    for r, path in enumerate(ctx.error_files):
        if os.path.exists(path):
            with open(path, "rb") as fh:
                out += f"\n--- rank {r}:\n{pickle.load(fh)}"
            os.unlink(path)
    return out


def spawn(fn, world: int, *, backend: str, device, store_path: str,
          timeout_s: float, args: tuple = ()) -> list:
    """fn(mesh, *args) on ranks 0 .. world-1, each in a process of its own
    with one intra-op thread, joined over a torch.distributed FileStore in
    a fresh directory under store_path (no port to race for).  `device` is
    each rank's ("cuda": card rank % the cards present).  Returns the
    results in rank order.  A rank that raises or dies fails the call with
    the tracebacks of the ranks that raised (torch.multiprocessing's join
    stops the other ranks), as does timeout_s passing (the start of the processes included; also each
    collective's timeout); no rank is left running."""
    os.makedirs(store_path, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="ranks-", dir=store_path)
    results = mp.get_context("spawn").Queue()
    done = {}
    ctx = start_processes(
        _rank_main, nprocs=world, join=False, daemon=True,
        args=(fn, world, backend, device, os.path.join(store_dir, "store"),
              timeout_s, args, results))
    deadline = time.monotonic() + timeout_s
    try:
        # a rank exits only once its result is read, so read while joining
        while not ctx.join(POLL_S):
            _drain(results, done)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"ranks {sorted(set(range(world)) - set(done))} of "
                    f"{world}: no result after {timeout_s:g} s")
        _drain(results, done, POLL_S)
    except (ProcessRaisedException, ProcessExitedException) as e:
        raise RuntimeError(f"rank {e.error_index} of {world} failed first"
                           + (_tracebacks(ctx) or f": {e}")) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    if len(done) < world:
        raise RuntimeError(f"ranks {sorted(set(range(world)) - set(done))} "
                           f"of {world} exited with no result")
    return [done[r] for r in range(world)]
