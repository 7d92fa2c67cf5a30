"""Spawn a process group on one host: ``world_size`` ranks, each a new
process that opens the group and runs one function.

    results = spawn_ranks(fn, 2, args, store=path)   # fn(rank, world, *args)

The ranks meet through a ``FileStore`` at ``store`` (a path no other group
uses; no port to collide with when several groups start at once) and
start with the ``spawn`` method. Each pins one intra-op thread. ``fn``
must be importable by name (a module-level function). A rank's return
value comes back to the caller; a rank that raises, or dies, fails the
call with its traceback or exit code, and no rank is left running.

The gloo backend takes CPU tensors, and CUDA tensors for all_reduce and
broadcast, so several ranks may share one card (NCCL refuses two ranks on
one GPU).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback

import torch
import torch.distributed as dist


def _rank_main(fn, rank, world_size, backend, store, args, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world_size)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, world_size: int, args=(), *, store: str, backend: str = "gloo", timeout: float = 600.0):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined in one process group; returns their results by rank (return
    numpy arrays or plain values: they are pickled, after which the rank
    exits). Raises RuntimeError naming the first rank that failed, with its
    traceback, or the ranks that died or did not report within
    ``timeout`` seconds."""
    if os.path.exists(store):
        raise ValueError(f"the FileStore {store} exists already: give each group a new path")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, store, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, failures = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size and not failures:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs) if p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"ranks died without a result: exit codes {dead}") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"no result from every rank within {timeout} s") from None
                continue
            (out if ok else failures)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5 if failures or len(out) < world_size else timeout)
            if p.is_alive():
                p.kill()
                p.join()
    if failures:
        rank = min(failures)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{failures[rank]}")
    bad = {i: p.exitcode for i, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [out[r] for r in range(world_size)]
