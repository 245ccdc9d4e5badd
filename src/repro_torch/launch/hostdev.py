"""CPU ranks that stand in for devices: the one place that starts them.

The JAX package's ``launch/hostdev.py`` forces N host devices into one
process through ``XLA_FLAGS``.  A ``torch.distributed`` program has one
device a process, so the port starts N CPU processes instead, joined in a
``gloo`` group, and returns rank 0's result.  The ranks meet through a
``FileStore`` in a temporary directory, not a TCP port, so that several
such runs on one machine never contend for an address.  The
``REPRO_SIM_DEVICES`` environment variable and :func:`sim_device_count`
keep the JAX package's names for a launcher's default count; the ranks
started are always the count the caller gives.

This module imports ``torch`` only inside the functions that start ranks.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import traceback

#: env override of a launcher's simulated device count (the JAX knob)
ENV_VAR = "REPRO_SIM_DEVICES"

#: the production dry-run's multi-pod placeholder count (2 x 16 x 16)
DEFAULT_DEVICES = 512


def sim_device_count(default: int = DEFAULT_DEVICES) -> int:
    """The effective simulated device count: env override, else default."""
    raw = os.environ.get(ENV_VAR)
    if raw is None:
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        return default


def _rank_main(fn, args, rank: int, world: int, store_path: str, results):
    """One rank: join the gloo group, run ``fn(*args)``, report."""
    import torch.distributed as dist
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:                 # reported, then the rank exits
        results.put(("error", rank, traceback.format_exc()))


def run_host_ranks(fn, *args, count: int, timeout: float = 600.0):
    """``fn(*args)`` on every rank of a gloo group of ``count`` CPU
    processes -> rank 0's return value.  ``fn``, its arguments and its
    result are pickled (a module-level function; the processes are
    spawned).  A rank that raises, or a run past ``timeout`` seconds,
    raises here, and every rank is stopped."""
    if count < 1:
        raise ValueError(f"run_host_ranks needs a count of 1 or more, "
                         f"got {count}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="hostdev-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, count, store_path,
                                   results))
                 for r in range(count)]
        for p in procs:
            p.start()
        try:
            out, errors = None, []
            for _ in range(count):
                try:
                    status, rank, value = results.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(f"{count} host ranks did not finish in "
                                       f"{timeout} s") from None
                if status == "error":
                    errors.append(f"rank {rank}:\n{value}")
                    break
                if rank == 0:
                    out = value
            if errors:
                raise RuntimeError("a host rank failed\n" + errors[0])
            for p in procs:
                p.join(timeout)
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
