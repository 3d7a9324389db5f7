"""Start the ranks of a mesh: one process each, its default process group
initialised, a function run in every one, every result brought back.

``spawn(target, devices, args)`` starts ``len(devices)`` processes with the
``spawn`` method (a fresh interpreter each: the function and its arguments
are pickled, so ``target`` is a module-level function of the package, and
the children import its module, not the caller's script's). Rank r runs on
``devices[r]``, joins the group over ``tcp://127.0.0.1:<free port>`` and
calls ``target(rank, *args)``. The backend is ``parallel.mesh.
choose_backend``'s (NCCL for ranks on cards of their own, gloo for CPU
ranks or when asked for) and is printed. The parent waits for every rank,
and on any failure stops the rest and raises with the failing rank's
traceback.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence

from powerpaint_tpu_torch.parallel.mesh import choose_backend


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank: int, world: int, port: int, backend: str, device: str,
           threads: Optional[int], target: Callable, args: tuple,
           results) -> None:
    import torch
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            out = target(rank, *args)
            results.put((rank, True, out))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(target: Callable, devices: Sequence, args: tuple = (), *,
          backend: Optional[str] = None, threads: Optional[int] = None,
          timeout: float = 3600.0) -> List:
    """Run ``target(rank, *args)`` on one process per entry of ``devices``
    ("cpu", "cuda:0", ...); returns the ranks' results in rank order.
    ``threads``: torch's intra-op threads in each rank (CPU ranks share the
    host's cores). Raises if a rank fails or the ranks outlast
    ``timeout`` seconds; no process outlives the call."""
    devices = [str(d) for d in devices]
    backend = choose_backend(devices, backend)
    world = len(devices)
    print(f"[parallel] {world} rank(s) on {', '.join(devices)} over {backend}",
          file=sys.stderr, flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, world, port, backend, devices[r], threads,
                               target, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world and failure is None:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    failure = f"no result from the ranks in {timeout} s"
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
        if failure is None:
            for p in procs:
                p.join(timeout=60)
                if p.exitcode not in (0, None):
                    failure = f"a rank exited with code {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                if failure is None:
                    p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(world)]


def cpu_threads(world: int) -> int:
    """Intra-op threads for each of ``world`` CPU ranks on this host."""
    return max(1, (os.cpu_count() or 1) // world)
