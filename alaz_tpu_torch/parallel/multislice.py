"""Multi-host meshes over ``torch.distributed`` (NCCL on the cards, gloo
on the CPU).

The 100k-pod config (BASELINE.json config 5) spans several hosts.
``initialize_distributed`` joins this process to the job's default
process group (rendezvous address from the arguments or the
environment), and ``make_hybrid_mesh`` builds a mesh whose *outermost*
axis crosses the host boundary while the inner axes stay within a host,
so dp gradients cross hosts once per step and tp/sp collectives stay on
NVLink. ``spawn`` starts one rank per device on this host and collects
what each returns: the dry-run, the tests and the chip smoke run their
multi-rank code through it.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from alaz_tpu_torch.config import MeshConfig
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.parallel.mesh import make_mesh

log = get_logger("alaz_tpu_torch.multislice")

# a collective that waits longer than this raises on its rank instead of
# hanging the job
COLLECTIVE_TIMEOUT_S = 300.0


def _init_method(address: str) -> str:
    """``host:port`` → ``tcp://host:port``; a URL (``tcp://``,
    ``file://``) as given."""
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """``dist.init_process_group`` with env fallbacks (ALAZ_TPU_COORDINATOR,
    then torch's MASTER_ADDR/MASTER_PORT; WORLD_SIZE and RANK where the
    arguments are not given). No-op when single-process. The backend is
    NCCL on ``cuda`` (the default; each rank takes the card of its rank
    on this host) and gloo only when ``cpu`` is asked for."""
    coordinator_address = coordinator_address or os.environ.get("ALAZ_TPU_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is None and num_processes is None:
        return  # single-process: nothing to do
    dev = resolve_device(device)
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=_init_method(coordinator_address),
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    log.info(f"distributed initialized: process {dist.get_rank()}/{dist.get_world_size()}")


def make_hybrid_mesh(cfg: MeshConfig, device=None):
    """Mesh over all (global) ranks with dp outermost.

    Rank order: a launcher numbers the ranks host by host, so reshaping
    (dp, tp, ep, sp) with dp first puts the host boundary on the dp axis:
    dp collectives cross hosts, the rest stay within one. When dp doesn't
    divide evenly into hosts the mesh still works; the placement is just
    less network-friendly."""
    return make_mesh(cfg, device)


def slice_count() -> int:
    """Number of distinct hosts among the ranks (1 on a single host, and
    when no process group is initialized). Every rank calls it."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    hosts: list = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return len(set(hosts))


# -- one rank per device on this host -----------------------------------------


def _rank_main(target, rank: int, world_size: int, init: str, device: str, args_path: str, results) -> None:
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        if device == "cpu":  # the ranks share this host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        initialize_distributed(init, world_size, rank, device)
        results.put((rank, True, target(*args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(
    target: Callable[..., Any],
    world_size: int,
    args: tuple = (),
    device=None,
    timeout_s: float = 600.0,
) -> list:
    """Run ``target(*args)`` on ``world_size`` fresh ranks of one process
    group (NCCL one rank per card on ``cuda``, the default; gloo on
    ``cpu``) and return what each rank returned, in rank order.
    ``target`` must be importable by name (a module-level function) and
    return picklable values (numpy, not CUDA tensors). A rank that raises,
    or a run that outlasts ``timeout_s`` (a hung collective), stops every
    rank and raises here with the rank's traceback."""
    import multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks need {world_size} cards, have {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="alaz_rdv_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        # the arguments go through a file: a process's start blocks until
        # the previous one has read what its pipe holds, so large
        # arguments there would start the ranks one after another
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        procs = [
            ctx.Process(target=_rank_main, args=(target, r, world_size, init, dev.type, args_path, results),
                        daemon=True)
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        out: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: ranks {sorted(set(range(world_size)) - set(out))} "
                                       f"did not finish within {timeout_s} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:  # no result yet: check for a rank that died silently
                    dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"spawn: rank {dead[0]} exited with code {procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(out) == world_size else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    return [out[r] for r in range(world_size)]
