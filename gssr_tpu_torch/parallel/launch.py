"""Multi-process launch: bring up the torch.distributed group (port of
gssr_tpu/parallel/launch.py).

One process per device. Two layers use the group, as in the reference:

  1. Tile parallelism (`train_split` without `--machine.parallel`): tiles
     never communicate; the striping only needs each process's rank and
     the world size, which `maybe_initialize_distributed` writes into
     `machine.num_hosts` / `machine.host_rank` when a group is up.
  2. Device parallelism (`--machine.parallel dp|band|gshard`): the scene's
     train step runs on every rank, with the collectives of
     parallel/comm.py between them. Every rank of the group trains the
     same run (under `train_split`, every tile of its host, one after
     another), so the group's rank is kept out of `num_hosts` /
     `host_rank`: those stay the `--machine.num-hosts` / `--host-rank`
     flags, one group per host.

Environment contract, the reference's, read in this order:
  GSSR_COORDINATOR   address of process 0, "host:port"
  GSSR_NUM_PROCESSES total process count
  GSSR_PROCESS_ID    this process's id
or torchrun's RANK / WORLD_SIZE / LOCAL_RANK (with MASTER_ADDR and
MASTER_PORT), or `--machine.dist-init true` alone: a group of one. The
backend is NCCL on `cuda` and gloo on `cpu`; the rank's device is
`cuda:(local_rank % device_count)`.

`spawn` starts the ranks of one machine itself, with the `spawn` start
method (CUDA is unsafe after `fork`) and a FileStore rendezvous under a
given directory; `python -m gssr_tpu_torch.train ... --machine.parallel
dp --machine.num-devices N` uses it when no group and no launcher
environment is there (`run`).
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gssr_tpu_torch.parallel import comm


def backend_for(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _bind_device(device: str, local_rank: int) -> None:
    """Make `cuda` this rank's own card: cuda:(local_rank % count)."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def _env_rendezvous():
    """(init_method, world, rank, local rank) from a launcher's
    environment (the module docstring's contract), or None; init_method
    None for a process alone (no coordinator)."""
    env = os.environ
    if "GSSR_COORDINATOR" in env or "GSSR_NUM_PROCESSES" in env:
        world = int(env.get("GSSR_NUM_PROCESSES", "1"))
        rank = int(env.get("GSSR_PROCESS_ID", "0"))
        coord = env.get("GSSR_COORDINATOR")
        if coord is None and world > 1:
            raise ValueError("GSSR_NUM_PROCESSES > 1 needs GSSR_COORDINATOR "
                             "(host:port of process 0)")
        return (coord and f"tcp://{coord}", world, rank,
                int(env.get("LOCAL_RANK", rank)))
    if "RANK" in env and "WORLD_SIZE" in env:
        rank = int(env["RANK"])
        return ("env://", int(env["WORLD_SIZE"]), rank,
                int(env.get("LOCAL_RANK", rank)))
    return None


def maybe_initialize_distributed(machine) -> bool:
    """Initialize torch.distributed when a multi-process launch is asked
    for (the environment contract of the module docstring, or
    machine.dist_init). Idempotent. After it, or when a group is already
    up, `machine.num_hosts` / `host_rank` are the world size and rank,
    unless `machine.parallel` is set (layer 2 of the module docstring).
    Returns True when a group is up."""
    if not comm.group_up():
        rendezvous = _env_rendezvous()
        if rendezvous is not None and rendezvous[0] is None:
            init_group_of_one(machine)
        elif rendezvous is not None:
            init, world, rank, local = rendezvous
            _bind_device(machine.device, local)
            dist.init_process_group(backend_for(machine.device),
                                    init_method=init, world_size=world,
                                    rank=rank)
        elif getattr(machine, "dist_init", False):
            init_group_of_one(machine)
        else:
            return False
        if dist.get_rank() == 0:
            print(f"torch.distributed up: {dist.get_world_size()} "
                  f"processes, backend {dist.get_backend()}")
    if getattr(machine, "parallel", "none") == "none":
        machine.num_hosts = dist.get_world_size()
        machine.host_rank = dist.get_rank()
    return True


def init_group_of_one(machine) -> None:
    """A group of this process alone (its device's backend, an in-process
    store), so that a one-rank run goes through the same collectives."""
    _bind_device(machine.device, 0)
    dist.init_process_group(backend_for(machine.device),
                            store=dist.HashStore(), world_size=1, rank=0)
    if getattr(machine, "parallel", "none") == "none":
        machine.num_hosts, machine.host_rank = 1, 0


def run(machine, fn: Callable, args: Sequence = (),
        rank_fn: Callable = None) -> Any:
    """fn(*args) inside the group `machine` asks for, and its result:
    here, as this process's rank, where a launcher started the process or
    a group is up (that group is left up); here without a group where
    `machine.parallel` is "none"; here in a group of one, torn down after,
    where one rank is asked for. Where several are (`machine.num_devices`,
    0 = every local card, 1 on the CPU), rank_fn(*args) (default fn) runs
    on each of `spawn`'s processes instead, and their results come back as
    a list in rank order."""
    if maybe_initialize_distributed(machine) or machine.parallel == "none":
        return fn(*args)
    cuda = torch.device(machine.device).type == "cuda"
    n = machine.num_devices or (torch.cuda.device_count() if cuda else 1)
    if cuda and n > torch.cuda.device_count():
        raise SystemExit(
            f"error: {n} ranks need {n} cards (NCCL takes one card a rank); "
            f"this machine has {torch.cuda.device_count()}")
    if n > 1:
        with tempfile.TemporaryDirectory() as store:
            return spawn(rank_fn or fn, n, backend_for(machine.device),
                         machine.device, store, tuple(args))
    init_group_of_one(machine)
    try:
        return fn(*args)
    finally:
        shutdown_distributed()


def shutdown_distributed() -> None:
    """Tear the group down (idempotent)."""
    if comm.group_up():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device: str, store_dir: str, args: tuple, results) -> None:
    try:
        # the ranks share the machine's cores: one torch pool each of the
        # full size oversubscribes them many times over (with gloo, a CPU
        # run slowed tens of times); a smaller pool asked for stays
        torch.set_num_threads(min(torch.get_num_threads(),
                                  max(1, (os.cpu_count() or 1) // world)))
        _bind_device(device, rank)
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(backend, store=store, world_size=world,
                                rank=rank)
        out = fn(*args)
        comm.barrier()
        results.put((rank, True, out))
    except BaseException:                            # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown_distributed()


def spawn(fn: Callable, world: int, backend: str, device: str,
          store_dir: str, args: Sequence = (), timeout: float = None
          ) -> List:
    """Run fn(*args) on `world` ranks, each a process started with the
    `spawn` method, joined into one group (`backend`) through a FileStore
    under store_dir; each rank's device is `device` ("cuda": its
    cuda:(rank % count); "cpu"). Returns the ranks' results in rank order;
    fn, args and results must pickle. Raises with the failing ranks'
    tracebacks if any rank fails."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, world, backend, device, store_dir,
                               tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        # drain the queue before joining (a rank blocks on a full pipe);
        # stop at the first failure, a rank gone without a result, or
        # the deadline: the other ranks may wait in a collective forever
        while len(got) < world:
            try:
                r, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                gone = any(p.exitcode not in (None, 0) for p in procs)
                late = deadline is not None and time.monotonic() > deadline
                if gone or late:
                    break
                continue
            got[r] = (ok, out)
            if not ok:
                break
    finally:
        for p in procs:
            p.join(timeout=None if len(got) == world else 5)
            if p.is_alive():
                p.kill()
                p.join()
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    missing = sorted(set(range(world)) - set(got))
    if failed or missing:
        raise RuntimeError(
            f"spawned ranks failed: {sorted(failed)}, without a result: "
            f"{missing}\n" + "\n".join(failed.values()))
    return [got[r][1] for r in range(world)]
