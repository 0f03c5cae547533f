"""Rank launcher: run one function on every rank of a ("data", "model") mesh.

The JAX package drives all of a host's devices from one process; the port
runs one process per device, so this module starts them:

  * `run(fn, args, devices=N, tp=T)` spawns N * T ranks
    (`torch.multiprocessing`, start method "spawn") on an (N, T) mesh: N
    along "data", T along "model" (tensor parallelism, parallel/tp.py); rank
    r runs on `cuda:r` over NCCL, or with device="cpu" on the host over
    gloo. Each calls `fn(mesh, *args)`, and the result of rank 0 comes back
    to the caller. With one rank and no multihost address, `fn(None, *args)`
    runs in this process, on the single-device paths.
  * multi-host: `multihost="HOST:PORT"`, `num_hosts`, `host_id`: every host
    runs the same command; host h's local rank l is global rank
    h * devices + l, and the ranks meet at the TCP store of HOST:PORT. With
    devices=1 the rank is this process itself.
  * the local rendezvous is a file in a fresh temporary directory, so two
    launches on one machine (two pytest workers) cannot meet each other.

Failure handling: every collective times out (`timeout_s`); a rank that
exits non-zero makes the launcher stop the others and raise with the last
output of every rank that failed (ranks other than 0 write theirs to a log
file; rank 0's goes to this process's terminal); the join itself is bounded
by `join_timeout_s` when given. `devices` beyond the visible CUDA devices
raises: two ranks never share a card. Spawned CPU ranks split this
process's intra-op threads between them.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import sys
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from tpu_reid_torch.device import full_fp32_convs
from tpu_reid_torch.parallel.mesh import backend_for, make_mesh

DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(device: str, init_method: str, rank: int, world: int,
                  timeout_s: float = DEFAULT_TIMEOUT_S, n_model: int = 1):
    """Join the default process group of `world` ranks (nccl for a CUDA
    device, gloo for the CPU), yield its mesh (`n_model` ranks along
    "model"), and destroy the group on the way out."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield make_mesh(n_model=n_model)
    finally:
        dist.destroy_process_group()


def _check_devices(devices: int, tp: int, device: str) -> None:
    if devices < 1 or tp < 1:
        raise ValueError(f"--devices and --tp must be at least 1, got {devices} and {tp}")
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if devices * tp > visible:
            what = f"--devices {devices}" + (f" x --tp {tp} = {devices * tp} ranks" if tp > 1
                                              else "")
            raise RuntimeError(f"{what}: this host has {visible} visible CUDA "
                               f"device(s); the port runs one rank per card")


def _rank_device(device: str, local_rank: int) -> str:
    return f"cuda:{local_rank}" if torch.device(device).type == "cuda" else "cpu"


def _child(local_rank: int, fn, args, device: str, init_method: str, rank0: int, world: int,
           threads: int, timeout_s: float, log_dir: str, n_model: int) -> None:
    rank = rank0 + local_rank
    if local_rank > 0 or rank0 > 0:
        # C-level output too: the file descriptors, not just sys.stdout
        log = os.open(os.path.join(log_dir, f"rank{rank}.log"),
                      os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        os.dup2(log, 1)
        os.dup2(log, 2)
    torch.set_num_threads(threads)
    full_fp32_convs()  # a spawned interpreter starts with torch's defaults
    with process_group(_rank_device(device, local_rank), init_method, rank, world,
                       timeout_s, n_model) as mesh:
        out = fn(mesh, *args)
    if rank == 0:
        torch.save(out, os.path.join(log_dir, "result.pt"))


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return "(no output)"


def run(fn: Callable, args: tuple = (), devices: int = 1, device: str = "cuda",
        multihost: Optional[str] = None, num_hosts: int = 1, host_id: int = 0,
        timeout_s: float = DEFAULT_TIMEOUT_S, join_timeout_s: Optional[float] = None,
        tp: int = 1):
    """fn(mesh, *args) on every local rank (devices * tp of them, `tp`
    along the "model" axis); returns rank 0's result (None on a host other
    than 0). fn and args must pickle (spawned ranks import fn by its module
    path). See the module docstring."""
    _check_devices(devices, tp, device)
    if multihost is None and num_hosts != 1:
        raise ValueError("--num_hosts > 1 needs --multihost HOST:PORT")
    if multihost is not None and tp != 1:
        raise ValueError("--multihost shards the batch axis only")
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"--host_id {host_id} is outside [0, {num_hosts})")
    local = devices * tp
    world = num_hosts * local
    rank0 = host_id * local
    if world == 1 and multihost is None:
        return fn(None, *args)
    if local == 1:
        with process_group(_rank_device(device, 0), f"tcp://{multihost}", rank0, world,
                           timeout_s) as mesh:
            return fn(mesh, *args)
    threads = max(1, torch.get_num_threads() // local)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tpu_reid_ranks_") as log_dir:
        init_method = (f"tcp://{multihost}" if multihost is not None
                       else "file://" + os.path.join(log_dir, "rendezvous"))
        procs = [ctx.Process(target=_child, args=(r, fn, args, device, init_method, rank0,
                                                  world, threads, timeout_s, log_dir, tp),
                             daemon=True)
                 for r in range(local)]
        for p in procs:
            p.start()
        t0 = time.monotonic()

        def failed():
            return [i for i, p in enumerate(procs) if not p.is_alive() and p.exitcode != 0]

        try:
            while any(p.is_alive() for p in procs) and not failed():
                if join_timeout_s is not None and time.monotonic() - t0 > join_timeout_s:
                    raise TimeoutError(f"the {local} ranks did not finish in "
                                       f"{join_timeout_s} s")
                time.sleep(0.05)
            if failed():
                # the peers of a failed rank fail in their next collective:
                # give them a moment, then name every rank that exited
                time.sleep(1.0)
                parts = [f"rank {rank0 + i} (exit code {procs[i].exitcode}): "
                         + ("its traceback is above" if rank0 + i == 0 else
                            _tail(os.path.join(log_dir, f"rank{rank0 + i}.log")))
                         for i in failed()]
                raise RuntimeError(f"{len(parts)} of the {world} ranks exited with an error; "
                                   + "\n".join(parts))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
            sys.stdout.flush()
        if rank0 != 0:
            return None
        return torch.load(os.path.join(log_dir, "result.pt"), weights_only=False)
