"""Process-group set-up and the row axis of the sharded engines
(counterpart of parallel/multihost.py).

The reference's sharded programs are SPMD over a 1-D mesh of row blocks
that one process can span.  Here it is one process per card: each rank
holds its row block of the square matrix and its slices of the row
vectors on its own device, and every cross-device step is an explicit
collective on the default process group.  The backend follows the torch
device of utils/torchconfig.py: NCCL on ``cuda``, gloo on ``cpu``; there
is no switch from one to the other.

Environment-driven init (one process per rank, started by the user or a
launcher):

  CCPHYLO_TORCH_COORDINATOR       host:port of rank 0's store
  CCPHYLO_TORCH_NUM_PROCS         world size
  CCPHYLO_TORCH_PROC_ID           this process's rank
  CCPHYLO_TORCH_AUTO_DISTRIBUTED  any value: ``init_method="env://"``
                                  (MASTER_ADDR, MASTER_PORT, RANK,
                                  WORLD_SIZE from a launcher such as
                                  torchrun)

On a card, rank r computes on ``cuda:(r % device_count)``.  With none of
these set, `row_axis` creates a group of one rank on a free localhost
port, so the engines always run their collectives.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket

import torch
import torch.distributed as dist

from ..utils.torchconfig import device

# collectives issued since the last reset (the engines' statistics)
counts = {"collectives": 0}


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _init(dev, **kw) -> None:
    dist.init_process_group(_backend(dev), **kw)
    atexit.register(_destroy)


def maybe_init_distributed(timeout: float | None = None) -> bool:
    """Initialize the default process group when a multi-process run is
    declared in the environment.

    Returns True when running multi-process.  A repeated call is a
    no-op; a failed init raises (an N-process job never degrades to N
    separate runs).  `timeout`: seconds the store and the collectives
    wait before they raise (torch's default when None)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = os.environ.get("CCPHYLO_TORCH_COORDINATOR")
    nproc = os.environ.get("CCPHYLO_TORCH_NUM_PROCS")
    pid = os.environ.get("CCPHYLO_TORCH_PROC_ID")
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dev = device()
    if coord and nproc and pid:
        rank = int(pid)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        _init(dev, init_method=f"tcp://{coord}", world_size=int(nproc),
              rank=rank, **kw)
    elif os.environ.get("CCPHYLO_TORCH_AUTO_DISTRIBUTED"):
        if dev.type == "cuda":
            rank = int(os.environ.get("LOCAL_RANK",
                                      os.environ.get("RANK", "0")))
            torch.cuda.set_device(rank % torch.cuda.device_count())
        _init(dev, init_method="env://", **kw)
    else:
        return False
    return dist.get_world_size() > 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def row_axis() -> tuple[int, int]:
    """(rank, world size) of the row axis: the default group, created
    from the environment (`maybe_init_distributed`) or, when none is
    declared, as a group of one rank on a free localhost port."""
    if not maybe_init_distributed() and not dist.is_initialized():
        _init(device(), init_method=f"tcp://127.0.0.1:{_free_port()}",
              world_size=1, rank=0)
    return dist.get_rank(), dist.get_world_size()


# --- collectives on the default group ----------------------------------


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """all_gather of each rank's `t` along dim 0 (the list form, which
    every torch version of the port's has without a deprecation)."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    counts["collectives"] += 1
    return torch.cat(out)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce of `t`; returns it."""
    dist.all_reduce(t, op=op)
    counts["collectives"] += 1
    return t


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """In-place broadcast of `t` from rank `src`; returns it."""
    dist.broadcast(t, src=src)
    counts["collectives"] += 1
    return t
