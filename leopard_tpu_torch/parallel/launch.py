"""Process-group bootstrap (port of leopard_tpu/parallel/launch.py).

The JAX package runs one process per host and discovers its peers through
`jax.distributed.initialize`. The port runs one process per device, started
by `torchrun` (`python -m torch.distributed.run --nproc_per_node=N ...`),
which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(device: str = "cuda", timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                           init_method: Optional[str] = None, rank: Optional[int] = None,
                           world_size: Optional[int] = None, store=None) -> dict:
    """Initialize the default process group: NCCL for `device="cuda"`
    (after `torch.cuda.set_device(LOCAL_RANK)`), gloo only when the caller
    asks for the CPU. Rank and world size come from the arguments or from
    torchrun's environment; a run without either is a world of one on
    tcp://localhost. A group that is already up is kept. Returns the
    topology."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda') without a CUDA device")
        torch.cuda.set_device(local_rank)
    if not dist.is_initialized():
        if store is None and init_method is None and "MASTER_ADDR" not in os.environ:
            if world_size != 1:
                raise RuntimeError("no MASTER_ADDR: start the run with torchrun or pass "
                                   "init_method / store")
            init_method = f"tcp://localhost:{_free_port()}"
        kw = dict(backend="nccl" if device == "cuda" else "gloo", rank=rank,
                  world_size=world_size, timeout=timeout)
        if store is not None:
            kw["store"] = store
        elif init_method is not None:
            kw["init_method"] = init_method
        if device == "cuda":
            kw["device_id"] = torch.device("cuda", local_rank)
        dist.init_process_group(**kw)
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "local_rank": local_rank, "backend": dist.get_backend()}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def is_primary() -> bool:
    """Rank 0, or no process group: logging and checkpoint writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def dp_rank_and_world(mesh) -> Tuple[int, int]:
    """This rank's data-loading shard: its coordinate on (data × fsdp), data
    major, and the product of the two sizes. The JAX package returns the
    process index, since it runs one process per host and the mesh shards
    the host's batch; here every device is a process, so ranks that differ
    only in their stage, expert, seq or model coordinate must read the same
    rows, and they do: they share the (data, fsdp) coordinate."""
    if mesh is None:
        return 0, 1
    from leopard_tpu_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, axis_coord, axis_size

    f = axis_size(mesh, FSDP_AXIS)
    return (axis_coord(mesh, DATA_AXIS) * f + axis_coord(mesh, FSDP_AXIS),
            axis_size(mesh, DATA_AXIS) * f)
