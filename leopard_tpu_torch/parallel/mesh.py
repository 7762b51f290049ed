"""The device mesh and its axis names (port of leopard_tpu/parallel/mesh.py).

The JAX package carries every parallel axis on one `jax.sharding.Mesh` and
lets XLA emit the collectives. The port builds the same six named axes as a
`torch.distributed.DeviceMesh` over one process per device, outermost to
innermost: data, stage, fsdp, expert, seq, model. Size-1 axes stay in the
mesh, so a placement can always name them.

`Parallel` is what a model's forward reads: the process groups and
coordinates of the axes whose collectives run inside the forward, "model"
(tensor parallelism, parallel/tensor_parallel.py), "seq" (ring context
parallelism, parallel/context_parallel.py) and "expert" (the MoE layer's
all-to-all dispatch, ops/moe.py), and the groups of the token axes, data,
fsdp and seq, over which an MoE layer sums its routing statistics. The
other axes shard parameters or batch rows, and their collectives run
outside the forward (training/trainer.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from leopard_tpu_torch.config import MeshConfig

# canonical axis names, outermost → innermost
DATA_AXIS = "data"
STAGE_AXIS = "stage"
FSDP_AXIS = "fsdp"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXIS_ORDER = (DATA_AXIS, STAGE_AXIS, FSDP_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)


def build_mesh(cfg: MeshConfig, device: str = "cuda"):
    """A DeviceMesh with the canonical axes over the initialized process
    group, one rank per device. The axis sizes must multiply to the world
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    if tuple(cfg.axis_names) != AXIS_ORDER:
        raise ValueError(f"mesh axes {cfg.axis_names} are not {AXIS_ORDER}")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if cfg.num_devices != n:
        raise ValueError(
            f"mesh {dict(zip(cfg.axis_names, cfg.shape))} wants {cfg.num_devices} devices, "
            f"have {n}")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call "
                           "parallel.launch.initialize_distributed first")
    return init_device_mesh(device, cfg.shape, mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device: str = "cuda"):
    return build_mesh(MeshConfig(), device)


def auto_mesh(model: int = 1, seq: int = 1, fsdp: int = 1, expert: int = 1, stage: int = 1,
              device: str = "cuda"):
    """A mesh with the given inner axes; the remaining ranks become data
    parallel."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    inner = model * seq * fsdp * expert * stage
    if n % inner:
        raise ValueError(f"{n} devices not divisible by {inner}")
    return build_mesh(MeshConfig(data=n // inner, stage=stage, fsdp=fsdp, expert=expert,
                                 seq=seq, model=model), device)


def mesh_config(mesh) -> MeshConfig:
    return MeshConfig(**{a: axis_size(mesh, a) for a in AXIS_ORDER})


def axis_size(mesh, axis: str) -> int:
    """The size of `axis`; 1 on a mesh without it (`drop_axis`)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_coord(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.get_coordinate()[names.index(axis)] if axis in names else 0


def drop_axis(mesh, axis: str):
    """The mesh of this rank's coordinate on `axis` with that axis taken
    out (the same process groups): where a tensor that lives on one
    coordinate of `axis` is placed, as a pipeline stage's layers are."""
    return mesh[tuple(a for a in mesh.mesh_dim_names if a != axis)]


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def parse_mesh(text: str) -> MeshConfig:
    """"data=2,fsdp=1,seq=1,model=4" → MeshConfig (unnamed axes are 1)."""
    sizes = {}
    for item in filter(None, (s.strip() for s in text.split(","))):
        name, _, value = item.partition("=")
        if name not in AXIS_ORDER or not value.isdigit() or int(value) < 1:
            raise ValueError(f"bad mesh entry {item!r}: want axis=size with axis in {AXIS_ORDER}")
        sizes[name] = int(value)
    return MeshConfig(**sizes)


@dataclasses.dataclass(frozen=True)
class Parallel:
    """The groups a forward runs collectives over. A size of 1 makes every
    collective of that axis a no-op, so a mesh of all ones runs the plain
    arithmetic."""

    tp_group: Optional[object] = None
    tp_size: int = 1
    tp_rank: int = 0
    cp_group: Optional[object] = None
    cp_size: int = 1
    cp_rank: int = 0
    cp_ranks: Sequence[int] = (0,)   # global ranks of the seq group, by seq coordinate
    ep_group: Optional[object] = None
    ep_size: int = 1
    ep_rank: int = 0
    dp_group: Optional[object] = None
    dp_size: int = 1
    dp_rank: int = 0
    fsdp_group: Optional[object] = None
    fsdp_size: int = 1
    fsdp_rank: int = 0
    # the expert group's ranks hold the same tokens, and each runs its own
    # experts on all of them (serving); False: the tokens are split over
    # the expert group, JAX's expert-parallel dispatch (training)
    ep_replicated: bool = False

    @staticmethod
    def of(mesh) -> "Parallel":
        def ranks(group, axis):
            return tuple(dist.get_global_rank(group, i) for i in range(axis_size(mesh, axis)))

        cp_group, ep_group = axis_group(mesh, SEQ_AXIS), axis_group(mesh, EXPERT_AXIS)
        return Parallel(
            tp_group=axis_group(mesh, MODEL_AXIS), tp_size=axis_size(mesh, MODEL_AXIS),
            tp_rank=axis_coord(mesh, MODEL_AXIS), cp_group=cp_group,
            cp_size=axis_size(mesh, SEQ_AXIS), cp_rank=axis_coord(mesh, SEQ_AXIS),
            cp_ranks=ranks(cp_group, SEQ_AXIS), ep_group=ep_group,
            ep_size=axis_size(mesh, EXPERT_AXIS), ep_rank=axis_coord(mesh, EXPERT_AXIS),
            dp_group=axis_group(mesh, DATA_AXIS),
            dp_size=axis_size(mesh, DATA_AXIS), dp_rank=axis_coord(mesh, DATA_AXIS),
            fsdp_group=axis_group(mesh, FSDP_AXIS), fsdp_size=axis_size(mesh, FSDP_AXIS),
            fsdp_rank=axis_coord(mesh, FSDP_AXIS))

    @property
    def token_shards(self) -> int:
        """How many shards the tokens of a batch are cut into before any
        expert split: data × fsdp × seq."""
        return self.dp_size * self.fsdp_size * self.cp_size

    def token_groups(self):
        """(group, size) of seq, fsdp and data, inner to outer."""
        return ((self.cp_group, self.cp_size), (self.fsdp_group, self.fsdp_size),
                (self.dp_group, self.dp_size))

    def sum_over_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` in place over data, fsdp and seq (the token axes)."""
        for group, size in self.token_groups():
            if size > 1:
                dist.all_reduce(t, group=group)
        return t


def set_parallel(module: torch.nn.Module, par: Optional[Parallel]) -> torch.nn.Module:
    """Give every submodule the groups its forward reads (`module.par`)."""
    for m in module.modules():
        m.par = par
    return module
