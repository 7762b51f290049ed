"""Checkpointing: step-indexed, asynchronous, with data-position state
(port of leopard_tpu/training/checkpoint.py).

The JAX package saves through Orbax. Here a save copies the train state to
host memory (synchronously, since the train step updates the state's tensors
in place) and writes it with `torch.save` on one worker thread, so training
goes on while the file is written. Layout:

    <dir>/<step>/state.pt          {"step", "params", "opt_state"}, or
                                   {"step", "params"} for parameters alone
    <dir>/<step>/data_state.json   when given
    <dir>/<step>/config.json       when given
    <dir>/latest_checkpointed_iteration.txt

A step directory counts once its state.pt is complete (written under a
temporary name and renamed). Only the newest `max_to_keep` are kept.

Under a device mesh the state's tensors are DTensors (training/trainer.py):
`save` gathers each one whole (`full_tensor()`, a collective, so every rank
calls it), the primary alone writes, synchronously, and every rank waits at
a barrier until the files are there. `restore` with a DTensor template
places each full tensor by the template's placements on the template's
mesh, so a checkpoint written at one mesh restores at another, as the JAX
package's does. A pipeline state (training/pp.py) holds only its stage's
layers: `save` gathers every stage's tensors to the primary over the
"stage" group, so a state saved at one stage count restores at another or
onto the plain step. `restore` holds the file to the template: the same
names and shapes, but for a stage's template, which takes its own layers
from the file and leaves the other stages'.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
from typing import Mapping, Optional, Union

import torch

from leopard_tpu_torch.training.trainer import AdamWState, TrainState

LATEST_FILE = "latest_checkpointed_iteration.txt"
STATE_FILE = "state.pt"


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _host(tensors):
    return {k: (v.full_tensor() if _is_dtensor(v) else v).detach().to("cpu", copy=True)
            for k, v in tensors.items()}


class CheckpointManager:
    """step-indexed checkpoints of {state, data_state, config}."""

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = concurrent.futures.ThreadPoolExecutor(1) if async_save else None
        self._pending: Optional[concurrent.futures.Future] = None

    def save(self, step: int, state: Union[TrainState, Mapping[str, torch.Tensor]],
             data_state: Optional[dict] = None, config: Optional[dict] = None) -> None:
        """Finish the previous save, snapshot `state` to host memory, and
        write it (on the worker thread when saving asynchronously). `state`
        is a TrainState, or parameters alone as {name: tensor}."""
        from leopard_tpu_torch.parallel.launch import barrier, is_primary

        self.wait_until_finished()
        params = state.params if isinstance(state, TrainState) else state
        sharded = any(_is_dtensor(v) for v in params.values())
        if isinstance(state, TrainState):
            opt = state.opt_state
            payload = {
                "step": int(state.step),
                "params": _host(state.params),
                "opt_state": {"count": int(opt.count), "mu": _host(opt.mu), "nu": _host(opt.nu)},
            }
        else:
            payload = {"step": int(step), "params": _host(state)}
        if sharded:
            payload = _gather_stages(payload, params)
            if is_primary():
                self._write(step, payload, data_state, config)
            barrier()
            return
        if self._pool is None:
            self._write(step, payload, data_state, config)
        else:
            self._pending = self._pool.submit(self._write, step, payload, data_state, config)

    def _write(self, step, payload, data_state, config) -> None:
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        for name, obj in (("data_state.json", data_state), ("config.json", config)):
            if obj is not None:
                with open(os.path.join(d, name), "w") as f:
                    json.dump(obj, f)
        tmp = os.path.join(d, STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(d, STATE_FILE))
        with open(os.path.join(self.directory, LATEST_FILE), "w") as f:
            f.write(str(step))
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def all_steps(self) -> list[int]:
        """Steps with a complete state file, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                template: Union[TrainState, Mapping[str, torch.Tensor], None] = None):
        """Returns (state, data_state or None), or (None, None) without a
        checkpoint; `state` is a TrainState, or {name: tensor} where
        parameters alone were saved. With `template` (of the same kind),
        each tensor goes to the device of the template's tensor of the same
        name; otherwise it stays on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.directory, str(step))
        payload = torch.load(os.path.join(d, STATE_FILE), map_location="cpu")

        def place(tensors, like):
            if like is None:
                return tensors
            _check_names(tensors, like)
            return {k: _place(k, tensors[k], v) for k, v in like.items()}

        if "opt_state" not in payload:
            state = place(payload["params"], template)
        else:
            opt = payload["opt_state"]
            t_opt = template.opt_state if template is not None else None
            state = TrainState(
                step=payload["step"],
                params=place(payload["params"], template.params if template else None),
                opt_state=AdamWState(
                    count=opt["count"],
                    mu=place(opt["mu"], t_opt.mu if t_opt else None),
                    nu=place(opt["nu"], t_opt.nu if t_opt else None),
                ),
            )
        data_state = None
        path = os.path.join(d, "data_state.json")
        if os.path.exists(path):
            with open(path) as f:
                data_state = json.load(f)
        return state, data_state

    def wait_until_finished(self) -> None:
        """Finish a pending asynchronous save (and raise its error, if any)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait_until_finished()
        if self._pool is not None:
            self._pool.shutdown()


def _pipeline_state(tensors) -> bool:
    """Whether `tensors` are a pipeline stage's (training/pp.py): its
    layers are DTensors on a mesh without the "stage" axis."""
    from leopard_tpu_torch.parallel.mesh import STAGE_AXIS

    return any(_is_dtensor(v) and STAGE_AXIS not in v.device_mesh.mesh_dim_names
               for v in tensors.values())


def _gather_stages(payload: dict, params) -> dict:
    """The payload with every stage's tensors, on the ranks of the primary's
    stage group (gathered there to the primary); as it was elsewhere and
    without stages."""
    import torch.distributed as dist

    from leopard_tpu_torch.parallel.mesh import STAGE_AXIS, axis_group, axis_size

    mesh = next((v.device_mesh for v in params.values()
                 if _is_dtensor(v) and STAGE_AXIS in v.device_mesh.mesh_dim_names), None)
    if mesh is None or axis_size(mesh, STAGE_AXIS) == 1:
        return payload
    group = axis_group(mesh, STAGE_AXIS)
    if 0 not in dist.get_process_group_ranks(group):
        return payload
    parts = [None] * dist.get_world_size(group) if dist.get_rank() == 0 else None
    dist.gather_object(payload, parts, dst=0, group=group)
    if parts is None:
        return payload
    merged = {**payload, "params": {}}
    if "opt_state" in payload:
        merged["opt_state"] = {**payload["opt_state"], "mu": {}, "nu": {}}
    for part in parts:
        merged["params"].update(part["params"])
        if "opt_state" in part:
            merged["opt_state"]["mu"].update(part["opt_state"]["mu"])
            merged["opt_state"]["nu"].update(part["opt_state"]["nu"])
    return merged


def _check_names(tensors, like) -> None:
    """Raise unless the file's tensors and the template's have the same
    names; a pipeline stage's template (`_pipeline_state`) may lack the
    layers of the other stages, and only those."""
    from leopard_tpu_torch.training.pp import layer_of

    missing = sorted(like.keys() - tensors.keys())
    extra = tensors.keys() - like.keys()
    if extra and _pipeline_state(like):
        held = {layer_of(k) for k in like}
        extra = {k for k in extra if layer_of(k) is None or layer_of(k) in held}
    if missing or extra:
        raise KeyError(f"the checkpoint does not fit the template: template tensors not in "
                       f"the file {missing[:4]}, file tensors not in the template "
                       f"{sorted(extra)[:4]}")


def _place(name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A restored full tensor placed as `like` is: on its device, and for a
    DTensor cut by its placements on its mesh (each rank its own shard)."""
    if full.shape != like.shape:
        raise ValueError(f"{name}: the checkpoint's {tuple(full.shape)} does not fit the "
                         f"template's {tuple(like.shape)}")
    if not _is_dtensor(like):
        return full.to(like.device)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh,
                             like.placements, src_data_rank=None)
