"""Checkpointing: step-indexed, asynchronous, with data-position state
(port of leopard_tpu/training/checkpoint.py).

The JAX package saves through Orbax. Here a save copies the train state to
host memory (synchronously, since the train step updates the state's tensors
in place) and writes it with `torch.save` on one worker thread, so training
goes on while the file is written. Layout:

    <dir>/<step>/state.pt          {"step", "params", "opt_state"}
    <dir>/<step>/data_state.json   when given
    <dir>/<step>/config.json       when given
    <dir>/latest_checkpointed_iteration.txt

A step directory counts once its state.pt is complete (written under a
temporary name and renamed). Only the newest `max_to_keep` are kept.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
from typing import Optional

import torch

from leopard_tpu_torch.training.trainer import AdamWState, TrainState

LATEST_FILE = "latest_checkpointed_iteration.txt"
STATE_FILE = "state.pt"


def _host(tensors):
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class CheckpointManager:
    """step-indexed checkpoints of {state, data_state, config}."""

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = concurrent.futures.ThreadPoolExecutor(1) if async_save else None
        self._pending: Optional[concurrent.futures.Future] = None

    def save(self, step: int, state: TrainState, data_state: Optional[dict] = None,
             config: Optional[dict] = None) -> None:
        """Finish the previous save, snapshot `state` to host memory, and
        write it (on the worker thread when saving asynchronously)."""
        self.wait_until_finished()
        opt = state.opt_state
        payload = {
            "step": int(state.step),
            "params": _host(state.params),
            "opt_state": {"count": int(opt.count), "mu": _host(opt.mu), "nu": _host(opt.nu)},
        }
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

    def restore(self, step: Optional[int] = None, template: Optional[TrainState] = None):
        """Returns (state, data_state or None), or (None, None) without a
        checkpoint. With `template`, each tensor goes to the device of the
        template's tensor of the same name; otherwise it stays on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.directory, str(step))
        payload = torch.load(os.path.join(d, STATE_FILE), map_location="cpu")

        def place(tensors, like):
            if like is None:
                return tensors
            return {k: v.to(like[k].device) for k, v in tensors.items()}

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
