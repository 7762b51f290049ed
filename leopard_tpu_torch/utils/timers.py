"""Timers and metrics logging (port of leopard_tpu/utils/timers.py).

Named phase timers with an optional device sync, a JSONL metrics stream and
a step-time tracker. The JAX package syncs with `jax.block_until_ready`;
here a sync is `torch.cuda.synchronize()` on the device the caller names
(a CPU device needs none: its work is done when the call returns).
"""

from __future__ import annotations

import json
import os
import statistics
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch


def sync(device=None) -> None:
    """Wait for the device's queued work; a no-op for the CPU."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timers:
    def __init__(self):
        self._elapsed: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._start: Dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str, sync_device=None):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name, sync_device)

    def start(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def stop(self, name: str, sync_device=None) -> None:
        """Stop `name`; with `sync_device`, first wait for that device."""
        if sync_device is not None:
            sync(sync_device)
        self._elapsed[name] += time.perf_counter() - self._start.pop(name)
        self._count[name] += 1

    def elapsed(self, name: str, reset: bool = False) -> float:
        v = self._elapsed[name]
        if reset:
            self._elapsed[name] = 0.0
            self._count[name] = 0
        return v

    def mean(self, name: str) -> float:
        c = self._count[name]
        return self._elapsed[name] / c if c else 0.0

    def snapshot(self, reset: bool = False) -> Dict[str, float]:
        out = {k: self.mean(k) for k in list(self._elapsed)}
        if reset:
            self._elapsed.clear()
            self._count.clear()
        return out


class MetricsLogger:
    """JSONL metrics stream (`<log_dir>/metrics.jsonl`) and, if asked and
    installed, tensorboard scalars."""

    def __init__(self, log_dir: str, tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in row.items():
                if isinstance(v, float) and k != "time":
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


class StepTimeTracker:
    """Step-time min/max/mean/median over a sliding window: the straggler
    signal. The JAX package can also toggle it over a TCP port; the port
    toggles it through `enabled`."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: list[float] = []
        self.enabled = True

    def record(self, seconds: float) -> None:
        if not self.enabled:
            return
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)

    def report(self) -> Dict[str, float]:
        if not self.times or not self.enabled:
            return {}
        return {
            "step_time_mean": statistics.mean(self.times),
            "step_time_min": min(self.times),
            "step_time_max": max(self.times),
            "step_time_p50": statistics.median(self.times),
        }
