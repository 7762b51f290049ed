"""Timers, program spans and metrics logging (port of
leopard_tpu/utils/timers.py).

Named phase timers, program spans, a JSONL metrics stream and a step-time
tracker. The JAX package syncs with `jax.block_until_ready`; here a sync is
`torch.cuda.synchronize()` on the device the caller names (a CPU device
needs none: its work is done when the call returns).

Program spans (`span`) mark the phases of the serving prefill and the train
step. They record only while a `torch.profiler` session runs, such as the
training loop's `profile_steps` window; otherwise `span` returns one shared
no-op context after a single flag test. A recorded span sits in the
profiler's trace as a `record_function` of its name, and in `SPANS`: its
host interval on the profiler's clock (the Unix epoch in ns, as the
profiler's events carry it), on a card the CUDA events that bound it on the
current stream, and its integer counts. A span never reads a device value.
`span_totals()` sums the records by name; `clear_spans()` drops them, as
the training loop does when its window opens.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler


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
        self._start: Dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def start(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        self._elapsed[name] += time.perf_counter() - self._start.pop(name)

    def elapsed(self, name: str, reset: bool = False) -> float:
        v = self._elapsed[name]
        if reset:
            self._elapsed[name] = 0.0
        return v


# ------------------------------------------------------------- program spans --


@dataclasses.dataclass
class SpanRecord:
    """One recorded span. `t0_ns`/`t1_ns`: host start and end on the
    profiler's clock (`t1_ns` 0 while open); `events`: CUDA timing events on
    the stream, the first at the open, the last where the span's device work
    ends."""

    name: str
    t0_ns: int
    t1_ns: int = 0
    events: list = dataclasses.field(default_factory=list)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


SPANS: List[SpanRecord] = []  # the spans recorded since the last clear_spans(), in open order


def _cuda_event():
    """A timing event recorded on the current stream, or None off a card."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _NoSpan:
    """The span of an untraced run: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end_at_grad(self, tensor: torch.Tensor) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "_fn")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.rec = SpanRecord(name, 0, counts=counts)

    def __enter__(self):
        rec = self.rec
        t0 = time.time_ns()
        self._fn = torch.profiler.record_function(rec.name)
        self._fn.__enter__()
        rec.t0_ns = (t0 + time.time_ns()) // 2  # the profiler stamps its start inside the call
        ev = _cuda_event()
        if ev is not None:
            rec.events.append(ev)
        SPANS.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        ev = _cuda_event()
        if ev is not None:
            rec.events.append(ev)
        self._fn.__exit__(*exc)
        rec.t1_ns = time.time_ns()
        return False

    def end_at_grad(self, tensor: torch.Tensor) -> None:
        """Extend the span's device time to where `tensor`'s gradient is
        ready in the backward: a hook records one more event then."""
        if tensor.requires_grad and torch.cuda.is_initialized():
            events = self.rec.events

            def hook(grad):
                events.append(_cuda_event())

            tensor.register_hook(hook)


def span(name: str, **counts):
    """A context manager over one phase of the program, recorded only while
    a `torch.profiler` session runs (module docstring). `counts`: host
    integers the caller already holds (shapes, lengths)."""
    # torch's own flag of a running session (private: a torch without it
    # records no spans, and tests/test_torch_spans.py pins it)
    if not getattr(_profiler, "_is_profiler_enabled", False):
        return NO_SPAN
    return _Span(name, counts)


def clear_spans() -> None:
    """Drop every recorded span. The owner of a profiler window calls it as
    the window opens, so that one process's windows do not add up."""
    SPANS.clear()


def span_totals() -> Dict[str, dict]:
    """The closed spans summed by name: {name: {"n", "host_ms", "stream_ms",
    "counts"}}. `host_ms` is the host interval; `stream_ms` runs from a
    span's first CUDA event to its last, the time the span held the stream,
    idle included (None without events, as on the CPU). Synchronizes the
    card first."""
    closed = [r for r in SPANS if r.t1_ns]
    if torch.cuda.is_initialized() and any(r.events for r in closed):
        torch.cuda.synchronize()
    out: Dict[str, dict] = {}
    for r in closed:
        t = out.setdefault(r.name, {"n": 0, "host_ms": 0.0, "stream_ms": None, "counts": {}})
        t["n"] += 1
        t["host_ms"] += (r.t1_ns - r.t0_ns) / 1e6
        if len(r.events) >= 2:
            t["stream_ms"] = (t["stream_ms"] or 0.0) + r.events[0].elapsed_time(r.events[-1])
        for k, v in r.counts.items():
            t["counts"][k] = t["counts"].get(k, 0) + v
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
