"""The traced window: torch.profiler over the card (CUPTI) and the host, and
the benchmark's own spans around its calls into the program's layers.

From the trace: the device's busy time (the union of kernel and copy
intervals) inside the traced window and that window's length; the device
time of kernels by a name rule (yardstick/kernels.py); the device
operations that took most time; and the idle gaps, each charged to the
innermost benchmark span open on the host when the gap began.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Callable, List, Optional, Tuple

import torch

WINDOW = "window"
TOP = 10
NEST = 64  # spans looked back over for the one open at a gap


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Tracer:
    """Spans always; the profiler only when `enabled`. `span(name)` marks a
    host interval; `start()` and `stop()` bound the traced window."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self.kernels: List[Tuple[str, int, int]] = []
        self.spans: List[Tuple[str, int, int]] = []
        self.window_ns: Optional[Tuple[int, int]] = None
        self.active = False
        self.stop_s = 0.0  # host time spent stopping the profiler and reading it

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.active = True
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> float:
        """End the traced window and read the trace; returns the seconds this
        took, which a driver leaves out of its window."""
        if not self.active:
            return 0.0
        t0 = time.perf_counter()
        _sync(self.device)
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.active = False
        for e in self.prof.profiler.kineto_results.events():
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a span's mirror on the device's timeline is no device work
                if e.name() != "Command Buffer Full" and not e.is_user_annotation():
                    self.kernels.append((e.name(), start, end))
            elif e.is_user_annotation():
                if e.name() == WINDOW:
                    self.window_ns = (start, end)
                else:
                    self.spans.append((e.name(), start, end))
        self.prof = None
        self.stop_s = time.perf_counter() - t0
        return self.stop_s

    # ------------------------------------------------------------ readings --

    @property
    def traced(self) -> bool:
        return self.window_ns is not None and bool(self.kernels)

    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def _busy(self) -> List[Tuple[int, int]]:
        lo, hi = self.window_ns
        merged: List[List[int]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) / 1e9

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e9

    def device_ops(self) -> list:
        by = collections.Counter()
        for n, s, e in self.kernels:
            by[n] += (e - s) / 1e9
        return [[n, v] for n, v in by.most_common(TOP)]

    def idle_gaps(self) -> list:
        """Idle time by the innermost benchmark span open when it began."""
        lo, hi = self.window_ns
        busy = self._busy()
        edges = [lo] + [x for se in busy for x in se] + [hi]
        by = collections.Counter()
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s for _, s, _ in spans]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            name = "outside the benchmark's spans"
            i = bisect.bisect_right(starts, g0) - 1
            for j in range(i, max(-1, i - NEST), -1):  # the latest-opened open span
                if spans[j][2] > g0:
                    name = spans[j][0]
                    break
            by[name] += (g1 - g0) / 1e9
        return [[n, v] for n, v in by.most_common(TOP)]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}
