"""The harness: one run of one cell, driven by data.

A cell is an entry of `workloads` in BENCHMARK.json (at the root of the
checkout). The harness finds, by the names there:
  - the configuration's file (`configs` → `file`), mapped onto the port's
    config by modelcfg.py;
  - the traffic mix, portbench/traffic/<traffic>.json, whose `kind` names
    the loop that serves it, portbench/drivers/<kind>.py;
  - the cell's limits, portbench/limits/<workload>.json;
  - each per-layer metric's reader, portbench/metrics/<metric>.py, for the
    metrics whose `workloads` list the cell (or, without the key, that move
    an end-to-end metric the cell reports).
A later change adds a cell, a configuration, a traffic mix of a known kind or
a metric by adding such files and entries.

A driver's `run(run)` builds the program on the device, warms the cell's
shapes, measures, then frees the program and has the plain reference judge
what the window produced. It fills `run.e2e` (seconds-based end-to-end
values), `run.data` (what the readers read), `run.attempted`,
`run.failed` and `run.numbers` (each compared number).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "leopard_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (`leopard_tpu_torch` is the port and is allowed)."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Run:
    """One run of one cell: its inputs, and what the driver fills."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None):
        from portbench import modelcfg
        from portbench.trace import Tracer

        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.workload = workload
        confs = {c["name"]: c for c in self.spec["configs"]}
        self.config_file = self.root / confs[self.cell["config"]]["file"]
        self.cfg_json = load_json(self.config_file)
        self.cfg = modelcfg.vlm_config(self.cfg_json)
        self.traffic = load_json(self.root / "portbench" / "traffic" / f"{self.cell['traffic']}.json")
        limits = self.root / "portbench" / "limits" / f"{workload}.json"
        self.limits = load_json(limits)["limits"] if limits.exists() else {}
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.variant = None  # "int8": the program's int8 weights (the control)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.tracer = Tracer(trace, device)
        self.e2e: dict = {}
        self.data: dict = {}
        self.numbers: dict = {}
        self.diagnostics: dict = {}  # readings reported beside, not compared
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0

    # -------------------------------------------------------- driver tools --

    def sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def setup_done(self) -> None:
        """Set-up ends here: the next thing is the first timed request or
        step. The window's memory peak is read from here on."""
        self.sync()
        self.e2e["setup_s"] = time.perf_counter() - self.t_start
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def window_closed(self) -> None:
        """The window has closed: stop the trace, read the peak, and refuse
        a process that has loaded JAX or the JAX package."""
        self.sync()
        self.tracer.stop()
        if self.device == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated()
        found = forbidden_modules(sys.modules)
        if found:
            raise ForbiddenImport(found)

    def free(self) -> None:
        """After the program's objects are dropped: give their memory back
        before the reference runs."""
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- results --

    def metric_entries(self, trace: bool) -> list:
        """This cell's metrics as BENCHMARK.json lists them."""
        e2e = [m for m in self.spec["end_to_end"]
               if self.workload in m.get("workloads", [self.workload])]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (self.workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def read_layer(self, name: str):
        path = self.root / "portbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read(self)

    def judge(self):
        """(correct, {name: {value, limit}}): every number at or under its
        limit; a number with no limit, or not finite, fails."""
        checks, ok = {}, True
        for name, value in self.numbers.items():
            limit = self.limits.get(name)
            checks[name] = {"value": value, "limit": limit}
            if limit is None or not (value == value) or value > limit:
                ok = False
        return ok and bool(self.numbers), checks


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("loaded in the measuring process: " + ", ".join(found))
        self.found = found


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def execute(run: Run) -> dict:
    """Drive the cell once and assemble the result line."""
    driver = importlib.import_module(f"portbench.drivers.{run.traffic['kind']}")
    driver.run(run)
    correct, checks = run.judge()
    metrics = {}
    for m in run.metric_entries(run.trace):
        if run.trace:
            value = run.read_layer(m["name"])
        else:
            value = run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = run.device == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    if cuda:
        device["power_limit"] = _power_limit()
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.tracer.traced:
        device["busy_s"] = run.tracer.busy_s()
        device["window_s"] = run.tracer.window_s()
        out["breakdown"] = run.tracer.breakdown()
    out["checks"] = checks
    return out
