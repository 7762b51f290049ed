"""What the kernel timing tools share (time_flash_kernels.py,
time_int4_kernels.py, time_norm_kernels.py): the checkouts named on the
command line, the port's modules imported from each in turn, the card's
name and power limit, and a buffer larger than the L2 cache to read before
each timed launch (chip_smoke.cuda_ms's `flush`).
"""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import torch


def roots() -> list:
    """The checkout roots named on the command line, or this directory."""
    return [Path(a).resolve() for a in sys.argv[1:]] or [Path(".").resolve()]


def import_port(root: Path, *modules: str) -> tuple:
    """`modules` (dotted names under leopard_tpu_torch) imported from the
    checkout at `root`: the package's modules are dropped from sys.modules
    first, so each root's kernels build into that root's build/."""
    for name in [m for m in sys.modules if m.split(".")[0] == "leopard_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        return tuple(importlib.import_module(f"leopard_tpu_torch.{m}") for m in modules)
    finally:
        sys.path.remove(str(root))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def flush_buffer(device) -> torch.Tensor:
    """1 GiB, larger than the card's L2 cache."""
    return torch.empty(2**30 // 4, dtype=torch.float32, device=device)
