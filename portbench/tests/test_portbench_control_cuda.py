"""The lower-precision controls at the cells' own sizes, on the card: each
must come out not correct under the committed limits, on three seeds. Run
on a machine with the card, from the root of the checkout:

    python -m pytest -q -m cuda portbench/tests/test_portbench_control_cuda.py
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _cells():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, workload, seed):
    from portbench.control import train_control
    from portbench.harness import Run, execute

    run = Run(REPO, workload, seed, 3.0, False)
    if run.traffic["kind"] == "train":
        compared, _ = train_control(run)["fp8 reference"]
        assert any(v > run.limits[k] for k, v in compared.items()), compared
    else:
        run.variant = "int8"
        assert execute(run)["correct"] is False
