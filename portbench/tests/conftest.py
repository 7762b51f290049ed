"""Fixtures of the benchmark's CPU tests: a checkout-like root in a
temporary directory whose BENCHMARK.json names toy cells, built from the
files under tests/tiny/ (toy configurations and traffic mixes, added the way
a later change adds any), beside a copy of portbench/."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = Path(__file__).resolve().parent / "tiny"

CELLS = {
    "tiny_llava.docqa": ("tiny_llava", "tiny_docqa"),
    "tiny_idefics2.train": ("tiny_idefics2", "tiny_train"),
}
# float32 on the CPU against the float32 reference: only summation order differs
LIMITS = {"tiny_llava.docqa": {"kl": 1e-6},
          "tiny_idefics2.train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}}


def make_root(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("tiny_llava", "tiny_idefics2"):
        shutil.copy(TINY / f"{name}.json", root / "portbench" / "configs" / f"{name}.json")
    for name in ("tiny_docqa", "tiny_train"):
        shutil.copy(TINY / f"{name}.json", root / "portbench" / "traffic" / f"{name}.json")
    spec["configs"] += [{"name": n, "source": "test", "file": f"portbench/configs/{n}.json",
                         "reduced": [], "why": "toy widths for CPU tests"}
                        for n in ("tiny_llava", "tiny_idefics2")]
    spec["workloads"] += [{"name": w, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for w, (c, t) in CELLS.items()]
    real = {"tiny_llava.docqa": "leopard_llava_mistral_7b.docqa_ttft",
            "tiny_idefics2.train": "idefics2_8b_stage.sft_train"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        for w, r in real.items():
            if r in m.get("workloads", []):
                m["workloads"].append(w)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    for w, lim in LIMITS.items():
        (root / "portbench" / "limits" / f"{w}.json").write_text(json.dumps({"limits": lim}))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
