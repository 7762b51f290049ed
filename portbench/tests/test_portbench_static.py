"""What the benchmark imports and reads, and BENCHMARK.json against the
contract's shape: every name resolves to a file under portbench/."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench.harness import forbidden_modules

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.relative_to(PB).parts)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("names, found", [
    (["jax.numpy", "leopard_tpu_torch.ops.norms", "os"], ["jax.numpy"]),
    (["leopard_tpu", "leopard_tpu.models.vlm", "jaxlib", "flax.linen"],
     ["flax.linen", "jaxlib", "leopard_tpu", "leopard_tpu.models.vlm"]),
    (["leopard_tpu_torch", "jaxtyping", "flaxen", "leopard_tpux"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_in_the_benchmark(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "leopard_tpu"}
    if "reference" in path.parts:  # the plain reference imports nothing of the program
        assert "leopard_tpu_torch" not in tops
    text = path.read_text()
    for artefact in ("bench.py", "BENCH_r", "BASELINE.json", "MULTICHIP_r", "chip_smoke"):
        assert artefact not in text


def test_benchmark_json_resolves():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and 1 <= spec["run_seconds"] <= 51
    confs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in confs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PB / "limits" / f"{w['name']}.json").is_file()
        assert any(w["name"] in m.get("workloads", [w["name"]]) and m["name"] != "setup_s"
                   for m in spec["end_to_end"])
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])
    for m in spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert len(json.dumps(spec)) < 64 * 1024
