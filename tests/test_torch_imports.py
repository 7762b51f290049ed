"""The port never imports JAX nor any module of the JAX package (not even
one that imports no JAX), nor Pillow, transformers or safetensors at import
time, and
chip_smoke.py refuses to run without a GPU.
Each check runs in a fresh interpreter, since this test process has JAX
loaded already."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import importlib, pkgutil, sys
import leopard_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not jax_mods, jax_mods
jax_pkg = sorted(m for m in sys.modules if m == "leopard_tpu" or m.startswith("leopard_tpu."))
assert not jax_pkg, jax_pkg
# Pillow, transformers and safetensors load only inside the functions that need them
host_libs = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("PIL", "transformers", "safetensors"))
assert not host_libs, host_libs
print(" ".join(names))
"""
# modules that must exist and import without JAX (each slice adds its own)
REQUIRED = ("ops.flash_attention", "ops.int4_matmul", "ops.fused_norms",
            "ops.chunked_attention", "inference.engine", "inference.speculative",
            "inference.beam", "training.trainer", "data.anyres", "data.chat",
            "data.tokenizer", "inference.continuous", "inference.server", "inference.api",
            "convert.hf", "data.conversation", "data.processor", "data.native",
            "data.text_dataset", "data.dataset", "cli.generate", "cli.serve",
            "cli.train_leopard_llava", "cli.convert_checkpoint", "data.idefics2_processor",
            "models.perceiver", "evaluation.metrics", "evaluation.vqa_metrics",
            "evaluation.loaders", "evaluation.harness", "evaluation.adapter",
            "evaluation.lm_eval_adapter", "cli.run_eval", "ops.remat")


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_every_module_without_jax():
    proc = _run(["-c", IMPORT_ALL], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 15  # every module of the package
    missing = [m for m in REQUIRED if "leopard_tpu_torch." + m not in names]
    assert not missing, missing


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run for real")
    proc = _run([str(REPO / "chip_smoke.py")], cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "jax" not in proc.stderr.lower()


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
