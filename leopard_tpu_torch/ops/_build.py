"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface, so it compiles in seconds
without PyTorch's headers. The shared library goes into `build/` at the root
of the checkout, named after a hash of its source and of the headers in
`csrc/` (`*.cuh`), so an edited source or header is rebuilt and an unchanged
one is loaded as it is. Nothing is built when the
module is imported: the first call to `load_library` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME"
        )
    return str(path)


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile csrc/<name>.cu into build/ unless it is already there. The
    library is written under a temporary name and renamed, so concurrent
    builders never load a half-written file."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-o", tmp, str(CSRC_DIR / f"{name}.cu"),
    ]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name, verbose=verbose)))
    return _loaded[name]
