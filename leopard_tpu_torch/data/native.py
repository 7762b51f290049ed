"""ctypes bindings for the native index builders (port of
leopard_tpu/data/native.py, over the port's own copy of
`_native/index_builders.cpp`).

The C++ source is compiled with g++ at first use into `build/` at the root
of the checkout, as `libindex_builders-<hash of the source>.so`, so an
edited source is rebuilt and an unchanged one is loaded as it is. The
library is written under a temporary name and renamed, so processes that
build at once (test workers) never load a half-written file. Nothing is
built when the module is imported.

This is host code. The functions call the compiled library and raise if it
cannot be built; they do not fall back. The numpy versions (`*_numpy`) are
the JAX package's fallbacks, kept as the tests' oracle. The shuffle is the
exception: the library's splitmix64 Fisher-Yates and numpy's RandomState
give different permutations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from leopard_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "_native" / "index_builders.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libindex_builders-{digest}.so"


def build() -> Path:
    """Compile the source into build/ unless it is already there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", tmp],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i16, i32, i64 = (ctypes.POINTER(t) for t in (ctypes.c_int16, ctypes.c_int32,
                                                      ctypes.c_int64))
        lib.leopard_build_blending_indices.restype = None
        lib.leopard_build_blending_indices.argtypes = [
            i16, i64, ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int64]
        lib.leopard_build_exhaustive_blending_indices.restype = None
        lib.leopard_build_exhaustive_blending_indices.argtypes = [i16, i64, i64, ctypes.c_int32]
        lib.leopard_build_sample_index.restype = ctypes.c_int64
        lib.leopard_build_sample_index.argtypes = [
            i32, i32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, i64]
        lib.leopard_shuffle_indices.restype = None
        lib.leopard_shuffle_indices.argtypes = [i64, ctypes.c_int64, ctypes.c_uint64]
        lib.leopard_pack_sequences_ffd.restype = ctypes.c_int64
        lib.leopard_pack_sequences_ffd.argtypes = [i32, ctypes.c_int64, ctypes.c_int32, i32]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library builds (or is built) and loads."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_blending_indices(weights: np.ndarray, size: int):
    """→ (dataset_index int16[size], dataset_sample_index int64[size]): for
    each output sample, the dataset whose realized share lags its weight
    most, and that dataset's running sample count."""
    weights = np.ascontiguousarray(weights, np.float64)
    ds_idx = np.empty(size, np.int16)
    ds_sample = np.empty(size, np.int64)
    _load().leopard_build_blending_indices(
        _ptr(ds_idx, ctypes.c_int16), _ptr(ds_sample, ctypes.c_int64),
        _ptr(weights, ctypes.c_double), len(weights), size)
    return ds_idx, ds_sample


def build_exhaustive_blending_indices(sizes: np.ndarray):
    """Blending that draws every sample of every dataset exactly once."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    total = int(sizes.sum())
    ds_idx = np.empty(total, np.int16)
    ds_sample = np.empty(total, np.int64)
    _load().leopard_build_exhaustive_blending_indices(
        _ptr(ds_idx, ctypes.c_int16), _ptr(ds_sample, ctypes.c_int64),
        _ptr(sizes, ctypes.c_int64), len(sizes))
    return ds_idx, ds_sample


def build_sample_index(document_lengths: np.ndarray, document_order: np.ndarray,
                       seq_len: int, num_samples: int):
    """→ int64 [built+1, 2] rows of (order position, in-document offset)."""
    document_lengths = np.ascontiguousarray(document_lengths, np.int32)
    document_order = np.ascontiguousarray(document_order, np.int32)
    if len(document_order) and int(document_order.max()) >= len(document_lengths):
        raise ValueError("document_order names a document past document_lengths")
    out = np.zeros((num_samples + 1, 2), np.int64)
    built = _load().leopard_build_sample_index(
        _ptr(document_lengths, ctypes.c_int32), _ptr(document_order, ctypes.c_int32),
        len(document_order), seq_len, num_samples, _ptr(out, ctypes.c_int64))
    return out[: built + 1]


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """A permutation of range(n): Fisher-Yates driven by splitmix64(seed)."""
    idx = np.arange(n, dtype=np.int64)
    _load().leopard_shuffle_indices(_ptr(idx, ctypes.c_int64), n, seed)
    return idx


def pack_sequences_ffd(lengths: np.ndarray, capacity: int):
    """First-fit-decreasing packing → (bin_ids int32[n] (−1 = too long),
    num_bins)."""
    lengths = np.ascontiguousarray(lengths, np.int32)
    bin_ids = np.empty(len(lengths), np.int32)
    nbins = _load().leopard_pack_sequences_ffd(
        _ptr(lengths, ctypes.c_int32), len(lengths), capacity, _ptr(bin_ids, ctypes.c_int32))
    return bin_ids, int(nbins)


# ---------------------------------------------------------------------------
# The numpy versions: the JAX package's fallbacks, the tests' oracle
# ---------------------------------------------------------------------------


def build_blending_indices_numpy(weights: np.ndarray, size: int):
    weights = np.asarray(weights, np.float64)
    ds_idx = np.empty(size, np.int16)
    ds_sample = np.empty(size, np.int64)
    counts = np.zeros(len(weights), np.int64)
    for s in range(size):
        err = weights * max(float(s), 1.0) - counts
        d = int(np.argmax(err))
        ds_idx[s] = d
        ds_sample[s] = counts[d]
        counts[d] += 1
    return ds_idx, ds_sample


def build_exhaustive_blending_indices_numpy(sizes: np.ndarray):
    sizes = np.asarray(sizes, np.int64)
    total = int(sizes.sum())
    ds_idx = np.empty(total, np.int16)
    ds_sample = np.empty(total, np.int64)
    weights = sizes / total
    counts = np.zeros(len(sizes), np.int64)
    live = np.ones(len(sizes), bool)
    for s in range(total):
        err = np.where(live, weights * max(float(s), 1.0) - counts, -np.inf)
        d = int(np.argmax(err))
        ds_idx[s] = d
        ds_sample[s] = counts[d]
        counts[d] += 1
        if counts[d] >= sizes[d]:
            live[d] = False
    return ds_idx, ds_sample


def build_sample_index_numpy(document_lengths: np.ndarray, document_order: np.ndarray,
                             seq_len: int, num_samples: int):
    out = np.zeros((num_samples + 1, 2), np.int64)
    sample, doc_pos, doc_off = 0, 0, 0
    while sample < num_samples and doc_pos < len(document_order):
        remaining = seq_len + 1
        while remaining > 0 and doc_pos < len(document_order):
            doc_len = int(document_lengths[document_order[doc_pos]]) - doc_off
            if doc_len > remaining:
                doc_off += remaining
                remaining = 0
            else:
                remaining -= doc_len
                doc_pos += 1
                doc_off = 0
        sample += 1
        out[sample] = (doc_pos, doc_off)
    return out[: sample + 1]


def shuffle_indices_numpy(n: int, seed: int) -> np.ndarray:
    """numpy's RandomState permutation: another order than the library's."""
    idx = np.arange(n, dtype=np.int64)
    np.random.RandomState(seed % (2**32)).shuffle(idx)
    return idx


def pack_sequences_ffd_numpy(lengths: np.ndarray, capacity: int):
    lengths = np.asarray(lengths, np.int32)
    bin_ids = np.empty(len(lengths), np.int32)
    space: list[int] = []
    for i in np.argsort(-lengths, kind="stable"):
        li = int(lengths[i])
        if li > capacity:
            bin_ids[i] = -1
            continue
        placed = next((b for b, s in enumerate(space) if s >= li), -1)
        if placed < 0:
            space.append(capacity)
            placed = len(space) - 1
        space[placed] -= li
        bin_ids[i] = placed
    return bin_ids, len(space)
