"""The port's native index builders (leopard_tpu_torch/data/native.py, its
own copy of index_builders.cpp built into build/) against the JAX package's
compiled functions and against the numpy versions, on the cases of
tests/test_native.py and a few seeded larger ones. Exact equality
throughout: the same integer algorithms."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from leopard_tpu.data import native as jnative
from leopard_tpu_torch.data import native as tnative

REPO = Path(__file__).resolve().parents[1]


def test_builds_into_build_dir():
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.parent == REPO / "build" and path.exists()
    assert (tnative.SOURCE.read_bytes()
            == (REPO / "leopard_tpu/data/_native/index_builders.cpp").read_bytes())


BUILD_AT_ONCE = """
import sys
from pathlib import Path
from leopard_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
import numpy as np
print(native.pack_sequences_ffd(np.array([5, 3, 9], np.int32), 10)[1])
"""


def test_concurrent_builds(tmp_path):
    """Four processes that build into an empty directory at once each load
    a whole library and leave only it behind."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AT_ONCE, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == ["2"] * 4
    assert [f.name for f in tmp_path.iterdir()] == [tnative.library_path().name]


def _three(fn, *args):
    """(port, JAX compiled, numpy version) of one function."""
    assert jnative.native_available()
    return (getattr(tnative, fn)(*args), getattr(jnative, fn)(*args),
            getattr(tnative, fn + "_numpy")(*args))


def _equal(outs):
    port, jax_c, ref = outs
    for a in (jax_c, ref):
        if isinstance(port, tuple):
            assert len(a) == len(port)
            for x, y in zip(port, a):
                np.testing.assert_array_equal(x, y)
                assert np.asarray(x).dtype == np.asarray(y).dtype
        else:
            np.testing.assert_array_equal(port, a)
            assert port.dtype == a.dtype


@pytest.mark.parametrize("weights,size", [([0.5, 0.3, 0.2], 100), ([0.1, 0.9], 37),
                                          ([1.0], 5), ([0.25] * 4, 1000)])
def test_blending(weights, size):
    outs = _three("build_blending_indices", np.asarray(weights), size)
    _equal(outs)
    counts = np.bincount(outs[0][0], minlength=len(weights))
    np.testing.assert_allclose(counts / size, weights, atol=max(0.02, 2 / size))


@pytest.mark.parametrize("sizes", [[7, 3, 5], [1, 1], [100, 1, 40]])
def test_exhaustive_blending(sizes):
    outs = _three("build_exhaustive_blending_indices", np.asarray(sizes, np.int64))
    _equal(outs)
    idx, samp = outs[0]
    np.testing.assert_array_equal(np.bincount(idx, minlength=len(sizes)), sizes)
    for d, n in enumerate(sizes):
        np.testing.assert_array_equal(samp[idx == d], np.arange(n))


def test_sample_index():
    rng = np.random.RandomState(0)
    cases = [(np.array([10, 10, 10], np.int32), np.array([0, 1, 2], np.int32), 4, 5)]
    lengths = rng.randint(1, 50, 40).astype(np.int32)
    cases.append((lengths, rng.permutation(40).astype(np.int32), 16, 30))
    cases.append((lengths, np.concatenate([rng.permutation(40)] * 2).astype(np.int32), 7, 1000))
    for case in cases:
        _equal(_three("build_sample_index", *case))
    rows = tnative.build_sample_index(*cases[0])
    np.testing.assert_array_equal(rows[:3], [[0, 0], [0, 5], [1, 0]])


def test_sample_index_rejects_bad_order():
    with pytest.raises(ValueError):
        tnative.build_sample_index(np.array([3, 3], np.int32), np.array([0, 2], np.int32), 2, 2)


def splitmix_shuffle(n, seed):
    """Fisher-Yates driven by splitmix64, as index_builders.cpp writes it."""
    mask = (1 << 64) - 1
    state = seed & mask
    idx = list(range(n))
    for i in range(n - 1, 0, -1):
        state = (state + 0x9E3779B97F4A7C15) & mask
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        z ^= z >> 31
        j = z % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return np.asarray(idx, np.int64)


@pytest.mark.parametrize("n,seed", [(1000, 7), (1000, 8), (1, 3), (0, 1), (257, 2**40 + 5)])
def test_shuffle(n, seed):
    """The library's permutation equals the JAX package's compiled one and
    the splitmix64 Fisher-Yates above; numpy's version is another
    permutation of the same indices."""
    port = tnative.shuffle_indices(n, seed)
    np.testing.assert_array_equal(port, jnative.shuffle_indices(n, seed))
    np.testing.assert_array_equal(port, splitmix_shuffle(n, seed))
    np.testing.assert_array_equal(np.sort(tnative.shuffle_indices_numpy(n, seed)), np.arange(n))
    assert port.dtype == np.int64


@pytest.mark.parametrize("lengths,cap", [([10, 90, 50, 50, 200], 100), ([5] * 20, 16),
                                         ([], 8), ([9, 1, 8, 2, 7, 3, 6, 4, 5], 10)])
def test_pack_ffd(lengths, cap):
    outs = _three("pack_sequences_ffd", np.asarray(lengths, np.int32), cap)
    port, jax_c, ref = outs
    np.testing.assert_array_equal(port[0], jax_c[0])
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] == jax_c[1] == ref[1]
    bins, nbins = port
    lengths = np.asarray(lengths, np.int32)
    for b in range(nbins):
        assert lengths[bins == b].sum() <= cap
    assert ((bins == -1) == (lengths > cap)).all()


def test_pack_ffd_random():
    rng = np.random.RandomState(1)
    lengths = rng.randint(1, 300, 500).astype(np.int32)
    port, jax_c, ref = _three("pack_sequences_ffd", lengths, 256)
    np.testing.assert_array_equal(port[0], jax_c[0])
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] == jax_c[1] == ref[1]
