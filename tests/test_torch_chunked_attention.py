"""`chunked_continuation_attention` and `pick_chunk` of the port against the
JAX package's (leopard_tpu/ops/chunked_attention.py and
leopard_tpu/models/decoder.py::_pick_chunk).

The same numpy inputs go through both: new queries against a cache whose
rows are valid up to ragged lengths, with holes, at several chunk sizes,
with and without a sliding window. A float32 cache agrees at 1e-5; an int8
cache, whose products take bf16 operands on both sides, at the JAX
package's own 2e-2 (tests/test_attn_impl.py). The chunk picker is checked
on the cases of tests/test_attn_impl.py::test_pick_chunk_keeps_lane_alignment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu.models.decoder import _pick_chunk as jax_pick_chunk
from leopard_tpu.ops import chunked_attention as jca
from leopard_tpu_torch.ops import chunked_attention as tca

B, SQ, SKV, HQ, HKV, D = 2, 12, 32, 4, 2, 16


def _inputs(seed, quant):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, SQ, HQ, D).astype(np.float32)
    valid = np.zeros((B, SKV), np.int32)
    valid[0, :27] = 1
    valid[1, :19] = 1
    valid[1, 4:6] = 0  # a hole: slots of a dropped draft
    # the new tokens sit at the end of each row's valid slots
    pos = np.stack([np.arange(27 - SQ, 27), np.arange(19 - SQ, 19)]).astype(np.int32)
    if quant:
        k = rng.randint(-127, 128, (B, SKV, HKV, D)).astype(np.int8)
        v = rng.randint(-127, 128, (B, SKV, HKV, D)).astype(np.int8)
        ks = (rng.rand(B, SKV, HKV) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(B, SKV, HKV) * 0.02 + 1e-3).astype(np.float32)
        return q, k, v, valid, pos, ks, vs
    k = rng.randn(B, SKV, HKV, D).astype(np.float32)
    v = rng.randn(B, SKV, HKV, D).astype(np.float32)
    return q, k, v, valid, pos, None, None


@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_chunked_continuation_attention_matches_jax(quant, chunk, window):
    q, k, v, valid, pos, ks, vs = _inputs(0, quant)
    kw = dict(sliding_window=window, chunk_size=chunk)
    want = jca.chunked_continuation_attention(
        *(jnp.asarray(a) for a in (q, k, v, valid, pos)),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), **kw)
    got = tca.chunked_continuation_attention(
        *(torch.from_numpy(a) for a in (q, k, v, valid, pos)),
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs), **kw)
    tol = 2e-2 if quant else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_chunked_continuation_attention_ignores_invalid_slots():
    """Changing K/V in slots that are invalid or in the future of every query
    leaves the output as it is."""
    q, k, v, valid, pos, _, _ = _inputs(1, False)
    args = [torch.from_numpy(a) for a in (q, k, v, valid, pos)]
    base = tca.chunked_continuation_attention(*args, chunk_size=8)
    k2, v2 = k.copy(), v.copy()
    k2[1, 4:6] = k2[1, 20:] = 99.0
    v2[1, 4:6] = v2[1, 20:] = -99.0
    k2[0, 27:] = v2[0, 27:] = 50.0
    args[1], args[2] = torch.from_numpy(k2), torch.from_numpy(v2)
    torch.testing.assert_close(tca.chunked_continuation_attention(*args, chunk_size=8), base,
                               rtol=0, atol=0)


PICK_CASES = [(s, t) for s in (8320, 8448, 8704, 4096, 1024) for t in (128, 256, 512, 1024)]
PICK_CASES += [(169, 512), (250, 128)]


@pytest.mark.parametrize("s,target", PICK_CASES)
def test_pick_chunk_matches_jax(s, target):
    c = tca.pick_chunk(s, target)
    assert c == jax_pick_chunk(s, target)
    assert s % c == 0 and c <= target
    if s % 128 == 0:
        assert c % 128 == 0
