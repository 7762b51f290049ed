"""The port's flash-attention forward against the JAX Pallas kernel.

On the CPU the port's `flash_attention` computes its plain version; the JAX
kernel runs in Pallas interpret mode, as tests/test_attention_kernels.py
runs it. Both get the same numpy inputs; valid rows are compared at 1e-4 in
float32 (fully-masked padding rows are don't-care in both kernels).

The kernel itself, which runs only on the card, is held against the plain
version in tests/test_torch_flash_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leopard_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _qkv(b, sq, skv, hq, hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32))


def _jax_flash(q, k, v, **kw):
    from leopard_tpu.ops.pallas.flash_attention import flash_attention

    return np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def _port(q, k, v, **kw):
    return tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 16), (4, 1, 8), (2, 2, 128)])
def test_causal_gqa(interpret_mode, hq, hkv, d):
    q, k, v = _qkv(2, 32, 32, hq, hkv, d)
    want = _jax_flash(q, k, v, causal=True, block_q=8, block_k=8)
    np.testing.assert_allclose(_port(q, k, v, causal=True), want, **TOL)


def test_noncausal_ragged_length(interpret_mode):
    """The vision tower's case: 20 real tokens, no tile divides them. The JAX
    side pads to a block multiple with segment 0 (siglip.py:174-191); the
    port takes the unpadded length."""
    s, s_pad = 20, 24
    q, k, v = _qkv(2, s, s, 2, 2, 72, seed=1)
    pad = ((0, 0), (0, s_pad - s), (0, 0), (0, 0))
    seg = np.zeros((2, s_pad), np.int32)
    seg[:, :s] = 1
    want = _jax_flash(
        np.pad(q, pad), np.pad(k, pad), np.pad(v, pad), causal=False,
        q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
        block_q=8, block_k=s_pad, kv_only_mask=True,
    )[:, :s]
    np.testing.assert_allclose(_port(q, k, v, causal=False), want, **TOL)


@pytest.mark.parametrize("kv_only_mask", [True, False], ids=["kv_only", "full_seg"])
def test_right_padded_segments(interpret_mode, kv_only_mask):
    """The decoder prefill's case: right-padded rows. The port always takes
    the full segment mask; on valid rows it equals the TPU kernel's
    kv_only_mask path."""
    q, k, v = _qkv(2, 24, 24, 4, 2, 16, seed=2)
    seg = np.array([[1] * 24, [1] * 13 + [0] * 11], np.int32)
    want = _jax_flash(q, k, v, causal=True, q_segment_ids=jnp.asarray(seg),
                      kv_segment_ids=jnp.asarray(seg), block_q=8, block_k=8,
                      kv_only_mask=kv_only_mask)
    got = _port(q, k, v, causal=True, q_segment_ids=torch.from_numpy(seg),
                kv_segment_ids=torch.from_numpy(seg))
    valid = seg != 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


def test_packed_segments_and_window(interpret_mode):
    q, k, v = _qkv(1, 32, 32, 4, 2, 16, seed=3)
    seg = np.array([[1] * 10 + [2] * 14 + [3] * 5 + [0] * 3], np.int32)
    kw = dict(causal=True, sliding_window=6)
    want = _jax_flash(q, k, v, q_segment_ids=jnp.asarray(seg),
                      kv_segment_ids=jnp.asarray(seg), block_q=8, block_k=8, **kw)
    got = _port(q, k, v, q_segment_ids=torch.from_numpy(seg),
                kv_segment_ids=torch.from_numpy(seg), **kw)
    valid = seg != 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_recurring_segment_ids(interpret_mode, causal):
    """Ids that come back in one row (1, 2, 1, 0): a segment id is a label,
    not a span, so the first and third runs attend each other. The kernels'
    tile ranges only widen for such ids; these are the semantics the
    skipping must keep."""
    q, k, v = _qkv(2, 32, 32, 4, 2, 16, seed=4)
    seg = np.array([[1] * 8 + [2] * 10 + [1] * 8 + [0] * 6,
                    [2] * 5 + [1] * 11 + [2] * 16], np.int32)
    want = _jax_flash(q, k, v, causal=causal, q_segment_ids=jnp.asarray(seg),
                      kv_segment_ids=jnp.asarray(seg), block_q=8, block_k=8)
    got = _port(q, k, v, causal=causal, q_segment_ids=torch.from_numpy(seg),
                kv_segment_ids=torch.from_numpy(seg))
    valid = seg != 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 1, 16))
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=True)
    assert tflash.flash_attention.launches == before
    torch.testing.assert_close(got, tflash.flash_attention_ref(q, k, v, causal=True),
                               rtol=0, atol=0)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(q, q, q)
