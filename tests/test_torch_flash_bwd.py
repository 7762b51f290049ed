"""The flash backward's plain version (K2's) and the port's differentiable
`flash_attention` against `jax.grad` through the JAX package's Pallas
`flash_attention` (default bwd_impl="flash", the dq and dk/dv kernels), run
in interpret mode on the CPU as tests/test_attention_kernels.py runs it.

Inputs come from numpy with a seed; the cotangent is non-uniform and zero
on padding rows (a padding query's output is don't-care, so no loss reads
it). Tolerance rtol 2e-4, atol 2e-5, the JAX flash tests': both sides are
fp32 and differ only in the order of their sums. K1's lse output is held
against the JAX forward's saved lse on the rows that attend something.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leopard_tpu.ops.pallas import flash_attention as jflash
from leopard_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-5)

CASES = {
    # name: (b, s, hq, hkv, d, causal, window, segments per row or None)
    "causal_gqa": (2, 32, 4, 2, 16, True, None, None),
    "segments_padding": (2, 32, 4, 1, 16, True, None, ([1] * 14 + [2] * 12 + [0] * 6,
                                                       [1] * 9 + [2] * 23)),
    "sliding_window": (1, 32, 2, 1, 64, True, 7, None),
    "noncausal_d72_ragged": (2, 76, 2, 2, 72, False, None, None),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    b, s, hq, hkv, d, causal, window, segs = CASES[request.param]
    rng = np.random.RandomState(0)
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    seg = None if segs is None else np.asarray(segs, np.int32)
    g = rng.randn(b, s, hq, d).astype(np.float32)
    if seg is not None:
        g *= (seg != 0)[:, :, None, None]
    kw = dict(causal=causal, sliding_window=window)

    def jax_out(q, k, v):
        return jflash.flash_attention(
            q, k, v, q_segment_ids=None if seg is None else jnp.asarray(seg),
            kv_segment_ids=None if seg is None else jnp.asarray(seg),
            block_q=s, block_k=s, **kw)

    with pltpu.force_tpu_interpret_mode():
        j_grads = jax.grad(lambda q, k, v: jnp.sum(jax_out(q, k, v) * g), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ones = jnp.ones((b, s), jnp.int32)
        jseg = ones if seg is None else jnp.asarray(seg)
        _, j_lse = jflash._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, jseg, scale=d**-0.5,
            block_q=s, block_k=s, save_lse=True, **kw)
    tseg = None if seg is None else torch.from_numpy(seg)
    return dict(
        q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v),
        seg=tseg, g=torch.from_numpy(g), kw=kw,
        valid=np.ones((b, s), bool) if seg is None else seg != 0,
        j_grads=[np.asarray(x) for x in j_grads],
        j_lse=np.asarray(j_lse)[..., 0],  # [B, Hq, S]: the 128-lane replica's first lane
    )


def test_plain_backward_matches_jax(case):
    q, k, v, seg, kw = case["q"], case["k"], case["v"], case["seg"], case["kw"]
    out = tflash.flash_attention_ref(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, **kw)
    lse = tflash.flash_attention_lse_ref(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, **kw)
    got = tflash.flash_attention_bwd_ref(q, k, v, seg, seg, out, lse, case["g"], **kw)
    for name, a, want in zip("qkv", got, case["j_grads"]):
        np.testing.assert_allclose(a.numpy(), want, **TOL, err_msg=f"d{name}")


def test_autograd_flash_attention_matches_jax(case):
    q, k, v = (t.clone().requires_grad_() for t in (case["q"], case["k"], case["v"]))
    seg = case["seg"]
    before = tflash.flash_attention_bwd.launches
    out = tflash.flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, **case["kw"])
    got = torch.autograd.grad(out, (q, k, v), case["g"])
    assert tflash.flash_attention_bwd.launches == before  # CPU tensors: the plain version
    for name, a, want in zip("qkv", got, case["j_grads"]):
        np.testing.assert_allclose(a.numpy(), want, **TOL, err_msg=f"d{name}")


def test_lse_matches_jax_forward(case):
    q, k, v, seg = case["q"], case["k"], case["v"], case["seg"]
    lse = tflash.flash_attention_lse_ref(q, k, v, q_segment_ids=seg, kv_segment_ids=seg,
                                         **case["kw"]).numpy()
    valid = np.broadcast_to(case["valid"][:, None, :], lse.shape)
    np.testing.assert_allclose(lse[valid], case["j_lse"][valid], rtol=1e-5, atol=1e-5)
    # a fully-masked (padding) row: about -1e30, which K2 never exponentiates
    assert np.all(lse[~valid] < -1e29)
