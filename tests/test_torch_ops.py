"""Parity of the PyTorch port's plain ops with the JAX package's.

Inputs are made from a seed with numpy and fed to both; outputs are compared
in float32 at 1e-5 (both sides compute in fp32 on the CPU, so the only
difference is the order of the sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leopard_tpu import config as cfgs
from leopard_tpu.ops import attention as jattn
from leopard_tpu.ops import image as jimage
from leopard_tpu.ops import norms as jnorms
from leopard_tpu.ops import pixel_shuffle as jps
from leopard_tpu.ops import rotary as jrot
from leopard_tpu_torch.ops import attention as tattn
from leopard_tpu_torch.ops import image as timage
from leopard_tpu_torch.ops import norms as tnorms
from leopard_tpu_torch.ops import pixel_shuffle as tps
from leopard_tpu_torch.ops import rotary as trot

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("shape,eps", [((2, 5, 64), 1e-5), ((3, 128), 1e-6), ((1, 4, 7, 72), 1e-5)])
def test_rms_norm(shape, eps):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3
    w = rng.randn(shape[-1]).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps), want)


@pytest.mark.parametrize("shape", [(2, 5, 1152), (3, 72)])
def test_layer_norm(shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32) + 0.5
    w, b = rng.randn(2, shape[-1]).astype(np.float32)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-6)
    _close(got, want)


def _range_reduction_tol(angles: np.ndarray) -> np.ndarray:
    """How far an fp32 cos/sin of the fp32 angle x may be from the exact
    value: a libm finds it by reducing x by k·π/2, and a reduction carried in
    fp32 arithmetic may err by one rounding of a product of size |x|,
    |x|·2^-24 (1.2e-3 at |x| = 2·10^4, 5e-6 below |x| = 64), on top of 1e-6
    for the result's own rounding. Two hosts' libms may each use that room,
    so a fixed 1e-5 between two tables depends on the host at large angles."""
    return 1e-6 + np.abs(angles) * 2.0**-24


@pytest.mark.parametrize("text_cfg", [
    cfgs.llama3_1_8b(),
    cfgs.mistral_7b(),
    cfgs.TextConfig(head_dim=16, rope_scaling="linear", rope_scaling_factor=4.0),
], ids=["llama3.1", "none", "linear"])
def test_rope(text_cfg):
    inv_j = jrot.compute_inv_freq(text_cfg)
    inv_t = trot.compute_inv_freq(text_cfg)
    np.testing.assert_array_equal(inv_t, inv_j)
    rng = np.random.RandomState(2)
    d = text_cfg.head_dim
    # positions past the original 8192 context exercise the scaled bands
    pos = rng.randint(0, 20000, size=(2, 9)).astype(np.int32)
    x = rng.randn(2, 9, 3, d).astype(np.float32)
    cos_j, sin_j = jrot.rope_cos_sin(jnp.asarray(pos), jnp.asarray(inv_j))
    cos_t, sin_t = trot.rope_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv_t))
    # the float64 oracle, from the same fp32 angles both packages form
    angles = pos.astype(np.float32)[..., None] * inv_j
    angles = np.concatenate([angles, angles], axis=-1)
    tol = _range_reduction_tol(angles)
    for name, table, oracle in (("cos", (cos_t, cos_j), np.cos(angles.astype(np.float64))),
                                ("sin", (sin_t, sin_j), np.sin(angles.astype(np.float64)))):
        port, jax_table = table[0].numpy(), np.asarray(table[1])
        assert np.all(np.abs(port - oracle) <= tol), f"port {name} vs float64"
        assert np.all(np.abs(jax_table - oracle) <= tol), f"JAX {name} vs float64"
        assert np.all(np.abs(port - jax_table) <= 2 * tol), f"port vs JAX {name}"
    # rotation itself, on the same tables
    got = trot.apply_rope(torch.from_numpy(x), torch.tensor(np.asarray(cos_j)),
                          torch.tensor(np.asarray(sin_j)))
    _close(got, jrot.apply_rope(jnp.asarray(x), cos_j, sin_j))


def test_rope_small_positions_exact_tables():
    cfg = cfgs.llama3_1_8b()
    pos = np.arange(64, dtype=np.int32)[None]
    inv = jrot.compute_inv_freq(cfg)
    cos_j, sin_j = jrot.rope_cos_sin(jnp.asarray(pos), jnp.asarray(inv))
    cos_t, sin_t = trot.rope_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv))
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)


ATTN_CASES = {
    "causal_gqa": dict(b=2, sq=12, skv=12, hq=4, hkv=2, d=16, causal=True),
    "bidir_mha_d72": dict(b=1, sq=10, skv=10, hq=2, hkv=2, d=72, causal=False),
    "segments_padding": dict(b=2, sq=12, skv=12, hq=4, hkv=1, d=8, causal=True,
                             seg=[[1] * 5 + [2] * 4 + [0] * 3, [1] * 12]),
    "window": dict(b=2, sq=16, skv=16, hq=4, hkv=2, d=8, causal=True, window=5),
    "fully_masked_rows": dict(b=1, sq=6, skv=6, hq=2, hkv=1, d=8, causal=False,
                              seg=[[0, 0, 1, 1, 0, 2]]),
    "cross_len": dict(b=1, sq=4, skv=9, hq=2, hkv=1, d=16, causal=False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES), ids=list(ATTN_CASES))
def test_dense_attention(case):
    c = ATTN_CASES[case]
    rng = np.random.RandomState(3)
    q = rng.randn(c["b"], c["sq"], c["hq"], c["d"]).astype(np.float32)
    k = rng.randn(c["b"], c["skv"], c["hkv"], c["d"]).astype(np.float32)
    v = rng.randn(c["b"], c["skv"], c["hkv"], c["d"]).astype(np.float32)
    seg = np.asarray(c["seg"], np.int32) if "seg" in c else None
    kw = dict(causal=c["causal"], sliding_window=c.get("window"))
    want = jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_segment_ids=None if seg is None else jnp.asarray(seg),
        kv_segment_ids=None if seg is None else jnp.asarray(seg), **kw,
    )
    got = tattn.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_segment_ids=None if seg is None else torch.from_numpy(seg),
        kv_segment_ids=None if seg is None else torch.from_numpy(seg), **kw,
    )
    # fully-masked rows included: both give the same finite uniform average
    assert torch.isfinite(got).all()
    _close(got, want)


def test_attention_mask_matches():
    seg = np.array([[1, 1, 2, 2, 0], [1, 1, 1, 0, 0]], np.int32)
    want = jattn.make_attention_mask(5, 5, causal=True, q_segment_ids=jnp.asarray(seg),
                                     kv_segment_ids=jnp.asarray(seg), sliding_window=2)
    got = tattn.make_attention_mask(5, 5, causal=True, q_segment_ids=torch.from_numpy(seg),
                                    kv_segment_ids=torch.from_numpy(seg), sliding_window=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,side,d", [(2, 4, 3), (1, 26, 8), (3, 2, 5)])
def test_pixel_shuffle(b, side, d):
    x = np.random.RandomState(4).randn(b, side * side, d).astype(np.float32)
    want = jps.pixel_shuffle(jnp.asarray(x), 2)
    got = tps.pixel_shuffle(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_normalize_uint8_nhwc():
    imgs = np.random.RandomState(5).randint(0, 256, (2, 28, 20, 3)).astype(np.uint8)
    mean, std = (0.48, 0.45, 0.40), (0.26, 0.26, 0.27)
    want = jimage.normalize_uint8_nhwc(jnp.asarray(imgs), mean, std)
    got = timage.normalize_uint8_nhwc(torch.from_numpy(imgs), mean, std)
    assert got.shape == (2, 3, 28, 20)
    _close(got, want)
