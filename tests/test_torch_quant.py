"""The port's weight and KV quantization ops against the JAX package's.

Inputs are numpy arrays from a seed, fed to both packages. The port's bf16
weights are [out, in], so its quantizers take W.T of the JAX input and must
give the same bytes. K4's plain version is held against the Pallas kernel in
interpret mode at the JAX test's tolerance (bf16 operands).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leopard_tpu.ops import attention as jattention
from leopard_tpu.ops import quant as jquant
from leopard_tpu.ops.pallas.int4_matmul import int4_matmul as jax_int4_matmul
from leopard_tpu_torch.models.params import Params, QuantizedWeight
from leopard_tpu_torch.ops import attention as tattention
from leopard_tpu_torch.ops import int4_matmul as tk4
from leopard_tpu_torch.ops import quant as tquant

torch.set_num_threads(2)


def _w(shape, seed, scale=0.05):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _port(w_jax_layout: np.ndarray) -> torch.Tensor:
    """The same weight in the port's [..., out, in] layout."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(w_jax_layout, -1, -2)))


def _assert_same_leaf(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].is_contiguous(), key  # the kernel reads them as laid out
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (key, g.dtype, g.shape, w.dtype, w.shape)
        np.testing.assert_array_equal(g, w)


# (K, N) of the tests/test_int4.py tree cases, and a layer-stacked weight
SHAPES = {"k256": (256, 128), "k192": (192, 128), "k24": (24, 128),
          "stacked": (3, 512, 256)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_quantize_int8_bytes_match_jax(name):
    w = _w(SHAPES[name], seed=0)
    _assert_same_leaf(tquant.quantize_int8(_port(w)), jquant.quantize_int8(jnp.asarray(w)))


@pytest.mark.parametrize("name,group", [("k256", 128), ("k256", 64), ("k192", 32),
                                        ("stacked", 128), ("stacked", 16)])
def test_quantize_int4_bytes_match_jax(name, group):
    w = _w(SHAPES[name], seed=1)
    _assert_same_leaf(tquant.quantize_int4(_port(w), group=group),
                      jquant.quantize_int4(jnp.asarray(w), group=group))


def test_quantize_int4_rejects_an_unpackable_width():
    with pytest.raises(ValueError, match="multiple of 2 x group"):
        tquant.quantize_int4(torch.zeros(128, 24), group=16)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_tree_matches_jax_with_adaptive_group_and_int8_fallback(mode):
    # the tests/test_int4.py tree: group 128, a width that shrinks the group
    # to 32, one that falls back to int8, and a leaf that stays plain
    tree = {"wq": _w((256, 128), 2), "w_up": _w((192, 128), 3), "w_down": _w((24, 128), 4)}
    want = jquant.quantize_tree({k: jnp.asarray(v) for k, v in tree.items()}, mode=mode)
    module = Params({k: v.shape[::-1] for k, v in tree.items()} | {"norm": (128, 1)},
                    dtype=torch.float32)
    with torch.no_grad():
        for k, v in tree.items():
            getattr(module, k).copy_(_port(v))
    tquant.quantize_tree(module, mode=mode)
    for k in tree:
        leaf = getattr(module, k)
        assert isinstance(leaf, QuantizedWeight)
        _assert_same_leaf(dict(leaf.named_buffers()), want[k])
    assert isinstance(module.norm, torch.nn.Parameter)  # not in QUANT_KEYS
    if mode == "int4":
        assert module.wq.int4 and module.w_up.s.shape == (6, 128) and not module.w_down.int4
    assert set(module.state_dict()) >= {"wq.s", "w_down.q", "norm"}


def test_dequantize_tree_matches_jax():
    tree = {"wq": _w((256, 128), 5), "w_down": _w((24, 128), 6)}
    jq = jquant.quantize_tree({k: jnp.asarray(v) for k, v in tree.items()}, mode="int4")
    want = jquant.dequantize_tree(jq, dtype=jnp.float32)
    module = Params({k: v.shape[::-1] for k, v in tree.items()}, dtype=torch.float32)
    with torch.no_grad():
        for k, v in tree.items():
            getattr(module, k).copy_(_port(v))
    tquant.dequantize_tree(tquant.quantize_tree(module, mode="int4"), dtype=torch.float32)
    for k in tree:
        np.testing.assert_array_equal(getattr(module, k).detach().numpy().T,
                                      np.asarray(want[k]))


@pytest.fixture
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (8, 512, 384), (16, 256, 128),
                                   (64, 512, 256)])
def test_int4_matmul_ref_matches_the_pallas_kernel(interpret_mode, m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    jq = jquant.quantize_int4(jnp.asarray(w))
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), jq["q4"], jq["s"]))
    tq = tquant.quantize_int4(_port(w))
    got = tk4.int4_matmul(torch.from_numpy(x), tq["q4"], tq["s"])  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (m, n)
    # the JAX test's tolerance: bf16 operands, rounded at other places
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_int4_matmul_on_cpu_launches_nothing():
    q = tquant.quantize_int4(torch.randn(128, 256))
    before = tk4.int4_matmul.launches
    tk4.int4_matmul(torch.randn(2, 256), q["q4"], q["s"])
    assert tk4.int4_matmul.launches == before


def _oracle(x: np.ndarray, q: dict) -> np.ndarray:
    """x @ unpack(q) in fp32 (the JAX package's fp32 unpack)."""
    return x.astype(np.float32) @ np.asarray(jquant._unpack_int4(
        {"q4": jnp.asarray(q["q4"].numpy()), "s": jnp.asarray(q["s"].numpy())}))


@pytest.mark.parametrize("xshape,group", [((80, 512), 128), ((2, 40, 512), 128),
                                          ((4, 256), 64), ((3, 2, 256), 64)])
def test_dense_dequant_path_matches_the_fp32_oracle(xshape, group):
    """M > 64 (prefill) and non-128 groups take the dense path on any device."""
    rng = np.random.RandomState(11)
    x = rng.randn(*xshape).astype(np.float32)
    w = _w((xshape[-1], 192), 12)
    q = tquant.quantize_int4(_port(w), group=group)
    got = tquant.matmul(torch.from_numpy(x), QuantizedWeight(q))
    np.testing.assert_allclose(got.numpy(), _oracle(x, q), rtol=1e-4, atol=1e-4)


def test_dense_dequant_bf16_scales_in_fp32():
    """ADVICE r5 (JAX quant.py:119-122): the JAX dense path scales the int4
    weight in bf16. The port scales in fp32 and casts once, so for bf16 x it
    sits closer to the fp32 oracle than the JAX path does."""
    rng = np.random.RandomState(13)
    x = rng.randn(96, 1024).astype(np.float32)
    w = _w((1024, 512), 14)
    q = tquant.quantize_int4(_port(w))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    oracle = _oracle(xb.float().numpy(), q)
    got = tquant.matmul(xb, QuantizedWeight(q)).float().numpy()
    jq = {"q4": jnp.asarray(q["q4"].numpy()), "s": jnp.asarray(q["s"].numpy())}
    jax_bf16 = np.asarray(jquant.matmul(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jq),
                          np.float32)
    err_port = np.abs(got - oracle).mean()
    err_jax = np.abs(jax_bf16 - oracle).mean()
    assert err_port < err_jax, (err_port, err_jax)
    # one bf16 rounding of the weight and one of the output: about 2^-8 relative
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("xshape", [(3, 256), (2, 5, 256)])
def test_int8_matmul_matches_jax(xshape):
    rng = np.random.RandomState(15)
    x = rng.randn(*xshape).astype(np.float32)
    w = _w((256, 192), 16)
    want = jquant.matmul(jnp.asarray(x), jquant.quantize_int8(jnp.asarray(w)))
    got = tquant.matmul(torch.from_numpy(x), QuantizedWeight(tquant.quantize_int8(_port(w))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_matmul_takes_a_plain_weight_as_f_linear():
    x = torch.randn(3, 64)
    w = torch.randn(32, 64)
    torch.testing.assert_close(tquant.matmul(x, w), x @ w.T)


def test_a_cpu_tensor_never_takes_the_kernel_tier():
    q = tquant.quantize_int4(torch.randn(128, 256))
    assert not tquant.use_int4_kernel(torch.randn(2, 256), q["q4"], q["s"])


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "padded_mask"])
def test_attention_quant_kv_matches_jax(masked):
    rng = np.random.RandomState(17)
    b, sq, skv, hq, hkv, d = 2, 3, 11, 4, 2, 16
    q = rng.randn(b, sq, hq, d).astype(np.float32)
    k_q = rng.randint(-127, 128, (b, skv, hkv, d)).astype(np.int8)
    v_q = rng.randint(-127, 128, (b, skv, hkv, d)).astype(np.int8)
    k_s = (rng.rand(b, skv, hkv) * 0.02 + 1e-3).astype(np.float32)
    v_s = (rng.rand(b, skv, hkv) * 0.02 + 1e-3).astype(np.float32)
    mask = None
    if masked:  # row 1 has 7 valid slots; causal over the last sq positions
        valid = np.arange(skv)[None] < np.array([11, 7])[:, None]
        pos = np.array([[8, 9, 10], [4, 5, 6]])
        mask = (valid[:, None, :] & (pos[:, :, None] >= np.arange(skv)[None, None]))[:, None]
    want = jattention.attention_quant_kv(
        jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(k_s), jnp.asarray(v_q),
        jnp.asarray(v_s), mask=None if mask is None else jnp.asarray(mask))
    got = tattention.attention_quant_kv(
        torch.from_numpy(q), torch.from_numpy(k_q), torch.from_numpy(k_s),
        torch.from_numpy(v_q), torch.from_numpy(v_s),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
