"""The port's quantized decoder against the JAX package's: the int8 KV cache,
a JAX-quantized parameter tree loaded as it is, and the K4 tier driven
through its plain version on the CPU.

Weights are the JAX init, moved by `state_dict_from_jax`; both packages run
float32 on the CPU and logits are compared at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.models import decoder as jdecoder
from leopard_tpu.models import vlm as jvlm
from leopard_tpu.ops import quant as jquant
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.models.decoder import KVCache
from leopard_tpu_torch.models.params import QuantizedWeight
from leopard_tpu_torch.ops import quant as tquant

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def narrow_kernel_widths_cfg(vocab_size: int = 1024) -> cfgs.VLMConfig:
    """Every decoder K a multiple of 256 and every N a multiple of 128, so
    every int4 leaf takes group 128, the kernel's; head dim 128 as at 8B."""
    vision = cfgs.VisionConfig(hidden_size=32, intermediate_size=64, num_layers=1,
                               num_heads=2, image_size=56, patch_size=14, dtype="float32")
    text = cfgs.TextConfig(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                           num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
                           dtype="float32")
    return cfgs.VLMConfig(
        vision=vision, text=text,
        projector=cfgs.ProjectorConfig(input_size=32 * 4, hidden_size=256, dtype="float32"),
        anyres=cfgs.AnyResConfig(tile_size=56, tile_budget=6, tokens_per_tile=4),
        image_token_id=vocab_size - 1,
    )


def _pair(cfg, seed=0):
    params = jax.device_get(jvlm.init_params(cfg, jax.random.PRNGKey(seed)))
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return params, model.eval()


def _tokens(cfg, lengths, seed):
    rng = np.random.RandomState(seed)
    tokens = np.zeros((len(lengths), max(lengths)), np.int32)
    seg = np.zeros_like(tokens)
    for r, n in enumerate(lengths):
        tokens[r, :n] = rng.randint(1, cfg.image_token_id, size=n)
        seg[r, :n] = 1
    return tokens, seg


@pytest.mark.parametrize("mode", [None, "int4"], ids=["bf16_weights", "int4_weights"])
def test_decoder_int8_kv_cache_matches_jax(mode):
    """Fresh prefill into an int8 cache, then two cached decode steps through
    attention_quant_kv: logits, index, segments and the scales match."""
    cfg = cfgs.tiny_vlm()
    params, model = _pair(cfg)
    jtext = params["text"] if mode is None else jquant.quantize_tree(params["text"], mode=mode)
    if mode is not None:
        tquant.quantize_tree(model.text, mode=mode)
    tokens, seg = _tokens(cfg, [9, 5], seed=1)
    steps = [np.array([[3], [4]], np.int32), np.array([[7], [2]], np.int32)]
    jcache = jdecoder.KVCache.create(cfg.text, 2, 16, quantized=True)
    jlog, jcache = jdecoder.forward(jtext, cfg.text, jnp.asarray(tokens),
                                    segment_ids=jnp.asarray(seg), cache=jcache,
                                    fresh_cache=True)
    jlogs = [jlog]
    tcache = KVCache.create(cfg.text, 2, 16, quantized=True)
    assert tcache.quantized and tcache.kv_scale.shape == (2, 2, 16, 4)
    with torch.no_grad():
        tlog, tcache = model.text(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg),
                                  cache=tcache, fresh_cache=True)
        tlogs = [tlog]
        for step in steps:
            jl, jcache = jdecoder.forward(jtext, cfg.text, jnp.asarray(step), cache=jcache)
            tl, tcache = model.text(torch.from_numpy(step), cache=tcache)
            jlogs.append(jl)
            tlogs.append(tl)
    valid = seg != 0
    np.testing.assert_allclose(tlogs[0].numpy()[valid], np.asarray(jlogs[0])[valid], **TOL)
    for tl, jl in zip(tlogs[1:], jlogs[1:]):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tcache.index.numpy(), np.asarray(jcache.index))
    np.testing.assert_array_equal(tcache.seg.numpy(), np.asarray(jcache.seg))
    written = np.asarray(jcache.seg) != 0
    assert tcache.kv.dtype == torch.int8
    np.testing.assert_allclose(tcache.kv_scale.numpy()[:, written],
                               np.asarray(jcache.kv_scale)[:, written], **TOL)
    # int8 codes agree except where fp32 noise moves a value across a
    # rounding boundary: at most one step
    diff = np.abs(tcache.kv.numpy()[:, written].astype(np.int32)
                  - np.asarray(jcache.kv)[:, written].astype(np.int32))
    assert diff.max() <= 1


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_jax_quantized_tree_loads_strict_and_gives_the_same_logits(mode):
    """A tree after the JAX quantize_tree loads into a quantized port model
    with strict=True: quantized leaves pass through untransposed, split along
    the layer axis only."""
    cfg = narrow_kernel_widths_cfg()
    params = jax.device_get(jvlm.init_params(cfg, jax.random.PRNGKey(2)))
    qparams = jax.device_get(dict(params, text=jquant.quantize_tree(params["text"], mode=mode)))
    model = tvlm.LeopardVLM(cfg, device="meta")
    tquant.quantize_tree(model.text, mode=mode)  # the structure only
    model.load_state_dict(state_dict_from_jax(qparams, cfg), strict=True, assign=True)
    leaf = model.text.layers[1].attn.wq
    assert isinstance(leaf, QuantizedWeight)
    key = "q4" if mode == "int4" else "q"
    jleaf = qparams["text"]["layers"]["attn"]["wq"][key][1]
    np.testing.assert_array_equal(getattr(leaf, key).numpy(), np.asarray(jleaf))
    tokens, seg = _tokens(cfg, [12, 7], seed=3)
    last = seg.sum(1) - 1
    want, _ = jvlm.forward(qparams, cfg, jnp.asarray(tokens), segment_ids=jnp.asarray(seg),
                           logits_indices=jnp.asarray(last))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg),
                       logits_indices=torch.from_numpy(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _kernel_rule_on_cpu(x, q4, s):
    """quant.use_int4_kernel without its CUDA condition."""
    m = x.numel() // x.shape[-1]
    return m <= 64 and x.dim() <= 3 and q4.dim() == 2 and 2 * q4.shape[0] // s.shape[0] == 128


def _clone(cache: KVCache) -> KVCache:
    return dataclasses.replace(cache, kv=cache.kv.clone(), seg=cache.seg.clone(),
                               index=cache.index.clone())


def test_kernel_tier_through_its_plain_version(monkeypatch):
    """With the tier predicate's CUDA condition dropped, CPU decode steps
    take int4_matmul (its plain version here): 7 per layer plus lm_head per
    step, and the prefill's lm_head at M = B. The step's logits match the
    dense-dequant tier within bf16 rounding: the kernel tier rounds x and
    the weight to bf16, the dense tier stays fp32."""
    cfg = narrow_kernel_widths_cfg()
    _, model = _pair(cfg, seed=4)
    tquant.quantize_tree(model.text, mode="int4")
    assert all(w.int4 and w.s.shape[0] * 128 == w.q4.shape[0] * 2
               for w in model.text.modules() if isinstance(w, QuantizedWeight))
    tokens, seg = _tokens(cfg, [40, 23], seed=5)  # M = 80 > 64 at prefill
    step = torch.tensor([[5], [9]], dtype=torch.int32)
    calls = []
    real = tquant.int4_matmul

    def spy(x, q4, s, **kw):
        calls.append((x.numel() // x.shape[-1], x.shape[-1]))  # (M, K)
        return real(x, q4, s, **kw)

    monkeypatch.setattr(tquant, "int4_matmul", spy)
    with torch.no_grad():
        cache = KVCache.create(cfg.text, 2, 48)
        model.text(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg), cache=cache,
                   fresh_cache=True)
        dense_log, _ = model.text(step, cache=_clone(cache))
        assert calls == []  # the CPU rule: no kernel tier
        monkeypatch.setattr(tquant, "use_int4_kernel", _kernel_rule_on_cpu)
        cache2 = KVCache.create(cfg.text, 2, 48)
        last = torch.from_numpy(seg.sum(1) - 1)
        model.text(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg), cache=cache2,
                   fresh_cache=True, logits_indices=last)
        assert calls == [(2, cfg.text.hidden_size)]  # the prefill's lm_head, M = B
        calls.clear()
        kernel_log, _ = model.text(step, cache=cache2)
    assert len(calls) == 7 * cfg.text.num_layers + 1
    assert all(m == 2 for m, _ in calls)
    # the kernel tier rounds x and every weight to bf16 (2^-9 relative each)
    # through two layers and the head; the largest difference measured here
    # is 0.021 on logits of std 1.0
    np.testing.assert_allclose(kernel_log.numpy(), dense_log.numpy(), rtol=5e-2, atol=5e-2)
    assert (kernel_log.argmax(-1) == dense_log.argmax(-1)).all()
