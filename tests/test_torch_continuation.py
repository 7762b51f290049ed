"""The decoder's chunked continuation tier and the engine's chunked prefill
of prompts above the largest bucket, against the JAX package.

Mirrors tests/test_attn_impl.py::test_continuation_prefill_chunked_matches_dense
and ::test_continuation_prefill_sliding_window (a prefill into a filled
cache through the continuation tier, forced by a low long_seq_threshold,
held against the dense sweep, for a float32 and an int8 cache), and
tests/test_vlm.py::test_engine_chunked_prefill_matches_single_shot. The
same weights (the JAX init moved by `state_dict_from_jax`) and numpy inputs
go through both packages, float32 on the CPU: logits agree at the JAX
tests' tolerances, greedy tokens are identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.config import GenerateConfig
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.models import decoder as jdecoder
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.models import decoder as tdecoder
from leopard_tpu_torch.models import vlm as tvlm

torch.set_num_threads(2)


# the decoder tests take the JAX tests' config; the engine test takes the
# full vocab, so that the image-token id is one the prompts can hold
BASE = cfgs.tiny_vlm()
VLM = cfgs.tiny_vlm(vocab_size=128256)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jvlm.init_params(BASE, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def vlm_params():
    return jax.device_get(jvlm.init_params(VLM, jax.random.PRNGKey(0)))


def _with(base=BASE, **text_kw):
    """`base` with some text-config fields replaced."""
    return dataclasses.replace(base, text=dataclasses.replace(base.text, **text_kw))


def _port(cfg, params):
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return model


def _two_prefills(params, cfg, ids1, seg1, ids2, seg2, quant):
    """A fresh prefill, then a continuation, through both decoders; returns
    (JAX logits, port logits, port cache) of the continuation."""
    tcfg = cfg.text
    cache = jdecoder.KVCache.create(tcfg, ids1.shape[0], 32, quantized=quant)
    _, cache = jdecoder.forward(params["text"], tcfg, jnp.asarray(ids1),
                                segment_ids=None if seg1 is None else jnp.asarray(seg1),
                                cache=cache, fresh_cache=True)
    want, _ = jdecoder.forward(params["text"], tcfg, jnp.asarray(ids2),
                               segment_ids=None if seg2 is None else jnp.asarray(seg2),
                               cache=cache)
    dec = _port(cfg, params).text
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.inference_mode():
        tcache = tdecoder.KVCache.create(tcfg, ids1.shape[0], 32, quantized=quant)
        _, tcache = dec(t(ids1), segment_ids=t(seg1), cache=tcache, fresh_cache=True)
        got, tcache = dec(t(ids2), segment_ids=t(seg2), cache=tcache)
    return np.asarray(want), got.numpy(), tcache


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_continuation_prefill_chunked_matches_dense(params, quant, monkeypatch):
    rng = np.random.RandomState(3)
    ids1 = rng.randint(1, 100, (2, 8)).astype(np.int32)
    seg1 = np.ones((2, 8), np.int32)
    seg1[1, 6:] = 0
    ids2 = rng.randint(1, 100, (2, 16)).astype(np.int32)
    seg2 = np.ones((2, 16), np.int32)
    seg2[1, 10:] = 0
    calls = []
    real = tdecoder.chunked_continuation_attention

    def spy(*args, **kw):
        calls.append(kw["chunk_size"])
        return real(*args, **kw)

    monkeypatch.setattr(tdecoder, "chunked_continuation_attention", spy)
    out = {}
    for name, thresh in [("dense", 10**9), ("cont", 1)]:
        cfg = _with(long_seq_threshold=thresh, attn_chunk_size=8)
        want, got, tcache = _two_prefills(params, cfg, ids1, seg1, ids2, seg2, quant)
        assert tcache.index.tolist() == [24, 16]
        valid = seg2 != 0
        tol = 2e-2 if quant else 2e-4
        np.testing.assert_allclose(got[valid], want[valid], rtol=tol, atol=tol)
        out[name] = got
    assert calls == [8] * BASE.text.num_layers  # the continuation only, chunk 8 of 32
    tol = 2e-2 if quant else 2e-4
    valid = seg2 != 0
    np.testing.assert_allclose(out["cont"][valid], out["dense"][valid], rtol=tol, atol=tol)


def test_continuation_prefill_sliding_window(params):
    ids1 = np.random.RandomState(4).randint(1, 100, (1, 8)).astype(np.int32)
    ids2 = np.random.RandomState(5).randint(1, 100, (1, 16)).astype(np.int32)
    out = {}
    for name, thresh in [("dense", 10**9), ("cont", 1)]:
        cfg = _with(long_seq_threshold=thresh, attn_chunk_size=8, sliding_window=6)
        want, got, _ = _two_prefills(params, cfg, ids1, None, ids2, None, False)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        out[name] = got
    np.testing.assert_allclose(out["cont"], out["dense"], rtol=2e-4, atol=2e-4)


def test_engine_chunked_prefill_matches_single_shot(vlm_params, monkeypatch):
    """Prompts above the largest bucket prefill in chunks (first fresh,
    later ones through the continuation tier), with a tile straddling the
    chunk boundary: tokens identical to the JAX chunked engine and to the
    port's single-shot engine."""
    params = vlm_params
    cfg = _with(VLM, long_seq_threshold=8, attn_chunk_size=8)
    model = _port(cfg, params)
    img = cfg.image_token_id
    rng = np.random.RandomState(7)
    t = cfg.anyres.tokens_per_tile
    # row 0: 2 tiles, the second across the 16-token chunk boundary; row 1:
    # 1 tile and a shorter prompt (its last token in the second chunk)
    p0 = list(rng.randint(1, 100, 10)) + [img] * (2 * t) + list(rng.randint(1, 100, 22))
    p1 = list(rng.randint(1, 100, 3)) + [img] * t + list(rng.randint(1, 100, 13))
    prompts = [np.asarray(p0, np.int32), np.asarray(p1, np.int32)]
    images = rng.randn(3, 3, 56, 56).astype(np.float32)
    calls = []
    real = tdecoder.chunked_continuation_attention

    def spy(*args, **kw):
        calls.append(args[0].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(tdecoder, "chunked_continuation_attention", spy)
    gen = GenerateConfig(max_new_tokens=4, greedy=True, eos_token_ids=(999999,))
    want = JaxEngine(cfg, params, seq_buckets=(16,), tile_buckets=(4,)).generate(
        prompts, images=images, gen_cfg=gen)
    chunked = Engine(cfg, model, seq_buckets=(16,), tile_buckets=(4,))
    got = chunked.generate(prompts, images=images, gen_cfg=gen)
    # 48 tokens: chunks 2 and 3 are continuations of 16 tokens
    assert calls == [16] * (2 * cfg.text.num_layers)
    single = Engine(cfg, model, seq_buckets=(64,), tile_buckets=(4,)).generate(
        prompts, images=images, gen_cfg=gen)
    for w, g, o, wl, gl in zip(want.tokens, got.tokens, single.tokens, want.logprobs,
                               got.logprobs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(o, w)
        np.testing.assert_allclose(gl, wl, rtol=1e-4, atol=1e-4)
    # the chunk logits of the row that ended in an earlier chunk are kept
    first_c, _ = chunked.prefill(prompts, images=images)
    first_s, _ = Engine(cfg, model, seq_buckets=(64,), tile_buckets=(4,)).prefill(
        prompts, images=images)
    torch.testing.assert_close(first_c, first_s, rtol=2e-4, atol=2e-4)
