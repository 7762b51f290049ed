"""Shared prefixes and multi-turn chat in the port's `Engine`
(build_prefix, generate(prefix=..., return_prefix=True)), against the JAX
engine and against the port's own path on the concatenated prompts.

Mirrors tests/test_prefix.py, except its Idefics2 and continuous-batching
cases (neither is in the port yet): text, images in the prefix, the int8
KV cache, a prefix bucket larger than the cache, the 3-turn conversation
(here also with the turns' suffixes through the chunked continuation
tier), and the rejection of speculative decode and repetition penalty. The
weights are the JAX init moved by `state_dict_from_jax`; both engines run
float32 on the CPU with `tiny_vlm(vocab_size=128256)`, so that the
image-token id is one the prompts can hold. Greedy tokens must be
identical to the JAX engine's and to the concatenated path's; logprobs
agree with the JAX engine's at 1e-4, or at 2e-3 with the int8 KV cache,
where the two packages' float32 keys and values differ in their last bits
and a few round to the neighbouring int8 step (the same bound holds without
a prefix, on the concatenated prompts). A prefix must come out of every
generate unchanged, and after `return_prefix` the cache holds exactly the
conversation: index == length == len(tokens).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.config import GenerateConfig
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.inference.speculative import SpecConfig
from leopard_tpu_torch.models import decoder as tdecoder
from leopard_tpu_torch.models import vlm as tvlm

torch.set_num_threads(2)
CFG = cfgs.tiny_vlm(vocab_size=128256)
GEN = GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(0,))


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jvlm.init_params(CFG, jax.random.PRNGKey(0)))


def _engines(params, cfg=CFG, **kw):
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return JaxEngine(cfg, params, **kw), Engine(cfg, model, **kw)


def _suffixes(rng, n=3):
    return [rng.randint(1, 100, int(rng.randint(3, 9))).astype(np.int32) for _ in range(n)]


def _snapshot(prefix):
    c = prefix.cache
    return [t.clone() for t in (c.kv, c.seg, c.index, c.kv_scale) if t is not None]


def _assert_unchanged(prefix, snap):
    c = prefix.cache
    now = [t for t in (c.kv, c.seg, c.index, c.kv_scale) if t is not None]
    assert all(torch.equal(a, b) for a, b in zip(now, snap)), "the prefix was written"


def _assert_tokens(got, want, want_lp=None, lp_tol=1e-4):
    for i, (g, w) in enumerate(zip(got.tokens, want.tokens)):
        np.testing.assert_array_equal(g, w, err_msg=f"row {i}")
    if want_lp is not None:
        for g, w in zip(got.logprobs, want_lp.logprobs):
            np.testing.assert_allclose(g, w, rtol=lp_tol, atol=lp_tol)


def _check_prefix_path(jeng, teng, pre, sfx, images=None, gen=GEN, lp_tol=1e-4):
    """Port with the prefix == JAX with the prefix == port on the
    concatenated prompts; the prefix is unchanged by two generates."""
    jpre = jeng.build_prefix(pre, images=images)
    tpre = teng.build_prefix(pre, images=images)
    assert tpre.length == len(pre) and tpre.cache.index.tolist() == [len(pre)]
    snap = _snapshot(tpre)
    want = jeng.generate(sfx, gen_cfg=gen, prefix=jpre)
    got = teng.generate(sfx, gen_cfg=gen, prefix=tpre)
    _assert_tokens(got, want, want, lp_tol)
    full_images = None if images is None else np.concatenate([images] * len(sfx))
    full = teng.generate([np.concatenate([pre, s]) for s in sfx], images=full_images,
                         gen_cfg=gen)
    _assert_tokens(got, full)
    again = teng.generate(sfx, gen_cfg=gen, prefix=tpre)
    _assert_tokens(again, got)
    _assert_unchanged(tpre, snap)
    return tpre


def test_prefix_matches_full_prompt_text(params):
    jeng, teng = _engines(params, seq_buckets=(16, 32, 64), tile_buckets=(1,))
    rng = np.random.RandomState(0)
    pre = rng.randint(1, 100, 21).astype(np.int32)
    tpre = _check_prefix_path(jeng, teng, pre, _suffixes(rng))
    # the prefix object is reusable: a second batch must also match
    sfx2 = _suffixes(rng, n=2)
    full2 = teng.generate([np.concatenate([pre, s]) for s in sfx2], gen_cfg=GEN)
    _assert_tokens(teng.generate(sfx2, gen_cfg=GEN, prefix=tpre), full2)


def test_prefix_with_images_matches_full_prompt(params):
    jeng, teng = _engines(params, seq_buckets=(16, 32, 64), tile_buckets=(1,))
    rng = np.random.RandomState(1)
    pre = rng.randint(1, 100, 12).astype(np.int32)
    pre[2:2 + CFG.anyres.tokens_per_tile] = CFG.image_token_id  # one tile
    images = rng.randn(1, 3, 56, 56).astype(np.float32)
    _check_prefix_path(jeng, teng, pre, _suffixes(rng, n=2), images=images)


def test_prefix_int8_kv_matches_full_prompt(params):
    # the prefix rows' int8 payload and its scales are both seeded
    jeng, teng = _engines(params, seq_buckets=(16, 32, 64), tile_buckets=(1,),
                          quantize_kv=True)
    rng = np.random.RandomState(2)
    pre = rng.randint(1, 100, 30).astype(np.int32)
    tpre = _check_prefix_path(jeng, teng, pre, _suffixes(rng), lp_tol=2e-3)
    assert tpre.cache.quantized
    # a prefix of one KV format cannot seed the other's cache
    _, plain = _engines(params, seq_buckets=(16, 32, 64), tile_buckets=(1,))
    with pytest.raises(ValueError, match="quantize_kv"):
        plain.generate(_suffixes(rng, n=1), gen_cfg=GEN, prefix=tpre)


def test_prefix_bucket_larger_than_cache(params):
    # the prefix is bucketed to 64 slots; only the slots the target cache
    # needs are copied (sp_keep)
    jeng, teng = _engines(params, seq_buckets=(8, 16, 64), tile_buckets=(1,))
    rng = np.random.RandomState(3)
    pre = rng.randint(1, 100, 17).astype(np.int32)
    gen = GenerateConfig(max_new_tokens=3, greedy=True, eos_token_ids=(0,))
    tpre = _check_prefix_path(jeng, teng, pre, [rng.randint(1, 100, 4).astype(np.int32)],
                              gen=gen)
    assert tpre.cache.kv.shape[2] == 512  # round_up(64, 512)
    small = teng.generate([np.arange(1, 5, dtype=np.int32)], gen_cfg=gen, prefix=tpre,
                          max_cache=32)
    full = teng.generate([np.concatenate([pre, np.arange(1, 5, dtype=np.int32)])],
                         gen_cfg=gen)
    _assert_tokens(small, full)


def _assert_conversation_cache(prefix):
    """Repair check: the cache that return_prefix hands back holds every
    token of the conversation, the last emitted one included."""
    c = prefix.cache
    assert c.index.tolist() == [prefix.length] and prefix.length == len(prefix.tokens)
    assert int((c.seg != 0).sum()) == prefix.length


@pytest.mark.parametrize("tier", ["dense", "chunked_cont"])
def test_multiturn_conversation_matches_concatenated(params, tier, monkeypatch):
    """A 3-turn chat through return_prefix: each turn's tokens identical to
    the JAX engine's turn and to the port's generate on the whole
    concatenated conversation. With "chunked_cont" the turns' suffixes
    (16-token bucket) take the chunked continuation tier."""
    cfg = CFG
    if tier == "chunked_cont":
        cfg = dataclasses.replace(CFG, text=dataclasses.replace(
            CFG.text, long_seq_threshold=16, attn_chunk_size=128))
    jeng, teng = _engines(params, cfg, seq_buckets=(16, 32, 64, 128), tile_buckets=(1,))
    calls = []
    real = tdecoder.chunked_continuation_attention
    monkeypatch.setattr(tdecoder, "chunked_continuation_attention",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or real(*a, **kw))
    rng = np.random.RandomState(7)
    gen = GenerateConfig(max_new_tokens=5, greedy=True, eos_token_ids=(0,))
    jpre = tpre = None
    for n in (9, 7, 11):
        turn = rng.randint(1, 100, n).astype(np.int32)
        want = jeng.generate([turn], gen_cfg=gen, prefix=jpre, return_prefix=True)
        snap = None if tpre is None else _snapshot(tpre)
        got = teng.generate([turn], gen_cfg=gen, prefix=tpre, return_prefix=True)
        _assert_tokens(got, want, want)
        if tpre is not None:
            _assert_unchanged(tpre, snap)
            full = teng.generate([np.concatenate([tpre.tokens, turn])], gen_cfg=gen)
            _assert_tokens(got, full)
        np.testing.assert_array_equal(got.prefix.tokens, want.prefix.tokens)
        assert got.prefix.length == want.prefix.length
        _assert_conversation_cache(got.prefix)
        jpre, tpre = want.prefix, got.prefix
    n_layers = cfg.text.num_layers
    assert calls == ([16] * 2 * n_layers if tier == "chunked_cont" else [])


@pytest.mark.parametrize("stop", ["budget", "eos"])
def test_return_prefix_keeps_the_last_tokens_kv(params, stop):
    """The decode loop runs the forward of its last emitted token when the
    cache outlives the call, at the budget's end and at an eos alike."""
    _, teng = _engines(params, seq_buckets=(16, 32), tile_buckets=(1,))
    turn = np.random.RandomState(8).randint(1, 100, 10).astype(np.int32)
    gen = GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(0,))
    emitted = gen.max_new_tokens
    if stop == "eos":
        plain = list(teng.generate([turn], gen_cfg=gen).tokens[0])
        emitted = plain.index(plain[2]) + 1  # the eos is a turn-end position
        gen = dataclasses.replace(gen, eos_token_ids=(int(plain[2]),))
    res = teng.generate([turn], gen_cfg=gen, return_prefix=True)
    assert len(res.tokens[0]) == emitted - (stop == "eos")
    assert res.prefix.length == len(turn) + emitted
    _assert_conversation_cache(res.prefix)


def test_prefix_rejects_spec_and_penalty(params):
    _, teng = _engines(params, seq_buckets=(16,), tile_buckets=(1,))
    pre = np.arange(1, 9, dtype=np.int32)
    prefix = teng.build_prefix(pre)
    with pytest.raises(ValueError, match="speculative"):
        teng.generate([pre], gen_cfg=GEN, prefix=prefix, spec=SpecConfig(ngram=2, draft=4))
    with pytest.raises(ValueError, match="repetition_penalty"):
        teng.generate([pre], prefix=prefix, gen_cfg=GenerateConfig(
            max_new_tokens=2, greedy=True, repetition_penalty=1.2, eos_token_ids=(0,)))
    with pytest.raises(ValueError, match="single-row"):
        teng.generate([pre, pre], gen_cfg=GEN, return_prefix=True)
