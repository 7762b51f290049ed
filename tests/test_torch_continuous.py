"""Continuous batching in the port (`inference/continuous.py`) against the
port's serial `Engine.generate` and against the JAX package's
`ContinuousEngine`, greedy tokens identical.

Mirrors tests/test_continuous.py (ten of its eleven cases, same names with
`torch` in them; the port keeps no `ttft`), then adds: a shared prefix, a request refused by the
admission guard that the JAX engine admits (its prefill bucket would run
past the cache), rows filled to the cache's last slot, and seeded sampling.
The weights are the JAX init moved by `state_dict_from_jax`; both packages
run float32 on the CPU with `tiny_vlm(vocab_size=128256)`.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.config import GenerateConfig as JaxGenerateConfig
from leopard_tpu.inference import continuous as jcont
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch.config import GenerateConfig
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.inference.continuous import ContinuousEngine, Request
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.models import vlm as tvlm

torch.set_num_threads(2)
CFG = cfgs.tiny_vlm(vocab_size=128256)
GEN = GenerateConfig(greedy=True, eos_token_ids=(0,))


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jvlm.init_params(CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(params):
    m = tvlm.LeopardVLM(CFG)
    m.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return m


def _requests(n=7, seed=0, with_images=False):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        prompt = rng.randint(1, 100, int(rng.randint(3, 14))).astype(np.int32)
        images = None
        if with_images and i % 2 == 0:
            prompt[1:5] = CFG.image_token_id  # one 4-token tile
            images = rng.randn(1, 3, 56, 56).astype(np.float32)
        reqs.append(Request(prompt=prompt, max_new_tokens=int(rng.randint(2, 9)),
                            images=images))
    return reqs


def _serial_oracle(engine, reqs, gen, prefix=None):
    out = []
    for r in reqs:
        g = GenerateConfig(max_new_tokens=r.max_new_tokens, greedy=True,
                           eos_token_ids=gen.eos_token_ids)
        out.append(engine.generate([r.prompt], images=r.images, gen_cfg=g,
                                   prefix=prefix).tokens[0])
    return out


def _jax_run(params, reqs, gen, engine_kw, cont_kw, prefix_ids=None, **run_kw):
    jeng = JaxEngine(CFG, params, **engine_kw)
    jreqs = [jcont.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens, images=r.images)
             for r in reqs]
    prefix = None if prefix_ids is None else jeng.build_prefix(prefix_ids)
    return jcont.ContinuousEngine(jeng, **cont_kw).run(
        jreqs, gen_cfg=JaxGenerateConfig(**dataclasses.asdict(gen)), prefix=prefix, **run_kw)


def _check(model, params, reqs, engine_kw, cont_kw, gen=GEN, jax_too=True, prefix_ids=None,
           **run_kw):
    """The port's continuous run == its serial generate (== the JAX
    continuous run); returns the port's ContinuousEngine and completions."""
    eng = Engine(CFG, model, **engine_kw)
    prefix = None if prefix_ids is None else eng.build_prefix(prefix_ids)
    cont = ContinuousEngine(eng, **cont_kw)
    got = cont.run(reqs, gen_cfg=gen, prefix=prefix, **run_kw)
    want = _serial_oracle(eng, reqs, gen, prefix)
    assert len(got) == len(reqs)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.tokens, w, err_msg=f"request {i} vs serial")
        assert g.prompt_length == len(reqs[i].prompt)
    if jax_too:
        jax_got = _jax_run(params, reqs, gen, engine_kw, cont_kw, prefix_ids, **run_kw)
        for i, (g, j) in enumerate(zip(got, jax_got)):
            np.testing.assert_array_equal(g.tokens, j.tokens, err_msg=f"request {i} vs JAX")
    return cont, got


def test_torch_continuous_matches_serial_greedy(model, params):
    _check(model, params, _requests(n=7), dict(seq_buckets=(16, 32), tile_buckets=(1,)),
           dict(slots=3, cache_len=512, max_new_cap=16, segment_steps=2))


def test_torch_continuous_with_images_matches_serial(model, params):
    _check(model, params, _requests(n=5, seed=3, with_images=True),
           dict(seq_buckets=(16, 32), tile_buckets=(1,)),
           dict(slots=2, cache_len=512, max_new_cap=16, segment_steps=3))


def test_torch_image_head_does_not_block_text_staging(model, params):
    # an image-first queue must still batch-stage the text behind it
    rng = np.random.RandomState(11)
    reqs = []
    for i in range(6):
        prompt = rng.randint(1, 100, 10).astype(np.int32)
        images = None
        if i == 0:
            prompt[1:5] = CFG.image_token_id
            images = rng.randn(1, 3, 56, 56).astype(np.float32)
        reqs.append(Request(prompt=prompt, max_new_tokens=4, images=images))
    cont, _ = _check(model, params, reqs, dict(seq_buckets=(16, 32), tile_buckets=(1,)),
                     dict(slots=6, cache_len=512, max_new_cap=16, segment_steps=2))
    # the 5 text rows went out in one block prefill at the first boundary
    assert cont.stats["blocks"] == 1 and cont.stats["block_rows"] == 5
    # the image request alone, then the block padded to 8 rows, both at bucket 16
    assert cont.stats["staged_shapes"] == [(1, 16), (8, 16)]


def test_torch_continuous_int8_kv_matches_serial(model, params):
    _check(model, params, _requests(n=4, seed=5),
           dict(seq_buckets=(16, 32), tile_buckets=(1,), quantize_kv=True),
           dict(slots=2, cache_len=512, max_new_cap=16, segment_steps=2))


def test_torch_continuous_fewer_requests_than_slots(model, params):
    _check(model, params, _requests(n=2, seed=7), dict(seq_buckets=(16,), tile_buckets=(1,)),
           dict(slots=4, cache_len=512, max_new_cap=16, segment_steps=2))


def test_torch_continuous_rejects_repetition_penalty(model):
    eng = Engine(CFG, model, seq_buckets=(16,), tile_buckets=(1,))
    cont = ContinuousEngine(eng, slots=2, cache_len=512)
    with pytest.raises(ValueError, match="repetition_penalty"):
        cont.run(_requests(n=1), gen_cfg=GenerateConfig(greedy=True, repetition_penalty=1.2))


def test_torch_continuous_zero_budget_emits_nothing(model, params):
    reqs = [Request(prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=0),
            Request(prompt=np.arange(2, 9, dtype=np.int32), max_new_tokens=4)]
    _, got = _check(model, params, reqs, dict(seq_buckets=(16,), tile_buckets=(1,)),
                    dict(slots=2, cache_len=512, max_new_cap=16, segment_steps=2))
    assert got[0].tokens.size == 0 and got[1].tokens.size == 4


def test_torch_continuous_warns_on_budget_above_cap(model):
    eng = Engine(CFG, model, seq_buckets=(16,), tile_buckets=(1,))
    reqs = [Request(prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=99)]
    cont = ContinuousEngine(eng, slots=1, cache_len=512, max_new_cap=8, segment_steps=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = cont.run(reqs, gen_cfg=GEN)
    assert any("truncated" in str(x.message) for x in w)
    capped = dataclasses.replace(reqs[0], max_new_tokens=8)
    np.testing.assert_array_equal(got[0].tokens, _serial_oracle(eng, [capped], GEN)[0])


def test_torch_continuous_longest_first_matches_serial(model, params):
    # admission order changes, completions stay in request order
    _check(model, params, _requests(n=7, seed=3), dict(seq_buckets=(16, 32), tile_buckets=(1,)),
           dict(slots=3, cache_len=512, max_new_cap=16, segment_steps=2), longest_first=True)


def test_torch_continuous_eos_finish_matches_serial(model, params):
    # a band of ids as eos makes rows stop early: the late refill path
    gen = GenerateConfig(greedy=True, eos_token_ids=tuple(range(0, 128000, 7)))
    reqs = _requests(n=9, seed=5)
    cont, got = _check(model, params, reqs, dict(seq_buckets=(16, 32), tile_buckets=(1,)),
                       dict(slots=3, cache_len=512, max_new_cap=16, segment_steps=4), gen=gen)
    assert sum(len(g.tokens) < r.max_new_tokens for g, r in zip(got, reqs)) > 0
    assert cont.stats["late_refills"] > 0 and cont.stats["det_refills"] > 0


def test_torch_continuous_prefix_matches_serial(model, params):
    prefix = np.random.RandomState(21).randint(1, 100, 37).astype(np.int32)
    _check(model, params, _requests(n=6, seed=13, with_images=True),
           dict(seq_buckets=(16, 32), tile_buckets=(1,)),
           dict(slots=3, cache_len=512, max_new_cap=16, segment_steps=3), prefix_ids=prefix)


def test_torch_continuous_refuses_a_bucket_past_the_cache(model):
    """The JAX guard admits this request (460 + 5 + 4 <= 512) and its prefill
    bucket of 64 slots from slot 460 runs past the cache; the port refuses
    it before anything is written, then serves the next run."""
    eng = Engine(CFG, model, seq_buckets=(64,), tile_buckets=(1,))
    prefix = eng.build_prefix(np.random.RandomState(4).randint(1, 100, 460).astype(np.int32))
    snap = [t.clone() for t in (prefix.cache.kv, prefix.cache.seg, prefix.cache.index)]
    cont = ContinuousEngine(eng, slots=2, cache_len=512, max_new_cap=8, segment_steps=2)
    bad = [Request(prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=4)]
    with pytest.raises(ValueError, match="bucket 64"):
        cont.run(bad, gen_cfg=GEN, prefix=prefix)
    assert cont.stats == {}
    for a, b in zip((prefix.cache.kv, prefix.cache.seg, prefix.cache.index), snap):
        assert torch.equal(a, b)
    reqs = _requests(n=3, seed=2)
    got = cont.run(reqs, gen_cfg=GEN)
    for g, w in zip(got, _serial_oracle(eng, reqs, GEN)):
        np.testing.assert_array_equal(g.tokens, w)


def test_torch_continuous_fills_a_row_to_the_last_slot(model, params):
    """prompt + budget == cache_len, served equal to serial; a 512-token
    prompt with budget 0 sits at index == cache_len and runs the segments'
    segment-0 writes from its last slot, not past the cache."""
    rng = np.random.RandomState(17)
    reqs = [Request(prompt=rng.randint(1, 100, 500).astype(np.int32), max_new_tokens=12),
            Request(prompt=rng.randint(1, 100, 512).astype(np.int32), max_new_tokens=0),
            Request(prompt=rng.randint(1, 100, 9).astype(np.int32), max_new_tokens=6)]
    cont, got = _check(model, params, reqs, dict(seq_buckets=(16, 512), tile_buckets=(1,)),
                       dict(slots=2, cache_len=512, max_new_cap=16, segment_steps=4),
                       jax_too=False)
    assert [len(g.tokens) for g in got] == [12, 0, 6]
    assert cont.cache_len == 512


def test_torch_continuous_seeded_sampling_repeats(model):
    eng = Engine(CFG, model, seq_buckets=(16, 32), tile_buckets=(1,))
    cont = ContinuousEngine(eng, slots=3, cache_len=512, max_new_cap=16, segment_steps=2)
    reqs = _requests(n=5, seed=6)
    gen = GenerateConfig(greedy=False, temperature=0.8, top_k=50, eos_token_ids=(0,), seed=3)
    runs = [[c.tokens.tolist() for c in cont.run(reqs, gen_cfg=g)]
            for g in (gen, gen, dataclasses.replace(gen, seed=4))]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert [len(t) for t in runs[0]] == [r.max_new_tokens for r in reqs]


def test_torch_eos_outside_the_vocab(model, params):
    """eos ids whose first entry lies outside the vocab (the server tests'
    999999): a row that ends before the others feeds its later forwards an
    id inside the vocab, in the serial decode and in the slot pool alike."""
    reqs = _requests(n=3, seed=8)
    eng = Engine(CFG, model, seq_buckets=(16, 32), tile_buckets=(1,))
    early = eng.generate([reqs[0].prompt], gen_cfg=GenerateConfig(max_new_tokens=2)).tokens[0]
    gen = GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(999999, int(early[1])))
    got = eng.generate([r.prompt for r in reqs], gen_cfg=gen)
    want = JaxEngine(CFG, params, seq_buckets=(16, 32), tile_buckets=(1,)).generate(
        [r.prompt for r in reqs], gen_cfg=JaxGenerateConfig(**dataclasses.asdict(gen)))
    assert len(got.tokens[0]) == 1
    for g, w in zip(got.tokens, want.tokens):
        np.testing.assert_array_equal(g, w)
    _check(model, params, reqs, dict(seq_buckets=(16, 32), tile_buckets=(1,)),
           dict(slots=2, cache_len=512, max_new_cap=16, segment_steps=2), gen=gen)
