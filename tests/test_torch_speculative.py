"""Speculative decoding and beam search of the port against the JAX package
and against plain greedy decoding.

Mirrors tests/test_speculative.py: the n-gram proposer, greedy identity on
random and repetitive prompts, eos mid-batch with budget edges, images, the
int8 KV cache, the rejection of sampling, verify-block headroom at the
bucket boundary, and a too-tight `max_cache` refused. Each speculative
generate is held token for token against the JAX engine's speculative
generate (and its round count) and against the port's plain greedy
generate. Beam search (tests/test_beam.py): width 1 equals greedy, width 4
gives the JAX `beam_search`'s tokens. The weights are the JAX init moved by
`state_dict_from_jax`, float32 on the CPU, `tiny_vlm(vocab_size=128256)`.
Logprobs agree at 1e-5 with plain greedy and at 1e-4 with JAX (2e-3 with
the int8 KV cache, where a few keys and values round to the neighbouring
int8 step in one package and not in the other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.config import GenerateConfig
from leopard_tpu.inference import beam as jbeam
from leopard_tpu.inference import speculative as jspec
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.inference import beam as tbeam
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.inference.speculative import SpecConfig, _propose
from leopard_tpu_torch.models import vlm as tvlm

torch.set_num_threads(2)
CFG = cfgs.tiny_vlm(vocab_size=128256)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jvlm.init_params(CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(params):
    m = tvlm.LeopardVLM(CFG)
    m.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return m


def _engines(params, model, **kw):
    return JaxEngine(CFG, params, **kw), Engine(CFG, model, **kw)


def _assert_spec_matches(jeng, teng, prompts, gen, spec, images=None, lp_tol=1e-4):
    plain = teng.generate(prompts, images=images, gen_cfg=gen)
    got = teng.generate(prompts, images=images, gen_cfg=gen, spec=spec)
    want = jeng.generate(prompts, images=images, gen_cfg=gen,
                         spec=jspec.SpecConfig(ngram=spec.ngram, draft=spec.draft))
    assert got.spec_rounds == want.spec_rounds
    for i, (p, g, w) in enumerate(zip(plain.tokens, got.tokens, want.tokens)):
        np.testing.assert_array_equal(g, p, err_msg=f"row {i} vs plain greedy")
        np.testing.assert_array_equal(g, w, err_msg=f"row {i} vs JAX")
        np.testing.assert_allclose(got.logprobs[i], plain.logprobs[i], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.logprobs[i], want.logprobs[i], rtol=lp_tol, atol=lp_tol)
    return got


@pytest.mark.parametrize("case", ["recent", "none"])
def test_propose_matches_jax(case):
    hist = np.zeros((2, 32), np.int32)
    if case == "recent":
        # ... [7 8] 9 ... [7 8] 4 5 | the row ends with [7 8]: most recent is idx 6
        row, want = [1, 7, 8, 9, 2, 3, 7, 8, 4, 5, 6, 7, 8], [4, 5, 6]
    else:
        row, want = [1, 2, 3, 4, 5], [5, 5, 5]
    hist[0, : len(row)] = row
    hist[1, :3] = [9, 9, 9]  # too short for a strictly earlier match but one
    total = np.array([len(row), 3], np.int32)
    got = _propose(torch.from_numpy(hist), torch.from_numpy(total), ngram=2, k=3)
    ref = jspec._propose(jnp.asarray(hist), jnp.asarray(total), ngram=2, k=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_spec_matches_greedy_random_prompts(params, model):
    jeng, teng = _engines(params, model, seq_buckets=(16, 32), tile_buckets=(1,))
    gen = GenerateConfig(max_new_tokens=12, greedy=True, eos_token_ids=(0,))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 100, n).astype(np.int32) for n in (5, 9, 13)]
    _assert_spec_matches(jeng, teng, prompts, gen, SpecConfig(ngram=2, draft=4))


def test_spec_matches_greedy_repetitive_prompts(params, model):
    # repeated n-grams: the lookup finds drafts in every round
    jeng, teng = _engines(params, model, seq_buckets=(32,), tile_buckets=(1,))
    gen = GenerateConfig(max_new_tokens=16, greedy=True, eos_token_ids=(0,))
    base = np.array([3, 14, 15, 9, 2, 6], np.int32)
    prompts = [np.tile(base, 4), np.concatenate([base, base, [7, 7], base]).astype(np.int32)]
    _assert_spec_matches(jeng, teng, prompts, gen, SpecConfig(ngram=2, draft=4))


@pytest.mark.parametrize("max_new", [1, 2, 5, 16])
@pytest.mark.parametrize("eos", [(0,), tuple(range(0, 50))], ids=["eos0", "eos_wide"])
def test_spec_eos_mid_batch_and_budget_edge(params, model, eos, max_new):
    jeng, teng = _engines(params, model, seq_buckets=(16,), tile_buckets=(1,))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 100, n).astype(np.int32) for n in (4, 8)]
    gen = GenerateConfig(max_new_tokens=max_new, greedy=True, eos_token_ids=eos)
    _assert_spec_matches(jeng, teng, prompts, gen, SpecConfig(ngram=2, draft=4))


def test_spec_with_images_matches(params, model):
    jeng, teng = _engines(params, model, seq_buckets=(16, 32), tile_buckets=(1,))
    gen = GenerateConfig(max_new_tokens=10, greedy=True, eos_token_ids=(0,))
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 100, 12).astype(np.int32)
    prompt[2:2 + CFG.anyres.tokens_per_tile] = CFG.image_token_id
    images = rng.randn(1, 3, 56, 56).astype(np.float32)
    _assert_spec_matches(jeng, teng, [prompt], gen, SpecConfig(ngram=2, draft=3),
                         images=images)


def test_spec_int8_kv_matches(params, model):
    jeng, teng = _engines(params, model, seq_buckets=(16,), tile_buckets=(1,),
                          quantize_kv=True)
    gen = GenerateConfig(max_new_tokens=12, greedy=True, eos_token_ids=(0,))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 100, n).astype(np.int32) for n in (6, 11)]
    _assert_spec_matches(jeng, teng, prompts, gen, SpecConfig(ngram=2, draft=4), lp_tol=2e-3)


def test_spec_rejects_sampling(params, model):
    _, teng = _engines(params, model, seq_buckets=(16,), tile_buckets=(1,))
    gen = GenerateConfig(max_new_tokens=4, greedy=False, temperature=0.7)
    with pytest.raises(ValueError, match="greedy"):
        teng.generate([np.arange(1, 6, dtype=np.int32)], gen_cfg=gen, spec=SpecConfig())


def test_spec_cache_headroom_at_bucket_boundary(params, model):
    """prompt == bucket and bucket + max_new a multiple of 512: the last
    verify blocks need the draft's headroom past the 512 slots (eos -1
    never fires, so decode runs the whole budget)."""
    jeng, teng = _engines(params, model, seq_buckets=(16,), tile_buckets=(1,))
    gen = GenerateConfig(max_new_tokens=496, greedy=True, eos_token_ids=(-1,))
    prompts = [np.random.RandomState(11).randint(1, 100, 16).astype(np.int32)]
    _assert_spec_matches(jeng, teng, prompts, gen, SpecConfig(ngram=2, draft=7))


def test_spec_tight_max_cache_rejected(params, model):
    _, teng = _engines(params, model, seq_buckets=(16,), tile_buckets=(1,))
    gen = GenerateConfig(max_new_tokens=16, greedy=True, eos_token_ids=(0,))
    with pytest.raises(ValueError, match="headroom"):
        teng.generate([np.arange(1, 9, dtype=np.int32)], gen_cfg=gen,
                      spec=SpecConfig(draft=7), max_cache=32)


def test_beam_width_1_matches_greedy(params, model):
    _, teng = _engines(params, model, seq_buckets=(16, 32), tile_buckets=(1,))
    prompt = np.array([5, 1, 30, 99], np.int32)
    gen = GenerateConfig(max_new_tokens=4, greedy=True, eos_token_ids=(999999,))
    greedy = teng.generate([prompt], gen_cfg=gen).tokens[0]
    beam = tbeam.beam_search(teng, prompt, beam_width=1, max_new_tokens=4, eos_ids=(999999,))
    np.testing.assert_array_equal(beam, greedy)


@pytest.mark.parametrize("eos_ids,penalty", [((999999,), 0.0), ((0, 1, 2), 1.0)],
                         ids=["no_eos", "eos"])
def test_beam_search_matches_jax(params, model, eos_ids, penalty):
    jeng, teng = _engines(params, model, seq_buckets=(16, 32), tile_buckets=(1,))
    rng = np.random.RandomState(9)
    prompt = rng.randint(1, 100, 9).astype(np.int32)
    prompt[1:1 + CFG.anyres.tokens_per_tile] = CFG.image_token_id
    images = rng.randn(1, 3, 56, 56).astype(np.float32)
    kw = dict(beam_width=4, max_new_tokens=6, eos_ids=eos_ids, length_penalty=penalty)
    want = jbeam.beam_search(jeng, prompt, images=images, **kw)
    got = tbeam.beam_search(teng, prompt, images=images, **kw)
    np.testing.assert_array_equal(got, want)
    assert len(got) <= 6
