"""Greedy `Engine.generate` of the port against the JAX engine, token for
token, plus sampling filters against the JAX sampler.

The model is `tiny_vlm(vocab_size=128256)`: with a small vocab the image
token ids fall out of range and a parity check passes vacuously
(tests/test_eval_e2e.py:38-46). Weights are the JAX init, moved by
`state_dict_from_jax`; both engines run float32 on the CPU. Tokens must be
identical; logprobs agree at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.config import GenerateConfig
from leopard_tpu.inference import sampling as jsampling
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.inference import sampling as tsampling
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.inference.speculative import SpecConfig
from leopard_tpu_torch.models import decoder as tdecoder
from leopard_tpu_torch.models import vlm as tvlm

torch.set_num_threads(2)
SEQ_BUCKETS = (32, 64)
TILE_BUCKETS = (1, 2, 4)


def _engines(cfg):
    params = jvlm.init_params(cfg, jax.random.PRNGKey(1))
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), cfg), strict=True)
    kw = dict(seq_buckets=SEQ_BUCKETS, tile_buckets=TILE_BUCKETS)
    return JaxEngine(cfg, params, **kw), Engine(cfg, model, **kw)


@pytest.fixture(scope="module")
def engines():
    return _engines(cfgs.tiny_vlm(vocab_size=128256))


def _requests(cfg, seed=0):
    """Two rows with images (2 tiles and 1 tile) and one text-only row."""
    rng = np.random.RandomState(seed)
    t = cfg.anyres.tokens_per_tile
    img = cfg.image_token_id

    def text(n):
        return list(rng.randint(1, 128000, size=n))

    prompts = [
        np.array(text(3) + [img] * (2 * t) + text(9), np.int32),
        np.array(text(5) + [img] * t + text(2), np.int32),
        np.array(text(14), np.int32),
    ]
    s = cfg.vision.image_size
    images = rng.randint(0, 256, (3, s, s, 3)).astype(np.uint8)
    return prompts, images


def _assert_same(jres, tres):
    assert len(jres.tokens) == len(tres.tokens)
    for jt, tt, jl, tl in zip(jres.tokens, tres.tokens, jres.logprobs, tres.logprobs):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def test_greedy_generate_matches_jax_with_eos_mid_batch(engines):
    jeng, teng = engines
    prompts, images = _requests(jeng.cfg)
    gen = GenerateConfig(max_new_tokens=10, eos_token_ids=(128001,))
    first = jeng.generate(prompts, images=images, gen_cfg=gen)
    _assert_same(first, teng.generate(prompts, images=images, gen_cfg=gen))
    # make row 1's fourth token the eos: row 1 stops mid-batch, the others
    # stop there too or run on
    eos = int(first.tokens[1][3])
    gen_eos = dataclasses.replace(gen, eos_token_ids=(eos,))
    jres = jeng.generate(prompts, images=images, gen_cfg=gen_eos)
    tres = teng.generate(prompts, images=images, gen_cfg=gen_eos)
    _assert_same(jres, tres)
    assert len(tres.tokens[1]) <= 3
    assert max(len(t) for t in tres.tokens) > len(tres.tokens[1])


def test_long_prompt_takes_the_flash_tier(monkeypatch):
    """With long_seq_threshold below the bucket, the port's fresh prefill
    goes through flash_attention (its plain version on the CPU) while the
    JAX engine takes its CPU chunked tier; tokens stay identical."""
    base = cfgs.tiny_vlm(vocab_size=128256)
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, long_seq_threshold=32))
    jeng, teng = _engines(cfg)
    calls = []
    real = tdecoder.flash_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tdecoder, "flash_attention", spy)
    prompts, images = _requests(cfg, seed=1)
    prompts[2] = np.concatenate([prompts[2], prompts[2], prompts[2]])  # 42 tokens → bucket 64
    gen = GenerateConfig(max_new_tokens=6, eos_token_ids=(128001,))
    _assert_same(jeng.generate(prompts, images=images, gen_cfg=gen),
                 teng.generate(prompts, images=images, gen_cfg=gen))
    assert len(calls) == cfg.text.num_layers  # prefill only; decode steps are dense
    assert calls[0][1] == 64


def test_sampled_generate_is_seeded(engines):
    _, teng = engines
    prompts, images = _requests(teng.cfg, seed=2)
    gen = GenerateConfig(max_new_tokens=6, greedy=False, temperature=0.8, top_k=50,
                         top_p=0.9, repetition_penalty=1.2, eos_token_ids=(128001,), seed=7)
    a = teng.generate(prompts, images=images, gen_cfg=gen)
    b = teng.generate(prompts, images=images, gen_cfg=gen)
    for x, y in zip(a.tokens, b.tokens):
        np.testing.assert_array_equal(x, y)
        assert np.all((x >= 0) & (x < teng.cfg.text.vocab_size))


def test_engine_rejects_an_unknown_quantize_mode(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="unknown quantize mode fp8"):
        Engine(teng.cfg, teng.model, quantize="fp8")


@pytest.mark.parametrize("kw", ["spec", "prefix", "return_prefix"])
def test_generate_rejects_what_the_port_lacks(engines, kw):
    """Speculative decode, prefixes and return_prefix are ported; what the
    JAX engine refuses of them (engine.py:290-308), the port refuses too:
    speculative decode with sampling, a prefix with a repetition penalty,
    return_prefix over more than one row."""
    _, teng = engines
    prompts, _ = _requests(teng.cfg)
    args = {
        "spec": dict(spec=SpecConfig(), gen_cfg=GenerateConfig(greedy=False, temperature=0.7)),
        "prefix": dict(prefix=teng.build_prefix(prompts[2]),
                       gen_cfg=GenerateConfig(repetition_penalty=1.2)),
        "return_prefix": dict(return_prefix=True),
    }[kw]
    rows = prompts[1:] if kw == "return_prefix" else prompts[2:]
    with pytest.raises(ValueError):
        teng.generate(rows, **args)


def test_generate_rejects_prompts_above_the_largest_bucket(engines):
    """A prompt above the largest bucket is prefilled in chunks; with a
    `max_cache` too small for its chunks it is refused before any write
    (the JAX engine would clamp the writes into the cache's last slots)."""
    jeng, teng = engines
    prompt = np.arange(1, SEQ_BUCKETS[-1] + 2, dtype=np.int32)
    with pytest.raises(ValueError, match="max_cache"):
        teng.generate([prompt], max_cache=SEQ_BUCKETS[-1] + 8)
    gen = GenerateConfig(max_new_tokens=3, eos_token_ids=(128001,))
    _assert_same(jeng.generate([prompt], gen_cfg=gen), teng.generate([prompt], gen_cfg=gen))


def _logits(seed, b=3, v=50):
    return np.random.RandomState(seed).randn(b, v).astype(np.float32) * 3


@pytest.mark.parametrize("k", [1, 5, 49])
def test_top_k_filter(k):
    x = _logits(0)
    want = jsampling.top_k_filter(jnp.asarray(x), k)
    np.testing.assert_array_equal(tsampling.top_k_filter(torch.from_numpy(x), k).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.95])
def test_top_p_filter(p):
    x = _logits(1)
    want = jsampling.top_p_filter(jnp.asarray(x), p)
    got = tsampling.top_p_filter(torch.from_numpy(x), p)
    np.testing.assert_array_equal(got.numpy() <= -1e29, np.asarray(want) <= -1e29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_repetition_penalty():
    x = _logits(2)
    prev = np.array([[0, 3, 3, 7], [1, 2, 0, 0], [5, 0, 9, 9]], np.int32)
    mask = np.array([[True, True, False, True], [True, True, False, False],
                     [False, False, True, True]])
    want = jsampling.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(prev),
                                              jnp.asarray(mask), 1.3)
    got = tsampling.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(prev),
                                             torch.from_numpy(mask), 1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_greedy_sample_matches():
    x = _logits(3, v=128256)
    cfg = GenerateConfig()
    want = jsampling.sample(jnp.asarray(x), jax.random.PRNGKey(0), cfg)
    got = tsampling.sample(torch.from_numpy(x), None, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
