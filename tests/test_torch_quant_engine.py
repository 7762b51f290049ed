"""Quantized `Engine.generate` of the port against the JAX engine under the
same flags, token for token.

Weights are the JAX init, moved by `state_dict_from_jax`; each engine
quantizes them itself, and both run float32 on the CPU. Tokens must be
identical; logprobs agree at 1e-4. Two configs: `tiny_vlm(vocab_size=128256)`
(so image token ids stay in range), whose narrow widths take int4 groups of
32 and 64, and a narrow config whose widths are multiples of 256, so every
int4 leaf takes group 128, the kernel's group (its dense path on the CPU).
"""

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
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.models.params import QuantizedWeight

from test_torch_quant_models import narrow_kernel_widths_cfg

torch.set_num_threads(2)
SEQ_BUCKETS = (32, 64)
TILE_BUCKETS = (1, 2, 4)
CONFIGS = {"tiny": lambda: cfgs.tiny_vlm(vocab_size=128256),
           "group128": lambda: narrow_kernel_widths_cfg(vocab_size=128256)}
FLAGS = {"int8": dict(quantize="int8"), "int4": dict(quantize="int4"),
         "int4_kv8": dict(quantize="int4", quantize_kv=True)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(cfg, JAX params, port model holding the same weights)."""
    cfg = CONFIGS[request.param]()
    params = jvlm.init_params(cfg, jax.random.PRNGKey(1))
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), cfg), strict=True)
    return cfg, params, model


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


@pytest.mark.parametrize("flags", list(FLAGS))
def test_quantized_generate_matches_jax(pair, flags):
    cfg, params, model = pair
    kw = dict(seq_buckets=SEQ_BUCKETS, tile_buckets=TILE_BUCKETS, **FLAGS[flags])
    jeng = JaxEngine(cfg, params, **kw)
    teng = Engine(cfg, model, **kw)
    prompts, images = _requests(cfg)
    gen = GenerateConfig(max_new_tokens=8, eos_token_ids=(128001,))
    jres = jeng.generate(prompts, images=images, gen_cfg=gen)
    tres = teng.generate(prompts, images=images, gen_cfg=gen)
    for jt, tt, jl, tl in zip(jres.tokens, tres.tokens, jres.logprobs, tres.logprobs):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def test_quantized_engine_leaves_the_callers_model_as_it_is(pair):
    """The engine quantizes a new decoder on the caller's tensors: vision
    tower, projector, embedding and norms are shared, not copied."""
    cfg, _, model = pair
    before = {k: v.clone() for k, v in model.state_dict().items()}
    teng = Engine(cfg, model, quantize="int4")
    assert isinstance(teng.model.text.layers[0].attn.wq, QuantizedWeight)
    assert isinstance(teng.model.text.lm_head, QuantizedWeight)
    assert teng.model.text._head_f32 is None  # no fp32 copy of a quantized head
    assert isinstance(model.text.layers[0].attn.wq, torch.nn.Parameter)
    assert model.state_dict().keys() == before.keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    shared = teng.model.state_dict()
    for k in ("text.embed_tokens", "text.final_norm", "text.layers.0.input_norm",
              "vision.layers.0.attn.wq", "projector.fc1"):
        assert shared[k].data_ptr() == model.state_dict()[k].data_ptr(), k
