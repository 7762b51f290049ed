"""Tied embeddings in the port (`tie_word_embeddings=True`: no `lm_head`,
logits through `embed_tokens`), on the CPU in float32:

  - the dense tied decoder's logits against the JAX decoder (rtol/atol
    1e-4, the decoder tests' tolerance), and one train step's gradient of
    `embed_tokens`, which sums its two uses, against `jax.grad` of the JAX
    `vlm_loss` (rtol 2e-4, atol 2e-5 of its largest entry, the tolerance of
    tests/test_torch_train_step.py);
  - a tiny transformers `LlamaForCausalLM(tie_word_embeddings=True)` into
    the port through `convert/hf.py`, and the port's export with its
    `config.json` back into transformers by `from_pretrained` (logits at
    3e-4, the tolerance of tests/test_torch_hf_convert.py);
  - int8 `Engine.generate` of a tied dense model against the JAX engine:
    identical tokens, logprobs 1e-4; the head, `embed_tokens`, stays fp32.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from leopard_tpu import config as jcfgs
from leopard_tpu.config import GenerateConfig
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.models import decoder as jdecoder
from leopard_tpu.models import vlm as jvlm
from leopard_tpu.training import trainer as jtrainer
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert import hf as thf
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.models.decoder import Decoder
from leopard_tpu_torch.ops.quant import is_quantized
from leopard_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(2)


def tied(mod, vocab_size=512):
    cfg = mod.tiny_vlm(vocab_size=vocab_size)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tie_word_embeddings=True))


def _pair(vocab_size=512, seed=0):
    jcfg, tcfg = tied(jcfgs, vocab_size), tied(tcfgs, vocab_size)
    params = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(seed)))
    assert "lm_head" not in params["text"]
    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return jcfg, tcfg, params, model


def test_tied_decoder_logits_match_jax():
    jcfg, _, params, model = _pair()
    assert "text.lm_head" not in model.state_dict()
    tokens = np.random.RandomState(0).randint(1, 500, (2, 12)).astype(np.int32)
    want, _ = jdecoder.forward(params["text"], jcfg.text, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model.text(torch.from_numpy(tokens).long())
        model.text.keep_fp32_head()  # the serving copy reads embed_tokens
        again, _ = model.text(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert torch.equal(again, got)


def test_train_step_embed_gradient_matches_jax():
    jcfg, tcfg, params, model = _pair(seed=1)
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(1, 500, (2, 16)).astype(np.int32),
             "segment_ids": np.ones((2, 16), np.int32),
             "loss_weights": np.ones((2, 16), np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.device_get(jax.grad(lambda p: jtrainer.vlm_loss(
        p, jcfg, jbatch, jnp.float32, "full", loss_chunk=16)[0])(params))
    ttc = tcfgs.TrainConfig(remat="full", loss_chunk=16)
    state = ttrainer.create_train_state(model, ttc)
    _, _, grads = ttrainer.make_train_step(tcfg, ttc).loss_and_grads(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = np.asarray(jgrads["text"]["embed_tokens"])
    got = grads["text.embed_tokens"].numpy()
    # rows of tokens not in the batch still get the unembedding's gradient
    unused = np.setdiff1d(np.arange(want.shape[0]), batch["tokens"])
    assert np.abs(got[unused]).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * np.abs(want).max())


def _hf_tied_llama(seed=2):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    hf_cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=True, attn_implementation="eager")
    return LlamaForCausalLM(hf_cfg).eval()


TEXT = tcfgs.TextConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                        rope_scaling=None, rms_norm_eps=1e-5, max_position_embeddings=128,
                        tie_word_embeddings=True, dtype="float32")
TOKENS = torch.tensor([[3, 17, 200, 90, 12, 0, 55, 7]])


def test_hf_tied_llama_into_the_port():
    hf = _hf_tied_llama()
    sd = hf.state_dict()
    decoder = Decoder(TEXT, device="meta")
    decoder.load_state_dict(thf.convert_decoder(sd, TEXT, "model.", device="cpu"),
                            strict=True, assign=True)
    with torch.no_grad():
        want = hf(TOKENS).logits
        got, _ = decoder(TOKENS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4, atol=3e-4)


def test_port_tied_decoder_out_to_hf(tmp_path):
    """export_decoder writes no lm_head.weight and hf_decoder_config says
    tie_word_embeddings: transformers' from_pretrained ties the head."""
    from safetensors.torch import save_file
    from transformers import LlamaForCausalLM

    decoder = Decoder(TEXT, device="meta")
    decoder.load_state_dict(thf.convert_decoder(_hf_tied_llama(seed=3).state_dict(), TEXT,
                                                "model.", device="cpu"),
                            strict=True, assign=True)
    sd = thf.export_decoder(decoder, TEXT, "model.")
    assert "lm_head.weight" not in sd
    save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    hf_config = thf.hf_decoder_config(TEXT)
    assert hf_config["tie_word_embeddings"] is True and hf_config["model_type"] == "llama"
    (tmp_path / "config.json").write_text(json.dumps(hf_config))
    hf = LlamaForCausalLM.from_pretrained(str(tmp_path)).eval()
    assert hf.lm_head.weight.data_ptr() == hf.model.embed_tokens.weight.data_ptr()
    with torch.no_grad():
        want = hf(TOKENS).logits
        got, _ = decoder(TOKENS)
    np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=3e-4, atol=3e-4)


def test_int8_generate_of_a_tied_model_matches_jax():
    jcfg, tcfg, params, model = _pair(vocab_size=128256, seed=4)
    kw = dict(seq_buckets=(32, 64), tile_buckets=(1, 2), quantize="int8")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 128000, n).astype(np.int32) for n in (9, 23)]
    gen = GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(999999,))
    teng = Engine(tcfg, model, **kw)
    assert is_quantized(teng.model.text.layers[0].attn.wq)
    assert teng.model.text.unembedding.dtype == torch.float32  # not quantized
    want = JaxEngine(jcfg, params, **kw).generate(prompts, gen_cfg=gen)
    got = teng.generate(prompts, gen_cfg=gen)
    for jt, tt, jl, tl in zip(want.tokens, got.tokens, want.logprobs, got.logprobs):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
