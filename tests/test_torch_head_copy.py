"""The serving copy of the fp32 head follows the live head
(models/decoder.py::Decoder.keep_fp32_head / _head).

An engine reused after a train step's in-place update of the weights (a
training loop's `eval_fn`, `cast_for_compute` writing the compute model in
place) must not mix the updated body with the head it copied at build time:
its logits after an in-place update of the unembedding equal a freshly
built engine's, bit for bit, for `Engine` and for `LeopardLM`, with the
text in bf16 (the case the copy exists for). One copy is kept: calls that
find the head unchanged reuse it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.evaluation.lm_eval_adapter import LeopardLM
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.models import vlm

PROMPTS = [np.array([1, 17, 30, 99, 5, 8], np.int32), np.array([2, 3, 4], np.int32)]


def bf16_model(tied=False):
    cfg = tcfgs.tiny_vlm()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, dtype="bfloat16", tie_word_embeddings=tied))
    return cfg, vlm.init_params(cfg, torch.Generator().manual_seed(0))


@torch.no_grad()
def update_head(model):
    """An in-place update of the unembedding, as cast_for_compute makes it."""
    head = model.text.unembedding
    head.add_(torch.randn(head.shape, generator=torch.Generator().manual_seed(1)).to(head.dtype))


def engine_logits(engine):
    return engine.prefill(PROMPTS)[0]


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_engine_logits_follow_an_in_place_head_update(tied):
    cfg, model = bf16_model(tied)
    kw = dict(seq_buckets=(8, 16), tile_buckets=(1,))
    engine = Engine(cfg, model, **kw)
    before = engine_logits(engine)
    copy = model.text._head_f32
    assert copy is not None and engine_logits(engine).equal(before)
    assert model.text._head_f32 is copy  # an unchanged head: the same copy serves
    update_head(model)
    after = engine_logits(engine)
    fresh = engine_logits(Engine(cfg, model, **kw))
    assert not after.equal(before)
    assert after.equal(fresh)
    assert model.text._head_f32.dtype == torch.float32
    assert model.text._head_f32.equal(model.text.unembedding.float())


def test_lm_eval_adapter_logprobs_follow_an_in_place_head_update():
    cfg, model = bf16_model()
    lm = LeopardLM(cfg, model, tokenizer=None)
    tokens = np.zeros((1, 8), np.int32)
    tokens[0, :6] = PROMPTS[0]
    seg = (tokens != 0).astype(np.int32)
    before = lm._logprobs(tokens, seg)
    update_head(model)
    after = lm._logprobs(tokens, seg)
    fresh = LeopardLM(cfg, model, tokenizer=None)._logprobs(tokens, seg)
    assert not after.equal(before)
    assert after.equal(fresh)


def test_a_new_head_tensor_is_copied_again():
    """A head replaced by another tensor (a checkpoint loaded with
    assign=True) is copied again, though its version counter may match."""
    cfg, model = bf16_model()
    engine = Engine(cfg, model, seq_buckets=(8, 16), tile_buckets=(1,))
    engine_logits(engine)
    new = torch.nn.Parameter(model.text.lm_head.detach().clone() * 2, requires_grad=False)
    model.text.lm_head = new
    got = engine_logits(engine)
    assert model.text._head_f32.equal(new.float())
    assert got.equal(engine_logits(Engine(cfg, model, seq_buckets=(8, 16), tile_buckets=(1,))))


def test_a_call_under_autograd_reads_the_live_head():
    cfg, model = bf16_model()
    model.text.keep_fp32_head()
    with torch.enable_grad():
        head = model.text._head()
    assert head.requires_grad and head is not model.text._head_f32
