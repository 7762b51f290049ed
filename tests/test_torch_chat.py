"""The port's chat templates (`leopard_tpu_torch/data/chat.py`) and its
tokenizer module against the JAX package's, with the tests' FakeTokenizer:
identical lists of ids (and weights) from every template function, both
layouts."""

import dataclasses

import numpy as np
import pytest

from leopard_tpu.data import chat as jref
from leopard_tpu.data import tokenizer as jtok
from leopard_tpu_torch.data import chat
from leopard_tpu_torch.data import tokenizer as ttok
from tests.test_chat import FakeTokenizer

TOK = FakeTokenizer()
IMG = chat.RST[250]


def test_torch_special_ids_match():
    assert (chat.BEGIN_OF_TEXT, chat.START_HEADER, chat.END_HEADER, chat.EOT_ID) == (
        jref.BEGIN_OF_TEXT, jref.START_HEADER, jref.END_HEADER, jref.EOT_ID)
    assert chat.RST == jref.RST and chat.DEFAULT_IMAGE_TOKEN_ID == jref.DEFAULT_IMAGE_TOKEN_ID
    for k in (5, 20, 21, 22, 250):
        assert chat.rst_id(TOK, k) == jref.rst_id(TOK, k) == chat.rst_id(None, k)


@pytest.mark.parametrize("layout", ["train", "eval"])
def test_torch_image_blocks_and_render(layout):
    tiles = [0, 2, 5]
    assert (chat.image_block_ids(tiles, 3, IMG, layout)
            == jref.image_block_ids(tiles, 3, IMG, layout))
    for text in ("<image> and <image> then <image>?", "no placeholder", "<image><image>"):
        assert (chat.render_images_into_text(TOK, text, tiles, 4, IMG, layout)
                == jref.render_images_into_text(TOK, text, tiles, 4, IMG, layout))
    with pytest.raises(ValueError, match="layout"):
        chat.image_block_ids([1], 2, IMG, "other")


@pytest.mark.parametrize("layout,gen_prompt", [("train", False), ("eval", True)])
def test_torch_build_llama3_chat(layout, gen_prompt):
    messages = [("system", "be brief"), ("user", "<image> what is this? <image>"),
                ("assistant", "a cat"), ("user", "and this?"), ("gpt", "a dog")]
    for tiles in ([1, 0, 3], [2, 4]):  # one placeholder missing, then none
        got = chat.build_llama3_chat(TOK, messages, tiles, 3, IMG, layout, gen_prompt)
        want = jref.build_llama3_chat(TOK, messages, tiles, 3, IMG, layout, gen_prompt)
        for field in dataclasses.fields(want):
            a, b = getattr(got, field.name), getattr(want, field.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_torch_build_idefics2_and_eval_prompts():
    for text, n in (("<image><image> compare", 2), ("describe", 3), ("a <image> b", 1)):
        got = chat.build_idefics2_prompt(TOK, text, n, image_seq_len=5)
        want = jref.build_idefics2_prompt(TOK, text, n, image_seq_len=5)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
    for instruction in ("Answer briefly.", ""):
        got = chat.build_eval_prompt(TOK, "<image> what?", [1, 2], 2, instruction=instruction,
                                     image_token_id=IMG)
        want = jref.build_eval_prompt(TOK, "<image> what?", [1, 2], 2, instruction=instruction,
                                      image_token_id=IMG)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()


class _HF:
    """Stands in for an HF tokenizer: a length, special ids, a call."""

    bos_token_id, eos_token_id, pad_token_id = 128000, 128009, None

    def __len__(self):
        return 128256 + 3

    def convert_tokens_to_ids(self, tok):
        return TOK.convert_tokens_to_ids(tok)

    def __call__(self, text, **kw):
        return TOK(text)

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_torch_tokenizer_wrapper():
    for n, mp in ((128256, 1), (128259, 1), (128259, 8), (32000, 3)):
        assert ttok.vocab_size_with_padding(n, mp) == jtok.vocab_size_with_padding(n, mp)
    got, want = ttok.LeopardTokenizer(_HF(), model_parallel_size=4), jtok.LeopardTokenizer(
        _HF(), model_parallel_size=4)
    for attr in ("padded_vocab_size", "image_token_id", "bos_token_id", "eos_token_id",
                 "pad_token_id"):
        assert getattr(got, attr) == getattr(want, attr)
    assert got.image_token_rank_and_id(4) == want.image_token_rank_and_id(4)
    assert got.special_token_id("<|reserved_special_token_20|>") == chat.RST[20]
    assert got("ab") == want("ab") and got.decode([1, 2]) == "1 2"
