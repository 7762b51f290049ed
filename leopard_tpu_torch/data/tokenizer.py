"""Tokenizer with vocab padding (port of leopard_tpu/data/tokenizer.py).

`build_tokenizer` builds an HF AutoTokenizer by name, importing
`transformers` only when called; `vocab_size_with_padding` rounds the
vocab up so that an embedding sharded `model_parallel_size` ways divides
evenly. The tokenizer is an explicit object, not a global.
"""

from __future__ import annotations

from typing import Optional


def vocab_size_with_padding(
    orig_vocab_size: int,
    model_parallel_size: int = 1,
    divisible_by: int = 128,
) -> int:
    """Round vocab up to a multiple of divisible_by × model_parallel_size."""
    multiple = divisible_by * model_parallel_size
    return ((orig_vocab_size + multiple - 1) // multiple) * multiple


class LeopardTokenizer:
    """Thin wrapper over an HF tokenizer with Leopard's multimodal extras."""

    def __init__(self, hf_tokenizer, image_token: str = "<|reserved_special_token_250|>",
                 model_parallel_size: int = 1, pad_vocab_to: int = 128):
        self.hf = hf_tokenizer
        self.image_token = image_token
        self.padded_vocab_size = vocab_size_with_padding(
            len(hf_tokenizer), model_parallel_size, pad_vocab_to
        )

    @property
    def image_token_id(self) -> int:
        return self.hf.convert_tokens_to_ids(self.image_token)

    @property
    def bos_token_id(self):
        return self.hf.bos_token_id

    @property
    def eos_token_id(self):
        return self.hf.eos_token_id

    @property
    def pad_token_id(self):
        return self.hf.pad_token_id if self.hf.pad_token_id is not None else 0

    def special_token_id(self, token: str) -> int:
        return self.hf.convert_tokens_to_ids(token)

    def image_token_rank_and_id(self, model_parallel_size: int):
        """Which shard of a vocab-parallel embedding holds the image token,
        and its row there."""
        tid = self.image_token_id
        per_rank = self.padded_vocab_size // model_parallel_size
        return tid // per_rank, tid % per_rank

    def __call__(self, *args, **kw):
        return self.hf(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.hf, name)


def build_tokenizer(
    name_or_path: str,
    tokenizer_type: str = "auto",
    model_parallel_size: int = 1,
    image_token: Optional[str] = None,
) -> LeopardTokenizer:
    """An HF AutoTokenizer wrapped as a LeopardTokenizer. Every
    `tokenizer_type` resolves through AutoTokenizer; it selects the default
    image token: reserved token 250 for the Llama-3 family, `<image>`
    otherwise."""
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(name_or_path, use_fast=True)
    if image_token is None:
        image_token = (
            "<|reserved_special_token_250|>"
            if tokenizer_type in ("auto", "llama3", "llama3.1")
            and hf.convert_tokens_to_ids("<|reserved_special_token_250|>") is not None
            else "<image>"
        )
    return LeopardTokenizer(hf, image_token, model_parallel_size)
