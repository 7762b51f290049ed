"""Chat templating and the multimodal token layout of Leopard models (port of
leopard_tpu/data/chat.py; pure Python over a tokenizer object, the same
lists of ids).

Two layouts, selected by `layout`:
  - "train": per image, `image {i}: <|rst_20|>`, then for each tile k
    tokens_per_tile image tokens and the tile tag `<|rst_{22+k}|>`, then
    tokens_per_tile image tokens for the resized original and `<|rst_21|>`
    (crop order: tiles first, original last);
  - "eval": per image, `image {i}: <|rst_20|>`, (tiles + 1) × tokens_per_tile
    image tokens and `<|rst_21|>` (crop order: original first).

Text segments are tokenized once and the image-token blocks are spliced in
as ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

# Llama-3 special-token ids: <|reserved_special_token_k|> for k >= 5 sits at
# 128010 + (k - 5), so <|reserved_special_token_250|> = 128255
BEGIN_OF_TEXT = 128000
START_HEADER = 128006
END_HEADER = 128007
EOT_ID = 128009
RST = {k: 128010 + (k - 5) for k in range(5, 251)}


def rst_id(tokenizer, k: int) -> int:
    """<|reserved_special_token_k|> through the tokenizer where it knows it."""
    if tokenizer is not None:
        tid = tokenizer.convert_tokens_to_ids(f"<|reserved_special_token_{k}|>")
        if tid is not None and tid >= 0:
            return tid
    return RST[k]


IMAGE_PLACEHOLDER = "<image>"
DEFAULT_IMAGE_TOKEN_ID = RST[250]
ANSWER_LOSS_START_ROLES = ("assistant", "gpt")


@dataclass
class ChatSample:
    input_ids: np.ndarray        # [S] int32; image positions hold image_token_id
    labels: np.ndarray           # [S] int32 (== input_ids; masking via weights)
    loss_weights: np.ndarray     # [S] float32: 1.0 on answer tokens
    preferences: np.ndarray      # [S] int32: 0 on context, 2 on answer tokens
    num_image_tokens: int


def _encode(tokenizer, text: str) -> List[int]:
    return tokenizer(text, add_special_tokens=False)["input_ids"]


def image_block_ids(
    tiles_per_image: Sequence[int],
    tokens_per_tile: int,
    image_token_id: int = DEFAULT_IMAGE_TOKEN_ID,
    layout: str = "train",
) -> List[List[int]]:
    """The token-id block of each image (everything after 'image {i}: ')."""
    blocks = []
    for n_tiles in tiles_per_image:
        ids: List[int] = [RST[20]]
        if layout == "train":
            for k in range(n_tiles):
                ids += [image_token_id] * tokens_per_tile
                ids.append(RST[22 + k])
            ids += [image_token_id] * tokens_per_tile  # the original image
            ids.append(RST[21])
        elif layout == "eval":
            ids += [image_token_id] * (tokens_per_tile * (n_tiles + 1))
            ids.append(RST[21])
        else:
            raise ValueError(f"unknown layout {layout}")
        blocks.append(ids)
    return blocks


def render_images_into_text(
    tokenizer,
    text: str,
    tiles_per_image: Sequence[int],
    tokens_per_tile: int,
    image_token_id: int = DEFAULT_IMAGE_TOKEN_ID,
    layout: str = "train",
) -> List[int]:
    """Tokenize `text`, replacing each `<image>` with its `image {i}: ...`
    block; missing placeholders are prepended."""
    n_images = len(tiles_per_image)
    count = text.count(IMAGE_PLACEHOLDER)
    if count < n_images:
        text = IMAGE_PLACEHOLDER * (n_images - count) + text
    parts = text.split(IMAGE_PLACEHOLDER)
    blocks = image_block_ids(tiles_per_image, tokens_per_tile, image_token_id, layout)
    ids: List[int] = []
    for i, part in enumerate(parts):
        if i > 0:
            ids += _encode(tokenizer, f"image {i}: ")
            ids += blocks[i - 1]
        if part:
            ids += _encode(tokenizer, part)
    return ids


def build_llama3_chat(
    tokenizer,
    messages: Sequence[Tuple[str, str]],       # (role, content); content may
                                               # hold <image> placeholders
    tiles_per_image: Sequence[int],
    tokens_per_tile: int,
    image_token_id: int = DEFAULT_IMAGE_TOKEN_ID,
    layout: str = "train",
    add_generation_prompt: bool = False,
) -> ChatSample:
    """The Llama-3 chat template with multimodal blocks and per-token loss
    weights: answer tokens 1.0; headers, user and system content 0.0."""
    messages = [list(m) for m in messages]
    total_ph = sum(m[1].count(IMAGE_PLACEHOLDER) for m in messages)
    if total_ph < len(tiles_per_image) and messages:
        # missing placeholders go to the front of the first message
        messages[0][1] = (
            IMAGE_PLACEHOLDER * (len(tiles_per_image) - total_ph) + messages[0][1]
        )
    remaining = list(tiles_per_image)
    ids: List[int] = [tokenizer.bos_token_id or BEGIN_OF_TEXT]
    weights: List[float] = [0.0]
    prefs: List[int] = [0]
    for role, content in messages:
        head = _encode(tokenizer, f"<|start_header_id|>{role}<|end_header_id|>\n\n")
        n_here = content.count(IMAGE_PLACEHOLDER)
        take = remaining[:n_here]
        if take:
            body = render_images_into_text(
                tokenizer, content, take, tokens_per_tile, image_token_id, layout
            )
        else:
            body = _encode(tokenizer, content.replace(IMAGE_PLACEHOLDER, ""))
        remaining = remaining[len(take):]
        tail = body + _encode(tokenizer, "<|eot_id|>")
        ids += head + tail
        is_answer = role in ANSWER_LOSS_START_ROLES
        weights += [0.0] * len(head) + [1.0 if is_answer else 0.0] * len(tail)
        prefs += [0] * len(head) + [2 if is_answer else 0] * len(tail)
    if add_generation_prompt:
        gen = _encode(tokenizer, "<|start_header_id|>assistant<|end_header_id|>\n\n")
        ids += gen
        weights += [0.0] * len(gen)
        prefs += [0] * len(gen)
    arr = np.asarray(ids, np.int32)
    return ChatSample(
        input_ids=arr,
        labels=arr.copy(),
        loss_weights=np.asarray(weights, np.float32),
        preferences=np.asarray(prefs, np.int32),
        num_image_tokens=int((arr == image_token_id).sum()),
    )


def build_idefics2_prompt(
    tokenizer,
    text: str,
    n_images: int,
    image_seq_len: int = 64,
    image_token_id: int = 32001,
    fake_token_id: int = 32000,
    add_bos: bool = True,
) -> np.ndarray:
    """Idefics2 prompt: each <image> becomes
    `<fake_token_around_image><image>×seq_len<fake_token_around_image>`, and
    adjacent images share one boundary token (HF Idefics2Processor)."""
    count = text.count(IMAGE_PLACEHOLDER)
    if count < n_images:
        text = IMAGE_PLACEHOLDER * (n_images - count) + text
    parts = text.split(IMAGE_PLACEHOLDER)
    ids: List[int] = []
    if add_bos and tokenizer.bos_token_id is not None:
        ids.append(tokenizer.bos_token_id)
    for i, part in enumerate(parts):
        if i > 0:
            if not ids or ids[-1] != fake_token_id:
                ids.append(fake_token_id)
            ids += [image_token_id] * image_seq_len
            ids.append(fake_token_id)
        if part:
            ids += _encode(tokenizer, part)
    return np.asarray(ids, np.int32)


def build_eval_prompt(
    tokenizer,
    question: str,
    tiles_per_image: Sequence[int],
    tokens_per_tile: int,
    instruction: str = "Answer the question using a single word or phrase.",
    image_token_id: int = DEFAULT_IMAGE_TOKEN_ID,
    layout: str = "eval",
) -> np.ndarray:
    """The eval prompt: `<bot><user header>\\n\\n{question}\\n{instruction}
    <eot><assistant header>\\n\\n`, with image blocks for the <image>s."""
    ids: List[int] = [BEGIN_OF_TEXT]
    ids += _encode(tokenizer, "<|start_header_id|>user<|end_header_id|>\n\n")
    text = f"{question}\n{instruction}" if instruction else question
    ids += render_images_into_text(
        tokenizer, text, tiles_per_image, tokens_per_tile, image_token_id, layout
    )
    ids += _encode(
        tokenizer, "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n"
    )
    return np.asarray(ids, np.int32)
