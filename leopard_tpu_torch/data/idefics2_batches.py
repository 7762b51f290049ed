"""Leopard-Idefics2 training batches from a jsonl manifest (port of the batch
builder of examples/train_leopard_idefics2.py).

Each manifest row is `{"text": a chat-rendered string with <image>
placeholders, "images": [paths]}`. A row becomes one sequence: the Idefics2
prompt layout (`data/chat.py::build_idefics2_prompt`: each image a block of
`num_latents` image tokens between fake-image tokens), loss weights on the
assistant turns (`answer_loss_mask`), right padding to `seq_len`. The
batch's kept images go through `preprocess_idefics2` together, padded to the
largest of them, in order of appearance.

One departure from the reference builder, which cuts a row at `seq_len` but
keeps every image of the row: an image whose block the cut reaches would
leave the row with fewer image tokens than image features, and the splice
(`models/vlm.py::splice_image_features`) would then give every later row the
wrong image's features. Here a row ends before the first image block that
does not fit whole, and only the images whose blocks were kept are
preprocessed.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Mapping, Sequence, Tuple

import numpy as np

from leopard_tpu_torch.config import VLMConfig
from leopard_tpu_torch.data.chat import IMAGE_PLACEHOLDER, build_idefics2_prompt
from leopard_tpu_torch.data.idefics2_processor import answer_loss_mask, preprocess_idefics2


def cut_row(ids: np.ndarray, seq_len: int, image_token_id: int, block: int) -> Tuple[int, int]:
    """(tokens kept, images kept) of a prompt cut to `seq_len`: the cut moves
    back to the start of an image block it would split."""
    n = min(len(ids), seq_len)
    starts = np.flatnonzero((ids == image_token_id)
                            & (np.r_[-1, ids[:-1]] != image_token_id))
    kept = 0
    for start in starts:
        if start + block > n:
            n = min(n, int(start))
            break
        kept += 1
    return n, kept


def idefics2_row(row: Mapping, tokenizer, cfg: VLMConfig, seq_len: int,
                 image_folder: str = ""):
    """One manifest row → (ids [n], loss weights [n], the kept PIL images)."""
    from PIL import Image

    paths = row.get("images", [])
    if row["text"].count(IMAGE_PLACEHOLDER) > len(paths):
        raise ValueError(f"a manifest row has more {IMAGE_PLACEHOLDER} placeholders than "
                         f"images ({len(paths)})")
    block = cfg.perceiver.num_latents
    ids = build_idefics2_prompt(tokenizer, row["text"], len(paths), image_seq_len=block,
                                image_token_id=cfg.image_token_id,
                                fake_token_id=cfg.image_token_id - 1)
    n, kept = cut_row(ids, seq_len, cfg.image_token_id, block)
    images = [Image.open(os.path.join(image_folder, p)).convert("RGB") for p in paths[:kept]]
    return ids[:n], answer_loss_mask(ids[:n]), images


def idefics2_batch(rows: Sequence[Mapping], tokenizer, cfg: VLMConfig, seq_len: int,
                   image_folder: str = "") -> dict:
    """A batch of manifest rows: numpy tokens, segment_ids, loss_weights
    [rows, seq_len], and images [N, 3, H, W] float32 with patch_mask
    [N, H/14, W/14] (both None when no row keeps an image)."""
    b = len(rows)
    toks = np.zeros((b, seq_len), np.int32)
    seg = np.zeros((b, seq_len), np.int32)
    weights = np.zeros((b, seq_len), np.float32)
    flat: List = []
    for r, row in enumerate(rows):
        ids, w, images = idefics2_row(row, tokenizer, cfg, seq_len, image_folder)
        n = len(ids)
        toks[r, :n], seg[r, :n], weights[r, :n] = ids, 1, w
        flat += images
    pixels, patch_mask = None, None
    if flat:
        pixels, _, patch_mask = preprocess_idefics2(flat)
    return {"tokens": toks, "segment_ids": seg, "loss_weights": weights, "images": pixels,
            "patch_mask": patch_mask}


def idefics2_batches(rows: Sequence[Mapping], tokenizer, cfg: VLMConfig, batch_size: int,
                     seq_len: int, image_folder: str = "", start: int = 0) -> Iterator[dict]:
    """Endless batches of `batch_size` rows, cycling the manifest from row
    `start` (a run resumed at step k starts at k × batch_size)."""
    i = start
    while True:
        yield idefics2_batch([rows[(i + j) % len(rows)] for j in range(batch_size)],
                             tokenizer, cfg, seq_len, image_folder)
        i += batch_size
