"""Idefics2 NaViT image preprocessing (port of
leopard_tpu/data/idefics2_processor.py): an aspect-preserving resize, padding
to the batch's largest image rounded up to whole patches, and the pixel and
patch masks of the real pixels. The arrays equal the JAX package's byte for
byte. Pillow is imported only inside `preprocess_idefics2`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

IDEFICS2_MEAN = (0.48145466, 0.4578275, 0.40821073)
IDEFICS2_STD = (0.26862954, 0.26130258, 0.27577711)
END_OF_UTTERANCE_ID = 32002  # <end_of_utterance> in the Idefics2 tokenizer


def answer_loss_mask(
    input_ids: np.ndarray,
    eou_id: int = END_OF_UTTERANCE_ID,
    assistant_prefix_len: int = 6,
) -> np.ndarray:
    """Loss weights for Idefics2 SFT: each odd <end_of_utterance> opens an
    assistant turn; the loss covers from `start + assistant_prefix_len`
    (past the "<eou>\\nAssistant:" tokens) through the closing (even)
    <end_of_utterance>; a turn left open by truncation runs to the end."""
    n = len(input_ids)
    mask = np.zeros(n, np.float32)
    count = 0
    start = -1
    for i in range(n):
        if input_ids[i] == eou_id:
            count += 1
            if count % 2 == 1:
                start = i
            else:
                mask[min(start + assistant_prefix_len, n - 1) : i + 1] = 1.0
    if count % 2 == 1:
        mask[min(start + assistant_prefix_len, n - 1) :] = 1.0
    return mask


def resize_for_navit(
    size: Tuple[int, int], shortest_edge: int = 378, longest_edge: int = 980
) -> Tuple[int, int]:
    """HF Idefics2's resize rule on (w, h): scale the longest side down to
    `longest_edge` if larger, then scale up until the shortest side is at
    least `shortest_edge`, neither side past `longest_edge`."""
    w, h = size
    if max(w, h) > longest_edge:
        scale = longest_edge / max(w, h)
        w, h = int(w * scale), int(h * scale)
    if min(w, h) < shortest_edge:
        scale = shortest_edge / min(w, h)
        w, h = min(int(np.ceil(w * scale)), longest_edge), min(
            int(np.ceil(h * scale)), longest_edge
        )
    return max(w, 1), max(h, 1)


def preprocess_idefics2(
    images: Sequence,
    shortest_edge: int = 378,
    longest_edge: int = 980,
    patch_size: int = 14,
    mean: Sequence[float] = IDEFICS2_MEAN,
    std: Sequence[float] = IDEFICS2_STD,
):
    """PIL images → (pixel_values [N, 3, H_max, W_max] float32 normalized,
    pixel_mask [N, H_max, W_max] bool, patch_mask [N, H_max/p, W_max/p]
    bool). Each image is resized (bicubic), then padded with zeros at the
    bottom and right to the batch maximum rounded up to patch multiples; a
    patch is real where it holds at least one real pixel."""
    from PIL import Image

    resized = []
    for im in images:
        w, h = resize_for_navit(im.size, shortest_edge, longest_edge)
        resized.append(im.convert("RGB").resize((w, h), Image.BICUBIC))
    hmax = max(im.size[1] for im in resized)
    wmax = max(im.size[0] for im in resized)
    hmax = ((hmax + patch_size - 1) // patch_size) * patch_size
    wmax = ((wmax + patch_size - 1) // patch_size) * patch_size

    mean_a = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std_a = np.asarray(std, np.float32).reshape(3, 1, 1)
    n = len(resized)
    pixels = np.zeros((n, 3, hmax, wmax), np.float32)
    mask = np.zeros((n, hmax, wmax), bool)
    for i, im in enumerate(resized):
        arr = np.asarray(im, np.float32).transpose(2, 0, 1) / 255.0
        arr = (arr - mean_a) / std_a
        h, w = arr.shape[1], arr.shape[2]
        pixels[i, :, :h, :w] = arr
        mask[i, :h, :w] = True
    patch_mask = (
        mask.reshape(n, hmax // patch_size, patch_size, wmax // patch_size, patch_size)
        .any(axis=(2, 4))
    )
    return pixels, mask, patch_mask
