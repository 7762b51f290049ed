"""LeopardProcessor: anyres tiling, image normalization and chat
tokenization in one object, the preprocessing shared by training and
evaluation (port of leopard_tpu/data/processor.py; the same ids, loss
weights and pixels).

Host code over PIL images and numpy arrays, built on the port's
`data/anyres.py` and `data/chat.py`. PIL is not imported here: the images
come in as PIL objects from the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

from leopard_tpu_torch.config import VLMConfig
from leopard_tpu_torch.data.anyres import preprocess_tiles, preprocess_tiles_uint8, tile_images
from leopard_tpu_torch.data.chat import build_eval_prompt, build_llama3_chat

if TYPE_CHECKING:
    from PIL import Image


@dataclass
class ProcessedSample:
    input_ids: np.ndarray        # [S] int32
    loss_weights: np.ndarray     # [S] float32
    pixel_values: np.ndarray     # [N_crops, 3, T, T] float32 or [N_crops, T, T, 3] uint8
    tiles_per_image: List[int]

    @property
    def seq_len(self) -> int:
        return len(self.input_ids)


class LeopardProcessor:
    def __init__(self, cfg: VLMConfig, tokenizer, layout: str = "train",
                 pixel_dtype: str = "float32"):
        """pixel_dtype="uint8" gives raw [N, T, T, 3] uint8 tiles, normalized
        on the device (`LeopardVLM.encode_images`); "float32" normalizes on
        the host and gives [N, 3, T, T] as an HF processor does."""
        if pixel_dtype not in ("float32", "uint8"):
            raise ValueError(f"pixel_dtype must be float32 or uint8, not {pixel_dtype!r}")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.layout = layout
        self.pixel_dtype = pixel_dtype

    def process_images(self, images: Sequence["Image.Image"], order: Optional[str] = None):
        anyres = self.cfg.anyres
        tiled = tile_images(
            images, tile_size=anyres.tile_size, total_budget=anyres.tile_budget,
            order=order or ("train" if self.layout == "train" else "eval"),
        )
        if self.pixel_dtype == "uint8":
            pixels = preprocess_tiles_uint8(tiled.tiles, tile_size=anyres.tile_size)
        else:
            pixels = preprocess_tiles(tiled.tiles, tile_size=anyres.tile_size,
                                      mean=anyres.image_mean, std=anyres.image_std)
        return pixels, tiled.tiles_per_image

    def process_chat(
        self,
        messages: Sequence[Tuple[str, str]],
        images: Sequence["Image.Image"],
    ) -> Optional[ProcessedSample]:
        """A training sample: the chat template and the anyres tiles. None
        when the sample has more than `max_images` images, or when its image
        tokens do not number (tiles + 1) x tokens_per_tile per image."""
        anyres = self.cfg.anyres
        if len(images) > anyres.max_images:
            return None
        pixels, tiles_per_image = self.process_images(images)
        chat = build_llama3_chat(
            self.tokenizer, messages, tiles_per_image, anyres.tokens_per_tile,
            image_token_id=self.cfg.image_token_id, layout="train",
        )
        expected = sum(t + 1 for t in tiles_per_image) * anyres.tokens_per_tile
        if images and chat.num_image_tokens != expected:
            return None
        return ProcessedSample(input_ids=chat.input_ids, loss_weights=chat.loss_weights,
                               pixel_values=pixels, tiles_per_image=tiles_per_image)

    def process_eval(self, question: str, images: Sequence["Image.Image"],
                     instruction: str = ""):
        """(prompt ids, pixels) of an eval or generate request."""
        pixels, tiles_per_image = self.process_images(images, order="eval")
        ids = build_eval_prompt(
            self.tokenizer, question, tiles_per_image, self.cfg.anyres.tokens_per_tile,
            instruction=instruction, image_token_id=self.cfg.image_token_id,
        )
        return ids, pixels
