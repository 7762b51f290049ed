"""Leopard VLM, both architectures (port of leopard_tpu/models/vlm.py):
  - leopard_llava: vision tower → pixel shuffle → projector → decoder;
  - leopard_idefics2: NaViT tower (patch masks) → perceiver (64 latents an
    image) → Mistral decoder. It holds no projector: the HF layout has
    none, and the JAX forward never reads the projector leaves its
    `init_params` makes anyway (convert/from_jax.py drops them).
Image features are spliced at the image-token positions.

The splice keeps the JAX package's static-shape cumsum-gather: the i-th image
token of the flattened batch takes the i-th image feature row. The JAX
forward's three layout pins (JAX vlm.py:135,147,153) are
`parallel/sharding.py::maybe_constrain`, a redistribute of a DTensor and
nothing otherwise: under a mesh the forward runs on this rank's rows and
shards, as plain tensors (parallel/tensor_parallel.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from leopard_tpu_torch.config import VLMConfig
from leopard_tpu_torch.models.decoder import Decoder, KVCache
from leopard_tpu_torch.models.params import init_normal_
from leopard_tpu_torch.models.perceiver import Perceiver
from leopard_tpu_torch.models.projector import Projector
from leopard_tpu_torch.models.siglip import SiglipVisionTower
from leopard_tpu_torch.ops.image import normalize_uint8_nhwc
from leopard_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from leopard_tpu_torch.parallel.sharding import maybe_constrain
from leopard_tpu_torch.parallel.tensor_parallel import vocab_parallel_embedding
from leopard_tpu_torch.utils.timers import span


def splice_image_features(
    token_embeds: torch.Tensor,    # [B, S, H]
    image_features: torch.Tensor,  # [N_tiles, T, H], in order of appearance
    is_image: torch.Tensor,        # [B, S] bool
    row_offsets: Optional[torch.Tensor] = None,  # [B] int
) -> torch.Tensor:
    """Replace embeddings at image-token positions with image feature rows in
    flattened-batch order. With `row_offsets` (chunked prefill) the i-th
    image token of row r takes feature row row_offsets[r] + i."""
    b, s, h = token_embeds.shape
    feat_rows = image_features.reshape(-1, h)
    if row_offsets is None:
        row_idx = torch.cumsum(is_image.reshape(b * s).long(), 0) - 1
    else:
        per_row = torch.cumsum(is_image.long(), dim=1) - 1
        row_idx = (row_offsets.long()[:, None] + per_row).reshape(b * s)
    row_idx = row_idx.clamp(0, feat_rows.shape[0] - 1)
    gathered = feat_rows[row_idx].to(token_embeds.dtype)
    out = torch.where(is_image.reshape(b * s, 1), gathered, token_embeds.reshape(b * s, h))
    return out.reshape(b, s, h)


class LeopardVLM(nn.Module):
    par = None  # parallel/mesh.py::Parallel, set by set_parallel

    def __init__(self, cfg: VLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision = SiglipVisionTower(cfg.vision, device=device)
        if cfg.architecture == "leopard_idefics2":
            if cfg.perceiver is None:
                raise ValueError("leopard_idefics2 needs a perceiver config")
            self.perceiver = Perceiver(cfg.perceiver, cfg.vision.hidden_size, device=device)
        elif cfg.architecture == "leopard_llava" and cfg.perceiver is None:
            self.projector = Projector(cfg.projector, device=device)
        else:
            raise NotImplementedError(
                f"architecture {cfg.architecture!r} with perceiver={cfg.perceiver} "
                "is not in the port")
        self.text = Decoder(cfg.text, device=device)

    def encode_images(self, pixel_values: torch.Tensor,
                      patch_mask: Optional[torch.Tensor] = None, remat=False) -> torch.Tensor:
        """pixel_values [N, 3, H, W] float, or [N, H, W, 3] uint8 →
        [N, tokens_per_tile, text_hidden]. `patch_mask` [N, H/p, W/p] bool
        (Idefics2): the real patches of each image; the perceiver attends
        only those."""
        cfg = self.cfg
        with span("model.tower"):
            if pixel_values.dtype == torch.uint8:
                pixel_values = normalize_uint8_nhwc(
                    pixel_values, cfg.anyres.image_mean, cfg.anyres.image_std
                )
            feats = self.vision(pixel_values, patch_mask=patch_mask, remat=remat)
            if cfg.architecture == "leopard_idefics2":
                seg = None
                if patch_mask is not None:
                    seg = patch_mask.reshape(feats.shape[0], -1).to(device=feats.device,
                                                                    dtype=torch.int32)
                return self.perceiver(feats, context_seg=seg)
            if cfg.pixel_shuffle_factor > 1:
                feats = pixel_shuffle(feats, cfg.pixel_shuffle_factor)
            return self.projector(feats)

    def forward(
        self,
        tokens: torch.Tensor,                           # [B, S] int
        images: Optional[torch.Tensor] = None,
        patch_mask: Optional[torch.Tensor] = None,      # [N, H/p, W/p] (Idefics2)
        segment_ids: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        image_features: Optional[torch.Tensor] = None,  # precomputed encode_images
        logits_indices: Optional[torch.Tensor] = None,
        fresh_cache: bool = False,
        positions: Optional[torch.Tensor] = None,       # [B, S]; default: slot order
        return_hidden: bool = False,
        remat=False,                                    # "none" | "full" | "attn" | "selective"
        remat_vision=None,                              # None: same as remat
        feature_row_offsets: Optional[torch.Tensor] = None,  # [B] chunked prefill
        return_aux: bool = False,
    ):
        """Returns (logits [B, S, V] fp32, the cache or None); with
        `return_hidden`, the decoder's final-normed hidden states in place of
        the logits (JAX vlm.py:105-168); with `return_aux`, a third item, the
        decoder's MoE aux values. `feature_row_offsets` maps one
        chunk's image tokens to their rows of the whole prompt's features
        (see splice_image_features)."""
        if image_features is None and images is not None:
            image_features = self.encode_images(
                images, patch_mask, remat=remat if remat_vision is None else remat_vision)
        with span("model.splice"):
            embeds = vocab_parallel_embedding(tokens.clamp(min=0), self.text.embed_tokens,
                                              self.par, self.cfg.text.vocab_size)
            embeds = maybe_constrain(embeds, ("data", "fsdp"), "seq", None)
            if image_features is not None:
                image_features = maybe_constrain(image_features, None, None, None)
                embeds = splice_image_features(
                    embeds, image_features, tokens == self.cfg.image_token_id,
                    row_offsets=feature_row_offsets,
                )
                embeds = maybe_constrain(embeds, ("data", "fsdp"), "seq", None)
        return self.text(
            input_embeds=embeds, positions=positions, segment_ids=segment_ids, cache=cache,
            return_hidden=return_hidden, remat=remat, logits_indices=logits_indices,
            fresh_cache=fresh_cache, return_aux=return_aux,
        )


def init_params(cfg: VLMConfig, generator: torch.Generator) -> LeopardVLM:
    """A LeopardVLM with seeded random weights, built and drawn directly on
    the generator's device (at 8B, an fp32 init on the host would take about
    32 GB of RAM and minutes)."""
    return init_normal_(LeopardVLM(cfg, device=generator.device), generator)
