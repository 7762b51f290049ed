"""Leopard model adapters for the evaluation harness (port of
leopard_tpu/evaluation/adapter.py).

Counterpart of the reference's evaluations/models/llava_multiimg_siglip_anyres.py
(the HF adapter), running on the port's Engine with the same prompt and crop
protocol: anyres tiling with the eval crop order (original first), `image i:`
blocks with one tokens_per_tile run of image tokens per crop, greedy decode
with max_new_tokens=128 and eos {128001, 128009}. The Idefics2 adapter
follows evaluations/models/idefics2_multiimg.py: NaViT images, perceiver
latents, eos `<end_of_utterance>`.

An adapter takes a LeopardVLM (the Engine takes a model, not a params tree)
and builds its Engine over it. Pixels stay numpy on the host until
`Engine.generate` copies them to the model's device; `plan`, `materialize`
and `prepare` touch no device, so the harness may run them in its prefetch
thread. Pillow is imported inside the functions that read images.

Prefix caching keeps the prefilled headers in an LRU store of at most
MAX_PREFIXES entries: each is a one-row KV cache on the card (at 8B, 64
MiB for a header under 512 tokens), so an unbounded store would grow with
every distinct header of a long run.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from leopard_tpu_torch.config import GenerateConfig, VLMConfig
from leopard_tpu_torch.data.anyres import (
    plan_tile_grid,
    preprocess_tiles,
    preprocess_tiles_uint8,
    tile_images,
    tiles_per_image_from_plan,
)
from leopard_tpu_torch.data.chat import build_eval_prompt, build_idefics2_prompt
from leopard_tpu_torch.data.idefics2_processor import preprocess_idefics2
from leopard_tpu_torch.inference.engine import Engine

MAX_PREFIXES = 8


@dataclasses.dataclass
class PreparedSample:
    """A row preprocessed for batched inference: tokenized prompt + pixel
    tiles (possibly empty). `n_tiles` drives cost bucketing."""

    prompt: np.ndarray                    # [S] int32 token ids
    pixels: Optional[np.ndarray]          # [n_tiles, 3, H, W] fp32 or
                                          # [n_tiles, H, W, 3] uint8, or None
    patch_mask: Optional[np.ndarray] = None

    @property
    def n_tiles(self) -> int:
        return 0 if self.pixels is None else int(self.pixels.shape[0])


@dataclasses.dataclass
class PlannedSample:
    """Phase 1 of the two-phase eval pipeline: what the batching loop needs
    to sort and bucket (prompt ids and crop count, from image headers only,
    no pixel decode), plus the tiling plan so materialize() skips planning
    again. The pixel work runs later, overlapped with the card
    (evaluation/harness.py::run_benchmark_batched)."""

    prompt: np.ndarray
    paths: List[str]
    resolutions: list                     # plan_tile_grid output
    n_tiles: int                          # total crops (tiles + originals)


class _PrefixStore:
    """Prefilled headers by token bytes, least recently used evicted past
    `max_entries`. `built` counts prefills, `evicted` evictions."""

    def __init__(self, max_entries: int = MAX_PREFIXES):
        self.max_entries = max_entries
        self.entries: "collections.OrderedDict" = collections.OrderedDict()
        self.built = 0
        self.evicted = 0

    def __len__(self) -> int:
        return len(self.entries)

    def get_or_build(self, key: bytes, build):
        pre = self.entries.get(key)
        if pre is not None:
            self.entries.move_to_end(key)
            return pre
        pre = build()
        self.built += 1
        self.entries[key] = pre
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)
            self.evicted += 1
        return pre


class _EvalAdapter:
    """What both families share: the engine, prefix caching and batched
    generate."""

    def __init__(self, cfg: VLMConfig, model, tokenizer, gen_cfg: GenerateConfig,
                 quantize: Optional[str], quantize_kv: bool, spec, prefix_caching: bool):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.spec = spec
        self.prefix_caching = prefix_caching
        self.prefix_min_len = 32      # don't bother below this LCP
        self.prefix_quantum = 32      # round LCP down for cross-batch reuse
        self._prefixes = _PrefixStore()
        self.gen_cfg = gen_cfg
        self.engine = Engine(cfg, model, self.gen_cfg, quantize=quantize,
                             quantize_kv=quantize_kv)

    def _generate(self, batch: List[PreparedSample], pixels, patch_mask) -> List[str]:
        prompts = [s.prompt for s in batch]
        prefix = None
        if (self.prefix_caching and self.spec is None
                and self.gen_cfg.repetition_penalty == 1.0):
            prefix, prompts = _batch_prefix(
                self.engine, self.cfg, prompts, self._prefixes,
                min_len=self.prefix_min_len, quantum=self.prefix_quantum,
            )
        result = self.engine.generate(
            prompts, images=pixels, patch_mask=patch_mask,
            gen_cfg=self.gen_cfg, spec=self.spec, prefix=prefix,
        )
        return [
            self.tokenizer.decode(t.tolist(), skip_special_tokens=True)
            for t in result.tokens
        ]

    def __call__(self, row: dict, instruction: str) -> str:
        return self.generate_prepared([self.prepare(row, instruction)])[0]


def _question(row: dict) -> str:
    question = row["question"]
    if row.get("concated_options"):
        question = f"{question}{row['concated_options']}"
    return question


class LeopardLlavaEvalAdapter(_EvalAdapter):
    """infer_fn provider for evaluation.harness.run_benchmark."""

    def __init__(
        self,
        cfg: VLMConfig,
        model,
        tokenizer,
        gen_cfg: Optional[GenerateConfig] = None,
        layout: str = "eval",
        max_images: int = 50,
        device_preprocess: bool = True,
        quantize: Optional[str] = None,
        quantize_kv: bool = False,
        spec=None,
        prefix_caching: bool = False,
    ):
        """`device_preprocess` ships raw uint8 tiles, normalized on the
        card inside `encode_images` (4x fewer bytes to the card); False
        normalizes on the host (the HF processor's fp32 output).

        `quantize` ("int8"/"int4") serves with weight-only quantized decoder
        matmuls; `quantize_kv` stores the KV cache int8. `spec` (a
        SpecConfig) decodes with prompt-lookup speculation, token-identical
        to plain greedy (inference/speculative.py). `prefix_caching`
        prefills each batch's common prompt header (system preamble +
        instruction) once and seeds it into every row (_batch_prefix),
        keeping at most MAX_PREFIXES headers; ignored when `spec` is set
        or sampling uses a repetition penalty."""
        super().__init__(
            cfg, model, tokenizer,
            gen_cfg or GenerateConfig(max_new_tokens=128, greedy=True,
                                      eos_token_ids=(128001, 128009)),
            quantize, quantize_kv, spec, prefix_caching)
        self.layout = layout
        self.max_images = max_images
        self.device_preprocess = device_preprocess

    def load_images(self, paths: Sequence[str]):
        from PIL import Image

        out = []
        for p in paths:
            with Image.open(p) as im:
                out.append(im.convert("RGB"))
        return out

    def plan(self, row: dict, instruction: str) -> PlannedSample:
        """Phase 1 (cheap): the tile grid from image header sizes and the
        tokenized prompt, enough for the harness's bucketing sort. No pixel
        is decoded here."""
        from PIL import Image

        paths = list(row["images_path"][: self.max_images])
        sizes = []
        for p in paths:
            with Image.open(p) as im:   # lazy: reads the header only
                sizes.append(im.size)
        anyres = self.cfg.anyres
        resolutions = plan_tile_grid(sizes, tile_size=anyres.tile_size,
                                     total_budget=anyres.tile_budget)
        tiles_per_image = tiles_per_image_from_plan(resolutions, anyres.tile_size)
        prompt = build_eval_prompt(
            self.tokenizer,
            _question(row),
            tiles_per_image,
            anyres.tokens_per_tile,
            instruction=instruction,
            image_token_id=self.cfg.image_token_id,
            layout=self.layout,
        )
        return PlannedSample(
            prompt=np.asarray(prompt, np.int32),
            paths=paths,
            resolutions=resolutions,
            n_tiles=sum(tiles_per_image) + len(paths),
        )

    def materialize(self, plan: PlannedSample) -> PreparedSample:
        """Phase 2 (expensive): decode, tile, and make (uint8|fp32) pixel
        arrays, on the host."""
        anyres = self.cfg.anyres
        tiled = tile_images(
            self.load_images(plan.paths),
            tile_size=anyres.tile_size,
            total_budget=anyres.tile_budget,
            order="eval" if self.layout == "eval" else "train",
            resolutions=plan.resolutions,
        )
        if not tiled.tiles:
            return PreparedSample(prompt=plan.prompt, pixels=None)
        if self.device_preprocess:
            pixels = preprocess_tiles_uint8(tiled.tiles, tile_size=anyres.tile_size)
        else:
            pixels = preprocess_tiles(tiled.tiles, tile_size=anyres.tile_size,
                                      mean=anyres.image_mean, std=anyres.image_std)
        return PreparedSample(prompt=plan.prompt, pixels=pixels)

    def prepare(self, row: dict, instruction: str) -> PreparedSample:
        """Anyres tiling + prompt build only; no device work."""
        return self.materialize(self.plan(row, instruction))

    def generate_prepared(self, batch: List[PreparedSample]) -> List[str]:
        """One engine.generate call for a whole batch: prompts pad to the
        batch's seq bucket; every row's tiles concatenate in row order (the
        splice consumes feature rows in flattened-batch order,
        models/vlm.py::splice_image_features, so concatenation is exact)."""
        with_px = [s.pixels for s in batch if s.pixels is not None and s.n_tiles]
        pixels = np.concatenate(with_px, axis=0) if with_px else None
        return self._generate(batch, pixels, None)


def _batch_prefix(engine: Engine, cfg: VLMConfig, prompts, store: _PrefixStore,
                  min_len: int = 32, quantum: int = 32):
    """Opportunistic prefix caching for a batch: eval prompts share their
    system preamble + instruction header, so the longest common prefix of
    the batch, cut at the first image token (a prefix's KV cannot hold
    per-row image features) and rounded down to a `quantum` so
    near-identical batches reuse one prefix, is prefilled once per distinct
    content (`store`, keyed by token bytes) and seeded into every row
    (inference/engine.py::Prefix). Returns (prefix | None, suffix prompts)."""
    if len(prompts) < 2:
        return None, prompts
    a0 = prompts[0]
    m = min(len(p) for p in prompts) - 1    # every row keeps ≥1 suffix token
    for p in prompts[1:]:
        k = min(m, len(p))
        neq = np.nonzero(p[:k] != a0[:k])[0]
        if neq.size:
            m = min(m, int(neq[0]))
    img = np.nonzero(a0[:m] == cfg.image_token_id)[0]
    if img.size:
        m = min(m, int(img[0]))
    m = (m // quantum) * quantum
    if m < min_len:
        return None, prompts
    pre = store.get_or_build(a0[:m].tobytes(), lambda: engine.build_prefix(a0[:m]))
    return pre, [p[m:] for p in prompts]


class LeopardIdefics2EvalAdapter(_EvalAdapter):
    """Idefics2 path: NaViT padded preprocessing + perceiver latents, ≤ 8
    images (evaluations/models/idefics2_multiimg.py:22-70)."""

    def __init__(self, cfg: VLMConfig, model, tokenizer,
                 gen_cfg: Optional[GenerateConfig] = None, max_images: int = 8,
                 quantize: Optional[str] = None, quantize_kv: bool = False,
                 spec=None, prefix_caching: bool = False):
        eos = tokenizer.convert_tokens_to_ids("<end_of_utterance>")
        super().__init__(
            cfg, model, tokenizer,
            gen_cfg or GenerateConfig(
                max_new_tokens=128, greedy=True,
                eos_token_ids=tuple(t for t in (tokenizer.eos_token_id, eos) if t)),
            quantize, quantize_kv, spec, prefix_caching)
        self.max_images = max_images
        self._preprocess = preprocess_idefics2

    def prepare(self, row: dict, instruction: str) -> PreparedSample:
        from PIL import Image

        images = []
        for p in row["images_path"][: self.max_images]:
            with Image.open(p) as im:
                images.append(im.convert("RGB"))
        pixels = patch_mask = None
        if images:
            pixels, _, patch_mask = self._preprocess(images)
        text = f"User:{_question(row)}\n{instruction}<end_of_utterance>\nAssistant:"
        prompt = build_idefics2_prompt(
            self.tokenizer, text, len(images),
            image_seq_len=self.cfg.perceiver.num_latents if self.cfg.perceiver else 64,
            image_token_id=self.cfg.image_token_id,
            fake_token_id=self.cfg.image_token_id - 1,
        )
        return PreparedSample(
            prompt=np.asarray(prompt, np.int32), pixels=pixels,
            patch_mask=patch_mask,
        )

    def generate_prepared(self, batch: List[PreparedSample]) -> List[str]:
        """Batched NaViT inference. preprocess_idefics2 pads each sample only
        to its own largest image, so samples are padded again (zeros at the
        bottom and right, the patch mask extended with False) to the largest
        across the batch before concatenating: padding patches are masked
        out of attention and the perceiver, so logits are unchanged."""
        with_px = [
            (s.pixels, s.patch_mask)
            for s in batch if s.pixels is not None and s.n_tiles
        ]
        pixels = patch_mask = None
        if with_px:
            pixels, patch_mask = repad_navit(with_px)
        return self._generate(batch, pixels, patch_mask)


def repad_navit(samples):
    """[(pixels [n, 3, h, w], patch_mask [n, h/p, w/p])] → one (pixels,
    patch_mask) padded with zeros and False to the largest h and w."""
    hmax = max(p.shape[2] for p, _ in samples)
    wmax = max(p.shape[3] for p, _ in samples)

    def pad(p, m):
        n, _, h, w = p.shape
        pp = np.zeros((n, 3, hmax, wmax), p.dtype)
        pp[:, :, :h, :w] = p
        mm = np.zeros((n, hmax * m.shape[1] // h, wmax * m.shape[2] // w), m.dtype)
        mm[:, : m.shape[1], : m.shape[2]] = m
        return pp, mm

    padded = [pad(p, m) for p, m in samples]
    return (np.concatenate([p for p, _ in padded], axis=0),
            np.concatenate([m for _, m in padded], axis=0))
