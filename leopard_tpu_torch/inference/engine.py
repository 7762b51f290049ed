"""Multi-image VLM inference engine: bucketed prefill, then KV-cache decode
(port of leopard_tpu/inference/engine.py).

Prompt lengths and tile counts are rounded up to buckets as in the JAX
engine. `generate` encodes the images, prefills a fresh cache in one pass
(flash tier at long prompts, decoder.py), then decodes greedily or by
sampling until every row has emitted eos or `max_new_tokens` is reached. The
decode loop runs eagerly in Python and checks for "all rows done" after each
step, where the JAX engine runs one `lax.while_loop`.

`quantize="int8"|"int4"` serves from a new model whose text decoder holds
quantized weights (ops/quant.py) and shares every other tensor with the
caller's model, which is left as it is; `quantize_kv=True` keeps the KV cache
in int8 (models/decoder.py).

Not in this slice (they raise): a device mesh, speculative decoding, shared
prefixes (`prefix`, `return_prefix`) and the chunked prefill of prompts above
the largest bucket. NaViT patch masks, `build_prefix` and `max_cache` are not
ported either.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from leopard_tpu_torch.config import GenerateConfig, VLMConfig
from leopard_tpu_torch.inference.sampling import sample
from leopard_tpu_torch.models.decoder import KVCache
from leopard_tpu_torch.models.vlm import LeopardVLM
from leopard_tpu_torch.ops.quant import quantize_tree


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _prefill(model: LeopardVLM, tokens, seg, cache: KVCache, image_features=None):
    """Prefill into a fresh cache. Returns the logits at each row's last
    valid position [B, V] and the cache (written in place). Unembedding runs
    only at those positions."""
    lengths = (seg != 0).sum(dim=1)
    logits, cache = model(
        tokens, image_features=image_features, segment_ids=seg, cache=cache,
        logits_indices=(lengths - 1).clamp(min=0), fresh_cache=True,
    )
    return logits[:, 0], cache


def _decode(model: LeopardVLM, gen_cfg: GenerateConfig, first_logits, prompt_tokens,
            prompt_seg, cache: KVCache, generator: torch.Generator, max_new_tokens: int):
    """Decode loop. Returns (gen_buf, gen_mask, lp_buf) [B, max_new_tokens]."""
    b = first_logits.shape[0]
    dev = first_logits.device
    eos = torch.tensor(gen_cfg.eos_token_ids, dtype=torch.int32, device=dev)
    gen_buf = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
    gen_mask = torch.zeros((b, max_new_tokens), dtype=torch.bool, device=dev)
    lp_buf = torch.zeros((b, max_new_tokens), dtype=torch.float32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    logits = first_logits
    for i in range(max_new_tokens):
        prev_tokens = prev_mask = None
        if gen_cfg.repetition_penalty != 1.0:
            prev_tokens = torch.cat([prompt_tokens, gen_buf], dim=1)
            prev_mask = torch.cat([prompt_seg != 0, gen_mask], dim=1)
        tok = sample(logits, generator, gen_cfg, prev_tokens, prev_mask)
        is_eos = (tok[:, None] == eos[None, :]).any(dim=1)
        tok = torch.where(done, eos[0], tok)
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = logp.gather(1, tok[:, None].long())[:, 0]
        gen_buf[:, i] = tok
        gen_mask[:, i] = ~done
        lp_buf[:, i] = torch.where(done, 0.0, tok_lp)
        step_seg = (~done).to(torch.int32)[:, None]  # eos itself is a valid slot
        done = done | is_eos
        # stop once every row is done: a batch ends at its longest answer
        if i + 1 == max_new_tokens or bool(done.all()):
            break
        step_logits, cache = model(tok[:, None], segment_ids=step_seg, cache=cache)
        logits = step_logits[:, 0]
    return gen_buf, gen_mask, lp_buf


@dataclasses.dataclass
class GenerationResult:
    tokens: List[np.ndarray]          # generated ids per row (trimmed at eos)
    prompt_lengths: List[int]
    logprobs: Optional[List[np.ndarray]] = None  # per-token logprob, same trim


class Engine:
    """Inference engine over a LeopardVLM, with shape bucketing."""

    def __init__(
        self,
        cfg: VLMConfig,
        model: LeopardVLM,
        gen_cfg: Optional[GenerateConfig] = None,
        seq_buckets: Sequence[int] = (256, 512, 1024, 2048, 4096, 8192, 16384),
        tile_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
        mesh=None,
        quantize: Optional[str] = None,
        quantize_kv: bool = False,
    ):
        if quantize not in (None, "int8", "int4"):
            raise ValueError(f"unknown quantize mode {quantize}")
        if mesh is not None:
            raise NotImplementedError("serving over a device mesh is not in the port yet")
        if quantize is not None:
            # a new model on the caller's tensors (no copy), then its text
            # weights replaced by quantized ones
            shared = LeopardVLM(cfg, device="meta")
            shared.load_state_dict(model.state_dict(), assign=True)
            quantize_tree(shared.text, mode=quantize)
            model = shared
        self.cfg = cfg
        self.model = model.eval()
        self.quantize_kv = quantize_kv
        self.device = model.text.embed_tokens.device
        model.text.keep_fp32_head()
        self.gen_cfg = gen_cfg or GenerateConfig()
        self.seq_buckets = sorted(seq_buckets)
        self.tile_buckets = sorted(tile_buckets)

    def _bucket(self, x: int, buckets: Sequence[int]) -> int:
        for bkt in buckets:
            if x <= bkt:
                return bkt
        return round_up(x, buckets[-1])

    @torch.inference_mode()
    def encode_images(self, pixel_values) -> torch.Tensor:
        """pixel_values: [N, 3, H, W] float or [N, H, W, 3] uint8, numpy or
        torch. Pads N up to a tile bucket; returns [NB, T, H] on the device
        (rows ≥ N are never gathered by the splice)."""
        x = torch.as_tensor(pixel_values)
        n = x.shape[0]
        nb = self._bucket(n, self.tile_buckets)
        if nb != n:
            x = torch.cat([x, x.new_zeros((nb - n,) + tuple(x.shape[1:]))], dim=0)
        return self.model.encode_images(x.to(self.device))

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[np.ndarray],
        images=None,                      # [N_tiles, ...], batch-ordered
        gen_cfg: Optional[GenerateConfig] = None,
        spec=None,
        prefix=None,
        return_prefix: bool = False,
    ) -> GenerationResult:
        if spec is not None:
            raise NotImplementedError("speculative decoding is not in the port yet")
        if prefix is not None or return_prefix:
            raise NotImplementedError("prefix caching is not in the port yet")
        gen_cfg = gen_cfg or self.gen_cfg
        b = len(prompts)
        lengths = [len(p) for p in prompts]
        s = self._bucket(max(lengths), self.seq_buckets)
        if s > self.seq_buckets[-1]:
            raise NotImplementedError(
                f"prompt of {max(lengths)} tokens is above the largest bucket "
                f"({self.seq_buckets[-1]}); chunked prefill is not in the port yet"
            )
        tokens = np.zeros((b, s), np.int32)
        seg = np.zeros((b, s), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = p
            seg[i, : len(p)] = 1
        tokens_t = torch.from_numpy(tokens).to(self.device)
        seg_t = torch.from_numpy(seg).to(self.device)
        # round to 512 rather than to the next bucket: a bucket-sized prompt
        # plus new tokens would otherwise nearly double the cache
        cache_len = round_up(s + gen_cfg.max_new_tokens, 512)
        cache = KVCache.create(self.cfg.text, b, cache_len, device=self.device,
                               quantized=self.quantize_kv)

        feats = None
        if images is not None and images.shape[0] > 0:
            feats = self.encode_images(images)
        first_logits, cache = _prefill(self.model, tokens_t, seg_t, cache, feats)
        generator = torch.Generator(device=self.device).manual_seed(gen_cfg.seed)
        gen_buf, gen_mask, lp_buf = _decode(
            self.model, gen_cfg, first_logits, tokens_t, seg_t, cache,
            generator, gen_cfg.max_new_tokens,
        )
        gen_buf, gen_mask, lp_buf = (t.cpu().numpy() for t in (gen_buf, gen_mask, lp_buf))
        out, out_lp = [], []
        for i in range(b):
            row = gen_buf[i][gen_mask[i]]
            lps = lp_buf[i][gen_mask[i]]
            stop = np.isin(row, np.asarray(gen_cfg.eos_token_ids))
            if stop.any():  # trim at the first eos
                n = int(np.argmax(stop))
                row, lps = row[:n], lps[:n]
            out.append(row)
            out_lp.append(lps)
        return GenerationResult(tokens=out, prompt_lengths=lengths, logprobs=out_lp)
