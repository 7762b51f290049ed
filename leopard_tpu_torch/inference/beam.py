"""Beam search for one prompt (port of leopard_tpu/inference/beam.py:27-140).

The prompt is prefilled once through the engine's prefill; its one-row
cache is then tiled across the beams (beam dim = batch dim), and every step
runs one forward of each beam's last token, keeps the best `beam_width`
continuations of all beams, and reorders the cache rows by the beams they
came from. A finished beam can continue only with eos[0], at no cost. The
final pick divides each beam's log-probability by its length to the power
`length_penalty`. The loop runs on the host in Python.

As in the JAX package the cache has bucket(prompt bucket + max_new_tokens)
slots in the model's dtype, whatever the engine's `quantize_kv`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from leopard_tpu_torch.inference.engine import _prefill
from leopard_tpu_torch.models.decoder import KVCache

NEG_INF = -1e30


def _reorder(cache: KVCache, rows: torch.Tensor) -> KVCache:
    """The cache with its batch rows taken in the order `rows` (a copy)."""
    return KVCache(kv=cache.kv[:, rows], seg=cache.seg[rows], index=cache.index[rows],
                   kv_scale=None if cache.kv_scale is None else cache.kv_scale[:, rows])


def _beam_decode(model, first_logits, cache: KVCache, beam_width: int, max_new_tokens: int,
                 length_penalty: float, eos_ids: Tuple[int, ...]):
    """Returns (the best beam's tokens [max_new_tokens] on the host, the
    position of its first eos or max_new_tokens)."""
    w = beam_width
    dev = first_logits.device
    v = first_logits.shape[-1]
    eos = torch.tensor(eos_ids, dtype=torch.int32, device=dev)
    cache = _reorder(cache, torch.zeros((w,), dtype=torch.long, device=dev))
    scores, top_tok = torch.topk(torch.log_softmax(first_logits[0].float(), dim=-1), w)
    top_tok = top_tok.to(torch.int32)
    done = (top_tok[:, None] == eos[None, :]).any(dim=1)
    tokens_buf = torch.zeros((w, max_new_tokens), dtype=torch.int32, device=dev)
    tokens_buf[:, 0] = top_tok
    frozen = torch.full((w, v), NEG_INF, device=dev)
    if -v <= eos_ids[0] < v:  # JAX's .at[].set drops an index outside the vocab
        frozen[:, eos_ids[0]] = 0.0
    for i in range(1, max_new_tokens):
        logits, cache = model(tokens_buf[:, i - 1: i],
                              segment_ids=(~done).to(torch.int32)[:, None], cache=cache)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1)
        logp = torch.where(done[:, None], frozen, logp)
        scores, flat_idx = torch.topk((scores[:, None] + logp).reshape(-1), w)
        beam_idx = flat_idx // v
        tok = (flat_idx % v).to(torch.int32)
        cache = _reorder(cache, beam_idx)
        tokens_buf = tokens_buf[beam_idx]
        tokens_buf[:, i] = tok
        done = done[beam_idx] | (tok[:, None] == eos[None, :]).any(dim=1)
    toks = tokens_buf.cpu().numpy()
    scores = scores.cpu().numpy()
    is_eos = np.isin(toks, np.asarray(eos_ids))
    first_eos = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1), max_new_tokens)
    final = scores / np.maximum(first_eos, 1).astype(np.float32) ** length_penalty
    best = int(np.argmax(final))
    return toks[best], int(first_eos[best])


@torch.inference_mode()
def beam_search(
    engine,
    prompt: np.ndarray,
    images: Optional[np.ndarray] = None,
    patch_mask: Optional[np.ndarray] = None,
    beam_width: int = 4,
    max_new_tokens: int = 128,
    length_penalty: float = 1.0,
    eos_ids: Tuple[int, ...] = (128001, 128009),
) -> np.ndarray:
    """Single-prompt beam search over an Engine's prefill. Returns the best
    token sequence, trimmed at eos."""
    tokens, seg, _, s = engine._pack([np.asarray(prompt, np.int32)])
    cache_len = engine._bucket(s + max_new_tokens, engine.seq_buckets)
    cache = KVCache.create(engine.cache_cfg, 1, cache_len, device=engine.device)
    first_logits, cache = _prefill(engine.model, engine._tensor(tokens), engine._tensor(seg),
                                   cache, engine._features(images, patch_mask), fresh=True)
    toks, n = _beam_decode(engine.model, first_logits, cache, int(beam_width),
                           int(max_new_tokens), float(length_penalty),
                           tuple(int(e) for e in eos_ids))
    return toks[:n]
