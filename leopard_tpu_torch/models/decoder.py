"""Decoder-only LLM, Llama-3.1 family with a dense SwiGLU MLP (port of
leopard_tpu/models/decoder.py).

Matmuls run in the parameter dtype (bf16 on the card); norms, softmax and
logits are fp32. The KV cache keeps the JAX package's packed layout and its
invariant, slot == absolute position, but is updated IN PLACE: each layer
scatters its new tokens into the stacked buffer (the JAX package threads an
immutable cache through its layer scan instead).

Attention tiers (JAX decoder.py:482-504): a continuation step into a
non-empty cache (decode) is the dense masked sweep over the cache; a
sequence of at least `long_seq_threshold` tokens without a cache, or into a
fresh cache, takes the flash tier; shorter ones take dense. On a CUDA tensor
the flash tier is the Hopper kernel; on a CPU tensor it is the kernel's plain
version, which stands in for the JAX package's CPU chunked tier (the same
function). `attn_impl="dense"` and `"flash"` force a tier. Not in this slice
(they raise): MoE, tied embeddings, the chunked continuation tier; context
parallelism is not ported either.

Training (JAX decoder.py:435-634 with `return_hidden` and `remat`): packed
rows carry multi-valued segment ids and positions that restart in each
segment; the flash tier masks by segment (K1 forward, K2 backward through
autograd), and `remat="full"` recomputes each layer in the backward.
`return_hidden=True` returns the final-normed hidden states for the
trainer's chunked cross-entropy, which reads the live `lm_head`, never the
serving fp32 copy.

Quantized serving (JAX decoder.py:131-178, 302-322, 391-394): the seven
projections and `lm_head` go through `ops/quant.py::matmul`, so a weight that
`quantize_tree` replaced by a QuantizedWeight runs int8 or int4 (K4 at decode
on the card). An int8 KV cache stores each new token per head as int8 with an
f32 scale; cached decode then attends through `attention_quant_kv`, while a
fresh prefill still attends over its own bf16 k/v.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from leopard_tpu_torch.config import TextConfig
from leopard_tpu_torch.models.params import Params, new_param, torch_dtype
from leopard_tpu_torch.ops.attention import attention, attention_quant_kv, make_attention_mask
from leopard_tpu_torch.ops.flash_attention import TileRanges, flash_attention, tile_ranges
from leopard_tpu_torch.ops.norms import rms_norm
from leopard_tpu_torch.ops.quant import is_quantized, matmul
from leopard_tpu_torch.ops.remat import remat_wrap
from leopard_tpu_torch.ops.rotary import apply_rope, compute_inv_freq, rope_cos_sin


@dataclass
class KVCache:
    """KV cache with per-row write offsets, updated in place.

    kv: [L, B, S_max, 2·H_kv, D], K in heads [:H_kv] and V in [H_kv:];
    seg: [B, S_max] int32 segment id per slot (0 = empty or padding, never
    attended); index: [B] int32 count of valid tokens written per row.
    Prefill writes a right-padded block at offset 0 (pad slots get seg 0);
    each decode step writes a row's next token at that row's index.

    int8 mode: kv is int8 and kv_scale [L, B, S_max, 2·H_kv] f32 holds the
    per-token-per-head scales (K in [:H_kv], V in [H_kv:]), a separate buffer
    as in the JAX package.
    """

    kv: torch.Tensor
    seg: torch.Tensor
    index: torch.Tensor
    kv_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.kv.dtype == torch.int8

    @staticmethod
    def create(cfg: TextConfig, batch: int, max_len: int, *, device=None,
               quantized: bool = False) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, 2 * cfg.num_kv_heads, cfg.head_dim)
        dtype = torch.int8 if quantized else torch_dtype(cfg.dtype)
        return KVCache(
            kv=torch.zeros(shape, dtype=dtype, device=device),
            seg=torch.zeros((batch, max_len), dtype=torch.int32, device=device),
            index=torch.zeros((batch,), dtype=torch.int32, device=device),
            kv_scale=(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                      if quantized else None),
        )


def _q8(x: torch.Tensor):
    """Symmetric int8 over the last dim: (q int8 [..., D], s f32 [...])."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig, *, dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError("MoE layers are not in the port yet")
        h, f = cfg.hidden_size, cfg.intermediate_size
        qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.input_norm = new_param((h,), dtype, device)
        self.attn = Params({"wq": (qd, h), "wk": (kvd, h), "wv": (kvd, h),
                            "wo": (h, qd)}, **kw)
        self.post_attn_norm = new_param((h,), dtype, device)
        self.mlp = Params({"w_gate": (f, h), "w_up": (f, h), "w_down": (h, f)}, **kw)

    def forward(
        self,
        x: torch.Tensor,                       # [B, S, H]
        cfg: TextConfig,
        cos: torch.Tensor,
        sin: torch.Tensor,
        *,
        attn_impl: str,
        mask: Optional[torch.Tensor],
        segment_ids: Optional[torch.Tensor],
        ranges: Optional[TileRanges],          # the flash kernels' tiles to run
        cache: Optional[KVCache],
        layer_idx: int,
        slots: Optional[torch.Tensor],         # [B, S] cache slots of the new tokens
        fresh_cache: bool,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        a = self.attn
        hkv = cfg.num_kv_heads
        y = rms_norm(x, self.input_norm, cfg.rms_norm_eps)
        q = matmul(y, a.wq).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = matmul(y, a.wk).reshape(b, s, hkv, cfg.head_dim)
        v = matmul(y, a.wv).reshape(b, s, hkv, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        quant_kv = None  # (k int8, k scale, v int8, v scale) over the layer slice
        if cache is not None:
            # views: the scatters land in the cache
            layer_kv = cache.kv[layer_idx]
            rows = torch.arange(b, device=x.device)[:, None]
            packed = torch.cat([k, v], dim=2)
            if cache.quantized:
                layer_s = cache.kv_scale[layer_idx]
                layer_kv[rows, slots], layer_s[rows, slots] = _q8(packed)
                if not fresh_cache:
                    quant_kv = (layer_kv[:, :, :hkv], layer_s[:, :, :hkv],
                                layer_kv[:, :, hkv:], layer_s[:, :, hkv:])
            else:
                layer_kv[rows, slots] = packed.to(layer_kv.dtype)
                if not fresh_cache:
                    # a fresh cache holds only these tokens: attend over the
                    # local k/v; otherwise over the whole layer slice
                    k, v = layer_kv[:, :, :hkv], layer_kv[:, :, hkv:]

        if attn_impl == "flash":
            o = flash_attention(
                q, k, v, causal=True,
                q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
                sliding_window=cfg.sliding_window, ranges=ranges,
            )
        elif quant_kv is not None:
            o = attention_quant_kv(q, *quant_kv, mask=mask)
        else:
            o = attention(q, k, v, mask=mask)
        x = x + matmul(o.reshape(b, s, -1), a.wo)

        y = rms_norm(x, self.post_attn_norm, cfg.rms_norm_eps)
        m = self.mlp
        gated = F.silu(matmul(y, m.w_gate)) * matmul(y, m.w_up)
        return x + matmul(gated, m.w_down)


class Decoder(nn.Module):
    def __init__(self, cfg: TextConfig, device=None):
        super().__init__()
        if cfg.tie_word_embeddings:
            raise NotImplementedError("tied embeddings are not in the port yet")
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        h = cfg.hidden_size
        self.embed_tokens = new_param((cfg.vocab_size, h), dt, device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype=dt, device=device) for _ in range(cfg.num_layers)
        )
        self.final_norm = new_param((h,), dt, device)
        self.lm_head = new_param((cfg.vocab_size, h), dt, device)
        self._head_f32: Optional[torch.Tensor] = None
        self._inv_freq = torch.from_numpy(compute_inv_freq(cfg))  # moved on first use

    def _rope_inv_freq(self, device) -> torch.Tensor:
        """The inverse-frequency table on `device`, copied there once: a
        pageable host-to-device copy in every forward would stall the
        stream at each decode step."""
        if self._inv_freq.device != device:
            self._inv_freq = self._inv_freq.to(device)
        return self._inv_freq

    def keep_fp32_head(self) -> None:
        """Keep one fp32 copy of the unembedding, made once from the final
        weights. Logits are fp32 as in the JAX package, where the bf16 head
        is promoted inside the fp32 product; without the copy each call
        would cast the whole [vocab, hidden] table (2.1 GB at 8B) anew. A
        quantized head keeps no copy: it goes through quant.matmul. The copy
        serves only calls without autograd: a call that records gradients
        reads the live head."""
        if not is_quantized(self.lm_head):
            self._head_f32 = self.lm_head.detach().float()

    def _head(self):
        if is_quantized(self.lm_head):
            return self.lm_head
        if self._head_f32 is not None and not torch.is_grad_enabled():
            return self._head_f32
        return self.lm_head.float()

    def _attn_impl(self, s: int, cache: Optional[KVCache], fresh_cache: bool) -> str:
        cfg = self.cfg
        if cache is not None and not fresh_cache:
            if s >= cfg.long_seq_threshold:
                raise NotImplementedError(
                    "continuation prefill into a filled cache (the chunked "
                    "continuation tier) is not in the port yet"
                )
            return "dense"
        impl = cfg.attn_impl
        if impl == "auto":
            impl = "flash" if s >= cfg.long_seq_threshold else "dense"
        if impl not in ("flash", "dense"):
            raise NotImplementedError(f"attn_impl={impl!r} is not in the port yet")
        return impl

    def forward(
        self,
        tokens: Optional[torch.Tensor] = None,        # [B, S] int
        *,
        input_embeds: Optional[torch.Tensor] = None,  # [B, S, H] overrides tokens
        positions: Optional[torch.Tensor] = None,     # [B, S] int
        segment_ids: Optional[torch.Tensor] = None,   # [B, S]; 0 = padding
        cache: Optional[KVCache] = None,
        return_hidden: bool = False,
        remat=False,                                  # "none" | "full" (ops/remat.py)
        logits_indices: Optional[torch.Tensor] = None,  # [B]: only these positions
        fresh_cache: bool = False,
    ):
        """Returns (logits [B, S, V] fp32, or [B, 1, V] with logits_indices,
        and the cache, updated in place, or None); with `return_hidden`, the
        final-normed hidden states [B, S, H] in place of the logits.
        `fresh_cache=True` says the cache is just created and empty: the
        tokens are then the whole history, and attention runs over them
        through the uncached tiers while the cache is still written for
        decode. `positions` default to the slot order (training passes
        positions that restart in each packed segment); `remat` applies to
        the uncached layer loop only, as in the JAX package."""
        cfg = self.cfg
        x = self.embed_tokens[tokens] if input_embeds is None else input_embeds
        b, s, _ = x.shape
        dev = x.device
        if positions is None:
            base = cache.index[:, None] if cache is not None else 0
            positions = (base + torch.arange(s, device=dev)[None, :]).expand(b, s)
        cos, sin = rope_cos_sin(positions, self._rope_inv_freq(dev))
        attn_impl = self._attn_impl(s, cache, fresh_cache)

        slots = None
        if cache is not None:
            if segment_ids is None:
                segment_ids = torch.ones((b, s), dtype=torch.int32, device=dev)
            slots = cache.index[:, None].long() + torch.arange(s, device=dev)[None, :]
            rows = torch.arange(b, device=dev)[:, None]
            cache.seg[rows, slots] = segment_ids.to(torch.int32)

        mask = None
        if cache is not None and not fresh_cache:
            # slot == absolute position (see KVCache)
            kv_pos = torch.arange(cache.seg.shape[1], device=dev)[None, :]
            mask = (positions[:, :, None] >= kv_pos[:, None, :]) & (cache.seg != 0)[:, None, :]
            if cfg.sliding_window is not None:
                mask = mask & ((positions[:, :, None] - kv_pos[:, None, :]) < cfg.sliding_window)
            mask = (mask & (segment_ids != 0)[:, :, None])[:, None]
        elif attn_impl == "dense":
            mask = make_attention_mask(
                s, s, causal=True, q_segment_ids=segment_ids,
                kv_segment_ids=segment_ids, sliding_window=cfg.sliding_window,
                device=dev,
            )
        ranges = None
        if attn_impl == "flash":  # one set of tile ranges for every layer's K1 and K2
            ranges = tile_ranges(segment_ids, segment_ids, sq=s, skv=s, causal=True,
                                 window=cfg.sliding_window, device=dev)

        for i, layer in enumerate(self.layers):
            run = layer if cache is not None else remat_wrap(layer, remat)
            x = run(
                x, cfg, cos, sin, attn_impl=attn_impl, mask=mask,
                segment_ids=segment_ids, ranges=ranges, cache=cache, layer_idx=i,
                slots=slots, fresh_cache=fresh_cache,
            )
        if cache is not None:
            cache.index = cache.index + (segment_ids != 0).sum(dim=1, dtype=torch.int32)

        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        if return_hidden:
            return x, cache
        if logits_indices is not None:
            x = x.gather(1, logits_indices.long()[:, None, None].expand(b, 1, x.shape[-1]))
        # fp32 logits: an int4 head at M ≤ 64 on the card takes K4, which
        # rounds x to bf16 as the TPU kernel does
        return matmul(x.float(), self._head()), cache
