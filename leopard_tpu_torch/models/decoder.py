"""Decoder-only LLM, Llama-3.1 family with a dense SwiGLU MLP (port of
leopard_tpu/models/decoder.py).

Matmuls run in the parameter dtype (bf16 on the card); norms, softmax and
logits are fp32. The KV cache keeps the JAX package's packed layout and its
invariant, slot == absolute position, but is updated IN PLACE: each layer
scatters its new tokens into the stacked buffer (the JAX package threads an
immutable cache through its layer scan instead).

Attention tiers (JAX decoder.py:482-504): a continuation into a non-empty
cache of fewer than `long_seq_threshold` tokens (a decode step, a verify
block, a short suffix) is the dense masked sweep over the cache; a longer
one (a second turn, a later chunk of a chunked prefill) takes the chunked
continuation tier, `ops/chunked_attention.py`, which holds the scores of
one kv chunk at a time. A sequence of at least `long_seq_threshold` tokens
without a cache, or into a fresh cache, takes the flash tier; shorter ones
take dense. On a CUDA tensor the flash tier is the Hopper kernel; on a CPU
tensor it is the kernel's plain version, which stands in for the JAX
package's CPU chunked tier (the same function). `attn_impl="dense"`,
`"flash"` and `"chunked"` force a tier for uncached and fresh-cache calls:
"chunked" is the JAX package's blockwise tier (JAX decoder.py:324-331,
`ops/chunked_attention.py::chunked_attention`), kv chunks of
`pick_chunk(S, attn_chunk_size)` with each chunk recomputed in the
backward, plain PyTorch on every device, which bounds the scores held at
once by the chunk.

Parallelism (parallel/): the modules hold this rank's shards and read the
groups of `self.par` (parallel/mesh.py::Parallel, None without a mesh).
Under tensor parallelism the projections are column- and row-parallel and
the embedding and head vocab-parallel (parallel/tensor_parallel.py); the
local head counts come from the weights' shapes. `attn_impl="ring"` (JAX
decoder.py:348-358, 581-599) is context parallelism over the seq group:
the forward takes the whole sequence, permutes it once into the ring's
layout (zig-zag where it applies) and keeps this rank's shard for the whole
layer stack; every layer's attention is `parallel/context_parallel.py::
ring_attention`. Hidden states come back as that shard
(`return_hidden`), logits gathered back into the natural order. A call
with a cache takes "auto" in place of "ring", as in the JAX package.

MoE (JAX decoder.py:407-431, 543-611): with `num_experts > 0` every layer's
MLP is a routed expert bank, `ops/moe.py`, whose parameters are `router.w`
[E, H] (fp32 at init) and `experts.w_gate`, `experts.w_up` [E, F, H] and
`experts.w_down` [E, H, F], the port's [out, in] layout per expert.
`forward(..., return_aux=True)` also returns {aux_loss, z_loss,
fraction_dropped}: the losses summed over layers, the dropped share the
worst layer's. Calls with a cache run the same layers and drop their aux
values, as the JAX package does. Under a mesh the layer holds this rank's
expert shards (the expert axis, then the model axis of F) and routes
through the expert-parallel dispatch; its aux and z losses are then this
rank's terms of the global ones (ops/moe.py).

Tied embeddings (`tie_word_embeddings`): there is no `lm_head`; logits are
the fp32 hidden states times the fp32 `embed_tokens` transposed (JAX
decoder.py:626-627), and `keep_fp32_head` copies `embed_tokens`.

Training (JAX decoder.py:435-634 with `return_hidden` and `remat`): packed
rows carry multi-valued segment ids and positions that restart in each
segment; the flash tier masks by segment (K1 forward, K2 backward through
autograd). `remat` recomputes each layer in the backward: "full" all of it,
"attn" all but the attention output (K1's out and lse, or the dense tier's
tagged output), "selective" all but that and the matmul outputs
(ops/remat.py).
`return_hidden=True` returns the final-normed hidden states for the
trainer's chunked cross-entropy, which reads the live unembedding
(`unembedding`: `lm_head`, or `embed_tokens` when tied), never the serving
fp32 copy.

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
from leopard_tpu_torch.ops.chunked_attention import (
    chunked_attention, chunked_continuation_attention, pick_chunk,
)
from leopard_tpu_torch.ops.flash_attention import TileRanges, flash_attention, tile_ranges
from leopard_tpu_torch.ops.moe import MoEConfig, moe_layer
from leopard_tpu_torch.ops.norms import rms_norm
from leopard_tpu_torch.ops.quant import is_quantized, matmul
from leopard_tpu_torch.ops.remat import remat_wrap, tag_attn_out
from leopard_tpu_torch.ops.rotary import apply_rope, compute_inv_freq, rope_cos_sin
from leopard_tpu_torch.parallel.context_parallel import (
    gather_sequence, local_positions, pick_layout, ring_attention,
)
from leopard_tpu_torch.parallel.tensor_parallel import (
    copy_to_tp, gather_from_tp, reduce_from_tp, vocab_parallel_embedding,
)
from leopard_tpu_torch.utils.timers import span


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


def _head_version(t: torch.Tensor):
    """What identifies a head's current values: its storage, shape, dtype and
    version counter (which every in-place op advances; an inference tensor
    has none, and is keyed by its storage alone)."""
    version = None if t.is_inference() else t._version
    return t.data_ptr(), tuple(t.shape), t.dtype, version


def moe_config(cfg: TextConfig) -> MoEConfig:
    return MoEConfig(num_experts=cfg.num_experts, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity_factor, dropless=cfg.moe_dropless,
                     aux_loss_coef=cfg.moe_aux_loss_coef, z_loss_coef=cfg.moe_z_loss_coef,
                     ep_capacity_factor=cfg.moe_ep_capacity_factor,
                     ep_ragged_a2a=cfg.moe_ep_ragged_a2a)


class DecoderLayer(nn.Module):
    """One pre-norm block: attention, then the SwiGLU MLP or, with
    `num_experts > 0`, the expert bank. A dense layer returns x; an MoE
    layer returns (x, its aux values)."""

    par = None  # parallel/mesh.py::Parallel, set by set_parallel

    def __init__(self, cfg: TextConfig, *, dtype: torch.dtype, device=None):
        super().__init__()
        h, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
        qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.input_norm = new_param((h,), dtype, device)
        self.attn = Params({"wq": (qd, h), "wk": (kvd, h), "wv": (kvd, h),
                            "wo": (h, qd)}, **kw)
        self.post_attn_norm = new_param((h,), dtype, device)
        self.moe = moe_config(cfg) if e > 0 else None
        if self.moe is None:
            self.mlp = Params({"w_gate": (f, h), "w_up": (f, h), "w_down": (h, f)}, **kw)
        else:
            self.router = Params({"w": (e, h)}, dtype=torch.float32, device=device)
            self.experts = Params({"w_gate": (e, f, h), "w_up": (e, f, h),
                                   "w_down": (e, h, f)}, **kw)

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
        positions: Optional[torch.Tensor] = None,  # [B, S] (chunked_cont)
        ring_layout: Optional[str] = None,     # "ring": the layout of the shard
    ) -> torch.Tensor:
        b, s, _ = x.shape
        a = self.attn
        par = self.par
        y = copy_to_tp(rms_norm(x, self.input_norm, cfg.rms_norm_eps), par)
        # this rank's heads (all of them without tensor parallelism)
        q = matmul(y, a.wq).reshape(b, s, -1, cfg.head_dim)
        k = matmul(y, a.wk).reshape(b, s, -1, cfg.head_dim)
        v = matmul(y, a.wv).reshape(b, s, -1, cfg.head_dim)
        hkv = k.shape[2]
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
        elif attn_impl == "ring":
            o = ring_attention(q, k, v, par, causal=True, segment_ids=segment_ids,
                               sliding_window=cfg.sliding_window, layout=ring_layout)
        elif attn_impl == "chunked":  # saved under "attn"/"selective", as the dense output
            o = tag_attn_out(chunked_attention(
                q, k, v, causal=True, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
                sliding_window=cfg.sliding_window, chunk_size=pick_chunk(s, cfg.attn_chunk_size)))
        elif attn_impl == "chunked_cont":
            # the layer's cache slice after this call's writes (JAX decoder.py:373-390)
            ck, ck_s, cv, cv_s = quant_kv if quant_kv is not None else (k, None, v, None)
            o = chunked_continuation_attention(
                q, ck, cv, cache.seg, positions, k_scale=ck_s, v_scale=cv_s,
                sliding_window=cfg.sliding_window,
                chunk_size=pick_chunk(ck.shape[1], cfg.attn_chunk_size),
            )
        elif quant_kv is not None:
            o = attention_quant_kv(q, *quant_kv, mask=mask)
        else:
            o = tag_attn_out(attention(q, k, v, mask=mask))  # saved under "attn"/"selective"
        x = x + reduce_from_tp(matmul(o.reshape(b, s, -1), a.wo), par)

        y = rms_norm(x, self.post_attn_norm, cfg.rms_norm_eps)
        if self.moe is not None:
            # this rank's expert shards; the layer sums over the model and
            # expert groups itself (ops/moe.py)
            ex = self.experts
            out, aux = moe_layer(self.router.w, {"w_gate": ex.w_gate, "w_up": ex.w_up,
                                                 "w_down": ex.w_down}, self.moe, y, par=par)
            return x + out, aux
        y = copy_to_tp(y, par)
        m = self.mlp
        gated = F.silu(matmul(y, m.w_gate)) * matmul(y, m.w_up)
        return x + reduce_from_tp(matmul(gated, m.w_down), par)


class Decoder(nn.Module):
    par = None  # parallel/mesh.py::Parallel, set by set_parallel

    def __init__(self, cfg: TextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        h = cfg.hidden_size
        self.embed_tokens = new_param((cfg.vocab_size, h), dt, device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype=dt, device=device) for _ in range(cfg.num_layers)
        )
        self.final_norm = new_param((h,), dt, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = new_param((cfg.vocab_size, h), dt, device)
        self._head_f32: Optional[torch.Tensor] = None
        self._head_key = None  # what the copy was made from (`_head_version`)
        self._inv_freq = torch.from_numpy(compute_inv_freq(cfg))  # moved on first use

    def _rope_inv_freq(self, device) -> torch.Tensor:
        """The inverse-frequency table on `device`, copied there once: a
        pageable host-to-device copy in every forward would stall the
        stream at each decode step."""
        if self._inv_freq.device != device:
            self._inv_freq = self._inv_freq.to(device)
        return self._inv_freq

    @property
    def unembedding(self):
        """The live unembedding [vocab, hidden]: `lm_head`, or `embed_tokens`
        when tied (a quantized head is a QuantizedWeight)."""
        return self.embed_tokens if self.cfg.tie_word_embeddings else self.lm_head

    def keep_fp32_head(self) -> None:
        """Keep one fp32 copy of the unembedding. Logits are fp32 as in the
        JAX package, where the bf16 head is promoted inside the fp32
        product; without the copy each call would cast the whole [vocab,
        hidden] table (2.1 GB at 8B) anew. A quantized head keeps no copy:
        it goes through quant.matmul. The copy serves only calls without
        autograd (a call that records gradients reads the live head), and it
        follows the live head: `_head` makes it again when the head's
        storage or version counter has moved since it was made (an in-place
        update, as a train step's `cast_for_compute` makes, or a new
        tensor), so logits never mix an updated body with a stale head. One
        copy is kept, never one a call."""
        if not is_quantized(self.unembedding):
            self._head_f32, self._head_key = self._copy_head()

    def _copy_head(self):
        head = self.unembedding
        with torch.inference_mode(False):  # a normal tensor, whatever mode the caller is in
            return head.detach().float(), _head_version(head)

    def _head(self):
        head = self.unembedding
        if is_quantized(head):
            return head
        if self._head_f32 is not None and not torch.is_grad_enabled():
            if self._head_key != _head_version(head):
                self._head_f32, self._head_key = None, None  # free the stale 2.1 GB first
                self._head_f32, self._head_key = self._copy_head()
            return self._head_f32
        return head.float()

    def _attn_impl(self, s: int, cache: Optional[KVCache], fresh_cache: bool) -> str:
        cfg = self.cfg
        if cache is not None and not fresh_cache:
            return "chunked_cont" if s >= cfg.long_seq_threshold else "dense"
        impl = cfg.attn_impl
        if impl == "ring" and cache is not None:
            impl = "auto"  # CP rings don't apply to cached prefill (JAX decoder.py:497)
        if impl == "auto":
            impl = "flash" if s >= cfg.long_seq_threshold else "dense"
        if impl == "ring" and self.par is None:
            raise ValueError("attn_impl='ring' needs a seq group: a model under a mesh "
                             "(make_train_step(mesh=...), parallel/mesh.py::set_parallel)")
        if impl not in ("flash", "dense", "ring", "chunked"):
            raise ValueError(f"attn_impl={impl!r} is none of auto, flash, dense, chunked, ring")
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
        remat=False,                                  # "none" | "full" | "attn" | "selective"
        logits_indices: Optional[torch.Tensor] = None,  # [B]: only these positions
        fresh_cache: bool = False,
        return_aux: bool = False,                     # also the MoE aux values
    ):
        """Returns (logits [B, S, V] fp32, or [B, 1, V] with logits_indices,
        and the cache, updated in place, or None); with `return_hidden`, the
        final-normed hidden states [B, S, H] in place of the logits; with
        `return_aux`, a third item {aux_loss, z_loss, fraction_dropped}
        (zeros without experts or with a cache).
        `fresh_cache=True` says the cache is just created and empty: the
        tokens are then the whole history, and attention runs over them
        through the uncached tiers while the cache is still written for
        decode. `positions` default to the slot order (training passes
        positions that restart in each packed segment); `remat` applies to
        the uncached layer loop only, as in the JAX package."""
        cfg = self.cfg
        par = self.par
        if input_embeds is not None:
            x = input_embeds
        elif par is not None:
            x = vocab_parallel_embedding(tokens, self.embed_tokens, par, cfg.vocab_size)
        else:
            x = self.embed_tokens[tokens]
        with span("model.decoder"):
            b, s, _ = x.shape
            dev = x.device
            if positions is None:
                base = cache.index[:, None] if cache is not None else 0
                positions = (base + torch.arange(s, device=dev)[None, :]).expand(b, s)
            attn_impl = self._attn_impl(s, cache, fresh_cache)
            ring_layout = None
            if attn_impl == "ring":  # this rank's shard, in the ring's layout, for every layer
                ring_layout = pick_layout(s, par.cp_size)
                idx = local_positions(s, par.cp_size, par.cp_rank, ring_layout).to(dev)
                x, positions = x[:, idx], positions[:, idx]
                if segment_ids is not None:
                    segment_ids = segment_ids[:, idx]
                s = x.shape[1]
            cos, sin = rope_cos_sin(positions, self._rope_inv_freq(dev))

            slots = None
            if cache is not None:
                if segment_ids is None:
                    segment_ids = torch.ones((b, s), dtype=torch.int32, device=dev)
                slots = cache.index[:, None].long() + torch.arange(s, device=dev)[None, :]
                rows = torch.arange(b, device=dev)[:, None]
                cache.seg[rows, slots] = segment_ids.to(torch.int32)

            mask = None  # chunked_cont masks each kv chunk from the positions and the seg
            if attn_impl == "dense" and cache is not None and not fresh_cache:
                # slot == absolute position (see KVCache)
                kv_pos = torch.arange(cache.seg.shape[1], device=dev)[None, :]
                mask = (positions[:, :, None] >= kv_pos[:, None, :]) & (cache.seg != 0)[:, None, :]
                if cfg.sliding_window is not None:
                    mask = mask & ((positions[:, :, None] - kv_pos[:, None, :])
                                   < cfg.sliding_window)
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

            aux = None  # the MoE aux values, summed (losses) and maxed over layers
            for i, layer in enumerate(self.layers):
                run = layer if cache is not None else remat_wrap(layer, remat)
                x = run(
                    x, cfg, cos, sin, attn_impl=attn_impl, mask=mask,
                    segment_ids=segment_ids, ranges=ranges, cache=cache, layer_idx=i,
                    slots=slots, fresh_cache=fresh_cache, positions=positions,
                    ring_layout=ring_layout,
                )
                if layer.moe is not None:
                    x, layer_aux = x
                    if cache is None and return_aux:
                        aux = layer_aux if aux is None else {
                            "aux_loss": aux["aux_loss"] + layer_aux["aux_loss"],
                            "z_loss": aux["z_loss"] + layer_aux["z_loss"],
                            "fraction_dropped": torch.maximum(aux["fraction_dropped"],
                                                              layer_aux["fraction_dropped"])}
            if return_aux and aux is None:
                zero = torch.zeros((), dtype=torch.float32, device=dev)
                aux = {"aux_loss": zero, "z_loss": zero, "fraction_dropped": zero}
            if cache is not None:
                cache.index = cache.index + (segment_ids != 0).sum(dim=1, dtype=torch.int32)

        with span("model.head"):
            x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
            if not return_hidden:
                if logits_indices is not None:
                    x = x.gather(1, logits_indices.long()[:, None, None].expand(b, 1, x.shape[-1]))
                # fp32 logits: an int4 head at M ≤ 64 on the card takes K4, which
                # rounds x to bf16 as the TPU kernel does
                x = gather_from_tp(matmul(copy_to_tp(x.float(), par), self._head()), par,
                                   cfg.vocab_size)
                if ring_layout is not None:
                    x = gather_sequence(x, par, ring_layout)
        return (x, cache, aux) if return_aux else (x, cache)
