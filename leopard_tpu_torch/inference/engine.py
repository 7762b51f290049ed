"""Multi-image VLM inference engine: bucketed prefill, then KV-cache decode
(port of leopard_tpu/inference/engine.py).

Prompt lengths and tile counts are rounded up to buckets as in the JAX
engine. `generate` encodes the images, prefills the cache, then decodes
greedily or by sampling until every row has emitted eos or `max_new_tokens`
is reached. The decode loop runs eagerly in Python and checks for "all rows
done" after each step, where the JAX engine runs one `lax.while_loop`.

  - Prefill of a prompt within the largest bucket is one pass into a fresh
    cache (flash tier at long prompts, decoder.py). A longer prompt is
    prefilled in chunks of the largest bucket against the growing cache:
    the first chunk fresh, later ones through the continuation tiers, with
    per-row feature offsets for image tiles that straddle a chunk boundary.
  - Shared prefixes: `build_prefix` prefills a prompt once into a one-row
    cache; `generate(prefix=...)` copies it into every row (slot ==
    absolute position, so the suffix lands at the right positions) and
    prefills only the suffix, as a continuation. `return_prefix=True` hands
    the post-decode cache back as the next turn's prefix (multi-turn chat).
    The cache is written in place here, where the JAX engine donates a new
    one, so a prefix is always copied into a generate's cache, never
    aliased: it comes out of any number of calls unchanged.
  - `spec=SpecConfig(...)` decodes by prompt lookup (speculative.py);
    `beam.py` holds beam search over the same prefill.
  - Idefics2: `patch_mask` [N, H/p, W/p] marks each NaViT image's real
    patches (`data/idefics2_processor.py`); images that the tile bucket
    adds get all-zero masks, as in the JAX engine.

`quantize="int8"|"int4"` serves from a new model whose text decoder holds
quantized weights (ops/quant.py) and shares every other tensor with the
caller's model, which is left as it is; `quantize_kv=True` keeps the KV cache
in int8 (models/decoder.py). A tied decoder's head is `embed_tokens`, which
is not quantized, so it stays fp32, as in the JAX package; an MoE decoder is
refused with `quantize` (the JAX package cannot serve it either).

An MoE decoder serves like a dense one: its layers run on every position of
the padded bucket, so capacity-mode drops are those of the JAX engine at the
same buckets, and dropless dispatch reads its group sizes on the host once a
layer at every forward.

`mesh=` serves on any mesh, as JAX's engine does (JAX engine.py:199-223):
the model is placed by the rules over "model" and "expert"
(parallel/sharding.py::tp_local_model: each rank keeps its block of heads,
of the MLP and of the vocabulary, and its block of the expert banks; int8
payloads cut like their weights, int4 weights cut per rank, their
split-half rows repacked for the row-parallel ones), the KV cache holds
this rank's kv heads, and the logits are gathered whole for sampling, so
every rank of the model group emits the same tokens. The other axes shard
no serving work, as in JAX's engine, which never places the batch: ranks
along data, fsdp, seq and stage each serve the whole batch they are given
(the caller splits requests over them) on replicated tensors, the
embedding table's model block whole on every fsdp rank (JAX cuts its
vocabulary over model × fsdp; a lookup gives the same rows), the prefill
on the flash tier rather than the ring (JAX's cache prefill never takes
the ring). An MoE layer routes the batch it is given alone, with no
statistics summed over other ranks; at expert > 1 each expert rank runs
its own experts on the whole batch and the outputs are summed over the
expert group (ops/moe.py), the plain dispatch's positions and drops in
both modes. The MoE decoder and Leopard-Idefics2 serve so too, through
the forward that training under a mesh runs (the experts' F and the
perceiver's heads cut over "model"). A mesh whose model or expert axis
does not divide the heads or the experts is refused
(training/trainer.py::check_divisible).

Where the JAX engine clamps a cache write that falls outside a too-small
`max_cache`, this engine raises before it writes anything.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from leopard_tpu_torch.config import GenerateConfig, VLMConfig
from leopard_tpu_torch.inference.sampling import sample
from leopard_tpu_torch.inference.speculative import _spec_decode
from leopard_tpu_torch.models.decoder import KVCache
from leopard_tpu_torch.models.vlm import LeopardVLM
from leopard_tpu_torch.ops.quant import quantize_tree
from leopard_tpu_torch.utils.timers import span


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _prefill(model: LeopardVLM, tokens, seg, cache: KVCache, image_features=None,
             fresh: bool = False, feat_offsets=None):
    """Prefill into the cache (written in place). Returns the logits at each
    row's last valid position [B, V] and the cache. Unembedding runs only at
    those positions. `fresh=True`: the cache is just created and empty, so
    attention runs over these tokens through the uncached tiers;
    `feat_offsets` [B] maps this chunk's image tokens to their feature rows
    in a chunked prefill."""
    lengths = (seg != 0).sum(dim=1)
    logits, cache = model(
        tokens, image_features=image_features, segment_ids=seg, cache=cache,
        logits_indices=(lengths - 1).clamp(min=0), fresh_cache=fresh,
        feature_row_offsets=feat_offsets,
    )
    return logits[:, 0], cache


def _decode(model: LeopardVLM, gen_cfg: GenerateConfig, first_logits, prompt_tokens,
            prompt_seg, cache: KVCache, generator: torch.Generator, max_new_tokens: int,
            write_last: bool = False):
    """Decode loop. Returns (gen_buf, gen_mask, lp_buf) [B, max_new_tokens].
    Each emitted token's forward writes its KV; the forward of the last
    token (at `max_new_tokens`, or once every row is done) runs only with
    `write_last`, when the cache outlives the call (JAX engine.py:86-124
    runs it always)."""
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
        # a done row's token is masked out and its forward writes segment id
        # 0; it takes id 0, since eos[0] may lie outside the vocab (999999)
        tok = torch.where(done, 0, tok)
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = logp.gather(1, tok[:, None].long())[:, 0]
        gen_buf[:, i] = tok
        gen_mask[:, i] = ~done
        lp_buf[:, i] = torch.where(done, 0.0, tok_lp)
        step_seg = (~done).to(torch.int32)[:, None]  # eos itself is a valid slot
        done = done | is_eos
        # stop once every row is done: a batch ends at its longest answer
        last = i + 1 == max_new_tokens or bool(done.all())
        if last and not write_last:
            break
        step_logits, cache = model(tok[:, None], segment_ids=step_seg, cache=cache)
        logits = step_logits[:, 0]
        if last:
            break
    return gen_buf, gen_mask, lp_buf


@dataclasses.dataclass
class Prefix:
    """A prefilled, reusable prompt prefix (system prompt, shared document,
    an earlier conversation turn): a one-row cache whose slots [0, length)
    hold the prefix's KV (JAX engine.py:134-148)."""

    cache: KVCache        # batch-1 cache
    length: int           # real prefix tokens
    tokens: np.ndarray    # the prefix ids


def _seed_prefix(cache: KVCache, pre: KVCache, p_len: int, sp_keep: int) -> None:
    """Copy the first `sp_keep` slots of the one-row prefix cache into every
    row of `cache` and set each row's index to the prefix length (JAX
    engine.py:151-173). Slots in [p_len, sp_keep) carry seg 0 and are
    overwritten by the suffix prefill. Copies, so the prefix is never
    written by the generate that reads it."""
    if pre.quantized != cache.quantized:
        raise ValueError(
            f"the prefix's KV cache is {'int8' if pre.quantized else 'float'} but this "
            f"engine's is {'int8' if cache.quantized else 'float'} (quantize_kv differs)"
        )
    cache.kv[:, :, :sp_keep] = pre.kv[:, :1, :sp_keep]
    cache.seg[:, :sp_keep] = pre.seg[:1, :sp_keep]
    if cache.quantized:
        cache.kv_scale[:, :, :sp_keep] = pre.kv_scale[:, :1, :sp_keep]
    cache.index.fill_(p_len)


@dataclasses.dataclass
class GenerationResult:
    tokens: List[np.ndarray]          # generated ids per row (trimmed at eos)
    prompt_lengths: List[int]
    logprobs: Optional[List[np.ndarray]] = None  # per-token logprob, same trim
    # return_prefix=True: the post-decode KV as the next turn's Prefix
    prefix: Optional[Prefix] = None
    # speculative decode: verify forwards run (emitted tokens / spec_rounds
    # is the tokens gained per weight read)
    spec_rounds: Optional[int] = None


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
        if mesh is not None:  # serving needs only the heads and experts to divide
            from leopard_tpu_torch.training.trainer import check_divisible

            check_divisible(cfg, mesh)
        if quantize is not None and cfg.text.num_experts > 0:
            # the JAX quantize_tree would quantize the expert banks, which
            # its moe_layer reads as raw weights: neither package serves it
            raise NotImplementedError(
                "quantized serving of an MoE decoder: the expert weights would be "
                "quantized, and the MoE layer reads them unquantized")
        if quantize is not None:
            # a new model on the caller's tensors (no copy), then its text
            # weights replaced by quantized ones
            shared = LeopardVLM(cfg, device="meta")
            shared.load_state_dict(model.state_dict(), assign=True)
            quantize_tree(shared.text, mode=quantize)
            model = shared
        self.cache_cfg = cfg.text
        if mesh is not None:
            from leopard_tpu_torch.parallel.mesh import MODEL_AXIS, Parallel, axis_size, set_parallel
            from leopard_tpu_torch.parallel.sharding import tp_local_model

            tp = axis_size(mesh, MODEL_AXIS)
            # every rank serves the whole batch it is given: an MoE layer
            # routes it alone, with no statistics summed over data, fsdp or
            # seq, and its expert ranks each run their experts on all of it
            full = Parallel.of(mesh)
            par = Parallel(tp_group=full.tp_group, tp_size=full.tp_size, tp_rank=full.tp_rank,
                           ep_group=full.ep_group, ep_size=full.ep_size, ep_rank=full.ep_rank,
                           ep_replicated=True)
            model = set_parallel(tp_local_model(model, mesh), par)
            self.cache_cfg = dataclasses.replace(cfg.text, num_kv_heads=cfg.text.num_kv_heads // tp)
        self.mesh = mesh
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

    def _pack(self, prompts: Sequence[np.ndarray]):
        """Right-padded tokens and segment ids [B, bucket] (numpy), the
        prompt lengths and the bucket."""
        lengths = [len(p) for p in prompts]
        s = self._bucket(max(lengths), self.seq_buckets)
        with span("engine.pack", tokens=sum(lengths), slots=len(prompts) * s):
            tokens = np.zeros((len(prompts), s), np.int32)
            seg = np.zeros((len(prompts), s), np.int32)
            for i, p in enumerate(prompts):
                tokens[i, : len(p)] = p
                seg[i, : len(p)] = 1
        return tokens, seg, lengths, s

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _new_cache(self, batch: int, length: int) -> KVCache:
        with span("engine.cache"):
            return KVCache.create(self.cache_cfg, batch, length, device=self.device,
                                  quantized=self.quantize_kv)

    @torch.inference_mode()
    def encode_images(self, pixel_values, patch_mask=None) -> torch.Tensor:
        """pixel_values: [N, 3, H, W] float or [N, H, W, 3] uint8, numpy or
        torch; patch_mask [N, H/p, W/p] bool or None. Pads N up to a tile
        bucket with zero images (and all-zero masks); returns [NB, T, H] on
        the device (rows ≥ N are never gathered by the splice)."""
        n = pixel_values.shape[0]
        nb = self._bucket(n, self.tile_buckets)
        with span("engine.tiles", tiles=n, tile_slots=nb):

            def padded(t):
                t = torch.as_tensor(t)
                if nb != n:
                    t = torch.cat([t, t.new_zeros((nb - n,) + tuple(t.shape[1:]))], dim=0)
                return t.to(self.device)

            if patch_mask is not None:
                patch_mask = padded(torch.as_tensor(patch_mask, dtype=torch.bool))
            pixel_values = padded(pixel_values)
        return self.model.encode_images(pixel_values, patch_mask)

    def _features(self, images, patch_mask=None) -> Optional[torch.Tensor]:
        if images is None or images.shape[0] == 0:
            return None
        return self.encode_images(images, patch_mask)

    @torch.inference_mode()
    def build_prefix(self, prompt: np.ndarray, images=None, patch_mask=None) -> Prefix:
        """Prefill a shared prompt prefix once, for reuse across generate()
        calls; its images' features splice during this prefill and live in
        the KV like any other position (JAX engine.py:252-275)."""
        prompt = np.asarray(prompt, np.int32)
        tokens, seg, _, s = self._pack([prompt])
        cache = self._new_cache(1, round_up(s, 512))
        _, cache = _prefill(self.model, self._tensor(tokens), self._tensor(seg), cache,
                            self._features(images, patch_mask), fresh=True)
        return Prefix(cache=cache, length=len(prompt), tokens=prompt)

    def _prefill_packed(self, tokens, seg, lengths, images, patch_mask,
                        prefix: Optional[Prefix], cache_len: int):
        """Seed the prefix (if any) into a new cache of `cache_len` slots and
        prefill the packed prompts: in one pass within the largest bucket,
        else chunk by chunk (JAX engine.py:345-397). Returns (first-step
        logits [B, V], cache)."""
        b, s = tokens.shape
        cache = self._new_cache(b, cache_len)
        if prefix is not None:
            p_len = prefix.length
            sp_keep = min(round_up(p_len, 512), prefix.cache.kv.shape[2], cache_len)
            _seed_prefix(cache, prefix.cache, p_len, sp_keep)
        feats = self._features(images, patch_mask)
        chunk = self.seq_buckets[-1]
        if s <= chunk:
            # with a prefix the suffix is a continuation: it attends over the
            # seeded cache from positions that start at the prefix length
            return _prefill(self.model, self._tensor(tokens), self._tensor(seg), cache,
                            feats, fresh=prefix is None)
        # chunked prefill above the largest bucket: row r's image tokens of
        # chunk j take the feature rows after those of rows < r and of its
        # own earlier chunks
        img_cum = np.cumsum(tokens == self.cfg.image_token_id, axis=1)
        global_base = np.concatenate([[0], np.cumsum(img_cum[:, -1])[:-1]])
        final_chunk = (np.maximum(np.asarray(lengths), 1) - 1) // chunk
        first_logits = None
        for j in range(s // chunk):
            sl = slice(j * chunk, (j + 1) * chunk)
            offs = global_base + (img_cum[:, j * chunk - 1] if j else 0)
            logits_j, cache = _prefill(
                self.model, self._tensor(tokens[:, sl]), self._tensor(seg[:, sl]), cache,
                feats, fresh=j == 0 and prefix is None,
                feat_offsets=self._tensor(offs) if feats is not None else None,
            )
            # keep the logits from the chunk holding each row's last token;
            # rows that ended earlier write seg-0 slots in later chunks
            pick = self._tensor(final_chunk == j)[:, None]
            first_logits = logits_j if first_logits is None else torch.where(
                pick, logits_j, first_logits)
        return first_logits, cache

    @torch.inference_mode()
    def prefill(self, prompts: Sequence[np.ndarray], images=None, patch_mask=None,
                prefix: Optional[Prefix] = None):
        """The prefill of `generate` alone: the first-step logits [B, V] fp32
        and the filled cache, of round_up(prefix + bucket, 512) slots."""
        tokens, seg, lengths, s = self._pack(prompts)
        p_len = prefix.length if prefix is not None else 0
        return self._prefill_packed(tokens, seg, lengths, images, patch_mask, prefix,
                                    round_up(p_len + s, 512))

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[np.ndarray],
        images=None,                      # [N_tiles, ...], batch-ordered
        patch_mask=None,                  # [N_tiles, H/p, W/p] bool (Idefics2)
        gen_cfg: Optional[GenerateConfig] = None,
        max_cache: Optional[int] = None,
        spec=None,                        # SpecConfig: speculative decode
        prefix: Optional[Prefix] = None,  # a shared prefilled prefix
        return_prefix: bool = False,      # one row: the post-decode KV as
        #                                   the next turn's prefix
    ) -> GenerationResult:
        gen_cfg = gen_cfg or self.gen_cfg
        # what the JAX engine refuses (engine.py:290-308)
        if return_prefix and (len(prompts) != 1 or spec is not None):
            raise ValueError("return_prefix is for single-row conversations without "
                             "speculative decoding")
        if spec is not None and not (gen_cfg.greedy and gen_cfg.repetition_penalty == 1.0):
            raise ValueError("speculative decoding is greedy-only (inference/speculative.py)")
        if prefix is not None and spec is not None:
            raise ValueError("prefix caching + speculative decode not supported (the n-gram "
                             "history buffer would need the prefix tokens)")
        if prefix is not None and gen_cfg.repetition_penalty != 1.0:
            raise ValueError("repetition_penalty scans only the suffix tokens; with a prefix "
                             "the penalty would silently ignore prefix tokens")
        b = len(prompts)
        max_new = gen_cfg.max_new_tokens
        tokens, seg, lengths, s = self._pack(prompts)
        # round to 512 rather than to the next bucket: a bucket-sized prompt
        # plus new tokens would otherwise nearly double the cache. A verify
        # block of speculative decode writes draft + 1 slots from the last
        # token, hence the headroom (JAX engine.py:318-344)
        spec_pad = spec.draft if spec is not None else 0
        p_len = prefix.length if prefix is not None else 0
        need = p_len + s + max_new + spec_pad
        cache_len = max_cache or round_up(need, 512)
        if cache_len < need:
            # checked before any write, where the JAX engine clamps the
            # writes into live slots: an index store outside the cache would
            # raise a device-side assert on the card
            raise ValueError(
                f"max_cache {cache_len} < prefix {p_len} + bucket {s} + max_new {max_new}"
                + (f" + {spec_pad}, the verify-block headroom of speculative decode"
                   if spec_pad else ""))
        first_logits, cache = self._prefill_packed(tokens, seg, lengths, images, patch_mask,
                                                   prefix, cache_len)
        spec_rounds = None
        if spec is not None:
            # history buffer for the n-gram lookup: the prompt, then the
            # generated tokens appended per row
            hist0 = np.zeros((b, s + max_new), np.int32)
            hist0[:, :s] = tokens
            gen_buf, gen_mask, lp_buf, spec_rounds = _spec_decode(
                self.model, gen_cfg, first_logits, self._tensor(hist0),
                self._tensor(np.asarray(lengths, np.int32)), cache, max_new,
                spec.ngram, spec.draft,
            )
        else:
            generator = torch.Generator(device=self.device).manual_seed(gen_cfg.seed)
            gen_buf, gen_mask, lp_buf = _decode(
                self.model, gen_cfg, first_logits, self._tensor(tokens), self._tensor(seg),
                cache, generator, max_new, write_last=return_prefix,
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
        new_prefix = None
        if return_prefix:
            # the cache holds prefix + prompt + every emitted token's KV, the
            # eos included (a valid turn-end position)
            emitted = gen_buf[0][gen_mask[0]]
            p_tokens = prefix.tokens if prefix is not None else np.zeros((0,), np.int32)
            new_prefix = Prefix(
                cache=cache, length=int(p_len + lengths[0] + emitted.size),
                tokens=np.concatenate([p_tokens, np.asarray(prompts[0], np.int32), emitted]),
            )
        return GenerationResult(tokens=out, prompt_lengths=lengths, logprobs=out_lp,
                                prefix=new_prefix, spec_rounds=spec_rounds)
