"""Continuous batching: a fixed pool of decode slots refilled from the queue
(port of leopard_tpu/inference/continuous.py).

Static batching (one `Engine.generate` per batch) runs every row until the
longest one ends, so short answers wait for long ones. Here a fixed number of
decode slots stays busy:
  - decode runs in segments of `segment_steps` steps over all slots at once;
    done and empty slots run the forward too, writing segment id 0;
  - between segments, finished rows are harvested on the host and refilled
    from a staging pool of requests prefilled ahead, each row copied from its
    staged cache into the pool's cache;
  - each request's own `max_new_tokens` is honored.

Where the JAX engine donates a new state to every jitted call, the port
writes the pool's cache and state in place:
  - a staged block's cache stays alive, and is only read, until its last row
    is installed (an install copies that row's kv, seg, index and kv_scale);
  - the decoder rebinds `cache.index` after each forward, so the pool holds
    the KVCache object, never a view of its index;
  - a segment makes no host sync: tokens, done flags, counters and budgets
    stay on the device for all its steps.

The boundary between segments is pipelined as in the JAX engine: snapshot
the host-visible state (a device clone, copied to pinned host buffers
without blocking, behind an event), dispatch the next segment, stage
prefills, and only then wait on the snapshot's event, which does not wait
for the segment. Rows whose budget runs out during a segment are known to
the host and refill at once, their output row captured first; rows that end
early at eos show only in the snapshot and refill one segment late. Tokens
do not depend on this timing; `stats` does.

Faults of the JAX engine that the port does not copy:
  - its admission guard counts the prompt's length, but a prefill writes a
    whole bucket from slot p_len, so with a prefix the write can run past
    the cache; here a request with p_len + bucket > cache_len is refused
    before anything is written;
  - an index store past the cache is a device-side assert on the card (JAX
    clamps it). Done rows write at their index; the only row that can sit at
    index == cache_len (a prompt that fills the cache, with budget 0) is
    installed with its index clamped to the last slot.

repetition_penalty must be 1.0: the penalty needs every row's whole history
under one shape, which slots refilled at different times do not have
(`Engine.generate` supports it).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from leopard_tpu_torch.config import GenerateConfig
from leopard_tpu_torch.inference.engine import Engine, Prefix, _prefill, _seed_prefix, round_up
from leopard_tpu_torch.inference.sampling import sample
from leopard_tpu_torch.models.decoder import KVCache


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                      # int32 [S]
    max_new_tokens: int
    images: Optional[np.ndarray] = None     # this row's tiles: [N, 3, H, W] float
    #                                         or [N, H, W, 3] uint8
    patch_mask: Optional[np.ndarray] = None  # [N, H/p, W/p] bool (Idefics2)


@dataclasses.dataclass
class Completion:
    tokens: np.ndarray                      # generated ids, trimmed at eos
    prompt_length: int


@dataclasses.dataclass
class _Slots:
    """The slot pool's decode state on the device, written in place."""

    cache: KVCache
    logits: torch.Tensor     # [b, V] f32, the next step's logits
    done: torch.Tensor       # [b] bool; empty slots are done
    n_gen: torch.Tensor      # [b] int32 tokens recorded
    budget: torch.Tensor     # [b] int32
    gen_buf: torch.Tensor    # [b, max_new_cap] int32
    gen_mask: torch.Tensor   # [b, max_new_cap] bool


def _install(s: _Slots, cache: KVCache, logits: torch.Tensor, j: int, row: int,
             budget: int, cache_len: int) -> None:
    """Install row `j` of a staged prefill into slot `row`: its KV row, first
    logits, cleared counters and buffers, and its budget; a zero budget is
    born done. The staged cache is only read."""
    s.cache.kv[:, row] = cache.kv[:, j]
    s.cache.seg[row] = cache.seg[j]
    if cache.kv_scale is not None:
        s.cache.kv_scale[:, row] = cache.kv_scale[:, j]
    # a done row's segment-0 writes land at its index, which must be a slot
    s.cache.index[row] = cache.index[j].clamp(max=cache_len - 1)
    s.logits[row] = logits[j]
    s.done[row] = budget <= 0
    s.n_gen[row] = 0
    s.budget[row] = budget
    s.gen_buf[row] = 0
    s.gen_mask[row] = False


def _to_host(tensors):
    """Copies of `tensors` as they stand at this point of the stream, and an
    event to wait on before reading them (None on the CPU, where the copies
    are done on return). On the card the tensors are cloned, then copied to
    pinned host buffers without blocking the host."""
    snap = [t.clone() for t in tensors]
    if snap[0].device.type != "cuda":
        return snap, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in snap]
    for h, t in zip(host, snap):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _decode_segment(model, s: _Slots, gen_cfg: GenerateConfig, eos: torch.Tensor,
                    generator: torch.Generator, steps: int) -> None:
    """`steps` decode steps for every slot, with no host sync. A row past its
    budget or eos stops recording and writes segment id 0 at its index."""
    positions = torch.arange(s.gen_buf.shape[1], device=eos.device)[None, :]
    for _ in range(steps):
        tok = sample(s.logits, generator, gen_cfg)
        is_eos = (tok[:, None] == eos[None, :]).any(dim=1)
        # a done row records nothing and writes segment id 0; it takes id 0,
        # since eos[0] may lie outside the vocab
        tok = torch.where(s.done, 0, tok)
        at = (positions == s.n_gen[:, None]) & ~s.done[:, None]
        s.gen_buf = torch.where(at, tok[:, None], s.gen_buf)
        s.gen_mask |= at
        s.n_gen += (~s.done).to(torch.int32)
        s.done |= is_eos | (s.n_gen >= s.budget)
        logits, _ = model(tok[:, None], segment_ids=(~s.done).to(torch.int32)[:, None],
                          cache=s.cache)
        s.logits = logits[:, 0]


class ContinuousEngine:
    """Fixed-slot continuous-batching server over an Engine's model."""

    def __init__(self, engine: Engine, slots: int = 8, cache_len: int = 2048,
                 max_new_cap: int = 512, segment_steps: int = 16):
        self.engine = engine
        self.slots = slots
        self.cache_len = round_up(cache_len, 512)
        self.max_new_cap = max_new_cap
        self.segment_steps = segment_steps
        self.stats: dict = {}

    def _fresh_cache(self, rows: int, prefix: Optional[Prefix]):
        """A `rows`-row cache of cache_len slots, seeded with the shared
        prefix when there is one (the prompt then prefills as a
        continuation); and whether it is fresh."""
        cache = self.engine._new_cache(rows, self.cache_len)
        if prefix is None:
            return cache, True
        p_len = prefix.length
        _seed_prefix(cache, prefix.cache, p_len,
                     min(round_up(p_len, 512), prefix.cache.kv.shape[2], self.cache_len))
        return cache, False

    @torch.inference_mode()
    def _prefill_one(self, req: Request, prefix: Optional[Prefix] = None):
        """Prefill one request at batch 1 into its own cache: (first-step
        logits [1, V], cache)."""
        eng = self.engine
        tokens, seg, _, _ = eng._pack([req.prompt])
        cache, fresh = self._fresh_cache(1, prefix)
        return _prefill(eng.model, eng._tensor(tokens), eng._tensor(seg), cache,
                        eng._features(req.images, req.patch_mask), fresh=fresh)

    @torch.inference_mode()
    def _prefill_block(self, reqs: Sequence[Request], nb: int,
                       prefix: Optional[Prefix] = None):
        """One bucketed prefill of nb rows for image-free requests, the list
        padded to nb by repeating its last entry."""
        eng = self.engine
        tokens, seg, _, _ = eng._pack([reqs[min(i, len(reqs) - 1)].prompt for i in range(nb)])
        cache, fresh = self._fresh_cache(nb, prefix)
        return _prefill(eng.model, eng._tensor(tokens), eng._tensor(seg), cache, None,
                        fresh=fresh)

    def _admit(self, requests: Sequence[Request], p_len: int) -> None:
        """Refuse, before anything is written, a request whose prefill or
        decode would run past the cache; warn of budgets above the cap."""
        eng = self.engine
        for i, r in enumerate(requests):
            if r.max_new_tokens > self.max_new_cap:
                warnings.warn(f"request max_new_tokens {r.max_new_tokens} truncated to "
                              f"engine max_new_cap {self.max_new_cap}", stacklevel=3)
            bucket = eng._bucket(len(r.prompt), eng.seq_buckets)
            need = p_len + len(r.prompt) + min(r.max_new_tokens, self.max_new_cap)
            if p_len + bucket > self.cache_len or need > self.cache_len:
                raise ValueError(
                    f"request {i} does not fit cache_len {self.cache_len}: the prefill "
                    f"writes prefix {p_len} + bucket {bucket} slots, the decode needs "
                    f"prefix + prompt + budget = {need}")

    @torch.inference_mode()
    def run(self, requests: Sequence[Request], gen_cfg: Optional[GenerateConfig] = None,
            longest_first: bool = False, prefix: Optional[Prefix] = None) -> List[Completion]:
        """Serve every request; returns completions in request order.

        `longest_first=True` admits requests by descending budget (for a
        queue known up front); completions still come in request order.
        `prefix`: an `Engine.build_prefix` result shared by every request of
        the run; each staged prefill seeds it and prefills only the request's
        own prompt. Fills `stats` (`staged_shapes`: the [rows, bucket] of
        each staged prefill, in order).
        """
        eng = self.engine
        gen_cfg = gen_cfg or eng.gen_cfg
        if gen_cfg.repetition_penalty != 1.0:
            raise ValueError("continuous batching does not support repetition_penalty "
                             "(use Engine.generate)")
        self._admit(requests, prefix.length if prefix is not None else 0)

        b, cap, dev = self.slots, self.max_new_cap, eng.device
        state = _Slots(
            cache=eng._new_cache(b, self.cache_len),
            logits=torch.zeros((b, eng.cfg.text.vocab_size), dtype=torch.float32, device=dev),
            done=torch.ones((b,), dtype=torch.bool, device=dev),
            n_gen=torch.zeros((b,), dtype=torch.int32, device=dev),
            budget=torch.zeros((b,), dtype=torch.int32, device=dev),
            gen_buf=torch.zeros((b, cap), dtype=torch.int32, device=dev),
            gen_mask=torch.zeros((b, cap), dtype=torch.bool, device=dev),
        )
        eos = torch.tensor(gen_cfg.eos_token_ids, dtype=torch.int32, device=dev)
        eos_host = np.asarray(gen_cfg.eos_token_ids)
        generator = torch.Generator(device=dev).manual_seed(gen_cfg.seed)
        results: List[Optional[Completion]] = [None] * len(requests)
        slot_req = [-1] * b   # request index in each slot
        rem = [0] * b         # budget left per slot (exact unless it ends at eos)

        def budget_of(ri: int) -> int:
            return min(requests[ri].max_new_tokens, cap)

        def has_img(r: Request) -> bool:
            return r.images is not None and r.images.shape[0] > 0

        def complete(ri: int, buf: np.ndarray, mask: np.ndarray) -> None:
            toks = buf[mask]
            stop = np.isin(toks, eos_host)
            if stop.any():
                toks = toks[: int(np.argmax(stop))]
            results[ri] = Completion(tokens=toks, prompt_length=len(requests[ri].prompt))

        # Prefill-ahead staging pool: refilling on demand degenerates to
        # batch-1 prefills once slots free one at a time, so the queue is
        # prefilled ahead in blocks. An entry is (request, block logits, block
        # cache, row in block); a block lives until its last row is installed.
        staged: List[tuple] = []
        order = (sorted(range(len(requests)), key=lambda i: -budget_of(i))
                 if longest_first else list(range(len(requests))))
        next_stage = 0
        self.stats = dict(boundaries=0, segments=0, blocks=0, block_rows=0, det_refills=0,
                          late_refills=0, fetch_s=0.0, stage_s=0.0, refill_s=0.0,
                          staged_shapes=[])

        def stage_more():
            nonlocal next_stage
            room = b - len(staged)
            # restock only once the pool has drained to half: restocking every
            # boundary degenerates blocks to batch 1 or 2
            if room <= 0 or len(staged) > b // 2 or next_stage >= len(order):
                return
            # image requests stage one at a time (their tile counts vary); the
            # loop goes on past them so that text behind them still batches
            while room > 0 and next_stage < len(order):
                if has_img(requests[order[next_stage]]):
                    ri = order[next_stage]
                    logits1, cache1 = self._prefill_one(requests[ri], prefix)
                    self.stats["staged_shapes"].append(
                        (1, eng._bucket(len(requests[ri].prompt), eng.seq_buckets)))
                    staged.append((ri, logits1, cache1, 0))
                    next_stage += 1
                    room -= 1
                    continue
                block = []
                while (len(block) < room and next_stage < len(order)
                       and not has_img(requests[order[next_stage]])):
                    block.append(order[next_stage])
                    next_stage += 1
                nb = 1
                while nb < len(block):
                    nb *= 2
                logits_nb, cache_nb = self._prefill_block([requests[i] for i in block], nb,
                                                          prefix)
                self.stats["blocks"] += 1
                self.stats["block_rows"] += len(block)
                self.stats["staged_shapes"].append(
                    (nb, eng._bucket(max(len(requests[i].prompt) for i in block),
                                     eng.seq_buckets)))
                staged.extend((i, logits_nb, cache_nb, j) for j, i in enumerate(block))
                room -= len(block)

        def refill(row: int):
            if not staged:
                slot_req[row] = -1
                rem[row] = 0
                return
            ri, logits_blk, cache_blk, j = staged.pop(0)
            _install(state, cache_blk, logits_blk, j, row, budget_of(ri), self.cache_len)
            slot_req[row] = ri
            rem[row] = budget_of(ri)

        pending: List[tuple] = []   # (request, host row capture, event) for the next fetch
        while True:
            self.stats["boundaries"] += 1
            snap, snap_event = _to_host([state.done, state.gen_buf, state.gen_mask])
            # dispatch the next segment before waiting on any fetch; occupancy
            # is exact on the host, so an empty pool runs no segment
            if any(ri >= 0 for ri in slot_req):
                self.stats["segments"] += 1
                _decode_segment(eng.model, state, gen_cfg, eos, generator, self.segment_steps)
                for row in range(b):
                    if slot_req[row] >= 0:
                        rem[row] -= self.segment_steps
            t0 = time.perf_counter()
            stage_more()   # runs on the device after the segment
            t1 = time.perf_counter()
            for event in [snap_event] + [e for _, _, e in pending]:
                if event is not None:
                    event.synchronize()
            done_h, buf_h, mask_h = (t.numpy() for t in snap)
            t2 = time.perf_counter()
            for ri, (buf1, mask1), _ in pending:
                complete(ri, buf1.numpy(), mask1.numpy())
            pending = []
            # late path: rows that ended early (eos), seen in the snapshot
            for row in np.nonzero(done_h)[0].tolist():
                if slot_req[row] >= 0:
                    complete(slot_req[row], buf_h[row], mask_h[row])
                    slot_req[row] = -1
                    self.stats["late_refills"] += 1
                if slot_req[row] < 0 and staged:
                    refill(row)
            # deterministic path: rows whose budget runs out in the segment
            # just dispatched refill now, after their output row is captured
            for row in range(b):
                if slot_req[row] >= 0 and rem[row] <= 0:
                    self.stats["det_refills"] += 1
                    pending.append((slot_req[row],
                                    *_to_host([state.gen_buf[row], state.gen_mask[row]])))
                    refill(row)
            t3 = time.perf_counter()
            self.stats["stage_s"] += t1 - t0
            self.stats["fetch_s"] += t2 - t1
            self.stats["refill_s"] += t3 - t2
            if (all(ri < 0 for ri in slot_req) and not staged and not pending
                    and next_stage >= len(order)):
                break
        assert all(r is not None for r in results)
        return results
