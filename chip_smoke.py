#!/usr/bin/env python3
"""Smoke run of the PyTorch port (leopard_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases, each printing its result on its own line; any failure raises and the
script exits non-zero without printing a result:
  1. environment: torch, the card, its name and power limit (nvidia-smi);
  2. build: nvcc compiles the flash-attention forward (K1) and backward (K2)
     and the int4 matmul (K4) into build/, one nvcc each, in parallel; the
     Triton norms (K3a/K3b) compile at their first launch, in phase 3;
  3. each kernel against its plain version, with its time, the plain
     version's, the time of one PyTorch call computing the same function
     where there is one, and the card's bound for the work (for K1 and K2
     also their TF/s over attended pairs, the fraction of the bound, and
     SDPA over the attended rows or segments alone, since the unsegmented
     SDPA call does up to 2x the work of a kernel that skips tiles): K1 in
     bf16 at the serving path's shapes (vision tower at 8, 16 and 32 tiles,
     decoder prefill, and
     the decoder prefills that phase 16's pool stages, every tower and
     decoder shape of phases 26-29's batches, with the plain version in
     slices where its scores pass 12 GiB; for phases 22-25 the
     NaViT tower at phase 22's eight images and phase 25's two, their patch
     masks' interleaved segment ids, with SDPA under the same boolean mask,
     and the decoder at [1, 8,192] with Mistral's window of 4,096 and
     without it); K2 at the
     train path's shapes (the decoder's packed two-segment rows with a
     padding tail, the tower's 16 tiles at head dim 72); K3a/K3b at the
     train path's rows, (8192, 4096) RMSNorm and (16·676, 1152) LayerNorm,
     cold L2;
     K4 at the 8B decode shapes (M = 2, M = 8 as in the slot pool's decode,
     M = 1 as in one request's decode, and M = 64 once, cold L2) against its
     plain version and the fp32 oracle, with its GB/s, tinygemm's time
     (torch._weight_int4pack_mm, bf16 scales), F.linear's on the bf16 weight
     it replaces, and host µs per call of both, per shape and per step;
  4. serving at 8B: Engine.generate on Leopard-LLaVA-8B with seeded random
     weights, 2 requests of 16 uint8 364×364 tiles each, 16 greedy tokens;
     K1's and K3's launch counts, no K1 input copied (TMA reads every
     input in place), repeatability, TTFT, prefill tok/s and decode ms/step;
  5. the K1 path against the dense path end to end (one request);
  6. int4 serving at 8B: Engine(quantize="int4") on the same model and
     requests; K1 and K4 launch counts, repeatability, TTFT, decode ms/step;
  7. one decode step of the int4 engine (K4) against the same step through a
     bf16 decoder built from the dequantized int4 weights;
  8. int4 weights with the int8 KV cache: one generate, checked;
  9. int8 weights: one checked generate, then TTFT and decode ms/step;
 10. prefix: build_prefix of a shared document (16 tiles + text, 3,004
     tokens; K1 in tower and decoder), two questions with prefix= against
     generate on the concatenated prompts (first-step logits, cosine per
     row), the prefix unchanged after, TTFT with and without the prefix;
 11. multi-turn: request 0 of phase 4 with return_prefix, then a second turn
     of 16 new tiles + 300 text tokens into the filled cache (the chunked
     continuation tier, counted per call) against the re-prefill of the
     whole conversation (K1, bucket 8,192), index == length == tokens, both
     turns' TTFT; then chunked_continuation_attention alone at turn 2's
     shape (float and int8 cache) beside SDPA with the boolean mask;
 12. chunked prefill: a 6,408-token prompt (32 tiles) through an engine
     whose largest bucket is 4,096 (K1, then the continuation tier)
     against the default engine's single-shot prefill;
 13. int4 weights with the int8 KV cache: phase 11's second turn (the
     continuation tier with scales, K4 at every decode matmul) against the
     same engine's re-prefill, and a speculative decode with K4 counted
     per verify round (M = draft + 1);
 14. speculative decode (n-gram 2, draft 7, 32 tokens) against plain
     greedy on a prompt that repeats a 200-token passage (first token
     equal, rounds, first divergence: random weights accept almost no
     draft), and beam search (width 4, 16 tokens);
     phases 10-14 hold logits at cosine >= 0.99 and report, without gating
     on it, whether the tokens agree;
 15. the HTTP server (GenerationServer on 127.0.0.1, a free port, in a
     thread; bf16): /api/generate with two text prompts (bucket 4,096, K1 in
     the decoder) against Engine.generate on the same ids, a two-turn
     /api/chat against generate(return_prefix=True) and generate(prefix=),
     two seeded noise PNGs through anyres tiling where Pillow imports
     against generate on the server's own _prepare_row output (K1 in the
     tower counted), and Predictor.predict_file against
     generate_and_post_process; the smoke's own byte-level tokenizer;
 16. continuous batching (bf16): ContinuousEngine with 8 slots over 16
     requests (4 of 16 tiles + 300 text tokens, 12 of 100-1,800 text
     tokens, budgets from {8, 16, 32, 64}): every budget met, the image
     requests' first tokens equal to serial generate's, the staged
     prefills' first-step logits against Engine.prefill (cosine per row),
     K1/K3 launch counts against the staged buckets and segments, every
     decoder shape K1 ran at held in phase 3, no K1 input copied; per request, agreement with serial greedy (reported,
     not gated); tokens/s, TTFT p50/p99, the pool's stats, and the same
     queue served statically in groups of 8;
 17. continuous batching with int4 weights, the int8 KV cache and a shared
     1,000-token prefix: 8 text requests, K4 launches per decode step and
     prefill, every (M, matmul) K4 ran at held in phase 3, staged logits against Engine.prefill(prefix=), a request
     whose bucket would run past the cache refused with ValueError, then
     the same queue served again token for token;
 18. HF conversion at the full width and depth of Leopard-LLaVA-8B, in
     memory: export_leopard_llava then convert_leopard_llava onto the card
     equal to the model bit for bit, the export adding no device memory
     beyond a few MB (it makes views); then transformers' LlamaForCausalLM
     and SiglipVisionModel built from the port's configs on the meta device
     and loaded with the exported tensors (assign=True; the rotary table and
     position ids rebuilt on the card, nothing left on meta): logits on
     2 x 4,096 tokens against the port's decoder (K1, K3a) and the last
     hidden state of 16 tiles against its tower (K1, K3b), cosine >= 0.995,
     with the top-1 agreement and each layer's hidden-state cosine;
 19. from a checkpoint on disk, at 8B widths with the text depth cut to 4
     of 32: the seeded model written by the port's export as two
     safetensors shards and an index, loaded (time, host peak RSS, device
     peak) equal bit for bit; the convert CLI hf2native then native2hf, the
     fp32 file equal to the original tensors; the generate CLI on two
     seeded PNGs (728x364, 364x1,092), 16 greedy tokens, against
     Engine.generate on the model in memory and the same process_eval
     output; the serve CLI with --quantize int4 on a free port, one image
     request over HTTP against an int4 Engine on the same weights, K4 at
     M = 1 and every K1 shape held in phase 3;
 20. training at the width of Leopard-LLaVA-8B with the text depth cut to 4
     of 32 (the 8B train state, ~18 B a parameter, does not fit one 80 GB
     card), seeded random weights, 2 rows x 4,096 tokens each packing two
     samples (positions restarting per segment, a padding tail) with 16
     tiles: first one step's gradients through K1 + K2 against the same
     step with dense attention in text and tower (cosine per parameter
     group), then 3 steps of `train()` (full recompute, chunked
     cross-entropy, AdamW with warmup from 0): loss and grad norm finite,
     params unchanged by step 1 (lr 0) and changed by steps 2-3, the K1, K2
     and K3 launch counts of every step against the layer counts, no K1/K2
     input copied, step ms,
     tokens/s and peak memory;
 21. the train CLI from a jsonl manifest of 8 samples (1-3 seeded PNGs and
     a two-turn conversation each), --init-from phase 19's checkpoint, 3
     steps at 2 x 4,096 through the TrainDataLoader with the native index
     builder loaded: losses finite, step 1's against vlm_loss on the
     loader's first batch with the model loaded from the checkpoint, the
     loader's K1/K2 shapes held in phase 3, the launches against the layer
     counts, step ms, tokens/s, the loader's host ms a batch, peak memory;
 22. (A) Leopard-Idefics2-8B at full depth and width, seeded weights (the
     perceiver's latents drawn apart): one request of the reference's
     serving shape, eight seeded noise images (one 980 x 980, the others
     wide or tall, so that every image but one has padded rows or columns
     inside the 70 x 70 patch grid) through preprocess_idefics2 and a
     prompt filled with text to bucket 8,192, 16 greedy tokens twice: K1 27
     + 32, K3a 65 x 16 + 10, K3b 55, no K1 input copied, tokens repeat; the
     tower's whole output finite; encode_images (tower and perceiver
     apart), TTFT, prefill tok/s, decode ms/step;
 23. (B) phase 22's first-step logits through the kernels against the dense
     path (tower and decoder attn_impl "dense"), cosine >= 0.99, and against
     the kernel path without the window, which must differ by more than 10x
     as much;
 24. (C) HF at full 8B in memory: export_leopard_idefics2 then
     convert_leopard_idefics2, bit for bit, the export adding no device
     memory; transformers' MistralForCausalLM (window 4,096) on the exported
     decoder against the port's on 1 x 8,192 tokens, and transformers'
     Idefics2VisionTransformer + Idefics2Connector against the port's tower
     + perceiver on phase 22's images: cosine >= 0.995 (the tower given
     the reference's position ids; transformers' own rule, which differs at
     exact boundaries, reported beside);
 25. (D) a depth-4 (of 32) Idefics2 checkpoint of two safetensors shards:
     convert_checkpoint --arch leopard_idefics2 both ways bit for bit, and
     serve --arch leopard_idefics2 answering one request of two seeded PNGs
     over HTTP with Engine.generate's tokens on the server's own
     _prepare_row output; every K1 shape of phases 22-25 held in phase 3;
 26. (eval A, after phase 18) the evaluation harness on Leopard-LLaVA-8B:
     run_benchmark_batched at batch 8 with its prefetch thread over
     MP-DocVQA (8 questions of 1-6 noise pages of 1,700 x 2,200: 342
     crops, the decoder at [8, 16,384]) and SlideVQA (decks of 20 slides)
     in their raw layouts and a prepared set of multiple-choice,
     captioning and webqa rows, 16 greedy tokens: each batch as planned
     before phase 3, the launches as the formula, every K1 shape held, the
     responses equal to Engine.generate on the same batches; samples/s,
     tok/s and the prefetch wait per batch; the prefix-caching adapter's
     first-step logits against the plain prefill (cosine >= 0.9999 on an
     fp32 twin with dense attention, >= 0.99982 in bf16, a limit that two
     planted faults, the suffix one position late and a stale header,
     must fall below); the serial loop's agreement with the batched one,
     reported;
 27. (eval B, after phase 24) the Idefics2 adapter on Leopard-Idefics2-8B:
     8 rows of 1-8 images at batch 4, each batch's samples re-padded to
     its largest grid, equal to Engine.generate on the same batches, K1
     held at the re-padded NaViT masks, the tower finite on every row;
 28. (eval C, after phase 21) the run_eval CLI on phase 19's depth-4
     checkpoint: two shards and the merge equal to one shard, each shard
     file equal to the adapter called directly; --quantize int4 (K4
     counted), --prefix-caching and --spec 7, their agreement with bf16
     reported;
 29. (eval D) LeopardLM on the same checkpoint: loglikelihood and
     loglikelihood_rolling of 2,200-token requests through K1 against the
     dense decoder (summed logprobs to 2e-3 relative, each token's
     logprob to 0.2), limits that a planted fault, the dense decoder with
     a 1,024-token window, must exceed; one generate_until;
 30. (eval E, after phase 20) the train step under "attn" and "selective"
     against "full": the first step's loss and gradients (cosine >= 0.999
     per group), K1 31 a step against 62, K2 31, step ms and peak memory;
 31. no JAX was imported.
Each engine is freed after its phase, with the phase's peak device memory
printed. Then the card's name and power limit as nvidia-smi prints them, one
JSON line with every kernel ({"kernels": [...]}) and, last, the JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
# bf16 kernel vs its plain version: each side rounds its output to bf16
# (2^-8 relative) and P is rounded against another max (running vs final)
KERNEL_TOL = dict(rtol=1e-2, atol=1e-2)
COSINE_MIN = 0.99
TILES_PER_REQUEST = 16
MAX_NEW_TOKENS = 16
# K4 vs its plain version, outputs of std ~1: the plain version rounds each
# weight to bf16 (2^-9 relative), the kernel keeps it in fp32
K4_TOL = dict(rtol=1e-2, atol=1e-2)
# K4 vs the fp32 oracle x_bf16 @ ((q - 8) * s): the same exact operands, fp32
# sums rounded in another order; bf16 scales would miss it by ~1e-3
K4_ORACLE_TOL = dict(rtol=1e-4, atol=1e-4)
# tinygemm vs K4: tinygemm rounds the scales and its output to bf16
K4_LIBRARY_TOL = dict(rtol=3e-2, atol=3e-2)
# decode-step matmuls of the 8B decoder, (K, N) and how many per layer
K4_SHAPES = {"wq_wo": (4096, 4096, 2), "wk_wv": (4096, 1024, 2),
             "gate_up": (4096, 14336, 2), "down": (14336, 4096, 1),
             "lm_head": (4096, 128256, 0)}
KERNELS = ("flash_attention", "flash_attention_bwd", "int4_matmul")
# K2 vs its plain version: P and dS are rounded to bf16 in the kernel, not in
# the plain version, and both round the gradients to bf16
K2_TOL = dict(rtol=2e-2, atol=2e-2)
# K3 vs its plain version: one bf16 rounding (2^-8 relative) of outputs up to
# ~4 on each side
K3_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# the card's peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# the train phase: Leopard-LLaVA-8B widths, text depth 4; 2 rows of 4,096
# tokens, each packing two samples of 4 tiles, then a padding tail
TRAIN_TEXT_LAYERS = 4
TRAIN_SEQ = 4096
TRAIN_ROWS = ((2100, 1900), (1700, 2300))  # sample lengths; the rest is padding
TRAIN_TILES_PER_SAMPLE = 4
TRAIN_STEPS = 3
# phase 3's K1 shapes: the vision tower at 8 (phase 19's two PNGs, 7 crops),
# 16 and 32 tiles, the decoder
# prefill of two right-padded rows, the decoder prefills that phase 16's
# pool stages (an image request alone, text blocks of 2 and 4 rows at bucket
# 2,048, with that queue's prompt lengths) and phase 15's PNG request (one
# row at 2,048); rows: each row's segment lengths or None. Phase 16 fails if
# its pool runs K1 at a decoder (rows, bucket) that is not here.
K1_SHAPES = {
    "vision_b8": dict(b=8, s=676, hq=16, hkv=16, d=72, causal=False, rows=None),
    "vision_b16": dict(b=16, s=676, hq=16, hkv=16, d=72, causal=False, rows=None),
    "vision_b32": dict(b=32, s=676, hq=16, hkv=16, d=72, causal=False, rows=None),
    "decoder": dict(b=2, s=4096, hq=32, hkv=8, d=128, causal=True, rows=((4096,), (2900,))),
    "decoder_b1": dict(b=1, s=4096, hq=32, hkv=8, d=128, causal=True, rows=((3004,),)),
    "decoder_b1_2048": dict(b=1, s=2048, hq=32, hkv=8, d=128, causal=True, rows=((1412,),)),
    "decoder_b2_2048": dict(b=2, s=2048, hq=32, hkv=8, d=128, causal=True,
                            rows=((1238,), (1520,))),
    "decoder_b4_2048": dict(b=4, s=2048, hq=32, hkv=8, d=128, causal=True,
                            rows=((612,), (1043,), (294,), (1660,))),
}


def k2_shapes(text, vis):
    """Phase 3's K2 shapes from the model's text and vision configs: the
    train phase's packed decoder rows and its tower tiles."""
    n_tiles = sum(len(row) for row in TRAIN_ROWS) * TRAIN_TILES_PER_SAMPLE
    return {"decoder": dict(b=len(TRAIN_ROWS), s=TRAIN_SEQ, hq=text.num_heads,
                            hkv=text.num_kv_heads, d=text.head_dim, causal=True, rows=TRAIN_ROWS),
            "tower": dict(b=n_tiles, s=vis.tokens_per_tile, hq=vis.num_heads, hkv=vis.num_heads,
                          d=vis.head_dim, causal=False, rows=None)}


def cuda_ms(fn, flush=None, reps=10, warm=True) -> float:
    """Median device time of fn() over `reps` runs in ms, by CUDA events,
    after a warm-up (none with warm=False: the caller has just run fn's
    work). With `flush` (a buffer larger than the L2 cache) the buffer is
    read before each run, outside the timed window, so fn() finds its inputs
    cold, as a decode step finds each weight; the read also keeps the device
    busy while the host enqueues fn(), so the window holds no launch gap."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(fn, reps=3) -> float:
    """Median host time of fn() over `reps` runs in s, each run ending in a
    synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def attended_pairs(segment_lengths, causal, window=None):
    """(q, kv) pairs the mask lets through, for rows of segments of the given
    lengths (a NaViT image's real patches count as one segment of their
    number: they attend each other wherever they lie in the row), under the
    causal band and, for a causal segment, the window (row i attends
    min(i + 1, window) positions)."""
    def pairs(n):
        if not causal:
            return n * n
        if window is None or n <= window:
            return n * (n + 1) // 2
        return window * (window + 1) // 2 + (n - window) * window
    return sum(pairs(n) for row in segment_lengths for n in row)


def attn_bound_ms(pairs, heads, d, products, n_bytes):
    """Least time for the work, the larger of two: `products` matmuls of 2·D
    flops per attended pair and head at the card's bf16 peak (2 for the
    forward, 5 for the backward), and `n_bytes` (each input read once, each
    output written once) at its memory rate. Returns (ms, what bounds it)."""
    ops_ms = products * 2 * d * pairs * heads / PEAK_BF16_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sdpa_ms(lengths, hq, hkv, d, causal, device, backward):
    """The yardstick: F.scaled_dot_product_attention (forward, or its
    backward) over sequences of the given lengths, one call per distinct
    length with the sequences of that length as its batch, all timed
    together. [s] * b is the unsegmented call at the kernel's shape; the
    valid rows' or packed segments' lengths give the attended work alone,
    which a kernel that skips tiles should be held to. The port never
    calls it."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(SEED)
    kw = dict(is_causal=causal, enable_gqa=hq != hkv)
    calls = []
    for s, b in sorted(collections.Counter(lengths).items()):
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=device, dtype=torch.bfloat16)
                   for h in (hq, hkv, hkv))
        if not backward:
            calls.append((q, k, v))
            continue
        leaves = [t.requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, **kw)
        calls.append((out, leaves, torch.randn_like(out)))
    if not backward:
        def run():
            for q, k, v in calls:
                F.scaled_dot_product_attention(q, k, v, **kw)
        with torch.no_grad():
            return cuda_ms(run)

    def run_backward():
        for out, leaves, dout in calls:
            torch.autograd.grad(out, leaves, dout, retain_graph=True)
    return cuda_ms(run_backward)


def ranges_ms(seg, s, causal, window=None) -> float:
    """Host time of one tile_ranges call on segment ids [B, S], device work
    included (median of 10, each ending in a synchronize). The decoder
    computes it once per forward and passes it to every layer, and the
    kernels are timed that way; this is the cost of a call that does not."""
    from leopard_tpu_torch.ops.flash_attention import tile_ranges

    if seg is None:
        return 0.0
    return wall_s(lambda: tile_ranges(seg, seg, sq=s, skv=s, causal=causal, window=window,
                                      device=seg.device), reps=10) * 1e3


def sdpa_masked_ms(q, k, v, seg, causal, window):
    """One F.scaled_dot_product_attention on the kernel's inputs with the
    same mask as a boolean attn_mask [B, 1, S, S]: the library call that
    computes the same function (its fully-masked rows aside). Returns (ms,
    None) or (None, the error) where SDPA refuses the call."""
    import torch
    import torch.nn.functional as F

    from leopard_tpu_torch.ops.attention import make_attention_mask

    s = q.shape[1]
    mask = make_attention_mask(s, s, causal=causal, q_segment_ids=seg, kv_segment_ids=seg,
                               sliding_window=window, device=q.device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        with torch.no_grad():
            return cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=q.shape[2] != k.shape[2])), None
    except RuntimeError as e:  # reported; the kernel's check does not depend on it
        return None, str(e).splitlines()[0]



def achieved(pairs, heads, d, products, ms, bound_ms):
    """TF/s of useful work (attended pairs only) and the fraction of the
    card's bound that the time reaches."""
    return {"tflops": products * 2 * d * pairs * heads / (ms * 1e-3) / 1e12,
            "bound_fraction": bound_ms / ms}


def attn_inputs(b, s, hq, hkv, d, rows, device):
    """Seeded bf16 q, k, v, dout of one phase-3 shape, and its segment ids
    (None without rows); dout is 0 on padding rows, as no loss reads them."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, dout = (torch.randn((b, s, h, d), generator=g, device=device, dtype=torch.bfloat16)
                     for h in (hq, hkv, hkv, hq))
    seg = None
    if rows is not None:
        seg = segments_of(rows, s, device)
        dout = dout * (seg != 0)[:, :, None, None].to(dout.dtype)
    return q, k, v, dout, seg


def kernel_vs_plain(name, b, s, hq, hkv, d, causal, rows, device, card, window=None,
                    seg_ids=None):
    """Phase 3 for one shape: max abs error over valid rows, both times.
    `seg_ids` [B, S] (numpy): segment ids as they come, e.g. a NaViT patch
    mask's interleaved 0/1 ids, in place of `rows`' contiguous ones; then
    `rows` gives each row's count of real patches for the pair count and the
    attended SDPA. `window`: the decoder's sliding window."""
    import torch

    from leopard_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_ref,
                                                       tile_ranges)

    q, k, v, _, seg = attn_inputs(b, s, hq, hkv, d, None if seg_ids is not None else rows,
                                  device)
    if seg_ids is not None:
        seg = torch.from_numpy(np.ascontiguousarray(seg_ids, np.int32)).to(device)
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg, sliding_window=window)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    valid = torch.ones((b, s), dtype=torch.bool, device=device) if seg is None else seg.bool()
    slices = plain_slices(b, hq, hkv, s)
    g = hq // hkv

    def plain(sl):
        rows_, heads = sl
        qh = slice(heads.start * g, heads.stop * g)
        sg = None if seg is None else seg[rows_]
        return flash_attention_ref(q[rows_, :, qh], k[rows_, :, heads], v[rows_, :, heads],
                                   causal=causal, q_segment_ids=sg, kv_segment_ids=sg,
                                   sliding_window=window)

    err = 0.0
    for sl in slices:
        part, ok = got[sl[0], :, sl[1].start * g:sl[1].stop * g], valid[sl[0]]
        if not ok.any():  # rows of padding images alone (a tile bucket's)
            continue
        want = plain(sl)
        err = max(err, (part[ok].float() - want[ok].float()).abs().max().item())
        torch.testing.assert_close(part[ok].float(), want[ok].float(), **KERNEL_TOL)
        del want
    ranges = tile_ranges(seg, seg, sq=s, skv=s, causal=causal, window=window, device=device)
    ms = cuda_ms(lambda: flash_attention(q, k, v, ranges=ranges, **kw))  # as the decoder
    # a plain version too large for the card in one call runs in slices:
    # its time is that of one pass over every slice (median of
    # PLAIN_SLICED_REPS; the comparison above was the warm-up)
    if len(slices) == 1:
        plain_ms = cuda_ms(lambda: plain(slices[0]))
    else:
        def every_slice():
            for sl in slices:
                plain(sl)

        plain_ms = cuda_ms(every_slice, reps=PLAIN_SLICED_REPS, warm=False)
    lone_ranges_ms = ranges_ms(seg, s, causal, window)
    masked = {}
    if seg_ids is not None or window is not None:  # SDPA with the same boolean mask
        masked["library_masked_ms"], error = sdpa_masked_ms(q, k, v, seg, causal, window)
        if error is not None:
            masked["library_masked_error"] = error
    n_bytes = nbytes(q, k, v, seg, seg, got)
    del q, k, v
    torch.cuda.empty_cache()
    segs = rows if rows is not None else [[s]] * b
    library_ms = sdpa_ms([s] * b, hq, hkv, d, causal, device, backward=False)
    attended = [n for row in segs for n in row if n > 0]
    attended_ms = sdpa_ms(attended, hq, hkv, d, causal, device, backward=False)
    pairs = attended_pairs(segs, causal, window)
    bound_ms, bound_by = attn_bound_ms(pairs, hq, d, 2, n_bytes)
    rate = achieved(pairs, hq, d, 2, ms, bound_ms)
    shape = (f"B={b} S={s} heads={hq}/{hkv} D={d} {'causal' if causal else 'non-causal'}"
             + (f" window={window}" if window else "")
             + (" NaViT patch-mask segments," if seg_ids is not None else "")
             + (f" lengths={[n for row in rows for n in row]}" if rows else ""))
    lib_masked = ""
    if "library_masked_ms" in masked:
        lib_masked = (f", {masked['library_masked_ms']:.4f} ms (boolean mask)"
                      if masked["library_masked_ms"] is not None
                      else f", boolean mask refused: {masked['library_masked_error']}")
    print(f"kernel {name}: {shape}: max_abs_err={err:.6g} (tol {KERNEL_TOL}) "
          f"kernel {ms:.4f} ms ({rate['tflops']:.1f} TF/s attended, "
          f"{rate['bound_fraction']:.3f} of the bound), plain {plain_ms:.4f} ms"
          f"{f' (one pass over {len(slices)} slices)' if len(slices) > 1 else ''}, sdpa "
          f"{library_ms:.4f} ms (unsegmented), {attended_ms:.4f} ms (attended rows only"
          f"{', the window not skipped' if window else ''}){lib_masked}, "
          f"bound {bound_ms:.4f} ms; tile ranges of a lone call {lone_ranges_ms:.4f} ms "
          f"(host) [{card}]", flush=True)
    return {"shape": f"{name}: {shape}", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_slices": len(slices),
            "library_ms": library_ms, "library_attended_ms": attended_ms, **masked,
            "tile_ranges_ms": lone_ranges_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **rate}


# the plain version's fp32 scores [rows, heads, S, S] in one call: a call
# above PLAIN_WHOLE_MAX runs in slices of rows and kv heads of at most
# PLAIN_SLICE_MAX (its softmax holds a few such tensors at once)
PLAIN_WHOLE_MAX = 12 * 2**30
PLAIN_SLICE_MAX = 4 * 2**30
PLAIN_SLICED_REPS = 3   # timed passes over the slices (2.4 s each at [8, 16,384])


def plain_slices(b, hq, hkv, s):
    """(rows, kv heads) slices of one plain-version call, the whole call
    where its scores fit PLAIN_WHOLE_MAX."""
    whole = [(slice(0, b), slice(0, hkv))]
    per_head = hq // hkv * s * s * 4
    if b * hkv * per_head <= PLAIN_WHOLE_MAX:
        return whole
    heads = max(1, min(hkv, PLAIN_SLICE_MAX // per_head))
    while hkv % heads:
        heads -= 1
    rows = max(1, min(b, PLAIN_SLICE_MAX // (per_head * heads)))
    while b % rows:
        rows -= 1
    return [(slice(r, r + rows), slice(h, h + heads))
            for r in range(0, b, rows) for h in range(0, hkv, heads)]


def segments_of(rows, s, device):
    """Segment ids [B, S] for rows of consecutive samples (ids 1, 2, ...)
    followed by padding (0)."""
    import torch

    seg = torch.zeros((len(rows), s), dtype=torch.int32)
    for r, row in enumerate(rows):
        start = 0
        for sid, n in enumerate(row, start=1):
            seg[r, start:start + n] = sid
            start += n
    return seg.to(device)


def flash_bwd_vs_plain(name, b, s, hq, hkv, d, causal, rows, device, card):
    """Phase 3, K2 at one shape: dq/dk/dv max abs error against the plain
    version on the same inputs (out and lse from K1), times, and the bound.
    `rows`: each row's packed sample lengths, or None (no segments)."""
    import torch

    from leopard_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, seg = attn_inputs(b, s, hq, hkv, d, rows, device)
    kw = dict(causal=causal)
    out, lse = fa._launch(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, with_lse=True,
                          sliding_window=None, **kw)
    got = fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, seg, seg, out, lse, dout, **kw)
    torch.cuda.synchronize()
    errs = {}
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: {gname} has non-finite values")
        errs[gname] = (a.float() - w.float()).abs().max().item()
        torch.testing.assert_close(a.float(), w.float(), **K2_TOL, msg=f"{name} {gname}")
    again = fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{name}: K2 does not repeat bit for bit")
    del want, got, again
    ranges = fa.tile_ranges(seg, seg, sq=s, skv=s, causal=causal, device=device)
    ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout,
                                                ranges=ranges, **kw))  # as a train step
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, seg, seg, out, lse, dout, **kw))
    # reads q, k, v, out, dout, lse and the segments; writes dq, dk, dv
    n_bytes = nbytes(q, k, v, out, dout, lse, seg, seg, q, k, v)
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()
    segs = rows if rows is not None else [[s]] * b
    library_ms = sdpa_ms([s] * b, hq, hkv, d, causal, device, backward=True)
    attended_ms = sdpa_ms([n for row in segs for n in row], hq, hkv, d, causal, device,
                          backward=True)
    pairs = attended_pairs(segs, causal)
    bound_ms, bound_by = attn_bound_ms(pairs, hq, d, 5, n_bytes)
    rate = achieved(pairs, hq, d, 5, ms, bound_ms)
    shape = (f"B={b} S={s} heads={hq}/{hkv} D={d} {'causal' if causal else 'non-causal'}"
             + (f" packed rows={[list(r) for r in rows]}" if rows else ""))
    print(f"kernel flash_attention_bwd {name}: {shape}: max_abs_err "
          + ", ".join(f"{k_}={e:.6g}" for k_, e in errs.items())
          + f" (tol {K2_TOL}), repeats bit for bit; kernel {ms:.4f} ms ({rate['tflops']:.1f} "
          f"TF/s attended, {rate['bound_fraction']:.3f} of the bound), plain {plain_ms:.4f} ms, "
          f"sdpa backward {library_ms:.4f} ms (unsegmented), {attended_ms:.4f} ms (attended "
          f"segments only), bound {bound_ms:.4f} ms [{card}]", flush=True)
    return {"shape": f"{name}: {shape}", "max_abs_err": max(errs.values()), "errs": errs,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_attended_ms": attended_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            **rate}


def norm_vs_plain(kind, rows, h, device, card, flush, eps=None):
    """Phase 3, K3a (rms; eps 1e-5 unless given) or K3b (ln; 1e-6) at
    [rows, h] bf16: max abs error,
    times (cold L2, so that the window holds device time and not the
    launch, which costs Triton's launcher more than the kernel takes), the
    F.rms_norm / F.layer_norm yardstick, and the byte bound."""
    import torch
    import torch.nn.functional as F

    from leopard_tpu_torch.ops import fused_norms, norms

    g = torch.Generator(device=device).manual_seed(SEED)
    x = (torch.randn((rows, h), generator=g, device=device) * 2 + 0.5).to(torch.bfloat16)
    params = [torch.randn(h, generator=g, device=device).to(torch.bfloat16)
              for _ in range(1 if kind == "rms" else 2)]
    if kind == "rms":
        fused, plain, eps = fused_norms.fused_rms_norm, norms.rms_norm_ref, eps or 1e-5
        library = lambda: F.rms_norm(x, (h,), params[0], eps)  # noqa: E731
    else:
        fused, plain, eps = fused_norms.fused_layer_norm, norms.layer_norm_ref, eps or 1e-6
        library = lambda: F.layer_norm(x, (h,), *params, eps)  # noqa: E731
    got = fused(x, *params, eps)
    want = plain(x, *params, eps)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kind}: kernel output has non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **K3_TOL)
    ms = cuda_ms(lambda: fused(x, *params, eps), flush=flush)
    plain_ms = cuda_ms(lambda: plain(x, *params, eps), flush=flush)
    library_ms = cuda_ms(library, flush=flush)
    n_bytes = nbytes(x, *params, got)
    bound_ms = n_bytes / PEAK_BYTES_S * 1e3
    name = "fused_rms_norm" if kind == "rms" else "fused_layer_norm"
    print(f"kernel {name}: x [{rows}, {h}] bf16: max_abs_err={err:.6g} (tol {K3_TOL}) kernel "
          f"{ms:.4f} ms ({n_bytes / (ms * 1e-3) / 1e9:.1f} GB/s), plain {plain_ms:.4f} ms, "
          f"torch {library_ms:.4f} ms, bound {bound_ms:.4f} ms [{card}]", flush=True)
    return {"shape": f"x [{rows}, {h}] bf16", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms}


def host_us(fn, calls=200, reps=5) -> float:
    """Host time of one fn() call in µs: a loop of `calls` calls on the host
    clock while a spin kernel keeps the device ahead, so no call waits for
    the device (median of `reps` loops)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # ~25-35 ms of device time, longer than the loop
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def tinygemm(x, q4, s):
    """The yardstick for K4: ATen's int4 matmul (tinygemm,
    torch._weight_int4pack_mm) on the same nibbles, x · ((q − 8) · s + 0) per
    group of 128, with scales_and_zeros in bf16 (it takes no fp32 scales).
    Returns the call, or the error ATen raised. The port never calls it."""
    import torch

    try:
        q = torch.cat([q4 & 15, q4 >> 4], dim=0).t().contiguous()  # [N, K] of q + 8
        packed = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8)  # [N, K/2], even k high
        w = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.stack([s, torch.zeros_like(s)], dim=-1).to(torch.bfloat16).contiguous()
        fn = lambda: torch._weight_int4pack_mm(x, w, 128, sz)  # noqa: E731
        fn()
        return fn, None
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {e}".splitlines()[0]


def int4_vs_plain(name, m, k, n, device, card, flush):
    """Phase 3 for one K4 shape: the largest error against the plain version
    and against the fp32 oracle; kernel, plain, tinygemm and dense bf16
    (F.linear) times with cold L2; GB/s over the bytes the call must move;
    host µs per call of the decoder's int4 matmul (quant.matmul into K4)
    and of F.linear."""
    import torch
    import torch.nn.functional as F

    from leopard_tpu_torch.models.params import QuantizedWeight
    from leopard_tpu_torch.ops import quant
    from leopard_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_ref

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((m, k), generator=g, device=device, dtype=torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=device, dtype=torch.bfloat16) * k**-0.5
    q = quant.quantize_int4(w)
    q4, s = q["q4"], q["s"]
    got = int4_matmul(x, q4, s)
    want = int4_matmul_ref(x, q4, s)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **K4_TOL)
    del want
    oracle = x.float() @ quant._unpack_int4(q4, s)
    oracle_err = (got - oracle).abs().max().item()
    torch.testing.assert_close(got, oracle, **K4_ORACLE_TOL)
    del oracle
    ms = cuda_ms(lambda: int4_matmul(x, q4, s), flush=flush)
    plain_ms = cuda_ms(lambda: int4_matmul_ref(x, q4, s), flush=flush)
    lib_fn, lib_error = tinygemm(x, q4, s)
    library_ms = lib_err = None
    if lib_fn is not None:
        lib_out = lib_fn().float()
        lib_err = (lib_out - got).abs().max().item()
        torch.testing.assert_close(lib_out, got, **K4_LIBRARY_TOL)
        del lib_out
        library_ms = cuda_ms(lib_fn, flush=flush)
    dense_ms = cuda_ms(lambda: F.linear(x, w), flush=flush)
    x3, qw = x[:, None], QuantizedWeight(q)
    k4_host = host_us(lambda: quant.matmul(x3, qw))
    dense_host = host_us(lambda: F.linear(x3, w))
    n_bytes = k // 2 * n + k // 128 * n * 4 + m * k * 2 + m * n * 4
    gbs = n_bytes / (ms * 1e-3) / 1e9
    lib_note = (f"tinygemm {library_ms:.4f} ms (|diff| {lib_err:.3g})" if lib_fn is not None
                else f"tinygemm not available ({lib_error})")
    print(f"kernel int4_matmul {name}: M={m} K={k} N={n}: max_abs_err={err:.6g} (tol {K4_TOL}), "
          f"vs fp32 oracle {oracle_err:.3g} (tol {K4_ORACLE_TOL}); kernel {ms:.4f} ms "
          f"({gbs:.1f} GB/s of {n_bytes} bytes, bound {n_bytes / PEAK_BYTES_S * 1e3:.4f} ms), "
          f"plain {plain_ms:.4f} ms, {lib_note}, dense bf16 F.linear {dense_ms:.4f} ms; "
          f"host us per call: quant.matmul (K4) {k4_host:.2f}, F.linear {dense_host:.2f} "
          f"[{card}]", flush=True)
    return {"shape": f"{name}: M={m} K={k} N={n}", "max_abs_err": err,
            "oracle_max_abs_err": oracle_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_diff": lib_err,
            "library_error": lib_error, "dense_ms": dense_ms, "host_us": k4_host,
            "dense_host_us": dense_host, "bytes": n_bytes, "gb_s": gbs,
            "bound_ms": n_bytes / PEAK_BYTES_S * 1e3}


def make_requests(cfg, n_requests, text_lengths, seed=SEED):
    """Prompts of [BOS, 16 tiles' image tokens, text] and their uint8 tiles."""
    rng = np.random.RandomState(seed)
    per_tile = cfg.anyres.tokens_per_tile
    prompts = []
    for r in range(n_requests):
        text = rng.randint(0, 128000, size=text_lengths[r]).astype(np.int32)
        img = np.full(TILES_PER_REQUEST * per_tile, cfg.image_token_id, np.int32)
        prompts.append(np.concatenate([[128000], img, text]).astype(np.int32))
    size = cfg.vision.image_size
    tiles = rng.randint(0, 256, (n_requests * TILES_PER_REQUEST, size, size, 3), dtype=np.uint8)
    return prompts, tiles


def serve(engine, cfg, prompts, tiles, card, label, k4_per_step=0, runs=2, time_reps=3):
    """Generate `runs` times, checking each run's K1 and K4 launch counts,
    tokens and logprobs, and that the runs agree; then time with `time_reps`
    repetitions (0: no timing). K4 runs k4_per_step times per decode forward
    and once more for the prefill's lm_head, where there is any K4 at all."""
    import torch

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.ops.flash_attention import flash_attention
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
    from leopard_tpu_torch.ops.int4_matmul import int4_matmul

    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS)
    expected = cfg.vision.num_layers + cfg.text.num_layers
    results, copies = [], 0
    for _ in range(runs):
        for counter in (flash_attention, int4_matmul, fused_rms_norm, fused_layer_norm):
            counter.launches = 0
        flash_attention.copies = 0
        res = engine.generate(prompts, images=tiles, gen_cfg=gen)
        torch.cuda.synchronize()
        copies += flash_attention.copies
        if flash_attention.copies:
            raise AssertionError(f"{label}: K1/K2 copied {flash_attention.copies} inputs that "
                                 "TMA could not address; the serving path must make none")
        launches = {"flash_attention": flash_attention.launches,
                    "int4_matmul": int4_matmul.launches,
                    "fused_rms_norm": fused_rms_norm.launches,
                    "fused_layer_norm": fused_layer_norm.launches}
        # decode forwards in one generate: the loop stops after the step
        # where the last row emits eos, and the final step runs no forward
        steps = max(min(MAX_NEW_TOKENS, len(t) + 1) for t in res.tokens) - 1
        want = {"flash_attention": expected,
                "int4_matmul": 1 + k4_per_step * steps if k4_per_step else 0,
                # two norms a layer and the final one, in the prefill and
                # every decode forward; two a tower layer and the post-LN
                "fused_rms_norm": (2 * cfg.text.num_layers + 1) * (1 + steps),
                "fused_layer_norm": 2 * cfg.vision.num_layers + 1}
        if launches != want:
            raise AssertionError(f"{label}: generate launched {launches}, expected {want}")
        for toks, lps in zip(res.tokens, res.logprobs):
            if not np.all((toks >= 0) & (toks < cfg.text.vocab_size)):
                raise AssertionError(f"{label}: tokens out of the vocab: {toks}")
            if not np.all(np.isfinite(lps)):
                raise AssertionError(f"{label}: non-finite logprobs (non-finite logits): {lps}")
        results.append(res)
    for other in results[1:]:
        for a, b in zip(results[0].tokens, other.tokens):
            if not np.array_equal(a, b):
                raise AssertionError(f"{label}: generate is not repeatable: {a} vs {b}")
    k4_note = f"; K4: 1 + {k4_per_step} x {steps} decode forwards" if k4_per_step else ""
    print(f"{label}: {runs} generate call(s), K1/K2 input copies {copies}, launches each {launches} "
          f"(K1: {cfg.vision.num_layers} vision + {cfg.text.num_layers} decoder prefill{k4_note}; "
          f"K3a: {2 * cfg.text.num_layers + 1} x (1 + {steps}) forwards; "
          f"K3b: {2 * cfg.vision.num_layers + 1}), "
          f"tokens{' identical' if runs > 1 else ''}: {[t.tolist() for t in results[0].tokens]}",
          flush=True)
    timings = {"launches": launches, "decode_steps": steps, "copies": copies}
    if not time_reps:
        return timings

    prompt_tokens = sum(len(p) for p in prompts)
    vision_s = wall_s(lambda: engine.encode_images(tiles), time_reps)
    ttft_s = wall_s(lambda: engine.generate(prompts, images=tiles,
                                            gen_cfg=dataclasses.replace(gen, max_new_tokens=1)),
                    time_reps)
    full_s = wall_s(lambda: engine.generate(prompts, images=tiles, gen_cfg=gen), time_reps)
    decode_ms = (full_s - ttft_s) / steps * 1e3
    timings.update({
        "ttft_s": ttft_s, "vision_tower_s": vision_s,
        "prefill_tok_s": prompt_tokens / ttft_s, "decode_ms_per_step": decode_ms,
        "prompt_tokens": prompt_tokens, "batch": len(prompts),
    })
    print(f"{label} timing [{card}]: TTFT {ttft_s * 1e3:.1f} ms (vision tower "
          f"{vision_s * 1e3:.1f} ms), prefill {timings['prefill_tok_s']:.1f} tok/s "
          f"({prompt_tokens} prompt tokens / TTFT), decode {decode_ms:.2f} ms/step "
          f"(batch {len(prompts)}, {steps} steps; median of {time_reps})", flush=True)
    return timings


def phase_memory(label):
    """Report the phase's peak device memory, after its engine was dropped,
    and start the next phase's count."""
    import torch

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    print(f"{label}: peak device memory {peak:.2f} GiB; after freeing "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    return peak


def kernel_vs_dense_end_to_end(model, cfg, prompt, tiles, device):
    """Phase 5: last-position logits of attn_impl auto (kernel) and dense,
    on the same weights (the dense twin shares the parameter storage)."""
    import torch

    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.ops.flash_attention import flash_attention

    dense_cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="dense"),
        text=dataclasses.replace(cfg.text, attn_impl="dense"))
    dense = LeopardVLM(dense_cfg, device="meta")
    dense.load_state_dict(model.state_dict(), assign=True)
    s = 4096  # the prompt's bucket
    tokens = torch.zeros((1, s), dtype=torch.int32, device=device)
    tokens[0, : len(prompt)] = torch.from_numpy(prompt).to(device)
    seg = (torch.arange(s, device=device) < len(prompt)).to(torch.int32)[None]
    last = torch.tensor([len(prompt) - 1], device=device)
    images = torch.from_numpy(tiles).to(device)
    logits = {}
    with torch.inference_mode():
        for name, m in (("kernel", model), ("dense", dense)):
            flash_attention.launches = 0
            out, _ = m(tokens, images=images, segment_ids=seg, logits_indices=last)
            torch.cuda.synchronize()
            logits[name] = (out[0, 0].float(), flash_attention.launches)
    (lk, nk), (ld, nd) = logits["kernel"], logits["dense"]
    if nk != cfg.vision.num_layers + cfg.text.num_layers or nd != 0:
        raise AssertionError(f"kernel path launched {nk}, dense path {nd} times")
    if not (torch.isfinite(lk).all() and torch.isfinite(ld).all()):
        raise AssertionError("non-finite logits")
    cos = torch.nn.functional.cosine_similarity(lk, ld, dim=0).item()
    same_argmax = int(lk.argmax()) == int(ld.argmax())
    print(f"end to end, kernel vs dense (1 request, {len(prompt)} tokens, "
          f"{TILES_PER_REQUEST} tiles): cosine {cos:.6f} (min {COSINE_MIN}), "
          f"argmax agrees: {same_argmax}, max |diff| {(lk - ld).abs().max().item():.4g}",
          flush=True)
    if cos < COSINE_MIN:
        raise AssertionError(f"cosine {cos} < {COSINE_MIN}")
    return cos, same_argmax


def int4_vs_dense_decode_step(int4_model, cfg, prompt, tiles, device):
    """Phase 7: one decode step's logits through the int4 model (K4 on every
    decode matmul) against the same step through a bf16 model whose text
    weights are the int4 weights dequantized, (q − 8) · s in fp32 rounded
    once to bf16, the rule of K4's plain version. Both prefill the same
    prompt (the int4 prefill takes the dense path with the same weights) and
    decode the same token."""
    import torch

    from leopard_tpu_torch.models.decoder import KVCache
    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.ops import quant
    from leopard_tpu_torch.ops.int4_matmul import int4_matmul

    dense = LeopardVLM(cfg, device="meta")
    quant.quantize_tree(dense.text, mode="int4")  # the structure only
    dense.load_state_dict(int4_model.state_dict(), assign=True)
    quant.dequantize_tree(dense.text, dtype=int4_model.text.embed_tokens.dtype)  # bf16 at 8B
    s = 4096  # the prompt's bucket
    tokens = torch.zeros((1, s), dtype=torch.int32, device=device)
    tokens[0, : len(prompt)] = torch.from_numpy(prompt).to(device)
    seg = (torch.arange(s, device=device) < len(prompt)).to(torch.int32)[None]
    last = torch.tensor([len(prompt) - 1], device=device)
    images = torch.from_numpy(tiles).to(device)
    step_token = None
    logits = {}
    with torch.inference_mode():
        for name, m in (("int4", int4_model), ("dense", dense)):
            cache = KVCache.create(cfg.text, 1, s + 512, device=device)
            first, cache = m(tokens, images=images, segment_ids=seg, cache=cache,
                             logits_indices=last, fresh_cache=True)
            if step_token is None:
                step_token = first[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            int4_matmul.launches = 0
            out, _ = m(step_token, cache=cache)
            torch.cuda.synchronize()
            logits[name] = (out[0, 0].float(), int4_matmul.launches)
    del dense
    (lq, nq), (ld, nd) = logits["int4"], logits["dense"]
    per_step = 7 * cfg.text.num_layers + 1
    if nq != per_step or nd != 0:
        raise AssertionError(f"int4 step launched K4 {nq} times (expected {per_step}), dense {nd}")
    if not (torch.isfinite(lq).all() and torch.isfinite(ld).all()):
        raise AssertionError("non-finite logits")
    cos = torch.nn.functional.cosine_similarity(lq, ld, dim=0).item()
    same_argmax = int(lq.argmax()) == int(ld.argmax())
    print(f"end to end, int4 (K4) vs dequantized bf16 (one decode step after a "
          f"{len(prompt)}-token prompt, {nq} K4 launches): cosine {cos:.6f} (min {COSINE_MIN}), "
          f"argmax agrees: {same_argmax}, max |diff| {(lq - ld).abs().max().item():.4g}",
          flush=True)
    if cos < COSINE_MIN:
        raise AssertionError(f"cosine {cos} < {COSINE_MIN}")
    return cos, same_argmax


# phases 10-14: prefixes, multi-turn chat, chunked prefill, speculative
# decode and beam search, at 8B in bf16 (phase 13: int4 weights, int8 KV)
DOC_TEXT = 299             # shared document: BOS, 16 tiles, 299 text = 3,004 tokens
QUESTIONS = (40, 90)       # text tokens of the two questions about it
TURN2_TEXT = 300           # turn 2: 16 new tiles, 300 text = 3,004 tokens
CHUNKED_TILES, CHUNKED_TEXT = 32, 1000   # 6,408 tokens: two chunks of 4,096
CHUNKED_BUCKETS = (256, 512, 1024, 2048, 4096)
SPEC_PASSAGE, SPEC_REPEATS, SPEC_NEW = 200, 3, 32
BEAM_WIDTH, BEAM_NEW = 4, 16


def tile_prompt(cfg, rng, n_tiles, n_text, bos):
    """[BOS,] n_tiles' image tokens, n_text random text tokens; the tiles
    as uint8 364x364 pixels."""
    img = np.full(n_tiles * cfg.anyres.tokens_per_tile, cfg.image_token_id, np.int32)
    text = rng.randint(0, 128000, size=n_text).astype(np.int32)
    prompt = np.concatenate([[128000] if bos else [], img, text]).astype(np.int32)
    size = cfg.vision.image_size
    return prompt, rng.randint(0, 256, (n_tiles, size, size, 3), dtype=np.uint8)


class Launches:
    """Kernel launch counts (and calls of the chunked continuation tier, a
    plain-PyTorch function counted here by a wrapper around the decoder's
    reference to it) over a `with` block: every count is set to 0 on entry
    and read on exit into `self.counts`."""

    def __init__(self):
        from leopard_tpu_torch.models import decoder
        from leopard_tpu_torch.ops.flash_attention import flash_attention
        from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
        from leopard_tpu_torch.ops.int4_matmul import int4_matmul

        self.counters = {"flash_attention": flash_attention, "int4_matmul": int4_matmul,
                         "fused_rms_norm": fused_rms_norm, "fused_layer_norm": fused_layer_norm}
        self.decoder = decoder
        self.cont_calls = []
        real = decoder.chunked_continuation_attention

        def counted(q, k, *args, **kw):
            self.cont_calls.append((tuple(q.shape), tuple(k.shape), str(k.dtype),
                                    kw["chunk_size"]))
            return real(q, k, *args, **kw)

        decoder.chunked_continuation_attention = counted
        self.counts = {}

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        for c in self.counters.values():
            c.launches = 0
        self.cont_calls.clear()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.counts = {k: c.launches for k, c in self.counters.items()}
        self.counts["chunked_continuation_attention"] = len(self.cont_calls)
        return False


def expect(label, counts, want):
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def logits_agree(label, got, want):
    """Per-row cosine of two first-step logits [B, V]; both must be finite
    and every row at least COSINE_MIN. Returns (cosines, argmax agreement)."""
    import torch

    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{label}: non-finite logits")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).tolist()
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    print(f"{label}: first-step logits cosine per row {[round(c, 6) for c in cos]} "
          f"(min {COSINE_MIN}), argmax agrees {same}, max |diff| "
          f"{(got - want).abs().max().item():.4g}", flush=True)
    if min(cos) < COSINE_MIN:
        raise AssertionError(f"{label}: cosine {cos} < {COSINE_MIN}")
    return cos, same


def tokens_agree(a, b):
    """Whether two token lists agree, and where they first differ."""
    n = min(len(a), len(b))
    diff = [i for i in range(n) if a[i] != b[i]]
    first = diff[0] if diff else (None if len(a) == len(b) else n)
    return first is None, first


def check_conversation(label, prefix):
    """The cache that return_prefix hands back holds every token so far."""
    index = prefix.cache.index.tolist()
    valid = int((prefix.cache.seg != 0).sum())
    if not (index == [prefix.length] and prefix.length == len(prefix.tokens) == valid):
        raise AssertionError(f"{label}: index {index}, length {prefix.length}, "
                             f"{len(prefix.tokens)} tokens, {valid} valid slots")


def cache_snapshot(prefix):
    c = prefix.cache
    return [t.clone() for t in (c.kv, c.seg, c.index, c.kv_scale) if t is not None]


def check_unchanged(label, prefix, snap):
    import torch

    c = prefix.cache
    now = [t for t in (c.kv, c.seg, c.index, c.kv_scale) if t is not None]
    if not all(torch.equal(a, b) for a, b in zip(now, snap)):
        raise AssertionError(f"{label}: the prefix's cache was written")


def ttft_s(engine, prompts, images=None, prefix=None):
    """Median of 3 of a generate with max_new_tokens=1, as phase 4."""
    from leopard_tpu_torch.config import GenerateConfig

    gen = GenerateConfig(max_new_tokens=1)
    return wall_s(lambda: engine.generate(prompts, images=images, gen_cfg=gen, prefix=prefix))


def prefix_phase(engine, cfg, launches, card):
    """Phase 10: build_prefix of a shared document, then two questions with
    prefix=, held against generate on the concatenated prompts."""
    from leopard_tpu_torch.config import GenerateConfig

    rng = np.random.RandomState(SEED + 10)
    doc, doc_tiles = tile_prompt(cfg, rng, TILES_PER_REQUEST, DOC_TEXT, bos=True)
    questions = [rng.randint(0, 128000, size=n).astype(np.int32) for n in QUESTIONS]
    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS)
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    with launches:
        prefix = engine.build_prefix(doc, images=doc_tiles)
    build = launches.counts
    expect("build_prefix", build, {"flash_attention": lv + lt, "fused_layer_norm": 2 * lv + 1,
                                   "fused_rms_norm": 2 * lt + 1})
    snap = cache_snapshot(prefix)
    with launches:
        res = engine.generate(questions, gen_cfg=gen, prefix=prefix)
    steps = max(min(MAX_NEW_TOKENS, len(t) + 1) for t in res.tokens) - 1
    # the suffixes (bucket 256) take the dense continuation: no K1, no tower
    expect("generate(prefix=)", launches.counts,
           {"flash_attention": 0, "fused_rms_norm": (2 * lt + 1) * (1 + steps),
            "chunked_continuation_attention": 0})
    with_prefix = launches.counts
    full_prompts = [np.concatenate([doc, q]) for q in questions]
    full_tiles = np.concatenate([doc_tiles] * len(questions))
    full = engine.generate(full_prompts, images=full_tiles, gen_cfg=gen)
    lp, _ = engine.prefill(questions, prefix=prefix)
    lf, _ = engine.prefill(full_prompts, images=full_tiles)
    cos, _ = logits_agree("prefix vs concatenated prompts", lp, lf)
    agree = [tokens_agree(a.tolist(), b.tolist()) for a, b in zip(res.tokens, full.tokens)]
    t_prefix = ttft_s(engine, questions, prefix=prefix)
    t_full = ttft_s(engine, full_prompts, images=full_tiles)
    check_unchanged("prefix phase", prefix, snap)
    print(f"prefix: document {len(doc)} tokens ({TILES_PER_REQUEST} tiles), build_prefix "
          f"launches {build}; 2 questions of {list(QUESTIONS)} tokens, launches {with_prefix}; "
          f"tokens agree with the concatenated path (identical, first divergence): {agree}; "
          f"prefix unchanged after {2 + 3 + 1} generate/prefill calls; TTFT with prefix "
          f"{t_prefix * 1e3:.1f} ms, concatenated {t_full * 1e3:.1f} ms (median of 3) "
          f"[{card}]", flush=True)
    return {"doc_tokens": len(doc), "build_prefix_launches": build,
            "launches": with_prefix, "cosine": cos, "tokens_agree": agree,
            "ttft_prefix_s": t_prefix, "ttft_concatenated_s": t_full}


def multiturn(engine, cfg, launches, turn1, tiles1, turn2, tiles2, label, k4_per_step=0):
    """Turn 1 with return_prefix, turn 2 (>= long_seq_threshold tokens into
    the filled cache: the chunked continuation tier) with prefix= and
    return_prefix; turn 2's first-step logits against the concatenated
    conversation's. Returns the turn-2 record and turn 1's prefix."""
    from leopard_tpu_torch.config import GenerateConfig

    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS)
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    r1 = engine.generate([turn1], images=tiles1, gen_cfg=gen, return_prefix=True)
    check_conversation(f"{label} turn 1", r1.prefix)
    snap = cache_snapshot(r1.prefix)
    with launches:
        r2 = engine.generate([turn2], images=tiles2, gen_cfg=gen, prefix=r1.prefix,
                             return_prefix=True)
    counts, cont = launches.counts, list(launches.cont_calls)
    check_conversation(f"{label} turn 2", r2.prefix)
    check_unchanged(f"{label} turn 1's prefix", r1.prefix, snap)
    # forwards: the prefill, then one per emitted token (the last included)
    forwards = 1 + r2.prefix.length - r1.prefix.length - len(turn2)
    want = {"flash_attention": lv, "chunked_continuation_attention": lt,
            "fused_rms_norm": (2 * lt + 1) * forwards}
    if k4_per_step:
        want["int4_matmul"] = 1 + k4_per_step * (forwards - 1)
    expect(f"{label} turn 2", counts, want)
    full = np.concatenate([r1.prefix.tokens, turn2])
    full_tiles = np.concatenate([tiles1, tiles2])
    lt2, _ = engine.prefill([turn2], images=tiles2, prefix=r1.prefix)
    lre, _ = engine.prefill([full], images=full_tiles)
    cos, _ = logits_agree(f"{label}: turn 2 vs the re-prefilled conversation", lt2, lre)
    again = engine.generate([full], images=full_tiles, gen_cfg=gen)
    agree = tokens_agree(r2.tokens[0].tolist(), again.tokens[0].tolist())
    print(f"{label}: turn 1 {len(turn1)} tokens -> prefix {r1.prefix.length}; turn 2 "
          f"{len(turn2)} tokens -> prefix {r2.prefix.length} (index == length == tokens, "
          f"turn 1's prefix unchanged); turn 2 launches {counts}, chunked continuation "
          f"calls {cont[:1]} x {len(cont)}; tokens agree with the re-prefill (identical, "
          f"first divergence): {agree}", flush=True)
    return {"turn1_tokens": len(turn1), "turn2_tokens": len(turn2),
            "prefix_lengths": [r1.prefix.length, r2.prefix.length], "launches": counts,
            "continuation_calls": cont[:1], "cosine": cos, "tokens_agree": agree,
            "conversation_tokens": len(full)}, r1.prefix


def multiturn_phase(engine, cfg, launches, prompts, tiles, card):
    """Phase 11: bf16 multi-turn, then turn 2's TTFT against the re-prefill
    of the whole conversation."""
    rng = np.random.RandomState(SEED + 11)
    turn2, tiles2 = tile_prompt(cfg, rng, TILES_PER_REQUEST, TURN2_TEXT, bos=False)
    tiles1 = tiles[:TILES_PER_REQUEST]
    rec, prefix = multiturn(engine, cfg, launches, prompts[0], tiles1, turn2, tiles2,
                            "multi-turn bf16")
    full, full_tiles = np.concatenate([prefix.tokens, turn2]), np.concatenate([tiles1, tiles2])
    rec["ttft_turn2_s"] = ttft_s(engine, [turn2], images=tiles2, prefix=prefix)
    rec["ttft_reprefill_s"] = ttft_s(engine, [full], images=full_tiles)
    print(f"multi-turn timing [{card}]: turn 2 TTFT {rec['ttft_turn2_s'] * 1e3:.1f} ms "
          f"({len(turn2)} new tokens over a {prefix.length}-token prefix), re-prefill of the "
          f"{len(full)}-token conversation {rec['ttft_reprefill_s'] * 1e3:.1f} ms "
          f"(median of 3)", flush=True)
    return rec, (prefix, turn2, tiles2)


def chunked_phase(model, engine, cfg, launches, card):
    """Phase 12: a 6,408-token prompt through an engine whose largest bucket
    is 4,096 (two chunks: K1, then the chunked continuation tier), against
    the default engine's single-shot prefill."""
    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.engine import Engine

    rng = np.random.RandomState(SEED + 12)
    prompt, ptiles = tile_prompt(cfg, rng, CHUNKED_TILES, CHUNKED_TEXT, bos=False)
    small = Engine(cfg, model, seq_buckets=CHUNKED_BUCKETS)
    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS)
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    with launches:
        res = small.generate([prompt], images=ptiles, gen_cfg=gen)
    counts = launches.counts
    expect("chunked prefill", counts, {"flash_attention": lv + lt,
                                       "chunked_continuation_attention": lt})
    lc, _ = small.prefill([prompt], images=ptiles)
    ls, _ = engine.prefill([prompt], images=ptiles)
    cos, _ = logits_agree("chunked prefill vs single shot", lc, ls)
    single = engine.generate([prompt], images=ptiles, gen_cfg=gen)
    agree = tokens_agree(res.tokens[0].tolist(), single.tokens[0].tolist())
    t_chunked = ttft_s(small, [prompt], images=ptiles)
    t_single = ttft_s(engine, [prompt], images=ptiles)
    print(f"chunked prefill: {len(prompt)} tokens ({CHUNKED_TILES} tiles), largest bucket "
          f"{CHUNKED_BUCKETS[-1]}: launches {counts}; tokens agree with single shot "
          f"(identical, first divergence): {agree}; TTFT chunked {t_chunked * 1e3:.1f} ms, "
          f"single shot {t_single * 1e3:.1f} ms (median of 3) [{card}]", flush=True)
    del small
    return {"prompt_tokens": len(prompt), "launches": counts, "cosine": cos,
            "tokens_agree": agree, "ttft_chunked_s": t_chunked, "ttft_single_s": t_single}


def spec_prompt(rng):
    passage = rng.randint(0, 128000, size=SPEC_PASSAGE).astype(np.int32)
    return np.concatenate([[128000]] + [passage] * SPEC_REPEATS).astype(np.int32)


def spec_phase(engine, cfg, launches, card, label, k4_per_step=0):
    """Speculative decode (n-gram 2, draft 7) against plain greedy on a
    prompt that repeats a passage; with int4 weights, K4 per verify round."""
    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.speculative import SpecConfig

    prompt = spec_prompt(np.random.RandomState(SEED + 14))
    gen = GenerateConfig(max_new_tokens=SPEC_NEW)
    plain = engine.generate([prompt], gen_cfg=gen)
    with launches:
        sp = engine.generate([prompt], gen_cfg=gen, spec=SpecConfig(ngram=2, draft=7))
    counts, rounds = launches.counts, sp.spec_rounds
    got, want = sp.tokens[0].tolist(), plain.tokens[0].tolist()
    if not got or got[0] != want[0]:
        raise AssertionError(f"{label}: first token {got[:1]} != plain greedy's {want[:1]}")
    if not 1 <= rounds <= len(got):
        raise AssertionError(f"{label}: {rounds} rounds for {len(got)} tokens")
    lt = cfg.text.num_layers
    want_counts = {"fused_rms_norm": (2 * lt + 1) * (1 + rounds)}
    if k4_per_step:
        want_counts["int4_matmul"] = 1 + k4_per_step * rounds
    expect(label, counts, want_counts)
    same, first = tokens_agree(got, want)
    print(f"{label}: prompt {len(prompt)} tokens ({SPEC_REPEATS} x a {SPEC_PASSAGE}-token "
          f"passage), {len(got)} tokens in {rounds} verify rounds ({len(got) / rounds:.3f} "
          f"tokens a round; random weights accept almost no draft, so this measures the "
          f"mechanism, not a gain), first token equals plain greedy's, identical to plain "
          f"greedy {same}, first divergence {first}; launches {counts} [{card}]", flush=True)
    return {"tokens": len(got), "rounds": rounds, "tokens_per_round": len(got) / rounds,
            "identical_to_greedy": same, "first_divergence": first, "launches": counts}


def beam_phase(engine, cfg, launches, card):
    from leopard_tpu_torch.inference.beam import beam_search

    prompt = spec_prompt(np.random.RandomState(SEED + 14))
    with launches:
        out = beam_search(engine, prompt, beam_width=BEAM_WIDTH, max_new_tokens=BEAM_NEW)
    out = np.asarray(out)
    if not (out.ndim == 1 and len(out) <= BEAM_NEW
            and np.all((out >= 0) & (out < cfg.text.vocab_size))
            and not np.isin(out, (128001, 128009)).any()):
        raise AssertionError(f"beam search returned {out}")
    expect("beam search", launches.counts,
           {"fused_rms_norm": (2 * cfg.text.num_layers + 1) * BEAM_NEW})
    print(f"beam search: width {BEAM_WIDTH}, {BEAM_NEW} new tokens: {len(out)} tokens "
          f"{out.tolist()}, launches {launches.counts} [{card}]", flush=True)
    return {"tokens": out.tolist(), "launches": launches.counts}


def continuation_timing(cfg, prefix_len, new_tokens, device, card):
    """chunked_continuation_attention's own time per call at turn 2's shape
    (one layer: the new tokens' queries over a cache of round_up(prefix +
    bucket + 16, 512) slots), float and int8 cache, beside SDPA on the same
    inputs with the equivalent boolean mask (kv heads repeated to the q
    heads), and the largest difference from SDPA over the valid queries."""
    import torch
    import torch.nn.functional as F

    from leopard_tpu_torch.models.decoder import _q8
    from leopard_tpu_torch.ops.chunked_attention import (chunked_continuation_attention,
                                                          pick_chunk)

    t = cfg.text
    bucket = 4096
    s_max = -(-(prefix_len + bucket + MAX_NEW_TOKENS) // 512) * 512
    chunk = pick_chunk(s_max, t.attn_chunk_size)
    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn((1, bucket, t.num_heads, t.head_dim), generator=g, device=device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, s_max, t.num_kv_heads, t.head_dim), generator=g, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    valid = torch.zeros((1, s_max), dtype=torch.int32, device=device)
    valid[0, : prefix_len + new_tokens] = 1
    pos = prefix_len + torch.arange(bucket, device=device)[None]
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    run = {
        "float": lambda: chunked_continuation_attention(q, k, v, valid, pos, chunk_size=chunk),
        "int8": lambda: chunked_continuation_attention(q, kq, vq, valid, pos, k_scale=ks,
                                                       v_scale=vs, chunk_size=chunk),
    }
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = run["float"]()
    extra_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    ms = {name: cuda_ms(fn) for name, fn in run.items()}
    slot = torch.arange(s_max, device=device)
    mask = ((pos[0, :, None] >= slot[None]) & (valid[0] != 0)[None])[None, None]
    group = t.num_heads // t.num_kv_heads
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(group, 2),
                                               v.repeat_interleave(group, 2)))
    with torch.no_grad():
        ref = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask).transpose(1, 2)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    rows = slice(0, new_tokens)
    err = (out[:, rows].float() - ref[:, rows].float()).abs().max().item()
    print(f"chunked_continuation_attention at turn 2's shape (q [1, {bucket}, {t.num_heads}, "
          f"{t.head_dim}], cache {s_max} slots, {prefix_len + new_tokens} valid, chunk "
          f"{chunk}): float cache {ms['float']:.3f} ms, int8 cache {ms['int8']:.3f} ms a call "
          f"(one layer; {ms['float'] * t.num_layers:.1f} ms for {t.num_layers}), SDPA with "
          f"the boolean mask {sdpa_ms:.3f} ms; max |diff| vs SDPA over the {new_tokens} valid "
          f"queries {err:.4g}; working memory {extra_gib:.2f} GiB [{card}]", flush=True)
    return {"ms_float": ms["float"], "ms_int8": ms["int8"], "sdpa_masked_ms": sdpa_ms,
            "max_abs_diff_vs_sdpa": err, "s_max": s_max, "chunk": chunk,
            "working_gib": extra_gib}


# phases 15-17: the serving front end (HTTP server, text API) and the slot
# pool of continuous batching, at 8B (phase 17: int4 weights, int8 KV and a
# shared prefix)
CHAT_TEXT = (3000, 300)            # characters of the two chat turns
SERVER_TEXT = (1500, 3000)         # characters of the two /api/generate prompts
SERVER_BUDGETS = [8, 16]
SERVER_PNGS = ((728, 364), (364, 1092))   # (width, height) of the posted images
POOL = dict(slots=8, cache_len=4608, max_new_cap=64, segment_steps=16)
POOL_QUEUE, POOL_IMAGE_AT = 16, (0, 5, 10, 15)
POOL_TEXT = (100, 1800)            # text requests' lengths, drawn uniformly
POOL_BUDGETS = (8, 16, 32, 64)
POOL_INT4 = dict(slots=8, cache_len=2560, max_new_cap=32, segment_steps=16)
POOL_INT4_PREFIX, POOL_INT4_TEXT, POOL_INT4_BUDGETS = 1000, (100, 900), (8, 32)
NO_EOS = 999999                    # an eos id no request reaches: each ends by its budget


class ByteTokenizer:
    """The smoke's own tokenizer: a character is ord(c) % 1000; the Llama-3
    header and eot strings and the reserved tokens are their ids; decode
    joins the ids. add_special_tokens puts BOS first."""

    bos_token_id = 128000
    SPECIALS = {"<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
                "<|eot_id|>": 128009}

    def __call__(self, text, add_special_tokens=False):
        ids = [self.bos_token_id] if add_special_tokens else []
        i = 0
        while i < len(text):
            special = next((s for s in self.SPECIALS if text.startswith(s, i)), None)
            if special is not None:
                ids.append(self.SPECIALS[special])
                i += len(special)
            else:
                ids.append(ord(text[i]) % 1000)
                i += 1
        return {"input_ids": ids}

    def convert_tokens_to_ids(self, tok):
        import re

        m = re.fullmatch(r"<\|reserved_special_token_(\d+)\|>", tok)
        return 128010 + int(m.group(1)) - 5 if m else None

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def random_text(rng, n):
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz ,."), size=n))


def noise_png(rng, w, h) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def http_call(url, payload=None):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=300) as r:
        return r.status, json.loads(r.read())


def server_phase(engine, cfg, launches, card):
    """Phase 15: GenerationServer over HTTP on 127.0.0.1 (bf16): two text
    prompts, a two-turn chat, two PNGs where Pillow imports, and
    Predictor.predict_file, each against the engine called directly."""
    import tempfile
    import threading
    import urllib.error

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.api import Predictor, generate_and_post_process
    from leopard_tpu_torch.inference.server import GenerationServer

    tok = ByteTokenizer()
    rng = np.random.RandomState(SEED + 15)
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    server = GenerationServer(engine, tok, host="127.0.0.1", port=0)
    httpd = server.http_server()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rec = {}
    try:
        deadline = time.perf_counter() + 30
        while True:
            try:
                if http_call(url + "/health") == (200, {"status": "ok"}):
                    break
            except (urllib.error.URLError, ConnectionError):
                if time.perf_counter() > deadline:
                    raise
            time.sleep(0.05)

        # (a) two text prompts, packed at bucket 4,096: K1 in the decoder
        prompts = [random_text(rng, n) for n in SERVER_TEXT]
        payload = {"prompts": prompts, "max_new_tokens": SERVER_BUDGETS, "greedy": True,
                   "eos_token_ids": [NO_EOS]}
        with launches:
            status, out = http_call(url + "/api/generate", payload)
        counts = launches.counts
        ids = [np.asarray(tok(p, add_special_tokens=True)["input_ids"], np.int32)
               for p in prompts]
        steps = max(SERVER_BUDGETS)
        direct = engine.generate(ids, gen_cfg=GenerateConfig(max_new_tokens=steps,
                                                             eos_token_ids=(NO_EOS,)))
        want = [t[:b].tolist() for t, b in zip(direct.tokens, SERVER_BUDGETS)]
        if status != 200 or out["tokens"] != want:
            raise AssertionError(f"/api/generate: {status}, tokens {out.get('tokens')} != {want}")
        expect("/api/generate", counts, {"flash_attention": lt, "fused_layer_norm": 0,
                                         "fused_rms_norm": (2 * lt + 1) * steps})
        rec["generate"] = {"prompt_tokens": [len(i) for i in ids], "launches": counts}

        # (b) a two-turn chat against generate(return_prefix / prefix=)
        sid = "smoke"
        turns = [random_text(rng, n) for n in CHAT_TEXT]
        gen = GenerateConfig(max_new_tokens=8, eos_token_ids=(NO_EOS,))
        prefix, chat = None, []
        for text in turns:
            status, out = http_call(url + "/api/chat", {
                "session_id": sid, "prompt": text, "max_new_tokens": 8, "greedy": True,
                "eos_token_ids": [NO_EOS]})
            turn_ids = np.asarray(tok(text, add_special_tokens=True)["input_ids"], np.int32)
            res = engine.generate([turn_ids], gen_cfg=gen, prefix=prefix, return_prefix=True)
            prefix = res.prefix
            if (status != 200 or out["tokens"] != res.tokens[0].tolist()
                    or out["context_tokens"] != prefix.length):
                raise AssertionError(f"/api/chat turn {len(chat) + 1}: {status} {out} != "
                                     f"{res.tokens[0].tolist()}, context {prefix.length}")
            chat.append(out["context_tokens"])
        if http_call(url + "/api/chat", {"session_id": sid, "reset": True}) != (
                200, {"status": "reset"}) or sid in server._sessions:
            raise AssertionError("/api/chat reset failed")
        rec["chat_context_tokens"] = chat

        # (c) two PNGs, where Pillow imports on this machine
        try:
            import PIL  # noqa: F401
            pil = True
        except ImportError:
            pil = False
        rec["pil"] = pil
        if pil:
            from leopard_tpu_torch.inference.server import _decode_images

            pngs = [noise_png(rng, w, h) for w, h in SERVER_PNGS]
            text = "<image> and <image>: " + random_text(rng, 200)
            payload = {"prompts": [text], "images": [pngs], "max_new_tokens": 8,
                       "greedy": True, "eos_token_ids": [NO_EOS]}
            with launches:
                status, out = http_call(url + "/api/generate", payload)
            counts = launches.counts
            row_ids, tiles, _ = server._prepare_row(text, _decode_images(pngs))
            res = engine.generate([row_ids], images=tiles, gen_cfg=gen)
            if status != 200 or out["tokens"] != [res.tokens[0].tolist()]:
                raise AssertionError(f"/api/generate with images: {status} {out} != "
                                     f"{res.tokens[0].tolist()}")
            bucket = engine._bucket(len(row_ids), engine.seq_buckets)
            expect("/api/generate with images", counts, {
                "flash_attention": lv + (lt if bucket >= cfg.text.long_seq_threshold else 0),
                "fused_layer_norm": 2 * lv + 1})
            rec["images"] = {"tiles": int(tiles.shape[0]), "prompt_tokens": len(row_ids),
                             "bucket": bucket, "launches": counts}

        # (d) Predictor.predict_file against generate_and_post_process
        lines = [random_text(rng, n) for n in (60, 200, 120, 30)]
        with tempfile.TemporaryDirectory() as tmp:
            src, dst = Path(tmp) / "in.jsonl", Path(tmp) / "out.jsonl"
            src.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in lines))
            Predictor(engine, tok, gen).predict_file(str(src), str(dst), batch_size=2)
            got = [json.loads(line) for line in dst.read_text().splitlines()]
        want = [text for i in (0, 2) for text in
                generate_and_post_process(engine, tok, lines[i:i + 2], gen).texts]
        if [g["prompt"] for g in got] != lines or [g["output"] for g in got] != want:
            raise AssertionError(f"predict_file: {got} != {want}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    print(f"server: HTTP on 127.0.0.1; /api/generate 2 prompts {rec['generate']['prompt_tokens']} "
          f"tokens, budgets {SERVER_BUDGETS}, launches {rec['generate']['launches']}; "
          f"/api/chat 2 turns, context {chat} tokens; images {json.dumps({'pil': pil})} "
          f"{rec.get('images', '')}; predict_file 4 lines equal generate_and_post_process; "
          f"tokens identical to the engine's [{card}]", flush=True)
    return rec


def pool_queue(cfg, rng):
    """Phase 16's queue: 16 requests, image ones (16 uint8 tiles + 300 text
    tokens) at POOL_IMAGE_AT, text ones of POOL_TEXT tokens; budgets drawn
    from POOL_BUDGETS."""
    from leopard_tpu_torch.inference.continuous import Request

    reqs = []
    for i in range(POOL_QUEUE):
        budget = int(rng.choice(POOL_BUDGETS))
        if i in POOL_IMAGE_AT:
            prompt, tiles = tile_prompt(cfg, rng, TILES_PER_REQUEST, 300, bos=False)
            reqs.append(Request(prompt=prompt, max_new_tokens=budget, images=tiles))
        else:
            n = int(rng.randint(POOL_TEXT[0], POOL_TEXT[1] + 1))
            reqs.append(Request(prompt=rng.randint(0, 128000, n).astype(np.int32),
                                max_new_tokens=budget))
    return reqs


def staged_logits_agree(label, cont, reqs, prefix=None):
    """First-step logits of the pool's staged prefills (_prefill_one per
    image request, _prefill_block over the text requests in blocks of at
    most 8) against Engine.prefill of each prompt alone."""
    import torch

    eng = cont.engine
    got, want = [], []
    text = [r for r in reqs if r.images is None]
    for r in reqs:
        if r.images is not None:
            got.append(cont._prefill_one(r, prefix)[0])
            want.append(eng.prefill([r.prompt], images=r.images, prefix=prefix)[0])
    for i in range(0, len(text), 8):
        part = text[i:i + 8]
        nb = 1 << (len(part) - 1).bit_length()
        got.append(cont._prefill_block(part, nb, prefix)[0][: len(part)])
        want += [eng.prefill([r.prompt], prefix=prefix)[0] for r in part]
    cos, _ = logits_agree(label, torch.cat(got), torch.cat(want))
    return cos


def run_pool(cont, reqs, launches, gen, prefix=None):
    """One timed run of the pool, with every kernel counted."""
    import torch

    from leopard_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.copies = 0
    with launches:
        t0 = time.perf_counter()
        out = cont.run(reqs, gen_cfg=gen, prefix=prefix)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, launches.counts, flash_attention.copies


def pool_report(cont, reqs, wall):
    """Tokens/s, TTFT percentiles, and the host ms a segment step: the run's
    wall time less staging and refills, over the segments' steps."""
    ttft = sorted(cont.ttft.values())
    tokens = sum(r.max_new_tokens for r in reqs)
    st = cont.stats
    steps = cont.segment_steps * st["segments"]
    return {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "segment_step_ms": (wall - st["stage_s"] - st["refill_s"]) / steps * 1e3,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "stats": dict(cont.stats)}


def continuous_phase(engine, cfg, launches, card):
    """Phase 16: the slot pool in bf16 over a queue of image and text
    requests; launch counts, budgets, the image requests' first tokens and
    the staged prefills' logits; then throughput, TTFT and the same queue
    served statically in groups of 8."""
    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.continuous import ContinuousEngine

    reqs = pool_queue(cfg, np.random.RandomState(SEED + 16))
    cont = ContinuousEngine(engine, **POOL)
    gen = GenerateConfig(eos_token_ids=(NO_EOS,))
    out, wall1, counts, copies = run_pool(cont, reqs, launches, gen)
    staged = [tuple(shape) for shape in cont.stats["staged_shapes"]]
    got = [c.tokens.tolist() for c in out]
    if [len(t) for t in got] != [r.max_new_tokens for r in reqs]:
        raise AssertionError(f"pool: lengths {[len(t) for t in got]} != budgets "
                             f"{[r.max_new_tokens for r in reqs]}")
    if copies:
        raise AssertionError(f"pool: K1 copied {copies} inputs")
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    thr = cfg.text.long_seq_threshold
    n_img = sum(r.images is not None for r in reqs)
    forwards = len(staged) + POOL["segment_steps"] * cont.stats["segments"]
    # K1: the tower of each image request, the decoder of each staged prefill
    # whose bucket reaches the flash tier (at 8B: 59 an image request, 32 a
    # text block of bucket 2,048)
    flash = [(rows, bucket) for rows, bucket in staged if bucket >= thr]
    expect("pool", counts, {
        "flash_attention": lv * n_img + lt * len(flash),
        "fused_layer_norm": (2 * lv + 1) * n_img,
        "fused_rms_norm": (2 * lt + 1) * forwards})
    checked = {(kw["b"], kw["s"]) for kw in K1_SHAPES.values() if kw["causal"]}
    if set(flash) - checked:
        raise AssertionError(f"pool: K1 ran in the decoder at [rows, bucket] "
                             f"{sorted(set(flash) - checked)}, which phase 3 did not hold "
                             f"against the plain version (it held {sorted(checked)})")
    serial = [engine.generate([r.prompt], images=r.images, gen_cfg=dataclasses.replace(
        gen, max_new_tokens=r.max_new_tokens)).tokens[0].tolist() for r in reqs]
    for i in POOL_IMAGE_AT:
        if got[i][:1] != serial[i][:1]:
            raise AssertionError(f"pool: image request {i} first token {got[i][:1]} != serial "
                                 f"{serial[i][:1]}")
    agree = [tokens_agree(g, s) for g, s in zip(got, serial)]
    cos = staged_logits_agree("pool staged prefills vs Engine.prefill", cont, reqs)
    # the timed run, which must repeat the first
    out2, wall, _, _ = run_pool(cont, reqs, launches, gen)
    if [c.tokens.tolist() for c in out2] != got:
        raise AssertionError("pool: a second run gave other tokens")
    rec = pool_report(cont, reqs, wall)
    # the same queue served statically: groups of 8 in queue order, each run
    # to its largest budget
    groups = [reqs[i:i + POOL["slots"]] for i in range(0, len(reqs), POOL["slots"])]

    def static():
        for grp in groups:
            imgs = [r.images for r in grp if r.images is not None]
            engine.generate([r.prompt for r in grp],
                            images=np.concatenate(imgs) if imgs else None,
                            gen_cfg=dataclasses.replace(
                                gen, max_new_tokens=max(r.max_new_tokens for r in grp)))
    static_s = wall_s(static, reps=1)
    rec.update({"static_wall_s": static_s, "static_tokens_per_s": rec["tokens"] / static_s,
                "first_run_wall_s": wall1, "launches": counts, "cosine": cos,
                "tokens_agree_serial": agree, "prompt_tokens": [len(r.prompt) for r in reqs],
                "budgets": [r.max_new_tokens for r in reqs]})
    print(f"pool bf16: {len(reqs)} requests ({len(POOL_IMAGE_AT)} with {TILES_PER_REQUEST} "
          f"tiles), prompts {rec['prompt_tokens']}, budgets {rec['budgets']}, {POOL}; every "
          f"request got its budget; launches {counts} (staged [rows, bucket] {staged}, "
          f"{cont.stats['segments']} segments); identical to serial greedy (identical, first "
          f"divergence) {agree}", flush=True)
    print(f"pool bf16 timing [{card}]: {rec['tokens']} tokens in {wall:.3f} s = "
          f"{rec['tokens_per_s']:.1f} tok/s (first run {wall1:.3f} s), "
          f"{rec['segment_step_ms']:.2f} ms a segment step; TTFT p50 "
          f"{rec['ttft_p50_s'] * 1e3:.1f} ms, p99 {rec['ttft_p99_s'] * 1e3:.1f} ms; static "
          f"groups of {POOL['slots']}: {static_s:.3f} s = {rec['static_tokens_per_s']:.1f} "
          f"tok/s; stats {rec['stats']}", flush=True)
    return rec


def continuous_int4_phase(engine, cfg, launches, card, k4_checked):
    """Phase 17: the slot pool with int4 weights, the int8 KV cache and a
    shared 1,000-token prefix; K4 counted per decode step and prefill; a
    request whose bucket would run past the cache is refused, and the pool
    then serves the same queue again token for token."""
    import torch

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.continuous import ContinuousEngine, Request

    rng = np.random.RandomState(SEED + 17)
    prefix = engine.build_prefix(rng.randint(0, 128000, POOL_INT4_PREFIX).astype(np.int32))
    snap = cache_snapshot(prefix)
    reqs = [Request(prompt=rng.randint(0, 128000, int(rng.randint(*POOL_INT4_TEXT) + 1))
                    .astype(np.int32),
                    max_new_tokens=int(rng.randint(POOL_INT4_BUDGETS[0],
                                                   POOL_INT4_BUDGETS[1] + 1)))
            for _ in range(8)]
    cont = ContinuousEngine(engine, **POOL_INT4)
    gen = GenerateConfig(eos_token_ids=(NO_EOS,))
    out, wall, counts, _ = run_pool(cont, reqs, launches, gen, prefix=prefix)
    staged = [tuple(shape) for shape in cont.stats["staged_shapes"]]
    got = [c.tokens.tolist() for c in out]
    if [len(t) for t in got] != [r.max_new_tokens for r in reqs]:
        raise AssertionError(f"pool int4: lengths {[len(t) for t in got]}")
    lt = cfg.text.num_layers
    prefills = len(staged)
    k4 = (7 * lt + 1) * POOL_INT4["segment_steps"] * cont.stats["segments"] + prefills
    expect("pool int4 + int8 KV", counts, {"int4_matmul": k4, "flash_attention": 0,
                                           "chunked_continuation_attention": 0})
    # K4 runs every decode matmul at M = slots and each prefill's lm_head at
    # M = the block's rows
    ran = ({(POOL_INT4["slots"], name) for name in K4_SHAPES}
           | {(rows, "lm_head") for rows, _ in staged})
    if ran - k4_checked:
        raise AssertionError(f"pool int4: K4 ran at (M, matmul) {sorted(ran - k4_checked)}, "
                             f"which phase 3 did not hold against the plain version")
    rec = pool_report(cont, reqs, wall)
    cos = staged_logits_agree("pool int4 staged prefills vs Engine.prefill(prefix=)", cont,
                              reqs, prefix)
    too_long = Request(prompt=rng.randint(0, 128000, 1100).astype(np.int32), max_new_tokens=8)
    try:
        cont.run([too_long], gen_cfg=gen, prefix=prefix)
        raise AssertionError("pool int4: a 1,100-token request past the cache was admitted")
    except ValueError as e:
        refusal = str(e)
    torch.cuda.synchronize()
    check_unchanged("pool int4 prefix", prefix, snap)
    again = [c.tokens.tolist() for c in cont.run(reqs, gen_cfg=gen, prefix=prefix)]
    if again != got:
        raise AssertionError("pool int4: the run after the refusal gave other tokens")
    rec.update({"launches": counts, "cosine": cos, "refusal": refusal,
                "prompt_tokens": [len(r.prompt) for r in reqs],
                "budgets": [r.max_new_tokens for r in reqs]})
    print(f"pool int4 + int8 KV: prefix {POOL_INT4_PREFIX} tokens, 8 requests "
          f"{rec['prompt_tokens']}, budgets {rec['budgets']}, {POOL_INT4}; launches {counts} "
          f"(K4: {7 * lt + 1} x {POOL_INT4['segment_steps']} x {cont.stats['segments']} "
          f"segments + {prefills} prefills); refused: {refusal}; the next run repeats the "
          f"tokens, prefix unchanged; {rec['tokens']} tokens in {wall:.3f} s = "
          f"{rec['tokens_per_s']:.1f} tok/s, {rec['segment_step_ms']:.2f} ms a segment step, "
          f"TTFT p50 {rec['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{rec['ttft_p99_s'] * 1e3:.1f} ms [{card}]", flush=True)
    return rec


# phases 18, 19 and 21: the checkpoint and training-data entry points. Phase
# 18 holds the HF converter at full 8B width and depth (in memory) and the
# port against transformers' own Llama and SigLIP; phase 19 writes the
# depth-4 train model (TRAIN_TEXT_LAYERS) as a published-layout checkpoint of
# two safetensors shards and drives the convert, generate and int4 serve CLIs
# from it; phase 21 fine-tunes from it through the train CLI.
HF_COSINE_MIN = 0.995
HF_ROWS, HF_TOKENS, HF_TILES = 2, 4096, 16
EXPORT_MAX_BYTES = 8 * 2**20       # what an export may add on the card: it only makes views
CKPT_SHARDS = 2
GEN_QUESTION_TEXT = 200            # characters of phase 19's question after its two images
GEN_TOKENS, SERVE_TOKENS = 16, 8
# phase 21's manifest: 8 samples of 1-3 images (by sample index), whose
# crops (5 or 6 a sample) put every batch of two at tile bucket 16, and an
# answer long enough to put every sample in sequence bucket 4,096
MANIFEST_SAMPLES = 8
MANIFEST_IMAGES = {1: ((728, 728),), 2: ((728, 364), (364, 728)),
                   3: ((364, 364), (364, 364), (728, 364))}
MANIFEST_ANSWER = (1300, 1600)     # characters, drawn uniformly
TRAIN_CLI_STEPS = 3
# step 1's loss in the train CLI against vlm_loss on the same batch and the
# model loaded straight from the checkpoint: the same weights and kernels,
# once under autograd with recompute and once without gradients
TRAIN_CLI_LOSS_RTOL = 1e-4


class HostPeak:
    """The largest resident set size of this process over a `with` block,
    sampled from /proc/self/statm every 5 ms."""

    @staticmethod
    def rss_gib() -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30

    def __enter__(self):
        self.start_gib = self.peak_gib = self.rss_gib()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak_gib = max(self.peak_gib, self.rss_gib())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gib = max(self.peak_gib, self.rss_gib())
        return False


def cosine(a, b, dim=-1):
    import torch

    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=dim)


def row_cosine(a, b):
    """The cosine of a[i] and b[i] over all their elements, for each i of
    the leading dim, summed in float64 (an fp32 sum over 5e8 elements would
    blur the third decimal)."""
    out = []
    for x, y in zip(a, b):
        x, y = x.reshape(-1).double(), y.reshape(-1).double()
        out.append((x @ y / (x @ x * (y @ y)).sqrt()).item())
    return out


def hf_llama_config(cfg):
    """transformers' LlamaConfig for the port's TextConfig (llama3 RoPE
    scaling), in the form the installed transformers takes."""
    import inspect

    from transformers import LlamaConfig

    t = cfg.text
    rope = {"rope_type": "llama3", "factor": t.rope_scaling_factor,
            "low_freq_factor": t.rope_low_freq_factor,
            "high_freq_factor": t.rope_high_freq_factor,
            "original_max_position_embeddings": t.rope_original_max_position}
    kw = dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
              intermediate_size=t.intermediate_size, num_hidden_layers=t.num_layers,
              num_attention_heads=t.num_heads, num_key_value_heads=t.num_kv_heads,
              head_dim=t.head_dim, rms_norm_eps=t.rms_norm_eps,
              max_position_embeddings=t.max_position_embeddings, tie_word_embeddings=False,
              attention_bias=False, mlp_bias=False, attn_implementation="sdpa")
    if "rope_parameters" in inspect.signature(LlamaConfig.__init__).parameters:
        kw["rope_parameters"] = {**rope, "rope_theta": t.rope_theta}
    else:
        kw.update(rope_scaling=rope, rope_theta=t.rope_theta)
    return LlamaConfig(**kw)


def on_meta(module):
    return [n for n, x in [*module.named_parameters(), *module.named_buffers()] if x.is_meta]


def hf_phase(model, cfg, launches, card, device):
    """Phase 18: (a) export_leopard_llava, then convert_leopard_llava onto
    the card, bit for bit, the export adding (almost) no device memory;
    (b) transformers' Llama and SigLIP on the exported tensors (meta build,
    assign=True) against the port's decoder (K1, K3a) and tower (K1, K3b)."""
    import torch
    from transformers import LlamaForCausalLM, SiglipVisionConfig, SiglipVisionModel
    from transformers.models.llama.modeling_llama import LlamaRotaryEmbedding

    from leopard_tpu_torch.convert import hf as chf
    from leopard_tpu_torch.ops.rotary import compute_inv_freq

    rec = {}
    state = model.state_dict()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    exported = chf.export_leopard_llava(model, cfg)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - before
    back = chf.convert_leopard_llava(exported, cfg, device=device)
    if back.keys() != state.keys():
        raise AssertionError(f"HF round trip: keys differ: {sorted(back.keys() ^ state.keys())[:5]}")
    differ = [k for k in state if back[k].dtype != state[k].dtype or not torch.equal(back[k], state[k])]
    if differ:
        raise AssertionError(f"HF round trip: {len(differ)} tensors differ, e.g. {differ[:5]}")
    if added > EXPORT_MAX_BYTES:
        raise AssertionError(f"export added {added} bytes on the card (at most {EXPORT_MAX_BYTES})")
    shared = sum(back[k].data_ptr() == state[k].data_ptr() for k in state)
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    rec["round_trip"] = {"tensors": len(state), "hf_keys": len(exported), "bytes": n_bytes,
                         "export_added_bytes": added, "same_storage": shared}
    print(f"HF round trip at 8B: export_leopard_llava → {len(exported)} HF keys, then "
          f"convert_leopard_llava onto the card: {len(state)} tensors ({n_bytes} bytes) equal "
          f"bit for bit, {shared} of them the model's own storage; the export added {added} "
          f"bytes of device memory (peak; limit {EXPORT_MAX_BYTES}) [{card}]", flush=True)
    del back

    # (b) transformers' Llama on the exported decoder tensors
    lcfg = hf_llama_config(cfg)
    with torch.device("meta"):
        llama = LlamaForCausalLM(lcfg)
    text_sd = chf.export_decoder(model.text, cfg.text, "model.")
    llama.load_state_dict(text_sd, strict=True, assign=True)
    llama.model.rotary_emb = LlamaRotaryEmbedding(config=lcfg, device=device)
    if on_meta(llama):
        raise AssertionError(f"HF Llama: left on the meta device: {on_meta(llama)[:5]}")
    llama.eval()
    inv = llama.model.rotary_emb.inv_freq.float()
    want_inv = torch.from_numpy(compute_inv_freq(cfg.text)).to(device).float()
    torch.testing.assert_close(inv, want_inv, rtol=1e-5, atol=0)
    rng = np.random.RandomState(SEED + 18)
    tokens = torch.from_numpy(rng.randint(0, 128000, (HF_ROWS, HF_TOKENS))).to(device)
    hf_out, layer_cos = [], []

    def keep_hf(_, __, out):
        hf_out.append(out[0] if isinstance(out, tuple) else out)

    def compare(i):
        def hook(_, __, out):
            layer_cos.append(min(row_cosine(out, hf_out[i])))
            hf_out[i] = None
        return hook

    hooks = [layer.register_forward_hook(keep_hf) for layer in llama.model.layers]
    with torch.inference_mode():
        want = llama(input_ids=tokens, use_cache=False).logits
        for h in hooks:
            h.remove()
        hooks = [layer.register_forward_hook(compare(i))
                 for i, layer in enumerate(model.text.layers)]
        with launches:
            got, _ = model.text(tokens)
        for h in hooks:
            h.remove()
    expect("HF Llama vs decoder", launches.counts,
           {"flash_attention": cfg.text.num_layers, "fused_rms_norm": 2 * cfg.text.num_layers + 1})
    text_cos = row_cosine(got, want)
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean(-1).tolist()
    pos_cos = cosine(got, want)
    rec["llama"] = {"rows": HF_ROWS, "tokens": HF_TOKENS, "cosine_per_row": text_cos,
                    "top1_agreement_per_row": top1, "position_cosine_min": pos_cos.min().item(),
                    "position_cosine_mean": pos_cos.mean().item(),
                    "layer_cosine_min": layer_cos, "launches": launches.counts}
    print(f"HF LlamaForCausalLM (transformers, sdpa, bf16, llama3 RoPE θ {cfg.text.rope_theta}) "
          f"vs the port's decoder on {HF_ROWS} x {HF_TOKENS} tokens: logits cosine per row "
          f"{[round(c, 6) for c in text_cos]} (min {HF_COSINE_MIN}), top-1 agreement per row "
          f"{[round(a, 4) for a in top1]}, per position min {pos_cos.min().item():.6f} mean "
          f"{pos_cos.mean().item():.6f}; hidden states after each layer, cosine (min over "
          f"rows) {[round(c, 5) for c in layer_cos]}; launches {launches.counts} [{card}]",
          flush=True)
    del want, got, pos_cos, llama, text_sd, hf_out
    if min(text_cos) < HF_COSINE_MIN:
        raise AssertionError(f"HF Llama disagrees with the port: cosine {text_cos}")

    # transformers' SigLIP on the exported tower tensors
    v = cfg.vision
    scfg = SiglipVisionConfig(
        hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
        num_hidden_layers=v.num_layers, num_attention_heads=v.num_heads,
        num_channels=v.num_channels, image_size=v.image_size, patch_size=v.patch_size,
        layer_norm_eps=v.layer_norm_eps, hidden_act=v.hidden_act, vision_use_head=False,
        attn_implementation="sdpa")
    with torch.device("meta"):
        siglip = SiglipVisionModel(scfg)
    siglip.load_state_dict(chf.export_siglip_vision(model.vision, v, "vision_model."),
                           strict=True, assign=True)
    emb = siglip.vision_model.embeddings
    emb.register_buffer("position_ids", torch.arange(emb.num_positions, device=device)[None],
                        persistent=False)
    if on_meta(siglip):
        raise AssertionError(f"HF SigLIP: left on the meta device: {on_meta(siglip)[:5]}")
    siglip.eval()
    g = torch.Generator(device=device).manual_seed(SEED + 18)
    pixels = torch.randn((HF_TILES, 3, v.image_size, v.image_size), generator=g,
                         device=device).to(torch.bfloat16)
    with torch.inference_mode():
        want = siglip(pixel_values=pixels).last_hidden_state
        with launches:
            got = model.vision(pixels)
    expect("HF SigLIP vs tower", launches.counts,
           {"flash_attention": v.num_layers, "fused_layer_norm": 2 * v.num_layers + 1})
    vis_cos = row_cosine(got[None], want[None])[0]
    tile_cos = min(row_cosine(got, want))
    rec["siglip"] = {"tiles": HF_TILES, "cosine": vis_cos, "tile_cosine_min": tile_cos,
                     "max_abs_diff": (got.float() - want.float()).abs().max().item(),
                     "launches": launches.counts}
    print(f"HF SiglipVisionModel (transformers, sdpa, bf16, no head) vs the port's tower on "
          f"{HF_TILES} tiles: last_hidden_state cosine {vis_cos:.6f} (min {HF_COSINE_MIN}), "
          f"per tile min {tile_cos:.6f}, max |diff| {rec['siglip']['max_abs_diff']:.4g}; "
          f"launches {launches.counts} [{card}]", flush=True)
    del want, got, siglip, exported, state
    if vis_cos < HF_COSINE_MIN:
        raise AssertionError(f"HF SigLIP disagrees with the port: cosine {vis_cos}")
    return rec


def write_hf_checkpoint(model, cfg, directory, shards=CKPT_SHARDS):
    """The model as a published-layout HF checkpoint of its architecture,
    written from the port's export: `shards` safetensors files of about equal bytes and
    model.safetensors.index.json. Returns the bytes written."""
    from safetensors.torch import save_file

    from leopard_tpu_torch.convert.hf import export_vlm

    directory.mkdir(parents=True)
    sd = export_vlm(model, cfg)
    sizes = {k: t.numel() * t.element_size() for k, t in sd.items()}
    total = sum(sizes.values())
    parts, acc = [[] for _ in range(shards)], 0
    for k in sd:
        parts[min(shards - 1, acc * shards // total)].append(k)
        acc += sizes[k]
    weight_map = {}
    for i, part in enumerate(parts):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({k: sd[k].to("cpu") for k in part}, str(directory / name),
                  metadata={"format": "pt"})
        weight_map.update({k: name for k in part})
    (directory / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def noise_png_file(path, rng, w, h):
    import base64

    path.write_bytes(base64.b64decode(noise_png(rng, w, h)))
    return str(path)


def k1_held(shapes=None):
    """The K1 shapes phase 3 holds: ("tower", tiles), ("navit", images,
    patches) and ("decoder", rows, bucket, window). `shapes`: phase 3's
    dict of every K1 entry, K1_SHAPES with the Idefics2 ones."""
    shapes = K1_SHAPES if shapes is None else shapes
    return ({("tower", kw["b"]) for kw in shapes.values()
             if not kw["causal"] and kw.get("seg_ids") is None}
            | {("navit", kw["b"], kw["s"]) for kw in shapes.values()
               if kw.get("seg_ids") is not None}
            | {("decoder", kw["b"], kw["s"], kw.get("window")) for kw in shapes.values()
               if kw["causal"]})


def k1_ran(tiles, rows, bucket, cfg, patches=None):
    """The K1 shapes of one forward: the tower at its tile bucket (NaViT:
    images and patches a row), and the decoder at (rows, bucket, window)
    where the bucket takes the flash tier."""
    ran = {("tower", tiles) if patches is None else ("navit", tiles, patches)}
    if bucket >= cfg.text.long_seq_threshold:
        ran.add(("decoder", rows, bucket, cfg.text.sliding_window))
    return ran


def held(label, kernel, ran, checked):
    """Fail if a kernel ran at a shape that phase 3 did not hold against its
    plain version."""
    missing = sorted(set(ran) - set(checked))
    if missing:
        raise AssertionError(f"{label}: {kernel} ran at {missing}, which phase 3 did not hold "
                             "against the plain version")


def checkpoint_phase(cfg, launches, card, k4_checked, tmp, device):
    """Phase 19: the depth-4 train model written as an HF checkpoint of two
    shards, then loaded (time, host peak RSS, device peak); (a) the convert
    CLI both ways, bit for bit; (b) the generate CLI on two PNGs against
    Engine.generate on the model in memory; (c) the serve CLI with int4
    weights over HTTP against an int4 Engine on the same weights."""
    import shutil
    import urllib.error

    import torch
    from PIL import Image
    from safetensors import safe_open

    from leopard_tpu_torch.cli import convert_checkpoint, generate, serve
    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.convert.hf import export_leopard_llava, load_leopard_llava
    from leopard_tpu_torch.data.processor import LeopardProcessor
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.inference.server import _decode_images
    from leopard_tpu_torch.models import vlm

    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    on = ["--device", device.type]
    rec = {}
    model = vlm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED))
    state = model.state_dict()
    hf_dir = tmp / "hf"
    t0 = time.perf_counter()
    n_bytes = write_hf_checkpoint(model, cfg, hf_dir)
    write_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with HostPeak() as rss:
        t0 = time.perf_counter()
        loaded = load_leopard_llava(str(hf_dir), cfg, device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    device_peak = torch.cuda.max_memory_allocated()
    got = loaded.state_dict()
    differ = [k for k in state if got[k].dtype != state[k].dtype or not torch.equal(got[k], state[k])]
    if got.keys() != state.keys() or differ:
        raise AssertionError(f"checkpoint load: {len(differ)} tensors differ, e.g. {differ[:5]}")
    del loaded, got
    rec["load"] = {"bytes": n_bytes, "write_s": write_s, "load_s": load_s,
                   "host_rss_start_gib": rss.start_gib, "host_rss_peak_gib": rss.peak_gib,
                   "device_peak_gib": device_peak / 2**30,
                   "device_added_gib": (device_peak - base) / 2**30}
    print(f"checkpoint: 8B widths, {lt} of 32 text layers, {n_bytes} bytes in {CKPT_SHARDS} "
          f"safetensors shards + index, written in {write_s:.2f} s; load_leopard_llava onto "
          f"the card in {load_s:.3f} s, equal bit for bit; host RSS {rss.start_gib:.2f} GiB "
          f"before, peak {rss.peak_gib:.2f} GiB during the load; device peak "
          f"{device_peak / 2**30:.2f} GiB ({(device_peak - base) / 2**30:.2f} GiB above the "
          f"model already there) [{card}]", flush=True)

    # (a) convert_checkpoint both ways; the fp32 file holds the tensors exactly
    native, out = tmp / "native", tmp / "out"
    t0 = time.perf_counter()
    convert_checkpoint.convert(convert_checkpoint.parse_args(
        ["--direction", "hf2native", "--input", str(hf_dir), "--output", str(native), *on]),
        cfg=cfg)
    hf2native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_checkpoint.convert(convert_checkpoint.parse_args(
        ["--direction", "native2hf", "--input", str(native), "--output", str(out), *on]),
        cfg=cfg)
    native2hf_s = time.perf_counter() - t0
    shutil.rmtree(native)
    want = export_leopard_llava(model, cfg)
    with safe_open(str(out / "model.safetensors"), framework="pt", device=str(device)) as f:
        if set(f.keys()) != set(want):
            raise AssertionError("native2hf: other keys than the export's")
        differ = [k for k in want if not torch.equal(f.get_tensor(k), want[k].float())]
    out_bytes = (out / "model.safetensors").stat().st_size
    shutil.rmtree(out)
    if differ:
        raise AssertionError(f"convert round trip: {len(differ)} tensors differ: {differ[:5]}")
    rec["convert"] = {"hf2native_s": hf2native_s, "native2hf_s": native2hf_s,
                      "fp32_file_bytes": out_bytes}
    print(f"convert_checkpoint: hf2native {hf2native_s:.2f} s, native2hf {native2hf_s:.2f} s "
          f"({out_bytes} bytes of fp32), every tensor equal to the original bit for bit; "
          f"both removed [{card}]", flush=True)

    # (b) the generate CLI against Engine.generate on the model in memory
    tok = ByteTokenizer()
    rng = np.random.RandomState(SEED + 19)
    pngs = [noise_png_file(tmp / f"gen{i}.png", rng, w, h) for i, (w, h) in enumerate(SERVER_PNGS)]
    question = "<image> and <image>: " + random_text(rng, GEN_QUESTION_TEXT)
    args = generate.parse_args(["--checkpoint", str(hf_dir), "--question", question,
                                "--images", *pngs, "--max-new-tokens", str(GEN_TOKENS), *on])
    with launches:
        got = generate.generate(args, tokenizer=tok, cfg=cfg)
    counts = launches.counts
    images = [Image.open(p).convert("RGB") for p in pngs]
    prompt, pixels = LeopardProcessor(cfg, tok, layout="eval").process_eval(question, images)
    gen_cfg = GenerateConfig(max_new_tokens=GEN_TOKENS, greedy=True, eos_token_ids=(128001, 128009))
    engine = Engine(cfg, model, gen_cfg)
    want = engine.generate([prompt], images=pixels, gen_cfg=gen_cfg).tokens[0]
    tiles, bucket = (engine._bucket(pixels.shape[0], engine.tile_buckets),
                     engine._bucket(len(prompt), engine.seq_buckets))
    del engine
    model.text._head_f32 = None
    if got.tolist() != want.tolist():
        raise AssertionError(f"generate CLI: tokens {got.tolist()} != the engine's {want.tolist()}")
    long = bucket >= cfg.text.long_seq_threshold
    expect("generate CLI", counts, {"flash_attention": lv + (lt if long else 0),
                                    "fused_layer_norm": 2 * lv + 1})
    held("generate CLI", "K1", k1_ran(tiles, 1, bucket, cfg), k1_held())
    rec["generate"] = {"crops": int(pixels.shape[0]), "tile_bucket": tiles,
                       "prompt_tokens": len(prompt), "bucket": bucket, "tokens": len(got),
                       "launches": counts}
    print(f"generate CLI: {len(pngs)} PNGs {list(SERVER_PNGS)} → {pixels.shape[0]} crops (tile "
          f"bucket {tiles}), prompt {len(prompt)} tokens (bucket {bucket}), {len(got)} greedy "
          f"tokens identical to Engine.generate on the model in memory; launches {counts} "
          f"[{card}]", flush=True)

    # (c) the serve CLI with int4 weights (and so the int8 KV cache) over HTTP
    args = serve.parse_args(["--checkpoint", str(hf_dir), "--host", "127.0.0.1", "--port", "0",
                             "--quantize", "int4", *on])
    server = serve.build_server(args, tokenizer=tok, cfg=cfg)
    httpd = server.http_server()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    b64 = [noise_png(rng, w, h) for w, h in SERVER_PNGS]
    text = "<image> and <image>: " + random_text(rng, GEN_QUESTION_TEXT)
    try:
        deadline = time.perf_counter() + 30
        while True:
            try:
                if http_call(url + "/health") == (200, {"status": "ok"}):
                    break
            except (urllib.error.URLError, ConnectionError):
                if time.perf_counter() > deadline:
                    raise
            time.sleep(0.05)
        with launches:
            status, out = http_call(url + "/api/generate", {
                "prompts": [text], "images": [b64], "max_new_tokens": SERVE_TOKENS,
                "greedy": True, "eos_token_ids": [NO_EOS]})
        counts = launches.counts
        row_ids, row_tiles, _ = server._prepare_row(text, _decode_images(b64))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("serve CLI: the HTTP thread did not stop")
    del server, httpd
    engine = Engine(cfg, model, quantize="int4", quantize_kv=True)
    want = engine.generate([row_ids], images=row_tiles, gen_cfg=GenerateConfig(
        max_new_tokens=SERVE_TOKENS, eos_token_ids=(NO_EOS,))).tokens[0].tolist()
    tiles, bucket = (engine._bucket(row_tiles.shape[0], engine.tile_buckets),
                     engine._bucket(len(row_ids), engine.seq_buckets))
    del engine
    if status != 200 or out["tokens"] != [want]:
        raise AssertionError(f"serve CLI int4: {status} {out} != the int4 engine's {want}")
    long = bucket >= cfg.text.long_seq_threshold
    # K4: the prefill's lm_head at M = 1, then every decode matmul at M = 1
    # for each of the SERVE_TOKENS - 1 decode forwards
    k4 = 1 + (7 * lt + 1) * (SERVE_TOKENS - 1)
    expect("serve CLI int4", counts, {"int4_matmul": k4, "fused_layer_norm": 2 * lv + 1,
                                      "flash_attention": lv + (lt if long else 0)})
    held("serve CLI int4", "K1", k1_ran(tiles, 1, bucket, cfg), k1_held())
    held("serve CLI int4", "K4 at (M, matmul)", {(1, name) for name in K4_SHAPES}, k4_checked)
    rec["serve_int4"] = {"crops": int(row_tiles.shape[0]), "tile_bucket": tiles,
                         "prompt_tokens": len(row_ids), "bucket": bucket, "launches": counts}
    print(f"serve CLI --quantize int4 (int8 KV): one request of 2 PNGs over HTTP, prompt "
          f"{len(row_ids)} tokens (bucket {bucket}), {SERVE_TOKENS} tokens identical to an int4 "
          f"Engine on the same weights; launches {counts} (K4 1 + {7 * lt + 1} x "
          f"{SERVE_TOKENS - 1} at M = 1) [{card}]", flush=True)
    del model, state
    return rec, hf_dir


def write_manifest(directory, rng):
    """MANIFEST_SAMPLES rows of MANIFEST_IMAGES seeded noise PNGs and a
    two-turn conversation with a long answer."""
    (directory / "imgs").mkdir(parents=True)
    rows = []
    for i in range(MANIFEST_SAMPLES):
        names = []
        for j, (w, h) in enumerate(MANIFEST_IMAGES[1 + i % 3]):
            names.append(f"{i}_{j}.png")
            noise_png_file(directory / "imgs" / names[-1], rng, w, h)
        question = "<image> " * len(names) + random_text(rng, 60)
        answer = random_text(rng, int(rng.randint(*MANIFEST_ANSWER)))
        rows.append({"conversations": [{"from": "human", "value": question},
                                       {"from": "gpt", "value": answer}], "images": names})
    path = directory / "data.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path), str(directory / "imgs")


def train_cli_phase(hf_dir, card, tmp, device):
    """Phase 21: train_leopard_llava from a jsonl manifest, --init-from the
    phase-19 checkpoint, through the real TrainDataLoader (native index
    builder loaded): every loss finite, step 1's loss against vlm_loss on
    the loader's first batch with the model loaded from the checkpoint, each
    K1/K2 shape of the loader's buckets held in phase 3, and the launches of
    the steps against the layer counts."""
    import torch

    from leopard_tpu_torch import config as cfgs
    from leopard_tpu_torch.cli import train_leopard_llava
    from leopard_tpu_torch.convert.hf import load_leopard_llava
    from leopard_tpu_torch.data import native
    from leopard_tpu_torch.data.dataset import DataState, JsonlSftDataset, TrainDataLoader
    from leopard_tpu_torch.data.processor import LeopardProcessor
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
    from leopard_tpu_torch.training.trainer import vlm_loss

    if not native.native_available():
        raise AssertionError("the native index builder did not build or load")
    tok = ByteTokenizer()
    manifest, images = write_manifest(tmp / "manifest", np.random.RandomState(SEED + 21))
    argv = ["--manifest", manifest, "--image-folder", images, "--tokenizer", "(the smoke's own)",
            "--init-from", str(hf_dir), "--checkpoint-dir", str(tmp / "run"),
            "--seq-len", str(TRAIN_SEQ), "--global-batch-size", "2",
            "--train-steps", str(TRAIN_CLI_STEPS), "--set", f"text.num_layers={TRAIN_TEXT_LAYERS}",
            "--device", device.type]
    args = train_leopard_llava.parse_args(argv)
    cfg = cfgs.apply_overrides(cfgs.leopard_llava_8b(),
                               train_leopard_llava.parse_overrides(args.set))
    train_cfg = cfgs.TrainConfig()
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers

    # the loader's batches, as the CLI will draw them
    loader = TrainDataLoader(JsonlSftDataset(manifest, images), LeopardProcessor(cfg, tok),
                             batch_size=2, seq_len=TRAIN_SEQ, state=DataState(seed=train_cfg.seed))
    t0 = time.perf_counter()
    it = iter(loader)
    batches = [next(it) for _ in range(TRAIN_CLI_STEPS)]
    loader_ms = (time.perf_counter() - t0) / TRAIN_CLI_STEPS * 1e3
    shapes = sorted({(b.tokens.shape, b.images.shape[0]) for b in batches})
    ran = set().union(*(k1_ran(tiles, *tokens, cfg) for tokens, tiles in shapes))
    k2 = k2_shapes(cfg.text, cfg.vision).values()
    k2_held = ({("tower", kw["b"]) for kw in k2 if not kw["causal"]}
               | {("decoder", kw["b"], kw["s"], None) for kw in k2 if kw["causal"]})
    held("train CLI", "K1", ran, k1_held())
    held("train CLI", "K2", ran, k2_held)
    ref = load_leopard_llava(str(hf_dir), cfg, device)
    first = {k: torch.from_numpy(v).to(device) for k, v in batches[0].as_dict().items()}
    with torch.no_grad():
        ref_loss = vlm_loss(ref, cfg, first, remat=train_cfg.remat,
                            loss_chunk=train_cfg.loss_chunk)[0].item()
    del ref, first
    torch.cuda.empty_cache()

    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "fused_rms_norm": fused_rms_norm, "fused_layer_norm": fused_layer_norm}
    per_step = {"flash_attention": 2 * (lt + lv), "flash_attention_bwd": lt + lv,
                "fused_rms_norm": 2 * 2 * lt + 1, "fused_layer_norm": 2 * 2 * lv + 1}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    flash_attention.copies = 0
    t0 = time.perf_counter()
    state = train_leopard_llava.train_main(args, tokenizer=tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    copies = flash_attention.copies
    del state
    with open(tmp / "run" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows]
    if [r["step"] for r in rows] != list(range(1, TRAIN_CLI_STEPS + 1)):
        raise AssertionError(f"train CLI: logged steps {[r['step'] for r in rows]}")
    if not all(np.isfinite(losses)) or any(r["nan_iters"] for r in rows):
        raise AssertionError(f"train CLI: non-finite losses {losses}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if rel > TRAIN_CLI_LOSS_RTOL:
        raise AssertionError(f"train CLI: step 1 loss {losses[0]} vs vlm_loss {ref_loss} "
                             f"(rel {rel:.3g} > {TRAIN_CLI_LOSS_RTOL})")
    expect("train CLI", totals, {k: TRAIN_CLI_STEPS * n for k, n in per_step.items()})
    if copies:
        raise AssertionError(f"train CLI: K1/K2 copied {copies} inputs")
    step_ms = statistics.mean(r["step_time"] for r in rows[1:]) * 1e3
    tokens = 2 * TRAIN_SEQ
    rec = {"losses": losses, "vlm_loss": ref_loss, "loss_rel_diff": rel,
           "batch_shapes": [[list(s), t] for s, t in shapes],
           "tokens_in_loss": [r["tokens_in_loss"] for r in rows],
           "step_ms": [r["step_time"] * 1e3 for r in rows], "step_ms_mean_2_3": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "loader_ms_per_batch": loader_ms,
           "data_ms": [r["data_time"] * 1e3 for r in rows], "wall_s": wall,
           "peak_memory_gib": peak_gib, "launches": totals, "launches_per_step": per_step}
    print(f"train CLI: {MANIFEST_SAMPLES}-sample manifest, --init-from the phase-19 checkpoint, "
          f"{TRAIN_CLI_STEPS} steps at batch 2 x {TRAIN_SEQ} (loader batches {rec['batch_shapes']} "
          f"as ((rows, bucket), tile bucket), native index builder loaded): losses "
          f"{[round(x, 6) for x in losses]}, step 1 vs vlm_loss on the model loaded from the "
          f"checkpoint {ref_loss:.6f} (rel {rel:.3g}, tol {TRAIN_CLI_LOSS_RTOL}); launches "
          f"{totals} = {TRAIN_CLI_STEPS} x {per_step}; step {step_ms:.1f} ms (mean of steps "
          f"2-{TRAIN_CLI_STEPS}), {tokens / step_ms * 1e3:.1f} tokens/s (padded), loader "
          f"{loader_ms:.1f} ms a batch on the host, the loop's data wait "
          f"{[round(x, 1) for x in rec['data_ms']]} ms; the whole CLI {wall:.2f} s; peak device "
          f"memory {peak_gib:.2f} GiB [{card}]", flush=True)
    return rec


def train_config():
    """Leopard-LLaVA-8B at full width with the text depth cut to
    TRAIN_TEXT_LAYERS (the one cut: the 8B train state does not fit)."""
    from leopard_tpu_torch.config import leopard_llava_8b

    cfg = leopard_llava_8b()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=TRAIN_TEXT_LAYERS))


def train_batch(cfg, device):
    """TRAIN_ROWS packed as the data pipeline packs them: each sample is BOS,
    its tiles' image tokens, then text; segment ids 1, 2 and 0 for the
    padding tail; positions restart at 0 in each segment; loss weight 1 on
    text tokens, 0 on image tokens and padding. Tiles in order of
    appearance, random pixels from the seed."""
    import torch

    rng = np.random.RandomState(SEED)
    n_img = TRAIN_TILES_PER_SAMPLE * cfg.anyres.tokens_per_tile
    shape = (len(TRAIN_ROWS), TRAIN_SEQ)
    tokens, seg, pos = (np.zeros(shape, np.int64) for _ in range(3))
    weights = np.zeros(shape, np.float32)
    for r, row in enumerate(TRAIN_ROWS):
        start = 0
        for sid, n in enumerate(row, start=1):
            sample = np.concatenate([[128000], np.full(n_img, cfg.image_token_id),
                                     rng.randint(0, 128000, n - 1 - n_img)])
            end = start + n
            tokens[r, start:end], seg[r, start:end], pos[r, start:end] = sample, sid, np.arange(n)
            weights[r, start:end] = sample != cfg.image_token_id
            start = end
    n_tiles = sum(len(row) for row in TRAIN_ROWS) * TRAIN_TILES_PER_SAMPLE
    size = cfg.vision.image_size
    g = torch.Generator(device=device).manual_seed(SEED)
    images = torch.randn((n_tiles, 3, size, size), generator=g, device=device)
    batch = {"tokens": tokens, "segment_ids": seg, "positions": pos, "loss_weights": weights}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    batch["images"] = images
    return batch


def param_group(name):
    if name.startswith("text.layers."):
        return "text layers"
    if name.startswith("vision.layers."):
        return "tower layers"
    return {"text.embed_tokens": "embed", "text.lm_head": "head",
            "text.final_norm": "text final norm"}.get(
        name, "projector" if name.startswith("projector.") else "tower patch/pos/post-LN")


def train_grads_vs_dense(model, cfg, batch, card):
    """Phase 20, first: one step's gradients through K1 + K2 against the same step
    with attn_impl="dense" in text and tower (plain attention under
    autograd), on the same weights; cosine per parameter group."""
    import torch

    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.training.trainer import vlm_loss

    dense_cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="dense"),
        text=dataclasses.replace(cfg.text, attn_impl="dense"))
    dense = LeopardVLM(dense_cfg, device="meta")
    dense.load_state_dict(model.state_dict(), assign=True)  # shares the weights
    grads, losses, launches = {}, {}, {}
    for name, m, c in (("kernel", model, cfg), ("dense", dense, dense_cfg)):
        flash_attention.launches = flash_attention_bwd.launches = 0
        loss, _ = vlm_loss(m, c, batch, remat="full")
        loss.backward()
        torch.cuda.synchronize()
        launches[name] = (flash_attention.launches, flash_attention_bwd.launches)
        losses[name] = loss.item()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
    layers = cfg.text.num_layers + cfg.vision.num_layers
    if launches != {"kernel": (2 * layers, layers), "dense": (0, 0)}:
        raise AssertionError(f"K1/K2 launches {launches}, expected kernel ({2 * layers}, "
                             f"{layers}) and dense (0, 0)")
    sums = {}
    for n, a in grads["kernel"].items():
        a, b = a.float(), grads["dense"][n].float()
        acc = sums.setdefault(param_group(n), [0.0, 0.0, 0.0])
        acc[0] += float((a * b).sum())
        acc[1] += float(a.square().sum())
        acc[2] += float(b.square().sum())
    cosines = {grp: dot / max((na * nb) ** 0.5, 1e-30) for grp, (dot, na, nb) in sums.items()}
    del grads, dense
    print(f"train, K1 + K2 vs dense gradients (one step, {cfg.text.num_layers} text layers): "
          f"loss {losses['kernel']:.6f} vs {losses['dense']:.6f}; cosine per group "
          + ", ".join(f"{g}: {c:.6f}" for g, c in cosines.items())
          + f" (min {COSINE_MIN}); K1/K2 launches {launches['kernel']} [{card}]", flush=True)
    if not all(np.isfinite(list(losses.values()))) or min(cosines.values()) < COSINE_MIN:
        raise AssertionError(f"gradients disagree: {cosines}, losses {losses}")
    return {"cosines": cosines, "losses": losses}


def train_phase(model, cfg, batch, card):
    """Phase 20, then: TRAIN_STEPS steps of train() through the user's entry
    points, each step timed and its kernel launches counted."""
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
    from leopard_tpu_torch.training import trainer
    from leopard_tpu_torch.training.loop import train

    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "fused_rms_norm": fused_rms_norm, "fused_layer_norm": fused_layer_norm}
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    # full recompute runs each layer's forward twice (K1, K3) and its
    # backward once (K2); the final norm and the tower's post-LN run once
    want = {"flash_attention": 2 * (lt + lv), "flash_attention_bwd": lt + lv,
            "fused_rms_norm": 2 * 2 * lt + 1, "fused_layer_norm": 2 * 2 * lv + 1}
    tcfg = TrainConfig(
        seq_len=TRAIN_SEQ, global_batch_size=len(TRAIN_ROWS), train_steps=TRAIN_STEPS,
        log_interval=1, eval_interval=0, save_interval=0, remat="full", loss_chunk=1024,
        optimizer=OptimizerConfig(lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0))
    torch.cuda.reset_peak_memory_stats()
    state = trainer.create_train_state(model, tcfg)
    step = trainer.make_train_step(cfg, tcfg, model=model)
    used_rows = torch.unique(batch["tokens"][batch["loss_weights"] > 0])[:64]

    def sample(params):
        """A few thousand elements of each master tensor (the embedding's
        rows of tokens in the batch: other rows get no gradient)."""
        out = {}
        for n, p in params.items():
            flat = p[used_rows].reshape(-1) if n == "text.embed_tokens" else p.reshape(-1)
            out[n] = flat[:: max(1, flat.numel() // 4096)][:4096].clone()
        return out

    snaps = [sample(state.params)]
    records = []

    def step_fn(st, b):
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, metrics = step(st, b)
        torch.cuda.synchronize()
        records.append({
            "ms": (time.perf_counter() - t0) * 1e3, "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "nan_step": bool(metrics["nan_step"]),
            "launches": {k: c.launches - before[k] for k, c in counters.items()}})
        snaps.append(sample(st.params))
        return st, metrics

    for c in counters.values():
        c.launches = 0
    flash_attention.copies = 0
    state = train(cfg, tcfg, state, step_fn, itertools.repeat(batch))
    torch.cuda.synchronize()
    copies = flash_attention.copies
    if copies:
        raise AssertionError(f"train: K1/K2 copied {flash_attention.copies} inputs that TMA "
                             "could not address; the training path must make none")
    totals = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(records, start=1):
        print(f"train step {i}: loss {r['loss']:.6f}, grad norm {r['grad_norm']:.6f}, "
              f"{r['ms']:.1f} ms, launches {r['launches']} [{card}]", flush=True)
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])) or r["nan_step"]:
            raise AssertionError(f"step {i}: non-finite loss or grad norm: {r}")
        if r["launches"] != want:
            raise AssertionError(f"step {i}: launches {r['launches']}, expected {want}")
    if state.step != TRAIN_STEPS or len(records) != TRAIN_STEPS:
        raise AssertionError(f"train() ran {len(records)} steps, state.step {state.step}")
    unchanged = [n for n in snaps[0] if not torch.equal(snaps[0][n], snaps[1][n])]
    if unchanged:
        raise AssertionError(f"step 1 (lr 0) changed {unchanged[:5]}")
    moved = {}
    for n in snaps[0]:
        grp = moved.setdefault(param_group(n), [0, 0])
        grp[0] += int(not torch.equal(snaps[1][n], snaps[-1][n]))
        grp[1] += 1
    if any(changed == 0 for changed, _ in moved.values()):
        raise AssertionError(f"steps 2-3 left a parameter group unchanged: {moved}")
    step_ms = statistics.mean(r["ms"] for r in records[1:])
    tokens = len(TRAIN_ROWS) * TRAIN_SEQ
    print(f"train: {TRAIN_STEPS} steps of train(), step 1 left the params unchanged (lr 0); "
          f"steps 2-3 changed tensors per group (changed/total): "
          + ", ".join(f"{g}: {c}/{t}" for g, (c, t) in moved.items())
          + f"; K1/K2 input copies {copies}; launches per step {want} (K1 2 x ({lt} + {lv}) layers, K2 {lt} + {lv}, "
          f"K3a 2 x 2 x {lt} + 1, K3b 2 x 2 x {lv} + 1), in all {totals}; step "
          f"{step_ms:.1f} ms (mean of steps 2-{TRAIN_STEPS}), {tokens / step_ms * 1e3:.1f} "
          f"tokens/s, peak device memory {peak_gib:.2f} GiB [{card}]", flush=True)
    return {"steps": records, "launches": totals, "launches_per_step": want, "copies": copies,
            "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_memory_gib": peak_gib, "params_moved": moved}


# phases 22-25 (A-D): Leopard-Idefics2 serving at 8B. Phase A serves one
# request of the reference's serving shape (8 images, bucket 8,192); phase
# B holds it against the dense path and a run without the window; phase C
# holds the HF converter and the port against transformers' Mistral,
# Idefics2 tower and connector; phase D serves from a depth-4 checkpoint on
# disk through the convert and serve CLIs.
IDEFICS2_IMAGES = ((980, 980), (1400, 700), (700, 1400), (1200, 500), (600, 800),
                   (400, 300), (900, 450), (500, 1000))   # (w, h): resized to grids of
#                                                          mixed rows and columns
IDEFICS2_BUCKET = 8192
IDEFICS2_TEXT_LAYERS = 4           # phase D's checkpoint
IDEFICS2_PNGS = ((728, 364), (364, 1092))   # phase D's request over HTTP


class MistralByteTokenizer(ByteTokenizer):
    """The smoke's tokenizer with Mistral's BOS (1): every id it gives lies
    inside Mistral's 32,003."""

    bos_token_id = 1


def idefics2_config():
    from leopard_tpu_torch.config import leopard_idefics2_8b

    return leopard_idefics2_8b()


def idefics2_model(cfg, device):
    """Seeded weights on the card; the perceiver's latents, all ones at
    init, drawn N(0, 1) so that the 64 latents differ."""
    import torch

    from leopard_tpu_torch.models import vlm

    g = torch.Generator(device=device).manual_seed(SEED)
    model = vlm.init_params(cfg, g)
    with torch.no_grad():
        model.perceiver.latents.normal_(generator=g)
    return model


def idefics2_request(cfg):
    """Phase A's request: eight seeded noise images through
    preprocess_idefics2 (float32 pixels, the pixel and patch masks) and one
    prompt, BOS and eight blocks of 64 image tokens, filled with seeded text
    to bucket 8,192."""
    from PIL import Image

    from leopard_tpu_torch.data.chat import build_idefics2_prompt
    from leopard_tpu_torch.data.idefics2_processor import preprocess_idefics2

    rng = np.random.RandomState(SEED + 22)
    images = [Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
              for w, h in IDEFICS2_IMAGES]
    pixels, pixel_mask, patch_mask = preprocess_idefics2(images)
    head = build_idefics2_prompt(MistralByteTokenizer(), "", len(images),
                                 image_seq_len=cfg.perceiver.num_latents,
                                 image_token_id=cfg.image_token_id,
                                 fake_token_id=cfg.image_token_id - 1)
    text = rng.randint(3, cfg.image_token_id - 1, size=IDEFICS2_BUCKET - len(head))
    return np.concatenate([head, text]).astype(np.int32), pixels, pixel_mask, patch_mask


def idefics2_pngs():
    """Phase D's two seeded noise PNGs (base64) and its question."""
    rng = np.random.RandomState(SEED + 25)
    pngs = [noise_png(rng, w, h) for w, h in IDEFICS2_PNGS]
    return pngs, "<image> and <image>: " + random_text(rng, GEN_QUESTION_TEXT)


def grids_of(patch_mask):
    """(real rows, real columns) of each image of a patch mask."""
    return [(int(m[:, 0].sum()), int(m[0].sum())) for m in patch_mask]


def idefics2_k1_shapes(cfg):
    """Phase 3's K1 entries of phases A-D: the tower at phase A's eight
    images and phase D's two (their patch masks' interleaved segment ids),
    and the decoder at [1, 8,192] with the window (phases A-C) and without
    (phase B's no-window run)."""
    from leopard_tpu_torch.data.idefics2_processor import preprocess_idefics2
    from leopard_tpu_torch.inference.server import _decode_images

    v, t = cfg.vision, cfg.text
    _, _, _, mask_a = idefics2_request(cfg)
    _, _, mask_d = preprocess_idefics2(_decode_images(idefics2_pngs()[0]))

    def navit(mask):
        n = mask.shape[0]
        return dict(b=n, s=mask[0].size, hq=v.num_heads, hkv=v.num_heads, d=v.head_dim,
                    causal=False, rows=[[r * c] for r, c in grids_of(mask)],
                    seg_ids=mask.reshape(n, -1).astype(np.int32))

    dec = dict(b=1, s=IDEFICS2_BUCKET, hq=t.num_heads, hkv=t.num_kv_heads, d=t.head_dim,
               causal=True, rows=((IDEFICS2_BUCKET,),))
    return {f"navit_b{mask_a.shape[0]}": navit(mask_a), f"navit_b{mask_d.shape[0]}": navit(mask_d),
            f"mistral_{IDEFICS2_BUCKET}": {**dec, "window": t.sliding_window},
            f"mistral_{IDEFICS2_BUCKET}_no_window": {**dec, "window": None}}


def idefics2_counts(cfg, steps, images=True):
    """K1, K3a and K3b launches of one Idefics2 generate with `steps`
    decode forwards: the tower (K1 and two LayerNorms a layer, the post-LN),
    the perceiver (three RMSNorms a layer, the final one), the decoder
    (K1 in a flash-tier prefill; two RMSNorms a layer and the final one in
    every forward)."""
    lv, lt, lp = cfg.vision.num_layers, cfg.text.num_layers, cfg.perceiver.num_layers
    return {"flash_attention": lv * images + lt,
            "fused_rms_norm": (2 * lt + 1) * (1 + steps) + (3 * lp + 1) * images,
            "fused_layer_norm": (2 * lv + 1) * images}


def idefics2_serve_phase(model, cfg, launches, card, k1_checked, device):
    """Phase 22 (A): Engine.generate at the reference's serving shape, twice
    (launches, no K1 input copied, tokens repeat), the tower's whole output
    finite, then encode_images (tower vs perceiver), TTFT, prefill tok/s and
    decode ms/step."""
    import torch

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.ops.flash_attention import flash_attention

    prompt, pixels, _, patch_mask = idefics2_request(cfg)
    engine = Engine(cfg, model)
    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, eos_token_ids=(NO_EOS,))
    runs = []
    for _ in range(2):
        flash_attention.copies = 0
        with launches:
            res = engine.generate([prompt], images=pixels, patch_mask=patch_mask, gen_cfg=gen)
        if flash_attention.copies:
            raise AssertionError(f"Idefics2 serve: K1 copied {flash_attention.copies} inputs")
        toks, lps = res.tokens[0], res.logprobs[0]
        if len(toks) != MAX_NEW_TOKENS or not np.all((toks >= 0) & (toks < cfg.text.vocab_size)):
            raise AssertionError(f"Idefics2 serve: tokens {toks}")
        if not np.all(np.isfinite(lps)):
            raise AssertionError(f"Idefics2 serve: non-finite logprobs {lps}")
        expect("Idefics2 serve", launches.counts, idefics2_counts(cfg, MAX_NEW_TOKENS - 1))
        runs.append(toks.tolist())
    if runs[0] != runs[1]:
        raise AssertionError(f"Idefics2 serve: generate is not repeatable: {runs}")
    tiles = engine._bucket(len(pixels), engine.tile_buckets)
    held("Idefics2 serve", "K1", k1_ran(tiles, 1, engine._bucket(len(prompt), engine.seq_buckets),
                                        cfg, patch_mask[0].size), k1_checked)

    px = torch.from_numpy(pixels).to(device)
    pm = torch.from_numpy(patch_mask).to(device)
    seg = pm.reshape(len(pixels), -1).to(torch.int32)
    with torch.inference_mode():
        feats = model.vision(px, pm)
        latents = model.perceiver(feats, seg)
        torch.cuda.synchronize()
        if not (torch.isfinite(feats).all() and torch.isfinite(latents).all()):
            raise AssertionError("Idefics2 tower or perceiver output is not finite")
        pad = feats[~pm.reshape(len(pixels), -1)]
        tower_s = wall_s(lambda: model.vision(px, pm))
        perceiver_s = wall_s(lambda: model.perceiver(feats, seg))
    encode_s = wall_s(lambda: engine.encode_images(pixels, patch_mask))
    ttft = wall_s(lambda: engine.generate([prompt], images=pixels, patch_mask=patch_mask,
                                          gen_cfg=dataclasses.replace(gen, max_new_tokens=1)))
    full = wall_s(lambda: engine.generate([prompt], images=pixels, patch_mask=patch_mask,
                                          gen_cfg=gen))
    steps = MAX_NEW_TOKENS - 1
    del engine
    model.text._head_f32 = None
    rec = {"images": len(pixels), "grids": grids_of(patch_mask), "patches": int(pm[0].numel()),
           "real_patches": int(pm.sum()), "prompt_tokens": len(prompt), "tokens": runs[0],
           "launches": launches.counts, "tower_output_finite": True,
           "padding_rows_abs_max": pad.abs().max().item() if pad.numel() else 0.0,
           "encode_images_s": encode_s, "tower_s": tower_s, "perceiver_s": perceiver_s,
           "ttft_s": ttft, "prefill_tok_s": len(prompt) / ttft,
           "decode_ms_per_step": (full - ttft) / steps * 1e3}
    print(f"Idefics2 serve at 8B: {len(pixels)} images, grids (rows, cols) {rec['grids']} on "
          f"{pm.shape[1]} x {pm.shape[2]} patches ({rec['real_patches']} real of "
          f"{pm.numel()}), prompt {len(prompt)} tokens (bucket {IDEFICS2_BUCKET}, window "
          f"{cfg.text.sliding_window}), {MAX_NEW_TOKENS} greedy tokens identical in two runs; "
          f"launches {launches.counts} (K1 {cfg.vision.num_layers} tower + "
          f"{cfg.text.num_layers} decoder; K3a 65 x 16 forwards + 10 perceiver; K3b 55), no K1 "
          f"input copied; the tower's output finite on every row (padding rows |max| "
          f"{rec['padding_rows_abs_max']:.4g}) [{card}]", flush=True)
    print(f"Idefics2 serve timing [{card}]: encode_images {encode_s * 1e3:.1f} ms for "
          f"{len(pixels)} images (tower {tower_s * 1e3:.1f} ms, perceiver "
          f"{perceiver_s * 1e3:.1f} ms, medians apart), TTFT {ttft * 1e3:.1f} ms, prefill "
          f"{rec['prefill_tok_s']:.1f} tok/s, decode {rec['decode_ms_per_step']:.2f} ms/step "
          f"(batch 1, {steps} steps; median of 3)", flush=True)
    return rec


def idefics2_twin(model, cfg):
    """A LeopardVLM of `cfg` on `model`'s tensors (no copy); either family."""
    from leopard_tpu_torch.models.vlm import LeopardVLM

    twin = LeopardVLM(cfg, device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin


def idefics2_dense_phase(model, cfg, launches, card, k1_checked):
    """Phase 23 (B): phase A's first-step logits through the kernels against
    the dense path (tower and decoder attn_impl "dense": the masked dense
    attention the JAX package's CPU path computes; cosine >= 0.99), and
    against the kernel path without the window, which must differ by far
    more than the dense path does."""
    import torch

    from leopard_tpu_torch.inference.engine import Engine

    prompt, pixels, _, patch_mask = idefics2_request(cfg)
    t, v = cfg.text, cfg.vision
    variants = {
        "kernel": cfg,
        "dense": dataclasses.replace(cfg, vision=dataclasses.replace(v, attn_impl="dense"),
                                     text=dataclasses.replace(t, attn_impl="dense")),
        "no_window": dataclasses.replace(cfg, text=dataclasses.replace(t, sliding_window=None)),
    }
    logits, counts = {}, {}
    for name, c in variants.items():
        twin = model if name == "kernel" else idefics2_twin(model, c)
        engine = Engine(c, twin)
        with launches:
            first, cache = engine.prefill([prompt], images=pixels, patch_mask=patch_mask)
        logits[name], counts[name] = first[0].float(), launches.counts
        del engine, cache, first
        twin.text._head_f32 = None
        torch.cuda.empty_cache()
    want = idefics2_counts(cfg, 0)
    expect("Idefics2 kernel path", counts["kernel"], want)
    expect("Idefics2 no-window path", counts["no_window"], want)
    expect("Idefics2 dense path", counts["dense"], {**want, "flash_attention": 0})
    held("Idefics2 no-window path", "K1", k1_ran(len(pixels), 1, IDEFICS2_BUCKET,
                                                  variants["no_window"], patch_mask[0].size),
         k1_checked)
    k, d, nw = logits["kernel"], logits["dense"], logits["no_window"]
    if not all(torch.isfinite(x).all() for x in (k, d, nw)):
        raise AssertionError("Idefics2 K1 vs dense: non-finite logits")
    cos_dense, cos_nw = cosine(k, d, 0).item(), cosine(k, nw, 0).item()
    diff_dense, diff_nw = (k - d).abs().max().item(), (k - nw).abs().max().item()
    rec = {"cosine_vs_dense": cos_dense, "argmax_agrees_dense": int(k.argmax()) == int(d.argmax()),
           "max_abs_diff_dense": diff_dense, "cosine_vs_no_window": cos_nw,
           "max_abs_diff_no_window": diff_nw, "launches": counts}
    print(f"Idefics2 first-step logits (1 x {IDEFICS2_BUCKET}, 8 images): kernel vs dense cosine "
          f"{cos_dense:.6f} (min {COSINE_MIN}), argmax agrees {rec['argmax_agrees_dense']}, "
          f"max |diff| {diff_dense:.4g}; kernel vs no window: cosine {cos_nw:.6f}, max |diff| "
          f"{diff_nw:.4g} (must exceed 10 x the dense path's); launches {counts} [{card}]",
          flush=True)
    if cos_dense < COSINE_MIN:
        raise AssertionError(f"Idefics2 K1 vs dense: cosine {cos_dense} < {COSINE_MIN}")
    if not diff_nw > 10 * diff_dense:
        raise AssertionError(f"Idefics2: the window changes the logits by {diff_nw}, not more "
                             f"than the kernels do ({diff_dense}): is it applied?")
    return rec


def hf_mistral_config(t):
    """transformers' MistralConfig for the port's TextConfig, in the form the
    installed transformers takes."""
    import inspect

    from transformers import MistralConfig

    kw = dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
              intermediate_size=t.intermediate_size, num_hidden_layers=t.num_layers,
              num_attention_heads=t.num_heads, num_key_value_heads=t.num_kv_heads,
              head_dim=t.head_dim, rms_norm_eps=t.rms_norm_eps,
              max_position_embeddings=t.max_position_embeddings,
              sliding_window=t.sliding_window, tie_word_embeddings=False,
              attn_implementation="sdpa")
    if "rope_parameters" in inspect.signature(MistralConfig.__init__).parameters:
        kw["rope_parameters"] = {"rope_type": "default", "rope_theta": t.rope_theta}
    else:
        kw["rope_theta"] = t.rope_theta
    return MistralConfig(**kw)


def hf_reference_position_ids(emb, ids):
    """Replace transformers' position-id rule in an Idefics2 embeddings
    module by the reference's ids: patch embedding plus the table at `ids`.
    transformers scales each fraction by 1 - 1e-6 before bucketizing, which
    puts a row that lands exactly on a boundary (row 35 of 70) one bucket
    lower than the reference's rule; the port keeps the reference's."""
    def forward(pixel_values, patch_attention_mask):
        patches = emb.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        return patches + emb.position_embedding(ids)
    emb.forward = forward


def idefics2_hf_phase(model, cfg, launches, card, device, k1_checked):
    """Phase 24 (C): (a) export_leopard_idefics2 then
    convert_leopard_idefics2 onto the card, bit for bit, the export adding
    no device memory; (b) transformers' MistralForCausalLM (window 4,096) on
    the exported decoder against the port's on 1 x 8,192 tokens; (c)
    transformers' Idefics2VisionTransformer and Idefics2Connector on the
    exported tower and connector against the port's on phase A's images and
    patch masks, with the reference's position ids (gated) and with
    transformers' own (reported)."""
    import torch
    from transformers import Idefics2Config, MistralForCausalLM
    from transformers.models.idefics2.modeling_idefics2 import (Idefics2Connector,
                                                                Idefics2VisionTransformer)
    from transformers.models.mistral.modeling_mistral import MistralRotaryEmbedding

    from leopard_tpu_torch.convert import hf as chf
    from leopard_tpu_torch.models.siglip import navit_position_ids
    from leopard_tpu_torch.ops.rotary import compute_inv_freq

    rec = {}
    state = model.state_dict()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    exported = chf.export_leopard_idefics2(model, cfg)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - before
    back = chf.convert_leopard_idefics2(exported, cfg, device=device)
    if back.keys() != state.keys():
        raise AssertionError(f"Idefics2 HF round trip: keys differ: "
                             f"{sorted(back.keys() ^ state.keys())[:5]}")
    differ = [k for k in state if back[k].dtype != state[k].dtype
              or not torch.equal(back[k], state[k])]
    if differ or added > EXPORT_MAX_BYTES:
        raise AssertionError(f"Idefics2 HF round trip: {len(differ)} tensors differ "
                             f"({differ[:5]}), the export added {added} bytes")
    n_bytes = sum(x.numel() * x.element_size() for x in state.values())
    rec["round_trip"] = {"tensors": len(state), "hf_keys": len(exported), "bytes": n_bytes,
                         "export_added_bytes": added}
    print(f"Idefics2 HF round trip at 8B: export_leopard_idefics2 → {len(exported)} HF keys, "
          f"convert_leopard_idefics2 onto the card: {len(state)} tensors ({n_bytes} bytes) "
          f"equal bit for bit; the export added {added} bytes of device memory [{card}]",
          flush=True)
    del back

    # (b) transformers' Mistral on the exported decoder
    t = cfg.text
    mcfg = hf_mistral_config(t)
    with torch.device("meta"):
        mistral = MistralForCausalLM(mcfg)
    mistral.load_state_dict(chf.export_decoder(model.text, t, "model."), strict=True, assign=True)
    mistral.model.rotary_emb = MistralRotaryEmbedding(config=mcfg, device=device)
    if on_meta(mistral):
        raise AssertionError(f"HF Mistral: left on the meta device: {on_meta(mistral)[:5]}")
    mistral.eval()
    torch.testing.assert_close(mistral.model.rotary_emb.inv_freq.float(),
                               torch.from_numpy(compute_inv_freq(t)).to(device).float(),
                               rtol=1e-5, atol=0)
    rng = np.random.RandomState(SEED + 24)
    tokens = torch.from_numpy(rng.randint(3, 32000, (1, IDEFICS2_BUCKET))).to(device)
    hf_out, layer_cos = [], []

    def keep_hf(_, __, out):
        hf_out.append(out[0] if isinstance(out, tuple) else out)

    def compare(i):
        def hook(_, __, out):
            layer_cos.append(min(row_cosine(out, hf_out[i])))
            hf_out[i] = None
        return hook

    hooks = [layer.register_forward_hook(keep_hf) for layer in mistral.model.layers]
    with torch.inference_mode():
        want = mistral(input_ids=tokens, use_cache=False).logits
        for h in hooks:
            h.remove()
        hooks = [layer.register_forward_hook(compare(i))
                 for i, layer in enumerate(model.text.layers)]
        with launches:
            got, _ = model.text(tokens)
        for h in hooks:
            h.remove()
    expect("HF Mistral vs decoder", launches.counts,
           {"flash_attention": t.num_layers, "fused_rms_norm": 2 * t.num_layers + 1})
    held("HF Mistral vs decoder", "K1", {("decoder", 1, IDEFICS2_BUCKET, t.sliding_window)},
         k1_checked)
    text_cos = row_cosine(got, want)[0]
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    pos_cos = cosine(got, want)
    rec["mistral"] = {"tokens": IDEFICS2_BUCKET, "window": t.sliding_window, "cosine": text_cos,
                      "top1_agreement": top1, "position_cosine_min": pos_cos.min().item(),
                      "layer_cosine_min": layer_cos, "launches": launches.counts}
    print(f"HF MistralForCausalLM (transformers, sdpa, bf16, window {t.sliding_window}) vs the "
          f"port's decoder on 1 x {IDEFICS2_BUCKET} tokens: logits cosine {text_cos:.6f} (min "
          f"{HF_COSINE_MIN}), top-1 agreement {top1:.4f}, per position min "
          f"{pos_cos.min().item():.6f}; hidden states after each layer, cosine "
          f"{[round(c, 5) for c in layer_cos]}; launches {launches.counts} [{card}]", flush=True)
    del want, got, pos_cos, mistral, hf_out
    if text_cos < HF_COSINE_MIN:
        raise AssertionError(f"HF Mistral disagrees with the port: cosine {text_cos}")

    # (c) transformers' Idefics2 tower and connector on the exported tensors
    v, p = cfg.vision, cfg.perceiver
    full = Idefics2Config(
        vision_config=dict(hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                           num_hidden_layers=v.num_layers, num_attention_heads=v.num_heads,
                           image_size=v.image_size, patch_size=v.patch_size,
                           layer_norm_eps=v.layer_norm_eps, hidden_act=v.hidden_act),
        perceiver_config=dict(hidden_size=p.hidden_size, resampler_n_latents=p.num_latents,
                              resampler_depth=p.num_layers, resampler_n_heads=p.num_heads,
                              resampler_head_dim=p.head_dim,
                              num_key_value_heads=p.num_kv_heads, rms_norm_eps=p.rms_norm_eps),
        text_config=dict(model_type="mistral", hidden_size=t.hidden_size,
                         intermediate_size=p.intermediate_size, hidden_act="silu"))
    for sub in (full.vision_config, full.perceiver_config):
        sub._attn_implementation = "sdpa"
    with torch.device("meta"):
        tower = Idefics2VisionTransformer(full.vision_config)
        connector = Idefics2Connector(full)
    tower.load_state_dict(chf.export_siglip_vision(model.vision, v, ""), strict=True, assign=True)
    connector.load_state_dict(chf.export_perceiver(model.perceiver, p, ""), strict=True,
                              assign=True)
    if on_meta(tower) or on_meta(connector):
        raise AssertionError(f"HF Idefics2: left on the meta device: "
                             f"{(on_meta(tower) + on_meta(connector))[:5]}")
    tower.eval()
    connector.eval()
    _, pixels, _, patch_mask = idefics2_request(cfg)
    n = len(pixels)
    px = torch.from_numpy(pixels).to(device).to(model.vision.pos_embed.dtype)
    pm = torch.from_numpy(patch_mask).to(device)
    flat = pm.reshape(n, -1)
    with torch.inference_mode():
        with launches:
            feats = model.vision(px, pm)
            latents = model.perceiver(feats, flat.to(torch.int32))
        port_counts = launches.counts
        own_emb = tower.embeddings(px, pm)
        ref_ids = navit_position_ids(pm, v.patches_per_side)
        hf_reference_position_ids(tower.embeddings, ref_ids)
        ref_emb = tower.embeddings(px, pm)
        differ_ids = int(((own_emb != ref_emb).any(-1) & flat).sum())
        results = {}
        for rule in ("reference", "transformers"):
            if rule == "transformers":
                del tower.embeddings.forward  # transformers' own rule again
            hf_feats = tower(px, patch_attention_mask=pm).last_hidden_state
            hf_lat = connector(hf_feats, attention_mask=flat)
            results[rule] = {
                "tower_cosine_valid_rows": row_cosine(feats[flat][None], hf_feats[flat][None])[0],
                "latents_cosine": row_cosine(latents[None], hf_lat[None])[0],
                "latents_cosine_per_image_min": min(row_cosine(latents, hf_lat))}
    expect("HF Idefics2 vs tower + perceiver", port_counts, idefics2_counts(cfg, 0) | {
        "flash_attention": v.num_layers, "fused_rms_norm": 3 * p.num_layers + 1})
    rec["idefics2_vision_connector"] = {"images": n, "position_ids_differing": differ_ids,
                                        "real_patches": int(flat.sum()), **results,
                                        "launches": port_counts}
    ref, own = results["reference"], results["transformers"]
    print(f"HF Idefics2VisionTransformer + Idefics2Connector (transformers, sdpa, bf16) vs the "
          f"port's tower + perceiver on phase A's {n} images: with the reference's position "
          f"ids, latents cosine {ref['latents_cosine']:.6f} (min {HF_COSINE_MIN}; per image min "
          f"{ref['latents_cosine_per_image_min']:.6f}), tower cosine over the real patches "
          f"{ref['tower_cosine_valid_rows']:.6f}; with transformers' own rule ({differ_ids} of "
          f"{int(flat.sum())} real patches take another id) latents {own['latents_cosine']:.6f}, "
          f"tower {own['tower_cosine_valid_rows']:.6f}; launches {port_counts} [{card}]",
          flush=True)
    del tower, connector, exported, state
    if ref["latents_cosine"] < HF_COSINE_MIN:
        raise AssertionError(f"HF Idefics2 disagrees with the port: {ref}")
    return rec


def idefics2_checkpoint_phase(cfg, launches, card, tmp, device, k1_checked):
    """Phase 25 (D): the depth-4 Idefics2 model written as an HF checkpoint
    of two safetensors shards; convert_checkpoint --arch leopard_idefics2
    both ways, bit for bit; serve --arch leopard_idefics2 answering one
    request of two PNGs over HTTP, against Engine.generate on the server's
    own _prepare_row output and the same weights."""
    import shutil
    import urllib.error

    import torch
    from safetensors import safe_open

    from leopard_tpu_torch.cli import convert_checkpoint, serve
    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.convert.hf import export_leopard_idefics2
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.inference.server import _decode_images

    on = ["--device", device.type, "--arch", "leopard_idefics2"]
    rec = {}
    model = idefics2_model(cfg, device)
    state = model.state_dict()
    hf_dir = tmp / "idefics2_hf"
    t0 = time.perf_counter()
    n_bytes = write_hf_checkpoint(model, cfg, hf_dir)
    rec["write"] = {"bytes": n_bytes, "s": time.perf_counter() - t0}

    native, out = tmp / "idefics2_native", tmp / "idefics2_out"
    t0 = time.perf_counter()
    convert_checkpoint.convert(convert_checkpoint.parse_args(
        ["--direction", "hf2native", "--input", str(hf_dir), "--output", str(native), *on]),
        cfg=cfg)
    hf2native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_checkpoint.convert(convert_checkpoint.parse_args(
        ["--direction", "native2hf", "--input", str(native), "--output", str(out), *on]),
        cfg=cfg)
    native2hf_s = time.perf_counter() - t0
    shutil.rmtree(native)
    want = export_leopard_idefics2(model, cfg)
    with safe_open(str(out / "model.safetensors"), framework="pt", device=str(device)) as f:
        if set(f.keys()) != set(want):
            raise AssertionError("Idefics2 native2hf: other keys than the export's")
        differ = [k for k in want if not torch.equal(f.get_tensor(k), want[k].float())]
    shutil.rmtree(out)
    if differ:
        raise AssertionError(f"Idefics2 convert round trip: {len(differ)} tensors differ")
    rec["convert"] = {"hf2native_s": hf2native_s, "native2hf_s": native2hf_s}
    print(f"Idefics2 checkpoint: 8B widths, {cfg.text.num_layers} of 32 text layers, {n_bytes} "
          f"bytes in {CKPT_SHARDS} safetensors shards + index; convert_checkpoint --arch "
          f"leopard_idefics2: hf2native {hf2native_s:.2f} s, native2hf {native2hf_s:.2f} s, "
          f"every tensor equal to the original bit for bit [{card}]", flush=True)

    tok = MistralByteTokenizer()
    args = serve.parse_args(["--checkpoint", str(hf_dir), "--host", "127.0.0.1", "--port", "0",
                             *on])
    server = serve.build_server(args, tokenizer=tok, cfg=cfg)
    loaded = server.engine.model.state_dict()
    if [k for k in state if not torch.equal(loaded[k], state[k])]:
        raise AssertionError("serve --arch leopard_idefics2: the loaded weights differ")
    del loaded
    httpd = server.http_server()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    pngs, text = idefics2_pngs()
    try:
        deadline = time.perf_counter() + 30
        while True:
            try:
                if http_call(url + "/health") == (200, {"status": "ok"}):
                    break
            except (urllib.error.URLError, ConnectionError):
                if time.perf_counter() > deadline:
                    raise
            time.sleep(0.05)
        with launches:
            status, got = http_call(url + "/api/generate", {
                "prompts": [text], "images": [pngs], "max_new_tokens": SERVE_TOKENS,
                "greedy": True, "eos_token_ids": [NO_EOS]})
        counts = launches.counts
        ids, pixels, patch_mask = server._prepare_row(text, _decode_images(pngs))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("Idefics2 serve CLI: the HTTP thread did not stop")
    del server, httpd
    engine = Engine(cfg, model)
    want = engine.generate([ids], images=pixels, patch_mask=patch_mask, gen_cfg=GenerateConfig(
        max_new_tokens=SERVE_TOKENS, eos_token_ids=(NO_EOS,))).tokens[0].tolist()
    tiles, bucket = (engine._bucket(len(pixels), engine.tile_buckets),
                     engine._bucket(len(ids), engine.seq_buckets))
    del engine
    if status != 200 or got["tokens"] != [want]:
        raise AssertionError(f"Idefics2 serve CLI: {status} {got} != the engine's {want}")
    long = bucket >= cfg.text.long_seq_threshold
    n_want = idefics2_counts(cfg, SERVE_TOKENS - 1)
    n_want["flash_attention"] = cfg.vision.num_layers + (cfg.text.num_layers if long else 0)
    expect("Idefics2 serve CLI", counts, n_want)
    held("Idefics2 serve CLI", "K1", k1_ran(tiles, 1, bucket, cfg, patch_mask[0].size),
         k1_checked)
    rec["serve"] = {"images": len(pixels), "grids": grids_of(patch_mask),
                    "patches": int(patch_mask[0].size), "prompt_tokens": len(ids),
                    "bucket": bucket, "tokens": SERVE_TOKENS, "launches": counts}
    print(f"serve CLI --arch leopard_idefics2: one request of {len(pngs)} PNGs "
          f"{list(IDEFICS2_PNGS)} over HTTP → grids {rec['serve']['grids']} on "
          f"{patch_mask.shape[1]} x {patch_mask.shape[2]} patches, prompt {len(ids)} tokens "
          f"(bucket {bucket}), {SERVE_TOKENS} tokens identical to Engine.generate on the "
          f"server's _prepare_row output; launches {counts} [{card}]", flush=True)
    del model, state
    return rec


# phases 26-30 (eval A-E): the evaluation harness and the recompute
# policies. A: LLaVA eval at full 8B through run_benchmark_batched (batch 8,
# the prefetch thread) on three sets in the loaders' layouts; B: Idefics2
# eval at full 8B, samples re-padded across each batch; C: the run_eval CLI
# on phase 19's depth-4 checkpoint (2 shards + merge, int4, prefix caching,
# speculative); D: LeopardLM on the same checkpoint; E: train steps under
# "attn" and "selective" at phase 20's shape. The sets are written, and
# their batches planned, before phase 3, which holds K1 at every shape they
# give.
EVAL_TOKENS = 16                   # greedy tokens a row (the adapters' default is 128)
EVAL_BATCH = 8
EVAL_DOC_PAGE = (1700, 2200)       # MP-DocVQA page (w, h): 5 x 6 tiles at native size
# the pages of 8 questions; the first three sort in their order (crops 31,
# 39, 50: prompt buckets 8,192, 8,192, 16,384), so that phase C's batches of
# 2 are the same in one shard and in two
EVAL_DOC_ROWS = ((0,), (1, 2, 3), (4, 5), (6, 7, 8, 9), (0, 1, 2, 3, 4),
                 (5, 6, 7, 8, 9, 10), (11, 2), (10, 11, 4, 5))
EVAL_SLIDE, EVAL_DECKS = (1024, 768), 2   # SlideVQA: decks of 20 slides, 2 questions a deck
# the prepared set's rows: question type and images (w, h); tile buckets
# grow with the row, so rows keep their order in the harness's sort
EVAL_WEB = (("multiple-choice", ((728, 364),)),
            ("multiple-choice", ((364, 728), (728, 364))),
            ("captioning", ((728, 364), (364, 728), (1092, 364))),
            ("webqa", ((728, 728),)))
EVAL_LEAD = ("Screenshots of one web page follow. Read every one of them with care before "
             "you answer the question below. ")
EVAL_PREFIX_COSINE_MIN = 0.9999
# the bf16 prefix path, first-step logits cosine per row, NVIDIA H100: sound
# 0.999868-0.999876 (the same in four runs), the planted faults of phase 26
# "shifted" 0.999781-0.999848 and "stale" 0.99963-0.999726; the limit lies
# midway between the sound minimum and the faults'
EVAL_PREFIX_BF16_MIN = 0.99982
EVAL_CLI = ("mpdocvqa", "visualwebbench")   # phase C: 3 rows each, batches of 2
EVAL_CLI_ROWS, EVAL_CLI_BATCH = 3, 2
IDEFICS2_EVAL_ROWS, IDEFICS2_EVAL_BATCH = 8, 4
LM_REQUESTS, LM_CONTEXT, LM_CONT = 4, 2190, 9   # BOS + 2,190 + 9 = 2,200 tokens: K1 at [1, 2,200]
# phase D: LeopardLM on K1 against the dense decoder. Each limit lies
# between the sound reading and that of a planted fault (the dense decoder
# with its attention cut to the last LM_FAULT_WINDOW tokens), which must
# exceed it: the summed logprobs' relative difference (NVIDIA H100: sound
# 3.56e-4, fault 1.54e-2) and the largest per-token logprob difference of
# the rolling texts (sound 0.0387, fault 1.249)
LM_RTOL = 2e-3
LM_TOKEN_ATOL = 0.2
LM_FAULT_WINDOW = 1024
REMAT_POLICIES = ("full", "attn", "selective")
REMAT_COSINE_MIN = 0.999


class EvalTokenizer(ByteTokenizer):
    """The smoke's tokenizer with an eos and Idefics2's end-of-utterance
    (inside Mistral's 32,003 ids)."""

    eos_token_id = 2

    def convert_tokens_to_ids(self, tok):
        if tok == "<end_of_utterance>":
            return 32002
        return super().convert_tokens_to_ids(tok)


class MistralEvalTokenizer(EvalTokenizer):
    bos_token_id = 1


def noise_image_file(path, rng, w, h):
    from PIL import Image

    Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
    return str(path)


def write_eval_sets(root):
    """Phase A's sets under `root`: MP-DocVQA in its raw layout (val.json,
    images/<page>.jpg: 8 questions over 12 noise pages of 1,700 x 2,200),
    SlideVQA in its raw layout (annotations/qa/test.jsonl, images/<deck>/
    of 20 slides of 1,024 x 768) and a prepared eval_visualwebbench.jsonl
    (EVAL_WEB: multiple-choice, captioning and webqa rows); and phase B's
    prepared eval_mirb.jsonl, 8 rows of 1-8 images of IDEFICS2_IMAGES'
    sizes. Returns the seconds it took."""
    from leopard_tpu_torch.evaluation.loaders import write_jsonl
    from leopard_tpu_torch.evaluation.metrics import option_block

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 26)
    doc = root / "mpdocvqa"
    (doc / "images").mkdir(parents=True)
    for p in range(1 + max(max(r) for r in EVAL_DOC_ROWS)):
        noise_image_file(doc / "images" / f"page{p}.jpg", rng, *EVAL_DOC_PAGE)
    (doc / "val.json").write_text(json.dumps({"data": [
        {"page_ids": [f"page{p}" for p in pages], "question": random_text(rng, 60),
         "answers": [random_text(rng, 8), random_text(rng, 12)]}
        for pages in EVAL_DOC_ROWS]}))
    slides = root / "slidevqa"
    (slides / "annotations" / "qa").mkdir(parents=True)
    qa = []
    for d in range(EVAL_DECKS):
        deck = slides / "images" / f"deck{d}"
        deck.mkdir(parents=True)
        for i in range(20):
            noise_image_file(deck / f"deck{d}-{i + 1}-1024.jpg", rng, *EVAL_SLIDE)
        qa += [{"deck_name": f"deck{d}", "question": random_text(rng, 80),
                "answer": random_text(rng, 10)} for _ in range(2)]
    write_jsonl(str(slides / "annotations" / "qa" / "test.jsonl"), qa)
    web = root / "visualwebbench"
    web.mkdir()
    rows = []
    for i, (kind, sizes) in enumerate(EVAL_WEB):
        paths = [noise_image_file(web / f"{i}_{j}.png", rng, w, h)
                 for j, (w, h) in enumerate(sizes)]
        opts = [random_text(rng, 10) for _ in range(4)] if kind == "multiple-choice" else None
        rows.append({"images_path": paths,
                     "question": EVAL_LEAD + "<image>" * len(paths) + random_text(rng, 40),
                     "options": opts, "concated_options": option_block(opts) if opts else None,
                     "answers": "B" if opts else [random_text(rng, 30)], "ques_type": kind})
    write_jsonl(str(web / "eval_visualwebbench.jsonl"), rows)
    mirb = root / "mirb"
    mirb.mkdir()
    rows = []
    for i in range(IDEFICS2_EVAL_ROWS):
        sizes = [IDEFICS2_IMAGES[(i + j) % len(IDEFICS2_IMAGES)] for j in range(i + 1)]
        paths = [noise_image_file(mirb / f"{i}_{j}.jpg", rng, w, h)
                 for j, (w, h) in enumerate(sizes)]
        rows.append({"images_path": paths,
                     "question": "<image>" * len(paths) + random_text(rng, 60),
                     "options": None, "answers": [random_text(rng, 8)], "ques_type": "open-ended"})
    write_jsonl(str(mirb / "eval_mirb.jsonl"), rows)
    return time.perf_counter() - t0


def load_eval_sets(root, names):
    from leopard_tpu_torch.evaluation.loaders import load_benchmark

    return {name: load_benchmark(name, str(root / name)) for name in names}


def engine_buckets():
    """The Engine's default sequence and tile buckets and its bucket rule,
    which the harness sorts and the engine pads by."""
    import inspect

    from leopard_tpu_torch.inference.engine import Engine

    params = inspect.signature(Engine.__init__).parameters
    return (sorted(params["seq_buckets"].default), sorted(params["tile_buckets"].default),
            lambda x, buckets: Engine._bucket(None, x, buckets))


def eval_batches(samples, batch_size, shard=0, num_shards=1):
    """The batches run_benchmark_batched makes of (n_tiles, prompt length)
    per row: the shard's rows sorted by (tile bucket, prompt bucket), cut
    into batch_size. Each batch: (row indices within the shard, crops,
    prompt bucket)."""
    seq_b, tile_b, bucket = engine_buckets()
    size = len(samples) // num_shards + 1
    samples = samples[shard * size:(shard + 1) * size]
    order = sorted(range(len(samples)), key=lambda i: (bucket(samples[i][0], tile_b),
                                                        bucket(samples[i][1], seq_b)))
    out = []
    for start in range(0, len(order), batch_size):
        idxs = order[start:start + batch_size]
        out.append((idxs, sum(samples[i][0] for i in idxs),
                    bucket(max(samples[i][1] for i in idxs), seq_b)))
    return out


def llava_eval_plans(cfg, sets):
    """(n_tiles, prompt length) of each row, by the adapter's own plan()
    on the files' headers (a namespace stands in for the adapter: planning
    needs no model)."""
    import types

    from leopard_tpu_torch.evaluation.adapter import LeopardLlavaEvalAdapter
    from leopard_tpu_torch.evaluation.harness import get_instruction

    planner = types.SimpleNamespace(cfg=cfg, tokenizer=EvalTokenizer(), max_images=50,
                                    layout="eval")
    out = {}
    for name, rows in sets.items():
        plans = [LeopardLlavaEvalAdapter.plan(planner, r, get_instruction("direct", r["ques_type"]))
                 for r in rows]
        out[name] = [(p.n_tiles, len(p.prompt)) for p in plans]
    return out


def idefics2_eval_prepared(cfg, rows):
    """The Idefics2 adapter's prepare() of every phase-B row (prompt, pixels,
    patch mask), with a namespace for the adapter: no model needed."""
    import types

    from leopard_tpu_torch.data.idefics2_processor import preprocess_idefics2
    from leopard_tpu_torch.evaluation.adapter import LeopardIdefics2EvalAdapter
    from leopard_tpu_torch.evaluation.harness import get_instruction

    prep = types.SimpleNamespace(cfg=cfg, tokenizer=MistralEvalTokenizer(), max_images=8,
                                 _preprocess=preprocess_idefics2)
    return [LeopardIdefics2EvalAdapter.prepare(prep, r, get_instruction("direct", r["ques_type"]))
            for r in rows]


def idefics2_eval_masks(prepared, tile_buckets, bucket):
    """Each phase-B batch's patch mask as the engine receives it: the
    samples re-padded to the batch's largest grid, then all-zero masks up
    to the tile bucket."""
    from leopard_tpu_torch.evaluation.adapter import repad_navit

    out = []
    for idxs, n, _ in eval_batches([(p.n_tiles, len(p.prompt)) for p in prepared],
                                   IDEFICS2_EVAL_BATCH):
        _, mask = repad_navit([(prepared[i].pixels, prepared[i].patch_mask) for i in idxs])
        nb = bucket(n, tile_buckets)
        out.append(np.concatenate([mask, np.zeros((nb - n,) + mask.shape[1:], bool)]))
    return out


def eval_runs(plans):
    """Every batch phases A and C run: (dataset, offset of the rows run,
    batches as eval_batches gives them) per run."""
    runs = [(name, 0, eval_batches(p, EVAL_BATCH)) for name, p in plans.items()]
    web = plans["visualwebbench"]
    runs += [("visualwebbench", i, eval_batches([s], 1)) for i, s in enumerate(web)]  # serial
    for name in EVAL_CLI:
        rows = plans[name][:EVAL_CLI_ROWS]
        size = len(rows) // 2 + 1
        runs.append((name, 0, eval_batches(rows, EVAL_CLI_BATCH)))
        runs += [(name, k * size, eval_batches(rows, EVAL_CLI_BATCH, k, 2)) for k in range(2)]
    return runs


def eval_k1_shapes(cfg, plans, icfg, masks):
    """Phase 3's K1 entries for phases A-D: the tower at each batch's tile
    bucket, the decoder at each (rows, bucket) of the flash tier (its rows'
    prompt lengths from the first batch of that shape), phase D's
    [1, 2,200], and the NaViT tower at each phase-B batch's re-padded
    masks."""
    _, tile_b, bucket = engine_buckets()
    v, t = cfg.vision, cfg.text
    out = {}
    for name, offset, batches in eval_runs(plans):
        for idxs, n, seq in batches:
            if n:
                nb = bucket(n, tile_b)
                out.setdefault(f"eval_tower_b{nb}", dict(
                    b=nb, s=v.tokens_per_tile, hq=v.num_heads, hkv=v.num_heads,
                    d=v.head_dim, causal=False, rows=None))
            if seq >= t.long_seq_threshold:
                out.setdefault(f"eval_decoder_b{len(idxs)}_{seq}", dict(
                    b=len(idxs), s=seq, hq=t.num_heads, hkv=t.num_kv_heads, d=t.head_dim,
                    causal=True, rows=tuple((plans[name][offset + i][1],) for i in idxs)))
    lm = 1 + LM_CONTEXT + LM_CONT
    out[f"lm_eval_{lm}"] = dict(b=1, s=lm, hq=t.num_heads, hkv=t.num_kv_heads, d=t.head_dim,
                                causal=True, rows=((lm,),))
    iv = icfg.vision
    for i, mask in enumerate(masks):
        n = mask.shape[0]
        out[f"navit_eval_{i}_b{n}"] = dict(
            b=n, s=mask[0].size, hq=iv.num_heads, hkv=iv.num_heads, d=iv.head_dim,
            causal=False, rows=[[r * c] for r, c in grids_of(mask)],
            seg_ids=mask.reshape(n, -1).astype(np.int32))
    return out


def decoded_len(text):
    """Tokens in a response the smoke's tokenizer decoded (ids joined by
    spaces)."""
    return len(text.split())


def batch_counts(cfg, batches, tokens_per_row, images=True, perceiver=False):
    """K1, K3a, K3b launches of generate over `batches` (row indices,
    crops, bucket) given each row's emitted tokens: per batch the tower (K1
    and two LayerNorms a layer, the post-LN) where it has crops, the
    perceiver (three RMSNorms a layer, the final one), the decoder's K1 in
    a flash-tier prefill, and its two RMSNorms a layer and the final one in
    the prefill and each decode forward (the loop stops after the step
    where the last row ends; the last token's forward is not run)."""
    lv, lt = cfg.vision.num_layers, cfg.text.num_layers
    want = {"flash_attention": 0, "fused_rms_norm": 0, "fused_layer_norm": 0}
    for idxs, n, seq in batches:
        steps = max(min(EVAL_TOKENS, tokens_per_row[i] + 1) for i in idxs) - 1
        tower = bool(n) and images
        want["flash_attention"] += lv * tower + lt * (seq >= cfg.text.long_seq_threshold)
        want["fused_rms_norm"] += (2 * lt + 1) * (1 + steps)
        if perceiver and tower:
            want["fused_rms_norm"] += 3 * cfg.perceiver.num_layers + 1
        want["fused_layer_norm"] += (2 * lv + 1) * tower
    return want


def batch_k1_ran(cfg, batches, patches=None):
    _, tile_b, bucket = engine_buckets()
    ran = set()
    for idxs, n, seq in batches:
        if n:
            ran |= k1_ran(bucket(n, tile_b), len(idxs), seq, cfg, patches)
        elif seq >= cfg.text.long_seq_threshold:
            ran.add(("decoder", len(idxs), seq, cfg.text.sliding_window))
    return ran


def direct_generate(adapter, rows, stats, repad=False):
    """Engine.generate called directly on each batch the harness ran (its
    rows' prepare(), pixels concatenated or re-padded), decoded as the
    adapter decodes."""
    from leopard_tpu_torch.evaluation.adapter import repad_navit
    from leopard_tpu_torch.evaluation.harness import get_instruction

    out = {}
    for rec in stats:
        batch = [adapter.prepare(rows[i], get_instruction("direct", rows[i]["ques_type"]))
                 for i in rec["indices"]]
        px = [(s.pixels, s.patch_mask) for s in batch if s.pixels is not None]
        pixels = mask = None
        if px and repad:
            pixels, mask = repad_navit(px)
        elif px:
            pixels = np.concatenate([p for p, _ in px], axis=0)
        res = adapter.engine.generate([s.prompt for s in batch], images=pixels, patch_mask=mask,
                                      gen_cfg=adapter.gen_cfg)
        for i, t in zip(rec["indices"], res.tokens):
            out[i] = adapter.tokenizer.decode(t.tolist(), skip_special_tokens=True)
    return [out[i] for i in range(len(rows))]


def run_harness(adapter, rows, name, launches, batch_size):
    """run_benchmark_batched with the prefetch thread, the multiple-choice
    generator at its seed (as in a new process); (details, stats, counts,
    wall s)."""
    import torch

    from leopard_tpu_torch.evaluation import metrics
    from leopard_tpu_torch.evaluation.harness import run_benchmark_batched

    metrics._rng.seed(42)
    stats = []
    with launches:
        t0 = time.perf_counter()
        details = run_benchmark_batched(rows, adapter, name, batch_size=batch_size,
                                        stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return details, stats, launches.counts, wall


def check_stats(label, stats, predicted):
    got = [(s["indices"], s["n_tiles"], s["bucket"]) for s in stats]
    if got != [(list(i), n, b) for i, n, b in predicted]:
        raise AssertionError(f"{label}: batches {got}, planned {predicted}")


def llava_eval_phase(model, cfg, launches, card, k1_checked, root):
    """Phase 26 (A): LeopardLlavaEvalAdapter on Leopard-LLaVA-8B in bf16:
    run_benchmark_batched (batch 8, prefetch) over MP-DocVQA, SlideVQA and
    the prepared set, each batch as planned, K1/K3 launches as the formula,
    every K1 shape held in phase 3; the responses equal Engine.generate
    called directly on the same batches; the prefix-caching adapter's
    first-step logits against the plain prefill; run_benchmark (serial) on
    the prepared rows, its agreement reported."""
    import torch

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.evaluation import metrics
    from leopard_tpu_torch.evaluation.adapter import LeopardLlavaEvalAdapter, _batch_prefix
    from leopard_tpu_torch.evaluation.harness import get_instruction, run_benchmark
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.models.vlm import LeopardVLM

    names = ("mpdocvqa", "slidevqa", "visualwebbench")
    sets = load_eval_sets(root, names)
    plans = llava_eval_plans(cfg, sets)
    tok = EvalTokenizer()
    gen = GenerateConfig(max_new_tokens=EVAL_TOKENS, greedy=True, eos_token_ids=(128001, 128009))
    adapter = LeopardLlavaEvalAdapter(cfg, model, tok, gen_cfg=gen)
    rec, responses = {"sets": {}}, {}
    for name in names:
        rows = sets[name]
        details, stats, counts, wall = run_harness(adapter, rows, name, launches, EVAL_BATCH)
        predicted = eval_batches(plans[name], EVAL_BATCH)
        check_stats(f"eval {name}", stats, predicted)
        n_tok = [decoded_len(d["raw"]) for d in details]
        expect(f"eval {name}", counts, batch_counts(cfg, predicted, n_tok))
        held(f"eval {name}", "K1", batch_k1_ran(cfg, predicted), k1_checked)
        direct = direct_generate(adapter, rows, stats)
        if direct != [d["raw"] for d in details]:
            raise AssertionError(f"eval {name}: the harness's responses differ from "
                                 f"Engine.generate on the same batches: {direct} vs "
                                 f"{[d['raw'] for d in details]}")
        responses[name] = [d["raw"] for d in details]
        rec["sets"][name] = {
            "rows": len(rows), "wall_s": wall, "samples_per_s": len(rows) / wall,
            "generated_tokens": sum(n_tok), "tokens_per_s": sum(n_tok) / wall,
            "batches": [{"rows": len(s["indices"]), "crops": s["n_tiles"],
                         "bucket": s["bucket"], "prefetch_wait_s": s["wait_s"],
                         "generate_s": s["generate_s"]} for s in stats],
            "launches": counts, "acc": sum(d["correct"] for d in details) / len(details)}
        print(f"eval {name} (LLaVA-8B bf16, batch {EVAL_BATCH}, prefetch): {len(rows)} rows in "
              f"{wall:.3f} s = {len(rows) / wall:.3f} samples/s, {sum(n_tok)} tokens = "
              f"{sum(n_tok) / wall:.1f} tok/s; batches (rows, crops, bucket, prefetch wait s, "
              f"generate s) {[(len(s['indices']), s['n_tiles'], s['bucket'], round(s['wait_s'], 4), round(s['generate_s'], 3)) for s in stats]}; "
              f"launches {counts} as the formula (per batch K1 {cfg.vision.num_layers} tower + "
              f"{cfg.text.num_layers} decoder where the bucket >= "
              f"{cfg.text.long_seq_threshold}, K3a {2 * cfg.text.num_layers + 1} x (1 + decode "
              f"steps), K3b {2 * cfg.vision.num_layers + 1}); responses equal to "
              f"Engine.generate on the same batches [{card}]", flush=True)

    # the prefix-caching adapter against the plain prefill, on the prepared
    # set's first batch (its rows share EVAL_LEAD before their images)
    web = sets["visualwebbench"]
    cached = LeopardLlavaEvalAdapter(cfg, model, tok, gen_cfg=gen, prefix_caching=True)
    idxs = eval_batches(plans["visualwebbench"], EVAL_BATCH)[0][0]
    batch = [cached.prepare(web[i], get_instruction("direct", web[i]["ques_type"])) for i in idxs]
    pixels = np.concatenate([s.pixels for s in batch], axis=0)
    prompts = [s.prompt for s in batch]
    pre, suffixes = _batch_prefix(cached.engine, cfg, prompts, cached._prefixes)
    if pre is None:
        raise AssertionError("eval prefix caching: the batch's common header was not cached")
    with launches:
        got, _ = cached.engine.prefill(suffixes, images=pixels, prefix=pre)
        want, _ = cached.engine.prefill(prompts, images=pixels)
    cos = cosine(got, want).tolist()
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    # planted faults, to show what the bf16 limit catches: the suffix one
    # position late (the prefix's length off by one; that slot is padding,
    # so only the positions move) and a stale entry (the cached header's
    # last token differs from the batch's)
    stale_tokens = pre.tokens.copy()
    stale_tokens[-1] = (stale_tokens[-1] + 1) % 1000
    faults = {"shifted": dataclasses.replace(pre, length=pre.length + 1),
              "stale": cached.engine.build_prefix(stale_tokens)}
    fault_cos = {}
    for fault, fpre in faults.items():
        fgot, _ = cached.engine.prefill(suffixes, images=pixels, prefix=fpre)
        fault_cos[fault] = cosine(fgot, want).tolist()
    del faults, fgot
    # In bf16 two paths of the same math that differ in GEMM shapes part at
    # a cosine of ~1e-4 on these random weights (phase 16's staged vs
    # direct prefills: 0.9998), below EVAL_PREFIX_COSINE_MIN; so the prefix
    # cache is held to it on an fp32 twin of the model (dense attention: K1
    # takes bf16), where rounding does not blur the comparison, and in bf16
    # to EVAL_PREFIX_BF16_MIN, set between the sound readings and the
    # planted faults'
    f32_cfg = dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dtype="float32", attn_impl="dense"),
        vision=dataclasses.replace(cfg.vision, dtype="float32", attn_impl="dense"),
        projector=dataclasses.replace(cfg.projector, dtype="float32"))
    twin = LeopardVLM(f32_cfg, device="meta")
    twin.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, assign=True)
    f32 = Engine(f32_cfg, twin)
    pre32 = f32.build_prefix(pre.tokens)
    got32, _ = f32.prefill(suffixes, images=pixels, prefix=pre32)
    want32, _ = f32.prefill(prompts, images=pixels)
    cos32 = cosine(got32, want32).tolist()
    del f32, twin, pre32, got32, want32
    print(f"eval prefix caching: a {pre.length}-token header prefilled once for {len(batch)} "
          f"rows; first-step logits vs the plain prefill, cosine per row: fp32 twin (dense "
          f"attention) {[round(c, 7) for c in cos32]} (min {EVAL_PREFIX_COSINE_MIN}), bf16 "
          f"(K1 in the plain prefill) {[round(c, 6) for c in cos]} (min "
          f"{EVAL_PREFIX_BF16_MIN}), argmax agrees {same}; planted faults in bf16, each "
          f"below the limit on some row: "
          + "; ".join(f"{f} {[round(c, 6) for c in fc]}" for f, fc in fault_cos.items())
          + f" [{card}]", flush=True)
    if (not torch.isfinite(got).all() or min(cos32) < EVAL_PREFIX_COSINE_MIN
            or min(cos) < EVAL_PREFIX_BF16_MIN):
        raise AssertionError(f"eval prefix caching: cosine {cos32} (fp32), {cos} (bf16)")
    missed = [f for f, fc in fault_cos.items() if min(fc) >= EVAL_PREFIX_BF16_MIN]
    if missed:
        raise AssertionError(f"eval prefix caching: the bf16 limit {EVAL_PREFIX_BF16_MIN} "
                             f"does not catch the planted faults {missed}: {fault_cos}")
    plain_web = responses["visualwebbench"]
    cached_web = [d["raw"] for d in run_harness(cached, web, "visualwebbench", launches,
                                                EVAL_BATCH)[0]]
    agree = [tokens_agree(a.split(), b.split()) for a, b in zip(cached_web, plain_web)]
    rec["prefix"] = {"header_tokens": pre.length, "cosine_fp32": cos32,
                     "cosine_bf16": cos, "cosine_bf16_faults": fault_cos, "argmax_agrees": same,
                     "built": cached._prefixes.built, "tokens_agree": agree}
    del cached, pre

    # run_benchmark, one row at a time, on the prepared set
    metrics._rng.seed(42)
    t0 = time.perf_counter()
    serial = run_benchmark(web, adapter, "visualwebbench")
    serial_s = time.perf_counter() - t0
    agree_serial = [tokens_agree(a["raw"].split(), b.split()) for a, b in zip(serial, plain_web)]
    for i, p in enumerate(plans["visualwebbench"]):
        held("eval serial", "K1", batch_k1_ran(cfg, eval_batches([p], 1)), k1_checked)
    rec["serial"] = {"rows": len(web), "wall_s": serial_s, "tokens_agree": agree_serial}
    print(f"eval serial (run_benchmark) on the prepared set: {len(web)} rows in "
          f"{serial_s:.3f} s; agreement with the batched loop per row (same, first "
          f"difference) {agree_serial}; prefix-caching adapter vs plain {agree} "
          f"(bf16: batch shapes and the cached tier move argmax ties; reported) [{card}]",
          flush=True)
    del adapter
    model.text._head_f32 = None
    return rec


def idefics2_eval_phase(model, cfg, launches, card, k1_checked, root):
    """Phase 27 (B): LeopardIdefics2EvalAdapter on Leopard-Idefics2-8B in
    bf16: 8 rows of 1-8 images at batch 4, samples re-padded across each
    batch; the responses equal Engine.generate on the same batches; K1 held
    at the re-padded NaViT grids; the tower's output finite on every row."""
    import torch

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.evaluation.adapter import LeopardIdefics2EvalAdapter, repad_navit

    rows = load_eval_sets(root, ("mirb",))["mirb"]
    tok = MistralEvalTokenizer()
    gen = GenerateConfig(max_new_tokens=EVAL_TOKENS, greedy=True, eos_token_ids=(2, 32002))
    adapter = LeopardIdefics2EvalAdapter(cfg, model, tok, gen_cfg=gen)
    details, stats, counts, wall = run_harness(adapter, rows, "mirb", launches,
                                               IDEFICS2_EVAL_BATCH)
    prepared = idefics2_eval_prepared(cfg, rows)
    predicted = eval_batches([(p.n_tiles, len(p.prompt)) for p in prepared], IDEFICS2_EVAL_BATCH)
    check_stats("Idefics2 eval", stats, predicted)
    n_tok = [decoded_len(d["raw"]) for d in details]
    expect("Idefics2 eval", counts, batch_counts(cfg, predicted, n_tok, perceiver=True))
    direct = direct_generate(adapter, rows, stats, repad=True)
    if direct != [d["raw"] for d in details]:
        raise AssertionError(f"Idefics2 eval: responses differ from Engine.generate: {direct}")
    _, tile_b, bucket = engine_buckets()
    grids, finite = [], []
    for idxs, n, seq in predicted:
        pixels, mask = repad_navit([(prepared[i].pixels, prepared[i].patch_mask) for i in idxs])
        held("Idefics2 eval", "K1", batch_k1_ran(cfg, [(idxs, n, seq)], mask[0].size), k1_checked)
        pad = bucket(n, tile_b) - n  # the engine's padding images, all-zero masks
        px = torch.from_numpy(np.concatenate([pixels, np.zeros((pad,) + pixels.shape[1:],
                                                               pixels.dtype)]))
        pm = torch.from_numpy(np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)]))
        with torch.inference_mode():
            feats = adapter.engine.model.vision(px.to(adapter.engine.device),
                                                pm.to(adapter.engine.device))
            finite.append(bool(torch.isfinite(feats).all()))
        grids.append(list(mask.shape[1:]))
        del feats, px, pm
    if not all(finite):
        raise AssertionError(f"Idefics2 eval: the tower's output is not finite: {finite}")
    rec = {"rows": len(rows), "wall_s": wall, "samples_per_s": len(rows) / wall,
           "tokens_per_s": sum(n_tok) / wall, "launches": counts,
           "batches": [{"rows": len(s["indices"]), "images": s["n_tiles"], "bucket": s["bucket"],
                        "grid": g, "prefetch_wait_s": s["wait_s"],
                        "generate_s": s["generate_s"]} for s, g in zip(stats, grids)]}
    print(f"Idefics2 eval (8B bf16, batch {IDEFICS2_EVAL_BATCH}): {len(rows)} rows of 1-8 "
          f"images in {wall:.3f} s = {len(rows) / wall:.3f} samples/s, "
          f"{sum(n_tok) / wall:.1f} tok/s; batches (rows, images, bucket, re-padded grid) "
          f"{[(len(s['indices']), s['n_tiles'], s['bucket'], g) for s, g in zip(stats, grids)]}; "
          f"launches {counts} as the formula; the tower finite on every row; responses equal "
          f"to Engine.generate on the same batches [{card}]", flush=True)
    del adapter
    model.text._head_f32 = None
    return rec


def read_details(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_eval_phase(hf_dir, launches, card, k1_checked, k4_checked, root, tmp, device):
    """Phase 28 (C): the run_eval CLI on phase 19's depth-4 checkpoint
    (`--set text.num_layers=4`), datasets EVAL_CLI, 3 rows each, batches of
    2: two shards and the merge against a one-shard run (equal
    all_bench_results.json), each shard file against the adapter called
    directly on the same model; then --quantize int4 (K4 counted),
    --prefix-caching and --spec 7, their responses' agreement with bf16
    reported."""
    import torch

    from leopard_tpu_torch.cli import run_eval
    from leopard_tpu_torch.config import GenerateConfig, leopard_llava_8b
    from leopard_tpu_torch.convert.hf import load_leopard_llava
    from leopard_tpu_torch.evaluation import metrics
    from leopard_tpu_torch.evaluation.adapter import LeopardLlavaEvalAdapter
    from leopard_tpu_torch.evaluation.harness import run_benchmark_batched
    from leopard_tpu_torch.inference.engine import Engine

    cfg = train_config()
    lt = cfg.text.num_layers
    sets = load_eval_sets(root, EVAL_CLI)
    plans = llava_eval_plans(cfg, sets)
    tok = EvalTokenizer()
    builds = []
    real_build = Engine.build_prefix

    def counted_build(self, *a, **kw):
        builds.append(1)
        return real_build(self, *a, **kw)

    def cli(out, *extra):
        argv = ["--checkpoint", str(hf_dir), "--data-root", str(root), "--datasets", *EVAL_CLI,
                "--max-samples", str(EVAL_CLI_ROWS), "--batch-size", str(EVAL_CLI_BATCH),
                "--max-new-tokens", str(EVAL_TOKENS), "--result-dir", str(tmp / out),
                "--set", f"text.num_layers={lt}", "--device", device.type, *extra]
        metrics._rng.seed(42)  # a new process's generator
        builds.clear()
        Engine.build_prefix = counted_build
        try:
            with launches, contextlib.redirect_stdout(io.StringIO()):  # its progress lines
                t0 = time.perf_counter()
                merged = run_eval.run_eval(run_eval.parse_args(argv), tokenizer=tok,
                                           cfg=leopard_llava_8b())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            Engine.build_prefix = real_build
        return merged, launches.counts, wall, len(builds)

    def raws(out, name, shard=None):
        f = (f"{shard}_direct_{name}_shard_details.jsonl" if shard is not None
             else f"{name}_direct_details.jsonl")
        return read_details(tmp / out / f)

    rec = {"runs": {}}
    runs = [("shard1", "--num-shards", "2", "--shard", "1"),
            ("shard0", "--num-shards", "2", "--shard", "0"), ("one",),
            ("int4", "--quantize", "int4"), ("prefix", "--prefix-caching"), ("spec", "--spec", "7")]
    for label, *extra in runs:
        out = "two" if label.startswith("shard") else label
        merged, counts, wall, n_builds = cli(out, *extra)
        rec["runs"][label] = {"launches": counts, "wall_s": wall, "prefix_builds": n_builds}
        tokens = {name: [decoded_len(d["raw"]) for d in raws(
            out, name, 1 if label == "shard1" else (0 if label == "shard0" else None))]
            for name in EVAL_CLI}
        shard = {"shard1": (1, 2), "shard0": (0, 2)}.get(label, (0, 1))
        batches = {name: eval_batches(plans[name][:EVAL_CLI_ROWS], EVAL_CLI_BATCH, *shard)
                   for name in EVAL_CLI}
        want = {"flash_attention": 0, "fused_layer_norm": 0}
        for name in EVAL_CLI:
            c = batch_counts(cfg, batches[name], tokens[name])
            want["flash_attention"] += c["flash_attention"]
            want["fused_layer_norm"] += c["fused_layer_norm"]
            held(f"run_eval {label}", "K1", batch_k1_ran(cfg, batches[name]), k1_checked)
        if label == "prefix":  # a prefixed batch's suffix takes the continuation tiers
            want.pop("flash_attention")
        if label == "int4":  # the prefill's lm_head, then every decode matmul, at M = rows
            want["int4_matmul"] = sum(
                1 + (7 * lt + 1) * (max(min(EVAL_TOKENS, tokens[name][i] + 1) for i in idxs) - 1)
                for name in EVAL_CLI for idxs, _, _ in batches[name])
            held("run_eval int4", "K4 at (M, matmul)",
                 {(len(idxs), m) for name in EVAL_CLI for idxs, _, _ in batches[name]
                  for m in K4_SHAPES}, k4_checked)
        expect(f"run_eval {label}", counts, want)
        print(f"run_eval CLI {label} ({' '.join(extra) or 'bf16, one shard'}): {wall:.2f} s "
              f"with the load, launches {counts}"
              + (f", {n_builds} prefixes built" if label == "prefix" else "")
              + (f"; all_bench_results {json.dumps(merged)}" if merged else "")
              + f" [{card}]", flush=True)
    two = json.loads((tmp / "two" / "all_bench_results.json").read_text())
    one = json.loads((tmp / "one" / "all_bench_results.json").read_text())
    if two != one:
        raise AssertionError(f"run_eval: 2 shards + merge {two} != one shard {one}")
    for name in EVAL_CLI:
        if raws("two", name) != raws("one", name):
            raise AssertionError(f"run_eval {name}: merged details differ from one shard's")
    if rec["runs"]["prefix"]["prefix_builds"] == 0:
        raise AssertionError("run_eval --prefix-caching built no prefix")

    # each shard file is the adapter called directly on the same model
    model = load_leopard_llava(str(hf_dir), cfg, device)
    adapter = LeopardLlavaEvalAdapter(cfg, model, tok, gen_cfg=GenerateConfig(
        max_new_tokens=EVAL_TOKENS, greedy=True, eos_token_ids=(128001, 128009)))
    for shard in (1, 0):
        metrics._rng.seed(42)
        for name in EVAL_CLI:
            want = run_benchmark_batched(sets[name][:EVAL_CLI_ROWS], adapter, name, shard=shard,
                                         num_shards=2, batch_size=EVAL_CLI_BATCH)
            if raws("two", name, shard) != want:
                raise AssertionError(f"run_eval shard {shard} {name}: differs from the adapter")
    del adapter, model
    agree = {}
    for label in ("int4", "prefix", "spec"):
        agree[label] = [tokens_agree(a["raw"].split(), b["raw"].split())
                        for name in EVAL_CLI for a, b in zip(raws(label, name), raws("one", name))]
    rec["tokens_agree_with_bf16"] = agree
    rec["all_bench_results"] = one
    print(f"run_eval CLI: 2 shards + merge equal to one shard (all_bench_results.json and "
          f"details), each shard file equal to the adapter called directly; agreement with "
          f"the bf16 run per row (same, first difference): {agree} [{card}]", flush=True)
    return rec


def lm_eval_phase(hf_dir, launches, card, k1_checked, device):
    """Phase 29 (D): LeopardLM on phase 19's depth-4 checkpoint: loglikelihood
    and loglikelihood_rolling of LM_REQUESTS texts of 2,200 tokens (K1 at
    [1, 2,200]) against the same decoder with attn_impl="dense", summed and
    per token, and the planted fault that the limits must catch; one
    generate_until."""
    from leopard_tpu_torch.convert.hf import load_leopard_llava
    from leopard_tpu_torch.evaluation.lm_eval_adapter import LeopardLM

    cfg = train_config()
    lt = cfg.text.num_layers
    model = load_leopard_llava(str(hf_dir), cfg, device)
    dense_cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, attn_impl="dense"))
    fault_cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, attn_impl="dense", sliding_window=LM_FAULT_WINDOW))
    tok = EvalTokenizer()
    rng = np.random.RandomState(SEED + 29)
    reqs = [(random_text(rng, LM_CONTEXT), random_text(rng, LM_CONT))
            for _ in range(LM_REQUESTS)]
    texts = [(c + x,) for c, x in reqs]
    out, per_token = {}, {}
    for label, c in (("kernel", cfg), ("dense", dense_cfg), ("fault", fault_cfg)):
        lm = LeopardLM(c, model if label == "kernel" else idefics2_twin(model, c), tok)  # a twin on the same tensors
        with launches:
            t0 = time.perf_counter()
            ll = lm.loglikelihood(reqs)
            roll = lm.loglikelihood_rolling(texts)
            wall = time.perf_counter() - t0
        out[label] = {"loglikelihood": ll, "rolling": roll, "launches": launches.counts,
                      "wall_s": wall}
        per_token[label] = [token_logprobs(lm, t) for (t,) in texts]
        if label == "kernel":
            with launches:
                gen = lm.generate_until([(reqs[0][0], {"max_gen_toks": 8, "until": ["\n"]})])
            out["generate_until"] = {"text": gen[0], "launches": launches.counts}
        model.text._head_f32 = None
        del lm
    n = 2 * LM_REQUESTS
    expect("LeopardLM", out["kernel"]["launches"], {"flash_attention": n * lt,
                                                     "fused_rms_norm": n * (2 * lt + 1)})
    expect("LeopardLM dense", out["dense"]["launches"], {"flash_attention": 0})
    expect("LeopardLM fault", out["fault"]["launches"], {"flash_attention": 0})
    held("LeopardLM", "K1", {("decoder", 1, 1 + LM_CONTEXT + LM_CONT, None)}, k1_checked)

    def sums(r):
        return [s for s, _ in r["loglikelihood"]] + r["rolling"]

    want = sums(out["dense"])
    rel = {label: max(abs(a - b) / abs(b) for a, b in zip(sums(out[label]), want))
           for label in ("kernel", "fault")}
    tok_diff = {label: max((a - b).abs().max().item()
                           for a, b in zip(per_token[label], per_token["dense"]))
                for label in ("kernel", "fault")}
    got = sums(out["kernel"])
    k, d = out["kernel"], out["dense"]
    flags = [(a, b) for (_, a), (_, b) in zip(k["loglikelihood"], d["loglikelihood"])]
    print(f"LeopardLM (depth-4 checkpoint, bf16): loglikelihood of {LM_REQUESTS} requests "
          f"({1 + LM_CONTEXT} context + {LM_CONT} tokens) and loglikelihood_rolling of "
          f"{LM_REQUESTS} texts through K1 {[round(x, 4) for x in got]} vs the dense decoder "
          f"{[round(x, 4) for x in want]}: summed logprobs' relative difference max "
          f"{rel['kernel']:.3g} (rtol {LM_RTOL}), per-token logprob |diff| max "
          f"{tok_diff['kernel']:.4g} (atol {LM_TOKEN_ATOL}); planted fault (the dense decoder "
          f"with a {LM_FAULT_WINDOW}-token window) {rel['fault']:.3g} and "
          f"{tok_diff['fault']:.4g}; greedy flags (kernel, dense) {flags}; "
          f"{k['wall_s']:.3f} s; launches {k['launches']}; generate_until: "
          f"{out['generate_until']['launches']} [{card}]", flush=True)
    if (not all(np.isfinite(got)) or rel["kernel"] > LM_RTOL
            or tok_diff["kernel"] > LM_TOKEN_ATOL):
        raise AssertionError(f"LeopardLM: kernel {got} vs dense {want}, per-token "
                             f"|diff| {tok_diff['kernel']}")
    if rel["fault"] <= LM_RTOL or tok_diff["fault"] <= LM_TOKEN_ATOL:
        raise AssertionError(f"LeopardLM: the limits (rtol {LM_RTOL}, atol {LM_TOKEN_ATOL}) "
                             f"do not catch the planted fault: {rel['fault']}, "
                             f"{tok_diff['fault']}")
    del model
    out["max_rel_diff"] = rel["kernel"]
    out["fault_max_rel_diff"] = rel["fault"]
    out["token_max_abs_diff"] = tok_diff["kernel"]
    out["fault_token_max_abs_diff"] = tok_diff["fault"]
    return out


def token_logprobs(lm, text):
    """The log-probability of each token of `text` after the first, as
    LeopardLM's rolling score reads them (fp32, moved to the host)."""
    import torch

    ids = lm.tokenizer(text, add_special_tokens=True)["input_ids"]
    pad = 8 * ((len(ids) + 7) // 8)
    tokens, seg = np.zeros((1, pad), np.int32), np.zeros((1, pad), np.int32)
    tokens[0, :len(ids)] = ids
    seg[0, :len(ids)] = 1
    lp = lm._logprobs(tokens, seg)
    target = torch.as_tensor(ids[1:], device=lp.device, dtype=torch.long)[:, None]
    return lp[:len(ids) - 1].gather(1, target)[:, 0].cpu()


def train_policies_phase(model, cfg, batch, card):
    """Phase 30 (E): the first step's loss and gradients under "attn" and
    "selective" against "full" on the same batch and masters (cosine per
    parameter group), K1/K2 launches a step (31 and 31 against 62 and 31),
    then two train steps under each policy: ms a step and peak memory."""
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.training import trainer

    lt, lv = cfg.text.num_layers, cfg.vision.num_layers

    def tcfg(policy):
        return TrainConfig(seq_len=TRAIN_SEQ, global_batch_size=len(TRAIN_ROWS), remat=policy,
                           loss_chunk=1024, optimizer=OptimizerConfig(
                               lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0))

    state = trainer.create_train_state(model, tcfg("full"))
    rec, ref = {}, None
    for policy in REMAT_POLICIES:
        step = trainer.make_train_step(cfg, tcfg(policy), model=model)
        flash_attention.launches = flash_attention_bwd.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the state, and full's gradients after full
        t0 = time.perf_counter()
        loss, _, grads = step.loss_and_grads(state, batch)
        torch.cuda.synchronize()
        grad_ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        k1, k2 = flash_attention.launches, flash_attention_bwd.launches
        want = (2 * (lt + lv) if policy == "full" else lt + lv, lt + lv)
        if (k1, k2) != want:
            raise AssertionError(f"remat {policy}: K1/K2 launches {(k1, k2)}, expected {want}")
        r = {"loss": loss.item(), "launches": {"flash_attention": k1, "flash_attention_bwd": k2},
             "loss_and_grads_ms": grad_ms, "loss_and_grads_added_gib": peak}
        if ref is None:
            ref = grads
        else:
            sums = {}
            for n, a in grads.items():
                b = ref[n]
                acc = sums.setdefault(param_group(n), [0.0, 0.0, 0.0])
                acc[0] += float((a.double() * b.double()).sum())
                acc[1] += float(a.double().square().sum())
                acc[2] += float(b.double().square().sum())
            r["cosines"] = {g: dot / max((na * nb) ** 0.5, 1e-30)
                            for g, (dot, na, nb) in sums.items()}
            r["loss_rel_diff"] = abs(r["loss"] - rec["full"]["loss"]) / abs(rec["full"]["loss"])
        del grads
        rec[policy] = r
    del ref
    for policy in REMAT_POLICIES:  # two train steps each, on the one state
        step = trainer.make_train_step(cfg, tcfg(policy), model=model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(float(metrics["loss"])):
                raise AssertionError(f"remat {policy}: non-finite loss")
        rec[policy]["step_ms"] = times
        rec[policy]["step_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del state
    for policy in REMAT_POLICIES:
        r = rec[policy]
        print(f"train remat={policy}: loss {r['loss']:.6f}"
              + (f" (rel. diff to full {r['loss_rel_diff']:.3g}), gradient cosine to full per "
                 "group " + ", ".join(f"{g}: {c:.6f}" for g, c in r["cosines"].items())
                 if "cosines" in r else "")
              + f"; K1/K2 a step {r['launches']}; loss_and_grads {r['loss_and_grads_ms']:.1f} "
              f"ms (its peak {r['loss_and_grads_added_gib']:.2f} GiB above the state); train "
              f"steps {[round(t, 1) for t in r['step_ms']]} ms (peak "
              f"{r['step_peak_memory_gib']:.2f} GiB) [{card}]", flush=True)
        if "cosines" in r and (min(r["cosines"].values()) < REMAT_COSINE_MIN
                               or r["loss_rel_diff"] > 1e-5):
            raise AssertionError(f"remat {policy}: differs from full: {r}")
    return rec


def main() -> int:
    import torch

    # phase 1: environment
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this smoke runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from leopard_tpu_torch.config import leopard_llava_8b
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.ops import _build
    from leopard_tpu_torch.ops.flash_attention import flash_attention

    # fp32 matmuls and convolutions in full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    if torch.cuda.device_count() != 1:
        print(f"note: {torch.cuda.device_count()} cards visible; the smoke uses card 0", flush=True)
    print("tf32: matmul False, cudnn False", flush=True)

    # phase 2: build, one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        for path in pool.map(lambda name: _build.build(name, verbose=True), KERNELS):
            print(f"build: {path.name}", flush=True)
    for name in KERNELS:
        _build.load_library(name)
    print(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s", flush=True)

    # the eval sets of phases 26-29, written now and planned without a
    # model, so that phase 3 holds K1 at every shape their batches give
    icfg = idefics2_config()
    eval_tmp = tempfile.TemporaryDirectory(prefix="leopard_eval_")
    eval_root = Path(eval_tmp.name)
    write_s = write_eval_sets(eval_root)
    eval_plans = llava_eval_plans(leopard_llava_8b(), load_eval_sets(
        eval_root, ("mpdocvqa", "slidevqa", "visualwebbench")))
    seq_b, tile_b, bucket = engine_buckets()
    eval_masks = idefics2_eval_masks(idefics2_eval_prepared(icfg, load_eval_sets(
        eval_root, ("mirb",))["mirb"]), tile_b, bucket)
    eval_shapes = eval_k1_shapes(leopard_llava_8b(), eval_plans, icfg, eval_masks)
    print(f"eval sets written in {write_s:.2f} s; planned rows (crops, prompt tokens): "
          f"{eval_plans}; K1 shapes of phases 26-29: {sorted(eval_shapes)}", flush=True)

    # phase 3: kernel against its plain version at the serving path's shapes
    # (Leopard-LLaVA's, then those of the Idefics2 phases 22-25 and of the
    # eval phases 26-29)
    k1_shapes = {**K1_SHAPES, **idefics2_k1_shapes(icfg), **eval_shapes}
    per_shape = {name: kernel_vs_plain(name, device=device, card=card, **kw)
                 for name, kw in k1_shapes.items()}
    k1_checked = k1_held(k1_shapes)
    # 1 GiB > L2; reading it keeps the device busy ~0.3 ms while a launch is queued
    flush = torch.empty(2**30 // 4, dtype=torch.float32, device=device)
    k4_shapes = {name: int4_vs_plain(name, 2, k, n, device, card, flush)
                 for name, (k, n, _) in K4_SHAPES.items()}
    # the slot pool's decode (phase 17) runs every matmul at M = slots
    m_pool = POOL_INT4["slots"]
    k4_pool = {name: int4_vs_plain(f"{name}_m{m_pool}", m_pool, k, n, device, card, flush)
               for name, (k, n, _) in K4_SHAPES.items()}
    k4_m64 = int4_vs_plain("gate_up_m64", 64, 4096, 14336, device, card, flush)
    # a single request's decode (phase 19's int4 server) runs every matmul at M = 1
    k4_m1 = {name: int4_vs_plain(f"{name}_m1", 1, k, n, device, card, flush)
             for name, (k, n, _) in K4_SHAPES.items()}
    k4_checked = ({(2, name) for name in K4_SHAPES} | {(m_pool, name) for name in K4_SHAPES}
                  | {(1, name) for name in K4_SHAPES} | {(64, "gate_up")})
    # K2 at the train path's shapes, K3 at its rows
    full = leopard_llava_8b()
    text, vis = full.text, full.vision
    n_tiles = sum(len(row) for row in TRAIN_ROWS) * TRAIN_TILES_PER_SAMPLE
    k2 = {name: flash_bwd_vs_plain(name, device=device, card=card, **kw)
          for name, kw in k2_shapes(text, vis).items()}
    k3 = {"rms": norm_vs_plain("rms", len(TRAIN_ROWS) * TRAIN_SEQ, text.hidden_size, device,
                               card, flush),
          "ln": norm_vs_plain("ln", n_tiles * vis.tokens_per_tile, vis.hidden_size, device,
                              card, flush)}
    # K3 at the Idefics2 encode's new rows: phase 22's eight images of 4,900
    # patches through the perceiver's context norm and the tower's LayerNorms
    navit_rows = k1_shapes["navit_b8"]["b"] * k1_shapes["navit_b8"]["s"]
    k3_idefics2 = {"rms": norm_vs_plain("rms", navit_rows, icfg.perceiver.hidden_size, device,
                                        card, flush, eps=icfg.perceiver.rms_norm_eps),
                   "ln": norm_vs_plain("ln", navit_rows, icfg.vision.hidden_size, device, card,
                                       flush, eps=icfg.vision.layer_norm_eps)}
    del flush
    # K4 in one 8B decode step: the seven matmuls of each layer and lm_head
    n_layers = leopard_llava_8b().text.num_layers
    step_calls = {name: n_layers * per + (name == "lm_head")
                  for name, (_, _, per) in K4_SHAPES.items()}

    def per_step(shapes, key):
        vals = [shapes[name][key] for name in K4_SHAPES]
        if any(v is None for v in vals):
            return None
        return sum(step_calls[name] * shapes[name][key] for name in K4_SHAPES)

    step_keys = ("ms", "plain_ms", "library_ms", "dense_ms", "host_us", "dense_host_us",
                 "bound_ms")
    k4_step = {key: per_step(k4_shapes, key) for key in step_keys}
    k4_step_pool = {key: per_step(k4_pool, key) for key in step_keys}
    lib_step = ("not available" if k4_step["library_ms"] is None
                else f"{k4_step['library_ms']:.4f} ms")
    print(f"K4 per 8B decode step (batch 2, {sum(step_calls.values())} calls, cold L2): kernel "
          f"{k4_step['ms']:.4f} ms, bound {k4_step['bound_ms']:.4f} ms "
          f"({k4_step['bound_ms'] / k4_step['ms']:.3f} of it), plain {k4_step['plain_ms']:.4f} "
          f"ms, tinygemm {lib_step}, dense bf16 {k4_step['dense_ms']:.4f} ms; host ms per step: "
          f"quant.matmul (K4) {k4_step['host_us'] / 1e3:.3f}, F.linear "
          f"{k4_step['dense_host_us'] / 1e3:.3f} [{card}]", flush=True)
    print(f"K4 per 8B decode step at M={m_pool} (the slot pool's): kernel "
          f"{k4_step_pool['ms']:.4f} ms, bound {k4_step_pool['bound_ms']:.4f} ms, plain "
          f"{k4_step_pool['plain_ms']:.4f} ms, dense bf16 {k4_step_pool['dense_ms']:.4f} ms "
          f"[{card}]", flush=True)
    torch.cuda.empty_cache()

    # phase 4: serving at 8B
    cfg = leopard_llava_8b()
    t0 = time.perf_counter()
    model = vlm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: Leopard-LLaVA-8B, {n_params} parameters (bf16), seeded random init "
          f"on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    engine = Engine(cfg, model)
    prompts, tiles = make_requests(cfg, 2, text_lengths=(500, 1100))
    timings = serve(engine, cfg, prompts, tiles, card, "serve bf16")
    del engine
    model.text._head_f32 = None  # the bf16 engine's fp32 head copy
    peak = {"bf16": phase_memory("serve bf16")}

    # phase 5: kernel path against the dense path, end to end
    cos, same_argmax = kernel_vs_dense_end_to_end(
        model, cfg, prompts[0], tiles[:TILES_PER_REQUEST], device)
    phase_memory("K1 vs dense")

    # phase 6: int4 serving at 8B, through K4 at every decode matmul
    k4_per_step = 7 * cfg.text.num_layers + 1
    engine = Engine(cfg, model, quantize="int4")
    timings_int4 = serve(engine, cfg, prompts, tiles, card, "serve int4", k4_per_step)
    print(f"decode ms/step [{card}]: bf16 {timings['decode_ms_per_step']:.2f}, "
          f"int4 {timings_int4['decode_ms_per_step']:.2f}; TTFT ms: bf16 "
          f"{timings['ttft_s'] * 1e3:.1f}, int4 {timings_int4['ttft_s'] * 1e3:.1f}", flush=True)

    # phase 7: the K4 path against the dense path, end to end
    cos4, same_argmax4 = int4_vs_dense_decode_step(
        engine.model, cfg, prompts[0], tiles[:TILES_PER_REQUEST], device)
    del engine
    peak["int4"] = phase_memory("serve int4 + K4 vs dense")

    # phase 8: int4 weights and the int8 KV cache
    engine = Engine(cfg, model, quantize="int4", quantize_kv=True)
    timings_kv8 = serve(engine, cfg, prompts, tiles, card, "serve int4 + int8 KV", k4_per_step,
                        runs=1, time_reps=0)
    del engine
    peak["int4_kv8"] = phase_memory("serve int4 + int8 KV")

    # phase 9: int8 weights (plain PyTorch, no kernel of their own)
    engine = Engine(cfg, model, quantize="int8")
    timings_int8 = serve(engine, cfg, prompts, tiles, card, "serve int8", runs=1, time_reps=1)
    del engine
    peak["int8"] = phase_memory("serve int8")

    # phases 10-14: prefixes, multi-turn chat, chunked prefill, int4 + int8
    # KV over a second turn, speculative decode and beam search
    launches = Launches()
    features = {}
    engine = Engine(cfg, model)
    features["prefix"] = prefix_phase(engine, cfg, launches, card)
    peak["prefix"] = phase_memory("prefix")
    features["multiturn"], (prefix1, turn2, tiles2) = multiturn_phase(
        engine, cfg, launches, prompts, tiles, card)
    features["continuation_timing"] = continuation_timing(cfg, prefix1.length, len(turn2),
                                                          device, card)
    del prefix1
    peak["multiturn"] = phase_memory("multi-turn")
    features["chunked"] = chunked_phase(model, engine, cfg, launches, card)
    peak["chunked"] = phase_memory("chunked prefill")
    del engine
    model.text._head_f32 = None
    engine = Engine(cfg, model, quantize="int4", quantize_kv=True)
    features["multiturn_int4_kv8"], _ = multiturn(
        engine, cfg, launches, prompts[0], tiles[:TILES_PER_REQUEST], turn2, tiles2,
        "multi-turn int4 + int8 KV", k4_per_step)
    features["spec_int4_kv8"] = spec_phase(engine, cfg, launches, card,
                                           "speculative int4 + int8 KV", k4_per_step)
    del engine
    peak["multiturn_int4_kv8"] = phase_memory("multi-turn + speculative, int4 + int8 KV")
    engine = Engine(cfg, model)
    features["spec"] = spec_phase(engine, cfg, launches, card, "speculative bf16")
    features["beam"] = beam_phase(engine, cfg, launches, card)
    del engine
    model.text._head_f32 = None
    peak["spec_beam"] = phase_memory("speculative + beam, bf16")

    # phases 15-17: the HTTP server and text API, then the slot pool of
    # continuous batching in bf16 and with int4 weights, int8 KV and a prefix
    engine = Engine(cfg, model)
    features["server"] = server_phase(engine, cfg, launches, card)
    peak["server"] = phase_memory("server")
    features["pool"] = continuous_phase(engine, cfg, launches, card)
    del engine
    model.text._head_f32 = None
    peak["pool"] = phase_memory("pool bf16")
    engine = Engine(cfg, model, quantize="int4", quantize_kv=True)
    features["pool_int4_kv8"] = continuous_int4_phase(engine, cfg, launches, card, k4_checked)
    del engine
    peak["pool_int4_kv8"] = phase_memory("pool int4 + int8 KV")

    # phase 18: HF conversion at full 8B width and depth, in memory, and
    # transformers' Llama and SigLIP on the exported tensors
    features["hf"] = hf_phase(model, cfg, launches, card, device)
    peak["hf"] = phase_memory("HF conversion and transformers")

    # phase 26 (eval A): the eval harness on Leopard-LLaVA-8B
    evals = {"llava": llava_eval_phase(model, cfg, launches, card, k1_checked, eval_root)}
    peak["eval_llava"] = phase_memory("eval LLaVA-8B")
    del model
    torch.cuda.empty_cache()

    # phases 19-21 at 8B widths with the text depth cut to 4 of 32 (the 8B
    # train state, ~18 B a parameter, does not fit one card); phase 21
    # fine-tunes from the checkpoint that phase 19 writes
    tcfg = train_config()
    with tempfile.TemporaryDirectory(prefix="leopard_smoke_") as tmp:
        # phase 19: from a checkpoint on disk, through the convert, generate
        # and serve CLIs
        features["checkpoint"], hf_dir = checkpoint_phase(tcfg, launches, card, k4_checked,
                                                          Path(tmp), device)
        peak["checkpoint"] = phase_memory("checkpoint and the convert, generate, serve CLIs")

        # phase 20: training at 8B width, text depth 4, on a synthetic batch
        model = vlm.init_params(tcfg, torch.Generator(device=device).manual_seed(SEED))
        batch = train_batch(tcfg, device)
        n_train = sum(p.numel() for p in model.parameters())
        print(f"train model: Leopard-LLaVA-8B widths, {TRAIN_TEXT_LAYERS} of 32 text layers, "
              f"{n_train} parameters; batch {len(TRAIN_ROWS)} x {TRAIN_SEQ} tokens packing "
              f"{[list(r) for r in TRAIN_ROWS]}, {batch['images'].shape[0]} tiles", flush=True)
        grads_check = train_grads_vs_dense(model, tcfg, batch, card)
        torch.cuda.empty_cache()
        train_run = train_phase(model, tcfg, batch, card)
        peak["train"] = phase_memory("train")
        # phase 30 (eval E): the "attn" and "selective" recompute policies
        evals["remat"] = train_policies_phase(model, tcfg, batch, card)
        del model, batch
        peak["train_policies"] = phase_memory("train under attn / selective")

        # phase 21: the train CLI from a manifest, --init-from phase 19's
        # checkpoint, through the data pipeline
        features["train_cli"] = train_cli_phase(hf_dir, card, Path(tmp), device)
        peak["train_cli"] = phase_memory("train CLI")

        # phases 28-29 (eval C-D): the run_eval CLI and LeopardLM on phase
        # 19's checkpoint
        evals["run_eval"] = run_eval_phase(hf_dir, launches, card, k1_checked, k4_checked,
                                           eval_root, Path(tmp), device)
        peak["run_eval"] = phase_memory("run_eval CLI")
        evals["lm_eval"] = lm_eval_phase(hf_dir, launches, card, k1_checked, device)
        peak["lm_eval"] = phase_memory("LeopardLM")

    # phases 22-25 (A-D): Leopard-Idefics2 serving at 8B, full depth and
    # width (A-C), then from a depth-4 checkpoint on disk (D)
    model = idefics2_model(icfg, device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: Leopard-Idefics2-8B, {n_params} parameters (bf16), seeded random init on "
          f"the card", flush=True)
    idefics2 = {"serve": idefics2_serve_phase(model, icfg, launches, card, k1_checked, device)}
    peak["idefics2_serve"] = phase_memory("Idefics2 serve")
    idefics2["dense"] = idefics2_dense_phase(model, icfg, launches, card, k1_checked)
    peak["idefics2_dense"] = phase_memory("Idefics2 K1 vs dense and no window")
    idefics2["hf"] = idefics2_hf_phase(model, icfg, launches, card, device, k1_checked)
    peak["idefics2_hf"] = phase_memory("Idefics2 HF conversion and transformers")
    # phase 27 (eval B): the eval harness on Leopard-Idefics2-8B
    evals["idefics2"] = idefics2_eval_phase(model, icfg, launches, card, k1_checked, eval_root)
    peak["eval_idefics2"] = phase_memory("eval Idefics2-8B")
    eval_tmp.cleanup()
    del model
    torch.cuda.empty_cache()
    dcfg = dataclasses.replace(icfg, text=dataclasses.replace(
        icfg.text, num_layers=IDEFICS2_TEXT_LAYERS))
    with tempfile.TemporaryDirectory(prefix="leopard_smoke_") as tmp:
        idefics2["checkpoint"] = idefics2_checkpoint_phase(dcfg, launches, card, Path(tmp),
                                                           device, k1_checked)
    peak["idefics2_checkpoint"] = phase_memory("Idefics2 checkpoint and the convert, serve CLIs")
    features["idefics2"] = idefics2

    # phase 31: no JAX
    if "jax" in sys.modules or any(m.split(".")[0] == "leopard_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    print("no jax: ok", flush=True)

    per_generate = ((cfg.vision.num_layers, per_shape["vision_b32"]),
                    (cfg.text.num_layers, per_shape["decoder"]))
    per_idefics2 = ((icfg.vision.num_layers, per_shape["navit_b8"]),
                    (icfg.text.num_layers, per_shape[f"mistral_{IDEFICS2_BUCKET}"]))
    per_train_step = ((tcfg.text.num_layers, k2["decoder"]),
                      (tcfg.vision.num_layers, k2["tower"]))

    def total(parts, key):
        return sum(n * r[key] for n, r in parts)

    def new_paths(name):
        """A kernel's launches on phases 15-19's and 21's paths."""
        server, hf, ckpt = features["server"], features["hf"], features["checkpoint"]
        return {"launches_server_generate": server["generate"]["launches"][name],
                "launches_server_images": (server["images"]["launches"][name]
                                           if "images" in server else None),
                "launches_pool": features["pool"]["launches"][name],
                "launches_pool_int4_kv8": features["pool_int4_kv8"]["launches"][name],
                "launches_hf_llama": hf["llama"]["launches"][name],
                "launches_hf_siglip": hf["siglip"]["launches"][name],
                "launches_generate_cli": ckpt["generate"]["launches"][name],
                "launches_serve_cli_int4": ckpt["serve_int4"]["launches"][name],
                "launches_train_cli": features["train_cli"]["launches"].get(name, 0)}

    def eval_paths(name):
        """A kernel's launches on phases 26-29's paths."""
        return {"launches_eval_llava": {k: r["launches"].get(name, 0)
                                        for k, r in evals["llava"]["sets"].items()},
                "launches_eval_idefics2": evals["idefics2"]["launches"].get(name, 0),
                "launches_run_eval_cli": {k: r["launches"].get(name, 0)
                                          for k, r in evals["run_eval"]["runs"].items()},
                "launches_lm_eval": evals["lm_eval"]["kernel"]["launches"].get(name, 0)}

    def remat_paths(name):
        """K1's or K2's launches a train step under each policy (phase 30)."""
        return {"launches_train_step_by_remat": {
            p: evals["remat"][p]["launches"][name] for p in REMAT_POLICIES}}

    def bound_by(parts):
        """What bounds a sum of calls: the side holding most of its bound."""
        share = {"operations": 0.0, "bytes": 0.0}
        for n, r in parts:
            share[r["bound_by"]] += n * r["bound_ms"]
        return max(share, key=share.get)

    kernels = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "leopard_tpu_torch/csrc/flash_attention.cu",
        "replaces": "leopard_tpu/ops/pallas/flash_attention.py:199",
        "launches": timings["launches"]["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        "ms": total(per_generate, "ms"),
        "plain_ms": total(per_generate, "plain_ms"),
        "bound_ms": total(per_generate, "bound_ms"),
        "bound_by": bound_by(per_generate),
        "library_ms": total(per_generate, "library_ms"),
        "library": "F.scaled_dot_product_attention forward at the same shapes, unsegmented",
        "library_attended_ms": total(per_generate, "library_attended_ms"),
        "library_attended": "the same SDPA forward over the valid rows only",
        "design": "wgmma+tma",
        "copies": sum(t["copies"] for t in (timings, timings_int4, timings_kv8, timings_int8)),
        "copies_is": "flash_attention.copies over every generate call of the serving phases",
        "ms_is": "per generate: 27 x vision_b32 + 32 x decoder",
        "launches_train": train_run["launches"]["flash_attention"],
        "launches_build_prefix": features["prefix"]["build_prefix_launches"]["flash_attention"],
        "launches_turn2": features["multiturn"]["launches"]["flash_attention"],
        "launches_chunked_prefill": features["chunked"]["launches"]["flash_attention"],
        **new_paths("flash_attention"),
        **eval_paths("flash_attention"),
        **remat_paths("flash_attention"),
        "idefics2": {
            "launches_per_generate": idefics2["serve"]["launches"]["flash_attention"],
            "launches_serve_cli_depth4": idefics2["checkpoint"]["serve"]["launches"][
                "flash_attention"],
            **{key: total(per_idefics2, key)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms", "library_attended_ms")},
            "library_masked_ms": (None if any(r.get("library_masked_ms") is None
                                              for _, r in per_idefics2)
                                  else total(per_idefics2, "library_masked_ms")),
            "bound_by": bound_by(per_idefics2),
            "ms_is": f"per Idefics2 generate: 27 x navit_b8 + 32 x mistral_{IDEFICS2_BUCKET}",
            "serve": idefics2["serve"],
            "end_to_end_cosine_vs_dense": idefics2["dense"]["cosine_vs_dense"],
        },
        "shapes": list(per_shape.values()),
        "card": card,
        "serve": timings,
        "end_to_end_cosine": cos,
        "end_to_end_argmax_agrees": same_argmax,
    }, {
        "name": "int4_matmul",
        "route": "cuda",
        "source": "leopard_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "leopard_tpu/ops/pallas/int4_matmul.py:76",
        "launches": timings_int4["launches"]["int4_matmul"],
        "max_abs_err": max(r["max_abs_err"] for r in [*k4_shapes.values(),
                                                       *k4_pool.values(), k4_m64,
                                                       *k4_m1.values()]),
        "ms": k4_step["ms"],
        "plain_ms": k4_step["plain_ms"],
        "bound_ms": k4_step["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k4_step["library_ms"],
        "library": ("torch._weight_int4pack_mm (ATen tinygemm) on the same nibbles, scales "
                    "and zeros in bf16 (zero 0), bf16 output"
                    + ("" if k4_step["library_ms"] is not None else ": not available, "
                       + str(k4_shapes["lm_head"]["library_error"]))),
        "dense_ms": k4_step["dense_ms"],
        "dense": "F.linear with the bf16 weight of the same shape, which int4 replaces",
        "host_us": {"k4_per_step": k4_step["host_us"],
                    "f_linear_per_step": k4_step["dense_host_us"],
                    "k4_per_call": {name: r["host_us"] for name, r in k4_shapes.items()},
                    "f_linear_per_call": {name: r["dense_host_us"]
                                          for name, r in k4_shapes.items()},
                    "is": "host µs of quant.matmul (K4) and F.linear, loop of 200 calls "
                          "with the device kept ahead"},
        "design": "mma.sync m16n8k16 bf16 (weight columns as MMA rows, x rows as n8) on "
                  "nibbles unpacked in registers (ldmatrix.trans, prmt, lop3, bf16x2 fma); "
                  "TMA + bulk-copy ring of 4 stages, one producer warp; exact fp32 group "
                  "scales per plane; K split in group pairs, summed in split order by the "
                  "last block: one launch a call",
        "ms_is": "per 8B decode step at batch 2, cold L2: 32 x (2 wq_wo + 2 wk_wv "
                 "+ 2 gate_up + down) + lm_head",
        "per_step_pool": k4_step_pool,
        "per_step_pool_is": f"the same step at M = {m_pool}, the slot pool's decode",
        "shapes": [*k4_shapes.values(), *k4_pool.values(), k4_m64, *k4_m1.values()],
        "card": card,
        "serve_int4": timings_int4,
        "launches_turn2_int4_kv8": features["multiturn_int4_kv8"]["launches"]["int4_matmul"],
        "launches_spec_int4_kv8": features["spec_int4_kv8"]["launches"]["int4_matmul"],
        "spec_rounds_int4_kv8": features["spec_int4_kv8"]["rounds"],
        **new_paths("int4_matmul"),
        **eval_paths("int4_matmul"),
        "serve_int8": timings_int8,
        "end_to_end_cosine": cos4,
        "end_to_end_argmax_agrees": same_argmax4,
        "peak_memory_gib": peak,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "leopard_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "leopard_tpu/ops/pallas/flash_attention.py:443",
        "launches": train_run["launches"]["flash_attention_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
        "ms": total(per_train_step, "ms"),
        "plain_ms": total(per_train_step, "plain_ms"),
        "bound_ms": total(per_train_step, "bound_ms"),
        "bound_by": bound_by(per_train_step),
        "library_ms": total(per_train_step, "library_ms"),
        "library": "backward of F.scaled_dot_product_attention at the same shapes, unsegmented",
        "library_attended_ms": total(per_train_step, "library_attended_ms"),
        "library_attended": "the same SDPA backward over each packed segment alone",
        "design": "wgmma+tma",
        "copies": train_run["copies"],
        "copies_is": "flash_attention.copies (K1 and K2 inputs) over the train() run",
        "ms_is": f"per train step: {tcfg.text.num_layers} x decoder + "
                 f"{tcfg.vision.num_layers} x tower",
        "launches_train_cli": features["train_cli"]["launches"]["flash_attention_bwd"],
        **remat_paths("flash_attention_bwd"),
        "shapes": list(k2.values()),
        "card": card,
        "train": train_run,
        "train_grads_vs_dense": grads_check,
    }, *[{
        "name": name,
        "route": "triton",
        "source": "leopard_tpu_torch/ops/fused_norms.py",
        "replaces": f"leopard_tpu/ops/pallas/norms.py:{line}",
        "launches": train_run["launches"][name],
        "launches_per_generate": timings["launches"][name],
        "launches_per_idefics2_generate": idefics2["serve"]["launches"][name],
        "launches_serving_features": {phase: rec["launches"][name] for phase, rec in
                                      features.items() if "launches" in rec},
        **new_paths(name),
        **eval_paths(name),
        "max_abs_err": k3[kind]["max_abs_err"],
        "ms": k3[kind]["ms"],
        "plain_ms": k3[kind]["plain_ms"],
        "bound_ms": k3[kind]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k3[kind]["library_ms"],
        "library": library,
        "ms_is": f"per call at {k3[kind]['shape']}",
        "idefics2_shape": k3_idefics2[kind],
        "card": card,
    } for name, kind, line, library in (
        ("fused_rms_norm", "rms", 54, "F.rms_norm"),
        ("fused_layer_norm", "ln", 88, "F.layer_norm"))]]}
    print(json.dumps({"serving_features": features}), flush=True)
    print(json.dumps({"eval": evals}), flush=True)
    print(smi.splitlines()[0], flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
