#!/usr/bin/env python3
"""Smoke run of the PyTorch port (leopard_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases, each printing its result on its own line; any failure raises and the
script exits non-zero without printing a result:
  1. environment: torch, the card, its name and power limit (nvidia-smi);
  2. build: nvcc compiles the flash-attention forward (K1) and backward (K2),
     the LayerNorm (K3b) and the int4 matmul (K4) into build/, one nvcc
     each, in parallel; the Triton RMSNorm (K3a) compiles at its first
     launch, in phase 3;
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
     without it; for phases 32-33 the decoder at [2, 8,192] with the window
     and the train batch's rows); K2 at the
     train path's shapes (the decoder's packed two-segment rows with a
     padding tail, the tower's 16 tiles at head dim 72; for phases 32-33
     the NaViT tower at phase 22's patch masks, where the padding patches'
     gradients must be exactly 0, and Mistral's [2, 8,192] rows with the
     window of 4,096, the plain version in slices); K3a/K3b at the
     train path's rows, (8192, 4096) RMSNorm and (16·676, 1152) LayerNorm,
     and K3b at the serving path's (32·676, 1152), cold L2, each with its
     share of the byte bound (K3b no slower than F.layer_norm and at least
     K3B_BOUND_SHARE_MIN of the bound, its aims printed beside);
     ops/image.py's resize, crop and normalization on the card against
     the same calls on the CPU;
     K4 at the 8B decode shapes (M = 2, M = 8 as in the slot pool's decode,
     M = 1 as in one request's decode, and M = 64 once, cold L2) against its
     plain version and the fp32 oracle, with its GB/s, tinygemm's time
     (torch._weight_int4pack_mm, bf16 scales), F.linear's on the bf16 weight
     it replaces, and host µs per call of both, per shape and per step;
     for phases 34-36: K1 and K2 at the MoE model's head dim 64 ([4, 4,096]
     causal, 32/16 heads, and K1 at phase 35's [2, 4,096] prefill), held by
     cosine >= KERNEL_COSINE_MIN too, K3a at (16,384, 2,048), and K4 at
     Mistral's head padded to 32,128 columns (M = 1, K = 4,096); for phase
     41: K1/K2 at one microbatch's row, K2 at one tower chunk, K3a at
     (4096, 4096) and K3b at (8·676, 1152); for phases 48-49: K1/K2 at the
     CLIP tower's [8, 577, 16, 64] non-causal against SDPA, K3b at
     (8·577, 1024) with eps 1e-5; K4 at every per-rank block of the 8B
     decoder's int4 leaves and head at model = 2, 4 and 8 (columns cut
     and padded, rows repacked split-half by ops/quant.py::int4_block),
     M = 1 and 8: rank 0's block against its plain version, the fp32
     oracle and tinygemm, timed; every rank's block through K4, the column
     blocks' outputs concatenated and the row blocks' partials summed in
     fp32 against the whole leaf's K4 product;
  4. serving at 8B: Engine.generate on Leopard-LLaVA-8B with seeded random
     weights, 2 requests of 16 uint8 364×364 tiles each, 16 greedy tokens;
     K1's and K3's launch counts, no K1 input copied (TMA reads every
     input in place), repeatability, TTFT, prefill tok/s and decode ms/step;
  5. the K1 path against the dense path end to end (one request);
 48. the CLIP tower (config.clip_vit_large_336: class token, pre-LN,
     quick-GELU, 23 of 24 layers, 576 tokens a 336-px tile) with phase 4's
     decoder, shared: 2 requests of 4 uint8 tiles and text (bucket 4,096),
     16 greedy tokens, twice; K1 23 + 32, K3b 1 + 2 x 23 and K3a 65 a
     forward; TTFT, tower and decode times, peak memory; the K1 path
     against the dense path (cosine >= 0.99); a seeded full-width
     transformers CLIPVisionModel through convert_clip_vision against its
     hidden_states[-2][:, 1:] (cosine >= 0.995);
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
 32. (after phase 25) Leopard-Idefics2 training at 8B widths with the text
     depth cut to 4 of 32 (the tower's 27 layers and the perceiver's 3
     kept), seeded weights, 2 rows x 8,192 slots a step from the port's
     batch builder over an 8-sample manifest (4 of phase 22's image sizes
     a row, every row one sample past the 4,096-token window): step 1's
     loss and gradients through K1 + K2 against dense attention in tower
     and decoder (one row at a time), cosine per parameter group >= 0.999,
     and the same without the window, whose text layers must fall below
     that limit; then
     3 steps of `train()` under "full" and under "selective" with the
     perceiver frozen and no weight decay: params unchanged by step 1
     (lr 0), changed by steps 2-3 but the perceiver's (bit-equal), K1 62 /
     31, K2 31, K3a 27, K3b 109 a step, each K2 launch timed in the step,
     step ms, tokens/s, peak memory;
 33. the train_leopard_idefics2 CLI from that manifest, --init-from phase
     25's checkpoint, --freeze-perceiver: 4 steps saving at step 3, the
     first loss against the train step's on the builder's first batch
     (rel 1e-4), the launches, the perceiver unchanged; a second run on the
     same directory resumes at step 3 and its loss equals the fourth;
 36. (after phase 23) phase 22's request through Engine(quantize="int4"):
     Mistral's head, 32,003 columns held padded to 32,128, reaches K4 at
     the prefill and every decode step (launches counted by N), every
     other decode matmul too; tokens in the vocab and repeated; TTFT and
     decode ms/step;
 34. (after phase 33) the MoE decoder with tied embeddings at the full width
     of the JAX package's MoE model (tools/bench_moe.py's compute-dense
     shape: hidden 2,048, ffn 5,632, 4 experts top-2, 4 layers, 32/16 heads
     of dim 64, vocab 32,768; 0.671 B parameters), seeded weights, 4 x
     4,096 seeded tokens: dropless against the capacity path at capacity
     factor 4, where nothing drops, as one layer on layer 0's weights
     (output and gradients at cosine >= 0.999) and as one whole step (losses
     within 1e-3, layer 0's routing identical; the gradient cosines and the
     tokens later layers route otherwise, through bf16 near-ties,
     reported), then 3 steps of make_train_step under dropless and
     capacity (factor 1.25) each with "full" and "selective": losses finite,
     dropless drops nothing, K1/K2/K3a launches a step as the formulas,
     moe_fraction_dropped, step ms, tokens/s, MFU(6ND_active) against the
     card's dense bf16 peak, peak memory;
 35. Engine.generate on that model (dropless): two text prompts of 3,000
     and 2,000 tokens (bucket 4,096), 16 greedy tokens, twice: tokens
     repeat, K1 and K3a launches as the formulas, the group sizes read on
     the host once a layer a forward; TTFT and decode ms/step;
 39. (after phase 9) Engine(mesh=) on a world-1 NCCL process group in this
     process and a mesh of all ones, at full 8B, bf16 and int4, on phase
     4's two requests: tokens equal phases 4 and 6, launches as there,
     TTFT and decode ms/step beside theirs;
 37. (after phase 30) phase 20's 8B-width, depth-4 train step through
     make_train_step(mesh=) against the plain step from the same weights:
     loss (rel 1e-5), gradient cosine per group (>= 0.9999), 3 steps each
     with K1 62, K2 31, K3a 17 and K3b 109 launches a step, step ms and
     peak memory of both; then once more with attn_impl="ring" at seq=1
     (one diagonal block a layer through K1 with its lse and K2), against
     the same plain step, and 2 timed ring steps;
 38. the ring's per-rank bodies for n = 2 and 4 virtual ranks in this
     process (the KV rotation reads the other shards from memory) at
     [1, 16,384, 32/8, 128] bf16 causal, zig-zag: out and dq/dk/dv against
     one K1 and one K2 call over the whole sequence (cosine >= 0.9999), K1
     and K2 launched n(2n + 1) times a pass each (one a block), ms per
     ring pass beside the one call's;
 41. (after phase 38) phase 20's 8B-width, depth-4 step through the 1F1B
     pipeline (training/pp.py's make_pp_train_step, MemoryStages(2): both
     stages in this process at a world of one, the gloo tests' code with
     the transport swapped), M = 2 microbatches of one row, the tower in
     chunks of 8 tiles, at v = 1 and v = 2 (one layer a chunk), against the
     plain make_train_step from the same seeded weights: loss (rel 1e-5),
     gradient cosine per group (>= 0.9999) and the clip norm (rel 4e-4);
     K1, K2, K3a and K3b launches a step as `pp_launches`, 3 steps each,
     step ms and peak memory beside the plain step's; then a planted fault
     (each stage handed the activation before the latest) that each of
     the three gates must fail;
 40. (after phase 21) `python -m torch.distributed.run --nproc_per_node=1
     -m leopard_tpu_torch.cli.train_leopard_llava --mesh data=1` on phase
     21's checkpoint and manifest, with a tokenizer.json that gives the
     smoke's ByteTokenizer ids (checked on the loader's first batch): the
     first loss equals phase 21's (rel 1e-4);
 44. (after phase 32, and after phase 33 for the CLI) phase 32's Idefics2
     step ("full", the perceiver frozen) through make_train_step(mesh=) at a
     world of one against the plain step from the same weights: loss (rel
     1e-5), gradient cosine per group (>= 0.9999; the frozen perceiver left
     out), clip norm (rel 1e-5), K1 62, K2 31, K3a 27, K3b 109 launches as
     the plain step's; the same with grad_accum_steps=2 (a row a
     microbatch, images and masks pre-stacked) against the plain
     accumulation; a planted fault (the patch mask dropped) that the cosine
     gate must fail; 3 mesh steps, step ms and peak memory beside phase
     32's; then `train_leopard_idefics2 --mesh data=1` under torchrun on
     phase 33's flags with a tokenizer.json that gives the smoke's
     Idefics2ByteTokenizer ids: the first loss equals phase 33's (rel 1e-4);
 42. (after phase 35) the expert-parallel dispatch (ops/moe.py::dispatch_ep)
     at the MoE model's widths on layer 0's weights, 4 x 4,096 seeded bf16
     tokens, forward and backward against the single-device dropless
     dispatch: over the world-1 NCCL group (CollectiveEP: NCCL's
     all_to_all_single on the card), dense worst case and ragged, bit for
     bit; for 2 and 4 virtual ranks in this process (MemoryEP), dense worst
     case, dense at capacity factor 1.0 (its dropped count equal to the
     host's working from the routing, the reference's gates zeroed there)
     and ragged, cosine >= 0.9999 over the output and the gradients of x,
     the router and the three banks; ms a layer forward + backward beside
     the single device's and the bytes each transport puts on the wire a
     shard; two planted faults (the reverse permutation skipped; the
     capacity from the whole batch) that the cosine and the dropped-count
     gates must fail;
 43. phase 34's MoE step ("full", dropless and capacity) through
     make_train_step(mesh=) at a world of one against the plain step from
     the same weights: loss, aux and z loss (rel 1e-5), moe_fraction_dropped
     (equal), gradient cosine per group (>= 0.9999), clip norm (rel 1e-5),
     K1 8, K2 4, K3a 17 launches a step as the plain step's, 3 steps of
     each, step ms and peak memory;
 45. (after phase 38) the ring's bodies with Mistral's window of 4,096 at
     phase 38's [1, 16,384, 32/8, 128] over n = 2 and 4 virtual ranks: the
     blocks wholly outside the window skipped by the schedule; one block of
     each band it keeps (diagonal, wholly inside, partly inside) through
     K1/K2 with its q - kv offset against their plain versions
     (KERNEL_TOL / K2_TOL on the rows that attend a key; the others 0), with
     their ms, bound over the attended pairs and SDPA with the block's band
     as a boolean mask; the whole pass against one windowed K1 and one K2
     call over the sequence (cosine >= 0.9999, finite); K1 and K2 launched
     `ring_blocks(n, window=)` times a pass (7 and 21 of 10 and 36); ms per
     pass beside the one call's;
 47. (after phase 41) the blockwise "chunked" tier (plain PyTorch, kv
     chunks of 512) on a new decoder of phase 20's widths and depth, two
     rows of 4,096 (one with a padding tail): logits against the K1
     forward, cosine per row >= 0.99, no K1 launch, both forwards' ms and
     peak memory;
 49. (after phase 47) phase 20's step with the CLIP tower in place of
     SigLIP (2 tiles a sample, weight decay 0.1), 3 steps of train(): K1
     2 x (23 + 4), K2 23 + 4 a step, step 2's loss on step 1's unchanged
     params equal to step 1's, the tower's unrun last layer moved by the
     weight decay alone; step ms, tokens/s, peak memory;
 46. (after phase 44) phase 32's Idefics2 step through the 1F1B pipeline
     (MemoryStages(2) at a world of one, M = 2 rows, the tower and the
     perceiver in chunks of 4 images, Mistral's window in both stages'
     layers) against the plain make_train_step from the same weights: loss
     (rel 1e-5), gradient cosine per group (>= 0.9999; the frozen perceiver
     left out); K1, K2, K3a and K3b launches a step as
     `idefics2_pp_launches`, 3 steps, step ms and peak memory beside phase
     32's;
 31. no JAX was imported (checked last).
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
KERNELS = ("flash_attention", "flash_attention_bwd", "layer_norm", "int4_matmul")
# K2 vs its plain version: P and dS are rounded to bf16 in the kernel, not in
# the plain version, and both round the gradients to bf16
K2_TOL = dict(rtol=2e-2, atol=2e-2)
# K3 vs its plain version: one bf16 rounding (2^-8 relative) of outputs up to
# ~4 on each side
K3_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# K3b (csrc/layer_norm.cu) at every phase-3 shape: slower than one
# F.layer_norm call, or below K3B_BOUND_SHARE_MIN of its byte bound (a
# guard against a broken launch; the CLIP tower's 4,616 rows read
# 0.49-0.50), fails the phase; its aims, 0.5 of the bound and 0.75 from
# K3B_LARGE_ROWS rows on, are printed beside each time
K3B_BOUND_SHARE_MIN = 0.35
K3B_LARGE_ROWS = 20_000
# ops/image.py on the card vs the CPU: float32 products summed in another
# order (fp32 matmuls in full precision: TF32 is off), values within ±2.2
IMAGE_TOL = dict(rtol=1e-5, atol=1e-5)
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
# phase 41: that step through the 1F1B pipeline, MemoryStages(2) at a world of
# one, M microbatches of one row each, at v = 1 and v = 2 (one layer a chunk)
PP_STAGES = 2
PP_MICROBATCHES = 2
PP_CHUNKS = (1, 2)
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
    # phase 41's microbatches: one packed train row each
    **{f"train_pp_row{i}": dict(b=1, s=TRAIN_SEQ, hq=32, hkv=8, d=128, causal=True, rows=(row,))
       for i, row in enumerate(TRAIN_ROWS)},
    # the CLIP tower (config.clip_vit_large_336: 576 patches and the class
    # token, 16 heads of 64) at phases 48-49's 8 tiles
    "clip_b8": dict(b=8, s=577, hq=16, hkv=16, d=64, causal=False, rows=None),
}
CLIP_TOKENS = 577
# phases 48-49: the CLIP tower with Leopard-LLaVA-8B's decoder. Phase 48
# serves 2 requests of 4 tiles (bucket 4,096, tile bucket 8); phase 49 runs
# phase 20's step with 2 tiles a sample (576 image tokens a tile: 8 tiles)
# and weight decay, which AdamW applies to the tower's unrun last layer
CLIP_TILES_PER_REQUEST = 4
CLIP_TEXT = (500, 1100)
CLIP_HF_TILES = 8
CLIP_TRAIN_TILES_PER_SAMPLE = 2
CLIP_WEIGHT_DECAY = 0.1
# phase 3: K4 at every per-rank block of the 8B decoder's int4 leaves at
# model = 2, 4 and 8 (parallel/sharding.py::tp_local_model's cut); (K, N)
# of the whole leaf and how the model axis cuts it
K4_TP_SIZES = (2, 4, 8)
K4_TP_M = (1, 8)
K4_TP_LEAVES = {"wq": (4096, 4096, "columns"), "wk_wv": (4096, 1024, "columns"),
                "wo": (4096, 4096, "rows"), "gate_up": (4096, 14336, "columns"),
                "down": (14336, 4096, "rows"), "lm_head": (4096, 128256, "columns")}
# K4 calls of each leaf in one 8B decode step, on every rank
K4_TP_CALLS = {"wq": 32, "wk_wv": 64, "wo": 32, "gate_up": 64, "down": 32, "lm_head": 1}


def k2_shapes(text, vis):
    """Phase 3's K2 shapes from the model's text and vision configs: the
    train phase's packed decoder rows and its tower tiles; phase 41's
    microbatches (one row each) and tower chunks (tiles / M)."""
    n_tiles = sum(len(row) for row in TRAIN_ROWS) * TRAIN_TILES_PER_SAMPLE
    dec = dict(s=TRAIN_SEQ, hq=text.num_heads, hkv=text.num_kv_heads, d=text.head_dim,
               causal=True)
    tower = dict(s=vis.tokens_per_tile, hq=vis.num_heads, hkv=vis.num_heads, d=vis.head_dim,
                 causal=False, rows=None)
    return {"decoder": dict(b=len(TRAIN_ROWS), rows=TRAIN_ROWS, **dec),
            "tower": dict(b=n_tiles, **tower),
            **{f"decoder_pp_row{i}": dict(b=1, rows=(row,), **dec)
               for i, row in enumerate(TRAIN_ROWS)},
            "tower_pp": dict(b=n_tiles // PP_MICROBATCHES, **tower)}


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
                    seg_ids=None, cosine_min=None):
    """Phase 3 for one shape: max abs error over valid rows, both times.
    `seg_ids` [B, S] (numpy): segment ids as they come, e.g. a NaViT patch
    mask's interleaved 0/1 ids, in place of `rows`' contiguous ones; then
    `rows` gives each row's count of real patches for the pair count and the
    attended SDPA. `window`: the decoder's sliding window. `cosine_min`: the
    cosine of the valid rows to the plain version must reach it too."""
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
    sums = [0.0, 0.0, 0.0]  # the valid rows' a·b, |a|², |b|² in float64
    for sl in slices:
        part, ok = got[sl[0], :, sl[1].start * g:sl[1].stop * g], valid[sl[0]]
        if not ok.any():  # rows of padding images alone (a tile bucket's)
            continue
        want = plain(sl)
        err = max(err, (part[ok].float() - want[ok].float()).abs().max().item())
        torch.testing.assert_close(part[ok].float(), want[ok].float(), **KERNEL_TOL)
        for i, term in enumerate(cosine_sums(part[ok], want[ok])):
            sums[i] += term
        del want
    cos = sums[0] / max((sums[1] * sums[2]) ** 0.5, 1e-30)
    if cosine_min is not None and cos < cosine_min:
        raise AssertionError(f"{name}: cosine {cos} to the plain version < {cosine_min}")
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
    cos_note = f", cosine {cos:.7f} (min {cosine_min})" if cosine_min is not None else ""
    print(f"kernel {name}: {shape}: max_abs_err={err:.6g} (tol {KERNEL_TOL}){cos_note} "
          f"kernel {ms:.4f} ms ({rate['tflops']:.1f} TF/s attended, "
          f"{rate['bound_fraction']:.3f} of the bound), plain {plain_ms:.4f} ms"
          f"{f' (one pass over {len(slices)} slices)' if len(slices) > 1 else ''}, sdpa "
          f"{library_ms:.4f} ms (unsegmented), {attended_ms:.4f} ms (attended rows only"
          f"{', the window not skipped' if window else ''}){lib_masked}, "
          f"bound {bound_ms:.4f} ms; tile ranges of a lone call {lone_ranges_ms:.4f} ms "
          f"(host) [{card}]", flush=True)
    return {"shape": f"{name}: {shape}", "max_abs_err": err, "cosine": cos, "ms": ms,
            "plain_ms": plain_ms, "plain_slices": len(slices),
            "library_ms": library_ms, "library_attended_ms": attended_ms, **masked,
            "tile_ranges_ms": lone_ranges_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **rate}


# the plain version's fp32 scores [rows, heads, S, S] in one call: a call
# above PLAIN_WHOLE_MAX runs in slices of rows and kv heads of at most
# PLAIN_SLICE_MAX (its softmax holds a few such tensors at once)
PLAIN_WHOLE_MAX = 12 * 2**30
PLAIN_SLICE_MAX = 4 * 2**30
PLAIN_SLICED_REPS = 3   # timed passes over the slices (2.4 s each at [8, 16,384])


def plain_slices(b, hq, hkv, s, whole_max=PLAIN_WHOLE_MAX):
    """(rows, kv heads) slices of one plain-version call, the whole call
    where its scores fit `whole_max`."""
    whole = [(slice(0, b), slice(0, hkv))]
    per_head = hq // hkv * s * s * 4
    if b * hkv * per_head <= whole_max:
        return whole
    heads = max(1, min(hkv, PLAIN_SLICE_MAX // per_head))
    while hkv % heads:
        heads -= 1
    rows = max(1, min(b, PLAIN_SLICE_MAX // (per_head * heads)))
    while b % rows:
        rows -= 1
    return [(slice(r, r + rows), slice(h, h + heads))
            for r in range(0, b, rows) for h in range(0, hkv, heads)]


def cosine_sums(a, b):
    """(a·b, |a|², |b|²) in float64, for a cosine summed over slices."""
    a, b = a.double(), b.double()
    return (a * b).sum().item(), a.square().sum().item(), b.square().sum().item()


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


def flash_bwd_vs_plain(name, b, s, hq, hkv, d, causal, rows, device, card, window=None,
                       seg_ids=None, cosine_min=None):
    """Phase 3, K2 at one shape: dq/dk/dv max abs error against the plain
    version on the same inputs (out and lse from K1), times, and the bound.
    `rows`: each row's packed sample lengths, or None (no segments).
    `seg_ids` [B, S] (numpy): segment ids as they come (a NaViT patch mask's
    interleaved 0/1 ids), with `rows` each image's count of real patches;
    then the gradients of padding patches must be exactly 0 from K2 (they
    attend nothing and nothing attends them) and finite from the plain
    version. `window`: the decoder's sliding window. The plain version runs
    in slices of rows and kv heads where its fp32 scores pass
    PLAIN_SLICE_MAX (it holds several such tensors at once). `cosine_min`:
    each of dq, dk, dv must reach it in cosine to the plain version too."""
    import torch

    from leopard_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, seg = attn_inputs(b, s, hq, hkv, d, None if seg_ids is not None else rows,
                                     device)
    if seg_ids is not None:
        seg = torch.from_numpy(np.ascontiguousarray(seg_ids, np.int32)).to(device)
        dout = dout * (seg != 0)[:, :, None, None].to(dout.dtype)
    kw = dict(causal=causal, sliding_window=window)
    out, lse = fa._launch(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, with_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    slices = plain_slices(b, hq, hkv, s, whole_max=PLAIN_SLICE_MAX)
    g = hq // hkv

    def plain(sl):
        rows_, heads = sl
        qh = slice(heads.start * g, heads.stop * g)
        sg = None if seg is None else seg[rows_]
        return fa.flash_attention_bwd_ref(
            q[rows_, :, qh], k[rows_, :, heads], v[rows_, :, heads], sg, sg,
            out[rows_, :, qh], lse[rows_, qh], dout[rows_, :, qh], **kw)

    torch.cuda.synchronize()
    errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    sums = {gname: [0.0, 0.0, 0.0] for gname in errs}
    for sl in slices:
        rows_, heads = sl
        qh = slice(heads.start * g, heads.stop * g)
        for gname, a, w in zip(errs, (got[0][rows_, :, qh], got[1][rows_, :, heads],
                                      got[2][rows_, :, heads]), plain(sl)):
            if not (torch.isfinite(a).all() and torch.isfinite(w).all()):
                raise AssertionError(f"{name}: {gname} has non-finite values")
            errs[gname] = max(errs[gname], (a.float() - w.float()).abs().max().item())
            torch.testing.assert_close(a.float(), w.float(), **K2_TOL, msg=f"{name} {gname}")
            for i, term in enumerate(cosine_sums(a, w)):
                sums[gname][i] += term
    cosines = {gname: dot / max((na * nb) ** 0.5, 1e-30) for gname, (dot, na, nb) in sums.items()}
    if cosine_min is not None and min(cosines.values()) < cosine_min:
        raise AssertionError(f"{name}: K2 cosines {cosines} to the plain version < {cosine_min}")
    padding = None
    if seg_ids is not None:  # padding patches: exactly 0 from K2
        pad = seg == 0
        padding = {gname: t[pad].abs().max().item() if pad.any() else 0.0
                   for gname, t in zip(errs, got)}
        if any(padding.values()):
            raise AssertionError(f"{name}: K2 gives padding patches gradients {padding}")
    again = fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{name}: K2 does not repeat bit for bit")
    del got, again
    ranges = fa.tile_ranges(seg, seg, sq=s, skv=s, causal=causal, window=window, device=device)
    ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout,
                                                ranges=ranges, **kw))  # as a train step
    if len(slices) == 1:
        plain_ms = cuda_ms(lambda: plain(slices[0]))
    else:
        def every_slice():
            for sl in slices:
                plain(sl)

        plain_ms = cuda_ms(every_slice, reps=PLAIN_SLICED_REPS)
    # reads q, k, v, out, dout, lse and the segments; writes dq, dk, dv
    n_bytes = nbytes(q, k, v, out, dout, lse, seg, seg, q, k, v)
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()
    segs = rows if rows is not None else [[s]] * b
    library_ms = sdpa_ms([s] * b, hq, hkv, d, causal, device, backward=True)
    attended_ms = sdpa_ms([n for row in segs for n in row if n > 0], hq, hkv, d, causal, device,
                          backward=True)
    pairs = attended_pairs(segs, causal, window)
    bound_ms, bound_by = attn_bound_ms(pairs, hq, d, 5, n_bytes)
    rate = achieved(pairs, hq, d, 5, ms, bound_ms)
    shape = (f"B={b} S={s} heads={hq}/{hkv} D={d} {'causal' if causal else 'non-causal'}"
             + (f" window={window}" if window else "")
             + (" NaViT patch-mask segments," if seg_ids is not None else "")
             + (f" rows={[list(r) for r in rows]}" if rows else ""))
    print(f"kernel flash_attention_bwd {name}: {shape}: max_abs_err "
          + ", ".join(f"{k_}={e:.6g}" for k_, e in errs.items())
          + f" (tol {K2_TOL})"
          + (", cosine " + ", ".join(f"{k_}={c:.7f}" for k_, c in cosines.items())
             + f" (min {cosine_min})" if cosine_min is not None else "")
          + ", repeats bit for bit"
          + (f", padding patches' gradients {padding}" if padding is not None else "")
          + f"; kernel {ms:.4f} ms ({rate['tflops']:.1f} "
          f"TF/s attended, {rate['bound_fraction']:.3f} of the bound), plain {plain_ms:.4f} ms"
          f"{f' (one pass over {len(slices)} slices)' if len(slices) > 1 else ''}, "
          f"sdpa backward {library_ms:.4f} ms (unsegmented), {attended_ms:.4f} ms (attended "
          f"segments only{', the window not skipped' if window else ''}), bound "
          f"{bound_ms:.4f} ms [{card}]", flush=True)
    return {"shape": f"{name}: {shape}", "max_abs_err": max(errs.values()), "errs": errs,
            "cosines": cosines, "padding_grads": padding, "plain_slices": len(slices),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_attended_ms": attended_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            **rate}


def k3b_shapes():
    """K3b's phase-3 shapes, {name: (rows, width, eps)}, bf16: the train
    step's tower (16 tiles), the serving path's 2 requests of 16 tiles in
    one tower call (phase 4), the Idefics2 encode's 8 images of 4,900
    patches (phase 22), one pipeline tower chunk of tiles / M (phase 41)
    and the CLIP tower's 8 tiles of 577 tokens (phases 48-49)."""
    from leopard_tpu_torch.config import leopard_llava_8b

    vis, navit = leopard_llava_8b().vision, idefics2_config().vision
    n_tiles = sum(len(row) for row in TRAIN_ROWS) * TRAIN_TILES_PER_SAMPLE
    tile, eps = vis.tokens_per_tile, vis.layer_norm_eps
    return {
        "train_tower_16_tiles": (n_tiles * tile, vis.hidden_size, eps),
        "serve_2x16_tiles": (2 * TILES_PER_REQUEST * tile, vis.hidden_size, eps),
        "navit_8_images": (8 * (navit.image_size // navit.patch_size) ** 2, navit.hidden_size,
                           navit.layer_norm_eps),
        "pipeline_tower_chunk": (n_tiles // PP_MICROBATCHES * tile, vis.hidden_size, eps),
        "clip_tower_8_tiles": (K1_SHAPES["clip_b8"]["b"] * CLIP_TOKENS, 1024, 1e-5),
    }


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
    share = bound_ms / ms
    name = "fused_rms_norm" if kind == "rms" else "fused_layer_norm"
    aim = (0.75 if rows >= K3B_LARGE_ROWS else 0.5) if kind == "ln" else None
    print(f"kernel {name}: x [{rows}, {h}] bf16 eps {eps}: max_abs_err={err:.6g} (tol {K3_TOL}) "
          f"kernel {ms:.4f} ms ({n_bytes / (ms * 1e-3) / 1e9:.1f} GB/s, {share:.3f} of the "
          f"bound"
          + (f"; aim {aim}: {'met' if share >= aim else 'missed'}" if aim else "")
          + f"), plain {plain_ms:.4f} ms, torch {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"[{card}]", flush=True)
    if kind == "ln" and (share < K3B_BOUND_SHARE_MIN or ms > library_ms):
        raise AssertionError(f"K3b at [{rows}, {h}]: {ms:.4f} ms, {share:.3f} of its byte bound "
                             f"(least {K3B_BOUND_SHARE_MIN}), F.layer_norm {library_ms:.4f} ms")
    return {"shape": f"x [{rows}, {h}] bf16", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_share": share}


def image_ops_vs_cpu(device) -> dict:
    """Phase 3: ops/image.py's functions on CUDA tensors against the same
    calls on the CPU (a uint8 batch of 4 tiles of 448 × 336, resized to
    364 × 364 by every method family, center-cropped and normalized):
    largest difference of each."""
    import numpy as np
    import torch

    from leopard_tpu_torch.ops import image

    rng = np.random.default_rng(SEED)
    tiles = torch.from_numpy(rng.integers(0, 256, (4, 3, 448, 336), dtype=np.uint8))
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    calls = {
        **{f"preprocess_on_device {m}": lambda t, m=m: image.preprocess_on_device(
            t, (364, 364), mean, std, method=m)
           for m in ("nearest", "bilinear", "bicubic", "lanczos3", "lanczos5")},
        "resize_images bicubic up": lambda t: image.resize_images(t, (672, 504)),
        "center_crop": lambda t: image.center_crop(t, (336, 336)),
        "normalize_images": lambda t: image.normalize_images(
            t.float() / 255, torch.tensor(mean), torch.tensor(std)),
    }
    errs = {}
    for name, fn in calls.items():
        got, want = fn(tiles.to(device)), fn(tiles)
        torch.cuda.synchronize()
        if got.device.type != device.type or got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"ops/image.py {name}: {got.device} {tuple(got.shape)} "
                                 f"{got.dtype}, CPU {tuple(want.shape)} {want.dtype}")
        torch.testing.assert_close(got.cpu(), want, **IMAGE_TOL)
        errs[name] = (got.cpu().float() - want.float()).abs().max().item()
    print("ops/image.py on the card vs the CPU: max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {IMAGE_TOL})",
          flush=True)
    return errs


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


def int4_vs_plain(name, m, k, n, device, card, flush, weight=None, host=True):
    """Phase 3 for one K4 shape: the largest error against the plain version
    and against the fp32 oracle; kernel, plain, tinygemm and dense bf16
    (F.linear) times with cold L2; GB/s over the bytes the call must move;
    with `host`, host µs per call of the decoder's int4 matmul (quant.matmul
    into K4) and of F.linear. `weight`: a QuantizedWeight to take in place
    of a seeded random one of [K, N] (its dense twin its dequantized
    weight in bf16)."""
    import torch
    import torch.nn.functional as F

    from leopard_tpu_torch.models.params import QuantizedWeight
    from leopard_tpu_torch.ops import quant
    from leopard_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_ref

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((m, k), generator=g, device=device, dtype=torch.bfloat16)
    if weight is None:
        w = torch.randn((n, k), generator=g, device=device, dtype=torch.bfloat16) * k**-0.5
        q = quant.quantize_int4(w)
    else:
        q = {"q4": weight.q4, "s": weight.s}
        w = quant._unpack_int4(weight.q4, weight.s).to(torch.bfloat16).t().contiguous()
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
    k4_host = dense_host = None
    if host:
        x3, qw = x[:, None], QuantizedWeight(q)
        k4_host = host_us(lambda: quant.matmul(x3, qw))
        dense_host = host_us(lambda: F.linear(x3, w))
    n_bytes = k // 2 * n + k // 128 * n * 4 + m * k * 2 + m * n * 4
    gbs = n_bytes / (ms * 1e-3) / 1e9
    lib_note = (f"tinygemm {library_ms:.4f} ms (|diff| {lib_err:.3g})" if lib_fn is not None
                else f"tinygemm not available ({lib_error})")
    host_note = (f"; host us per call: quant.matmul (K4) {k4_host:.2f}, F.linear "
                 f"{dense_host:.2f}" if host else "")
    print(f"kernel int4_matmul {name}: M={m} K={k} N={n}: max_abs_err={err:.6g} (tol {K4_TOL}), "
          f"vs fp32 oracle {oracle_err:.3g} (tol {K4_ORACLE_TOL}); kernel {ms:.4f} ms "
          f"({gbs:.1f} GB/s of {n_bytes} bytes, bound {n_bytes / PEAK_BYTES_S * 1e3:.4f} ms), "
          f"plain {plain_ms:.4f} ms, {lib_note}, dense bf16 F.linear {dense_ms:.4f} ms"
          f"{host_note} [{card}]", flush=True)
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
    tower_layers, tower_norms = tower_run(cfg.vision)
    expected = tower_layers + cfg.text.num_layers
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
                "fused_layer_norm": tower_norms}
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
          f"(K1: {tower_layers} vision + {cfg.text.num_layers} decoder prefill{k4_note}; "
          f"K3a: {2 * cfg.text.num_layers + 1} x (1 + {steps}) forwards; "
          f"K3b: {tower_norms}), "
          f"tokens{' identical' if runs > 1 else ''}: {[t.tolist() for t in results[0].tokens]}",
          flush=True)
    timings = {"launches": launches, "decode_steps": steps, "copies": copies,
               "tokens": [t.tolist() for t in results[0].tokens]}
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


def tower_run(v):
    """The layers a tower config runs (all but the last -1 - feature_layer)
    and its K3b launches in one forward: two a layer, and the pre-LN and the
    sequence post-LN where the config has them (SigLIP: 27 and 55; the CLIP
    tower at feature layer -2: 23 and 47)."""
    layers = v.num_layers if v.feature_layer == -1 else v.num_layers + 1 + v.feature_layer
    return layers, 2 * layers + int(v.pre_ln) + int(v.post_ln_sequence)


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
    if nk != tower_run(cfg.vision)[0] + cfg.text.num_layers or nd != 0:
        raise AssertionError(f"kernel path launched {nk}, dense path {nd} times")
    if not (torch.isfinite(lk).all() and torch.isfinite(ld).all()):
        raise AssertionError("non-finite logits")
    cos = torch.nn.functional.cosine_similarity(lk, ld, dim=0).item()
    same_argmax = int(lk.argmax()) == int(ld.argmax())
    print(f"end to end, kernel vs dense (1 request, {len(prompt)} tokens, "
          f"{len(tiles)} tiles): cosine {cos:.6f} (min {COSINE_MIN}), "
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
    """Tokens/s and the host ms a segment step: the run's wall time less
    staging and refills, over the segments' steps."""
    tokens = sum(r.max_new_tokens for r in reqs)
    st = cont.stats
    steps = cont.segment_steps * st["segments"]
    return {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "segment_step_ms": (wall - st["stage_s"] - st["refill_s"]) / steps * 1e3,
            "stats": dict(cont.stats)}


def continuous_phase(engine, cfg, launches, card):
    """Phase 16: the slot pool in bf16 over a queue of image and text
    requests; launch counts, budgets, the image requests' first tokens and
    the staged prefills' logits; then throughput and the same queue
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
          f"{rec['segment_step_ms']:.2f} ms a segment step; static "
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
          f"{rec['tokens_per_s']:.1f} tok/s, {rec['segment_step_ms']:.2f} ms a segment step "
          f"[{card}]", flush=True)
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
    """The K1 shapes phase 3 holds: ("tower", tiles), ("clip", tiles),
    ("navit", images, patches) and ("decoder", rows, bucket, window). `shapes`: phase 3's
    dict of every K1 entry, K1_SHAPES with the Idefics2 ones."""
    shapes = K1_SHAPES if shapes is None else shapes
    return ({("clip" if kw["s"] == CLIP_TOKENS else "tower", kw["b"]) for kw in shapes.values()
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
    rec = {"argv": argv, "losses": losses, "vlm_loss": ref_loss, "loss_rel_diff": rel,
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


def train_batch(cfg, device, tiles_per_sample=TRAIN_TILES_PER_SAMPLE):
    """TRAIN_ROWS packed as the data pipeline packs them: each sample is BOS,
    its tiles' image tokens, then text; segment ids 1, 2 and 0 for the
    padding tail; positions restart at 0 in each segment; loss weight 1 on
    text tokens, 0 on image tokens and padding. Tiles in order of
    appearance, random pixels from the seed."""
    import torch

    rng = np.random.RandomState(SEED)
    n_img = tiles_per_sample * cfg.anyres.tokens_per_tile
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
    n_tiles = sum(len(row) for row in TRAIN_ROWS) * tiles_per_sample
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
    for group in ("projector", "perceiver"):
        if name.startswith(group + "."):
            return group
    return {"text.embed_tokens": "embed", "text.lm_head": "head",
            "text.final_norm": "text final norm"}.get(name, "tower patch/pos/post-LN")


def group_cosines(a_grads, b_grads):
    """Cosine of two gradient sets per parameter group, in float64 on the
    device of `a_grads` (each of `b_grads` moved there in turn)."""
    sums = {}
    for n, a in a_grads.items():
        a, b = a.double(), b_grads[n].to(a.device).double()
        acc = sums.setdefault(param_group(n), [0.0, 0.0, 0.0])
        acc[0] += float((a * b).sum())
        acc[1] += float(a.square().sum())
        acc[2] += float(b.square().sum())
    return {g: dot / max((na * nb) ** 0.5, 1e-30) for g, (dot, na, nb) in sums.items()}


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
    cosines = group_cosines(grads["kernel"], grads["dense"])
    del grads, dense
    print(f"train, K1 + K2 vs dense gradients (one step, {cfg.text.num_layers} text layers): "
          f"loss {losses['kernel']:.6f} vs {losses['dense']:.6f}; cosine per group "
          + ", ".join(f"{g}: {c:.6f}" for g, c in cosines.items())
          + f" (min {COSINE_MIN}); K1/K2 launches {launches['kernel']} [{card}]", flush=True)
    if not all(np.isfinite(list(losses.values()))) or min(cosines.values()) < COSINE_MIN:
        raise AssertionError(f"gradients disagree: {cosines}, losses {losses}")
    return {"cosines": cosines, "losses": losses}


def train_phase(model, cfg, batch, card, weight_decay=0.0, label="train"):
    """Phase 20, then: TRAIN_STEPS steps of train() through the user's entry
    points, each step timed and its kernel launches counted; step 2's loss,
    on step 1's unchanged params (lr 0), must equal step 1's. A tower
    layer the config does not run (the CLIP tower's last) gets no gradient:
    its matrices must move by AdamW's weight decay alone and its vectors
    not at all (phase 49)."""
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
    from leopard_tpu_torch.training import trainer
    from leopard_tpu_torch.training.loop import train

    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "fused_rms_norm": fused_rms_norm, "fused_layer_norm": fused_layer_norm}
    lt = cfg.text.num_layers
    lv, tower_norms = tower_run(cfg.vision)
    v = cfg.vision
    # full recompute runs each layer's forward twice (K1, K3) and its
    # backward once (K2); the final norm, the tower's pre-LN and post-LN
    # run once
    want = {"flash_attention": 2 * (lt + lv), "flash_attention_bwd": lt + lv,
            "fused_rms_norm": 2 * 2 * lt + 1,
            "fused_layer_norm": 2 * 2 * lv + int(v.pre_ln) + int(v.post_ln_sequence)}
    tcfg = TrainConfig(
        seq_len=TRAIN_SEQ, global_batch_size=len(TRAIN_ROWS), train_steps=TRAIN_STEPS,
        log_interval=1, eval_interval=0, save_interval=0, remat="full", loss_chunk=1024,
        optimizer=OptimizerConfig(lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0,
                                  weight_decay=weight_decay))
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
        print(f"{label} step {i}: loss {r['loss']:.6f}, grad norm {r['grad_norm']:.6f}, "
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
    repeat = abs(records[1]["loss"] - records[0]["loss"]) / abs(records[0]["loss"])
    if repeat > 1e-6:
        raise AssertionError(f"{label}: step 2's loss on step 1's params differs by rel {repeat}")
    unrun = (unrun_layer_decay(snaps, state, tcfg.optimizer, lv) if lv < v.num_layers
             else None)
    step_ms = statistics.mean(r["ms"] for r in records[1:])
    tokens = len(TRAIN_ROWS) * TRAIN_SEQ
    print(f"{label}: {TRAIN_STEPS} steps of train(), step 1 left the params unchanged (lr 0), "
          f"step 2's loss on them equal to step 1's (rel {repeat:.3g}); "
          f"steps 2-3 changed tensors per group (changed/total): "
          + ", ".join(f"{g}: {c}/{t}" for g, (c, t) in moved.items())
          + f"; K1/K2 input copies {copies}; launches per step {want} (K1 2 x ({lt} + {lv}) "
          f"layers, K2 {lt} + {lv}, K3a 2 x 2 x {lt} + 1, K3b 2 x 2 x {lv} "
          f"+ {want['fused_layer_norm'] - 4 * lv}), in all {totals}; step "
          f"{step_ms:.1f} ms (mean of steps 2-{TRAIN_STEPS}), {tokens / step_ms * 1e3:.1f} "
          f"tokens/s, peak device memory {peak_gib:.2f} GiB [{card}]", flush=True)
    return {"steps": records, "launches": totals, "launches_per_step": want, "copies": copies,
            "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_memory_gib": peak_gib, "params_moved": moved, "loss_repeat_rel": repeat,
            "unrun_layers": unrun}


def unrun_layer_decay(snaps, state, opt, run):
    """The tower layers past `run` never run, so their gradient is 0 and
    AdamW's moments stay 0: each of steps 2.. moves a matrix by the decay
    alone, w ← w − lr·wd·w, and leaves a vector. Held on the sampled
    elements against that update applied to step 1's snapshot in fp32."""
    import torch

    from leopard_tpu_torch.training.trainer import decay_mask, lr_schedule

    # the update counts of steps 2.. (step 1's is 0)
    lrs = [lr_schedule(opt)(c) for c in range(1, state.opt_state.count)]
    out = {}
    for n, before in snaps[1].items():
        parts = n.split(".")
        if parts[:2] != ["vision", "layers"] or int(parts[2]) < run:
            continue
        got, want = snaps[-1][n], before.clone()
        matrix = decay_mask(n, state.params[n]) and opt.weight_decay > 0
        for lr in lrs:
            if matrix:
                want = want + (want * opt.weight_decay) * -lr
        if not matrix:
            if not torch.equal(got, before):
                raise AssertionError(f"unrun layer: vector {n} moved")
            continue
        step, want_step = (got - before).double(), (want - before).double()
        cos = float(step @ want_step / (step.norm() * want_step.norm()).clamp(min=1e-300))
        ratio = float(step.norm() / want_step.norm().clamp(min=1e-300))
        out[n] = {"cosine": cos, "norm_ratio": ratio, "rel_change": float(
            step.norm() / before.double().norm())}
        if cos < 0.999 or abs(ratio - 1) > 0.01:
            raise AssertionError(f"unrun layer: {n} moved by other than its weight decay: "
                                 f"cosine {cos}, norm ratio {ratio}")
    if not out:
        raise AssertionError("unrun layer: no matrix to hold against its weight decay")
    print(f"unrun tower layers (>= {run}): {len(out)} matrices moved by AdamW's weight decay "
          f"alone (lr {lrs}, wd {opt.weight_decay}; cosine to the decay-only update min "
          f"{min(r['cosine'] for r in out.values()):.6f}, norm ratio "
          f"{[round(r['norm_ratio'], 6) for r in out.values()][:4]}...), vectors unchanged",
          flush=True)
    return out


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


# phases 32-33: Leopard-Idefics2 training at 8B widths with the text depth
# cut to 4 of 32 (as phase 20: the train state, ~18 B a parameter, does not
# fit one card; the tower keeps its 27 layers and the perceiver its 3). Each
# step takes 2 rows x 8,192 slots from the port's batch builder over an
# 8-sample manifest: a sample is one row of 4 of phase 22's image sizes and a
# two-turn chat whose answer takes the row past the 4,096-token window;
# samples alternate between the first four sizes and the last four, so that
# every batch holds phase 22's eight images and its NaViT masks.
IDEFICS2_TRAIN_SEQ = 8192
IDEFICS2_TRAIN_SAMPLES = 8
IDEFICS2_TRAIN_ANSWER = (4600, 7200)   # characters: rows of ~4,950-7,550 tokens
IDEFICS2_TRAIN_STEPS = 3
IDEFICS2_REMAT = ("full", "selective")
# step 1's gradients through K1 + K2 against dense, per group: the sound
# path reads 0.999995-0.999996 and the run without the window 0.9915-0.997
# (text layers 0.994; this script on an NVIDIA H100 80GB HBM3 at 700 W), which
# COSINE_MIN (0.99) would let pass; this limit fails it
IDEFICS2_GRAD_COSINE_MIN = 0.999


class Idefics2ByteTokenizer(MistralByteTokenizer):
    """MistralByteTokenizer with Idefics2's <end_of_utterance> (32002), which
    opens and closes the assistant turns that carry the loss."""

    SPECIALS = {"<end_of_utterance>": 32002}


def write_idefics2_manifest(directory):
    """IDEFICS2_TRAIN_SAMPLES rows {text, images}: seeded noise PNGs of
    phase 22's sizes, four a row, and `User:<image>x4 question<eou>\\n
    Assistant: answer<eou>\\n`."""
    rng = np.random.RandomState(SEED + 32)
    directory.mkdir(parents=True)
    rows = []
    for i in range(IDEFICS2_TRAIN_SAMPLES):
        names = []
        for j, (w, h) in enumerate(IDEFICS2_IMAGES[4 * (i % 2):4 * (i % 2) + 4]):
            names.append(f"{i}_{j}.png")
            noise_png_file(directory / names[-1], rng, w, h)
        answer = random_text(rng, int(rng.randint(*IDEFICS2_TRAIN_ANSWER)))
        rows.append({"text": "User:" + "<image>" * len(names) + random_text(rng, 60)
                     + "<end_of_utterance>\nAssistant: " + answer + "<end_of_utterance>\n",
                     "images": names})
    path = directory / "data.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return path, rows


def idefics2_train_batches(cfg, rows, folder, steps=IDEFICS2_TRAIN_STEPS, start=0):
    """The batch builder's first `steps` batches (numpy), as the CLI draws
    them."""
    from leopard_tpu_torch.data.idefics2_batches import idefics2_batches

    return list(itertools.islice(idefics2_batches(
        rows, Idefics2ByteTokenizer(), cfg, 2, IDEFICS2_TRAIN_SEQ, str(folder), start=start),
        steps))


def row_lengths(batch):
    return [[int(n)] for n in (batch["segment_ids"] != 0).sum(1)]


def idefics2_train_shapes(cfg, batches):
    """Phase 3's K1 and K2 entries of phases 32-33: the decoder at
    [2, 8,192] with the window (every batch's rows), the tower's K2 at the
    NaViT masks (K1 there is phase 22's `navit_b8`)."""
    t, v = cfg.text, cfg.vision
    first = batches[0]
    if any(b["patch_mask"].shape != first["patch_mask"].shape
           or not np.array_equal(b["patch_mask"], first["patch_mask"]) for b in batches):
        raise AssertionError("the train batches' patch masks differ")
    mask = first["patch_mask"]
    n = mask.shape[0]
    dec = dict(b=2, s=IDEFICS2_TRAIN_SEQ, hq=t.num_heads, hkv=t.num_kv_heads, d=t.head_dim,
               causal=True, rows=row_lengths(first), window=t.sliding_window)
    navit = dict(b=n, s=mask[0].size, hq=v.num_heads, hkv=v.num_heads, d=v.head_dim,
                 causal=False, rows=[[r * c] for r, c in grids_of(mask)],
                 seg_ids=mask.reshape(n, -1).astype(np.int32))
    return ({f"mistral_train_{IDEFICS2_TRAIN_SEQ}": dec},
            {f"navit_b{n}": navit, f"mistral_train_{IDEFICS2_TRAIN_SEQ}": dec})


def k2_ran(batch, cfg):
    """The K2 shapes of one Idefics2 train step, which are also its K1
    shapes (keyed as `k1_held`)."""
    mask = batch["patch_mask"]
    return {("navit", mask.shape[0], mask[0].size),
            ("decoder", *batch["tokens"].shape, cfg.text.sliding_window)}


def k2_held(shapes):
    """The K2 shapes phase 3 holds, keyed as k2_ran."""
    return ({("navit", kw["b"], kw["s"]) for kw in shapes.values()
             if kw.get("seg_ids") is not None}
            | {("decoder", kw["b"], kw["s"], kw.get("window")) for kw in shapes.values()
               if kw["causal"]})


def to_device(batch, device):
    import torch

    return {k: None if v is None else torch.from_numpy(v).to(device) for k, v in batch.items()}


def idefics2_grads_vs_dense(model, cfg, batch, card):
    """Phase 32, first: step 1's loss and gradients through K1 + K2 against
    dense attention in tower and decoder on the same weights (one row at a
    time: the dense decoder's fp32 scores of two 8,192-token rows would not
    fit beside the model), cosine per parameter group at least
    IDEFICS2_GRAD_COSINE_MIN; then the kernel path without the window,
    whose text layers must fall below it."""
    import torch

    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.training.trainer import vlm_loss

    def twin(c):
        m = LeopardVLM(c, device="meta")
        m.load_state_dict(model.state_dict(), assign=True)  # shares the weights
        return m

    def grads_of(m):
        out = {n: p.grad for n, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
        return out

    dense_cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="dense"),
        text=dataclasses.replace(cfg.text, attn_impl="dense"))
    dense = twin(dense_cfg)
    tokens = batch["tokens"]
    weights = (batch["loss_weights"][:, 1:] * (tokens[:, 1:] != cfg.image_token_id)
               * (batch["segment_ids"][:, 1:] != 0))
    total_w = float(weights.sum())
    per_row = (tokens == cfg.image_token_id).sum(1) // cfg.perceiver.num_latents
    first = np.r_[0, np.cumsum(per_row)]
    dense_loss = 0.0
    for r in range(tokens.shape[0]):
        row = {k: batch[k][r:r + 1] for k in ("tokens", "segment_ids", "loss_weights")}
        row["images"] = batch["images"][first[r]:first[r + 1]]
        row["patch_mask"] = batch["patch_mask"][first[r]:first[r + 1]]
        loss, aux = vlm_loss(dense, dense_cfg, to_device(row, model.text.lm_head.device),
                             remat="full")
        (loss * (aux["tokens_in_loss"] / total_w)).backward()
        dense_loss += loss.item() * aux["tokens_in_loss"].item() / total_w
        del loss, aux
    want = grads_of(dense)
    del dense
    torch.cuda.empty_cache()
    dev = to_device(batch, model.text.lm_head.device)
    rec = {"dense_loss": dense_loss}
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    for name, c in (("kernel", cfg), ("no_window", dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, sliding_window=None)))):
        m = model if name == "kernel" else twin(c)
        flash_attention.launches = flash_attention_bwd.launches = 0
        loss, _ = vlm_loss(m, c, dev, remat="full")
        loss.backward()
        torch.cuda.synchronize()
        launches = (flash_attention.launches, flash_attention_bwd.launches)
        if launches != (2 * (lt + lv), lt + lv):
            raise AssertionError(f"Idefics2 train, {name}: K1/K2 launches {launches}, "
                                 f"expected {(2 * (lt + lv), lt + lv)}")
        rec[name] = {"loss": loss.item(), "cosines": group_cosines(grads_of(m), want)}
        del loss, m
        torch.cuda.empty_cache()
    del want
    kc, nc = rec["kernel"]["cosines"], rec["no_window"]["cosines"]
    print(f"Idefics2 train, K1 + K2 vs dense gradients (step 1, {lt} text layers, the dense "
          f"path a row at a time): loss {rec['kernel']['loss']:.6f} vs {dense_loss:.6f}; "
          "cosine per group " + ", ".join(f"{g}: {c:.6f}" for g, c in kc.items())
          + f" (min {IDEFICS2_GRAD_COSINE_MIN}); without the window, which must fall below "
          f"it in the text layers: loss {rec['no_window']['loss']:.6f}, "
          + ", ".join(f"{g}: {c:.6f}" for g, c in nc.items()) + f" [{card}]", flush=True)
    if (not np.isfinite([rec["kernel"]["loss"], dense_loss]).all()
            or min(kc.values()) < IDEFICS2_GRAD_COSINE_MIN):
        raise AssertionError(f"Idefics2 train: kernel gradients disagree with dense: {rec}")
    if abs(rec["kernel"]["loss"] - dense_loss) > 1e-2 * abs(dense_loss):
        raise AssertionError(f"Idefics2 train: loss {rec['kernel']['loss']} vs dense "
                             f"{dense_loss}")
    if nc["text layers"] >= IDEFICS2_GRAD_COSINE_MIN:
        raise AssertionError("Idefics2 train: the run without the window passes the text "
                             f"layers' limit ({nc['text layers']}): the check cannot see "
                             "the window")
    return rec


def idefics2_train_phase(model, cfg, batches, card, k1_checked, k2_checked):
    """Phase 32, then: IDEFICS2_TRAIN_STEPS steps of train() under each of
    IDEFICS2_REMAT, the perceiver frozen and no weight decay, a warmup from
    0: params unchanged by step 1, changed by steps 2-3 but the perceiver's,
    bit-equal throughout; K1, K2, K3 launches of every step against the
    formulas, each K2 launch timed by CUDA events; step ms, tokens/s, peak
    memory."""
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.ops import flash_attention as fa
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
    from leopard_tpu_torch.training import trainer
    from leopard_tpu_torch.training.loop import train

    for b in batches:  # K1 and K2 run at the same shapes
        held("Idefics2 train", "K1", k2_ran(b, cfg), k1_checked)
        held("Idefics2 train", "K2", k2_ran(b, cfg), k2_checked)
    counters = {"flash_attention": fa.flash_attention, "flash_attention_bwd":
                fa.flash_attention_bwd, "fused_rms_norm": fused_rms_norm,
                "fused_layer_norm": fused_layer_norm}
    lt, lv, lp = cfg.text.num_layers, cfg.vision.num_layers, cfg.perceiver.num_layers
    device = model.text.lm_head.device
    dev_batches = [to_device(b, device) for b in batches]
    real_bwd = fa._launch_bwd
    k2_events = []

    def timed_bwd(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_bwd(*a, **kw)
        end.record()
        k2_events.append((start, end))
        return out

    recs = {}
    fa._launch_bwd = timed_bwd
    try:
        for policy in IDEFICS2_REMAT:
            # "full" runs each tower and decoder layer's forward twice (K1,
            # K3) and its backward once (K2); "selective" saves K1's output,
            # so only the norms run again; the perceiver runs once
            want = {"flash_attention": (2 if policy == "full" else 1) * (lt + lv),
                    "flash_attention_bwd": lt + lv,
                    "fused_rms_norm": 2 * 2 * lt + 1 + 3 * lp + 1,
                    "fused_layer_norm": 2 * 2 * lv + 1}
            tcfg = TrainConfig(
                seq_len=IDEFICS2_TRAIN_SEQ, global_batch_size=2,
                train_steps=IDEFICS2_TRAIN_STEPS, log_interval=1, eval_interval=0,
                save_interval=0, remat=policy, loss_chunk=1024,
                optimizer=OptimizerConfig(lr=1e-5, warmup_steps=1, decay_steps=1000,
                                          grad_clip=1.0, weight_decay=0.0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state = trainer.create_train_state(model, tcfg)
            step = trainer.make_train_step(cfg, tcfg, frozen=("perceiver",), model=model)
            snaps = [{n: p.reshape(-1)[:: max(1, p.numel() // 4096)][:4096].clone()
                      for n, p in state.params.items()}]
            records = []

            def step_fn(st, b):
                before = {k: c.launches for k, c in counters.items()}
                k2_events.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, metrics = step(st, b)
                torch.cuda.synchronize()
                records.append({
                    "ms": (time.perf_counter() - t0) * 1e3, "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "nan_step": bool(metrics["nan_step"]),
                    "k2_ms": sum(s.elapsed_time(e) for s, e in k2_events),
                    "launches": {k: c.launches - before[k] for k, c in counters.items()}})
                snaps.append({n: p.reshape(-1)[:: max(1, p.numel() // 4096)][:4096].clone()
                              for n, p in st.params.items()})
                return st, metrics

            fa.flash_attention.copies = 0
            state = train(cfg, tcfg, state, step_fn, iter(dev_batches))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            copies = fa.flash_attention.copies
            del state, step
            torch.cuda.empty_cache()
            for i, r in enumerate(records, start=1):
                print(f"Idefics2 train {policy} step {i}: loss {r['loss']:.6f}, grad norm "
                      f"{r['grad_norm']:.6f}, {r['ms']:.1f} ms (K2 {r['k2_ms']:.2f} ms), "
                      f"launches {r['launches']} [{card}]", flush=True)
                if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])) or r["nan_step"]:
                    raise AssertionError(f"Idefics2 train {policy} step {i}: non-finite {r}")
                if r["launches"] != want:
                    raise AssertionError(f"Idefics2 train {policy} step {i}: launches "
                                         f"{r['launches']}, expected {want}")
            if len(records) != IDEFICS2_TRAIN_STEPS or copies:
                raise AssertionError(f"Idefics2 train {policy}: {len(records)} steps, "
                                     f"{copies} K1/K2 input copies")
            changed_1 = [n for n in snaps[0] if not torch.equal(snaps[0][n], snaps[1][n])]
            if changed_1:
                raise AssertionError(f"Idefics2 train {policy}: step 1 (lr 0) changed "
                                     f"{changed_1[:5]}")
            moved = {}
            for n in snaps[0]:
                grp = moved.setdefault(param_group(n), [0, 0])
                grp[0] += int(not torch.equal(snaps[0][n], snaps[-1][n]))
                grp[1] += 1
            if moved["perceiver"][0] or any(c == 0 for g, (c, _) in moved.items()
                                            if g != "perceiver"):
                raise AssertionError(f"Idefics2 train {policy}: tensors changed per group "
                                     f"{moved} (the frozen perceiver must stay, every other "
                                     "group move)")
            step_ms = statistics.mean(r["ms"] for r in records[1:])
            k2_ms = statistics.mean(r["k2_ms"] for r in records[1:])
            tokens = 2 * IDEFICS2_TRAIN_SEQ
            recs[policy] = {"steps": records, "launches_per_step": want, "copies": copies,
                            "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
                            "k2_ms_per_step": k2_ms, "peak_memory_gib": peak,
                            "params_moved": moved}
            print(f"Idefics2 train remat={policy}: {IDEFICS2_TRAIN_STEPS} steps of train(), "
                  "step 1 left the params unchanged (lr 0), steps 2-3 changed tensors per "
                  "group " + ", ".join(f"{g}: {c}/{t}" for g, (c, t) in moved.items())
                  + f" (the perceiver frozen, bit-equal); launches a step {want}; step "
                  f"{step_ms:.1f} ms (mean of steps 2-{IDEFICS2_TRAIN_STEPS}), "
                  f"{tokens / step_ms * 1e3:.1f} tokens/s (slots), K2 {k2_ms:.2f} ms a step "
                  f"({lv} + {lt} launches); peak device memory {peak:.2f} GiB [{card}]",
                  flush=True)
    finally:
        fa._launch_bwd = real_bwd
    return recs


def idefics2_train_cli_phase(hf_dir, manifest, rows, cfg, card, tmp, device, k1_checked,
                             k2_checked):
    """Phase 33: train_leopard_idefics2 --init-from phase 25's depth-4
    checkpoint --freeze-perceiver on the manifest: 4 steps, saving at step
    3; its first loss against the train step's loss on the builder's first
    batch with the model loaded from the checkpoint, the launches against
    the formulas, the perceiver unchanged; then a second run on the same
    directory to step 4 resumes at step 3 and its loss equals the unbroken
    run's fourth."""
    import torch

    from leopard_tpu_torch.cli import train_leopard_idefics2 as cli
    from leopard_tpu_torch.config import TrainConfig
    from leopard_tpu_torch.convert.hf import load_leopard_idefics2
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
    from leopard_tpu_torch.training import trainer

    steps = IDEFICS2_TRAIN_STEPS + 1
    batches = idefics2_train_batches(cfg, rows, manifest.parent, steps)
    for b in batches:
        held("Idefics2 train CLI", "K1", k2_ran(b, cfg), k1_checked)
        held("Idefics2 train CLI", "K2", k2_ran(b, cfg), k2_checked)
    run = tmp / "idefics2_run"
    argv = ["--manifest", str(manifest), "--image-folder", str(manifest.parent),
            "--tokenizer", "(the smoke's own)", "--init-from", str(hf_dir),
            "--checkpoint-dir", str(run), "--seq-len", str(IDEFICS2_TRAIN_SEQ),
            "--global-batch-size", "2", "--set", f"text.num_layers={cfg.text.num_layers}",
            "--freeze-perceiver", "--device", device.type]
    ref = load_leopard_idefics2(str(hf_dir), cfg, device)
    perceiver = {n: p.detach().float().clone() for n, p in ref.named_parameters()
                 if n.startswith("perceiver.")}
    tc = TrainConfig()
    with torch.no_grad():
        ref_loss = trainer.make_train_step(cfg, tc, model=ref).eval_loss(
            dict(ref.named_parameters()), to_device(batches[0], device))[0].item()
    del ref
    torch.cuda.empty_cache()

    lt, lv, lp = cfg.text.num_layers, cfg.vision.num_layers, cfg.perceiver.num_layers
    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "fused_rms_norm": fused_rms_norm, "fused_layer_norm": fused_layer_norm}
    per_step = {"flash_attention": 2 * (lt + lv), "flash_attention_bwd": lt + lv,
                "fused_rms_norm": 2 * 2 * lt + 1 + 3 * lp + 1,
                "fused_layer_norm": 2 * 2 * lv + 1}
    tok = Idefics2ByteTokenizer()
    walls, totals = [], []
    states = []
    for n_steps in (steps, steps):  # the unbroken run saving at step 3, then the resume
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        flash_attention.copies = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            state = cli.train_main(cli.parse_args(argv + ["--train-steps", str(n_steps)]),
                                   tokenizer=tok, save_interval=IDEFICS2_TRAIN_STEPS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        totals.append({k: c.launches for k, c in counters.items()})
        states.append({"step": int(state.step), "peak_gib":
                       torch.cuda.max_memory_allocated() / 2**30, "stdout": out.getvalue(),
                       "copies": flash_attention.copies,
                       "perceiver_equal": all(torch.equal(state.params[n], p.to(device))
                                              for n, p in perceiver.items())})
        del state
        torch.cuda.empty_cache()
    with open(run / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    losses = [r["loss"] for r in logged]
    if [r["step"] for r in logged] != [*range(1, steps + 1), steps]:
        raise AssertionError(f"Idefics2 train CLI: logged steps {[r['step'] for r in logged]}")
    if not np.isfinite(losses).all() or any(r["nan_iters"] for r in logged):
        raise AssertionError(f"Idefics2 train CLI: non-finite losses {losses}")
    if f"resumed from step {IDEFICS2_TRAIN_STEPS}" not in states[1]["stdout"]:
        raise AssertionError(f"Idefics2 train CLI: the second run did not resume: "
                             f"{states[1]['stdout']!r}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if rel > TRAIN_CLI_LOSS_RTOL:
        raise AssertionError(f"Idefics2 train CLI: step 1 loss {losses[0]} vs the train "
                             f"step's {ref_loss} (rel {rel:.3g} > {TRAIN_CLI_LOSS_RTOL})")
    resume_rel = abs(losses[-1] - losses[steps - 1]) / abs(losses[steps - 1])
    if resume_rel > TRAIN_CLI_LOSS_RTOL:
        raise AssertionError(f"Idefics2 train CLI: the resumed step {steps} loss {losses[-1]} "
                             f"vs the unbroken run's {losses[steps - 1]}")
    expect("Idefics2 train CLI", totals[0], {k: steps * n for k, n in per_step.items()})
    expect("Idefics2 train CLI resumed", totals[1], per_step)
    if any(s["copies"] for s in states) or not all(s["perceiver_equal"] for s in states):
        raise AssertionError(f"Idefics2 train CLI: copies or a moved frozen perceiver {states}")
    step_ms = statistics.mean(r["step_time"] for r in logged[1:steps]) * 1e3
    rec = {"losses": losses, "train_step_loss": ref_loss, "loss_rel_diff": rel,
           "resume_rel_diff": resume_rel, "row_lengths": [row_lengths(b) for b in batches],
           "step_ms": [r["step_time"] * 1e3 for r in logged], "step_ms_mean_2_4": step_ms,
           "tokens_per_s": 2 * IDEFICS2_TRAIN_SEQ / step_ms * 1e3,
           "data_ms": [r["data_time"] * 1e3 for r in logged], "wall_s": walls,
           "peak_memory_gib": [s["peak_gib"] for s in states], "launches": totals,
           "launches_per_step": per_step}
    print(f"train_leopard_idefics2 CLI: {IDEFICS2_TRAIN_SAMPLES}-sample manifest, --init-from "
          f"phase 25's checkpoint, --freeze-perceiver, {steps} steps at 2 x "
          f"{IDEFICS2_TRAIN_SEQ} saving at step {IDEFICS2_TRAIN_STEPS}: losses "
          f"{[round(x, 6) for x in losses[:steps]]}, step 1 vs the train step on the "
          f"builder's first batch {ref_loss:.6f} (rel {rel:.3g}, tol {TRAIN_CLI_LOSS_RTOL}); "
          f"resumed at step {IDEFICS2_TRAIN_STEPS}, step {steps} loss {losses[-1]:.6f} vs the "
          f"unbroken {losses[steps - 1]:.6f} (rel {resume_rel:.3g}); launches {totals} = "
          f"{steps} x and 1 x {per_step}; the perceiver unchanged; step {step_ms:.1f} ms "
          f"(mean of steps 2-{steps}), the builder's wait a step "
          f"{[round(x, 1) for x in rec['data_ms']]} ms; the runs {[round(w, 2) for w in walls]} "
          f"s; peak device memory {[round(s['peak_gib'], 2) for s in states]} GiB [{card}]",
          flush=True)
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
            r["cosines"] = group_cosines(grads, ref)
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



# phases 34-35: the JAX package's only MoE model, tools/bench_moe.py's
# compute-dense shape (README: hidden 2,048, ffn 5,632, 4 experts top-2, 4
# layers, 32 query / 16 KV heads of dim 64, vocab 32,768, tied embeddings;
# 0.671 B parameters), at that tool's batch of 4 x 4,096 tokens, and
# phase 36: int4 Leopard-Idefics2 at phase 22's request
MOE_SHAPE = dict(hidden=2048, ff=5632, experts=4, topk=2, layers=4)
MOE_BATCH, MOE_SEQ = 4, 4096
MOE_STEPS = 3
MOE_CAPACITY_FACTOR = 1.25
MOE_RUNS = (("dropless", "full"), ("dropless", "selective"), ("capacity", "full"),
            ("capacity", "selective"))
# dropless against the capacity path at capacity factor E (nothing drops),
# one layer on one input: the same routing and expert math, the combine
# rounded in another order in bf16, so output and gradients agree to bf16
# noise
MOE_GRAD_COSINE_MIN = 0.999
MOE_SERVE_TEXT = (3000, 2000)     # tokens of phase 35's two text prompts (bucket 4,096)
# K1 and K2 at head dim 64 against their plain versions: bf16 outputs of
# std ~1 agree to ~2^-9 relative, cosine ~1 - 1e-5
KERNEL_COSINE_MIN = 0.9999
# K4 at Mistral's head padded to whole 128-column tiles (phase 36)
MISTRAL_HEAD_PADDED = 32128


def moe_config(mode):
    """tools/bench_torch_moe.py's config at MOE_SHAPE; `mode` "dropless" or
    "capacity" (factor MOE_CAPACITY_FACTOR)."""
    from tools.bench_torch_moe import moe_config as bench_config

    cfg = bench_config(dropless=mode == "dropless", **MOE_SHAPE)
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, moe_capacity_factor=MOE_CAPACITY_FACTOR))


def moe_k1_shapes():
    """Phase 3's K1 entries of phases 34-35: the train batch's four full
    rows and the serve prefill's two prompts at bucket 4,096, head dim 64,
    held by cosine too."""
    t = moe_config("dropless").text
    kw = dict(s=MOE_SEQ, hq=t.num_heads, hkv=t.num_kv_heads, d=t.head_dim, causal=True,
              cosine_min=KERNEL_COSINE_MIN)
    return {"moe_train": dict(b=MOE_BATCH, rows=((MOE_SEQ,),) * MOE_BATCH, **kw),
            "moe_serve": dict(b=len(MOE_SERVE_TEXT), rows=tuple((n,) for n in MOE_SERVE_TEXT),
                              **kw)}


def moe_batch(device):
    """tools/bench_moe.py's batch: seeded ids, every position in the loss."""
    import torch

    ids = np.random.RandomState(SEED).randint(1, 30000, (MOE_BATCH, MOE_SEQ))
    return {"tokens": torch.from_numpy(ids).to(device),
            "loss_weights": torch.ones((MOE_BATCH, MOE_SEQ), device=device),
            "segment_ids": torch.ones((MOE_BATCH, MOE_SEQ), dtype=torch.int32, device=device)}


def moe_train_config(remat):
    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig

    return TrainConfig(seq_len=MOE_SEQ, global_batch_size=MOE_BATCH, remat=remat,
                       loss_chunk=1024, optimizer=OptimizerConfig(
                           lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0))


def moe_dropless_vs_capacity(model, batch, card, device):
    """Phase 34, first: dropless against the capacity path at capacity factor
    E, where nothing drops (the JAX package's tests/test_moe.py:146 at full
    size). (a) One MoE layer on layer 0's weights and a seeded input of the
    batch's size, where both route identically: output and gradients (input,
    router, experts) at cosine >= MOE_GRAD_COSINE_MIN. (b) One whole step of
    each: nothing dropped, losses within 1e-3 relative, layer 0's routing
    identical; the step's gradient cosines per text group and each layer's
    share of tokens routed otherwise are reported: in bf16 a later layer's
    input differs in its last bits between the two dispatches (the combine
    rounds in another order), which flips tokens whose k-th and (k+1)-th
    router probabilities are near ties."""
    import torch

    from leopard_tpu_torch.ops import moe
    from leopard_tpu_torch.training import trainer

    cap = moe_config("capacity")
    e = cap.text.num_experts
    cfgs_ = {"dropless": moe_config("dropless"),
             "capacity": dataclasses.replace(cap, text=dataclasses.replace(
                 cap.text, moe_capacity_factor=float(e)))}
    # (a) the layer alone
    layer = model.text.layers[0]
    g = torch.Generator(device=device).manual_seed(SEED + 34)
    h = cap.text.hidden_size
    x0 = torch.randn((MOE_BATCH, MOE_SEQ, h), generator=g, device=device).to(
        layer.experts.w_gate.dtype)
    cot = torch.randn((MOE_BATCH, MOE_SEQ, h), generator=g, device=device)
    leaves = {"router": layer.router.w, **dict(layer.experts.named_parameters())}
    outs, grads = {}, {}
    for mode, c in cfgs_.items():
        mine = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
        x = x0.clone().requires_grad_()
        out, aux = moe.moe_layer(mine["router"], {k: mine[k] for k in ("w_gate", "w_up", "w_down")},
                                 moe.MoEConfig(num_experts=e, top_k=c.text.moe_top_k,
                                               capacity_factor=c.text.moe_capacity_factor,
                                               dropless=c.text.moe_dropless), x)
        if float(aux["fraction_dropped"]):
            raise AssertionError(f"MoE layer {mode} at factor {e} dropped tokens")
        ((out.float() * cot).sum() + aux["aux_loss"] + aux["z_loss"]).backward()
        outs[mode] = out.detach()
        grads[mode] = {"x": x.grad, **{k: v.grad for k, v in mine.items()}}
    pairs = {"out": (outs["dropless"], outs["capacity"]),
             **{k: (grads["dropless"][k], grads["capacity"][k]) for k in grads["dropless"]}}
    layer_cos = {k: cosine(a.reshape(-1), b.reshape(-1), dim=0).item()
                 for k, (a, b) in pairs.items()}
    del outs, grads, pairs, x0, cot
    print(f"MoE layer dropless vs capacity at factor {e} ([{MOE_BATCH} x {MOE_SEQ}, {h}], layer "
          f"0's weights): cosine " + ", ".join(f"{k}: {c:.7f}" for k, c in layer_cos.items())
          + f" (min {MOE_GRAD_COSINE_MIN}) [{card}]", flush=True)
    if min(layer_cos.values()) < MOE_GRAD_COSINE_MIN:
        raise AssertionError(f"MoE layer: dropless differs from capacity at factor E: "
                             f"{layer_cos}")

    # (b) a whole step of each, its routing recorded
    routes, real = [], moe.router_top_k

    def recorded(logits, k):
        top_p, top_i = real(logits, k)
        routes.append(top_i.sort(dim=-1).values)
        return top_p, top_i

    tcfg = moe_train_config("full")
    state = trainer.create_train_state(model, tcfg)
    lt = cap.text.num_layers
    grads, metrics, forward_routes = {}, {}, {}
    moe.router_top_k = recorded
    try:
        for mode, c in cfgs_.items():
            routes.clear()
            m = model if mode == "dropless" else idefics2_twin(model, c)
            loss, metrics[mode], grads[mode] = trainer.make_train_step(
                c, tcfg, model=m).loss_and_grads(state, batch)
            metrics[mode] = {k: float(v) for k, v in metrics[mode].items()}
            metrics[mode]["total_loss"] = float(loss)
            forward_routes[mode] = routes[:lt]  # the forward's; the recompute's follow
    finally:
        moe.router_top_k = real
    del state
    flipped = [(a != b).any(dim=-1).float().mean().item()
               for a, b in zip(forward_routes["dropless"], forward_routes["capacity"])]
    # text-only batches: the stub tower and projector get no gradient
    text = {m: {n: g_ for n, g_ in gs.items() if n.startswith("text.")}
            for m, gs in grads.items()}
    cosines = group_cosines(text["dropless"], text["capacity"])
    del grads, text, forward_routes
    drops = {m: r["moe_fraction_dropped"] for m, r in metrics.items()}
    rel = abs(metrics["dropless"]["loss"] - metrics["capacity"]["loss"]) / abs(
        metrics["capacity"]["loss"])
    print(f"MoE step dropless vs capacity at factor {e}: loss {metrics['dropless']['loss']:.6f} "
          f"vs {metrics['capacity']['loss']:.6f} (rel {rel:.3g}), dropped {drops}; tokens "
          f"routed otherwise per layer {flipped} (layer 0 must be 0); the step's gradient "
          "cosine per group " + ", ".join(f"{g_}: {c:.6f}" for g_, c in cosines.items())
          + f" (reported) [{card}]", flush=True)
    if any(drops.values()) or rel > 1e-3 or flipped[0] != 0.0:
        raise AssertionError(f"MoE step: dropless differs from capacity at factor E: "
                             f"{metrics}, flipped {flipped}")
    return {"layer_cosines": layer_cos, "step_cosines": cosines, "metrics": metrics,
            "loss_rel_diff": rel, "tokens_routed_otherwise_per_layer": flipped}


def moe_train_phase(model, batch, card):
    """Phase 34: MOE_STEPS steps of make_train_step under each (dispatch,
    recompute) of MOE_RUNS, each from a fresh train state of the model's
    current weights: loss finite, dropless drops nothing, K1/K2/K3a launches
    a step as the formulas, step ms, tokens/s, MFU, peak memory."""
    import torch

    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.ops.fused_norms import fused_rms_norm
    from leopard_tpu_torch.training import trainer

    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "fused_rms_norm": fused_rms_norm}
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for n, p in model.named_parameters() if ".experts." in n)
    t = moe_config("dropless").text
    n_active = n_params - n_expert * (1 - t.moe_top_k / t.num_experts)
    lt = t.num_layers
    tokens = MOE_BATCH * MOE_SEQ
    rec = {}
    for mode, remat in MOE_RUNS:
        cfg = moe_config(mode)
        m = model if mode == "dropless" else idefics2_twin(model, cfg)
        # K1 in the forward and again in a full recompute (saved under
        # "selective"), K2 once, two RMSNorms a layer forward and recomputed
        # and the final one
        want = {"flash_attention": (2 if remat == "full" else 1) * lt,
                "flash_attention_bwd": lt, "fused_rms_norm": 2 * 2 * lt + 1}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tcfg = moe_train_config(remat)
        state = trainer.create_train_state(m, tcfg)
        step = trainer.make_train_step(cfg, tcfg, model=m)
        steps = []
        for i in range(MOE_STEPS):
            for c in counters.values():
                c.launches = 0
            flash_attention.copies = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            r = {"ms": ms, "loss": float(metrics["loss"]),
                 "aux_loss": float(metrics["moe_aux_loss"]),
                 "z_loss": float(metrics["moe_z_loss"]),
                 "fraction_dropped": float(metrics["moe_fraction_dropped"]),
                 "grad_norm": float(metrics["grad_norm"]),
                 "launches": {k: c.launches for k, c in counters.items()},
                 "copies": flash_attention.copies}
            steps.append(r)
            label = f"MoE train {mode}/{remat} step {i + 1}"
            if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
                raise AssertionError(f"{label}: non-finite loss or grad norm: {r}")
            if mode == "dropless" and r["fraction_dropped"] != 0.0:
                raise AssertionError(f"{label}: dropless dropped {r['fraction_dropped']}")
            if r["launches"] != want or r["copies"]:
                raise AssertionError(f"{label}: launches {r['launches']} (copies "
                                     f"{r['copies']}), expected {want}")
        del state, step
        step_ms = statistics.mean(r["ms"] for r in steps[1:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        mfu = 6 * n_active * tokens / (step_ms * 1e-3) / PEAK_BF16_FLOPS
        rec[f"{mode}/{remat}"] = {"steps": steps, "step_ms": step_ms,
                                  "tokens_per_s": tokens / step_ms * 1e3, "mfu_6nd_active": mfu,
                                  "peak_memory_gib": peak, "launches_per_step": want,
                                  "fraction_dropped": steps[-1]["fraction_dropped"]}
        print(f"MoE train {mode}/{remat}: losses {[round(r['loss'], 6) for r in steps]}, aux "
              f"{steps[-1]['aux_loss']:.6f}, z {steps[-1]['z_loss']:.6f}, moe_fraction_dropped "
              f"{[r['fraction_dropped'] for r in steps]}; launches a step {want} (K1 "
              f"{want['flash_attention']}, K2 {lt}, K3a 2 x 2 x {lt} + 1); step ms "
              f"{[round(r['ms'], 1) for r in steps]} (mean of steps 2-{MOE_STEPS} "
              f"{step_ms:.1f} ms), {tokens / step_ms * 1e3:.1f} tokens/s, MFU(6ND_active, "
              f"{n_active / 1e9:.3f} B active of {n_params / 1e9:.3f} B) {mfu * 100:.1f}%, peak "
              f"{peak:.2f} GiB [{card}]", flush=True)
    return {"runs": rec, "parameters": n_params, "active_parameters": n_active}


def moe_serve_phase(model, card, device):
    """Phase 35: Engine.generate on the phase-34 model (dropless), two text
    prompts of MOE_SERVE_TEXT tokens (bucket 4,096), 16 greedy tokens, twice:
    tokens repeat and lie in the vocab, K1 (prefill) and K3a launches as the
    formulas, the dropless dispatch called once a layer a forward (one host
    read of the group sizes each); TTFT and decode ms a step."""
    import torch

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.ops import moe
    from leopard_tpu_torch.ops.flash_attention import flash_attention
    from leopard_tpu_torch.ops.fused_norms import fused_rms_norm

    cfg = moe_config("dropless")
    lt = cfg.text.num_layers
    rng = np.random.RandomState(SEED + 35)
    prompts = [rng.randint(1, 30000, n).astype(np.int32) for n in MOE_SERVE_TEXT]
    engine = Engine(cfg, model)
    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, eos_token_ids=(NO_EOS,))
    steps = MAX_NEW_TOKENS - 1
    want = {"flash_attention": lt, "fused_rms_norm": (2 * lt + 1) * (1 + steps),
            "host_reads": lt * (1 + steps)}
    real = moe._dropless_dispatch
    reads = []

    def counted(*args, **kw):
        reads.append(1)
        return real(*args, **kw)

    moe._dropless_dispatch = counted
    runs = []
    try:
        for _ in range(2):
            reads.clear()
            flash_attention.launches = fused_rms_norm.launches = flash_attention.copies = 0
            res = engine.generate(prompts, gen_cfg=gen)
            torch.cuda.synchronize()
            got = {"flash_attention": flash_attention.launches,
                   "fused_rms_norm": fused_rms_norm.launches, "host_reads": len(reads)}
            if got != want or flash_attention.copies:
                raise AssertionError(f"MoE serve: {got} (copies {flash_attention.copies}), "
                                     f"expected {want}")
            for toks, lps in zip(res.tokens, res.logprobs):
                if len(toks) != MAX_NEW_TOKENS or not np.all((toks >= 0)
                                                               & (toks < cfg.text.vocab_size)):
                    raise AssertionError(f"MoE serve: tokens {toks}")
                if not np.all(np.isfinite(lps)):
                    raise AssertionError(f"MoE serve: non-finite logprobs {lps}")
            runs.append([t.tolist() for t in res.tokens])
        if runs[0] != runs[1]:
            raise AssertionError(f"MoE serve: generate is not repeatable: {runs}")
        ttft = wall_s(lambda: engine.generate(prompts, gen_cfg=dataclasses.replace(
            gen, max_new_tokens=1)))
        full = wall_s(lambda: engine.generate(prompts, gen_cfg=gen))
    finally:
        moe._dropless_dispatch = real
    del engine
    model.text._head_f32 = None
    rec = {"prompt_tokens": list(MOE_SERVE_TEXT), "tokens": runs[0], "launches": want,
           "host_reads_per_decode_step": lt, "ttft_s": ttft,
           "prefill_tok_s": sum(MOE_SERVE_TEXT) / ttft,
           "decode_ms_per_step": (full - ttft) / steps * 1e3}
    print(f"MoE serve (dropless): 2 prompts of {list(MOE_SERVE_TEXT)} tokens (bucket "
          f"{MOE_SEQ}), {MAX_NEW_TOKENS} greedy tokens identical in two runs; launches {want} "
          f"(K1 {lt} prefill, K3a {2 * lt + 1} x {1 + steps} forwards; group sizes read on the "
          f"host {lt} times a forward, once a layer); TTFT {ttft * 1e3:.1f} ms, prefill "
          f"{rec['prefill_tok_s']:.1f} tok/s, decode {rec['decode_ms_per_step']:.2f} ms/step "
          f"(batch 2, {steps} steps; median of 3) [{card}]", flush=True)
    return rec


def idefics2_int4_phase(model, cfg, launches, card):
    """Phase 36: phase 22's request through Engine(quantize="int4"): the
    head (N = 32,003, held padded to 32,128 columns) reaches K4 at the
    prefill and every decode step, beside the 7 K4 matmuls of each layer;
    tokens in the vocab, logprobs finite, tokens repeat; TTFT and decode
    ms/step."""
    import torch

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.ops import quant

    prompt, pixels, _, patch_mask = idefics2_request(cfg)
    engine = Engine(cfg, model, quantize="int4")
    head = engine.model.text.lm_head
    if head.q4.shape[-1] != MISTRAL_HEAD_PADDED or head.n != cfg.text.vocab_size:
        raise AssertionError(f"int4 Idefics2 head q4 {tuple(head.q4.shape)}, n {head.n}")
    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, eos_token_ids=(NO_EOS,))
    steps = MAX_NEW_TOKENS - 1
    widths = collections.Counter()
    real = quant.int4_matmul

    def counted(x, q4, s, **kw):
        widths[q4.shape[-1]] += 1
        return real(x, q4, s, **kw)

    quant.int4_matmul = counted
    runs = []
    try:
        for _ in range(2):
            widths.clear()
            with launches:
                res = engine.generate([prompt], images=pixels, patch_mask=patch_mask,
                                      gen_cfg=gen)
            toks, lps = res.tokens[0], res.logprobs[0]
            if len(toks) != MAX_NEW_TOKENS or not np.all((toks >= 0)
                                                           & (toks < cfg.text.vocab_size)):
                raise AssertionError(f"int4 Idefics2: tokens {toks}")
            if not np.all(np.isfinite(lps)):
                raise AssertionError(f"int4 Idefics2: non-finite logprobs {lps}")
            want = {**idefics2_counts(cfg, steps),
                    "int4_matmul": 1 + (7 * cfg.text.num_layers + 1) * steps}
            expect("int4 Idefics2", launches.counts, want)
            if widths[MISTRAL_HEAD_PADDED] != 1 + steps:
                raise AssertionError(f"int4 Idefics2: K4 at N = {MISTRAL_HEAD_PADDED} "
                                     f"{widths[MISTRAL_HEAD_PADDED]} times, expected "
                                     f"{1 + steps}: {dict(widths)}")
            runs.append(toks.tolist())
        if runs[0] != runs[1]:
            raise AssertionError(f"int4 Idefics2: generate is not repeatable: {runs}")
        by_n = dict(widths)  # one generate's; the timed runs below count on
        ttft = wall_s(lambda: engine.generate([prompt], images=pixels, patch_mask=patch_mask,
                                              gen_cfg=dataclasses.replace(gen,
                                                                          max_new_tokens=1)))
        full = wall_s(lambda: engine.generate([prompt], images=pixels, patch_mask=patch_mask,
                                              gen_cfg=gen))
    finally:
        quant.int4_matmul = real
    del engine, head
    torch.cuda.synchronize()
    rec = {"tokens": runs[0], "launches": launches.counts,
           "k4_calls_by_n": {str(k): v for k, v in by_n.items()},
           "head_k4_launches": by_n[MISTRAL_HEAD_PADDED], "ttft_s": ttft,
           "decode_ms_per_step": (full - ttft) / steps * 1e3}
    print(f"int4 Idefics2 serve at 8B: phase 22's request, {MAX_NEW_TOKENS} greedy tokens "
          f"identical in two runs: {runs[0]}; launches {launches.counts}; K4 calls by N "
          f"{by_n} (the head padded 32,003 -> {MISTRAL_HEAD_PADDED}: 1 prefill + "
          f"{steps} decode); TTFT {ttft * 1e3:.1f} ms, decode {rec['decode_ms_per_step']:.2f} "
          f"ms/step (batch 1; median of 3) [{card}]", flush=True)
    return rec

# phases 37-40: the device mesh (leopard_tpu_torch/parallel/) at a world of
# one; the card is one H100, so no collective runs between two devices here
MESH_LOSS_RTOL = 1e-5
MESH_COSINE_MIN = 0.9999
RING_SHAPE = dict(b=1, s=16384, hq=32, hkv=8, d=128)   # Leopard-LLaVA's training length
RING_SIZES = (2, 4)
RING_COSINE_MIN = 0.9999
MESH_RING_STEPS = 2


def world_one_mesh():
    """A world-1 NCCL process group in this process and a mesh of all ones."""
    from leopard_tpu_torch.config import MeshConfig
    from leopard_tpu_torch.parallel.launch import initialize_distributed
    from leopard_tpu_torch.parallel.mesh import build_mesh, mesh_config

    info = initialize_distributed("cuda")
    mesh = build_mesh(MeshConfig(), "cuda")
    print(f"mesh: process group {info}, mesh {mesh_config(mesh)}", flush=True)
    return mesh


def mesh_serve_phase(model, cfg, prompts, tiles, mesh, card, bf16, int4):
    """Phase 39: Engine(mesh=) in bf16 and int4 against phases 4 and 6."""
    from leopard_tpu_torch.inference.engine import Engine

    out = {}
    for label, quantize, ref, k4 in (("bf16", None, bf16, 0),
                                      ("int4", "int4", int4, 7 * cfg.text.num_layers + 1)):
        engine = Engine(cfg, model, mesh=mesh, quantize=quantize)
        t = serve(engine, cfg, prompts, tiles, card, f"serve {label} mesh", k4, runs=1,
                  time_reps=3 if quantize is None else 1)
        del engine
        model.text._head_f32 = None
        if t["tokens"] != ref["tokens"]:
            raise AssertionError(f"mesh {label}: tokens {t['tokens']} vs {ref['tokens']}")
        print(f"serve {label} mesh vs plain [{card}]: tokens equal; TTFT "
              f"{t['ttft_s'] * 1e3:.1f} vs {ref['ttft_s'] * 1e3:.1f} ms, decode "
              f"{t['decode_ms_per_step']:.2f} vs {ref['decode_ms_per_step']:.2f} ms/step",
              flush=True)
        out[label] = {"mesh": t, "plain_ttft_s": ref["ttft_s"],
                      "plain_decode_ms_per_step": ref["decode_ms_per_step"]}
    return out


def mesh_train_phase(model, cfg, batch, mesh, card):
    """Phase 37: the plain step, then make_train_step(mesh=) and its ring
    form at seq=1, from the same weights. `model`'s parameters become
    DTensors (create_train_state(mesh=)): run it last on this model."""
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
    from leopard_tpu_torch.training import trainer

    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "fused_rms_norm": fused_rms_norm, "fused_layer_norm": fused_layer_norm}
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    want = {"flash_attention": 2 * (lt + lv), "flash_attention_bwd": lt + lv,
            "fused_rms_norm": 2 * 2 * lt + 1, "fused_layer_norm": 2 * 2 * lv + 1}
    tc = TrainConfig(
        seq_len=TRAIN_SEQ, global_batch_size=len(TRAIN_ROWS), remat="full", loss_chunk=1024,
        optimizer=OptimizerConfig(lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0))

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, {k: c.launches for k, c in counters.items()}

    def timed_steps(label, step, state, n):
        ms = []
        for i in range(n):
            (state, metrics), t, launches = counted(lambda: step(state, batch))
            if launches != want or not np.isfinite(float(metrics["loss"])):
                raise AssertionError(f"{label} step {i + 1}: launches {launches} (expected "
                                     f"{want}), loss {float(metrics['loss'])}")
            ms.append(t)
        return state, ms

    rec = {}
    torch.cuda.reset_peak_memory_stats()
    state = trainer.create_train_state(model, tc)
    step = trainer.make_train_step(cfg, tc)
    (loss, _, grads), _, _ = counted(lambda: step.loss_and_grads(state, batch))
    plain_loss = float(loss)
    plain_grads = {k: g.cpu() for k, g in grads.items()}
    del grads
    state, rec["plain_step_ms"] = timed_steps("plain", step, state, 3)
    rec["plain_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del state, step
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    state = trainer.create_train_state(model, tc, mesh=mesh)
    ring_cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, attn_impl="ring"))
    runs = {}
    # both against the plain step's gradients before any update; each step
    # function holds its own compute copy, so one at a time
    for name, c in (("mesh_ring", ring_cfg), ("mesh", cfg)):
        step = trainer.make_train_step(c, tc, mesh=mesh)
        (loss, _, grads), ms, launches = counted(lambda: step.loss_and_grads(state, batch))
        rel = abs(float(loss) - plain_loss) / abs(plain_loss)
        cos = group_cosines(grads, plain_grads)
        del grads
        print(f"{name} step vs plain (one step's loss and gradients) [{card}]: loss "
              f"{float(loss):.6f} vs {plain_loss:.6f} (rel {rel:.3g}, tol {MESH_LOSS_RTOL}), "
              "cosine per group " + ", ".join(f"{g}: {v:.7f}" for g, v in cos.items())
              + f" (min {MESH_COSINE_MIN}); launches {launches}", flush=True)
        if rel > MESH_LOSS_RTOL or min(cos.values()) < MESH_COSINE_MIN or launches != want:
            raise AssertionError(f"{name}: loss rel {rel}, cosines {cos}, launches {launches}")
        runs[name] = {"loss": float(loss), "loss_rel": rel, "cosines": cos,
                      "launches": launches}
        if name == "mesh_ring":
            del step
            torch.cuda.empty_cache()
    state, rec["mesh_step_ms"] = timed_steps("mesh", step, state, 3)
    del step
    torch.cuda.empty_cache()
    step = trainer.make_train_step(ring_cfg, tc, mesh=mesh)
    state, rec["mesh_ring_step_ms"] = timed_steps("mesh ring", step, state, MESH_RING_STEPS)
    rec["mesh_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec.update(runs=runs, plain_loss=plain_loss, launches_per_step=want)
    del state, step
    mean = lambda ms: statistics.mean(ms[1:])  # noqa: E731
    print(f"train step, plain vs mesh of one (world 1, NCCL) [{card}]: "
          f"{mean(rec['plain_step_ms']):.1f} vs {mean(rec['mesh_step_ms']):.1f} ms (mean of "
          f"steps 2-3), ring at seq=1 {mean(rec['mesh_ring_step_ms']):.1f} ms (step 2); "
          f"launches a step {want}; peak device memory {rec['plain_peak_gib']:.2f} (plain) / "
          f"{rec['mesh_peak_gib']:.2f} GiB (mesh)", flush=True)
    return rec


def ring_kernels_phase(device, card):
    """Phase 38: the ring's block arithmetic through K1/K2 for n virtual
    ranks against one K1 and one K2 call over the whole sequence."""
    import torch

    from leopard_tpu_torch.ops import flash_attention as fa
    from leopard_tpu_torch.parallel import context_parallel as cp

    b, s, hq, hkv, d = (RING_SHAPE[k] for k in ("b", "s", "hq", "hkv", "d"))
    g = torch.Generator(device=device).manual_seed(SEED + 38)

    def rand(h):
        return torch.randn((b, s, h, d), generator=g, device=device).to(torch.bfloat16)

    q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
    kw = dict(causal=True, q_segment_ids=None, kv_segment_ids=None, sliding_window=None)
    out_ref, lse_ref = fa._launch(q, k, v, with_lse=True, **kw)
    grads_ref = fa._launch_bwd(q, k, v, None, None, out_ref, lse_ref, do, causal=True,
                               sliding_window=None)
    refs = {"out": out_ref, "dq": grads_ref[0], "dk": grads_ref[1], "dv": grads_ref[2]}
    rec = {"shape": dict(RING_SHAPE), "whole_fwd_ms": cuda_ms(
        lambda: fa._launch(q, k, v, with_lse=True, **kw)),
        "whole_bwd_ms": cuda_ms(lambda: fa._launch_bwd(
            q, k, v, None, None, out_ref, lse_ref, do, causal=True, sliding_window=None))}
    for n in RING_SIZES:
        got = ring_pass(q, k, v, do, refs, n)
        formula = cp.ring_blocks(n, "zigzag")
        print(f"ring n={n} (zig-zag, in-memory rotation) at {RING_SHAPE} [{card}]: cosine vs "
              f"one K1/K2 call {got['cosines']} (min {RING_COSINE_MIN}); launches "
              f"{got['launches']} (a pass: n(2n+1) = {formula} each); ms per ring pass fwd "
              f"{got['fwd_ms']:.3f} / bwd {got['bwd_ms']:.3f} vs one call "
              f"{rec['whole_fwd_ms']:.3f} / {rec['whole_bwd_ms']:.3f}", flush=True)
        if (min(got["cosines"].values()) < RING_COSINE_MIN
                or got["launches"] != {"flash_attention": formula,
                                       "flash_attention_bwd": formula}):
            raise AssertionError(f"ring n={n}: {got}")
        rec[f"n{n}"] = got
    return rec


def ring_pass(q, k, v, do, refs, n, window=None):
    """One pass of the ring's per-rank bodies over n virtual ranks (the
    layout `pick_layout` gives, the KV rotation read from memory) on the
    whole sequence's q, k, v and output gradient: the out and dq/dk/dv put
    back in sequence order, their cosines to `refs` (one K1/K2 call over
    the sequence), whether all are finite, the K1 and K2 launches of the
    pass, and ms a pass forward and backward."""
    import torch

    from leopard_tpu_torch.ops import flash_attention as fa
    from leopard_tpu_torch.parallel import context_parallel as cp

    s, device = q.shape[1], q.device
    layout = cp.pick_layout(s, n)
    idx = [cp.local_positions(s, n, r, layout).to(device) for r in range(n)]
    qs, ks, vs, dos = ([t[:, i].contiguous() for i in idx] for t in (q, k, v, do))
    ring = cp.MemoryRing(ks, vs)
    opts = dict(n=n, layout=layout, causal=True, window=window)

    def fwd():
        return [cp.ring_forward(qs[r], None, ring.view(r), rank=r, **opts) for r in range(n)]

    def bwd(outs):
        for t in (*ring.dk, *ring.dv):
            t.zero_()
        return [cp.ring_backward(qs[r], None, *outs[r], dos[r], ring.view(r), rank=r, **opts)
                for r in range(n)]

    fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
    outs = fwd()
    torch.cuda.synchronize()
    k1 = fa.flash_attention.launches
    dqs = bwd(outs)
    torch.cuda.synchronize()
    launches = {"flash_attention": k1, "flash_attention_bwd": fa.flash_attention_bwd.launches}
    whole = {"out": torch.empty_like(q), "dq": torch.empty_like(q),
             "dk": torch.empty(k.shape, device=device), "dv": torch.empty(v.shape, device=device)}
    for r, i in enumerate(idx):
        whole["out"][:, i], whole["dq"][:, i] = outs[r][0], dqs[r]
        whole["dk"][:, i], whole["dv"][:, i] = ring.dk[r], ring.dv[r]
    finite = all(bool(torch.isfinite(t).all()) for t in whole.values())
    cos = {name: float(cosine(whole[name].float().flatten(), refs[name].float().flatten(),
                              dim=0)) for name in whole}
    del whole
    fwd_ms = cuda_ms(fwd, reps=3)
    bwd_ms = cuda_ms(lambda: bwd(outs), reps=3)
    return {"layout": layout, "cosines": cos, "finite": finite, "launches": launches,
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms}


# phase 45: the windowed ring, Mistral's window over phase 38's shape
RING_WINDOW = 4096


def block_valid_rows(sq, skv, causal, window, offset, device):
    """[Sq] bool: the rows of a ring block that attend at least one key (a
    partial block's others come out (0, -1e30) from K1 and a uniform
    average from the plain version, and merge away)."""
    from leopard_tpu_torch.ops.attention import make_attention_mask

    mask = make_attention_mask(sq, skv, causal=causal, sliding_window=window, device=device,
                               q_offset=offset)
    return mask[0, 0].any(-1)


def offset_block_vs_plain(q, k, v, dout, kind, window, offset, card):
    """One ring block's K1 (out, lse) and K2 (dq, dk, dv) with its q − kv
    offset against their plain versions on the same inputs (K2 from K1's
    out and lse), under KERNEL_TOL / K2_TOL, on the rows that attend a key;
    K1's and K2's times beside the bound over the attended pairs."""
    import torch

    from leopard_tpu_torch.ops import flash_attention as fa

    causal = kind == "diag"
    kw = dict(causal=causal, sliding_window=window, q_offset=offset)
    b, ln, hq, d = q.shape
    out, lse = fa._launch(q, k, v, q_segment_ids=None, kv_segment_ids=None, with_lse=True,
                          **kw)
    grads = fa._launch_bwd(q, k, v, None, None, out, lse, dout, **kw)
    torch.cuda.synchronize()
    rows = block_valid_rows(ln, ln, causal, window, offset, q.device)
    want_out = fa.flash_attention_ref(q, k, v, **kw)
    want_lse = fa.flash_attention_lse_ref(q, k, v, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, None, None, out, lse, dout, **kw)
    errs = {"out": (out[:, rows].float() - want_out[:, rows].float()).abs().max().item(),
            "lse": (lse[:, :, rows] - want_lse[:, :, rows]).abs().max().item()}
    torch.testing.assert_close(out[:, rows].float(), want_out[:, rows].float(), **KERNEL_TOL)
    torch.testing.assert_close(lse[:, :, rows], want_lse[:, :, rows], **KERNEL_TOL)
    if not torch.isfinite(out).all() or not bool((out[:, ~rows] == 0).all()):
        raise AssertionError(f"ring block {kind} offset {offset}: rows with no key not 0")
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        errs[name] = (a.float() - w.float()).abs().max().item()
        torch.testing.assert_close(a.float(), w.float(), **K2_TOL, msg=f"{kind} {offset} {name}")
    del want_out, want_lse, want
    ranges = fa.tile_ranges(None, None, sq=ln, skv=ln, causal=causal, window=window,
                            device=q.device, offset=offset)
    k1_ms = cuda_ms(lambda: fa._launch(q, k, v, q_segment_ids=None, kv_segment_ids=None,
                                       with_lse=True, ranges=ranges, **kw))
    k2_ms = cuda_ms(lambda: fa._launch_bwd(q, k, v, None, None, out, lse, dout, ranges=ranges,
                                           **kw))
    from leopard_tpu_torch.ops.attention import make_attention_mask

    band = make_attention_mask(ln, ln, causal=causal, sliding_window=window, device=q.device,
                               q_offset=offset)
    lib_fwd, lib_bwd = sdpa_band_ms(q, k, v, dout, band)
    plain_k1_ms = cuda_ms(lambda: (fa.flash_attention_ref(q, k, v, **kw),
                                   fa.flash_attention_lse_ref(q, k, v, **kw)), reps=3)
    plain_k2_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, None, None, out, lse, dout,
                                                             **kw), reps=3)
    # attended pairs: row i of the block attends kv j with j <= i + offset
    # (causal) and i + offset - j < window
    i = torch.arange(ln, device=q.device)
    hi = torch.minimum(i + offset + 1, torch.tensor(ln, device=q.device)) if causal else (
        torch.full_like(i, ln))
    lo = (i + offset - window + 1).clamp(min=0)
    pairs = int((hi - lo).clamp(min=0).sum()) * b
    k1_bound, k1_by = attn_bound_ms(pairs, hq, d, 2, nbytes(q, k, v, out, lse))
    k2_bound, k2_by = attn_bound_ms(pairs, hq, d, 5, nbytes(q, k, v, out, dout, lse, q, k, v))
    print(f"ring block {kind}, offset {offset}, window {window}, [{b}, {ln}, {hq}/"
          f"{k.shape[2]}, {d}]: {int(rows.sum())} of {ln} rows attend a key, {pairs} pairs; "
          f"K1/K2 vs plain max_abs_err {errs} (tol {KERNEL_TOL} / {K2_TOL}); K1 {k1_ms:.4f} ms "
          f"(bound {k1_bound:.4f}, plain {plain_k1_ms:.4f}, SDPA with the band as a boolean "
          f"mask {lib_fwd if lib_fwd is None else round(lib_fwd, 4)}), K2 {k2_ms:.4f} ms (bound "
          f"{k2_bound:.4f}, plain {plain_k2_ms:.4f}, SDPA's backward "
          f"{lib_bwd if lib_bwd is None else round(lib_bwd, 4)}) [{card}]", flush=True)
    band = "diagonal" if causal else "inside" if offset + ln - 1 < window else "partial"
    return {"kind": kind, "band": band, "offset": offset, "rows_with_keys": int(rows.sum()),
            "pairs": pairs,
            "errs": errs, "k1_ms": k1_ms, "k2_ms": k2_ms, "k1_library_ms": lib_fwd,
            "k2_library_ms": lib_bwd, "k1_plain_ms": plain_k1_ms, "k2_plain_ms": plain_k2_ms,
            "k1_bound_ms": k1_bound,
            "k1_bound_by": k1_by, "k2_bound_ms": k2_bound, "k2_bound_by": k2_by}


def sdpa_band_ms(q, k, v, dout, mask):
    """F.scaled_dot_product_attention's forward and backward ms on a
    block's inputs with its band (the q − kv offset's causal cut and window)
    as a boolean attn_mask [1, 1, Sq, Skv]: the library call that computes
    the block. None where SDPA refuses it."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    kw = dict(attn_mask=mask, enable_gqa=q.shape[2] != k.shape[2])
    try:
        with torch.no_grad():
            fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw))
        o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        g = dout.transpose(1, 2)
        bwd = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), g, retain_graph=True))
        return fwd, bwd
    except RuntimeError as e:  # reported; the kernels' checks do not depend on it
        print(f"SDPA with a boolean band refused: {str(e).splitlines()[0]}", flush=True)
        return None, None


def ring_window_phase(device, card):
    """Phase 45: phase 38's ring bodies with Mistral's window of
    RING_WINDOW over n = 2 and 4 virtual ranks: each kind of block the
    schedule keeps (diagonal, wholly inside the window, partly inside)
    through K1/K2 with its q − kv offset against the plain versions; the
    whole pass against one windowed K1 and one K2 call over the sequence
    (cosine >= RING_COSINE_MIN); K1 and K2 launched `ring_blocks(...,
    window=)` times a pass, the blocks wholly outside the window skipped;
    ms per pass beside the one call's, and the library call (SDPA with the
    band as a boolean mask) for the whole sequence."""
    import torch

    from leopard_tpu_torch.ops import flash_attention as fa
    from leopard_tpu_torch.parallel import context_parallel as cp

    t_phase = time.perf_counter()
    b, s, hq, hkv, d = (RING_SHAPE[k] for k in ("b", "s", "hq", "hkv", "d"))
    w = RING_WINDOW
    g = torch.Generator(device=device).manual_seed(SEED + 45)

    def rand(h):
        return torch.randn((b, s, h, d), generator=g, device=device).to(torch.bfloat16)

    q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
    kw = dict(causal=True, q_segment_ids=None, kv_segment_ids=None, sliding_window=w)
    ranges = fa.tile_ranges(None, None, sq=s, skv=s, causal=True, window=w, device=device)
    out_ref, lse_ref = fa._launch(q, k, v, with_lse=True, **kw)
    grads_ref = fa._launch_bwd(q, k, v, None, None, out_ref, lse_ref, do, causal=True,
                               sliding_window=w)
    whole_pairs = attended_pairs([[s]] * b, True, w)
    rec = {"shape": dict(RING_SHAPE), "window": w, "whole_fwd_ms": cuda_ms(
        lambda: fa._launch(q, k, v, with_lse=True, ranges=ranges, **kw)),
        "whole_bwd_ms": cuda_ms(lambda: fa._launch_bwd(
            q, k, v, None, None, out_ref, lse_ref, do, causal=True, sliding_window=w,
            ranges=ranges))}
    rec["whole_fwd_bound_ms"], rec["whole_fwd_bound_by"] = attn_bound_ms(
        whole_pairs, hq, d, 2, nbytes(q, k, v, out_ref, lse_ref))
    rec["whole_bwd_bound_ms"], rec["whole_bwd_bound_by"] = attn_bound_ms(
        whole_pairs, hq, d, 5, nbytes(q, k, v, out_ref, do, lse_ref, q, k, v))
    rec["library_fwd_ms"], rec["library_error"] = sdpa_masked_ms(q, k, v, None, True, w)
    refs = {"out": out_ref, "dq": grads_ref[0], "dk": grads_ref[1], "dv": grads_ref[2]}
    rec["blocks"] = []
    for n in RING_SIZES:
        layout = cp.pick_layout(s, n)
        ln = s // (2 * n)
        kept = {(kind, off) for r in range(n) for t in range(n)
                for _, _, _, kind, off in cp.schedule(n, r, (r - t) % n, s // n, layout, True, w)}
        every = {(kind, off) for r in range(n) for t in range(n)
                 for _, _, _, kind, off in cp.schedule(n, r, (r - t) % n, s // n, layout, True)}
        # each kind of block this n gives, on the sequence's first chunk
        # pair at that offset
        for kind, off in sorted(kept):
            rec["blocks"].append({"n": n, **offset_block_vs_plain(
                q[:, off:off + ln], k[:, :ln], v[:, :ln], do[:, off:off + ln], kind, w, off,
                card)})
        got = ring_pass(q, k, v, do, refs, n, window=w)
        formula = cp.ring_blocks(n, layout, window=w, s=s)
        got.update(ring_blocks=formula, unwindowed_blocks=cp.ring_blocks(n, layout),
                   kept=sorted(kept), skipped=sorted(every - kept))
        print(f"windowed ring n={n} ({layout}, window {w}, in-memory rotation) at "
              f"{RING_SHAPE} [{card}]: blocks kept {got['kept']}, skipped {got['skipped']}; "
              f"cosine vs one windowed K1/K2 call {got['cosines']} (min {RING_COSINE_MIN}), "
              f"finite {got['finite']}; launches {got['launches']} (ring_blocks {formula} "
              f"each, of {got['unwindowed_blocks']} without the window); ms per pass fwd "
              f"{got['fwd_ms']:.3f} / bwd {got['bwd_ms']:.3f} vs one call "
              f"{rec['whole_fwd_ms']:.3f} / {rec['whole_bwd_ms']:.3f}", flush=True)
        if (not got["finite"] or min(got["cosines"].values()) < RING_COSINE_MIN
                or not got["skipped"] or got["launches"] != {
                    "flash_attention": formula, "flash_attention_bwd": formula}):
            raise AssertionError(f"windowed ring n={n}: {got}")
        rec[f"n{n}"] = got
        torch.cuda.empty_cache()
    bands = {blk["band"] for blk in rec["blocks"]}
    if bands != {"diagonal", "inside", "partial"}:
        raise AssertionError(f"windowed ring: blocks of {bands}, not every band")
    rec["phase_s"] = time.perf_counter() - t_phase
    lib = ("refused: " + str(rec["library_error"]) if rec["library_fwd_ms"] is None
           else f"{rec['library_fwd_ms']:.3f} ms")
    print(f"phase 45 took {rec['phase_s']:.1f} s; one windowed call over {s} tokens: K1 "
          f"{rec['whole_fwd_ms']:.3f} ms (bound {rec['whole_fwd_bound_ms']:.3f}), K2 "
          f"{rec['whole_bwd_ms']:.3f} ms (bound {rec['whole_bwd_bound_ms']:.3f}), SDPA with the "
          f"band as a boolean mask {lib} [{card}]", flush=True)
    return rec


# phase 41: the 1F1B pipeline (parallel/pipeline.py, training/pp.py) at a world
# of one: MemoryStages runs the n stages in this process, through the same
# make_pp_train_step as P2PStages over gloo in the CPU tests
# (each limit between the sound run's reading and the planted fault's on the
# card: loss rel 7.78e-8 / 1.69e-4, clip norm rel 1.95e-4 / 6.98e-4, least
# cosine 0.9999282 / 0.9487; the clip norm's two readings move by a few
# 1e-4 with a LayerNorm kernel's last-bit rounding: PERF.md)
PP_LOSS_RTOL = 1e-5
PP_COSINE_MIN = 0.9999
PP_NORM_RTOL = 4e-4


def pp_launches(cfg, m_total, tower_chunks):
    """K1, K2, K3a and K3b launches of one pipeline step under "full"
    recompute, whatever n and v: each text layer runs each microbatch's
    forward at its forward tick (K1, two K3a) and again at its backward
    tick, where the layer's checkpoint recomputes it once more before K2;
    the head's final norm runs once a microbatch. The tower runs outside
    the pipeline in `tower_chunks` calls, each under a checkpoint: its
    forward, the checkpoint's recompute and each layer's own recompute (K1,
    two K3b a layer; the post-LN in the first two), and K2 once."""
    lt, lv, m, k = cfg.text.num_layers, cfg.vision.num_layers, m_total, tower_chunks
    return {"flash_attention": 3 * lt * m + 3 * lv * k, "flash_attention_bwd": lt * m + lv * k,
            "fused_rms_norm": 3 * 2 * lt * m + m, "fused_layer_norm": k * (3 * 2 * lv + 2)}


def stale_activations(n):
    """Phase 41's planted fault, a transport that hands each stage the
    activation its predecessor sent one hand-off before the latest (a
    receive buffer reused too early): every later microbatch's upper stages
    run on the previous microbatch's hidden states. Not a path of the port:
    it exists to show that the gates below fail such a run."""
    from leopard_tpu_torch.parallel.pipeline import MemoryStages

    class StaleActivations(MemoryStages):
        def __init__(self):
            super().__init__(n)
            self.previous = {}

        def exchange(self, up, down, want_act, want_grad, like):
            acts, grads = super().exchange(up, down, want_act, want_grad, like)
            for d, act in acts.items():
                if act is not None:
                    acts[d], self.previous[d] = self.previous.get(d, act), act
            return acts, grads

    return StaleActivations()


def traced(fn):
    """fn() once under torch.profiler, device activity alone (a host trace
    of a train step takes longer to process than the step): (its result,
    {host ms, device busy ms (the union of kernel and copy intervals), idle
    share, device ms by tools/profile_torch_train.py's kernel families})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tools.profile_torch_train import family

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"]
    if not kernels:
        raise AssertionError("the trace recorded no device activity")
    busy_us, end_us = 0.0, float("-inf")
    by_family = collections.defaultdict(float)
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = max(e.time_range.start, end_us), e.time_range.end
        busy_us += max(stop - start, 0)
        end_us = max(end_us, stop)
        by_family[family(e.name)] += e.time_range.elapsed_us() / 1e3
    return out, {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
                 "idle_share": 1 - busy_us / 1e3 / wall_ms, "activities": len(kernels),
                 "by_family_ms": dict(by_family)}


def pp_train_phase(cfg, batch, mesh, card, device):
    """Phase 41: phase 20's step through make_pp_train_step with
    MemoryStages(PP_STAGES) at a world of one, at v in PP_CHUNKS, against
    the plain make_train_step from the same seeded weights: loss, gradient
    cosine per group and the clip norm; launches a step against
    `pp_launches`; step ms and peak memory beside the plain step's; and a
    planted fault that the gates must catch."""
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm
    from leopard_tpu_torch.parallel.pipeline import MemoryStages
    from leopard_tpu_torch.training import pp, trainer

    t_phase = time.perf_counter()
    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "fused_rms_norm": fused_rms_norm, "fused_layer_norm": fused_layer_norm}
    tiles = batch["images"].shape[0]
    chunk = -(-tiles // PP_MICROBATCHES)   # vision_chunk 0: tiles / M a call
    want = pp_launches(cfg, PP_MICROBATCHES, -(-tiles // chunk))
    tc = TrainConfig(
        seq_len=TRAIN_SEQ, global_batch_size=len(TRAIN_ROWS), remat="full", loss_chunk=1024,
        optimizer=OptimizerConfig(lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0))

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, {k: c.launches for k, c in counters.items()}

    def timed_steps(label, step, state, launches_want):
        """TRAIN_STEPS steps: the state, each step's ms and clip norm."""
        ms, norms = [], []
        for i in range(TRAIN_STEPS):
            (state, metrics), t, launches = counted(lambda: step(state, batch))
            if launches != launches_want or not np.isfinite(float(metrics["loss"])):
                raise AssertionError(f"{label} step {i + 1}: launches {launches} (expected "
                                     f"{launches_want}), loss {float(metrics['loss'])}")
            ms.append(t)
            norms.append(float(metrics["grad_norm"]))
        return state, ms, norms

    model = vlm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED))
    lt, lv = cfg.text.num_layers, cfg.vision.num_layers
    plain_want = {"flash_attention": 2 * (lt + lv), "flash_attention_bwd": lt + lv,
                  "fused_rms_norm": 2 * 2 * lt + 1, "fused_layer_norm": 2 * 2 * lv + 1}
    rec = {"launches_per_step": want, "plain_launches_per_step": plain_want,
           "stages": PP_STAGES, "microbatches": PP_MICROBATCHES, "tower_chunk": chunk}
    state = trainer.create_train_state(model, tc)
    step = trainer.make_train_step(cfg, tc)
    (loss, _, grads), _, _ = counted(lambda: step.loss_and_grads(state, batch))
    plain = {"loss": float(loss), "norm": float(trainer.global_norm(grads))}
    plain_grads = {k: g.cpu() for k, g in grads.items()}
    del grads
    torch.cuda.reset_peak_memory_stats()   # both peaks: over the timed steps
    state, rec["plain_step_ms"], plain_norms = timed_steps("plain", step, state, plain_want)
    rec["plain_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    (state, _), rec["plain_trace"] = traced(lambda: step(state, batch))
    rec["plain"] = plain
    del state, step
    torch.cuda.empty_cache()

    def gate(label, stages, v):
        """One step's loss and gradients from the initial weights against
        the plain step's: the readings, and which gates they pass."""
        step = pp.make_pp_train_step(cfg, tc, mesh, num_microbatches=PP_MICROBATCHES,
                                     virtual_chunks=v, stages=stages)
        (loss, _, grads), ms, launches = counted(lambda: step.loss_and_grads(state, batch))
        cos = group_cosines(grads, plain_grads)
        norm = float(trainer.global_norm(grads))
        del grads, step
        torch.cuda.empty_cache()
        got = {"loss": float(loss), "loss_rel": abs(float(loss) - plain["loss"]) / plain["loss"],
               "norm": norm, "norm_rel": abs(norm - plain["norm"]) / plain["norm"],
               "cosines": cos, "launches": launches, "ms": ms}
        got["passed"] = {"loss": got["loss_rel"] <= PP_LOSS_RTOL,
                         "cosine": min(cos.values()) >= PP_COSINE_MIN,
                         "norm": got["norm_rel"] <= PP_NORM_RTOL}
        print(f"{label} vs the plain step (one step's loss and gradients) [{card}]: loss "
              f"{got['loss']:.6f} vs {plain['loss']:.6f} (rel {got['loss_rel']:.3g}, tol "
              f"{PP_LOSS_RTOL}), clip norm {norm:.6f} vs {plain['norm']:.6f} (rel "
              f"{got['norm_rel']:.3g}, tol {PP_NORM_RTOL}), cosine per group "
              + ", ".join(f"{g}: {c:.7f}" for g, c in cos.items())
              + f" (min {PP_COSINE_MIN}); passed {got['passed']}; launches {launches}",
              flush=True)
        return got

    state = pp.create_pp_train_state(model, tc, mesh, stages=MemoryStages(PP_STAGES))
    del model
    for v in PP_CHUNKS:
        rec[f"v{v}"] = gate(f"pipeline n={PP_STAGES}, v={v}, M={PP_MICROBATCHES}",
                            MemoryStages(PP_STAGES), v)
        if not all(rec[f"v{v}"]["passed"].values()) or rec[f"v{v}"]["launches"] != want:
            raise AssertionError(f"pipeline v={v}: {rec[f'v{v}']} (launches expected {want})")
    rec["fault"] = gate("planted fault (stale activations), v=1", stale_activations(PP_STAGES), 1)
    if any(rec["fault"]["passed"].values()):   # each gate must catch it on its own
        raise AssertionError(f"the planted fault passed a gate: {rec['fault']}")
    torch.cuda.reset_peak_memory_stats()
    for v in PP_CHUNKS:
        step = pp.make_pp_train_step(cfg, tc, mesh, num_microbatches=PP_MICROBATCHES,
                                     virtual_chunks=v, stages=MemoryStages(PP_STAGES))
        state, rec[f"v{v}"]["step_ms"], norms = timed_steps(f"pipeline v={v}", step, state,
                                                            want)
        if v == PP_CHUNKS[0]:   # the clip norm of the first step, from the initial weights
            rel = abs(norms[0] - plain_norms[0]) / plain_norms[0]
            rec["step1_clip_norm"] = {"pipeline": norms[0], "plain": plain_norms[0], "rel": rel}
            print(f"pipeline v={v}, step 1's clip norm {norms[0]:.6f} vs the plain step's "
                  f"{plain_norms[0]:.6f} (rel {rel:.3g}, tol {PP_NORM_RTOL}) [{card}]", flush=True)
            if rel > PP_NORM_RTOL:
                raise AssertionError(f"pipeline clip norm: {rec['step1_clip_norm']}")
            (state, _), rec["pipeline_trace"] = traced(lambda: step(state, batch))
        del step
        torch.cuda.empty_cache()
    rec["pp_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    mean = lambda ms: statistics.mean(ms[1:])  # noqa: E731
    print(f"train step, plain vs pipeline (MemoryStages({PP_STAGES}), M={PP_MICROBATCHES}, "
          f"tower chunks of {chunk} tiles) [{card}]: plain {mean(rec['plain_step_ms']):.1f} ms, "
          + ", ".join(f"v={v} {mean(rec[f'v{v}']['step_ms']):.1f} ms" for v in PP_CHUNKS)
          + f" (mean of steps 2-{TRAIN_STEPS}); launches a step {want} against the plain "
          f"{plain_want}; peak device memory {rec['plain_peak_gib']:.2f} (plain) / "
          f"{rec['pp_peak_gib']:.2f} GiB (pipeline)", flush=True)
    for label, t in (("plain", rec["plain_trace"]),
                     (f"pipeline v={PP_CHUNKS[0]}", rec["pipeline_trace"])):
        print(f"traced {label} step [{card}]: host {t['wall_ms']:.1f} ms, device busy "
              f"{t['busy_ms']:.1f} ms (idle share {t['idle_share']:.3f}), {t['activities']} "
              "device activities; by family " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(t["by_family_ms"].items(),
                                                     key=lambda kv: -kv[1])) + " ms", flush=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 41 took {rec['phase_s']:.1f} s", flush=True)
    return rec


def write_byte_tokenizer(directory, specials=None, bos="<|begin_of_text|>", eos="<|eot_id|>"):
    """A tokenizer.json whose ids are ByteTokenizer's on ASCII text: a
    character is its code point, the specials (by default the Llama-3
    specials and reserved tokens) their ids."""
    if specials is None:
        specials = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
                    "<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
                    "<|eot_id|>": 128009}
        specials.update({f"<|reserved_special_token_{k}|>": 128010 + k - 5
                         for k in range(5, 251)})
    vocab = {chr(i): i for i in range(32, 127)}
    vocab.update({"\n": 10, **specials})
    doc = {"version": "1.0", "truncation": None, "padding": None, "normalizer": None,
           "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                             "rstrip": False, "normalized": False, "special": True}
                            for t, i in specials.items()],
           "pre_tokenizer": {"type": "Split", "pattern": {"Regex": "[\\s\\S]"},
                             "behavior": "Isolated", "invert": False},
           "post_processor": None, "decoder": None,
           "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}
    directory.mkdir()
    (directory / "tokenizer.json").write_text(json.dumps(doc))
    (directory / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": bos, "eos_token": eos}))
    return str(directory)


def mesh_train_cli_phase(cli_rec, tmp, card):
    """Phase 40: the train CLI under torchrun with --mesh data=1 against
    phase 21's first loss."""
    import socket

    import torch

    from leopard_tpu_torch.cli import train_leopard_llava
    from leopard_tpu_torch.config import TrainConfig, leopard_llava_8b
    from leopard_tpu_torch.data.dataset import DataState, JsonlSftDataset, TrainDataLoader
    from leopard_tpu_torch.data.processor import LeopardProcessor
    from leopard_tpu_torch.data.tokenizer import build_tokenizer

    tok_dir = write_byte_tokenizer(tmp / "tokenizer")
    args = train_leopard_llava.parse_args(cli_rec["argv"])
    cfg = leopard_llava_8b()
    first = {}
    with contextlib.redirect_stdout(io.StringIO()):  # transformers lists the added tokens
        file_tok = build_tokenizer(tok_dir)
    for name, tok in (("file", file_tok), ("smoke", ByteTokenizer())):
        loader = TrainDataLoader(JsonlSftDataset(args.manifest, args.image_folder),
                                 LeopardProcessor(cfg, tok), batch_size=2, seq_len=TRAIN_SEQ,
                                 state=DataState(seed=TrainConfig().seed))
        first[name] = next(iter(loader)).tokens
    if not np.array_equal(first["file"], first["smoke"]):
        raise AssertionError("the tokenizer.json does not give ByteTokenizer's ids")
    argv = list(cli_rec["argv"])
    for flag, value in (("--tokenizer", tok_dir), ("--checkpoint-dir", str(tmp / "mesh_run")),
                        ("--train-steps", "1")):
        argv[argv.index(flag) + 1] = value
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
           "--master_addr=localhost", f"--master_port={port}",
           "-m", "leopard_tpu_torch.cli.train_leopard_llava", *argv, "--mesh", "data=1"]
    torch.cuda.empty_cache()  # the card's memory to the child, but for this process's tensors
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "done at step 1" not in proc.stdout:
        raise AssertionError(f"torchrun train CLI failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    with open(tmp / "mesh_run" / "metrics.jsonl") as f:
        (row,) = [json.loads(line) for line in f]
    ref = cli_rec["losses"][0]
    rel = abs(row["loss"] - ref) / abs(ref)
    print(f"train CLI under torchrun, --mesh data=1 (NCCL, world 1) [{card}]: first loss "
          f"{row['loss']:.6f} vs phase 21's {ref:.6f} (rel {rel:.3g}, tol "
          f"{TRAIN_CLI_LOSS_RTOL}); step {row['step_time'] * 1e3:.1f} ms; the whole command "
          f"{wall:.1f} s, this process holding {held:.2f} GiB meanwhile", flush=True)
    if rel > TRAIN_CLI_LOSS_RTOL:
        raise AssertionError(f"torchrun train CLI: first loss {row['loss']} vs {ref}")
    return {"loss": row["loss"], "phase21_loss": ref, "rel": rel, "step_ms": row["step_time"] * 1e3,
            "wall_s": wall}



# phases 42-44: expert parallelism and the rest of the sharded train step,
# at a world of one (one H100: no collective crosses two cards here)
EP_SIZES = (2, 4)                 # virtual expert ranks of phase 42 (b)
EP_CAP_FACTOR = 1.0               # the dense transport's drops at this factor
# the EP body against the single-device dispatch: the same rows through the
# same per-expert products in the same order, so bf16 agrees to its last
# bits; a planted fault (the reverse permutation skipped) reads far lower
EP_COSINE_MIN = 0.9999
EP_REPS = 3
MESH_MOE_RUNS = ("dropless", "capacity")


def ep_routing(moe, router_w, x, k):
    """moe_layer's router: (top_p [T, k] renormalized, top_i [T, k])."""
    logits = x.float() @ router_w.float().t()
    top_p, top_i = moe.router_top_k(logits, k)
    return top_p / top_p.sum(dim=-1, keepdim=True).clamp(min=1e-9), top_i


def host_drops(top_i, ep, cap, e):
    """The dense transport's kept assignments [T, k] and dropped count,
    worked out on the host from the routing: each virtual rank's slice
    sorted by expert (stable), the rows past `cap` for a destination
    dropped."""
    ids_all = top_i.cpu().numpy()
    t, k = ids_all.shape
    n, el = t // ep, e // ep
    keep = np.ones(t * k, bool)
    for r in range(ep):
        ids = ids_all[r * n:(r + 1) * n].reshape(-1)
        order = np.argsort(ids, kind="stable")
        dst = ids[order] // el
        for d in range(ep):
            keep[r * n * k + order[dst == d][cap:]] = False
    return keep.reshape(t, k), int((~keep).sum())


def ep_layer(moe, leaves, x, e, k, ep, cap, transport=None):
    """One MoE layer through the expert-parallel body over `ep` ranks
    (MemoryEP's virtual ranks, or a process group's transport): every rank's
    slice of x's rows, its block of the experts. Returns (out [T, H], the
    group's dropped rows)."""
    import torch

    top_p, top_i = ep_routing(moe, leaves["router"], x, k)
    transport = transport or moe.MemoryEP(ep)
    n, el = x.shape[0] // ep, e // ep
    banks = {r: {w: leaves[w][r * el:(r + 1) * el] for w in ("w_gate", "w_up", "w_down")}
             for r in transport.local}
    part = {r: slice(r * n, (r + 1) * n) for r in transport.local}
    out, dropped = moe.dispatch_ep(transport, banks, {r: x[s] for r, s in part.items()},
                                   {r: top_p[s] for r, s in part.items()},
                                   {r: top_i[s] for r, s in part.items()}, e, cap)
    return torch.cat([out[r] for r in transport.local]), dropped


def ep_dispatch_phase(model, card, device):
    """Phase 42: the expert-parallel dispatch on the card at the MoE model's
    widths, layer 0's weights, a seeded bf16 input of MOE_BATCH x MOE_SEQ
    tokens, against the single-device dropless dispatch (forward and
    backward: the input's, the router's and the three banks' gradients):
    (a) the body over the world-1 NCCL group (dispatch_ep with
    CollectiveEP: NCCL's all_to_all_single on the card), dense worst case and
    ragged, bit for bit; (b) the body for EP_SIZES virtual ranks in this
    process (MemoryEP), dense worst case, dense at EP_CAP_FACTOR (the
    reference's gates zeroed where the host's working drops a row; the
    dropped count equal to the host's) and ragged, by cosine >=
    EP_COSINE_MIN; ms a layer forward + backward beside the single device,
    and the bytes each transport puts on the wire per shard. Two planted
    faults: the receiving rank's reverse permutation skipped (the cosine
    gates must fail it) and the capacity taken from the whole batch's T·k
    in place of a shard's (the dropped-count gate must fail it)."""
    import torch
    import torch.distributed as dist

    from leopard_tpu_torch.ops import moe

    t_cfg = moe_config("dropless").text
    e, k, h = t_cfg.num_experts, t_cfg.moe_top_k, t_cfg.hidden_size
    layer = model.text.layers[0]
    base = {"router": layer.router.w, **dict(layer.experts.named_parameters())}
    g = torch.Generator(device=device).manual_seed(SEED + 42)
    t = MOE_BATCH * MOE_SEQ
    x0 = torch.randn((t, h), generator=g, device=device).to(layer.experts.w_gate.dtype)
    cot = torch.randn((t, h), generator=g, device=device)

    def run(fn):
        """fn(leaves, x) → (out, dropped); (out, grads, dropped, ms a layer
        forward + backward)."""
        def once():
            leaves = {n: v.detach().clone().requires_grad_() for n, v in base.items()}
            x = x0.clone().requires_grad_()
            out, dropped = fn(leaves, x)
            (out.float() * cot).sum().backward()
            return out.detach(), {"x": x.grad, **{n: v.grad for n, v in leaves.items()}}, dropped

        out, grads, dropped = once()
        ms = wall_s(once, reps=EP_REPS) * 1e3
        return out, grads, dropped, ms

    def single(keep=None):
        def fn(leaves, x):
            top_p, top_i = ep_routing(moe, leaves["router"], x, k)
            if keep is not None:
                top_p = top_p * keep
            banks = {w: leaves[w] for w in ("w_gate", "w_up", "w_down")}
            return moe._dropless_dispatch(banks, x, top_p, top_i), 0
        return fn

    def cosines(a, b):
        pairs = {"out": (a[0], b[0]), **{n: (a[1][n], b[1][n]) for n in a[1]}}
        return {n: cosine(p.reshape(-1).double(), q.reshape(-1).double(), dim=0).item()
                for n, (p, q) in pairs.items()}

    ref = run(single())
    rec = {"single_ms": ref[3], "card": card}
    # (a) the world-1 process group: NCCL's all-to-all on the card
    world = moe.CollectiveEP(dist.group.WORLD, 1, 0)
    for name, cap in (("dense", t * k), ("ragged", None)):
        got = run(lambda lv, x: ep_layer(moe, lv, x, e, k, 1, cap, world))
        equal = torch.equal(got[0], ref[0]) and all(torch.equal(got[1][n], ref[1][n])
                                                    for n in ref[1])
        cos = cosines(got, ref)
        rec[f"world1_{name}"] = {"bit_equal": equal, "cosines": cos, "ms": got[3]}
        print(f"EP dispatch over the world-1 NCCL group, {name}: out and gradients "
              f"{'bit-equal' if equal else 'not bit-equal'} to the single-device dispatch "
              f"(least cosine {min(cos.values()):.7f}); {got[3]:.2f} ms a layer forward + "
              f"backward vs {ref[3]:.2f} [{card}]", flush=True)
        if not equal and min(cos.values()) < EP_COSINE_MIN:
            raise AssertionError(f"EP world-1 {name}: cosines {cos}")
        del got
    # (b) virtual ranks in this process
    for ep in EP_SIZES:
        tk_local = t // ep * k
        for name in ("dense", f"dense_cf{EP_CAP_FACTOR:g}", "ragged"):
            ragged = name == "ragged"
            cap = None if ragged else moe.ep_capacity(
                tk_local, ep, EP_CAP_FACTOR if name != "dense" else 0.0)
            want_drop, keep = 0, None
            if cap is not None and cap < tk_local:
                with torch.no_grad():
                    _, top_i = ep_routing(moe, base["router"], x0, k)
                kept, want_drop = host_drops(top_i, ep, cap, e)
                keep = torch.from_numpy(kept).to(device)
            want = ref if keep is None else run(single(keep))
            got = run(lambda lv, x: ep_layer(moe, lv, x, e, k, ep, cap))
            cos = cosines(got, want)
            wire = (ep * cap if cap is not None else tk_local) * h * 2
            r = {"cosines": cos, "dropped": got[2], "dropped_host": want_drop,
                 "fraction_dropped": got[2] / (t * k), "ms": got[3], "capacity": cap,
                 "wire_bytes_per_shard": wire, "routed_bytes_per_shard": tk_local * h * 2}
            rec[f"ep{ep}_{name}"] = r
            print(f"EP body, {ep} virtual ranks, {name} (C {cap}): least cosine "
                  f"{min(cos.values()):.7f} (min {EP_COSINE_MIN}) over out and the gradients of "
                  f"x, router and the three banks; dropped {got[2]} (host {want_drop}); "
                  f"{got[3]:.2f} ms a layer forward + backward vs the single device's "
                  f"{ref[3]:.2f}; on the wire per shard {wire / 1e6:.1f} MB, routed "
                  f"{tk_local * h * 2 / 1e6:.1f} MB [{card}]", flush=True)
            if min(cos.values()) < EP_COSINE_MIN or got[2] != want_drop:
                raise AssertionError(f"EP body ep={ep} {name}: {r}")
            if name == "dense" and got[2]:
                raise AssertionError(f"EP body ep={ep}: the worst case dropped {got[2]}")
            del got, want
    # the planted faults: the permutation at 2 ranks (at 4 each rank holds
    # one expert, whose rows arrive in order), the capacity at 4
    real_experts, real_capacity = moe.ep_experts, moe.ep_capacity

    def unsorted(plan, dst, x_recv, id_recv, experts, par=None):
        sizes = plan.received(dst)
        y = moe._grouped(x_recv[torch.sort(id_recv, stable=True).indices[:sum(sizes)]],
                         experts, sizes)
        return torch.cat([y, y.new_zeros((x_recv.shape[0] - y.shape[0], y.shape[1]))])

    faults = {}
    try:
        moe.ep_experts = unsorted
        got = run(lambda lv, x: ep_layer(moe, lv, x, e, k, EP_SIZES[0], None))
        faults["reverse_permutation_skipped"] = min(cosines(got, ref).values())
        del got
    finally:
        moe.ep_experts = real_experts
    ep = EP_SIZES[-1]
    cap = moe.ep_capacity(t // ep * k, ep, EP_CAP_FACTOR)
    with torch.no_grad():
        _, top_i = ep_routing(moe, base["router"], x0, k)
    _, want_drop = host_drops(top_i, ep, cap, e)
    with torch.no_grad():
        _, fault_drop = ep_layer(moe, base, x0, e, k, ep,
                                 real_capacity(t * k, ep, EP_CAP_FACTOR))
    faults["capacity_from_whole_batch_dropped"] = (fault_drop, want_drop)
    print(f"EP planted faults: the reverse permutation skipped ({EP_SIZES[0]} virtual ranks, "
          f"ragged), least cosine {faults['reverse_permutation_skipped']:.5f} (must fall below "
          f"{EP_COSINE_MIN}); the capacity from the whole batch's T·k ({ep} ranks), dropped "
          f"{fault_drop} vs the host's {want_drop} (must differ) [{card}]", flush=True)
    if faults["reverse_permutation_skipped"] >= EP_COSINE_MIN or fault_drop == want_drop:
        raise AssertionError(f"EP planted faults passed a gate: {faults}")
    rec["faults"] = faults
    del ref, x0, cot
    torch.cuda.empty_cache()
    return rec


def live_cosines(a_grads, b_grads):
    """group_cosines over the groups whose gradient is not all zero in
    `b_grads` (a text-only batch leaves the tower's, a frozen group leaves
    its own at zero), and the names of the groups left out."""
    live = {n for n, g in b_grads.items() if bool(g.abs().max() > 0)}
    groups = {param_group(n) for n in live}
    cos = group_cosines({n: a_grads[n] for n in a_grads if param_group(n) in groups},
                        {n: b_grads[n] for n in b_grads if param_group(n) in groups})
    return cos, sorted({param_group(n) for n in b_grads} - groups)


def norm64(grads):
    """The gradients' global norm in float64: the clip norm without the fp32
    summation's error (`torch._foreach_norm` over a 4 M-element fp32 tensor
    is off in the fifth digit)."""
    import torch

    return float(torch.stack([g.double().square().sum() for g in grads.values()]).sum().sqrt())


def launch_counter(names):
    """(counters, counted(fn) → (fn(), ms, launches))."""
    import torch

    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm, fused_rms_norm

    every = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
             "fused_rms_norm": fused_rms_norm, "fused_layer_norm": fused_layer_norm}
    counters = {k: every[k] for k in names}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, {k: c.launches for k, c in counters.items()}

    return counters, counted


def mesh_gates(label, loss, ref_loss, cos, norm, ref_norm, launches, want, card, extra=""):
    """The sharded step's gates against the plain step's: loss rel, gradient
    cosine per group, clip norm rel, launches; returns the readings."""
    rel = abs(loss - ref_loss) / abs(ref_loss)
    norm_rel = abs(norm - ref_norm) / abs(ref_norm)
    print(f"{label} vs plain [{card}]: loss {loss:.6f} vs {ref_loss:.6f} (rel {rel:.3g}, tol "
          f"{MESH_LOSS_RTOL}), clip norm {norm:.6f} vs {ref_norm:.6f} (rel {norm_rel:.3g}, tol "
          f"{MESH_LOSS_RTOL}), cosine per group " + ", ".join(f"{g}: {v:.7f}"
                                                               for g, v in cos.items())
          + f" (min {MESH_COSINE_MIN}); launches {launches} (plain {want}){extra}", flush=True)
    if (rel > MESH_LOSS_RTOL or norm_rel > MESH_LOSS_RTOL or min(cos.values()) < MESH_COSINE_MIN
            or launches != want):
        raise AssertionError(f"{label}: loss rel {rel}, norm rel {norm_rel}, cosines {cos}, "
                             f"launches {launches} vs {want}")
    return {"loss": loss, "loss_rel": rel, "grad_norm": norm, "norm_rel": norm_rel,
            "cosines": cos, "launches": launches}


def moe_mesh_train_phase(model, batch, mesh, card):
    """Phase 43: phase 34's MoE step ("full"; dropless, then capacity at
    MOE_CAPACITY_FACTOR) through make_train_step(mesh=) on a world-1 mesh
    against the plain step from the same weights: loss (rel), aux and z
    loss (rel) and moe_fraction_dropped (equal), per-group gradient cosines,
    the mesh step's clip norm against the plain gradients' norm in float64
    (rel), K1/K2/K3a launches a step equal to the plain step's; 3 steps each, step ms and peak memory beside. Each path trains
    a twin of `model` (its tensors, not its Parameter objects), so `model`
    itself stays as it was."""
    import torch

    from leopard_tpu_torch.parallel.sharding import local_rows
    from leopard_tpu_torch.training import trainer

    lt = moe_config("dropless").text.num_layers
    want = {"flash_attention": 2 * lt, "flash_attention_bwd": lt, "fused_rms_norm": 2 * 2 * lt + 1}
    _, counted = launch_counter(want)
    rec = {}
    for mode in MESH_MOE_RUNS:
        cfg = moe_config(mode)
        tcfg = moe_train_config("full")
        runs = {}
        for path in ("plain", "mesh"):
            m = idefics2_twin(model, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if path == "plain":  # its own compute copy: `model`'s tensors are not written
                state = trainer.create_train_state(m, tcfg)
                step = trainer.make_train_step(cfg, tcfg)
                mine = batch
            else:
                state = trainer.create_train_state(m, tcfg, mesh=mesh)
                step = trainer.make_train_step(cfg, tcfg, mesh=mesh)
                mine = local_rows(batch, mesh, cfg.anyres.tokens_per_tile, cfg.image_token_id)
            (loss, metrics, grads), _, launches = counted(lambda: step.loss_and_grads(state, mine))
            r = {"loss": float(loss), "launches": launches,
                 **{k: float(metrics[k]) for k in ("moe_aux_loss", "moe_z_loss",
                                                   "moe_fraction_dropped")}}
            r["grads"], r["grad_norm64"] = grads, norm64(grads)
            del grads
            steps = []
            for i in range(MOE_STEPS):
                (state, metrics), ms, n = counted(lambda: step(state, mine))
                if n != want or not np.isfinite(float(metrics["loss"])):
                    raise AssertionError(f"MoE {mode} {path} step {i + 1}: launches {n}, loss "
                                         f"{float(metrics['loss'])}")
                steps.append({"ms": ms, "grad_norm": float(metrics["grad_norm"])})
            r.update(step_ms=[s["ms"] for s in steps], grad_norm=steps[0]["grad_norm"],
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            runs[path] = r
            del state, step, m
            torch.cuda.empty_cache()
        plain, mesh_run = runs["plain"], runs["mesh"]
        cos, left_out = live_cosines(mesh_run.pop("grads"), plain.pop("grads"))
        aux_rel = {k: abs(mesh_run[k] - plain[k]) / max(abs(plain[k]), 1e-30)
                   for k in ("moe_aux_loss", "moe_z_loss")}
        mean = lambda ms: statistics.mean(ms[1:])  # noqa: E731
        gates = mesh_gates(
            f"MoE {mode} step through make_train_step(mesh=)", mesh_run["loss"], plain["loss"],
            cos, mesh_run["grad_norm"], plain["grad_norm64"], mesh_run["launches"],
            plain["launches"], card,
            extra=f"; aux/z rel {aux_rel}, dropped {mesh_run['moe_fraction_dropped']} vs "
                  f"{plain['moe_fraction_dropped']}; groups without gradient {left_out}; step "
                  f"{mean(mesh_run['step_ms']):.1f} vs {mean(plain['step_ms']):.1f} ms (mean of "
                  f"steps 2-{MOE_STEPS}), peak {mesh_run['peak_gib']:.2f} vs "
                  f"{plain['peak_gib']:.2f} GiB")
        if (max(aux_rel.values()) > MESH_LOSS_RTOL
                or mesh_run["moe_fraction_dropped"] != plain["moe_fraction_dropped"]
                or plain["launches"] != want):
            raise AssertionError(f"MoE {mode} under the mesh: aux/z rel {aux_rel}, dropped "
                                 f"{mesh_run['moe_fraction_dropped']} vs "
                                 f"{plain['moe_fraction_dropped']}, launches {plain['launches']}")
        rec[mode] = {**gates, "aux_rel": aux_rel, "plain": plain, "mesh": mesh_run,
                     "launches_per_step": want, "step_ms": mean(mesh_run["step_ms"]),
                     "plain_step_ms": mean(plain["step_ms"])}
    return rec


def idefics2_mesh_phase(model, cfg, batches, mesh, card, plain_rec):
    """Phase 44: phase 32's Idefics2 step ("full", the perceiver frozen, no
    weight decay) through make_train_step(mesh=) at a world of one against
    the plain step from the same weights: loss, per-group gradient cosines
    (the frozen perceiver's are 0 on both sides and left out), the
    gradients' norm in float64 and the mesh step's own clip norm against
    the plain gradients',
    K1/K2/K3a/K3b launches equal to the plain step's (62/31/27/109); the
    same with grad_accum_steps=2 (one row a microbatch, images and masks
    pre-stacked) against the plain accumulation; a planted fault, the
    patch mask dropped from the mesh path's rows, which the cosine gate
    must fail; 3 steps of the mesh step, step ms and peak memory beside
    phase 32's plain "full" steps (`plain_rec`). The plain step's gradients
    wait on the host while the mesh state exists."""
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.parallel.sharding import local_rows
    from leopard_tpu_torch.training import trainer

    lt, lv, lp = cfg.text.num_layers, cfg.vision.num_layers, cfg.perceiver.num_layers
    want = {"flash_attention": 2 * (lt + lv), "flash_attention_bwd": lt + lv,
            "fused_rms_norm": 2 * 2 * lt + 1 + 3 * lp + 1, "fused_layer_norm": 2 * 2 * lv + 1}
    _, counted = launch_counter(want)
    device = model.text.lm_head.device
    dev = [to_device(b, device) for b in batches]
    first = dev[0]
    # the accumulation's batch: the first batch's two rows as two
    # microbatches, each row's images and masks stacked [2, tiles, ...]
    n_img = first["images"].shape[0] // 2
    acc = {**first, "images": first["images"].reshape(2, n_img, *first["images"].shape[1:]),
           "patch_mask": first["patch_mask"].reshape(2, n_img, *first["patch_mask"].shape[1:])}
    lat = cfg.perceiver.num_latents
    per_row = (first["tokens"] == cfg.image_token_id).sum(dim=1).tolist()
    if per_row != [n_img * lat] * 2:
        raise AssertionError(f"Idefics2 mesh: rows of {per_row} image tokens, not {n_img} "
                             "images each")
    tcfg = TrainConfig(seq_len=IDEFICS2_TRAIN_SEQ, global_batch_size=2, remat="full",
                       loss_chunk=1024, optimizer=OptimizerConfig(
                           lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0,
                           weight_decay=0.0))
    frozen = ("perceiver",)
    plain = {}
    state = trainer.create_train_state(model, tcfg)
    for name, accum, b in (("step", 1, first), ("accum", 2, acc)):
        step = trainer.make_train_step(cfg, tcfg, frozen=frozen, grad_accum_steps=accum,
                                       model=model)
        (loss, _, grads), ms, launches = counted(lambda: step.loss_and_grads(state, b))
        plain[name] = {"loss": float(loss), "grad_norm": norm64(grads), "launches": launches,
                       "ms": ms,
                       "grads": {k: g.cpu() for k, g in grads.items()}}
        del grads, step
    del state
    torch.cuda.empty_cache()
    if plain["step"]["launches"] != want:
        raise AssertionError(f"Idefics2 plain step: launches {plain['step']['launches']}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    twin = idefics2_twin(model, cfg)
    state = trainer.create_train_state(twin, tcfg, mesh=mesh)
    rows = lambda b, a=1: local_rows(b, mesh, lat, cfg.image_token_id, accum=a)  # noqa: E731
    rec = {}
    for name, accum, b in (("step", 1, rows(first)), ("accum", 2, rows(acc, 2)),
                           ("fault_no_patch_mask", 1,
                            {k: v for k, v in rows(first).items() if k != "patch_mask"})):
        step = trainer.make_train_step(cfg, tcfg, frozen=frozen, grad_accum_steps=accum,
                                       mesh=mesh)
        (loss, _, grads), ms, launches = counted(lambda: step.loss_and_grads(state, b))
        ref = plain["accum" if name == "accum" else "step"]
        cos, left_out = live_cosines(grads, ref["grads"])
        norm = norm64(grads)
        del grads
        if name == "fault_no_patch_mask":
            least = min(cos.values())
            rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
            print(f"Idefics2 mesh planted fault (the patch mask dropped from the rows) "
                  f"[{card}]: least cosine {least:.5f} (must fall below {MESH_COSINE_MIN}), "
                  f"loss rel {rel:.3g}", flush=True)
            if least >= MESH_COSINE_MIN:
                raise AssertionError(f"Idefics2 mesh: the dropped patch mask passed the "
                                     f"cosine gate: {cos}")
            rec[name] = {"cosines": cos, "loss_rel": rel}
            continue
        rec[name] = mesh_gates(
            f"Idefics2 {name} through make_train_step(mesh=)", float(loss), ref["loss"], cos,
            norm, ref["grad_norm"], launches, ref["launches"], card,
            extra=f"; groups without gradient {left_out}; {ms:.1f} vs {ref['ms']:.1f} ms")
        if name == "step" and launches != want:
            raise AssertionError(f"Idefics2 mesh step: launches {launches} vs {want}")
        del step
    step = trainer.make_train_step(cfg, tcfg, frozen=frozen, mesh=mesh)
    times = []
    for i, b in enumerate(dev):
        (state, metrics), ms, launches = counted(lambda: step(state, rows(b)))
        if launches != want or not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"Idefics2 mesh step {i + 1}: launches {launches}, loss "
                                 f"{float(metrics['loss'])}")
        if i == 0:  # the step's own clip norm, at the weights the gradients were taken at
            norm = float(metrics["grad_norm"])
            rel = abs(norm - plain["step"]["grad_norm"]) / plain["step"]["grad_norm"]
            print(f"Idefics2 mesh step 1's clip norm {norm:.6f} vs the plain gradients' "
                  f"{plain['step']['grad_norm']:.6f} (rel {rel:.3g}, tol {MESH_LOSS_RTOL}) "
                  f"[{card}]", flush=True)
            if rel > MESH_LOSS_RTOL:
                raise AssertionError(f"Idefics2 mesh step 1: clip norm rel {rel}")
            rec["step"]["step_clip_norm_rel"] = rel
        times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, step, twin
    torch.cuda.empty_cache()
    step_ms = statistics.mean(times[1:])
    rec.update(step_ms=times, step_ms_mean=step_ms, peak_gib=peak, launches_per_step=want,
               plain_step_ms_mean=plain_rec["step_ms"], plain_peak_gib=plain_rec["peak_memory_gib"])
    print(f"Idefics2 train step, plain (phase 32, full) vs mesh of one (world 1, NCCL) [{card}]: "
          f"{plain_rec['step_ms']:.1f} vs {step_ms:.1f} ms (mean of steps 2-{len(dev)}); launches "
          f"a step {want}; peak device memory {plain_rec['peak_memory_gib']:.2f} (plain) / "
          f"{peak:.2f} GiB (mesh)", flush=True)
    return rec


def idefics2_pp_launches(cfg, m_total, tower_chunks):
    """`pp_launches` for Leopard-Idefics2: the perceiver runs in each tower
    chunk's forward and again in the chunk checkpoint's recompute (3 RMSNorms
    a layer and the final one each time; its attention is not K1's)."""
    want = pp_launches(cfg, m_total, tower_chunks)
    want["fused_rms_norm"] += 2 * tower_chunks * (3 * cfg.perceiver.num_layers + 1)
    return want


def idefics2_pp_phase(model, cfg, batch, mesh, card, plain_rec):
    """Phase 46: phase 32's Idefics2 step ("full", the perceiver frozen, no
    weight decay) through make_pp_train_step with MemoryStages(PP_STAGES) at
    a world of one, PP_MICROBATCHES microbatches of one row, the tower and
    the perceiver in chunks of images / M: loss (rel PP_LOSS_RTOL) and
    gradient cosine per group (>= PP_COSINE_MIN; the frozen perceiver left
    out) against the plain make_train_step from the same weights; launches
    a step against `idefics2_pp_launches`, 3 steps, step ms and peak memory
    beside phase 32's plain "full" steps (`plain_rec`). A twin of `model`
    becomes the pipeline's DTensors: `model` stays."""
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.parallel.pipeline import MemoryStages
    from leopard_tpu_torch.training import pp, trainer

    t_phase = time.perf_counter()
    lt, lv, lp = cfg.text.num_layers, cfg.vision.num_layers, cfg.perceiver.num_layers
    device = model.text.lm_head.device
    b = to_device(batch, device)
    images = b["images"].shape[0]
    chunk = -(-images // PP_MICROBATCHES)
    want = idefics2_pp_launches(cfg, PP_MICROBATCHES, -(-images // chunk))
    plain_want = {"flash_attention": 2 * (lt + lv), "flash_attention_bwd": lt + lv,
                  "fused_rms_norm": 2 * 2 * lt + 1 + 3 * lp + 1,
                  "fused_layer_norm": 2 * 2 * lv + 1}
    _, counted = launch_counter(want)
    tcfg = TrainConfig(seq_len=IDEFICS2_TRAIN_SEQ, global_batch_size=2, remat="full",
                       loss_chunk=1024, optimizer=OptimizerConfig(
                           lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0,
                           weight_decay=0.0))
    frozen = ("perceiver",)
    state = trainer.create_train_state(model, tcfg)
    step = trainer.make_train_step(cfg, tcfg, frozen=frozen, model=model)
    (loss, _, grads), plain_ms, launches = counted(lambda: step.loss_and_grads(state, b))
    if launches != plain_want:
        raise AssertionError(f"Idefics2 plain step: launches {launches} vs {plain_want}")
    plain = {"loss": float(loss), "ms": plain_ms, "launches": launches,
             "step_ms_mean": plain_rec["step_ms"], "peak_gib": plain_rec["peak_memory_gib"]}
    plain_grads = {k: g.cpu() for k, g in grads.items()}
    del grads, state, step
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    twin = idefics2_twin(model, cfg)
    stages = MemoryStages(PP_STAGES)
    state = pp.create_pp_train_state(twin, tcfg, mesh, stages=stages)
    step = pp.make_pp_train_step(cfg, tcfg, mesh, num_microbatches=PP_MICROBATCHES,
                                 frozen=frozen, stages=MemoryStages(PP_STAGES))
    (loss, _, grads), ms, launches = counted(lambda: step.loss_and_grads(state, b))
    cos, left_out = live_cosines(grads, plain_grads)
    del grads, plain_grads
    rel = abs(float(loss) - plain["loss"]) / abs(plain["loss"])
    print(f"Idefics2 pipeline (MemoryStages({PP_STAGES}), M={PP_MICROBATCHES}, tower and "
          f"perceiver in chunks of {chunk} images) vs the plain step (one step's loss and "
          f"gradients) [{card}]: loss {float(loss):.6f} vs {plain['loss']:.6f} (rel {rel:.3g}, "
          f"tol {PP_LOSS_RTOL}), cosine per group " + ", ".join(
              f"{g}: {c:.7f}" for g, c in cos.items()) + f" (min {PP_COSINE_MIN}; left out "
          f"{left_out}); launches {launches} (expected {want}); {ms:.1f} vs {plain_ms:.1f} ms",
          flush=True)
    if rel > PP_LOSS_RTOL or min(cos.values()) < PP_COSINE_MIN or launches != want:
        raise AssertionError(f"Idefics2 pipeline: loss rel {rel}, cosines {cos}, launches "
                             f"{launches} vs {want}")
    times = []
    for i in range(TRAIN_STEPS):
        (state, metrics), t, launches = counted(lambda: step(state, b))
        if launches != want or not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"Idefics2 pipeline step {i + 1}: launches {launches}, loss "
                                 f"{float(metrics['loss'])}")
        times.append(t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, step, twin
    torch.cuda.empty_cache()
    mean = lambda ms: statistics.mean(ms[1:])  # noqa: E731
    rec = {"loss": float(loss), "loss_rel": rel, "cosines": cos, "left_out": left_out,
           "launches_per_step": want, "plain_launches_per_step": plain_want,
           "step_ms": times, "step_ms_mean": mean(times), "peak_gib": peak, "plain": plain,
           "tower_chunk": chunk,
           "phase_s": time.perf_counter() - t_phase}
    print(f"Idefics2 train step, plain (phase 32, full) vs pipeline [{card}]: "
          f"{plain['step_ms_mean']:.1f} vs "
          f"{rec['step_ms_mean']:.1f} ms (mean of steps 2-{TRAIN_STEPS}); launches a step "
          f"{want} against the plain {plain_want}; peak device memory {plain['peak_gib']:.2f} "
          f"(plain) / {peak:.2f} GiB (pipeline); phase 46 took {rec['phase_s']:.1f} s",
          flush=True)
    return rec


# phase 47: the blockwise "chunked" tier (plain PyTorch, a forced option on
# the card) on the train model's decoder against K1's forward
CHUNKED_ROWS = ((4096,), (2900,))


def chunked_tier_phase(cfg, card, device):
    """Phase 47: the decoder of Leopard-LLaVA-8B's widths at the train
    phase's depth, seeded weights, two rows of TRAIN_SEQ tokens (one with a
    padding tail), forward with text.attn_impl="chunked" (kv chunks of
    `attn_chunk_size`, no K1 launch) against "flash" (K1 a layer): logits'
    cosine per valid row >= COSINE_MIN, both forwards' ms and peak memory."""
    import torch

    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.ops.flash_attention import flash_attention

    t_phase = time.perf_counter()
    model = vlm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED + 47))
    dec = model.text
    g = torch.Generator(device=device).manual_seed(SEED + 47)
    tokens = torch.randint(1, cfg.text.vocab_size, (len(CHUNKED_ROWS), TRAIN_SEQ), generator=g,
                           device=device)
    seg = segments_of(CHUNKED_ROWS, TRAIN_SEQ, device)
    tokens = tokens * (seg != 0)
    out, rec = {}, {"rows": CHUNKED_ROWS, "chunk": None}
    for impl in ("flash", "chunked"):
        dec.cfg = dataclasses.replace(cfg.text, attn_impl=impl)
        flash_attention.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            logits, _ = dec(tokens, segment_ids=seg)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = flash_attention.launches
            ms = wall_s(lambda: dec(tokens, segment_ids=seg)) * 1e3
        out[impl] = logits.float()
        del logits
        rec[impl] = {"ms": ms, "peak_gib": peak, "k1_launches": launches}
    dec.cfg = cfg.text
    valid = seg != 0
    cos = []
    for r in range(len(CHUNKED_ROWS)):  # in float64: a fp32 sum over 0.5 G terms drifts
        dot, na, nb = cosine_sums(out["chunked"][r][valid[r]], out["flash"][r][valid[r]])
        cos.append(dot / max((na * nb) ** 0.5, 1e-30))
    from leopard_tpu_torch.ops.chunked_attention import pick_chunk

    rec.update(cosines=cos, chunk=pick_chunk(TRAIN_SEQ, cfg.text.attn_chunk_size),
               phase_s=time.perf_counter() - t_phase)
    print(f"chunked tier vs K1 (decoder of {cfg.text.num_layers} layers at 8B widths, rows "
          f"{CHUNKED_ROWS} of {TRAIN_SEQ}, kv chunks of {rec['chunk']}) [{card}]: logits "
          f"cosine per row {cos} (min {COSINE_MIN}); forward {rec['chunked']['ms']:.1f} ms "
          f"(K1 launches {rec['chunked']['k1_launches']}, peak {rec['chunked']['peak_gib']:.2f} "
          f"GiB) vs K1's {rec['flash']['ms']:.1f} ms (K1 launches "
          f"{rec['flash']['k1_launches']}, peak {rec['flash']['peak_gib']:.2f} GiB); phase 47 "
          f"took {rec['phase_s']:.1f} s", flush=True)
    if (min(cos) < COSINE_MIN or rec["chunked"]["k1_launches"] != 0
            or rec["flash"]["k1_launches"] != cfg.text.num_layers):
        raise AssertionError(f"chunked tier: {rec}")
    del model, dec, out
    torch.cuda.empty_cache()
    return rec


def idefics2_mesh_cli_phase(cli_rec, hf_dir, manifest, rows, cfg, tmp, card, device):
    """Phase 44, last: `python -m torch.distributed.run --nproc_per_node=1 -m
    leopard_tpu_torch.cli.train_leopard_idefics2 --mesh data=1` with phase
    33's flags (--init-from phase 25's checkpoint, --freeze-perceiver) and a
    tokenizer.json that gives Idefics2ByteTokenizer's ids (checked on the
    builder's first batch): the first loss equals phase 33's (rel
    TRAIN_CLI_LOSS_RTOL)."""
    import socket

    import torch

    from leopard_tpu_torch.data.tokenizer import build_tokenizer

    tok_dir = write_byte_tokenizer(
        tmp / "idefics2_tokenizer", specials={"<s>": 1, "</s>": 2, "<end_of_utterance>": 32002},
        bos="<s>", eos="</s>")
    with contextlib.redirect_stdout(io.StringIO()):
        file_tok = build_tokenizer(tok_dir, tokenizer_type="mistral", image_token="<image>")
    from leopard_tpu_torch.data.idefics2_batches import idefics2_batch

    first = {name: idefics2_batch(rows[:2], tok, cfg, IDEFICS2_TRAIN_SEQ,
                                  str(manifest.parent))["tokens"]
             for name, tok in (("file", file_tok), ("smoke", Idefics2ByteTokenizer()))}
    if not np.array_equal(first["file"], first["smoke"]):
        raise AssertionError("the tokenizer.json does not give Idefics2ByteTokenizer's ids")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
           "--master_addr=localhost", f"--master_port={port}",
           "-m", "leopard_tpu_torch.cli.train_leopard_idefics2", "--manifest", str(manifest),
           "--image-folder", str(manifest.parent), "--tokenizer", tok_dir, "--init-from",
           str(hf_dir), "--checkpoint-dir", str(tmp / "idefics2_mesh_run"), "--seq-len",
           str(IDEFICS2_TRAIN_SEQ), "--global-batch-size", "2", "--train-steps", "1", "--set",
           f"text.num_layers={cfg.text.num_layers}", "--freeze-perceiver", "--device",
           device.type, "--mesh", "data=1"]
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "done at step 1" not in proc.stdout:
        raise AssertionError(f"torchrun Idefics2 train CLI failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    with open(tmp / "idefics2_mesh_run" / "metrics.jsonl") as f:
        (row,) = [json.loads(line) for line in f]
    ref = cli_rec["losses"][0]
    rel = abs(row["loss"] - ref) / abs(ref)
    print(f"train_leopard_idefics2 under torchrun, --mesh data=1 (NCCL, world 1) [{card}]: "
          f"first loss {row['loss']:.6f} vs phase 33's {ref:.6f} (rel {rel:.3g}, tol "
          f"{TRAIN_CLI_LOSS_RTOL}); step {row['step_time'] * 1e3:.1f} ms; the whole command "
          f"{wall:.1f} s, this process holding {held_gib:.2f} GiB meanwhile", flush=True)
    if rel > TRAIN_CLI_LOSS_RTOL:
        raise AssertionError(f"torchrun Idefics2 train CLI: first loss {row['loss']} vs {ref}")
    return {"loss": row["loss"], "phase33_loss": ref, "rel": rel,
            "step_ms": row["step_time"] * 1e3, "wall_s": wall}


def int4_tp_blocks(device, card, flush):
    """Phase 3, K4 at every per-rank block of the 8B decoder's int4 leaves
    at model = 2, 4 and 8: each whole leaf is quantized once and cut by
    `ops/quant.py::int4_block`, as `tp_local_model` cuts it (a column
    block padded to whole 128-column tiles; a row block repacked
    split-half). Rank 0's block goes through `int4_vs_plain` at M = 1 and
    8 (its plain version, the fp32 oracle, tinygemm, times and bound);
    every rank's block goes through K4, and the column blocks' outputs
    concatenated, or the row blocks' partial products summed in fp32, are
    held against the whole leaf's K4 product. On one card no serving path
    runs at model > 1: the launches a rank would make are 7 x 32 + 1 a
    decode step, as at model = 1; the times of rank 0's blocks are summed
    into a decode step's per model size and M."""
    import torch

    from leopard_tpu_torch.models.params import QuantizedWeight
    from leopard_tpu_torch.ops import quant
    from leopard_tpu_torch.ops.int4_matmul import int4_matmul
    from leopard_tpu_torch.parallel.sharding import _chunk

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    out = []
    for leaf, (k, n, dim) in K4_TP_LEAVES.items():
        w = torch.randn((n, k), generator=g, device=device, dtype=torch.bfloat16) * k**-0.5
        whole = QuantizedWeight(quant.quantize_int4(w))
        del w
        xs = {m: torch.randn((m, k), generator=g, device=device, dtype=torch.bfloat16)
              for m in K4_TP_M}
        want = {m: int4_matmul(xs[m], whole.q4, whole.s)[:, :whole.n] for m in K4_TP_M}
        for tp in K4_TP_SIZES:
            cuts = [_chunk(whole.n if dim == "columns" else k, tp, r) for r in range(tp)]
            blocks = [QuantizedWeight(quant.int4_block(whole, dim, *c)) for c in cuts]
            for m in K4_TP_M:
                x = xs[m]
                if dim == "columns":
                    got = torch.cat([int4_matmul(x, b.q4, b.s)[:, :b.n] for b in blocks], 1)
                else:
                    got = sum(int4_matmul(x[:, lo:lo + size].contiguous(), b.q4, b.s)
                              for (lo, size), b in zip(cuts, blocks))
                torch.cuda.synchronize()
                err = (got - want[m]).abs().max().item()
                torch.testing.assert_close(got, want[m], **K4_ORACLE_TOL)
                b0 = blocks[0]
                rec = int4_vs_plain(f"{leaf}_tp{tp}_m{m}", m, 2 * b0.q4.shape[0], b0.q4.shape[1],
                                    device, card, flush, weight=b0, host=False)
                rec.update(leaf=leaf, tp=tp, m=m, cut=dim, true_n=b0.n,
                           ranks_vs_whole_max_abs_err=err)
                print(f"  {leaf} at model={tp}, M={m}: {tp} {dim} blocks, rank 0's "
                      f"{rec['shape']} (true N {b0.n}), "
                      f"{'concatenated' if dim == 'columns' else 'summed'} vs "
                      f"the whole leaf's K4 product: max |diff| {err:.3g} (tol "
                      f"{K4_ORACLE_TOL})", flush=True)
                out.append(rec)
        del whole, want, blocks
    per_step = {}
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "dense_ms")
    for tp in K4_TP_SIZES:
        for m in K4_TP_M:
            recs = {r["leaf"]: r for r in out if r["tp"] == tp and r["m"] == m}
            step = {key: (None if any(recs[x][key] is None for x in recs) else
                          sum(K4_TP_CALLS[x] * recs[x][key] for x in recs)) for key in keys}
            per_step[f"model{tp}_m{m}"] = step
            lib = "n/a" if step["library_ms"] is None else f"{step['library_ms']:.4f}"
            print(f"K4 per 8B decode step on one rank at model={tp}, M={m} "
                  f"({sum(K4_TP_CALLS[x] for x in recs)} calls): kernel {step['ms']:.4f} ms, "
                  f"bound {step['bound_ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, tinygemm "
                  f"{lib} ms, dense bf16 {step['dense_ms']:.4f} ms [{card}]", flush=True)
    return {"blocks": out, "per_step": per_step}


def clip_config(cfg):
    """`cfg` with the CLIP tower (config.clip_vit_large_336, 23 of 24
    layers run, the class token dropped: 576 tokens a 336-px tile), no
    pixel shuffle, and a projector from its 1,024 features."""
    from leopard_tpu_torch.config import clip_vit_large_336

    v = clip_vit_large_336()
    return dataclasses.replace(
        cfg, vision=v, pixel_shuffle_factor=1,
        projector=dataclasses.replace(cfg.projector, input_size=v.hidden_size),
        anyres=dataclasses.replace(cfg.anyres, tile_size=v.image_size,
                                   tokens_per_tile=v.tokens_per_tile))


def clip_model(model, ccfg, device):
    """A CLIP VLM on `model`'s decoder (shared, not copied): a new seeded
    tower (0.3 B) and projector."""
    import torch

    from leopard_tpu_torch.models.params import init_normal_
    from leopard_tpu_torch.models.projector import Projector
    from leopard_tpu_torch.models.siglip import SiglipVisionTower
    from leopard_tpu_torch.models.vlm import LeopardVLM

    g = torch.Generator(device=device).manual_seed(SEED + 48)
    clip = LeopardVLM(ccfg, device="meta")
    clip.vision = init_normal_(SiglipVisionTower(ccfg.vision, device=device), g)
    clip.projector = init_normal_(Projector(ccfg.projector, device=device), g)
    clip.text = model.text
    return clip


def clip_requests(cfg):
    """Phase 48's prompts, [BOS, 4 tiles' image tokens, text], and uint8
    tiles."""
    rng = np.random.RandomState(SEED + 48)
    n_img = CLIP_TILES_PER_REQUEST * cfg.anyres.tokens_per_tile
    prompts = [np.concatenate([[128000], np.full(n_img, cfg.image_token_id),
                               rng.randint(0, 128000, n)]).astype(np.int32) for n in CLIP_TEXT]
    size = cfg.vision.image_size
    tiles = rng.randint(0, 256, (len(CLIP_TEXT) * CLIP_TILES_PER_REQUEST, size, size, 3),
                        dtype=np.uint8)
    return prompts, tiles


def clip_hf_compare(ccfg, launches, card, device):
    """Phase 48, last: a seeded full-width transformers CLIPVisionModel
    (built on the card in bf16, sdpa) converted by `convert_clip_vision`
    into the port's tower, held against its hidden_states[-2][:, 1:]."""
    import torch
    from transformers import CLIPVisionConfig, CLIPVisionModel

    from leopard_tpu_torch.convert import hf as chf
    from leopard_tpu_torch.models.siglip import SiglipVisionTower

    v = ccfg.vision
    hcfg = CLIPVisionConfig(
        hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
        num_hidden_layers=v.num_layers, num_attention_heads=v.num_heads,
        num_channels=v.num_channels, image_size=v.image_size, patch_size=v.patch_size,
        layer_norm_eps=v.layer_norm_eps, hidden_act=v.hidden_act, attn_implementation="sdpa")
    torch.manual_seed(SEED + 48)
    with torch.device(device):
        hf = CLIPVisionModel(hcfg)
    hf = hf.to(torch.bfloat16).eval()
    tower = SiglipVisionTower(v, device="meta")
    tower.load_state_dict(chf.convert_clip_vision(hf.state_dict(), v, device=device),
                          strict=True, assign=True)
    if on_meta(tower):
        raise AssertionError(f"CLIP tower: left on the meta device: {on_meta(tower)[:5]}")
    g = torch.Generator(device=device).manual_seed(SEED + 48)
    pixels = torch.randn((CLIP_HF_TILES, 3, v.image_size, v.image_size), generator=g,
                         device=device).to(torch.bfloat16)
    with torch.inference_mode():
        want = hf(pixel_values=pixels, output_hidden_states=True).hidden_states[-2][:, 1:]
        with launches:
            got = tower(pixels)
    layers, norms = tower_run(v)
    expect("HF CLIP vs tower", launches.counts,
           {"flash_attention": layers, "fused_layer_norm": norms})
    cos = row_cosine(got[None], want[None])[0]
    tile_cos = min(row_cosine(got, want))
    rec = {"tiles": CLIP_HF_TILES, "cosine": cos, "tile_cosine_min": tile_cos,
           "max_abs_diff": (got.float() - want.float()).abs().max().item(),
           "launches": launches.counts}
    print(f"HF CLIPVisionModel (transformers, sdpa, bf16, 24 layers of 1,024) through "
          f"convert_clip_vision vs the port's tower on {CLIP_HF_TILES} tiles: "
          f"hidden_states[-2][:, 1:] cosine {cos:.6f} (min {HF_COSINE_MIN}), per tile min "
          f"{tile_cos:.6f}, max |diff| {rec['max_abs_diff']:.4g}; launches {launches.counts} "
          f"[{card}]", flush=True)
    del hf, tower, want, got
    if cos < HF_COSINE_MIN:
        raise AssertionError(f"HF CLIP disagrees with the port: cosine {cos}")
    return rec


def clip_serve_phase(model, cfg, launches, card, k1_checked, device):
    """Phase 48: the CLIP tower with phase 4's Leopard-LLaVA-8B decoder,
    served at full width: 2 requests of 4 uint8 336-px tiles and text
    (bucket 4,096), 16 greedy tokens, twice (repeatable), K1/K3a/K3b
    launches per generate (K1 23 + 32, K3b 1 + 2 x 23, K3a 65 a forward),
    TTFT, tower and decode times; the K1 path against the dense path; then
    a transformers CLIPVisionModel through convert_clip_vision."""
    import torch

    from leopard_tpu_torch.inference.engine import Engine

    t0 = time.perf_counter()
    ccfg = clip_config(cfg)
    clip = clip_model(model, ccfg, device)
    prompts, tiles = clip_requests(ccfg)
    n_tower = sum(p.numel() for p in clip.vision.parameters())
    print(f"CLIP VLM: the CLIP tower ({n_tower} parameters, bf16) and a projector, seeded, "
          f"on phase 4's Leopard-LLaVA-8B decoder; {len(prompts)} requests of "
          f"{CLIP_TILES_PER_REQUEST} tiles, {[len(p) for p in prompts]} tokens", flush=True)
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(ccfg, clip)
    held("CLIP serve", "K1", {("clip", engine._bucket(len(tiles), engine.tile_buckets))},
         k1_checked)
    rec = {"serve": serve(engine, ccfg, prompts, tiles, card, "serve CLIP bf16")}
    del engine
    clip.text._head_f32 = None
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["cosine_vs_dense"], rec["argmax_agrees"] = kernel_vs_dense_end_to_end(
        clip, ccfg, prompts[0], tiles, device)
    del clip
    rec["hf"] = clip_hf_compare(ccfg, launches, card, device)
    rec["phase_s"] = time.perf_counter() - t0
    t = rec["serve"]
    print(f"phase 48 (CLIP serving) took {rec['phase_s']:.1f} s: TTFT "
          f"{t['ttft_s'] * 1e3:.1f} ms, tower {t['vision_tower_s'] * 1e3:.1f} ms, decode "
          f"{t['decode_ms_per_step']:.2f} ms/step, peak device memory "
          f"{rec['peak_memory_gib']:.2f} GiB while serving [{card}]", flush=True)
    return rec


def clip_train_phase(tcfg, card, device):
    """Phase 49: phase 20's step (8B widths, text depth 4, "full") with the
    CLIP tower in place of SigLIP, 2 tiles a sample, weight decay 0.1:
    TRAIN_STEPS steps of train(), K1 2 x (23 + 4) and K2 23 + 4 a step,
    and the tower's unrun last layer moved by the decay alone."""
    import torch

    from leopard_tpu_torch.models import vlm

    t0 = time.perf_counter()
    ccfg = clip_config(tcfg)
    model = vlm.init_params(ccfg, torch.Generator(device=device).manual_seed(SEED))
    batch = train_batch(ccfg, device, tiles_per_sample=CLIP_TRAIN_TILES_PER_SAMPLE)
    print(f"CLIP train model: 8B widths, {ccfg.text.num_layers} of 32 text layers, the CLIP "
          f"tower, {sum(p.numel() for p in model.parameters())} parameters; "
          f"{batch['images'].shape[0]} tiles of {CLIP_TOKENS} tokens", flush=True)
    rec = train_phase(model, ccfg, batch, card, weight_decay=CLIP_WEIGHT_DECAY,
                      label="CLIP train")
    del model, batch
    rec["phase_s"] = time.perf_counter() - t0
    print(f"phase 49 (CLIP training) took {rec['phase_s']:.1f} s", flush=True)
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

    # the manifest of phases 32-33 and its batches, built now, so that phase
    # 3 holds K1 and K2 at their shapes
    train_tmp = tempfile.TemporaryDirectory(prefix="leopard_idefics2_train_")
    dcfg = dataclasses.replace(icfg, text=dataclasses.replace(
        icfg.text, num_layers=IDEFICS2_TEXT_LAYERS))
    t0 = time.perf_counter()
    i2_manifest, i2_rows = write_idefics2_manifest(Path(train_tmp.name) / "manifest")
    i2_batches = idefics2_train_batches(dcfg, i2_rows, i2_manifest.parent)
    i2_k1, i2_k2 = idefics2_train_shapes(dcfg, i2_batches)
    print(f"Idefics2 train manifest written and {IDEFICS2_TRAIN_STEPS} batches built in "
          f"{time.perf_counter() - t0:.2f} s: rows of {[row_lengths(b) for b in i2_batches]} "
          f"tokens, images {[b['patch_mask'].shape for b in i2_batches]}", flush=True)

    # phase 3: kernel against its plain version at the serving path's shapes
    # (Leopard-LLaVA's, then those of the Idefics2 phases 22-25, of the eval
    # phases 26-29 and of the Idefics2 train phases 32-33)
    k1_shapes = {**K1_SHAPES, **idefics2_k1_shapes(icfg), **eval_shapes, **i2_k1,
                 **moe_k1_shapes()}
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
    k2 = {name: flash_bwd_vs_plain(name, device=device, card=card, **kw)
          for name, kw in k2_shapes(text, vis).items()}
    k2_idefics2 = {name: flash_bwd_vs_plain(name, device=device, card=card, **kw)
                   for name, kw in i2_k2.items()}
    k2_checked = k2_held(i2_k2)
    # K2 at the MoE train batch's shape (phase 34), head dim 64, by cosine too
    k2_moe = flash_bwd_vs_plain("moe_train", device=device, card=card,
                                **moe_k1_shapes()["moe_train"])
    ln_shapes = k3b_shapes()
    k3b = lambda name: norm_vs_plain("ln", *ln_shapes[name][:2], device, card, flush,  # noqa: E731
                                     eps=ln_shapes[name][2])
    k3 = {"rms": norm_vs_plain("rms", len(TRAIN_ROWS) * TRAIN_SEQ, text.hidden_size, device,
                               card, flush),
          "ln": k3b("train_tower_16_tiles")}
    # K3b at the serving path's rows: phase 4's 2 requests of 16 tiles in one
    # tower call
    k3_serve = k3b("serve_2x16_tiles")
    image_errs = image_ops_vs_cpu(device)
    # K3 at the Idefics2 encode's new rows: phase 22's eight images of 4,900
    # patches through the perceiver's context norm and the tower's LayerNorms
    navit_rows = k1_shapes["navit_b8"]["b"] * k1_shapes["navit_b8"]["s"]
    if ln_shapes["navit_8_images"][0] != navit_rows:
        raise AssertionError(f"k3b_shapes: {ln_shapes['navit_8_images']}, phase 22's rows "
                             f"{navit_rows}")
    k3_idefics2 = {"rms": norm_vs_plain("rms", navit_rows, icfg.perceiver.hidden_size, device,
                                        card, flush, eps=icfg.perceiver.rms_norm_eps),
                   "ln": k3b("navit_8_images")}
    # K3a at the MoE train batch's rows, width 2,048 (phase 34)
    k3_moe = norm_vs_plain("rms", MOE_BATCH * MOE_SEQ, MOE_SHAPE["hidden"], device, card, flush)
    # K3 at the pipeline's rows (phase 41): K3a on one microbatch's row,
    # K3b on one tower chunk of tiles / M
    k3_pp = {"rms": norm_vs_plain("rms", len(TRAIN_ROWS) // PP_MICROBATCHES * TRAIN_SEQ,
                                  text.hidden_size, device, card, flush),
             "ln": k3b("pipeline_tower_chunk")}
    # K4 at the int4 Idefics2 head (phase 36): Mistral's 32,003 columns held
    # padded to whole 128-column tiles, K = 4,096, one request's decode
    k4_mistral_head = int4_vs_plain("mistral_head_m1", 1, icfg.text.hidden_size,
                                    MISTRAL_HEAD_PADDED, device, card, flush)
    # the CLIP tower of phases 48-49: K2 at its 8 tiles of 577 tokens (K1 is
    # in k1_shapes), K3b at its rows with eps 1e-5
    t0 = time.perf_counter()
    k2_clip = flash_bwd_vs_plain("clip_tower", device=device, card=card, **K1_SHAPES["clip_b8"])
    k3_clip = k3b("clip_tower_8_tiles")
    # K4 at every per-rank block of the 8B int4 leaves, model = 2, 4, 8
    k4_tp = int4_tp_blocks(device, card, flush)
    print(f"phase 3, the CLIP shapes and the per-rank K4 blocks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
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

    # phase 48: the CLIP tower on phase 4's decoder, served at full width
    launches = Launches()
    clip_rec = {"serve": clip_serve_phase(model, cfg, launches, card, k1_checked, device)}
    peak["clip_serve"] = phase_memory("CLIP serve")

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

    # phase 39: Engine(mesh=) at a world of one, bf16 and int4
    mesh = world_one_mesh()
    mesh_rec = {"serve": mesh_serve_phase(model, cfg, prompts, tiles, mesh, card, timings,
                                          timings_int4)}
    peak["mesh_serve"] = phase_memory("serve under a mesh")

    # phases 10-14: prefixes, multi-turn chat, chunked prefill, int4 + int8
    # KV over a second turn, speculative decode and beam search
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
        peak["train_policies"] = phase_memory("train under attn / selective")
        # phase 37: the sharded train step at a world of one (its model's
        # parameters become DTensors: the last phase on this model)
        mesh_rec["train"] = mesh_train_phase(model, tcfg, batch, mesh, card)
        del model
        peak["mesh_train"] = phase_memory("train under a mesh")
        # phase 38: the ring's block arithmetic through K1/K2
        mesh_rec["ring"] = ring_kernels_phase(device, card)
        peak["ring"] = phase_memory("ring blocks")
        # phase 45: the same with Mistral's window, K1/K2 taking each
        # block's q - kv offset
        mesh_rec["ring_window"] = ring_window_phase(device, card)
        peak["ring_window"] = phase_memory("windowed ring blocks")
        # phase 41: phase 20's step through the 1F1B pipeline (a new model
        # from the same seed)
        mesh_rec["pp"] = pp_train_phase(tcfg, batch, mesh, card, device)
        del batch
        peak["pp_train"] = phase_memory("train through the pipeline")
        # phase 47: the blockwise "chunked" tier against K1 on a new model of
        # the same widths and depth
        features["chunked_tier"] = chunked_tier_phase(tcfg, card, device)
        peak["chunked_tier"] = phase_memory("chunked tier vs K1")
        # phase 49: phase 20's step with the CLIP tower (a new model)
        clip_rec["train"] = clip_train_phase(tcfg, card, device)
        peak["clip_train"] = phase_memory("CLIP train")

        # phase 21: the train CLI from a manifest, --init-from phase 19's
        # checkpoint, through the data pipeline
        features["train_cli"] = train_cli_phase(hf_dir, card, Path(tmp), device)
        peak["train_cli"] = phase_memory("train CLI")
        # phase 40: the same CLI under torchrun with --mesh data=1
        mesh_rec["train_cli"] = mesh_train_cli_phase(features["train_cli"], Path(tmp), card)

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
    # phase 36: phase 22's request with int4 weights, the head through K4
    idefics2["int4"] = idefics2_int4_phase(model, icfg, launches, card)
    peak["idefics2_int4"] = phase_memory("Idefics2 int4")
    idefics2["hf"] = idefics2_hf_phase(model, icfg, launches, card, device, k1_checked)
    peak["idefics2_hf"] = phase_memory("Idefics2 HF conversion and transformers")
    # phase 27 (eval B): the eval harness on Leopard-Idefics2-8B
    evals["idefics2"] = idefics2_eval_phase(model, icfg, launches, card, k1_checked, eval_root)
    peak["eval_idefics2"] = phase_memory("eval Idefics2-8B")
    eval_tmp.cleanup()
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="leopard_smoke_") as tmp:
        idefics2["checkpoint"] = idefics2_checkpoint_phase(dcfg, launches, card, Path(tmp),
                                                           device, k1_checked)
        peak["idefics2_checkpoint"] = phase_memory(
            "Idefics2 checkpoint and the convert, serve CLIs")

        # phase 32: the Idefics2 train step at 8B widths, text depth 4
        model = idefics2_model(dcfg, device)
        n_train = sum(p.numel() for p in model.parameters())
        print(f"Idefics2 train model: 8B widths, {IDEFICS2_TEXT_LAYERS} of 32 text layers, "
              f"27 tower and 3 perceiver layers, {n_train} parameters", flush=True)
        i2_train = {"grads_vs_dense": idefics2_grads_vs_dense(model, dcfg, i2_batches[0], card)}
        peak["idefics2_train_grads"] = phase_memory("Idefics2 train, K1 + K2 vs dense")
        i2_train["remat"] = idefics2_train_phase(model, dcfg, i2_batches, card, k1_checked,
                                                 k2_checked)
        peak["idefics2_train"] = phase_memory("Idefics2 train")
        # phase 44: the same step through make_train_step(mesh=), at a world
        # of one (a twin of the model becomes DTensors: `model` stays)
        t0 = time.perf_counter()
        mesh_rec["idefics2"] = idefics2_mesh_phase(model, dcfg, i2_batches, mesh, card,
                                                   i2_train["remat"]["full"])
        phase44_s = time.perf_counter() - t0
        # phase 46: the same step through the 1F1B pipeline (MemoryStages)
        mesh_rec["idefics2_pp"] = idefics2_pp_phase(model, dcfg, i2_batches[0], mesh, card,
                                                    i2_train["remat"]["full"])
        peak["idefics2_pp"] = phase_memory("Idefics2 train through the pipeline")
        del model
        peak["idefics2_mesh_train"] = phase_memory("Idefics2 train under a mesh")

        # phase 33: the train_leopard_idefics2 CLI on phase 25's checkpoint
        i2_train["cli"] = idefics2_train_cli_phase(
            Path(tmp) / "idefics2_hf", i2_manifest, i2_rows, dcfg, card, Path(tmp), device,
            k1_checked, k2_checked)
        peak["idefics2_train_cli"] = phase_memory("Idefics2 train CLI")
        # phase 44, last: that CLI under torchrun with --mesh data=1
        t0 = time.perf_counter()
        mesh_rec["idefics2_cli"] = idefics2_mesh_cli_phase(
            i2_train["cli"], Path(tmp) / "idefics2_hf", i2_manifest, i2_rows, dcfg, Path(tmp),
            card, device)
        mesh_rec["idefics2"]["phase_s"] = phase44_s + time.perf_counter() - t0
    train_tmp.cleanup()
    idefics2["train"] = i2_train
    features["idefics2"] = idefics2

    # phases 34-35: the MoE decoder with tied embeddings at tools/bench_moe.py's
    # full width, trained under both dispatches and both policies, then served
    t0 = time.perf_counter()
    model = vlm.init_params(moe_config("dropless"),
                            torch.Generator(device=device).manual_seed(SEED))
    batch = moe_batch(device)
    moe_rec = {"dropless_vs_capacity": moe_dropless_vs_capacity(model, batch, card, device)}
    moe_rec["train"] = moe_train_phase(model, batch, card)
    del batch
    peak["moe_train"] = phase_memory("MoE train")
    moe_rec["serve"] = moe_serve_phase(model, card, device)
    peak["moe_serve"] = phase_memory("MoE serve")
    moe_rec["phases_s"] = time.perf_counter() - t0
    print(f"MoE phases 34-35 took {moe_rec['phases_s']:.1f} s", flush=True)
    features["moe"] = moe_rec

    # phases 42-43: the expert-parallel dispatch on layer 0's weights, then
    # the MoE step through make_train_step(mesh=) (the last use of the model)
    t0 = time.perf_counter()
    mesh_rec["ep"] = ep_dispatch_phase(model, card, device)
    peak["ep_dispatch"] = phase_memory("EP dispatch")
    batch = moe_batch(device)
    mesh_rec["moe_train"] = moe_mesh_train_phase(model, batch, mesh, card)
    del batch, model
    peak["moe_mesh_train"] = phase_memory("MoE train under a mesh")
    mesh_rec["ep"]["phases_42_43_s"] = time.perf_counter() - t0
    print(f"phases 42-43 took {mesh_rec['ep']['phases_42_43_s']:.1f} s; phase 44 "
          f"{mesh_rec['idefics2']['phase_s']:.1f} s with its torchrun run "
          f"{mesh_rec['idefics2_cli']['wall_s']:.1f} s", flush=True)

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
    per_idefics2_step = ((dcfg.text.num_layers, k2_idefics2[f"mistral_train_{IDEFICS2_TRAIN_SEQ}"]),
                         (dcfg.vision.num_layers,
                          k2_idefics2[f"navit_b{len(IDEFICS2_IMAGES)}"]))

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

    def idefics2_train_paths(name):
        """A kernel's launches a step of phase 32 under each policy and over
        phase 33's unbroken run."""
        return {"launches_idefics2_train_step_by_remat": {
                    p: r["launches_per_step"][name] for p, r in i2_train["remat"].items()},
                "launches_idefics2_train_cli": i2_train["cli"]["launches"][0][name]}

    def moe_paths(name):
        """A kernel's launches a step of phase 34 per (dispatch, recompute)
        and in one generate of phase 35."""
        return {"launches_moe_train_step_by_run": {
                    run: r["launches_per_step"].get(name, 0)
                    for run, r in features["moe"]["train"]["runs"].items()},
                "launches_moe_generate": features["moe"]["serve"]["launches"].get(name, 0)}

    def mesh_paths(name):
        """A kernel's launches on phases 37-39's, 41's and 43-44's paths: a
        mesh train step (flash and ring), a ring pass of phase 38 per n, a
        generate under the mesh (bf16), a pipeline train step per v, the MoE
        step under the mesh per dispatch, the Idefics2 step under the mesh
        (one step, and two microbatches)."""
        runs = mesh_rec["train"]["runs"]
        out = {"launches_mesh_train_step": runs["mesh"]["launches"].get(name, 0),
               "launches_mesh_ring_train_step": runs["mesh_ring"]["launches"].get(name, 0),
               "launches_mesh_generate": mesh_rec["serve"]["bf16"]["mesh"]["launches"].get(
                   name, 0),
               "launches_pp_train_step": {f"v{v}": mesh_rec["pp"][f"v{v}"]["launches"][name]
                                          for v in PP_CHUNKS},
               "launches_moe_mesh_train_step": {
                   mode: mesh_rec["moe_train"][mode]["launches"].get(name, 0)
                   for mode in MESH_MOE_RUNS},
               "launches_idefics2_mesh_train_step": mesh_rec["idefics2"]["step"]["launches"].get(
                   name, 0),
               "launches_idefics2_mesh_accum_step": mesh_rec["idefics2"]["accum"]["launches"].get(
                   name, 0)}
        out["launches_idefics2_pp_train_step"] = mesh_rec["idefics2_pp"]["launches_per_step"][
            name]
        if name.startswith("flash_attention"):
            out["launches_ring_pass"] = {n: mesh_rec["ring"][f"n{n}"]["launches"][name]
                                         for n in RING_SIZES}
            out["launches_windowed_ring_pass"] = {
                n: mesh_rec["ring_window"][f"n{n}"]["launches"][name] for n in RING_SIZES}
        return out

    def clip_paths(name):
        """A kernel's launches in one CLIP generate (phase 48) and a CLIP
        train step (phase 49)."""
        return {"launches_clip_generate": clip_rec["serve"]["serve"]["launches"].get(name, 0),
                "launches_clip_train_step": clip_rec["train"]["launches_per_step"].get(name, 0)}

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
        "launches_chunked_tier_forward": features["chunked_tier"]["chunked"]["k1_launches"],
        **mesh_paths("flash_attention"),
        **new_paths("flash_attention"),
        **eval_paths("flash_attention"),
        **remat_paths("flash_attention"),
        **idefics2_train_paths("flash_attention"),
        **moe_paths("flash_attention"),
        "moe_shapes": [per_shape["moe_train"], per_shape["moe_serve"]],
        **clip_paths("flash_attention"),
        "clip_shape": per_shape["clip_b8"],
        "idefics2": {
            "launches_per_generate": idefics2["serve"]["launches"]["flash_attention"],
            "launches_int4_generate": idefics2["int4"]["launches"]["flash_attention"],
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
        "offset_shapes": [{key: blk[key] for key in (
            "n", "kind", "band", "offset", "pairs", "k1_ms", "k1_plain_ms", "k1_bound_ms",
            "k1_bound_by", "k1_library_ms", "errs")} for blk in mesh_rec["ring_window"]["blocks"]],
        "offset_shapes_is": (f"phase 45: one ring block of [1, S/2n, 32/8, 128] at each "
                             f"(n, q - kv offset) the windowed ring keeps, window {RING_WINDOW}; "
                             "library: SDPA with the block's band as a boolean mask"),
        "windowed_ring_whole_call": {key: mesh_rec["ring_window"][key] for key in (
            "whole_fwd_ms", "whole_fwd_bound_ms", "library_fwd_ms")},
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
                                                       *k4_m1.values(), *k4_tp["blocks"]]),
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
        "launches_idefics2_int4_generate": idefics2["int4"]["launches"]["int4_matmul"],
        "launches_mesh_generate_int4": mesh_rec["serve"]["int4"]["mesh"]["launches"][
            "int4_matmul"],
        "launches_idefics2_int4_head": idefics2["int4"]["head_k4_launches"],
        "idefics2_int4": idefics2["int4"],
        "mistral_head_shape": k4_mistral_head,
        "tp_blocks": k4_tp,
        "tp_blocks_is": ("phase 3: rank 0's block of each 8B int4 leaf at model = 2, 4, 8 and "
                         "M = 1, 8 (ops/quant.py::int4_block); ranks_vs_whole_max_abs_err: "
                         "every rank's K4 output, concatenated (columns) or summed in fp32 "
                         "(rows), against the whole leaf's; not on a path of this one-card "
                         "run, where a rank would launch K4 7 x 32 + 1 times a decode step"),
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
        "max_abs_err": max(r["max_abs_err"] for r in [*k2.values(), *k2_idefics2.values(),
                                                       k2_moe, k2_clip]),
        "clip_shape": k2_clip,
        **clip_paths("flash_attention_bwd"),
        **moe_paths("flash_attention_bwd"),
        "moe_shape": k2_moe,
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
        **mesh_paths("flash_attention_bwd"),
        **remat_paths("flash_attention_bwd"),
        **idefics2_train_paths("flash_attention_bwd"),
        "idefics2": {
            **{key: total(per_idefics2_step, key)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms", "library_attended_ms")},
            "bound_by": bound_by(per_idefics2_step),
            "ms_is": f"per Idefics2 train step: {dcfg.text.num_layers} x mistral_train_"
                     f"{IDEFICS2_TRAIN_SEQ} + {dcfg.vision.num_layers} x navit_b8 (phase 3)",
            "k2_ms_per_step_in_train": {p: r["k2_ms_per_step"]
                                        for p, r in i2_train["remat"].items()},
            "shapes": list(k2_idefics2.values()),
            "train": i2_train,
        },
        "shapes": list(k2.values()),
        "offset_shapes": [{key: blk[key] for key in (
            "n", "kind", "band", "offset", "pairs", "k2_ms", "k2_plain_ms", "k2_bound_ms",
            "k2_bound_by", "k2_library_ms", "errs")} for blk in mesh_rec["ring_window"]["blocks"]],
        "windowed_ring_whole_call": {key: mesh_rec["ring_window"][key] for key in (
            "whole_bwd_ms", "whole_bwd_bound_ms")},
        "card": card,
        "train": train_run,
        "train_grads_vs_dense": grads_check,
    }, *[{
        "name": name,
        "route": route,
        "source": source,
        "replaces": f"leopard_tpu/ops/pallas/norms.py:{line}",
        "launches": train_run["launches"][name],
        "launches_per_generate": timings["launches"][name],
        "launches_per_idefics2_generate": idefics2["serve"]["launches"][name],
        **mesh_paths(name),
        "launches_serving_features": {phase: rec["launches"][name] for phase, rec in
                                      features.items() if "launches" in rec},
        **new_paths(name),
        **eval_paths(name),
        **idefics2_train_paths(name),
        **moe_paths(name),
        "max_abs_err": k3[kind]["max_abs_err"],
        "ms": k3[kind]["ms"],
        "plain_ms": k3[kind]["plain_ms"],
        "bound_ms": k3[kind]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k3[kind]["library_ms"],
        "library": library,
        "ms_is": f"per call at {k3[kind]['shape']}",
        "idefics2_shape": k3_idefics2[kind],
        "moe_shape": k3_moe if kind == "rms" else None,
        "clip_shape": k3_clip if kind == "ln" else None,
        "serve_shape": k3_serve if kind == "ln" else None,
        "bound_share": k3[kind]["bound_share"],
        **clip_paths(name),
        "pp_shape": k3_pp[kind],
        "card": card,
    } for name, kind, line, library, route, source in (
        ("fused_rms_norm", "rms", 54, "F.rms_norm", "triton",
         "leopard_tpu_torch/ops/fused_norms.py"),
        ("fused_layer_norm", "ln", 88, "F.layer_norm", "cuda",
         "leopard_tpu_torch/csrc/layer_norm.cu"))]]}
    torch.distributed.destroy_process_group()
    print(json.dumps({"mesh": mesh_rec}), flush=True)
    print(json.dumps({"serving_features": features}), flush=True)
    print(json.dumps({"eval": evals}), flush=True)
    print(json.dumps({"clip": clip_rec}), flush=True)
    print(json.dumps({"image_ops_max_diff_vs_cpu": image_errs}), flush=True)
    print(smi.splitlines()[0], flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
