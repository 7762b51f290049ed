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
     bf16 at the serving path's shapes (vision tower and decoder prefill); K2 at the
     train path's shapes (the decoder's packed two-segment rows with a
     padding tail, the tower's 16 tiles at head dim 72); K3a/K3b at the
     train path's rows, (8192, 4096) RMSNorm and (16·676, 1152) LayerNorm,
     cold L2;
     K4 at the 8B decode shapes (M = 2, and M = 64 once, cold L2) against its
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
 10. training at the width of Leopard-LLaVA-8B with the text depth cut to 4
     of 32 (the 8B train state, ~18 B a parameter, does not fit one 80 GB
     card), seeded random weights, 2 rows × 4,096 tokens each packing two
     samples (positions restarting per segment, a padding tail) with 16
     tiles: first one step's gradients through K1 + K2 against the same
     step with dense attention in text and tower (cosine per parameter
     group), then 3 steps of `train()` (full recompute, chunked
     cross-entropy, AdamW with warmup from 0): loss and grad norm finite,
     params unchanged by step 1 (lr 0) and changed by steps 2-3, the K1, K2
     and K3 launch counts of every step against the layer counts, no K1/K2
     input copied, step ms,
     tokens/s and peak memory;
 11. no JAX was imported.
Each engine is freed after its phase, with the phase's peak device memory
printed. Then the card's name and power limit as nvidia-smi prints them, one
JSON line with every kernel ({"kernels": [...]}) and, last, the JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
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
# phase 3's K1 shapes: the vision tower at 16 and 32 tiles and the decoder
# prefill of two right-padded rows; rows: each row's segment lengths or None
K1_SHAPES = {
    "vision_b16": dict(b=16, s=676, hq=16, hkv=16, d=72, causal=False, rows=None),
    "vision_b32": dict(b=32, s=676, hq=16, hkv=16, d=72, causal=False, rows=None),
    "decoder": dict(b=2, s=4096, hq=32, hkv=8, d=128, causal=True, rows=((4096,), (2900,))),
}


def k2_shapes(text, vis):
    """Phase 3's K2 shapes from the model's text and vision configs: the
    train phase's packed decoder rows and its tower tiles."""
    n_tiles = sum(len(row) for row in TRAIN_ROWS) * TRAIN_TILES_PER_SAMPLE
    return {"decoder": dict(b=len(TRAIN_ROWS), s=TRAIN_SEQ, hq=text.num_heads,
                            hkv=text.num_kv_heads, d=text.head_dim, causal=True, rows=TRAIN_ROWS),
            "tower": dict(b=n_tiles, s=vis.tokens_per_tile, hq=vis.num_heads, hkv=vis.num_heads,
                          d=vis.head_dim, causal=False, rows=None)}


def cuda_ms(fn, flush=None) -> float:
    """Median device time of fn() over 10 runs in ms, by CUDA events, after
    a warm-up. With `flush` (a buffer larger than the L2 cache) the buffer is
    read before each run, outside the timed window, so fn() finds its inputs
    cold, as a decode step finds each weight; the read also keeps the device
    busy while the host enqueues fn(), so the window holds no launch gap."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
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


def attended_pairs(segment_lengths, causal):
    """(q, kv) pairs the mask lets through, for rows of contiguous segments."""
    return sum(n * (n + 1) // 2 if causal else n * n
               for row in segment_lengths for n in row)


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


def ranges_ms(seg, s, causal) -> float:
    """Host time of one tile_ranges call on segment ids [B, S], device work
    included (median of 10, each ending in a synchronize). The decoder
    computes it once per forward and passes it to every layer, and the
    kernels are timed that way; this is the cost of a call that does not."""
    from leopard_tpu_torch.ops.flash_attention import tile_ranges

    if seg is None:
        return 0.0
    return wall_s(lambda: tile_ranges(seg, seg, sq=s, skv=s, causal=causal,
                                      device=seg.device), reps=10) * 1e3


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


def kernel_vs_plain(name, b, s, hq, hkv, d, causal, rows, device, card):
    """Phase 3 for one shape: max abs error over valid rows, both times."""
    import torch

    from leopard_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_ref,
                                                       tile_ranges)

    q, k, v, _, seg = attn_inputs(b, s, hq, hkv, d, rows, device)
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    valid = torch.ones((b, s), dtype=torch.bool, device=device) if seg is None else seg.bool()
    err = (got[valid].float() - want[valid].float()).abs().max().item()
    torch.testing.assert_close(got[valid].float(), want[valid].float(), **KERNEL_TOL)
    del want
    ranges = tile_ranges(seg, seg, sq=s, skv=s, causal=causal, device=device)
    ms = cuda_ms(lambda: flash_attention(q, k, v, ranges=ranges, **kw))  # as the decoder
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw))
    lone_ranges_ms = ranges_ms(seg, s, causal)
    n_bytes = nbytes(q, k, v, seg, seg, got)
    del q, k, v
    segs = rows if rows is not None else [[s]] * b
    library_ms = sdpa_ms([s] * b, hq, hkv, d, causal, device, backward=False)
    attended_ms = sdpa_ms([n for row in segs for n in row], hq, hkv, d, causal, device,
                          backward=False)
    pairs = attended_pairs(segs, causal)
    bound_ms, bound_by = attn_bound_ms(pairs, hq, d, 2, n_bytes)
    rate = achieved(pairs, hq, d, 2, ms, bound_ms)
    shape = (f"B={b} S={s} heads={hq}/{hkv} D={d} {'causal' if causal else 'non-causal'}"
             + (f" lengths={[n for row in rows for n in row]}" if rows else ""))
    print(f"kernel {name}: {shape}: max_abs_err={err:.6g} (tol {KERNEL_TOL}) "
          f"kernel {ms:.4f} ms ({rate['tflops']:.1f} TF/s attended, "
          f"{rate['bound_fraction']:.3f} of the bound), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms (unsegmented), {attended_ms:.4f} ms (attended rows only), "
          f"bound {bound_ms:.4f} ms; tile ranges of a lone call {lone_ranges_ms:.4f} ms "
          f"(host) [{card}]", flush=True)
    return {"shape": f"{name}: {shape}", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_attended_ms": attended_ms,
            "tile_ranges_ms": lone_ranges_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **rate}


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


def norm_vs_plain(kind, rows, h, device, card, flush):
    """Phase 3, K3a (rms) or K3b (ln) at [rows, h] bf16: max abs error,
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
        fused, plain, eps = fused_norms.fused_rms_norm, norms.rms_norm_ref, 1e-5
        library = lambda: F.rms_norm(x, (h,), params[0], eps)  # noqa: E731
    else:
        fused, plain, eps = fused_norms.fused_layer_norm, norms.layer_norm_ref, 1e-6
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
    """Phase 10a: one step's gradients through K1 + K2 against the same step
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
    """Phase 10b: TRAIN_STEPS steps of train() through the user's entry
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

    # phase 3: kernel against its plain version at the serving path's shapes
    per_shape = {name: kernel_vs_plain(name, device=device, card=card, **kw)
                 for name, kw in K1_SHAPES.items()}
    # 1 GiB > L2; reading it keeps the device busy ~0.3 ms while a launch is queued
    flush = torch.empty(2**30 // 4, dtype=torch.float32, device=device)
    k4_shapes = {name: int4_vs_plain(name, 2, k, n, device, card, flush)
                 for name, (k, n, _) in K4_SHAPES.items()}
    k4_m64 = int4_vs_plain("gate_up_m64", 64, 4096, 14336, device, card, flush)
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
    del flush
    # K4 in one 8B decode step: the seven matmuls of each layer and lm_head
    n_layers = leopard_llava_8b().text.num_layers
    step_calls = {name: n_layers * per + (name == "lm_head")
                  for name, (_, _, per) in K4_SHAPES.items()}

    def per_step(key):
        vals = [k4_shapes[name][key] for name in K4_SHAPES]
        if any(v is None for v in vals):
            return None
        return sum(step_calls[name] * k4_shapes[name][key] for name in K4_SHAPES)

    k4_step = {key: per_step(key) for key in ("ms", "plain_ms", "library_ms", "dense_ms",
                                              "host_us", "dense_host_us", "bound_ms")}
    lib_step = ("not available" if k4_step["library_ms"] is None
                else f"{k4_step['library_ms']:.4f} ms")
    print(f"K4 per 8B decode step (batch 2, {sum(step_calls.values())} calls, cold L2): kernel "
          f"{k4_step['ms']:.4f} ms, bound {k4_step['bound_ms']:.4f} ms "
          f"({k4_step['bound_ms'] / k4_step['ms']:.3f} of it), plain {k4_step['plain_ms']:.4f} "
          f"ms, tinygemm {lib_step}, dense bf16 {k4_step['dense_ms']:.4f} ms; host ms per step: "
          f"quant.matmul (K4) {k4_step['host_us'] / 1e3:.3f}, F.linear "
          f"{k4_step['dense_host_us'] / 1e3:.3f} [{card}]", flush=True)
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

    # phase 10: training at 8B width, text depth 4
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = train_config()
    model = vlm.init_params(tcfg, torch.Generator(device=device).manual_seed(SEED))
    batch = train_batch(tcfg, device)
    n_train = sum(p.numel() for p in model.parameters())
    print(f"train model: Leopard-LLaVA-8B widths, {TRAIN_TEXT_LAYERS} of 32 text layers, "
          f"{n_train} parameters; batch {len(TRAIN_ROWS)} x {TRAIN_SEQ} tokens packing "
          f"{[list(r) for r in TRAIN_ROWS]}, {batch['images'].shape[0]} tiles", flush=True)
    grads_check = train_grads_vs_dense(model, tcfg, batch, card)
    torch.cuda.empty_cache()
    train_run = train_phase(model, tcfg, batch, card)
    del model, batch
    peak["train"] = phase_memory("train")

    # phase 11: no JAX
    if "jax" in sys.modules or any(m.split(".")[0] == "leopard_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    print("no jax: ok", flush=True)

    per_generate = ((cfg.vision.num_layers, per_shape["vision_b32"]),
                    (cfg.text.num_layers, per_shape["decoder"]))
    per_train_step = ((tcfg.text.num_layers, k2["decoder"]),
                      (tcfg.vision.num_layers, k2["tower"]))

    def total(parts, key):
        return sum(n * r[key] for n, r in parts)

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
        "max_abs_err": max(r["max_abs_err"] for r in [*k4_shapes.values(), k4_m64]),
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
        "shapes": [*k4_shapes.values(), k4_m64],
        "card": card,
        "serve_int4": timings_int4,
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
        "max_abs_err": k3[kind]["max_abs_err"],
        "ms": k3[kind]["ms"],
        "plain_ms": k3[kind]["plain_ms"],
        "bound_ms": k3[kind]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k3[kind]["library_ms"],
        "library": library,
        "ms_is": f"per call at {k3[kind]['shape']}",
        "card": card,
    } for name, kind, line, library in (
        ("fused_rms_norm", "rms", 54, "F.rms_norm"),
        ("fused_layer_norm", "ln", 88, "F.layer_norm"))]]}
    print(smi.splitlines()[0], flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
