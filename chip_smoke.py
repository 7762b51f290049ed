#!/usr/bin/env python3
"""Smoke run of the PyTorch port (leopard_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases, each printing its result on its own line; any failure raises and the
script exits non-zero without printing a result:
  1. environment: torch, the card, its name and power limit (nvidia-smi);
  2. build: nvcc compiles the flash-attention (K1) and int4 matmul (K4)
     kernels into build/, one nvcc each, in parallel;
  3. K1 against its plain version in bf16 at the serving path's shapes
     (vision tower and decoder prefill), with both times; K4 against its
     plain version at the 8B decode shapes (M = 2, and M = 64 once), with
     both times (cold L2) and the kernel's GB/s on the packed bytes;
  4. serving at 8B: Engine.generate on Leopard-LLaVA-8B with seeded random
     weights, 2 requests of 16 uint8 364×364 tiles each, 16 greedy tokens;
     K1's launch count, repeatability, TTFT, prefill tok/s and decode ms/step;
  5. the K1 path against the dense path end to end (one request);
  6. int4 serving at 8B: Engine(quantize="int4") on the same model and
     requests; K1 and K4 launch counts, repeatability, TTFT, decode ms/step;
  7. one decode step of the int4 engine (K4) against the same step through a
     bf16 decoder built from the dequantized int4 weights;
  8. int4 weights with the int8 KV cache: one generate, checked;
  9. int8 weights: one checked generate, then TTFT and decode ms/step;
 10. no JAX was imported.
Each engine is freed after its phase, with the phase's peak device memory
printed. Then one JSON line per kernel ({"kernels": [...]}) and, last, the
JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
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
# decode-step matmuls of the 8B decoder, (K, N) and how many per layer
K4_SHAPES = {"wq_wo": (4096, 4096, 2), "wk_wv": (4096, 1024, 2),
             "gate_up": (4096, 14336, 2), "down": (14336, 4096, 1),
             "lm_head": (4096, 128256, 0)}
KERNELS = ("flash_attention", "int4_matmul")


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


def kernel_vs_plain(name, b, s, hq, hkv, d, causal, lengths, device, card):
    """Phase 3 for one shape: max abs error over valid rows, both times."""
    import torch

    from leopard_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn((b, s, hq, d), generator=g, device=device, dtype=torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device=device, dtype=torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=g, device=device, dtype=torch.bfloat16)
    seg = None
    if lengths is not None:
        seg = (torch.arange(s, device=device)[None]
               < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
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
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw))
    shape = (f"B={b} S={s} heads={hq}/{hkv} D={d} {'causal' if causal else 'non-causal'}"
             + (f" lengths={list(lengths)}" if lengths else ""))
    print(f"kernel {name}: {shape}: max_abs_err={err:.6g} (tol {KERNEL_TOL}) "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]", flush=True)
    return {"shape": f"{name}: {shape}", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def int4_vs_plain(name, m, k, n, device, card, flush):
    """Phase 3 for one K4 shape: max abs error, both times, GB/s."""
    import torch

    from leopard_tpu_torch.ops import quant
    from leopard_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_ref

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((m, k), generator=g, device=device, dtype=torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=device, dtype=torch.bfloat16) * k**-0.5
    q = quant.quantize_int4(w)
    del w
    q4, s = q["q4"], q["s"]
    got = int4_matmul(x, q4, s)
    want = int4_matmul_ref(x, q4, s)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **K4_TOL)
    del want
    ms = cuda_ms(lambda: int4_matmul(x, q4, s), flush=flush)
    plain_ms = cuda_ms(lambda: int4_matmul_ref(x, q4, s), flush=flush)
    gbs = q4.numel() / (ms * 1e-3) / 1e9
    print(f"kernel int4_matmul {name}: M={m} K={k} N={n}: max_abs_err={err:.6g} (tol {K4_TOL}) "
          f"kernel {ms:.4f} ms ({gbs:.1f} GB/s of packed weight), plain {plain_ms:.4f} ms "
          f"[{card}]", flush=True)
    return {"shape": f"{name}: M={m} K={k} N={n}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "packed_gb_s": gbs}


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
    from leopard_tpu_torch.ops.int4_matmul import int4_matmul

    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS)
    expected = cfg.vision.num_layers + cfg.text.num_layers
    results = []
    for _ in range(runs):
        flash_attention.launches = 0
        int4_matmul.launches = 0
        res = engine.generate(prompts, images=tiles, gen_cfg=gen)
        torch.cuda.synchronize()
        launches = {"flash_attention": flash_attention.launches,
                    "int4_matmul": int4_matmul.launches}
        # decode forwards in one generate: the loop stops after the step
        # where the last row emits eos, and the final step runs no forward
        steps = max(min(MAX_NEW_TOKENS, len(t) + 1) for t in res.tokens) - 1
        want = {"flash_attention": expected,
                "int4_matmul": 1 + k4_per_step * steps if k4_per_step else 0}
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
    print(f"{label}: {runs} generate call(s), launches each {launches} "
          f"(K1: {cfg.vision.num_layers} vision + {cfg.text.num_layers} decoder prefill{k4_note}), "
          f"tokens{' identical' if runs > 1 else ''}: {[t.tolist() for t in results[0].tokens]}",
          flush=True)
    timings = {"launches": launches, "decode_steps": steps}
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
    shapes = {
        "vision_b16": dict(b=16, s=676, hq=16, hkv=16, d=72, causal=False, lengths=None),
        "vision_b32": dict(b=32, s=676, hq=16, hkv=16, d=72, causal=False, lengths=None),
        "decoder": dict(b=2, s=4096, hq=32, hkv=8, d=128, causal=True, lengths=(4096, 2900)),
    }
    per_shape = {name: kernel_vs_plain(name, device=device, card=card, **kw)
                 for name, kw in shapes.items()}
    flush = torch.empty(2**28 // 4, dtype=torch.float32, device=device)  # 256 MiB > L2
    k4_shapes = {name: int4_vs_plain(name, 2, k, n, device, card, flush)
                 for name, (k, n, _) in K4_SHAPES.items()}
    k4_m64 = int4_vs_plain("gate_up_m64", 64, 4096, 14336, device, card, flush)
    del flush
    # K4's time in one 8B decode step: the seven matmuls of each layer and lm_head
    n_layers = leopard_llava_8b().text.num_layers
    k4_step = {key: sum(n_layers * per * k4_shapes[name][key]
                        for name, (_, _, per) in K4_SHAPES.items())
               + k4_shapes["lm_head"][key] for key in ("ms", "plain_ms")}
    print(f"K4 per 8B decode step (batch 2, cold L2): kernel {k4_step['ms']:.4f} ms, "
          f"plain {k4_step['plain_ms']:.4f} ms [{card}]", flush=True)
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
    serve(engine, cfg, prompts, tiles, card, "serve int4 + int8 KV", k4_per_step,
          runs=1, time_reps=0)
    del engine
    peak["int4_kv8"] = phase_memory("serve int4 + int8 KV")

    # phase 9: int8 weights (plain PyTorch, no kernel of their own)
    engine = Engine(cfg, model, quantize="int8")
    timings_int8 = serve(engine, cfg, prompts, tiles, card, "serve int8", runs=1, time_reps=1)
    del engine
    peak["int8"] = phase_memory("serve int8")

    # phase 10: no JAX
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print("no jax: ok", flush=True)

    per_generate = (cfg.vision.num_layers * per_shape["vision_b32"]["ms"]
                    + cfg.text.num_layers * per_shape["decoder"]["ms"])
    per_generate_plain = (cfg.vision.num_layers * per_shape["vision_b32"]["plain_ms"]
                          + cfg.text.num_layers * per_shape["decoder"]["plain_ms"])
    kernels = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "leopard_tpu_torch/csrc/flash_attention.cu",
        "replaces": "leopard_tpu/ops/pallas/flash_attention.py:199",
        "launches": timings["launches"]["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        "ms": per_generate,
        "plain_ms": per_generate_plain,
        "ms_is": "per generate: 27 x vision_b32 + 32 x decoder",
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
        "ms_is": "per 8B decode step at batch 2, cold L2: 32 x (2 wq_wo + 2 wk_wv "
                 "+ 2 gate_up + down) + lm_head",
        "shapes": [*k4_shapes.values(), k4_m64],
        "card": card,
        "serve_int4": timings_int4,
        "serve_int8": timings_int8,
        "end_to_end_cosine": cos4,
        "end_to_end_argmax_agrees": same_argmax4,
        "peak_memory_gib": peak,
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
