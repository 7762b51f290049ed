#!/usr/bin/env python3
"""Smoke run of the PyTorch port (leopard_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases, each printing its result on its own line; any failure raises and the
script exits non-zero without printing a result:
  1. environment: torch, the card, its name and power limit (nvidia-smi);
  2. build: nvcc compiles the flash-attention kernel into build/;
  3. the kernel against its plain version in bf16 at the serving path's
     shapes (vision tower and decoder prefill), with both times;
  4. serving at 8B: Engine.generate on Leopard-LLaVA-8B with seeded random
     weights, 2 requests of 16 uint8 364×364 tiles each, 16 greedy tokens;
     the kernel's launch count, repeatability, TTFT, prefill tok/s and
     decode ms/step;
  5. the kernel path against the dense path end to end (one request);
  6. no JAX was imported.
Then one JSON line per kernel ({"kernels": [...]}) and, last, the JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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


def cuda_ms(fn) -> float:
    """Median device time of fn() over 10 runs in ms, by CUDA events, after
    a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(fn) -> float:
    """Median host time of fn() over 3 runs in s, each run ending in a
    synchronize."""
    import torch

    times = []
    for _ in range(3):
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


def serve(engine, cfg, prompts, tiles, card):
    """Phase 4: generate twice through the kernel, check, then time."""
    import torch

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.ops.flash_attention import flash_attention

    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS)
    expected = cfg.vision.num_layers + cfg.text.num_layers
    runs = []
    for _ in range(2):
        flash_attention.launches = 0
        res = engine.generate(prompts, images=tiles, gen_cfg=gen)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        if launches != expected:
            raise AssertionError(f"generate launched the kernel {launches} times, expected {expected}")
        for toks, lps in zip(res.tokens, res.logprobs):
            if not np.all((toks >= 0) & (toks < cfg.text.vocab_size)):
                raise AssertionError(f"tokens out of the vocab: {toks}")
            if not np.all(np.isfinite(lps)):
                raise AssertionError(f"non-finite logprobs (non-finite logits): {lps}")
        runs.append(res)
    for a, b in zip(runs[0].tokens, runs[1].tokens):
        if not np.array_equal(a, b):
            raise AssertionError(f"generate is not repeatable: {a} vs {b}")
    print(f"serve: 2 generate calls, {launches} kernel launches each "
          f"({cfg.vision.num_layers} vision + {cfg.text.num_layers} decoder prefill), "
          f"tokens identical: {[t.tolist() for t in runs[0].tokens]}", flush=True)

    prompt_tokens = sum(len(p) for p in prompts)
    vision_s = wall_s(lambda: engine.encode_images(tiles))
    ttft_s = wall_s(lambda: engine.generate(prompts, images=tiles,
                                            gen_cfg=dataclasses.replace(gen, max_new_tokens=1)))
    full_s = wall_s(lambda: engine.generate(prompts, images=tiles, gen_cfg=gen))
    # decode forwards in one generate: the loop stops after the step where
    # the last row emits eos, and the final step runs no forward
    steps = max(min(MAX_NEW_TOKENS, len(t) + 1) for t in runs[0].tokens) - 1
    decode_ms = (full_s - ttft_s) / steps * 1e3
    timings = {
        "ttft_s": ttft_s, "vision_tower_s": vision_s,
        "prefill_tok_s": prompt_tokens / ttft_s, "decode_ms_per_step": decode_ms,
        "prompt_tokens": prompt_tokens, "batch": len(prompts), "decode_steps": steps,
    }
    print(f"serve timing [{card}]: TTFT {ttft_s * 1e3:.1f} ms (vision tower "
          f"{vision_s * 1e3:.1f} ms), prefill {timings['prefill_tok_s']:.1f} tok/s "
          f"({prompt_tokens} prompt tokens / TTFT), decode {decode_ms:.2f} ms/step "
          f"(batch {len(prompts)}, {steps} steps)", flush=True)
    return launches, timings


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

    # phase 2: build
    t0 = time.perf_counter()
    _build.load_library("flash_attention", verbose=True)
    print(f"build: flash_attention in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path('flash_attention').name})", flush=True)

    # phase 3: kernel against its plain version at the serving path's shapes
    shapes = {
        "vision_b16": dict(b=16, s=676, hq=16, hkv=16, d=72, causal=False, lengths=None),
        "vision_b32": dict(b=32, s=676, hq=16, hkv=16, d=72, causal=False, lengths=None),
        "decoder": dict(b=2, s=4096, hq=32, hkv=8, d=128, causal=True, lengths=(4096, 2900)),
    }
    per_shape = {name: kernel_vs_plain(name, device=device, card=card, **kw)
                 for name, kw in shapes.items()}
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
    launches, timings = serve(engine, cfg, prompts, tiles, card)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # phase 5: kernel path against the dense path, end to end
    cos, same_argmax = kernel_vs_dense_end_to_end(
        model, cfg, prompts[0], tiles[:TILES_PER_REQUEST], device)

    # phase 6: no JAX
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
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        "ms": per_generate,
        "plain_ms": per_generate_plain,
        "ms_is": "per generate: 27 x vision_b32 + 32 x decoder",
        "shapes": list(per_shape.values()),
        "card": card,
        "serve": timings,
        "end_to_end_cosine": cos,
        "end_to_end_argmax_agrees": same_argmax,
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
