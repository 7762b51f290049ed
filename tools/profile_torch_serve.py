#!/usr/bin/env python3
"""Profile the PyTorch port's serving path on one NVIDIA GPU.

    python3 tools/profile_torch_serve.py [--trace-dir traces/] [--quantize int4] [--quantize-kv]
    python3 tools/profile_torch_serve.py --pool

Builds Leopard-LLaVA-8B with seeded random weights on the card and the same
two requests as chip_smoke.py (16 uint8 tiles each, bucket 4,096), with the
Engine's weight and KV quantization flags as given, warms up,
then traces with torch.profiler (CPU + CUDA activities):
  - prefill: one generate with max_new_tokens=1 (the TTFT window);
  - decode: one generate with 16 greedy tokens.
With --pool it traces instead one ContinuousEngine.run of chip_smoke.py's
phase-16 queue (16 requests, 8 slots), after one untraced run.
For each window it prints the host wall time, the device busy time (the
union of kernel and copy intervals), the device idle share (1 - busy /
wall) and the kernels that take the most device time. Chrome traces go to
--trace-dir (tens of MB for the decode window).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _window(name, fn, trace_dir, top=25):
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only (kernels, copies), not the host ops that launched
    # them; "Command Buffer Full" marks the host waiting on a full launch
    # queue, not device work
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"]
    busy_us, end_us = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = max(e.time_range.start, end_us), e.time_range.end
        if stop > start:
            busy_us += stop - start
        end_us = max(end_us, stop)
    busy_ms = busy_us / 1e3
    print(f"{name}: wall {wall_ms:.1f} ms (traced), device busy {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {len(kernels)} device activities",
          flush=True)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    for kname, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:9.2f} ms  {n:6d}x  {kname[:100]}", flush=True)
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / f"serve_{name}.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", type=Path, default=None)
    ap.add_argument("--quantize", choices=("int8", "int4"), default=None)
    ap.add_argument("--quantize-kv", action="store_true")
    ap.add_argument("--pool", action="store_true",
                    help="trace the slot pool over phase 16's queue instead")
    args = ap.parse_args()

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import MAX_NEW_TOKENS, SEED, make_requests
    from leopard_tpu_torch.config import GenerateConfig, leopard_llava_8b
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.models import vlm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = leopard_llava_8b()
    model = vlm.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    engine = Engine(cfg, model, quantize=args.quantize, quantize_kv=args.quantize_kv)
    prompts, tiles = make_requests(cfg, 2, text_lengths=(500, 1100))
    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS)
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"quantize={args.quantize}, quantize_kv={args.quantize_kv}", flush=True)
    if args.pool:
        import numpy as np

        from chip_smoke import NO_EOS, POOL, pool_queue
        from leopard_tpu_torch.inference.continuous import ContinuousEngine

        reqs = pool_queue(cfg, np.random.RandomState(SEED + 16))
        pool = ContinuousEngine(engine, **POOL)
        pool_gen = GenerateConfig(eos_token_ids=(NO_EOS,))
        pool.run(reqs, gen_cfg=pool_gen)  # warm-up
        _window("pool", lambda: pool.run(reqs, gen_cfg=pool_gen), args.trace_dir)
        print(f"pool stats: {pool.stats}", flush=True)
        return 0
    engine.generate(prompts, images=tiles, gen_cfg=gen)  # warm-up: build, cuBLAS plans

    _window("prefill", lambda: engine.generate(
        prompts, images=tiles, gen_cfg=dataclasses.replace(gen, max_new_tokens=1)),
        args.trace_dir)
    _window("generate16", lambda: engine.generate(prompts, images=tiles, gen_cfg=gen),
            args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
