#!/usr/bin/env python3
"""Profile the PyTorch port's train step on one NVIDIA GPU.

    python3 tools/profile_torch_train.py [--trace-dir build/traces] [--steps 1]

Builds the train phase of chip_smoke.py: Leopard-LLaVA-8B widths with the
text depth cut to 4 (seeded random weights), 2 rows × 4,096 tokens packing
two samples each with 16 tiles, full recompute, chunked cross-entropy,
AdamW. After two warm-up steps it times the parts of a step with the host
clock around synchronized calls (the forward and backward, then the
optimizer update), and traces whole steps with torch.profiler (CPU + CUDA
activities): the host wall time, the device busy time (the union of kernel
and copy intervals), the device idle share (1 - busy / wall), device time
by kernel family (K1, K2, K3, GEMMs, the rest) and the kernels that take
the most device time. A chrome trace goes to --trace-dir when given (keep it
out of chiprun_out/: a step's trace is large).
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

FAMILIES = (
    ("K1 flash forward", re.compile(r"flash_fwd_kernel")),
    ("K2 flash backward", re.compile(r"flash_bwd_(dq|dkv)_kernel")),
    ("K3 fused norms", re.compile(r"^(rms|ln)_kernel")),
    ("GEMMs (cuBLAS/CUTLASS)", re.compile(r"gemm|xmma|cutlass|nvjet|sm90_|splitK", re.I)),
)


def family(name: str) -> str:
    for label, pattern in FAMILIES:
        if pattern.search(name):
            return label
    return "other (elementwise, reductions, copies)"


def synced_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", type=Path, default=None)
    ap.add_argument("--steps", type=int, default=1, help="steps in the traced window")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import SEED, TRAIN_ROWS, TRAIN_SEQ, train_batch, train_config
    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = train_config()
    model = vlm.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    batch = train_batch(cfg, "cuda")
    tcfg = TrainConfig(remat="full", loss_chunk=1024, optimizer=OptimizerConfig(
        lr=1e-5, warmup_steps=1, decay_steps=1000, grad_clip=1.0))
    state = trainer.create_train_state(model, tcfg)
    step = trainer.make_train_step(cfg, tcfg, model=model)
    opt = trainer.make_optimizer(tcfg.optimizer)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; train model "
          f"{sum(p.numel() for p in model.parameters())} parameters, {cfg.text.num_layers} text "
          f"layers; batch {len(TRAIN_ROWS)} x {TRAIN_SEQ} tokens", flush=True)
    for _ in range(2):  # warm-up: Triton compiles, cuBLAS plans, allocator
        state, _ = step(state, batch)

    (loss, metrics, grads), fwd_bwd_ms = synced_ms(lambda: step.loss_and_grads(state, batch))
    (state, _), update_ms = synced_ms(
        lambda: trainer.apply_gradients(opt, state, grads, loss, metrics))
    del grads
    print(f"parts of one step (host clock, synchronized): forward + backward "
          f"{fwd_bwd_ms:.1f} ms, optimizer update (clip + AdamW) {update_ms:.1f} ms [{smi}]",
          flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"]
    busy_us, end_us = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = max(e.time_range.start, end_us), e.time_range.end
        if stop > start:
            busy_us += stop - start
        end_us = max(end_us, stop)
    busy_ms = busy_us / 1e3
    print(f"train step window ({args.steps} step(s)): wall {wall_ms:.1f} ms (traced), device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels)} device activities [{smi}]", flush=True)
    by_family = collections.defaultdict(float)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        by_family[family(e.name)] += ms
        by_name[e.name][0] += ms
        by_name[e.name][1] += 1
    for label, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.2f} ms  {label}", flush=True)
    print("top kernels:", flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"  {ms:9.2f} ms  {n:6d}x  {name[:110]}", flush=True)
    if args.trace_dir is not None:
        args.trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace_dir / "train_step.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
