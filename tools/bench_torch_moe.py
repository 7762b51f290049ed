"""MoE training on one card through the port (counterpart of
tools/bench_moe.py): a text-only MoE decoder with tied embeddings through
`leopard_tpu_torch.training.trainer.make_train_step`. Reports tokens/s and
moe_fraction_dropped (exactly 0 on the dropless path).

Usage: python tools/bench_torch_moe.py [--seq 4096] [--steps 8] [--capacity]
    [--hidden 1024 --ff 2048 --experts 8 --topk 2 --layers 8 --batch 1]
    [--remat full] [--device cuda|cpu]

The flags and defaults are tools/bench_moe.py's. The README's compute-dense
shape is `--hidden 2048 --ff 5632 --experts 4 --topk 2 --layers 4 --batch 4`
(0.671 B parameters). --capacity switches to the capacity-factor path.
MFU(6ND_active) is reckoned against the H100 SXM's dense bf16 peak, 989
TF/s; the first step (kernel builds, Triton compiles) is not timed.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H100_BF16_FLOPS = 989e12


def moe_config(hidden, ff, experts, topk, layers, dropless):
    """tools/bench_moe.py's config: the stub tower of tiny_vlm() (text-only
    batches never run it) and a tied MoE decoder of head dim 64."""
    from leopard_tpu_torch import config as cfgs

    text = cfgs.TextConfig(
        vocab_size=32768, hidden_size=hidden, intermediate_size=ff,
        num_layers=layers, num_heads=max(hidden // 64, 1),
        num_kv_heads=max(hidden // 128, 1), head_dim=64,
        num_experts=experts, moe_top_k=topk, moe_dropless=dropless,
        tie_word_embeddings=True, dtype="bfloat16", attn_impl="auto",
    )
    return dataclasses.replace(cfgs.tiny_vlm(), text=text, image_token_id=32767)


def main(seq=4096, steps=8, dropless=True, hidden=1024, ff=2048, experts=8, topk=2,
         layers=8, batch=1, remat="full", device="cuda"):
    import torch

    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.training.trainer import create_train_state, make_train_step

    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("bench_torch_moe: no CUDA device; pass --device cpu to run on the host")
    dev = torch.device(device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    cfg = moe_config(hidden, ff, experts, topk, layers, dropless)
    text = cfg.text
    train_cfg = TrainConfig(
        seq_len=seq, global_batch_size=batch, remat=remat,
        optimizer=OptimizerConfig(lr=1e-5, warmup_steps=10, decay_steps=1000),
    )
    model = vlm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    # active params per token: shared + top_k/num_experts of the expert bank
    n_experts_p = sum(p.numel() for n, p in model.text.named_parameters() if ".experts." in n)
    n_active = n_params - n_experts_p * (1 - text.moe_top_k / text.num_experts)
    state = create_train_state(model, train_cfg)
    step = make_train_step(cfg, train_cfg, model=model)

    ids = np.random.RandomState(0).randint(1, 30000, (batch, seq)).astype(np.int64)
    data = {
        "tokens": torch.from_numpy(ids).to(dev),
        "loss_weights": torch.ones((batch, seq), dtype=torch.float32, device=dev),
        "segment_ids": torch.ones((batch, seq), dtype=torch.int32, device=dev),
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    state, metrics = step(state, data)  # kernel builds and first launches
    loss = float(metrics["loss"])
    dropped = float(metrics["moe_fraction_dropped"])
    print(f"first step in {time.perf_counter() - t0:.0f}s "
          f"(loss={loss:.3f}, fraction_dropped={dropped:.4f})")
    assert np.isfinite(loss)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, data)
    dropped = float(metrics["moe_fraction_dropped"])
    sync()
    dt = (time.perf_counter() - t0) / steps
    toks = batch * seq
    mfu = 6 * n_active * toks / dt / H100_BF16_FLOPS
    mode = "dropless(per-expert bmm)" if dropless else "capacity"
    print(
        f"MoE train step [{mode}]: {toks / dt:.0f} tokens/s/chip "
        f"({dt * 1e3:.0f} ms/step, {n_params / 1e9:.3f}B total / "
        f"{n_active / 1e9:.3f}B active, {experts} experts top-{topk}, "
        f"H={hidden} F={ff} L={layers}, batch {batch}, seq {seq}, "
        f"{remat} remat) MFU(6ND_active)={mfu * 100:.1f}% "
        f"fraction_dropped={dropped:.4f}"
    )
    if dropless:
        assert dropped == 0.0, "dropless path must never drop tokens"


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--seq", type=int, default=4096)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--capacity", action="store_true")
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--ff", type=int, default=2048)
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--topk", type=int, default=2)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--remat", default="full",
                   choices=("none", "selective", "attn", "full"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args()
    main(a.seq, a.steps, dropless=not a.capacity, hidden=a.hidden, ff=a.ff,
         experts=a.experts, topk=a.topk, layers=a.layers, batch=a.batch,
         remat=a.remat, device=a.device)
