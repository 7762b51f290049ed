"""Train Leopard-Idefics2 (NaViT tower + perceiver + Mistral-7B with its
4,096-token window) from a jsonl manifest (port of
examples/train_leopard_idefics2.py):

  python -m leopard_tpu_torch.cli.train_leopard_idefics2 \\
      --manifest data.jsonl --image-folder imgs/ \\
      --tokenizer /ckpts/leopard-idefics2-hf --init-from /ckpts/leopard-idefics2-hf \\
      --set text.num_layers=4 --seq-len 8192 --global-batch-size 2 --freeze-perceiver

On N cards, one process each, started by torchrun, over a device mesh:

  python -m torch.distributed.run --nproc_per_node=N \\
      -m leopard_tpu_torch.cli.train_leopard_idefics2 ... --mesh data=2,model=2

`--mesh` names the axes data, fsdp, seq and model, as in
`train_leopard_llava`; seq > 1 takes `--set text.attn_impl=ring`, and on
the card the ring does not take Mistral's window yet (ROADMAP). Every rank
builds each global batch and keeps its (data, fsdp) coordinate's rows with
their whole images (`parallel/sharding.py::local_rows`); the primary alone
logs and writes checkpoints.

Manifest rows are `{"text": a chat-rendered string with <image>
placeholders, "images": [paths]}`; `data/idefics2_batches.py` turns them
into batches, one row a sequence. A run resumes from the newest checkpoint
in `--checkpoint-dir`, parameters and optimizer together, and its batches
start at row step × global batch size, so it sees the rows an unbroken run
would have seen. `train_main(args, tokenizer, cfg, **train_overrides)` is
the whole path for a caller that has built its own tokenizer or config;
`train_overrides` replace fields of the TrainConfig that the flags build.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

import torch

from leopard_tpu_torch.cli import add_device_arg, resolve_device, start_mesh
from leopard_tpu_torch.cli.train_leopard_llava import parse_overrides


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--manifest", required=True,
                   help="jsonl: {text: chat-rendered string with <image> placeholders, "
                        "images: [paths]}")
    p.add_argument("--image-folder", default="")
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--init-from", default=None, help="HF checkpoint dir")
    p.add_argument("--checkpoint-dir", default="checkpoints/leopard-idefics2")
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--global-batch-size", type=int, default=1024)
    p.add_argument("--train-steps", type=int, default=10614)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--freeze-vision-tower", action="store_true")
    p.add_argument("--freeze-perceiver", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="axis sizes, e.g. data=2,model=2 (run under torchrun)")
    p.add_argument("--tiny", action="store_true", help="tiny config smoke run")
    p.add_argument("--set", action="append", default=[],
                   help="dotted config override, e.g. text.num_layers=4")
    add_device_arg(p)
    return p.parse_args(argv)


def train_main(args: argparse.Namespace, tokenizer=None, cfg=None, **train_overrides):
    """Build the model, state, batches and checkpoints from the flags and
    run `training.loop.train`. Returns the final TrainState."""
    device = resolve_device(args.device)
    mesh = None
    if args.mesh is not None:
        mesh, device = start_mesh(args.mesh, device)
    from leopard_tpu_torch import config as cfgs
    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.convert.hf import load_leopard_idefics2
    from leopard_tpu_torch.data.idefics2_batches import idefics2_batches
    from leopard_tpu_torch.data.tokenizer import build_tokenizer
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.parallel.launch import is_primary
    from leopard_tpu_torch.parallel.sharding import local_rows
    from leopard_tpu_torch.training.checkpoint import CheckpointManager
    from leopard_tpu_torch.training.loop import train
    from leopard_tpu_torch.training.trainer import create_train_state, make_train_step
    from leopard_tpu_torch.utils.timers import MetricsLogger

    cfg = cfg or (cfgs.tiny_idefics2() if args.tiny else cfgs.leopard_idefics2_8b())
    cfg = cfgs.apply_overrides(cfg, parse_overrides(args.set))
    train_cfg = TrainConfig(
        seq_len=args.seq_len,
        global_batch_size=args.global_batch_size,
        train_steps=args.train_steps,
        optimizer=OptimizerConfig(lr=args.lr, decay_steps=args.train_steps),
        freeze_vision_tower=args.freeze_vision_tower,
        freeze_perceiver=args.freeze_perceiver,
        checkpoint_dir=args.checkpoint_dir,
    )
    train_cfg = dataclasses.replace(train_cfg, **train_overrides)
    tokenizer = tokenizer or build_tokenizer(args.tokenizer, tokenizer_type="mistral",
                                             image_token="<image>")

    if args.init_from:
        model = load_leopard_idefics2(args.init_from, cfg, device)
    else:
        model = vlm.init_params(cfg, torch.Generator(device=device).manual_seed(train_cfg.seed))
    state = create_train_state(model, train_cfg, mesh=mesh)
    frozen = tuple(name for name, flag in (("vision", train_cfg.freeze_vision_tower),
                                           ("perceiver", train_cfg.freeze_perceiver)) if flag)
    # the loaded model is the step's compute copy: the masters are written
    # into it at every step (under a mesh the step builds its own, of local
    # shards)
    step_fn = make_train_step(cfg, train_cfg, frozen=frozen,
                              model=None if mesh is not None else model, mesh=mesh)

    ckpt = CheckpointManager(train_cfg.checkpoint_dir, async_save=train_cfg.async_checkpoint)
    latest = ckpt.latest_step()
    if latest is not None:
        state, _ = ckpt.restore(template=state)
        if is_primary():
            print(f"resumed from step {latest}", flush=True)

    with open(args.manifest) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    batches = idefics2_batches(rows, tokenizer, cfg, train_cfg.global_batch_size,
                               train_cfg.seq_len, args.image_folder,
                               start=int(state.step) * train_cfg.global_batch_size)

    def device_batches():
        for batch in batches:
            batch = {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}
            if mesh is not None:
                batch = local_rows(batch, mesh, cfg.perceiver.num_latents, cfg.image_token_id)
            yield {k: v.to(device, non_blocking=True) for k, v in batch.items()}

    logger = MetricsLogger(train_cfg.checkpoint_dir) if is_primary() else None
    try:
        final = train(cfg, train_cfg, state, step_fn, device_batches(), ckpt=ckpt,
                      logger=logger)
    finally:
        ckpt.close()
        if logger is not None:
            logger.close()
    if is_primary():
        print(f"done at step {int(final.step)}", flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return final


def main(argv: Optional[Sequence[str]] = None) -> None:
    train_main(parse_args(argv))


if __name__ == "__main__":
    main()
