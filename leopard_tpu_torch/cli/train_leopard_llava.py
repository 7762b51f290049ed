"""Train Leopard-LLaVA (SigLIP-SO400M-364 + Llama-3.1-8B, anyres multi-image)
from a jsonl manifest (port of examples/train_leopard_llava.py):

  python -m leopard_tpu_torch.cli.train_leopard_llava \
      --manifest data.jsonl --image-folder imgs/ \
      --tokenizer /ckpts/leopard-llava-hf --init-from /ckpts/leopard-llava-hf \
      --set text.num_layers=4 --seq-len 4096 --global-batch-size 2

On N cards, one process each, started by torchrun, over a device mesh:

  python -m torch.distributed.run --nproc_per_node=N \
      -m leopard_tpu_torch.cli.train_leopard_llava ... --mesh data=2,fsdp=2,model=2

`--mesh` names the axes data, fsdp, seq and model (unnamed ones are 1; their
product must be the world size); seq > 1 takes `--set text.attn_impl=ring`.
`stage` is refused: the JAX CLI drives no pipeline either, which trains
through `training.pp.make_pp_train_step` called directly; so is `expert`:
the model has no experts. Each (data, fsdp)
coordinate loads its own share of every global batch; the primary alone
logs and writes checkpoints (with its data position, which a resume gives
every rank). Without `--mesh` the run is one process on one device, as
before.

A run resumes from the newest checkpoint in `--checkpoint-dir`, parameters,
optimizer and data position (`DataState`) together. Batches come from
`TrainDataLoader` as numpy on the host and are moved to the device here.
`train_main(args, tokenizer, cfg, **train_overrides)` is the whole path for
a caller that has built its own tokenizer or config; `train_overrides`
replace fields of the TrainConfig that the flags build.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
from typing import Optional, Sequence

import torch

from leopard_tpu_torch.cli import add_device_arg, resolve_device, start_mesh


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--manifest", required=True, help="jsonl SFT manifest")
    p.add_argument("--image-folder", default="")
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--init-from", default=None, help="HF checkpoint dir")
    p.add_argument("--checkpoint-dir", default="checkpoints/leopard-llava")
    p.add_argument("--seq-len", type=int, default=16384)
    p.add_argument("--global-batch-size", type=int, default=128)
    p.add_argument("--train-steps", type=int, default=10614)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--freeze-vision-tower", action="store_true")
    p.add_argument("--freeze-llm", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny config smoke run")
    p.add_argument("--mesh", default=None,
                   help="axis sizes, e.g. data=2,fsdp=2,model=2 (run under torchrun)")
    p.add_argument("--set", action="append", default=[],
                   help="dotted config override, e.g. text.num_layers=4")
    add_device_arg(p)
    return p.parse_args(argv)


def parse_overrides(items: Sequence[str]) -> dict:
    overrides = {}
    for item in items:
        path, value = item.split("=", 1)
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        overrides[path] = value
    return overrides


def train_main(args: argparse.Namespace, tokenizer=None, cfg=None, **train_overrides):
    """Build the model, state, loader and checkpoints from the flags and run
    `training.loop.train`. Returns the final TrainState."""
    device = resolve_device(args.device)
    mesh = None
    if args.mesh is not None:
        mesh, device = start_mesh(args.mesh, device)
    from leopard_tpu_torch import config as cfgs
    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
    from leopard_tpu_torch.convert.hf import load_leopard_llava
    from leopard_tpu_torch.data.dataset import DataState, JsonlSftDataset, TrainDataLoader
    from leopard_tpu_torch.data.processor import LeopardProcessor
    from leopard_tpu_torch.data.tokenizer import build_tokenizer
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.parallel.launch import dp_rank_and_world, is_primary
    from leopard_tpu_torch.training.checkpoint import CheckpointManager
    from leopard_tpu_torch.training.loop import train
    from leopard_tpu_torch.training.trainer import create_train_state, make_train_step
    from leopard_tpu_torch.utils.timers import MetricsLogger

    cfg = cfg or (cfgs.tiny_vlm() if args.tiny else cfgs.leopard_llava_8b())
    cfg = cfgs.apply_overrides(cfg, parse_overrides(args.set))
    train_cfg = TrainConfig(
        seq_len=args.seq_len,
        global_batch_size=args.global_batch_size,
        train_steps=args.train_steps,
        optimizer=OptimizerConfig(lr=args.lr, decay_steps=args.train_steps),
        freeze_vision_tower=args.freeze_vision_tower,
        freeze_llm=args.freeze_llm,
        checkpoint_dir=args.checkpoint_dir,
    )
    train_cfg = dataclasses.replace(train_cfg, **train_overrides)
    tokenizer = tokenizer or build_tokenizer(args.tokenizer)

    if args.init_from:
        model = load_leopard_llava(args.init_from, cfg, device)
    else:
        model = vlm.init_params(cfg, torch.Generator(device=device).manual_seed(train_cfg.seed))
    state = create_train_state(model, train_cfg, mesh=mesh)
    frozen = tuple(name for name, flag in (("vision", train_cfg.freeze_vision_tower),
                                           ("text", train_cfg.freeze_llm)) if flag)
    # the loaded model is the step's compute copy: the masters are written
    # into it at every step (under a mesh the step builds its own, of local
    # shards)
    step_fn = make_train_step(cfg, train_cfg, frozen=frozen,
                              model=None if mesh is not None else model, mesh=mesh)
    dp_rank, dp_world = dp_rank_and_world(mesh)
    if train_cfg.global_batch_size % dp_world:
        raise SystemExit(f"error: global batch {train_cfg.global_batch_size} does not split "
                         f"over {dp_world} data-parallel ranks")

    data_state = DataState(seed=train_cfg.seed)
    ckpt = CheckpointManager(train_cfg.checkpoint_dir, async_save=train_cfg.async_checkpoint)
    latest = ckpt.latest_step()
    if latest is not None:
        state, ds = ckpt.restore(template=state)
        if ds:
            data_state = DataState.from_dict(ds)
        if is_primary():
            print(f"resumed from step {latest}", flush=True)

    loader = TrainDataLoader(
        JsonlSftDataset(args.manifest, args.image_folder), LeopardProcessor(cfg, tokenizer),
        batch_size=train_cfg.global_batch_size // dp_world, seq_len=train_cfg.seq_len,
        dp_rank=dp_rank, dp_world=dp_world, state=data_state)

    def device_batches():
        for batch in loader:
            yield {k: torch.from_numpy(v).to(device, non_blocking=True)
                   for k, v in batch.as_dict().items()}

    logger = MetricsLogger(train_cfg.checkpoint_dir) if is_primary() else None
    try:
        final = train(cfg, train_cfg, state, step_fn, device_batches(),
                      data_state=data_state, ckpt=ckpt, logger=logger)
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
