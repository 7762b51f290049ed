"""The port's entry points, one module per example of the JAX package, run
as `python -m leopard_tpu_torch.cli.<name>`: generate, serve,
train_leopard_llava, train_leopard_idefics2, convert_checkpoint and
run_eval. Each takes the JAX example's
flags and `--device`, `cuda` unless the caller asks for `cpu`; without a
card it refuses to run on `cuda`. The two train CLIs take `--mesh` under
torchrun (`start_mesh`)."""

from __future__ import annotations

import argparse

import torch


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs (default: the CUDA card)")


def resolve_device(name: str) -> torch.device:
    """The device to run on; exits with an error when it is the card and
    there is none."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to run on the CPU")
    return torch.device(name)


def start_mesh(text: str, device: torch.device):
    """`--mesh axis=size,...` under torchrun: the process group (NCCL on the
    card, gloo on the CPU) and the device mesh; returns (mesh, this
    process's device). The pipeline's stage axis is refused (it trains
    through `training.pp.make_pp_train_step`, as in the JAX package), and
    so is the expert axis: neither Leopard model has experts."""
    import os

    from leopard_tpu_torch.parallel.launch import initialize_distributed
    from leopard_tpu_torch.parallel.mesh import build_mesh, parse_mesh

    mesh_cfg = parse_mesh(text)
    if mesh_cfg.stage > 1:
        raise SystemExit("error: --mesh stage > 1 is not a CLI option (the pipeline trains "
                         "through training.pp.make_pp_train_step, as in the JAX package)")
    if mesh_cfg.expert > 1:
        raise SystemExit("error: --mesh expert > 1 shards experts, and the Leopard models "
                         "have none")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if mesh_cfg.num_devices != world:
        raise SystemExit(f"error: --mesh {text} wants {mesh_cfg.num_devices} processes, "
                         f"WORLD_SIZE is {world}")
    initialize_distributed(device.type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return build_mesh(mesh_cfg, device.type), device
