"""The port's entry points, one module per example of the JAX package, run
as `python -m leopard_tpu_torch.cli.<name>`: generate, serve,
train_leopard_llava, train_leopard_idefics2, convert_checkpoint and
run_eval. Each takes the JAX example's
flags (less those that need a device mesh) and `--device`, `cuda` unless
the caller asks for `cpu`; without a card it refuses to run on `cuda`."""

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
