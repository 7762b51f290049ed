"""Seeded weights, drawn on the device in a few large calls.

Every parameter of the port's model, by its state-dict name, is a view into
one flat buffer per (dtype, draw) group, and each group is filled by one
call of a generator on the device:
  - matrices and tables: N(0, 1/fan_in), fan_in the last dim;
  - norm scales: N(1, 0.1²), so that a scale that is dropped shows;
  - biases: N(0, 0.02²); the perceiver's latents: N(0, 1).
The same seed on the same device gives the same values, so the plain
reference draws them again itself after the program's state is freed.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from leopard_tpu_torch.models.params import ONE_LEAVES, ZERO_LEAVES

NORM_STD = 0.1
BIAS_STD = 0.02


def _draw_kind(name: str, shape) -> tuple:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "latents":
        return ("normal", 0.0, 1.0)
    if leaf in ONE_LEAVES:
        return ("normal", 1.0, NORM_STD)
    if leaf in ZERO_LEAVES or len(shape) == 1:
        return ("normal", 0.0, BIAS_STD)
    return ("normal", 0.0, shape[-1] ** -0.5)


def draw(shapes: dict, seed: int, device) -> dict:
    """{name: (shape, dtype)} → {name: tensor}, each a view of its group's
    flat buffer, in the given dtype, on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    groups = defaultdict(list)
    for name in sorted(shapes):
        shape, dtype = shapes[name]
        groups[(dtype, _draw_kind(name, shape))].append(name)
    out = {}
    for (dtype, (_, mean, std)), names in sorted(groups.items(), key=lambda kv: repr(kv[0])):
        sizes = [torch.Size(shapes[n][0]).numel() for n in names]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        flat.normal_(mean, std, generator=gen)
        for n, part in zip(names, flat.split(sizes)):
            out[n] = part.view(shapes[n][0])
    return out


def model_shapes(model: torch.nn.Module) -> dict:
    return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


def shapes_of(cfg) -> dict:
    """The parameter shapes and dtypes of the port's model for `cfg`."""
    from leopard_tpu_torch.models.vlm import LeopardVLM

    return model_shapes(LeopardVLM(cfg, device="meta"))


def build_model(cfg, seed: int, device, requires_grad: bool = False):
    """The port's LeopardVLM for `cfg`, its parameters the seeded draws."""
    from leopard_tpu_torch.models.vlm import LeopardVLM

    model = LeopardVLM(cfg, device="meta")
    tensors = draw(model_shapes(model), seed, device)
    for name, t in tensors.items():
        *path, leaf = name.split(".")
        mod = model.get_submodule(".".join(path))
        mod._parameters[leaf] = torch.nn.Parameter(t, requires_grad=requires_grad)
    return model
