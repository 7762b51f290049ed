"""JAX parameter tree → state dict of the port's modules.

The JAX package stacks every layer's weights on a leading axis and keeps
weight matrices [in, out]; the port has one module per layer and keeps them
[out, in] (models/params.py). The bridge is mechanical: flatten the tree to
dotted paths, split each `layers` leaf along its first axis into
`layers.{i}`, and transpose the matrix leaves.

A tree after the JAX `quantize_tree` holds quantized leaves ({"q", "s"} or
{"q4", "s"}) where weights were. The port keeps those in the JAX layout
(models/params.py::QuantizedWeight), so they pass through untransposed,
split along the layer axis only, and load into a port model quantized the
same way:

    model = LeopardVLM(cfg, device="meta")
    quantize_tree(model.text, mode="int4")      # the structure only
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True, assign=True)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from leopard_tpu_torch.config import VLMConfig

# leaves the port applies with F.linear, i.e. stores [out, in]; the leaves
# of a quantized weight (q, q4, s) are not among them
LINEAR_LEAVES = frozenset({
    "kernel", "wq", "wk", "wv", "wo", "fc1", "fc2",
    "w_gate", "w_up", "w_down", "lm_head",
})


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: device_get arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes, as jax.device_get returns it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_dict_from_jax(params: Mapping[str, Any], cfg: VLMConfig) -> Dict[str, torch.Tensor]:
    """`params`: the JAX VLM param tree as numpy (after `jax.device_get`).
    Returns a dict that `LeopardVLM(cfg).load_state_dict(strict=True)`
    accepts."""
    if cfg.perceiver is not None or "perceiver" in params:
        raise NotImplementedError("the Idefics2 perceiver is not in the port yet")
    out: Dict[str, torch.Tensor] = {}

    def put(path, a):
        if path[-1] in LINEAR_LEAVES:
            a = a.T
        out[".".join(path)] = _to_torch(a)

    def walk(tree, path):
        for key, val in tree.items():
            p = path + (key,)
            if isinstance(val, Mapping):
                walk(val, p)
                continue
            a = np.asarray(val)
            if "layers" in p:
                at = p.index("layers") + 1
                for i in range(a.shape[0]):
                    put(p[:at] + (str(i),) + p[at:], a[i])
            else:
                put(p, a)

    walk(params, ())
    return out
