"""JAX parameter tree → state dict of the port's modules, and back.

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

`jax_tree_from_state_dict` is the inverse for unquantized trees: it re-stacks
the layers and transposes the matrices back, so that the port's params or
gradients can be held against the JAX tree leaf by leaf.

An MoE decoder's `router.w` and `experts.{w_gate,w_up,w_down}` are matrices
too, the experts' stacked on an expert axis: the bridge swaps their last two
axes as it transposes the others. A tied decoder has no `lm_head` on either
side.

An Idefics2 tree carries its `perceiver` subtree across like any other. Its
`projector` subtree is dropped: the JAX `init_params` makes one that its
forward never reads, and the port's model has none (HF's Idefics2 layout has
none either).
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


def _is_matrix(path) -> bool:
    """A leaf stored transposed in the port: a LINEAR_LEAVES name, or the
    MoE router's `router.w`."""
    return path[-1] in LINEAR_LEAVES or tuple(path[-2:]) == ("router", "w")


def _swap(a: np.ndarray) -> np.ndarray:
    """[..., in, out] ↔ [..., out, in]: the last two axes (a 2-D transpose;
    the experts' leading expert axis stays)."""
    return np.swapaxes(a, -1, -2)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: device_get arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes, as jax.device_get returns it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_dict_from_jax(params: Mapping[str, Any], cfg: VLMConfig) -> Dict[str, torch.Tensor]:
    """`params`: the JAX VLM param tree as numpy (after `jax.device_get`).
    Returns a dict that `LeopardVLM(cfg).load_state_dict(strict=True)`
    accepts."""
    if "perceiver" in params:  # an Idefics2 tree: its projector is never read
        params = {k: v for k, v in params.items() if k != "projector"}
    out: Dict[str, torch.Tensor] = {}

    def put(path, a):
        if _is_matrix(path):
            a = _swap(a)
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


def jax_tree_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """{dotted name: tensor} in the port's layout → the JAX tree as nested
    dicts of fp32 numpy arrays: `layers.{i}` leaves stacked on a leading axis,
    matrix leaves transposed to [in, out]."""
    stacks: Dict[tuple, Dict[int, np.ndarray]] = {}
    tree: Dict[str, Any] = {}

    def put(path, a):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a

    for name, t in state.items():
        path = tuple(name.split("."))
        a = np.array(t.detach().to("cpu", torch.float32))  # a copy: the state moves on
        if _is_matrix(path):
            a = _swap(a)
        if "layers" in path:
            at = path.index("layers") + 1
            stacks.setdefault(path[:at] + path[at + 1:], {})[int(path[at])] = a
        else:
            put(path, a)
    for path, by_layer in stacks.items():
        put(path, np.stack([by_layer[i] for i in range(len(by_layer))]))
    return tree
