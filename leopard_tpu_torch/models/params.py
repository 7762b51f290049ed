"""Parameter groups named after the JAX parameter tree, and their seeded
initialization.

A `Params` module is the port's counterpart of one dict of the JAX tree: it
holds bare parameters under the JAX leaf names, so a state-dict key reads as
the JAX path with the layer index spelled out (`text.layers.3.attn.wq`).
Weight matrices are kept in torch's `nn.Linear` layout [out, in] and applied
with `F.linear`; the JAX tree keeps them [in, out] (convert/from_jax.py
transposes them). A quantized weight is a `QuantizedWeight` module in the
JAX layout instead, applied by `ops/quant.py::matmul`.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

# leaves initialized to 0 (biases) and to 1 (norm scales); every other leaf is
# a weight matrix or table drawn from N(0, 1/fan_in), fan_in = its last dim,
# as the JAX init_params draw theirs
ZERO_LEAVES = frozenset({"bias", "bq", "bk", "bv", "bo", "b1", "b2"})
ONE_LEAVES = frozenset({"scale", "input_norm", "post_attn_norm", "final_norm"})


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def new_param(shape: Sequence[int], dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device))


class Params(nn.Module):
    """A named group of parameters: {leaf name: shape}."""

    def __init__(self, shapes: Mapping[str, Sequence[int]], *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, new_param(shape, dtype, device))


class QuantizedWeight(nn.Module):
    """A quantized weight leaf (ops/quant.py), in the JAX package's layout and
    bytes, with the reduction dim K first:
      int8: `q` int8 [K, N], `s` f32 [1, N];
      int4: `q4` uint8 [K/2, N] split-half packed, `s` f32 [K/G, N].
    It takes the place of the weight under the leaf's name, so its buffers'
    state-dict keys read as the JAX path (`text.layers.3.attn.wq.q4`)."""

    def __init__(self, leaves: Mapping[str, torch.Tensor]):
        super().__init__()
        if set(leaves) not in ({"q", "s"}, {"q4", "s"}):
            raise ValueError(f"a quantized leaf holds q/s or q4/s, not {sorted(leaves)}")
        for name, t in leaves.items():
            self.register_buffer(name, t)

    @property
    def int4(self) -> bool:
        return "q4" in self._buffers


def init_normal_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded in-place init of every parameter, on the parameters' own
    device (the generator must live there too)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ZERO_LEAVES:
                p.zero_()
            elif leaf in ONE_LEAVES:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
    return module
