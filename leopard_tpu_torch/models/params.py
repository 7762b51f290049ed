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
import torch.nn.functional as F
from torch import nn

# leaves initialized to 0 (biases) and to 1 (norm scales); every other leaf is
# a weight matrix or table drawn from N(0, 1/fan_in), fan_in = its last dim,
# as the JAX init_params draw theirs
ZERO_LEAVES = frozenset({"bias", "bq", "bk", "bv", "bo", "b1", "b2"})
# (the perceiver's latents start at 1 too, as in the JAX and HF inits)
ONE_LEAVES = frozenset({"scale", "input_norm", "post_attn_norm", "final_norm",
                        "latents_norm", "context_norm", "latents"})


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


# K4 takes an int4 weight whose output width N is a multiple of this
INT4_COLUMNS = 128


def _pad_columns(t: torch.Tensor, n: int) -> torch.Tensor:
    """`t` with zero columns appended up to `n` (the last dim)."""
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


class QuantizedWeight(nn.Module):
    """A quantized weight leaf (ops/quant.py), in the JAX package's layout and
    bytes, with the reduction dim K first:
      int8: `q` int8 [K, N], `s` f32 [1, N];
      int4: `q4` uint8 [K/2, N] split-half packed, `s` f32 [K/G, N].
    It takes the place of the weight under the leaf's name, so its buffers'
    state-dict keys read as the JAX path (`text.layers.3.attn.wq.q4`).

    An int4 weight whose N is not a multiple of INT4_COLUMNS (Mistral's head,
    N = 32,003) is held padded to the next multiple, its q4 with zero bytes
    and its s with zero scales, so that K4 takes it; `n` keeps the true N,
    and `ops/quant.py::matmul` slices the product back to it. Both ways in
    pad here: a weight quantized by `quantize_tree`, and the true-N leaves of
    a JAX-quantized tree loaded into a model that `quantize_tree` built on
    "meta" (`_load_from_state_dict`). The state dict gives the true N, as
    the JAX tree holds it."""

    def __init__(self, leaves: Mapping[str, torch.Tensor]):
        super().__init__()
        if set(leaves) not in ({"q", "s"}, {"q4", "s"}):
            raise ValueError(f"a quantized leaf holds q/s or q4/s, not {sorted(leaves)}")
        self.n = leaves["s"].shape[-1]
        cols = self.n
        if "q4" in leaves:
            cols = -(-self.n // INT4_COLUMNS) * INT4_COLUMNS
        for name, t in leaves.items():
            self.register_buffer(name, _pad_columns(t, cols))

    @property
    def int4(self) -> bool:
        return "q4" in self._buffers

    @property
    def padded(self) -> bool:
        return self.s.shape[-1] != self.n

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        if self.padded:
            for name in self._buffers:
                key = prefix + name
                destination[key] = destination[key][..., :self.n].contiguous()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # `load_state_dict` hands each module its own copy of the mapping
        for name, buf in self._buffers.items():
            t = state_dict.get(prefix + name)
            if t is not None and t.shape[-1] == self.n != buf.shape[-1]:
                state_dict[prefix + name] = _pad_columns(t, buf.shape[-1])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


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
