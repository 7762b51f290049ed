"""Recompute (remat) policies for the layer loops (port of
leopard_tpu/ops/remat.py).

  - "none" (or False/None): save every intermediate;
  - "full" (or True): per-layer full recompute, ≙ the reference's
    `--recompute-granularity full --recompute-num-layers 1`: only layer
    inputs are saved, and each layer's forward re-runs in the backward
    (`torch.utils.checkpoint`, non-reentrant), flash kernels included;
  - "attn": save only the attention outputs, the flash forward's (out, lse)
    and the dense tiers' tagged output: the recompute re-runs everything
    else in the layer but not K1;
  - "selective": ≙ Megatron's selective recompute: "attn" plus the outputs
    of every matmul without batch dims (`aten.mm`, `aten.addmm`: the
    projections and MLP GEMMs), as the JAX policy
    `dots_with_no_batch_dims_saveable`; the dense path's batched score
    products (`aten.bmm`) are recomputed, never saved, and so are the MoE
    expert GEMMs, which ops/moe.py runs as `aten.bmm` for that reason (JAX
    saves neither its batched expert einsums nor `ragged_dot`), while the
    MoE router's product is an `aten.mm` and is saved.

The last two are selective-checkpoint contexts
(`torch.utils.checkpoint.create_selective_checkpoint_contexts`): a policy
sees every operator the layer runs and answers MUST_SAVE for the ones above,
PREFER_RECOMPUTE otherwise. K1 is an operator
(`torch.ops.leopard.flash_attention_fwd`, ops/flash_attention.py) for that
reason; a ctypes launch would be invisible to the policy. The dense tiers'
output is made visible by `tag_attn_out`, the counterpart of the JAX
package's `checkpoint_name(o, "attn_out")`: an identity operator (a copy,
since an operator's output may not alias its input), applied only inside a
layer that runs under "attn" or "selective" and only when autograd records,
so "none" and "full" pay no copy.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable, Union

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

import leopard_tpu_torch.ops.flash_attention  # noqa: F401  (registers leopard::flash_attention_fwd)


@torch.library.custom_op("leopard::attn_out", mutates_args=())
def _attn_out(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


torch.library.register_autograd("leopard::attn_out", lambda ctx, grad: grad)


# set while a layer runs (forward and recompute) under a policy that reads the tag
_TAGGING = contextvars.ContextVar("leopard_attn_out_tagging", default=False)


def tag_attn_out(o: torch.Tensor) -> torch.Tensor:
    """Mark a dense attention output as saved under "attn"/"selective";
    the identity outside such a layer or when autograd does not record."""
    if _TAGGING.get() and torch.is_grad_enabled() and o.requires_grad:
        return torch.ops.leopard.attn_out(o)
    return o


def _tagging(fn: Callable) -> Callable:
    """`fn` with tag_attn_out active; the recompute re-runs this same
    function, so it records the tagged operators as the forward did."""

    def run(*args, **kwargs):
        token = _TAGGING.set(True)
        try:
            return fn(*args, **kwargs)
        finally:
            _TAGGING.reset(token)

    return run


_ATTN_OPS = frozenset({torch.ops.leopard.flash_attention_fwd.default,
                       torch.ops.leopard.attn_out.default})
_MATMUL_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"attn": _ATTN_OPS, "selective": _ATTN_OPS | _MATMUL_OPS}


def remat_wrap(fn: Callable, mode: Union[bool, str, None]) -> Callable:
    """`fn` under the recompute policy `mode`."""
    if not mode or mode == "none":
        return fn
    if mode is True or mode == "full":
        context_fn = torch.utils.checkpoint.noop_context_fn
    elif mode in _POLICIES:
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       functools.partial(_policy, _POLICIES[mode]))
        fn = _tagging(fn)
    else:
        raise ValueError(f"unknown remat mode: {mode!r}")

    def wrapped(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=context_fn, **kwargs)

    return wrapped
