"""Mixture-of-Experts layer: a top-k router, then capacity or dropless
dispatch to the experts (port of leopard_tpu/ops/moe.py, its single-device
paths).

Weights are in the port's [out, in] layout (models/params.py): the router
`w` [E, H] (fp32 at init; the trainer's compute copy rounds it to the
compute dtype, as the JAX `cast_for_compute` does) and the experts
`w_gate`, `w_up` [E, F, H] and `w_down` [E, H, F]. The JAX tree keeps them
[H, E], [E, H, F] and [E, F, H]; convert/from_jax.py swaps the last two axes.

The semantics are the JAX package's, step for step:
  - the router runs in fp32 (the tokens cast to fp32 times the weight cast
    to fp32); softmax over every expert, then top-k, then the selected
    probabilities renormalized;
  - the load-balancing loss reads the renormalized probabilities; the
    z-loss is the mean squared logsumexp of the router logits;
  - capacity: C = int(max(1, cf · T · k / E)) in Python floats, T counting
    padded positions too; an assignment's position in its expert is a
    cumsum over the token-major, then slot, flattening, so the same tokens
    drop; `fraction_dropped` = 1 − the kept share;
  - dropless: a stable sort of the T·k assignments by expert id, the three
    expert matmuls over each expert's contiguous rows, and a scatter-add of
    the gated outputs; `fraction_dropped` is 0.

Two choices differ from the JAX lowering, not its results:
  - the capacity path scatters the kept tokens into [E, C, H] and gathers
    the outputs back, where JAX builds a [T, E, C] one-hot dispatch and
    combines by einsum (at 16,384 tokens, 4 experts and cf 1.25 its
    [T, k, E, C] one-hot holds 1.34 G elements);
  - dropless runs one matmul per expert over its slice of the sorted rows,
    where JAX runs `jax.lax.ragged_dot`. The slices' bounds come from the
    group sizes, read on the host once a layer: a device-to-host sync each
    layer of each forward, decode steps included. A grouped-GEMM kernel
    waits for a profile that names it.

Every expert matmul is a batched product (`torch.bmm`), so the "selective"
recompute policy (ops/remat.py), which saves the outputs of `aten.mm`,
recomputes them, as the JAX policy `dots_with_no_batch_dims_saveable`
recomputes the batched einsums and `ragged_dot`; the router's product is an
`aten.mm` and stays saved.

Not ported: the expert-parallel dispatch (`_ep_mesh_axes`,
`_dropless_dispatch_ep`), which the JAX package takes only under a mesh
with an "expert" axis; the port has no mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dropless: bool = False
    aux_loss_coef: float = 1e-2
    z_loss_coef: float = 1e-3


def router_top_k(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] fp32 → (probabilities of the selected experts [T, k],
    their ids [T, k]): softmax over every expert, then top-k."""
    return torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)


def load_balancing_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch-style: E · Σ_e (share of the T·k assignments to e) · (sum of
    the probabilities routed to e / T)."""
    t, k = expert_ids.shape
    onehot = F.one_hot(expert_ids, num_experts).to(probs.dtype)   # [T, k, E]
    tokens_per_expert = onehot.sum(dim=(0, 1)) / (t * k)
    prob_per_expert = (onehot * probs[..., None]).sum(dim=(0, 1)) / t
    return num_experts * (tokens_per_expert * prob_per_expert).sum()


def z_loss(logits: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(logits, dim=-1).square().mean()


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., n, in] × w [..., out, in]ᵀ as a batched product, never
    `aten.mm` (see the module docstring)."""
    if x.dim() == 2:
        return torch.bmm(x[None], w.transpose(-1, -2)[None])[0]
    return torch.bmm(x, w.transpose(-1, -2))


def _experts(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU expert(s): x [(E,) n, H] → [(E,) n, H]."""
    return _expert_mm(F.silu(_expert_mm(x, w_gate)) * _expert_mm(x, w_up), w_down)


def _dropless_dispatch(experts: Dict[str, torch.Tensor], xt: torch.Tensor,
                       top_p: torch.Tensor, top_i: torch.Tensor) -> torch.Tensor:
    """Sort the T·k assignments by expert (stable), run each expert on its
    contiguous rows, scatter-add the gated outputs back to their tokens."""
    t, h = xt.shape
    k = top_i.shape[1]
    e = experts["w_gate"].shape[0]
    e_flat = top_i.reshape(t * k)
    sort_idx = torch.sort(e_flat, stable=True).indices
    tok_idx = sort_idx // k
    x_sorted = xt[tok_idx]                                         # [T·k, H]
    # the one host read of the layer: each expert's row count
    sizes = torch.bincount(e_flat, minlength=e).tolist()
    parts, start = [], 0
    for j, n in enumerate(sizes):
        if n:
            parts.append(_experts(x_sorted[start:start + n], experts["w_gate"][j],
                                  experts["w_up"][j], experts["w_down"][j]))
        start += n
    y_sorted = torch.cat(parts)                                    # [T·k, H]
    gates = top_p.reshape(t * k)[sort_idx].to(y_sorted.dtype)
    out = torch.zeros((t, h), dtype=y_sorted.dtype, device=xt.device)
    return out.index_add(0, tok_idx, y_sorted * gates[:, None])


def _capacity_dispatch(experts: Dict[str, torch.Tensor], xt: torch.Tensor,
                       top_p: torch.Tensor, top_i: torch.Tensor, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each expert takes its first `capacity` assignments in token-major,
    slot order; the rest are dropped (gate 0). Returns (out [T, H], keep
    [T, k])."""
    t, h = xt.shape
    k = top_i.shape[1]
    e = experts["w_gate"].shape[0]
    flat = F.one_hot(top_i.reshape(t * k), e)                      # [T·k, E]
    pos = ((torch.cumsum(flat, dim=0) * flat).amax(dim=-1) - 1).reshape(t, k)
    keep = pos < capacity
    gates = torch.where(keep, top_p, 0.0).to(xt.dtype)
    pos_clip = pos.clamp(max=capacity - 1)
    expert_in = xt.new_zeros((e, capacity, h))
    kept = keep.reshape(-1)
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    expert_in[top_i.reshape(-1)[kept], pos.reshape(-1)[kept]] = xt[tok[kept]]
    expert_out = _experts(expert_in, experts["w_gate"], experts["w_up"],
                          experts["w_down"])                       # [E, C, H]
    y = expert_out[top_i, pos_clip]                                # [T, k, H]
    # JAX's combine einsum: exact products of the gate (in x's dtype) and
    # the output, summed in fp32, rounded once
    out = (y.float() * gates.float()[..., None]).sum(dim=1)
    return out.to(xt.dtype), keep


def moe_layer(router_w: torch.Tensor, experts: Dict[str, torch.Tensor], cfg: MoEConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, H] → (output [B, S, H] in x's dtype, {aux_loss, z_loss,
    fraction_dropped}), the losses already scaled by their coefficients."""
    b, s, h = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(t, h)

    logits = xt.float() @ router_w.float().t()                    # [T, E]
    top_p, top_i = router_top_k(logits, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    aux = {"aux_loss": cfg.aux_loss_coef * load_balancing_loss(top_p, top_i, e),
           "z_loss": cfg.z_loss_coef * z_loss(logits)}

    if cfg.dropless:
        out = _dropless_dispatch(experts, xt, top_p, top_i)
        aux["fraction_dropped"] = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        capacity = int(max(1, cfg.capacity_factor * t * k / e))
        out, keep = _capacity_dispatch(experts, xt, top_p, top_i, capacity)
        aux["fraction_dropped"] = 1.0 - keep.float().mean()
    return out.reshape(b, s, h).to(x.dtype), aux
