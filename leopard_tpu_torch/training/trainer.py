"""Training step: loss, optimizer, LR schedule, train state (port of
leopard_tpu/training/trainer.py).

The semantics are the JAX trainer's:
  - fp32 master params live in the train state; each step copies them into
    a compute model in the text config's dtype (bf16 at 8B), and the
    gradients are that model's cotangents upcast to fp32, as the VJP of the
    JAX package's `cast_for_compute` gives them;
  - loss = token cross-entropy weighted by per-token loss weights, averaged
    over the weighted tokens, computed chunk by chunk over the sequence so
    that no [B, S, V] logits exist;
  - the optimizer is optax's `chain(clip_by_global_norm, adamw)` written out:
    clipping by g · max / ‖g‖ when ‖g‖ ≥ max, Adam with bias correction,
    decoupled weight decay under the JAX path mask, and the schedule read at
    the update count before it is incremented (so a warmup from 0 gives the
    first step lr 0);
  - frozen groups get zero gradients and still go through AdamW;
  - a step whose loss or gradient norm is not finite leaves the params and
    the optimizer state, its count included, untouched, while `step` still
    advances.

One difference, for memory: the JAX state is immutable and every update
makes a new one; here `apply_gradients` updates the state's tensors in place
(at 8B width a functional update would need another ~28 GB) and consumes the
gradients it is given.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from leopard_tpu_torch.config import OptimizerConfig, TrainConfig, VLMConfig
from leopard_tpu_torch.models.params import torch_dtype
from leopard_tpu_torch.models.vlm import LeopardVLM

Tensors = Dict[str, torch.Tensor]

# optimizer math walks each tensor in flat slices of this many elements, so
# its temporaries stay small next to the 2 GB embedding and head at 8B
_SLICE = 1 << 26


@dataclasses.dataclass
class AdamWState:
    """optax's adamw state: the update count (shared by Adam's bias
    correction and the schedule, which advance together) and the moments."""

    count: int
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tensors        # fp32 master params, by state-dict name
    opt_state: AdamWState

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def lr_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """The JAX trainer's schedule as optax evaluates it at an update count."""

    def linear(init, end, steps):
        if steps <= 0:  # optax: a non-positive transition is the constant init
            return lambda count: init
        return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end

    if cfg.schedule == "cosine":
        warmup = linear(0.0, cfg.lr, cfg.warmup_steps)
        span = max(cfg.decay_steps, cfg.warmup_steps + 1) - cfg.warmup_steps
        alpha = 0.0 if cfg.lr == 0.0 else cfg.min_lr / cfg.lr

        def cosine(count):
            if count < cfg.warmup_steps:
                return warmup(count)
            t = min(count - cfg.warmup_steps, span)
            return cfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / span)) + alpha)

        return cosine
    if cfg.schedule == "linear":
        return linear(0.0, cfg.lr, cfg.warmup_steps)
    return lambda count: cfg.lr


def decay_mask(name: str, p: torch.Tensor) -> bool:
    """Weight decay only on matrix weights (JAX trainer.py:62-79): norm
    scales, biases and other vectors are exempt. The JAX check is on the
    path with a layer-stack axis; the port's names are dotted and its layers
    unstacked, so the path is the name with dots as slashes and the rank is
    the tensor's own."""
    if re.search(r"(norm|(^|/)b[a-z0-9]?$|bias|latents)", name.replace(".", "/")):
        return False
    return p.dim() >= 2


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    norms = torch._foreach_norm([g.float() for g in grads.values()])
    return torch.stack(norms).square().sum().sqrt()


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps, weight_decay, mask)) of the JAX trainer's `make_optimizer`."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)

    def init(self, params: Tensors) -> AdamWState:
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update_(self, grads: Tensors, state: AdamWState, params: Tensors,
                gnorm: torch.Tensor) -> None:
        """One update of `params` and `state`, in place; `gnorm` is the
        gradients' global norm."""
        cfg = self.cfg
        clip = None
        if cfg.grad_clip > 0 and not bool(gnorm < cfg.grad_clip):
            clip = gnorm.to(torch.float32)
        count = state.count + 1
        bc1 = 1.0 - cfg.beta1**count
        bc2 = 1.0 - cfg.beta2**count
        step_size = -self.schedule(state.count)
        for name, p in params.items():
            decay = cfg.weight_decay if cfg.weight_decay > 0 and decay_mask(name, p) else 0.0
            flat = (t.view(-1) for t in (p, grads[name], state.mu[name], state.nu[name]))
            for pp, g, m, v in zip(*(t.split(_SLICE) for t in flat)):
                if clip is not None:
                    g = g / clip * cfg.grad_clip
                m.mul_(cfg.beta1).add_(g, alpha=1 - cfg.beta1)
                v.mul_(cfg.beta2).add_(g * g, alpha=1 - cfg.beta2)
                u = (m / bc1) / ((v / bc2).sqrt_().add_(cfg.eps))
                if decay:
                    u.add_(pp, alpha=decay)
                pp.add_(u.mul_(step_size))
        state.count = count


def make_optimizer(cfg: OptimizerConfig) -> AdamW:
    return AdamW(cfg)


def create_train_state(params, cfg: TrainConfig) -> TrainState:
    """`params`: a module or a {name: tensor} mapping; they are copied as
    fp32 master params, on their own device."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    fp32 = {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}
    return TrainState(step=0, params=fp32, opt_state=make_optimizer(cfg.optimizer).init(fp32))


@torch.no_grad()
def cast_for_compute(params: Tensors, model: torch.nn.Module) -> torch.nn.Module:
    """Copy the fp32 masters into the compute model's parameters, rounding
    to their dtype as `astype` does."""
    for name, p in model.named_parameters():
        p.copy_(params[name])
    return model


def token_cross_entropy(
    logits: torch.Tensor,   # [B, S, V] (already shifted: predicts t+1)
    targets: torch.Tensor,  # [B, S] int
    weights: torch.Tensor,  # [B, S] float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weighted mean loss, total weight)."""
    nll = _weighted_nll(logits.float(), targets, weights)
    total_w = torch.clamp(weights.float().sum(), min=1e-8)
    return nll.sum() / total_w, total_w


def _weighted_nll(logits, targets, weights):
    logz = torch.logsumexp(logits, dim=-1)
    # weight-0 targets may be out-of-vocab sentinels (the JAX gather fills
    # NaN there): gather in range and drop them with a select
    idx = targets.long().clamp(0, logits.shape[-1] - 1)[..., None]
    true_logit = logits.gather(-1, idx)[..., 0]
    return torch.where(weights > 0, logz - true_logit, 0.0) * weights


def _chunk_nll(hx, unembed, tx, wx):
    return _weighted_nll(F.linear(hx.float(), unembed), tx, wx).sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,   # [B, S, H], before the unembedding
    unembed: torch.Tensor,  # [V, H], the lm_head in the port's layout
    targets: torch.Tensor,  # [B, S]
    weights: torch.Tensor,  # [B, S]
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without [B, S, V] logits: each sequence chunk's fp32
    logits are computed, reduced to a weighted NLL sum and dropped, and
    recomputed in the backward (a checkpoint per chunk), so peak memory is
    O(B · chunk · V). S is padded up to a chunk multiple with zero-weight
    positions, never shrunk to a divisor (JAX trainer.py:132-190: S − 1 is
    often prime)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        weights = F.pad(weights, (0, pad))
    weights = weights.float()
    unembed = unembed.float()
    nll_sum = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s + pad, chunk):
        nll_sum = nll_sum + torch.utils.checkpoint.checkpoint(
            _chunk_nll, hidden[:, i:i + chunk], unembed, targets[:, i:i + chunk],
            weights[:, i:i + chunk], use_reentrant=False)
    total_w = torch.clamp(weights.sum(), min=1e-8)
    return nll_sum / total_w, total_w


def vlm_loss(
    model: LeopardVLM,
    cfg: VLMConfig,
    batch: Mapping[str, Any],
    remat="full",
    loss_chunk: int = 1024,
    remat_vision=None,
):
    """batch: tokens [B, S], loss_weights [B, S], segment_ids [B, S],
    optional images [N, 3, H, W] and positions [B, S]. Next-token
    prediction: hidden[:, t] predicts tokens[:, t + 1]; image-token and
    padding targets carry weight 0. `model` holds the compute weights."""
    if batch.get("patch_mask") is not None:
        raise NotImplementedError("NaViT patch masks are not in the port yet")
    tokens = batch["tokens"]
    segment_ids = batch.get("segment_ids")
    hidden, _ = model(
        tokens, images=batch.get("images"), positions=batch.get("positions"),
        segment_ids=segment_ids, return_hidden=True, remat=remat, remat_vision=remat_vision,
    )
    targets = tokens[:, 1:]
    weights = batch["loss_weights"][:, 1:].float() * (targets != cfg.image_token_id)
    if segment_ids is not None:
        weights = weights * (segment_ids[:, 1:] != 0)
    loss, total_w = chunked_cross_entropy(
        hidden[:, :-1], model.text.lm_head, targets, weights, chunk=loss_chunk)
    return loss, {"loss": loss, "tokens_in_loss": total_w}


def _to_device(batch: Mapping[str, Any], device) -> Dict[str, Any]:
    return {k: (v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def make_train_step(cfg: VLMConfig, train_cfg: TrainConfig, frozen=(),
                    grad_accum_steps: int = 1, model: Optional[LeopardVLM] = None):
    """Returns train_step(state, batch) → (state, metrics). `frozen` names
    top-level param groups to freeze ("vision", "text", "projector").
    `grad_accum_steps` > 1 splits the batch's leading dim into microbatches
    and weights each microbatch's gradients by its tokens in the loss;
    images must then come pre-stacked [accum, tiles, 3, H, W].

    `model` is the compute copy to reuse (its weights are overwritten from
    the masters every step); without one, a model in the text config's
    dtype is built on the masters' device at the first step.
    `train_step.loss_and_grads(state, batch)` gives (loss, metrics, fp32
    grads) without the update, and `train_step.eval_loss(params, batch)`
    (loss, metrics) without gradients, the `loss_fn` of `evaluate_loss`."""
    opt = make_optimizer(train_cfg.optimizer)
    remat = False if train_cfg.remat == "none" else train_cfg.remat
    compute_dtype = torch_dtype(cfg.text.dtype)
    holder = {"model": model}

    def compute_model(state: TrainState) -> LeopardVLM:
        m = holder["model"]
        if m is None:
            device = next(iter(state.params.values())).device
            m = LeopardVLM(cfg, device="meta").to_empty(device=device).to(compute_dtype)
            holder["model"] = m
        cast_for_compute(state.params, m)
        for name, p in m.named_parameters():
            p.requires_grad_(name.split(".", 1)[0] not in frozen)
            p.grad = None
        return m

    def grads_of(m, scale=None, into=None) -> Tensors:
        """The compute model's grads upcast to fp32 (zeros where none),
        times `scale`, added into `into`; the compute grads are freed."""
        out = {} if into is None else into
        for name, p in m.named_parameters():
            g = p.grad.float() if p.grad is not None else torch.zeros(
                p.shape, dtype=torch.float32, device=p.device)
            p.grad = None
            if scale is not None:
                g = g * scale
            out[name] = g if into is None else out[name].add_(g)
        return out

    def loss_fn(m, mb):
        return vlm_loss(m, cfg, mb, remat, loss_chunk=train_cfg.loss_chunk,
                        remat_vision=train_cfg.remat_vision)

    def loss_and_grads(state: TrainState, batch):
        m = compute_model(state)
        batch = _to_device(batch, next(m.parameters()).device)
        if grad_accum_steps <= 1:
            loss, metrics = loss_fn(m, batch)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads_of(m)
        a = grad_accum_steps
        micro = {}
        for k, v in batch.items():
            if k in ("images", "patch_mask"):
                if v is not None and v.shape[0] != a:
                    raise ValueError(f"with grad accumulation, pass {k} as [{a}, tiles, ...]")
                micro[k] = v
            else:
                if v.shape[0] % a:
                    raise ValueError(f"batch {v.shape[0]} not divisible by grad_accum_steps={a}")
                micro[k] = v.reshape(a, v.shape[0] // a, *v.shape[1:])
        grads, nll, tw = None, 0.0, 0.0
        for i in range(a):
            loss, aux = loss_fn(m, {k: v[i] for k, v in micro.items() if v is not None})
            loss.backward()
            w = aux["tokens_in_loss"].detach()
            grads = grads_of(m, scale=w, into=grads)
            nll, tw = nll + loss.detach() * w, tw + w
        inv = 1.0 / torch.clamp(tw, min=1e-8)
        for g in grads.values():
            g.mul_(inv)
        loss = nll * inv
        return loss, {"loss": loss, "tokens_in_loss": tw}, grads

    @torch.no_grad()
    def eval_loss(params: Tensors, batch):
        m = compute_model(TrainState(step=0, params=params, opt_state=None))
        return loss_fn(m, _to_device(batch, next(m.parameters()).device))

    def train_step(state: TrainState, batch):
        loss, metrics, grads = loss_and_grads(state, batch)
        return apply_gradients(opt, state, grads, loss, metrics, frozen=frozen)

    train_step.loss_and_grads = loss_and_grads
    train_step.eval_loss = eval_loss
    return train_step


def apply_gradients(opt: AdamW, state: TrainState, grads: Tensors, loss, metrics,
                    frozen=()) -> Tuple[TrainState, dict]:
    """Freeze mask, clip and AdamW update, NaN-step skip: the shared tail of
    every train step. Updates `state` in place and returns it with the step
    advanced."""
    if frozen:
        for k in grads:
            if k.split(".", 1)[0] in frozen:
                grads[k] = torch.zeros_like(grads[k])
    gnorm = global_norm(grads)
    metrics = dict(metrics)
    metrics["grad_norm"] = gnorm
    loss_ok = bool(torch.isfinite(torch.as_tensor(loss)))
    metrics["nan_step"] = not loss_ok
    if loss_ok and bool(torch.isfinite(gnorm)):
        opt.update_(grads, state.opt_state, state.params, gnorm)
    return state.replace(step=state.step + 1), metrics
