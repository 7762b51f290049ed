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

Under a device mesh (`create_train_state(..., mesh=)`, `make_train_step(...,
mesh=)`; JAX trainer.py:193-277 jitted with the rules' shardings) the fp32
masters and both moments are DTensors placed by the rules
(parallel/sharding.py), and each rank runs one process:
  - the step takes this rank's rows of the batch (its (data, fsdp)
    coordinate's, `parallel/sharding.py::local_rows`; ranks that differ in
    seq or model read the same rows);
  - the compute model holds each master's fsdp shards gathered and its model
    shard kept, and runs the tensor-parallel forward; with
    `attn_impl="ring"` the decoder keeps this rank's shard of the sequence
    and attends through the ring over the seq axis, and the loss reads the
    same shard of the targets;
  - the loss is this rank's weighted NLL over the whole batch's weight, the
    vocab-parallel chunked cross-entropy, plus, with experts, this rank's
    terms of the global aux and z losses (ops/moe.py: the router's
    statistics are summed over data, fsdp and seq before they combine);
    each gradient is summed over data, fsdp and seq and cut to the master's
    own shard, so it keeps the parameter's placements; an expert bank's
    gradient arrives whole on the rank that holds its experts, through the
    backward of the dispatch's all-to-all;
  - Leopard-Idefics2 rows carry their whole images and patch masks
    (`local_rows` with the perceiver's `num_latents` tokens an image), and
    the perceiver runs tensor-parallel like the towers;
  - with `grad_accum_steps` > 1 the rows are `local_rows(..., accum=)`'s,
    microbatch-major, each microbatch's gradients weighted by its global
    tokens in the loss and summed over the batch axes once, after the last;
  - the clip's global norm sums every shard once, and AdamW runs on the
    local shards in place.
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
from leopard_tpu_torch.utils.timers import span

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

    def clip_of(self, gnorm: torch.Tensor) -> Optional[torch.Tensor]:
        """The clip's divisor, the global norm `gnorm` in fp32, where it is
        at or over `grad_clip`; None below it or without a clip. Reads
        `gnorm` on the host."""
        if self.cfg.grad_clip > 0 and not bool(gnorm < self.cfg.grad_clip):
            return gnorm.to(torch.float32)
        return None

    @torch.no_grad()
    def update_(self, grads: Tensors, state: AdamWState, params: Tensors,
                gnorm: torch.Tensor) -> None:
        """One update of `params` and `state`, in place; `gnorm` is the
        gradients' global norm."""
        self.update_clipped_(grads, state, params, self.clip_of(gnorm))

    @torch.no_grad()
    def update_clipped_(self, grads: Tensors, state: AdamWState, params: Tensors,
                        clip: Optional[torch.Tensor]) -> None:
        """`update_` with the clip's divisor given (`clip_of`)."""
        cfg = self.cfg
        count = state.count + 1
        bc1 = 1.0 - cfg.beta1**count
        bc2 = 1.0 - cfg.beta2**count
        step_size = -self.schedule(state.count)
        with span("train.adamw"):
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


def create_train_state(params, cfg: TrainConfig, mesh=None) -> TrainState:
    """`params`: a module or a {name: tensor} mapping; they are copied as
    fp32 master params, on their own device. With `mesh`, a module's
    parameters are first made DTensors by the rules (FSDP when the mesh's
    fsdp axis is > 1), and the masters and moments are DTensors of the same
    placements."""
    if mesh is not None:
        if not isinstance(params, torch.nn.Module):
            raise TypeError("create_train_state(mesh=...) takes the model")
        return sharded_state(params, mesh)
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    fp32 = {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}
    return TrainState(step=0, params=fp32, opt_state=make_optimizer(cfg.optimizer).init(fp32))


def sharded_state(model: torch.nn.Module, mesh, mesh_of: Optional[Callable] = None
                  ) -> TrainState:
    """The train state of `model` under `mesh`: its parameters made
    DTensors by the rules, in place, then fp32 masters and zero moments of
    the same placements. `mesh_of` as in parallel/sharding.py::shard_params:
    the parameters it gives no mesh go to "meta" and take no master."""
    from leopard_tpu_torch.parallel.mesh import FSDP_AXIS, axis_size
    from leopard_tpu_torch.parallel.sharding import like, shard_params

    shard_params(model, mesh, fsdp=axis_size(mesh, FSDP_AXIS) > 1, mesh_of=mesh_of)
    fp32 = {k: like(p, p.to_local().detach().to(torch.float32, copy=True))
            for k, p in model.named_parameters() if not p.is_meta}
    zeros = lambda: {k: like(p, torch.zeros_like(p.to_local()))  # noqa: E731
                     for k, p in fp32.items()}
    return TrainState(step=0, params=fp32, opt_state=AdamWState(0, zeros(), zeros()))


@torch.no_grad()
def cast_for_compute(params: Tensors, model: torch.nn.Module) -> torch.nn.Module:
    """Copy the fp32 masters into the compute model's parameters, rounding
    to their dtype as `astype` does. Its span opens each step."""
    with span("train.cast"):
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
    with span("train.loss") as sp:
        # the loss's device time runs on through its chunks' recompute and
        # backward, which end when `hidden`'s gradient is ready
        sp.end_at_grad(hidden)
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
    optional images [N, 3, H, W] (with Idefics2's patch_mask [N, H/p, W/p])
    and positions [B, S]. Next-token prediction: hidden[:, t] predicts
    tokens[:, t + 1]; image-token and padding targets carry weight 0.
    `model` holds the compute weights. The unembedding is `lm_head`, or
    `embed_tokens` when tied (its gradient then sums both uses). With
    experts, the returned loss adds the decoder's aux and z losses, and the
    metrics carry them and the dropped share (JAX trainer.py:213-248); the
    metric "loss" stays the cross-entropy."""
    tokens = batch["tokens"]
    segment_ids = batch.get("segment_ids")
    moe = cfg.text.num_experts > 0
    hidden, _, moe_aux = model(
        tokens, images=batch.get("images"), patch_mask=batch.get("patch_mask"),
        positions=batch.get("positions"), segment_ids=segment_ids, return_hidden=True,
        remat=remat, remat_vision=remat_vision, return_aux=True,
    )
    targets = tokens[:, 1:]
    weights = batch["loss_weights"][:, 1:].float() * (targets != cfg.image_token_id)
    if segment_ids is not None:
        weights = weights * (segment_ids[:, 1:] != 0)
    loss, total_w = chunked_cross_entropy(
        hidden[:, :-1], model.text.unembedding, targets, weights, chunk=loss_chunk)
    metrics = {"loss": loss, "tokens_in_loss": total_w}
    if moe:
        loss = loss + moe_aux["aux_loss"] + moe_aux["z_loss"]
        metrics["moe_aux_loss"] = moe_aux["aux_loss"]
        metrics["moe_z_loss"] = moe_aux["z_loss"]
        metrics["moe_fraction_dropped"] = moe_aux["fraction_dropped"]
    return loss, metrics


def _to_device(batch: Mapping[str, Any], device) -> Dict[str, Any]:
    return {k: (v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


STACKED = ("images", "patch_mask")


def split_microbatches(batch, accum: int) -> list:
    """The batch's rows split into `accum` microbatches (JAX
    trainer.py:280-330); images and patch_mask come pre-stacked [accum,
    tiles, ...] and each microbatch takes its entry."""
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} not divisible by grad_accum_steps={accum}")
    for k in STACKED:
        if batch.get(k) is not None and batch[k].shape[0] != accum:
            raise ValueError(f"with grad accumulation, pass {k} as [{accum}, tiles, ...]")
    n = b // accum
    return [{k: (v[i] if k in STACKED else v[i * n:(i + 1) * n])
             for k, v in batch.items() if v is not None} for i in range(accum)]


def grads_of(m: torch.nn.Module, scale=None, into=None) -> Tensors:
    """The compute model's grads upcast to fp32 (zeros where none), times
    `scale`, added into `into`; the compute grads are freed."""
    out = {} if into is None else into
    with span("train.grads"):
        for name, p in m.named_parameters():
            g = p.grad.float() if p.grad is not None else torch.zeros(
                p.shape, dtype=torch.float32, device=p.device)
            p.grad = None
            if scale is not None:
                g = g * scale
            out[name] = g if into is None else out[name].add_(g)
    return out


def accumulate(m: torch.nn.Module, micros, run) -> Tuple[torch.Tensor, dict, Tensors]:
    """Grad accumulation: `run(m, mb)` gives (the loss to backward, the
    microbatch's loss, its metrics with "tokens_in_loss"). Each
    microbatch's grads, loss and MoE losses are weighted by its tokens in
    the loss; the dropped share is the worst microbatch's (the JAX trainer
    drops the MoE metrics under accumulation). Returns (loss, metrics,
    fp32 grads)."""
    grads, nll, tw, moe = None, 0.0, 0.0, {}
    for mb in micros:
        backward, loss, aux = run(m, mb)
        with span("train.backward"):
            backward.backward()
        w = aux["tokens_in_loss"].detach()
        grads = grads_of(m, scale=w, into=grads)
        nll, tw = nll + loss.detach() * w, tw + w
        for k in ("moe_aux_loss", "moe_z_loss"):
            if k in aux:
                moe[k] = moe.get(k, 0.0) + aux[k].detach() * w
        if "moe_fraction_dropped" in aux:
            f = aux["moe_fraction_dropped"].detach()
            moe["moe_fraction_dropped"] = torch.maximum(moe.get("moe_fraction_dropped", f), f)
    inv = 1.0 / torch.clamp(tw, min=1e-8)
    for g in grads.values():
        g.mul_(inv)
    loss = nll * inv
    for k in ("moe_aux_loss", "moe_z_loss"):
        if k in moe:
            moe[k] = moe[k] * inv
    return loss, {"loss": loss, "tokens_in_loss": tw, **moe}, grads


def make_train_step(cfg: VLMConfig, train_cfg: TrainConfig, frozen=(),
                    grad_accum_steps: int = 1, model: Optional[LeopardVLM] = None,
                    mesh=None):
    """Returns train_step(state, batch) → (state, metrics). `frozen` names
    top-level param groups to freeze: "vision", "text" and "projector" of
    Leopard-LLaVA, "vision", "perceiver" and "text" of Leopard-Idefics2.
    `grad_accum_steps` > 1 splits the batch's leading dim into microbatches
    and weights each microbatch's gradients by its tokens in the loss;
    images and patch_mask must then come pre-stacked [accum, tiles, ...].

    `model` is the compute copy to reuse (its weights are overwritten from
    the masters every step); without one, a model in the text config's
    dtype is built on the masters' device at the first step.
    `train_step.loss_and_grads(state, batch)` gives (loss, metrics, fp32
    grads) without the update, and `train_step.eval_loss(params, batch)`
    (loss, metrics) without gradients, the `loss_fn` of `evaluate_loss`.

    `mesh`: the sharded step (module docstring) over a state from
    `create_train_state(..., mesh=)`, on this rank's rows of the batch
    (`parallel/sharding.py::local_rows`, with `accum=grad_accum_steps`
    under accumulation); its grads are the masters' local shards. Attention takes the ring over the
    mesh's "seq" axis only when `cfg.text.attn_impl == "ring"` (JAX
    trainer.py:270-271, whose `cp_mesh`/`cp_axis` the mesh replaces)."""
    if mesh is not None:
        return _sharded_train_step(cfg, train_cfg, frozen, grad_accum_steps, mesh)
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

    def loss_fn(m, mb):
        return vlm_loss(m, cfg, mb, remat, loss_chunk=train_cfg.loss_chunk,
                        remat_vision=train_cfg.remat_vision)

    def loss_and_grads(state: TrainState, batch):
        m = compute_model(state)
        batch = _to_device(batch, next(m.parameters()).device)
        if grad_accum_steps <= 1:
            loss, metrics = loss_fn(m, batch)
            with span("train.backward"):
                loss.backward()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads_of(m)

        def run(m, mb):
            loss, aux = loss_fn(m, mb)
            return loss, loss, aux

        return accumulate(m, split_microbatches(batch, grad_accum_steps), run)

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


def check_mesh_supported(cfg: VLMConfig, mesh) -> None:
    """Refuse what training does not run under a mesh; the pipeline
    (stage > 1) refuses more of its own. Serving checks `check_divisible`
    alone (inference/engine.py)."""
    from leopard_tpu_torch.parallel.mesh import mesh_config

    check_divisible(cfg, mesh)
    if mesh_config(mesh).seq > 1 and cfg.text.attn_impl != "ring":
        raise NotImplementedError("the port shards the sequence only through the ring: "
                                  "seq > 1 takes text.attn_impl='ring'")


def check_divisible(cfg: VLMConfig, mesh) -> None:
    """The mesh's expert axis must divide the experts and its model axis
    every head count it cuts."""
    from leopard_tpu_torch.parallel.mesh import mesh_config

    m = mesh_config(mesh)
    e = cfg.text.num_experts
    if m.expert > 1 and e and e % m.expert:
        raise ValueError(f"{e} experts must divide over expert-axis size {m.expert}")
    heads = {"kv heads": cfg.text.num_kv_heads, "vision heads": cfg.vision.num_heads}
    if cfg.perceiver is not None:
        heads.update({"perceiver heads": cfg.perceiver.num_heads,
                      "perceiver kv heads": cfg.perceiver.num_kv_heads})
    if m.model > 1 and any(n % m.model for n in heads.values()):
        raise ValueError(f"model={m.model} does not divide the " + ", the ".join(
            f"{k} ({n})" for k, n in heads.items()))


def _chunk_nll_tp(hx, unembed, tx, wx, par, vocab):
    from leopard_tpu_torch.parallel.tensor_parallel import copy_to_tp, vocab_parallel_logz

    logits = F.linear(copy_to_tp(hx, par).float(), unembed)
    logz, true = vocab_parallel_logz(logits, tx, par, vocab)
    return (torch.where(wx > 0, logz - true, 0.0) * wx).sum()


def nll_sum(hidden, unembed, targets, weights, chunk: int, par,
            vocab: int) -> torch.Tensor:
    """The weighted NLL summed over [B, S] positions, without [B, S, V]
    logits: each sequence chunk's fp32 logits (this rank's vocab columns
    under tensor parallelism; `vocab` the whole vocabulary) are computed,
    reduced and dropped, and recomputed in the backward. S is padded to a
    chunk multiple with weight 0."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets, weights = F.pad(targets, (0, pad)), F.pad(weights, (0, pad))
    unembed = unembed.float()
    nll = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s + pad, chunk):
        nll = nll + torch.utils.checkpoint.checkpoint(
            _chunk_nll_tp, hidden[:, i:i + chunk], unembed, targets[:, i:i + chunk],
            weights[:, i:i + chunk], par, vocab, use_reentrant=False)
    return nll


def sharded_compute_model(cfg: VLMConfig, frozen, compute_dtype, par) -> Callable:
    """compute_model(state): the compute copy of a sharded state's masters
    (parallel/sharding.py::gather_fsdp, in the compute dtype), built on
    "meta" at the first call and refreshed in place after; parameters that
    the state does not hold stay on "meta". Frozen groups take no grad."""
    from leopard_tpu_torch.parallel.mesh import set_parallel
    from leopard_tpu_torch.parallel.sharding import _set, gather_fsdp

    holder = {}

    def compute_model(state: TrainState) -> LeopardVLM:
        m = holder.get("model")
        with torch.no_grad():
            if m is None:
                m = LeopardVLM(cfg, device="meta")
                for name, master in state.params.items():
                    _set(m, name, torch.nn.Parameter(gather_fsdp(master).to(compute_dtype)))
                holder["model"] = set_parallel(m, par)
            else:
                for name, master in state.params.items():
                    m.get_parameter(name).copy_(gather_fsdp(master))
        for name in state.params:
            p = m.get_parameter(name)
            p.requires_grad_(name.split(".", 1)[0] not in frozen)
            p.grad = None
        return m

    return compute_model


def _sharded_train_step(cfg, train_cfg, frozen, grad_accum_steps, mesh):
    """make_train_step under a mesh (module docstring)."""
    from leopard_tpu_torch.parallel.context_parallel import local_positions, pick_layout
    from leopard_tpu_torch.parallel.mesh import Parallel, mesh_config
    from leopard_tpu_torch.parallel.sharding import all_reduce_batch, reduce_to_shard

    check_mesh_supported(cfg, mesh)
    if mesh_config(mesh).stage > 1:
        raise NotImplementedError("stage > 1 is the 1F1B pipeline: train with "
                                  "training.pp.make_pp_train_step")
    opt = make_optimizer(train_cfg.optimizer)
    remat = False if train_cfg.remat == "none" else train_cfg.remat
    par = Parallel.of(mesh)
    ring = cfg.text.attn_impl == "ring"
    moe = cfg.text.num_experts > 0
    compute_model = sharded_compute_model(cfg, frozen, torch_dtype(cfg.text.dtype), par)

    def global_value(t):
        return all_reduce_batch(t.detach().clone(), mesh)

    def loss_parts(m, batch):
        """(this rank's share of the global loss: its NLL over the batch's
        whole weight, plus its terms of the MoE losses; the metrics, global:
        the loss without the MoE losses, as `vlm_loss` reports it)."""
        tokens = batch["tokens"]
        seg = batch.get("segment_ids")
        hidden, _, aux = m(tokens, images=batch.get("images"),
                           patch_mask=batch.get("patch_mask"), positions=batch.get("positions"),
                           segment_ids=seg, return_hidden=True, remat=remat,
                           remat_vision=train_cfg.remat_vision, return_aux=True)
        # targets at every position (the last one weight 0), so that a
        # shard of the sequence takes its targets by the same positions
        targets = F.pad(tokens[:, 1:], (0, 1))
        weights = batch["loss_weights"][:, 1:].float() * (tokens[:, 1:] != cfg.image_token_id)
        if seg is not None:
            weights = weights * (seg[:, 1:] != 0)
        weights = F.pad(weights, (0, 1))
        if ring:
            s = tokens.shape[1]
            idx = local_positions(s, par.cp_size, par.cp_rank,
                                  pick_layout(s, par.cp_size)).to(tokens.device)
            targets, weights = targets[:, idx], weights[:, idx]
        nll = nll_sum(hidden, m.text.unembedding, targets, weights, train_cfg.loss_chunk, par,
                      cfg.text.vocab_size)
        total_w = torch.clamp(global_value(weights.sum()), min=1e-8)
        local = nll / total_w
        metrics = {"loss": global_value(nll) / total_w, "tokens_in_loss": total_w}
        if moe:
            local = local + aux["aux_loss"] + aux["z_loss"]
            metrics["moe_aux_loss"] = global_value(aux["aux_loss"])
            metrics["moe_z_loss"] = global_value(aux["z_loss"])
            metrics["moe_fraction_dropped"] = aux["fraction_dropped"].detach()
        return local, metrics

    def total(metrics):
        """The global loss the step minimizes: the cross-entropy plus the
        MoE losses."""
        if not moe:
            return metrics["loss"]
        return metrics["loss"] + metrics["moe_aux_loss"] + metrics["moe_z_loss"]

    def loss_and_grads(state: TrainState, batch):
        m = compute_model(state)
        batch = _to_device(batch, next(m.parameters()).device)
        if grad_accum_steps <= 1:
            local_loss, metrics = loss_parts(m, batch)
            local_loss.backward()
            acc, loss = grads_of(m), total(metrics)
        else:
            # each microbatch's gradients weighted by its global tokens in
            # the loss; reduced once at the end
            def run(m, mb):
                local_loss, mm = loss_parts(m, mb)
                return local_loss, total(mm), mm

            loss, metrics, acc = accumulate(m, split_microbatches(batch, grad_accum_steps), run)
        grads = {name: reduce_to_shard(g, state.params[name]) for name, g in acc.items()}
        return loss, metrics, grads

    @torch.no_grad()
    def eval_loss(params: Tensors, batch):
        m = compute_model(TrainState(step=0, params=params, opt_state=None))
        _, metrics = loss_parts(m, _to_device(batch, next(m.parameters()).device))
        return total(metrics), metrics

    def train_step(state: TrainState, batch):
        loss, metrics, grads = loss_and_grads(state, batch)
        return apply_sharded_gradients(opt, state, grads, loss, metrics, frozen=frozen)

    train_step.loss_and_grads = loss_and_grads
    train_step.eval_loss = eval_loss
    return train_step


def apply_sharded_gradients(opt: AdamW, state: TrainState, grads: Tensors, loss, metrics,
                            frozen=()) -> Tuple[TrainState, dict]:
    """apply_gradients for a sharded state whose grads are the masters'
    local shards: the clip's global norm sums every rank's squares, each
    divided by its DTensor's replication (the ranks that hold each
    element), and AdamW runs on the local shards in place."""
    from leopard_tpu_torch.parallel.sharding import replication

    if frozen:
        for k in grads:
            if k.split(".", 1)[0] in frozen:
                grads[k].zero_()
    sq = torch.stack([g.float().square().sum() / replication(state.params[k])
                      for k, g in grads.items()]).sum()
    torch.distributed.all_reduce(sq)
    gnorm = sq.sqrt()
    metrics = dict(metrics, grad_norm=gnorm)
    loss_ok = bool(torch.isfinite(loss))
    metrics["nan_step"] = not loss_ok
    if loss_ok and bool(torch.isfinite(gnorm)):
        st = state.opt_state
        local = AdamWState(st.count, {k: t.to_local() for k, t in st.mu.items()},
                           {k: t.to_local() for k, t in st.nu.items()})
        opt.update_(grads, local, {k: p.to_local() for k, p in state.params.items()}, gnorm)
        st.count = local.count
    return state.replace(step=state.step + 1), metrics


def apply_gradients(opt: AdamW, state: TrainState, grads: Tensors, loss, metrics,
                    frozen=()) -> Tuple[TrainState, dict]:
    """Freeze mask, clip and AdamW update, NaN-step skip: the shared tail of
    every train step. Updates `state` in place and returns it with the step
    advanced."""
    if frozen:
        for k in grads:
            if k.split(".", 1)[0] in frozen:
                grads[k] = torch.zeros_like(grads[k])
    with span("train.norm"):
        gnorm = global_norm(grads)
        loss_ok = bool(torch.isfinite(torch.as_tensor(loss)))
        step_ok = loss_ok and bool(torch.isfinite(gnorm))
        clip = opt.clip_of(gnorm) if step_ok else None
    metrics = dict(metrics)
    metrics["grad_norm"] = gnorm
    metrics["nan_step"] = not loss_ok
    if step_ok:
        opt.update_clipped_(grads, state.opt_state, state.params, clip)
    return state.replace(step=state.step + 1), metrics
