"""The pipeline-parallel VLM train step, 1F1B (port of
leopard_tpu/training/pp.py).

The JAX package runs the whole schedule as one jitted SPMD program over the
"stage" mesh axis. Here each stage rank runs parallel/pipeline.py's
`pipeline_1f1b` over its own layers, with the exchange made explicit by a
transport: `P2PStages` over the mesh's "stage" group (one process a stage),
or `MemoryStages(n)`, n virtual stages in one process at a stage axis of
one (the card check of chip_smoke.py; never a production path). The rest
of the step is the same code for both.

Layout, as the JAX step's:
  - the embedding, the vision tower (in chunks of `vision_chunk` tiles, each
    under a checkpoint) and the splice run outside the pipeline on every
    stage rank; their backward takes the stage-reduced input gradients;
  - the decoder's layers are split over the stages, v chunks a stage when
    interleaved: global stage c·n + d holds layers [(c·n + d)·Lc,
    (c·n + d + 1)·Lc), Lc = L / (n·v);
  - the loss head (the final RMSNorm, then the chunked cross-entropy,
    returning the unnormalized (nll, w)) is fused into the last stage's
    forward tick. With tied embeddings it reads `embed_tokens`, and its
    gradient is added into the embedding's;
  - each stage's layers are the port's `DecoderLayer`s under
    `train_cfg.remat`: attention through the flash tier (K1 with its lse,
    K2 in the backward) on a CUDA tensor and its plain version on a CPU
    tensor, the dense tier below `long_seq_threshold`, as the decoder
    chooses; with seq > 1 and `attn_impl="ring"`, context parallelism: each
    seq rank holds a contiguous shard of the sequence (JAX "ring_local") and
    attends through `ring_attention(..., layout="contiguous")`;
  - tensor parallelism inside a stage over the mesh's "model" group, batch
    rows over "data" and "fsdp", as the sharded step (training/trainer.py);
  - with fsdp > 1 each stage's layers are sharded over the stage group's
    fsdp axis, and so is every non-layer tensor over the whole mesh's (the
    rules' placements): the compute copy gathers each master's fsdp shards
    (parallel/sharding.py::gather_fsdp), and each gradient, summed over the
    axes it is partial on, is cut to the master's own shard
    (`cut_to_shard`), as in the plain mesh step. The JAX package's tests
    never combine fsdp with stages; this step is held against its plain
    step;
  - Leopard-Idefics2 (JAX pp.py:135-181): the NaViT tower and the perceiver
    run on every stage rank outside the pipeline, over chunks of images,
    each chunk with its slice of `patch_mask` under one checkpoint
    (`encode_images` runs both, as JAX's `vlm.encode_images`); the latents
    are spliced at the image tokens and the loss skips image-token targets,
    as `trainer.vlm_loss`; Mistral's window bites in every stage's layers,
    through K1/K2 (or the ring's offset blocks under CP) on the card;
    `frozen=("perceiver",)` freezes the perceiver; the 32,003-row
    vocabulary is cut unevenly under TP as in the mesh step;
  - a stage rank's train state (`create_pp_train_state`) holds only its
    layers' masters and moments, DTensors on the mesh without its "stage"
    axis, and every non-layer tensor, replicated over "stage"; so each
    DTensor's replication is true, and the clip's global norm counts each
    element once.

One difference: the JAX step ignores a batch's "positions" (its RoPE reads
arange(S)); this step reads them when given, as `vlm_loss` does.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from leopard_tpu_torch.config import TrainConfig, VLMConfig
from leopard_tpu_torch.models.params import torch_dtype
from leopard_tpu_torch.models.vlm import splice_image_features
from leopard_tpu_torch.ops.attention import make_attention_mask
from leopard_tpu_torch.ops.flash_attention import tile_ranges
from leopard_tpu_torch.ops.norms import rms_norm
from leopard_tpu_torch.ops.remat import remat_wrap
from leopard_tpu_torch.ops.rotary import rope_cos_sin
from leopard_tpu_torch.parallel.pipeline import (
    MemoryStages, P2PStages, pipeline_1f1b, split_stages_interleaved,
)
from leopard_tpu_torch.training.trainer import (
    TrainState, _to_device, apply_sharded_gradients, check_mesh_supported, make_optimizer,
    nll_sum, sharded_compute_model, sharded_state,
)

_LAYER = re.compile(r"text\.layers\.(\d+)\.")


def layer_of(name: str) -> Optional[int]:
    """The decoder layer a parameter belongs to, or None."""
    hit = _LAYER.match(name)
    return int(hit.group(1)) if hit else None


def stage_layers(num_layers: int, n: int, v: int):
    """[v][n] lists of layer indices: chunk c of stage d."""
    if num_layers % (n * v):
        raise ValueError(f"{num_layers} layers do not split over {n} stages x {v} chunks")
    return split_stages_interleaved(list(range(num_layers)), n, v)


def _layout(mesh, stages):
    """(n, the stages this process runs): the mesh's "stage" axis (stages
    None), or the caller's MemoryStages at a stage axis of one."""
    from leopard_tpu_torch.parallel.mesh import STAGE_AXIS, axis_coord, axis_size

    if stages is None:
        return axis_size(mesh, STAGE_AXIS), (axis_coord(mesh, STAGE_AXIS),)
    if not isinstance(stages, MemoryStages):
        raise TypeError(f"stages must be None (the mesh's stage group) or MemoryStages, "
                        f"not {type(stages).__name__}")
    if axis_size(mesh, STAGE_AXIS) != 1:
        raise ValueError("MemoryStages runs every stage in this process: the mesh's stage "
                         "axis must be 1")
    return stages.n, stages.local


def _local_layers(num_layers, n, local, v):
    """{layer: (chunk, stage)} for the layers of the stages `local`."""
    layout = stage_layers(num_layers, n, v)
    return {i: (c, d) for c in range(v) for d in local for i in layout[c][d]}


def create_pp_train_state(model, train_cfg: TrainConfig, mesh, virtual_chunks: int = 1,
                          stages=None) -> TrainState:
    """The train state of this rank's stages, from `model` (whose other
    stages' layers may be on "meta"): fp32 masters and zero moments of
    every non-layer parameter, DTensors on `mesh` (replicated over
    "stage"), and of the layers of this rank's chunks (all of them with
    MemoryStages), DTensors on the mesh without its "stage" axis. `model`'s
    parameters become those DTensors in place; the other stages' layers go
    to "meta", never cut or copied."""
    from leopard_tpu_torch.parallel.mesh import STAGE_AXIS, drop_axis

    n, local = _layout(mesh, stages)
    mine = _local_layers(model.cfg.text.num_layers, n, local, virtual_chunks)
    stage_mesh = drop_axis(mesh, STAGE_AXIS)

    def mesh_of(name):
        i = layer_of(name)
        return mesh if i is None else stage_mesh if i in mine else None

    return sharded_state(model, mesh, mesh_of)


def make_pp_train_step(cfg: VLMConfig, train_cfg: TrainConfig, mesh,
                       num_microbatches: Optional[int] = None, frozen=(),
                       virtual_chunks: int = 1, vision_chunk: Optional[int] = 0,
                       stages=None):
    """Returns train_step(state, batch) → (state, metrics) over a state
    from `create_pp_train_state` (the same mesh, v and stages), on this
    rank's rows of the batch (parallel/sharding.py::local_rows);
    `train_step.loss_and_grads(state, batch)` gives (loss, metrics, this
    rank's fp32 grads) without the update.

    `num_microbatches` M (default: the stage count) must divide the rows;
    `virtual_chunks` v > 1 selects the interleaved schedule; `vision_chunk`
    is the tiles the tower encodes at a time, under a checkpoint: 0 means
    tiles / M, None one call. `stages`: None for the mesh's "stage" group,
    or `MemoryStages(n)` at a stage axis of one.

    Refused: one stage ("use make_train_step"), MoE (as JAX pp.py:82: the
    router's losses would have to ride the schedule), L not a multiple of
    n·v, and what `check_mesh_supported` refuses."""
    from leopard_tpu_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, SEQ_AXIS, Parallel
    from leopard_tpu_torch.parallel.sharding import all_reduce_batch, cut_to_shard

    tcfg = cfg.text
    n, local = _layout(mesh, stages)
    v = virtual_chunks
    if n == 1:
        raise ValueError("one pipeline stage: use make_train_step")
    if tcfg.num_experts > 0:
        raise NotImplementedError("MoE under the pipeline is not supported (nor in the JAX "
                                  "package): the router's losses would ride the schedule")
    check_mesh_supported(cfg, mesh)
    layout = stage_layers(tcfg.num_layers, n, v)
    where = _local_layers(tcfg.num_layers, n, local, v)
    if stages is None:
        stages = P2PStages.of(mesh)
    m_total = num_microbatches or n
    par = Parallel.of(mesh)
    cp = par.cp_size > 1
    opt = make_optimizer(train_cfg.optimizer)
    remat = False if train_cfg.remat == "none" else train_cfg.remat
    remat_vision = remat if train_cfg.remat_vision is None else train_cfg.remat_vision
    compute_model = sharded_compute_model(cfg, frozen, torch_dtype(tcfg.dtype), par)
    batch_axes = (DATA_AXIS, FSDP_AXIS)   # the axes that split the rows
    embed_axes = (*batch_axes, SEQ_AXIS) if cp else batch_axes

    def attn_impl(s):
        if cp:
            return "ring"
        if tcfg.attn_impl in ("flash", "dense", "chunked"):
            return tcfg.attn_impl
        return "flash" if s >= tcfg.long_seq_threshold else "dense"

    def layer_fn(chunk, x, a):
        """This stage's layers of one chunk on one microbatch."""
        for i, layer in chunk.items():
            x = remat_wrap(layer, remat)(
                x, tcfg, a["cos"], a["sin"], attn_impl=a["impl"], mask=a["mask"],
                segment_ids=a["seg"], ranges=a["ranges"], cache=None, layer_idx=int(i),
                slots=None, fresh_cache=False, ring_layout="contiguous" if cp else None)
        return x

    def head_fn(hp, y, a):
        """The final norm and the chunked cross-entropy: unnormalized (nll, w)."""
        h = rms_norm(y, hp["final_norm"], tcfg.rms_norm_eps)
        return (nll_sum(h, hp["lm_head"], a["targets"], a["w"], train_cfg.loss_chunk, par,
                        tcfg.vocab_size),
                a["w"].sum())

    def encode(m, images, patch_mask):
        """The tower over chunks of tiles, each under a checkpoint, so the
        backward holds one chunk's activations at a time."""
        count = images.shape[0]
        ck = count if vision_chunk is None else (vision_chunk or max(1, -(-count // m_total)))
        feats = []
        for i in range(0, count, ck):
            pm = None if patch_mask is None else patch_mask[i:i + ck]
            feats.append(torch.utils.checkpoint.checkpoint(
                m.encode_images, images[i:i + ck], pm, remat_vision, use_reentrant=False))
        return torch.cat(feats)

    def microbatch_constants(m, batch, s):
        """Per microbatch: RoPE, segment ids, the mask or the flash tiles,
        targets shifted onto the hidden positions (the last one weight 0)
        and their weights, zero at image-token targets and padding; with
        CP this rank's contiguous shard of each."""
        from leopard_tpu_torch.parallel.context_parallel import local_positions

        tokens = batch["tokens"]
        b, dev = tokens.shape[0], tokens.device
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=dev).expand(b, s)
        seg = batch.get("segment_ids")
        if seg is None:
            seg = torch.ones((b, s), dtype=torch.int32, device=dev)
        targets = F.pad(tokens[:, 1:], (0, 1))
        weights = F.pad(batch["loss_weights"][:, 1:].float()
                        * (tokens[:, 1:] != cfg.image_token_id) * (seg[:, 1:] != 0), (0, 1))
        cos, sin = rope_cos_sin(positions, m.text._rope_inv_freq(dev))
        if cp:
            idx = local_positions(s, par.cp_size, par.cp_rank, "contiguous").to(dev)
            seg, targets, weights = seg[:, idx], targets[:, idx], weights[:, idx]
            cos, sin = cos[:, idx], sin[:, idx]
        s_local = seg.shape[1]
        impl = attn_impl(s_local * par.cp_size)
        mb = b // m_total
        out = []
        for i in range(m_total):
            rows = slice(i * mb, (i + 1) * mb)
            sg = seg[rows]
            out.append({
                "cos": cos[rows], "sin": sin[rows], "seg": sg, "targets": targets[rows],
                "w": weights[rows], "impl": impl,
                "mask": make_attention_mask(s_local, s_local, causal=True, q_segment_ids=sg,
                                            kv_segment_ids=sg,
                                            sliding_window=tcfg.sliding_window, device=dev)
                if impl == "dense" else None,
                "ranges": tile_ranges(sg, sg, sq=s_local, skv=s_local, causal=True,
                                      window=tcfg.sliding_window, device=dev)
                if impl == "flash" else None})
        return out

    def loss_and_grads(state: TrainState, batch):
        from leopard_tpu_torch.parallel.context_parallel import local_positions
        from leopard_tpu_torch.parallel.tensor_parallel import vocab_parallel_embedding

        m = compute_model(state)
        mine = {layer_of(k) for k in state.params} - {None}
        if mine != set(where):
            raise ValueError(f"the state holds layers {sorted(mine)}, these stages run "
                             f"{sorted(where)}: build it with create_pp_train_state")
        batch = _to_device(batch, next(iter(state.params.values())).device)
        tokens = batch["tokens"]
        b, s = tokens.shape
        if b % m_total:
            raise ValueError(f"batch of {b} rows not divisible by {m_total} microbatches")

        # embedding, tower and splice, outside the pipeline, under autograd
        embeds = vocab_parallel_embedding(tokens.clamp(min=0), m.text.embed_tokens, par,
                                          tcfg.vocab_size)
        if batch.get("images") is not None:
            feats = encode(m, batch["images"], batch.get("patch_mask"))
            embeds = splice_image_features(embeds, feats, tokens == cfg.image_token_id)
        if cp:
            embeds = embeds[:, local_positions(s, par.cp_size, par.cp_rank,
                                               "contiguous").to(tokens.device)]
        xs = embeds.detach().reshape(m_total, b // m_total, *embeds.shape[1:])
        aux = microbatch_constants(m, batch, s)

        layers = m.text.layers
        stage_params = {d: [torch.nn.ModuleDict({str(i): layers[i] for i in layout[c][d]})
                            for c in range(v)] for d in stages.local}
        head_params = {"final_norm": m.text.final_norm, "lm_head": m.text.unembedding}
        res = pipeline_1f1b(layer_fn, head_fn, stage_params, head_params, xs, aux, stages,
                            v_chunks=v, seq_group=par.cp_group if cp else None)

        nll = all_reduce_batch(res["nll_sum"], mesh, batch_axes)
        total_w = torch.clamp(all_reduce_batch(res["w_sum"], mesh, batch_axes), min=1e-8)
        inv = 1.0 / total_w
        if embeds.requires_grad:
            embeds.backward(res["d_xs"].reshape(embeds.shape))

        # each gradient is summed over the axes its part is still partial on:
        # the pipeline's (layers, head) over data and fsdp; the embedding
        # side's (embedding, tower, perceiver) over those and, each seq rank
        # having back-propagated its own shard, seq; then cut to the master's
        # own fsdp shard
        grads = {}
        for name in state.params:
            p = m.get_parameter(name)
            i = layer_of(name)
            if i is not None:
                c, d = where[i]
                parts = [(res["d_stage"][d][c].get(name.split(".", 2)[2]), batch_axes)]
            elif name in ("text.final_norm", "text.lm_head"):
                parts = [(res["d_head"].get(name.split(".")[1]), batch_axes)]
            else:
                parts = [(None if p.grad is None else p.grad.float(), embed_axes)]
            if name == "text.embed_tokens" and tcfg.tie_word_embeddings:
                parts.append((res["d_head"].get("lm_head"), batch_axes))   # the tied head's
            p.grad = None
            g = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for part, axes in parts:
                if part is not None:
                    g += all_reduce_batch(part, mesh, axes)
            grads[name] = cut_to_shard(g.mul_(inv), state.params[name])
        loss = nll * inv
        return loss, {"loss": loss, "tokens_in_loss": total_w}, grads

    def train_step(state: TrainState, batch):
        loss, metrics, grads = loss_and_grads(state, batch)
        return apply_sharded_gradients(opt, state, grads, loss, metrics, frozen=frozen)

    train_step.loss_and_grads = loss_and_grads
    return train_step
