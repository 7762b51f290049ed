"""The sharding rules, read as DTensor placements (port of
leopard_tpu/parallel/sharding.py).

The JAX package keeps every parameter at its full logical shape and maps
each path of its parameter tree to a `PartitionSpec` through a table of
rules; GSPMD inserts the collectives. The port keeps the same table, read
against its own names, and stores each parameter as a DTensor whose local
shard is the one that JAX places on the device with the same mesh
coordinate:

  - the rules are the JAX ones, on the JAX paths: the port's
    `text.layers.3.attn.wq` is JAX `text/layers/attn/wq`;
  - a spec is right-aligned to the leaf, then FSDP takes the first dim it
    leaves replicated that the fsdp size divides (`_normalize`), on the JAX
    leaf's shape, [in, out] for a weight matrix; the port keeps matrices
    [out, in] (models/params.py), so the spec is transposed back;
  - the port's layers are separate tensors, so the rules apply to one
    layer's leaf as they apply to an unstacked JAX tree. JAX's stacked
    leaves [L, in, out] put FSDP on the layer axis, which a per-layer tensor
    does not have; here it lands on the first replicated dim of the layer's
    own weight;
  - a dim sharded over two axes lists them major first, as JAX does: the
    embedding table's vocab is over ("model", "fsdp"), so its shards are
    model-major, which DTensor says with a `_StridedShard` on the fsdp axis.

Only parameters are DTensors. The forward runs on plain local tensors
(parallel/tensor_parallel.py): `gather_fsdp` gives the compute copy of one
parameter (its fsdp shards gathered, its model shard kept), and
`reduce_to_shard` brings a gradient of that copy back to the parameter's
own shard, summed over the axes that split the batch.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from leopard_tpu_torch.parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, MODEL_AXIS, SEQ_AXIS, axis_coord, axis_group, axis_size,
)

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# Ordered (regex, spec) rules on "/"-joined JAX paths; the first match wins
# (a copy of the JAX DEFAULT_RULES, spec for spec).
DEFAULT_RULES: list[tuple[str, Spec]] = [
    # int8-quantized weights: the payload shards like its parent, the
    # per-output-channel scales are replicated
    (r".*/(wq|wk|wv|w_gate|w_up|fc1|lm_head)/q$", (None, MODEL_AXIS)),
    (r".*/(wo|w_down|fc2)/q$", (MODEL_AXIS, None)),
    (r".*/(wq|wk|wv|wo|w_gate|w_up|w_down|fc1|fc2|lm_head)/s$", ()),
    # decoder / encoder attention
    (r"(.*/)?attn/wq$", (None, MODEL_AXIS)),
    (r"(.*/)?attn/wk$", (None, MODEL_AXIS)),
    (r"(.*/)?attn/wv$", (None, MODEL_AXIS)),
    (r"(.*/)?attn/wo$", (MODEL_AXIS, None)),
    (r"(.*/)?attn/bq$", (MODEL_AXIS,)),
    (r"(.*/)?attn/bk$", (MODEL_AXIS,)),
    (r"(.*/)?attn/bv$", (MODEL_AXIS,)),
    (r"(.*/)?attn/bo$", (None,)),
    # MLP
    (r"(.*/)?mlp/w_gate$", (None, MODEL_AXIS)),
    (r"(.*/)?mlp/w_up$", (None, MODEL_AXIS)),
    (r"(.*/)?mlp/w_down$", (MODEL_AXIS, None)),
    (r"(.*/)?mlp/fc1$", (None, MODEL_AXIS)),
    (r"(.*/)?mlp/fc2$", (MODEL_AXIS, None)),
    (r"(.*/)?mlp/b1$", (MODEL_AXIS,)),
    (r"(.*/)?mlp/b2$", (None,)),
    # MoE experts: the expert dim over "expert", then column/row over model
    (r"(.*/)?experts/w_gate$", ("expert", None, MODEL_AXIS)),
    (r"(.*/)?experts/w_up$", ("expert", None, MODEL_AXIS)),
    (r"(.*/)?experts/w_down$", ("expert", MODEL_AXIS, None)),
    (r"(.*/)?router/.*$", ()),
    # embeddings / output head: vocab-parallel; the table's vocab over
    # model × fsdp jointly, its hidden dim replicated
    (r".*embed_tokens$", ((MODEL_AXIS, FSDP_AXIS), None)),
    (r".*lm_head$", (None, MODEL_AXIS)),
    # projector
    (r"(.*/)?projector/fc1$", (None, MODEL_AXIS)),
    (r"(.*/)?projector/fc2$", (MODEL_AXIS, None)),
    (r"(.*/)?projector/b1$", (MODEL_AXIS,)),
    # the vision patchify conv and position table: replicated
    (r".*patch_embed.*$", ()),
    (r".*pos_embed.*$", ()),
    # perceiver latents
    (r".*latents$", ()),
    # norms, scalars, everything else
    (r".*", ()),
]

# replicated even under FSDP (a few MB at 8B; the JAX package keeps them
# whole so that no lookup reshards its output)
_NO_FSDP_RE = re.compile(r".*(patch_embed|pos_embed|embed_tokens).*")

# leaves the port stores [out, in] where the JAX tree has [in, out]
# (convert/from_jax.py::LINEAR_LEAVES; the router's `w` too)
_MATRIX_LEAVES = frozenset({"kernel", "wq", "wk", "wv", "wo", "fc1", "fc2",
                            "w_gate", "w_up", "w_down", "lm_head"})


def jax_path(name: str) -> str:
    """The port's state-dict name → the JAX tree path the rules read:
    dots to slashes, the layer index dropped (`text.layers.3.attn.wq` →
    `text/layers/attn/wq`)."""
    parts = name.split(".")
    if "layers" in parts:
        at = parts.index("layers") + 1
        if at < len(parts) and parts[at].isdigit():
            del parts[at]
    return "/".join(parts)


def _is_matrix(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] in _MATRIX_LEAVES or tuple(parts[-2:]) == ("router", "w")


def spec_for_path(path: str, rules=None) -> Spec:
    for pattern, spec in DEFAULT_RULES if rules is None else rules:
        if re.fullmatch(pattern, path):
            return spec
    return ()


def _normalize(spec: Spec, shape: Sequence[int], fsdp_size: int) -> Spec:
    """Right-align the spec to the leaf's rank, then FSDP-shard the first
    still-replicated dim whose size the fsdp size divides (fsdp_size > 1)."""
    ndim = len(shape)
    parts = [None] * max(0, ndim - len(spec)) + list(spec)
    parts = parts[:ndim] if ndim else list(spec)
    if fsdp_size > 1 and ndim:
        for i, p in enumerate(parts):
            if p is None and shape[i] % fsdp_size == 0:
                parts[i] = FSDP_AXIS
                break
    return tuple(parts)


def param_spec(name: str, shape: Sequence[int], rules=None, fsdp: bool = False,
               fsdp_size: int = 2) -> Spec:
    """The spec of one port tensor, in the port's layout: the JAX spec of
    the same leaf (one layer's), transposed where the port transposes."""
    shape = tuple(shape)
    matrix = _is_matrix(name)
    jshape = shape[:-2] + shape[:-3:-1] if matrix else shape
    path = jax_path(name)
    no_fsdp = not fsdp or _NO_FSDP_RE.fullmatch(path)
    spec = _normalize(spec_for_path(path, rules), jshape, 1 if no_fsdp else fsdp_size)
    return spec[:-2] + spec[:-3:-1] if matrix and len(spec) >= 2 else spec


def param_specs(model: torch.nn.Module, rules=None, fsdp: bool = False,
                fsdp_size: int = 2) -> Dict[str, Spec]:
    """{state-dict name: spec} for every parameter and quantized buffer."""
    return {name: param_spec(name, t.shape, rules, fsdp, fsdp_size)
            for name, t in model.state_dict(keep_vars=True).items()}


def _axes(entry: Entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements (one per mesh axis) of a spec. A dim over two
    axes whose layout order is not the mesh's takes a `_StridedShard` on
    the outer mesh axis."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if len(axes) == 1 or idx == sorted(idx):
            for i in idx:
                out[i] = Shard(d)
        elif len(axes) == 2:  # layout-major axis inner in the mesh
            out[idx[0]] = Shard(d)
            out[idx[1]] = _StridedShard(d, split_factor=axis_size(mesh, axes[0]))
        else:
            raise NotImplementedError(f"dim {d} over {axes}: at most two axes out of mesh order")
    return out


def _chunk(n: int, k: int, i: int) -> Tuple[int, int]:
    """(start, length) of block i of a dim of n cut in k, as `torch.chunk`
    and DTensor's `Shard` cut it (and GSPMD pads it): blocks of ceil(n / k),
    the last shorter, any after it empty."""
    c = -(-n // k)
    start = min(i * c, n)
    return start, min(c, n - start)


def local_shard(t: torch.Tensor, spec: Spec, mesh, axes: Optional[Sequence[str]] = None
                ) -> torch.Tensor:
    """This rank's block of the full tensor `t` under `spec` (a view),
    cut only over `axes` when given (e.g. the model axis alone). A dim over
    two axes is cut by the major one, then that block by the minor one; a
    dim that an axis does not divide is cut as `_chunk` says (Mistral's
    vocabulary of 32,003 rows)."""
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if (axes is not None and a not in axes) or axis_size(mesh, a) == 1:
                continue
            start, length = _chunk(t.shape[d], axis_size(mesh, a), axis_coord(mesh, a))
            t = t.narrow(d, start, length)
    return t


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """A DTensor of the full tensor `t` (present on every rank) under
    `spec`, cut locally: no communication."""
    from torch.distributed.tensor import DTensor

    local = local_shard(t, spec, mesh).contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=t.stride())


def like(dt, local: torch.Tensor):
    """A DTensor with `dt`'s mesh, placements and global shape over
    `local` (a tensor of dt's local shape)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, dt.device_mesh, dt.placements, run_check=False,
                              shape=dt.shape, stride=dt.stride())


def _set(module: torch.nn.Module, name: str, value) -> None:
    *path, leaf = name.split(".")
    mod = module.get_submodule(".".join(path))
    if leaf in mod._parameters:
        mod._parameters[leaf] = value
    else:
        mod._buffers[leaf] = value


def shard_params(model: torch.nn.Module, mesh, rules=None, fsdp: bool = False,
                 mesh_of: Optional[Callable[[str], Any]] = None) -> Dict[str, Spec]:
    """Make every parameter of `model` (loaded, full, on every rank) a
    DTensor under the rules, in place. Returns the specs. `mesh_of(name)`,
    when given, is the mesh of each parameter (a sub-mesh of `mesh`), or
    None for one this rank does not hold: it is put on "meta", uncut and
    unread (it may be on "meta" already)."""
    specs = param_specs(model, rules, fsdp, axis_size(mesh, FSDP_AXIS))
    for name, p in list(model.named_parameters()):
        on = mesh if mesh_of is None else mesh_of(name)
        if on is None:
            value = torch.empty(p.shape, dtype=p.dtype, device="meta")
        else:
            value = distribute(p.detach(), on, specs[name])
        _set(model, name, torch.nn.Parameter(value, requires_grad=p.requires_grad))
    return specs


def _fsdp_dim(dt) -> Optional[int]:
    """The tensor dim that the fsdp axis shards, or None."""
    from torch.distributed.tensor import Replicate

    names = dt.device_mesh.mesh_dim_names
    if FSDP_AXIS not in names:
        return None
    p = dt.placements[names.index(FSDP_AXIS)]
    return None if isinstance(p, Replicate) else p.dim


def _compute_len(dt, d: int) -> int:
    """The length along dim d of a DTensor's compute copy: its full length
    cut by the axis other than fsdp that shards d, if any (the rules share a
    dim between fsdp and one other axis at most: the table's vocab over
    (model, fsdp))."""
    mesh = dt.device_mesh
    n = dt.shape[d]
    for name, p in zip(mesh.mesh_dim_names, dt.placements):
        if name != FSDP_AXIS and getattr(p, "dim", None) == d:
            n = _chunk(n, axis_size(mesh, name), axis_coord(mesh, name))[1]
    return n


@torch.no_grad()
def gather_fsdp(dt) -> torch.Tensor:
    """The compute copy of a DTensor parameter: its fsdp shards gathered
    (data-major blocks in layout order, so a model-major joint shard comes
    back as this rank's model block), its model shard kept. Uneven shards
    are padded for the gather and the padding cut off."""
    local = dt.to_local()
    d = _fsdp_dim(dt)
    mesh = dt.device_mesh
    f = axis_size(mesh, FSDP_AXIS)
    if d is None or f == 1:
        return local
    n = _compute_len(dt, d)
    c = -(-n // f)
    if local.shape[d] < c:
        pad = list(local.shape)
        pad[d] = c - local.shape[d]
        local = torch.cat([local, local.new_zeros(pad)], dim=d)
    parts = [torch.empty_like(local) for _ in range(f)]
    dist.all_gather(parts, local.contiguous(), group=axis_group(mesh, FSDP_AXIS))
    return torch.cat(parts, dim=d).narrow(d, 0, n)


BATCH_AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS)


def all_reduce_batch(t: torch.Tensor, mesh, axes: Sequence[str] = BATCH_AXES) -> torch.Tensor:
    """Sum `t` in place over the axes that split the batch rows and the
    sequence."""
    for a in axes:
        if axis_size(mesh, a) > 1:
            dist.all_reduce(t, group=axis_group(mesh, a))
    return t


@torch.no_grad()
def reduce_to_shard(g: torch.Tensor, dt) -> torch.Tensor:
    """The gradient of a compute copy (see gather_fsdp) → the gradient of
    the parameter's own local shard: summed over data, fsdp and seq, then
    cut to this rank's fsdp block. `g` is consumed."""
    return cut_to_shard(all_reduce_batch(g, dt.device_mesh), dt)


def cut_to_shard(g: torch.Tensor, dt) -> torch.Tensor:
    """A gradient of a compute copy that is already summed over the batch
    axes → this rank's fsdp block of it, the parameter's own shard."""
    mesh = dt.device_mesh
    d = _fsdp_dim(dt)
    f = axis_size(mesh, FSDP_AXIS)
    if d is None or f == 1:
        return g
    start, length = _chunk(g.shape[d], f, axis_coord(mesh, FSDP_AXIS))
    return g.narrow(d, start, length).contiguous()


def replication(dt) -> int:
    """How many ranks hold each element of a DTensor: the world over the
    product of the sizes of the axes that shard it."""
    from torch.distributed.tensor import Replicate

    mesh = dt.device_mesh
    sharded = 1
    for i, p in enumerate(dt.placements):
        if not isinstance(p, Replicate):
            sharded *= mesh.size(i)
    return mesh.size() // sharded


def maybe_constrain(x, *spec_parts, mesh=None):
    """The JAX package's layout pin (`with_sharding_constraint` at the
    embedding gather and the image splice, JAX vlm.py:135-153): a
    `redistribute` to the spec's placements when `x` is a DTensor, nothing
    otherwise. The port's forward runs on local tensors, so on its own
    paths this returns `x`."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh or x.device_mesh, placements(tuple(spec_parts), x.device_mesh))


def logical_batch_spec(seq_sharded: bool = False) -> Spec:
    """Activation spec for [batch, seq, ...]: batch over data(+fsdp), seq
    over "seq" when the sequence is sharded."""
    if seq_sharded:
        return ((DATA_AXIS, FSDP_AXIS), SEQ_AXIS, None)
    return ((DATA_AXIS, FSDP_AXIS), None, None)


def local_rows(batch: Mapping[str, Any], mesh, tokens_per_tile: int,
               image_token_id: int, accum: int = 1) -> Dict[str, Any]:
    """The rows of a global batch that this rank's (data, fsdp) coordinate
    holds under `logical_batch_spec` (contiguous blocks, data major), with
    the images those rows' image tokens take: the batch's images are in
    order of appearance, `tokens_per_tile` image tokens each (a LLaVA
    tile's, or an Idefics2 image's `num_latents`), with their `patch_mask`.
    An image may run on from one row into the next, but not across the cut
    between two ranks' rows: that raises. Ranks that differ only in other
    axes get the same rows.

    With `accum` > 1 the batch is the step's whole batch for grad
    accumulation (the JAX trainer's layout): its leading dim splits into
    `accum` microbatches and images and patch_mask come [accum, tiles, ...].
    Each microbatch's rows are cut as above; the result holds this rank's
    rows of every microbatch, microbatch-major, and its images [accum,
    tiles, ...], each microbatch's padded with zero images (all-zero
    patch masks) to the most any microbatch takes: no image token reads
    them."""
    if accum > 1:
        return _local_rows_accum(batch, mesh, tokens_per_tile, image_token_id, accum)
    from leopard_tpu_torch.parallel.launch import dp_rank_and_world

    r, n = dp_rank_and_world(mesh)
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch of {b} rows does not split over {n} data-parallel ranks")
    lo, hi = r * b // n, (r + 1) * b // n
    out = {k: v[lo:hi] for k, v in batch.items() if k not in ("images", "patch_mask")}
    if batch.get("images") is not None:
        per_row = (batch["tokens"] == image_token_id).sum(dim=1).tolist()
        before, count = sum(per_row[:lo]), sum(per_row[lo:hi])
        if before % tokens_per_tile or count % tokens_per_tile:
            raise ValueError(
                f"the cut between data-parallel ranks' rows falls inside an image: rows "
                f"[{lo}, {hi}) start after {before} and hold {count} image tokens, "
                f"{tokens_per_tile} an image")
        first, count = before // tokens_per_tile, count // tokens_per_tile
        out["images"] = batch["images"][first:first + count]
        if batch.get("patch_mask") is not None:
            out["patch_mask"] = batch["patch_mask"][first:first + count]
    return out


def _local_rows_accum(batch, mesh, tokens_per_tile, image_token_id, accum):
    import torch.nn.functional as F

    from leopard_tpu_torch.training.trainer import STACKED, split_microbatches

    parts = [local_rows(mb, mesh, tokens_per_tile, image_token_id)
             for mb in split_microbatches(batch, accum)]
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0] if k not in STACKED}
    for key in STACKED:
        if key in parts[0]:
            most = max(p[key].shape[0] for p in parts)
            out[key] = torch.stack([F.pad(p[key], (0, 0) * (p[key].dim() - 1)
                                          + (0, most - p[key].shape[0])) for p in parts])
    return out


def tp_local_model(model: torch.nn.Module, mesh, rules=None) -> torch.nn.Module:
    """A new module of `model`'s class and config, on "meta" then given this
    rank's shard over the "model" and "expert" axes of each of `model`'s
    tensors (views, no copy; the full tensors on every rank): what serving
    under a mesh runs (JAX engine.py:199-223 places the same tree by the
    rules). Every other axis (data, stage, fsdp, seq) keeps the tensors
    whole: serving replicates over them, and the embedding table's fsdp
    blocks are this rank's model block whole, as one all-gather at
    construction would give it.

    Quantized leaves: an int8 payload is cut like its weight, and its
    replicated per-column scales are cut with a column-parallel payload's
    columns. An int4 weight, which the rules replicate, is cut like its
    unquantized weight all the same (`ops/quant.py::int4_block`): this
    rank's columns of a column-parallel weight (the head's true columns cut
    as its vocabulary is, each block padded to whole 128-column tiles with
    its own `n`), or its block of rows of a row-parallel one, repacked
    split-half. Those blocks are new tensors, 1/model of the leaf's bytes:
    the whole int4 leaves are not kept."""
    from leopard_tpu_torch.models.params import QuantizedWeight
    from leopard_tpu_torch.ops.quant import int4_block, quantize_tree

    local = type(model)(model.cfg, device="meta")
    quantized = {name: m for name, m in model.named_modules() if isinstance(m, QuantizedWeight)}
    if quantized:  # the structure only, on "meta"
        mode = "int4" if next(iter(quantized.values())).int4 else "int8"
        quantize_tree(local.text, mode=mode)
    int4 = {name: m for name, m in quantized.items() if m.int4}
    axes = (MODEL_AXIS, EXPERT_AXIS)
    specs = param_specs(model, rules)
    for name, t in model.state_dict(keep_vars=True).items():
        if name.rsplit(".", 1)[0] in int4:
            continue
        spec = specs[name]
        if name.endswith(".s"):  # a scale: cut with its payload's columns
            q = name[:-2] + ".q"
            if q in specs and specs[q][-1] == MODEL_AXIS:
                spec = (None,) * (t.dim() - 1) + (MODEL_AXIS,)
        piece = local_shard(t.detach(), spec, mesh, axes)
        if isinstance(t, torch.nn.Parameter):
            piece = torch.nn.Parameter(piece, requires_grad=False)
        _set(local, name, piece)
    for m in local.modules():
        if isinstance(m, QuantizedWeight) and not m.int4:
            m.n = m.s.shape[-1]
    tp, coord = axis_size(mesh, MODEL_AXIS), axis_coord(mesh, MODEL_AXIS)
    for name, w in int4.items():
        k_in, n_out = spec_for_path(jax_path(name), rules)[-2:] or (None, None)
        if tp > 1 and n_out == MODEL_AXIS:
            leaves = int4_block(w, "columns", *_chunk(w.n, tp, coord))
        elif tp > 1 and k_in == MODEL_AXIS:
            leaves = int4_block(w, "rows", *_chunk(2 * w.q4.shape[0], tp, coord))
        else:
            leaves = {"q4": w.q4[:, :w.n], "s": w.s[:, :w.n]}
        parent, _, leaf = name.rpartition(".")
        setattr(local.get_submodule(parent), leaf, QuantizedWeight(leaves))
    return local
