"""The device mesh and the sharding rules of the port (parallel/), against
the JAX package.

  - spec parity, in one process: every parameter's spec equals JAX
    `param_specs` on the same leaf (one layer's, transposed to the port's
    [out, in]), with FSDP and without;
  - shard equality, in a world of 4 (fsdp=2, model=2) on gloo: each rank's
    local shard equals the JAX shard that `shard_params` puts on the device
    of the same mesh coordinate (`addressable_shards`), exactly.

Process groups run in processes started with "spawn" over gloo and a
FileStore under tmp_path. The workers live at module level and never import
JAX: the parent computes the JAX side and writes .npz files. `run_world`
gives each run an init timeout and a join limit, and kills what is left.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.config import MeshConfig
from leopard_tpu_torch.parallel import sharding
from leopard_tpu_torch.parallel.mesh import AXIS_ORDER, parse_mesh

JOIN_LIMIT_S = 120


def run_world(fn, world, tmp_path, *args, limit=JOIN_LIMIT_S):
    """fn(rank, world, store_path, *args) in `world` spawned processes;
    raises what a child raised, or on expiry of the join limit (after
    killing every child)."""
    import torch.multiprocessing as mp

    store = str(tmp_path / f"store-{time.monotonic_ns()}")
    ctx = mp.start_processes(fn, args=(world, store, *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {world} did not finish in {limit} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def init_worker(rank, world, store, mesh_kw):
    """A gloo process group with a 60 s timeout and the port's mesh."""
    import torch.distributed as dist

    from leopard_tpu_torch.parallel.launch import initialize_distributed
    from leopard_tpu_torch.parallel.mesh import build_mesh

    torch.set_num_threads(1)
    initialize_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                           world_size=world, timeout=datetime.timedelta(seconds=60))
    return build_mesh(MeshConfig(**mesh_kw), "cpu")


def _layer_tree(tree, i):
    """The JAX tree with every stacked `layers` leaf cut to layer i."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer_tree(v, i) if k != "layers" else _slice(v, i)
        else:
            out[k] = v
    return out


def _slice(tree, i):
    return {k: _slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _jax_leaf(tree, name):
    """The JAX leaf (or spec) of the port's state-dict name."""
    node = tree
    for part in sharding.jax_path(name).split("/"):
        node = node[part]
    return node


def _transposed(spec, name):
    spec = tuple(spec)
    return spec[:-2] + spec[:-3:-1] if sharding._is_matrix(name) and len(spec) >= 2 else spec


def _jax_params():
    import jax

    from leopard_tpu import config as cfgs
    from leopard_tpu.models import vlm as jvlm

    return jax.device_get(jvlm.init_params(cfgs.tiny_vlm(), jax.random.PRNGKey(0)))


@pytest.mark.parametrize("fsdp", [False, True])
def test_specs_match_jax(fsdp):
    from leopard_tpu.parallel import sharding as jsharding
    from leopard_tpu_torch.models.vlm import LeopardVLM

    params = _jax_params()
    want = jsharding.param_specs(_layer_tree(params, 0), fsdp=fsdp, fsdp_size=2)
    stacked = jsharding.param_specs(params, fsdp=False)
    model = LeopardVLM(tcfgs.tiny_vlm(), device="meta")
    got = sharding.param_specs(model, fsdp=fsdp, fsdp_size=2)
    assert len(got) == len(list(model.parameters()))
    for name, spec in got.items():
        jspec = _transposed(_jax_leaf(want, name), name)
        assert tuple(spec) == tuple(jspec), (name, spec, jspec)
        if ".layers." in name and not fsdp:  # the stacked rule: one more, leading axis
            assert tuple(_jax_leaf(stacked, name)) == (None, *_transposed(jspec, name)), name
    assert got["text.embed_tokens"] == (("model", "fsdp"), None)
    assert got["text.layers.1.attn.wq"] == ("model", "fsdp" if fsdp else None)


def test_parse_mesh():
    assert parse_mesh("fsdp=2,model=4") == MeshConfig(fsdp=2, model=4)
    assert parse_mesh("data=1").num_devices == 1
    assert MeshConfig().axis_names == AXIS_ORDER
    for bad in ("pipe=2", "model=0", "model"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


class _Coord:
    """A mesh's axis sizes and this rank's coordinate, for the helpers that
    read no process group."""

    mesh_dim_names = AXIS_ORDER

    def __init__(self, coord, **sizes):
        self.sizes = [sizes.get(a, 1) for a in AXIS_ORDER]
        self.coord = [coord.get(a, 0) for a in AXIS_ORDER]

    def size(self, dim=None):
        return self.sizes[dim]

    def get_coordinate(self):
        return self.coord


@pytest.mark.parametrize("rank", [0, 1])
def test_local_rows_take_their_rows_tiles(rank):
    """data=2 × model=2: each data coordinate takes its half of the rows and
    the tiles its rows' image tokens take; the model coordinate does not
    matter. Row 0 has one tile, row 1 none, rows 2-3 two each."""
    from leopard_tpu_torch.parallel.launch import dp_rank_and_world

    cfg = tcfgs.tiny_vlm()
    t, img = cfg.anyres.tokens_per_tile, cfg.image_token_id
    tokens = torch.ones((4, 20), dtype=torch.int64)
    for row, tiles in enumerate((1, 0, 2, 2)):
        tokens[row, 1:1 + tiles * t] = img
    batch = {"tokens": tokens, "loss_weights": torch.ones(4, 20),
             "images": torch.arange(5.0)[:, None, None, None].expand(5, 3, 4, 4)}
    for m in (0, 1):
        mesh = _Coord(dict(data=rank, model=m), data=2, model=2)
        assert dp_rank_and_world(mesh) == (rank, 2)
        got = sharding.local_rows(batch, mesh, t, img)
        assert torch.equal(got["tokens"], tokens[2 * rank:2 * rank + 2])
        want_tiles = [0.0] if rank == 0 else [1.0, 2.0, 3.0, 4.0]
        assert got["images"][:, 0, 0, 0].tolist() == want_tiles


def _shards_worker(rank, world, store, path):
    import torch.distributed as dist
    from torch.distributed.tensor.placement_types import _StridedShard

    from leopard_tpu_torch.models.vlm import LeopardVLM

    mesh = init_worker(rank, world, store, dict(fsdp=2, model=2))
    data = np.load(path)
    model = LeopardVLM(tcfgs.tiny_vlm())
    model.load_state_dict({k[5:]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith("full/")}, strict=True)
    specs = sharding.shard_params(model, mesh, fsdp=True)
    for name, p in model.named_parameters():
        want = torch.from_numpy(data[f"r{rank}/{name}"])
        assert torch.equal(p.to_local(), want), (rank, name, specs[name])
    strided = model.text.embed_tokens.placements[AXIS_ORDER.index("fsdp")]
    assert isinstance(strided, _StridedShard), strided
    # the compute copy: fsdp gathered, this rank's model block kept
    m = mesh.get_coordinate()[AXIS_ORDER.index("model")]
    table = torch.from_numpy(data["full/text.embed_tokens"])
    block = table.shape[0] // 2
    assert torch.equal(sharding.gather_fsdp(model.text.embed_tokens),
                       table[m * block:(m + 1) * block])
    dist.destroy_process_group()


def test_local_shards_match_jax_shards(tmp_path):
    """fsdp=2 × model=2: rank r holds JAX's shard on device r of the same
    MeshConfig (both meshes lay devices out row-major in the axis order)."""
    import jax

    from leopard_tpu.config import MeshConfig as JMeshConfig
    from leopard_tpu.parallel.mesh import build_mesh as jbuild_mesh
    from leopard_tpu.parallel.sharding import shard_params as jshard_params
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax

    params = _jax_params()
    tcfg = tcfgs.tiny_vlm()
    full = state_dict_from_jax(params, tcfg)
    jmesh = jbuild_mesh(JMeshConfig(fsdp=2, model=2), devices=jax.devices()[:4])
    rank_of = {d: r for r, d in enumerate(np.asarray(jmesh.devices).reshape(-1))}
    arrays = {f"full/{k}": v.numpy() for k, v in full.items()}
    for layer in range(2):
        placed = jshard_params(_layer_tree(params, layer), jmesh, fsdp=True)
        for name in full:
            if ".layers." in name and f".layers.{layer}." not in name:
                continue
            leaf = _jax_leaf(placed, name)
            for shard in leaf.addressable_shards:
                a = np.asarray(shard.data)
                if sharding._is_matrix(name):
                    a = np.swapaxes(a, -1, -2)
                arrays[f"r{rank_of[shard.device]}/{name}"] = np.ascontiguousarray(a)
    path = str(tmp_path / "shards.npz")
    np.savez(path, **arrays)
    run_world(_shards_worker, 4, tmp_path, path)
