"""The MoE decoder's train step under a device mesh
(training/trainer.py::make_train_step(mesh=) over ops/moe.py), on gloo
across spawned processes, against the JAX package's step.

The model is test_torch_moe.py's: tiny_vlm with a 4-expert top-2 decoder
and tied embeddings, fp32, from the JAX init; four text rows of 24 tokens,
the last ending in padding. Cases:

  - data=2, the capacity path at factor 1.0, which drops: each rank routes
    its row pair with the global capacity and the global positions;
  - fsdp=2, the capacity path: the rows split over fsdp, the expert banks
    sharded on it, the router statistics summed over it;
  - model=2, capacity and dropless: the banks' F split over model, the
    expert rows summed over model before the gates;
  - seq=2 on the ring (the zig-zag layout), capacity and dropless, against
    JAX's context-parallel step (`cp_mesh=`, its ring over a seq=2 mesh):
    the capacity positions counted in the ring's sequence order, as JAX's
    layer stack runs, the statistics summed over seq. These rows hold no
    padding: a padding query attends to no key, and its attention output
    is unspecified in JAX (pallas/flash_attention.py:121-124, "callers
    discard them"; JAX's ring and dense attention give V's mean, K1 and the
    port's ring 0), yet the router takes it into the MoE statistics;
  - a planted fault at seq=2, positions counted within each rank's shard,
    which the checks must catch;
  - data=2 with grad_accum_steps=2 (the rows of local_rows(..., accum=2)),
    against JAX's accumulating step: the loss and the updated params;
  - expert=2, dropless through the expert-parallel dispatch, dense worst
    case and ragged (JAX's one-device dropless step is the reference of
    both: its EP dispatch computes the same numbers);
  - the expert-sharded state saved whole and restored at expert=1 and onto
    the plain step, equal tensors;
  - Engine(mesh=) on the MoE decoder at model=2 and data=2: tokens equal
    to the plain engine's, logprobs within 1e-5 (capacity and dropless).

Checks (test_torch_mesh_train.py's): the loss (the cross-entropy plus the
aux and z losses) within 1e-4 and rel 1e-5, aux and z rtol 1e-5,
`moe_fraction_dropped` the same count of dropped assignments (rtol 1e-6),
the clip norm rtol 1e-5, every gradient leaf at cosine >= 0.99999
(leaves whose gradient is ~0 by atol 2e-5 of the largest), the updated
params within LR / 100 and their updates at cosine >= 0.99999.
"""

import dataclasses

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs

from test_torch_mesh import init_worker, run_world
from test_torch_mesh_train import LR, assert_step_matches, train_cfg

MODES = {"capacity": dict(moe_dropless=False, moe_capacity_factor=1.0),
         "dropless": dict(moe_dropless=True),
         "ragged": dict(moe_dropless=True, moe_ep_ragged_a2a=True)}
# mesh label: (mesh, [(mode, grad_accum_steps, planted fault)])
CASES = {"data2": (dict(data=2), [("capacity", 1, None), ("capacity", 2, None)]),
         "fsdp2": (dict(fsdp=2), [("capacity", 1, None)]),
         "model2": (dict(model=2), [("capacity", 1, None), ("dropless", 1, None)]),
         "seq2_ring": (dict(seq=2), [("capacity", 1, None), ("dropless", 1, None),
                                     ("capacity", 1, "local_positions")]),
         "expert2": (dict(expert=2), [("dropless", 1, None), ("ragged", 1, None)])}


def moe_cfg(mod, mode, ring=False):
    """tools/bench_moe.py's topology at test_torch_moe.py's toy size; the
    decoder on the ring when asked."""
    cfg = mod.tiny_vlm(vocab_size=512)
    ring = dict(attn_impl="ring") if ring else {}
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_experts=4, moe_top_k=2, tie_word_embeddings=True, **MODES[mode],
        **ring))


def text_batch(seed=1, padded=True):
    """Four rows of 24 tokens, row 3 ending in 5 padding positions; or,
    not `padded`, in 5 tokens of its segment that the loss skips."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 511, (4, 24)).astype(np.int32)
    seg = np.ones((4, 24), np.int32)
    weights = np.ones((4, 24), np.float32)
    weights[3, -5:] = 0
    if padded:
        seg[3, -5:] = 0
        tokens[3, -5:] = 0
    return dict(tokens=tokens, segment_ids=seg, loss_weights=weights)


def _worker(rank, world, store, mesh_kw, cases, path, out):
    import torch.distributed as dist

    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.parallel.sharding import like, local_rows
    from leopard_tpu_torch.training import trainer
    from test_torch_moe_ep import _planted

    mesh = init_worker(rank, world, store, mesh_kw)
    data = np.load(path)
    prefix = "ringbatch/" if "seq" in mesh_kw else "batch/"
    batch = {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith(prefix)}
    saved = {}
    for mode, accum, fault in cases:
        cfg = moe_cfg(tcfgs, mode, ring="seq" in mesh_kw)
        model = LeopardVLM(cfg)
        model.load_state_dict({k[5:]: torch.from_numpy(data[k]) for k in data.files
                               if k.startswith("full/")})
        tc = train_cfg(tcfgs, "full")
        state = trainer.create_train_state(model, tc, mesh=mesh)
        step = trainer.make_train_step(cfg, tc, mesh=mesh, grad_accum_steps=accum)
        mine = local_rows(batch, mesh, cfg.anyres.tokens_per_tile, cfg.image_token_id,
                          accum=accum)
        undo = _planted(fault)
        try:
            loss, metrics, grads = step.loss_and_grads(state, mine)
            grads = {k: like(state.params[k], g).full_tensor() for k, g in grads.items()}
            state, after = step(state, mine)
        finally:
            undo()
        assert float(after["loss"]) == float(metrics["loss"])
        key = f"fault_{fault}" if fault else f"{mode}/{accum}"
        saved[f"{key}/loss"] = float(loss)
        saved[f"{key}/grad_norm"] = float(after["grad_norm"])
        saved.update({f"{key}/m/{k}": float(v) for k, v in metrics.items()})
        saved.update({f"{key}/g/{k}": v.numpy() for k, v in grads.items()})
        saved.update({f"{key}/p/{k}": p.full_tensor().numpy()
                      for k, p in state.params.items()})
        if "expert" in mesh_kw and mode == "dropless":
            _checkpoint_round_trip(cfg, tc, state, f"{path}.ckpt")
    if "data" in mesh_kw:
        saved.update(_engines(data))
    if rank == 0:
        np.savez(out, **saved)
    dist.destroy_process_group()


def _checkpoint_round_trip(cfg, tc, state, directory):
    """An expert-sharded state saved whole, restored at expert=1 (a data
    mesh of the same world) and onto the plain step: equal tensors."""
    from leopard_tpu_torch.config import MeshConfig
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.parallel.mesh import build_mesh
    from leopard_tpu_torch.training import trainer
    from leopard_tpu_torch.training.checkpoint import CheckpointManager

    ckpt = CheckpointManager(directory, async_save=False)
    ckpt.save(1, state)
    world = torch.distributed.get_world_size()
    data_mesh = build_mesh(MeshConfig(data=world), "cpu")
    for mesh in (data_mesh, None):
        template = trainer.create_train_state(
            vlm.init_params(cfg, torch.Generator().manual_seed(9)), tc, mesh=mesh)
        restored, _ = ckpt.restore(template=template)
        assert restored.step == 1 and restored.opt_state.count == 1
        for group in ("params", "mu", "nu"):
            a = state.params if group == "params" else getattr(state.opt_state, group)
            b = restored.params if group == "params" else getattr(restored.opt_state, group)
            for k in a:
                want = a[k].full_tensor()
                got = b[k].full_tensor() if mesh is not None else b[k]
                assert torch.equal(want, got), (group, k, mesh)
                if mesh is not None:
                    assert b[k].placements == template.params[k].placements, k


ENGINE_PROMPTS = ([5, 1, 30, 99, 7, 400], [7, 8, 9])


def _engines(data):
    """Engine(mesh=) on the MoE decoder (capacity, which drops at these
    buckets, and dropless) at model=2 and data=2: tokens and logprobs
    against the plain engine's."""
    from leopard_tpu_torch.config import GenerateConfig, MeshConfig
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.parallel.mesh import build_mesh

    world = torch.distributed.get_world_size()
    gen = GenerateConfig(max_new_tokens=5, greedy=True, eos_token_ids=(999999,))
    prompts = [np.asarray(p, np.int32) for p in ENGINE_PROMPTS]
    out = {}
    for mode in ("capacity", "dropless"):
        cfg = moe_cfg(tcfgs, mode)
        model = LeopardVLM(cfg)
        model.load_state_dict({k[5:]: torch.from_numpy(data[k]) for k in data.files
                               if k.startswith("full/")})
        kw = dict(seq_buckets=(8, 16), tile_buckets=(1,))
        plain = Engine(cfg, model, **kw).generate(prompts, gen_cfg=gen)
        for axis in ("model", "data"):
            mesh = build_mesh(MeshConfig(**{axis: world}), "cpu")
            got = Engine(cfg, model, mesh=mesh, **kw).generate(prompts, gen_cfg=gen)
            for a, b in zip(got.tokens, plain.tokens):
                assert np.array_equal(a, b), (mode, axis, a, b)
            for a, b in zip(got.logprobs, plain.logprobs):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            out[f"engine/{mode}/{axis}"] = np.stack(got.tokens)
    return out


def _jax_reference(mode, accum, params, batch, ring=False):
    """JAX's step: (loss, metrics, grads or None, the updated params), the
    last two as port state dicts. One device, or with `ring` the decoder's
    attention on JAX's ring over a seq=2 mesh (its context-parallel step,
    `cp_mesh=`): the ring masks padding queries, which the plain attention
    does not, so padding rows reach the router with other values there."""
    import jax
    import jax.numpy as jnp

    from leopard_tpu import config as cfgs
    from leopard_tpu.config import MeshConfig
    from leopard_tpu.parallel.mesh import build_mesh
    from leopard_tpu.training import trainer as jtrainer
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax

    jcfg = moe_cfg(cfgs, "dropless" if mode == "ragged" else mode, ring=ring)
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, moe_ep_ragged_a2a=False))
    tcfg = moe_cfg(tcfgs, mode)
    jtc = train_cfg(cfgs, "none")
    cp = build_mesh(MeshConfig(seq=2), jax.devices()[:2]) if ring else None
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtrainer.create_train_state(params, jtc)
    grads = None
    if accum == 1:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jtrainer.vlm_loss(p, jcfg, jbatch, jnp.float32, False, loss_chunk=16,
                                        cp_mesh=cp),
            has_aux=True))(state.params)
        grads = state_dict_from_jax(jax.device_get(grads), tcfg)
        metrics = {k: float(v) for k, v in metrics.items()}
    new, m = jax.jit(jtrainer.make_train_step(jcfg, jtc, grad_accum_steps=accum,
                                              cp_mesh=cp))(state, jbatch)
    if accum > 1:
        loss, metrics = m["loss"], {}
    metrics["grad_norm"] = float(m["grad_norm"])
    return (float(loss), metrics, grads,
            state_dict_from_jax(jax.device_get(new.params), tcfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from leopard_tpu import config as cfgs
    from leopard_tpu.models import vlm as jvlm
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("moe_mesh")
    batch = text_batch()
    params = jax.device_get(jvlm.init_params(moe_cfg(cfgs, "capacity"), jax.random.PRNGKey(1)))
    before = state_dict_from_jax(params, moe_cfg(tcfgs, "capacity"))
    path = str(tmp / "in.npz")
    ring_batch = text_batch(padded=False)
    np.savez(path, **{f"full/{k}": v.numpy() for k, v in before.items()},
             **{f"batch/{k}": v for k, v in batch.items()},
             **{f"ringbatch/{k}": v for k, v in ring_batch.items()})
    got = {}
    for label, (mesh_kw, cases) in CASES.items():
        out = str(tmp / f"{label}.npz")
        run_world(_worker, 2, tmp, mesh_kw, cases, path, out)
        got[label] = np.load(out)
    ref = {(mode, accum, "seq" in mesh_kw): _jax_reference(
               mode, accum, params, ring_batch if "seq" in mesh_kw else batch,
               ring="seq" in mesh_kw)
           for mesh_kw, cases in CASES.values() for mode, accum, _ in cases}
    return got, ref, before


def _case(got, key):
    return {k[len(key) + 1:]: got[k] for k in got.files if k.startswith(key + "/")}


def check_step(mine, ref, before, mode, ring=False):
    """One step's loss, MoE metrics, clip norm, gradients and updated params
    against JAX's step (on the ring where the port's is)."""
    loss, metrics, want_g, want_p = ref[(mode, 1, ring)]
    assert abs(float(mine["loss"]) - loss) <= 1e-5 * abs(loss)
    np.testing.assert_allclose(float(mine["m/loss"]), metrics["loss"], rtol=1e-5)
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(mine[f"m/{k}"]), metrics[k], rtol=1e-5, err_msg=k)
    # the same dropped count (XLA's mean multiplies by 1/N: the last bit differs)
    per = text_batch()["tokens"].size * 2
    dropped = float(mine["m/moe_fraction_dropped"])
    assert round(dropped * per) == round(metrics["moe_fraction_dropped"] * per)
    np.testing.assert_allclose(dropped, metrics["moe_fraction_dropped"], rtol=1e-6)
    assert (metrics["moe_fraction_dropped"] > 0) == (mode == "capacity")
    # the clip norm over the expert-sharded leaves (each counted once) is JAX's
    np.testing.assert_allclose(float(mine["grad_norm"]), metrics["grad_norm"], rtol=1e-5)
    # text-only rows: the tower and projector (41 of 63 leaves) take no gradient
    assert_step_matches({"loss": mine["loss"], **{k: v for k, v in mine.items()
                                                  if k[:2] in ("g/", "p/")}},
                        loss, want_g, want_p, before, real_share=0.3)


@pytest.mark.parametrize("label,mode", [("data2", "capacity"), ("fsdp2", "capacity"),
                                        ("model2", "capacity"), ("model2", "dropless"),
                                        ("seq2_ring", "capacity"), ("seq2_ring", "dropless"),
                                        ("expert2", "dropless"), ("expert2", "ragged")])
def test_moe_step_under_mesh_matches_jax(runs, label, mode):
    got, ref, before = runs
    check_step(_case(got[label], f"{mode}/1"), ref, before, mode, ring=label == "seq2_ring")


def test_per_shard_positions_at_seq2_are_caught(runs):
    """Capacity positions counted within each sequence shard drop other
    tokens than JAX's global cumsum: the checks fail."""
    got, ref, before = runs
    with pytest.raises(AssertionError):
        check_step(_case(got["seq2_ring"], "fault_local_positions"), ref, before, "capacity",
                   ring=True)


def test_moe_grad_accumulation_under_mesh_matches_jax(runs):
    got, ref, before = runs
    mine = _case(got["data2"], "capacity/2")
    loss, metrics, _, want_p = ref[("capacity", 2, False)]
    np.testing.assert_allclose(float(mine["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(float(mine["grad_norm"]), metrics["grad_norm"], rtol=1e-5)
    for k, want in want_p.items():
        np.testing.assert_allclose(mine[f"p/{k}"], want.numpy(), atol=LR / 100, rtol=0,
                                   err_msg=k)


def test_expert_sharded_checkpoint_restores_at_expert1_and_plain(runs):
    """Asserted inside the expert=2 world (`_checkpoint_round_trip`): here,
    that it ran."""
    got, _, _ = runs
    assert "dropless/1/loss" in got["expert2"].files


@pytest.mark.parametrize("mode", ["capacity", "dropless"])
@pytest.mark.parametrize("axis", ["model", "data"])
def test_moe_engine_under_mesh_equals_plain(runs, mode, axis):
    """Asserted inside the data=2 world (`_engines`): the tokens it kept."""
    got, _, _ = runs
    tokens = got["data2"][f"engine/{mode}/{axis}"]
    assert tokens.shape == (len(ENGINE_PROMPTS), 5)
    assert (tokens < 512).all()
