"""Leopard-Idefics2 and fsdp under the 1F1B pipeline (training/pp.py), over
gloo in spawned processes, against the JAX package, fp32 on the CPU.

The model is the tiny Idefics2 of tests/test_torch_idefics2_mesh.py (the
JAX init, vocab 32,003, Mistral's window of 16, the tower and the decoder on
the flash tier: the plain K1/K2 versions here) with 4 text layers, so that
v = 2 gives one layer a chunk; the batch is that file's: two rows of 48
slots with three NaViT images of ragged grids and an all-padding one.

  - (stage=2) at v = 1, M = 2: loss and updated params against JAX's
    `make_pp_train_step` itself, gradients against JAX's plain step;
  - (stage=2, seq=2) with attn_impl="ring" at v = 2: each seq rank holds a
    contiguous 24-token shard, longer than the window, so the ring's
    off-diagonal blocks are partly inside it (the q − kv offset); loss and
    params against JAX's pipeline with its ring, gradients against JAX's
    plain step with dense attention;
  - (stage=2, fsdp=2), each fsdp rank one row and its whole images, one
    microbatch: every tensor sharded over fsdp, each stage's layers inside
    its stage group; against JAX's plain step (JAX's own tests never
    combine fsdp with stages);
  - the perceiver frozen at (stage=2): no gradient reaches it, every other
    gradient is the unfrozen step's, and the update moves it by AdamW's
    decay alone (p · (1 − LR · decay) where the decay mask applies);
  - a planted fault, the patch mask dropped from the rows, which the
    gradient check must fail.

Tolerances as tests/test_torch_pp_train.py: loss 1e-4, every gradient leaf
at cosine >= 0.99999, updated params within LR / 100.
"""

import dataclasses

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.training import pp

from test_torch_mesh import init_worker, run_world
from test_torch_mesh_train import assert_step_matches

LAYERS = 4
LR = 1e-2
DECAY = 0.1
# name: (world, mesh, ring attention, v, microbatches, frozen, the patch mask dropped)
CASES = {
    "stage2": (2, dict(stage=2), False, 1, 2, (), False),
    "stage2_frozen_perceiver": (2, dict(stage=2), False, 1, 2, ("perceiver",), False),
    "fault_no_patch_mask": (2, dict(stage=2), False, 1, 2, (), True),
    "stage2_seq2_ring_v2": (4, dict(stage=2, seq=2), True, 2, 2, (), False),
    "stage2_fsdp2": (4, dict(stage=2, fsdp=2), False, 1, 1, (), False),
}


def idefics2_cfg(mod, ring=False, port=True):
    """The tiny Idefics2 at 4 text layers; the port's on the flash tier."""
    from test_torch_idefics2 import tiny_idefics2

    cfg = tiny_idefics2(mod)
    text = dataclasses.replace(cfg.text, num_layers=LAYERS,
                               attn_impl="ring" if ring else cfg.text.attn_impl)
    if port:
        text = dataclasses.replace(text, long_seq_threshold=8)
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision,
                                                                  attn_impl="flash"))
    return dataclasses.replace(cfg, text=text)


def train_cfg(mod, remat):
    return mod.TrainConfig(
        remat=remat, loss_chunk=16,
        optimizer=mod.OptimizerConfig(lr=LR, warmup_steps=0, decay_steps=100, eps=1e-4,
                                      weight_decay=DECAY, grad_clip=1.0))


def _load(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files if k.startswith(prefix)}


def _worker(rank, world, store, path, out):
    import torch.distributed as dist

    from leopard_tpu_torch.config import MeshConfig
    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.parallel.mesh import axis_coord, build_mesh
    from leopard_tpu_torch.parallel.sharding import like, local_rows

    init_worker(rank, world, store, dict(data=world))
    data = np.load(path)
    full = _load(data, "full/")
    tc = train_cfg(tcfgs, "full")
    for name, (w, mesh_kw, ring, v, m_total, frozen, fault) in CASES.items():
        if w != world:
            continue
        mesh = build_mesh(MeshConfig(**mesh_kw), "cpu")
        cfg = idefics2_cfg(tcfgs, ring)
        model = LeopardVLM(cfg)
        model.load_state_dict(full)
        batch = _load(data, "batch/")
        if fault:
            batch.pop("patch_mask")
        state = pp.create_pp_train_state(model, tc, mesh, virtual_chunks=v)
        step = pp.make_pp_train_step(cfg, tc, mesh, num_microbatches=m_total,
                                     virtual_chunks=v, frozen=frozen)
        mine = local_rows(batch, mesh, cfg.perceiver.num_latents, cfg.image_token_id)
        loss, _, grads = step.loss_and_grads(state, mine)
        grads = {k: like(state.params[k], g).full_tensor() for k, g in grads.items()}
        state, metrics = step(state, mine)
        assert float(metrics["loss"]) == float(loss)
        params = {k: p.full_tensor() for k, p in state.params.items()}
        if all(axis_coord(mesh, a) == 0 for a in ("model", "seq", "fsdp", "data")):
            np.savez(f"{out}/{name}-{axis_coord(mesh, 'stage')}.npz", loss=float(loss),
                     **{f"g/{k}": g.numpy() for k, g in grads.items()},
                     **{f"p/{k}": p.numpy() for k, p in params.items()})
    dist.destroy_process_group()


def _merged(out, name):
    merged = {}
    for stage in range(2):
        with np.load(f"{out}/{name}-{stage}.npz") as f:
            merged.update({k: f[k] for k in f.files})
    return merged


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's references (its plain step, and its pipeline at (stage=2) and
    (stage=2, seq=2) ring), then the two worlds."""
    import jax
    import jax.numpy as jnp

    from leopard_tpu import config as cfgs
    from leopard_tpu.config import MeshConfig as JMeshConfig
    from leopard_tpu.models import siglip as jsiglip
    from leopard_tpu.parallel.mesh import build_mesh as jbuild_mesh
    from leopard_tpu.training import trainer as jtrainer
    from leopard_tpu.training.pp import make_pp_train_step as jmake_pp
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
    from test_torch_idefics2 import exact_position_ids, init_params
    from test_torch_idefics2_train import train_batch

    tmp = tmp_path_factory.mktemp("pp_idefics2")
    batch = train_batch()
    port_cfg = idefics2_cfg(tcfgs)
    jtc = train_cfg(cfgs, "none")
    real = jsiglip.navit_position_ids
    jsiglip.navit_position_ids = exact_position_ids  # test_torch_idefics2.py says why
    try:
        jcfg = idefics2_cfg(cfgs, port=False)
        params = init_params(jcfg)
        before = state_dict_from_jax(params, port_cfg)
        state = jtrainer.create_train_state(params, jtc)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        step = jtrainer.make_train_step(jcfg, jtc)

        def both(st, b):
            loss, grads = jax.value_and_grad(lambda p: jtrainer.vlm_loss(
                p, jcfg, b, jnp.float32, False, loss_chunk=16)[0])(st.params)
            return loss, grads, step(st, b)[0].params

        loss, grads, new = jax.device_get(jax.jit(both)(state, jbatch))
        plain = (float(loss), state_dict_from_jax(grads, port_cfg),
                 state_dict_from_jax(new, port_cfg))
        pipelines = {}
        for name, mesh_kw, ring, v in (("stage2", dict(stage=2, data=1), False, 1),
                                       ("stage2_seq2_ring_v2", dict(stage=2, seq=2), True, 2)):
            devices = jax.devices()[:mesh_kw["stage"] * mesh_kw.get("seq", 1)]
            jmesh = jbuild_mesh(JMeshConfig(**mesh_kw), devices=devices)
            jstep = jmake_pp(idefics2_cfg(cfgs, ring, port=False), jtc, jmesh,
                             num_microbatches=2, virtual_chunks=v)
            new, metrics = jax.device_get(jax.jit(jstep)(
                jtrainer.create_train_state(params, jtc), jbatch))
            pipelines[name] = (float(metrics["loss"]), state_dict_from_jax(new.params, port_cfg))
    finally:
        jsiglip.navit_position_ids = real
    path = str(tmp / "in.npz")
    np.savez(path, **{f"full/{k}": t.numpy() for k, t in before.items()},
             **{f"batch/{k}": a for k, a in batch.items()})
    run_world(_worker, 2, tmp, path, str(tmp))
    run_world(_worker, 4, tmp, path, str(tmp))
    return tmp, plain, pipelines, before


def test_jax_pipeline_matches_its_plain_step_on_idefics2(runs):
    """The reference itself: JAX's pipeline step, which its own tests never
    run on Idefics2, agrees with its plain step (loss 1e-5, params LR/100)."""
    _, plain, pipelines, _ = runs
    loss, _, want_p = plain
    for name, (p_loss, p_params) in pipelines.items():
        assert abs(p_loss - loss) <= 1e-5 * abs(loss), name
        for k, w in want_p.items():
            np.testing.assert_allclose(p_params[k].numpy(), w.numpy(), atol=LR / 100, rtol=0,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["stage2", "stage2_seq2_ring_v2", "stage2_fsdp2"])
def test_idefics2_pipeline_step_matches_jax(runs, name):
    out, plain, pipelines, before = runs
    loss, want_g, want_p = plain
    got = _merged(out, name)
    assert {k[2:] for k in got if k.startswith("g/")} == set(want_g)
    assert {k.split(".")[0] for k in want_g} == {"vision", "perceiver", "text"}
    if name in pipelines:  # the loss and params of JAX's own pipeline
        loss, want_p = pipelines[name]
    assert_step_matches(got, loss, want_g, want_p, before)


def test_frozen_perceiver_under_the_pipeline(runs):
    """Against the unfrozen run of the same step: the perceiver takes no
    gradient and moves by AdamW's decoupled decay alone, every other
    gradient is unchanged."""
    from leopard_tpu_torch.training.trainer import decay_mask

    out, _, _, before = runs
    got, free = _merged(out, "stage2_frozen_perceiver"), _merged(out, "stage2")
    assert float(got["loss"]) == float(free["loss"])
    keys = [k[2:] for k in got if k.startswith("g/")]
    perceiver = [k for k in keys if k.startswith("perceiver.")]
    assert perceiver and not any(got[f"g/{k}"].any() for k in perceiver)
    for k in keys:
        if k not in perceiver:
            np.testing.assert_array_equal(got[f"g/{k}"], free[f"g/{k}"], err_msg=k)
    for k in perceiver:
        b = before[k]
        want = b * (1 - LR * DECAY) if decay_mask(k, b) else b
        np.testing.assert_allclose(got[f"p/{k}"], want.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_dropped_patch_mask_is_caught(runs):
    out, plain, _, before = runs
    loss, want_g, want_p = plain
    with pytest.raises(AssertionError):
        assert_step_matches(_merged(out, "fault_no_patch_mask"), loss, want_g, want_p, before)
