"""The pipeline-parallel train step (training/pp.py) over gloo, against the
JAX package (its tests/test_pipeline_train.py cases), fp32, tiny_vlm with 4
text layers, JAX test_pipeline_train's batch (one tile a row, a padding
tail), microbatches M = 2 unless said:

  - (stage=2, model=2) at v = 1, against JAX's plain step (which JAX's own
    tests hold equal to its pipeline);
  - (stage=2, seq=2) with attn_impl="ring" at v = 2 (one layer a chunk):
    loss and updated params against JAX `make_pp_train_step` itself,
    gradients against JAX's plain step with dense attention;
  - tied embeddings, and M = 4 on a text-only batch of 8 rows, at stage=2,
    against JAX's plain step;
    (tolerances of test_torch_mesh_train.py: loss 1e-4, every gradient leaf
    at cosine >= 0.99999, updated params within LR / 100);
  - vision_chunk 0 (tiles / M) and None (one call) give the same step;
  - loop.train's batch ramp (4, 6, 8, 8 rows) drives the pipeline step, its
    losses those of the plain step on the same batches;
  - a stage's state holds its layers on the mesh without "stage" and
    leaves the model's other layers on "meta";
  - a pipeline state saved (each stage's layers gathered to the primary)
    restores into the plain step, into MemoryStages(4) and into a stage's
    own state, equal tensors, and the restored plain step's loss equals the
    pipeline's; a plain template refuses another model's file;
  - the refusals: one stage, MoE, layers or rows that do not divide, and
    make_train_step at stage > 1 (fsdp with stages runs:
    tests/test_torch_pp_idefics2.py).

Two spawned worlds (4 and 2 processes) run every case; the JAX references
are computed once per module and handed over as .npz files.
"""

import dataclasses

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.parallel.pipeline import MemoryStages
from leopard_tpu_torch.training import pp

from test_torch_mesh import _Coord, init_worker, run_world
from test_torch_mesh_train import assert_step_matches, ring_cfg, train_cfg

LAYERS = 4
JAX_CASES = {   # name: (world, mesh, config variant, batch, M, v)
    "stage2_model2": (4, dict(stage=2, model=2), "plain", "images", 2, 1),
    "stage2_seq2_ring_v2": (4, dict(stage=2, seq=2), "ring", "images", 2, 2),
    "tied": (2, dict(stage=2), "tied", "images", 2, 1),
    "m4_text_only": (2, dict(stage=2), "plain", "text", 4, 1),
}


def variant(mod, name):
    cfg = mod.tiny_vlm()
    text = dataclasses.replace(cfg.text, num_layers=LAYERS,
                               tie_word_embeddings=name == "tied")
    cfg = dataclasses.replace(cfg, text=text)
    return ring_cfg(cfg) if name == "ring" else cfg


def batches():
    """JAX test_pipeline_train's `_batch`: 4 rows of 16 with a tile each,
    and 8 text-only rows."""
    from leopard_tpu import config as cfgs
    from test_pipeline_train import _batch

    cfg = cfgs.tiny_vlm()
    return {"images": {k: np.asarray(v) for k, v in _batch(cfg, seed=3).items()},
            "text": {k: np.asarray(v) for k, v in _batch(cfg, b=8, seed=5, images=False).items()}}


def weights_of(kind):
    """The variant whose initial weights a case loads: the ring's are the plain ones."""
    return "plain" if kind == "ring" else kind


def _load(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files if k.startswith(prefix)}


def _model(cfg, full):
    from leopard_tpu_torch.models.vlm import LeopardVLM

    model = LeopardVLM(cfg)
    model.load_state_dict(full)
    return model


def _full(state, grads):
    """Full tensors of this rank's grads (model shards gathered) and params."""
    from leopard_tpu_torch.parallel.sharding import like

    return ({k: like(state.params[k], g).full_tensor() for k, g in grads.items()},
            {k: p.full_tensor() for k, p in state.params.items()})


def _save_stage(mesh, out, **arrays):
    from leopard_tpu_torch.parallel.mesh import axis_coord

    if axis_coord(mesh, "model") == 0 and axis_coord(mesh, "seq") == 0:
        np.savez(f"{out}-{axis_coord(mesh, 'stage')}.npz", **arrays)


def run_case(mesh, cfg, full, batch, m_total, v, out):
    from leopard_tpu_torch.parallel.sharding import local_rows

    tc = train_cfg(tcfgs, "full")
    state = pp.create_pp_train_state(_model(cfg, full), tc, mesh, virtual_chunks=v)
    step = pp.make_pp_train_step(cfg, tc, mesh, num_microbatches=m_total, virtual_chunks=v)
    mine = local_rows(batch, mesh, cfg.anyres.tokens_per_tile, cfg.image_token_id)
    loss, _, grads = step.loss_and_grads(state, mine)
    grads, _ = _full(state, grads)
    state, metrics = step(state, mine)
    assert float(metrics["loss"]) == float(loss)
    _, params = _full(state, {})
    _save_stage(mesh, out, loss=float(loss), **{f"g/{k}": g.numpy() for k, g in grads.items()},
                **{f"p/{k}": p.numpy() for k, p in params.items()})
    return state, step


def _world4(rank, world, store, path, out):
    import torch.distributed as dist

    from leopard_tpu_torch.config import MeshConfig
    from leopard_tpu_torch.parallel.mesh import build_mesh

    init_worker(rank, world, store, dict(stage=2, model=2))
    data = np.load(path)
    for name, (w, mesh_kw, kind, which, m_total, v) in JAX_CASES.items():
        if w == world:
            run_case(build_mesh(MeshConfig(**mesh_kw), "cpu"), variant(tcfgs, kind),
                     _load(data, f"{weights_of(kind)}/full/"), _load(data, f"{which}/"), m_total, v,
                     f"{out}/{name}")
    dist.destroy_process_group()


def _world2(rank, world, store, path, out):
    import torch.distributed as dist

    from leopard_tpu_torch.config import MeshConfig
    from leopard_tpu_torch.parallel.mesh import build_mesh
    from leopard_tpu_torch.training import trainer
    from leopard_tpu_torch.training.checkpoint import CheckpointManager
    from leopard_tpu_torch.training.loop import train

    mesh = init_worker(rank, world, store, dict(stage=2))
    data = np.load(path)
    for name, (w, mesh_kw, kind, which, m_total, v) in JAX_CASES.items():
        if w == world:
            run_case(mesh, variant(tcfgs, kind), _load(data, f"{weights_of(kind)}/full/"),
                     _load(data, f"{which}/"), m_total, v, f"{out}/{name}")
    cfg, full, batch = variant(tcfgs, "plain"), _load(data, "plain/full/"), _load(data, "images/")
    tc = train_cfg(tcfgs, "full")

    # vision_chunk: 0 (tiles / M = 2 tiles a call) and None (one call of 4)
    got = {}
    for chunk in (0, None):
        state = pp.create_pp_train_state(_model(cfg, full), tc, mesh)
        step = pp.make_pp_train_step(cfg, tc, mesh, vision_chunk=chunk)
        loss, _, grads = step.loss_and_grads(state, batch)
        got[chunk] = (float(loss), _full(state, grads)[0])
    _save_stage(mesh, f"{out}/vision_chunk", loss0=got[0][0], loss_none=got[None][0],
                **{f"g0/{k}": g.numpy() for k, g in got[0][1].items()},
                **{f"gnone/{k}": g.numpy() for k, g in got[None][1].items()})
    with pytest.raises(ValueError, match="not divisible by 2 microbatches"):
        step.loss_and_grads(state, {k: v[:3] for k, v in batch.items() if k != "images"})

    # the batch ramp: 4, 6, 8, 8 rows, the pipeline step against the plain one
    ramp_tc = dataclasses.replace(tc, global_batch_size=8, rampup_batch_size=(4, 2, 8),
                                  train_steps=4, log_interval=1000, save_interval=0,
                                  eval_interval=0)
    text = _load(data, "text/")
    losses = {}
    for kind in ("pp", "plain"):
        model = _model(cfg, full)
        if kind == "pp":
            state = pp.create_pp_train_state(model, ramp_tc, mesh)
            step = pp.make_pp_train_step(cfg, ramp_tc, mesh)
        else:
            state = trainer.create_train_state(model, ramp_tc)
            step = trainer.make_train_step(cfg, ramp_tc)
        seen = []

        def record(st, b, step=step, seen=seen):
            st, metrics = step(st, b)
            seen.append((b["tokens"].shape[0], float(metrics["loss"])))
            return st, metrics

        state = train(cfg, ramp_tc, state, record, lambda bs: {k: v[:bs] for k, v in text.items()})
        losses[kind] = seen
    if rank == 0:
        np.savez(f"{out}/ramp.npz", **{k: np.asarray(v) for k, v in losses.items()})

    # a pipeline state saved whole, restored into the plain step, MemoryStages(4)
    # and this stage's own template; a stage's layers live on the mesh
    # without "stage", and the model's other layers went to "meta" uncut
    model = _model(cfg, full)
    state = pp.create_pp_train_state(model, tc, mesh)
    mine = {pp.layer_of(k) for k in state.params} - {None}
    assert mine == {2 * rank, 2 * rank + 1}
    for k, p in state.params.items():
        assert ("stage" in p.device_mesh.mesh_dim_names) == (pp.layer_of(k) is None), k
    assert all(p.is_meta == (pp.layer_of(k) not in mine | {None})
               for k, p in model.named_parameters())
    step = pp.make_pp_train_step(cfg, tc, mesh)
    state, _ = step(state, batch)
    ckpt = CheckpointManager(f"{out}/ckpt", async_save=False)
    ckpt.save(1, state)
    plain = trainer.create_train_state(_model(cfg, full), tc)
    restored, _ = ckpt.restore(template=plain)
    assert restored.step == 1 and restored.opt_state.count == 1
    assert set(restored.params) == set(plain.params)
    for k, p in state.params.items():
        for group, a, b in (("params", p, restored.params[k]),
                            ("mu", state.opt_state.mu[k], restored.opt_state.mu[k]),
                            ("nu", state.opt_state.nu[k], restored.opt_state.nu[k])):
            assert torch.equal(a.full_tensor(), b), (group, k)
    rows = build_mesh(MeshConfig(data=2), "cpu")
    template = pp.create_pp_train_state(_model(cfg, full), tc, rows, stages=MemoryStages(4))
    again, _ = ckpt.restore(template=template)
    for k, p in restored.params.items():
        assert torch.equal(again.params[k].full_tensor(), p), k
    own, _ = ckpt.restore(template=pp.create_pp_train_state(_model(cfg, full), tc, mesh))
    assert set(own.params) == set(state.params)
    for k, p in state.params.items():
        assert torch.equal(own.params[k].to_local(), p.to_local()), k
        assert torch.equal(own.opt_state.nu[k].to_local(), state.opt_state.nu[k].to_local()), k
    pp_loss = float(step.loss_and_grads(state, batch)[0])
    plain_loss = float(trainer.make_train_step(cfg, tc).loss_and_grads(restored, batch)[0])
    if rank == 0:
        np.savez(f"{out}/restore.npz", pp=pp_loss, plain=plain_loss)
    dist.destroy_process_group()


def _merged(out, name):
    """The stage files of one case as one {"loss", "g/..", "p/.."}."""
    merged = {}
    for stage in range(2):
        with np.load(f"{out}/{name}-{stage}.npz") as f:
            merged.update({k: f[k] for k in f.files})
    return merged


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, then both worlds."""
    import jax
    import jax.numpy as jnp

    from leopard_tpu import config as cfgs
    from leopard_tpu.config import MeshConfig as JMeshConfig
    from leopard_tpu.models import vlm as jvlm
    from leopard_tpu.parallel.mesh import build_mesh as jbuild_mesh
    from leopard_tpu.training import trainer as jtrainer
    from leopard_tpu.training.pp import make_pp_train_step as jmake_pp
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("pp")
    data = batches()
    arrays = {f"{w}/{k}": v for w, b in data.items() for k, v in b.items()}
    refs = {}
    jtc = train_cfg(cfgs, "none")
    params = {}
    for kind in ("plain", "tied"):
        jcfg = variant(cfgs, kind)
        params[kind] = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(4)))
        before = state_dict_from_jax(params[kind], variant(tcfgs, kind))
        arrays.update({f"{kind}/full/{k}": v.numpy() for k, v in before.items()})
        refs[kind] = before
    want = {}
    for name, (_, _, kind, which, _, _) in JAX_CASES.items():
        jkind = weights_of(kind)
        jcfg = variant(cfgs, jkind)
        jbatch = {k: jnp.asarray(v) for k, v in data[which].items()}
        step = jtrainer.make_train_step(jcfg, jtc)

        def both(state, b, jcfg=jcfg, step=step):
            loss, grads = jax.value_and_grad(lambda p: jtrainer.vlm_loss(
                p, jcfg, b, jnp.float32, False, loss_chunk=16)[0])(state.params)
            return loss, grads, step(state, b)[0].params

        state = jtrainer.create_train_state(params[jkind], jtc)
        loss, grads, new = jax.device_get(jax.jit(both)(state, jbatch))
        tcfg = variant(tcfgs, jkind)
        want[name] = (float(loss), state_dict_from_jax(grads, tcfg),
                      state_dict_from_jax(new, tcfg), refs[jkind])
    # the ring case's loss and params from the JAX pipeline itself
    jmesh = jbuild_mesh(JMeshConfig(stage=2, seq=2), devices=jax.devices()[:4])
    jstep = jmake_pp(variant(cfgs, "ring"), jtc, jmesh, num_microbatches=2, virtual_chunks=2)
    new, metrics = jax.device_get(jax.jit(jstep)(
        jtrainer.create_train_state(params["plain"], jtc),
        {k: jnp.asarray(v) for k, v in data["images"].items()}))
    loss, grads, _, before = want["stage2_seq2_ring_v2"]
    want["stage2_seq2_ring_v2"] = (float(metrics["loss"]), grads,
                                   state_dict_from_jax(new.params, variant(tcfgs, "plain")),
                                   before)
    assert abs(float(metrics["loss"]) - loss) <= 1e-5   # JAX's pipeline against its plain step
    path = str(tmp / "in.npz")
    np.savez(path, **arrays)
    run_world(_world4, 4, tmp, path, str(tmp))
    run_world(_world2, 2, tmp, path, str(tmp))
    return tmp, want


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_pp_step_matches_jax(runs, name):
    out, want = runs
    loss, want_g, want_p, before = want[name]
    got = _merged(out, name)
    assert {k[2:] for k in got if k.startswith("g/")} == set(want_g)
    # a text-only batch gives the tower and projector (41 of 80 leaves) no gradient
    assert_step_matches(got, loss, want_g, want_p, before,
                        real_share=0.45 if JAX_CASES[name][3] == "text" else 0.9)


def test_vision_chunk_0_equals_one_call(runs):
    got = _merged(runs[0], "vision_chunk")
    assert abs(float(got["loss0"]) - float(got["loss_none"])) <= 1e-6 * abs(float(got["loss0"]))
    for k in (k for k in got if k.startswith("g0/")):
        a, b = got[k], got["gnone/" + k[3:]]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(np.abs(b).max(), 1e-12),
                                   err_msg=k)


def test_batch_ramp_drives_pp_step(runs):
    with np.load(f"{runs[0]}/ramp.npz") as f:
        got, plain = f["pp"], f["plain"]
    assert [int(r) for r in got[:, 0]] == [4, 6, 8, 8] == [int(r) for r in plain[:, 0]]
    np.testing.assert_allclose(got[:, 1], plain[:, 1], rtol=1e-5)


def test_pp_checkpoint_restores_into_plain_step(runs):
    with np.load(f"{runs[0]}/restore.npz") as f:
        np.testing.assert_allclose(float(f["plain"]), float(f["pp"]), rtol=1e-5)


@pytest.mark.parametrize("saved, template, error", [
    (dict(num_layers=6), dict(num_layers=4), KeyError),   # a deeper model's file
    (dict(num_layers=4), dict(num_layers=6), KeyError),   # a shallower model's
    (dict(vocab_size=640), dict(vocab_size=512), ValueError),   # another shape
])
def test_restore_refuses_another_models_file(tmp_path, saved, template, error):
    """A plain template takes a file of exactly its names and shapes: only
    a pipeline stage's template may leave other stages' layers."""
    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.training import trainer
    from leopard_tpu_torch.training.checkpoint import CheckpointManager

    def state(**text):
        cfg = variant(tcfgs, "plain")
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, **text))
        return trainer.create_train_state(LeopardVLM(cfg), train_cfg(tcfgs, "full"))

    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(1, state(**saved))
    with pytest.raises(error, match="template"):
        ckpt.restore(template=state(**template))


def _refused(stages=None, **overrides):
    sizes = dict(stage=1)
    sizes.update(overrides.pop("mesh", {}))
    mesh = _Coord({}, **sizes)
    cfg = overrides.pop("cfg", variant(tcfgs, "plain"))
    pp.make_pp_train_step(cfg, train_cfg(tcfgs, "full"), mesh,
                          stages=stages or MemoryStages(2), **overrides)


@pytest.mark.parametrize("case", ["one_stage", "moe", "layers", "plain_step_at_stage2"])
def test_refusals(case):
    from leopard_tpu_torch.training import trainer

    moe = variant(tcfgs, "plain")
    moe = dataclasses.replace(moe, text=dataclasses.replace(moe.text, num_experts=4))
    want = {"one_stage": (ValueError, "use make_train_step", dict(stages=MemoryStages(1))),
            "moe": (NotImplementedError, "MoE", dict(cfg=moe)),
            "layers": (ValueError, "do not split", dict(virtual_chunks=3))}
    if case == "plain_step_at_stage2":
        with pytest.raises(NotImplementedError, match="make_pp_train_step"):
            trainer.make_train_step(variant(tcfgs, "plain"), train_cfg(tcfgs, "full"),
                                    mesh=_Coord({}, stage=2))
        return
    error, match, kw = want[case]
    with pytest.raises(error, match=match):
        _refused(**kw)
