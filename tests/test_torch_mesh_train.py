"""The sharded train step, serving under a mesh, the resharded checkpoint
and the train CLI's --mesh (training/trainer.py, inference/engine.py,
training/checkpoint.py, cli/train_leopard_llava.py), on gloo across
spawned processes, against the JAX package on one device.

  - one train step at (data=1, fsdp=2, model=2), and at (seq=2, model=2)
    with `attn_impl="ring"` (JAX test_vlm_loss_grads_with_cp_match_dense):
    the global loss within 1e-4, every gradient leaf at cosine >= 0.99999
    (leaves whose exact gradient is ~0 -- the key bias under softmax's shift
    invariance -- by atol 2e-5 of the largest, as test_torch_train_step.py),
    updated parameters within LR / 100 and their updates at cosine
    >= 0.99999; fp32, the packed batch of test_torch_train_step.py;
  - Engine(mesh=) at model=2, fp32 and int8 weights: greedy tokens equal to
    the JAX Engine's and to the unsharded port's, decoding over a KV cache
    of this rank's kv heads (JAX test_sharding.py:117-165);
  - a train state saved at fsdp=2 restores at model=2 to equal tensors;
  - `python -m torch.distributed.run --nproc_per_node=2 ... --mesh fsdp=2
    --device cpu`: the first logged loss equals a direct one-process run's
    (rtol 1e-5).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs

from test_torch_mesh import init_worker, run_world

REPO = Path(__file__).resolve().parents[1]
LR = 1e-2
COS_MIN = 0.99999


def train_cfg(mod, remat):
    return mod.TrainConfig(
        remat=remat, loss_chunk=16,
        optimizer=mod.OptimizerConfig(lr=LR, warmup_steps=0, decay_steps=100, eps=1e-4,
                                      weight_decay=0.1, grad_clip=1.0))


def ring_cfg(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, attn_impl="ring"))


def _step_worker(rank, world, store, mesh_kw, ring, path, out):
    import torch.distributed as dist

    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.parallel.sharding import like, local_rows
    from leopard_tpu_torch.training import trainer

    mesh = init_worker(rank, world, store, mesh_kw)
    data = np.load(path)
    cfg = ring_cfg(tcfgs.tiny_vlm()) if ring else tcfgs.tiny_vlm()
    model = LeopardVLM(cfg)
    model.load_state_dict({k[5:]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith("full/")})
    batch = {k[6:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("batch/")}
    tc = train_cfg(tcfgs, "full")
    state = trainer.create_train_state(model, tc, mesh=mesh)
    step = trainer.make_train_step(cfg, tc, mesh=mesh)
    mine = local_rows(batch, mesh, cfg.anyres.tokens_per_tile, cfg.image_token_id)
    loss, _, grads = step.loss_and_grads(state, mine)
    grads = {k: like(state.params[k], g).full_tensor() for k, g in grads.items()}
    state, metrics = step(state, mine)
    params = {k: p.full_tensor() for k, p in state.params.items()}
    assert float(metrics["loss"]) == float(loss)
    if rank == 0:
        np.savez(out, loss=float(loss), **{f"g/{k}": v.numpy() for k, v in grads.items()},
                 **{f"p/{k}": v.numpy() for k, v in params.items()})
    dist.destroy_process_group()


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_step():
    """One JAX step on one device from the JAX init: (the loss, the grads,
    the updated params, the params before), the last three as port state
    dicts; and the batch."""
    import jax
    import jax.numpy as jnp

    from leopard_tpu import config as cfgs
    from leopard_tpu.models import vlm as jvlm
    from leopard_tpu.training import trainer as jtrainer
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax

    from test_torch_train_step import packed_batch

    jcfg = cfgs.tiny_vlm()
    params = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = packed_batch(jcfg)
    jtc = train_cfg(cfgs, "none")
    jstate = jtrainer.create_train_state(params, jtc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer.vlm_loss(p, jcfg, jbatch, jnp.float32, False, loss_chunk=16)[0]
    ))(jstate.params)
    new_state, _ = jax.jit(jtrainer.make_train_step(jcfg, jtc))(jstate, jbatch)
    tcfg = tcfgs.tiny_vlm()
    return (float(loss), state_dict_from_jax(jax.device_get(grads), tcfg),
            state_dict_from_jax(jax.device_get(new_state.params), tcfg),
            state_dict_from_jax(params, tcfg), batch)


@pytest.mark.parametrize("mesh_kw,ring", [(dict(fsdp=2, model=2), False),
                                          (dict(seq=2, model=2), True)],
                         ids=["fsdp2_model2", "seq2_model2_ring"])
def test_sharded_step_matches_jax(tmp_path, jax_step, mesh_kw, ring):
    loss, want_g, want_p, before, batch = jax_step
    path, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(path, **{f"full/{k}": v.numpy() for k, v in before.items()},
             **{f"batch/{k}": v for k, v in batch.items()})
    run_world(_step_worker, 4, tmp_path, mesh_kw, ring, path, out)
    assert_step_matches(np.load(out), loss, want_g, want_p, before)


def assert_step_matches(got, loss, want_g, want_p, before, real_share=0.9):
    """`got` ({"loss", "g/<name>", "p/<name>"}: one sharded step's loss,
    full gradients and updated params) against a reference step's; more
    than `real_share` of the leaves must have a gradient above noise."""
    assert abs(float(got["loss"]) - float(loss)) <= 1e-4
    g_max = max(float(np.abs(v.numpy()).max()) for v in want_g.values())
    real = {k for k, v in want_g.items() if float(np.abs(v.numpy()).max()) > 1e-3 * g_max}
    assert len(real) > real_share * len(want_g)
    for k, want in want_g.items():
        w, g = want.numpy(), got[f"g/{k}"]
        if k in real:
            assert _cos(g, w) >= COS_MIN, (k, _cos(g, w))
        else:  # an exact gradient of ~0: float noise on both sides
            np.testing.assert_allclose(g, w, atol=2e-5 * g_max, rtol=0, err_msg=k)
    for k, want in want_p.items():
        w, g, b = want.numpy(), got[f"p/{k}"], before[k].numpy()
        np.testing.assert_allclose(g, w, atol=LR / 100, rtol=0, err_msg=k)
        if k in real:  # a noise gradient's update is noise too
            assert _cos(g - b, w - b) >= COS_MIN, (k, _cos(g - b, w - b))


PROMPTS = ([5, 1, 30, 99], [7, 8, 9])
QUANTIZE = (None, "int8")


def _engine_worker(rank, world, store, out):
    import torch.distributed as dist

    from leopard_tpu_torch.config import GenerateConfig
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.models import vlm

    mesh = init_worker(rank, world, store, dict(model=world))
    cfg = tcfgs.tiny_vlm()
    model = vlm.init_params(cfg, torch.Generator().manual_seed(0))
    gen = GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(999999,))
    tokens = {}
    for quantize in QUANTIZE:
        eng = Engine(cfg, model, seq_buckets=(8, 16), tile_buckets=(1,), mesh=mesh,
                     quantize=quantize)
        assert eng._new_cache(1, 8).kv.shape[3] == 2 * cfg.text.num_kv_heads // world
        got = eng.generate([np.asarray(p, np.int32) for p in PROMPTS], gen_cfg=gen)
        tokens[str(quantize)] = np.stack(got.tokens)
    if rank == 0:
        np.savez(out, **tokens)
    dist.destroy_process_group()


def test_engine_over_model_axis_matches_jax(tmp_path):
    import jax

    from leopard_tpu import config as cfgs
    from leopard_tpu.inference.engine import Engine as JEngine
    from leopard_tpu_torch.convert.from_jax import jax_tree_from_state_dict
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.models import vlm

    out = str(tmp_path / "tokens.npz")
    run_world(_engine_worker, 2, tmp_path, out)
    got = np.load(out)
    cfg = tcfgs.tiny_vlm()
    model = vlm.init_params(cfg, torch.Generator().manual_seed(0))
    params = jax_tree_from_state_dict(model.state_dict())
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    for quantize in QUANTIZE:
        gen = tcfgs.GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(999999,))
        plain = Engine(cfg, model, seq_buckets=(8, 16), tile_buckets=(1,), quantize=quantize)
        want = np.stack(plain.generate(prompts, gen_cfg=gen).tokens)
        jgen = cfgs.GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(999999,))
        jeng = JEngine(cfgs.tiny_vlm(), jax.tree_util.tree_map(np.asarray, params),
                       seq_buckets=(8, 16), tile_buckets=(1,), quantize=quantize)
        np.testing.assert_array_equal(np.stack(jeng.generate(prompts, gen_cfg=jgen).tokens),
                                      want)
        np.testing.assert_array_equal(got[str(quantize)], want, err_msg=str(quantize))


def _reshard_worker(rank, world, store, path, ckpt_dir):
    import torch.distributed as dist

    from leopard_tpu_torch.config import MeshConfig
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.parallel.mesh import build_mesh
    from leopard_tpu_torch.parallel.sharding import local_rows
    from leopard_tpu_torch.training import trainer
    from leopard_tpu_torch.training.checkpoint import CheckpointManager

    fsdp = init_worker(rank, world, store, dict(fsdp=world))
    cfg, tc = tcfgs.tiny_vlm(), train_cfg(tcfgs, "none")
    data = np.load(path)
    batch = {k: torch.from_numpy(data[k]) for k in data.files}
    state = trainer.create_train_state(vlm.init_params(cfg, torch.Generator().manual_seed(0)),
                                       tc, mesh=fsdp)
    step = trainer.make_train_step(cfg, tc, mesh=fsdp)
    state, _ = step(state, local_rows(batch, fsdp, cfg.anyres.tokens_per_tile,
                                      cfg.image_token_id))
    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    ckpt.save(1, state)
    model_axis = build_mesh(MeshConfig(model=world), "cpu")
    template = trainer.create_train_state(
        vlm.init_params(cfg, torch.Generator().manual_seed(1)), tc, mesh=model_axis)
    restored, _ = ckpt.restore(template=template)
    assert restored.step == 1 and restored.opt_state.count == 1
    for group in ("params", "mu", "nu"):
        a = state.params if group == "params" else getattr(state.opt_state, group)
        b = restored.params if group == "params" else getattr(restored.opt_state, group)
        for k in a:
            assert b[k].placements == template.params[k].placements, k
            assert torch.equal(a[k].full_tensor(), b[k].full_tensor()), (group, k)
    dist.destroy_process_group()


def test_checkpoint_saved_at_fsdp_restores_at_model(tmp_path):
    from test_torch_train_step import packed_batch

    path = str(tmp_path / "batch.npz")
    np.savez(path, **packed_batch(tcfgs.tiny_vlm()))
    run_world(_reshard_worker, 2, tmp_path, path, str(tmp_path / "ckpt"))


def test_torchrun_mesh_first_loss_equals_direct_call(tmp_path):
    from PIL import Image

    from leopard_tpu_torch.cli import train_leopard_llava
    from test_torch_cli import SETS, write_tokenizer

    rng = np.random.RandomState(0)
    (tmp_path / "imgs").mkdir()
    rows = []
    for i in range(4):
        w, h = rng.randint(30, 160, size=2)
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "imgs" / f"{i}.png")
        rows.append({"conversations": [
            {"from": "human", "value": f"<image> what is shown in {i}?"},
            {"from": "gpt", "value": f"a picture number {i}, mostly noise"}],
            "images": [f"{i}.png"]})
    (tmp_path / "data.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    tok = write_tokenizer(tmp_path / "tok")

    def argv(run):
        return ["--manifest", str(tmp_path / "data.jsonl"), "--image-folder",
                str(tmp_path / "imgs"), "--tokenizer", tok, "--checkpoint-dir",
                str(tmp_path / run), "--seq-len", "256", "--global-batch-size", "2",
                "--train-steps", "1", "--lr", "1e-3", "--device", "cpu", "--tiny", *SETS]

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         "--master_addr=localhost", f"--master_port={port}",
         "-m", "leopard_tpu_torch.cli.train_leopard_llava", *argv("mesh"), "--mesh", "fsdp=2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done at step 1" in proc.stdout
    (sharded,) = [json.loads(x) for x in (tmp_path / "mesh" / "metrics.jsonl").open()]

    from leopard_tpu_torch.data.tokenizer import build_tokenizer

    train_leopard_llava.train_main(train_leopard_llava.parse_args(argv("direct")),
                                   tokenizer=build_tokenizer(tok))
    (direct,) = [json.loads(x) for x in (tmp_path / "direct" / "metrics.jsonl").open()]
    np.testing.assert_allclose(sharded["loss"], direct["loss"], rtol=1e-5)
    assert sharded["tokens_in_loss"] == direct["tokens_in_loss"]
