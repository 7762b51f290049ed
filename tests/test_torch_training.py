"""The port's trainer, optimizer, checkpoints and loops (ports of
tests/test_training.py), on the CPU at the tiny config, held against the
JAX trainer and optax where the two can be compared directly.

Tolerances: losses rtol 1e-5 and gradient norms rtol 1e-4 (fp32 on both
sides, sums in another order); optimizer updates from identical inputs
rtol 1e-6, atol 1e-9 (elementwise fp32 math, the same formulas); params
after steps whose gradients differ only by float noise, atol 5e-4 = lr / 20,
as the JAX tests state it (Adam's normalization magnifies noise near g = 0).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leopard_tpu import config as jcfgs
from leopard_tpu.models import vlm as jvlm
from leopard_tpu.training import trainer as jtrainer
from leopard_tpu_torch import config as cfgs
from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.models import vlm
from leopard_tpu_torch.training import trainer
from leopard_tpu_torch.training.checkpoint import CheckpointManager
from leopard_tpu_torch.training.finetune import finetune
from leopard_tpu_torch.training.loop import evaluate_loss, param_hash, train
from leopard_tpu_torch.utils.timers import MetricsLogger

torch.set_num_threads(2)


def _model(seed=0):
    return vlm.init_params(cfgs.tiny_vlm(), torch.Generator().manual_seed(seed))


def _setup(remat="none", **opt):
    cfg = cfgs.tiny_vlm()
    tcfg = TrainConfig(seq_len=16, global_batch_size=2, remat=remat,
                       optimizer=OptimizerConfig(**{"lr": 1e-2, "warmup_steps": 1,
                                                    "decay_steps": 100, **opt}))
    state = trainer.create_train_state(_model(), tcfg)
    return cfg, tcfg, state, trainer.make_train_step(cfg, tcfg)


def _batch(cfg, b=2, s=16, with_images=True, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 100, (b, s)).astype(np.int64)
    batch = {"loss_weights": torch.ones((b, s)), "segment_ids": torch.ones((b, s), dtype=torch.int32)}
    if with_images:
        ids[:, 2:6] = cfg.image_token_id
        batch["images"] = torch.from_numpy(rng.randn(b, 3, 56, 56).astype(np.float32))
    batch["tokens"] = torch.from_numpy(ids)
    return batch


def _copy(tensors):
    return {k: v.clone() for k, v in tensors.items()}


def test_token_cross_entropy_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 8).astype(np.float32)
    targets = np.array([[1, 3, 5, 7, 99], [0, 2, 4, 6, 8]], np.int32)  # 99, 8: out of vocab
    weights = np.array([[1, 0, 1, 1, 0], [1, 1, 0.5, 1, 0]], np.float32)
    want, want_w = jtrainer.token_cross_entropy(*map(jnp.asarray, (logits, targets, weights)))
    got, got_w = trainer.token_cross_entropy(*map(torch.from_numpy, (logits, targets, weights)))
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(got_w) == float(want_w)


@pytest.mark.parametrize("s,chunk", [(12, 5), (127, 32)], ids=["short", "prime_length"])
def test_chunked_ce_matches_dense_and_jax(s, chunk, monkeypatch):
    """S = 127 is prime: S is padded to 4 chunks of 32, never shrunk to a
    divisor (JAX trainer.py:132-190)."""
    rng = np.random.RandomState(11)
    hidden = rng.randn(2, s, 16).astype(np.float32)
    head = rng.randn(40, 16).astype(np.float32)  # [V, H], the port's layout
    targets = rng.randint(0, 40, (2, s)).astype(np.int32)
    weights = (rng.rand(2, s) > 0.3).astype(np.float32)
    want, _ = jtrainer.chunked_cross_entropy(jnp.asarray(hidden), jnp.asarray(head.T),
                                             jnp.asarray(targets), jnp.asarray(weights),
                                             chunk=chunk)
    calls = []
    real = trainer._chunk_nll
    monkeypatch.setattr(trainer, "_chunk_nll", lambda *a: calls.append(1) or real(*a))
    h, u = torch.from_numpy(hidden).requires_grad_(), torch.from_numpy(head).requires_grad_()
    got, got_w = trainer.chunked_cross_entropy(h, u, torch.from_numpy(targets),
                                               torch.from_numpy(weights), chunk=chunk)
    assert len(calls) == -(-s // chunk)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert float(got_w) == float(weights.sum())
    dense, _ = trainer.token_cross_entropy(h @ u.T, torch.from_numpy(targets),
                                           torch.from_numpy(weights))
    np.testing.assert_allclose(got.item(), dense.item(), rtol=1e-5)
    g_chunked = torch.autograd.grad(got, (h, u))
    g_dense = torch.autograd.grad(dense, (h, u))
    for a, b in zip(g_chunked, g_dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def test_decay_mask_matches_jax():
    cfg = jcfgs.tiny_vlm()
    jmask = jtrainer._decay_mask(jvlm.init_params(cfg, jax.random.PRNGKey(0)))
    for name, p in _model().named_parameters():
        node = jmask
        for key in name.split("."):
            if not key.isdigit():  # the JAX tree stacks layers
                node = node[key]
        assert trainer.decay_mask(name, p) == bool(node), name


@pytest.mark.parametrize("schedule,warmup", [("cosine", 3), ("cosine", 0), ("linear", 4),
                                             ("constant", 2)])
def test_lr_schedule_matches_optax(schedule, warmup):
    kw = dict(lr=2e-3, min_lr=1e-4, warmup_steps=warmup, decay_steps=20, schedule=schedule)
    want = jtrainer.lr_schedule(jcfgs.OptimizerConfig(**kw))
    got = trainer.lr_schedule(OptimizerConfig(**kw))
    counts = range(0, 25)
    np.testing.assert_allclose([got(c) for c in counts], [float(want(c)) for c in counts],
                               rtol=1e-6, atol=1e-12)
    if warmup and schedule != "constant":
        assert got(0) == 0.0  # optax counts from 0: a warmup's first step has lr 0


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adamw_matches_optax(clip):
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=10, weight_decay=0.1, grad_clip=clip,
              beta2=0.95)
    rng = np.random.RandomState(3)
    # names outside `layers`: the JAX mask reads a leading layer axis there
    shapes = {"text.lm_head": (6, 4), "text.final_norm": (4,),
              "vision.post_ln.bias": (4,), "projector.fc1": (3, 5)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]

    tx = jtrainer.make_optimizer(jcfgs.OptimizerConfig(**kw))
    jtree = {k.replace(".", "/"): jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jtree)
    opt = trainer.make_optimizer(OptimizerConfig(**kw))
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tparams)
    for g in grads:
        jg = {k.replace(".", "/"): jnp.asarray(v) for k, v in g.items()}
        updates, opt_state = tx.update(jg, opt_state, jtree)
        jtree = optax.apply_updates(jtree, updates)
        tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        opt.update_(tg, state, tparams, trainer.global_norm(tg))
    assert state.count == 3
    for k in params:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jtree[k.replace(".", "/")]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


def test_train_step_reduces_loss():
    cfg, _, state, step = _setup()
    batch = _batch(cfg)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[1] == losses[0]  # lr 0 on the first step (warmup from 0)
    assert losses[-1] < losses[0] * 0.9, losses
    assert state.step == 8 and state.opt_state.count == 8


def test_first_step_matches_jax():
    """One train step from the same weights: loss, grad norm and params."""
    cfg = jcfgs.tiny_vlm()
    params = jax.device_get(jvlm.init_params(cfg, jax.random.PRNGKey(0)))
    jtc = jcfgs.TrainConfig(remat="none", optimizer=jcfgs.OptimizerConfig(
        lr=1e-2, warmup_steps=0, decay_steps=100, weight_decay=0.1, eps=1e-4))
    batch = _batch(cfgs.tiny_vlm())
    jstate, jm = jax.jit(jtrainer.make_train_step(cfg, jtc))(
        jtrainer.create_train_state(params, jtc), {k: jnp.asarray(v.numpy()) for k, v in batch.items()})

    model = vlm.LeopardVLM(cfgs.tiny_vlm())
    model.load_state_dict(state_dict_from_jax(params, cfgs.tiny_vlm()), strict=True)
    ttc = TrainConfig(remat="none", optimizer=OptimizerConfig(
        lr=1e-2, warmup_steps=0, decay_steps=100, weight_decay=0.1, eps=1e-4))
    tstate, tm = trainer.make_train_step(cfgs.tiny_vlm(), ttc)(
        trainer.create_train_state(model, ttc), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = state_dict_from_jax(jax.device_get(jstate.params), cfgs.tiny_vlm())
    for k, v in tstate.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=5e-4, rtol=0, err_msg=k)


def test_full_remat_matches_none():
    cfg, _, state, step = _setup("none")
    _, _, state_r, step_r = _setup("full")
    batch = _batch(cfg)
    l1, m1, g1 = step.loss_and_grads(state, batch)
    l2, m2, g2 = step_r.loss_and_grads(state_r, batch)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode", ["selective", "attn"])
def test_policies_not_ported_raise(mode):
    cfg, _, state, step = _setup(mode)
    with pytest.raises(NotImplementedError, match=mode):
        step(state, _batch(cfg))


def test_frozen_groups_dont_update():
    cfg = cfgs.tiny_vlm()
    tcfg = TrainConfig(remat="none", optimizer=OptimizerConfig(lr=1e-2, warmup_steps=1,
                                                               decay_steps=100))
    state = trainer.create_train_state(_model(), tcfg)
    step = trainer.make_train_step(cfg, tcfg, frozen=("vision",))
    before = _copy(state.params)
    for _ in range(2):  # the first step has lr 0 (warmup)
        state, _ = step(state, _batch(cfg))
    moved = {k: float((state.params[k] - before[k]).abs().max()) for k in before}
    assert all(v == 0 for k, v in moved.items() if k.startswith("vision."))
    assert max(v for k, v in moved.items() if k.startswith("text.")) > 0
    # frozen groups still go through AdamW, with zero gradients
    assert all(float(state.opt_state.nu[k].abs().max()) == 0 for k in before
               if k.startswith("vision."))


def test_loss_ignores_image_and_pad_targets():
    cfg, _, state, step = _setup()
    b = _batch(cfg)
    seg = torch.ones((2, 16), dtype=torch.int32)
    seg[:, -4:] = 0
    b["segment_ids"] = seg
    _, aux, _ = step.loss_and_grads(state, b)
    targets = b["tokens"][:, 1:]
    valid = (targets != cfg.image_token_id) & (seg[:, 1:] != 0)
    assert float(aux["tokens_in_loss"]) == float(valid.sum())


def test_nan_step_skips_update():
    cfg, _, state, step = _setup(warmup_steps=0)
    state, _ = step(state, _batch(cfg))  # a real update first: moments non-zero
    bad = _batch(cfg)
    bad["loss_weights"] = bad["loss_weights"] * float("nan")
    params, mu, nu = _copy(state.params), _copy(state.opt_state.mu), _copy(state.opt_state.nu)
    count = state.opt_state.count
    state2, metrics = step(state, bad)
    assert metrics["nan_step"]
    assert state2.step == 2 and state2.opt_state.count == count
    for k in params:
        assert torch.equal(state2.params[k], params[k])
        assert torch.equal(state2.opt_state.mu[k], mu[k])
        assert torch.equal(state2.opt_state.nu[k], nu[k])


@pytest.mark.parametrize("with_images", [False, True], ids=["text", "ragged_tiles"])
def test_grad_accumulation_matches_full_batch(with_images):
    """accum = 2 over 4 rows equals one 4-row step: microbatches weighted by
    their tokens in the loss (ragged answer-only weights), and with images
    pre-stacked per microbatch (padding tiles allowed)."""
    cfg = cfgs.tiny_vlm()
    tcfg = TrainConfig(remat="none", optimizer=OptimizerConfig(
        lr=1e-2, warmup_steps=0, decay_steps=100, grad_clip=0.0, eps=1.0))
    rng = np.random.RandomState(13)
    ids = rng.randint(1, 100, (4, 16)).astype(np.int64)
    w = np.zeros((4, 16), np.float32)
    w[0, 6:], w[1, 3:8], w[2, 8:], w[3, 1:] = 1, 1, 1, 1
    full = {"tokens": None, "loss_weights": torch.from_numpy(w),
            "segment_ids": torch.ones((4, 16), dtype=torch.int32)}
    accum = dict(full)
    if with_images:
        for r in (0, 2, 3):
            ids[r, 2:6] = cfg.image_token_id
        tiles = rng.randn(3, 3, 56, 56).astype(np.float32)
        stacked = np.zeros((2, 2, 3, 56, 56), np.float32)
        stacked[0, 0], stacked[1, 0], stacked[1, 1] = tiles
        full["images"], accum["images"] = torch.from_numpy(tiles), torch.from_numpy(stacked)
    full["tokens"] = accum["tokens"] = torch.from_numpy(ids)

    s1, m1 = trainer.make_train_step(cfg, tcfg)(trainer.create_train_state(_model(), tcfg), full)
    s2, m2 = trainer.make_train_step(cfg, tcfg, grad_accum_steps=2)(
        trainer.create_train_state(_model(), tcfg), accum)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-4)
    for k in s1.params:
        np.testing.assert_allclose(s1.params[k].numpy(), s2.params[k].numpy(), atol=5e-4,
                                   rtol=0, err_msg=k)


def test_checkpoint_round_trip(tmp_path):
    cfg, tcfg, state, step = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for _ in range(3):
        state, _ = step(state, _batch(cfg))
        mgr.save(state.step, state, data_state={"epoch": 0, "cursor": 40 + state.step},
                 config=cfgs.to_dict(cfg))
    mgr.wait_until_finished()
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]  # max_to_keep
    with open(tmp_path / "ckpt" / "latest_checkpointed_iteration.txt") as f:
        assert f.read() == "3"
    with open(tmp_path / "ckpt" / "3" / "config.json") as f:
        assert cfgs.from_dict(cfgs.VLMConfig, json.load(f)) == cfg

    restored, data_state = mgr.restore(template=state)
    assert data_state["cursor"] == 43 and restored.step == 3
    assert restored.opt_state.count == state.opt_state.count
    for k in state.params:
        assert torch.equal(restored.params[k], state.params[k])
        assert torch.equal(restored.opt_state.mu[k], state.opt_state.mu[k])
        assert torch.equal(restored.opt_state.nu[k], state.opt_state.nu[k])
    assert param_hash(restored.params) == param_hash(state.params)
    mgr.close()
    assert CheckpointManager(str(tmp_path / "empty")).restore() == (None, None)


def test_checkpoint_params_only_round_trip(tmp_path):
    """Parameters alone ({name: tensor}, as an HF conversion has them) save
    and restore as a mapping, placed like the template's tensors."""
    model = _model()
    params = {k: v.detach() for k, v in model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(0, params, config={"arch": "leopard_llava"})
    assert mgr.latest_step() == 0
    for template in (None, params):
        restored, data_state = mgr.restore(template=template)
        assert data_state is None and isinstance(restored, dict)
        assert restored.keys() == params.keys()
        for k, v in params.items():
            assert torch.equal(restored[k], v) and restored[k].dtype == v.dtype
            assert restored[k].device == v.device
    with open(tmp_path / "ckpt" / "0" / "config.json") as f:
        assert json.load(f) == {"arch": "leopard_llava"}
    mgr.close()


def test_train_loop_smoke(tmp_path):
    cfg, tcfg, state, step = _setup()
    tcfg = dataclasses.replace(tcfg, train_steps=3, log_interval=1, save_interval=2,
                               eval_interval=0, check_param_hash_interval=3)

    class DataState:
        def to_dict(self):
            return {"cursor": 7}

    logger = MetricsLogger(str(tmp_path))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    final = train(cfg, tcfg, state, step, iter([_batch(cfg, seed=i) for i in range(5)]),
                  data_state=DataState(), ckpt=ckpt, logger=logger, profile_steps=(1, 2),
                  profile_dir=str(tmp_path / "profile"))
    logger.close()
    assert final.step == 3
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3]
    assert any("param_hash" in r for r in rows)
    assert ckpt.latest_step() == 2 and ckpt.restore()[1] == {"cursor": 7}
    assert os.listdir(tmp_path / "profile")  # the profiler window's trace


def test_evaluate_loss_and_finetune(tmp_path):
    cfg, tcfg, state, step = _setup(warmup_steps=0)
    loss_fn = trainer.make_train_step(cfg, tcfg).eval_loss
    batches = [_batch(cfg, seed=i) for i in range(2)]
    before = evaluate_loss(state, loss_fn, batches)
    assert set(before) == {"loss", "ppl"}
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    state = finetune(cfg, tcfg, state, step, lambda epoch: batches, num_epochs=2,
                     eval_fn=lambda s: evaluate_loss(s, loss_fn, batches), ckpt=ckpt)
    assert state.step == 4 and ckpt.latest_step() == 4
    assert evaluate_loss(state, loss_fn, batches)["loss"] < before["loss"]
