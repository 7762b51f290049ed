"""The training slice as a whole, against the JAX package: `tiny_vlm` in
float32 with `attn_impl="flash"` in the text decoder and the vision tower,
one packed batch (two segments a row, positions restarting per segment,
images, a padding tail), full recompute, chunked cross-entropy, AdamW with
clipping and weight decay.

The JAX side runs its Pallas flash kernels (forward and backward) in
interpret mode, without recompute (interpret mode's callbacks cannot go
through `jax.checkpoint`); the port runs the plain versions of K1 and K2
through its autograd function, on the CPU, under full recompute, which
must not change a number. Tolerances:
  - loss: rtol 1e-5 (fp32 on both sides; only the order of sums differs);
  - grads: rtol 2e-4 and atol 2e-5 of the largest gradient of the tree,
    the JAX flash tests' tolerance scaled to the gradients' size (leaves
    whose exact gradient is 0, such as the key bias under softmax's shift
    invariance, hold only float noise on both sides);
  - params after each step: atol LR / 100. Adam's update m̂ / (√v̂ + eps)
    magnifies noise in a near-zero gradient: its first step is about
    lr · sign(g), so with the default eps (1e-8) an element whose gradient
    is ~1e-8 moves by ±lr on a coin flip of float noise. The test therefore
    uses eps = 1e-4: a noise-level gradient (~1e-7) then moves its element
    by ~1e-3 · lr, while every element with a real gradient still moves by
    ~lr, so a wrong update would be off by ~100 times the tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leopard_tpu import config as cfgs
from leopard_tpu.models import vlm as jvlm
from leopard_tpu.training import trainer as jtrainer
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert.from_jax import jax_tree_from_state_dict, state_dict_from_jax
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(2)
LR = 1e-2


def _flash_cfg(mod):
    cfg = mod.tiny_vlm()
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, attn_impl="flash"),
        vision=dataclasses.replace(cfg.vision, attn_impl="flash"))


def _train_cfg(mod, remat):
    return mod.TrainConfig(
        remat=remat, loss_chunk=16,
        optimizer=mod.OptimizerConfig(lr=LR, warmup_steps=0, decay_steps=100, eps=1e-4,
                                      weight_decay=0.1, grad_clip=1.0))


def packed_batch(cfg, seed=0):
    """Two rows of 40 tokens: row 0 packs samples of 22 and 18 tokens, row 1
    of 17 and 15 and a padding tail of 8; each sample is BOS, one tile's
    image tokens, then text. Positions restart at 0 in each segment."""
    rng = np.random.RandomState(seed)
    per_tile = cfg.anyres.tokens_per_tile
    s = 40
    tokens = np.zeros((2, s), np.int32)
    seg = np.zeros((2, s), np.int32)
    pos = np.zeros((2, s), np.int32)
    weights = np.zeros((2, s), np.float32)
    for r, lengths in enumerate(((22, 18), (17, 15))):
        start = 0
        for sid, n in enumerate(lengths, start=1):
            sample = rng.randint(1, cfg.image_token_id, size=n)
            sample[1:1 + per_tile] = cfg.image_token_id
            tokens[r, start:start + n] = sample
            seg[r, start:start + n] = sid
            pos[r, start:start + n] = np.arange(n)
            weights[r, start:start + n] = sample != cfg.image_token_id
            start += n
    images = rng.randn(4, 3, cfg.vision.image_size, cfg.vision.image_size).astype(np.float32)
    return dict(tokens=tokens, segment_ids=seg, positions=pos, loss_weights=weights,
                images=images)


@pytest.fixture(scope="module")
def runs():
    """JAX and the port from the same weights and batch: the loss and grads
    at the start, and the loss and params of each of two train steps."""
    jcfg, tcfg = _flash_cfg(cfgs), _flash_cfg(tcfgs)
    params = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = packed_batch(jcfg)

    with pltpu.force_tpu_interpret_mode():
        jtc = _train_cfg(cfgs, "none")
        jstate = jtrainer.create_train_state(params, jtc)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jtrainer.vlm_loss(p, jcfg, jbatch, jnp.float32, False, loss_chunk=16)[0]
        ))(jstate.params)
        j = {"loss0": float(loss), "grads": jax.device_get(grads), "loss": [], "params": []}
        step = jax.jit(jtrainer.make_train_step(jcfg, jtc))
        for _ in range(2):
            jstate, metrics = step(jstate, jbatch)
            j["loss"].append(float(metrics["loss"]))
            j["params"].append(jax.device_get(jstate.params))

    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    ttc = _train_cfg(tcfgs, "full")
    tstate = ttrainer.create_train_state(model, ttc)
    tstep = ttrainer.make_train_step(tcfg, ttc)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = tstep.loss_and_grads(tstate, tbatch)
    t = {"loss0": float(loss), "grads": jax_tree_from_state_dict(grads), "loss": [],
         "params": []}
    for _ in range(2):
        tstate, metrics = tstep(tstate, tbatch)
        t["loss"].append(float(metrics["loss"]))
        t["params"].append(jax_tree_from_state_dict(tstate.params))
    return j, t


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_loss_matches_jax(runs):
    j, t = runs
    np.testing.assert_allclose([t["loss0"], *t["loss"]], [j["loss0"], *j["loss"]], rtol=1e-5)


def test_grads_match_jax(runs):
    j, t = runs
    jg, tg = _leaves(j["grads"]), _leaves(t["grads"])
    assert set(jg) == set(tg)
    scale = max(float(np.abs(g).max()) for g in jg.values())
    for name, want in jg.items():
        np.testing.assert_allclose(tg[name], want, rtol=2e-4, atol=2e-5 * scale, err_msg=name)


@pytest.mark.parametrize("step", [0, 1])
def test_params_after_steps_match_jax(runs, step):
    j, t = runs
    jp, tp = _leaves(j["params"][step]), _leaves(t["params"][step])
    assert set(jp) == set(tp)
    for name, want in jp.items():
        np.testing.assert_allclose(tp[name], want, rtol=0, atol=LR / 100, err_msg=name)
