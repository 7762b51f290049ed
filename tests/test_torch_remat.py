"""The recompute policies "attn" and "selective" of the port (ops/remat.py)
and the mixed policy (remat="selective", remat_vision="full"), on the CPU at
tiny_vlm in float32.

  - the first step's loss and gradients under each policy equal the port's
    "none" at the tolerance of test_torch_training.py's
    test_full_remat_matches_none (loss rtol 1e-5, grads rtol 1e-4 and atol
    1e-7: the same math, recomputed) and the JAX package's loss and
    gradients under the same policy (loss rtol 1e-5; grads rtol 2e-4 and
    atol 2e-5 of the largest gradient, the tolerance of
    test_torch_train_step.py: fp32 on both sides, sums in another order);
  - a counter on the attention forward (the plain version of K1, which the
    flash tier runs on the CPU) shows it once per layer per step under
    "attn" and "selective" and twice under "full";
  - under "selective" the backward recomputes no plain matmul (`aten.mm`,
    `aten.addmm`), under "attn" it does;
  - the dense tiers' output is tagged (copied) only under "attn" and
    "selective", the policies that save it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from leopard_tpu import config as jcfgs
from leopard_tpu.models import vlm as jvlm
from leopard_tpu.training import trainer as jtrainer
from leopard_tpu_torch import config as cfgs
from leopard_tpu_torch.config import OptimizerConfig, TrainConfig
from leopard_tpu_torch.convert.from_jax import jax_tree_from_state_dict, state_dict_from_jax
from leopard_tpu_torch.models import vlm
from leopard_tpu_torch.ops import flash_attention as fa
from leopard_tpu_torch.ops.remat import remat_wrap
from leopard_tpu_torch.training import trainer

torch.set_num_threads(2)
POLICIES = [("attn", None), ("selective", None), ("selective", "full")]
IDS = ["attn", "selective", "mixed"]


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 100, (2, 16)).astype(np.int32)
    ids[:, 2:6] = cfg.image_token_id
    seg = np.ones((2, 16), np.int32)
    seg[1, -3:] = 0
    return {"tokens": ids, "loss_weights": np.ones((2, 16), np.float32), "segment_ids": seg,
            "images": rng.randn(2, 3, 56, 56).astype(np.float32)}


def _params():
    return jax.device_get(jvlm.init_params(jcfgs.tiny_vlm(), jax.random.PRNGKey(0)))


def _first_layer(cfg):
    """Decoder layer 0 of a VLM holding the JAX init's weights (a module
    built without loading holds whatever `torch.empty` gave it)."""
    model = vlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(_params(), cfg), strict=True)
    return model.text.layers[0]


def _port_grads(cfg, params, batch, remat, remat_vision=None):
    model = vlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    tcfg = TrainConfig(remat=remat, remat_vision=remat_vision, loss_chunk=16,
                       optimizer=OptimizerConfig(lr=1e-2, warmup_steps=1, decay_steps=100))
    step = trainer.make_train_step(cfg, tcfg)
    loss, _, grads = step.loss_and_grads(trainer.create_train_state(model, tcfg),
                                         {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), grads


def _jax_grads(params, batch, remat, remat_vision=None):
    cfg = jcfgs.tiny_vlm()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtrainer.vlm_loss(
        p, cfg, jbatch, jnp.float32, remat, loss_chunk=16, remat_vision=remat_vision)[0]))(
        params)
    return float(loss), jax.device_get(grads)


@pytest.fixture(scope="module")
def setup():
    params = _params()
    batch = _batch(cfgs.tiny_vlm())
    return params, batch, _port_grads(cfgs.tiny_vlm(), params, batch, "none")


@pytest.mark.parametrize("remat,remat_vision", POLICIES, ids=IDS)
def test_policy_matches_none(setup, remat, remat_vision):
    params, batch, (loss0, g0) = setup
    loss, grads = _port_grads(cfgs.tiny_vlm(), params, batch, remat, remat_vision)
    np.testing.assert_allclose(loss, loss0, rtol=1e-5)
    assert grads.keys() == g0.keys()
    for k in g0:
        np.testing.assert_allclose(grads[k].numpy(), g0[k].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("remat,remat_vision", POLICIES, ids=IDS)
def test_policy_matches_jax(setup, remat, remat_vision):
    params, batch, _ = setup
    loss, grads = _port_grads(cfgs.tiny_vlm(), params, batch, remat, remat_vision)
    jloss, jgrads = _jax_grads(params, batch, remat, remat_vision)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    got = {jax.tree_util.keystr(k): np.asarray(v)
           for k, v in jax.tree_util.tree_leaves_with_path(jax_tree_from_state_dict(grads))}
    assert got.keys() == want.keys()
    scale = max(float(np.abs(g).max()) for g in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=2e-5 * scale, err_msg=name)


def _flash_cfg():
    """tiny_vlm with every attention through the flash tier: the decoder's
    threshold below the 16-token batch, the tower forced to "flash"."""
    cfg = cfgs.tiny_vlm()
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, long_seq_threshold=8),
        vision=dataclasses.replace(cfg.vision, attn_impl="flash"))


@pytest.mark.parametrize("remat,remat_vision,text_runs,vision_runs", [
    ("full", None, 2, 2), ("attn", None, 1, 1), ("selective", None, 1, 1),
    ("selective", "full", 1, 2)], ids=["full", "attn", "selective", "mixed"])
def test_attention_forward_runs_once_per_layer(setup, monkeypatch, remat, remat_vision,
                                               text_runs, vision_runs):
    params, batch, _ = setup
    cfg = _flash_cfg()
    calls = {"text": 0, "vision": 0}
    real = fa.flash_attention_ref

    def counted(q, k, v, **kw):
        calls["text" if kw["causal"] else "vision"] += 1
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention_ref", counted)
    loss, grads = _port_grads(cfg, params, batch, remat, remat_vision)
    layers = cfg.vision.num_layers + 1 + cfg.vision.feature_layer \
        if cfg.vision.feature_layer != -1 else cfg.vision.num_layers
    assert calls == {"text": text_runs * cfg.text.num_layers, "vision": vision_runs * layers}
    # the flash tier gives the dense tiers' loss under the same policy
    want, _ = _port_grads(cfgs.tiny_vlm(), params, batch, remat, remat_vision)
    np.testing.assert_allclose(loss, want, rtol=1e-5)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode,recomputed", [("attn", True), ("selective", False)])
def test_selective_saves_plain_matmuls(mode, recomputed):
    """One decoder layer: the backward under "selective" runs only the
    gradient products (2 per forward matmul), under "attn" also the
    recomputed forward matmuls but the last (w_down: the recompute stops
    once it has every saved tensor, and no backward reads that output)."""
    cfg = _flash_cfg()
    layer = _first_layer(cfg)
    torch.nn.init.normal_(layer.attn.wq, std=0.1)
    h = cfg.text.hidden_size
    x = torch.randn(1, 16, h, requires_grad=True)
    pos = torch.arange(16)[None]
    from leopard_tpu_torch.ops.rotary import compute_inv_freq, rope_cos_sin

    cos, sin = rope_cos_sin(pos, torch.from_numpy(compute_inv_freq(cfg.text)))
    kw = dict(attn_impl="dense", mask=None, segment_ids=None, ranges=None, cache=None,
              layer_idx=0, slots=None, fresh_cache=False)
    out = remat_wrap(layer, mode)(x, cfg.text, cos, sin, **kw)
    with _CountMatmuls() as counter:
        out.sum().backward()
    grads = 7 * 2  # dx and dW of q, k, v, o, gate, up, down
    assert counter.n == grads + (6 if recomputed else 0)


class _CountTags(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.leopard.attn_out.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode,tags", [("none", 0), ("full", 0), ("attn", 1), ("selective", 1)])
def test_attn_out_tagged_only_where_saved(mode, tags):
    """One dense decoder layer's forward: tag_attn_out's copy runs once
    under the policies that save it and never under "none" or "full"."""
    cfg = cfgs.tiny_vlm()
    layer = _first_layer(cfg)
    x = torch.randn(1, 16, cfg.text.hidden_size, requires_grad=True)
    from leopard_tpu_torch.ops.rotary import compute_inv_freq, rope_cos_sin

    cos, sin = rope_cos_sin(torch.arange(16)[None], torch.from_numpy(compute_inv_freq(cfg.text)))
    kw = dict(attn_impl="dense", mask=None, segment_ids=None, ranges=None, cache=None,
              layer_idx=0, slots=None, fresh_cache=False)
    with _CountTags() as counter:
        out = remat_wrap(layer, mode)(x, cfg.text, cos, sin, **kw)
    assert counter.n == tags
    out.sum().backward()
    assert torch.isfinite(x.grad).all()
