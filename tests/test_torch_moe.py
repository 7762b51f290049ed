"""The port's MoE (ops/moe.py, the MoE decoder, its train step and serving)
against the JAX package, on the CPU in float32, from numpy inputs and the
JAX init's weights.

Tolerances:
  - the layer's output: rtol 1e-5, atol 1e-6; aux values rtol 1e-5 (fp32
    on both sides, sums in another order);
  - gradients against `jax.grad`: rtol 1e-4, atol 1e-5 of the largest;
  - decoder logits: rtol 1e-4, atol 1e-4 (the decoder tests' tolerance);
  - one train step: loss, the MoE metrics and the gradients' global norm
    rtol 1e-5, the updated params atol LR / 100
    (tests/test_torch_train_step.py says why); `Engine.generate`:
    identical tokens, logprobs 1e-4.

Routing can flip where a token's k-th and (k+1)-th router probabilities lie
within fp32 noise of each other. Such tokens (a gap below NEAR_TIE,
computed in float64) are left out of the elementwise checks of the layer,
and the tests assert that at most one in 50 is left out. The seeds are
not chosen to avoid ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from leopard_tpu import config as jcfgs
from leopard_tpu.config import GenerateConfig
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.models import decoder as jdecoder
from leopard_tpu.models import vlm as jvlm
from leopard_tpu.ops import moe as jmoe
from leopard_tpu.training import trainer as jtrainer
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert.from_jax import jax_tree_from_state_dict, state_dict_from_jax
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.ops import moe as tmoe
from leopard_tpu_torch.ops.remat import remat_wrap
from leopard_tpu_torch.ops.rotary import compute_inv_freq, rope_cos_sin
from leopard_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(2)
NEAR_TIE = 1e-5
LR = 1e-2
MODES = {"capacity": dict(moe_dropless=False, moe_capacity_factor=1.0),
         "dropless": dict(moe_dropless=True)}


def _layer_params(e=4, h=16, f=32, seed=0):
    cfg = jmoe.MoEConfig(num_experts=e, top_k=2, intermediate_size=f, hidden_size=h,
                         dtype="float32")
    return jax.device_get(jmoe.init_params(cfg, jax.random.PRNGKey(seed)))


def _port_layer(params):
    """The JAX layer's weights in the port's layout: [E, H] and [E, out, in]."""
    router = torch.from_numpy(np.ascontiguousarray(params["router"]["w"].T))
    experts = {k: torch.from_numpy(np.ascontiguousarray(np.swapaxes(v, -1, -2)))
               for k, v in params["experts"].items()}
    return router, experts


def _cfgs(dropless, capacity_factor):
    kw = dict(num_experts=4, top_k=2, capacity_factor=capacity_factor, dropless=dropless)
    return (jmoe.MoEConfig(intermediate_size=32, hidden_size=16, dtype="float32", **kw),
            tmoe.MoEConfig(**kw))


def _near_ties(x, router_w, k=2):
    """[T] bool: tokens whose k-th and (k+1)-th probabilities (float64) lie
    within NEAR_TIE."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router_w.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return (p[:, k - 1] - p[:, k]) < NEAR_TIE


# capacity factor 1.0 on 32 tokens drops a few; 2.0 drops none; dropless
LAYER_CASES = {"capacity_drops": (False, 1.0), "capacity_roomy": (False, 2.0),
               "dropless": (True, 1.25)}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax(case):
    dropless, cf = LAYER_CASES[case]
    params = _layer_params()
    jcfg, tcfg = _cfgs(dropless, cf)
    x = np.random.RandomState(1).randn(2, 16, 16).astype(np.float32)
    want, jaux = jmoe.moe_layer(params, jcfg, jnp.asarray(x))
    router, experts = _port_layer(params)
    got, taux = tmoe.moe_layer(router, experts, tcfg, torch.from_numpy(x))
    near = _near_ties(x, params["router"]["w"])
    assert near.sum() <= max(1, near.size // 50)
    keep = ~near.reshape(2, 16)
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep], rtol=1e-5, atol=1e-6)
    for name in ("aux_loss", "z_loss", "fraction_dropped"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    dropped = float(taux["fraction_dropped"])
    assert (dropped > 0) == (case == "capacity_drops")


def test_dropless_equals_capacity_without_drops():
    """tests/test_moe.py:146 in the port: at capacity_factor = E nothing
    drops, and dropless gives the capacity path's output and gradients."""
    params = _layer_params(seed=3)
    router, experts = _port_layer(params)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 16, 16).astype(np.float32))
    outs = []
    for dropless in (True, False):
        _, tcfg = _cfgs(dropless, 4.0)
        leaves = [t.clone().requires_grad_() for t in (router, *experts.values())]
        out, aux = tmoe.moe_layer(leaves[0], dict(zip(experts, leaves[1:])), tcfg, x)
        assert float(aux["fraction_dropped"]) == 0.0
        out.square().sum().backward()
        outs.append((out.detach(), [t.grad for t in leaves]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["capacity_drops", "dropless"])
def test_moe_layer_gradients_match_jax(case):
    dropless, cf = LAYER_CASES[case]
    params = _layer_params(seed=2)
    jcfg, tcfg = _cfgs(dropless, cf)
    x = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
    assert not _near_ties(x, params["router"]["w"]).any()

    def jloss(p, xx):
        out, aux = jmoe.moe_layer(p, jcfg, xx)
        return jnp.sum(out ** 2) + aux["aux_loss"] + aux["z_loss"]

    jg, jgx = jax.device_get(jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x)))
    router, experts = _port_layer(params)
    leaves = {"router": router.requires_grad_(),
              **{k: v.requires_grad_() for k, v in experts.items()}}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_layer(leaves["router"], experts, tcfg, xt)
    (out.square().sum() + aux["aux_loss"] + aux["z_loss"]).backward()
    want = {"router": jg["router"]["w"].T, "x": np.asarray(jgx),
            **{k: np.swapaxes(v, -1, -2) for k, v in jg["experts"].items()}}
    got = {"router": router.grad.numpy(), "x": xt.grad.numpy(),
           **{k: v.grad.numpy() for k, v in experts.items()}}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def moe_cfg(mod, mode, vocab_size=512, **text_kw):
    """tiny_vlm with a 4-expert top-2 decoder in `mode` (capacity factor 1.0
    drops tokens at these sizes) and the JAX bench's tied embeddings."""
    cfg = mod.tiny_vlm(vocab_size=vocab_size)
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_experts=4, moe_top_k=2, tie_word_embeddings=True, **MODES[mode],
        **text_kw))


def _pair(mode, seed=0, **text_kw):
    jcfg, tcfg = moe_cfg(jcfgs, mode, **text_kw), moe_cfg(tcfgs, mode, **text_kw)
    params = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(seed)))
    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return jcfg, tcfg, params, model


def _text_batch(vocab, seed=0):
    """Two rows of 24 tokens, row 1 ending in 5 padding positions."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, vocab - 1, (2, 24)).astype(np.int32)
    seg = np.ones((2, 24), np.int32)
    seg[1, -5:] = 0
    tokens[1, -5:] = 0
    return dict(tokens=tokens, segment_ids=seg, loss_weights=seg.astype(np.float32))


@pytest.mark.parametrize("mode", list(MODES))
def test_decoder_forward_with_aux_matches_jax(mode):
    jcfg, tcfg, params, model = _pair(mode)
    assert not hasattr(model.text, "lm_head")
    assert model.text.layers[0].router.w.dtype == torch.float32
    b = _text_batch(jcfg.text.vocab_size)
    want, _, jaux = jdecoder.forward(params["text"], jcfg.text, jnp.asarray(b["tokens"]),
                                     segment_ids=jnp.asarray(b["segment_ids"]),
                                     return_aux=True)
    with torch.no_grad():
        got, cache, taux = model.text(torch.from_numpy(b["tokens"]).long(),
                                      segment_ids=torch.from_numpy(b["segment_ids"]),
                                      return_aux=True)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for name in ("aux_loss", "z_loss", "fraction_dropped"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert (float(taux["fraction_dropped"]) > 0) == (mode == "capacity")


def _train_cfg(mod):
    return mod.TrainConfig(
        remat="full", loss_chunk=16,
        optimizer=mod.OptimizerConfig(lr=LR, warmup_steps=0, decay_steps=100, eps=1e-4,
                                      weight_decay=0.1, grad_clip=1.0))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(mode):
    """One step of make_train_step: the loss, the MoE metrics, the gradients'
    global norm and the updated params (the gradients leaf by leaf are held
    at the layer, test_moe_layer_gradients_match_jax)."""
    jcfg, tcfg, params, model = _pair(mode, seed=1)
    batch = _text_batch(jcfg.text.vocab_size, seed=1)
    jtc = _train_cfg(jcfgs)
    jstate = jtrainer.create_train_state(params, jtc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jmetrics = jax.jit(jtrainer.make_train_step(jcfg, jtc))(jstate, jbatch)

    ttc = _train_cfg(tcfgs)
    tstate = ttrainer.create_train_state(model, ttc)
    tstate, tmetrics = ttrainer.make_train_step(tcfg, ttc)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})

    for name in ("loss", "moe_aux_loss", "moe_z_loss", "moe_fraction_dropped", "grad_norm"):
        np.testing.assert_allclose(float(tmetrics[name]), float(jmetrics[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert (float(tmetrics["moe_fraction_dropped"]) > 0) == (mode == "capacity")
    jp, tp = _leaves(jax.device_get(jstate.params)), _leaves(jax_tree_from_state_dict(
        tstate.params))
    for name, want in jp.items():
        np.testing.assert_allclose(tp[name], want, rtol=0, atol=LR / 100, err_msg=name)


def test_grad_accumulation_carries_the_moe_metrics():
    """Two microbatches: the losses weighted by their tokens in the loss,
    the worst microbatch's dropped share; the JAX trainer reports neither
    there, so the reference is the port's own one-row steps."""
    _, tcfg, _, model = _pair("capacity", seed=2)
    batch = {k: torch.from_numpy(v) for k, v in _text_batch(512, seed=2).items()}
    ttc = _train_cfg(tcfgs)
    state = ttrainer.create_train_state(model, ttc)
    _, whole, _ = ttrainer.make_train_step(tcfg, ttc, grad_accum_steps=2).loss_and_grads(
        state, batch)
    rows = [ttrainer.make_train_step(tcfg, ttc).loss_and_grads(
        state, {k: v[i:i + 1] for k, v in batch.items()})[1] for i in range(2)]
    w = [float(r["tokens_in_loss"]) for r in rows]
    for name in ("moe_aux_loss", "moe_z_loss"):
        want = sum(float(r[name]) * wi for r, wi in zip(rows, w)) / sum(w)
        np.testing.assert_allclose(float(whole[name]), want, rtol=1e-6, err_msg=name)
    assert float(whole["moe_fraction_dropped"]) == max(
        float(r["moe_fraction_dropped"]) for r in rows)


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_matches_jax(mode):
    """Text prompts of 7, 19 and 30 tokens at bucket 32: the MoE layers run on
    every padded position in both engines, so the capacity path drops the
    same tokens; eos 999999 is never reached."""
    jcfg, tcfg, params, model = _pair(mode, seed=4, vocab_size=128256)
    kw = dict(seq_buckets=(32, 64), tile_buckets=(1, 2))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 128000, n).astype(np.int32) for n in (7, 19, 30)]
    gen = GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(999999,))
    want = JaxEngine(jcfg, params, **kw).generate(prompts, gen_cfg=gen)
    got = Engine(tcfg, model, **kw).generate(prompts, gen_cfg=gen)
    for jt, tt, jl, tl in zip(want.tokens, got.tokens, want.logprobs, got.logprobs):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def test_quantized_moe_engine_is_refused():
    _, tcfg, _, model = _pair("dropless")
    with pytest.raises(NotImplementedError, match="MoE"):
        Engine(tcfg, model, quantize="int8")


@pytest.mark.parametrize("mode", list(MODES))
def test_full_and_selective_give_the_same_gradients(mode):
    _, tcfg, _, model = _pair(mode, seed=5)
    batch = {k: torch.from_numpy(v) for k, v in _text_batch(512, seed=5).items()}
    grads = {}
    for remat in ("none", "full", "selective"):
        ttc = dataclasses.replace(_train_cfg(tcfgs), remat=remat)
        state = ttrainer.create_train_state(model, ttc)
        grads[remat] = ttrainer.make_train_step(tcfg, ttc).loss_and_grads(state, batch)[2]
    for remat in ("full", "selective"):
        for k, g in grads["none"].items():
            np.testing.assert_allclose(grads[remat][k].numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{remat} {k}")


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n["mm"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.n["bmm"] += 1
        return func(*args, **(kwargs or {}))


def test_selective_recomputes_the_expert_gemms_and_saves_the_router(monkeypatch):
    """One dropless MoE layer (flash tier, whose forward "selective" saves):
    its backward under "selective" runs every product that "none" runs,
    plus the three expert GEMMs of each expert with rows (recomputed, as
    JAX recomputes `ragged_dot`), and no more `aten.mm` (the router's
    product and the projections are saved)."""
    _, tcfg, _, model = _pair("dropless", seed=6, long_seq_threshold=8, attn_impl="flash")
    layer = model.text.layers[0]
    x = torch.randn(1, 8, tcfg.text.hidden_size, generator=torch.Generator().manual_seed(6))
    cos, sin = rope_cos_sin(torch.arange(8)[None],
                            torch.from_numpy(compute_inv_freq(tcfg.text)))
    kw = dict(attn_impl="flash", mask=None, segment_ids=None, ranges=None, cache=None,
              layer_idx=0, slots=None, fresh_cache=False)
    routes, real = [], tmoe.router_top_k
    monkeypatch.setattr(tmoe, "router_top_k", lambda logits, k: routes.append(
        real(logits, k)) or routes[-1])
    counts = {}
    for mode in ("none", "full", "selective"):
        xi = x.clone().requires_grad_()
        out, aux = remat_wrap(layer, mode)(xi, tcfg.text, cos, sin, **kw)
        with _CountProducts() as counter:
            (out.square().sum() + aux["aux_loss"] + aux["z_loss"]).backward()
        counts[mode] = counter.n
    active = len(torch.unique(routes[0].indices))  # the experts "none" ran
    assert counts["selective"]["mm"] == counts["none"]["mm"]
    assert counts["selective"]["bmm"] == counts["none"]["bmm"] + 3 * active
    assert counts["full"]["mm"] > counts["none"]["mm"]  # "full" recomputes the router too
