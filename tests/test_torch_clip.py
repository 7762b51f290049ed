"""The CLIP tower options of the port (models/siglip.py with
`config.clip_vit_large_336`'s fields: a class token, a pre-LN, no patch
bias, quick-GELU, no sequence post-LN, the penultimate layer's features
with the class token's row dropped) against the JAX package, HF's
CLIPVisionModel and the JAX converter.

The tower is tiny: hidden 64, 3 layers, 4 heads, 56 px images in 14 px
patches, so 16 patches and the class token, an odd sequence of 17. In fp32
on the CPU:

  - the tower against `leopard_tpu.models.siglip.forward`, with and without
    a patch mask, on the dense tier and on the flash tier's plain version
    (K1's semantics: under a patch mask a padding patch attends nothing,
    so only the real patches' rows are compared there), rtol/atol 2e-4;
  - `convert_clip_vision` against JAX's `convert_clip_vision` (equal
    tensors, fp32 and bf16), and the converted tower against transformers'
    `hidden_states[-2][:, 1:]` at 2e-4 (tests/test_hf_parity.py:380-410);
    the export against JAX's `export_siglip_vision`;
  - `state_dict_from_jax` carrying `class_embed` and `pre_ln` into a CLIP
    VLM, and the port's own init making the same tree;
  - a tiny CLIP VLM (pixel shuffle 1, 16 image tokens a tile): greedy
    `Engine.generate` tokens equal to JAX's `Engine`; one train step's
    loss (rtol 1e-5), gradients and updated params against JAX's
    `vlm_loss` and `make_train_step`, including the unrun last tower
    layer's zero gradient and the weight decay AdamW still applies to it.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.convert import hf as jhf
from leopard_tpu.models import siglip as jsiglip
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert import hf as thf
from leopard_tpu_torch.convert.from_jax import jax_tree_from_state_dict, state_dict_from_jax
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.models.siglip import SiglipVisionTower

from test_torch_serve_mesh import clip_vision, tiny_clip_vlm

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
LR = 1e-2
LAST = 2  # the tower's last layer, which feature_layer -2 does not run


def _tower(cfg, params):
    tower = SiglipVisionTower(cfg)
    tower.load_state_dict(state_dict_from_jax(params, None), strict=True)
    return tower.eval()


@pytest.fixture(scope="module")
def tower_params():
    return jax.device_get(jsiglip.init_params(clip_vision(cfgs), jax.random.PRNGKey(3)))


def _pixels(n, seed):
    return np.random.RandomState(seed).randn(n, 3, 56, 56).astype(np.float32)


def _mask():
    """Two images on the 4 × 4 grid: 3 × 4 and 2 × 3 real patches."""
    m = np.zeros((2, 4, 4), bool)
    m[0, :3, :4] = True
    m[1, :2, :3] = True
    return m


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "patch_mask"])
def test_tower_matches_jax(tower_params, impl, masked):
    pix = _pixels(2, seed=0)
    mask = _mask() if masked else None
    want = np.asarray(jsiglip.forward(tower_params, clip_vision(cfgs), jnp.asarray(pix),
                                      None if mask is None else jnp.asarray(mask)))
    tower = _tower(clip_vision(tcfgs, impl), tower_params)
    with torch.no_grad():
        got = tower(torch.from_numpy(pix), None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 16, 64) == want.shape
    got = got.numpy()
    if masked and impl == "flash":  # a padding patch attends nothing under K1's mask
        real = mask.reshape(2, 16)
        got, want = got[real], want[real]
    np.testing.assert_allclose(got, want, **TOL)


def test_class_token_positions_start_at_one(tower_params):
    """The patches take position rows 1..16 and the class token row 0: a
    tower that reads the patches' rows from 0 (the table shifted by one
    row) gives other features."""
    pix = torch.from_numpy(_pixels(1, seed=1))
    tower = _tower(clip_vision(tcfgs), tower_params)
    with torch.no_grad():
        base = tower(pix)
        tower.pos_embed[1:] = tower.pos_embed[:-1].clone()  # ids from 0: the fault
        shifted = tower(pix)
    assert not torch.allclose(base, shifted, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(5)
    hf_cfg = CLIPVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                              num_attention_heads=4, image_size=56, patch_size=14,
                              attn_implementation="eager")
    model = CLIPVisionModel(hf_cfg).eval()
    assert hf_cfg.layer_norm_eps == 1e-5 and hf_cfg.hidden_act == "quick_gelu"
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_clip_vision_matches_jax(hf_clip, dtype):
    _, sd = hf_clip
    got = thf.convert_clip_vision(sd, clip_vision(tcfgs, dtype=dtype), device="cpu")
    jparams = jhf.convert_clip_vision(sd, clip_vision(cfgs, dtype=dtype), "vision_model.")
    want = state_dict_from_jax(jax.device_get(jparams), None)
    assert set(got) == set(want)
    assert {"class_embed", "pre_ln.scale", "pre_ln.bias"} <= set(got)
    assert "patch_embed.bias" not in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype == getattr(torch, dtype), k
        assert torch.equal(got[k], v), k


def test_converted_tower_matches_hf(hf_clip):
    """The port's tower on convert_clip_vision's tensors against HF's
    penultimate hidden states without the class token."""
    model, sd = hf_clip
    tower = SiglipVisionTower(clip_vision(tcfgs))
    tower.load_state_dict(thf.convert_clip_vision(sd, clip_vision(tcfgs), device="cpu"),
                          strict=True)
    pix = _pixels(2, seed=7)
    with torch.no_grad():
        want = model(torch.from_numpy(pix), output_hidden_states=True).hidden_states[-2][:, 1:]
        got = tower.eval()(torch.from_numpy(pix))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_export_matches_jax(tower_params):
    tower = _tower(clip_vision(tcfgs), tower_params)
    got = thf.export_siglip_vision(tower, clip_vision(tcfgs))
    want = jhf.export_siglip_vision(tower_params, clip_vision(cfgs))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def vlm_params():
    return jax.device_get(jvlm.init_params(tiny_clip_vlm(cfgs), jax.random.PRNGKey(1)))


def test_state_dict_from_jax_carries_the_clip_leaves(vlm_params):
    cfg = tiny_clip_vlm(tcfgs)
    state = state_dict_from_jax(vlm_params, cfg)
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state, strict=True)
    v = vlm_params["vision"]
    np.testing.assert_array_equal(model.vision.class_embed.detach().numpy(), v["class_embed"])
    np.testing.assert_array_equal(model.vision.pre_ln.scale.detach().numpy(),
                                  v["pre_ln"]["scale"])
    np.testing.assert_array_equal(model.vision.pos_embed.detach().numpy(), v["pos_embed"])
    assert model.vision.pos_embed.shape == (17, 64)
    # the port's own init makes the same tree, leaf for leaf in shape
    own = tvlm.init_params(cfg, torch.Generator().manual_seed(0)).state_dict()
    assert {k: tuple(t.shape) for k, t in own.items()} == {
        k: tuple(t.shape) for k, t in state.items()}
    assert torch.equal(own["vision.pre_ln.scale"], torch.ones(64))
    assert 0.05 < float(own["vision.class_embed"].std()) < 0.25  # N(0, 1/64)


def _requests(cfg, seed=0):
    rng = np.random.RandomState(seed)
    t, img = cfg.anyres.tokens_per_tile, cfg.image_token_id

    def text(n):
        return list(rng.randint(1, 128000, size=n))

    prompts = [np.array(text(3) + [img] * (2 * t) + text(5), np.int32),
               np.array(text(4) + [img] * t + text(7), np.int32)]
    return prompts, rng.randint(0, 256, (3, 56, 56, 3)).astype(np.uint8)


def test_engine_generate_matches_jax(vlm_params):
    from leopard_tpu.config import GenerateConfig
    from leopard_tpu.inference.engine import Engine as JaxEngine
    from leopard_tpu_torch.inference.engine import Engine

    jcfg, tcfg = tiny_clip_vlm(cfgs), tiny_clip_vlm(tcfgs)
    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(vlm_params, tcfg), strict=True)
    kw = dict(seq_buckets=(64,), tile_buckets=(4,))
    prompts, images = _requests(jcfg)
    gen = GenerateConfig(max_new_tokens=8, eos_token_ids=(999999,))
    want = JaxEngine(jcfg, vlm_params, **kw).generate(prompts, images=images, gen_cfg=gen)
    got = Engine(tcfg, model, **kw).generate(prompts, images=images, gen_cfg=gen)
    for w, g, wl, gl in zip(want.tokens, got.tokens, want.logprobs, got.logprobs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(gl, wl, rtol=1e-4, atol=1e-4)


def _train_cfg(mod):
    return mod.TrainConfig(
        remat="none", loss_chunk=16,
        optimizer=mod.OptimizerConfig(lr=LR, warmup_steps=0, decay_steps=100, eps=1e-4,
                                      weight_decay=0.1, grad_clip=1.0))


def train_batch(cfg, seed=0):
    """Two rows of 48 tokens: samples of 26 and 22 tokens, and of 24 and 18
    and a padding tail of 6; each is BOS, one tile's 16 image tokens, then
    text, its positions restarting at 0."""
    rng = np.random.RandomState(seed)
    s, per_tile = 48, cfg.anyres.tokens_per_tile
    tokens, seg, pos = (np.zeros((2, s), np.int32) for _ in range(3))
    weights = np.zeros((2, s), np.float32)
    for r, lengths in enumerate(((26, 22), (24, 18))):
        start = 0
        for sid, n in enumerate(lengths, start=1):
            sample = rng.randint(1, 128000, size=n)
            sample[1:1 + per_tile] = cfg.image_token_id
            tokens[r, start:start + n] = sample
            seg[r, start:start + n] = sid
            pos[r, start:start + n] = np.arange(n)
            weights[r, start:start + n] = sample != cfg.image_token_id
            start += n
    images = rng.randn(4, 3, 56, 56).astype(np.float32)
    return dict(tokens=tokens, segment_ids=seg, positions=pos, loss_weights=weights,
                images=images)


@pytest.fixture(scope="module")
def train_runs(vlm_params):
    """JAX (dense tower) and the port (the tower on the flash tier's plain
    K1/K2) from the same weights and batch: the loss and grads, then one
    step's loss and params."""
    from leopard_tpu.training import trainer as jtrainer
    from leopard_tpu_torch.training import trainer as ttrainer

    jcfg, tcfg = tiny_clip_vlm(cfgs), tiny_clip_vlm(tcfgs, attn_impl="flash")
    batch = train_batch(jcfg)
    jtc = _train_cfg(cfgs)
    jstate = jtrainer.create_train_state(vlm_params, jtc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer.vlm_loss(p, jcfg, jbatch, jnp.float32, False, loss_chunk=16)[0]
    ))(jstate.params)
    jstate, metrics = jax.jit(jtrainer.make_train_step(jcfg, jtc))(jstate, jbatch)
    j = {"loss0": float(loss), "grads": jax.device_get(grads),
         "loss": float(metrics["loss"]), "params": jax.device_get(jstate.params)}

    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(vlm_params, tcfg), strict=True)
    tstate = ttrainer.create_train_state(model, _train_cfg(tcfgs))
    tstep = ttrainer.make_train_step(tcfg, _train_cfg(tcfgs))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = tstep.loss_and_grads(tstate, tbatch)
    t = {"loss0": float(loss), "grads": grads}
    tstate, metrics = tstep(tstate, tbatch)
    t.update(loss=float(metrics["loss"]), params=jax_tree_from_state_dict(tstate.params))
    return j, t


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_step_loss_and_grads_match_jax(train_runs):
    j, t = train_runs
    np.testing.assert_allclose([t["loss0"], t["loss"]], [j["loss0"], j["loss"]], rtol=1e-5)
    jg, tg = _leaves(j["grads"]), _leaves(jax_tree_from_state_dict(t["grads"]))
    assert set(jg) == set(tg)
    scale = max(float(np.abs(g).max()) for g in jg.values())
    for name, want in jg.items():
        np.testing.assert_allclose(tg[name], want, rtol=2e-4, atol=2e-5 * scale, err_msg=name)
    # the class token and the pre-LN are on the gradient's path
    for name in ("vision.class_embed", "vision.pre_ln.scale", "vision.layers.1.attn.wq"):
        assert float(t["grads"][name].abs().max()) > 1e-3 * scale, name


def test_unrun_last_layer_has_zero_grad_and_is_decayed(train_runs, vlm_params):
    """feature_layer -2 never runs layer 2: its gradient is exactly 0 on
    both sides, and AdamW's decoupled decay still moves its matrices, by
    -lr·wd·w, as JAX's step does."""
    j, t = train_runs
    last = {k: g for k, g in t["grads"].items() if k.startswith(f"vision.layers.{LAST}.")}
    assert len(last) == 16 and all(not g.any() for g in last.values())
    for leaf, g in jax.tree_util.tree_leaves_with_path(j["grads"]["vision"]["layers"]):
        assert not np.asarray(g)[LAST].any(), jax.tree_util.keystr(leaf)
    before = vlm_params["vision"]["layers"]["mlp"]["fc1"][LAST]
    want = j["params"]["vision"]["layers"]["mlp"]["fc1"][LAST]
    got = t["params"]["vision"]["layers"]["mlp"]["fc1"][LAST]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got - before, -LR * 0.1 * before, rtol=0, atol=1e-7)
    assert np.abs(got - before).max() > 1e-5


def test_train_step_params_match_jax(train_runs):
    j, t = train_runs
    jp, tp = _leaves(j["params"]), _leaves(t["params"])
    assert set(jp) == set(tp)
    for name, want in jp.items():
        np.testing.assert_allclose(tp[name], want, rtol=0, atol=LR / 100, err_msg=name)
