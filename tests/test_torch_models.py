"""Parity of the port's models with the JAX package's, with the JAX weights
moved by `convert.from_jax.state_dict_from_jax`.

Two configs: `tiny_vlm`, and a narrow one with the real head dims (vision
head dim 72 on a 26×26 patch grid, text head dim 128 with llama3.1 rope),
because toy dims hide dim-dependent bugs. Both run in float32 on the CPU;
outputs are compared at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.models import decoder as jdecoder
from leopard_tpu.models import projector as jprojector
from leopard_tpu.models import siglip as jsiglip
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.models.decoder import KVCache

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def narrow_real_dims_cfg(vocab_size: int = 1024) -> cfgs.VLMConfig:
    vision = cfgs.VisionConfig(hidden_size=144, intermediate_size=256, num_layers=2,
                               num_heads=2, dtype="float32")
    text = cfgs.TextConfig(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                           num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
                           dtype="float32")
    return cfgs.VLMConfig(
        vision=vision, text=text,
        projector=cfgs.ProjectorConfig(input_size=144 * 4, hidden_size=256, dtype="float32"),
        image_token_id=vocab_size - 1,
    )


CONFIGS = {"tiny": cfgs.tiny_vlm, "narrow_real_dims": narrow_real_dims_cfg}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(cfg, JAX params, port model holding the same weights)."""
    cfg = CONFIGS[request.param]()
    params = jax.device_get(jvlm.init_params(cfg, jax.random.PRNGKey(0)))
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return cfg, params, model.eval()


def _np(x):
    return np.asarray(x)


def _pixels(cfg, n, seed):
    s = cfg.vision.image_size
    return np.random.RandomState(seed).randn(n, 3, s, s).astype(np.float32)


def _tokens(cfg, lengths, n_image_tokens, seed):
    """Right-padded rows; row r's first n_image_tokens[r] tokens after the
    first are image tokens."""
    rng = np.random.RandomState(seed)
    s = max(lengths)
    tokens = np.zeros((len(lengths), s), np.int32)
    seg = np.zeros_like(tokens)
    for r, (n, n_img) in enumerate(zip(lengths, n_image_tokens)):
        tokens[r, :n] = rng.randint(1, cfg.image_token_id, size=n)
        tokens[r, 1:1 + n_img] = cfg.image_token_id
        seg[r, :n] = 1
    return tokens, seg


def test_state_dict_names_follow_the_jax_tree(pair):
    cfg, _, model = pair
    keys = set(model.state_dict())
    assert {"vision.layers.1.attn.wq", "vision.post_ln.scale", "projector.fc1",
            "text.layers.1.mlp.w_gate", "text.layers.0.input_norm",
            "text.lm_head", "text.embed_tokens"} <= keys
    assert model.text.layers[0].attn.wq.shape == (
        cfg.text.num_heads * cfg.text.head_dim, cfg.text.hidden_size)


def test_siglip_features(pair):
    cfg, params, model = pair
    pix = _pixels(cfg, 2, seed=0)
    want = jsiglip.forward(params["vision"], cfg.vision, jnp.asarray(pix))
    with torch.no_grad():
        got = model.vision(torch.from_numpy(pix))
    assert got.shape == (2, cfg.vision.tokens_per_tile, cfg.vision.hidden_size)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_projector(pair):
    cfg, params, model = pair
    x = np.random.RandomState(1).randn(3, 5, cfg.projector.input_size).astype(np.float32)
    want = jprojector.forward(params["projector"], jnp.asarray(x))
    with torch.no_grad():
        got = model.projector(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_encode_images_uint8(pair):
    cfg, params, model = pair
    s = cfg.vision.image_size
    imgs = np.random.RandomState(2).randint(0, 256, (2, s, s, 3)).astype(np.uint8)
    want = jvlm.encode_images(params, cfg, jnp.asarray(imgs))
    with torch.no_grad():
        got = model.encode_images(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_decoder_prefill_logits(pair):
    cfg, params, model = pair
    tokens, seg = _tokens(cfg, [12, 7], [0, 0], seed=3)
    want, _ = jdecoder.forward(params["text"], cfg.text, jnp.asarray(tokens),
                               segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        got, _ = model.text(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg))
    valid = seg != 0
    np.testing.assert_allclose(got.numpy()[valid], _np(want)[valid], **TOL)


def test_decoder_fresh_cache_then_decode_step(pair):
    """Prefill into a fresh cache, then one cached decode step: logits and
    the written cache match the JAX decoder's."""
    cfg, params, model = pair
    tokens, seg = _tokens(cfg, [9, 5], [0, 0], seed=4)
    step = np.array([[3], [4]], np.int32)
    jcache = jdecoder.KVCache.create(cfg.text, 2, 16)
    _, jcache = jdecoder.forward(params["text"], cfg.text, jnp.asarray(tokens),
                                 segment_ids=jnp.asarray(seg), cache=jcache, fresh_cache=True)
    jlog, jcache = jdecoder.forward(params["text"], cfg.text, jnp.asarray(step), cache=jcache)
    with torch.no_grad():
        tcache = KVCache.create(cfg.text, 2, 16)
        model.text(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg),
                   cache=tcache, fresh_cache=True)
        tlog, tcache = model.text(torch.from_numpy(step), cache=tcache)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
    np.testing.assert_array_equal(tcache.index.numpy(), _np(jcache.index))
    np.testing.assert_array_equal(tcache.seg.numpy(), _np(jcache.seg))
    valid = _np(jcache.seg) != 0
    np.testing.assert_allclose(tcache.kv.numpy()[:, valid], _np(jcache.kv)[:, valid], **TOL)


def test_vlm_forward_last_position_logits(pair):
    cfg, params, model = pair
    t = cfg.anyres.tokens_per_tile if cfg.vision.image_size == 56 else 169
    n_tiles = 3
    tokens, seg = _tokens(cfg, [2 * t + 6, t + 4], [2 * t, t], seed=5)
    pix = _pixels(cfg, n_tiles, seed=6)
    last = seg.sum(1) - 1
    want, _ = jvlm.forward(params, cfg, jnp.asarray(tokens), images=jnp.asarray(pix),
                           segment_ids=jnp.asarray(seg), logits_indices=jnp.asarray(last))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens), images=torch.from_numpy(pix),
                       segment_ids=torch.from_numpy(seg),
                       logits_indices=torch.from_numpy(last))
    assert got.shape == (2, 1, cfg.text.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("with_offsets", [False, True], ids=["flat", "row_offsets"])
def test_splice_image_features(with_offsets):
    from leopard_tpu_torch.models.vlm import splice_image_features

    rng = np.random.RandomState(7)
    emb = rng.randn(2, 10, 4).astype(np.float32)
    feats = rng.randn(3, 2, 4).astype(np.float32)
    is_img = np.zeros((2, 10), bool)
    is_img[0, 2:5] = True
    is_img[1, 0:3] = True
    offs = np.array([1, 4], np.int32) if with_offsets else None
    want = jvlm.splice_image_features(
        jnp.asarray(emb), jnp.asarray(feats), jnp.asarray(is_img),
        row_offsets=None if offs is None else jnp.asarray(offs))
    got = splice_image_features(
        torch.from_numpy(emb), torch.from_numpy(feats), torch.from_numpy(is_img),
        row_offsets=None if offs is None else torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_init_params_is_seeded():
    cfg = dataclasses.replace(cfgs.tiny_vlm(), text=dataclasses.replace(
        cfgs.tiny_vlm().text, num_layers=1))
    a = tvlm.init_params(cfg, torch.Generator().manual_seed(3)).state_dict()
    b = tvlm.init_params(cfg, torch.Generator().manual_seed(3)).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert torch.all(a["text.layers.0.input_norm"] == 1)
    assert torch.all(a["vision.layers.0.attn.bq"] == 0)
    std = a["text.layers.0.attn.wq"].std().item()
    assert abs(std - cfg.text.hidden_size ** -0.5) < 0.03
