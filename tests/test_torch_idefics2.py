"""Leopard-Idefics2 serving in the port against the JAX package, on a tiny
Idefics2 VLM whose Mistral window (16) is smaller than its prompts (~45
tokens), so that the window bites in every tier:

  - `LeopardVLM.forward` logits (valid positions, 1e-4), and a no-window
    twin that differs past the window;
  - `Engine.generate` with `patch_mask`, token for token (logprobs 1e-4),
    with images of mixed grids and one all-zero image from the tile bucket,
    at the dense and at the flash prefill tier;
  - `build_prefix(patch_mask=)` and a suffix through the continuation tier,
    `beam_search(patch_mask=)`, `ContinuousEngine` with an Idefics2 request,
    and the server's `_prepare_row` (ids, pixels byte for byte, mask) and
    `handle_generate`;
  - each window tier of the decoder (fresh prefill through the flash tier,
    cached decode, the chunked continuation) against JAX's decoder at 1e-4;
  - the `from_jax` bridge both ways (JAX's unused `projector` is dropped).

The weights are the JAX init moved by `state_dict_from_jax`, float32 on the
CPU; the perceiver's latents (ones at init) are redrawn so that they differ.
`tiny_idefics2` and `CharTokenizer` serve the other Idefics2 test files.

NaViT position ids: where a fraction row / real_rows lands exactly on a
boundary j / patches_per_side (row 3 of 6, 35 of 70), JAX's
`navit_position_ids` gives the searchsorted bucket eagerly, but under
`jax.jit` on the CPU the division is compiled otherwise and some rows fall
one bucket short (5 of 6 → 4). The port computes the eager rule. So that the
jitted JAX engines here serve as the reference, their tower takes
`exact_position_ids`, the same rule in integer arithmetic, which
tests/test_torch_navit.py holds equal to the eager JAX function on every
grid up to 70 × 70.
"""

import base64
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from leopard_tpu import config as cfgs
from leopard_tpu.config import GenerateConfig
from leopard_tpu.inference import beam as jbeam
from leopard_tpu.inference import continuous as jcont
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.inference.server import GenerationServer as JaxGenerationServer
from leopard_tpu.models import decoder as jdecoder
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert.from_jax import jax_tree_from_state_dict, state_dict_from_jax
from leopard_tpu_torch.inference import beam as tbeam
from leopard_tpu_torch.inference import continuous as tcont
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.inference.server import GenerationServer
from leopard_tpu_torch.models import decoder as tdecoder
from leopard_tpu_torch.models import vlm as tvlm

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 16
IMG, FAKE = 32001, 32000
GEN = GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(999999,))
BUCKETS = dict(seq_buckets=(32, 64), tile_buckets=(1, 2, 4))


def tiny_idefics2(mod, window=WINDOW, **text_kw):
    """Leopard-Idefics2's topology at toy widths, in the config module `mod`
    (the JAX package's or the port's): a 2-layer NaViT tower at head dim 72
    on a 6 × 6 patch grid (84 px), a 2-layer perceiver of 4 latents, and a
    2-layer Mistral with vocab 32,003, no RoPE scaling and the window."""
    vision = mod.VisionConfig(hidden_size=144, intermediate_size=256, num_layers=2, num_heads=2,
                              image_size=84, patch_size=14, layer_norm_eps=1e-6,
                              dtype="float32")
    text = mod.TextConfig(vocab_size=32003, hidden_size=64, intermediate_size=128, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                          rope_scaling=None, sliding_window=window,
                          max_position_embeddings=32768, dtype="float32", **text_kw)
    perceiver = mod.PerceiverConfig(num_latents=4, num_layers=2, hidden_size=64, num_heads=4,
                                    num_kv_heads=2, head_dim=16, intermediate_size=96,
                                    rms_norm_eps=1e-6, dtype="float32")
    return mod.VLMConfig(
        vision=vision, text=text, perceiver=perceiver,
        projector=mod.ProjectorConfig(projector_type="none", input_size=64, hidden_size=64,
                                      dtype="float32"),
        anyres=mod.AnyResConfig(tile_size=84, tile_budget=0, tokens_per_tile=4),
        image_token_id=IMG, pixel_shuffle_factor=1, architecture="leopard_idefics2")


def init_params(cfg, seed=0):
    """JAX params of `cfg` (numpy), the latents redrawn (ones at init)."""
    params = jax.device_get(jvlm.init_params(cfg, jax.random.PRNGKey(seed)))
    lat = params["perceiver"]["latents"]
    params["perceiver"]["latents"] = np.random.RandomState(seed).randn(*lat.shape).astype(
        lat.dtype)
    return params


def port_model(params, cfg):
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return model.eval()


class CharTokenizer:
    """One id per character, all inside Mistral's 32,003; BOS 1."""

    bos_token_id = 1
    eos_token_id = 2

    def __call__(self, text, add_special_tokens=False):
        ids = [ord(c) % 500 + 3 for c in text]
        return {"input_ids": ([1] if add_special_tokens else []) + ids}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def navit_images(grids, seed, size=6):
    """Normalized float32 pixels [N, 3, 14·size, 14·size] and patch masks
    [N, size, size] for images of (rows, cols) real patches, zero outside."""
    rng = np.random.RandomState(seed)
    n = len(grids)
    pixels = np.zeros((n, 3, 14 * size, 14 * size), np.float32)
    mask = np.zeros((n, size, size), bool)
    for i, (r, c) in enumerate(grids):
        pixels[i, :, : 14 * r, : 14 * c] = rng.randn(3, 14 * r, 14 * c)
        mask[i, :r, :c] = True
    return pixels, mask


def idefics2_prompt(n_images, n_text, rng, latents=4, n_before=0):
    """BOS, `n_before` text tokens, the image blocks (shared fake-image
    boundaries), then `n_text` text tokens."""
    ids = [1] + list(rng.randint(3, 31999, size=n_before))
    for _ in range(n_images):
        if ids[-1] != FAKE:
            ids.append(FAKE)
        ids += [IMG] * latents + [FAKE]
    ids += list(rng.randint(3, 31999, size=n_text))
    return np.asarray(ids, np.int32)


def exact_position_ids(patch_mask, patches_per_side):
    """JAX's `navit_position_ids` in integer arithmetic: row i of an image of
    n_h real rows takes bucket i·n // n_h (columns alike), which is the
    number of boundaries j / n <= i / n_h; padding takes 0."""
    b, nph, npw = patch_mask.shape
    n = patches_per_side

    def buckets(count, length):
        return jnp.arange(length)[None, :] * n // jnp.maximum(count, 1)[:, None]

    bh = buckets(jnp.sum(patch_mask[:, :, 0], axis=1), nph)
    bw = buckets(jnp.sum(patch_mask[:, 0, :], axis=1), npw)
    ids = bh[:, :, None] * n + bw[:, None, :]
    return jnp.where(patch_mask, ids, 0).astype(jnp.int32).reshape(b, nph * npw)


@pytest.fixture(scope="module", autouse=True)
def eager_rule_in_jax():
    """The jitted JAX tower takes the eager position-id rule (see above)."""
    from leopard_tpu.models import siglip as jsiglip

    real = jsiglip.navit_position_ids
    jsiglip.navit_position_ids = exact_position_ids
    yield
    jsiglip.navit_position_ids = real


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_idefics2(cfgs)
    params = init_params(cfg)
    return cfg, params, port_model(params, cfg)


def _requests(seed=0):
    """Two image rows (2 images of mixed grids, 1 narrow image) and a text
    row: 3 images, so the tile bucket adds an all-zero one. The images sit
    near each prompt's end, within the two layers' reach of the window."""
    rng = np.random.RandomState(seed)
    prompts = [idefics2_prompt(2, 6, rng, n_before=24), idefics2_prompt(1, 8, rng, n_before=30),
               np.concatenate([[1], rng.randint(3, 31999, size=41)]).astype(np.int32)]
    pixels, mask = navit_images([(6, 6), (3, 6), (5, 2)], seed)
    return prompts, pixels, mask


def _assert_same(jres, tres):
    for jt, tt, jl, tl in zip(jres.tokens, tres.tokens, jres.logprobs, tres.logprobs):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, **TOL)


def test_vlm_forward_matches_jax_and_the_window_bites(pair):
    cfg, params, model = pair
    prompts, pixels, mask = _requests()
    tokens = prompts[0][None]
    want, _ = jvlm.forward(params, cfg, jnp.asarray(tokens), images=jnp.asarray(pixels[:2]),
                           patch_mask=jnp.asarray(mask[:2]))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens), images=torch.from_numpy(pixels[:2]),
                       patch_mask=torch.from_numpy(mask[:2]))
        no_window = tvlm.LeopardVLM(dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, sliding_window=None)), device="meta")
        no_window.load_state_dict(model.state_dict(), assign=True)
        unwindowed, _ = no_window(torch.from_numpy(tokens), images=torch.from_numpy(pixels[:2]),
                                  patch_mask=torch.from_numpy(mask[:2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0, :WINDOW].numpy(), unwindowed[0, :WINDOW].numpy(), **TOL)
    assert (got[0, WINDOW:] - unwindowed[0, WINDOW:]).abs().max() > 1e-2


@pytest.mark.parametrize("threshold", [2048, 32], ids=["dense_prefill", "flash_prefill"])
def test_generate_with_patch_mask_matches_jax(pair, monkeypatch, threshold):
    """Bucket 64: at threshold 32 the port's fresh prefill takes the flash
    tier (its plain version on the CPU), the JAX engine its chunked tier."""
    cfg, params, model = pair
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                            long_seq_threshold=threshold))
    tmodel = tvlm.LeopardVLM(cfg, device="meta")
    tmodel.load_state_dict(model.state_dict(), assign=True)
    calls = []
    real = tdecoder.flash_attention
    monkeypatch.setattr(tdecoder, "flash_attention",
                        lambda *a, **kw: calls.append(kw["sliding_window"]) or real(*a, **kw))
    prompts, pixels, mask = _requests(seed=1)
    jeng, teng = JaxEngine(cfg, params, **BUCKETS), Engine(cfg, tmodel, **BUCKETS)
    _assert_same(jeng.generate(prompts, images=pixels, patch_mask=mask, gen_cfg=GEN),
                 teng.generate(prompts, images=pixels, patch_mask=mask, gen_cfg=GEN))
    assert calls == ([WINDOW] * cfg.text.num_layers if threshold == 32 else [])
    # the patch mask matters: without it the image rows answer otherwise
    plain = teng.generate(prompts[:2], images=pixels, gen_cfg=GEN)
    masked = teng.generate(prompts[:2], images=pixels, patch_mask=mask, gen_cfg=GEN)
    assert any(not np.array_equal(a, b) for a, b in zip(plain.logprobs, masked.logprobs))


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_generate_matches_jax(pair, quantize):
    """int8 and int4 weights against the JAX engine's CPU path (its dense
    dequant for int4). Quantized, the 32,003-wide head is padded to 32,128
    columns in the port (K4's whole tiles) and its logits sliced back."""
    cfg, params, model = pair
    prompts, pixels, mask = _requests(seed=3)
    jeng = JaxEngine(cfg, params, quantize=quantize, **BUCKETS)
    teng = Engine(cfg, model, quantize=quantize, **BUCKETS)
    head = teng.model.text.lm_head
    assert head.n == cfg.text.vocab_size
    assert head.s.shape[-1] == (32128 if quantize == "int4" else cfg.text.vocab_size)
    _assert_same(jeng.generate(prompts, images=pixels, patch_mask=mask, gen_cfg=GEN),
                 teng.generate(prompts, images=pixels, patch_mask=mask, gen_cfg=GEN))


def test_encode_images_pads_the_bucket_with_masked_images(pair):
    cfg, params, model = pair
    _, pixels, mask = _requests(seed=2)
    jfeats = JaxEngine(cfg, params, **BUCKETS).encode_images(pixels, mask)
    tfeats = Engine(cfg, model, **BUCKETS).encode_images(pixels, mask)
    assert tfeats.shape == (4, 4, 64) and torch.isfinite(tfeats).all()
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats), **TOL)


def test_prefix_with_images_then_a_continuation_matches_jax(pair):
    """The prefix holds two images (patch masks); the suffix of 20 tokens
    crosses long_seq_threshold 16, so it takes the chunked continuation
    tier with the window, against JAX's and against the port on the
    concatenated prompt."""
    cfg, params, model = pair
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, long_seq_threshold=16, attn_chunk_size=128))
    tmodel = tvlm.LeopardVLM(cfg, device="meta")
    tmodel.load_state_dict(model.state_dict(), assign=True)
    rng = np.random.RandomState(3)
    pre_ids = idefics2_prompt(2, 3, rng, n_before=20)
    pixels, mask = navit_images([(4, 6), (6, 3)], seed=3)
    sfx = [rng.randint(3, 31999, 20).astype(np.int32), rng.randint(3, 31999, 24).astype(np.int32)]
    jeng, teng = JaxEngine(cfg, params, **BUCKETS), Engine(cfg, tmodel, **BUCKETS)
    jpre = jeng.build_prefix(pre_ids, images=pixels, patch_mask=mask)
    tpre = teng.build_prefix(pre_ids, images=pixels, patch_mask=mask)
    got = teng.generate(sfx, gen_cfg=GEN, prefix=tpre)
    _assert_same(jeng.generate(sfx, gen_cfg=GEN, prefix=jpre), got)
    whole = teng.generate([np.concatenate([pre_ids, s]) for s in sfx], images=np.concatenate(
        [pixels, pixels]), patch_mask=np.concatenate([mask, mask]), gen_cfg=GEN)
    for a, b in zip(got.tokens, whole.tokens):
        np.testing.assert_array_equal(a, b)


def test_beam_search_with_patch_mask_matches_jax(pair):
    cfg, params, model = pair
    prompts, pixels, mask = _requests(seed=4)
    kw = dict(beam_width=3, max_new_tokens=5, eos_ids=(999999,))
    want = jbeam.beam_search(JaxEngine(cfg, params, **BUCKETS), prompts[0], pixels[:2], mask[:2],
                             **kw)
    got = tbeam.beam_search(Engine(cfg, model, **BUCKETS), prompts[0], pixels[:2], mask[:2], **kw)
    np.testing.assert_array_equal(got, want)


def test_continuous_engine_serves_an_idefics2_request_as_jax(pair):
    cfg, params, model = pair
    prompts, pixels, mask = _requests(seed=5)
    budgets = (5, 3, 6)
    images = [(pixels[:2], mask[:2]), (pixels[2:], mask[2:]), (None, None)]
    cont = dict(slots=2, cache_len=512, max_new_cap=8, segment_steps=2)
    treqs = [tcont.Request(prompt=p, max_new_tokens=n, images=px, patch_mask=m)
             for p, n, (px, m) in zip(prompts, budgets, images)]
    jreqs = [jcont.Request(prompt=p, max_new_tokens=n, images=px, patch_mask=m)
             for p, n, (px, m) in zip(prompts, budgets, images)]
    teng = Engine(cfg, model, **BUCKETS)
    got = tcont.ContinuousEngine(teng, **cont).run(treqs, gen_cfg=GEN)
    want = jcont.ContinuousEngine(JaxEngine(cfg, params, **BUCKETS), **cont).run(
        jreqs, gen_cfg=GEN)
    for g, w, r in zip(got, want, treqs):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        serial = teng.generate([r.prompt], images=r.images, patch_mask=r.patch_mask,
                               gen_cfg=dataclasses.replace(GEN, max_new_tokens=r.max_new_tokens))
        np.testing.assert_array_equal(g.tokens, serial.tokens[0])


def _png(w, h, seed):
    buf = io.BytesIO()
    px = np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(px).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_server_idefics2_branch_matches_jax(pair):
    """`_prepare_row` resizes to at most 980 px as the published processor
    does, so the tiny tower's 6 × 6 table is indexed by buckets of a far
    larger grid; ids, pixels and masks must equal JAX's all the same."""
    cfg, params, model = pair
    tok = CharTokenizer()
    jsrv = JaxGenerationServer(JaxEngine(cfg, params), tok)
    tsrv = GenerationServer(Engine(cfg, model), tok)
    from leopard_tpu_torch.inference.server import _decode_images

    pngs = [_png(150, 60, 0), _png(40, 130, 1)]
    text = "<image> and <image>: which is wider?"
    ids, px, mask = tsrv._prepare_row(text, _decode_images(pngs))
    jids, jpx, jmask = jsrv._prepare_row(text, _decode_images(pngs))
    np.testing.assert_array_equal(ids, jids)
    assert px.dtype == jpx.dtype == np.float32 and px.tobytes() == jpx.tobytes()
    np.testing.assert_array_equal(mask, jmask)
    assert (ids == IMG).sum() == 2 * cfg.perceiver.num_latents and "<" not in tok.decode(ids)
    payload = {"prompts": [text, "just text"], "images": [pngs, []], "max_new_tokens": 4,
               "greedy": True, "eos_token_ids": [999999]}
    got, want = tsrv.handle_generate(payload), jsrv.handle_generate(payload)
    assert got["tokens"] == want["tokens"] and all(len(t) == 4 for t in got["tokens"])
    for g, w in zip(got["logprobs"], want["logprobs"]):
        np.testing.assert_allclose(g, w, **TOL)


def _decoders(params, cfg):
    """JAX text params and config, and port decoders with and without the
    window on the same weights."""
    model = port_model(params, cfg)
    no_window = tdecoder.Decoder(dataclasses.replace(cfg.text, sliding_window=None),
                                 device="meta")
    no_window.load_state_dict(model.text.state_dict(), assign=True)
    return params["text"], cfg.text, model.text, no_window


@pytest.mark.parametrize("tier", ["fresh_flash", "cached_decode", "continuation"])
def test_window_bites_in_every_tier(pair, monkeypatch, tier):
    """The same text through JAX's decoder and the port's, at the tier
    named; the port's no-window twin must differ, so the window applies."""
    cfg, params, _ = pair
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, long_seq_threshold=16, attn_chunk_size=32))
    jtext, jcfg, dec, no_window = _decoders(params, cfg)
    seen = []
    for name in ("flash_attention", "chunked_continuation_attention"):
        real = getattr(tdecoder, name)
        monkeypatch.setattr(tdecoder, name,
                            lambda *a, _n=name, _r=real, **kw: seen.append(_n) or _r(*a, **kw))
    rng = np.random.RandomState(6)
    first = rng.randint(3, 31999, (2, 64 if tier == "fresh_flash" else 40)).astype(np.int32)
    later = rng.randint(3, 31999, (2, 1 if tier == "cached_decode" else 24)).astype(np.int32)

    def port(decoder):
        if tier == "fresh_flash":
            return decoder(torch.from_numpy(first))[0]
        cache = tdecoder.KVCache.create(cfg.text, 2, 128)
        decoder(torch.from_numpy(first), cache=cache, fresh_cache=True)
        seen.clear()  # the tier of the calls into the filled cache
        out = None
        for t in range(0, later.shape[1], 1 if tier == "cached_decode" else later.shape[1]):
            out, cache = decoder(torch.from_numpy(later[:, t:t + 24]), cache=cache)
        return out

    if tier == "fresh_flash":
        want, _ = jdecoder.forward(jtext, jcfg, jnp.asarray(first))
    else:
        cache = jdecoder.KVCache.create(jcfg, 2, 128)
        _, cache = jdecoder.forward(jtext, jcfg, jnp.asarray(first), cache=cache,
                                    fresh_cache=True)
        want, _ = jdecoder.forward(jtext, jcfg, jnp.asarray(later), cache=cache)
    with torch.no_grad():
        got = port(dec)
        seen_windowed = list(seen)
        other = port(no_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got - other).abs().max() > 1e-2
    expect = {"fresh_flash": "flash_attention", "continuation": "chunked_continuation_attention",
              "cached_decode": None}[tier]
    assert seen_windowed == ([expect] * cfg.text.num_layers if expect else [])


def test_from_jax_bridge_both_ways(pair):
    """The JAX tree's perceiver crosses leaf for leaf; its projector, which
    the JAX forward never reads, is dropped."""
    cfg, params, model = pair
    state = state_dict_from_jax(params, cfg)
    assert not any(k.startswith("projector.") for k in state)
    assert "projector" in params and not hasattr(model, "projector")
    n_perceiver = sum(k.startswith("perceiver.") for k in state)
    assert n_perceiver == 5 + 10 * cfg.perceiver.num_layers
    back = jax_tree_from_state_dict(model.state_dict())
    assert set(back) == {"vision", "perceiver", "text"}
    want = {k: v for k, v in params.items() if k != "projector"}
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)


def test_leopard_idefics2_8b_builds():
    """The full configuration builds (on the meta device): the tower, the
    perceiver and Mistral-7B with its window, no projector."""
    cfg = tcfgs.leopard_idefics2_8b()
    model = tvlm.LeopardVLM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    per = {name: sum(p.numel() for p in getattr(model, name).parameters())
           for name in ("vision", "perceiver", "text")}
    assert n == sum(per.values()) and 8.2e9 < n < 8.5e9
    assert model.text.cfg.sliding_window == 4096 and model.text.cfg.vocab_size == 32003
    assert model.vision.pos_embed.shape == (70 * 70, 1152)
    assert model.perceiver.latents.shape == (64, 4096)
