"""The port's HF converter (leopard_tpu_torch/convert/hf.py) against the JAX
package's (leopard_tpu/convert/hf.py) and against HF's own modules.

  - convert: the JAX export of random JAX params is an HF state dict; the
    port's conversion of it must equal `state_dict_from_jax` of the JAX
    conversion exactly, in fp32 and in bf16 (where fp32 → bf16 rounds once
    on both sides);
  - export: the port's export equals the JAX export key for key and value
    for value (exactly, after `.float()`), and its tensors are the
    model's own storage;
  - tiny HF LlamaForCausalLM (llama3 RoPE scaling) and SiglipVisionModel
    through the port's converter and forward, against HF at 3e-4 in fp32,
    the tolerance of tests/test_hf_parity.py;
  - the patch-kernel flatten order against HF's conv on a weight whose
    channel and spatial axes all differ; the lm_head candidates; the three
    on-disk layouts of `load_hf_state_dict` (the CLIP converter is held in
    tests/test_torch_clip.py);
  - Idefics2: the connector and the whole Idefics2ForConditionalGeneration
    layout both ways against the JAX converter and export (the head as HF
    keeps it, `lm_head.weight`, where the JAX export writes
    `model.text_lm_head.weight`), `load_leopard_idefics2` from shards, a
    tiny HF MistralForCausalLM whose window (6) bites over 16 tokens, and
    HF's Idefics2VisionTransformer with a patch mask on grids where its
    position-id rule and the reference's agree (HF's rule scales each
    fraction by 1 - 1e-6, so at an exact boundary, row 3 of 6, it takes the
    bucket below; tests/test_torch_navit.py holds the port to the
    reference's rule there).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.convert import hf as jhf
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert import hf as thf
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.models.decoder import Decoder
from leopard_tpu_torch.models.params import torch_dtype
from leopard_tpu_torch.models.siglip import SiglipVisionTower, patchify
from tests.test_torch_idefics2 import init_params as idefics2_params
from tests.test_torch_idefics2 import navit_images, tiny_idefics2

torch.set_num_threads(2)


def _with_dtype(mod, dtype):
    cfg = mod.tiny_vlm()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, dtype=dtype),
        text=dataclasses.replace(cfg.text, dtype=dtype),
        projector=dataclasses.replace(cfg.projector, dtype=dtype))


@pytest.fixture(scope="module")
def jax_params():
    """fp32 JAX params of tiny_vlm and their JAX export (fp32 numpy)."""
    cfg = cfgs.tiny_vlm()
    params = jax.device_get(jvlm.init_params(cfg, jax.random.PRNGKey(0)))
    return params, jhf.export_leopard_llava(params, cfg)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_equals_jax(jax_params, dtype):
    _, sd = jax_params
    jcfg, tcfg = _with_dtype(cfgs, dtype), _with_dtype(tcfgs, dtype)
    want = state_dict_from_jax(jax.device_get(jhf.convert_leopard_llava(sd, jcfg)), tcfg)
    got = thf.convert_leopard_llava(sd, tcfg, device="cpu")
    _assert_same(got, want)
    model = tvlm.LeopardVLM(tcfg, device="meta")
    model.load_state_dict(got, strict=True, assign=True)


def test_convert_from_bf16_tensors_equals_jax(jax_params):
    """A checkpoint stored in bf16 (as the published one is), converted to
    fp32 and to bf16."""
    _, sd = jax_params
    sd16 = {k: torch.from_numpy(np.array(v, order="C")).to(torch.bfloat16) for k, v in sd.items()}
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _with_dtype(cfgs, dtype), _with_dtype(tcfgs, dtype)
        want = state_dict_from_jax(jax.device_get(jhf.convert_leopard_llava(sd16, jcfg)), tcfg)
        _assert_same(thf.convert_leopard_llava(sd16, tcfg, device="cpu"), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_equals_jax(jax_params, dtype):
    params, _ = jax_params
    jcfg, tcfg = _with_dtype(cfgs, dtype), _with_dtype(tcfgs, dtype)
    jparams = jax.tree_util.tree_map(lambda a: np.asarray(a, jcfg.text.dtype), params)
    want = jhf.export_leopard_llava(jparams, jcfg)
    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(jparams, tcfg), strict=True)
    got = thf.export_leopard_llava(model, tcfg)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch_dtype(dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(), w, err_msg=k)
    # no copies: every exported tensor lies in a parameter's storage
    storages = {p.untyped_storage().data_ptr() for p in model.parameters()}
    assert all(t.untyped_storage().data_ptr() in storages for t in got.values())
    # and the export converts back to the same state dict
    back = thf.convert_leopard_llava(got, tcfg, device="cpu")
    _assert_same(back, {k: v.detach() for k, v in model.state_dict().items()})


def test_export_vlm_dispatch(jax_params):
    params, _ = jax_params
    tcfg = tcfgs.tiny_vlm()
    state = state_dict_from_jax(params, tcfg)
    assert thf.export_vlm(state, tcfg).keys() == thf.export_leopard_llava(state, tcfg).keys()
    icfg = tiny_idefics2(tcfgs)
    istate = state_dict_from_jax(idefics2_params(tiny_idefics2(cfgs)), icfg)
    got = thf.export_vlm(istate, icfg)
    assert got.keys() == thf.export_leopard_idefics2(istate, icfg).keys()
    assert "lm_head.weight" in got and not any(k.startswith("multi_modal") for k in got)


def test_llama_logits_match_hf_llama3_rope():
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(1)
    hf_cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        attention_bias=False, tie_word_embeddings=False, attn_implementation="eager")
    hf = LlamaForCausalLM(hf_cfg).eval()
    cfg = tcfgs.TextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=16, rope_theta=500000.0, rope_scaling="llama3.1",
        rms_norm_eps=1e-5, dtype="float32")
    decoder = Decoder(cfg, device="meta")
    decoder.load_state_dict(thf.convert_decoder(hf.state_dict(), cfg, "model.", device="cpu"),
                            strict=True, assign=True)
    tokens = torch.tensor([[3, 17, 200, 90, 12, 0, 55, 7]])
    with torch.no_grad():
        want = hf(tokens).logits
        got, _ = decoder(tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4, atol=3e-4)


def test_siglip_features_match_hf():
    from transformers import SiglipVisionConfig, SiglipVisionModel

    torch.manual_seed(3)
    hf_cfg = SiglipVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                num_attention_heads=4, image_size=56, patch_size=14,
                                attn_implementation="eager")
    hf = SiglipVisionModel(hf_cfg).eval()
    cfg = tcfgs.VisionConfig(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                             image_size=56, patch_size=14, layer_norm_eps=hf_cfg.layer_norm_eps,
                             dtype="float32")
    sd = hf.state_dict()
    assert any(k.startswith("vision_model.head.") for k in sd)  # ignored by the converter
    tower = SiglipVisionTower(cfg, device="meta")
    tower.load_state_dict(thf.convert_siglip_vision(sd, cfg, "vision_model.", device="cpu"),
                          strict=True, assign=True)
    pixels = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 56, 56).astype(np.float32))
    with torch.no_grad():
        want = hf(pixels).last_hidden_state
        got = tower(pixels)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4, atol=3e-4)


def test_patch_kernel_order_matches_hf_conv():
    """A conv weight whose entries all differ, with C = 3 != p = 4 and a
    non-square image: the converted kernel applied to the port's patchify
    equals HF's Conv2d, which fails for any other flatten order."""
    rng = np.random.RandomState(0)
    h, c, p = 8, 3, 4
    w = torch.from_numpy(rng.randn(h, c, p, p).astype(np.float32))
    b = torch.from_numpy(rng.randn(h).astype(np.float32))
    cfg = tcfgs.VisionConfig(hidden_size=h, intermediate_size=16, num_layers=0, num_heads=2,
                             image_size=12, patch_size=p, dtype="float32")
    prefix = "vision_model."
    sd = {f"{prefix}embeddings.patch_embedding.weight": w,
          f"{prefix}embeddings.patch_embedding.bias": b,
          f"{prefix}embeddings.position_embedding.weight": torch.zeros(9, h),
          f"{prefix}post_layernorm.weight": torch.ones(h),
          f"{prefix}post_layernorm.bias": torch.zeros(h)}
    kernel = thf.convert_siglip_vision(sd, cfg, prefix, device="cpu")["patch_embed.kernel"]
    x = torch.from_numpy(rng.randn(2, c, 8, 12).astype(np.float32))
    want = torch.nn.functional.conv2d(x, w, b, stride=p).flatten(2).transpose(1, 2)
    got = torch.nn.functional.linear(patchify(x, p), kernel, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    exported = thf.export_siglip_vision({"patch_embed.kernel": kernel, **{
        k: torch.zeros(1) for k in ("patch_embed.bias", "pos_embed", "post_ln.scale",
                                    "post_ln.bias")}}, cfg, prefix)
    assert torch.equal(exported[f"{prefix}embeddings.patch_embedding.weight"], w)


@pytest.mark.parametrize("prefix,keys,expect", [
    ("model.", ("lm_head.weight",), "lm_head.weight"),
    ("language_model.model.", ("language_model.lm_head.weight", "lm_head.weight"),
     "language_model.lm_head.weight"),
    ("language_model.model.", ("lm_head.weight",), "lm_head.weight"),
])
def test_lm_head_candidates(prefix, keys, expect):
    """The port picks the head the JAX converter picks, and an explicit
    lm_head_key wins."""
    rng = np.random.RandomState(1)
    tcfg = tcfgs.TextConfig(vocab_size=16, hidden_size=8, intermediate_size=16, num_layers=1,
                            num_heads=2, num_kv_heads=1, head_dim=4, dtype="float32")
    jcfg = cfgs.TextConfig(**dataclasses.asdict(tcfg))
    shapes = {"embed_tokens.weight": (16, 8), "norm.weight": (8,),
              "layers.0.input_layernorm.weight": (8,),
              "layers.0.post_attention_layernorm.weight": (8,),
              "layers.0.self_attn.q_proj.weight": (8, 8), "layers.0.self_attn.k_proj.weight": (4, 8),
              "layers.0.self_attn.v_proj.weight": (4, 8), "layers.0.self_attn.o_proj.weight": (8, 8),
              "layers.0.mlp.gate_proj.weight": (16, 8), "layers.0.mlp.up_proj.weight": (16, 8),
              "layers.0.mlp.down_proj.weight": (8, 16)}
    sd = {prefix + k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    sd.update({k: rng.randn(16, 8).astype(np.float32) for k in keys})
    got = thf.convert_decoder(sd, tcfg, prefix, device="cpu")["lm_head"]
    np.testing.assert_array_equal(got.numpy(), sd[expect])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhf.convert_decoder(sd, jcfg, prefix)["lm_head"]).T)
    other = keys[-1]
    np.testing.assert_array_equal(
        thf.convert_decoder(sd, tcfg, prefix, lm_head_key=other, device="cpu")["lm_head"].numpy(),
        sd[other])


def _write_layout(directory, sd, layout):
    directory.mkdir()
    if layout == "bin":
        torch.save(sd, directory / "pytorch_model.bin")
        return
    from safetensors.torch import save_file

    if layout == "single":
        save_file(sd, str(directory / "model.safetensors"))
        return
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    weight_map = {}
    for name, part in shards.items():
        save_file({k: sd[k] for k in part}, str(directory / name))
        weight_map.update({k: name for k in part})
    (directory / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))


@pytest.mark.parametrize("layout", ["index", "single", "bin"])
def test_load_hf_state_dict_layouts(tmp_path, jax_params, layout):
    """Each layout reads back the same tensors as the JAX loader, and the
    converted model equals the one converted from memory."""
    _, sd = jax_params
    tensors = {k: torch.from_numpy(np.array(v, order="C")).to(torch.bfloat16)
               for k, v in sd.items()}
    _write_layout(tmp_path / layout, tensors, layout)
    loaded = thf.load_hf_state_dict(str(tmp_path / layout), device="cpu")
    jloaded = jhf.load_hf_state_dict(str(tmp_path / layout))
    assert set(loaded) == set(jloaded) == set(tensors) and len(loaded) == len(tensors)
    for k, t in tensors.items():
        assert torch.equal(loaded[k], t) and torch.equal(jloaded[k], t), k
    tcfg = _with_dtype(tcfgs, "bfloat16")
    model = thf.load_leopard_llava(str(tmp_path / layout), tcfg, device="cpu")
    _assert_same({k: v for k, v in model.state_dict().items()},
                 thf.convert_leopard_llava(tensors, tcfg, device="cpu"))


def test_load_hf_state_dict_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        thf.load_hf_state_dict(str(tmp_path))


def _idefics2(dtype):
    """The JAX and port configs of the tiny Idefics2 VLM in `dtype`, and
    fp32 JAX params of it."""
    def cast(mod):
        cfg = tiny_idefics2(mod)
        return dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, dtype=dtype),
            text=dataclasses.replace(cfg.text, dtype=dtype),
            perceiver=dataclasses.replace(cfg.perceiver, dtype=dtype))
    return cast(cfgs), cast(tcfgs), idefics2_params(tiny_idefics2(cfgs))


# the one key where the port's Idefics2 export differs from the JAX export
JAX_IDEFICS2_HEAD = "model.text_lm_head.weight"


def _as_hf(jax_export):
    """A JAX Idefics2 export with its head where HF keeps it."""
    out = dict(jax_export)
    out["lm_head.weight"] = out.pop(JAX_IDEFICS2_HEAD)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perceiver_round_trip_equals_jax(dtype):
    jcfg, tcfg, params = _idefics2(dtype)
    sd = jhf.export_perceiver(params["perceiver"], jcfg.perceiver, "model.connector.")
    want = state_dict_from_jax(
        {"perceiver": jax.device_get(jhf.convert_perceiver(sd, jcfg.perceiver))}, tcfg)
    got = thf.convert_perceiver(sd, tcfg.perceiver, device="cpu")
    _assert_same({"perceiver." + k: v for k, v in got.items()}, want)
    back = thf.export_perceiver(got, tcfg.perceiver)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(
            back[k].float().numpy(), np.asarray(np.asarray(v, jcfg.perceiver.dtype), np.float32),
            err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_idefics2_convert_equals_jax(dtype):
    """From the JAX export (its head key) and from the HF layout: the same
    state dict as `state_dict_from_jax` of the JAX conversion."""
    jcfg, tcfg, params = _idefics2(dtype)
    sd = jhf.export_leopard_idefics2(params, jcfg)
    assert JAX_IDEFICS2_HEAD in sd and "lm_head.weight" not in sd
    want = state_dict_from_jax(jax.device_get(jhf.convert_leopard_idefics2(sd, jcfg)), tcfg)
    for layout in (sd, _as_hf(sd)):
        got = thf.convert_leopard_idefics2(layout, tcfg, device="cpu")
        _assert_same(got, want)
    model = tvlm.LeopardVLM(tcfg, device="meta")
    model.load_state_dict(got, strict=True, assign=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_idefics2_export_equals_jax(dtype):
    jcfg, tcfg, params = _idefics2(dtype)
    jparams = jax.tree_util.tree_map(lambda a: np.asarray(a, jcfg.text.dtype), params)
    want = _as_hf(jhf.export_leopard_idefics2(jparams, jcfg))
    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(jparams, tcfg), strict=True)
    got = thf.export_leopard_idefics2(model, tcfg)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch_dtype(dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(), w, err_msg=k)
    storages = {p.untyped_storage().data_ptr() for p in model.parameters()}
    assert all(t.untyped_storage().data_ptr() in storages for t in got.values())
    back = thf.convert_leopard_idefics2(got, tcfg, device="cpu")
    _assert_same(back, {k: v.detach() for k, v in model.state_dict().items()})


def test_load_leopard_idefics2_from_shards(tmp_path):
    jcfg, tcfg, params = _idefics2("bfloat16")
    tensors = {k: torch.from_numpy(np.array(v, order="C")).to(torch.bfloat16)
               for k, v in _as_hf(jhf.export_leopard_idefics2(params, jcfg)).items()}
    _write_layout(tmp_path / "index", tensors, "index")
    model = thf.load_leopard_idefics2(str(tmp_path / "index"), tcfg, device="cpu")
    _assert_same(dict(model.state_dict()),
                 thf.convert_leopard_idefics2(tensors, tcfg, device="cpu"))
    assert not hasattr(model, "projector")


def test_mistral_logits_match_hf_sliding_window():
    from transformers import MistralConfig, MistralForCausalLM

    torch.manual_seed(2)
    hf_cfg = MistralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
        max_position_embeddings=128, rms_norm_eps=1e-5, sliding_window=6,
        tie_word_embeddings=False, attn_implementation="eager")
    hf = MistralForCausalLM(hf_cfg).eval()
    cfg = tcfgs.TextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=16, rope_theta=10000.0, rope_scaling=None,
        sliding_window=6, rms_norm_eps=1e-5, dtype="float32")
    decoder = Decoder(cfg, device="meta")
    decoder.load_state_dict(thf.convert_decoder(hf.state_dict(), cfg, "model.", device="cpu"),
                            strict=True, assign=True)
    no_window = Decoder(dataclasses.replace(cfg, sliding_window=None), device="meta")
    no_window.load_state_dict(decoder.state_dict(), assign=True)
    tokens = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (2, 16)))
    with torch.no_grad():
        want = hf(tokens).logits
        got, _ = decoder(tokens)
        other, _ = no_window(tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4, atol=3e-4)
    assert (got - other)[:, 6:].abs().max() > 1e-2
    exported = thf.export_decoder(decoder, cfg, "model.")
    assert set(exported) == set(hf.state_dict())


def test_navit_tower_matches_hf_idefics2_vision():
    """Grids of 5 and 1 rows or columns on a 6-side table: no fraction of
    theirs lands on a boundary, where the two position-id rules part."""
    from transformers import Idefics2Config
    from transformers.models.idefics2.modeling_idefics2 import Idefics2VisionTransformer

    torch.manual_seed(5)
    hf_cfg = Idefics2Config(vision_config=dict(
        hidden_size=144, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
        image_size=84, patch_size=14, layer_norm_eps=1e-6)).vision_config
    hf_cfg._attn_implementation = "eager"
    hf = Idefics2VisionTransformer(hf_cfg).eval()
    cfg = tiny_idefics2(tcfgs).vision
    tower = SiglipVisionTower(cfg, device="meta")
    tower.load_state_dict(thf.convert_siglip_vision(hf.state_dict(), cfg, "", device="cpu"),
                          strict=True, assign=True)
    pixels, mask = navit_images([(5, 5), (5, 1), (1, 5)], seed=6)
    with torch.no_grad():
        want = hf(torch.from_numpy(pixels),
                  patch_attention_mask=torch.from_numpy(mask)).last_hidden_state
        got = tower(torch.from_numpy(pixels), torch.from_numpy(mask))
    valid = torch.from_numpy(mask.reshape(3, -1))
    np.testing.assert_allclose(got[valid].numpy(), want[valid].numpy(), rtol=3e-4, atol=3e-4)
    assert set(thf.export_siglip_vision(tower, cfg, "")) == set(hf.state_dict())


def test_safetensors_reader_dtypes(tmp_path):
    """The port's plain-read safetensors reader gives what safetensors' own
    reader gives, for every dtype it names, a scalar and an empty tensor."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "f16": torch.randn(7, generator=g).half(), "f32": torch.randn(2, 2, 2, generator=g),
               "f64": torch.randn(4, generator=g).double(), "i64": torch.arange(-3, 3),
               "i32": torch.arange(5, dtype=torch.int32), "i16": torch.arange(4, dtype=torch.int16),
               "i8": torch.arange(-4, 4, dtype=torch.int8), "u8": torch.arange(9, dtype=torch.uint8),
               "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5),
               "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    mine = thf.SafetensorsFile(path)
    assert set(mine.keys()) == set(tensors)
    with safe_open(path, framework="pt") as theirs:
        for k, t in tensors.items():
            got = mine.get_tensor(k)
            assert got.dtype == t.dtype and got.shape == t.shape, k
            assert torch.equal(got, theirs.get_tensor(k)) and torch.equal(got, t), k
