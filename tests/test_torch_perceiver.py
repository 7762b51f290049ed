"""The port's Idefics2 connector (leopard_tpu_torch/models/perceiver.py):
modality projection + perceiver resampler, against the JAX package's
`perceiver.forward` and against HF's own `Idefics2Connector`, float32 on
the CPU, with padded context rows masked:

  - against JAX at 1e-4, at toy widths and at the real head dim 96 (GQA
    16/4 heads scaled down to 4/1);
  - against HF at 2e-4, the tolerance of tests/test_idefics2.py;
  - masking matters: a mask changes the output, the content of masked rows
    does not (not even 1e4), and an image whose every patch is padding (the
    tile bucket's) comes out finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.models import perceiver as jperceiver
from leopard_tpu_torch.convert import hf as thf
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.models.perceiver import Perceiver

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
VISION = 32

CONFIGS = {
    "tiny": dict(num_latents=8, num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2,
                 head_dim=16, intermediate_size=96),
    "head_dim_96": dict(num_latents=16, num_layers=3, hidden_size=128, num_heads=4,
                        num_kv_heads=1, head_dim=96, intermediate_size=160),
}


def _pair(name, seed=0):
    cfg = cfgs.PerceiverConfig(rms_norm_eps=1e-6, dtype="float32", **CONFIGS[name])
    params = jax.device_get(jperceiver.init_params(cfg, jax.random.PRNGKey(seed),
                                                   vision_hidden=VISION))
    # the init's latents are all ones: draw them so that the latents differ
    params["latents"] = np.random.RandomState(seed).randn(*params["latents"].shape).astype(
        np.float32)
    model = Perceiver(cfg, VISION)
    state = state_dict_from_jax({"perceiver": params}, cfg)
    model.load_state_dict({k[len("perceiver."):]: v for k, v in state.items()}, strict=True)
    return cfg, params, model.eval()


def _context(b, s, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, s, VISION).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    seg[1, 9:] = 0               # a narrow image: its tail is padding
    seg[1, 3:5] = 0              # and padding inside the row, as NaViT interleaves it
    return feats, seg


def _port(model, feats, seg):
    with torch.no_grad():
        return model(torch.from_numpy(feats),
                     None if seg is None else torch.from_numpy(seg)).numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_connector_matches_jax(name):
    cfg, params, model = _pair(name)
    feats, seg = _context(2, 14, seed=1)
    want = np.asarray(jperceiver.forward(params, cfg, jnp.asarray(feats), jnp.asarray(seg)))
    got = _port(model, feats, seg)
    assert got.shape == (2, cfg.num_latents, cfg.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(_port(model, feats, None),
                               np.asarray(jperceiver.forward(params, cfg, jnp.asarray(feats))),
                               **TOL)


def test_connector_matches_hf_idefics2_connector():
    from transformers import Idefics2Config
    from transformers.models.idefics2.modeling_idefics2 import Idefics2Connector

    cfg, _, model = _pair("tiny", seed=2)
    hf_cfg = Idefics2Config(
        vision_config=dict(hidden_size=VISION),
        text_config=dict(model_type="mistral", hidden_size=cfg.hidden_size,
                         intermediate_size=cfg.intermediate_size, hidden_act="silu"),
        perceiver_config=dict(hidden_size=cfg.hidden_size, resampler_n_latents=cfg.num_latents,
                              resampler_depth=cfg.num_layers, resampler_n_heads=cfg.num_heads,
                              resampler_head_dim=cfg.head_dim,
                              num_key_value_heads=cfg.num_kv_heads, rms_norm_eps=1e-6,
                              attn_implementation="eager"))
    hf_cfg.perceiver_config._attn_implementation = "eager"
    connector = Idefics2Connector(hf_cfg).eval()
    connector.load_state_dict(thf.export_perceiver(model, cfg, prefix=""), strict=True)
    feats, seg = _context(2, 14, seed=3)
    with torch.no_grad():
        want = connector(torch.from_numpy(feats), attention_mask=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(_port(model, feats, seg), want, rtol=2e-4, atol=2e-4)


def test_masking_matters():
    cfg, _, model = _pair("tiny", seed=4)
    feats, seg = _context(2, 14, seed=5)
    masked = _port(model, feats, seg)
    unmasked = _port(model, feats, np.ones_like(seg))
    assert np.abs(masked[1] - unmasked[1]).max() > 1e-3
    np.testing.assert_allclose(masked[0], unmasked[0], **TOL)  # row 0 has no padding
    loud = feats.copy()
    loud[seg == 0] = 1e4
    np.testing.assert_allclose(_port(model, loud, seg), masked, **TOL)


def test_a_padding_image_comes_out_finite():
    """The tile bucket's all-zero image: no context row is valid, the
    latents attend each other only."""
    _, _, model = _pair("tiny", seed=6)
    feats = np.zeros((2, 14, VISION), np.float32)
    seg = np.zeros((2, 14), np.int32)
    out = _port(model, feats, seg)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0], out[1], **TOL)
