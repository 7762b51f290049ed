"""The port's own copy of the configuration (leopard_tpu_torch/config.py)
against the JAX package's: every preset, field for field, under `to_dict`,
and the serialization helpers on both."""

import inspect

import pytest

from leopard_tpu import config as jcfg
from leopard_tpu_torch import config as tcfg

PRESETS = [name for name, fn in inspect.getmembers(jcfg, inspect.isfunction)
           if fn.__module__ == jcfg.__name__ and not inspect.signature(fn).parameters
           or name == "tiny_vlm"]


def test_every_preset_is_copied():
    assert set(PRESETS) <= set(dir(tcfg))
    assert {"leopard_llava_8b", "tiny_vlm", "llama3_1_8b", "mistral_7b"} <= set(PRESETS)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equals_jax(name):
    assert tcfg.to_dict(getattr(tcfg, name)()) == jcfg.to_dict(getattr(jcfg, name)())


@pytest.mark.parametrize("cls", ["VLMConfig", "TrainConfig", "GenerateConfig", "MeshConfig"])
def test_defaults_equal_jax(cls):
    assert tcfg.to_dict(getattr(tcfg, cls)()) == jcfg.to_dict(getattr(jcfg, cls)())


def test_serialization_round_trip(tmp_path):
    cfg = tcfg.apply_overrides(tcfg.leopard_llava_8b(), {"text.num_layers": 4,
                                                        "vision.attn_impl": "dense"})
    assert cfg.text.num_layers == 4 and cfg.vision.attn_impl == "dense"
    path = str(tmp_path / "cfg.json")
    tcfg.save_json(cfg, path)
    assert tcfg.load_json(tcfg.VLMConfig, path) == cfg
    assert tcfg.from_dict(tcfg.VLMConfig, jcfg.to_dict(jcfg.apply_overrides(
        jcfg.leopard_llava_8b(), {"text.num_layers": 4, "vision.attn_impl": "dense"}))) == cfg
    with pytest.raises(KeyError):
        tcfg.from_dict(tcfg.TextConfig, {"no_such_field": 1})
