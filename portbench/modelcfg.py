"""A configuration file (configs/<name>.json, HF-style keys) → the port's
VLMConfig, and the model's parameter counts by part.

The files keep the published config.json keys of each part (`text_config`,
`vision_config`, `perceiver_config`); what the published file does not give
sits under `assumed`. This module is the one place that maps those keys
onto the port's dataclasses, so a configuration of a known architecture is
added as a data file alone.
"""

from __future__ import annotations

from leopard_tpu_torch.config import (
    AnyResConfig, PerceiverConfig, ProjectorConfig, TextConfig, VisionConfig, VLMConfig,
)


def _dtype(group: dict) -> str:
    return group.get("torch_dtype", "bfloat16")


def text_config(t: dict, assumed: dict) -> TextConfig:
    heads = t["num_attention_heads"]
    return TextConfig(
        vocab_size=t["vocab_size"] + assumed.get("added_tokens", 0),
        hidden_size=t["hidden_size"],
        intermediate_size=t["intermediate_size"],
        num_layers=t["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=t["num_key_value_heads"],
        head_dim=t.get("head_dim", assumed.get("head_dim", t["hidden_size"] // heads)),
        rms_norm_eps=t["rms_norm_eps"],
        rope_theta=float(t["rope_theta"]),
        rope_scaling=None,
        sliding_window=t.get("sliding_window"),
        max_position_embeddings=t["max_position_embeddings"],
        tie_word_embeddings=t.get("tie_word_embeddings", False),
        dtype=_dtype(t),
    )


def vision_config(v: dict) -> VisionConfig:
    return VisionConfig(
        hidden_size=v["hidden_size"],
        intermediate_size=v["intermediate_size"],
        num_layers=v["num_hidden_layers"],
        num_heads=v["num_attention_heads"],
        image_size=v["image_size"],
        patch_size=v["patch_size"],
        layer_norm_eps=v["layer_norm_eps"],
        hidden_act=v.get("hidden_act", "gelu_pytorch_tanh"),
        dtype=_dtype(v),
    )


def vlm_config(spec: dict) -> VLMConfig:
    """The port's config for a configuration file."""
    assumed = spec.get("assumed", {})
    text = text_config(spec["text_config"], assumed)
    vision = vision_config(spec["vision_config"])
    arch = spec["architecture"]
    if arch == "leopard_llava":
        any_ = spec["anyres_config"]
        r = spec["projector_config"]["pixel_shuffle_factor"]
        per_tile = (vision.image_size // vision.patch_size) ** 2 // (r * r)
        return VLMConfig(
            vision=vision, text=text,
            projector=ProjectorConfig(projector_type=spec["projector_config"]["projector_type"],
                                      input_size=vision.hidden_size * r * r,
                                      hidden_size=text.hidden_size, dtype=text.dtype),
            anyres=AnyResConfig(tile_size=any_["tile_size"], tile_budget=any_["tile_budget"],
                                tokens_per_tile=per_tile,
                                image_mean=tuple(any_["image_mean"]),
                                image_std=tuple(any_["image_std"])),
            image_token_id=assumed["image_token_id"], pixel_shuffle_factor=r,
            architecture=arch)
    if arch == "leopard_idefics2":
        p = spec["perceiver_config"]
        perceiver = PerceiverConfig(
            num_latents=p["resampler_n_latents"], num_layers=p["resampler_depth"],
            hidden_size=text.hidden_size, num_heads=p["resampler_n_heads"],
            num_kv_heads=p["num_key_value_heads"], head_dim=p["resampler_head_dim"],
            intermediate_size=text.intermediate_size, rms_norm_eps=p["rms_norm_eps"],
            dtype=text.dtype)
        return VLMConfig(
            vision=vision, text=text, perceiver=perceiver,
            projector=ProjectorConfig(projector_type="none", input_size=text.hidden_size,
                                      hidden_size=text.hidden_size, dtype=text.dtype),
            anyres=AnyResConfig(tile_size=vision.image_size, tile_budget=0,
                                tokens_per_tile=perceiver.num_latents),
            image_token_id=spec["image_token_id"], pixel_shuffle_factor=1,
            architecture=arch)
    raise ValueError(f"unknown architecture {arch!r}")


def matmul_params(cfg: VLMConfig) -> dict:
    """Weights that multiply each token, by part (per token of that part):
    `text_layer` one decoder layer, `head` the unembedding, `tower_layer`
    one vision layer, `patch` the patch embedding, `projector` the LLaVA
    projector (per 4·hidden input row), `modality` the Idefics2 modality
    projection (per patch), `perceiver_q` / `perceiver_kv` / `perceiver_o` /
    `perceiver_mlp` one resampler layer's parts (per latent or per kv row)."""
    t, v = cfg.text, cfg.vision
    h, qd, kvd = t.hidden_size, t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    vh = v.hidden_size
    out = {
        "text_layer": h * (qd + 2 * kvd) + qd * h + 3 * h * t.intermediate_size,
        "head": t.vocab_size * h,
        "tower_layer": 4 * vh * vh + 2 * vh * v.intermediate_size,
        "patch": vh * v.num_channels * v.patch_size ** 2,
    }
    if cfg.perceiver is None:
        out["projector"] = cfg.projector.input_size * h + h * h
    else:
        p = cfg.perceiver
        pq, pkv = p.num_heads * p.head_dim, p.num_kv_heads * p.head_dim
        out.update(modality=2 * vh * p.intermediate_size + p.intermediate_size * h,
                   perceiver_q=h * pq, perceiver_kv=2 * h * pkv, perceiver_o=pq * h,
                   perceiver_mlp=3 * h * 4 * h)
    return out
