"""HF checkpoint ↔ the port's state dict (port of leopard_tpu/convert/hf.py,
for the LLaVA, Idefics2, Llama and Mistral families).

The published Leopard-LLaVA checkpoint is a LlavaForConditionalGeneration:
`vision_tower.vision_model.*`, `multi_modal_projector.linear_{1,2}.*`,
`language_model.model.*` and `language_model.lm_head.weight`. Leopard-Idefics2
is an Idefics2ForConditionalGeneration: `model.vision_model.*`,
`model.connector.{modality_projection,perceiver_resampler}.*`,
`model.text_model.*` and `lm_head.weight`. HF `Linear`
weights are [out, in], as the port's are (models/params.py), and the port
keeps one module per layer, so where the JAX converter transposes and
stacks, this one only renames, layer by layer (`layers.{i}`). The one
reshape is the SigLIP patch embedding: the HF conv weight [H, C, p, p]
flattens in (C, ph, pw) order to the port's kernel [H, C·p·p], the feature
order of `models/siglip.py::patchify`.

`convert_*` take an HF state dict (torch tensors or numpy arrays) and give
the names that `LeopardVLM.load_state_dict(strict=True)` accepts. Each
tensor is moved to `device` in its stored dtype, then cast there once to the
config's dtype (fp32 → bf16 rounds to nearest even, as `jnp.asarray` does;
bf16 → fp32 is exact), so the values equal the JAX converter's bit for bit.
`load_hf_state_dict` reads one tensor at a time when it is looked up (a
safetensors file with plain reads, no memory map), so a conversion holds one
tensor on the host at a time and never the whole checkpoint.

`export_*` are the inverse: the same keys as the JAX exports, but each
value is the port's own tensor or a view of it, in the params' dtype (the
JAX exports give fp32 numpy copies). An export copies nothing.

One key differs from the JAX exports: `export_leopard_idefics2` writes the
head as `lm_head.weight`, where HF's Idefics2 model keeps it. The JAX export
derives it from the decoder's prefix and writes `model.text_lm_head.weight`,
a key HF does not read; `convert_leopard_idefics2` reads either.

The CLIP tower (`convert_clip_vision`, JAX convert/hf.py:162-200) reads a
CLIPVisionModel: the SigLIP names with `embeddings.class_embedding`,
`pre_layrnorm.*` and an unbiased patch embedding. The tower's names follow
its config (`_siglip_names`), so `export_siglip_vision` writes a CLIP
tower's keys too, as the JAX export does.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from leopard_tpu_torch.config import (PerceiverConfig, ProjectorConfig, TextConfig, VisionConfig,
                                      VLMConfig)
from leopard_tpu_torch.models.params import torch_dtype

StateDict = Mapping  # name → torch.Tensor or np.ndarray

# port name under `layers.{i}.` → HF name under `layers.{i}.`
DECODER_LAYER = {
    "input_norm": "input_layernorm.weight",
    "attn.wq": "self_attn.q_proj.weight",
    "attn.wk": "self_attn.k_proj.weight",
    "attn.wv": "self_attn.v_proj.weight",
    "attn.wo": "self_attn.o_proj.weight",
    "post_attn_norm": "post_attention_layernorm.weight",
    "mlp.w_gate": "mlp.gate_proj.weight",
    "mlp.w_up": "mlp.up_proj.weight",
    "mlp.w_down": "mlp.down_proj.weight",
}
SIGLIP_LAYER = {
    "ln1.scale": "layer_norm1.weight", "ln1.bias": "layer_norm1.bias",
    "attn.wq": "self_attn.q_proj.weight", "attn.bq": "self_attn.q_proj.bias",
    "attn.wk": "self_attn.k_proj.weight", "attn.bk": "self_attn.k_proj.bias",
    "attn.wv": "self_attn.v_proj.weight", "attn.bv": "self_attn.v_proj.bias",
    "attn.wo": "self_attn.out_proj.weight", "attn.bo": "self_attn.out_proj.bias",
    "ln2.scale": "layer_norm2.weight", "ln2.bias": "layer_norm2.bias",
    "mlp.fc1": "mlp.fc1.weight", "mlp.b1": "mlp.fc1.bias",
    "mlp.fc2": "mlp.fc2.weight", "mlp.b2": "mlp.fc2.bias",
}
PROJECTOR = {"fc1": "linear_1.weight", "b1": "linear_1.bias",
             "fc2": "linear_2.weight", "b2": "linear_2.bias"}
# the Idefics2 connector: port name under `perceiver.` → HF name under the
# connector's prefix; the resampler's layers under `layers.{i}.`
PERCEIVER = {
    "modality_proj.w_gate": "modality_projection.gate_proj.weight",
    "modality_proj.w_up": "modality_projection.up_proj.weight",
    "modality_proj.w_down": "modality_projection.down_proj.weight",
    "latents": "perceiver_resampler.latents",
    "final_norm": "perceiver_resampler.norm.weight",
}
PERCEIVER_LAYER = {
    "latents_norm": "input_latents_norm.weight",
    "context_norm": "input_context_norm.weight",
    "attn.wq": "self_attn.q_proj.weight",
    "attn.wk": "self_attn.k_proj.weight",
    "attn.wv": "self_attn.v_proj.weight",
    "attn.wo": "self_attn.o_proj.weight",
    "post_attn_norm": "post_attention_layernorm.weight",
    "mlp.w_gate": "mlp.gate_proj.weight",
    "mlp.w_up": "mlp.up_proj.weight",
    "mlp.w_down": "mlp.down_proj.weight",
}
IDEFICS2_LM_HEAD = "lm_head.weight"


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a, order="C")  # a writable copy: JAX arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes, as the JAX package holds it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _cast(a, dtype: torch.dtype, device) -> torch.Tensor:
    """To the device in the stored dtype, then one cast there."""
    return _as_tensor(a).to(device).to(dtype)


def _lm_head_key(sd: StateDict, prefix: str) -> str:
    """lm_head sits beside the decoder: model.* → lm_head.weight;
    language_model.model.* → language_model.lm_head.weight."""
    candidates = [
        prefix[: -len("model.")] + "lm_head.weight" if prefix.endswith("model.")
        else prefix + "lm_head.weight",
        "lm_head.weight",
    ]
    return next((c for c in candidates if c in sd), candidates[0])


def _decoder_names(cfg: TextConfig, prefix: str) -> Dict[str, str]:
    """{port name: HF name} of a decoder, lm_head excluded."""
    if cfg.num_experts > 0:
        # the JAX package has no HF layout for its expert banks either
        raise NotImplementedError("no HF checkpoint layout for MoE decoders")
    names = {"embed_tokens": f"{prefix}embed_tokens.weight", "final_norm": f"{prefix}norm.weight"}
    for i in range(cfg.num_layers):
        for ours, theirs in DECODER_LAYER.items():
            names[f"layers.{i}.{ours}"] = f"{prefix}layers.{i}.{theirs}"
    return names


def _siglip_names(cfg: VisionConfig, prefix: str) -> Dict[str, str]:
    """{port name: HF name} of a SigLIP or CLIP tower (as `cfg` says), the
    patch kernel excluded."""
    names = {
        "pos_embed": f"{prefix}embeddings.position_embedding.weight",
        "post_ln.scale": f"{prefix}post_layernorm.weight",
        "post_ln.bias": f"{prefix}post_layernorm.bias",
    }
    if cfg.patch_bias:
        names["patch_embed.bias"] = f"{prefix}embeddings.patch_embedding.bias"
    if cfg.use_class_token:
        names["class_embed"] = f"{prefix}embeddings.class_embedding"
    if cfg.pre_ln:  # HF's CLIP spells it so
        names["pre_ln.scale"] = f"{prefix}pre_layrnorm.weight"
        names["pre_ln.bias"] = f"{prefix}pre_layrnorm.bias"
    for i in range(cfg.num_layers):
        for ours, theirs in SIGLIP_LAYER.items():
            names[f"layers.{i}.{ours}"] = f"{prefix}encoder.layers.{i}.{theirs}"
    return names


def _perceiver_names(cfg: PerceiverConfig, prefix: str) -> Dict[str, str]:
    """{port name: HF name} of an Idefics2 connector."""
    names = {ours: prefix + theirs for ours, theirs in PERCEIVER.items()}
    for i in range(cfg.num_layers):
        for ours, theirs in PERCEIVER_LAYER.items():
            names[f"layers.{i}.{ours}"] = f"{prefix}perceiver_resampler.layers.{i}.{theirs}"
    return names


def convert_decoder(sd: StateDict, cfg: TextConfig, prefix: str = "model.",
                    lm_head_key: Optional[str] = None, device="cuda") -> Dict[str, torch.Tensor]:
    """HF LlamaForCausalLM / MistralForCausalLM state dict → the port's
    `Decoder` state dict."""
    dt = torch_dtype(cfg.dtype)
    out = {ours: _cast(sd[theirs], dt, device)
           for ours, theirs in _decoder_names(cfg, prefix).items()}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = _cast(sd[lm_head_key or _lm_head_key(sd, prefix)], dt, device)
    return out


def convert_siglip_vision(sd: StateDict, cfg: VisionConfig, prefix: str = "vision_model.",
                          device="cuda") -> Dict[str, torch.Tensor]:
    """HF SiglipVisionModel state dict → the port's `SiglipVisionTower`
    state dict. Keys the tower does not use (`vision_model.head.*`) are
    ignored."""
    dt = torch_dtype(cfg.dtype)
    out = {ours: _cast(sd[theirs], dt, device)
           for ours, theirs in _siglip_names(cfg, prefix).items()}
    conv_w = _cast(sd[f"{prefix}embeddings.patch_embedding.weight"], dt, device)  # [H, C, p, p]
    out["patch_embed.kernel"] = conv_w.reshape(conv_w.shape[0], -1)
    return out


def convert_clip_vision(sd: StateDict, cfg: VisionConfig, prefix: str = "vision_model.",
                        device="cuda") -> Dict[str, torch.Tensor]:
    """HF CLIPVisionModel state dict → the port's `SiglipVisionTower` state
    dict with the CLIP options (class token, pre-LN, no patch bias; `cfg`
    as `config.clip_vit_large_336` sets them). Keys the tower does not use
    (`vision_model.embeddings.position_ids`) are ignored."""
    return convert_siglip_vision(sd, cfg, prefix, device=device)


def convert_projector(sd: StateDict, cfg: ProjectorConfig,
                      prefix: str = "multi_modal_projector.", device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    dt = torch_dtype(cfg.dtype)
    return {ours: _cast(sd[prefix + theirs], dt, device) for ours, theirs in PROJECTOR.items()}


def _prefixed(group: str, tensors: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{group}.{k}": v for k, v in tensors.items()}


def convert_leopard_llava(sd: StateDict, cfg: VLMConfig, device="cuda") -> Dict[str, torch.Tensor]:
    """A whole Leopard-LLaVA HF checkpoint → the port's `LeopardVLM` state
    dict, every tensor on `device`."""
    out = _prefixed("vision", convert_siglip_vision(
        sd, cfg.vision, "vision_tower.vision_model.", device=device))
    out.update(_prefixed("projector", convert_projector(
        sd, cfg.projector, "multi_modal_projector.", device=device)))
    out.update(_prefixed("text", convert_decoder(
        sd, cfg.text, "language_model.model.", device=device)))
    return out


def convert_perceiver(sd: StateDict, cfg: PerceiverConfig, prefix: str = "model.connector.",
                      device="cuda") -> Dict[str, torch.Tensor]:
    """HF Idefics2Connector (modality projection + perceiver resampler)
    state dict → the port's `Perceiver` state dict."""
    dt = torch_dtype(cfg.dtype)
    return {ours: _cast(sd[theirs], dt, device)
            for ours, theirs in _perceiver_names(cfg, prefix).items()}


def convert_leopard_idefics2(sd: StateDict, cfg: VLMConfig, device="cuda"
                             ) -> Dict[str, torch.Tensor]:
    """A whole Idefics2ForConditionalGeneration HF checkpoint → the port's
    `LeopardVLM` state dict, every tensor on `device`."""
    out = _prefixed("vision", convert_siglip_vision(
        sd, cfg.vision, "model.vision_model.", device=device))
    out.update(_prefixed("perceiver", convert_perceiver(
        sd, cfg.perceiver, "model.connector.", device=device)))
    out.update(_prefixed("text", convert_decoder(
        sd, cfg.text, "model.text_model.", device=device)))
    return out


# ---------------------------------------------------------------------------
# The reverse direction: the port's state dict → HF keys, without copies
# ---------------------------------------------------------------------------


def _state(params) -> Mapping:
    """A module's state dict (detached tensors sharing its storage) or a
    mapping as it is."""
    return params.state_dict() if isinstance(params, torch.nn.Module) else params


def _sub(state: Mapping, group: str) -> Dict[str, torch.Tensor]:
    n = len(group) + 1
    return {k[n:]: v for k, v in state.items() if k.startswith(group + ".")}


def export_decoder(params, cfg: TextConfig, prefix: str = "model.",
                   lm_head_key: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The port's `Decoder` state dict → HF LlamaForCausalLM /
    MistralForCausalLM keys; the head goes beside the decoder's prefix
    (model.* → lm_head.weight) unless `lm_head_key` names it. A tied decoder
    has no head to write: HF ties it to the embedding on load
    (`hf_decoder_config` says so)."""
    state = _state(params)
    out = {theirs: state[ours] for ours, theirs in _decoder_names(cfg, prefix).items()}
    if "lm_head" in state:
        out[lm_head_key or prefix.rsplit("model.", 1)[0] + "lm_head.weight"] = state["lm_head"]
    return out


def hf_decoder_config(cfg: TextConfig) -> Dict[str, Any]:
    """The HF config.json of a decoder alone: LlamaForCausalLM, or
    MistralForCausalLM for a windowed config, with `tie_word_embeddings` as
    the config has it."""
    mistral = cfg.sliding_window is not None
    rope = None
    if cfg.rope_scaling == "llama3.1":
        rope = {"rope_type": "llama3", "factor": cfg.rope_scaling_factor,
                "low_freq_factor": cfg.rope_low_freq_factor,
                "high_freq_factor": cfg.rope_high_freq_factor,
                "original_max_position_embeddings": cfg.rope_original_max_position}
    elif cfg.rope_scaling == "linear":
        rope = {"rope_type": "linear", "factor": cfg.rope_scaling_factor}
    out = {
        "architectures": ["MistralForCausalLM" if mistral else "LlamaForCausalLM"],
        "model_type": "mistral" if mistral else "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta, "rope_scaling": rope,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings, "hidden_act": "silu",
        "torch_dtype": cfg.dtype,
    }
    if mistral:
        out["sliding_window"] = cfg.sliding_window
    else:
        out.update(attention_bias=cfg.attention_bias, mlp_bias=cfg.mlp_bias)
    return out


def export_siglip_vision(params, cfg: VisionConfig, prefix: str = "vision_model."
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of convert_siglip_vision: the patch kernel [H, C·p·p] goes
    back to the conv weight [H, C, p, p] as a view."""
    state = _state(params)
    out = {theirs: state[ours] for ours, theirs in _siglip_names(cfg, prefix).items()}
    kernel = state["patch_embed.kernel"]
    p = cfg.patch_size
    out[f"{prefix}embeddings.patch_embedding.weight"] = kernel.view(
        kernel.shape[0], cfg.num_channels, p, p)
    return out


def export_projector(params, prefix: str = "multi_modal_projector.") -> Dict[str, torch.Tensor]:
    state = _state(params)
    return {prefix + theirs: state[ours] for ours, theirs in PROJECTOR.items()}


def export_perceiver(params, cfg: PerceiverConfig, prefix: str = "model.connector."
                     ) -> Dict[str, torch.Tensor]:
    """Inverse of convert_perceiver: HF Idefics2Connector keys."""
    state = _state(params)
    return {theirs: state[ours] for ours, theirs in _perceiver_names(cfg, prefix).items()}


def export_leopard_llava(params, cfg: VLMConfig) -> Dict[str, torch.Tensor]:
    """A `LeopardVLM` or its state dict → LlavaForConditionalGeneration keys
    (inverse of convert_leopard_llava)."""
    state = _state(params)
    out = export_siglip_vision(_sub(state, "vision"), cfg.vision, "vision_tower.vision_model.")
    out.update(export_projector(_sub(state, "projector"), "multi_modal_projector."))
    out.update(export_decoder(_sub(state, "text"), cfg.text, "language_model.model."))
    return out


def export_leopard_idefics2(params, cfg: VLMConfig) -> Dict[str, torch.Tensor]:
    """A `LeopardVLM` or its state dict → Idefics2ForConditionalGeneration
    keys (inverse of convert_leopard_idefics2; the head as HF keeps it,
    `lm_head.weight`)."""
    state = _state(params)
    out = export_siglip_vision(_sub(state, "vision"), cfg.vision, "model.vision_model.")
    out.update(export_perceiver(_sub(state, "perceiver"), cfg.perceiver, "model.connector."))
    out.update(export_decoder(_sub(state, "text"), cfg.text, "model.text_model.",
                              lm_head_key=IDEFICS2_LM_HEAD))
    return out


def export_vlm(params, cfg: VLMConfig) -> Dict[str, torch.Tensor]:
    """Architecture-dispatching full-model export."""
    if cfg.architecture == "leopard_idefics2":
        return export_leopard_idefics2(params, cfg)
    return export_leopard_llava(params, cfg)


# ---------------------------------------------------------------------------
# Loading from disk (safetensors shards, one safetensors file, or a torch
# .bin), one tensor at a time
# ---------------------------------------------------------------------------


# the safetensors format's dtype names
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


class SafetensorsFile:
    """One .safetensors file, read one tensor at a time with plain reads: an
    8-byte little-endian header size, a JSON header of {name: {dtype, shape,
    data_offsets}}, then the data. Nothing is memory-mapped, so the host
    holds only the tensor being read, and frees it with the tensor."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.path, self.data_start, self.entries = path, 8 + n, header

    def keys(self):
        return self.entries.keys()

    def get_tensor(self, key: str) -> torch.Tensor:
        entry = self.entries[key]
        begin, end = entry["data_offsets"]
        buf = torch.empty(end - begin, dtype=torch.uint8)
        with open(self.path, "rb") as f:
            f.seek(self.data_start + begin)
            if f.readinto(buf.numpy()) != end - begin:
                raise OSError(f"{self.path}: the data of {key} is cut short")
        return buf.view(SAFETENSORS_DTYPES[entry["dtype"]]).reshape(entry["shape"])


class HFStateDict(Mapping):
    """The tensors of an HF model directory by name; each is read from disk
    and moved to `device` when it is looked up, and nothing is kept."""

    def __init__(self, model_dir: str, device="cpu"):
        self.device = torch.device(device)
        index_path = os.path.join(model_dir, "model.safetensors.index.json")
        single = os.path.join(model_dir, "model.safetensors")
        bin_path = os.path.join(model_dir, "pytorch_model.bin")
        if os.path.exists(index_path):
            with open(index_path) as f:
                weight_map = json.load(f)["weight_map"]
            files = {shard: SafetensorsFile(os.path.join(model_dir, shard))
                     for shard in sorted(set(weight_map.values()))}
            self._where: Dict[str, Any] = {key: files[shard] for key, shard in weight_map.items()}
        elif os.path.exists(single):
            file = SafetensorsFile(single)
            self._where = {key: file for key in file.keys()}
        elif os.path.exists(bin_path):
            # memory-mapped: a tensor's bytes are read when it is moved
            tensors = torch.load(bin_path, map_location="cpu", weights_only=True, mmap=True)
            self._where = {key: tensors for key in tensors}
        else:
            raise FileNotFoundError(f"no weights found under {model_dir}")

    def __getitem__(self, key: str) -> torch.Tensor:
        src = self._where[key]
        t = src[key] if isinstance(src, dict) else src.get_tensor(key)
        return t.to(self.device)

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, key) -> bool:
        return key in self._where


def load_hf_state_dict(model_dir: str, device="cpu") -> HFStateDict:
    """All weights of an HF model directory (a safetensors index and its
    shards, one model.safetensors, or pytorch_model.bin), read lazily onto
    `device`."""
    return HFStateDict(model_dir, device)


def _load_vlm(convert, model_dir: str, cfg: VLMConfig, device):
    from leopard_tpu_torch.models.vlm import LeopardVLM

    state = convert(load_hf_state_dict(model_dir, device), cfg, device=device)
    model = LeopardVLM(cfg, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    return model


def load_leopard_llava(model_dir: str, cfg: VLMConfig, device="cuda"):
    """A Leopard-LLaVA `LeopardVLM` on `device` holding the converted
    tensors themselves."""
    return _load_vlm(convert_leopard_llava, model_dir, cfg, device)


def load_leopard_idefics2(model_dir: str, cfg: VLMConfig, device="cuda"):
    """A Leopard-Idefics2 `LeopardVLM` on `device` holding the converted
    tensors themselves."""
    return _load_vlm(convert_leopard_idefics2, model_dir, cfg, device)
