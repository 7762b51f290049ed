"""Typed configuration for the PyTorch port: the port's own copy of
leopard_tpu/config.py, so that the port imports nothing of the JAX package.

The dataclasses, the presets and the serialization helpers (`to_dict`,
`from_dict`, `apply_overrides`, `save_json`, `load_json`) are the JAX
package's, field for field; a CPU test holds every preset equal to its JAX
counterpart under `to_dict`. Some field comments speak of the TPU: they
describe what the JAX package does with the field, and the port reads the
same fields.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Optional, Tuple


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VisionConfig:
    """SigLIP / Idefics2-NaViT vision transformer config.

    Mirrors the fields the reference maps from HF SiglipConfig into a Megatron
    TransformerConfig (megatron_patch/model/llava/clip_encoder.py:318-342).
    """

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    image_size: int = 364
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"  # or "quick_gelu" (CLIP)
    dtype: str = "bfloat16"
    # CLIP-style options (legacy clip-vit-large-patch14-336 tower,
    # megatron_patch/model/llava/clip_encoder.py:74-315)
    use_class_token: bool = False
    pre_ln: bool = False      # CLIP applies a LayerNorm before the encoder
    patch_bias: bool = True   # CLIP's patchify conv has no bias
    drop_class_token: bool = True  # feature-select "default": drop CLS output
    post_ln_sequence: bool = True  # SigLIP norms the sequence; CLIP only the
                                   # pooled CLS (sequence output is un-normed)
    feature_layer: int = -1   # -2 = penultimate (LLaVA's CLIP feature select)
    attn_impl: str = "auto"   # "auto": Pallas flash on TPU (seq padded to
                              # ×128 with segment masking), dense elsewhere

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_tile(self) -> int:
        return self.patches_per_side**2


@dataclass(frozen=True)
class TextConfig:
    """Decoder-only LLM config (Llama-3.1 / Mistral family).

    Covers the decoder dims the reference sets in
    examples/llava/train_multiimg_llava_siglip.sh:86-93 plus rope scaling
    selection (megatron_patch/model/llava/vlm_model.py:409-414).
    """

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[str] = "llama3.1"  # None | "llama3.1" | "linear"
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    max_position_embeddings: int = 131072
    sliding_window: Optional[int] = None  # Mistral-style when set
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    dtype: str = "bfloat16"
    # attention implementation: "auto" picks dense XLA attention for short
    # sequences / cached decode and blockwise chunked attention for long
    # prefill/training; "dense" | "chunked" | "flash" force one.
    attn_impl: str = "auto"
    attn_chunk_size: int = 512
    # flash kernel block size (both inference prefill fwd and training
    # fwd+bwd): 1024×1024 measured best on v5e at 4k AND 16k causal, fwd and
    # fwd+bwd (tools/tune_flash.py r5 sweep: 4k fwd+bwd 6.78 ms vs 7.70 at
    # 512²; 16k 49.5 vs 63.8) — fewer online-softmax state round-trips per
    # kv element. 2048-side blocks fail to compile (VMEM).
    flash_block_size: int = 1024
    long_seq_threshold: int = 2048
    # MoE (0 experts = dense MLP). When enabled, every layer's MLP becomes a
    # top-k routed expert bank (≙ Megatron --moe / MegaBlocks dMoE).
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # dropless (MegaBlocks dMoE): sort-based ragged dispatch, no token drops
    moe_dropless: bool = False
    moe_aux_loss_coef: float = 1e-2
    moe_z_loss_coef: float = 1e-3
    # expert-parallel all-to-all transport capacity factor (ops/moe.py):
    # <= 0 → worst-case buckets (zero drops); ~2.0 for production EP
    moe_ep_capacity_factor: float = 0.0
    # variable-split EP transport (jax.lax.ragged_all_to_all): moves only the
    # routed bytes over ICI, zero drops. TPU-only — keep False on CPU meshes.
    moe_ep_ragged_a2a: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class PerceiverConfig:
    """Idefics2 perceiver resampler config
    (megatron_patch/model/idefics2/perceiver_transformer.py)."""

    num_latents: int = 64
    num_layers: int = 3
    hidden_size: int = 4096
    num_heads: int = 16
    num_kv_heads: int = 4
    head_dim: int = 96
    intermediate_size: int = 14336
    rms_norm_eps: float = 1e-6
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class ProjectorConfig:
    """MLP multimodal projector (mm_projector_builder.py:72-89). The input is
    vision hidden ×4 because pixel-shuffle concatenates a 2×2 neighborhood."""

    projector_type: str = "mlp2x_gelu"
    input_size: int = 4608  # 1152 * 4 after pixel-shuffle
    hidden_size: int = 4096
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class AnyResConfig:
    """Adaptive high-resolution multi-image tiling budget
    (mm_pretrain_dataset.py:65-201,225-231)."""

    tile_size: int = 364
    tile_budget: int = 50
    tokens_per_tile: int = 169  # 26*26 // 4 after pixel-shuffle
    max_images: int = 50
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class VLMConfig:
    """Full Leopard VLM: vision tower + projector (or perceiver) + decoder."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    perceiver: Optional[PerceiverConfig] = None
    anyres: AnyResConfig = field(default_factory=AnyResConfig)
    image_token_id: int = 128255  # <|reserved_special_token_250|>
    pixel_shuffle_factor: int = 2
    architecture: str = "leopard_llava"  # or "leopard_idefics2"


# ---------------------------------------------------------------------------
# Runtime configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Axis sizes of 1 disable that parallelism.

    Axes (order = ICI-major): data (DP over DCN/outer ICI), stage (pipeline
    parallel — neighbor-only ppermute traffic, so it sits outer), fsdp
    (optimizer/param sharding over DP), expert (EP), seq (sequence/context
    parallel), model (tensor parallel, innermost → fastest ICI).
    """

    data: int = 1
    stage: int = 1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1
    axis_names: Tuple[str, ...] = (
        "data", "stage", "fsdp", "expert", "seq", "model"
    )

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.stage, self.fsdp, self.expert, self.seq, self.model)

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class GenerateConfig:
    """Sampling config (feature parity with
    megatron_patch/generation/generation.py:109-353 and the eval adapter's
    greedy decode at evaluations/models/llava_multiimg_siglip_anyres.py:448)."""

    max_new_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    repetition_penalty: float = 1.0
    greedy: bool = True
    eos_token_ids: Tuple[int, ...] = (128001, 128009)
    seed: int = 0


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 1e-5
    min_lr: float = 0.0
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10614
    schedule: str = "cosine"  # cosine | linear | constant


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 16384
    global_batch_size: int = 128
    micro_batch_size: int = 1
    # (start, increment, ramp_samples): global batch ramps from `start` to
    # global_batch_size in steps of `increment`, spending ramp_samples
    # uniformly across the increments (≙ Megatron --rampup-batch-size /
    # update_num_microbatches, megatron_patch/training.py:564-575)
    rampup_batch_size: Optional[Tuple[int, int, int]] = None
    train_steps: int = 10614
    eval_interval: int = 1000
    save_interval: int = 1000
    log_interval: int = 1
    seed: int = 1234
    remat: str = "full"  # none | selective | attn | full (decoder layer scan)
    # vision-tower recompute override; None = same as `remat`. The tower and
    # the decoder have different recompute/memory ratios (a 48-tile tower's
    # saved activations are small next to a 16k decoder's, but its recompute
    # is pure GEMM time), so a MIXED policy — e.g. remat="selective",
    # remat_vision="full" — buys decoder speed without the tower's memory.
    remat_vision: Optional[str] = None
    # chunked cross-entropy scan granularity (trainer.chunked_cross_entropy):
    # peak logits memory is B·loss_chunk·V; larger chunks = fewer scan steps
    loss_chunk: int = 1024
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    freeze_vision_tower: bool = False
    freeze_llm: bool = False
    freeze_perceiver: bool = False
    answer_loss_only: bool = True
    checkpoint_dir: str = "checkpoints"
    async_checkpoint: bool = True
    check_param_hash_interval: int = 0  # 0 = disabled
    exit_duration_mins: int = 0
    nan_check: bool = True


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def siglip_so400m_14_364() -> VisionConfig:
    """SigLIP-SO400M-patch14-364 as used by Leopard-LLaVA (README.md:22-25)."""
    return VisionConfig()


def llama3_1_8b() -> TextConfig:
    return TextConfig()


def llama2_7b() -> TextConfig:
    """Llama-2-7B (legacy text family, megatron_patch/model/llama2/)."""
    return TextConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_layers=32,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        rope_scaling=None,
        max_position_embeddings=4096,
    )


def clip_vit_large_336() -> VisionConfig:
    """clip-vit-large-patch14-336 tower (legacy CLIP path, 576 tokens/image;
    clip_encoder.py:74-315 — feature layer -2, CLS dropped)."""
    return VisionConfig(
        hidden_size=1024,
        intermediate_size=4096,
        num_layers=24,
        num_heads=16,
        image_size=336,
        patch_size=14,
        layer_norm_eps=1e-5,
        hidden_act="quick_gelu",
        use_class_token=True,
        pre_ln=True,
        patch_bias=False,
        drop_class_token=True,
        post_ln_sequence=False,
        feature_layer=-2,
    )


def mistral_7b() -> TextConfig:
    return TextConfig(
        vocab_size=32003,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=10000.0,
        rope_scaling=None,
        sliding_window=4096,
        max_position_embeddings=32768,
    )


def leopard_llava_8b() -> VLMConfig:
    return VLMConfig()


def idefics2_vision() -> VisionConfig:
    return VisionConfig(
        hidden_size=1152,
        intermediate_size=4304,
        num_layers=27,
        num_heads=16,
        image_size=980,
        patch_size=14,
        layer_norm_eps=1e-6,
    )


def leopard_idefics2_8b() -> VLMConfig:
    return VLMConfig(
        vision=idefics2_vision(),
        text=mistral_7b(),
        projector=ProjectorConfig(projector_type="none", input_size=4096),
        perceiver=PerceiverConfig(),
        anyres=AnyResConfig(tile_size=980, tile_budget=0, tokens_per_tile=64),
        image_token_id=32001,
        pixel_shuffle_factor=1,
        architecture="leopard_idefics2",
    )


def tiny_vlm(vocab_size: int = 512) -> VLMConfig:
    """Small config for tests; same topology, toy dims."""
    vision = VisionConfig(
        hidden_size=32,
        intermediate_size=64,
        num_layers=2,
        num_heads=4,
        image_size=56,
        patch_size=14,
        dtype="float32",
    )
    text = TextConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope_scaling=None,
        rope_theta=10000.0,
        dtype="float32",
    )
    proj = ProjectorConfig(input_size=vision.hidden_size * 4, hidden_size=64, dtype="float32")
    anyres = AnyResConfig(tile_size=56, tile_budget=6, tokens_per_tile=4)
    return VLMConfig(
        vision=vision,
        text=text,
        projector=proj,
        anyres=anyres,
        image_token_id=vocab_size - 1,
    )


def tiny_idefics2() -> VLMConfig:
    """Leopard-Idefics2's topology at toy widths, for tests and `--tiny`
    runs: a 2-layer NaViT tower at head dim 72 on a 6 × 6 patch table, a
    2-layer perceiver of 4 latents, and a 2-layer Mistral with its
    32,003-token vocabulary and a sliding window of 16."""
    vision = VisionConfig(hidden_size=144, intermediate_size=256, num_layers=2, num_heads=2,
                          image_size=84, patch_size=14, layer_norm_eps=1e-6, dtype="float32")
    text = TextConfig(vocab_size=32003, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                      rope_scaling=None, sliding_window=16,
                      max_position_embeddings=32768, dtype="float32")
    perceiver = PerceiverConfig(num_latents=4, num_layers=2, hidden_size=64, num_heads=4,
                                num_kv_heads=2, head_dim=16, intermediate_size=96,
                                rms_norm_eps=1e-6, dtype="float32")
    return VLMConfig(
        vision=vision, text=text, perceiver=perceiver,
        projector=ProjectorConfig(projector_type="none", input_size=64, hidden_size=64,
                                  dtype="float32"),
        anyres=AnyResConfig(tile_size=84, tile_budget=0, tokens_per_tile=4),
        image_token_id=32001, pixel_shuffle_factor=1, architecture="leopard_idefics2")


# ---------------------------------------------------------------------------
# Serialization / CLI overrides
# ---------------------------------------------------------------------------


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def from_dict(cls: type, data: dict) -> Any:
    kwargs = {}
    field_map = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        if key not in field_map:
            raise KeyError(f"unknown config field {cls.__name__}.{key}")
        f = field_map[key]
        sub = _resolve_dataclass(f.type)
        if sub is not None and isinstance(value, dict):
            kwargs[key] = from_dict(sub, value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_KNOWN = {}


def _resolve_dataclass(tp: Any):
    if isinstance(tp, str):
        if not _KNOWN:
            for obj in list(globals().values()):
                if is_dataclass(obj) and isinstance(obj, type):
                    _KNOWN[obj.__name__] = obj
        for name, obj in _KNOWN.items():
            if name in tp:
                return obj
        return None
    if is_dataclass(tp):
        return tp
    return None


def apply_overrides(cfg: Any, overrides: dict[str, Any]) -> Any:
    """Apply dotted-path overrides, e.g. {"text.num_layers": 4}."""
    for path, value in overrides.items():
        cfg = _set_path(cfg, path.split("."), value)
    return cfg


def _set_path(cfg: Any, parts: list[str], value: Any) -> Any:
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    child = getattr(cfg, parts[0])
    return dataclasses.replace(cfg, **{parts[0]: _set_path(child, parts[1:], value)})


def save_json(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_json(cls: type, path: str) -> Any:
    with open(path) as f:
        return from_dict(cls, json.load(f))
