"""`Engine(mesh=)` on the axes that serving replicates over (fsdp, seq,
stage) and on the expert axis, on gloo across spawned processes, against
the plain port engine and the JAX package's `Engine(mesh=build_mesh(...))`
on its 8-device CPU platform.

JAX's engine places its parameters by the rules on any mesh and never
places the batch, so every device computes the whole batch; its MoE layer
runs the single-device dispatch on expert-sharded banks. The port's engine
does the same arithmetic: every rank serves the whole batch, each expert
rank runs its own experts on it, and the combine is summed over the expert
group. So greedy tokens must equal the plain engine's and JAX's, on every
rank. Cases, one world of 2 for all of them:

  - fsdp=2, stage=2 and seq=2 on `tiny_vlm` (vocabulary 1,000, prompts with
    image tiles), seq=2 under `text.attn_impl` "auto" and "ring" (a cached
    prefill never takes the ring, in either package);
  - expert=2 on test_torch_moe.py's tiny MoE (4 experts, top 2), dropless,
    and capacity at factor 1.0, which drops: the dropped share of an
    uncached forward over the packed prompts must equal the plain model's.

The workers live at module level and never import JAX (tests/
test_torch_mesh.py); every rank writes its tokens, and the parent compares
them. int4 at model > 1 and the CLIP VLM at model=2 are in
tests/test_torch_serve_mesh_int4.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs

from test_torch_mesh import init_worker, run_world
from test_torch_moe_mesh_train import moe_cfg

torch.set_num_threads(2)
VOCAB = 1000  # the head's 1,000 columns cut to 500 a rank: padded to 512 under int4
ENGINE_KW = dict(seq_buckets=(32, 64), tile_buckets=(4,))
MAX_NEW = 6
# label: (mesh axes, model kind, Engine keywords)
CASES = {
    "fsdp2": (dict(fsdp=2), "dense", {}),
    "stage2": (dict(stage=2), "dense", {}),
    "seq2": (dict(seq=2), "dense", {}),
    "seq2_ring": (dict(seq=2), "dense_ring", {}),
    "expert2_dropless": (dict(expert=2), "moe_dropless", {}),
    "expert2_capacity": (dict(expert=2), "moe_capacity", {}),
    "model2_int4": (dict(model=2), "dense", dict(quantize="int4")),
    "model2_clip": (dict(model=2), "clip", {}),
    "fsdp2_model2_int4": (dict(fsdp=2, model=2), "dense", dict(quantize="int4")),
}
# a row-parallel int4 block taken from the wrong half of its packed bytes
FAULT = "model2_int4_wrong_half"


def clip_vision(mod, attn_impl="auto", dtype="float32"):
    """config.clip_vit_large_336's options at toy widths."""
    return mod.VisionConfig(
        hidden_size=64, intermediate_size=128, num_layers=3, num_heads=4, image_size=56,
        patch_size=14, layer_norm_eps=1e-5, hidden_act="quick_gelu", use_class_token=True,
        pre_ln=True, patch_bias=False, drop_class_token=True, post_ln_sequence=False,
        feature_layer=-2, dtype=dtype, attn_impl=attn_impl)


def tiny_clip_vlm(mod, attn_impl="auto", vocab_size=128256):
    """tiny_vlm with the CLIP tower, no pixel shuffle: 16 tokens a tile."""
    base = mod.tiny_vlm(vocab_size=vocab_size)
    return dataclasses.replace(
        base, vision=clip_vision(mod, attn_impl),
        projector=dataclasses.replace(base.projector, input_size=64),
        anyres=dataclasses.replace(base.anyres, tokens_per_tile=16), pixel_shuffle_factor=1)


def config(mod, kind):
    """The VLM config of a model kind, in either package's config module."""
    if kind.startswith("moe_"):
        return moe_cfg(mod, kind[4:])
    if kind == "clip":
        return tiny_clip_vlm(mod, vocab_size=VOCAB)
    cfg = mod.tiny_vlm(vocab_size=VOCAB)
    if kind == "dense_ring":
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, attn_impl="ring"))
    return cfg


def weights_kind(kind):
    """Which weights a kind loads: the MoE modes share theirs, as do the
    dense configs."""
    return {"dense_ring": "dense", "moe_capacity": "moe_dropless"}.get(kind, kind)


def requests(cfg, seed=0):
    """Two rows: text and image tiles (none for the MoE decoder, as in its
    JAX tests), and uint8 tiles."""
    rng = np.random.RandomState(seed)
    img = cfg.image_token_id
    t = cfg.anyres.tokens_per_tile

    def text(n):
        return list(rng.randint(1, img, size=n))

    if cfg.text.num_experts:
        return [np.array(text(n), np.int32) for n in (9, 14)], None
    s = cfg.vision.image_size
    prompts = [np.array(text(3) + [img] * (2 * t) + text(5), np.int32),
               np.array(text(4) + [img] * t + text(7), np.int32)]
    return prompts, rng.randint(0, 256, (3, s, s, 3)).astype(np.uint8)


def load_model(cfg, data, kind):
    from leopard_tpu_torch.models.vlm import LeopardVLM

    model = LeopardVLM(cfg)
    pre = f"{weights_kind(kind)}/"
    model.load_state_dict({k[len(pre):]: torch.from_numpy(data[k]) for k in data.keys()
                           if k.startswith(pre)}, strict=True)
    return model.eval()


def generate(engine, cfg):
    from leopard_tpu_torch.config import GenerateConfig

    prompts, images = requests(cfg)
    gen = GenerateConfig(max_new_tokens=MAX_NEW, greedy=True, eos_token_ids=(999999,))
    return np.stack(engine.generate(prompts, images=images, gen_cfg=gen).tokens)


@torch.inference_mode()
def dropped(engine, cfg):
    """The MoE layers' dropped share (the worst layer's) over one uncached
    forward of the packed prompts, as the engine's model routes them."""
    tokens, seg, _, _ = engine._pack(requests(cfg)[0])
    _, _, aux = engine.model(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg),
                             return_aux=True)
    return float(aux["fraction_dropped"])


def _wrong_half(int4_block):
    """int4_block with a row block's nibbles read from the other half of
    each byte: the fault the token check must catch."""
    def faulty(w, dim, start, length):
        leaves = int4_block(w, dim, start, length)
        if dim == "rows":
            q4 = leaves["q4"]
            leaves["q4"] = (q4 >> 4) | ((q4 & 15) << 4)
        return leaves
    return faulty


def _worker(rank, world, store, labels, path, out):
    import torch.distributed as dist

    from leopard_tpu_torch.config import MeshConfig
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.ops import quant
    from leopard_tpu_torch.parallel.mesh import build_mesh

    init_worker(rank, world, store, dict(data=world))
    data = np.load(path)
    saved = {}
    for label in labels:
        mesh_kw, kind, kw = CASES["model2_int4" if label == FAULT else label]
        cfg = config(tcfgs, kind)
        mesh = build_mesh(MeshConfig(**mesh_kw), "cpu")
        real = quant.int4_block
        if label == FAULT and rank == 1:
            quant.int4_block = _wrong_half(real)
        try:
            engine = Engine(cfg, load_model(cfg, data, kind), mesh=mesh, **ENGINE_KW, **kw)
        finally:
            quant.int4_block = real
        saved[f"{label}/tokens"] = generate(engine, cfg)
        if kind.startswith("moe_"):
            saved[f"{label}/dropped"] = dropped(engine, cfg)
    np.savez(f"{out}-{rank}.npz", **saved)
    dist.destroy_process_group()


def weights(kinds):
    """{"<kind>/<name>": fp32 array} of each kind's weights: the JAX init,
    moved by `state_dict_from_jax`; and the JAX params themselves."""
    import jax

    from leopard_tpu import config as cfgs
    from leopard_tpu.models import vlm as jvlm
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax

    arrays, params = {}, {}
    for kind in sorted({weights_kind(k) for k in kinds}):
        p = jax.device_get(jvlm.init_params(config(cfgs, kind), jax.random.PRNGKey(2)))
        params[kind] = p
        for k, v in state_dict_from_jax(p, config(tcfgs, kind)).items():
            arrays[f"{kind}/{k}"] = v.numpy()
    return arrays, params


def references(labels, arrays, params):
    """Per case: the plain port engine's tokens (and dropped share) and JAX's
    `Engine(mesh=)` tokens."""
    import jax

    from leopard_tpu import config as cfgs
    from leopard_tpu.inference.engine import Engine as JaxEngine
    from leopard_tpu.parallel.mesh import build_mesh as jax_mesh
    from leopard_tpu_torch.inference.engine import Engine

    out = {}
    for label in labels:
        mesh_kw, kind, kw = CASES[label]
        tcfg, jcfg = config(tcfgs, kind), config(cfgs, kind)
        plain = Engine(tcfg, load_model(tcfg, arrays, kind), **ENGINE_KW, **kw)
        out[f"{label}/plain"] = generate(plain, tcfg)
        if kind.startswith("moe_"):
            out[f"{label}/plain_dropped"] = dropped(plain, tcfg)
        mc = cfgs.MeshConfig(**mesh_kw)
        jeng = JaxEngine(jcfg, params[weights_kind(kind)],
                         mesh=jax_mesh(mc, jax.devices()[:mc.num_devices]), **ENGINE_KW, **kw)
        prompts, images = requests(jcfg)
        gen = cfgs.GenerateConfig(max_new_tokens=MAX_NEW, greedy=True, eos_token_ids=(999999,))
        out[f"{label}/jax"] = np.stack(jeng.generate(prompts, images=images, gen_cfg=gen).tokens)
    return out


def run_cases(tmp_path, labels, world=2):
    """Every rank's outputs of `labels` ({rank: npz}) and the references."""
    arrays, params = weights([CASES["model2_int4" if x == FAULT else x][1] for x in labels])
    path, out = str(tmp_path / "weights.npz"), str(tmp_path / "out")
    np.savez(path, **arrays)
    run_world(_worker, world, tmp_path, list(labels), path, out)
    got = {r: np.load(f"{out}-{r}.npz") for r in range(world)}
    return got, references([x for x in labels if x != FAULT], arrays, params)


LABELS = ("fsdp2", "stage2", "seq2", "seq2_ring", "expert2_dropless", "expert2_capacity")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("serve_mesh"), LABELS)


def assert_case(runs, label):
    got, ref = runs
    want = ref[f"{label}/plain"]
    np.testing.assert_array_equal(ref[f"{label}/jax"], want, err_msg=f"{label}: JAX vs port")
    for rank, out in got.items():
        np.testing.assert_array_equal(out[f"{label}/tokens"], want,
                                      err_msg=f"{label}: rank {rank}")


@pytest.mark.parametrize("label", LABELS)
def test_engine_on_mesh_matches_plain_and_jax(runs, label):
    assert_case(runs, label)


def test_capacity_drops_equal_the_plain_dispatch(runs):
    """expert=2, capacity 1.0: the dispatch drops, and each rank's model
    drops the share the single-device dispatch does."""
    got, ref = runs
    want = ref["expert2_capacity/plain_dropped"]
    assert want > 0
    for out in got.values():
        assert float(out["expert2_capacity/dropped"]) == pytest.approx(want, rel=1e-6)
        assert float(out["expert2_dropless/dropped"]) == 0.0


class _MeshShape:
    """What `check_divisible` reads of a mesh: its axis names and sizes."""

    def __init__(self, **sizes):
        from leopard_tpu_torch.parallel.mesh import AXIS_ORDER

        self.mesh_dim_names = AXIS_ORDER
        self.sizes = [sizes.get(a, 1) for a in AXIS_ORDER]

    def size(self, dim=None):
        return self.sizes[dim]


@pytest.mark.parametrize("sizes,ok", [
    (dict(fsdp=2, seq=2, stage=2, data=2), True), (dict(model=2, expert=4), True),
    (dict(model=4), False), (dict(expert=3), False)],
    ids=["replicated_axes", "model2_expert4", "model4_kv_heads", "expert3"])
def test_serving_refuses_only_what_it_cannot_place(sizes, ok):
    """`Engine(mesh=)` checks the mesh with `check_divisible` alone: it
    refuses a model axis that does not divide the heads (tiny MoE: 2 kv
    heads) and an expert axis that does not divide the experts (4); a seq
    axis needs no ring (training's check would refuse seq=2 here)."""
    from leopard_tpu_torch.training.trainer import check_divisible, check_mesh_supported

    cfg = config(tcfgs, "moe_dropless")
    if ok:
        check_divisible(cfg, _MeshShape(**sizes))
    else:
        with pytest.raises(ValueError, match="divide"):
            check_divisible(cfg, _MeshShape(**sizes))
    if sizes.get("seq", 1) > 1:
        with pytest.raises(NotImplementedError, match="ring"):
            check_mesh_supported(cfg, _MeshShape(**sizes))
