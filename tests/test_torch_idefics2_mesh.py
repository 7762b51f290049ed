"""Leopard-Idefics2 under a device mesh (training/trainer.py::
make_train_step(mesh=), the perceiver tensor-parallel, parallel/sharding.py::
local_rows with whole images, inference/engine.py::Engine(mesh=),
cli/train_leopard_idefics2.py --mesh), on gloo across spawned processes,
against the JAX package's one-device step.

The model and batch are test_torch_idefics2_train.py's: the tiny Idefics2
(vocab 32,003, window 16) from the JAX init, two rows of 48 slots with three
NaViT images of ragged grids and an all-padding one; the tower and the
decoder on the flash tier (the plain versions of K1 and K2 on the CPU).
One world of two processes runs, one after the other:

  - one train step at data=2 (each rank one row and its whole images),
    model=2 (the perceiver's heads and MLP, the tower's, the decoder's, and
    the vocabulary of 32,003 rows in blocks of 16,002 and 16,001), fsdp=2
    (the same uneven vocabulary over fsdp) and seq=2 with
    `attn_impl="ring"` (Mistral's window across the ring's blocks): the
    loss rtol 1e-5, gradients rtol 2e-4 and atol 2e-5 of the largest, the
    updated params within LR / 100 (test_torch_idefics2_train.py's
    tolerances);
  - grad_accum_steps=2 at model=2, images and masks pre-stacked [accum,
    tiles, ...]: the loss and params of JAX's accumulating step; and at
    data=2 on two microbatches of two rows whose ranks take different image
    counts (`data_accum_batch`), so that local_rows cuts each microbatch
    and pads a rank's smaller one with a zero image;
  - a planted fault, the patch mask dropped from the ranks' rows, which the
    gradient check must fail;
  - Engine(mesh=) at model=2 and data=2: greedy tokens equal to the plain
    engine's on two requests with images and patch masks.

And `python -m torch.distributed.run --nproc_per_node=2 -m
leopard_tpu_torch.cli.train_leopard_idefics2 --mesh data=2`: the first
logged loss equals a direct one-process run's (rtol 1e-5).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs

from test_torch_mesh import init_worker, run_world

REPO = Path(__file__).resolve().parents[1]
LR = 1e-2
# label: (mesh, ring attention, grad_accum_steps, the patch mask dropped, batch)
CASES = {"data2": (dict(data=2), False, 1, False, "batch"),
         "model2": (dict(model=2), False, 1, False, "batch"),
         "fsdp2": (dict(fsdp=2), False, 1, False, "batch"),
         "seq2_ring": (dict(seq=2), True, 1, False, "batch"),
         "model2_accum2": (dict(model=2), False, 2, False, "accum"),
         "data2_accum2": (dict(data=2), False, 2, False, "daccum"),
         "fault_no_patch_mask": (dict(data=2), False, 1, True, "batch")}


def port_cfg(ring=False):
    """test_torch_idefics2_train.py's port config (both attentions on the
    flash tier, window 16), the decoder on the ring when asked."""
    cfg = tcfgs.tiny_idefics2()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="flash"),
        text=dataclasses.replace(cfg.text, long_seq_threshold=8, sliding_window=16,
                                 attn_impl="ring" if ring else "auto"))


def train_cfg(mod):
    return mod.TrainConfig(
        remat="full", loss_chunk=16,
        optimizer=mod.OptimizerConfig(lr=LR, warmup_steps=0, decay_steps=100, eps=1e-4,
                                      weight_decay=0.1, grad_clip=1.0))


def data_accum_batch():
    """grad_accum_steps=2 at data=2: two microbatches of two rows, images
    and masks pre-stacked [2, 4, ...]. Microbatch 0 is train_batch (rows of
    2 and 1 images, then the padding image), microbatch 1 rows of 1 and 2
    images: data rank 0 takes 2 and 1 images, rank 1 takes 1 and 2, and
    local_rows pads each rank's smaller microbatch with a zero image."""
    from test_torch_idefics2 import FAKE, idefics2_prompt, navit_images
    from test_torch_idefics2_train import train_batch

    first = train_batch()
    rng = np.random.RandomState(7)
    prompts = [idefics2_prompt(1, 22, rng, n_before=8), idefics2_prompt(2, 18, rng, n_before=12)]
    tokens = np.zeros((2, 48), np.int32)
    seg = np.zeros((2, 48), np.int32)
    weights = np.zeros((2, 48), np.float32)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)], seg[r, :len(p)] = p, 1
        weights[r, :len(p)] = np.arange(len(p)) > np.flatnonzero(p == FAKE).max()
    pixels, mask = navit_images([(5, 3), (2, 6), (6, 4), (0, 0)], 7)
    second = dict(tokens=tokens, segment_ids=seg, loss_weights=weights, images=pixels,
                  patch_mask=mask)
    return {k: (np.stack if k in ("images", "patch_mask") else np.concatenate)(
        [first[k], second[k]]) for k in first}


def _worker(rank, world, store, path, out):
    import torch.distributed as dist

    from leopard_tpu_torch.config import MeshConfig
    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.parallel.mesh import build_mesh
    from leopard_tpu_torch.parallel.sharding import like, local_rows
    from leopard_tpu_torch.training import trainer

    init_worker(rank, world, store, dict(data=world))
    data = np.load(path)
    full = {k[5:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("full/")}
    saved = {}
    for label, (mesh_kw, ring, accum, fault, name) in CASES.items():
        mesh = build_mesh(MeshConfig(**mesh_kw), "cpu")
        cfg = port_cfg(ring)
        prefix = name + "/"
        batch = {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith(prefix)}
        if fault:
            batch.pop("patch_mask")
        model = LeopardVLM(cfg)
        model.load_state_dict(full)
        tc = train_cfg(tcfgs)
        state = trainer.create_train_state(model, tc, mesh=mesh)
        step = trainer.make_train_step(cfg, tc, mesh=mesh, grad_accum_steps=accum)
        mine = local_rows(batch, mesh, cfg.perceiver.num_latents, cfg.image_token_id,
                          accum=accum)
        if name == "daccum":  # the microbatch of one image took a zero image
            assert mine["images"].shape[:2] == (2, 2)
            padded = mine["patch_mask"][1 - rank]
            assert padded[0].any() and not padded[1].any()
        loss, _, grads = step.loss_and_grads(state, mine)
        grads = {k: like(state.params[k], g).full_tensor() for k, g in grads.items()}
        state, metrics = step(state, mine)
        assert float(metrics["loss"]) == float(loss)
        saved[f"{label}/loss"] = float(loss)
        saved.update({f"{label}/g/{k}": v.numpy() for k, v in grads.items()})
        saved.update({f"{label}/p/{k}": p.full_tensor().numpy() for k, p in state.params.items()})
    saved.update(_engines(data, full))
    if rank == 0:
        np.savez(out, **saved)
    dist.destroy_process_group()


def _engines(data, full):
    """Engine(mesh=) at model=2 and data=2 against the plain engine."""
    from leopard_tpu_torch.config import GenerateConfig, MeshConfig
    from leopard_tpu_torch.inference.engine import Engine
    from leopard_tpu_torch.models.vlm import LeopardVLM
    from leopard_tpu_torch.parallel.mesh import build_mesh

    world = torch.distributed.get_world_size()
    cfg = tcfgs.tiny_idefics2()
    model = LeopardVLM(cfg)
    model.load_state_dict(full)
    gen = GenerateConfig(max_new_tokens=5, greedy=True, eos_token_ids=(999999,))
    prompts = [data["engine/prompt0"], data["engine/prompt1"]]
    kw = dict(seq_buckets=(32, 64), tile_buckets=(1, 2, 4))
    req = dict(images=data["engine/pixels"], patch_mask=data["engine/mask"], gen_cfg=gen)
    plain = Engine(cfg, model, **kw).generate(prompts, **req)
    out = {}
    for axis in ("model", "data"):
        mesh = build_mesh(MeshConfig(**{axis: world}), "cpu")
        got = Engine(cfg, model, mesh=mesh, **kw).generate(prompts, **req)
        for a, b in zip(got.tokens, plain.tokens):
            assert np.array_equal(a, b), (axis, a, b)
        out[f"engine/{axis}"] = np.stack(got.tokens)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results, and JAX's step-1 loss, gradients and params
    after one step (and after one accumulating step), as JAX leaves."""
    import jax
    import jax.numpy as jnp

    from leopard_tpu import config as cfgs
    from leopard_tpu.models import siglip as jsiglip
    from leopard_tpu.training import trainer as jtrainer
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
    from test_torch_idefics2 import exact_position_ids, idefics2_prompt, init_params, \
        navit_images, tiny_idefics2
    from test_torch_idefics2_train import accum_batch, jax_steps, leaves, train_batch

    real = jsiglip.navit_position_ids
    jsiglip.navit_position_ids = exact_position_ids  # test_torch_idefics2.py says why
    try:
        jcfg = tiny_idefics2(cfgs)
        params = init_params(jcfg)
        batch = train_batch()
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jtrainer.vlm_loss(
            p, jcfg, jbatch, jnp.float32, False, loss_chunk=16)[0]))(params)
        losses, after = jax_steps(params, batch, 1)
        accum_losses, accum_after = jax_steps(params, accum_batch(), 1, accum=2)
        daccum_losses, daccum_after = jax_steps(params, data_accum_batch(), 1, accum=2)
    finally:
        jsiglip.navit_position_ids = real
    ref = {"loss": float(loss), "grads": leaves(jax.device_get(grads)), "after": after[0],
           "accum_loss": accum_losses[0], "accum_after": accum_after[0],
           "daccum_loss": daccum_losses[0], "daccum_after": daccum_after[0]}
    assert losses[0] == pytest.approx(ref["loss"], rel=1e-6)

    tmp = tmp_path_factory.mktemp("idefics2_mesh")
    path, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    rng = np.random.RandomState(5)
    pixels, mask = navit_images([(6, 6), (3, 6), (5, 2)], 5)
    np.savez(path, **{f"full/{k}": v.numpy()
                      for k, v in state_dict_from_jax(params, port_cfg()).items()},
             **{f"batch/{k}": v for k, v in batch.items()},
             **{f"accum/{k}": v for k, v in accum_batch().items()},
             **{f"daccum/{k}": v for k, v in data_accum_batch().items()},
             **{"engine/prompt0": idefics2_prompt(2, 6, rng, n_before=24),
                "engine/prompt1": idefics2_prompt(1, 8, rng, n_before=30),
                "engine/pixels": pixels, "engine/mask": mask})
    run_world(_worker, 2, tmp, path, out)
    return np.load(out), ref


def _tree(got, label, group):
    from leopard_tpu_torch.convert.from_jax import jax_tree_from_state_dict
    from test_torch_idefics2_train import leaves

    key = f"{label}/{group}/"
    return leaves(jax_tree_from_state_dict(
        {k[len(key):]: torch.from_numpy(got[k]) for k in got.files if k.startswith(key)}))


def check_step(got, ref, label):
    """Step 1's loss and gradients and the params after it, against JAX."""
    from test_torch_idefics2_train import assert_grads_close, assert_params_close

    np.testing.assert_allclose(float(got[f"{label}/loss"]), ref["loss"], rtol=1e-5)
    grads = _tree(got, label, "g")
    assert {k.split("'")[1] for k in grads} == {"vision", "perceiver", "text"}
    assert_grads_close(grads, ref["grads"])
    assert_params_close(_tree(got, label, "p"), ref["after"])


@pytest.mark.parametrize("label", ["data2", "model2", "fsdp2", "seq2_ring"])
def test_idefics2_step_under_mesh_matches_jax(runs, label):
    got, ref = runs
    check_step(got, ref, label)


@pytest.mark.parametrize("label,key", [("model2_accum2", "accum"), ("data2_accum2", "daccum")])
def test_idefics2_grad_accumulation_under_mesh_matches_jax(runs, label, key):
    from test_torch_idefics2_train import assert_params_close

    got, ref = runs
    np.testing.assert_allclose(float(got[f"{label}/loss"]), ref[f"{key}_loss"], rtol=1e-5)
    assert_params_close(_tree(got, label, "p"), ref[f"{key}_after"])


def test_dropped_patch_mask_is_caught(runs):
    got, ref = runs
    with pytest.raises(AssertionError):
        check_step(got, ref, "fault_no_patch_mask")


@pytest.mark.parametrize("axis", ["model", "data"])
def test_idefics2_engine_under_mesh_equals_plain(runs, axis):
    """Asserted inside the world (`_engines`): the tokens it kept."""
    got, _ = runs
    tokens = got[f"engine/{axis}"]
    assert tokens.shape == (2, 5) and (tokens < 32003).all()


def test_local_rows_keeps_whole_images():
    """Rows take their own images and masks; a cut between two ranks' rows
    that falls inside an image is refused."""
    from leopard_tpu_torch.parallel.sharding import local_rows

    from test_torch_mesh import _Coord

    img, lat = 32001, 4
    tokens = torch.zeros((4, 12), dtype=torch.long)
    tokens[0, 1:9] = img      # two images
    tokens[1, 2:6] = img      # one
    tokens[3, 0:4] = img      # one; row 2 none
    batch = {"tokens": tokens, "images": torch.arange(4.0)[:, None],
             "patch_mask": torch.arange(4)[:, None] > 0}
    parts = [local_rows(batch, _Coord(dict(data=r), data=2), lat, img) for r in range(2)]
    assert parts[0]["images"][:, 0].tolist() == [0.0, 1.0, 2.0]
    assert parts[1]["images"][:, 0].tolist() == [3.0]
    assert parts[1]["patch_mask"][:, 0].tolist() == [True]
    cut = dict(batch, tokens=tokens.clone())
    cut["tokens"][1, 6] = img  # row 1 ends inside an image that runs on into row 2
    cut["tokens"][2, 0:3] = img
    cut["tokens"][3, 3] = 0
    with pytest.raises(ValueError, match="inside an image"):
        local_rows(cut, _Coord(dict(data=1), data=2), lat, img)
    # two microbatches of two rows: images [a, b] and [c, padding]; rank 1
    # takes row 1 (image b) and row 3 (image c)
    tokens = torch.zeros((4, 12), dtype=torch.long)
    tokens[0, 0:4] = tokens[1, 4:8] = tokens[3, 2:6] = img
    images = torch.tensor([[1.0, 2.0], [3.0, 0.0]])[..., None]
    stacked = local_rows({"tokens": tokens, "images": images, "patch_mask": images > 0},
                         _Coord(dict(data=1), data=2), lat, img, accum=2)
    assert stacked["tokens"].tolist() == tokens[[1, 3]].tolist()
    assert stacked["images"].shape == (2, 1, 1)
    assert stacked["images"][:, 0, 0].tolist() == [2.0, 3.0]
    assert stacked["patch_mask"].dtype == torch.bool


def write_mistral_tokenizer(directory):
    """A character-level tokenizer.json with Idefics2's specials at their
    ids (BOS 1, <image> 32001, <end_of_utterance> 32002, which opens and
    closes the turns that carry the loss), written without the network."""
    specials = {"<s>": 1, "</s>": 2, "<fake_token_around_image>": 32000, "<image>": 32001,
                "<end_of_utterance>": 32002}
    vocab = {chr(i): i for i in range(32, 127)}
    vocab.update({"\n": 10, "<unk>": 0, **specials})
    doc = {"version": "1.0", "truncation": None, "padding": None, "normalizer": None,
           "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                             "rstrip": False, "normalized": False, "special": True}
                            for t, i in specials.items()],
           "pre_tokenizer": {"type": "Split", "pattern": {"Regex": "[\\s\\S]"},
                             "behavior": "Isolated", "invert": False},
           "post_processor": None, "decoder": None,
           "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}
    directory.mkdir()
    (directory / "tokenizer.json").write_text(json.dumps(doc))
    (directory / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>"}))
    return str(directory)


def test_torchrun_mesh_first_loss_equals_direct_call(tmp_path):
    from PIL import Image

    from leopard_tpu_torch.cli import train_leopard_idefics2

    rng = np.random.RandomState(0)
    (tmp_path / "imgs").mkdir()
    rows = []
    for i in range(4):
        w, h = rng.randint(20, 90, size=2)
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "imgs" / f"{i}.png")
        rows.append({"text": f"User:<image>what is in {i}?<end_of_utterance>\nAssistant: "
                             f"noise number {i}<end_of_utterance>\n",
                     "images": [f"{i}.png"]})
    (tmp_path / "data.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    tok = write_mistral_tokenizer(tmp_path / "tok")

    def argv(run):
        return ["--manifest", str(tmp_path / "data.jsonl"), "--image-folder",
                str(tmp_path / "imgs"), "--tokenizer", tok, "--checkpoint-dir",
                str(tmp_path / run), "--seq-len", "64", "--global-batch-size", "2",
                "--train-steps", "1", "--lr", "1e-3", "--device", "cpu", "--tiny",
                "--freeze-perceiver"]

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         "--master_addr=localhost", f"--master_port={port}",
         "-m", "leopard_tpu_torch.cli.train_leopard_idefics2", *argv("mesh"),
         "--mesh", "data=2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done at step 1" in proc.stdout
    (sharded,) = [json.loads(x) for x in (tmp_path / "mesh" / "metrics.jsonl").open()]

    from leopard_tpu_torch.data.tokenizer import build_tokenizer

    train_leopard_idefics2.train_main(train_leopard_idefics2.parse_args(argv("direct")),
                                      tokenizer=build_tokenizer(tok, tokenizer_type="mistral",
                                                                image_token="<image>"))
    (direct,) = [json.loads(x) for x in (tmp_path / "direct" / "metrics.jsonl").open()]
    assert direct["tokens_in_loss"] > 0
    np.testing.assert_allclose(sharded["loss"], direct["loss"], rtol=1e-5)
    assert sharded["tokens_in_loss"] == direct["tokens_in_loss"]


class _CudaCoord:
    """A mesh's sizes and coordinate on the "cuda" device type, for the
    checks that read no process group."""

    device_type = "cuda"

    def __new__(cls, **sizes):
        from test_torch_mesh import _Coord

        mesh = _Coord({}, **sizes)
        mesh.device_type = cls.device_type
        return mesh


def test_windowed_ring_is_accepted_on_a_cuda_mesh():
    """Mistral's window over the ring at seq > 1 on the card: K1/K2 take
    each block's q − kv offset (tests/test_torch_ring_window.py holds the
    blocks against JAX's ring), so a cuda mesh no longer refuses it; the
    Idefics2 pipeline runs too (tests/test_torch_pp_idefics2.py)."""
    from leopard_tpu_torch.training import trainer

    for sizes in (dict(seq=2), dict(seq=4, model=2)):
        assert trainer.check_mesh_supported(port_cfg(ring=True), _CudaCoord(**sizes)) is None


@pytest.mark.parametrize("case", ["experts_do_not_divide", "perceiver_heads", "cli_expert",
                                  "cli_stage"])
def test_what_stays_refused(case):
    """What ROADMAP still lists is refused when the step is built."""
    from leopard_tpu_torch.cli import start_mesh
    from leopard_tpu_torch.training import trainer

    tc = train_cfg(tcfgs)
    if case == "experts_do_not_divide":
        cfg = tcfgs.tiny_vlm()
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_experts=4))
        with pytest.raises(ValueError, match="4 experts must divide over expert-axis size 3"):
            trainer.make_train_step(cfg, tc, mesh=_CudaCoord(expert=3))
    elif case == "perceiver_heads":
        cfg = port_cfg()
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, num_heads=8))
        with pytest.raises(ValueError, match="perceiver heads"):
            trainer.make_train_step(cfg, tc, mesh=_CudaCoord(model=8))
    else:
        axis = case.split("_")[1]
        with pytest.raises(SystemExit, match=f"--mesh {axis}"):
            start_mesh(f"{axis}=2", torch.device("cpu"))
