"""Leopard-Idefics2 training in the port against the JAX package, on the tiny
Idefics2 VLM of tests/test_torch_idefics2.py (window 16, rows of 46 and 40
tokens, so that the window bites), float32 on the CPU:

  - `make_train_step` with NaViT patch masks (images of ragged grids and an
    all-padding image, as `preprocess_idefics2` pads a batch) against the
    JAX package's `make_train_step` under `jax.jit`: step-1 loss and the
    gradients of every group (vision, perceiver, text), the loss and
    params after each of two steps, under "none", "full", "selective" and
    the mixed policy; `grad_accum_steps=2` with images and masks
    pre-stacked [accum, tiles, ...]; the frozen groups ("vision",
    "perceiver") at weight decay 0 and 0.1;
  - the port runs its tower and its decoder through the flash tier (the
    plain versions of K1 and K2 on the CPU, the window in K2's), the JAX
    package its dense tiers; the JAX side's recompute policy changes no
    number (tests/test_torch_remat.py holds that), so its one run without
    recompute is every port policy's reference;
  - the tower's tile ranges: computed once a forward and handed to every
    layer's K1 and K2 under each policy; padding patches' gradients exactly
    0 in the plain version;
  - a no-window twin gives other text gradients (the window bites);
  - the batch builder (`data/idefics2_batches.py`) against the JAX
    package's `build_idefics2_prompt`, `answer_loss_mask` and
    `preprocess_idefics2`, composed as examples/train_leopard_idefics2.py
    composes them, on rows the cut does not reach; on rows it does reach, the
    oracle: each row's image tokens are 4 × its kept images and the batch's
    images are the kept ones in order (the reference builder keeps every
    image and so hands later rows other rows' features).

Tolerances as tests/test_torch_train_step.py: loss rtol 1e-5; gradients
rtol 2e-4 and atol 2e-5 of the largest gradient; params atol LR / 100 with
Adam's eps 1e-4 (see there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from leopard_tpu import config as cfgs
from leopard_tpu.data import chat as jchat
from leopard_tpu.data import idefics2_processor as jproc
from leopard_tpu.training import trainer as jtrainer
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert.from_jax import jax_tree_from_state_dict, state_dict_from_jax
from leopard_tpu_torch.data.idefics2_batches import idefics2_batch, idefics2_batches
from leopard_tpu_torch.models import siglip as tsiglip
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.training import trainer as ttrainer
from tests.test_torch_idefics2 import (
    FAKE,
    IMG,
    CharTokenizer,
    exact_position_ids,
    idefics2_prompt,
    init_params,
    navit_images,
    tiny_idefics2,
)

torch.set_num_threads(2)
LR = 1e-2
EOU = 32002
POLICIES = [("none", None), ("full", None), ("selective", None), ("selective", "full")]
POLICY_IDS = ["none", "full", "selective", "mixed"]


class EouTokenizer(CharTokenizer):
    """CharTokenizer with Idefics2's <end_of_utterance> (32002) as one id."""

    def __call__(self, text, add_special_tokens=False):
        parts = text.split("<end_of_utterance>")
        ids = [1] if add_special_tokens else []
        for i, part in enumerate(parts):
            if i:
                ids.append(EOU)
            ids += super().__call__(part)["input_ids"]
        return {"input_ids": ids}


@pytest.fixture(scope="module", autouse=True)
def eager_rule_in_jax():
    """The jitted JAX tower takes the eager position-id rule (see
    tests/test_torch_idefics2.py)."""
    from leopard_tpu.models import siglip as jsiglip

    real = jsiglip.navit_position_ids
    jsiglip.navit_position_ids = exact_position_ids
    yield
    jsiglip.navit_position_ids = real


def port_cfg(window=16):
    """The port's tiny Idefics2 with both attentions on the flash tier."""
    cfg = tcfgs.tiny_idefics2()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="flash"),
        text=dataclasses.replace(cfg.text, long_seq_threshold=8, sliding_window=window))


def train_cfg(mod, remat="none", remat_vision=None, weight_decay=0.1):
    return mod.TrainConfig(
        remat=remat, remat_vision=remat_vision, loss_chunk=16,
        optimizer=mod.OptimizerConfig(lr=LR, warmup_steps=0, decay_steps=100, eps=1e-4,
                                      weight_decay=weight_decay, grad_clip=1.0))


def train_batch(seed=0):
    """Two rows of 48 slots: row 0 holds two images (grids 6 × 6 and 3 × 5)
    and 46 tokens, row 1 one image (4 × 2) and 40 tokens; the tile bucket
    adds an all-padding image. Loss weights on the text after the images."""
    rng = np.random.RandomState(seed)
    prompts = [idefics2_prompt(2, 24, rng, n_before=10), idefics2_prompt(1, 20, rng, n_before=13)]
    tokens = np.zeros((2, 48), np.int32)
    seg = np.zeros((2, 48), np.int32)
    weights = np.zeros((2, 48), np.float32)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)], seg[r, :len(p)] = p, 1
        weights[r, :len(p)] = np.arange(len(p)) > np.flatnonzero(p == FAKE).max()
    pixels, mask = navit_images([(6, 6), (3, 5), (4, 2), (0, 0)], seed)
    return dict(tokens=tokens, segment_ids=seg, loss_weights=weights, images=pixels,
                patch_mask=mask)


def accum_batch():
    """`train_batch` as two microbatches of one row: images and masks
    pre-stacked [2, 2, ...]; microbatch 1's second image is the padding."""
    b = train_batch()
    return {**b, "images": b["images"].reshape(2, 2, *b["images"].shape[1:]),
            "patch_mask": b["patch_mask"].reshape(2, 2, 6, 6)}


def leaves(tree):
    tree = {k: v for k, v in tree.items() if k != "projector"}  # JAX's unused leaves
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_steps(params, batch, steps, frozen=(), accum=1, weight_decay=0.1):
    """JAX: (losses, params) after each of `steps` jitted train steps."""
    jcfg = tiny_idefics2(cfgs)
    jtc = train_cfg(cfgs, weight_decay=weight_decay)
    state = jtrainer.create_train_state(params, jtc)
    step = jax.jit(jtrainer.make_train_step(jcfg, jtc, frozen=frozen, grad_accum_steps=accum))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, out = [], []
    for _ in range(steps):
        state, metrics = step(state, jbatch)
        losses.append(float(metrics["loss"]))
        out.append(leaves(jax.device_get(state.params)))
    return losses, out


def port_model(params, cfg):
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return model


def port_steps(params, batch, steps, cfg=None, frozen=(), accum=1, weight_decay=0.1,
               remat="none", remat_vision=None):
    """The port: step-1 (loss, grads as JAX leaves), then (losses, params)
    after each of `steps` train steps."""
    cfg = cfg or port_cfg()
    tc = train_cfg(tcfgs, remat, remat_vision, weight_decay)
    state = ttrainer.create_train_state(port_model(params, cfg), tc)
    step = ttrainer.make_train_step(cfg, tc, frozen=frozen, grad_accum_steps=accum)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = step.loss_and_grads(state, tbatch)
    first = (float(loss), leaves(jax_tree_from_state_dict(grads)))
    losses, out = [], []
    for _ in range(steps):
        state, metrics = step(state, tbatch)
        losses.append(float(metrics["loss"]))
        out.append(leaves(jax_tree_from_state_dict(state.params)))
    return first, losses, out


def assert_grads_close(got, want):
    assert got.keys() == want.keys()
    scale = max(float(np.abs(g).max()) for g in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=2e-5 * scale, err_msg=name)


def assert_params_close(got, want):
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=LR / 100, err_msg=name)


@pytest.fixture(scope="module")
def ref():
    """The weights, the batch, and JAX's step-1 loss and gradients and its
    two train steps."""
    jcfg = tiny_idefics2(cfgs)
    params = init_params(jcfg)
    batch = train_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtrainer.vlm_loss(
        p, jcfg, jbatch, jnp.float32, False, loss_chunk=16)[0]))(params)
    losses, after = jax_steps(params, batch, 2)
    return {"params": params, "batch": batch, "loss0": float(loss),
            "grads": leaves(jax.device_get(grads)), "losses": losses, "after": after}


@pytest.mark.parametrize("remat,remat_vision", POLICIES, ids=POLICY_IDS)
def test_train_step_matches_jax(ref, remat, remat_vision):
    (loss0, grads), losses, after = port_steps(ref["params"], ref["batch"], 2, remat=remat,
                                               remat_vision=remat_vision)
    np.testing.assert_allclose([loss0, *losses], [ref["loss0"], *ref["losses"]], rtol=1e-5)
    assert {k.split("'")[1] for k in grads} == {"vision", "perceiver", "text"}
    assert_grads_close(grads, ref["grads"])
    for got, want in zip(after, ref["after"]):
        assert_params_close(got, want)


def test_grad_accumulation_with_prestacked_masks_matches_jax(ref):
    batch = accum_batch()
    assert not batch["patch_mask"][1, 1].any()
    jlosses, jafter = jax_steps(ref["params"], batch, 1, accum=2)
    _, losses, after = port_steps(ref["params"], batch, 1, accum=2, remat="full")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert_params_close(after[0], jafter[0])
    # the accumulated loss is the whole batch's
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=1e-5)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_frozen_vision_and_perceiver_match_jax(ref, weight_decay):
    """Frozen groups get zero gradients and still go through AdamW: at
    decay 0 they stay bit-equal, at 0.1 they move by the decay alone."""
    frozen = ("vision", "perceiver")
    jlosses, jafter = jax_steps(ref["params"], ref["batch"], 2, frozen=frozen,
                                weight_decay=weight_decay)
    _, losses, after = port_steps(ref["params"], ref["batch"], 2, frozen=frozen,
                                  weight_decay=weight_decay, remat="full")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for got, want in zip(after, jafter):
        assert_params_close(got, want)
    start, decayed = leaves(ref["params"]), leaves(jtrainer._decay_mask(ref["params"]))
    final = after[-1]
    assert any(not np.array_equal(final[k], start[k]) for k in final if k.startswith("['text']"))
    for name, p in final.items():
        if name.startswith("['text']"):
            continue
        if weight_decay and decayed[name]:  # p (1 - lr wd)^2
            np.testing.assert_allclose(p, start[name] * (1 - LR * weight_decay) ** 2,
                                       rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(p, start[name], err_msg=name)


@pytest.mark.parametrize("remat", ["full", "attn", "selective"])
def test_tower_tile_ranges_once_a_forward(ref, monkeypatch, remat):
    """The tower computes its tile ranges once a forward, and every call of
    the K1 wrapper, in the forward and in the backward's recompute (where
    "attn" and "selective" hand back K1's saved output instead of running
    it), gets that one object; K2 reads the ranges its forward saved."""
    made, seen = [], []
    real_ranges, real_flash = tsiglip.tile_ranges, tsiglip.flash_attention

    def ranges(*a, **kw):
        made.append(real_ranges(*a, **kw))
        return made[-1]

    def flash(*a, ranges=None, **kw):
        seen.append(ranges)
        return real_flash(*a, ranges=ranges, **kw)

    monkeypatch.setattr(tsiglip, "tile_ranges", ranges)
    monkeypatch.setattr(tsiglip, "flash_attention", flash)
    cfg = port_cfg()
    tc = train_cfg(tcfgs, remat)
    step = ttrainer.make_train_step(cfg, tc)
    state = ttrainer.create_train_state(port_model(ref["params"], cfg), tc)
    step.loss_and_grads(state, {k: torch.from_numpy(v) for k, v in ref["batch"].items()})
    assert len(made) == 1 and len(seen) == 2 * cfg.vision.num_layers
    assert all(r is made[0] for r in seen)


def test_padding_patches_get_zero_gradients(ref):
    """Through the tower's flash tier (the plain K1/K2) and the perceiver:
    every gradient finite, the pixels of padding patches (the all-padding
    image whole) exactly 0."""
    cfg = port_cfg()
    model = port_model(ref["params"], cfg)
    pixels = torch.from_numpy(ref["batch"]["images"]).requires_grad_()
    mask = torch.from_numpy(ref["batch"]["patch_mask"])
    model.encode_images(pixels, mask, remat="full").square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    pix_mask = mask.repeat_interleave(14, 1).repeat_interleave(14, 2)[:, None]
    assert torch.isfinite(pixels.grad).all()
    assert (pixels.grad * ~pix_mask).abs().max() == 0
    assert (pixels.grad * pix_mask).abs().max() > 0


def test_window_bites_in_the_gradients(ref):
    """A no-window twin on the same weights gives other text gradients: rows
    of 46 and 40 tokens pass the window of 16."""
    (_, grads), _, _ = port_steps(ref["params"], ref["batch"], 0, remat="full")
    (_, unwindowed), _, _ = port_steps(ref["params"], ref["batch"], 0, cfg=port_cfg(None),
                                       remat="full")
    text = [k for k in grads if k.startswith("['text']['layers']")]
    diff = max(float(np.abs(grads[k] - unwindowed[k]).max() / np.abs(grads[k]).max())
               for k in text)
    assert diff > 1e-2


# --- the batch builder --------------------------------------------------------

LATENTS = 4


def write_rows(tmp_path, specs, seed=0):
    """Manifest rows: (images, (w, h) of each, characters of text before and
    after them, answer characters) → {"text", "images"} with PNGs."""
    rng = np.random.RandomState(seed)
    rows = []
    for i, (sizes, before, answer) in enumerate(specs):
        names = []
        for j, (w, h) in enumerate(sizes):
            names.append(f"{i}_{j}.png")
            Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                tmp_path / names[-1])
        text = ("User:" + "x" * before + "<image>" * len(sizes) + " what?<end_of_utterance>\n"
                "Assistant: " + "y" * answer + "<end_of_utterance>\n")
        rows.append({"text": text, "images": names})
    return rows


def reference_batch(rows, tokenizer, seq_len, image_folder):
    """examples/train_leopard_idefics2.py's batch composition, in the JAX
    package's functions (the cut keeps every image of a row)."""
    b = len(rows)
    toks = np.zeros((b, seq_len), np.int32)
    seg = np.zeros((b, seq_len), np.int32)
    weights = np.zeros((b, seq_len), np.float32)
    flat = []
    for r, row in enumerate(rows):
        images = [Image.open(f"{image_folder}/{p}").convert("RGB") for p in row["images"]]
        ids = jchat.build_idefics2_prompt(tokenizer, row["text"], len(images),
                                          image_seq_len=LATENTS, image_token_id=IMG,
                                          fake_token_id=FAKE)
        n = min(len(ids), seq_len)
        toks[r, :n], seg[r, :n] = ids[:n], 1
        weights[r, :n] = jproc.answer_loss_mask(ids[:n])
        flat += images
    pix, _, patch_mask = jproc.preprocess_idefics2(flat)
    return {"tokens": toks, "segment_ids": seg, "loss_weights": weights, "images": pix,
            "patch_mask": patch_mask}


def test_batches_match_the_reference_composition(tmp_path):
    rows = write_rows(tmp_path, [(((40, 30), (20, 50)), 5, 12), (((60, 60),), 0, 20),
                                 ((), 3, 9)])
    tok, cfg = EouTokenizer(), tcfgs.tiny_idefics2()
    got = next(idefics2_batches(rows, tok, cfg, 3, 96, str(tmp_path)))
    want = reference_batch(rows, tok, 96, str(tmp_path))
    assert (got["loss_weights"].sum(1) > 0).all()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_batches_cycle_and_start(tmp_path):
    rows = write_rows(tmp_path, [(((30, 30),), i, 5 + i) for i in range(3)])
    tok, cfg = EouTokenizer(), tcfgs.tiny_idefics2()
    it = idefics2_batches(rows, tok, cfg, 2, 64, str(tmp_path))
    first = [next(it) for _ in range(3)]  # rows 0-1, 2-0, 1-2
    resumed = next(idefics2_batches(rows, tok, cfg, 2, 64, str(tmp_path), start=4))
    for k, v in first[2].items():
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)
    np.testing.assert_array_equal(first[1]["tokens"][1], first[0]["tokens"][0])


def test_a_cut_keeps_only_whole_image_blocks(tmp_path):
    """seq_len 40: row 0's cut falls inside its second image block, row 1's
    before its only block, row 2 fits. Each row keeps the images whose
    blocks it holds whole, and the batch's images are those, in order; the
    reference composition keeps all five and misaligns the splice."""
    specs = [(((40, 30), (20, 50), (30, 30)), 25, 4), (((50, 40),), 45, 4),
             (((30, 40),), 2, 6)]
    rows = write_rows(tmp_path, specs)
    tok, cfg = EouTokenizer(), tcfgs.tiny_idefics2()
    got = idefics2_batch(rows, tok, cfg, 40, str(tmp_path))
    per_row = (got["tokens"] == IMG).sum(1)
    assert per_row.tolist() == [LATENTS, 0, LATENTS]
    kept = [Image.open(tmp_path / rows[r]["images"][0]).convert("RGB") for r in (0, 2)]
    pix, _, mask = jproc.preprocess_idefics2(kept)
    np.testing.assert_array_equal(got["images"], pix)
    np.testing.assert_array_equal(got["patch_mask"], mask)
    assert (got["tokens"] == IMG).sum() == LATENTS * len(got["images"])
    # no row ends inside a block: a row's image tokens come in whole blocks
    for r in range(3):
        ids = got["tokens"][r][got["segment_ids"][r] == 1]
        runs = np.diff(np.flatnonzero(np.diff(np.r_[0, ids == IMG, 0])))[::2]
        assert (runs == LATENTS).all()
    want = reference_batch(rows, tok, 40, str(tmp_path))
    assert (want["tokens"] == IMG).sum() < LATENTS * len(want["images"])


def test_splice_gives_each_row_its_own_images(tmp_path, monkeypatch):
    """The feature rows a row's image tokens receive are its kept images'
    own, through `LeopardVLM.forward`'s splice."""
    rows = write_rows(tmp_path, [(((40, 30), (20, 50), (30, 30)), 25, 4), (((50, 40),), 45, 4),
                                 (((30, 40),), 2, 6)])
    cfg = tcfgs.tiny_idefics2()
    got = idefics2_batch(rows, EouTokenizer(), cfg, 40, str(tmp_path))
    model = port_model(init_params(tiny_idefics2(cfgs)), cfg).eval()
    captured = {}
    real = tvlm.splice_image_features

    def splice(embeds, features, is_image, row_offsets=None):
        captured.update(out=real(embeds, features, is_image, row_offsets), features=features)
        return captured["out"]

    monkeypatch.setattr(tvlm, "splice_image_features", splice)
    with torch.no_grad():
        model(torch.from_numpy(got["tokens"]), images=torch.from_numpy(got["images"]),
              patch_mask=torch.from_numpy(got["patch_mask"]))
    for r, image in ((0, 0), (2, 1)):
        at = torch.from_numpy(got["tokens"][r] == IMG)
        torch.testing.assert_close(captured["out"][r][at], captured["features"][image],
                                   rtol=0, atol=0)
