"""The general traffic generator: serving requests and training batches from
a traffic mix's parameters (traffic/<name>.json) and a configuration.

Two random streams, so that every seed runs the same work:
  - the mix's own `design_seed` fixes the sizes: documents, images and
    their kinds, tile counts, lengths, how samples pack into rows;
  - the run's `--seed` fixes the content (token ids, tile pixels, image
    pixels) and, for requests, the order in which the set is served.
    Training batches keep the design's order: their steps differ in cost
    (images' real patches), and a window of whole steps that took a
    seed's own selection of them would read the seed, not the program.
A prompt follows the layout of the port's eval prompt (data/chat.py,
layout "eval"): BOS, an opening of `open_tokens` ids, then per image a label
of `label_tokens` ids, a begin-image id, (tiles + 1) × tokens_per_tile image
tokens (the original and its grid tiles) and an end-image id, then the
question and a closing of `close_tokens` ids. Text ids are drawn from
`text_ids` [lo, hi): a vocabulary's ordinary ids.

A training row packs samples, Idefics2's SFT layout
(data/idefics2_batches.py, data/chat.py::build_idefics2_prompt): BOS, each
image a block of num_latents image tokens between fake-image tokens (two
adjacent images share one), the user's text, <end_of_utterance>, the
assistant prefix, the answer, <end_of_utterance>. The loss covers the
answer and the closing <end_of_utterance> (`answer_loss_mask`'s span);
positions restart in each sample; segment ids count the samples of a row
from 1; slots after the last sample are padding (segment 0).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from portbench.traffic.anyres import tiles_per_image


def _kinds(traffic: dict):
    return [(k[0], int(k[1]), int(k[2])) for k in traffic["image_kinds"]]


def _text(rng: np.random.Generator, lo_hi, n: int) -> np.ndarray:
    return rng.integers(lo_hi[0], lo_hi[1], size=n, dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------- serving --

def request_design(traffic: dict, cfg) -> List[dict]:
    """The sizes of the mix's request set, from its design seed alone: each
    request is a document of one of the mix's `documents` sources, drawn by
    their weights, with its page count drawn from the source's `pages`
    and every page of the source's (width, height)."""
    rng = np.random.default_rng(traffic["design_seed"])
    docs = traffic["documents"]
    share = np.asarray([d["weight"] for d in docs], np.float64)
    out = []
    for _ in range(traffic["requests"]):
        doc = docs[int(rng.choice(len(docs), p=share / share.sum()))]
        n_img = _draw(rng, doc["pages"])
        w, h = doc["page"]
        tiles = tiles_per_image([(w, h)] * n_img, cfg.anyres.tile_size,
                                cfg.anyres.tile_budget)
        q = _draw(rng, traffic["question_tokens"])
        out.append({"source": doc["name"], "tiles": tiles, "question": q})
    return out


def serving_requests(traffic: dict, cfg, seed: int) -> List[dict]:
    """The request set in the run's order: each {prompt int32 [S], tiles
    uint8 [crops, T, T, 3], crops, tokens, design index}."""
    design = request_design(traffic, cfg)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(design))
    chat = traffic["chat"]
    ids = traffic["text_ids"]
    per_tile = cfg.anyres.tokens_per_tile
    t = cfg.anyres.tile_size
    out = []
    for di in order.tolist():
        d = design[di]
        parts = [np.asarray([chat["bos"]], np.int32), _text(rng, ids, chat["open_tokens"])]
        for n in d["tiles"]:
            parts += [_text(rng, ids, chat["label_tokens"] + 1),
                      np.full((n + 1) * per_tile, cfg.image_token_id, np.int32),
                      _text(rng, ids, 1)]
        parts += [_text(rng, ids, d["question"]), _text(rng, ids, chat["close_tokens"])]
        prompt = np.concatenate(parts)
        crops = sum(n + 1 for n in d["tiles"])
        tiles = rng.integers(0, 256, size=(crops, t, t, 3), dtype=np.uint8)
        out.append({"prompt": prompt, "tiles": tiles, "crops": crops, "tokens": len(prompt),
                    "design": di})
    return out


# --------------------------------------------------------------- training --

def resize_for_navit(w: int, h: int, shortest: int, longest: int):
    """HF Idefics2's resize rule on (w, h), as data/idefics2_processor.py
    has it: the longest side down to `longest`, then up until the shortest
    reaches `shortest`, neither side past `longest`."""
    if max(w, h) > longest:
        scale = longest / max(w, h)
        w, h = int(w * scale), int(h * scale)
    if min(w, h) < shortest:
        scale = shortest / min(w, h)
        w, h = min(int(math.ceil(w * scale)), longest), min(int(math.ceil(h * scale)), longest)
    return max(w, 1), max(h, 1)


def _draw(rng, spec: dict) -> int:
    """A whole number in spec["range"] [lo, hi]: "uniform"; "lognormal"
    (`mean_log`, `sigma`, clipped to the range); "binomial", lo plus a
    binomial over hi − lo with the mean at `mean`."""
    lo, hi = spec["range"]
    if spec["dist"] == "uniform":
        return int(rng.integers(lo, hi + 1))
    if spec["dist"] == "lognormal":
        return int(min(max(round(rng.lognormal(spec["mean_log"], spec["sigma"])), lo), hi))
    if spec["dist"] == "binomial":
        return lo + int(rng.binomial(hi - lo, (spec["mean"] - lo) / (hi - lo)))
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def _sample_len(n_img: int, block: int, user: int, answer: int, prefix: int) -> int:
    img = n_img * block + (n_img + 1 if n_img else 0)
    return 1 + img + user + 1 + prefix + answer + 1


def batch_design(traffic: dict, cfg) -> List[dict]:
    """The batches' layout from the design seed: per row its samples
    (images, user and answer lengths), per image its real patch grid."""
    rng = np.random.default_rng(traffic["design_seed"])
    kinds = _kinds(traffic)
    block = cfg.perceiver.num_latents if cfg.perceiver is not None else 0
    p = cfg.vision.patch_size
    nav = traffic.get("navit", {})
    prefix = traffic["assistant_prefix_tokens"]
    s_len = traffic["row_tokens"]
    batches = []
    for _ in range(traffic["batches"]):
        rows = []
        for _ in range(traffic["rows"]):
            samples, used, left = [], 0, traffic.get("images_per_row", 0)
            while True:
                k = 0
                if left:
                    lo, hi = traffic["images_per_sample"]
                    k = min(int(rng.integers(lo, hi + 1)), left)
                text = _draw(rng, traffic["sample_text_tokens"])
                a_lo, a_hi = traffic["answer_share"]
                answer = max(1, int(round(text * rng.uniform(a_lo, a_hi))))
                user = max(1, text - answer)
                room = s_len - used
                need = _sample_len(k, block, user, answer, prefix)
                if need > room:  # cut the text, never an image block
                    spare = room - _sample_len(k, block, 1, 1, prefix)
                    if spare < traffic.get("min_cut_text", 16):
                        if left:
                            raise ValueError("a row cannot hold its images: raise row_tokens")
                        break
                    answer = max(1, min(answer, spare // 2))
                    user = 1 + spare - answer
                    need = _sample_len(k, block, user, answer, prefix)
                imgs = []
                for kind in rng.integers(0, len(kinds), size=k):
                    _, w0, h0 = kinds[int(kind)]
                    w, h = resize_for_navit(w0, h0, nav.get("shortest_edge", 378),
                                            nav.get("longest_edge", cfg.vision.image_size))
                    imgs.append((-(-h // p), -(-w // p)))
                samples.append({"images": imgs, "user": user, "answer": answer})
                used += need
                left -= k
                if used >= s_len:
                    break
            rows.append(samples)
        batches.append(rows)
    return batches


def train_batches(traffic: dict, cfg, seed: int, device) -> List[dict]:
    """The batches in the design's order, as tensors on `device`: tokens,
    segment_ids, positions int32 [B, S], loss_weights f32 [B, S], and with
    images `images` f32 [N, 3, side, side] (zeros outside each image's real
    pixels, side the tower's image size) and `patch_mask` bool [N, side/p,
    side/p]. Each carries `stats`: real tokens, tokens in the loss, each
    image's real patches, each row's sample lengths."""
    import torch

    design = batch_design(traffic, cfg)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = traffic["ids"]
    txt = traffic["text_ids"]
    block = cfg.perceiver.num_latents if cfg.perceiver is not None else 0
    prefix = traffic["assistant_prefix_tokens"]
    s_len, b = traffic["row_tokens"], traffic["rows"]
    side = cfg.vision.image_size
    p = cfg.vision.patch_size
    mean = torch.tensor(traffic.get("image_mean", (0.5, 0.5, 0.5)), device=device)[:, None, None]
    std = torch.tensor(traffic.get("image_std", (0.5, 0.5, 0.5)), device=device)[:, None, None]
    out = []
    for rows in design:
        toks = np.zeros((b, s_len), np.int32)
        seg = np.zeros((b, s_len), np.int32)
        pos = np.zeros((b, s_len), np.int32)
        wts = np.zeros((b, s_len), np.float32)
        grids, seg_lens = [], []
        for r, samples in enumerate(rows):
            at, lens = 0, []
            for si, smp in enumerate(samples):
                parts = [np.asarray([ids["bos"]], np.int32)]
                for j, g in enumerate(smp["images"]):
                    if j == 0:
                        parts.append(np.asarray([ids["fake_image"]], np.int32))
                    parts += [np.full(block, cfg.image_token_id, np.int32),
                              np.asarray([ids["fake_image"]], np.int32)]
                    grids.append(g)
                parts += [_text(rng, txt, smp["user"]), np.asarray([ids["eou"]], np.int32),
                          _text(rng, txt, prefix)]
                a0 = sum(len(x) for x in parts)
                parts += [_text(rng, txt, smp["answer"]), np.asarray([ids["eou"]], np.int32)]
                sample = np.concatenate(parts)
                n = len(sample)
                toks[r, at:at + n] = sample
                seg[r, at:at + n] = si + 1
                pos[r, at:at + n] = np.arange(n)
                wts[r, at + a0:at + n] = 1.0
                lens.append(n)
                at += n
            seg_lens.append(lens)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in (("tokens", toks), ("segment_ids", seg), ("positions", pos),
                              ("loss_weights", wts))}
        if grids:
            n_img = len(grids)
            mask = torch.zeros((n_img, side // p, side // p), dtype=torch.bool, device=device)
            pix = torch.rand((n_img, 3, side, side), generator=gen, device=device)
            pix = (pix - mean) / std
            for i, (gh, gw) in enumerate(grids):
                mask[i, :gh, :gw] = True
            pixel_mask = mask.repeat_interleave(p, 1).repeat_interleave(p, 2)
            batch["images"] = pix * pixel_mask[:, None]
            batch["patch_mask"] = mask
        real = int((seg != 0).sum())
        in_loss = float((wts[:, 1:] * (toks[:, 1:] != cfg.image_token_id)
                         * (seg[:, 1:] != 0)).sum())
        batch["stats"] = {"real_tokens": real, "loss_tokens": in_loss,
                          "image_patches": [gh * gw for gh, gw in grids], "grids": grids,
                          "segments": seg_lens}
        out.append(batch)
    return out
