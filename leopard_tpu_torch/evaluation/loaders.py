"""Benchmark loaders (port of leopard_tpu/evaluation/loaders.py, line for
line): normalize 12 benchmarks to the common row schema
{"images_path": [...], "question": str (with <image> placeholders),
 "options": list|None, "answers": str|list, "ques_type": str}.

Behavioral spec: evaluations/*/load_*.py (e.g. load_mpdocvqa.py:1-42,
load_mmmu.py, load_textvqa.py). Each loader takes the benchmark's raw-data
root and returns rows; `write_normalized` dumps the same eval_<name>.jsonl
the reference's shard runners consume, so existing prepared files remain
compatible.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, List, Optional

from leopard_tpu_torch.evaluation.metrics import CHOICE_SYMBOLS, option_block

Row = Dict


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def read_jsonl(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def write_jsonl(path: str, rows) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _row(images, question, answers, ques_type="open-ended", options=None) -> Row:
    return {
        "images_path": images,
        "question": question,
        "options": options,
        "concated_options": option_block(options) if options else None,
        "answers": answers,
        "ques_type": ques_type,
    }


# --- multi-image, text-rich -------------------------------------------------


def load_mpdocvqa(root: str) -> List[Row]:
    """MP-DocVQA val.json: page_ids → one image per page."""
    data = read_json(os.path.join(root, "val.json"))["data"]
    rows = []
    for s in data:
        imgs = [os.path.join(root, "images", f"{p}.jpg") for p in s["page_ids"]]
        q = "<image>" * len(imgs) + " " + s["question"]
        rows.append(_row(imgs, q, s["answers"]))
    return rows


def load_dude(root: str) -> List[Row]:
    """DUDE: doc pages pre-extracted as images/val/{docId}_{page}.jpg."""
    ann = read_jsonl(os.path.join(root, "dude_val.jsonl"))
    rows = []
    for s in ann:
        rows.append(_row(s["images"], s["question"], s["answers"]))
    return rows


def load_slidevqa(root: str) -> List[Row]:
    """SlideVQA test decks: 20 slides per deck, ordered by slide number."""
    ann = read_jsonl(os.path.join(root, "annotations", "qa", "test.jsonl"))
    rows = []
    for s in ann:
        deck_dir = os.path.join(root, "images", s["deck_name"])
        if not os.path.isdir(deck_dir):
            continue
        imgs = [f for f in os.listdir(deck_dir) if f.endswith(".jpg")]
        if len(imgs) != 20:
            continue
        imgs = sorted(
            imgs, key=lambda x: int(re.search(r"-(\d+)-\d+\.jpg", x).group(1))
        )
        imgs = [os.path.join(deck_dir, f) for f in imgs]
        rows.append(_row(imgs, s["question"], s["answer"]))
    return rows


def load_multichart(root: str) -> List[Row]:
    data = read_jsonl(os.path.join(root, "multichartqa_test.jsonl"))
    rows = []
    for s in data:
        imgs = [os.path.join(root, p) for p in s["images_path"]]
        rows.append(
            _row(imgs, s["question"], s["answers"],
                 ques_type=s.get("ques_type", "open-ended"),
                 options=s.get("options"))
        )
    return rows


def load_multihiertt(root: str) -> List[Row]:
    data = read_json(os.path.join(root, "test.json"))
    rows = []
    for s in data:
        imgs = [os.path.join(root, "images", p) for p in s.get("tables", [])]
        q = s["qa"]["question"] if "qa" in s else s["question"]
        ans = s["qa"].get("answer") if "qa" in s else s.get("answers")
        rows.append(_row(imgs, q, ans))
    return rows


# --- single-image, text-rich --------------------------------------------------


def load_textvqa(root: str) -> List[Row]:
    data = read_json(os.path.join(root, "TextVQA_0.5.1_val.json"))["data"]
    return [
        _row(
            [os.path.join(root, "images", "train_images", f"{s['image_id']}.jpg")],
            f"<image> {s['question']}",
            s["answers"],
        )
        for s in data
    ]


def load_docvqa(root: str) -> List[Row]:
    data = read_json(os.path.join(root, "val_v1.0_withQT.json"))["data"]
    rows = []
    for s in data:
        img = s["image"].replace("documents/", "")
        rows.append(
            _row([os.path.join(root, "images", img)], f"<image> {s['question']}", s["answers"])
        )
    return rows


def load_visualwebbench(root: str) -> List[Row]:
    data = read_jsonl(os.path.join(root, "visualwebbench.jsonl"))
    rows = []
    for s in data:
        imgs = [os.path.join(root, p) for p in s["images_path"]]
        rows.append(
            _row(imgs, s["question"], s["answers"],
                 ques_type=s.get("ques_type", "open-ended"),
                 options=s.get("options"))
        )
    return rows


# --- general ------------------------------------------------------------------


def load_mmmu(root: str) -> List[Row]:
    """MMMU val parquet shards pre-extracted to images/ + mmmu_val.jsonl by
    tools/prepare_mmmu.py (the reference inlines the parquet extraction in
    load_mmmu.py; we keep raw parsing in tools/ and loading pure)."""
    data = read_jsonl(os.path.join(root, "mmmu_val.jsonl"))
    rows = []
    for s in data:
        imgs = [os.path.join(root, p) for p in s["images_path"]]
        q = s["question"]
        if q.count("<image>") > len(imgs):
            q = retain_first_k_images(q, len(imgs))
        rows.append(
            _row(imgs, q, s["answers"], ques_type=s["ques_type"], options=s.get("options"))
        )
    return rows


def load_mathvista(root: str) -> List[Row]:
    data = read_jsonl(os.path.join(root, "mathvista_testmini.jsonl"))
    rows = []
    for s in data:
        rows.append(
            _row([os.path.join(root, s["image"])], s["question"], s["answers"],
                 ques_type=s.get("ques_type", "open-ended"), options=s.get("options"))
        )
    return rows


def load_scienceqa(root: str) -> List[Row]:
    data = read_json(os.path.join(root, "problems.json"))
    rows = []
    for qid, s in data.items():
        if s.get("split") != "test" or not s.get("image"):
            continue
        img = os.path.join(root, "images", "test", qid, s["image"])
        q = f"<image> {s['question']}"
        options = s.get("choices")
        ans = CHOICE_SYMBOLS[s["answer"]] if options else s["answer"]
        rows.append(_row([img], q, ans, ques_type="multiple-choice", options=options))
    return rows


def load_mirb(root: str) -> List[Row]:
    data = read_jsonl(os.path.join(root, "mirb.jsonl"))
    rows = []
    for s in data:
        imgs = [os.path.join(root, p) for p in s["images_path"]]
        rows.append(
            _row(imgs, s["question"], s["answers"],
                 ques_type=s.get("ques_type", "multiple-choice"),
                 options=s.get("options"))
        )
    return rows


def retain_first_k_images(text: str, k: int) -> str:
    """Keep only the first k <image> placeholders (load_mmmu.py:14-23)."""
    positions = [m.start() for m in re.finditer(r"<image>", text)]
    if k >= len(positions):
        return text
    cut = positions[k - 1] + len("<image>") if k > 0 else 0
    return text[:cut] + re.sub(r"<image>", "", text[cut:])


LOADERS: Dict[str, Callable[[str], List[Row]]] = {
    "mpdocvqa": load_mpdocvqa,
    "dude": load_dude,
    "slidevqa": load_slidevqa,
    "multichart": load_multichart,
    "multihiertt": load_multihiertt,
    "textvqa": load_textvqa,
    "docvqa": load_docvqa,
    "visualwebbench": load_visualwebbench,
    "mmmu": load_mmmu,
    "mathvista": load_mathvista,
    "scienceqa": load_scienceqa,
    "mirb": load_mirb,
}

# datasets scored with ANLS in addition to open-ended accuracy
ANLS_DATASETS = ("mpdocvqa", "dude", "docvqa")


def load_benchmark(name: str, root: str) -> List[Row]:
    """Load a benchmark by name; falls back to a prepared eval_<name>.jsonl
    (the reference's normalized format) when present."""
    prepared = os.path.join(root, f"eval_{name}.jsonl")
    if os.path.exists(prepared):
        return read_jsonl(prepared)
    if name not in LOADERS:
        raise KeyError(f"unknown benchmark {name}; known: {sorted(LOADERS)}")
    return LOADERS[name](root)


def write_normalized(name: str, root: str, out_path: Optional[str] = None) -> str:
    rows = load_benchmark(name, root)
    out_path = out_path or os.path.join(root, f"eval_{name}.jsonl")
    write_jsonl(out_path, rows)
    return out_path
