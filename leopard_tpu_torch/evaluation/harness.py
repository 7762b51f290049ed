"""Evaluation harness: run a Leopard engine over normalized benchmark rows,
score per question type, aggregate shards, merge benchmark results (port of
leopard_tpu/evaluation/harness.py; the scoring, the shard split and the
file protocol are the JAX package's, line for line).

Behavioral spec: evaluations/models/llava_multiimg_siglip_anyres.py:364-514
(per-sample pipeline + per-type scoring), eval_utils.py group_acc (:187) and
merge_all_bench_results (:508), run_eval_llava_siglip_multiimg.sh shard loop.

The reference shards across GPUs with one process per device; here a single
process drives one card with batched, bucketed inference, and `shard`/
`num_shards` keep the reference's data sharding (one process per card).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from leopard_tpu_torch.evaluation.loaders import ANLS_DATASETS, read_jsonl, write_jsonl
from leopard_tpu_torch.evaluation.metrics import (
    CHOICE_SYMBOLS,
    anls,
    eval_multi_choice,
    eval_open,
    parse_multi_choice_response,
    parse_open_response,
    levenshtein,
    rouge_1_f,
    rouge_l_f,
)


def get_instruction(setting: str, ques_type: str) -> str:
    """eval_utils.py:104-119."""
    if ques_type == "multiple-choice":
        return {
            "cot": "First think step by step. Then answer with the letter of the correct option.",
            "direct": "Answer with the option's letter from the given choices directly.",
            "none": "",
        }[setting]
    return {
        "cot": "First think step by step. Then answer with a single word or phrase.",
        "direct": "Answer the question using a single word or phrase.",
        "none": "",
    }[setting]


def calculate_anls(gt: Sequence[str], pred: str) -> float:
    """eval_utils.py:60-74 (≥0.5 threshold on max similarity)."""
    if len(gt) == 0:
        return 1.0 if pred in ["", "none", "NA", "unanswerable", None, []] else 0.0
    if len(pred) == 0:
        return 0.0
    sims = [
        1 - _lev(g, pred) / max(len(g), len(pred)) for g in gt
    ]
    best = max(sims)
    return best if best >= 0.5 else 0.0


def _lev(a: str, b: str) -> int:
    return levenshtein(a, b)


def score_sample(
    dataset: str,
    ques_type: str,
    response: str,
    answers,
    options: Optional[Sequence[str]] = None,
):
    """Returns (correct, chosen, correct_anls) — the per-type scoring of
    llava_multiimg_siglip_anyres.py:455-483."""
    correct_anls = 0.0
    if ques_type == "multiple-choice":
        opts = options or []
        chosen = parse_multi_choice_response(
            response, CHOICE_SYMBOLS[: len(opts)],
            {s: o for s, o in zip(CHOICE_SYMBOLS[: len(opts)], opts)},
        )
        correct = eval_multi_choice(answers, chosen)
    elif ques_type == "open-ended":
        chosen = parse_open_response(response)
        correct = eval_open(answers, chosen)
        if dataset in ANLS_DATASETS:
            formatted = response.split("Answer: ")[-1].lower()
            gts = [a.lower() for a in (answers if isinstance(answers, list) else [answers])]
            correct_anls = calculate_anls(gts, formatted)
    elif ques_type == "captioning":
        chosen = response
        gold = answers[0] if isinstance(answers, list) else answers
        correct = rouge_l_f(gold.lower(), response.lower())
    elif ques_type == "webqa":
        chosen = response
        golds = answers if isinstance(answers, list) else [answers]
        correct = max(rouge_1_f(g.lower(), response.lower()) for g in golds)
    else:
        raise ValueError(f"unknown ques_type {ques_type}")
    return correct, chosen, correct_anls


@dataclass
class EvalRecord:
    correct: float
    chosen: object
    gold: object
    raw: str
    question: str
    image_type: Optional[str]
    multi_img: bool
    correct_anls: float

    def to_dict(self):
        return self.__dict__


def _score_row(dataset: str, row: dict, response: str) -> dict:
    correct, chosen, correct_anls = score_sample(
        dataset, row["ques_type"], response, row["answers"], row.get("options")
    )
    return EvalRecord(
        correct=float(correct),
        chosen=chosen,
        gold=row["answers"],
        raw=response,
        question=row["question"],
        image_type=row.get("image_type"),
        multi_img=len(row["images_path"]) > 1,
        correct_anls=correct_anls,
    ).to_dict()


def run_benchmark(
    rows: List[dict],
    infer_fn: Callable[[dict, str], str],
    dataset: str,
    setting: str = "direct",
    shard: int = 0,
    num_shards: int = 1,
    progress: bool = False,
) -> List[dict]:
    """Drive inference over (a shard of) normalized rows.

    infer_fn(row, instruction) → response string. Sharding matches
    eval_utils.split_shard (:84-90)."""
    shard_size = len(rows) // num_shards + 1
    rows = rows[shard * shard_size : (shard + 1) * shard_size]
    results = []
    for i, row in enumerate(rows):
        instruction = get_instruction(setting, row["ques_type"])
        response = infer_fn(row, instruction)
        results.append(_score_row(dataset, row, response))
        if progress and (i + 1) % 25 == 0:
            acc = sum(r["correct"] for r in results) / len(results)
            print(f"[{dataset}] {i+1}/{len(rows)} acc={acc:.4f}", flush=True)
    return results


def run_benchmark_batched(
    rows: List[dict],
    adapter,
    dataset: str,
    setting: str = "direct",
    shard: int = 0,
    num_shards: int = 1,
    batch_size: int = 8,
    progress: bool = False,
    prefetch: bool = True,
    stats: Optional[list] = None,
) -> List[dict]:
    """Batched evaluation loop.

    `adapter` must provide prepare(row, instruction) → PreparedSample and
    generate_prepared(List[PreparedSample]) → List[str] (see
    evaluation/adapter.py). Rows are prepared on the host, sorted by
    (tile-count bucket, prompt-length bucket) so each engine batch pads to a
    shared shape, and results are restored to input order before scoring,
    so scores are identical to the serial loop's.

    When the adapter also provides plan/materialize (two-phase preparation,
    evaluation/adapter.py::PlannedSample), the pixel work (PIL decode,
    tiling, uint8 arrays) runs in a prefetch thread that stays one batch
    ahead while the current batch runs on the card. That thread touches no
    device: every copy to the card and every launch stays on this thread,
    and the producer's exceptions are raised here. `prefetch=False` forces
    the eager path. `stats`, when given a list, gets one dict per batch:
    its rows (indices into the shard's rows), tile count, prompt bucket,
    the seconds this thread waited for the batch's pixels and the seconds
    its generate took."""
    shard_size = len(rows) // num_shards + 1
    rows = rows[shard * shard_size : (shard + 1) * shard_size]
    pipelined = (
        prefetch
        and hasattr(adapter, "plan")
        and hasattr(adapter, "materialize")
    )
    if pipelined:
        # phase 1 only: header reads + prompt build (cheap, sortable)
        prepared = [
            adapter.plan(row, get_instruction(setting, row["ques_type"]))
            for row in rows
        ]
    else:
        prepared = [
            adapter.prepare(row, get_instruction(setting, row["ques_type"]))
            for row in rows
        ]

    engine = getattr(adapter, "engine", None)
    if engine is not None:
        # the engine's own bucketing (with its round-up past the top bucket),
        # so the sort key matches the shape the engine pads each batch to
        seq_buckets, tile_buckets = engine.seq_buckets, engine.tile_buckets
        bucket = engine._bucket
    else:
        from leopard_tpu_torch.inference.engine import round_up

        seq_buckets = [512, 1024, 2048, 4096]
        tile_buckets = [1, 4, 8, 16, 32]

        def bucket(x: int, buckets) -> int:
            for bkt in buckets:
                if x <= bkt:
                    return bkt
            return round_up(x, buckets[-1])
    order = sorted(
        range(len(prepared)),
        key=lambda i: (
            bucket(prepared[i].n_tiles, tile_buckets),
            bucket(len(prepared[i].prompt), seq_buckets),
        ),
    )
    batches = [
        order[start : start + batch_size]
        for start in range(0, len(order), batch_size)
    ]
    responses: List[Optional[str]] = [None] * len(prepared)
    done = 0
    stop = None
    if pipelined:
        import queue
        import threading

        # maxsize=2: the producer stays one batch ahead (double buffering)
        # without hoarding pixel arrays for the whole run
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for idxs in batches:
                    if not put((idxs, [adapter.materialize(prepared[i]) for i in idxs])):
                        return
                put(None)
            except BaseException as e:  # raised again in the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def batch_iter():
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
    else:
        def batch_iter():
            for idxs in batches:
                yield idxs, [prepared[i] for i in idxs]

    try:
        it = batch_iter()
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            if item is None:
                break
            idxs, batch = item
            t1 = time.perf_counter()
            outs = adapter.generate_prepared(batch)
            t2 = time.perf_counter()
            for i, resp in zip(idxs, outs):
                responses[i] = resp
            done += len(idxs)
            if stats is not None:
                stats.append({
                    "indices": list(idxs),
                    "n_tiles": sum(s.n_tiles for s in batch),
                    "bucket": bucket(max(len(s.prompt) for s in batch), seq_buckets),
                    "wait_s": t1 - t0,
                    "generate_s": t2 - t1,
                })
            if progress:
                print(f"[{dataset}] {done}/{len(rows)} generated", flush=True)
    finally:
        if stop is not None:  # a failed batch: let the producer end
            stop.set()
            thread.join()
    return [_score_row(dataset, row, resp) for row, resp in zip(rows, responses)]


def group_acc(details: List[dict]) -> dict:
    """Aggregate shard details → accuracy report (eval_utils.py:187-246):
    overall acc, ANLS, multi/single-image and per-image-type breakdowns."""
    correct = sum(d["correct"] for d in details)
    correct_anls = sum(d.get("correct_anls") or 0.0 for d in details)
    total = len(details)
    stats = defaultdict(lambda: {"total": 0, "correct": 0.0})
    for d in details:
        key = "multi_img" if d.get("multi_img") else "single_img"
        stats[key]["total"] += 1
        stats[key]["correct"] += d["correct"]
        t = d.get("image_type")
        if t:
            stats[t]["total"] += 1
            stats[t]["correct"] += d["correct"]
    report = {
        "Acc": round(correct / total * 100, 2) if total else 0.0,
        "Total": total,
        "Correct": correct,
        "Acc_anls": round(correct_anls / total * 100, 2) if total else 0.0,
    }
    for t, c in stats.items():
        acc = c["correct"] / c["total"] if c["total"] else 0.0
        report[f"image type {t} acc"] = f"{acc:.2%}"
        report[f"image type {t} total"] = c["total"]
    return report


def merge_shard_files(result_dir: str, dataset: str, setting: str) -> dict:
    """Collect <shard>_<setting>_<dataset>_shard_details.jsonl files, write
    <dataset>_<setting>_acc.json + _details.jsonl (group_acc file protocol)."""
    suffix = f"{setting}_{dataset}_shard_details.jsonl"
    files = [f for f in os.listdir(result_dir) if f.endswith(suffix)]
    details: List[dict] = []
    for f in sorted(files):
        details.extend(read_jsonl(os.path.join(result_dir, f)))
    report = group_acc(details)
    with open(os.path.join(result_dir, f"{dataset}_{setting}_acc.json"), "w") as f:
        json.dump(report, f, indent=2)
    write_jsonl(os.path.join(result_dir, f"{dataset}_{setting}_details.jsonl"), details)
    return report


def merge_all_bench_results(result_dir: str) -> dict:
    """eval_utils.py:508-...: gather every *_acc.json into one summary."""
    out = {}
    for f in sorted(os.listdir(result_dir)):
        if f.endswith("_acc.json"):
            with open(os.path.join(result_dir, f)) as fh:
                out[f[: -len("_acc.json")]] = json.load(fh)
    with open(os.path.join(result_dir, "all_bench_results.json"), "w") as fh:
        json.dump(out, fh, indent=2)
    return out
