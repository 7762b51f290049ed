"""The port's evaluation metrics, VQA metrics, loaders and the host parts of
the harness (leopard_tpu_torch/evaluation) against the JAX package's on the
same inputs. Both are plain Python, so every result must be exactly equal:
scores, parsed answers, rows and reports.

The multiple-choice parser draws from a module-level `random.Random(42)`
when no option matches; each package keeps its own, and both are reseeded
before each comparison that can reach it.
"""

import json
import os
import random

import pytest
from PIL import Image

from leopard_tpu.evaluation import harness as jharness
from leopard_tpu.evaluation import loaders as jloaders
from leopard_tpu.evaluation import metrics as jmetrics
from leopard_tpu.evaluation import vqa_metrics as jvqa
from leopard_tpu_torch.evaluation import harness as tharness
from leopard_tpu_torch.evaluation import loaders as tloaders
from leopard_tpu_torch.evaluation import metrics as tmetrics
from leopard_tpu_torch.evaluation import vqa_metrics as tvqa

WORDS = ["the", "cat", "dog", "(A)", "(B)", "C", " D ", "answer:", "is", "42", "3.14",
         "1,234", "New", "York", "paris", "fish", "so", "therefore", "=", "1e5", ".", ",",
         "Answer: ", "unanswerable", "none", "-7", "twenty", "don't", "it's"]


def _reseed():
    jmetrics._rng.seed(42)
    tmetrics._rng.seed(42)


def random_responses(n, seed):
    rng = random.Random(seed)
    return [" ".join(rng.choice(WORDS) for _ in range(rng.randint(0, 12))) for _ in range(n)]


RESPONSES = random_responses(200, 0)
PAIRS = [("kitten", "sitting"), ("", "abc"), ("abc", "abc"), ("hello", "hallo"),
         ("hello", "world"), ("", ""), ("Paris", "paris city"), *zip(RESPONSES[:40],
                                                                     RESPONSES[40:80])]


@pytest.mark.parametrize("fn", ["levenshtein", "anls", "rouge_l_f", "rouge_1_f"])
def test_pairwise_metrics(fn):
    for a, b in PAIRS:
        assert getattr(tmetrics, fn)(a, b) == getattr(jmetrics, fn)(a, b), (a, b)


def test_anls_score_and_calculate_anls():
    cases = [([], ""), ([], "something"), (["Paris"], ""), (["Paris", "paris city"], "paris"),
             (["hello"], "hallo"), (["hello"], "xyzzy"), ([], "unanswerable"),
             *[([r], s) for r, s in zip(RESPONSES[80:120], RESPONSES[120:160])]]
    for targets, pred in cases:
        assert tmetrics.anls_score(targets, pred) == jmetrics.anls_score(targets, pred)
        assert tharness.calculate_anls(targets, pred) == jharness.calculate_anls(targets, pred)


def test_option_block_and_retain_first_k_images():
    for opts in ([], ["x"], ["cat", "dog", "fish"], [str(i) for i in range(14)]):
        assert tmetrics.option_block(opts) == jmetrics.option_block(opts)
    for text in ("<image><image> q <image>", "a <image> b <image> c", "no images"):
        for k in range(4):
            assert (tloaders.retain_first_k_images(text, k)
                    == jloaders.retain_first_k_images(text, k))


@pytest.mark.parametrize("n_choices", [2, 4, 9])
def test_parse_multi_choice_random_branch(n_choices):
    """Seeded random responses: most match no option and draw from `_rng`,
    so the two packages agree only while their generators stay in step."""
    choices = tmetrics.CHOICE_SYMBOLS[:n_choices]
    index2ans = {c: WORDS[i + 1] for i, c in enumerate(choices)}
    _reseed()
    got = [tmetrics.parse_multi_choice_response(r, choices, index2ans) for r in RESPONSES]
    want = [jmetrics.parse_multi_choice_response(r, choices, index2ans) for r in RESPONSES]
    assert got == want
    assert tmetrics._rng.getstate() != random.Random(42).getstate()  # the branch ran
    # the JAX tests' cases
    opts = {"A": "cat", "B": "dog", "C": "fish"}
    for r, chosen in (("The answer is (B)", "B"), ("I think B ", "B"),
                      ("the animal shown in all images is a dog indeed", "B"),
                      ("(A) no wait (C)", "C")):
        assert tmetrics.parse_multi_choice_response(r, ["A", "B", "C"], opts) == chosen


def test_parse_open_and_eval():
    for r in RESPONSES + ["The total is 1,234 dollars", "Answer: 3.14", "the answer is 42",
                          "It is New York City", "no idea"]:
        got, want = tmetrics.parse_open_response(r), jmetrics.parse_open_response(r)
        assert sorted(map(repr, got)) == sorted(map(repr, want)), r
        for gold in (["42"], "New York", ["paris", "3.14"], "A"):
            assert tmetrics.eval_open(gold, got) == jmetrics.eval_open(gold, want)
            assert (tmetrics.eval_multi_choice(gold, r[:1])
                    == jmetrics.eval_multi_choice(gold, r[:1]))
    assert 1234.0 in tmetrics.parse_open_response("The total is 1,234 dollars")


def test_normalize_and_extract_numbers():
    for s in RESPONSES + [" 1,234 ", "x", "3.14e5"]:
        assert tmetrics.normalize_str(s) == jmetrics.normalize_str(s)
        assert tmetrics.extract_numbers(s) == jmetrics.extract_numbers(s)


VQA_CASES = ["The answer is 3,200 dollars.", "a Dog; maybe two?", "dont know", "Twenty-one",
             "he's got ten apples!", "none", "hello-world (test) [x]", "1.5 million",
             *RESPONSES[:60]]


def test_vqa_normalize():
    for c in VQA_CASES:
        assert tvqa.vqa_normalize(c) == jvqa.vqa_normalize(c), c
    assert tvqa.vqa_normalize("The answer is 3,200 dollars.") == "answer is 3200 dollars"


def _vqa_rows(seed):
    rng = random.Random(seed)
    return [{"pred_answer": rng.choice(VQA_CASES),
             "gt_answers": [rng.choice(VQA_CASES[:12]) for _ in range(10)]} for _ in range(30)]


@pytest.mark.parametrize("fn", ["textvqa_accuracy", "stvqa_accuracy", "stvqa_anls", "bleu4"])
def test_vqa_scores(fn):
    for rows in (_vqa_rows(1), _vqa_rows(2), [], [
            {"pred_answer": "a man riding a horse on the beach",
             "gt_answers": ["a man riding a horse on the beach",
                            "a person rides a horse near the ocean"]}]):
        assert getattr(tvqa, fn)(rows) == getattr(jvqa, fn)(rows)
    assert tvqa.vqa_answer_scores(VQA_CASES[:10]) == jvqa.vqa_answer_scores(VQA_CASES[:10])


SCORE_CASES = [
    ("mmmu", "multiple-choice", "(A)", "A", ["x", "y"]),
    ("docvqa", "open-ended", "Answer: hello", ["hello"], None),
    ("x", "captioning", "a cat", ["a cat"], None),
    ("visualwebbench", "webqa", "the red button", ["red button", "the blue one"], None),
    ("mpdocvqa", "open-ended", "it says 1,234", ["1234", "one"], None),
]


def test_score_sample_and_instructions():
    for setting in ("cot", "direct", "none"):
        for qt in ("multiple-choice", "open-ended"):
            assert tharness.get_instruction(setting, qt) == jharness.get_instruction(setting, qt)
    _reseed()
    cases = SCORE_CASES + [(ds, qt, r, ans, opts) for r in RESPONSES[:50]
                           for ds, qt, _, ans, opts in SCORE_CASES]
    for case in cases:
        assert tharness.score_sample(*case) == jharness.score_sample(*case), case


def _rows(n, seed):
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        qt = rng.choice(["open-ended", "multiple-choice", "captioning", "webqa"])
        opts = ["cat", "dog", "fish"] if qt == "multiple-choice" else None
        rows.append({"images_path": ["a.jpg"] * rng.randint(1, 3), "question": f"q{i}",
                     "options": opts, "answers": "B" if opts else ["the cat", "42"],
                     "ques_type": qt, "image_type": rng.choice([None, "chart", "doc"])})
    return rows


def test_run_benchmark_shards_and_reports(tmp_path):
    """The serial loop over each shard of 2 and 3 (the reference's split,
    len // n + 1), then the shard files merged, in both packages."""
    rows = _rows(23, 0)

    def infer(row, instruction):
        return RESPONSES[int(row["question"][1:])] + instruction[:5]

    for n in (1, 2, 3):
        outs = {}
        for name, h, ld in (("t", tharness, tloaders), ("j", jharness, jloaders)):
            d = tmp_path / f"{name}{n}"
            d.mkdir()
            _reseed()
            for shard in range(n):
                details = h.run_benchmark(rows, infer, "docvqa", "direct", shard=shard,
                                          num_shards=n)
                ld.write_jsonl(str(d / f"{shard}_direct_docvqa_shard_details.jsonl"), details)
            outs[name] = (h.merge_shard_files(str(d), "docvqa", "direct"),
                          h.merge_all_bench_results(str(d)), h.group_acc(details))
            files = sorted(os.listdir(d))
            outs[name + "files"] = {f: (d / f).read_text() for f in files}
        assert outs["t"] == outs["j"]
        assert outs["tfiles"] == outs["jfiles"]


def _png(path, w=20, h=10):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.new("RGB", (w, h), (1, 2, 3)).save(path, format="JPEG" if path.suffix == ".jpg"
                                               else "PNG")
    return str(path)


def _dump(path, data, jsonl=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        if jsonl:
            f.write("".join(json.dumps(r) + "\n" for r in data))
        else:
            json.dump(data, f)


def write_raw_layout(name, root):
    """A few rows of benchmark `name` in its raw layout under `root`."""
    mc = {"ques_type": "multiple-choice", "options": ["a", "b", "c"], "answers": "B"}
    if name == "mpdocvqa":
        _dump(root / "val.json", {"data": [
            {"page_ids": ["p1", "p2"], "question": "what?", "answers": ["x"]},
            {"page_ids": ["p3"], "question": "who?", "answers": ["y", "z"]}]})
    elif name == "dude":
        _dump(root / "dude_val.jsonl", [{"images": ["images/val/d_0.jpg"],
                                         "question": "<image> q", "answers": ["a"]}], True)
    elif name == "slidevqa":
        for deck, n in (("deckA", 20), ("deckB", 19)):  # deckB is skipped: not 20 slides
            for i in range(n):
                _png(root / "images" / deck / f"slide-{i + 1}-1024.jpg")
        _dump(root / "annotations" / "qa" / "test.jsonl", [
            {"deck_name": "deckA", "question": "q1", "answer": "x"},
            {"deck_name": "deckB", "question": "q2", "answer": "y"},
            {"deck_name": "missing", "question": "q3", "answer": "z"}], True)
    elif name in ("multichart", "visualwebbench", "mirb"):
        fname = {"multichart": "multichartqa_test.jsonl",
                 "visualwebbench": "visualwebbench.jsonl", "mirb": "mirb.jsonl"}[name]
        _dump(root / fname, [{"images_path": ["i/1.png", "i/2.png"], "question": "q",
                              "answers": ["x"]},
                             {"images_path": ["i/3.png"], "question": "m", **mc}], True)
    elif name == "multihiertt":
        _dump(root / "test.json", [{"tables": ["t1.png"], "qa": {"question": "q", "answer": 3}},
                                   {"question": "p", "answers": ["4"]}])
    elif name == "textvqa":
        _dump(root / "TextVQA_0.5.1_val.json", {"data": [
            {"image_id": "abc", "question": "what?", "answers": ["x"] * 10}]})
    elif name == "docvqa":
        _dump(root / "val_v1.0_withQT.json", {"data": [
            {"image": "documents/d1.png", "question": "q?", "answers": ["a", "b"]}]})
    elif name == "mmmu":
        _dump(root / "mmmu_val.jsonl", [
            {"images_path": ["i/1.png"], "question": "<image> <image> q", **mc},
            {"images_path": ["i/1.png", "i/2.png"], "question": "<image> q",
             "ques_type": "open-ended", "answers": ["x"]}], True)
    elif name == "mathvista":
        _dump(root / "mathvista_testmini.jsonl", [
            {"image": "i/1.png", "question": "q", "answers": "2"},
            {"image": "i/2.png", "question": "p", **mc}], True)
    elif name == "scienceqa":
        _dump(root / "problems.json", {
            "1": {"split": "test", "image": "image.png", "question": "q", "choices": ["a", "b"],
                  "answer": 1},
            "2": {"split": "train", "image": "image.png", "question": "p", "answer": 0},
            "3": {"split": "test", "image": None, "question": "r", "answer": 0}})


@pytest.mark.parametrize("name", sorted(jloaders.LOADERS))
def test_loader_raw_layout(tmp_path, name):
    root = tmp_path / name
    root.mkdir()
    write_raw_layout(name, root)
    got = tloaders.load_benchmark(name, str(root))
    assert got == jloaders.load_benchmark(name, str(root))
    assert got and all(r["question"] is not None for r in got)
    # write_normalized, then the prepared file takes precedence
    path = tloaders.write_normalized(name, str(root))
    assert path == str(root / f"eval_{name}.jsonl")
    assert tloaders.load_benchmark(name, str(root)) == got == jloaders.load_benchmark(
        name, str(root))
    assert tloaders.ANLS_DATASETS == jloaders.ANLS_DATASETS


def test_unknown_benchmark(tmp_path):
    with pytest.raises(KeyError, match="unknown benchmark"):
        tloaders.load_benchmark("nope", str(tmp_path))
    assert sorted(tloaders.LOADERS) == sorted(jloaders.LOADERS)
