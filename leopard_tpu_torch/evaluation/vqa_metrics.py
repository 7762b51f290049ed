"""VQA-style accuracy metrics (TextVQA / ST-VQA families; port of
leopard_tpu/evaluation/vqa_metrics.py, line for line).

Behavioral spec: evaluations/models/m4c_evaluator.py (itself derived from the
public Facebook MMF / EvalAI VQA evaluation code) — answer normalization
(EvalAIAnswerProcessor), the VQA soft accuracy min(#matches/3, 1) over 10
human answers (TextVQAAccuracyEvaluator), exact-match ST-VQA accuracy, and
ANLS (STVQAANLSEvaluator). The normalization tables (contractions, number
words, punctuation handling) are the standard public VQA-eval constants and
must match exactly for score reproducibility.

The reference's TextCapsBleu4Evaluator shells out to pycocoevalcap (Java);
here `bleu4` is a self-contained corpus-BLEU with the same smoothing-free
convention.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence

from leopard_tpu_torch.evaluation.metrics import levenshtein

# Standard EvalAI/VQA contraction table (public MMF constants; parity-mandated)
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've",
    "couldnt've": "couldn't've", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hadnt've": "hadn't've",
    "hadn'tve": "hadn't've", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's", "Id've": "I'd've",
    "I'dve": "I'd've", "Im": "I'm", "Ive": "I've", "isnt": "isn't",
    "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've", "itll": "it'll",
    "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've",
    "mightve": "might've", "mustnt": "mustn't", "mustve": "must've",
    "neednt": "needn't", "notve": "not've", "oclock": "o'clock",
    "oughtnt": "oughtn't", "ow's'at": "'ow's'at", "'ows'at": "'ow's'at",
    "'ow'sat": "'ow's'at", "shant": "shan't", "shed've": "she'd've",
    "she'dve": "she'd've", "she's": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've", "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someoned've": "someone'd've",
    "someone'dve": "someone'd've", "someonell": "someone'll",
    "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've",
    "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyd've": "they'd've", "they'dve": "they'd've", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "twas": "'twas",
    "wasnt": "wasn't", "wed've": "we'd've", "we'dve": "we'd've",
    "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = {"a", "an", "the"}
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
_PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def vqa_normalize(answer: str) -> str:
    """EvalAIAnswerProcessor.__call__ equivalence (m4c_evaluator.py:61-218):
    lowercase, strip commas/question marks, split possessives, drop or space
    punctuation (keeping digit-internal commas/periods), map number words,
    drop articles, restore contractions."""
    s = answer.lower().replace(",", "").replace("?", "").replace("'s", " 's")
    s = s.strip().replace("\n", " ").replace("\t", " ").strip()
    out = s
    for p in _PUNCT:
        if (p + " " in s or " " + p in s) or _COMMA_STRIP.search(s) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out)
    words = []
    for w in out.lower().split():
        w = _NUMBER_MAP.get(w, w)
        if w not in _ARTICLES:
            words.append(w)
    words = [_CONTRACTIONS.get(w, w) for w in words]
    return " ".join(words)


def vqa_answer_scores(raw_answers: Sequence[str]) -> Dict[str, float]:
    """Soft consensus score of each unique human answer: for every annotator,
    acc = min(#other annotators agreeing / 3, 1); averaged over annotators
    (TextVQAAccuracyEvaluator._compute_answer_scores)."""
    answers = [vqa_normalize(a) for a in raw_answers]
    n = len(answers)
    scores: Dict[str, float] = {}
    for unique in set(answers):
        accs = []
        for i in range(n):
            matching = sum(1 for j in range(n) if j != i and answers[j] == unique)
            accs.append(min(1.0, matching / 3.0))
        scores[unique] = sum(accs) / n
    return scores


def textvqa_accuracy(pred_list: Sequence[dict]) -> float:
    """VQA soft accuracy over rows {pred_answer, gt_answers (10 humans)}."""
    if not pred_list:
        return 0.0
    total = 0.0
    for entry in pred_list:
        pred = vqa_normalize(entry["pred_answer"])
        total += vqa_answer_scores(entry["gt_answers"]).get(pred, 0.0)
    return total / len(pred_list)


def stvqa_accuracy(pred_list: Sequence[dict]) -> float:
    """Exact match on normalized answers (STVQAAccuracyEvaluator)."""
    if not pred_list:
        return 0.0
    hits = 0
    for entry in pred_list:
        pred = vqa_normalize(entry["pred_answer"])
        gts = [vqa_normalize(a) for a in entry["gt_answers"]]
        hits += pred in gts
    return hits / len(pred_list)


def stvqa_anls(pred_list: Sequence[dict]) -> float:
    """Max-over-gts ANLS with 0.5 threshold (STVQAANLSEvaluator)."""
    if not pred_list:
        return 0.0

    def one(p: str, g: str) -> float:
        p, g = p.lower().strip(), g.lower().strip()
        if max(len(p), len(g)) == 0:
            return 1.0
        iou = 1 - levenshtein(p, g) / max(len(p), len(g))
        return iou if iou >= 0.5 else 0.0

    return sum(
        max(one(e["pred_answer"], g) for g in e["gt_answers"]) for e in pred_list
    ) / len(pred_list)


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu4(pred_list: Sequence[dict]) -> float:
    """Corpus BLEU-4 with clipped n-gram precision and brevity penalty
    (≙ TextCapsBleu4Evaluator without the Java tokenizer; whitespace/punct
    tokenization matches PTB closely enough for relative comparison)."""
    if not pred_list:
        return 0.0
    tok = lambda s: re.findall(r"[a-z0-9]+", s.lower())  # noqa: E731
    p_num = [0] * 4
    p_den = [0] * 4
    hyp_len = 0
    ref_len = 0
    for e in pred_list:
        hyp = tok(e["pred_answer"])
        refs = [tok(g) for g in e["gt_answers"]]
        hyp_len += len(hyp)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, 5):
            h = _ngrams(hyp, n)
            max_ref: Counter = Counter()
            for r in refs:
                for g, c in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], c)
            p_num[n - 1] += sum(min(c, max_ref[g]) for g, c in h.items())
            p_den[n - 1] += max(sum(h.values()), 0)
    if any(d == 0 for d in p_den) or any(n == 0 for n in p_num):
        return 0.0
    log_p = sum(math.log(p_num[i] / p_den[i]) for i in range(4)) / 4
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return bp * math.exp(log_p)
