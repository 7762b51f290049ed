"""Evaluation metrics: ANLS, multiple-choice/open-response parsing, ROUGE-L
(port of leopard_tpu/evaluation/metrics.py, line for line: the scores must
reproduce the JAX package's exactly).

Behavioral spec: evaluations/models/eval_utils.py —
  anls_metric/calculate_anls (:26-74), parse_multi_choice_response (:277-329),
  normalize_str/extract_numbers/parse_open_response (:345-443),
  eval_multi_choice/eval_open (:449-489), eval_rouge (:499-501).

Self-contained: Levenshtein and ROUGE-L are implemented here (the reference
pulls in `editdistance` and `rouge` pip packages).
"""

from __future__ import annotations

import random
import re
from typing import Dict, List, Sequence, Union

# an unmatched multiple-choice response draws from this generator, so a score
# depends on how many unmatched responses came before it in the process; the
# paper's scores depend on that rule, and the port keeps its own generator
# with the same seed
_rng = random.Random(42)

CHOICE_SYMBOLS = ["A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L", "M", "N"]


def levenshtein(a: str, b: str) -> int:
    """Edit distance, O(min(len)) memory."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(target: str, prediction: str, theta: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity for one target."""
    if not target and not prediction:
        return 1.0
    nld = levenshtein(target, prediction) / max(len(target), len(prediction))
    return 1.0 - nld if nld < theta else 0.0


def anls_score(targets: Sequence[str], prediction: str) -> float:
    """Max-over-targets ANLS with the reference's empty-answer conventions
    (eval_utils.py:49-57)."""
    if len(targets) == 0:
        return 1.0 if prediction in ["", "none", "NA", None, []] else 0.0
    if len(prediction) == 0:
        return 0.0
    p = prediction.lower()
    return max(anls(t.lower(), p) for t in targets)


def option_block(options: Sequence[str]) -> str:
    """`\\nOptions: A. x B. y\\n` block (eval_utils.py:92-102)."""
    if not options:
        return ""
    parts = [f"{CHOICE_SYMBOLS[i]}. {o}" for i, o in enumerate(options)]
    return f"\nOptions: {' '.join(parts)}\n"


def parse_multi_choice_response(
    response: str, all_choices: Sequence[str], index2ans: Dict[str, str]
) -> str:
    """Extract the chosen letter from a free-form response. Priority:
    bracketed "(A)", bare " A ", then option text containment; ties resolved
    by last occurrence; no match → seeded random choice.

    Close transcription of eval_utils.py:277-329, which is itself the public
    MMMU evaluation code (github.com/MMMU-Benchmark/MMMU); kept
    step-equivalent (including variable roles like index_ans/with_brack) so
    scores reproduce exactly."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = f" {response} "

    index_ans = True
    with_brack = False
    candidates = []
    for c in all_choices:
        if f"({c})" in response:
            candidates.append(c)
            with_brack = True
    if not candidates:
        for c in all_choices:
            if f" {c} " in response:
                candidates.append(c)
    if not candidates and len(response.split()) > 5:
        for idx, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(idx)
                index_ans = False
    if not candidates:
        return _rng.choice(list(all_choices))
    if len(candidates) == 1:
        return candidates[0]
    starts = []
    for c in candidates:
        if index_ans and with_brack:
            starts.append(response.rfind(f"({c})"))
        elif index_ans:
            starts.append(response.rfind(f" {c} "))
        else:
            starts.append(response.lower().rfind(index2ans[c].lower()))
    return candidates[max(range(len(starts)), key=starts.__getitem__)]


def _is_number(s: str) -> bool:
    try:
        float(s.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(s: str) -> List[Union[str, float]]:
    s = s.strip()
    if _is_number(s):
        return [round(float(s.replace(",", "")), 2)]
    s = s.lower()
    if len(s) == 1:
        return [f" {s}", f"{s} "]  # avoid trivial single-char matches
    return [s]


_NUM_COMMAS = re.compile(r"-?\b\d{1,3}(?:,\d{3})+\b")
_NUM_SCI = re.compile(r"-?\d+(?:\.\d+)?[eE][+-]?\d+")
_NUM_SIMPLE = re.compile(r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])")


def extract_numbers(s: str) -> List[str]:
    return _NUM_COMMAS.findall(s) + _NUM_SCI.findall(s) + _NUM_SIMPLE.findall(s)


_KEY_INDICATORS = [
    "answer: ", "Answer: ", "could be ", "so ", "is ",
    "thus ", "therefore ", "final ", "answer ", "result ",
]


def parse_open_response(response: str) -> List[Union[str, float]]:
    """Pull candidate answers out of a free-form response: split into
    sentences, take the tail after answer-indicator phrases, extract numbers,
    normalize.

    Step-equivalent to eval_utils.py:393-443 (public MMMU evaluation code) —
    parity-mandated for score reproducibility."""
    def key_subresponses(resp: str) -> List[str]:
        resp = resp.strip().strip(".").lower()
        subs = re.split(r"\.\s(?=[A-Z])|\n", resp)
        keys = []
        for i, sub in enumerate(subs):
            indicators = list(_KEY_INDICATORS)
            if i == len(subs) - 1:
                indicators.append("=")
            shortest = None
            for ind in indicators:
                if ind in sub:
                    tail = sub.split(ind)[-1].strip()
                    if shortest is None or len(tail) < len(shortest):
                        shortest = tail
            if shortest and shortest.strip() not in [":", ",", ".", "!", "?", ";", "'"]:
                keys.append(shortest)
        return keys or [resp]

    keys = key_subresponses(response)
    preds: List[str] = list(keys)
    for k in keys:
        preds.extend(extract_numbers(k))
    out: List[Union[str, float]] = []
    for p in preds:
        out.extend(normalize_str(p))
    return list(set(out))


def eval_multi_choice(gold: Union[str, Sequence[str]], pred: str) -> bool:
    if isinstance(gold, (list, tuple)):
        return any(a == pred for a in gold)
    return gold == pred


def eval_open(gold: Union[str, Sequence[str]], preds: Sequence[Union[str, float]]) -> bool:
    norm_answers: List[Union[str, float]] = []
    if isinstance(gold, (list, tuple)):
        for a in gold:
            norm_answers.extend(normalize_str(a))
    else:
        norm_answers = normalize_str(gold)
    for p in preds:
        if isinstance(p, str):
            for ans in norm_answers:
                if isinstance(ans, str) and ans in p:
                    return True
        elif p in norm_answers:
            return True
    return False


# --- ROUGE-L (f-measure), reference uses the `rouge` package's rouge-l f ----


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def _rouge_tokenize(s: str) -> List[str]:
    return re.findall(r"[a-z0-9]+", s.lower())


def rouge_l_f(gold: str, pred: str) -> float:
    g, p = _rouge_tokenize(gold), _rouge_tokenize(pred)
    lcs = _lcs_len(g, p)
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(g)
    return 2 * prec * rec / (prec + rec)


def rouge_1_f(gold: str, pred: str) -> float:
    from collections import Counter

    g, p = Counter(_rouge_tokenize(gold)), Counter(_rouge_tokenize(pred))
    overlap = sum((g & p).values())
    if overlap == 0:
        return 0.0
    prec, rec = overlap / sum(p.values()), overlap / sum(g.values())
    return 2 * prec * rec / (prec + rec)
