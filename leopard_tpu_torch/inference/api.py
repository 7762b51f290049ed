"""Text-level generation API (port of leopard_tpu/inference/api.py):
prompts in, detokenized text, tokens and per-token logprobs out, and a batch
predictor over a jsonl file of prompts."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from leopard_tpu_torch.config import GenerateConfig
from leopard_tpu_torch.inference.engine import Engine


@dataclass
class PostProcessedOutput:
    texts: List[str]
    tokens: List[np.ndarray]
    logprobs: List[np.ndarray]


def generate_and_post_process(
    engine: Engine,
    tokenizer,
    prompts: Sequence[str],
    gen_cfg: Optional[GenerateConfig] = None,
    return_logprobs: bool = True,
) -> PostProcessedOutput:
    """Tokenize → generate → detokenize, with optional per-token logprobs."""
    ids = [
        np.asarray(tokenizer(p, add_special_tokens=True)["input_ids"], np.int32)
        for p in prompts
    ]
    result = engine.generate(ids, gen_cfg=gen_cfg)
    texts = [
        tokenizer.decode(t.tolist(), skip_special_tokens=True)
        for t in result.tokens
    ]
    return PostProcessedOutput(
        texts=texts,
        tokens=result.tokens,
        logprobs=result.logprobs if return_logprobs else [],
    )


class Predictor:
    """Batch prediction over a jsonl file of prompts (one {"prompt": ...} per
    line) into a jsonl of {"prompt", "output", "logprob"}, where logprob is
    the sum over the generated tokens."""

    def __init__(self, engine: Engine, tokenizer, gen_cfg: Optional[GenerateConfig] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.gen_cfg = gen_cfg

    def predict_file(self, input_path: str, output_path: str, batch_size: int = 8):
        with open(input_path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        with open(output_path, "w") as out:
            for i in range(0, len(rows), batch_size):
                chunk = rows[i : i + batch_size]
                res = generate_and_post_process(
                    self.engine, self.tokenizer,
                    [r["prompt"] for r in chunk], self.gen_cfg,
                )
                for r, text, lps in zip(chunk, res.texts, res.logprobs):
                    out.write(json.dumps({
                        "prompt": r["prompt"],
                        "output": text,
                        "logprob": float(np.sum(lps)) if len(lps) else 0.0,
                    }) + "\n")
