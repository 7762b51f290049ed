"""lm-evaluation-harness adaptor (port of
leopard_tpu/evaluation/lm_eval_adapter.py).

Role parity with the reference's megatron_patch/lm_evaluate.py:41
(EvalHarnessAdaptor(HFLM)): it exposes the text decoder through the LM
interface lm-eval expects, `loglikelihood(context, continuation)`,
`loglikelihood_rolling` and `generate_until`. The lm-eval package itself is
optional and never imported here; the scoring methods take plain tuples or
any object with `.args`.

`_score` runs the decoder once over the whole right-padded context with
segment ids, no cache and no `logits_indices`, so a context of at least
`long_seq_threshold` tokens goes through the flash tier (K1 on the card),
and takes a log-softmax of the full fp32 logits.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from leopard_tpu_torch.config import GenerateConfig, VLMConfig


class LeopardLM:
    def __init__(self, cfg: VLMConfig, model, tokenizer, max_len: int = 4096):
        self.cfg = cfg
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.device = model.text.embed_tokens.device
        model.text.keep_fp32_head()
        self._engine = None

    @torch.inference_mode()
    def _logprobs(self, tokens: np.ndarray, seg: np.ndarray) -> torch.Tensor:
        """[S, V] fp32 log-probabilities of row 0, on the model's device."""
        logits, _ = self.model.text(
            torch.from_numpy(tokens).to(self.device),
            segment_ids=torch.from_numpy(seg).to(self.device))
        return torch.log_softmax(logits[0].float(), dim=-1)

    def _score(self, ctx_ids: Sequence[int], cont_ids: Sequence[int]) -> Tuple[float, bool]:
        """Sum logprob of continuation given context + greedy-match flag.

        Over-length requests keep the last max_len tokens; the continuation is
        clamped so at least one conditioning token remains (scoring position
        t reads lp[t-1], so start must be >= 1)."""
        ids = list(ctx_ids) + list(cont_ids)
        ids = ids[-self.max_len:]
        n_cont = min(len(cont_ids), len(ids) - 1)
        if n_cont <= 0:
            return 0.0, True
        pad = 8 * ((len(ids) + 7) // 8)
        tokens = np.zeros((1, pad), np.int32)
        seg = np.zeros((1, pad), np.int32)
        tokens[0, : len(ids)] = ids
        seg[0, : len(ids)] = 1
        lp = self._logprobs(tokens, seg)
        start = len(ids) - n_cont
        with torch.inference_mode():
            rows = lp[start - 1: len(ids) - 1]
            target = torch.as_tensor(ids[start:], device=rows.device)
            picked = rows.gather(1, target[:, None].long())[:, 0].cpu().numpy()
            greedy_ids = rows.argmax(dim=-1).cpu().numpy()
        total = 0.0
        for x in picked:  # summed in order in fp64, as the JAX adaptor does
            total += float(x)
        return total, bool((greedy_ids == np.asarray(ids[start:])).all())

    # --- lm-eval LM interface -------------------------------------------

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        out = []
        for req in requests:
            ctx, cont = req.args if hasattr(req, "args") else req
            ctx_ids = self.tokenizer(ctx, add_special_tokens=True)["input_ids"]
            cont_ids = self.tokenizer(cont, add_special_tokens=False)["input_ids"]
            out.append(self._score(ctx_ids, cont_ids))
        return out

    def loglikelihood_rolling(self, requests) -> List[float]:
        out = []
        for req in requests:
            if hasattr(req, "args"):
                (text,) = req.args
            elif isinstance(req, tuple):
                (text,) = req
            else:
                text = req
            ids = self.tokenizer(text, add_special_tokens=True)["input_ids"]
            total, _ = self._score(ids[:1], ids[1:])
            out.append(total)
        return out

    def generate_until(self, requests) -> List[str]:
        from leopard_tpu_torch.inference.engine import Engine

        if self._engine is None:
            self._engine = Engine(self.cfg, self.model)
        out = []
        for req in requests:
            ctx, kwargs = req.args if hasattr(req, "args") else req
            ids = np.asarray(
                self.tokenizer(ctx, add_special_tokens=True)["input_ids"], np.int32
            )
            gen = GenerateConfig(
                max_new_tokens=kwargs.get("max_gen_toks", 128),
                greedy=True,
                eos_token_ids=tuple(
                    self.tokenizer(u, add_special_tokens=False)["input_ids"][-1]
                    for u in kwargs.get("until", [])
                ) or (self.tokenizer.eos_token_id,),
            )
            res = self._engine.generate([ids], gen_cfg=gen)
            out.append(self.tokenizer.decode(res.tokens[0].tolist(),
                                             skip_special_tokens=True))
        return out
