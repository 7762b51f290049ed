"""Text-only datasets: raw-corpus packing (port of
leopard_tpu/data/text_dataset.py; host code over numpy, the same samples).

Documents live in a flat token store (one .npy of tokens and one .npy of
document offsets); `PackedLMDataset` packs shuffled, epoch-expanded documents
into (seq_len + 1)-token samples with the native sample-index builder
(data/native.py), and `BlendedDataset` mixes corpora by the native blending
indices.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np

from leopard_tpu_torch.data import native


class TokenStore:
    """Flat token archive: tokens.npy (int32 [N]) + offsets.npy (int64 [D+1])."""

    def __init__(self, tokens: np.ndarray, offsets: np.ndarray):
        self.tokens = tokens
        self.offsets = offsets

    @staticmethod
    def build(documents: Sequence[Sequence[int]]) -> "TokenStore":
        lengths = [len(d) for d in documents]
        offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        tokens = np.concatenate([np.asarray(d, np.int32) for d in documents])
        return TokenStore(tokens, offsets)

    @staticmethod
    def from_jsonl(path: str, tokenizer, text_key: str = "text",
                   append_eos: bool = True) -> "TokenStore":
        docs = []
        eos = [tokenizer.eos_token_id] if append_eos else []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                ids = tokenizer(row[text_key], add_special_tokens=True)["input_ids"]
                docs.append(list(ids) + eos)
        return TokenStore.build(docs)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "tokens.npy"), self.tokens)
        np.save(os.path.join(directory, "offsets.npy"), self.offsets)

    @staticmethod
    def load(directory: str) -> "TokenStore":
        return TokenStore(
            np.load(os.path.join(directory, "tokens.npy")),
            np.load(os.path.join(directory, "offsets.npy")),
        )

    @property
    def num_documents(self) -> int:
        return len(self.offsets) - 1

    def doc_length(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    def doc_tokens(self, i: int, start: int = 0, end: Optional[int] = None):
        a = int(self.offsets[i]) + start
        b = int(self.offsets[i + 1]) if end is None else int(self.offsets[i]) + end
        return self.tokens[a:b]


class PackedLMDataset:
    """GPT-style packed language-modeling dataset: documents are shuffled,
    epoch-expanded, and packed into (seq_len + 1)-token samples by the native
    sample-index builder (≙ GPTDataset's doc/sample/shuffle indices)."""

    def __init__(self, store: TokenStore, seq_len: int, num_samples: int,
                 seed: int = 1234):
        self.store = store
        self.seq_len = seq_len
        lengths = np.diff(store.offsets).astype(np.int32)
        total_tokens = int(lengths.sum())
        epochs = max(1, -(-(num_samples * (seq_len + 1)) // max(total_tokens, 1)))
        order = np.concatenate([
            native.shuffle_indices(store.num_documents, seed + e)
            for e in range(epochs)
        ]).astype(np.int32)
        self.order = order
        self.sample_idx = native.build_sample_index(
            lengths, order, seq_len, num_samples
        )
        self.num_samples = len(self.sample_idx) - 1

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i: int) -> dict:
        (p0, o0), (p1, o1) = self.sample_idx[i], self.sample_idx[i + 1]
        parts: List[np.ndarray] = []
        if p0 == p1:
            parts.append(self.store.doc_tokens(int(self.order[p0]), int(o0), int(o1)))
        else:
            parts.append(self.store.doc_tokens(int(self.order[p0]), int(o0)))
            for p in range(int(p0) + 1, int(p1)):
                parts.append(self.store.doc_tokens(int(self.order[p])))
            if o1 > 0:
                parts.append(self.store.doc_tokens(int(self.order[p1]), 0, int(o1)))
        seq = np.concatenate(parts)[: self.seq_len + 1].astype(np.int32)
        return {
            "tokens": seq[:-1],
            "targets": seq[1:],
            "loss_weights": np.ones(self.seq_len, np.float32),
        }


class BlendedDataset:
    """Deterministic multi-corpus mixing using the native blending indices
    (≙ BlendedDataset, megatron/core/datasets/blended_dataset.py:23)."""

    def __init__(self, datasets: Sequence, weights: Sequence[float], size: int):
        assert len(datasets) == len(weights)
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        self.datasets = list(datasets)
        self.ds_index, self.ds_sample_index = native.build_blending_indices(w, size)
        self.size = size

    def __len__(self):
        return self.size

    def __getitem__(self, i: int):
        d = int(self.ds_index[i])
        return self.datasets[d][int(self.ds_sample_index[i]) % len(self.datasets[d])]
