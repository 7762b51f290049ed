"""Training datasets and batching for multi-image SFT (port of
leopard_tpu/data/dataset.py; the same samples, batches and data positions).

  - static-shape batches: sequence lengths are padded to a bucket and tile
    counts to a tile bucket (extra tiles zeroed; the splice never reads
    them), so the step sees a handful of shapes;
  - deterministic epoch shuffles (native.shuffle_indices) and an exact
    resume from the epoch and cursor of a `DataState`;
  - batches stay numpy on the host; the caller moves them to the device.

PIL is imported inside `JsonlSftDataset.get`, which opens the images.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from leopard_tpu_torch.data import native
from leopard_tpu_torch.data.processor import LeopardProcessor, ProcessedSample


@dataclass
class DataState:
    """Position for exact resume; serialized with every checkpoint."""

    epoch: int = 0
    cursor: int = 0            # index into the current epoch's shuffled order
    seed: int = 1234

    def to_dict(self):
        return {"epoch": self.epoch, "cursor": self.cursor, "seed": self.seed}

    @staticmethod
    def from_dict(d):
        return DataState(**d)


class JsonlSftDataset:
    """Supervised multimodal dataset from a jsonl manifest:
    each line {"conversations": [{"from"/"role", "value"/"content"}, ...],
               "images": [relative paths]} (+ image_folder root).
    Equivalent of LazySupervisedDataset (mm_pretrain_dataset.py:925-1044)."""

    def __init__(self, manifest_path: str, image_folder: str = ""):
        self.image_folder = image_folder
        with open(manifest_path) as f:
            self.rows = [json.loads(l) for l in f if l.strip()]

    def __len__(self):
        return len(self.rows)

    def get(self, i: int):
        from PIL import Image

        row = self.rows[i]
        msgs = []
        mapping = {"human": "user", "gpt": "assistant"}
        for m in row.get("conversations", []):
            role = mapping.get(m.get("from"), m.get("from") or m.get("role"))
            msgs.append((role, m.get("value", m.get("content", ""))))
        images = [
            Image.open(os.path.join(self.image_folder, p)).convert("RGB")
            for p in row.get("images", [])
        ]
        return msgs, images


class ShardedSampleDataset:
    """wids-style sharded dataset: a shard-list json [{"path", "num_samples"}]
    where each shard is a jsonl bundle or a webdataset-style .tar (members
    grouped by key prefix: `000001.conversations`, `000001.input_image`, …).
    Random access via (shard, offset) computed from cumulative sizes
    (≙ PackedShardListDataset over wids, mm_pretrain_dataset.py:409-481)."""

    def __init__(self, shard_list_path: str):
        with open(shard_list_path) as f:
            spec = json.load(f)
        self.shards = spec["shardlist"] if isinstance(spec, dict) else spec
        self.base = os.path.dirname(os.path.abspath(shard_list_path))
        sizes = [s["num_samples"] for s in self.shards]
        self.cum = np.concatenate([[0], np.cumsum(sizes)])
        self._cache: Dict[int, list] = {}

    def __len__(self):
        return int(self.cum[-1])

    def _load_shard(self, si: int) -> list:
        if si not in self._cache:
            self._cache.clear()  # hold one shard at a time (sequential access)
            path = os.path.join(self.base, self.shards[si]["path"])
            if path.endswith(".tar"):
                self._cache[si] = self._load_tar(path)
            else:
                with open(path) as f:
                    self._cache[si] = [json.loads(l) for l in f if l.strip()]
        return self._cache[si]

    @staticmethod
    def _load_tar(path: str) -> list:
        """webdataset tar → list of {".suffix": bytes} dicts, grouped by key
        prefix in archive order (the wids sample layout)."""
        import tarfile

        samples: Dict[str, dict] = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                name = member.name
                key, dot, suffix = name.partition(".")
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key]["." + suffix] = tf.extractfile(member).read()
        return [samples[k] for k in order]

    def get_raw(self, i: int):
        si = int(np.searchsorted(self.cum, i, side="right") - 1)
        return self._load_shard(si)[i - int(self.cum[si])]


@dataclass
class Batch:
    tokens: np.ndarray         # [B, S]
    loss_weights: np.ndarray   # [B, S]
    segment_ids: np.ndarray    # [B, S]
    images: np.ndarray         # [N_tiles_bucket, 3, T, T]
    positions: Optional[np.ndarray] = None  # [B, S] — per-sample RoPE
                                            # positions (packed batches)

    def as_dict(self):
        d = {
            "tokens": self.tokens,
            "loss_weights": self.loss_weights,
            "segment_ids": self.segment_ids,
            "images": self.images,
        }
        if self.positions is not None:
            d["positions"] = self.positions
        return d


def collate(
    samples: Sequence[ProcessedSample],
    seq_buckets: Sequence[int] = (512, 1024, 2048, 4096, 8192, 16384),
    tile_buckets: Sequence[int] = (4, 8, 16, 32, 64, 128),
    tile_size: int = 364,
) -> Batch:
    """Pad a list of processed samples to bucketed static shapes."""
    max_len = max(s.seq_len for s in samples)
    s_bkt = next((b for b in sorted(seq_buckets) if max_len <= b), max_len)
    b = len(samples)
    tokens = np.zeros((b, s_bkt), np.int32)
    weights = np.zeros((b, s_bkt), np.float32)
    seg = np.zeros((b, s_bkt), np.int32)
    tiles = []
    for i, s in enumerate(samples):
        n = min(s.seq_len, s_bkt)
        tokens[i, :n] = s.input_ids[:n]
        weights[i, :n] = s.loss_weights[:n]
        seg[i, :n] = 1
        tiles.append(s.pixel_values)
    all_tiles = (
        np.concatenate(tiles, 0)
        if tiles and sum(t.shape[0] for t in tiles)
        else np.zeros((0, 3, tile_size, tile_size), np.float32)
    )
    n_tiles = all_tiles.shape[0]
    t_bkt = next((t for t in sorted(tile_buckets) if n_tiles <= t), n_tiles)
    if t_bkt != n_tiles:
        pad = np.zeros((t_bkt - n_tiles,) + all_tiles.shape[1:], all_tiles.dtype)
        all_tiles = np.concatenate([all_tiles, pad], 0)
    return Batch(tokens=tokens, loss_weights=weights, segment_ids=seg, images=all_tiles)


def collate_packed(
    samples: Sequence[ProcessedSample],
    seq_len: int,
    tile_buckets: Sequence[int] = (4, 8, 16, 32, 64, 128),
    tile_size: int = 364,
) -> Batch:
    """Sequence-packed collation: FFD-pack samples into bins of `seq_len`
    tokens (native packer), one bin per batch row, with per-sample segment
    ids so attention never crosses samples (≙ the role flash-attn varlen
    cu_seqlens play in the reference; the reference itself never packs —
    this recovers the padding waste of variable_seq_lengths batches).

    Image tiles are concatenated in (bin, within-bin) order, matching the
    order image tokens appear in the flattened token stream that the splice
    gather consumes."""
    lengths = np.asarray([s.seq_len for s in samples], np.int32)
    bin_ids, n_bins = native.pack_sequences_ffd(lengths, seq_len)
    order = np.argsort(-lengths, kind="stable")  # FFD assignment order
    per_bin: List[List[int]] = [[] for _ in range(n_bins)]
    for idx in order:
        b = int(bin_ids[idx])
        if b >= 0:
            per_bin[b].append(int(idx))

    tokens = np.zeros((n_bins, seq_len), np.int32)
    weights = np.zeros((n_bins, seq_len), np.float32)
    seg = np.zeros((n_bins, seq_len), np.int32)
    positions = np.zeros((n_bins, seq_len), np.int32)
    tiles = []
    for b, members in enumerate(per_bin):
        cursor = 0
        for si, idx in enumerate(members, start=1):
            s = samples[idx]
            n = s.seq_len
            tokens[b, cursor : cursor + n] = s.input_ids
            weights[b, cursor : cursor + n] = s.loss_weights
            seg[b, cursor : cursor + n] = si
            positions[b, cursor : cursor + n] = np.arange(n)  # RoPE restarts
            cursor += n
            tiles.append(s.pixel_values)
    all_tiles = (
        np.concatenate(tiles, 0)
        if tiles and sum(t.shape[0] for t in tiles)
        else np.zeros((0, 3, tile_size, tile_size), np.float32)
    )
    n_tiles = all_tiles.shape[0]
    t_bkt = next((t for t in sorted(tile_buckets) if n_tiles <= t), n_tiles)
    if t_bkt != n_tiles:
        pad = np.zeros((t_bkt - n_tiles,) + all_tiles.shape[1:], all_tiles.dtype)
        all_tiles = np.concatenate([all_tiles, pad], 0)
    return Batch(tokens=tokens, loss_weights=weights, segment_ids=seg,
                 images=all_tiles, positions=positions)


class TrainDataLoader:
    """Deterministic, resumable, DP-sharded loader over an SFT dataset.

    Iteration order: per-epoch Fisher-Yates shuffle (native) of sample
    indices, then round-robin slice by (dp_rank, dp_world); samples rejected
    by the processor guards are skipped (≙ skip-too-long/too-many-images,
    mm_pretrain_dataset.py:333-347)."""

    def __init__(
        self,
        dataset: JsonlSftDataset,
        processor: LeopardProcessor,
        batch_size: int,
        seq_len: int,
        dp_rank: int = 0,
        dp_world: int = 1,
        state: Optional[DataState] = None,
        seq_buckets: Sequence[int] = (512, 1024, 2048, 4096, 8192, 16384),
        tile_buckets: Sequence[int] = (4, 8, 16, 32, 64, 128),
        pack: bool = False,
    ):
        self.ds = dataset
        self.proc = processor
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.dp_rank = dp_rank
        self.dp_world = dp_world
        self.state = state or DataState()
        self.seq_buckets = [b for b in seq_buckets if b <= seq_len] or [seq_len]
        self.tile_buckets = tile_buckets
        self.pack = pack

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = native.shuffle_indices(len(self.ds), seed=self.state.seed + epoch)
        return order[self.dp_rank :: self.dp_world]

    def _samples(self) -> Iterator[ProcessedSample]:
        """Endless stream of valid processed samples in deterministic order.
        Raises if a whole epoch, read from its start, yields nothing (every
        sample rejected) instead of spinning forever. A resume from a state
        saved at the end of an epoch (cursor == its length) goes on to the
        next epoch; the JAX loader raises there, having read nothing."""
        while True:
            order = self._epoch_order(self.state.epoch)
            from_start = self.state.cursor == 0
            yielded = 0
            while self.state.cursor < len(order):
                idx = int(order[self.state.cursor])
                self.state.cursor += 1
                msgs, images = self.ds.get(idx)
                sample = self.proc.process_chat(msgs, images)
                if sample is None or sample.seq_len > self.seq_len:
                    continue
                yielded += 1
                yield sample
            if from_start and yielded == 0:
                raise RuntimeError(
                    f"epoch {self.state.epoch}: every sample was rejected "
                    f"(too long for seq_len={self.seq_len} or guard-filtered)"
                )
            self.state.epoch += 1
            self.state.cursor = 0

    def __iter__(self) -> Iterator[Batch]:
        stream = self._samples()
        tile_size = self.proc.cfg.anyres.tile_size
        if not self.pack:
            while True:
                batch_samples = [next(stream) for _ in range(self.batch_size)]
                yield collate(
                    batch_samples, self.seq_buckets, self.tile_buckets,
                    tile_size=tile_size,
                )
        else:
            # sequence packing: fill until the token mass covers the batch,
            # pack with FFD, emit exactly batch_size bins (short bins are
            # zero rows; leftover bins carry into the next batch)
            carry: List[ProcessedSample] = []
            while True:
                buf = carry
                carry = []
                budget = self.batch_size * self.seq_len
                total = sum(s.seq_len for s in buf)
                while total < budget * 0.92:
                    s = next(stream)
                    buf.append(s)
                    total += s.seq_len
                batch = collate_packed(buf, self.seq_len, self.tile_buckets,
                                       tile_size=tile_size)
                n_bins = batch.tokens.shape[0]
                if n_bins > self.batch_size:
                    # give the overflow bins' samples back to the next batch
                    keep, overflow = self._split_by_bins(buf, self.batch_size)
                    carry = overflow
                    batch = collate_packed(keep, self.seq_len, self.tile_buckets,
                                           tile_size=tile_size)
                    n_bins = batch.tokens.shape[0]
                if n_bins < self.batch_size:
                    pad = self.batch_size - n_bins
                    batch = Batch(
                        tokens=np.concatenate([batch.tokens, np.zeros((pad, self.seq_len), np.int32)]),
                        loss_weights=np.concatenate([batch.loss_weights, np.zeros((pad, self.seq_len), np.float32)]),
                        segment_ids=np.concatenate([batch.segment_ids, np.zeros((pad, self.seq_len), np.int32)]),
                        images=batch.images,
                        positions=np.concatenate([batch.positions, np.zeros((pad, self.seq_len), np.int32)]),
                    )
                yield batch

    def _split_by_bins(self, samples: List[ProcessedSample], max_bins: int):
        """Partition samples into (fits in first max_bins bins, overflow)."""
        lengths = np.asarray([s.seq_len for s in samples], np.int32)
        bin_ids, _ = native.pack_sequences_ffd(lengths, self.seq_len)
        keep = [s for s, b in zip(samples, bin_ids) if 0 <= b < max_bins]
        overflow = [s for s, b in zip(samples, bin_ids) if b >= max_bins]
        return keep, overflow
