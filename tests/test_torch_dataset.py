"""The port's training-data modules (leopard_tpu_torch/data/{dataset,
text_dataset}.py) against the JAX package's: collation, the jsonl and tar
datasets, the token store, packed and blended text datasets, and the
TrainDataLoader over two epochs with and without packing, every array
equal; a mid-epoch resume against an uninterrupted run; the empty-epoch
error."""

import io
import json
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from leopard_tpu import config as cfgs
from leopard_tpu.data import dataset as jds
from leopard_tpu.data import text_dataset as jtext
from leopard_tpu.data.processor import LeopardProcessor as JProcessor
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.data import dataset as tds
from leopard_tpu_torch.data import text_dataset as ttext
from leopard_tpu_torch.data.processor import LeopardProcessor as TProcessor
from leopard_tpu_torch.data.processor import ProcessedSample
from tests.test_chat import FakeTokenizer

TOK = FakeTokenizer()


def make_manifest(directory, n=8, seed=0):
    """n rows of 0-3 seeded noise PNGs and a two-turn conversation; row 5
    has a long answer (rejected at seq_len 256)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(directory, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    for i in range(n):
        names = []
        for j in range(i % 4):
            w, h = rng.randint(20, 160, size=2)
            name = f"im{i}_{j}.png"
            Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(img_dir, name))
            names.append(name)
        answer = "long " * 80 if i == 5 else f"it is {i}"
        rows.append({"conversations": [
            {"from": "human", "value": "<image> " * len(names) + f"what is {i}?"},
            {"from": "gpt", "value": answer}], "images": names})
    path = os.path.join(directory, "data.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return path, img_dir


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gd, wd = g.as_dict(), w.as_dict()
        assert set(gd) == set(wd)
        for k, v in wd.items():
            assert gd[k].dtype == v.dtype and gd[k].shape == v.shape, k
            np.testing.assert_array_equal(gd[k], v, err_msg=k)


def samples(seed=0, n=5, tile=56):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length, tiles = int(rng.randint(3, 60)), int(rng.randint(0, 4))
        out.append(ProcessedSample(
            input_ids=rng.randint(0, 500, length).astype(np.int32),
            loss_weights=rng.rand(length).astype(np.float32),
            pixel_values=rng.randn(tiles, 3, tile, tile).astype(np.float32),
            tiles_per_image=[tiles]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collate_matches_jax(seed):
    ss = samples(seed)
    kw = dict(seq_buckets=(16, 32, 64), tile_buckets=(4, 8), tile_size=56)
    assert_batches_equal([tds.collate(ss, **kw)], [jds.collate(ss, **kw)])
    kw = dict(seq_len=64, tile_buckets=(4, 8, 16), tile_size=56)
    assert_batches_equal([tds.collate_packed(ss, **kw)], [jds.collate_packed(ss, **kw)])
    # no tiles at all: one bucket of zero tiles
    bare = [ProcessedSample(s.input_ids, s.loss_weights, s.pixel_values[:0], []) for s in ss]
    assert_batches_equal([tds.collate(bare, tile_size=56)], [jds.collate(bare, tile_size=56)])


def test_batch_as_dict_keys():
    """Exactly the keys the port's trainer reads."""
    ss = samples(3)
    assert set(tds.collate(ss, tile_size=56).as_dict()) == {
        "tokens", "loss_weights", "segment_ids", "images"}
    assert set(tds.collate_packed(ss, 64, tile_size=56).as_dict()) == {
        "tokens", "loss_weights", "segment_ids", "images", "positions"}


def test_jsonl_dataset_matches_jax(tmp_path):
    path, img_dir = make_manifest(tmp_path)
    j, t = jds.JsonlSftDataset(path, img_dir), tds.JsonlSftDataset(path, img_dir)
    assert len(t) == len(j) == 8
    for i in range(len(j)):
        (jm, ji), (tm, ti) = j.get(i), t.get(i)
        assert tm == jm
        assert [np.asarray(im).tolist() for im in ti] == [np.asarray(im).tolist() for im in ji]


def test_sharded_datasets_match_jax(tmp_path):
    """A jsonl shard and a webdataset-style tar shard, read at every index."""
    with open(tmp_path / "shard0.jsonl", "w") as f:
        f.writelines(json.dumps({"id": j}) + "\n" for j in range(3))
    with tarfile.open(tmp_path / "shard1.tar", "w") as tf:
        for key in ("000000", "000001"):
            for suffix, data in (("conversations", json.dumps([{"q": key}]).encode()),
                                 ("input_image", bytes(range(key.count("1") + 5)))):
                info = tarfile.TarInfo(f"{key}.{suffix}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    spec = tmp_path / "shards.json"
    spec.write_text(json.dumps({"shardlist": [{"path": "shard0.jsonl", "num_samples": 3},
                                              {"path": "shard1.tar", "num_samples": 2}]}))
    j, t = jds.ShardedSampleDataset(str(spec)), tds.ShardedSampleDataset(str(spec))
    assert len(t) == len(j) == 5
    for i in (0, 3, 1, 4, 2):
        assert t.get_raw(i) == j.get_raw(i)
    assert t.get_raw(4)[".conversations"] == json.dumps([{"q": "000001"}]).encode()


def docs(seed=0, n=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1000, int(rng.randint(1, 40))).tolist() for _ in range(n)]


def test_token_store_matches_jax(tmp_path):
    d = docs()
    j, t = jtext.TokenStore.build(d), ttext.TokenStore.build(d)
    np.testing.assert_array_equal(t.tokens, j.tokens)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    assert t.tokens.dtype == j.tokens.dtype and t.offsets.dtype == j.offsets.dtype
    t.save(str(tmp_path / "store"))
    back = jtext.TokenStore.load(str(tmp_path / "store"))  # the JAX package reads it
    np.testing.assert_array_equal(back.tokens, j.tokens)
    again = ttext.TokenStore.load(str(tmp_path / "store"))
    assert again.num_documents == 12
    for i in range(12):
        assert again.doc_length(i) == len(d[i])
        np.testing.assert_array_equal(again.doc_tokens(i), d[i])
        np.testing.assert_array_equal(again.doc_tokens(i, 1, 3), j.doc_tokens(i, 1, 3))
    lines = tmp_path / "docs.jsonl"
    lines.write_text("".join(json.dumps({"text": f"doc {i} " * (i + 1)}) + "\n"
                             for i in range(4)) + "\n")

    class EosTok(FakeTokenizer):
        eos_token_id = 128009

    a = ttext.TokenStore.from_jsonl(str(lines), EosTok())
    b = jtext.TokenStore.from_jsonl(str(lines), EosTok())
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.offsets, b.offsets)


@pytest.mark.parametrize("seq_len,num_samples", [(8, 20), (31, 10), (5, 200)])
def test_packed_and_blended_match_jax(seq_len, num_samples):
    d = docs(seq_len)
    j = jtext.PackedLMDataset(jtext.TokenStore.build(d), seq_len, num_samples, seed=3)
    t = ttext.PackedLMDataset(ttext.TokenStore.build(d), seq_len, num_samples, seed=3)
    assert len(t) == len(j)
    np.testing.assert_array_equal(t.sample_idx, j.sample_idx)
    for i in range(len(j)):
        for k, v in j[i].items():
            np.testing.assert_array_equal(t[i][k], v, err_msg=k)
    j2 = jtext.PackedLMDataset(jtext.TokenStore.build(docs(9)), seq_len, 7, seed=1)
    t2 = ttext.PackedLMDataset(ttext.TokenStore.build(docs(9)), seq_len, 7, seed=1)
    jb, tb = jtext.BlendedDataset([j, j2], [0.7, 0.3], 25), ttext.BlendedDataset([t, t2], [0.7, 0.3], 25)
    np.testing.assert_array_equal(tb.ds_index, jb.ds_index)
    np.testing.assert_array_equal(tb.ds_sample_index, jb.ds_sample_index)
    for i in range(len(jb)):
        np.testing.assert_array_equal(tb[i]["tokens"], jb[i]["tokens"])


def loaders(path, img_dir, state_kw=None, **kw):
    """The JAX and the port's loader over the same manifest."""
    state_kw = state_kw or {"seed": 5}
    out = []
    for ds_mod, proc_cls, cfg in ((jds, JProcessor, cfgs.tiny_vlm()),
                                  (tds, TProcessor, tcfgs.tiny_vlm())):
        out.append(ds_mod.TrainDataLoader(
            ds_mod.JsonlSftDataset(path, img_dir), proc_cls(cfg, TOK),
            state=ds_mod.DataState(**state_kw), **kw))
    return out


def take(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("pack", [False, True])
def test_loader_two_epochs_match_jax(tmp_path, pack):
    """Two epochs (7 valid samples of 8 each) at batch 2: every array of
    every batch equal, and the data positions equal after each batch."""
    path, img_dir = make_manifest(tmp_path)
    kw = dict(batch_size=2, seq_len=256, seq_buckets=(128, 256), tile_buckets=(4, 8, 16),
              pack=pack)
    j, t = loaders(path, img_dir, **kw)
    n = 7 if not pack else 4
    jit, tit = iter(j), iter(t)
    for _ in range(n):
        assert_batches_equal([next(tit)], [next(jit)])
        assert t.state.to_dict() == j.state.to_dict()
    assert t.state.epoch >= 1  # the second epoch was reached


@pytest.mark.parametrize("dp_rank", [0, 1])
def test_loader_dp_shard_matches_jax(tmp_path, dp_rank):
    path, img_dir = make_manifest(tmp_path)
    j, t = loaders(path, img_dir, batch_size=1, seq_len=256, dp_rank=dp_rank, dp_world=2,
                   seq_buckets=(256,))
    assert_batches_equal(take(t, 5), take(j, 5))


def test_loader_resume_mid_epoch(tmp_path):
    """A loader started from the DataState saved after batch 1 gives the
    uninterrupted run's batches 2-5 (across the epoch boundary)."""
    path, img_dir = make_manifest(tmp_path)
    kw = dict(batch_size=2, seq_len=256, seq_buckets=(256,), tile_buckets=(4, 8, 16))
    _, whole = loaders(path, img_dir, **kw)
    want = take(whole, 5)
    _, first = loaders(path, img_dir, **kw)
    take(first, 1)
    saved = first.state.to_dict()
    assert saved["epoch"] == 0 and 0 < saved["cursor"] < 8
    _, resumed = loaders(path, img_dir, state_kw=saved, **kw)
    assert_batches_equal(take(resumed, 4), want[1:])


def test_loader_resume_at_epoch_end(tmp_path):
    """A state saved just as an epoch ran out (cursor == its length) goes on
    into the next epoch; the JAX loader raises there as if the epoch had
    yielded nothing."""
    path, img_dir = make_manifest(tmp_path, n=4)
    kw = dict(batch_size=2, seq_len=256, seq_buckets=(256,), tile_buckets=(4, 8, 16))
    _, whole = loaders(path, img_dir, **kw)
    want = take(whole, 4)
    _, first = loaders(path, img_dir, **kw)
    take(first, 2)
    saved = first.state.to_dict()
    assert saved == {"epoch": 0, "cursor": 4, "seed": 5}
    j, resumed = loaders(path, img_dir, state_kw=saved, **kw)
    assert_batches_equal(take(resumed, 2), want[2:])
    with pytest.raises(RuntimeError, match="every sample was rejected"):
        take(j, 1)


def test_loader_empty_epoch_raises(tmp_path):
    path, img_dir = make_manifest(tmp_path)
    j, t = loaders(path, img_dir, batch_size=2, seq_len=8, seq_buckets=(8,))
    for loader in (j, t):
        with pytest.raises(RuntimeError, match="epoch 0: every sample was rejected"):
            take(loader, 1)
