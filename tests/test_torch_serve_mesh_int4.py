"""int4 weights cut per rank under tensor parallelism
(ops/quant.py::int4_block, parallel/sharding.py::tp_local_model), and the
CLIP VLM served at model=2, against the plain port engine and the JAX
package's `Engine(mesh=)` (which replicates int4 leaves: the same numbers
up to the order of the model group's sums).

  - each rank's dequantized int4 block equals the whole leaf's dequantized
    rows (row-parallel: wo, w_down, repacked split-half) or columns
    (column-parallel: wq, wk, wv, w_gate, w_up, the head) bit for bit, at
    model = 2, 4 and 8, the head of 1,000 columns cut into blocks that are
    padded to whole 128-column tiles with their own `n` (padding live at
    every size); a block that would split a scale group raises;
  - gloo worlds: model=2 with int4 weights, the CLIP VLM at model=2, and
    fsdp=2 × model=2 with int4 weights (a world of 4): greedy tokens equal
    to the plain engine's and JAX's on every rank;
  - a planted fault, one rank's row-parallel blocks taken from the wrong
    half of their packed bytes: its tokens must differ.
"""

import numpy as np
import pytest
import torch

from leopard_tpu_torch import config as tcfgs

from test_torch_mesh import _Coord
from test_torch_serve_mesh import FAULT, VOCAB, assert_case, run_cases

torch.set_num_threads(2)
ROW_PARALLEL = ("attn.wo", "mlp.w_down")
COLUMN_PARALLEL = ("attn.wq", "attn.wk", "attn.wv", "mlp.w_gate", "mlp.w_up", "lm_head")


def _dequantized(w):
    from leopard_tpu_torch.ops.quant import _unpack_int4

    return _unpack_int4(w.q4, w.s)[:, :w.n]  # [K, N] fp32


def _int4_model(cfg):
    from leopard_tpu_torch.models import vlm
    from leopard_tpu_torch.ops.quant import quantize_tree

    model = vlm.init_params(cfg, torch.Generator().manual_seed(0))
    quantize_tree(model.text, mode="int4")
    return model


def _wide(mod):
    """tiny_vlm with K wide enough for 8 ranks of whole 128-row groups:
    hidden 1,024, 16 heads of 64 (wo's K 1,024), MLP 2,048, one layer,
    vocabulary 1,000."""
    import dataclasses

    cfg = mod.tiny_vlm(vocab_size=VOCAB)
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hidden_size=1024, intermediate_size=2048, num_heads=16, num_kv_heads=8,
        head_dim=64, num_layers=1), projector=dataclasses.replace(cfg.projector,
                                                                    hidden_size=1024))


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_rank_blocks_equal_the_whole_leaf_bit_for_bit(tp):
    from leopard_tpu_torch.parallel.sharding import _chunk, tp_local_model

    model = _int4_model(_wide(tcfgs))
    whole = {name: _dequantized(m) for name, m in model.text.named_modules()
             if hasattr(m, "q4")}
    locals_ = [tp_local_model(model, _Coord(dict(model=r), model=tp)) for r in range(tp)]
    for name, w in whole.items():
        leaf = name.split("layers.0.")[-1]
        k, n = w.shape
        for r, local in enumerate(locals_):
            m = local.text.get_submodule(name)
            got = _dequantized(m)
            if leaf in ROW_PARALLEL:
                lo, length = _chunk(k, tp, r)
                want = w[lo:lo + length]
            else:
                assert leaf in COLUMN_PARALLEL, name
                lo, length = _chunk(n, tp, r)
                want = w[:, lo:lo + length]
                assert m.n == length and m.q4.shape[1] % 128 == 0
            assert torch.equal(got, want), (name, r)
            assert m.q4.is_contiguous() and m.q4.untyped_storage().data_ptr() != \
                model.text.get_submodule(name).q4.untyped_storage().data_ptr()
    # the head: 1,000 columns in blocks of ceil(1000 / tp), each padded
    heads = [local.text.lm_head for local in locals_]
    assert [h.n for h in heads] == [_chunk(VOCAB, tp, r)[1] for r in range(tp)]
    assert all(h.padded for h in heads)


def test_a_block_that_splits_a_scale_group_raises():
    from leopard_tpu_torch.models.params import QuantizedWeight
    from leopard_tpu_torch.ops.quant import int4_block, quantize_int4

    w = QuantizedWeight(quantize_int4(torch.randn(256, 512), group=128))  # K 512, 4 groups
    int4_block(w, "rows", 128, 128)
    with pytest.raises(ValueError, match=r"K=512, N=256.*groups of 128.*\[64, 192\)"):
        int4_block(w, "rows", 64, 128)


def test_row_block_repacks_split_half():
    """A row block's bytes hold block row i low and block row i + K_r/2
    high, and the fault of test_torch_serve_mesh (the halves swapped) reads
    other rows."""
    from leopard_tpu_torch.models.params import QuantizedWeight
    from leopard_tpu_torch.ops.quant import _unpack_int4, int4_block, quantize_int4

    from test_torch_serve_mesh import _wrong_half

    w = QuantizedWeight(quantize_int4(torch.randn(128, 1024), group=128))
    whole = _unpack_int4(w.q4, w.s)
    for lo in (0, 256, 512, 768):
        block = int4_block(w, "rows", lo, 256)
        assert block["q4"].shape == (128, 128)
        codes = torch.cat([block["q4"] & 15, block["q4"] >> 4]).to(torch.int8) - 8
        assert torch.equal(codes.float() * block["s"].repeat_interleave(128, 0),
                           whole[lo:lo + 256])
        bad = _wrong_half(int4_block)(w, "rows", lo, 256)
        assert not torch.equal(_unpack_int4(bad["q4"], bad["s"]), whole[lo:lo + 256])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("serve_int4"), ("model2_int4", "model2_clip", FAULT))


@pytest.mark.parametrize("label", ["model2_int4", "model2_clip"])
def test_engine_on_model_axis_matches_plain_and_jax(runs, label):
    assert_case(runs, label)


def test_wrong_half_fault_fails_the_token_check(runs):
    """Rank 1 serves its row-parallel int4 blocks from the wrong nibbles:
    the model group's sums are wrong on both ranks, so are the tokens."""
    got, ref = runs
    want = ref["model2_int4/plain"]
    for out in got.values():
        assert not np.array_equal(out[f"{FAULT}/tokens"], want)


def test_fsdp2_model2_int4_world_of_4(tmp_path):
    assert_case(run_cases(tmp_path, ("fsdp2_model2_int4",), world=4), "fsdp2_model2_int4")
