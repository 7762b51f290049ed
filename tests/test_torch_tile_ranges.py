"""The tile-skipping rule of the port's flash kernels (K1 and K2),
`tile_ranges`, against a brute-force mask from `make_attention_mask`.

Sound: every pair the mask lets through lies in its q tile's kv range and
in its kv tile's q range, for any segment ids (contiguous, recurring as in
1, 2, 1, negative or larger than the sequence, all padding) with and without the causal band and a window. Tight
for contiguous segments (a packed row attending itself): every 8-row slice of a range holds a pair that
the mask lets through, so the kernels compute no tile that could be
skipped at that grain. The rule runs on the CPU; the kernels that read it
are held against their plain versions on the card
(tests/test_torch_flash_cuda.py, tests/test_torch_flash_bwd_cuda.py).
Also: the decoder computes one set of ranges for all its layers, ranges
that do not fit a call are refused, and segment ids changed between the
forward and the backward are caught.
"""

import numpy as np
import pytest
import torch

from leopard_tpu_torch.ops import flash_attention as tflash
from leopard_tpu_torch.ops.attention import make_attention_mask

LAYOUTS = ("none", "contiguous", "recurring", "odd_ids", "all_padding")
BANDS = {"full": (False, None), "causal": (True, None), "window": (False, 37),
         "causal_window": (True, 50)}


def _segments(layout, b, s, rng):
    if layout == "none":
        return None
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        if layout == "contiguous":  # samples packed from row 0, padding after
            cuts = np.sort(rng.choice(np.arange(1, s + 1), size=min(s, 3), replace=False))
            start = 0
            for sid, end in enumerate(cuts, start=1):
                seg[r, start:end] = sid
                start = end
        elif layout in ("recurring", "odd_ids"):  # runs whose ids come back, padding among them
            ids = [0, 1, 2, 3] if layout == "recurring" else [0, -5, 3, 10**6, s + 1]
            pos = 0
            while pos < s:
                n = int(rng.randint(1, 40))
                seg[r, pos:pos + n] = rng.choice(ids)
                pos += n
    return torch.from_numpy(seg)


def _mask(q_seg, kv_seg, sq, skv, causal, window):
    m = make_attention_mask(sq, skv, causal=causal, q_segment_ids=q_seg,
                            kv_segment_ids=kv_seg, sliding_window=window)
    return torch.ones((1, sq, skv), dtype=torch.bool) if m is None else m[:, 0]


def _case(layout, band, seed):
    rng = np.random.RandomState(seed)
    b, block = 2, int(rng.choice([16, 64, 128]))
    sq = int(rng.randint(1, 400))
    skv = sq if layout == "contiguous" or rng.rand() < 0.6 else int(rng.randint(1, 400))
    q_seg = _segments(layout, b, sq, rng)
    # packed rows attend themselves (q and kv ids the same row); otherwise
    # half the cases give the kv side ids of its own
    same = layout == "contiguous" or (skv == sq and rng.rand() < 0.5)
    kv_seg = q_seg if same else _segments(layout, b, skv, rng)
    causal, window = BANDS[band]
    rng_ = tflash.tile_ranges(q_seg, kv_seg, sq=sq, skv=skv, causal=causal, window=window,
                              block=block)
    return rng_, _mask(q_seg, kv_seg, sq, skv, causal, window), block, sq, skv


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranges_are_sound(layout, band, seed):
    ranges, mask, block, _, _ = _case(layout, band, seed)
    for r in range(mask.shape[0]):
        kv_of_q = ranges.kv_of_q[min(r, ranges.kv_of_q.shape[0] - 1)]
        q_of_kv = ranges.q_of_kv[min(r, ranges.q_of_kv.shape[0] - 1)]
        qi, kj = torch.nonzero(mask[r], as_tuple=True)
        lo, hi = kv_of_q[qi // block].unbind(-1)
        assert bool(((kj >= lo) & (kj < hi)).all()), "a pair outside its q tile's kv range"
        lo, hi = q_of_kv[kj // block].unbind(-1)
        assert bool(((qi >= lo) & (qi < hi)).all()), "a pair outside its kv tile's q range"


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("band", list(BANDS))
def test_ranges_are_tight_for_contiguous_segments(band, seed):
    ranges, mask, block, sq, skv = _case("contiguous", band, seed)
    grain = 8
    for r in range(mask.shape[0]):
        for t in range(-(-sq // block)):
            lo, hi = ranges.kv_of_q[r, t].tolist()
            rows = mask[r, t * block:(t + 1) * block]
            for j in range(lo // grain * grain, hi, grain):
                assert bool(rows[:, j:j + grain].any()), (t, lo, hi, j)
        for t in range(-(-skv // block)):
            lo, hi = ranges.q_of_kv[r, t].tolist()
            cols = mask[r, :, t * block:(t + 1) * block]
            for i in range(lo // grain * grain, hi, grain):
                assert bool(cols[i:i + grain].any()), (t, lo, hi, i)


def test_all_padding_tiles_get_empty_ranges():
    seg = torch.tensor([[1] * 70 + [0] * 186, [0] * 256]).int()
    ranges = tflash.tile_ranges(seg, seg, sq=256, skv=256, causal=True, block=64)
    assert ranges.kv_of_q[0].tolist() == [[0, 64], [0, 70], [0, 0], [0, 0]]
    assert ranges.q_of_kv[0].tolist() == [[0, 70], [64, 70], [0, 0], [0, 0]]
    assert ranges.kv_of_q[1].abs().sum() == 0 and ranges.q_of_kv[1].abs().sum() == 0


def test_ranges_without_segments_are_the_band_and_cached():
    a = tflash.tile_ranges(None, None, sq=300, skv=300, causal=True, window=100, block=128)
    b = tflash.tile_ranges(None, None, sq=300, skv=300, causal=True, window=100, block=128)
    assert a is b and a.q_uid is None and a.kv_uid is None
    assert a.kv_of_q[0].tolist() == [[0, 128], [29, 256], [157, 300]]
    assert a.q_of_kv[0].tolist() == [[0, 227], [128, 300], [256, 300]]


def test_uniform_ids_mark_mixed_padding_and_ragged_blocks():
    seg = torch.tensor([[3] * 64 + [3] * 10 + [4] * 54 + [5] * 64 + [0] * 64 + [6] * 20]).int()
    assert tflash.uniform_ids(seg, 64).tolist() == [[3, -1, 5, -1, -1]]


def test_decoder_passes_one_set_of_ranges_to_every_layer(monkeypatch):
    """The decoder computes the ranges of its segment ids once, next to its
    mask, and hands that one set to each layer's flash call."""
    from leopard_tpu_torch.config import TextConfig
    from leopard_tpu_torch.models import decoder as tdecoder

    cfg = TextConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=3,
                     num_heads=4, num_kv_heads=2, head_dim=16, dtype="float32",
                     attn_impl="flash", sliding_window=5)
    torch.manual_seed(0)
    model = tdecoder.Decoder(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.05)
    seen = []

    def recording_flash(*args, ranges=None, **kw):
        seen.append(ranges)
        return tflash.flash_attention(*args, ranges=ranges, **kw)

    monkeypatch.setattr(tdecoder, "flash_attention", recording_flash)
    seg = torch.tensor([[1] * 9 + [2] * 7 + [0] * 4, [3] * 20]).int()
    tokens = torch.randint(0, 64, (2, 20), generator=torch.Generator().manual_seed(1))
    model(tokens, segment_ids=seg)
    assert len(seen) == cfg.num_layers and all(r is seen[0] for r in seen)
    want = tflash.tile_ranges(seg, seg, sq=20, skv=20, causal=True, window=5)
    for got, ref in zip(seen[0], want):
        assert torch.equal(got, ref)


def test_passed_ranges_must_fit_the_call():
    """The kernels index the ranges unchecked, so ranges of another shape,
    or made without the call's segments, are refused before a launch."""
    q = torch.zeros((2, 300, 4, 16))
    k = torch.zeros((2, 200, 2, 16))
    seg_q, seg_kv = torch.ones((2, 300), dtype=torch.int32), torch.ones((2, 200), dtype=torch.int32)
    fit = tflash.tile_ranges(seg_q, seg_kv, sq=300, skv=200, causal=False)
    assert tflash._ranges(q, k, fit, False, None, seg_q, seg_kv) is fit
    made = tflash._ranges(q, k, None, False, None, seg_q, seg_kv)
    assert all(torch.equal(a, b) for a, b in zip(made, fit))
    for wrong, segs in (
            (tflash.tile_ranges(seg_kv, seg_q, sq=200, skv=300, causal=False), (seg_q, seg_kv)),
            (tflash.tile_ranges(None, None, sq=300, skv=200, causal=False), (seg_q, seg_kv)),
            (fit, (None, None)),
            (fit._replace(kv_of_q=fit.kv_of_q.long()), (seg_q, seg_kv))):
        with pytest.raises(ValueError, match="ranges do not fit"):
            tflash._ranges(q, k, wrong, False, None, *segs)


def test_segment_ids_changed_before_the_backward_are_refused():
    """The backward reads tile ranges made from the forward's segment ids;
    those ids are saved for it, so an in-place change in between is caught
    by autograd instead of reaching the backward."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((1, 24, 2, 16), generator=g, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    seg = torch.tensor([[1] * 10 + [2] * 14]).int()
    out = tflash.flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
    seg[0, :5] = 2
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        out.sum().backward()
