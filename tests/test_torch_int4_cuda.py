"""The Hopper int4 matmul kernel (K4) against its plain version, on the card.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_int4_cuda.py
"""

import functools

import pytest
import torch

from leopard_tpu_torch.models.params import QuantizedWeight
from leopard_tpu_torch.ops import int4_matmul as tk4
from leopard_tpu_torch.ops import quant as tquant

# Leopard-LLaVA-8B's decode matmuls (K, N): wq/wo, wk/wv, gate/up, down, lm_head
SHAPES_8B = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024), "gate_up": (4096, 14336),
             "down": (14336, 4096), "lm_head": (4096, 128256)}
# the kernel against the fp32 oracle x_bf16 @ ((q - 8) * s): both take the
# same bf16 x and exact weights, and differ only in where fp32 sums round
# (the kernel folds each 128-row group's product in with its scale); outputs
# have std ~1. A bf16 rounding of the scales or weights would move them by
# ~2^-9 relative, ~1e-3, ten times this tolerance.
ORACLE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=2)
def _weight_8b(name):
    """A seeded quantized weight of one 8B shape on the card, kept for the
    next test of the same shape."""
    k, n = SHAPES_8B[name]
    g = torch.Generator(device="cuda").manual_seed(k + n)
    w = torch.randn((n, k), generator=g, device="cuda") * k**-0.5
    q = tquant.quantize_int4(w)
    return q["q4"], q["s"]


def _x(m, k, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((m, k), generator=g, device="cuda").to(dtype)


def _oracle(x, q4, s):
    return x.to(torch.bfloat16).float() @ tquant._unpack_int4(q4, s)


def _operands(m, k, n, dtype, device, seed=0, group=128):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device).to(dtype)
    w = torch.randn((n, k), generator=g, device=device) * k**-0.5  # port layout [N, K]
    q = tquant.quantize_int4(w, group=group)
    return x, q["q4"], q["s"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [128, 384, 1024])
@pytest.mark.parametrize("k", [256, 512, 14336])
@pytest.mark.parametrize("m", [1, 3, 17, 64])
def test_kernel_matches_plain_on_card(cuda, m, k, n, dtype):
    x, q4, s = _operands(m, k, n, dtype, cuda, seed=m + k + n)
    before = tk4.int4_matmul.launches
    got = tk4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert tk4.int4_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = tk4.int4_matmul_ref(x, q4, s)
    # outputs have std ~1; the plain version rounds each weight to bf16
    # (2^-9 relative), the kernel keeps it in fp32, and the sums run in
    # another order
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_kernel_is_deterministic_on_card(cuda):
    x, q4, s = _operands(2, 4096, 1024, torch.bfloat16, cuda)  # K split across blocks
    a = tk4.int4_matmul(x, q4, s)
    b = tk4.int4_matmul(x, q4, s)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_matmul_takes_the_kernel_tier_on_card(cuda):
    x, q4, s = _operands(2, 512, 256, torch.bfloat16, cuda)
    w = QuantizedWeight({"q4": q4, "s": s})
    before = tk4.int4_matmul.launches
    y = tquant.matmul(x[:, None], w)  # [B, 1, K], a decode step
    assert tk4.int4_matmul.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (2, 1, 256)
    xp = torch.randn((65, 512), device=cuda, dtype=torch.bfloat16)  # M > 64: dense path
    tquant.matmul(xp, w)
    assert tk4.int4_matmul.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["m65", "group64", "n_not_128"])
def test_unsupported_shapes_raise_on_card(cuda, case):
    shape = {"m65": (65, 256, 128), "group64": (2, 256, 128), "n_not_128": (2, 256, 192)}[case]
    x, q4, s = _operands(*shape, torch.bfloat16, cuda,
                         group=64 if case == "group64" else 128)
    before = tk4.int4_matmul.launches
    with pytest.raises(ValueError):
        tk4.int4_matmul(x, q4, s)
    assert tk4.int4_matmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8])
def test_mistral_head_padded_to_whole_tiles_on_card(cuda, m):
    """Mistral's head, K = 4,096 and N = 32,003: quantized, it is held
    padded to 32,128 columns, and quant.matmul takes K4 at that width and
    slices the product back, against the plain version on the same padded
    weight and against the fp32 oracle."""
    k, n = 4096, 32003
    g = torch.Generator(device="cuda").manual_seed(n)
    w = QuantizedWeight(tquant.quantize_int4(
        torch.randn((n, k), generator=g, device="cuda") * k**-0.5))
    assert w.q4.shape == (k // 2, 32128) and w.n == n
    x = _x(m, k, seed=m)
    before = tk4.int4_matmul.launches
    got = tquant.matmul(x.float(), w)
    assert tk4.int4_matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.float32
    want = tk4.int4_matmul_ref(x.cpu(), w.q4.cpu(), w.s.cpu())[:, :n].to("cuda")
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got, _oracle(x, w.q4, w.s)[:, :n], **ORACLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8, 9, 64])
@pytest.mark.parametrize("name", list(SHAPES_8B))
def test_decode_shapes_match_plain_on_card(cuda, name, m):
    """Every 8B decode shape (lm_head N = 128,256, down K = 14,336) at the
    M the kernel's n tiles switch at."""
    q4, s = _weight_8b(name)
    x = _x(m, 2 * q4.shape[0], seed=m)
    got = tk4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert got.shape == (m, q4.shape[1]) and torch.isfinite(got).all()
    torch.testing.assert_close(got, tk4.int4_matmul_ref(x, q4, s), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 64])
@pytest.mark.parametrize("name", list(SHAPES_8B))
def test_kernel_matches_the_fp32_oracle_on_card(cuda, name, m):
    """Scales enter in fp32 and weights as exact integers: the kernel sits
    within ORACLE_TOL of x_bf16 @ ((q - 8) * s) in fp32, much closer than
    its plain version (weights rounded to bf16) can."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q4, s = _weight_8b(name)
    x = _x(m, 2 * q4.shape[0], seed=100 + m)
    torch.testing.assert_close(tk4.int4_matmul(x, q4, s), _oracle(x, q4, s), **ORACLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,split", [(4096, 1024, True), (512, 33792, False)],
                         ids=["split", "unsplit"])
def test_kernel_repeats_bit_for_bit_on_card(cuda, k, n, split):
    """The split sum runs in split order, whatever block finishes last."""
    assert (tk4.plan_splits(2, k, n)[0] > 1) == split
    x, q4, s = _operands(2, k, n, torch.bfloat16, cuda, seed=7)
    first = tk4.int4_matmul(x, q4, s)
    for _ in range(5):
        assert torch.equal(tk4.int4_matmul(x, q4, s), first)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(4096, 1024), (512, 33792), (4096, 4096)])
@pytest.mark.parametrize("m", [2, 40])
def test_bf16_output_is_the_f32_output_rounded_once_on_card(cuda, k, n, m):
    x, q4, s = _operands(m, k, n, torch.bfloat16, cuda, seed=11)
    before = tk4.int4_matmul.launches
    got = tk4.int4_matmul(x, q4, s, out_dtype=torch.bfloat16)
    assert tk4.int4_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tk4.int4_matmul(x, q4, s).to(torch.bfloat16))


@pytest.mark.cuda
def test_plan_cache_follows_each_weight_on_card(cuda):
    """Two weights of one shape at different pointers each get their own
    product; a weight edited in place is read as it is now."""
    x, q4a, sa = _operands(2, 4096, 1024, torch.bfloat16, cuda, seed=1)
    _, q4b, sb = _operands(2, 4096, 1024, torch.bfloat16, cuda, seed=2)
    for q4, s in ((q4a, sa), (q4b, sb), (q4a, sa)):
        torch.testing.assert_close(tk4.int4_matmul(x, q4, s), _oracle(x, q4, s), **ORACLE_TOL)
    q4a.copy_(q4b)
    sa.mul_(0.5)
    torch.testing.assert_close(tk4.int4_matmul(x, q4a, sa), _oracle(x, q4a, sa), **ORACLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["offset", "strided"])
def test_x_that_bulk_copies_cannot_read_is_copied_on_card(cuda, case):
    _, q4, s = _operands(2, 512, 256, torch.bfloat16, cuda)
    base = _x(4, 512, seed=3)
    x = base.view(-1)[1:1 + 2 * 512].view(2, 512) if case == "offset" else base[::2]
    assert x.data_ptr() % 16 or not x.is_contiguous()
    torch.testing.assert_close(tk4.int4_matmul(x, q4, s), _oracle(x, q4, s), **ORACLE_TOL)


@pytest.mark.cuda
def test_split_calls_on_two_streams_on_card(cuda):
    """A K split sums through a workspace kept per stream: a split call on a
    side stream, queued while the default stream runs one, gives the same
    bits."""
    x, q4, s = _operands(2, 4096, 1024, torch.bfloat16, cuda, seed=5)
    assert tk4.plan_splits(2, 4096, 1024)[0] > 1
    want = tk4.int4_matmul(x, q4, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = tk4.int4_matmul(x, q4, s)
    again = tk4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
