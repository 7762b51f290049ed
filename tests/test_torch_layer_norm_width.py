"""The load width K3b (csrc/layer_norm.cu) is launched with,
`fused_norms.vector_bytes`, on the CPU: the widest of 16, 8, 4 or 2 bytes
that divides the row's bytes, the base addresses and the row strides,
preferring a width that splits the row evenly over a warp's 32 lanes."""

import pytest
import torch

from leopard_tpu_torch.ops import fused_norms

CASES = {
    # name: (row bytes, offsets, width)
    "tower_1152_bf16": (2304, (0, 1 << 20, 2304, 2304), 8),   # 288 8-byte vectors, 9 a lane
    "clip_1024_bf16": (2048, (0, 4096, 2048, 2048), 16),       # 128 16-byte vectors, 4 a lane
    "tower_1152_fp32": (4608, (0, 4608, 4608), 16),            # 288 16-byte vectors
    "uneven_16_bytes": (2000, (0, 2000), 16),                  # 1,000 bf16: 125 vectors, no even split
    "strided_view_bf16": (2304, (20, 2400, 2304), 4),          # buf[:, 10:1162] of a [., 1200] buffer
    "odd_element_offset_bf16": (200, (2, 202), 2),             # buf[:, 1:101] of a [., 101] buffer
    "odd_element_offset_fp32": (400, (4, 404), 4),             # the same in fp32: scalar loads
    "odd_width_bf16": (202, (0, 202), 2),                      # 101 elements
    "width_100_bf16": (200, (0, 200), 8),                      # 25 8-byte vectors
    "max_width_bf16": (32768, (0, 32768), 16),
    "one_row_no_strides": (2304, (0,), 8),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_vector_bytes(case):
    row_bytes, offsets, want = CASES[case]
    assert fused_norms.vector_bytes(row_bytes, *offsets) == want


def test_strided_view_is_not_copied():
    """The wrapper reads a row-strided view as it is: `_rows` keeps the view,
    and the width comes from its own base and stride."""
    buf = torch.zeros((4, 1200), dtype=torch.bfloat16)
    x = buf[:, 10:1162]
    w, b = torch.ones(1152, dtype=torch.bfloat16), torch.zeros(1152, dtype=torch.bfloat16)
    x2 = fused_norms._rows(x, (w, b))
    assert x2.data_ptr() == x.data_ptr() and x2.stride() == (1200, 1)
    offset = x2.data_ptr() - buf.data_ptr()
    assert fused_norms.vector_bytes(1152 * 2, offset, 1200 * 2, 1152 * 2) == 4
