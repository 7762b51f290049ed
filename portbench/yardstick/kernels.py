"""Which device kernels belong to which of the port's operations, by the
kernel names the profiler records (csrc/*.cu).

K1 is `leopard::flash_attention_fwd`'s forward, csrc/flash_attention.cu's
`flash_fwd_kernel`; K2, the op's registered backward, is
csrc/flash_attention_bwd.cu's `delta_kernel`, `flash_bwd_dq_kernel` and
`flash_bwd_dkv_kernel`.
"""

import re

K1 = re.compile(r"flash_fwd_kernel")
K2 = re.compile(r"flash_bwd_dq_kernel|flash_bwd_dkv_kernel|delta_kernel")


def attention_kernel(name: str) -> bool:
    """A kernel of K1 or K2."""
    return bool(K1.search(name) or K2.search(name))
