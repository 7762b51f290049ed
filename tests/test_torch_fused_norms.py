"""The fused norms (K3a/K3b) on the CPU against the JAX package's Pallas
`fused_rms_norm` / `fused_layer_norm`, run in interpret mode: the forward,
and the gradients of x, the scale and the bias.

Two routes of the port are checked: the wrapper on a CPU tensor (the plain
version under torch autograd), and the kernel's autograd function with its
launch swapped for the plain version, so that its hand-written backward (a
VJP of the plain version, as `_rms_bwd`/`_ln_bwd` are) runs here too.
Tolerance rtol 1e-5, atol 1e-6 forward (the JAX norm tests'), rtol 1e-4,
atol 1e-5 for gradients: fp32 on both sides, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leopard_tpu.ops.pallas.norms import fused_layer_norm as j_ln
from leopard_tpu.ops.pallas.norms import fused_rms_norm as j_rms
from leopard_tpu_torch.ops import fused_norms
from leopard_tpu_torch.ops import norms as tnorms

torch.set_num_threads(2)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

CASES = {
    # name: (kind, x shape, eps)
    "rms_decoder_rows": ("rms", (2, 8, 64), 1e-5),
    "rms_odd_width": ("rms", (5, 72), 1e-6),
    "ln_tower_rows": ("ln", (3, 7, 48), 1e-6),
    "ln_odd_width": ("ln", (4, 100), 1e-5),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    kind, shape, eps = CASES[request.param]
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    params = [rng.randn(shape[-1]).astype(np.float32) for _ in range(1 if kind == "rms" else 2)]
    g = rng.randn(*shape).astype(np.float32)

    def jfn(x, *p):
        return j_rms(x, *p, eps) if kind == "rms" else j_ln(x, *p, eps)

    with pltpu.force_tpu_interpret_mode():
        out = jfn(jnp.asarray(x), *map(jnp.asarray, params))
        grads = jax.grad(lambda *a: jnp.sum(jfn(*a) * g), argnums=tuple(range(1 + len(params))))(
            jnp.asarray(x), *map(jnp.asarray, params))
    return dict(kind=kind, eps=eps, x=x, params=params, g=g, out=np.asarray(out),
                grads=[np.asarray(a) for a in grads])


def _check(case, fn):
    x = torch.from_numpy(case["x"]).requires_grad_()
    params = [torch.from_numpy(p).requires_grad_() for p in case["params"]]
    out = fn(x, *params)
    np.testing.assert_allclose(out.detach().numpy(), case["out"], **FWD_TOL)
    got = torch.autograd.grad(out, (x, *params), torch.from_numpy(case["g"]))
    for a, want in zip(got, case["grads"]):
        np.testing.assert_allclose(a.numpy(), want, **GRAD_TOL)


def test_wrapper_on_cpu_matches_jax(case):
    if case["kind"] == "rms":
        _check(case, lambda x, w: tnorms.rms_norm(x, w, case["eps"]))
    else:
        _check(case, lambda x, w, b: tnorms.layer_norm(x, w, b, case["eps"]))


def test_kernel_autograd_matches_jax(case, monkeypatch):
    def plain_launch(kind, x, params, eps):
        ref = tnorms.rms_norm_ref if kind == "rms" else tnorms.layer_norm_ref
        return ref(x, *params, eps)

    monkeypatch.setattr(fused_norms, "_launch", plain_launch)
    _check(case, lambda x, *p: fused_norms._FusedNorm.apply(case["kind"], case["eps"], x, *p))
