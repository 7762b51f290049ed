"""The MoE layer under a device mesh (ops/moe.py: the expert-parallel
dispatch, dense and ragged, and the capacity path's global positions),
on gloo across spawned processes, against the JAX package's
`moe_layer` on its 8-device CPU platform.

Two meshes of four ranks, (data=2, expert=2) and (expert=2, model=2), the
JAX test_moe.py layer (4 experts top-2, hidden 16, ffn 32, fp32) on x [4,
16, 16]; each rank routes its rows, the loss Σ out · cot + aux + z:

  - dense worst case (`moe_ep_capacity_factor` 0) against JAX's EP run
    under `jax.set_mesh` at the same mesh: output, aux and z rtol 1e-4,
    atol 1e-5 (tests/test_moe.py:246-272), nothing dropped; gradients (x,
    router, the three expert banks) rtol 2e-4, atol 1e-5;
  - dense at `moe_ep_capacity_factor` 0.25, where the buckets drop rows:
    `fraction_dropped` equal to JAX's EP run's exactly, the output and
    gradients at the tolerances above (a row dropped otherwise would move
    its token's output by O(1));
  - ragged against JAX's dense worst case and its single-device dispatch
    (JAX runs no ragged all-to-all on the CPU);
  - the capacity path at factor 0.5 (drops) against JAX's, whose
    positions are a cumsum over the global batch;
  - planted faults that these checks catch: the aux statistics per rank
    (a mean of the ranks' products) and the capacity positions per rank.

The rows' routing is checked free of near ties (test_torch_moe.py's
NEAR_TIE) on the seed used, so that fp32 noise cannot flip a token's
experts between the packages.
"""

import numpy as np
import pytest
import torch

from test_torch_mesh import init_worker, run_world

E, K, H, F = 4, 2, 16, 32
X_SHAPE = (4, 16, 16)
SEED = 7
NEAR_TIE = 1e-5
MESHES = {"data2_expert2": dict(data=2, expert=2), "expert2_model2": dict(expert=2, model=2)}
# name: (dropless, capacity_factor, ep_capacity_factor, ragged, planted fault)
VARIANTS = {"dense": (True, 1.25, 0.0, False, None),
            "dense_cf025": (True, 1.25, 0.25, False, None),
            "ragged": (True, 1.25, 0.0, True, None),
            "capacity": (False, 0.5, 0.0, False, None),
            "fault_local_aux": (True, 1.25, 0.0, False, "local_aux"),
            "fault_local_positions": (False, 0.5, 0.0, False, "local_positions")}
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
LEAVES = ("x", "router", "w_gate", "w_up", "w_down")


def _planted(fault):
    """Patch ops/moe.py with a planted fault; returns the undo."""
    from leopard_tpu_torch.ops import moe

    if fault == "local_aux":
        real = moe.load_balancing_loss

        def per_rank(probs, ids, e, par=None):  # a mean of the ranks' own products
            return real(probs, ids, e) / (1 if par is None else par.token_shards)

        moe.load_balancing_loss = per_rank
        return lambda: setattr(moe, "load_balancing_loss", real)
    if fault == "local_positions":
        real = moe._global_positions
        moe._global_positions = lambda top_i, e, *a: (  # noqa: E731
            (torch.cumsum(torch.nn.functional.one_hot(top_i.reshape(-1), e), 0)
             * torch.nn.functional.one_hot(top_i.reshape(-1), e)).amax(-1) - 1
        ).reshape(top_i.shape)
        return lambda: setattr(moe, "_global_positions", real)
    return lambda: None


def _ep_worker(rank, world, store, mesh_kw, path, out_dir):
    """Every variant's layer on this rank's rows; saves this rank's output
    rows, input gradient, the global aux values and its shards of the
    parameter gradients (summed over the token axes, as the trainer's
    reduce_to_shard does)."""
    import torch.distributed as dist

    from leopard_tpu_torch.ops import moe
    from leopard_tpu_torch.parallel.launch import dp_rank_and_world
    from leopard_tpu_torch.parallel.mesh import Parallel

    mesh = init_worker(rank, world, store, mesh_kw)
    par = Parallel.of(mesh)
    data = np.load(path)
    r, n = dp_rank_and_world(mesh)
    b = X_SHAPE[0]
    rows = slice(r * b // n, (r + 1) * b // n)
    el, fl = E // par.ep_size, F // par.tp_size
    es, fs = slice(par.ep_rank * el, (par.ep_rank + 1) * el), slice(par.tp_rank * fl,
                                                                     (par.tp_rank + 1) * fl)
    shards = {"w_gate": (es, fs), "w_up": (es, fs), "w_down": (es, slice(None), fs)}
    saved = {"coords": np.asarray([r, par.ep_rank, par.tp_rank])}
    for name, (dropless, cf, ep_cf, ragged, fault) in VARIANTS.items():
        cfg = moe.MoEConfig(num_experts=E, top_k=K, capacity_factor=cf, dropless=dropless,
                            ep_capacity_factor=ep_cf, ep_ragged_a2a=ragged)
        x = torch.from_numpy(data["x"][rows]).requires_grad_()
        router = torch.from_numpy(data["router"]).requires_grad_()
        experts = {k: torch.from_numpy(np.ascontiguousarray(data[k][s])).requires_grad_()
                   for k, s in shards.items()}
        undo = _planted(fault)
        try:
            out, aux = moe.moe_layer(router, experts, cfg, x, par=par)
            ((out * torch.from_numpy(data["cot"][rows])).sum() + aux["aux_loss"]
             + aux["z_loss"]).backward()
        finally:
            undo()
        for k in ("aux_loss", "z_loss"):
            saved[f"{name}/{k}"] = par.sum_over_tokens(aux[k].detach().clone()).numpy()
        saved[f"{name}/fraction_dropped"] = aux["fraction_dropped"].numpy()
        saved[f"{name}/out"] = out.detach().numpy()
        saved[f"{name}/x"] = x.grad.numpy()
        saved[f"{name}/router"] = par.sum_over_tokens(router.grad).numpy()
        for k, v in experts.items():
            saved[f"{name}/{k}"] = par.sum_over_tokens(v.grad).numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **saved)
    dist.destroy_process_group()


def _assemble(out_dir, world, mesh_kw):
    """{variant: {out, aux values, the full gradients}} from the ranks'
    files: rows by data coordinate, expert banks by (expert, model)
    block."""
    files = [np.load(f"{out_dir}/rank{r}.npz") for r in range(world)]
    dp, ep, tp = mesh_kw.get("data", 1), mesh_kw.get("expert", 1), mesh_kw.get("model", 1)
    got = {}
    for name in VARIANTS:
        g = {"out": np.zeros(X_SHAPE, np.float32), "x": np.zeros(X_SHAPE, np.float32),
             "w_gate": np.zeros((E, F, H), np.float32), "w_up": np.zeros((E, F, H), np.float32),
             "w_down": np.zeros((E, H, F), np.float32)}
        for f in files:
            d, e, t = (int(c) for c in f["coords"])
            rows = slice(d * X_SHAPE[0] // dp, (d + 1) * X_SHAPE[0] // dp)
            g["out"][rows] = f[f"{name}/out"]
            g["x"][rows] = f[f"{name}/x"]
            es = slice(e * E // ep, (e + 1) * E // ep)
            fs = slice(t * F // tp, (t + 1) * F // tp)
            g["w_gate"][es, fs] = f[f"{name}/w_gate"]
            g["w_up"][es, fs] = f[f"{name}/w_up"]
            g["w_down"][es, :, fs] = f[f"{name}/w_down"]
        g["router"] = files[0][f"{name}/router"]
        for k in ("aux_loss", "z_loss", "fraction_dropped"):
            g[k] = float(files[0][f"{name}/{k}"])
            assert all(float(f[f"{name}/{k}"]) == g[k] for f in files), (name, k)
        got[name] = g
    return got


def _jax_inputs():
    import jax

    from leopard_tpu.ops import moe as jmoe

    cfg = jmoe.MoEConfig(num_experts=E, top_k=K, intermediate_size=F, hidden_size=H,
                         dtype="float32")
    params = jax.device_get(jmoe.init_params(cfg, jax.random.PRNGKey(SEED)))
    rng = np.random.RandomState(SEED)
    x = rng.randn(*X_SHAPE).astype(np.float32)
    cot = rng.randn(*X_SHAPE).astype(np.float32)
    return params, x, cot


def _jax_run(params, x, cot, dropless, cf, ep_cf, mesh_kw=None):
    """JAX's layer and its gradients, under `jax.set_mesh` at `mesh_kw`
    (the EP dispatch for dropless) or on one device; in the port's layout."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from leopard_tpu.config import MeshConfig
    from leopard_tpu.ops import moe as jmoe
    from leopard_tpu.parallel.mesh import build_mesh
    from leopard_tpu.parallel.sharding import param_shardings

    cfg = jmoe.MoEConfig(num_experts=E, top_k=K, capacity_factor=cf, dropless=dropless,
                         ep_capacity_factor=ep_cf, intermediate_size=F, hidden_size=H,
                         dtype="float32")

    def loss(p, xx):
        out, aux = jmoe.moe_layer(p, cfg, xx)
        return jnp.sum(out * cot) + aux["aux_loss"] + aux["z_loss"], (out, aux)

    run = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))
    if mesh_kw is None:
        (gp, gx), (out, aux) = run(params, jnp.asarray(x))
    else:
        mc = MeshConfig(**mesh_kw)
        mesh = build_mesh(mc, jax.devices()[:mc.num_devices])
        p = jax.device_put(params, param_shardings(params, mesh))
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None)))
        with jax.set_mesh(mesh):
            (gp, gx), (out, aux) = run(p, xs)
    gp, gx, out, aux = jax.device_get((gp, gx, out, aux))
    return {"out": np.asarray(out), "x": np.asarray(gx), "router": gp["router"]["w"].T,
            **{k: np.swapaxes(v, -1, -2) for k, v in gp["experts"].items()},
            **{k: float(v) for k, v in aux.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's variants at both meshes and JAX's references."""
    params, x, cot = _jax_inputs()
    logits = x.reshape(-1, H).astype(np.float64) @ params["router"]["w"].astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    assert ((p[:, K - 1] - p[:, K]) >= NEAR_TIE).all(), "near ties in the routing"
    tmp = tmp_path_factory.mktemp("moe_ep")
    path = str(tmp / "in.npz")
    np.savez(path, x=x, cot=cot, router=np.ascontiguousarray(params["router"]["w"].T),
             **{k: np.ascontiguousarray(np.swapaxes(v, -1, -2))
                for k, v in params["experts"].items()})
    port = {}
    for label, mesh_kw in MESHES.items():
        out_dir = tmp / label
        out_dir.mkdir()
        run_world(_ep_worker, 4, tmp, mesh_kw, path, str(out_dir))
        port[label] = _assemble(str(out_dir), 4, mesh_kw)
    ref = {"single_dropless": _jax_run(params, x, cot, True, 1.25, 0.0),
           "single_capacity": _jax_run(params, x, cot, False, 0.5, 0.0)}
    for label, mesh_kw in MESHES.items():
        for name, ep_cf in (("dense", 0.0), ("dense_cf025", 0.25)):
            ref[f"{label}/{name}"] = _jax_run(params, x, cot, True, 1.25, ep_cf, mesh_kw)
    return port, ref


def check(got, want, what):
    """The layer's output, aux values and gradients against a reference."""
    np.testing.assert_allclose(got["out"], want["out"], err_msg=f"{what}: out", **OUT_TOL)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what}: {k}", **OUT_TOL)
    assert got["fraction_dropped"] == want["fraction_dropped"], (
        what, got["fraction_dropped"], want["fraction_dropped"])
    for k in LEAVES:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what}: grad {k}", **GRAD_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dense_worst_case_matches_jax_ep(runs, mesh):
    port, ref = runs
    got = port[mesh]["dense"]
    assert got["fraction_dropped"] == 0.0
    check(got, ref[f"{mesh}/dense"], f"{mesh} dense")
    check(got, ref["single_dropless"], f"{mesh} dense vs one device")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dense_with_drops_matches_jax_ep_exactly(runs, mesh):
    port, ref = runs
    got, want = port[mesh]["dense_cf025"], ref[f"{mesh}/dense_cf025"]
    assert want["fraction_dropped"] > 0.0
    check(got, want, f"{mesh} dense at ep capacity factor 0.25")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ragged_matches_jax_dense_and_one_device(runs, mesh):
    port, ref = runs
    got = port[mesh]["ragged"]
    check(got, ref[f"{mesh}/dense"], f"{mesh} ragged vs JAX dense")
    check(got, ref["single_dropless"], f"{mesh} ragged vs one device")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_capacity_path_takes_global_positions(runs, mesh):
    port, ref = runs
    want = ref["single_capacity"]
    assert want["fraction_dropped"] > 0.0
    check(port[mesh]["capacity"], want, f"{mesh} capacity")


@pytest.mark.parametrize("fault,against", [("fault_local_aux", "single_dropless"),
                                           ("fault_local_positions", "single_capacity")])
def test_planted_faults_are_caught(runs, fault, against):
    """Per-rank statistics or positions differ from the global ones once
    the data axis splits the batch."""
    port, ref = runs
    with pytest.raises(AssertionError):
        check(port["data2_expert2"][fault], ref[against], fault)


def test_ep_capacity_and_plan():
    """JAX's bucket rows, and the plan's drops, kept rows and splits."""
    from leopard_tpu_torch.ops.moe import EPPlan, ep_capacity

    assert ep_capacity(32, 2, 0.25) == 8
    assert ep_capacity(64, 2, 0.25) == 8
    assert ep_capacity(64, 4, 2.0) == 32
    assert ep_capacity(6, 2, 1.0) == 8  # at least 8, even past T·k
    assert ep_capacity(64, 2, 0.0) == 64
    plan = EPPlan([[5, 4, 1, 2], [0, 3, 6, 7]], cap=8)
    assert plan.send(0) == [9, 3] and plan.send(1) == [3, 13]
    assert plan.kept(0, 0) == [5, 3] and plan.kept(1, 1) == [6, 2]
    assert plan.received(0) == [5, 6] and plan.received(1) == [7, 4]
    assert plan.dropped == 1 + 5
    ragged = EPPlan(plan.counts, cap=None)
    assert ragged.in_splits(0) == [9, 3] and ragged.out_splits(1) == [3, 13]
    assert ragged.dropped == 0


@pytest.mark.parametrize("ragged", [False, True])
def test_memory_ep_matches_one_device(ragged):
    """The virtual ranks of MemoryEP (every rank in one process) at ep
    = 2 and 4 against the single-device dropless dispatch: the same code
    the process groups run."""
    from leopard_tpu_torch.ops import moe

    g = torch.Generator().manual_seed(3)
    t, e = 64, 4
    x = torch.randn((t, H), generator=g)
    logits = torch.randn((t, e), generator=g)
    top_p, top_i = moe.router_top_k(logits, K)
    experts = {"w_gate": torch.randn((e, F, H), generator=g) / 4,
               "w_up": torch.randn((e, F, H), generator=g) / 4,
               "w_down": torch.randn((e, H, F), generator=g) / 6}
    want = moe._dropless_dispatch(experts, x, top_p, top_i)
    for ep in (2, 4):
        el, n = e // ep, t // ep
        mine = {r: {k: v[r * el:(r + 1) * el] for k, v in experts.items()} for r in range(ep)}
        parts = [slice(r * n, (r + 1) * n) for r in range(ep)]
        out, dropped = moe.dispatch_ep(
            moe.MemoryEP(ep), mine, {r: x[s] for r, s in enumerate(parts)},
            {r: top_p[s] for r, s in enumerate(parts)}, {r: top_i[s] for r, s in enumerate(parts)},
            e, None if ragged else moe.ep_capacity(n * K, ep, 0.0))
        assert dropped == 0
        torch.testing.assert_close(torch.cat([out[r] for r in range(ep)]), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tokens,ep,match", [(
    (3, 5), 2, r"B·S = 15 tokens must divide over the 2 token shards \(mesh axes "
               r"\('data', 'fsdp', 'seq', 'expert'\)\) for expert-parallel dispatch"),
    ((2, 6), 3, "4 experts must divide over expert-axis size 3")])
def test_ep_refusals_carry_jax_messages(tokens, ep, match):
    """JAX's two assertions of `_dropless_dispatch_ep`, as ValueErrors,
    raised before any collective."""
    from leopard_tpu_torch.ops import moe
    from leopard_tpu_torch.parallel.mesh import Parallel

    g = torch.Generator().manual_seed(0)
    x = torch.randn((*tokens, H), generator=g)
    experts = {"w_gate": torch.randn((E, F, H)), "w_up": torch.randn((E, F, H)),
               "w_down": torch.randn((E, H, F))}
    cfg = moe.MoEConfig(num_experts=E, top_k=K, dropless=True)
    with pytest.raises(ValueError, match=match):
        moe.moe_layer(torch.randn((E, H), generator=g), experts, cfg, x,
                      par=Parallel(ep_size=ep))
