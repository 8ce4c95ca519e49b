"""The port's gossip optimizer (``repro_torch/core/gossip_optimizer.py``)
and partner schedules against the JAX package's on the same numpy-seeded
inputs.

Exact: ``partner_schedule`` and ``perms_for_step`` (every schedule, pods
with ``pod_every``), ``gossip_merge`` bit for bit on random trees
(float32 and bfloat16 leaves of per-peer rank 0-3, with the hypercube
pairing and with the identity) for every codec name and the legacy dtype
spellings, and ``step``. Within a tolerance: ``unstack_mean`` and
``peer_disagreement`` (rtol 1e-6: float32 sums in another order), and a
few train steps on ``tests/test_gossip_optimizer.py``'s quadratic loss
(mu, um, rw x sgd, sgdm, adamw) against the reference's jitted step:
parameters within 1e-5 of their largest value and the loss within rtol
1e-5 after 8 steps (measured up to 1.2e-7: XLA fuses the step, the port
runs it op by op). The convergence tests of
``tests/test_gossip_optimizer.py`` run on the port too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GossipConfig as JGossipConfig
from repro.core import gossip_optimizer as jgo
from repro.core import peer_sampling as jps
from repro.optim import constant as jconstant
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.config import GossipConfig
from repro_torch.core import gossip_optimizer as go
from repro_torch.core import peer_sampling as ps
from repro_torch.core.wire_codec import WIRE_CODECS
from repro_torch.kernels import gossip_cycle as gc
from repro_torch.optim import constant, make_optimizer
from repro_torch.utils.tree import tree_leaves

PEERS = 8


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(a):
    """An array's or a tensor's raw bits, for a bitwise comparison."""
    if isinstance(a, torch.Tensor):
        a = a.detach().view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.detach().numpy()
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def stacked_tree(seed, peers=PEERS):
    """Per-peer leaves of rank 0-3 stacked on a leading peer axis, float32
    and bfloat16, with a spread of scales (and a constant row, whose scale
    is zero) so every codec's rounding is exercised."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal((peers,) + s)
                    * rng.choice([1e-3, 1.0, 40.0], peers)
                    .reshape((peers,) + (1,) * len(s))).astype(np.float32)
    tree = {"scalar": f(), "vec": f(13), "mat": f(6, 33), "cube": f(3, 4, 5),
            "bf": [f(7, 9).astype(jnp.bfloat16), f(10).astype(jnp.bfloat16)],
            "const": np.full((peers, 2, 6), 0.25, np.float32)}
    return tree


PERM_CASES = {"hypercube": ps.hypercube_partner(1, PEERS),
              "identity": np.arange(PEERS)}
EXCHANGES = [None, ""] + sorted(WIRE_CODECS)
LEGACY = [(jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16),
          (jnp.int8, torch.int8), (jnp.float32, torch.float32)]


@pytest.mark.parametrize("kind", ["hypercube", "ring", "random"])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_partner_schedules_equal_the_reference(kind, n):
    for step in range(12):
        for seed in (0, 3):
            want = jps.partner_schedule(kind, step, n, seed)
            got = ps.partner_schedule(kind, step, n, seed)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ps.partner_schedule("star", 0, n)


def test_hypercube_needs_a_power_of_two():
    with pytest.raises(ValueError):
        ps.hypercube_partner(0, 6)


@pytest.mark.parametrize("schedule", ["hypercube", "ring", "random"])
@pytest.mark.parametrize("pods,pod_every", [(1, 8), (2, 2), (2, 3), (4, 1),
                                            (2, 0)])
def test_perms_for_step_equal_the_reference(schedule, pods, pod_every):
    kw = dict(schedule=schedule, pod_every=pod_every, seed=5)
    jcfg, cfg = JGossipConfig(**kw), GossipConfig(**kw)
    for step in range(9):
        jp, jpod = jgo.perms_for_step(jcfg, step, 16, n_pods=pods)
        p, pod = go.perms_for_step(cfg, step, 16, n_pods=pods)
        np.testing.assert_array_equal(p, jp)
        assert (pod is None) == (jpod is None)
        if pod is not None:
            np.testing.assert_array_equal(pod, jpod)
            assert pod.dtype == jpod.dtype


def test_gossip_config_equals_the_reference():
    assert (dataclasses.asdict(GossipConfig())
            == dataclasses.asdict(JGossipConfig()))


@pytest.mark.parametrize("perm", sorted(PERM_CASES))
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_gossip_merge_bitwise(exchange, perm):
    tree = stacked_tree(1)
    p = PERM_CASES[perm]
    want = jgo.gossip_merge(jax.tree.map(jnp.asarray, tree), p,
                            exchange_dtype=exchange)
    before = dict(gc.quantize_send.launches)
    got = go.gossip_merge(jax.tree.map(to_torch, tree), p,
                          exchange_dtype=exchange)
    assert gc.quantize_send.launches == before      # the CPU launches none
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(bits(g), bits(w))


@pytest.mark.parametrize("jdtype,tdtype", LEGACY)
def test_gossip_merge_legacy_dtypes_bitwise(jdtype, tdtype):
    tree = stacked_tree(2)
    p = PERM_CASES["hypercube"]
    want = jgo.gossip_merge(jax.tree.map(jnp.asarray, tree), p,
                            exchange_dtype=jdtype)
    got = go.gossip_merge(jax.tree.map(to_torch, tree), p,
                          exchange_dtype=tdtype)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(bits(g), bits(w))


def test_resolve_exchange():
    assert go._resolve_exchange(None) == (None, None)
    assert go._resolve_exchange("f32") == (None, None)
    assert go._resolve_exchange("bf16") == (None, torch.bfloat16)
    assert go._resolve_exchange("int8_sr")[0].name == "int8"
    assert go._resolve_exchange("int4_ef")[0].name == "int4_ef"
    assert go._resolve_exchange(torch.int8)[0].name == "int8"
    with pytest.raises(TypeError):
        go._resolve_exchange(3)
    with pytest.raises(ValueError):
        go._resolve_exchange("int3")


def test_gossip_merge_is_pairwise_average():
    params = {"w": torch.arange(8.0)[:, None] * torch.ones((8, 3))}
    merged = go.gossip_merge(params, (1, 0, 3, 2, 5, 4, 7, 6))
    torch.testing.assert_close(merged["w"][0], torch.full((3,), 0.5))
    assert float(merged["w"].sum()) == pytest.approx(float(params["w"].sum()))


def test_stack_unstack_and_disagreement_match_the_reference():
    tree = stacked_tree(3)
    jt, tt = jax.tree.map(jnp.asarray, tree), jax.tree.map(to_torch, tree)
    for g, w in zip(tree_leaves(go.unstack_mean(tt)),
                    jax.tree.leaves(jgo.unstack_mean(jt))):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()))
    assert float(go.peer_disagreement(tt)) == pytest.approx(
        float(jgo.peer_disagreement(jt)), rel=1e-6)
    one = {"a": np.float32(2.5) * np.ones((3, 4), np.float32),
           "b": np.ones((5,), np.float32).astype(jnp.bfloat16)}
    want = jgo.stack_for_peers(jax.tree.map(jnp.asarray, one), 4)
    got = go.stack_for_peers(jax.tree.map(to_torch, one), 4)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.is_contiguous()
        np.testing.assert_array_equal(bits(g), bits(w))
    assert float(go.peer_disagreement(got)) == 0.0


def quad_loss_j(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def quad_loss_t(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2), {}


@pytest.mark.parametrize("optimizer", ["sgd", "sgdm", "adamw"])
@pytest.mark.parametrize("merge", ["mu", "um", "rw"])
def test_train_steps_match_the_reference(merge, optimizer):
    rng = np.random.default_rng(7)
    w_true = rng.standard_normal(12).astype(np.float32)
    init = {"w": (0.1 * rng.standard_normal((PEERS, 12))).astype(np.float32),
            "b": np.zeros((PEERS,), np.float32)}
    jo = jmake_optimizer(optimizer, jconstant(0.05))
    to = make_optimizer(optimizer, constant(0.05))
    jcfg, cfg = JGossipConfig(merge=merge), GossipConfig(merge=merge)
    jfn = jax.jit(jgo.make_gossip_train_step(quad_loss_j, jo, PEERS, jcfg),
                  static_argnums=(2, 3))
    tfn = go.make_gossip_train_step(quad_loss_t, to, PEERS, cfg)
    jp = jax.tree.map(jnp.asarray, init)
    js = jgo.GossipState(jp, jo.init(jp), jnp.zeros((), jnp.int32))
    ts = go.GossipState(jax.tree.map(to_torch, init),
                        to.init(jax.tree.map(to_torch, init)),
                        torch.zeros((), dtype=torch.int32))
    for s in range(8):
        x = rng.standard_normal((PEERS, 16, 12)).astype(np.float32)
        b = {"x": x, "y": x @ w_true}
        perm, _ = jgo.perms_for_step(jcfg, s, PEERS)
        js, jl, _ = jfn(js, jax.tree.map(jnp.asarray, b),
                        tuple(int(v) for v in perm), None)
        ts, tl, _ = tfn(ts, jax.tree.map(to_torch, b), perm)
        assert int(ts.step) == int(js.step) == s + 1
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for g, w in zip(tree_leaves(ts.params) + tree_leaves(ts.opt_state),
                    jax.tree.leaves(js.params) + jax.tree.leaves(js.opt_state)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=1e-5 * max(float(np.abs(w).max()),
                                                   1e-30))


def _run(merge, steps=60, n_peers=8, schedule="hypercube", lr=0.1, seed=0):
    """``tests/test_gossip_optimizer.py::_run`` on the port, the data drawn
    with numpy."""
    rng = np.random.default_rng(seed)
    w_true = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    params = {"w": torch.zeros(12), "b": torch.zeros(())}
    sp = go.stack_for_peers(params, n_peers)
    opt = make_optimizer("sgd", constant(lr), grad_clip=0)
    cfg = GossipConfig(schedule=schedule, merge=merge)
    fn = go.make_gossip_train_step(quad_loss_t, opt, n_peers, cfg)
    state = go.GossipState(sp, opt.init(sp), torch.zeros((), dtype=torch.int32))
    loss = None
    for s in range(steps):
        x = torch.from_numpy(rng.standard_normal((n_peers, 16, 12))
                             .astype(np.float32))
        perm, _ = go.perms_for_step(cfg, s, n_peers)
        state, loss, _ = fn(state, {"x": x, "y": x @ w_true}, perm)
    return state, float(loss), w_true


@pytest.mark.parametrize("merge", ["mu", "um"])
def test_gossip_converges_with_low_disagreement(merge):
    state, loss, w_true = _run(merge)
    assert loss < 1e-3
    assert float(go.peer_disagreement(state.params)) < 1e-2
    err = float(torch.linalg.norm(go.unstack_mean(state.params)["w"] - w_true))
    assert err < 0.05


def test_rw_diverges_across_peers_more_than_mu():
    st_mu, _, _ = _run("mu", steps=30)
    st_rw, _, _ = _run("rw", steps=30)
    assert float(go.peer_disagreement(st_rw.params)) > \
        float(go.peer_disagreement(st_mu.params))


def test_pod_merge_runs_in_the_step():
    """A pod permutation merges once more after the step."""
    cfg = GossipConfig(merge="rw", pod_every=1)
    opt = make_optimizer("sgd", constant(0.0), grad_clip=0)
    fn = go.make_gossip_train_step(quad_loss_t, opt, 4, cfg)
    params = {"w": torch.arange(4.0)[:, None].repeat(1, 12),
              "b": torch.zeros(4)}
    state = go.GossipState(params, {}, torch.zeros((), dtype=torch.int32))
    x = torch.ones((4, 2, 12))
    perm, pod = go.perms_for_step(cfg, 0, 4, n_pods=2)
    state, _, _ = fn(state, {"x": x, "y": torch.zeros(4, 2)}, perm, pod)
    torch.testing.assert_close(state.params["w"][:, 0],
                               torch.tensor([1.0, 2.0, 1.0, 2.0]))


class _OnePeerMesh:
    """What the merge reads of a mesh: a ``data`` axis of one rank and a
    ``model`` axis of two."""
    mesh_dim_names = ("data", "model")
    mesh = torch.arange(2).reshape(1, 2)


@pytest.mark.parametrize("kw", [
    dict(mesh=_OnePeerMesh, peer_axes=("data",)),
    dict(mesh=_OnePeerMesh, peer_axes=("model",)),
    dict(mesh=_OnePeerMesh), dict(peer_axes=("data",))],
    ids=["size1", "size-not-perm", "no-axes", "no-mesh"])
def test_mesh_merge_falls_back_to_the_stacked_take(kw):
    """The reference's fallback: no mesh or no peer axis, a peer axis of
    size 1, or one whose size is not the permutation's, merges the whole
    stack on every rank (the stacked take), and the train step steps the
    stack."""
    tree = jax.tree.map(to_torch, stacked_tree(3))
    perm = PERM_CASES["hypercube"]
    want = go.gossip_merge(tree, perm, exchange_dtype="int8")
    got = go.gossip_merge(tree, perm, exchange_dtype="int8", **kw)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(bits(a), bits(b))
    opt = make_optimizer("sgd", constant(0.0), grad_clip=0)
    fn = go.make_gossip_train_step(quad_loss_t, opt, 4, GossipConfig(),
                                   **kw)
    params = {"w": torch.arange(4.0)[:, None].repeat(1, 12),
              "b": torch.zeros(4)}
    state = go.GossipState(params, {}, torch.zeros((), dtype=torch.int32))
    state, _, _ = fn(state, {"x": torch.ones((4, 2, 12)),
                             "y": torch.zeros(4, 2)}, np.array([1, 0, 3, 2]))
    torch.testing.assert_close(state.params["w"][:, 0],
                               torch.tensor([0.5, 0.5, 2.5, 2.5]))


def test_production_mesh_names_the_roadmap():
    """Without the fake group of its size, the production mesh raises and
    names the helper that starts it (``launch/mesh.py``)."""
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="start_fake_group"):
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_allreduce_step_matches_the_reference():
    rng = np.random.default_rng(9)
    w_true = rng.standard_normal(12).astype(np.float32)
    init = {"w": np.zeros(12, np.float32), "b": np.zeros((), np.float32)}
    jo, to = (jmake_optimizer("adamw", jconstant(0.05)),
              make_optimizer("adamw", constant(0.05)))
    jfn = jax.jit(jgo.make_allreduce_train_step(quad_loss_j, jo))
    tfn = go.make_allreduce_train_step(quad_loss_t, to)
    jp, tp = jax.tree.map(jnp.asarray, init), jax.tree.map(to_torch, init)
    js, ts = jo.init(jp), to.init(tp)
    for s in range(6):
        x = rng.standard_normal((32, 12)).astype(np.float32)
        b = {"x": x, "y": x @ w_true}
        jp, js, jl, _ = jfn(jp, js, jax.tree.map(jnp.asarray, b),
                            jnp.int32(s))
        tp, ts, tl, _ = tfn(tp, ts, jax.tree.map(to_torch, b),
                            torch.tensor(s, dtype=torch.int32))
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_refuse_grad_is_the_wrappers_shared_check():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        gc.refuse_grad("kernel", torch.zeros(3), None, x)
    with torch.no_grad():
        gc.refuse_grad("kernel", x)
    gc.refuse_grad("kernel", x.detach(), None)


def test_send_kernel_named_by_the_residual_passed():
    assert gc.send_kernel_name("int8") == "affine8"
    assert gc.send_kernel_name("int8_sr", ef=False) == "affine8"
    assert gc.send_kernel_name("int4_ef") == "packed_ef"
    assert gc.send_kernel_name("int4_ef", ef=False) == "packed"
    assert gc.send_kernel_name("ternary_ef", ef=False) == "packed"
    assert gc.send_kernel_name("ternary_ef", ef=True) == "packed_ef"
    assert gc.send_kernel_name("int4", ef=True) == "packed_ef"
    assert gc.send_kernel_name("ternary") == "packed"
