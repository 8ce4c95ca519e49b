"""The gossip optimizer's peer mesh (``gossip_merge(mesh=, peer_axes=)``,
``make_gossip_train_step(mesh=, peer_axes=)``, ``linear_gossip_mesh_step``)
against the port's stacked path and the JAX package.

One peer a rank, in spawned 2- and 4-rank ``gloo`` groups on the CPU
(``tests/torch_mesh_cases.py``, which imports no JAX; one group a size,
shared with ``test_torch_mesh_engine.py`` and by the xdist workers):

- ``gossip_merge`` on f32, bf16, int8, int4 and ternary, on a tree with a
  per-peer scalar (0-d on a rank), a vector (rank 1), a matrix and a
  bfloat16 matrix: each rank's result is its row of the port's stacked
  merge bit for bit, and of JAX's jitted ``gossip_merge`` within the
  stacked tests' bar (bit for bit, ``tests/test_torch_gossip_optimizer.py``);
- the train step on the quadratic toy (SGD with momentum; mu, um, rw, and
  mu with ``pod_perm`` on a ``("pod", "data")`` 2 x 2 mesh) is the
  stacked step bit for bit with ``grad_clip=0``; with the clip (and an
  int8 exchange) within 1e-6 of the largest parameter: the stacked norm
  sums every peer's squares leaf by leaf, the mesh sums a rank's and then
  the ranks'. The losses within rtol 1e-6 (the peers' mean is a psum).
  Every case, the pod and clip cases too, is held to the reference's
  jitted stacked step on the same data: losses within rtol 1e-6 and
  params within 1e-6 of the leaf's largest value (measured up to 1.1e-7
  on the CPU; XLA fuses the step, the port runs it op by op);
- ``linear_gossip_mesh_step`` (mu, um, rw, with and without a drop mask,
  ten cycles on the hypercube) equals, on every rank, JAX's
  ``learners.pegasos_update`` and the reference's merge applied to that
  peer within rtol 1e-6 (XLA's float32 against PyTorch's, op by op)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GossipConfig as JGossipConfig
from repro.core import gossip_optimizer as jgo
from repro.core.learners import LinearModel as JModel
from repro.core.learners import pegasos_update as jpegasos
from repro.optim import constant as jconstant
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.core import gossip_optimizer as go
from repro_torch.core import peer_sampling as ps
from torch_mesh_cases import (MERGE_EXCHANGES, peer_tree, shared_ranks,
                              train_config, train_data)

WORLDS = [2, 4]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory):
    out = shared_ranks(tmp_path_factory, request.param)
    return request.param, [r["gossip"] for r in out]


def bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    a = t.numpy()
    return a.view(f"u{a.dtype.itemsize}")


def to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("exchange", MERGE_EXCHANGES, ids=str)
def test_mesh_merge_is_the_stacked_merge_and_jax(ranks, exchange):
    world, out = ranks
    tree = peer_tree(1, world)
    perm = ps.hypercube_partner(1, world)
    stacked = go.gossip_merge(tree, perm, exchange_dtype=exchange)
    # jitted: the eager reference dispatches the codec op by op (~5 s)
    merge = jax.jit(lambda t: jgo.gossip_merge(t, perm,
                                               exchange_dtype=exchange))
    want = merge({k: to_jax(v) for k, v in tree.items()})
    for rank in range(world):
        got = out[rank]["merge"][exchange]
        for k in tree:
            assert got[k].shape == tree[k].shape[1:]
            assert got[k].dtype == tree[k].dtype
            np.testing.assert_array_equal(bits(got[k]),
                                          bits(stacked[k][rank]))
            w = np.asarray(want[k][rank])
            np.testing.assert_array_equal(
                bits(got[k]), w.view(f"u{w.dtype.itemsize}"))


def test_mesh_train_step_is_the_stacked_step(ranks):
    world, out = ranks
    cases = out[0]["train"]
    assert len(cases) == (5 if world == 4 else 4)
    for i, (case, _, (one_loss, one_params)) in enumerate(cases):
        for rank in range(world):
            c, (losses, params), _ = out[rank]["train"][i]
            assert c == case
            np.testing.assert_allclose(losses, one_loss, rtol=1e-6)
            for k, v in one_params.items():
                if case["clip"] == 0:
                    np.testing.assert_array_equal(bits(params[k]),
                                                  bits(v[rank]))
                else:
                    scale = float(v.abs().max())
                    np.testing.assert_allclose(params[k].numpy(),
                                               v[rank].numpy(), rtol=0,
                                               atol=1e-6 * scale)
        if case.get("pods"):        # the pod merge averaged pod partners
            assert torch.equal(one_params["w"][0], one_params["w"][2])


def quad_loss_j(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def _jax_train(world, case):
    """The reference's jitted stacked step on the train case's data:
    the losses and the final params, stacked by peer."""
    init, batches = train_data(world)
    cfg_kw, opt_kw, pods = train_config(case)
    jcfg = JGossipConfig(**cfg_kw)
    opt = jmake_optimizer(opt_kw["name"], jconstant(0.05),
                          grad_clip=opt_kw["grad_clip"])
    fn = jax.jit(jgo.make_gossip_train_step(quad_loss_j, opt, world, jcfg),
                 static_argnums=(2, 3))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = jgo.GossipState(params, opt.init(params),
                            jnp.zeros((), jnp.int32))
    losses = []
    for s, b in enumerate(batches):
        perm, pod = jgo.perms_for_step(jcfg, s, world, n_pods=pods)
        state, loss, _ = fn(state, {k: jnp.asarray(v) for k, v in b.items()},
                            tuple(int(v) for v in perm),
                            None if pod is None else
                            tuple(int(v) for v in pod))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in state.params.items()}


def test_mesh_train_step_matches_jax(ranks):
    """Every rank's losses and params against its row of the reference's
    jitted step on the same data, perms and ``pod_perm``."""
    world, out = ranks
    with jax.default_device(jax.devices("cpu")[0]):
        for i, (case, _, _) in enumerate(out[0]["train"]):
            want_loss, want = _jax_train(world, case)
            for rank in range(world):
                c, (losses, params), _ = out[rank]["train"][i]
                assert c == case
                np.testing.assert_allclose(losses, want_loss, rtol=1e-6)
                for k, v in want.items():
                    np.testing.assert_allclose(
                        params[k].numpy(), v[rank], rtol=0,
                        atol=1e-6 * float(np.abs(v).max()))


def _linear_reference(world, variant, drop):
    """``linear_gossip_mesh_step``'s ten cycles, every peer in turn, with
    the reference's merge and JAX's ``pegasos_update``."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((world, 3, 8)).astype(np.float32)
    y = np.sign(rng.standard_normal((world, 3))).astype(np.float32)
    drops = rng.random((10, world)) < 0.3
    w = [jnp.zeros(8, jnp.float32) for _ in range(world)]
    t = [jnp.zeros((), jnp.int32) for _ in range(world)]
    hist = []

    def merge(w, t, c):
        partner = ps.hypercube_partner(c, world)
        src = {int(partner[s]): s for s in range(world)}
        new_w, new_t = [], []
        for i in range(world):
            w_in, t_in = w[src[i]], t[src[i]]
            if drop and drops[c, i]:
                w_in, t_in = w[i], t[i]
            new_w.append((w[i] + w_in) / 2.0)
            new_t.append(jnp.maximum(t[i], t_in))
        return new_w, new_t

    def update(w, t):
        out = [jpegasos(JModel(w[i], t[i]), X[i][int(t[i]) % 3],
                        y[i][int(t[i]) % 3], 0.1) for i in range(world)]
        return [m.w for m in out], [m.t for m in out]

    for c in range(10):
        if variant == "mu":
            w, t = update(*merge(w, t, c))
        elif variant == "um":
            w, t = merge(*update(w, t), c)
        else:
            w, t = update(w, t)
        hist.append([(np.asarray(w[i]), int(t[i])) for i in range(world)])
    return hist


@pytest.mark.parametrize("variant", ["mu", "um", "rw"])
@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
def test_linear_mesh_step_matches_jax_per_peer(ranks, variant, drop):
    world, out = ranks
    with jax.default_device(jax.devices("cpu")[0]):
        want = _linear_reference(world, variant, drop)
    for rank in range(world):
        got = out[rank]["linear"][(variant, drop)]
        for c, (w, t) in enumerate(got):
            jw, jt = want[c][rank]
            assert t == jt
            np.testing.assert_allclose(w, jw, rtol=1e-6, atol=1e-7)
