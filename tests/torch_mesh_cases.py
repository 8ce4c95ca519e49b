"""The rank bodies of the mesh tests (``tests/test_torch_mesh_*.py``).

``mesh_ranks`` runs in every rank of a spawned ``gloo`` group
(``repro_torch.launch.mesh.run_ranks``), on the CPU: the node mesh's
cases (``engine_ranks``) and the peer mesh's (``gossip_ranks``), one
group a size for both files. It returns what the parent tests compare.
The ranks also run the one-process counterparts (the one-device engine,
a case a rank in turn; the stacked step on rank 0), so both sides of a
bit-for-bit comparison run in processes with one thread. The groups of
every size (``GROUPS``) start together, once a test session
(``shared_ranks``). This module imports neither JAX nor the JAX package:
the children never load them.
"""
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from filelock import FileLock

from repro_torch.config import GossipConfig
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core import gossip_optimizer as go
from repro_torch.core import peer_sampling as ps
from repro_torch.core.simulation import run_simulation
from repro_torch.core.telemetry import Telemetry
from repro_torch.data.synthetic import make_linear_dataset
from repro_torch.launch.mesh import (make_mesh, make_smoke_mesh,
                                     mesh_axis_sizes, num_chips, run_ranks)
from repro_torch.optim import constant, make_optimizer


def mesh_ranks(rank, world):
    """Both files' rank bodies in one group."""
    return {"engine": engine_ranks(rank, world),
            "gossip": gossip_ranks(rank, world)}


def shared_ranks(tmp_path_factory, world: int):
    """The results of the ``world``-rank group of ``GROUPS``, once a test
    session: the first xdist worker to ask starts every group at once
    (each with a 240 s limit and 60 s a collective) and keeps their
    results, or the error of a group that failed, for the others."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"mesh_groups_{world}.pkl"
    with FileLock(str(root / "mesh_groups.lock")):
        if not path.is_file():
            with ThreadPoolExecutor(len(GROUPS)) as pool:
                runs = {w: pool.submit(run_ranks, fn, w, device_type="cpu",
                                       timeout_s=240.0, pg_timeout_s=60.0)
                        for w, fn in GROUPS.items()}
                for w, run in runs.items():
                    try:
                        kept = ("ok", run.result())
                    except Exception as e:      # each test that reads it
                        kept = ("error", f"{type(e).__name__}: {e}")
                    with open(root / f"mesh_groups_{w}.pkl", "wb") as f:
                        pickle.dump(kept, f)
    with open(path, "rb") as f:
        status, out = pickle.load(f)
    if status != "ok":
        raise RuntimeError(f"the {world}-rank group failed: {out}")
    return out


# tests/test_sharded_engine.py's mesh setup: N = 128, d = 16, drop 0.3,
# delay <= 4 (d outside 5..8, where a screen's sum order would depend on
# the row count)
N, DIM = 128, 16
RUN = dict(cycles=20, eval_every=10, seed=6)
ENGINE_CASES = (
    [dict(mode=m, wire=w) for m in ("dense", "compact", "compact_all")
     for w in (None, "int8_sr", "int4_ef")]
    + [dict(mode=None, wire=None, learner="adaline"),
       dict(mode=None, wire=None, fault=True)])


def toy(n=N, d=DIM, seed=0):
    rng = np.random.default_rng(seed)
    X, y = make_linear_dataset(rng, n + 64, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


def engine_config(wire=None, learner="pegasos", fault=False, n=N, **_):
    kw = dict(name="toy", dim=DIM, n_nodes=n, n_test=64,
              class_ratio=(1, 1), lam=1e-3, variant="mu", drop_prob=0.3,
              delay_max_cycles=4, wire_dtype=wire, learner=learner)
    if fault:
        kw.update(fault_model="sign_flip", defense="norm_clip",
                  byzantine_frac=0.25)
    return kw


def engine_ranks(rank, world):
    """Every case on a ``("nodes",)`` mesh of all ranks (and rank 0's
    one-device runs), then the errors."""
    torch.set_num_threads(1)
    mesh = make_mesh((world,), ("nodes",), "cpu")
    X, y, Xt, yt = toy()
    out = {"runs": [], "one": {}}
    for i, case in enumerate(ENGINE_CASES):
        cfg = GossipLinearConfig(**engine_config(**case))
        kw = dict(RUN, engine="sharded", device="cpu",
                  compact_mode=case["mode"], final_state=True)
        out["runs"].append(run_simulation(cfg, X, y, Xt, yt, mesh=mesh,
                                          **kw))
    for i in range(rank, len(ENGINE_CASES), world):   # case i on rank i % W
        case = ENGINE_CASES[i]
        cfg = GossipLinearConfig(**engine_config(**case))
        out["one"][i] = run_simulation(
            cfg, X, y, Xt, yt, **RUN, engine="sharded", device="cpu",
            compact_mode=case["mode"], final_state=True)
    # an axis of size 1 runs the one-device path
    flat = make_mesh((world, 1), ("nodes", "model"), "cpu")
    cfg = GossipLinearConfig(**engine_config())
    kw = dict(RUN, engine="sharded", device="cpu")
    out["size1"] = (run_simulation(cfg, X, y, Xt, yt, mesh=flat,
                                   node_axis="model", **kw),
                    run_simulation(cfg, X, y, Xt, yt, **kw)
                    if rank == 0 else None)
    out["errors"] = errors = {}
    for name, call in (
            ("indivisible", lambda: run_simulation(
                GossipLinearConfig(**engine_config(n=N + 1)),
                *toy(N + 1), mesh=mesh, engine="sharded", device="cpu",
                cycles=2)),
            ("serve_hook", lambda: run_simulation(
                cfg, X, y, Xt, yt, mesh=mesh, engine="sharded",
                device="cpu", cycles=2, serve_hook=lambda c, s: None)),
            ("telemetry", lambda: run_simulation(
                cfg, X, y, Xt, yt, mesh=mesh, engine="sharded",
                device="cpu", cycles=2, telemetry=Telemetry()))):
        try:
            call()
            errors[name] = None
        except Exception as e:          # the parent pins type and message
            errors[name] = (type(e).__name__, str(e))
    return out


def smoke_rank(rank, world):
    """``make_smoke_mesh`` on a one-rank group, read, and the engine on it
    (its node axis has one rank: the one-device path) beside the engine
    without a mesh."""
    torch.set_num_threads(1)
    mesh = make_smoke_mesh("cpu")
    X, y, Xt, yt = toy()
    cfg = GossipLinearConfig(**engine_config())
    kw = dict(RUN, engine="sharded", device="cpu")
    return (mesh_axis_sizes(mesh), num_chips(mesh),
            run_simulation(cfg, X, y, Xt, yt, mesh=mesh, **kw),
            run_simulation(cfg, X, y, Xt, yt, **kw))


# ---------------------------------------------------------------------------
# the peer mesh
# ---------------------------------------------------------------------------

MERGE_EXCHANGES = (None, "bf16", "int8", "int4", "ternary")
STEPS = 3


def peer_tree(seed, peers):
    """Per-peer leaves stacked on a leading peer axis: a per-peer scalar
    (a 0-d leaf on each rank), a vector (rank 1 on each rank), a matrix
    and a bfloat16 matrix, with a spread of scales and a constant row."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal((peers,) + s)
         * rng.choice([1e-3, 1.0, 40.0], peers)
         .reshape((peers,) + (1,) * len(s))).astype(np.float32))
    return {"scalar": f(), "vec": f(13), "mat": f(6, 33),
            "bf": f(7, 9).to(torch.bfloat16),
            "const": torch.full((peers, 2, 6), 0.25)}


def quad_loss_t(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def _own(tree, rank):
    return {k: v[rank].clone() for k, v in tree.items()}


def _train_cases(world):
    cases = [dict(merge=m, clip=0.0) for m in ("mu", "um", "rw")]
    cases += [dict(merge="mu", clip=0.5, exchange="int8")]
    if world == 4:
        cases += [dict(merge="mu", clip=0.0, pods=2)]
    return cases


def train_data(world):
    """The train cases' data, drawn with numpy: the stacked initial params
    and STEPS batches stacked by peer."""
    rng = np.random.default_rng(11)
    w_true = rng.standard_normal(12).astype(np.float32)
    init = {"w": (0.1 * rng.standard_normal((world, 12))).astype(np.float32),
            "b": np.zeros(world, np.float32)}
    batches = []
    for _ in range(STEPS):
        x = rng.standard_normal((world, 4, 12)).astype(np.float32)
        batches.append({"x": x, "y": x @ w_true})
    return init, batches


def train_config(case):
    """The case's ``GossipConfig`` fields, its optimizer's arguments and
    its pod count."""
    pods = case.get("pods", 1)
    return (dict(merge=case["merge"], pod_every=1 if pods > 1 else 0,
                 exchange_dtype=case.get("exchange", "")),
            dict(name="sgdm", grad_clip=case["clip"]), pods)


def _train(rank, world, case, mesh, axes, stacked: bool):
    """STEPS steps of the quadratic toy, on the ranks (stacked=False) or
    stacked on rank 0; returns the losses and the final params (this
    rank's peer, or the stack)."""
    init, batches = train_data(world)
    init = {k: torch.from_numpy(v) for k, v in init.items()}
    cfg_kw, opt_kw, pods = train_config(case)
    cfg = GossipConfig(**cfg_kw)
    opt = make_optimizer(opt_kw["name"], constant(0.05),
                         grad_clip=opt_kw["grad_clip"])
    if stacked:
        fn = go.make_gossip_train_step(quad_loss_t, opt, world, cfg)
        params = {k: v.clone() for k, v in init.items()}
    else:
        fn = go.make_gossip_train_step(quad_loss_t, opt, world, cfg,
                                       mesh=mesh, peer_axes=axes)
        params = _own(init, rank)
    state = go.GossipState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32))
    losses = []
    for s, b in enumerate(batches):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        if not stacked:
            batch = _own(batch, rank)
        perm, pod = go.perms_for_step(cfg, s, world, n_pods=pods)
        state, loss, _ = fn(state, batch, perm, pod)
        losses.append(float(loss))
    return losses, state.params


def _linear(rank, world, variant, drop, mesh):
    """Ten cycles of ``linear_gossip_mesh_step`` on this rank's peer."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((world, 3, 8)).astype(np.float32)
    y = np.sign(rng.standard_normal((world, 3))).astype(np.float32)
    drops = rng.random((10, world)) < 0.3
    w, t = torch.zeros(8), torch.zeros((), dtype=torch.int32)
    hist = []
    for c in range(10):
        partner = ps.hypercube_partner(c, world)
        pairs = [(s, int(partner[s])) for s in range(world)]
        w, t = go.linear_gossip_mesh_step(
            w, t, torch.from_numpy(X[rank]), torch.from_numpy(y[rank]),
            pairs, lam=0.1, variant=variant, axis="data", mesh=mesh,
            drop_mask=bool(drops[c, rank]) if drop else None)
        hist.append((w.numpy().copy(), int(t)))
    return hist


def gossip_ranks(rank, world):
    """The merge on every exchange, the train steps and the linear cycle
    on a ``("data",)`` mesh of all ranks (and ``("pod", "data")`` 2 x 2 on
    four), with rank 0's stacked counterparts."""
    torch.set_num_threads(1)
    mesh = make_mesh((world,), ("data",), "cpu")
    out = {"merge": {}, "train": [], "linear": {}}
    tree = peer_tree(1, world)
    perm = ps.hypercube_partner(1, world)
    for ex in MERGE_EXCHANGES:
        got = go.gossip_merge(_own(tree, rank), perm, mesh=mesh,
                              peer_axes=("data",), exchange_dtype=ex)
        out["merge"][ex] = got
    pod_mesh = make_mesh((2, 2), ("pod", "data"), "cpu") if world == 4 else None
    for case in _train_cases(world):
        axes = ("pod", "data") if case.get("pods") else ("data",)
        m = pod_mesh if case.get("pods") else mesh
        ranks = _train(rank, world, case, m, axes, stacked=False)
        one = _train(rank, world, case, None, (), True) if rank == 0 \
            else None
        out["train"].append((case, ranks, one))
    for variant in ("mu", "um", "rw"):
        for drop in (False, True):
            out["linear"][(variant, drop)] = _linear(rank, world, variant,
                                                     drop, mesh)
    return out


# the groups a test session starts, by size: the smoke mesh's one rank,
# and both files' 2- and 4-rank groups
GROUPS = {1: smoke_rank, 2: mesh_ranks, 4: mesh_ranks}
