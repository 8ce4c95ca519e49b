"""The rank bodies of the mesh tests (``tests/test_torch_mesh_*.py``).

``mesh_ranks`` runs in every rank of a spawned ``gloo`` group
(``repro_torch.launch.mesh.run_ranks``), on the CPU: the node mesh's
cases (``engine_ranks``), serving and telemetry on it
(``serving_ranks``), the peer mesh's (``gossip_ranks``) and the LM's
step builders on DTensors (``lm_ranks``), one group a size for those
files; ``family_ranks`` runs the ssm, hybrid, audio and vlm families'
step builders in groups of their own beside them. Each returns what the
parent tests compare.
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
    """The four files' rank bodies in one group."""
    return {"engine": engine_ranks(rank, world),
            "serving": serving_ranks(rank, world),
            "gossip": gossip_ranks(rank, world),
            "lm": lm_ranks(rank, world)}


def shared_ranks(tmp_path_factory, group):
    """The results of group ``group`` of ``GROUPS``, once a test session:
    the first xdist worker to ask starts every group at once (each with
    a 240 s limit and 60 s a collective) and keeps their results, or the
    error of a group that failed, for the others."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"mesh_groups_{group}.pkl"
    with FileLock(str(root / "mesh_groups.lock")):
        if not path.is_file():
            with ThreadPoolExecutor(len(GROUPS)) as pool:
                runs = {g: pool.submit(run_ranks, fn, w, device_type="cpu",
                                       timeout_s=240.0, pg_timeout_s=60.0)
                        for g, (w, fn) in GROUPS.items()}
                for g, run in runs.items():
                    try:
                        kept = ("ok", run.result())
                    except Exception as e:      # each test that reads it
                        kept = ("error", f"{type(e).__name__}: {e}")
                    with open(root / f"mesh_groups_{g}.pkl", "wb") as f:
                        pickle.dump(kept, f)
    with open(path, "rb") as f:
        status, out = pickle.load(f)
    if status != "ok":
        raise RuntimeError(f"the group {group!r} failed: {out}")
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
    seen, tel = [], Telemetry()
    for name, call in (
            ("indivisible", lambda: run_simulation(
                GossipLinearConfig(**engine_config(n=N + 1)),
                *toy(N + 1), mesh=mesh, engine="sharded", device="cpu",
                cycles=2)),
            ("serve_hook", lambda: run_simulation(
                cfg, X, y, Xt, yt, mesh=mesh, engine="sharded",
                device="cpu", cycles=2, serve_hook=lambda c, s: seen.append(
                    (c, tuple(s.w.shape), s.shard[:5])))),
            ("telemetry", lambda: run_simulation(
                cfg, X, y, Xt, yt, mesh=mesh, engine="sharded",
                device="cpu", cycles=2, telemetry=tel))):
        try:
            call()
            errors[name] = None
        except Exception as e:          # the parent pins type and message
            errors[name] = (type(e).__name__, str(e))
    # what the two hooked runs saw: the hook's calls (cycle, the shard's
    # cache shape and its place) and the armed streams' lengths
    out["hooked"] = {"serve_hook": seen, "telemetry": {
        k: len(v) for k, v in tel.streams.items()}, "rank": tel.rank}
    return out


# serving and telemetry on the node mesh: f32 with sign_flip + norm_clip,
# int8_sr and int4_ef, each armed with two servers (uniform and
# round_robin, batches of SERVE_BATCH, SERVE_QUERIES queries an eval
# point: a padded tail batch is flushed after the run)
SERVE_CASES = (dict(mode=None, wire=None, fault=True),
               dict(mode=None, wire="int8_sr"),
               dict(mode=None, wire="int4_ef"))
SERVE_BATCH, SERVE_QUERIES = 16, 20
POLICIES = ("uniform", "round_robin")


def _serve_run(cfg, data, mesh=None, node_axis=None, armed=True):
    """One armed (or plain) run with the servers hooked in: the result,
    the streams, every eval point's whole snapshot (gathered under a
    node mesh), each server's answers, batches and stats, the spans'
    rank tags and the snapshot's place."""
    from repro_torch.core import serving
    from repro_torch.launch.gossip_serve import GossipServer
    X, y, Xt, yt = data
    tel = Telemetry() if armed else None
    servers = {p: GossipServer(batch_size=SERVE_BATCH, policy=p, seed=3,
                               telemetry=tel if p == "uniform" else None)
               for p in POLICIES}
    snaps, places = {}, []

    def hook(cycle, snap):
        places.append(None if snap.shard is None else snap.shard[:5])
        whole = serving.gather_snapshot(snap)
        snaps[cycle] = [a.numpy().copy() if torch.is_tensor(a) else a
                        for a in whole[:6]]
        for srv in servers.values():
            srv.serve_hook(cycle, snap)
            srv.submit(Xt[:SERVE_QUERIES])

    res = run_simulation(cfg, X, y, Xt, yt, **RUN, engine="sharded",
                         device="cpu", mesh=mesh, node_axis=node_axis,
                         telemetry=tel, serve_hook=hook if armed else None)
    served = {}
    for p, srv in servers.items():
        srv.flush()
        st = srv.stats()
        served[p] = {"voted": srv.answers(), "fresh": srv.answers_fresh(),
                     "batches": [(b.cycle, b.size, b.assign.copy(),
                                  b.query_ids.copy()) for b in srv.batches],
                     "queries": st.queries, "n_batches": st.batches}
    return {"res": res, "snaps": snaps, "served": served, "places": places,
            "streams": None if tel is None else dict(tel.streams),
            "span_ranks": None if tel is None else sorted(
                {s.args.get("rank") for s in tel.spans}, key=str),
            "report": None if tel is None else tel.phase_report()}


def serving_ranks(rank, world):
    """Every serving case armed and plain on a ``("nodes",)`` mesh of all
    ranks, their one-device runs (case i on rank i % W), and an armed
    run on an axis of size 1 beside the one-device one on rank 0."""
    torch.set_num_threads(1)
    mesh = make_mesh((world,), ("nodes",), "cpu")
    data = toy()
    out = {"mesh": [], "plain": [], "one": {}}
    for case in SERVE_CASES:
        cfg = GossipLinearConfig(**engine_config(**case))
        out["mesh"].append(_serve_run(cfg, data, mesh))
        out["plain"].append(_serve_run(cfg, data, mesh, armed=False)["res"])
    for i in range(rank, len(SERVE_CASES), world):
        cfg = GossipLinearConfig(**engine_config(**SERVE_CASES[i]))
        out["one"][i] = _serve_run(cfg, data)
    flat = make_mesh((world, 1), ("nodes", "model"), "cpu")
    cfg = GossipLinearConfig(**engine_config(**SERVE_CASES[0]))
    out["size1"] = (_serve_run(cfg, data, flat, node_axis="model"),
                    _serve_run(cfg, data) if rank == 0 else None)
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


# ---------------------------------------------------------------------------
# the LM on a mesh (launch/specs.py's step builders)
# ---------------------------------------------------------------------------

LM_BATCH, LM_PROMPT, LM_CACHE, LM_STEPS = 2, 32, 96, 3
# the train cases' step counter: past half the builders' 100 warmup steps,
# so the step's learning rate (1.5e-4) moves the weights
LM_TRAIN_STEP = 50


def lm_config(kind: str):
    """The LM cases' configs: reduced qwen3-1.7b at widths whose matrices
    pass the rules' 2^16 elements (d_model 256, 8 query heads of 64, d_ff
    512, vocab 1024), with 4 kv heads ("dense") or 2 ("kv2": on a 4-way
    model axis the rules replicate them while the query heads split);
    "train" is "dense" on the chunked attention; "moe" is reduced
    mixtral-8x22b (4 experts, top 2, d_ff_expert 256, 'tensor' sharding)
    at d_model 128. All float32."""
    import dataclasses
    from repro_torch.config import get_config, reduced_config
    if kind == "moe":
        cfg = reduced_config(get_config("mixtral-8x22b"), d_model=128,
                             layers=2, vocab=512)
        return cfg.replace(attn_impl="xla")
    cfg = reduced_config(get_config("qwen3-1.7b"), d_model=256, layers=2,
                         vocab=1024)
    kv = 2 if kind == "kv2" else 4
    cfg = cfg.replace(attention=dataclasses.replace(
        cfg.attention, num_heads=8, num_kv_heads=kv, head_dim=64))
    if kind == "train":
        return cfg.replace(attn_impl="chunked", attn_chunk=16, xent_chunk=16)
    return cfg.replace(attn_impl="flash")


def lm_tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np_tree(tree):
    """DTensors and tensors of a tree as numpy arrays (whole values)."""
    from repro_torch.sharding.act import is_dtensor
    from repro_torch.utils.tree import tree_map

    def one(t):
        t = t.full_tensor() if is_dtensor(t) else t
        return t.detach().float().numpy().copy()
    return tree_map(one, tree)


def _placed(tree):
    """The placements of a tree's DTensors, as strings, by leaf."""
    from repro_torch.utils.tree import tree_leaves_with_path
    return {"/".join(map(str, p)): [str(x) for x in t.placements]
            for p, t in tree_leaves_with_path(tree)}


def _flash_recorder():
    """Wrap kernel #8's entry in ``models/attention.py``'s per-rank body
    to record the local (q, k) shapes it gets; returns the list and an
    undo."""
    from repro_torch.kernels import ops as kops
    real, seen = kops.flash_attention, []

    def wrapper(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)
    kops.flash_attention = wrapper
    return seen, lambda: setattr(kops, "flash_attention", real)


def lm_serve_case(mesh, kind: str, profiles=("context", "batch")):
    """The prefill step (logits), the fused prefill into each profile's
    cache, LM_STEPS decode steps on it: logits, the final cache, the
    placements of the weights, the cache and the logits, and kernel #8's
    local shapes."""
    import torch
    from repro_torch.config import InputShape
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import distribute_params
    cfg = lm_config(kind)
    params = T.init_params(cfg, device="cpu", seed=7)
    toks = torch.from_numpy(lm_tokens(3, (LM_BATCH, LM_PROMPT),
                                      cfg.vocab_size))
    shape = InputShape("t", LM_PROMPT, LM_BATCH, "prefill")
    seen, undo = _flash_recorder()
    try:
        fn, args, pl = specs.build_prefill_step(cfg, shape, mesh)
        dp = distribute_params(params, mesh, pl[0])
        batch = distribute_params({"tokens": toks}, mesh, pl[1])
        logits = fn(dp, batch)
        out = {"prefill": _np_tree(logits), "flash": list(seen),
               "params_pl": _placed(dp), "logits_pl":
               [str(x) for x in logits.placements], "decode": {}}
        for profile in profiles:
            dshape = InputShape("d", LM_CACHE, LM_BATCH, "decode")
            dfn, dargs, dpl = specs.build_decode_step(cfg, dshape, mesh,
                                                      profile=profile)
            pfn, _, ppl = specs.build_prefill_step(
                cfg, shape, mesh, cache_len=LM_CACHE,
                decode_profile=profile)
            first, cache = pfn(dp, batch)
            steps = []
            tok = torch.argmax(first.full_tensor(), -1).to(torch.int32)
            for i in range(LM_STEPS):
                dtok = distribute_params({"t": tok}, mesh, {"t": dpl[1]})
                lg, cache = dfn(dp, dtok["t"], cache, LM_PROMPT + i)
                steps.append(_np_tree(lg))
                tok = torch.argmax(lg.full_tensor(), -1).to(torch.int32)
            out["decode"][profile] = {
                "first": _np_tree(first), "steps": steps,
                "cache": _np_tree(cache), "cache_pl": _placed(cache)}
    finally:
        undo()
    return out


def lm_moe_case(mesh):
    """``moe_ffn`` of the reduced MoE at 'tensor' sharding under the
    mesh, G = 2 groups over 'data', with the reduce and the gather
    combine: outputs, aux, the combine counts and the placements."""
    import dataclasses
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.sharding import rules
    from repro_torch.sharding.act import activation_sharding
    cfg = lm_config("moe")
    out = {}
    for combine in ("reduce", "gather"):
        m = dataclasses.replace(cfg.moe, dispatch_groups=2, combine=combine)
        spec = moe.moe_spec(cfg.d_model, m, cfg.act)
        params = L.init_params(spec, torch.Generator().manual_seed(5), "cpu")
        ps = rules.params_pspecs(L.spec_axes(spec), params, mesh,
                                 rules.default_rules(moe_sharding="tensor"))
        dp = rules.distribute_params(params, mesh, ps)
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
        dx = rules.distribute_params({"x": x}, mesh,
                                     {"x": rules.PS("data")})["x"]
        before = dict(moe.COMBINE_COUNTS)
        with activation_sharding(mesh, ("data",)):
            y, aux = moe.moe_ffn(dp, m, dx, cfg.act)
        out[combine] = {
            "y": _np_tree(y), "aux": _np_tree(aux),
            "counts": {k: moe.COMBINE_COUNTS[k] - before[k]
                       for k in before},
            "params_pl": _placed(dp), "y_pl": [str(p) for p in y.placements]}
    return out


def lm_train_case(mesh, gossip: bool, optimizer: str = "adamw"):
    """One ``build_train_step`` step (``optimizer``, at step
    LM_TRAIN_STEP) of the "train" config: all-reduce on the mesh as placed
    by the rules, or gossip (mu, int8) with a peer a ``data`` rank and
    each peer's weights drawn from its own seed. Returns the loss, the new
    params and the placements."""
    import torch
    from repro_torch.config import GossipConfig, InputShape
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import zeros_of
    from repro_torch.sharding import compat
    from repro_torch.sharding.rules import distribute_params
    cfg = lm_config("train")
    shape = InputShape("t", 32, 4, "train")
    if gossip:
        peers = mesh.mesh.shape[0]
        me = compat.mesh_axis(mesh, ("data",)).index
        fn, args, pl = specs.build_train_step(
            cfg, shape, mesh, optimizer=optimizer,
            gossip=GossipConfig(merge="mu", exchange_dtype="int8"),
            n_peers=peers)
        inner = specs.peer_mesh(mesh)
        params = T.init_params(cfg, device="cpu", seed=20 + me)
        toks = lm_tokens(30, (peers, 4 // peers, 33), cfg.vocab_size)[me]
        on = inner
    else:
        fn, args, pl = specs.build_train_step(cfg, shape, mesh,
                                              optimizer=optimizer)
        params = T.init_params(cfg, device="cpu", seed=20)
        toks = lm_tokens(30, (4, 33), cfg.vocab_size)
        on = mesh
    dp = distribute_params(params, on, pl[0])
    dopt = distribute_params(zeros_of(args[1], "cpu"), on, pl[1])
    batch = {"tokens": torch.from_numpy(toks[..., :-1].copy()),
             "labels": torch.from_numpy(toks[..., 1:].copy())}
    dbatch = distribute_params(batch, on, pl[3])
    step = distribute_params({"s": torch.tensor(LM_TRAIN_STEP,
                                                dtype=torch.int32)}, on,
                             {"s": pl[2]})["s"]
    placed = _placed(dp)
    new_p, _, new_step, loss = fn(dp, dopt, step, dbatch)
    return {"loss": float(loss.full_tensor() if hasattr(loss, "full_tensor")
                          else loss),
            "params": _np_tree(new_p), "params_pl": placed,
            "step": int(new_step.full_tensor() if hasattr(
                new_step, "full_tensor") else new_step)}


def lm_ranks(rank, world):
    """The LM cases of a group: on 2 ranks tensor parallel (1, 2), the
    decode cache's length over data (2, 1) and FSDP training (2, 1; AdamW
    and SGD); on 4 ranks (2, 2) serving, the MoE combines and gossip
    training (SGD), and (1, 4) with the kv heads replicated."""
    torch.set_num_threads(1)
    out = {}
    if world == 2:
        tp = make_mesh((1, 2), ("data", "model"), "cpu")
        out["tp"] = lm_serve_case(tp, "dense")
        dp = make_mesh((2, 1), ("data", "model"), "cpu")
        out["length"] = lm_serve_case(dp, "dense", profiles=("context",))
        out["train_allreduce"] = {opt: lm_train_case(dp, False, opt)
                                  for opt in ("adamw", "sgd")}
    else:
        m22 = make_mesh((2, 2), ("data", "model"), "cpu")
        out["tp2x2"] = lm_serve_case(m22, "dense")
        out["moe"] = lm_moe_case(m22)
        out["train_gossip"] = lm_train_case(m22, True, "sgd")
        m14 = make_mesh((1, 4), ("data", "model"), "cpu")
        out["kv2"] = lm_serve_case(m14, "kv2", profiles=("context",))
    return out


# the groups a test session starts, by name: (ranks, body). The smoke
# mesh's one rank, the 2- and 4-rank groups of the engine, serving,
# gossip and LM files, and the families' own 2- and 4-rank groups
GROUPS = {1: (1, smoke_rank), 2: (2, mesh_ranks), 4: (4, mesh_ranks)}


# ---------------------------------------------------------------------------
# the ssm, hybrid, audio and vlm families on a mesh (their own groups)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("mamba2-780m", "recurrentgemma-9b", "whisper-medium",
                "llama-3.2-vision-11b")
GATES = ("gate_attn", "gate_ffn")


def family_config(arch: str, train: bool = False, bf16: bool = False):
    """A family's reduced config (``reduced_config`` at d_model 256,
    vocab 1024, float32: the mixers' projections pass the rules' 2^16
    elements), with ``bf16`` computing in bfloat16 (the published
    configs' compute dtype) on its float32 weights; kernel #8 on its
    attention layers (the chunked attention to train)."""
    from repro_torch.config import get_config, reduced_config
    cfg = reduced_config(get_config(arch), d_model=256, vocab=1024)
    if bf16:
        cfg = cfg.replace(compute_dtype=torch.bfloat16)
    if train:
        return cfg.replace(attn_impl="chunked", attn_chunk=16,
                           xent_chunk=16)
    return cfg.replace(attn_impl="flash")


def family_params(cfg, seed: int):
    """The port's seeded weights, every cross layer's gates set to seeded
    values in [0.3, 1) (at their zero init a cross layer adds nothing)."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    for lp in params["blocks"]:
        for name in GATES:
            if name in lp:
                lp[name].data.fill_(float(torch.rand((), generator=g) * 0.7
                                          + 0.3))
    return params


def family_source(cfg, batch: int, seed: int):
    """The patch embeddings (vlm) or frames (audio) as numpy, or None."""
    if cfg.family not in ("vlm", "audio"):
        return None
    src = (cfg.cross_attn or cfg.encoder).source_len
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (batch, src, cfg.d_model))).astype(np.float32)


def _digest(tree) -> dict:
    """Each leaf's bytes, hashed: the other ranks' copy of rank 0's."""
    import hashlib
    from repro_torch.utils.tree import tree_leaves_with_path
    return {"/".join(map(str, p)): hashlib.sha1(
        np.ascontiguousarray(t).tobytes()).hexdigest()
        for p, t in tree_leaves_with_path(tree)}


def family_case(mesh, arch: str, profiles, keep: bool, bf16: bool = False):
    """A family's prefill step, its fused prefill into each profile's
    cache and LM_STEPS decode steps, and one all-reduce SGD train step at
    LM_TRAIN_STEP: logits, caches, parameters (whole where ``keep``, else
    their digest), placements and kernel #8's local shapes. ``bf16``: the
    serving half only, computing in bfloat16."""
    from repro_torch.config import InputShape
    from repro_torch.launch import specs
    from repro_torch.models.layers import zeros_of
    from repro_torch.sharding.rules import distribute_params
    cfg = family_config(arch, bf16=bf16)
    params = family_params(cfg, 7)
    batch = {"tokens": torch.from_numpy(lm_tokens(3, (LM_BATCH, LM_PROMPT),
                                                  cfg.vocab_size))}
    src = family_source(cfg, LM_BATCH, 4)
    if src is not None:
        batch["encoder_out"] = torch.from_numpy(src)
    shape = InputShape("t", LM_PROMPT, LM_BATCH, "prefill")
    seen, undo = _flash_recorder()
    try:
        fn, _, pl = specs.build_prefill_step(cfg, shape, mesh)
        dp = distribute_params(params, mesh, pl[0])
        db = distribute_params(batch, mesh, pl[1])
        out = {"prefill": _np_tree(fn(dp, db)), "params_pl": _placed(dp),
               "decode": {}}
        out["flash"] = list(seen)
        if cfg.family == "audio":
            # the decoder's cross K/V from the encoder, as a server fills
            # its cache
            from repro_torch.models import encdec
            from repro_torch.sharding.act import activation_sharding
            with activation_sharding(mesh, ("data",)):
                kv = encdec.encoder_cross_kv(dp, cfg, db["encoder_out"])
            out["cross_kv"] = [_np_tree(t) for t in kv]
        for profile in profiles:
            dshape = InputShape("d", LM_CACHE, LM_BATCH, "decode")
            dfn, _, dpl = specs.build_decode_step(cfg, dshape, mesh,
                                                  profile=profile)
            pfn, _, _ = specs.build_prefill_step(
                cfg, shape, mesh, cache_len=LM_CACHE, decode_profile=profile)
            first, cache = pfn(dp, db)
            tok = torch.argmax(first.full_tensor(), -1).to(torch.int32)
            steps = []
            for i in range(LM_STEPS):
                dtok = distribute_params({"t": tok}, mesh, {"t": dpl[1]})
                lg, cache = dfn(dp, dtok["t"], cache, LM_PROMPT + i)
                steps.append(_np_tree(lg))
                tok = torch.argmax(lg.full_tensor(), -1).to(torch.int32)
            out["decode"][profile] = {
                "first": _np_tree(first), "steps": steps,
                "cache": _np_tree(cache), "cache_pl": _placed(cache)}
    finally:
        undo()
    if bf16:
        return out
    # one all-reduce SGD step
    tcfg = family_config(arch, train=True)
    tshape = InputShape("t", 32, 4, "train")
    fn, args, pl = specs.build_train_step(tcfg, tshape, mesh,
                                          optimizer="sgd")
    toks = lm_tokens(30, (4, 33), tcfg.vocab_size)
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    tsrc = family_source(tcfg, 4, 8)
    if tsrc is not None:
        tb["encoder_out"] = torch.from_numpy(tsrc)
    dp = distribute_params(family_params(tcfg, 20), mesh, pl[0])
    dopt = distribute_params(zeros_of(args[1], "cpu"), mesh, pl[1])
    step = distribute_params({"s": torch.tensor(LM_TRAIN_STEP,
                                                dtype=torch.int32)}, mesh,
                             {"s": pl[2]})["s"]
    placed = _placed(dp)
    new_p, _, _, loss = fn(dp, dopt, step, distribute_params(tb, mesh,
                                                             pl[3]))
    whole = _np_tree(new_p)
    out["train"] = {"loss": float(loss.full_tensor()
                                  if hasattr(loss, "full_tensor") else loss),
                    "params": whole if keep else None,
                    "digest": _digest(whole), "params_pl": placed}
    return out


FAMILY_MESHES = {2: {"tp": ((1, 2), ("context",))},
                 4: {"tp2x2": ((2, 2), ("context", "batch")),
                     "tp1x4": ((1, 4), ("context",))}}


def family_ranks(rank, world):
    """Every family on the group's meshes: (1, 2) on two ranks, (2, 2)
    (both decode profiles) and (1, 4) on four; on (1, 2) also mamba2's
    serving half at bfloat16 compute (``BF16_MESH``)."""
    torch.set_num_threads(1)
    out = {}
    for name, (shape, profiles) in FAMILY_MESHES[world].items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        out[name] = {arch: family_case(mesh, arch, profiles, rank == 0)
                     for arch in FAMILY_ARCHS}
        if name == BF16_MESH:
            out["bf16"] = family_case(mesh, "mamba2-780m", profiles, True,
                                      bf16=True)
    return out


# the mesh of the bfloat16 case
BF16_MESH = "tp"


GROUPS.update({"families2": (2, family_ranks),
               "families4": (4, family_ranks)})
