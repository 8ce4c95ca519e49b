"""The port's optimizers, schedules and tree helpers
(``repro_torch/optim/``, ``repro_torch/utils/tree.py``) against the JAX
package's on the same numpy-seeded inputs.

Schedules: within 1 float32 ulp (XLA's ``cos`` and PyTorch's may round a
last bit apart; every other op is the same IEEE op in the same order).
Three optimizer updates (sgd, sgdm, adamw; clip on and off) on a tree of
float32 and bfloat16 leaves against the reference's eager updates:
float32 leaves within 1e-6 of the leaf's largest value, bfloat16 leaves
(parameters and SGD momentum) within one bfloat16 ulp (2^-8 of it), where
a float32 difference of an ulp lands on a rounding boundary. Measured on
these inputs: bit for bit everywhere but AdamW with the clip active,
1.05e-7 of the largest value (the global norm's summation order moves the
clip scale by an ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.utils import tree as jtree
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.utils import tree as ttree

F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -8


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def random_tree(seed, bf16=True):
    """A tree of leaves of rank 0-3, float32 and (with ``bf16``) bfloat16,
    a peer-stacked (4, ...) leaf among them, as numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"b": f(), "w": f(5, 7), "layers": [{"k": f(3, 4, 6)},
                                               {"k": f(3, 4, 6)}],
            "stacked": f(4, 9, 2)}
    if bf16:
        tree["emb"] = f(11, 8).astype(jnp.bfloat16)
        tree["layers"][1]["s"] = f(8).astype(jnp.bfloat16)
    return tree


def assert_tree_close(got, want, what):
    gl, wl = ttree.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        g = to_np(g)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        rtol = BF16_RTOL if w.dtype == jnp.bfloat16 else F32_RTOL
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   rtol=0, atol=rtol * float(
                                       np.abs(w.astype(np.float32)).max()),
                                   err_msg=what)


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-4),
    lambda m: m.warmup_cosine(1e-3, 20, 100),
    lambda m: m.warmup_cosine(2e-3, 1, 3, final_frac=0.2),
    lambda m: m.pegasos_schedule(1e-2),
])
def test_schedules_equal_the_reference(make):
    jf, tf = make(jsched), make(tsched)
    for step in [0, 1, 2, 5, 19, 20, 21, 57, 99, 100, 150]:
        want = np.float32(jf(jnp.int32(step)))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = tf(s)
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(float(got) - float(want)) <= np.spacing(want), (step,
                                                                       s)


@pytest.mark.parametrize("clip", [0.0, 0.5, 1e3])
@pytest.mark.parametrize("name", ["sgd", "sgdm", "adamw"])
def test_one_update_matches_the_reference(name, clip):
    params = random_tree(0)
    grads = jax.tree.map(lambda a: (a * 3).astype(a.dtype), random_tree(1))
    sched = lambda m: m.warmup_cosine(0.05, 2, 10)
    jo = jopt.make_optimizer(name, sched(jsched), grad_clip=clip,
                             weight_decay=0.1)
    to = topt.make_optimizer(name, sched(tsched), grad_clip=clip,
                             weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(to_torch, params)
    js, ts = jo.init(jp), to.init(tp)
    assert_tree_close(ts, js, "init")
    for step in range(3):
        g = jax.tree.map(lambda a: (a * (step + 1)).astype(a.dtype), grads)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.int32(step))
        tp, ts = to.update(jax.tree.map(to_torch, g), ts, tp,
                           torch.tensor(step, dtype=torch.int32))
        assert_tree_close(tp, jp, f"{name} params, step {step}")
        assert_tree_close(ts, js, f"{name} state, step {step}")


def test_update_writes_in_place_and_returns_the_same_trees():
    p = {"w": torch.ones(4, 3)}
    opt = topt.adamw(tsched.constant(0.1))
    s = opt.init(p)
    w = p["w"]
    p2, s2 = opt.update({"w": torch.ones(4, 3)}, s, p, 0)
    assert p2 is p and s2 is s and p2["w"] is w
    assert not torch.equal(w, torch.ones(4, 3))


def test_update_in_slices_gives_the_whole_leaf_bits(monkeypatch):
    params = random_tree(3)
    grads = random_tree(4)
    outs = []
    for chunk in (topt.CHUNK, 7):
        monkeypatch.setattr(topt, "CHUNK", chunk)
        opt = topt.adamw(tsched.constant(0.01), grad_clip=0.3)
        tp = jax.tree.map(to_torch, params)
        ts = opt.init(tp)
        for step in range(2):
            tp, ts = opt.update(jax.tree.map(to_torch, grads), ts, tp, step)
        outs.append(ttree.tree_leaves(tp) + ttree.tree_leaves(ts))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_global_norm_spans_the_whole_tree():
    """One norm over every leaf (in the gossip step: every peer at once),
    not one a leaf or a peer."""
    g = {"a": torch.full((4, 3), 3.0), "b": torch.full((4,), 4.0)}
    norm = float(topt._global_norm(g))
    assert norm == pytest.approx(float(np.sqrt(12 * 9 + 4 * 16)))
    scale = float(topt._clip_scale(g, 1.0))
    assert scale == pytest.approx(1.0 / norm)


def test_make_optimizer_names():
    for name in ("sgd", "sgdm", "adamw"):
        assert topt.make_optimizer(name, tsched.constant(1.0)).name == name
    with pytest.raises(ValueError):
        topt.make_optimizer("lion", tsched.constant(1.0))


def test_tree_leaves_follow_jax_flatten_order():
    tree = random_tree(5)
    want = jax.tree.leaves(tree)
    got = ttree.tree_leaves(jax.tree.map(to_torch, tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_tree_helpers_match_the_reference():
    a, b = random_tree(6, bf16=False), random_tree(7, bf16=False)
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = jax.tree.map(to_torch, a), jax.tree.map(to_torch, b)
    pairs = [
        (ttree.tree_add(ta, tb), jtree.tree_add(ja, jb)),
        (ttree.tree_sub(ta, tb), jtree.tree_sub(ja, jb)),
        (ttree.tree_scale(0.3, ta), jtree.tree_scale(0.3, ja)),
        (ttree.tree_axpy(-0.7, ta, tb), jtree.tree_axpy(-0.7, ja, jb)),
        (ttree.tree_average(ta, tb), jtree.tree_average(ja, jb)),
        (ttree.tree_average(ta, tb, weights=[1.0, 3.0]),
         jtree.tree_average(ja, jb, weights=[1.0, 3.0])),
        (ttree.tree_zeros_like(ta), jtree.tree_zeros_like(ja)),
    ]
    for got, want in pairs:
        assert_tree_close(got, want, "tree op")
    assert float(ttree.tree_dot(ta, tb)) == pytest.approx(
        float(jtree.tree_dot(ja, jb)), rel=1e-5)
    assert float(ttree.tree_norm(ta)) == pytest.approx(
        float(jtree.tree_norm(ja)), rel=1e-6)
    assert ttree.tree_size(ta) == jtree.tree_size(ja)
    assert ttree.tree_bytes(ta) == jtree.tree_bytes(ja)
    cast = ttree.tree_cast(ta, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in ttree.tree_leaves(cast))


def test_tree_map_reads_params_and_random_like():
    from repro_torch.config import get_config, reduced_config
    from repro_torch.models import transformer as T
    cfg = reduced_config(get_config("qwen3-1.7b"), d_model=64, vocab=64)
    params = T.init_params(cfg, device="cpu")
    tree = ttree.tree_map(lambda p: p.detach(), params)
    assert isinstance(tree, dict) and isinstance(tree["blocks"], list)
    assert ttree.tree_size(tree) == cfg.param_count()
    g = torch.Generator().manual_seed(1)
    r = ttree.tree_random_like(g, tree, scale=2.0)
    leaves = ttree.tree_leaves(r)
    assert [x.shape for x in leaves] == [x.shape for x in
                                         ttree.tree_leaves(tree)]
    g2 = torch.Generator().manual_seed(1)
    again = ttree.tree_leaves(ttree.tree_random_like(g2, tree, scale=2.0))
    assert all(torch.equal(x, y) for x, y in zip(leaves, again))
