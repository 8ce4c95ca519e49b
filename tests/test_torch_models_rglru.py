"""The port's RG-LRU block (``repro_torch/models/rglru.py``) against the
JAX package's ``repro/models/rglru.py`` on the CPU.

Seeded numpy inputs and JAX-initialised weights (the gate biases drawn
too) go through both packages at reduced widths: the gates, the conv,
the log-depth scan against ``jax.lax.associative_scan`` at sequence
lengths around powers of two, ``rglru_forward`` with its decode state,
``rglru_step`` over a run of tokens, and the fused state against the
recurrence fed token by token. Float32 on both sides. The port's
Hillis–Steele scan associates the products in another order than the
reference's scan, so values agree within rtol 1e-4 and an atol of 1e-5
times the largest magnitude compared, not bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import RGLRUConfig as JRGLRUConfig
from repro.models import rglru as jrglru
from repro_torch import convert
from repro_torch.config.base import RGLRUConfig
from repro_torch.models import layers
from repro_torch.models import rglru
from repro_torch.utils.tree import tree_map

RTOL, ATOL = 1e-4, 1e-5
D_MODEL = 64
CFG = JRGLRUConfig(lru_width=96, d_conv=4, num_heads=4, c=8.0,
                   local_window=16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (many small ops; a thread
    pool costs more than it gains beside other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=RTOL, atol=ATOL * scale)


def port_cfg():
    return RGLRUConfig(**dataclasses.asdict(CFG))


def block(seed=0):
    # the port's leaves from a seeded generator (the reference's own
    # init_params seeds by Python's per-process string hash)
    p = layers.init_params(rglru.rglru_spec(D_MODEL, port_cfg()),
                           torch.Generator().manual_seed(seed), "cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(convert._np, p))
    rng = np.random.default_rng(seed)
    for name in ("b_a", "b_i", "conv_b"):
        jp[name] = jnp.asarray(0.5 * rng.standard_normal(jp[name].shape),
                               jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    p = layers.build_params(rglru.rglru_spec(D_MODEL, port_cfg()),
                            lambda path, _: convert._tensor(tree[path[0]],
                                                            "cpu"))
    return jp, p


def test_spec_matches_reference():
    jspec = jrglru.rglru_spec(D_MODEL, CFG, jnp.bfloat16)
    spec = rglru.rglru_spec(D_MODEL, port_cfg(), torch.bfloat16)
    assert sorted(spec) == sorted(jspec)
    for name, p in spec.items():
        assert p.shape == jspec[name].shape, name
        assert (p.init, p.scale) == (jspec[name].init, jspec[name].scale)
        assert str(p.dtype)[6:] == np.dtype(jspec[name].dtype).name, name
    assert rglru.rglru_dims(D_MODEL, port_cfg()) == jrglru.rglru_dims(
        D_MODEL, CFG)


def test_gates_and_conv_match_reference():
    jp, p = block(1)
    x = np.random.default_rng(1).standard_normal((2, 9, 96),
                                                 dtype=np.float32)
    jla, jg = jrglru._gates(jp, CFG, x, 96, 4)
    la, g = rglru._gates(p, port_cfg(), torch.from_numpy(x), 96, 4)
    close(la, jla)
    close(g, jg)
    state = np.random.default_rng(2).standard_normal((2, 3, 96),
                                                     dtype=np.float32)
    for st in (None, state):
        jo, jst = jrglru._conv(jp, CFG, x, st)
        o, s = layers.causal_conv(p, torch.from_numpy(x),
                                  None if st is None
                                  else torch.from_numpy(st))
        close(o, jo)
        assert torch.equal(s, torch.from_numpy(np.array(jst)))


@pytest.mark.parametrize("seq", [1, 2, 7, 8, 33, 64])
def test_scan_matches_associative_scan(seq):
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.5, 1.0, (2, seq, 5)).astype(np.float32)
    b = rng.standard_normal((2, seq, 5), dtype=np.float32)

    def op(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]
    _, want = jax.lax.associative_scan(op, (a, b), axis=1)
    close(rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b)),
          want)


@pytest.mark.parametrize("seq", [16, 37])
def test_rglru_forward_and_state_match_reference(seq):
    jp, p = block(seq)
    x = np.random.default_rng(seq).standard_normal((2, seq, D_MODEL),
                                                   dtype=np.float32)
    jout, jst = jrglru.rglru_forward(jp, CFG, D_MODEL, x,
                                     compute_dtype=jnp.float32,
                                     return_state=True)
    out, st = rglru.rglru_forward(p, port_cfg(), D_MODEL,
                                  torch.from_numpy(x),
                                  compute_dtype=torch.float32,
                                  return_state=True)
    close(out, jout)
    close(st["h"], jst["h"])
    close(st["conv"], jst["conv"])


def test_rglru_step_matches_reference_and_the_fused_state():
    jp, p = block(3)
    seq = 12
    x = np.random.default_rng(3).standard_normal((2, seq, D_MODEL),
                                                 dtype=np.float32)
    jst = jrglru.init_rglru_state(2, D_MODEL, CFG, jnp.float32)
    st = rglru.init_rglru_state(2, D_MODEL, port_cfg(), torch.float32)
    for name in ("h", "conv"):
        assert tuple(st[name].shape) == jst[name].shape
    outs = []
    for i in range(seq):
        jo, jst = jrglru.rglru_step(jp, CFG, D_MODEL, x[:, i:i + 1], jst,
                                    compute_dtype=jnp.float32)
        o, st = rglru.rglru_step(p, port_cfg(), D_MODEL,
                                 torch.from_numpy(x[:, i:i + 1]), st,
                                 compute_dtype=torch.float32)
        close(o, jo)
        outs.append(o)
    close(st["h"], jst["h"])
    close(st["conv"], jst["conv"])
    fused, fst = rglru.rglru_forward(p, port_cfg(), D_MODEL,
                                     torch.from_numpy(x),
                                     compute_dtype=torch.float32,
                                     return_state=True)
    close(torch.cat(outs, dim=1), fused.numpy())
    close(st["h"], fst["h"].numpy())
    close(st["conv"], fst["conv"].numpy())
