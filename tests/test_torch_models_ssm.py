"""The port's Mamba-2 SSD block (``repro_torch/models/ssm.py``) against
the JAX package's ``repro/models/ssm.py`` on the CPU.

Seeded numpy inputs and JAX-initialised weights (``A_log``, ``D`` and
``dt_bias`` drawn too, so that the decays and skips are not their
trivial inits) go through both packages at reduced widths: ``softplus``
(within two ulps, past the x > 20 switch of ``F.softplus``), ``_segsum``,
``ssd_chunked`` at a sequence that is a multiple of the chunk and one that
is not (padded with dt = 0), ``ssm_forward`` with its decode state,
``ssm_step`` over a run of tokens, and the fused state against the
recurrence fed token by token. Float32 on both sides; the chunked form's
pairwise contraction order is the port's own, so values agree within
rtol 1e-4 and an atol of 1e-5 times the largest magnitude compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import SSMConfig as JSSMConfig
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.config.base import SSMConfig
from repro_torch.models import layers
from repro_torch.models import ssm
from repro_torch.utils.tree import tree_map

RTOL, ATOL = 1e-4, 1e-5
D_MODEL = 64
CFG = JSSMConfig(d_state=16, expand=2, head_dim=16, n_groups=2,
                 chunk_size=8)


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


def port_cfg(s=CFG):
    return SSMConfig(**dataclasses.asdict(s))


def block(seed=0, s=CFG):
    """Block parameters from the port's ``init_params`` on a seeded
    generator (the reference's own seeds by Python's per-process string
    hash) with the float32 leaves drawn, as JAX arrays, and the port's
    copy."""
    p = layers.init_params(ssm.ssm_spec(D_MODEL, port_cfg(s)),
                           torch.Generator().manual_seed(seed), "cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(convert._np, p))
    rng = np.random.default_rng(seed)
    h = jp["A_log"].shape[0]
    jp["A_log"] = jnp.asarray(rng.uniform(-1.0, 1.0, h), jnp.float32)
    jp["D"] = jnp.asarray(rng.uniform(0.5, 1.5, h), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 0.0, h), jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    p = layers.build_params(ssm.ssm_spec(D_MODEL, port_cfg(s)),
                            lambda path, _: convert._tensor(
                                tree[path[0]] if len(path) == 1
                                else tree[path[0]][path[1]], "cpu"))
    return jp, p


def test_softplus_matches_reference():
    """Within two float32 ulps (the libraries' exp and log1p differ by one
    at 12 of these points), past the x > 20 switch of ``F.softplus`` too."""
    x = np.concatenate([np.linspace(-40, 40, 801, dtype=np.float32),
                        np.float32([19.9, 20.0, 20.1, 30.5, -1e-8])])
    got = layers.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("t", [1, 5, 8])
def test_segsum_matches_reference(t):
    x = np.random.default_rng(t).standard_normal((3, 2, t),
                                                 dtype=np.float32)
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jssm._segsum(x))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_spec_matches_reference():
    jspec = jssm.ssm_spec(D_MODEL, CFG, jnp.bfloat16)
    spec = ssm.ssm_spec(D_MODEL, port_cfg(), torch.bfloat16)
    assert sorted(spec) == sorted(jspec)
    for name in ("w_in", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                 "w_out"):
        assert spec[name].shape == jspec[name].shape, name
        assert str(spec[name].dtype)[6:] == np.dtype(
            jspec[name].dtype).name, name
    assert ssm.ssm_dims(D_MODEL, port_cfg()) == jssm.ssm_dims(D_MODEL, CFG)


@pytest.mark.parametrize("seq", [16, 21])
def test_ssd_chunked_matches_reference(seq):
    rng = np.random.default_rng(seq)
    b, h, p, g, n = 2, 8, 16, 2, 16
    x = rng.standard_normal((b, seq, h, p), dtype=np.float32)
    dt = rng.uniform(0.01, 0.5, (b, seq, h)).astype(np.float32)
    A = -rng.uniform(0.1, 2.0, h).astype(np.float32)
    B = rng.standard_normal((b, seq, g, n), dtype=np.float32)
    C = rng.standard_normal((b, seq, g, n), dtype=np.float32)
    jy, jstate = jssm.ssd_chunked(x, dt, A, B, C, 8)
    y, state = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), 8)
    assert tuple(y.shape) == (b, seq, h, p)
    close(y, jy)
    close(state, jstate)


@pytest.mark.parametrize("seq", [16, 21])
def test_ssm_forward_and_state_match_reference(seq):
    jp, p = block(seq)
    x = np.random.default_rng(seq).standard_normal((2, seq, D_MODEL),
                                                   dtype=np.float32)
    jout, jst = jssm.ssm_forward(jp, CFG, D_MODEL, x,
                                 compute_dtype=jnp.float32,
                                 return_state=True)
    out, st = ssm.ssm_forward(p, port_cfg(), D_MODEL, torch.from_numpy(x),
                              compute_dtype=torch.float32,
                              return_state=True)
    close(out, jout)
    for name in ("ssm", "conv"):
        assert st[name].dtype == torch.float32
        close(st[name], jst[name])
    plain = ssm.ssm_forward(p, port_cfg(), D_MODEL, torch.from_numpy(x),
                            compute_dtype=torch.float32)
    assert torch.equal(plain, out)


def test_ssm_step_matches_reference_and_the_fused_state():
    """Twelve steps from the zero state against the reference's steps, and
    the state after them against ``ssm_forward``'s fused state."""
    jp, p = block(3)
    seq = 12
    x = np.random.default_rng(3).standard_normal((2, seq, D_MODEL),
                                                 dtype=np.float32)
    jst = jssm.init_ssm_state(2, D_MODEL, CFG, jnp.float32)
    st = ssm.init_ssm_state(2, D_MODEL, port_cfg(), torch.float32)
    for name in ("ssm", "conv"):
        assert tuple(st[name].shape) == jst[name].shape
    outs = []
    for i in range(seq):
        jo, jst = jssm.ssm_step(jp, CFG, D_MODEL, x[:, i:i + 1], jst,
                                compute_dtype=jnp.float32)
        o, st = ssm.ssm_step(p, port_cfg(), D_MODEL,
                             torch.from_numpy(x[:, i:i + 1]), st,
                             compute_dtype=torch.float32)
        close(o, jo)
        outs.append(o)
    close(st["ssm"], jst["ssm"])
    close(st["conv"], jst["conv"])
    fused, fst = ssm.ssm_forward(p, port_cfg(), D_MODEL, torch.from_numpy(x),
                                 compute_dtype=torch.float32,
                                 return_state=True)
    close(torch.cat(outs, dim=1), fused.numpy())
    close(st["ssm"], fst["ssm"].numpy())
    close(st["conv"], fst["conv"].numpy())
