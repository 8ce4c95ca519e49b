"""The port's synthetic LM data, checkpoints and the LM tree converters
against the JAX package, exactly: ``SyntheticLMDataset`` batches element
for element, ``state.msgpack`` byte for byte and ``manifest.json`` equal
to the reference's ``save_checkpoint``'s for the same tree, each package
restoring the other's checkpoint bit for bit, the hand-written msgpack
subset equal to ``msgpack``'s, and ``convert.lm_params_to_arrays`` the
inverse of ``lm_params_from_arrays``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jlatest_step
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.data import lm_data as jlm
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.data import lm_data as tlm
from repro_torch.launch import train as train_mod
from repro_torch.utils.tree import tree_leaves


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(a):
    """A leaf's raw bits (booleans as they are)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("vocab,seq,batch,seed,band,copy", [
    (2048, 128, 8, 0, 32, 0.3), (256, 33, 3, 7, 32, 0.3),
    (151_936, 64, 2, 1, 5, 0.9), (50, 17, 4, 2, 40, 0.0)])
def test_lm_batches_equal_the_reference(vocab, seq, batch, seed, band, copy):
    kw = dict(seed=seed, markov_band=band, copy_prob=copy)
    jds = jlm.SyntheticLMDataset(vocab, seq, batch, **kw)
    tds = tlm.SyntheticLMDataset(vocab, seq, batch, **kw)
    assert iter(tds) is tds
    for _ in range(4):
        want, got = next(jds), next(tds)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    for want, got in zip(jlm.synthetic_lm_batches(vocab, seq, batch, 3, seed),
                         tlm.synthetic_lm_batches(vocab, seq, batch, 3, seed)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def ckpt_tree(seed):
    """A tree with float32, bfloat16, int32, int16, uint8 and bool leaves,
    a scalar, nested dicts and lists, and more than 15 leaves and keys (the
    16-bit msgpack containers)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"params": {"w": f(3, 40), "bf": f(5, 7).astype(jnp.bfloat16),
                       "layers": [{"k": f(2, 3), "b": f(3)} for _ in range(9)],
                       "big": f(70)},
            "step": np.int32(5), "ids": np.arange(300, dtype=np.int16),
            "mask": rng.random(12) > 0.5, "codes": np.arange(256,
                                                            dtype=np.uint8)}
    tree.update({f"k{i:02d}": np.full((i % 3 + 1,), i, np.int32)
                 for i in range(16)})
    return tree


def test_checkpoint_bytes_equal_the_reference(tmp_path):
    tree = ckpt_tree(0)
    jsave(tmp_path / "j", 12, jax.tree.map(jnp.asarray, tree))
    ck.save_checkpoint(tmp_path / "t", 12, jax.tree.map(to_torch, tree))
    ck.save_checkpoint(tmp_path / "n", 12, tree)     # numpy leaves too
    want = (tmp_path / "j" / "step_00000012" / "state.msgpack").read_bytes()
    for d in ("t", "n"):
        step = tmp_path / d / "step_00000012"
        assert (step / "state.msgpack").read_bytes() == want
        assert (json.loads((step / "manifest.json").read_text())
                == json.loads((tmp_path / "j" / "step_00000012"
                               / "manifest.json").read_text()))


def test_each_package_restores_the_others_checkpoint(tmp_path):
    tree = ckpt_tree(1)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(to_torch, tree)
    jsave(tmp_path / "j", 3, jtree)
    ck.save_checkpoint(tmp_path / "t", 3, ttree)
    mine = ck.restore_checkpoint(tmp_path / "j", 3, ttree)
    theirs = jrestore(tmp_path / "t", 3, jtree)
    for g, w in zip(tree_leaves(mine), jax.tree.leaves(tree)):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(bits(g), bits(w))
    for g, w in zip(jax.tree.leaves(theirs), jax.tree.leaves(tree)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(bits(np.asarray(g)), bits(w))
    assert isinstance(mine["params"]["layers"], list)
    with pytest.raises(ValueError):
        ck.restore_checkpoint(tmp_path / "j", 3, {"only": ttree["step"]})
    bad = dict(ttree, step=torch.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        ck.restore_checkpoint(tmp_path / "j", 3, bad)


def test_latest_step_equals_the_reference(tmp_path):
    assert ck.latest_step(tmp_path / "none") is None
    assert jlatest_step(tmp_path / "none") is None
    for s in (3, 10, 7):
        ck.save_checkpoint(tmp_path, s, {"x": torch.zeros(1)})
    assert ck.latest_step(tmp_path) == jlatest_step(tmp_path) == 10


@pytest.mark.parametrize("obj", [
    [], {}, [0, 1, 127, 128, 255, 256, 65_535, 65_536, 2 ** 32, 2 ** 40],
    [True, False], "s" * 31, "s" * 32, "s" * 256, "é" * 40,
    b"", b"x" * 255, b"x" * 256, b"x" * 70_000, list(range(15)),
    list(range(16)), list(range(70_000)), {b"k%d" % i: i for i in range(15)},
    {b"k%d" % i: i for i in range(16)}, {b"a": [{b"b": b"\x00\xff"}]}])
def test_msgpack_subset_equals_msgpack(obj):
    packed = ck.packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    back = ck.unpackb(packed)
    want = msgpack.unpackb(packed, raw=True)
    norm = lambda v: (bytes(v) if isinstance(v, memoryview) else
                      [norm(x) for x in v] if isinstance(v, list) else
                      {k: norm(x) for k, x in v.items()}
                      if isinstance(v, dict) else v)
    assert norm(back) == want


def test_msgpack_subset_refuses_what_the_format_lacks():
    for obj in (-1, 1.5, None):
        with pytest.raises((TypeError, ValueError)):
            ck.packb(obj)
    with pytest.raises(ValueError):
        ck.unpackb(b"\xcb" + bytes(8))             # float64
    with pytest.raises(ValueError):
        ck.unpackb(b"\xc4\x05ab")                  # truncated bin
    with pytest.raises(ValueError):
        ck.unpackb(b"\x01\x02")                    # trailing bytes


@pytest.mark.parametrize("pattern,layers,dtype", [
    (("attn",), 2, jnp.float32), (("attn",), 3, jnp.bfloat16),
    (("attn", "local"), 3, jnp.float32), (("attn", "local"), 5, jnp.bfloat16)])
def test_lm_params_to_arrays_inverts_from_arrays(pattern, layers, dtype):
    jcfg = jreduced_config(jget_config("qwen3-1.7b"), d_model=64,
                           layers=layers, vocab=128)
    jcfg = jcfg.replace(layer_pattern=pattern, param_dtype=dtype,
                        tie_embeddings=len(pattern) == 1)
    if len(pattern) > 1:
        jcfg = jcfg.replace(attention=dataclasses.replace(
            jcfg.attention, sliding_window=16))
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    arrays = jax.tree.map(np.asarray, JT.init_params(jax.random.key(4),
                                                     jcfg))
    params = convert.lm_params_from_arrays(cfg, arrays, "cpu")
    back = convert.lm_params_to_arrays(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(arrays)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        np.testing.assert_array_equal(bits(g), bits(w))
    # and with a leading (peer) axis, through gossip_state_from_arrays
    stacked = jax.tree.map(lambda a: np.stack([a, a]), arrays)
    state = convert.gossip_state_from_arrays(stacked, {"m": stacked}, 9,
                                             "cpu", cfg=cfg)
    assert int(state.step) == 9 and state.step.dtype == torch.int32
    for tree in (state.params, state.opt_state["m"]):
        again = convert.lm_params_to_arrays(cfg, tree, lead=1)
        for g, w in zip(jax.tree.leaves(again), jax.tree.leaves(stacked)):
            np.testing.assert_array_equal(bits(g), bits(w))


def test_gossip_state_from_arrays_moves_any_tree():
    params = {"w": np.ones((4, 3), np.float32), "b": np.zeros(4, np.float32)}
    state = convert.gossip_state_from_arrays(params, {}, np.int32(2), "cpu")
    assert state.opt_state == {} and int(state.step) == 2
    assert torch.equal(state.params["w"], torch.ones(4, 3))


def test_trainer_checkpoint_restores_in_the_reference(tmp_path):
    """The trainer's checkpoint (the consensus params in the reference's
    layout) restores into the reference model's own tree."""
    train_mod.train(steps=2, batch=4, seq_len=16, d_model=32, dist="gossip",
                    n_peers=2, log_every=2, device="cpu",
                    ckpt_dir=str(tmp_path), ckpt_every=2)
    jcfg = jreduced_config(jget_config("qwen3-1.7b"), d_model=32, layers=2,
                           vocab=2048)
    like = {"params": JT.init_params(jax.random.key(0), jcfg)}
    assert jlatest_step(tmp_path) == 2
    got = jrestore(tmp_path, 2, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    assert all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(got))
