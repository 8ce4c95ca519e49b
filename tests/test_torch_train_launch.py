"""``repro_torch.launch.train`` end to end on the CPU: the counterpart of
``tests/test_system.py::test_gossip_transformer_matches_allreduce_loss``
(gossip and all-reduce reach losses within 0.8 of each other and the
peers agree), the history and checkpoints ``train`` returns and writes,
its device rule and flags, and llama3-405b (refused until it was ported)
trained reduced."""
import math

import numpy as np
import pytest
import torch

from repro_torch.launch import train as train_mod
from repro_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (80 training steps of many
    small ops; a thread pool costs more than it gains beside other pytest
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gossip_transformer_matches_allreduce_loss():
    """``tests/test_system.py::test_gossip_transformer_matches_allreduce_loss``
    on the port."""
    _, h_ar = train_mod.train("qwen3-1.7b", reduced=True, steps=40, batch=8,
                              seq_len=32, lr=3e-3, dist="allreduce",
                              log_every=40, seed=0, d_model=128,
                              device="cpu")
    _, h_go = train_mod.train("qwen3-1.7b", reduced=True, steps=40, batch=8,
                              seq_len=32, lr=3e-3, dist="gossip", n_peers=4,
                              merge="mu", log_every=40, seed=0, d_model=128,
                              device="cpu")
    ar, go_ = h_ar[-1][1], h_go[-1][1]
    assert abs(ar - go_) < 0.8, f"allreduce {ar} vs gossip {go_}"
    assert h_go[-1][2] < 0.3      # peers agree
    assert [h[0] for h in h_go] == [40]


def test_train_history_and_final_params(tmp_path):
    params, hist = train_mod.train(steps=3, batch=4, seq_len=16, d_model=32,
                                   dist="gossip", n_peers=2, log_every=1,
                                   device="cpu", ckpt_dir=str(tmp_path),
                                   ckpt_every=3)
    assert [h[0] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h[1]) and h[2] >= 0.0 for h in hist)
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    assert (tmp_path / "step_00000003" / "state.msgpack").exists()
    with pytest.raises(ValueError, match="split"):
        train_mod.train(steps=1, batch=3, n_peers=2, dist="gossip",
                        d_model=32, device="cpu")
    with pytest.raises(ValueError, match="dist"):
        train_mod.train(steps=1, d_model=32, dist="ring", device="cpu")


def test_train_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.train(steps=1, d_model=32)


def test_train_names_what_is_not_ported():
    # nothing is refused any more: the last refused architecture trains
    _, hist = train_mod.train("llama3-405b", steps=2, batch=2, seq_len=16,
                              d_model=32, log_every=1, device="cpu")
    assert [s for s, _, _ in hist] == [1, 2]
    assert all(math.isfinite(loss) for _, loss, _ in hist)


def test_train_main_parses_the_reference_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(train_mod, "train", lambda *a, **kw: seen.update(
        kw, arch=a[0]))
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "qwen3-4b", "--full", "--steps", "7", "--dist",
        "gossip", "--peers", "2", "--merge", "um", "--seq-len", "64",
        "--device", "cpu"])
    train_mod.main()
    assert seen["arch"] == "qwen3-4b" and seen["reduced"] is False
    assert (seen["steps"], seen["dist"], seen["n_peers"], seen["merge"],
            seen["seq_len"], seen["device"]) == (7, "gossip", 2, "um", 64,
                                                 "cpu")
