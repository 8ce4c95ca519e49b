"""``repro_torch.launch.train`` on the vlm and audio families, reduced, on
the CPU: llama-3.2-vision-11b (5 layers, the cross layer's gates trained
from zero) and whisper-medium (2 + 2 layers, 64 learned positions) at
d_model 64, batch 8 x 32, 30 steps, under all-reduce and under gossip (4
peers, mu, hypercube, AdamW), with the stub source beside the tokens
(``train``'s ``source``: one batch under all-reduce, ``batch // peers``
broadcast across the peers under gossip). Every loss is finite, gossip
ends within 0.8 of all-reduce and the peers agree
(tests/test_torch_train_launch.py's bars).

The vision model's loss falls (the mean of the last five steps 0.1 under
that of the first five) and its gates leave zero. Whisper's does not fall
at this size in either package: its ungated cross-attention adds the same
large vector at every position (one stub source for every example), which
drowns the 0.02-scale token embeddings, and the reference's own trainer
goes 7.669 -> 7.624 over 300 steps at lr 1e-2 in 30-step means (the port:
7.689 -> 7.621), i.e. to ln(2048) = 7.625 and no further. So whisper's
loss is held to stay within 0.1 of ln(vocab) instead."""
import numpy as np
import pytest
import torch

from repro_torch.launch import train as train_mod

STEPS = 30
KW = dict(reduced=True, steps=STEPS, batch=8, seq_len=32, lr=3e-3,
          log_every=1, seed=0, d_model=64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium"])
def test_train_vlm_and_audio_under_allreduce_and_gossip(arch):
    runs = {}
    for dist in ("allreduce", "gossip"):
        params, hist = train_mod.train(arch, dist=dist, n_peers=4,
                                       merge="mu", **KW)
        losses = [h[1] for h in hist]
        assert [h[0] for h in hist] == list(range(1, STEPS + 1))
        assert np.all(np.isfinite(losses)), (dist, losses)
        if arch == "whisper-medium":
            assert np.all(np.abs(np.array(losses) - np.log(2048)) < 0.1)
        else:
            assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, (
                dist, losses)
        runs[dist] = params, hist
    ar, go_ = runs["allreduce"][1][-1][1], runs["gossip"][1][-1][1]
    assert abs(ar - go_) < 0.8, f"allreduce {ar} vs gossip {go_}"
    assert runs["gossip"][1][-1][2] < 0.3       # peers agree
    for params, _ in runs.values():
        if arch == "whisper-medium":
            assert {"encoder", "pos_embed"} <= set(params)
            continue
        cross = params["blocks"][4]
        assert float(cross["gate_attn"]) != 0.0
        assert float(cross["gate_ffn"]) != 0.0
