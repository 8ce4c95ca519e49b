"""The port's paper drivers (``repro_torch.paper``) against the JAX
package's (``benchmarks/paper_*.py``) at ``quick=True`` on the CPU.

Both drivers of a pair read one small seeded dataset (their ``dataset``
names monkeypatched; the theory driver makes its own geometries) and write
no file (their ``write_csv`` names record the table). The port's protocol
runs take its sharded engine, the JAX drivers the reference engine.
Checked: the CSV name and header, the rows' labels and cycles equal and
their errors (and similarities) within 0.02, the JAX suite's curve bar;
Table I's rows equal but for the error (within 0.02) and the time; the
theory rows' steps equal, their regrets and bounds within rtol 3e-3 (the
spambase-like geometry's measured 3.6e-4, ``tests/test_torch_theory.py``);
and every printed line equal in its labels, its numbers within the same
bars (``us_per_iter`` is a time and not compared).
"""
import dataclasses
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.data.synthetic import make_linear_dataset
from repro_torch import convert

REPO = Path(__file__).resolve().parents[1]
CURVE_TOL = 0.02
REGRET_RTOL = 3e-3
# the JAX benchmark module of each port driver
PAIRS = {"fig1": "paper_fig1", "fig2": "paper_fig2", "fig3": "paper_fig3",
         "table1": "paper_table1", "theory": "paper_theory"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its runs are thousands of
    small ops, whose thread pool costs far more than it gains when pytest
    workers share the cores (the theory tests took ~20 s alone and 214 s
    beside three other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_dataset():
    """A Table-I-like surrogate, small: 256 peers, d = 12, lam = 1e-3."""
    cfg = JConfig(name="small", dim=12, n_nodes=256, n_test=100,
                  class_ratio=(1, 1), lam=1e-3)
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, 356, 12, noise=0.05, separation=2.5)
    return X[:256], y[:256], X[256:], y[256:], cfg


def run_driver(monkeypatch, capsys, module, cfg):
    """``module.run(quick=True)`` on the small dataset (with ``cfg``):
    (its rows, the (name, header) written, its printed lines)."""
    X, y, Xt, yt, _ = small_dataset()
    written = []
    if hasattr(module, "dataset"):
        monkeypatch.setattr(module, "dataset",
                            lambda name, seed=0: (X, y, Xt, yt, cfg))
    monkeypatch.setattr(module, "write_csv",
                        lambda name, header, rows: written.append(
                            (name, header)))
    kw = {} if module.__name__.startswith("benchmarks") else dict(
        device="cpu")
    capsys.readouterr()
    rows = module.run(quick=True, **kw)
    lines = capsys.readouterr().out.strip().splitlines()
    return rows, written, lines


def split_line(line):
    """A printed line's labels and its numbers (``key=value`` fields)."""
    labels, nums = [], []
    for field in line.split(","):
        key, eq, val = field.partition("=")
        if eq and val not in ("True", "False"):
            labels.append(key)
            nums.append(float(val))
        else:
            labels.append(field)
    return labels, nums


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_port_driver_matches_jax_driver(monkeypatch, capsys, name):
    jmod = importlib.import_module(f"benchmarks.{PAIRS[name]}")
    pmod = importlib.import_module(f"repro_torch.paper.{name}")
    jcfg = small_dataset()[4]
    pcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jrows, jcsv, jlines = run_driver(monkeypatch, capsys, jmod, jcfg)
    prows, pcsv, plines = run_driver(monkeypatch, capsys, pmod, pcfg)

    assert pcsv == jcsv and len(pcsv) == 1
    assert len(prows) == len(jrows) > 0
    for p, j in zip(prows, jrows):
        assert len(p) == len(j)
        if name == "theory":            # geometry, t, avg_regret, bound
            assert p[:2] == j[:2]
            np.testing.assert_allclose(p[2:], j[2:], rtol=REGRET_RTOL,
                                       atol=1e-5)      # the rows' rounding
        elif name == "table1":          # ..., err, paper_err, us_per_iter
            assert p[:4] == j[:4] and p[5] == j[5]
            assert abs(p[4] - j[4]) <= CURVE_TOL
        else:                           # labels and cycle, then the values
            k = sum(not isinstance(v, float) for v in j)
            assert p[:k] == j[:k]
            assert max(abs(a - b) for a, b in zip(p[k:], j[k:])) \
                <= CURVE_TOL, (p, j)

    assert len(plines) == len(jlines) > 0
    for pl, jl in zip(plines, jlines):
        (pl_labels, pl_nums), (jl_labels, jl_nums) = (split_line(pl),
                                                      split_line(jl))
        assert pl_labels == jl_labels
        if name == "table1":
            pl_nums, jl_nums = pl_nums[:-1], jl_nums[:-1]
        if name == "theory":
            np.testing.assert_allclose(pl_nums, jl_nums, rtol=REGRET_RTOL,
                                       atol=1e-5)
        else:
            assert all(abs(a - b) <= CURVE_TOL
                       for a, b in zip(pl_nums, jl_nums)), (pl, jl)


def test_paper_main_runs_the_named_drivers_in_order(monkeypatch, capsys):
    from repro_torch.paper import __main__ as main_mod
    ran = []
    for name in main_mod.DRIVERS:
        mod = importlib.import_module(f"repro_torch.paper.{name}")
        monkeypatch.setattr(mod, "run", lambda quick, device, name=name:
                            ran.append((name, quick, device)))
    main_mod.main(["--quick", "--device", "cpu", "theory", "fig1"])
    assert ran == [("fig1", True, "cpu"), ("theory", True, "cpu")]
    ran.clear()
    main_mod.main([])
    assert ran == [(n, False, None) for n in main_mod.DRIVERS]
    assert main_mod.DRIVERS == ("table1", "fig1", "fig2", "fig3", "theory")
    with pytest.raises(SystemExit):
        main_mod.main(["fig9"])
    assert "unknown driver" in capsys.readouterr().err


def test_paper_csvs_go_to_results_pt_paper(tmp_path, monkeypatch):
    from repro_torch.paper import common
    assert common.OUT_DIR == REPO / "results" / "pt_paper"
    monkeypatch.setattr(common, "OUT_DIR", tmp_path / "pt_paper")
    fp = common.write_csv("x", "a,b", [(1, 0.5), ("s", 2)])
    assert fp.read_text() == "a,b\n1,0.5\ns,2\n"


def test_port_examples_import_no_jax():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((REPO / "examples").glob("pt_*.py"))
    assert {p.name for p in files} >= {"pt_quickstart.py",
                                       "pt_robustness_failures.py"}
    for p in files:
        assert not pat.findall(p.read_text()), p
