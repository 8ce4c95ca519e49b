"""Shared driver utilities: CSV output and the dataset cache.

The port's copy of the parts of ``benchmarks/common.py`` that the paper's
drivers use: ``write_csv`` (to ``results/pt_paper/`` in the checkout) and
the cached surrogate ``dataset(name, seed)``."""
from __future__ import annotations

import functools
from pathlib import Path

from repro_torch.data.synthetic import paper_dataset

REPO_ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = REPO_ROOT / "results" / "pt_paper"


def write_csv(name: str, header: str, rows) -> Path:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    fp = OUT_DIR / f"{name}.csv"
    with fp.open("w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    return fp


@functools.lru_cache(maxsize=None)
def dataset(name: str, seed: int = 0):
    """(X_train, y_train, X_test, y_test, cfg) of a Table I surrogate, made
    once a process."""
    return paper_dataset(name, seed)
