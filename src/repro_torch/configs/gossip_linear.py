"""The paper's model family: linear classifiers over fully distributed data.

A copy of ``repro/configs/gossip_linear.py`` (that module cannot be imported
here: its package loads JAX). ``tests/test_torch_core.py`` holds the fields,
``DATASETS`` and ``FAILURE_SCENARIOS`` equal to the reference."""
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class GossipLinearConfig:
    """One gossip-learning experimental setup (the paper's Table I rows).

    Problem shape: ``name``, ``dim`` (d, also the transmitted model size),
    ``n_nodes`` (N, one training record per node), ``n_test``,
    ``class_ratio``. Learning rule: ``learner`` ("pegasos" | "adaline" |
    "logistic"), ``lam`` (Pegasos λ, step 1/(λt)), ``eta`` (Adaline/logistic
    rate), ``cache_size`` (the VOTEDPREDICT cache), ``variant`` (CREATEMODEL
    "rw" | "mu" | "um"). Failure model (Section VI-A): ``drop_prob``,
    ``delay_max_cycles`` (delay uniform in [1, max] cycles),
    ``online_fraction`` (lognormal churn; 1.0 disables it). ``wire_dtype``
    names a wire codec of ``repro_torch.core.wire_codec`` (``None`` is
    f32). ``fault_model`` (a name of ``repro_torch.core.faults.
    FAULT_MODELS``), ``byzantine_frac`` (in [0, 1]) and ``defense`` (one
    of ``faults.DEFENSES``) are the reference's fault options; a run
    rejects bad values with the reference's messages."""
    name: str
    dim: int
    n_nodes: int
    n_test: int
    class_ratio: Tuple[int, int]
    learner: str = "pegasos"
    lam: float = 1e-4
    eta: float = 0.01
    cache_size: int = 10
    variant: str = "mu"
    drop_prob: float = 0.0
    delay_max_cycles: int = 1
    online_fraction: float = 1.0
    wire_dtype: Optional[str] = None
    fault_model: Optional[str] = None
    byzantine_frac: float = 0.0
    defense: str = "none"
    citation: str = "[DOI:10.1002/cpe.2858]"


# The paper's three datasets (Table I); repro_torch.data.synthetic generates
# surrogate sets with the same dimensions, sizes and class ratios.
REUTERS = GossipLinearConfig("reuters", dim=9947, n_nodes=2000, n_test=600,
                             class_ratio=(1300, 1300))
SPAMBASE = GossipLinearConfig("spambase", dim=57, n_nodes=4140, n_test=461,
                              class_ratio=(1813, 2788), lam=1e-3)
MALICIOUS_URLS = GossipLinearConfig("malicious-urls", dim=10, n_nodes=10_000,
                                    n_test=2000, class_ratio=(7921, 16039))

DATASETS = {c.name: c for c in (REUTERS, SPAMBASE, MALICIOUS_URLS)}


# Named failure operating points: "extreme" is the paper's hardest published
# scenario; the "sparse-*" family are the sparse-delivery regimes of
# Fig. 5-7.
FAILURE_SCENARIOS = {
    "clean": dict(drop_prob=0.0, delay_max_cycles=1, online_fraction=1.0),
    "extreme": dict(drop_prob=0.5, delay_max_cycles=10, online_fraction=0.9),
    "sparse-d0.5-o0.3": dict(drop_prob=0.5, delay_max_cycles=10,
                             online_fraction=0.3),
    "sparse-d0.5-o0.1": dict(drop_prob=0.5, delay_max_cycles=10,
                             online_fraction=0.1),
    "sparse-d0.8-o0.3": dict(drop_prob=0.8, delay_max_cycles=10,
                             online_fraction=0.3),
    "sparse-d0.8-o0.1": dict(drop_prob=0.8, delay_max_cycles=10,
                             online_fraction=0.1),
}


def with_failure_scenario(cfg: GossipLinearConfig,
                          scenario: str) -> GossipLinearConfig:
    """A copy of ``cfg`` with the named failure operating point applied;
    unknown scenarios and scenario keys that are not config fields raise."""
    try:
        overrides = FAILURE_SCENARIOS[scenario]
    except KeyError:
        raise ValueError(f"unknown failure scenario {scenario!r} "
                         f"(expected one of {sorted(FAILURE_SCENARIOS)})"
                         ) from None
    known = {f.name for f in dataclasses.fields(GossipLinearConfig)}
    bad = sorted(set(overrides) - known)
    if bad:
        raise ValueError(
            f"failure scenario {scenario!r} overrides unknown "
            f"GossipLinearConfig field(s) {bad} "
            f"(known fields: {sorted(known)})")
    return dataclasses.replace(cfg, **overrides)
