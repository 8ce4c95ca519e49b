"""The paper's protocol and the gossip optimizer; the reference's
``repro/core/__init__.py`` names, in its ``__all__`` order.
``linear_gossip_mesh_step`` runs a cycle with peers = ranks of a
``torch.distributed`` group.

The engines' and the ensembles' names resolve on first use (a module
``__getattr__``): the kernels import ``core.faults`` and
``core.wire_codec``, and the engines import the kernels, so importing the
engines here would send every first import of a kernel round through
them.
"""
import importlib

from repro_torch.core.learners import (
    LinearModel,
    init_model,
    pegasos_update,
    adaline_update,
    logistic_update,
    make_update,
)
from repro_torch.core.merge import merge, create_model, VARIANTS
from repro_torch.core.cache import (ModelCache, init_cache, cache_add,
                                    freshest, voted_predict)
from repro_torch.core.gossip_optimizer import (
    GossipState,
    stack_for_peers,
    unstack_mean,
    gossip_merge,
    peer_disagreement,
    make_gossip_train_step,
    make_allreduce_train_step,
    perms_for_step,
    linear_gossip_mesh_step,
)
from repro_torch.core import peer_sampling, theory

_LAZY = {"SimState": "simulation", "run_simulation": "simulation",
         "simulate_cycle": "simulation", "churn_trace": "simulation",
         "run_sharded_simulation": "sharded_engine",
         "run_weighted_bagging": "ensemble",
         "run_sequential_pegasos": "ensemble"}

__all__ = [
    "LinearModel", "init_model", "pegasos_update", "adaline_update",
    "logistic_update", "make_update", "merge", "create_model", "VARIANTS",
    "ModelCache", "init_cache", "cache_add", "freshest", "voted_predict",
    "SimState", "run_simulation", "simulate_cycle", "churn_trace",
    "run_sharded_simulation",
    "run_weighted_bagging", "run_sequential_pegasos",
    "GossipState", "stack_for_peers", "unstack_mean", "gossip_merge",
    "peer_disagreement", "make_gossip_train_step", "make_allreduce_train_step",
    "perms_for_step", "linear_gossip_mesh_step", "peer_sampling", "theory",
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
