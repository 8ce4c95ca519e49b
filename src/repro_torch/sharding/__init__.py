"""The port's counterpart of ``repro/sharding``: the logical-axis rules
(``rules``), the activation constraints and per-rank bodies (``act``), and
the per-rank body's collectives (``compat``)."""
from repro_torch.sharding.compat import (Axis, exchange_rows, gather_rows,
                                         mesh_axis, ppermute, psum,
                                         reset_stats,
                                         stage_functional_collectives)
from repro_torch.sharding.rules import (LogicalRules, PartitionSpec,
                                        cache_pspecs, default_rules,
                                        named_sharding_tree, params_pspecs,
                                        partition_spec)

__all__ = [
    "LogicalRules",
    "default_rules",
    "partition_spec",
    "params_pspecs",
    "cache_pspecs",
    "named_sharding_tree",
    "PartitionSpec",
    "Axis", "mesh_axis", "ppermute", "exchange_rows", "gather_rows",
    "psum", "reset_stats", "stage_functional_collectives",
]
