"""The port's counterpart of ``repro/sharding``: the per-rank body's
collectives (``compat``). The logical-axis rules (``rules``, ``act``)
wait for ROADMAP.md queue 1 item 11's second half."""
from repro_torch.sharding.compat import (Axis, exchange_rows, gather_rows,
                                         mesh_axis, ppermute, psum,
                                         reset_stats)

__all__ = ["Axis", "mesh_axis", "ppermute", "exchange_rows", "gather_rows",
           "psum", "reset_stats"]
