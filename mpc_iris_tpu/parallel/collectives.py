"""Cross-device collectives for exact fraction minima.

XLA's built-in reduction collectives (psum/pmax) can't carry the exact rational
comparator, so the global winner is combined by all-gathering each shard's winner
triple (n, d, index) — 12 bytes per query per shard over NVLink — and reducing with
the same exact comparator used on-device. This is the equivalent of the coordinator's
running argmin over participant streams (reference src/main.rs:581-626), but it stays
on the devices.
"""

from __future__ import annotations

import jax

from mpc_iris_tpu.ops.decode import fold_candidates


def fraction_allmin(n, d, idx, axis_name: str):
    """All-reduce an exact fraction minimum over a mesh axis.

    Args:
      n, d, idx: int32 [...] per-shard winner triples (d == 0 means invalid/+inf).
      axis_name: mesh axis to reduce over.

    Returns (n, d, idx) replicated across the axis: the global minimum fraction,
    ties keeping the smallest *global index*. (Shard rank order is NOT index
    order under the strided-by-chunk DB distribution, so the fold must compare
    carried indices, not gather slots.)
    """
    # [A, ...] gathered along a new leading axis; 12 bytes/query/shard.
    gn = jax.lax.all_gather(n, axis_name)
    gd = jax.lax.all_gather(d, axis_name)
    gi = jax.lax.all_gather(idx, axis_name)
    return fold_candidates(gn, gd, gi, axis=0)
