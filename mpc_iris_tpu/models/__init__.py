"""Match engines (layer L2 of SURVEY.md) — the device equivalents of the reference's
`DistanceEngine` / `MasksEngine` (src/lib.rs:28-80) plus a fused plaintext match
pipeline the reference computes only via its scalar oracle (src/template.rs:43-64).

All engines hold the database device-resident (HBM) in matmul-friendly layouts, expand
queries over 31 rotations on device, and stream the DB through int8 GEMMs in fixed-size
chunks under `lax.scan` so intermediates stay bounded at any DB size.
"""

from mpc_iris_tpu.models.engines import (
    KeyedShareEngine,
    MasksEngine,
    PlaintextEngine,
    ShareEngine,
    prepare_query_planes,
)

__all__ = ["KeyedShareEngine", "MasksEngine", "PlaintextEngine", "ShareEngine",
           "prepare_query_planes"]
