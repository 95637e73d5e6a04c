"""N-party match protocol over TCP (layer L4 of SURVEY.md).

Wire format parity with the reference (src/main.rs:405-445, 486-560):

- query: the raw 3,200-byte template (pattern plane then mask plane), plaintext
  (security model v1: query and masks are public, only DB patterns are shared),
- reply: a stream of 62-byte records — 31 little-endian u16 dot shares per DB entry,
  in DB order — terminated by connection close,
- topology: coordinator fans out one connection per participant per query and sums
  the per-party u16 shares to reconstruct plaintext distances (the only place they
  exist).

Device compute (the engines) runs in worker threads feeding asyncio queues, so network
streaming overlaps the device chunk scans — the tokio-pipeline equivalent
(src/main.rs:423-445, 508-626).
"""

from mpc_iris_tpu.protocol.participant import ParticipantServer
from mpc_iris_tpu.protocol.coordinator import (
    Coordinator,
    MatchAt,
    PersistentQueryClient,
    QueryOutcome,
    QueryServer,
    StalledPartyError,
    TruncatedScanError,
    UnderThresholdOutcome,
    query_remote,
    query_remote_under,
)

__all__ = [
    "ParticipantServer",
    "Coordinator",
    "MatchAt",
    "PersistentQueryClient",
    "QueryOutcome",
    "UnderThresholdOutcome",
    "QueryServer",
    "StalledPartyError",
    "TruncatedScanError",
    "query_remote",
    "query_remote_under",
]
