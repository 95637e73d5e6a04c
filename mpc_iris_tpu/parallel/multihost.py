"""Multi-host / multi-party topology.

Two distinct distribution layers (SURVEY.md section 2 parallelism table):

1. **Within one MPC party**: all of the party's hosts/chips form ONE JAX
   process universe (`jax.distributed`) and one `Mesh`; the party's DB shard
   axis spans every device and winner/reply reductions are device
   collectives (collectives.py). This replaces the reference's rayon pool (src/lib.rs:44-51)
   at datacenter scale.

2. **Between parties and the coordinator**: NEVER a shared collective universe —
   each party must stay cryptographically isolated, exactly like the
   reference's separate OS processes (src/main.rs:384-452). Share/reply tensors
   travel over host networking via protocol/ (TCP; the reference's
   bytemuck-framed streams, src/main.rs:405-445), with device buffers staged
   through host RAM.

Typical party bring-up on an N-host pod slice:

    from mpc_iris_tpu.parallel import multihost, make_mesh
    multihost.init_party(coordinator_address="10.0.0.1:9999",
                         num_processes=N, process_id=rank)
    mesh = make_mesh(db=len(jax.devices()))          # global devices
    shares = np.memmap("mpc.share-0", dtype=np.uint16, shape=(N_DB, 12800))
    engine = ShardedShareEngine(shares, mesh)        # GLOBAL-indexed source

The engines take the GLOBAL share/masks source (shared filesystem memmap or
any [N, ...]-indexable) and each process reads ONLY its own
`local_entry_spans` slices — other ranks' rows are never touched/paged. A
host that must pre-fetch rows from remote storage should write them into a
global-shaped sparse local file (filling just its spans) and hand that
memmap to the engine; the engines do not accept rank-compacted arrays.

Each party runs its own coordinator_address/port tuple; nothing is shared
between parties except the protocol/ TCP endpoints.
"""

from __future__ import annotations

import jax


def init_party(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize this party's JAX process universe (idempotent, no-op for
    single-process runs).

    Args mirror jax.distributed.initialize; all None => single-process party.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def party_info() -> dict:
    """This process's position within its party's universe."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def local_entry_spans(total_rows: int, chunk: int, mesh) -> list[tuple[int, int]]:
    """Contiguous [start, end) DB-row spans THIS process loads under the
    sharded engines' strided-by-chunk layout (one span per global block).

    The engines already read only these spans when handed the GLOBAL-indexed
    (memmap'd) source; this helper exists for callers that must *fetch* rows
    from remote storage first — write the fetched rows into a global-shaped
    sparse local file at these offsets (the engines index globally; they do
    not accept rank-compacted arrays). Empty/clamped spans at the DB tail
    are omitted.

    ``chunk`` is clamped exactly like the engines clamp it
    (sharded.effective_chunk) so the spans always describe the rows the
    engine will actually read — pass the same value you pass the engine.
    """
    from mpc_iris_tpu.parallel.sharded import effective_chunk, local_db_span

    lo, hi = local_db_span(mesh)
    d = mesh.shape["db"]
    chunk = effective_chunk(chunk, total_rows, d)
    block = chunk * d
    spans = []
    for j in range(max(1, -(-total_rows // block))):
        start = (j * d + lo) * chunk
        end = min(total_rows, start + (hi - lo) * chunk)
        if end > start:
            spans.append((start, end))
    return spans
