#!/usr/bin/env python
"""Library-API walkthrough: using mpc_iris_tpu as a Python framework.

The CLI roles (examples/quickstart.sh) are thin wrappers over the library
surface shown here:

  1. data types        — Template / Bits, packed-plane batch arrays
  2. plaintext engine  — fused min-distance uniqueness check on device
  3. MPC in-process    — share split, per-party ShareEngine dots, wrapping
                         share-sum reconstruction, reference-exact f64 decode
  4. keyed party       — serve a share with ZERO share bytes stored
                         (regenerated on device from the 32-byte prepare key)
  5. re-randomization  — pairwise zero-sum share refresh, reconstruction
                         invariant

Every assertion is exact (bit-identical f64), not approximate. Runs on any
backend:

    JAX_PLATFORMS=cpu python examples/api_demo.py     # CPU (~1 min)
    python examples/api_demo.py                       # GPU

Reference parity notes: the plaintext path equals Template.distance
(src/template.rs:43-64), the MPC path equals the reference's
encode/share/dot/decode pipeline (src/lib.rs:16-107, src/encoded_bits.rs:22-38).
"""

import numpy as np

from mpc_iris_tpu import Template, native
from mpc_iris_tpu.models.engines import (
    KeyedShareEngine,
    MasksEngine,
    PlaintextEngine,
    ShareEngine,
)
from mpc_iris_tpu.ops.decode import decode_distance_batch_np

N_DB, B, N_PARTIES, CHUNK = 1024, 4, 3, 256


def check(cond, what):
    """Exactness checks must survive `python -O` (a bare assert would
    vanish and the demo-as-test would pass vacuously)."""
    if not cond:
        raise RuntimeError(f"api_demo check failed: {what}")


def main():
    rng = np.random.default_rng(42)

    # ------------------------------------------------- 1. data types
    # A Template is two packed 12,800-bit planes (pattern + valid-bit mask).
    # Engines take batch arrays of the packed planes: uint8 [N, 1600].
    db = [Template.random(rng) for _ in range(N_DB)]
    patterns = np.stack([t.pattern.data for t in db])
    masks = np.stack([t.mask.data for t in db])

    # Queries: rotated copies of random DB entries, so the expected winner
    # and its distance (0.0, rotation-invariant) are known exactly.
    q_idx = rng.integers(0, N_DB, size=B)
    queries = [db[i].rotated(int(rng.integers(-15, 16))) for i in q_idx]
    qpat = np.stack([t.pattern.data for t in queries])
    qmsk = np.stack([t.mask.data for t in queries])

    # ------------------------------------------------- 2. plaintext engine
    # One fused device pass per batch: int8 matmuls over the
    # chunk-scanned DB + exact integer-fraction argmin (no f64 on device).
    print(f"[2] PlaintextEngine: {B} queries vs {N_DB} templates")
    eng = PlaintextEngine(patterns, masks, chunk=CHUNK)
    results = eng.match(qpat, qmsk)
    for want, r in zip(q_idx, results):
        check((r.index, r.distance) == (want, 0.0), r)
    # Winner distances are bit-identical to the scalar reference oracle:
    oracle = queries[0].distance(db[int(q_idx[0])])
    check(results[0].distance == oracle, "f64 parity with Template.distance")
    print(f"    self-match winners exact; f64 parity with Template.distance")

    # ------------------------------------------------- 2b. threshold audit
    # find_under lists EVERY entry under a threshold (the argmin's audit
    # complement) with an EXACT rational comparison: a threshold placed
    # exactly ON a distance excludes it (strict <).
    print("[2b] find_under: dedup audit (exact threshold semantics)")
    audits = eng.find_under(qpat, qmsk, 1e-9)
    for want, hits in zip(q_idx, audits):
        check([m.index for m in hits] == [int(want)], hits)
        check(all(m.distance == 0.0 for m in hits), hits)
    check(eng.find_under(qpat, qmsk, 0.0) == [[]] * B,
          "strict <: t=0.0 excludes exact duplicates")
    print("    each query's planted duplicate listed; t=0.0 lists nothing")

    # ------------------------------------------------- 3. MPC in-process
    # Secret-share the DB: encode to Z_2^16 ({-1,0,+1} ring embedding), then
    # split into N_PARTIES additive shares. Shares s < n-1 are addressable
    # ChaCha20 keystreams of `key` (docs/SPEC.md section 4.1); the last share
    # carries the data. This is what `prepare` writes to mpc.share-i files.
    # Derived from the seeded rng so any failure reproduces byte-identically
    # (a real deployment uses a CSPRNG, e.g. os.urandom(32)).
    key = rng.bytes(32)
    enc = native.encode_u16_native(patterns, masks)
    shares = native.share_split(enc, N_PARTIES, key)  # u16 [n, N_DB, 12800]

    # Each party serves dot shares of the (public) query against ITS share
    # only — dot-with-a-public-vector is linear, so the wrapping u16 sum of
    # the per-party replies is the true encoded dot. The coordinator holds
    # the plaintext masks for the denominators.
    print(f"[3] MPC: {N_PARTIES} in-process parties, share-sum reconstruction")
    parties = [ShareEngine(shares[p], chunk=CHUNK) for p in range(N_PARTIES)]
    masks_eng = MasksEngine(masks, chunk=CHUNK)
    dots = native.share_sum([p.dots(qpat, qmsk) for p in parties])  # [B,N,31]
    dens = masks_eng.dots(qmsk)                                     # [B,N,31]
    # Reference-exact f64 decode (min over 31 rotations, NaN-skip semantics):
    dist = decode_distance_batch_np(
        dots.reshape(-1, 31), dens.reshape(-1, 31)
    ).reshape(B, -1)
    check((dist.argmin(axis=1) == q_idx).all(), "MPC winners == planted")
    # The MPC pipeline reproduces the plaintext engine bit-for-bit:
    for b, r in enumerate(results):
        check(dist[b].min() == r.distance, "MPC f64 == plaintext f64")
    print("    MPC distances == plaintext engine distances (bit-exact f64)")

    # ------------------------------------------------- 4. keyed party
    # Party 0's share is pure keystream, so it can serve with no share bytes
    # at all: rows are regenerated on device from (key, stream_id, row).
    print("[4] KeyedShareEngine: party 0 from the 32-byte key alone")
    keyed = KeyedShareEngine(key, stream_id=0, count=N_DB, chunk=CHUNK)
    np.testing.assert_array_equal(keyed.dots(qpat, qmsk), parties[0].dots(qpat, qmsk))
    print("    keyed dots == file-backed dots (byte-identical)")

    # ------------------------------------------------- 5. re-randomization
    # Parties 0 and 1 refresh their shares with opposite-signed halves of a
    # pairwise zero-sum ChaCha20 stream: each share changes, the sum doesn't.
    print("[5] rerandomize: pairwise refresh, reconstruction invariant")
    pair_key = rng.bytes(32)
    s0 = native.rerandomize(shares[0].copy(), pair_key, +1)
    s1 = native.rerandomize(shares[1].copy(), pair_key, -1)
    check(not np.array_equal(s0, shares[0]), "share 0 changed")
    np.testing.assert_array_equal(
        native.share_sum([s0, s1]), native.share_sum([shares[0], shares[1]])
    )
    print("    shares changed, share-sum unchanged")

    # ------------------------------------------------- 6. serving stack
    # The network roles as library objects: two share-holding participants
    # behind a Coordinator, fronted by a QueryServer; clients use the
    # one-shot wire or a persistent session (SPEC 5.2/5.5).
    print("[6] serving stack: QueryServer + persistent client, in-process")
    import asyncio

    from mpc_iris_tpu.protocol import (
        Coordinator,
        ParticipantServer,
        PersistentQueryClient,
        QueryServer,
        query_remote,
    )

    async def serve_demo():
        servers = [ParticipantServer(p, "127.0.0.1", 0) for p in parties]
        addrs = [await s.start() for s in servers]
        coord = Coordinator(masks_eng, addrs)
        front = QueryServer(coord, "127.0.0.1", 0)
        host, port = await front.start()
        try:
            q_t = Template.from_bytes(bytes(qpat[0]) + bytes(qmsk[0]))
            solo = await query_remote(host, port, q_t)
            session = await PersistentQueryClient.connect(host, port)
            o1 = await session.query(q_t)   # same connection,
            o2 = await session.query(q_t)   # many queries
            await session.close()
            return solo, o1, o2
        finally:
            await front.close()
            for s in servers:
                await s.close()

    solo, o1, o2 = asyncio.run(serve_demo())
    check((solo.index, solo.distance) == (o1.index, o1.distance)
          == (o2.index, o2.distance), "persistent == one-shot outcomes")
    check(solo.distance == results[0].distance, "served == local engine")
    print("    one-shot and persistent wires agree with the local engine")

    print("api_demo: all checks passed")


if __name__ == "__main__":
    main()
