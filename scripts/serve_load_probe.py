"""End-to-end uniqueness-SERVICE throughput: concurrent network clients vs
the micro-batching QueryServer (SPEC 5.2), all roles in one process.

Measures sustained queries/s and per-query latency through the full stack:
client TCP -> QueryServer micro-batch aggregation -> one batched MPC round
over 2 share-holding participants -> fused device decode -> 24-byte replies.
All roles share one process, so one JAX process drives the card; the number
documents the service envelope on that host, wire included.

PYTHONPATH=. python scripts/serve_load_probe.py \
    [--db 20480] [--clients 16] [--queries 96] [--batch 16]
"""

import argparse
import asyncio
import time

import numpy as np

from mpc_iris_tpu.models import KeyedShareEngine, MasksEngine, ShareEngine
from mpc_iris_tpu.native import encode_u16_native, share_split
from mpc_iris_tpu.protocol import (
    Coordinator,
    ParticipantServer,
    QueryServer,
    query_remote,
)
from mpc_iris_tpu.types import Template


async def run(args):
    rng = np.random.default_rng(7)
    pats = rng.integers(0, 256, (args.db, 1600), dtype=np.uint8)
    msks = rng.integers(0, 256, (args.db, 1600), dtype=np.uint8)
    key = rng.bytes(32)
    enc = encode_u16_native(pats, msks)
    shares = share_split(enc, 2, key)
    del enc
    print(f"built {args.db}-entry share DB", flush=True)

    # --keyed: party 0 regenerates its share on device from the key (the
    # flagship zero-share-I/O participant); party 1 holds the data share.
    # Both engines timeshare the one chip, so split HBM between them.
    if args.keyed:
        engines = [
            KeyedShareEngine(key, 0, args.db, chunk=args.chunk,
                             hbm_budget=2 << 30, batch_hint=args.batch),
            ShareEngine(shares[1], chunk=args.chunk),
        ]
    else:
        engines = [ShareEngine(s, chunk=args.chunk) for s in shares]
    del shares

    # Solo serving rounds (max_batch=1) speak the reference wire; micro-
    # batched rounds need the batched wire on every participant.
    wire = "batched" if args.batch > 1 else "reference"
    parts = [
        ParticipantServer(e, "127.0.0.1", 0, wire=wire) for e in engines
    ]
    addrs = [await p.start() for p in parts]
    coord = Coordinator(MasksEngine(msks, chunk=args.chunk), addrs)
    server = QueryServer(coord, "127.0.0.1", 0,
                         max_batch=args.batch, batch_window=0.02,
                         max_inflight=args.clients,
                         rounds_inflight=args.rounds)
    host, port = await server.start()

    queries = [Template.random(rng) for _ in range(args.queries)]
    # warm the compile paths with one query
    await query_remote(host, port, queries[0])

    lat = []

    if args.persistent:
        # Persistent wire (SPEC 5.5): each concurrent client keeps ONE
        # connection for its whole query stream — no per-query TCP handshake.
        from mpc_iris_tpu.protocol import PersistentQueryClient

        qq: asyncio.Queue = asyncio.Queue()
        for q in queries:
            qq.put_nowait(q)

        async def worker():
            c = await PersistentQueryClient.connect(host, port)
            try:
                while True:
                    try:
                        q = qq.get_nowait()
                    except asyncio.QueueEmpty:
                        return
                    t0 = time.monotonic()
                    out = await c.query(q)
                    lat.append(time.monotonic() - t0)
                    assert out.total == args.db
            finally:
                await c.close()

        t0 = time.monotonic()
        await asyncio.gather(*[worker() for _ in range(args.clients)])
        dt = time.monotonic() - t0
    else:
        sem = asyncio.Semaphore(args.clients)

        async def client(q):
            async with sem:
                t0 = time.monotonic()
                out = await query_remote(host, port, q)
                lat.append(time.monotonic() - t0)
                assert out.total == args.db
                return out

        t0 = time.monotonic()
        await asyncio.gather(*[client(q) for q in queries])
        dt = time.monotonic() - t0

    lat.sort()
    qps = args.queries / dt
    wire_note = "persistent" if args.persistent else "one-shot"
    print(f"{args.queries} queries, {args.clients} concurrent clients "
          f"({wire_note} wire), micro-batch {args.batch}: "
          f"{dt:.2f}s = {qps:.1f} q/s "
          f"({qps * args.db:.3e} query-entries/s); "
          f"client p50 {lat[len(lat)//2]*1e3:.0f} ms "
          f"p95 {lat[int(0.95*len(lat))]*1e3:.0f} ms", flush=True)
    print("server stats:", server.stats(), flush=True)

    await server.close()
    for p in parts:
        await p.close()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--db", type=int, default=20_480)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--queries", type=int, default=96)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--rounds", type=int, default=1,
                   help="concurrent micro-batched MPC rounds (QueryServer "
                        "rounds_inflight)")
    p.add_argument("--persistent", action="store_true",
                   help="clients reuse ONE connection each (SPEC 5.5) "
                        "instead of a fresh connection per query")
    p.add_argument("--keyed", action="store_true",
                   help="party 0 serves keyed (on-device share regeneration "
                        "from the 32-byte key) instead of file-backed")
    args = p.parse_args()
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
