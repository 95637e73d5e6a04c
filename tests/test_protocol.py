"""End-to-end N-party protocol tests on localhost — the integration coverage the
reference lacks entirely (SURVEY.md section 4: "the multi-process protocol path is
entirely untested").

Spins up in-process asyncio participant servers holding real share DBs, runs
coordinator queries against them, and checks the reconstructed min-distance winner
against the plaintext scalar oracle.
"""

import asyncio

import numpy as np
import pytest

from mpc_iris_tpu.models import MasksEngine, ShareEngine
from mpc_iris_tpu.ops.encode import encode_template
from mpc_iris_tpu.protocol import Coordinator, ParticipantServer
from mpc_iris_tpu.protocol.coordinator import _rechunk
from mpc_iris_tpu.types import Template


def build_party_data(rng, db, n_parties):
    mats = [
        np.zeros((len(db), 12800), dtype=np.uint16) for _ in range(n_parties)
    ]
    for i, t in enumerate(db):
        for p, s in enumerate(encode_template(t).share(n_parties, rng)):
            mats[p][i] = s.data
    return mats


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(99)
    db = [Template.random(rng) for _ in range(23)]
    query = Template.random(rng)
    db[17] = query.rotated(5)  # plant the winner
    masks = np.stack([t.mask.data for t in db])
    return rng, db, query, masks


def run_protocol(world, n_parties, local_share=False, batch_records=7, chunk=8):
    rng, db, query, masks = world
    mats = build_party_data(rng, db, n_parties)

    async def go():
        local_engine = None
        remote_mats = mats
        if local_share:
            local_engine = ShareEngine(mats[0], chunk=chunk)
            remote_mats = mats[1:]
        servers = [
            ParticipantServer(ShareEngine(m, chunk=chunk), "127.0.0.1", 0)
            for m in remote_mats
        ]
        addrs = [await s.start() for s in servers]
        coord = Coordinator(
            MasksEngine(masks, chunk=chunk),
            addrs,
            local_engine=local_engine,
            batch_records=batch_records,
        )
        try:
            return await coord.query(query)
        finally:
            for s in servers:
                await s.close()

    return asyncio.run(go())


class TestProtocol:
    def test_two_party_matches_oracle(self, world):
        rng, db, query, masks = world
        outcome = run_protocol(world, 2)
        oracle = np.array([query.distance(t) for t in db])
        assert outcome.total == len(db)
        assert outcome.index == int(np.argmin(oracle))
        assert outcome.distance == oracle.min()

    def test_three_party(self, world):
        rng, db, query, masks = world
        outcome = run_protocol(world, 3, batch_records=23)
        oracle = np.array([query.distance(t) for t in db])
        assert (outcome.index, outcome.distance) == (
            int(np.argmin(oracle)),
            oracle.min(),
        )

    def test_coordinator_holds_share(self, world):
        """--share mode: coordinator is also a participant (unimplemented in the
        reference, src/main.rs:482)."""
        rng, db, query, masks = world
        outcome = run_protocol(world, 3, local_share=True)
        oracle = np.array([query.distance(t) for t in db])
        assert (outcome.index, outcome.distance) == (
            int(np.argmin(oracle)),
            oracle.min(),
        )

    def test_coordinator_holds_keyed_share(self, world):
        """--share keyed:... mode: the coordinator's own share is PRF-backed
        (SPEC section 4.2) and regenerated from the 32-byte key — no share
        data at all on the coordinator. Winner must match both the oracle and
        the file-served run above."""
        from mpc_iris_tpu import native
        from mpc_iris_tpu.models import KeyedShareEngine

        rng, db, query, masks = world
        enc = np.stack([encode_template(t).data for t in db])
        key = native.derive_insecure_key(31)
        shares = native.share_split(enc, 3, key)

        async def go():
            servers = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in shares[1:]
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(
                MasksEngine(masks, chunk=8), addrs,
                local_engine=KeyedShareEngine(key, 0, len(db), chunk=8),
                batch_records=7,
            )
            try:
                return await coord.query(query)
            finally:
                for s in servers:
                    await s.close()

        outcome = asyncio.run(go())
        oracle = np.array([query.distance(t) for t in db])
        assert (outcome.index, outcome.distance) == (
            int(np.argmin(oracle)), oracle.min(),
        )

    def test_single_party_is_plaintext(self, world):
        """One party holds the whole encoding: protocol == plaintext pipeline."""
        rng, db, query, masks = world
        outcome = run_protocol(world, 1)
        oracle = np.array([query.distance(t) for t in db])
        assert outcome.distance == oracle.min()

    def test_shorter_party_truncates(self, world):
        """A party with fewer entries truncates the comparison to the common
        prefix (reference src/main.rs:565-569)."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go():
            servers = [
                ParticipantServer(ShareEngine(mats[0], chunk=8), "127.0.0.1", 0),
                ParticipantServer(ShareEngine(mats[1][:11], chunk=8), "127.0.0.1", 0),
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs, batch_records=7)
            try:
                return await coord.query(query)
            finally:
                for s in servers:
                    await s.close()

        outcome = asyncio.run(go())
        assert outcome.total == 11
        oracle = np.array([query.distance(t) for t in db[:11]])
        assert outcome.index == int(np.argmin(oracle))
        assert outcome.distance == oracle.min()


class TestStrictScan:
    """strict_scan (SPEC section 5): a participant crashing MID-STREAM looks
    exactly like clean early EOF, so the default reference-compatible
    truncation would return a verdict over a prefix; strict mode aborts
    loudly with per-party record counts."""

    def test_aborts_on_midstream_crash(self, world):
        from mpc_iris_tpu.protocol import TruncatedScanError

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        half = len(db) // 2

        async def crashing_party(reader, writer):
            await reader.readexactly(3200)
            # stream half the records, then "crash" (close mid-scan)
            full = ShareEngine(mats[1], chunk=8).dots(
                query.pattern.data[None], query.mask.data[None]
            )[0]  # [N, 31] u16
            writer.write(full[:half].astype("<u2").tobytes())
            await writer.drain()
            writer.close()

        async def go():
            real = ParticipantServer(ShareEngine(mats[0], chunk=8),
                                     "127.0.0.1", 0)
            a0 = await real.start()
            fake = await asyncio.start_server(crashing_party, "127.0.0.1", 0)
            a1 = fake.sockets[0].getsockname()[:2]
            coord = Coordinator(MasksEngine(masks, chunk=8), [a0, a1],
                                batch_records=7, strict_scan=True)
            try:
                with pytest.raises(TruncatedScanError) as ei:
                    await coord.query(query)
                return str(ei.value)
            finally:
                await real.close()
                fake.close()
                await fake.wait_closed()

        msg = asyncio.run(go())
        assert f"{half}/{len(db)}" in msg
        assert f"sent {half}" in msg  # the short party is identifiable

    def test_full_scan_passes_strict(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = np.array([query.distance(t) for t in db])

        async def go():
            servers = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in mats
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7, strict_scan=True)
            try:
                return await coord.query(query)
            finally:
                for s in servers:
                    await s.close()

        async def go_batched():
            servers = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7, strict_scan=True)
            try:
                return await coord.query_batch([query, db[2]])
            finally:
                for s in servers:
                    await s.close()

        single = asyncio.run(go())
        assert single.total == len(db)
        assert (single.index, single.distance) == (
            int(np.argmin(oracle)), oracle.min()
        )
        batch = asyncio.run(go_batched())
        assert batch[0].total == len(db)
        assert (batch[0].index, batch[0].distance) == (
            int(np.argmin(oracle)), oracle.min()
        )
        assert batch[1].distance == 0.0 and batch[1].index == 2


class TestRechunk:
    def test_rechunk_sizes(self):
        chunks = [np.ones((1, n, 31), dtype=np.uint16) * i
                  for i, n in enumerate([5, 3, 9, 1])]
        out = list(_rechunk(iter(chunks), 7))
        sizes = [o.shape[0] for o in out]
        assert sizes == [7, 7, 4]
        total_in = np.concatenate([c[0] for c in chunks], axis=0)
        total_out = np.concatenate(out, axis=0)
        np.testing.assert_array_equal(total_in, total_out)


class TestBatchedWire:
    def test_batched_matches_oracle_and_single(self, world):
        """Batched wire: B queries in one round, each winner == scalar oracle."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        queries = [query, Template.random(np.random.default_rng(5)), db[3]]

        async def go():
            servers = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            try:
                return await coord.query_batch(queries)
            finally:
                for s in servers:
                    await s.close()

        outcomes = asyncio.run(go())
        assert len(outcomes) == 3
        for q, outcome in zip(queries, outcomes):
            oracle = np.array([q.distance(t) for t in db])
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_byte_budgeted_records_per_read(self):
        """Read rounds are sized in bytes, not entry-groups: large B shrinks
        the per-round group count so coordinator memory stays bounded."""
        from mpc_iris_tpu.constants import REPLY_RECORD_BYTES
        from mpc_iris_tpu.protocol.wire import (
            BATCH_RECORDS, READ_BYTE_BUDGET, records_per_read,
        )

        assert records_per_read(1) == BATCH_RECORDS  # reference batching kept
        for b in (256, 4096, 65536):
            r = records_per_read(b)
            assert 1 <= r <= BATCH_RECORDS
            assert r * b * REPLY_RECORD_BYTES <= READ_BYTE_BUDGET
        assert records_per_read(65536) >= 1  # never stalls at the B cap

    def test_batched_b256_multi_round(self, world, monkeypatch):
        """B=256 end-to-end with a budget that forces multiple byte-budgeted
        read rounds; every winner matches the scalar oracle."""
        import mpc_iris_tpu.protocol.wire as wire_mod

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        qrng = np.random.default_rng(11)
        queries = [query] + [Template.random(qrng) for _ in range(255)]
        queries[100] = db[4]  # plant a mid-batch exact hit
        # 7 entry-groups per round at B=256 -> 4 rounds over the 23-entry DB.
        monkeypatch.setattr(
            wire_mod, "READ_BYTE_BUDGET", 7 * 256 * 62, raising=True
        )

        async def go():
            servers = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs)
            try:
                return await coord.query_batch(queries)
            finally:
                for s in servers:
                    await s.close()

        outcomes = asyncio.run(go())
        assert len(outcomes) == 256
        for q, outcome in zip(queries, outcomes):
            oracle = np.array([q.distance(t) for t in db])
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_batched_with_local_share(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 3)
        queries = [query, db[2]]

        async def go():
            servers = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats[1:]
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(
                MasksEngine(masks, chunk=8), addrs,
                local_engine=ShareEngine(mats[0], chunk=8), batch_records=23,
            )
            try:
                return await coord.query_batch(queries)
            finally:
                for s in servers:
                    await s.close()

        outcomes = asyncio.run(go())
        for q, outcome in zip(queries, outcomes):
            oracle = np.array([q.distance(t) for t in db])
            assert (outcome.index, outcome.distance) == (
                int(np.argmin(oracle)), oracle.min(),
            )


class TestQueryServer:
    """The serving front (SPEC section 5.2): the reference resolver declares
    --bind but never serves on it; QueryServer accepts raw templates and
    replies with the 24-byte outcome record."""

    def test_serve_round_trip_matches_oracle(self, world):
        from mpc_iris_tpu.protocol import QueryServer, query_remote

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = Template.random(np.random.default_rng(21))

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0)
            host, port = await server.start()
            try:
                # Two sequential + two concurrent client queries.
                seq = [await query_remote(host, port, q) for q in (query, q2)]
                con = await asyncio.gather(
                    query_remote(host, port, query),
                    query_remote(host, port, q2),
                )
                return seq, con
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        seq, con = asyncio.run(go())
        for q, outcome in zip((query, q2), seq):
            oracle = np.array([q.distance(t) for t in db])
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()
        for s, c in zip(seq, con):
            assert (c.index, c.distance, c.total) == (s.index, s.distance, s.total)

    def test_persistent_wire_reuses_one_connection(self, world):
        """SPEC 5.5: a PersistentQueryClient sends many queries over ONE
        connection; outcomes are bit-identical to one-shot queries and the
        server counts every query."""
        from mpc_iris_tpu.protocol import (
            PersistentQueryClient,
            QueryServer,
            query_remote,
        )

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = Template.random(np.random.default_rng(21))
        q3 = db[7]

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0)
            host, port = await server.start()
            try:
                client = await PersistentQueryClient.connect(host, port)
                persist = [await client.query(q) for q in (query, q2, q3)]
                await client.close()
                solo = [await query_remote(host, port, q)
                        for q in (query, q2, q3)]
                return persist, solo, server.stats()
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        persist, solo, stats = asyncio.run(go())
        for p, s in zip(persist, solo):
            assert (p.index, p.distance, p.total) == \
                (s.index, s.distance, s.total)
        oracle = np.array([query.distance(t) for t in db])
        assert persist[0].index == int(np.argmin(oracle))
        assert persist[0].distance == oracle.min()
        assert persist[2].distance == 0.0  # q3 is a DB self-match
        assert stats["served"] == 6

    def test_persistent_wire_composes_with_micro_batching(self, world):
        """Two persistent sessions' concurrent queries aggregate into shared
        batched rounds; outcomes bit-exact vs the oracle."""
        from mpc_iris_tpu.protocol import PersistentQueryClient, QueryServer

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = Template.random(np.random.default_rng(88))

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0, max_batch=2,
                                 batch_window=0.25)
            host, port = await server.start()
            try:
                c1 = await PersistentQueryClient.connect(host, port)
                c2 = await PersistentQueryClient.connect(host, port)
                round1 = await asyncio.gather(c1.query(query), c2.query(q2))
                round2 = await asyncio.gather(c1.query(q2), c2.query(query))
                await c1.close()
                await c2.close()
                return round1, round2
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        (o1, o2), (o2b, o1b) = asyncio.run(go())
        for q, outs in ((query, (o1, o1b)), (q2, (o2, o2b))):
            oracle = np.array([q.distance(t) for t in db])
            for out in outs:
                assert out.total == len(db)
                assert out.index == int(np.argmin(oracle))
                assert out.distance == oracle.min()

    def test_idle_persistent_session_does_not_block_drain(self, world):
        """A persistent client parked between records has nothing in flight:
        drain must end its session immediately (clean EOF at the record
        boundary) instead of burning the whole grace and reporting failure."""
        import time as _time

        from mpc_iris_tpu.protocol import PersistentQueryClient, QueryServer

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0)
            host, port = await server.start()
            client = await PersistentQueryClient.connect(host, port)
            out = await client.query(query)  # one served record, then idle
            await asyncio.sleep(0.05)  # let the handler park on the next read
            t0 = _time.monotonic()
            ok = await server.drain(grace=10.0)
            dt = _time.monotonic() - t0
            # the parked session sees EOF -> clean end; further queries fail
            with pytest.raises((asyncio.IncompleteReadError,
                                ConnectionError)):
                await client.query(query)
            await client.close()
            await server.close()
            for p in parts:
                await p.close()
            return out, ok, dt

        out, ok, dt = asyncio.run(go())
        oracle = np.array([query.distance(t) for t in db])
        assert out.index == int(np.argmin(oracle))
        assert ok is True
        assert dt < 5.0, f"drain burned {dt:.1f}s on an idle session"

    def test_close_with_idle_persistent_session_does_not_hang(self, world):
        """server.close() (without a prior drain) must not deadlock in
        wait_closed() on a persistent session parked between records —
        Python >=3.12.1 waits for every handler, and an idle keep-alive
        handler never exits on its own (read_timeout defaults to None)."""
        from mpc_iris_tpu.protocol import PersistentQueryClient, QueryServer

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)

        async def go():
            part = ParticipantServer(ShareEngine(mats[0], chunk=8),
                                     "127.0.0.1", 0)
            addr = await part.start()
            coord = Coordinator(MasksEngine(masks, chunk=8), [addr],
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0)
            host, port = await server.start()
            client = await PersistentQueryClient.connect(host, port)
            await client.query(query)
            await asyncio.sleep(0.05)  # handler parks on the next record
            await asyncio.wait_for(server.close(), timeout=10)
            await client.close()
            await part.close()

        asyncio.run(go())  # wait_for raising TimeoutError = the hang

    def test_persistent_audit_torn_mid_record_is_not_clean_eof(self, world,
                                                               caplog):
        """EOF between an audit template and its 8-byte threshold is a TORN
        record: the session must be logged as a dropped client, never
        treated as a clean end-of-session."""
        import logging

        from mpc_iris_tpu.protocol.coordinator import PERSIST_MAGIC
        from mpc_iris_tpu.protocol import QueryServer

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0, audit=True)
            host, port = await server.start()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(PERSIST_MAGIC + query.to_bytes())  # no threshold
                await writer.drain()
                writer.close()
                await writer.wait_closed()
                await asyncio.sleep(0.2)  # let the handler observe the EOF
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        with caplog.at_level(logging.WARNING, logger="mpc_iris_tpu.coordinator"):
            asyncio.run(go())
        assert any("dropped" in r.getMessage() for r in caplog.records), \
            [r.getMessage() for r in caplog.records]

    def test_serve_read_timeout_single_deadline(self, world):
        """A slow-loris client that sends 8 bytes just under the deadline
        must NOT get a fresh budget for the rest of the record: the whole
        first request shares one read_timeout."""
        import time as _time

        from mpc_iris_tpu.protocol import QueryServer

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)

        async def go():
            part = ParticipantServer(ShareEngine(mats[0], chunk=8),
                                     "127.0.0.1", 0)
            addr = await part.start()
            coord = Coordinator(MasksEngine(masks, chunk=8), [addr],
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0, read_timeout=0.6)
            host, port = await server.start()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                t0 = _time.monotonic()
                await asyncio.sleep(0.4)
                writer.write(query.to_bytes()[:8])  # head only, then stall
                await writer.drain()
                eof = await reader.read()  # server closes at the deadline
                dt = _time.monotonic() - t0
                writer.close()
                await writer.wait_closed()
                return eof, dt
            finally:
                await server.close()
                await part.close()

        eof, dt = asyncio.run(go())
        assert eof == b""  # closed with no reply record
        assert dt < 1.1, f"two stacked deadlines: closed after {dt:.2f}s"

    def test_serve_micro_batching_aggregates_concurrent_clients(self, world):
        """max_batch > 1: concurrent clients share ONE batched MPC round;
        outcomes are bit-identical to solo queries, and the participants see
        fewer connections than clients."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        qrng = np.random.default_rng(33)
        queries = [query, db[9], Template.random(qrng), Template.random(qrng)]
        conn_count = [0]

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            # Count inbound participant connections (MPC rounds x parties) —
            # patch BEFORE start() binds the handler into the server.
            orig = parts[0]._handle

            async def counting_handle(reader, writer):
                conn_count[0] += 1
                await orig(reader, writer)

            parts[0]._handle = counting_handle
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0,
                                 max_batch=4, batch_window=0.25)
            host, port = await server.start()
            try:
                outcomes = await asyncio.gather(
                    *[query_remote(host, port, q) for q in queries]
                )
                single = await query_remote(host, port, queries[0])
                return outcomes, single
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        outcomes, single = asyncio.run(go())
        for q, outcome in zip(queries, outcomes):
            oracle = np.array([q.distance(t) for t in db])
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()
        # 4 concurrent clients + 1 solo follow-up -> at most 3 MPC rounds
        # (typically 2) on party 0, not 5.
        assert conn_count[0] <= 3
        assert (single.index, single.distance) == (
            outcomes[0].index, outcomes[0].distance
        )

    def test_serve_pipelined_rounds_overlap_and_stay_exact(self, world):
        """rounds_inflight=2: two micro-batched MPC rounds run CONCURRENTLY
        (observed via a query_batch wrapper that holds each round open) and
        every client outcome still matches the scalar oracle."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        qrng = np.random.default_rng(44)
        queries = [query, db[3], db[9]] + [
            Template.random(qrng) for _ in range(5)
        ]
        inflight, peak = [0], [0]

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            orig = coord.query_batch

            async def tracking(templates):
                inflight[0] += 1
                peak[0] = max(peak[0], inflight[0])
                try:
                    # Hold the round open so the dispatcher provably starts
                    # the next one while this one is still in flight.
                    await asyncio.sleep(0.05)
                    return await orig(templates)
                finally:
                    inflight[0] -= 1

            coord.query_batch = tracking
            server = QueryServer(coord, "127.0.0.1", 0, max_batch=2,
                                 batch_window=0.01, rounds_inflight=2)
            host, port = await server.start()
            try:
                return await asyncio.gather(
                    *[query_remote(host, port, q) for q in queries]
                )
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        outcomes = asyncio.run(go())
        assert peak[0] >= 2, "no two rounds ever overlapped"
        for q, outcome in zip(queries, outcomes):
            oracle = np.array([q.distance(t) for t in db])
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_serve_micro_batching_failure_propagates(self, world):
        """A failed batched round closes every waiting client with no reply
        bytes."""
        from mpc_iris_tpu.protocol import QueryServer

        rng, db, query, masks = world

        async def go():
            coord = Coordinator(MasksEngine(masks, chunk=8),
                                [("127.0.0.1", 1)])  # unreachable party
            server = QueryServer(coord, "127.0.0.1", 0,
                                 max_batch=2, batch_window=0.2)
            host, port = await server.start()

            async def client(q):
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(q.to_bytes())
                await writer.drain()
                data = await asyncio.wait_for(reader.read(), timeout=10)
                writer.close()
                await writer.wait_closed()
                return data

            try:
                return await asyncio.gather(client(query), client(db[2]))
            finally:
                await server.close()

        assert asyncio.run(go()) == [b"", b""]

    def test_serve_failure_closes_without_reply(self, world):
        """A failed MPC round (unreachable participant) must close the client
        connection with NO reply bytes — never a fabricated outcome."""
        from mpc_iris_tpu.protocol import QueryServer

        rng, db, query, masks = world

        async def go():
            coord = Coordinator(MasksEngine(masks, chunk=8),
                                [("127.0.0.1", 1)])  # unreachable party
            server = QueryServer(coord, "127.0.0.1", 0)
            host, port = await server.start()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(query.to_bytes())
                await writer.drain()
                data = await asyncio.wait_for(reader.read(), timeout=10)
                writer.close()
                await writer.wait_closed()
                return data
            finally:
                await server.close()

        assert asyncio.run(go()) == b""

    def test_serve_recovers_after_participant_restart(self, world):
        """Availability: the coordinator opens fresh participant connections
        per query, so a crashed-and-restarted participant needs NO server
        restart — queries fail loudly (closed, no reply bytes) while the party
        is down and produce bit-identical outcomes once it is back."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = np.array([query.distance(t) for t in db])

        async def raw_query(host, port, q):
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(q.to_bytes())
            await writer.drain()
            data = await asyncio.wait_for(reader.read(), timeout=10)
            writer.close()
            await writer.wait_closed()
            return data

        async def go():
            p0 = ParticipantServer(ShareEngine(mats[0], chunk=8),
                                   "127.0.0.1", 0)
            p1 = ParticipantServer(ShareEngine(mats[1], chunk=8),
                                   "127.0.0.1", 0)
            a0, a1 = await p0.start(), await p1.start()
            coord = Coordinator(MasksEngine(masks, chunk=8), [a0, a1],
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0)
            host, port = await server.start()
            p1b = None
            try:
                before = await query_remote(host, port, query)
                # participant 1 crashes
                await p1.close()
                failed = await raw_query(host, port, query)
                # ... and comes back on the SAME address
                p1b = ParticipantServer(ShareEngine(mats[1], chunk=8),
                                        a1[0], a1[1])
                await p1b.start()
                after = await query_remote(host, port, query)
                return before, failed, after
            finally:
                await server.close()
                await p0.close()
                if p1b is not None:
                    await p1b.close()

        before, failed, after = asyncio.run(go())
        assert failed == b""  # down window: closed with no reply record
        for outcome in (before, after):
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_serve_max_inflight_bounds_solo_rounds(self, world):
        """max_inflight: solo-mode MPC rounds never exceed the gate; excess
        clients queue and are still answered correctly."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = np.array([query.distance(t) for t in db])
        peak = [0]

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0, max_inflight=2)
            inflight = [0]
            orig = coord.query

            async def counting_query(template):
                inflight[0] += 1
                peak[0] = max(peak[0], inflight[0])
                try:
                    return await orig(template)
                finally:
                    inflight[0] -= 1

            coord.query = counting_query
            host, port = await server.start()
            try:
                return await asyncio.gather(
                    *[query_remote(host, port, query) for _ in range(5)]
                )
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        outcomes = asyncio.run(go())
        assert peak[0] <= 2
        for outcome in outcomes:
            assert outcome.total == len(db)
            assert (outcome.index, outcome.distance) == (
                int(np.argmin(oracle)), oracle.min()
            )

    def test_serve_stats_counters(self, world):
        """Serving observability: served/failed counters and latency
        quantiles over the recent window (the reference's indicatif
        throughput lines, for the serving front)."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            # second, dead address -> every query fails after the good round
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            bad_coord = Coordinator(MasksEngine(masks, chunk=8),
                                    [("127.0.0.1", 1)])
            server = QueryServer(coord, "127.0.0.1", 0)
            host, port = await server.start()
            try:
                for _ in range(3):
                    await query_remote(host, port, query)
                good_stats = server.stats()
                server.coordinator = bad_coord
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(query.to_bytes())
                await writer.drain()
                await asyncio.wait_for(reader.read(), timeout=10)
                writer.close()
                await writer.wait_closed()
                return good_stats, server.stats()
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        good, after = asyncio.run(go())
        assert good["served"] == 3 and good["failed"] == 0
        assert good["window"] == 3 and good["p50_s"] > 0
        assert good["p95_s"] >= good["p50_s"]
        assert after["served"] == 3 and after["failed"] == 1

    def test_serve_read_timeout_cuts_silent_client(self, world):
        from mpc_iris_tpu.protocol import QueryServer

        rng, db, query, masks = world

        async def go():
            coord = Coordinator(MasksEngine(masks, chunk=8),
                                [("127.0.0.1", 1)])
            server = QueryServer(coord, "127.0.0.1", 0, read_timeout=0.5)
            host, port = await server.start()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                data = await asyncio.wait_for(reader.read(), timeout=10)
                writer.close()
                await writer.wait_closed()
                return data
            finally:
                await server.close()

        assert asyncio.run(go()) == b""


class TestConcurrentConnections:
    """One participant, several simultaneous coordinators timesharing the
    device: replies must stay bit-exact vs serial, the
    refresh hook must run serialized per request, and no pump worker thread
    may leak."""

    def _thread_floor(self):
        import threading

        return threading.active_count()

    def test_two_coordinators_reference_wire_bit_exact(self, world):
        import threading
        import time as _time

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)
        q2 = Template.random(np.random.default_rng(7))
        refresh_calls = []

        def refresh():
            # Widen the race window: concurrent requests must serialize here
            # (server-wide lock) without deadlock or double-entry.
            refresh_calls.append(threading.get_ident())
            _time.sleep(0.05)

        async def go():
            server = ParticipantServer(
                ShareEngine(mats[0], chunk=8), "127.0.0.1", 0,
                refresh=refresh,
            )
            addr = await server.start()

            def coord():
                return Coordinator(MasksEngine(masks, chunk=8), [addr],
                                   batch_records=7)

            try:
                serial = [await coord().query(q) for q in (query, q2)]
                concurrent = await asyncio.gather(
                    coord().query(query), coord().query(q2)
                )
                return serial, concurrent
            finally:
                await server.close()

        before = threading.active_count()
        serial, concurrent = asyncio.run(go())
        for s, c in zip(serial, concurrent):
            assert (c.index, c.distance, c.total) == (s.index, s.distance, s.total)
        assert len(refresh_calls) == 4  # once per request, all serialized
        deadline = _time.monotonic() + 5
        while threading.active_count() > before and _time.monotonic() < deadline:
            _time.sleep(0.1)
        assert threading.active_count() <= before  # no stranded pump workers

    def test_two_coordinators_batched_wire_bit_exact(self, world):
        import threading
        import time as _time

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        qrng = np.random.default_rng(13)
        batch_a = [query, Template.random(qrng)]
        batch_b = [db[6], Template.random(qrng)]

        async def go():
            servers = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await s.start() for s in servers]

            def coord():
                return Coordinator(MasksEngine(masks, chunk=8), addrs,
                                   batch_records=7)

            try:
                serial = [await coord().query_batch(b)
                          for b in (batch_a, batch_b)]
                concurrent = await asyncio.gather(
                    coord().query_batch(batch_a), coord().query_batch(batch_b)
                )
                return serial, concurrent
            finally:
                for s in servers:
                    await s.close()

        before = threading.active_count()
        serial, concurrent = asyncio.run(go())
        for srow, crow in zip(serial, concurrent):
            for s, c in zip(srow, crow):
                assert (c.index, c.distance, c.total) == (
                    s.index, s.distance, s.total
                )
        deadline = _time.monotonic() + 5
        while threading.active_count() > before and _time.monotonic() < deadline:
            _time.sleep(0.1)
        assert threading.active_count() <= before


class TestRobustness:
    def test_masks_only_coordinator_rejected(self, world):
        rng, db, query, masks = world
        with pytest.raises(ValueError):
            Coordinator(MasksEngine(masks, chunk=8), participants=[])

    def test_oversized_batch_rejected(self, world):
        rng, db, query, masks = world
        coord = Coordinator.__new__(Coordinator)  # skip __init__ checks
        coord.participants = []
        coord.masks_engine = None
        coord.local_engine = None
        coord.batch_records = 7
        with pytest.raises(ValueError):
            asyncio.run(coord.query_batch([query] * 0))

    def test_client_disconnect_releases_worker(self, world):
        """Dropping the connection mid-stream must not strand the producer
        thread (pre-fix it blocked forever on the full queue)."""
        import threading
        import time as _time

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)

        async def go():
            server = ParticipantServer(ShareEngine(mats[0], chunk=4), "127.0.0.1", 0)
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            await reader.read(62)  # first bytes arrive, then hang up
            writer.close()
            await writer.wait_closed()
            await asyncio.sleep(1.0)  # let the pump notice and exit
            await server.close()

        before = threading.active_count()
        asyncio.run(go())
        deadline = _time.monotonic() + 5
        while threading.active_count() > before and _time.monotonic() < deadline:
            _time.sleep(0.1)
        assert threading.active_count() <= before

    def test_unreachable_participant_clear_error(self, world):
        rng, db, query, masks = world
        coord = Coordinator(MasksEngine(masks, chunk=8), [("127.0.0.1", 1)])
        with pytest.raises(ConnectionError, match="cannot reach"):
            asyncio.run(coord.query(query))

    def test_stalled_party_aborts_within_deadline(self, world):
        """A connected participant that replies partially then goes silent
        must abort the query within the round deadline, naming the party —
        never hang (the reference waits forever, src/main.rs:538-555) and
        never silently truncate (SPEC section 5)."""
        import time as _time

        from mpc_iris_tpu.protocol import StalledPartyError

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def stalling_handler(reader, writer):
            await reader.readexactly(3200)
            # Ship a few whole records, then stall with the socket open.
            # Stall by READING (the coordinator sends nothing more): the
            # handler unblocks on EOF when the aborting coordinator closes,
            # so Server.wait_closed() (which awaits handlers on 3.12+)
            # terminates promptly.
            writer.write(b"\x00" * (3 * 62))
            await writer.drain()
            await reader.read(1)
            writer.close()

        async def go():
            healthy = ParticipantServer(
                ShareEngine(mats[0], chunk=8), "127.0.0.1", 0
            )
            addr0 = await healthy.start()
            stall_srv = await asyncio.start_server(
                stalling_handler, "127.0.0.1", 0
            )
            addr1 = stall_srv.sockets[0].getsockname()[:2]
            coord = Coordinator(
                MasksEngine(masks, chunk=8), [addr0, addr1],
                batch_records=7, round_timeout=1.0,
            )
            try:
                t0 = _time.monotonic()
                with pytest.raises(StalledPartyError, match=f"{addr1[1]}"):
                    await coord.query(query)
                return _time.monotonic() - t0
            finally:
                await healthy.close()
                stall_srv.close()
                await stall_srv.wait_closed()

        elapsed = asyncio.run(go())
        assert elapsed < 10  # bounded by the deadline, not the 1h stall

    def test_stalled_party_aborts_batched_wire(self, world):
        """Same stalled-party policy on the batched wire."""
        from mpc_iris_tpu.protocol import StalledPartyError
        from mpc_iris_tpu.protocol.wire import BATCHED_MAGIC

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def stalling_handler(reader, writer):
            await reader.readexactly(len(BATCHED_MAGIC) + 4 + 2 * 3200)
            await reader.read(1)  # stall until the coordinator hangs up
            writer.close()

        async def go():
            healthy = ParticipantServer(
                ShareEngine(mats[0], chunk=8), "127.0.0.1", 0, wire="batched"
            )
            addr0 = await healthy.start()
            stall_srv = await asyncio.start_server(
                stalling_handler, "127.0.0.1", 0
            )
            addr1 = stall_srv.sockets[0].getsockname()[:2]
            coord = Coordinator(
                MasksEngine(masks, chunk=8), [addr0, addr1],
                batch_records=7, round_timeout=1.0,
            )
            try:
                with pytest.raises(StalledPartyError, match="no complete"):
                    await coord.query_batch([query, db[2]])
            finally:
                await healthy.close()
                stall_srv.close()
                await stall_srv.wait_closed()

        asyncio.run(go())

    def test_no_timeout_still_waits(self, world):
        """Default round_timeout=None keeps reference semantics: a slow-but-
        alive party is waited for and the query completes correctly."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)

        async def go():
            server = ParticipantServer(
                ShareEngine(mats[0], chunk=8), "127.0.0.1", 0
            )
            addr = await server.start()
            coord = Coordinator(MasksEngine(masks, chunk=8), [addr],
                                batch_records=7)
            assert coord.round_timeout is None
            try:
                return await coord.query(query)
            finally:
                await server.close()

        outcome = asyncio.run(go())
        oracle = np.array([query.distance(t) for t in db])
        assert outcome.distance == oracle.min()

    def test_participant_read_timeout_closes_silent_client(self, world):
        """A connected client that never sends a query is cut off after the
        participant's --timeout; a subsequent real query still works."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)

        async def go():
            server = ParticipantServer(
                ShareEngine(mats[0], chunk=8), "127.0.0.1", 0,
                read_timeout=0.5,
            )
            host, port = await server.start()
            # Silent client: connect, send nothing.
            reader, writer = await asyncio.open_connection(host, port)
            data = await asyncio.wait_for(reader.read(), timeout=10)
            assert data == b""  # server closed us without records
            writer.close()
            await writer.wait_closed()
            # The server is still healthy for real queries.
            coord = Coordinator(MasksEngine(masks, chunk=8), [(host, port)],
                                batch_records=7)
            try:
                return await coord.query(query)
            finally:
                await server.close()

        outcome = asyncio.run(go())
        oracle = np.array([query.distance(t) for t in db])
        assert outcome.distance == oracle.min()

    def test_wire_mode_mismatch_fails_fast(self, world):
        """A reference-wire client hitting a batched server gets a clean
        rejection (magic mismatch) instead of garbage records."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)

        async def go():
            server = ParticipantServer(ShareEngine(mats[0], chunk=8),
                                       "127.0.0.1", 0, wire="batched")
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())  # reference-wire bytes
            await writer.drain()
            data = await reader.read(62)  # server must close without records
            writer.close()
            await writer.wait_closed()
            await server.close()
            return data

        assert asyncio.run(go()) == b""

    def test_participant_stats_counters(self, world):
        """Serving stats: served/entries_sent counters + latency window."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go():
            server = ParticipantServer(ShareEngine(mats[0], chunk=8),
                                       "127.0.0.1", 0)
            host, port = await server.start()

            async def one():
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(query.to_bytes())
                await writer.drain()
                data = await reader.read()
                writer.close()
                await writer.wait_closed()
                return data

            await one()
            await one()
            stats = server.stats()
            await server.close()
            return stats

        stats = asyncio.run(go())
        assert stats["served"] == 2
        assert stats["failed"] == 0
        assert stats["entries_sent"] == 2 * len(db)
        assert stats["window"] == 2 and stats["p50_s"] > 0


class TestDrain:
    """Graceful shutdown (SPEC section 5): drain() stops accepting, finishes
    in-flight replies under a grace deadline — the clean-shutdown behavior
    the reference leaves as TODOs (src/main.rs:449, 631, 641)."""

    @staticmethod
    def _gated_engine(inner, gate):
        """Engine wrapper whose stream yields its first chunk, then blocks on
        `gate` (a threading.Event) before continuing — pins the connection
        handler mid-reply deterministically."""

        class Gated:
            count = inner.count

            def stream(self, qp, qm, entry_major=False):
                first = True
                for item in inner.stream(qp, qm, entry_major=entry_major):
                    yield item
                    if first:
                        assert gate.wait(timeout=30)
                        first = False

        return Gated()

    def test_participant_drain_finishes_inflight_reply(self, world):
        import threading

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        gate = threading.Event()

        async def go():
            eng = self._gated_engine(ShareEngine(mats[0], chunk=8), gate)
            server = ParticipantServer(eng, "127.0.0.1", 0)
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            first = await reader.readexactly(8 * 62)  # chunk 0 streamed

            drain = asyncio.ensure_future(server.drain(grace=20))
            await asyncio.sleep(0.1)
            assert not drain.done(), "drain must wait for the in-flight reply"
            # The listener is already closed: new connections are refused.
            with pytest.raises(ConnectionError):
                await asyncio.open_connection(host, port)

            gate.set()
            rest = await reader.read()  # remaining 15 records to EOF
            assert await drain is True
            writer.close()
            await writer.wait_closed()
            await server.close()
            return first + rest

        payload = asyncio.run(go())
        assert len(payload) == len(db) * 62  # the FULL reply survived drain

    def test_participant_drain_grace_expires(self, world):
        import threading

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        gate = threading.Event()

        async def go():
            eng = self._gated_engine(ShareEngine(mats[0], chunk=8), gate)
            server = ParticipantServer(eng, "127.0.0.1", 0)
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            await reader.readexactly(8 * 62)
            ok = await server.drain(grace=0.2)  # handler still gated
            gate.set()
            writer.close()
            await writer.wait_closed()
            await server.close()
            return ok

        assert asyncio.run(go()) is False

    @pytest.mark.parametrize("expires", [False, True])
    def test_participant_drain_pre_3_12_fallback(self, world, monkeypatch,
                                                 expires):
        """On Python < 3.12.1 Server.wait_closed() returns at listener close
        (gh-79033), so drain must poll the ConnectionTracker instead of
        instantly reporting 'drained clean' with a reply still streaming.
        Forced here by monkeypatching the version gate."""
        import threading

        from mpc_iris_tpu.protocol import drain as drain_mod

        monkeypatch.setattr(
            drain_mod, "_WAIT_CLOSED_TRACKS_CONNECTIONS", False)
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        gate = threading.Event()

        async def go():
            eng = self._gated_engine(ShareEngine(mats[0], chunk=8), gate)
            server = ParticipantServer(eng, "127.0.0.1", 0)
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            first = await reader.readexactly(8 * 62)
            if expires:
                ok = await server.drain(grace=0.2)  # handler stays gated
                gate.set()
                rest = await reader.read()
            else:
                drain = asyncio.ensure_future(server.drain(grace=20))
                await asyncio.sleep(0.1)
                assert not drain.done(), \
                    "fallback drain must wait on the tracker"
                gate.set()
                rest = await reader.read()
                ok = await drain
            writer.close()
            await writer.wait_closed()
            await server.close()
            return ok, first + rest

        ok, payload = asyncio.run(go())
        assert ok is (not expires)
        assert len(payload) == len(db) * 62  # full reply survived either way

    def test_queryserver_drain_answers_queued_clients(self, world):
        from mpc_iris_tpu.protocol import QueryServer, query_remote

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = Template.random(np.random.default_rng(55))

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0, max_batch=2,
                                 batch_window=0.2)
            host, port = await server.start()
            clients = [
                asyncio.ensure_future(query_remote(host, port, q))
                for q in (query, q2)
            ]
            await asyncio.sleep(0.05)  # let both enqueue into the window
            drained = await server.drain(grace=30)
            outcomes = await asyncio.gather(*clients)
            with pytest.raises(ConnectionError):
                await query_remote(host, port, query)
            await server.close()
            for p in parts:
                await p.close()
            return drained, outcomes

        drained, outcomes = asyncio.run(go())
        assert drained is True
        for q, outcome in zip((query, q2), outcomes):
            oracle = np.array([q.distance(t) for t in db])
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_close_cancels_parked_dispatcher_batch(self, world):
        """close() while the dispatcher is parked on the rounds gate with a
        collected batch must unwind that batch's waiting clients (cancelled
        futures -> closed connections), never strand them (review finding:
        abandoned batch on dispatcher cancellation)."""
        from mpc_iris_tpu.protocol import QueryServer

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        release = asyncio.Event()

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            orig = coord.query_batch

            async def slow(templates):
                await release.wait()  # round 1 blocks the single gate slot
                return await orig(templates)

            coord.query_batch = slow
            server = QueryServer(coord, "127.0.0.1", 0, max_batch=1,
                                 batch_window=0.01, rounds_inflight=1)
            host, port = await server.start()

            async def raw_client(q):
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(q.to_bytes())
                await writer.drain()
                data = await asyncio.wait_for(reader.read(), timeout=15)
                writer.close()
                await writer.wait_closed()
                return data

            c1 = asyncio.ensure_future(raw_client(query))
            c2 = asyncio.ensure_future(raw_client(db[2]))
            await asyncio.sleep(0.3)  # round 1 in flight, batch 2 parked
            # close() with the dispatcher parked on gate.acquire(): both
            # clients must unwind promptly (closed, no reply bytes).
            await asyncio.wait_for(server.close(), timeout=10)
            release.set()
            replies = await asyncio.gather(*[c1, c2])
            for p in parts:
                await p.close()
            return replies

        assert asyncio.run(go()) == [b"", b""]

    def test_abort_connections_after_failed_drain(self, world):
        """The force path: a connection that outlives the grace is hard-
        closed by abort_connections() so close() cannot hang on it (review
        finding: wait_closed blocks forever on surviving connections)."""
        import threading

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        gate = threading.Event()

        async def go():
            eng = self._gated_engine(ShareEngine(mats[0], chunk=8), gate)
            server = ParticipantServer(eng, "127.0.0.1", 0)
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            await reader.readexactly(8 * 62)
            assert await server.drain(grace=0.2) is False
            assert server.abort_connections() == 1
            gate.set()  # un-wedge the engine thread so the pump can exit
            await asyncio.wait_for(server.close(), timeout=10)
            # the client sees the abort as EOF/reset, not a clean reply
            try:
                rest = await asyncio.wait_for(reader.read(), timeout=5)
            except ConnectionResetError:
                rest = b""
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionResetError:
                pass
            return rest

        rest = asyncio.run(go())
        assert len(rest) < (len(db) - 8) * 62  # reply was cut short


class TestChain:
    """Chained reply aggregation (SPEC section 5.4): parties forward partial
    share sums along a chain; the coordinator contacts only the chain head
    and receives ONE summed stream, reconstructing with its own local share
    (which must stay out of the chain so no party ever holds the full sum)."""

    def _world_mats(self, world, n_parties):
        rng, db, query, masks = world
        return build_party_data(rng, db, n_parties)

    async def _run_chain(self, world, mats, templates, *, trim_root=None,
                         batch_records=7):
        """3 chain parties (shares 0..2) + coordinator-held share 3."""
        rng, db, query, masks = world
        root_rows = mats[0] if trim_root is None else mats[0][:trim_root]
        parts = [
            ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                              wire="chain")
            for m in (root_rows, mats[1], mats[2])
        ]
        addrs = [await p.start() for p in parts]
        coord = Coordinator(
            MasksEngine(masks, chunk=8), addrs,
            local_engine=ShareEngine(mats[3], chunk=8),
            batch_records=batch_records, chain=True,
        )
        try:
            return await coord.query_batch(templates)
        finally:
            for p in parts:
                await p.close()

    def test_chain_matches_standard_and_oracle(self, world):
        rng, db, query, masks = world
        mats = self._world_mats(world, 4)
        q2 = Template.random(np.random.default_rng(77))
        outcomes = asyncio.run(self._run_chain(world, mats, [query, q2]))
        for q, outcome in zip((query, q2), outcomes):
            oracle = np.array([q.distance(t) for t in db])
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_chain_solo_query_routes_through_batch(self, world):
        """Coordinator.query in chain mode == query_batch([t])[0]."""
        rng, db, query, masks = world
        mats = self._world_mats(world, 4)

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="chain")
                for m in mats[:3]
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(
                MasksEngine(masks, chunk=8), addrs,
                local_engine=ShareEngine(mats[3], chunk=8),
                batch_records=7, chain=True,
            )
            try:
                return await coord.query(query)
            finally:
                for p in parts:
                    await p.close()

        outcome = asyncio.run(go())
        oracle = np.array([query.distance(t) for t in db])
        assert (outcome.index, outcome.distance, outcome.total) == (
            int(np.argmin(oracle)), oracle.min(), len(db),
        )

    def test_chain_requires_local_share(self, world):
        rng, db, query, masks = world
        with pytest.raises(ValueError, match="chain mode requires"):
            Coordinator(MasksEngine(masks, chunk=8), [("127.0.0.1", 1)],
                        chain=True)

    def test_chain_shorter_root_truncates_whole_chain(self, world):
        """The chain's shortest party truncates everything downstream —
        the chained analogue of the coordinator's shortest-prefix rule."""
        rng, db, query, masks = world
        mats = self._world_mats(world, 4)
        outcomes = asyncio.run(
            self._run_chain(world, mats, [query], trim_root=11)
        )
        assert outcomes[0].total == 11
        oracle = np.array([query.distance(t) for t in db[:11]])
        assert outcomes[0].index == int(np.argmin(oracle))
        assert outcomes[0].distance == oracle.min()

    def test_chain_unreachable_upstream_fails_loud(self, world):
        """A chain party that cannot reach its upstream ABORTS its reply;
        the coordinator must fail loudly, never return a truncated verdict
        that looks clean."""
        rng, db, query, masks = world
        mats = self._world_mats(world, 3)

        async def go():
            head = ParticipantServer(ShareEngine(mats[1], chunk=8),
                                     "127.0.0.1", 0, wire="chain")
            addr = await head.start()
            coord = Coordinator(
                MasksEngine(masks, chunk=8),
                [("127.0.0.1", 9), addr],  # upstream port 9: unreachable
                local_engine=ShareEngine(mats[2], chunk=8),
                batch_records=7, chain=True,
            )
            try:
                with pytest.raises(ConnectionError):
                    await coord.query_batch([query])
            finally:
                await head.close()

        asyncio.run(go())

    def test_chain_composes_with_serving_front(self, world):
        """QueryServer micro-batching over a chain coordinator: concurrent
        clients share one batched MPC round whose replies aggregate through
        the chain — outcomes bit-exact vs the oracle."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote

        rng, db, query, masks = world
        mats = self._world_mats(world, 4)
        q2 = Template.random(np.random.default_rng(88))

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="chain")
                for m in mats[:3]
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(
                MasksEngine(masks, chunk=8), addrs,
                local_engine=ShareEngine(mats[3], chunk=8),
                batch_records=7, chain=True,
            )
            server = QueryServer(coord, "127.0.0.1", 0, max_batch=2,
                                 batch_window=0.2, rounds_inflight=2)
            host, port = await server.start()
            try:
                return await asyncio.gather(
                    query_remote(host, port, query),
                    query_remote(host, port, q2),
                )
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        outcomes = asyncio.run(go())
        for q, outcome in zip((query, q2), outcomes):
            oracle = np.array([q.distance(t) for t in db])
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()


def test_pump_put_blocking_survives_loop_death():
    """A pump worker blocked on a full queue when the event loop CLOSES must
    exit promptly (not spin until process exit) and must retire the pending
    queue.put coroutine instead of leaking it to GC as an un-awaited
    coroutine (the r04 suite-shutdown RuntimeWarning)."""
    import threading
    import warnings

    from mpc_iris_tpu.protocol.pump import put_blocking

    loop = asyncio.new_event_loop()
    ready = threading.Event()
    stop = threading.Event()  # never set: only loop death may release it
    result = {}

    async def fill_then_park():
        q = asyncio.Queue(maxsize=1)
        await q.put("full")
        result["q"] = q
        ready.set()
        # Park without draining: the worker's put stays blocked until the
        # runner returns and the loop is closed out from under it.
        await asyncio.sleep(0.6)

    def run_loop():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(fill_then_park())
        finally:
            for task in asyncio.all_tasks(loop):
                task.cancel()
            loop.close()
            asyncio.set_event_loop(None)

    t = threading.Thread(target=run_loop)
    t.start()
    assert ready.wait(10)

    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        worker_done = threading.Event()

        def worker():
            result["ok"] = put_blocking(result["q"], "blocked", loop, stop)
            worker_done.set()

        # daemon: a regression (worker spinning past loop death) must FAIL
        # the assert below, not hang the interpreter at exit
        w = threading.Thread(target=worker, daemon=True)
        w.start()
        t.join(20)
        assert worker_done.wait(10), "worker spun past loop death"
        w.join(10)
        import gc

        gc.collect()  # would raise the un-awaited-coroutine RuntimeWarning
    assert result["ok"] is False
