"""DB hot-sync (engine.refresh) tests — the reference's participant sync TODO
(src/main.rs:402,415: "Sync from database and add to memmapped file"),
implemented as first-class append-only refresh on every DB-holding engine.

Every test pins the same bar: a refreshed engine must be indistinguishable
from an engine freshly built on the grown source.
"""

import asyncio

import numpy as np
import pytest

from mpc_iris_tpu import native
from mpc_iris_tpu.constants import BITS, BITS_BYTES
from mpc_iris_tpu.models import KeyedShareEngine, MasksEngine, ShareEngine
from mpc_iris_tpu.protocol import ParticipantServer


def _shares(rng, n):
    return rng.integers(0, 1 << 16, size=(n, BITS), dtype=np.uint16)


def _queries(rng, b=2):
    return (rng.integers(0, 256, (b, BITS_BYTES), dtype=np.uint8),
            rng.integers(0, 256, (b, BITS_BYTES), dtype=np.uint8))


class TestShareEngineRefresh:
    def test_grow_partial_tail_chunk(self, rng):
        """Growth through a previously-padded tail chunk (the tricky case:
        that chunk's device copy is stale and must be re-transferred)."""
        full = _shares(rng, 13)
        qp, qm = _queries(rng)
        eng = ShareEngine(full[:6], chunk=4)  # 1 full + 1 partial chunk
        added = eng.refresh(full)
        assert added == 7 and eng.count == 13
        fresh = ShareEngine(full, chunk=4)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_grow_aligned(self, rng):
        full = _shares(rng, 12)
        qp, qm = _queries(rng)
        eng = ShareEngine(full[:8], chunk=4)
        assert eng.refresh(full) == 4
        fresh = ShareEngine(full, chunk=4)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_grow_past_residency_budget(self, rng):
        """Growth past an explicit HBM budget: new chunks serve out-of-core
        (streamed per batch) and results stay identical."""
        full = _shares(rng, 14)
        qp, qm = _queries(rng)
        budget = 2 * BITS * 4 * 2  # exactly 2 resident chunks of 4 rows
        eng = ShareEngine(full[:8], chunk=4, hbm_budget=budget)
        assert eng._n_resident == 2
        eng.refresh(full)
        assert eng._n_resident == 2  # budget unchanged; tail streams
        assert eng.num_chunks() == 4
        fresh = ShareEngine(full, chunk=4, hbm_budget=budget)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_noop_and_shrink(self, rng):
        full = _shares(rng, 8)
        eng = ShareEngine(full, chunk=4)
        assert eng.refresh(full) == 0
        with pytest.raises(ValueError, match="append-only"):
            eng.refresh(full[:4])

    def test_refresh_mid_stream_serves_engine_state_at_start(self, rng):
        """refresh() between stream() chunks must not corrupt the in-flight
        reply: the stream captured its chunk count at generator start, and
        the grown source is append-only, so every already- or not-yet-
        dispatched chunk still reads identical prefix rows."""
        full = _shares(rng, 24)
        qp, qm = _queries(rng)
        eng = ShareEngine(full[:10], chunk=2)  # 5 chunks in flight
        gen = eng.stream(qp, qm)
        parts = [next(gen)]  # generator started: count/chunks captured
        assert eng.refresh(full) == 14
        parts.extend(gen)
        got = np.concatenate(parts, axis=1)
        fresh = ShareEngine(full[:10], chunk=2)
        np.testing.assert_array_equal(got, fresh.dots(qp, qm))
        # ... and the NEXT stream serves the grown DB.
        grown = np.concatenate(list(eng.stream(qp, qm)), axis=1)
        np.testing.assert_array_equal(
            grown, ShareEngine(full, chunk=2).dots(qp, qm))

    def test_memmap_file_growth(self, rng, tmp_path):
        """The real deployment shape: the share FILE is appended to and a
        re-opened memmap slots in (reference src/main.rs:415)."""
        from mpc_iris_tpu.io.formats import open_share, write_share

        full = _shares(rng, 10)
        path = tmp_path / "mpc.share-0"
        write_share(path, full[:6])
        eng = ShareEngine(open_share(path), chunk=4)
        write_share(path, full[6:])  # append-only file growth
        assert eng.refresh(open_share(path)) == 4
        qp, qm = _queries(rng)
        fresh = ShareEngine(full, chunk=4)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))


class TestWatcherTornRecords:
    def test_share_watcher_ignores_partial_trailing_record(self, rng, tmp_path):
        """A writer mid-append leaves a torn trailing record; the watcher
        must ignore it until the record completes (docstring contract of
        cli.make_share_watcher)."""
        from mpc_iris_tpu.cli import make_share_watcher
        from mpc_iris_tpu.io.formats import open_share, write_share

        full = _shares(rng, 9)
        path = tmp_path / "mpc.share-0"
        write_share(path, full[:7])
        eng = ShareEngine(open_share(path), chunk=4)
        watch = make_share_watcher(str(path), eng)

        tail = np.ascontiguousarray(full[7:]).astype("<u2").tobytes()
        with open(path, "ab") as f:
            f.write(tail[:1000])  # torn mid-record (record = 25,600 B)
        assert watch() == 0 and eng.count == 7
        with open(path, "ab") as f:
            f.write(tail[1000:])  # append completes
        assert watch() == 2 and eng.count == 9
        # A transiently missing file skips the sync instead of raising —
        # a watcher exception would kill the serving loop.
        path.rename(tmp_path / "moved-away")
        assert watch() == 0 and eng.count == 9
        (tmp_path / "moved-away").rename(path)
        qp, qm = _queries(rng)
        np.testing.assert_array_equal(
            eng.dots(qp, qm), ShareEngine(full, chunk=4).dots(qp, qm))

    def test_masks_watcher_ignores_partial_trailing_record(self, rng, tmp_path):
        from mpc_iris_tpu.cli import make_masks_watcher
        from mpc_iris_tpu.io.formats import open_masks, write_masks

        masks = rng.integers(0, 256, (6, BITS_BYTES), dtype=np.uint8)
        path = tmp_path / "mpc.masks"
        write_masks(path, masks[:4])
        eng = MasksEngine(open_masks(path), chunk=4)
        watch = make_masks_watcher(str(path), eng)
        with open(path, "ab") as f:
            f.write(masks[4:].tobytes()[:700])  # torn (record = 1,600 B)
        assert watch() == 0 and eng.count == 4
        with open(path, "ab") as f:
            f.write(masks[4:].tobytes()[700:])
        assert watch() == 2 and eng.count == 6


class TestKeyedRefresh:
    def test_grow_count(self, rng):
        key = native.derive_insecure_key(7)
        qp, qm = _queries(rng)
        eng = KeyedShareEngine(key, 0, count=9, chunk=4)
        assert eng.refresh(17) == 8
        fresh = KeyedShareEngine(key, 0, count=17, chunk=4)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))
        with pytest.raises(ValueError, match="append-only"):
            eng.refresh(3)

    def test_grow_extends_resident_head(self, rng):
        key = native.derive_insecure_key(8)
        qp, qm = _queries(rng)
        budget = 2 * BITS * 4 * 3  # room for 3 resident chunks of 4 rows
        eng = KeyedShareEngine(key, 1, count=6, chunk=4, hbm_budget=budget)
        assert eng._n_resident == 2  # only 2 chunks exist yet
        eng.refresh(20)
        assert eng._n_resident == 3  # head grew to the budget cap
        fresh = KeyedShareEngine(key, 1, count=20, chunk=4, hbm_budget=budget)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))


class TestKeyedCountWatcher:
    def test_grow_torn_and_shrink(self, rng, tmp_path):
        """A keyed party learns growth from the `<base>.count` text sidecar:
        absent/torn/garbage files are skipped until the writer completes;
        a shrunk count is refused without killing the serving loop."""
        from mpc_iris_tpu.cli import make_keyed_count_watcher

        key = native.derive_insecure_key(5)
        eng = KeyedShareEngine(key, 0, count=6, chunk=4)
        cf = tmp_path / "mpc.count"
        watch = make_keyed_count_watcher(str(cf), eng)
        assert watch() == 0  # absent file: adopt next time
        cf.write_text("")
        assert watch() == 0  # mid-write torn/empty
        cf.write_text("not-a-number")
        assert watch() == 0
        cf.write_text("13\n")
        assert watch() == 7 and eng.count == 13
        qp, qm = _queries(rng)
        fresh = KeyedShareEngine(key, 0, count=13, chunk=4)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))
        cf.write_text("4\n")  # shrink: append-only, ignored loudly
        assert watch() == 0 and eng.count == 13

    def test_masks_follower(self, rng):
        """Coordinator-held keyed share follows the masks count (same
        logical DB; no sidecar needed on the coordinator)."""
        from mpc_iris_tpu.cli import make_keyed_masks_follower

        key = native.derive_insecure_key(6)
        eng = KeyedShareEngine(key, 0, count=5, chunk=4)
        masks = rng.integers(0, 256, (9, BITS_BYTES), dtype=np.uint8)
        me = MasksEngine(masks[:5], chunk=4)
        follow = make_keyed_masks_follower(eng, me)
        assert follow() == 0
        me.refresh(masks)
        assert follow() == 4 and eng.count == 9


class TestMasksRefresh:
    @pytest.mark.parametrize("storage", ["dense", "packed"])
    def test_grow(self, rng, storage):
        masks = rng.integers(0, 256, (11, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
        eng = MasksEngine(masks[:5], chunk=4, storage=storage)
        assert eng.refresh(masks) == 6
        fresh = MasksEngine(masks, chunk=4, storage=storage)
        np.testing.assert_array_equal(eng.dots(qm), fresh.dots(qm))
        with pytest.raises(ValueError, match="append-only"):
            eng.refresh(masks[:2])

    @pytest.mark.parametrize("storage", ["dense", "packed"])
    def test_refresh_cost_is_o_added(self, rng, storage):
        """refresh() transfers only the previously-padded tail chunk plus new
        chunks — O(added), not O(total)."""
        masks = rng.integers(0, 256, (72, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)

        # Aligned start: 64 rows = 16 full chunks; +8 rows = 2 new chunks.
        eng = MasksEngine(masks[:64], chunk=4, storage=storage)
        kept = list(eng._blocks)
        put, orig = [], eng._put_chunk
        eng._put_chunk = lambda c: (put.append(c), orig(c))[1]
        assert eng.refresh(masks) == 8
        assert put == [16, 17]  # zero re-transfers of existing chunks
        assert all(a is b for a, b in zip(eng._blocks, kept))  # reused

        # Padded start: 62 rows -> chunk 15 was padded, so it re-transfers.
        eng2 = MasksEngine(masks[:62], chunk=4, storage=storage)
        put2, orig2 = [], eng2._put_chunk
        eng2._put_chunk = lambda c: (put2.append(c), orig2(c))[1]
        assert eng2.refresh(masks) == 10
        assert put2 == [15, 16, 17]

        fresh = MasksEngine(masks, chunk=4, storage=storage)
        np.testing.assert_array_equal(eng.dots(qm), fresh.dots(qm))
        np.testing.assert_array_equal(eng2.dots(qm), fresh.dots(qm))


class TestShardedRefresh:
    def test_sharded_share(self, rng):
        from mpc_iris_tpu.parallel import ShardedShareEngine, make_mesh

        mesh = make_mesh(db=4, batch=1)
        full = _shares(rng, 26)  # blocks of 4 shards x chunk 2 = 8 rows
        qp, qm = _queries(rng)
        eng = ShardedShareEngine(full[:10], mesh, chunk=2)
        assert eng.refresh(full) == 16
        fresh = ShardedShareEngine(full, mesh, chunk=2)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_sharded_keyed(self, rng):
        from mpc_iris_tpu.parallel import ShardedKeyedShareEngine, make_mesh

        key = native.derive_insecure_key(9)
        mesh = make_mesh(db=4, batch=1)
        qp, qm = _queries(rng)
        eng = ShardedKeyedShareEngine(key, 0, 9, mesh, chunk=2)
        assert eng.refresh(21) == 12
        fresh = ShardedKeyedShareEngine(key, 0, 21, mesh, chunk=2)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_sharded_masks(self, rng):
        from mpc_iris_tpu.parallel import ShardedMasksEngine, make_mesh

        mesh = make_mesh(db=4, batch=1)
        masks = rng.integers(0, 256, (19, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
        eng = ShardedMasksEngine(masks[:7], mesh, chunk=2)
        assert eng.refresh(masks) == 12
        fresh = ShardedMasksEngine(masks, mesh, chunk=2)
        np.testing.assert_array_equal(eng.dots(qm), fresh.dots(qm))

    def test_sharded_masks_refresh_cost_is_o_added(self, rng):
        """Sharded masks refresh reuses complete blocks and loads only the
        padded tail + new blocks."""
        from mpc_iris_tpu.parallel import ShardedMasksEngine, make_mesh

        mesh = make_mesh(db=4, batch=1)
        masks = rng.integers(0, 256, (40, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
        # block = 4 shards x chunk 2 = 8 rows; 24 rows = 3 full blocks.
        eng = ShardedMasksEngine(masks[:24], mesh, chunk=2)
        kept = list(eng._blocks)
        loads, orig = [], eng._load_block
        eng._load_block = lambda j, src, n: (loads.append(j), orig(j, src, n))[1]
        assert eng.refresh(masks) == 16
        assert loads == [3, 4]  # only the two appended blocks
        assert all(a is b for a, b in zip(eng._blocks, kept))
        fresh = ShardedMasksEngine(masks, mesh, chunk=2)
        np.testing.assert_array_equal(eng.dots(qm), fresh.dots(qm))


class TestParticipantWatch:
    def test_server_syncs_appended_rows_between_queries(self, rng, tmp_path):
        """End-to-end: participant with a --watch-style refresh hook serves a
        grown share file to the SECOND query without restarting (the
        reference's in-accept-loop sync TODO, src/main.rs:415)."""
        from mpc_iris_tpu.cli import make_share_watcher
        from mpc_iris_tpu.io.formats import open_share, write_share
        from mpc_iris_tpu.protocol.wire import read_records
        from mpc_iris_tpu.types import Template

        full = _shares(rng, 11)
        path = tmp_path / "mpc.share-0"
        write_share(path, full[:7])
        eng = ShareEngine(open_share(path), chunk=4)
        query = Template.random(np.random.default_rng(3))

        async def ask(port):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(query.to_bytes())
            await writer.drain()
            recs, _eof = await read_records(reader, 1000)
            writer.close()
            await writer.wait_closed()
            return recs

        async def go():
            server = ParticipantServer(
                eng, "127.0.0.1", 0,
                refresh=make_share_watcher(str(path), eng),
            )
            _, port = await server.start()
            try:
                first = await ask(port)
                write_share(path, full[7:])  # DB grows while serving
                second = await ask(port)
            finally:
                await server.close()
            return first, second

        first, second = asyncio.run(go())
        assert first.shape[0] == 7 and second.shape[0] == 11
        # The grown reply must match a from-scratch engine on the full DB.
        qp = query.pattern.data[None]
        qm = query.mask.data[None]
        fresh = ShareEngine(full, chunk=4)
        np.testing.assert_array_equal(second, fresh.dots(qp, qm)[0])


class TestKeyedParticipantWatch:
    def test_keyed_server_follows_count_file(self, rng, tmp_path):
        """End-to-end keyed DB growth: a keyed participant with a
        --watch-count-style hook serves the grown count to the second query
        (zero share bytes ever written — growth arrives as a number)."""
        from mpc_iris_tpu.cli import make_keyed_count_watcher
        from mpc_iris_tpu.protocol.wire import read_records
        from mpc_iris_tpu.types import Template

        key = native.derive_insecure_key(11)
        eng = KeyedShareEngine(key, 0, count=7, chunk=4)
        cf = tmp_path / "mpc.count"
        cf.write_text("7\n")
        query = Template.random(np.random.default_rng(4))

        async def ask(port):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(query.to_bytes())
            await writer.drain()
            recs, _eof = await read_records(reader, 1000)
            writer.close()
            await writer.wait_closed()
            return recs

        async def go():
            server = ParticipantServer(
                eng, "127.0.0.1", 0,
                refresh=make_keyed_count_watcher(str(cf), eng),
            )
            _, port = await server.start()
            try:
                first = await ask(port)
                cf.write_text("11\n")  # DB grows while serving
                second = await ask(port)
            finally:
                await server.close()
            return first, second

        first, second = asyncio.run(go())
        assert first.shape[0] == 7 and second.shape[0] == 11
        qp = query.pattern.data[None]
        qm = query.mask.data[None]
        fresh = KeyedShareEngine(key, 0, count=11, chunk=4)
        np.testing.assert_array_equal(second, fresh.dots(qp, qm)[0])
        np.testing.assert_array_equal(second[:7], first)


class TestCoordinatorWatch:
    def test_full_protocol_finds_winner_appended_between_rounds(
            self, rng, tmp_path):
        """Whole-system DB sync (the cmd_coordinator --watch loop): masks and
        both parties' share files grow between two coordinator queries; the
        second round must search the appended region and find a planted
        winner there."""
        from mpc_iris_tpu.cli import make_masks_watcher, make_share_watcher
        from mpc_iris_tpu.io.formats import (open_masks, open_share,
                                             write_masks, write_share)
        from mpc_iris_tpu.ops.encode import encode_template
        from mpc_iris_tpu.protocol import Coordinator
        from mpc_iris_tpu.types import Template

        db = [Template.random(rng) for _ in range(19)]
        query = Template.random(rng)
        db[14] = query.rotated(-4)  # planted winner lives in the APPENDED rows
        head = 11
        mats = [np.zeros((19, BITS), dtype=np.uint16) for _ in range(2)]
        for i, t in enumerate(db):
            for p, s in enumerate(encode_template(t).share(2, rng)):
                mats[p][i] = s.data
        masks = np.stack([t.mask.data for t in db])
        mpath = tmp_path / "mpc.masks"
        spaths = [tmp_path / f"mpc.share-{p}" for p in range(2)]
        write_masks(mpath, masks[:head])
        for p in range(2):
            write_share(spaths[p], mats[p][:head])

        masks_engine = MasksEngine(open_masks(mpath), chunk=4)
        engines = [ShareEngine(open_share(sp), chunk=4) for sp in spaths]
        watch_masks = make_masks_watcher(str(mpath), masks_engine)

        async def go():
            servers = [
                ParticipantServer(
                    eng, "127.0.0.1", 0,
                    refresh=make_share_watcher(str(sp), eng))
                for eng, sp in zip(engines, spaths)
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(masks_engine, addrs, batch_records=5)
            try:
                first = await coord.query(query)
                write_masks(mpath, masks[head:])
                for p in range(2):
                    write_share(spaths[p], mats[p][head:])
                await asyncio.to_thread(watch_masks)  # the --watch loop step
                second = await coord.query(query)
            finally:
                for s in servers:
                    await s.close()
            return first, second

        first, second = asyncio.run(go())
        oracle_head = np.array([query.distance(t) for t in db[:head]])
        assert first.total == head
        assert (first.index, first.distance) == (
            int(np.argmin(oracle_head)), oracle_head.min())
        assert second.total == 19
        assert (second.index, second.distance) == (14, 0.0)
