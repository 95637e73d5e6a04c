"""Threshold-audit (dedup) capability: every DB entry with distance strictly
under a threshold, exactly.

The spec's uniqueness flow compares the MINIMUM distance against a threshold
(specification.ipynb "Uniqueness"); these tests pin the audit complement —
`PlaintextEngine.find_under` / `ShardedPlaintextEngine.find_under` /
`Coordinator.query_under` — against the scalar oracle, including thresholds
placed adversarially ON a representable distance (strict <) and rationals whose
f64 rounding collides with the threshold.
"""

import asyncio

import numpy as np
import pytest

from mpc_iris_tpu.models import MasksEngine, PlaintextEngine, ShareEngine
from mpc_iris_tpu.ops.decode import (
    fractions_to_f64_np,
    under_threshold_mask_np,
)
from mpc_iris_tpu.protocol import Coordinator, ParticipantServer
from mpc_iris_tpu.types import Bits, Template

from test_protocol import build_party_data


@pytest.fixture(scope="module")
def audit_world():
    rng = np.random.default_rng(1234)
    n, b = 61, 3
    dpat = np.stack([Template.random(rng).pattern.data for _ in range(n)])
    dmsk = np.stack([Template.random(rng).mask.data for _ in range(n)])
    qpat = np.stack([Template.random(rng).pattern.data for _ in range(b)])
    qmsk = np.stack([Template.random(rng).mask.data for _ in range(b)])
    # plant exact and near matches for query 0
    qpat[0] = Bits(dpat[7]).rotated(-3).data
    qmsk[0] = Bits(dmsk[7]).rotated(-3).data
    dpat[20] = dpat[7]
    dmsk[20] = dmsk[7]
    # an all-invalid DB entry: d == 0 -> +inf, never under any threshold
    dmsk[11] = np.zeros_like(dmsk[11])

    oracle = np.empty((b, n))
    for i in range(b):
        tq = Template(Bits(qpat[i]), Bits(qmsk[i]))
        for j in range(n):
            oracle[i, j] = tq.distance(Template(Bits(dpat[j]), Bits(dmsk[j])))
    return dpat, dmsk, qpat, qmsk, oracle


def check_against_oracle(lists, oracle, threshold):
    for b, hits in enumerate(lists):
        want = np.nonzero(oracle[b] < threshold)[0].tolist()
        got = sorted(m.index for m in hits)
        assert got == sorted(want), (b, threshold, got, want)
        # reported distances are the oracle's f64s; ordering ascending
        dist_by_idx = {m.index: m.distance for m in hits}
        for j in want:
            assert dist_by_idx[j] == oracle[b, j]
        ds = [m.distance for m in hits]
        assert ds == sorted(ds)


class TestUnderThresholdMask:
    def test_exact_boundary_rationals(self):
        # f64(1/3) < 1/3 (the rounding is downward), so with t = f64(1/3):
        # the fraction 100/300 rounds TO t but is exactly above it -> excluded.
        t = 1.0 / 3.0
        n = np.array([100, 1, 1])
        d = np.array([300, 4, 0])
        mask = under_threshold_mask_np(n, d, t)
        assert mask.tolist() == [False, True, False]
        # nudge the threshold one ulp up: now 1/3 is strictly under it
        t_up = float(np.nextafter(t, 1.0))
        assert under_threshold_mask_np(n, d, t_up).tolist() == [True, True, False]

    def test_threshold_on_representable_distance_is_strict(self):
        # distance exactly equal to the threshold must NOT match (strict <)
        n = np.array([1, 1])
        d = np.array([2, 2])
        assert under_threshold_mask_np(n, d, 0.5).tolist() == [False, False]
        assert under_threshold_mask_np(n, d, float(np.nextafter(0.5, 1))).tolist() == [True, True]

    def test_degenerate_thresholds(self):
        n = np.array([0, 3])
        d = np.array([5, 7])
        assert under_threshold_mask_np(n, d, 0.0).tolist() == [False, False]
        assert under_threshold_mask_np(n, d, float("nan")).tolist() == [False, False]
        assert under_threshold_mask_np(n, d, float("inf")).tolist() == [True, True]

    def test_adversarial_boundary_scales(self):
        """A threshold placed exactly on a popular representable distance
        (1/2) pushes every other entry through the ambiguous settle — it
        must stay vectorized-fast at 1M entries and exactly strict."""
        import time

        rng = np.random.default_rng(7)
        N = 1_000_000
        d = np.full(N, 2, dtype=np.int64)
        n = np.ones(N, dtype=np.int64)       # all exactly 1/2 == t
        under = rng.integers(0, N, size=117)  # sprinkle some strictly-under
        n2 = n.copy()
        n2[under] = 0
        t0 = time.monotonic()
        mask = under_threshold_mask_np(n2, d, 0.5)
        dt = time.monotonic() - t0
        assert dt < 1.0, f"boundary settle took {dt:.3f}s at 1M entries"
        want = np.zeros(N, dtype=bool)
        want[under] = True
        assert np.array_equal(mask, want)

    def test_boundary_object_math_fallback(self):
        """When a cross-product would overflow int64 (t = f64(1/3) has
        td = 2**54, so n = 1000 gives n*td > 2**63) the settle must fall
        back to exact object math with identical strict semantics."""
        t = 1.0 / 3.0
        tn, td = t.as_integer_ratio()
        n = np.array([1000, 1, 999])
        d = np.array([3000, 3000, 3000])
        assert 1000 * td >= 2**63  # the int64 path would be unsound here
        # 1000/3000 rounds to f64(1/3) but is exactly ABOVE it (f64(1/3)
        # rounds down) -> ambiguous -> settled False; 999/3000 < 1/3
        # definitively; 1/3000 definitively under.
        assert under_threshold_mask_np(n, d, t).tolist() == [False, True, True]
        # one ulp up: exact 1/3 is now strictly under
        t_up = float(np.nextafter(t, 1.0))
        assert under_threshold_mask_np(n, d, t_up).tolist() == [True, True, True]

    def test_fractions_to_f64_np(self):
        n = np.array([1, 0, 5])
        d = np.array([3, 0, 5])
        vals = fractions_to_f64_np(n, d)
        assert vals[0] == np.float64(1) / np.float64(3)
        assert vals[1] == np.inf
        assert vals[2] == 1.0


class TestPlaintextFindUnder:
    @pytest.mark.parametrize("storage", ["dense", "packed"])
    def test_matches_oracle(self, audit_world, storage):
        dpat, dmsk, qpat, qmsk, oracle = audit_world
        eng = PlaintextEngine(dpat, dmsk, chunk=16, storage=storage)
        finite = oracle[np.isfinite(oracle)]
        for t in (0.25, float(np.median(finite)), 1e-9, 2.0):
            check_against_oracle(eng.find_under(qpat, qmsk, t), oracle, t)

    def test_threshold_on_planted_duplicate(self, audit_world):
        dpat, dmsk, qpat, qmsk, oracle = audit_world
        eng = PlaintextEngine(dpat, dmsk, chunk=16, storage="dense")
        # exact-zero duplicates planted at 7 and 20 for query 0
        hits = eng.find_under(qpat, qmsk, 1e-12)[0]
        assert [m.index for m in hits] == [7, 20]
        assert all(m.distance == 0.0 for m in hits)
        # threshold exactly 0.0: strict < excludes the exact duplicates
        assert eng.find_under(qpat, qmsk, 0.0)[0] == []

    @pytest.mark.parametrize("storage", ["dense", "packed"])
    def test_compact_path_matches_full(self, audit_world, storage):
        """The device-compacted audit (O(matches) fetch) is bit-identical to
        the full-spectrum path at every threshold class: normal, tiny,
        median, and one sitting EXACTLY on a present distance (the f32
        prefilter over-includes it; the exact host settle must exclude)."""
        dpat, dmsk, qpat, qmsk, oracle = audit_world
        eng = PlaintextEngine(dpat, dmsk, chunk=16, storage=storage)
        finite = oracle[np.isfinite(oracle)]
        exact_hit = float(finite[5])  # a threshold equal to a real distance
        for t in (0.25, float(np.median(finite)), 1e-9, exact_hit, 2.0):
            # compact_k < count forces the compacted device path
            fast = eng.find_under(qpat, qmsk, t, compact_k=48)
            full = eng.find_under(qpat, qmsk, t)  # k >= count: full path
            assert [[(m.index, m.distance, m.numerator, m.denominator)
                     for m in row] for row in fast] == \
                [[(m.index, m.distance, m.numerator, m.denominator)
                  for m in row] for row in full], t

    def test_compact_subnormal_threshold_takes_exact_path(self, audit_world):
        """A threshold below f32 normal range must NOT go through the f32
        prefilter (device flush-to-zero would turn t_hi*d into 0 and silently
        exclude exact duplicates); the orchestrator routes it to the exact
        full path — the planted distance-0 duplicates must appear."""
        dpat, dmsk, qpat, qmsk, oracle = audit_world
        eng = PlaintextEngine(dpat, dmsk, chunk=16, storage="dense")
        hits = eng.find_under(qpat, qmsk, 1e-40, compact_k=48)[0]
        assert [m.index for m in hits] == [7, 20]  # exact duplicates found
        assert all(m.distance == 0.0 for m in hits)
        # gigantic thresholds (f32 overflow of t_hi) likewise stay exact
        big = eng.find_under(qpat, qmsk, 1e39, compact_k=48)
        full = eng.find_under(qpat, qmsk, 1e39)
        assert [[m.index for m in row] for row in big] == \
            [[m.index for m in row] for row in full]

    def test_compact_overflow_falls_back_to_full(self, audit_world):
        """Candidates past compact_k (e.g. an adversarial threshold matching
        nearly everything) fall back to the full fetch — identical lists."""
        dpat, dmsk, qpat, qmsk, oracle = audit_world
        eng = PlaintextEngine(dpat, dmsk, chunk=16, storage="dense")
        fast = eng.find_under(qpat, qmsk, 0.9, compact_k=4)  # overflow
        full = eng.find_under(qpat, qmsk, 0.9)
        assert [[m.index for m in row] for row in fast] == \
            [[m.index for m in row] for row in full]

    def test_compact_path_respects_limit(self, audit_world):
        """The serving limit guard raises through the compacted path too."""
        from mpc_iris_tpu.models.engines import AuditLimitExceeded

        dpat, dmsk, qpat, qmsk, oracle = audit_world
        eng = PlaintextEngine(dpat, dmsk, chunk=16, storage="dense")
        with pytest.raises(AuditLimitExceeded):
            eng.find_under(qpat, qmsk, 0.9, limit=2, compact_k=48)

    def test_min_fractions_equals_full_oracle(self, audit_world):
        dpat, dmsk, qpat, qmsk, oracle = audit_world
        eng = PlaintextEngine(dpat, dmsk, chunk=16, storage="dense")
        nd = eng.min_fractions(qpat, qmsk)
        assert nd.shape == (2, qpat.shape[0], dpat.shape[0])
        assert np.array_equal(fractions_to_f64_np(nd[0], nd[1]), oracle)


class TestShardedFindUnder:
    def test_matches_single_chip(self, audit_world):
        import jax

        from mpc_iris_tpu.parallel import (
            ShardedPlaintextEngine,
            make_mesh,
            mesh_shape_for,
        )

        dpat, dmsk, qpat, qmsk, oracle = audit_world
        b = qpat.shape[0]
        db_ax, batch_ax = mesh_shape_for(len(jax.devices()), b)
        mesh = make_mesh(db=db_ax, batch=batch_ax)
        seng = ShardedPlaintextEngine(dpat, dmsk, mesh, chunk=4)
        nd = seng.min_fractions(qpat, qmsk)
        assert np.array_equal(fractions_to_f64_np(nd[0], nd[1]), oracle)
        t = float(np.median(oracle[np.isfinite(oracle)]))
        check_against_oracle(seng.find_under(qpat, qmsk, t), oracle, t)
        # compacted device path (forced by compact_k < count) == full path
        # at every threshold class, incl. one equal to a present distance
        finite = oracle[np.isfinite(oracle)]
        for tt in (t, 1e-9, float(finite[4]), 2.0):
            fast = seng.find_under(qpat, qmsk, tt, compact_k=48)
            full = seng.find_under(qpat, qmsk, tt)
            assert [[(m.index, m.distance, m.numerator, m.denominator)
                     for m in row] for row in fast] == \
                [[(m.index, m.distance, m.numerator, m.denominator)
                  for m in row] for row in full], tt
        # overflow falls back to the full fetch, identical lists
        fast = seng.find_under(qpat, qmsk, 0.9, compact_k=4)
        full = seng.find_under(qpat, qmsk, 0.9)
        assert [[m.index for m in row] for row in fast] == \
            [[m.index for m in row] for row in full]


class TestCoordinatorQueryUnder:
    def run_under(self, world, threshold, n_parties=2, local_share=False,
                  batch_records=7, chunk=8):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, n_parties)

        async def go():
            local_engine = None
            remote = mats
            if local_share:
                local_engine = ShareEngine(mats[0], chunk=chunk)
                remote = mats[1:]
            servers = [
                ParticipantServer(ShareEngine(m, chunk=chunk), "127.0.0.1", 0)
                for m in remote
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(
                MasksEngine(masks, chunk=chunk), addrs,
                local_engine=local_engine, batch_records=batch_records,
            )
            try:
                return await coord.query_under(query, threshold)
            finally:
                for s in servers:
                    await s.close()

        return asyncio.run(go())

    @pytest.fixture(scope="class")
    def world(self):
        rng = np.random.default_rng(99)
        db = [Template.random(rng) for _ in range(23)]
        query = Template.random(rng)
        db[17] = query.rotated(5)  # exact duplicate
        db[3] = query.rotated(-2)  # second exact duplicate
        masks = np.stack([t.mask.data for t in db])
        return rng, db, query, masks

    def test_matches_oracle(self, world):
        rng, db, query, masks = world
        oracle = np.array([query.distance(t) for t in db])
        t = float(np.median(oracle))
        out = self.run_under(world, t)
        assert out.total == len(db)
        want = sorted(np.nonzero(oracle < t)[0].tolist())
        assert sorted(m.index for m in out.matches) == want
        for m in out.matches:
            assert m.distance == oracle[m.index]
        ds = [m.distance for m in out.matches]
        assert ds == sorted(ds)

    def test_duplicates_listed_with_local_share(self, world):
        rng, db, query, masks = world
        out = self.run_under(world, 1e-9, n_parties=3, local_share=True)
        assert [m.index for m in out.matches] == [3, 17]
        assert all(m.distance == 0.0 for m in out.matches)

    def test_strict_threshold_zero(self, world):
        out = self.run_under(world, 0.0)
        assert out.matches == []
        assert out.total == 23

    def test_audit_serving_wire_round_trip(self, world):
        """SPEC 5.3: QueryServer(audit=True) — template ‖ f64 threshold in,
        (count, total) header + (index, distance) records out; lists identical
        to a direct query_under."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote_under

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = np.array([query.distance(t) for t in db])
        t = float(np.median(oracle))

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
                hit = await query_remote_under(host, port, query, t)
                none = await query_remote_under(host, port, query, 0.0)
                return hit, none
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        hit, none = asyncio.run(go())
        want = sorted(np.nonzero(oracle < t)[0].tolist())
        assert hit.total == len(db)
        assert sorted(m.index for m in hit.matches) == want
        for m in hit.matches:
            assert m.distance == oracle[m.index]
        assert none.matches == [] and none.total == len(db)

    def test_audit_serving_micro_batched_mixed_thresholds(self, world):
        """Micro-batched audit clients each bring their OWN threshold; lists
        stay bit-identical to solo rounds (the device pass is threshold-
        independent)."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote_under

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = db[5]
        oracle_q = np.array([query.distance(t) for t in db])
        oracle_2 = np.array([q2.distance(t) for t in db])
        t1 = float(np.median(oracle_q))
        t2 = float(np.quantile(oracle_2, 0.25))

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0, audit=True,
                                 max_batch=2, batch_window=0.25)
            host, port = await server.start()
            try:
                return await asyncio.gather(
                    query_remote_under(host, port, query, t1),
                    query_remote_under(host, port, q2, t2),
                )
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        o1, o2 = asyncio.run(go())
        for out, oracle, t in ((o1, oracle_q, t1), (o2, oracle_2, t2)):
            assert out.total == len(db)
            assert sorted(m.index for m in out.matches) == \
                sorted(np.nonzero(oracle < t)[0].tolist())
            for m in out.matches:
                assert m.distance == oracle[m.index]

    def test_audit_serving_limit_guard(self, world):
        """max_matches: a client whose threshold matches too many entries is
        closed without a reply; a co-batched modest client still gets its
        exact list (per-query enforcement)."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote_under

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = np.array([query.distance(t) for t in db])
        t_small = 1e-9  # exact duplicates only (2 planted)

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                                  wire="batched")
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0, audit=True,
                                 max_batch=2, batch_window=0.25,
                                 max_matches=3)
            host, port = await server.start()
            try:
                greedy, modest = await asyncio.gather(
                    query_remote_under(host, port, query, 1.0),  # all entries
                    query_remote_under(host, port, query, t_small),
                    return_exceptions=True,
                )
                return greedy, modest, server.stats()
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        greedy, modest, stats = asyncio.run(go())
        assert isinstance(greedy, asyncio.IncompleteReadError)
        assert not isinstance(modest, BaseException)
        assert sorted(m.index for m in modest.matches) == \
            sorted(np.nonzero(oracle < t_small)[0].tolist())
        assert stats["failed"] == 1 and stats["served"] == 1

    def test_audit_serving_failure_closes_short(self, world):
        """A failed audit round closes the client without a complete header."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote_under

        rng, db, query, masks = world

        async def go():
            coord = Coordinator(MasksEngine(masks, chunk=8),
                                [("127.0.0.1", 1)])  # unreachable party
            server = QueryServer(coord, "127.0.0.1", 0, audit=True)
            host, port = await server.start()
            try:
                with pytest.raises(asyncio.IncompleteReadError):
                    await asyncio.wait_for(
                        query_remote_under(host, port, query, 0.5), timeout=10
                    )
            finally:
                await server.close()

        asyncio.run(go())

    def test_audit_serving_rejects_nonfinite_threshold(self, world):
        """A client-supplied NaN/inf threshold is a nonsense policy value:
        the server closes without a reply (like the limit_exceeded path)
        instead of returning a well-formed '0 matches' that reads as
        'no duplicates'."""
        from mpc_iris_tpu.protocol import QueryServer, query_remote_under

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
                bad = await asyncio.gather(
                    query_remote_under(host, port, query, float("nan")),
                    query_remote_under(host, port, query, float("inf")),
                    return_exceptions=True,
                )
                ok = await query_remote_under(host, port, query, 1e-9)
                return bad, ok, server.stats()
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        bad, ok, stats = asyncio.run(go())
        assert all(isinstance(b, asyncio.IncompleteReadError) for b in bad)
        assert sorted(m.index for m in ok.matches) == [3, 17]
        assert stats["failed"] == 2 and stats["served"] == 1

    def test_audit_client_bounds_server_count(self, world):
        """query_remote_under must not trust the server's u64 match count:
        a malicious/buggy server claiming a huge count gets a clean
        ConnectionError, not a multi-exabyte allocation attempt."""
        from mpc_iris_tpu.protocol import query_remote_under
        from mpc_iris_tpu.protocol.coordinator import (AUDIT_HEAD,
                                                       AUDIT_THRESHOLD)
        from mpc_iris_tpu.constants import TEMPLATE_BYTES

        rng, db, query, masks = world

        async def evil(reader, writer):
            await reader.readexactly(TEMPLATE_BYTES + AUDIT_THRESHOLD.size)
            writer.write(AUDIT_HEAD.pack(2**60, 23))  # exabytes of "matches"
            await writer.drain()
            writer.close()

        async def go():
            server = await asyncio.start_server(evil, "127.0.0.1", 0)
            host, port = server.sockets[0].getsockname()[:2]
            try:
                with pytest.raises(ConnectionError, match="client cap"):
                    await query_remote_under(host, port, query, 0.5)
            finally:
                server.close()
                await server.wait_closed()

        asyncio.run(go())

    def test_persistent_audit_wire(self, world):
        """SPEC 5.5 on the audit service: one connection carries several
        (template ‖ threshold) queries; per-query lists identical to
        one-shot audits, and a close-without-reply (limit exceeded) ends
        the session as a short read."""
        from mpc_iris_tpu.protocol import (
            PersistentQueryClient,
            QueryServer,
            query_remote_under,
        )

        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = np.array([query.distance(t) for t in db])
        t1 = float(np.median(oracle))
        t2 = 1e-9

        async def go():
            parts = [
                ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
                for m in mats
            ]
            addrs = [await p.start() for p in parts]
            coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                                batch_records=7)
            server = QueryServer(coord, "127.0.0.1", 0, audit=True,
                                 max_matches=len(db) // 2)
            host, port = await server.start()
            try:
                c = await PersistentQueryClient.connect(host, port,
                                                        audit=True)
                a1 = await c.query_under(query, t1)
                a2 = await c.query_under(query, t2)
                # threshold 1.0 exceeds max_matches -> session ends with a
                # short read, not a fabricated reply
                with pytest.raises(asyncio.IncompleteReadError):
                    await c.query_under(query, 1.0)
                await c.close()
                solo1 = await query_remote_under(host, port, query, t1)
                return a1, a2, solo1, server.stats()
            finally:
                await server.close()
                for p in parts:
                    await p.close()

        a1, a2, solo1, stats = asyncio.run(go())
        assert [(m.index, m.distance) for m in a1.matches] == \
            [(m.index, m.distance) for m in solo1.matches]
        assert sorted(m.index for m in a2.matches) == [3, 17]
        assert stats["served"] == 3 and stats["failed"] == 1

    def test_batched_audit_matches_single(self, world):
        """query_batch_under over the batched wire: per-query audit lists
        identical to sequential query_under runs."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = db[5]
        oracle_q = np.array([query.distance(t) for t in db])
        t = float(np.median(oracle_q))

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
                return await coord.query_batch_under([query, q2], t)
            finally:
                for s in servers:
                    await s.close()

        outs = asyncio.run(go())
        assert len(outs) == 2
        for q, out in zip((query, q2), outs):
            oracle = np.array([q.distance(tt) for tt in db])
            assert out.total == len(db)
            want = sorted(np.nonzero(oracle < t)[0].tolist())
            assert sorted(m.index for m in out.matches) == want
            for m in out.matches:
                assert m.distance == oracle[m.index]
        # sequential single-wire audit gives the identical lists
        single0 = self.run_under(world, t)
        assert [(m.index, m.distance) for m in outs[0].matches] == \
            [(m.index, m.distance) for m in single0.matches]


# ------------------------------------------------------- compaction properties


class TestCompactionProperties:
    """Hypothesis coverage of the device-side audit compaction
    (models.engines._compact_under_device + its host epilogues): for random (n, d) spectra and thresholds placed exactly
    on representable distances, (a) the f32 prefilter candidate set is a
    SUPERSET of the exact match set, (b) settle_compacted_under equals
    find_under_from_fractions, and (c) overflow (> k candidates) falls back
    through orchestrate_find_under with identical results. Exactness bar ==
    the reference decode (src/lib.rs:97-107)."""

    @staticmethod
    def _spectrum(seed: int, b: int, n: int) -> np.ndarray:
        """uint16 [2, B, N] with adversarial structure: d == 0 invalids,
        n == 0 exact duplicates, tiny denominators, and a cluster of equal
        fractions (boundary pile-ups)."""
        rng = np.random.default_rng(seed)
        d = rng.integers(0, 12801, (b, n)).astype(np.int64)
        d[rng.random((b, n)) < 0.05] = 0            # invalid entries
        num = np.floor(rng.random((b, n)) * (d + 1)).astype(np.int64)
        num[rng.random((b, n)) < 0.05] = 0          # exact duplicates
        tiny = rng.random((b, n)) < 0.05            # tiny-denominator rows
        d[tiny] = rng.integers(1, 8, tiny.sum())
        num = np.minimum(num, d)
        # a pile-up: several entries share one exact fraction
        if n >= 16:
            num[:, 3:9] = 300
            d[:, 3:9] = 800
        return np.stack([num, d]).astype(np.uint16)

    @staticmethod
    def _thresholds(nd: np.ndarray, seed: int) -> list[float]:
        """A threshold EXACTLY on a representable present distance, one a
        ulp above/below it, and a generic one."""
        from mpc_iris_tpu.ops.decode import fractions_to_f64_np

        dist = fractions_to_f64_np(nd[0].ravel(), nd[1].ravel())
        finite = dist[np.isfinite(dist) & (dist > 0)]
        rng = np.random.default_rng(seed)
        ts = [0.375]
        if finite.size:
            t = float(rng.choice(finite))
            ts += [t, float(np.nextafter(t, 2.0)), float(np.nextafter(t, 0.0))]
        return ts

    def _check_one(self, nd: np.ndarray, t: float, k: int):
        import jax.numpy as jnp

        from mpc_iris_tpu.models.engines import (
            _compact_under_jit,
            find_under_from_fractions,
            orchestrate_find_under,
            settle_compacted_under,
        )

        b, n = nd.shape[1], nd.shape[2]
        t_hi = np.float32(t * (1.0 + 1e-4))
        assert np.isfinite(t_hi) and t_hi >= np.finfo(np.float32).tiny
        meta, nd_c = _compact_under_jit(jnp.asarray(nd), t_hi, k=k)
        meta = np.asarray(meta)
        nd_c = np.asarray(nd_c)

        exact = under_threshold_mask_np(
            nd[0].astype(np.int64), nd[1].astype(np.int64), t)
        for q in range(b):
            want = set(np.nonzero(exact[q])[0].tolist())
            c = int(meta[q, 0])
            if c > k:
                continue  # overflow: superset property checked via fallback
            cand = set(meta[q, 1:1 + c].tolist())
            # (a) conservative f32 prefilter: candidates ⊇ exact matches
            assert want <= cand, (t, q, sorted(want - cand))

        full = find_under_from_fractions(nd, t)
        settled = settle_compacted_under(meta, nd_c, k, n, t)
        as_tuples = lambda rows: [
            [(m.index, m.distance, m.numerator, m.denominator) for m in r]
            for r in rows
        ]
        if settled is not None:
            # (b) compacted settle == full-spectrum epilogue, bit for bit
            assert as_tuples(settled) == as_tuples(full), t
        # (c) the shared orchestration equals the full path whether the
        # compacted attempt succeeded or overflowed into the fallback
        orch = orchestrate_find_under(
            n, b, t, None, k, lambda: nd,
            lambda t_hi_, k_: _compact_under_jit(jnp.asarray(nd), t_hi_, k=k_),
        )
        assert as_tuples(orch) == as_tuples(full), t

    def test_compaction_properties_random_spectra(self):
        from hypothesis import HealthCheck, given, settings
        from hypothesis import strategies as st

        # shapes drawn from a fixed palette so the jit cache is bounded
        @settings(max_examples=20, deadline=None,
                  suppress_health_check=[HealthCheck.too_slow])
        @given(seed=st.integers(0, 2**32 - 1),
               b=st.sampled_from([1, 3]),
               n=st.sampled_from([64, 257]),
               k_frac=st.sampled_from([0.05, 0.5, 1.0]))
        def prop(seed, b, n, k_frac):
            nd = self._spectrum(seed, b, n)
            k = max(1, int(n * k_frac))
            for t in self._thresholds(nd, seed):
                self._check_one(nd, t, k)

        prop()

    def test_compaction_properties_at_scale(self):
        """One deterministic pass at 10k+ entries,
        including a threshold exactly on the planted pile-up fraction and a
        compact_k small enough to force the overflow fallback."""
        nd = self._spectrum(99, 2, 16384)
        for t in self._thresholds(nd, 99) + [300 / 800]:
            self._check_one(nd, t, k=4096)   # normal compaction
            self._check_one(nd, t, k=64)     # likely overflow -> fallback
