"""L2 engine tests: fused plaintext match vs the scalar oracle, participant/coordinator
engine parity, and the N-party share-sum linearity that underpins the MPC protocol
(the reference pins this end-to-end in test_encrypted_distances, src/lib.rs:165-193)."""

import numpy as np
import pytest

from mpc_iris_tpu.constants import BITS_BYTES, N_ROTATIONS
from mpc_iris_tpu.models import MasksEngine, PlaintextEngine, ShareEngine
from mpc_iris_tpu.models.engines import prepare_query_planes
from mpc_iris_tpu.ops.decode import decode_distance_batch_np
from mpc_iris_tpu.ops.encode import encode_template
from mpc_iris_tpu.types import Bits, EncodedBits, Template


def make_db(rng, n, base_templates=None):
    """Random templates, some derived from bases by rotation+noise so matches exist."""
    out = []
    for i in range(n):
        if base_templates and i % 3 == 0:
            base = base_templates[i % len(base_templates)]
            t = base.rotated(int(rng.integers(-15, 16)))
            # flip ~2% of pattern bits
            noise = rng.random(BITS_BYTES * 8) < 0.02
            flipped = np.unpackbits(t.pattern.data, bitorder="little") ^ noise
            t = Template(
                Bits(np.packbits(flipped, bitorder="little")), Bits(t.mask.data)
            )
            out.append(t)
        else:
            out.append(Template.random(rng))
    return out


def packed(templates):
    pat = np.stack([t.pattern.data for t in templates])
    msk = np.stack([t.mask.data for t in templates])
    return pat, msk


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    queries = [Template.random(rng) for _ in range(2)]
    db = make_db(rng, 37, queries)
    return rng, queries, db


class TestPlaintextEngine:
    def test_distances_match_oracle(self, setup):
        rng, queries, db = setup
        eng = PlaintextEngine(*packed(db), chunk=16)  # force multi-chunk + padding
        dists = eng.distances(*packed(queries))
        assert dists.shape == (2, len(db))
        for qi, q in enumerate(queries):
            for di in (0, 3, 9, 17, 36):
                expect = q.distance(db[di])
                assert dists[qi, di] == expect, (qi, di)

    def test_match_is_argmin_of_oracle(self, setup):
        rng, queries, db = setup
        eng = PlaintextEngine(*packed(db), chunk=16)
        results = eng.match(*packed(queries))
        for qi, q in enumerate(queries):
            oracle = np.array([q.distance(e) for e in db])
            r = results[qi]
            assert r.index == int(np.argmin(oracle))
            assert r.distance == oracle.min()
            # reported value is the f64 of the winning integer pair
            assert r.distance == r.numerator / r.denominator

    def test_padding_never_wins(self, rng):
        """d=0 padding entries must lose to any real entry."""
        t = Template.random(rng)
        db = [t]  # N=1, padded to chunk size
        eng = PlaintextEngine(*packed(db), chunk=128)
        r = eng.match(*packed([t]))[0]
        assert r.index == 0 and r.distance == 0.0

    def test_single_query_single_entry(self, rng):
        a, b = Template.random(rng), Template.random(rng)
        eng = PlaintextEngine(*packed([b]), chunk=128)
        r = eng.match(*packed([a]))[0]
        assert r.distance == a.distance(b)


class TestShareMasksEngines:
    def test_mpc_reconstruction_matches_plaintext(self, setup):
        """N-party protocol algebra: sum of per-party dot shares == plaintext dot;
        decode reproduces the oracle distance (src/lib.rs:165-193 equivalence)."""
        rng, queries, db = setup
        n_parties = 3
        enc_db = [encode_template(t) for t in db]
        share_mats = [
            np.zeros((len(db), enc_db[0].data.size), dtype=np.uint16)
            for _ in range(n_parties)
        ]
        for i, e in enumerate(enc_db):
            for p, s in enumerate(e.share(n_parties, rng)):
                share_mats[p][i] = s.data

        engines = [ShareEngine(m, chunk=16) for m in share_mats]
        masks_eng = MasksEngine(np.stack([t.mask.data for t in db]), chunk=16)

        qpat, qmsk = packed(queries)
        dots = sum(
            e.dots(qpat, qmsk).astype(np.int64) for e in engines
        ) & 0xFFFF  # wrapping sum of u16 shares (src/main.rs:603-608)
        dens = masks_eng.dots(qmsk)
        assert dots.shape == (2, len(db), N_ROTATIONS)
        assert dens.shape == (2, len(db), N_ROTATIONS)

        for qi, q in enumerate(queries):
            dist = decode_distance_batch_np(
                dots[qi].astype(np.uint16), dens[qi].astype(np.uint16)
            )
            oracle = np.array([q.distance(e) for e in db])
            np.testing.assert_array_equal(dist, oracle)

    def test_share_dots_equal_direct_dot(self, setup):
        """Participant engine output == EncodedBits.dot of rotated query vs share."""
        rng, queries, db = setup
        share = np.stack([EncodedBits.random(rng).data for _ in range(5)])
        eng = ShareEngine(share, chunk=128)
        q = queries[0]
        out = eng.dots(*packed([q]))[0]  # [5, 31]
        enc_q = encode_template(q)
        for r_idx, r in enumerate(range(-15, 16)):
            rot = enc_q.rotated(r)
            for e_idx in range(5):
                assert out[e_idx, r_idx] == rot.dot(EncodedBits(share[e_idx])), (
                    e_idx,
                    r,
                )

    def test_masks_dots_equal_direct_dot(self, setup):
        rng, queries, db = setup
        eng = MasksEngine(np.stack([t.mask.data for t in db[:5]]), chunk=128)
        q = queries[0]
        out = eng.dots(np.stack([q.mask.data]))[0]
        for r_idx, r in enumerate(range(-15, 16)):
            rot = q.mask.rotated(r)
            for e_idx in range(5):
                assert out[e_idx, r_idx] == rot.dot(db[e_idx].mask)

    def test_stream_equals_bulk(self, setup):
        rng, queries, db = setup
        share = np.stack([EncodedBits.random(rng).data for _ in range(21)])
        eng = ShareEngine(share, chunk=8)
        qpat, qmsk = packed(queries)
        bulk = eng.dots(qpat, qmsk)
        streamed = np.concatenate(list(eng.stream(qpat, qmsk)), axis=1)
        assert streamed.shape == bulk.shape  # padding trimmed
        np.testing.assert_array_equal(streamed, bulk)

    def test_out_of_core_share_engine_matches_resident(self, setup):
        """DB-larger-than-HBM path: with a budget that pins only one chunk
        resident, the remaining chunks stream host->device per query batch
        with bit-identical results (== the reference's mmap-streaming
        participant, src/main.rs:386-400)."""
        rng, queries, db = setup
        share = np.stack([EncodedBits.random(rng).data for _ in range(21)])
        resident = ShareEngine(share, chunk=8)
        # budget for exactly one 8-entry chunk of lo/hi planes
        ooc = ShareEngine(share, chunk=8, hbm_budget=2 * 12800 * 8)
        assert ooc.resident_entries == 8 and resident.resident_entries == 21
        qpat, qmsk = packed(queries)
        np.testing.assert_array_equal(
            ooc.dots(qpat, qmsk), resident.dots(qpat, qmsk)
        )
        np.testing.assert_array_equal(
            np.concatenate(list(ooc.stream(qpat, qmsk, entry_major=True)), axis=0),
            np.concatenate(list(resident.stream(qpat, qmsk, entry_major=True)),
                           axis=0),
        )
        # zero-resident (pure streaming) also works; an EXPLICIT budget is
        # the caller's exact accounting, so prefetch (which would add a
        # second raw-chunk HBM transient) must stay off for it
        pure = ShareEngine(share, chunk=8, hbm_budget=0)
        assert pure.resident_entries == 0
        np.testing.assert_array_equal(
            pure.dots(qpat, qmsk), resident.dots(qpat, qmsk)
        )
        assert not pure._prefetch

    def test_ooc_prefetch_default_budget(self, setup, monkeypatch):
        """Under the DEFAULT budget policy (which reserves the second
        raw-chunk transient) sequential scans run through the prefetch
        worker with bit-identical results; MPC_IRIS_NO_OOC_PREFETCH=1
        disables it; random access evicts stale futures."""
        from mpc_iris_tpu.models import engines as engines_mod

        rng, queries, db = setup
        share = np.stack([EncodedBits.random(rng).data for _ in range(21)])
        qpat, qmsk = packed(queries)
        resident = ShareEngine(share, chunk=8)
        # tiny DEFAULT budget (env, not explicit arg) -> 0 resident, OOC
        monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", "1")
        eng = ShareEngine(share, chunk=8)
        assert eng.resident_entries == 0 and not eng._explicit_budget
        np.testing.assert_array_equal(
            eng.dots(qpat, qmsk), resident.dots(qpat, qmsk)
        )
        assert engines_mod._OOC_POOL is not None  # worker engaged
        monkeypatch.setenv("MPC_IRIS_NO_OOC_PREFETCH", "1")
        nopf = ShareEngine(share, chunk=8)
        np.testing.assert_array_equal(
            nopf.dots(qpat, qmsk), resident.dots(qpat, qmsk)
        )
        assert not nopf._prefetch
        monkeypatch.delenv("MPC_IRIS_NO_OOC_PREFETCH")
        # random chunk access after a sequential pass: stale prefetches are
        # evicted, results stay identical
        q_enc = prepare_query_planes(qpat, qmsk)[0]
        np.testing.assert_array_equal(
            np.asarray(eng.dots_chunk(q_enc, 2)),
            np.asarray(resident.dots_chunk(q_enc, 2)),
        )
        assert set(eng._prefetch) <= {3}

    def test_ooc_prefetch_invalidated_by_refresh(self, setup, monkeypatch):
        """A prefetched PADDED tail chunk must not leak pre-growth zeros
        into a post-growth scan: refresh() bumps the epoch and clears the
        cache atomically with the source swap."""
        rng, queries, db = setup
        share = np.stack([EncodedBits.random(rng).data for _ in range(21)])
        grown = np.concatenate(
            [share, np.stack([EncodedBits.random(rng).data for _ in range(3)])]
        )
        qpat, qmsk = packed(queries)
        monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", "1")
        eng = ShareEngine(share[:21], chunk=8)
        q_enc = prepare_query_planes(qpat, qmsk)[0]
        # Touch chunk 1 -> schedules a prefetch of chunk 2 (the padded tail)
        np.asarray(eng.dots_chunk(q_enc, 1))
        assert 2 in eng._prefetch
        epoch_before = eng._prefetch_epoch
        eng.refresh(grown)
        assert not eng._prefetch  # stale padded-tail future dropped
        assert eng._prefetch_epoch == epoch_before + 1
        fresh = ShareEngine(grown, chunk=8)
        np.testing.assert_array_equal(
            eng.dots(qpat, qmsk), fresh.dots(qpat, qmsk)
        )

    def test_masks_stream_equals_bulk(self, setup):
        rng, queries, db = setup
        eng = MasksEngine(np.stack([t.mask.data for t in db]), chunk=8)
        _, qmsk = packed(queries)
        bulk = eng.dots(qmsk)
        streamed = np.concatenate(list(eng.stream(qmsk)), axis=1)
        np.testing.assert_array_equal(streamed, bulk)


def test_packed_storage_matches_dense(rng):
    """storage='packed' (bit-packed HBM + on-device unpack) == dense results."""
    from mpc_iris_tpu.models.engines import PlaintextEngine

    qpat = rng.integers(0, 256, (3, 1600), dtype=np.uint8)
    qmsk = rng.integers(0, 256, (3, 1600), dtype=np.uint8)
    dpat = rng.integers(0, 256, (37, 1600), dtype=np.uint8)
    dmsk = rng.integers(0, 256, (37, 1600), dtype=np.uint8)
    dense = PlaintextEngine(dpat, dmsk, chunk=16, storage="dense")
    packed = PlaintextEngine(dpat, dmsk, chunk=16, storage="packed")
    rd = dense.match(qpat, qmsk)
    rp = packed.match(qpat, qmsk)
    for a, b in zip(rd, rp):
        assert (a.index, a.numerator, a.denominator) == (b.index, b.numerator, b.denominator)
        assert a.distance == b.distance


def test_packed_storage_fused_path(rng):
    """Packed storage (on-device unpack per chunk) == dense storage at B=8."""
    from mpc_iris_tpu.models.engines import PlaintextEngine

    qpat = rng.integers(0, 256, (8, 1600), dtype=np.uint8)
    qmsk = rng.integers(0, 256, (8, 1600), dtype=np.uint8)
    dpat = rng.integers(0, 256, (2048, 1600), dtype=np.uint8)
    dmsk = rng.integers(0, 256, (2048, 1600), dtype=np.uint8)
    dense = PlaintextEngine(dpat, dmsk, chunk=2048, storage="dense")
    packed = PlaintextEngine(dpat, dmsk, chunk=2048, storage="packed")
    rd = dense.match(qpat, qmsk)
    rp = packed.match(qpat, qmsk)
    for a, b in zip(rd, rp):
        assert (a.index, a.distance) == (b.index, b.distance)


def test_masks_engine_packed_matches_dense(rng):
    from mpc_iris_tpu.models.engines import MasksEngine

    qmsk = rng.integers(0, 256, (2, 1600), dtype=np.uint8)
    dmsk = rng.integers(0, 256, (33, 1600), dtype=np.uint8)
    dense = MasksEngine(dmsk, chunk=16, storage="dense")
    packed = MasksEngine(dmsk, chunk=16, storage="packed")
    np.testing.assert_array_equal(dense.dots(qmsk), packed.dots(qmsk))


def test_out_of_core_default_budget_reserves_stream_headroom(monkeypatch):
    """Regression: in out-of-core mode the DEFAULT budget must reserve the
    streamed-chunk transient (u16 chunk + planes + B-scaled dot/reply
    blocks) out of the resident head — filling the whole budget with
    resident planes OOMs at the first streamed dots_chunk on real HBM. An
    explicit hbm_budget remains the caller's exact resident-plane budget."""
    from mpc_iris_tpu.models.engines import ShareEngine

    rng = np.random.default_rng(5)
    share = rng.integers(0, 1 << 16, size=(1024, 12800), dtype=np.uint16)
    plane_bytes = 2 * 12800 * 128  # one 128-entry chunk of lo/hi planes
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", str(5 * plane_bytes))
    eng = ShareEngine(share, chunk=128, batch_hint=8)
    # 5 chunks' budget minus the transient: (4*12800 + 10*31*8)*128 bytes
    # (TWO raw u16 chunks — computing + prefetched — plus B-scaled blocks)
    # = ~2.1 plane-chunks -> 2 resident of 8, NOT 5.
    assert eng._n_resident == 2
    # all-resident DBs are unaffected by the headroom rule
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", str(8 * plane_bytes))
    assert ShareEngine(share, chunk=128, batch_hint=8)._n_resident == 8
    # explicit budget: exact resident-plane accounting, no reservation
    assert ShareEngine(share, chunk=128,
                       hbm_budget=5 * plane_bytes)._n_resident == 5


def test_keyed_engine_high_stream_id():
    """Regression: stream ids in [2^31, 2^32-2] — admitted by
    check_stream_id — must cross the jit boundary as uint32 (a raw Python
    int overflowed the default int32 conversion with OverflowError)."""
    from mpc_iris_tpu import native
    from mpc_iris_tpu.models import KeyedShareEngine, ShareEngine
    from mpc_iris_tpu.ops import chacha

    key = bytes(range(32))
    sid = 0x80000000
    kw = chacha.key_words(key)
    rows = np.asarray(chacha.share_rows(kw, sid, 0, 12))
    keyed = KeyedShareEngine(key, sid, count=12, chunk=8)
    file_eng = ShareEngine(rows, chunk=8)
    rng = np.random.default_rng(1)
    q = Template.random(rng)
    qpat, qmsk = q.pattern.data[None], q.mask.data[None]
    np.testing.assert_array_equal(
        keyed.dots(qpat, qmsk), file_eng.dots(qpat, qmsk)
    )


def test_keyed_fold_pass_segmented_matches_single():
    """fold_pass_fn(segments=S) must produce the SAME uint32 checksum as the
    single dispatch for every split — including segments that straddle or lie
    entirely inside the resident head — since uint32 addition is associative
    mod 2^32. (Segmentation bounds the device time of each dispatch.)"""
    from mpc_iris_tpu.models import KeyedShareEngine
    from mpc_iris_tpu.models.engines import prepare_query_planes

    key = bytes(range(1, 33))
    count, chunk = 6 * 128, 128  # 6 whole chunks
    plane_bytes = 2 * 12_800 * chunk
    rng = np.random.default_rng(7)
    qpat = rng.integers(0, 256, (2, 1600), dtype=np.uint8)
    qmsk = rng.integers(0, 256, (2, 1600), dtype=np.uint8)
    q_enc, _ = prepare_query_planes(qpat, qmsk)
    q_enc = np.asarray(q_enc)

    # 3 resident chunks + 3 regenerated tail chunks
    eng = KeyedShareEngine(key, 5, count, chunk=chunk,
                           hbm_budget=3 * plane_bytes)
    assert eng._n_resident == 3
    whole = int(eng.fold_pass_fn()(q_enc))
    for segments in (2, 3, 4, 6, 99):
        got = int(eng.fold_pass_fn(segments=segments)(q_enc))
        assert got == whole, (segments, got, whole)
