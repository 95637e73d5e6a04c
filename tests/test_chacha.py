"""Pin the jittable ChaCha20 (ops/chacha.py) three ways: RFC 8439 test vector,
the `cryptography` package, and the native C++ core — then pin the share-row
generator against the share files `prepare`'s C++ path writes."""

import numpy as np
import pytest

from mpc_iris_tpu import native
from mpc_iris_tpu.ops import chacha


def test_rfc8439_keystream_vector():
    """RFC 8439 section 2.3.2 test vector (block counter 1)."""
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a00000000")
    got = chacha.keystream_bytes(key, 1, nonce, 64)
    want = bytes.fromhex(
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e"
    )
    assert got == want


def test_matches_cryptography_package():
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    key = bytes(range(1, 33))
    nonce12 = b"\x07" * 12
    counter = 5
    n = 1000
    got = chacha.keystream_bytes(key, counter, nonce12, n)
    full_nonce = counter.to_bytes(4, "little") + nonce12
    enc = Cipher(algorithms.ChaCha20(key, full_nonce), mode=None).encryptor()
    assert got == enc.update(b"\x00" * n)


def test_matches_native_core():
    key = bytes(range(2, 34))
    nonce12 = (123).to_bytes(4, "little") + (2**33 + 7).to_bytes(8, "little")
    got = chacha.keystream_bytes(key, 0, nonce12, 777)
    want = bytes(memoryview(native.chacha20_stream(key, 0, nonce12, 777)))
    assert got == want


def test_share_rows_match_prepared_files():
    """share_rows regenerates exactly the rows ic_share_split writes for
    shares s < n-1 (same key, any row offset)."""
    rng = np.random.default_rng(3)
    enc = rng.integers(0, 1 << 16, size=(5, 12800), dtype=np.uint16)
    key = native.derive_insecure_key(42)
    out = native.share_split(enc, 3, key, row_offset=7)  # shares 0,1 = PRF
    kw = chacha.key_words(key)
    for s in range(2):
        got = np.asarray(chacha.share_rows(kw, s, 7, 5))
        np.testing.assert_array_equal(got, out[s])
    # and the last share is NOT a pure stream (it carries the data)
    got2 = np.asarray(chacha.share_rows(kw, 2, 7, 5))
    assert not np.array_equal(got2, out[2])
    # reconstruction sanity: sum of all shares is the encoding
    np.testing.assert_array_equal(native.share_sum(list(out)), enc)


def test_share_rows_row_addressing_is_stable():
    """Row streams are independent of batching: one call for rows [3, 7) equals
    two calls for [3, 5) + [5, 7)."""
    kw = chacha.key_words(bytes(range(32)))
    whole = np.asarray(chacha.share_rows(kw, 1, 3, 4))
    a = np.asarray(chacha.share_rows(kw, 1, 3, 2))
    b = np.asarray(chacha.share_rows(kw, 1, 5, 2))
    np.testing.assert_array_equal(whole, np.concatenate([a, b]))


def test_keyed_engine_matches_file_engine():
    """KeyedShareEngine (DB regenerated on device from the key) produces
    bit-identical reply streams to ShareEngine over the prepared share file."""
    from mpc_iris_tpu.models import KeyedShareEngine, ShareEngine
    from mpc_iris_tpu.ops.encode import encode_template
    from mpc_iris_tpu.types import Template

    rng = np.random.default_rng(17)
    db = [Template.random(rng) for _ in range(21)]
    enc = np.stack([encode_template(t).data for t in db])
    key = native.derive_insecure_key(99)
    shares = native.share_split(enc, 3, key)  # [3, 21, 12800]

    q = Template.random(rng)
    qpat, qmsk = q.pattern.data[None], q.mask.data[None]
    for s in range(2):  # PRF-backed parties only (last share carries data)
        file_eng = ShareEngine(shares[s], chunk=8)
        keyed = KeyedShareEngine(key, s, count=21, chunk=8)
        assert keyed.resident_entries == 21  # default budget: all resident
        np.testing.assert_array_equal(
            keyed.dots(qpat, qmsk), file_eng.dots(qpat, qmsk)
        )
        np.testing.assert_array_equal(
            np.concatenate(list(keyed.stream(qpat, qmsk, entry_major=True))),
            np.concatenate(list(file_eng.stream(qpat, qmsk, entry_major=True))),
        )
        # resident-head + regenerated-tail split, and pure regen, both match
        head = KeyedShareEngine(key, s, 21, chunk=8, hbm_budget=2 * 12800 * 8)
        assert head.resident_entries == 8
        pure = KeyedShareEngine(key, s, 21, chunk=8, hbm_budget=0)
        assert pure.resident_entries == 0
        np.testing.assert_array_equal(
            head.dots(qpat, qmsk), file_eng.dots(qpat, qmsk)
        )
        np.testing.assert_array_equal(
            pure.dots(qpat, qmsk), file_eng.dots(qpat, qmsk)
        )


def test_keyed_fold_pass_matches_dots():
    """fold_pass_fn (single-dispatch bench pass) checksum == uint32 sum of the
    per-chunk dots stream, for pure-regen and resident+tail splits."""
    from mpc_iris_tpu.models import KeyedShareEngine
    from mpc_iris_tpu.models.engines import prepare_query_planes
    from mpc_iris_tpu.types import Template

    rng = np.random.default_rng(23)
    q = Template.random(rng)
    qpat, qmsk = q.pattern.data[None], q.mask.data[None]
    key = native.derive_insecure_key(7)
    # count chunk-aligned: the fused pass folds whole chunks (bench shapes).
    for budget in (None, 2 * 12800 * 8, 0):
        eng = KeyedShareEngine(key, 1, count=24, chunk=8, hbm_budget=budget)
        q_enc, _ = prepare_query_planes(qpat, qmsk)
        got = int(np.asarray(eng.fold_pass_fn()(q_enc)))
        want = int(eng.dots(qpat, qmsk).astype(np.uint32).sum() & 0xFFFFFFFF)
        assert got == want, (budget, got, want)


def test_keyed_batch_hint_scales_headroom(monkeypatch):
    """A larger batch_hint reserves more workspace headroom out of the
    default resident budget (engines.scan_workspace), and the engine stays
    bit-identical regardless of the resident split."""
    from mpc_iris_tpu.models import KeyedShareEngine
    from mpc_iris_tpu.models.engines import scan_workspace
    from mpc_iris_tpu.types import Template

    # Budget = the B=1 workspace + exactly 2 chunks of resident planes.
    monkeypatch.setenv(
        "MPC_IRIS_HBM_BUDGET", str(scan_workspace(1, 8) + 2 * (2 * 12800 * 8))
    )
    key = native.derive_insecure_key(11)
    small = KeyedShareEngine(key, 0, count=24, chunk=8, batch_hint=1)
    assert small.resident_entries == 16
    # 10 * 31 * batch_hint * chunk bytes of reply blocks evict the head.
    huge = KeyedShareEngine(key, 0, count=24, chunk=8, batch_hint=2**27)
    assert huge.resident_entries == 0

    rng = np.random.default_rng(5)
    q = Template.random(rng)
    qpat, qmsk = q.pattern.data[None], q.mask.data[None]
    np.testing.assert_array_equal(
        small.dots(qpat, qmsk), huge.dots(qpat, qmsk)
    )


def test_keyed_participant_protocol():
    """Full 3-party protocol where parties 0 and 1 are KEYED (no share files
    at all) and party 2 serves its file: winner == plaintext oracle."""
    import asyncio

    from mpc_iris_tpu.models import KeyedShareEngine, MasksEngine, ShareEngine
    from mpc_iris_tpu.ops.encode import encode_template
    from mpc_iris_tpu.protocol import Coordinator, ParticipantServer
    from mpc_iris_tpu.types import Template

    rng = np.random.default_rng(23)
    db = [Template.random(rng) for _ in range(17)]
    query = Template.random(rng)
    db[11] = query.rotated(-4)  # plant the winner
    enc = np.stack([encode_template(t).data for t in db])
    key = native.derive_insecure_key(7)
    shares = native.share_split(enc, 3, key)
    masks = np.stack([t.mask.data for t in db])

    async def go():
        servers = [
            ParticipantServer(KeyedShareEngine(key, 0, 17, chunk=8),
                              "127.0.0.1", 0),
            ParticipantServer(KeyedShareEngine(key, 1, 17, chunk=8),
                              "127.0.0.1", 0),
            ParticipantServer(ShareEngine(shares[2], chunk=8), "127.0.0.1", 0),
        ]
        addrs = [await s.start() for s in servers]
        coord = Coordinator(MasksEngine(masks, chunk=8), addrs)
        try:
            return await coord.query(query)
        finally:
            for s in servers:
                await s.close()

    outcome = asyncio.run(go())
    oracle = np.array([query.distance(t) for t in db])
    assert outcome.total == 17
    assert outcome.index == 11
    assert outcome.distance == oracle.min() == 0.0


def test_sharded_keyed_engine_matches_file(monkeypatch):
    """ShardedKeyedShareEngine: every shard regenerates its rows on device;
    results equal the single-chip file-based engine over the prepared file."""
    import jax

    from mpc_iris_tpu.models import ShareEngine
    from mpc_iris_tpu.ops.encode import encode_template
    from mpc_iris_tpu.parallel import ShardedKeyedShareEngine, make_mesh
    from mpc_iris_tpu.types import Template

    rng = np.random.default_rng(31)
    db = [Template.random(rng) for _ in range(21)]  # ragged vs 4x8 blocks
    enc = np.stack([encode_template(t).data for t in db])
    key = native.derive_insecure_key(5)
    shares = native.share_split(enc, 2, key)

    mesh = make_mesh(db=4, batch=2)
    keyed = ShardedKeyedShareEngine(key, 0, 21, mesh, chunk=4)
    q = Template.random(rng)
    qpat, qmsk = q.pattern.data[None], q.mask.data[None]
    want = ShareEngine(shares[0], chunk=4).dots(qpat, qmsk)
    np.testing.assert_array_equal(keyed.dots(qpat, qmsk), want)

    # High stream ids (>= 2^31, admitted by check_stream_id) must survive
    # the shard_map closure/trace path too (cf. the engine-level uint32
    # regression in test_engines.py).
    sid = 0x80000001
    kw = chacha.key_words(key)
    rows = np.asarray(chacha.share_rows(kw, sid, 0, 21))
    hi_keyed = ShardedKeyedShareEngine(key, sid, 21, mesh, chunk=4)
    np.testing.assert_array_equal(
        hi_keyed.dots(qpat, qmsk), ShareEngine(rows, chunk=4).dots(qpat, qmsk)
    )


def test_sharded_keyed_fold_pass_matches_single_chip():
    """Sharded fold_pass_fn (scan per shard + psum over "db") == the
    single-chip KeyedShareEngine fold == uint32 sum of the dots stream,
    for a chunk-and-mesh-aligned count (the fused passes fold whole chunks)."""
    from mpc_iris_tpu.models import KeyedShareEngine
    from mpc_iris_tpu.models.engines import prepare_query_planes
    from mpc_iris_tpu.parallel import ShardedKeyedShareEngine, make_mesh
    from mpc_iris_tpu.types import Template

    rng = np.random.default_rng(37)
    q = Template.random(rng)
    qpat, qmsk = q.pattern.data[None], q.mask.data[None]
    key = native.derive_insecure_key(11)
    count = 32  # 4 shards x 2 global blocks x chunk 4

    mesh = make_mesh(db=4, batch=2)
    sharded = ShardedKeyedShareEngine(key, 0, count, mesh, chunk=4)
    single = KeyedShareEngine(key, 0, count, chunk=4)
    q_enc, _ = prepare_query_planes(qpat, qmsk)

    got_sharded = int(np.asarray(sharded.fold_pass_fn()(q_enc)))
    got_single = int(np.asarray(single.fold_pass_fn()(q_enc)))
    want = int(single.dots(qpat, qmsk).astype(np.uint32).sum() & 0xFFFFFFFF)
    assert got_sharded == got_single == want


def test_fold_pass_rejects_ragged_counts():
    """fold_pass_fn folds whole chunks; a count that is not chunk-aligned
    (single-chip) or chunk*n_shards-aligned (sharded) must raise instead of
    silently folding phantom padding rows into the checksum."""
    from mpc_iris_tpu.models import KeyedShareEngine
    from mpc_iris_tpu.parallel import ShardedKeyedShareEngine, make_mesh

    key = native.derive_insecure_key(17)
    with pytest.raises(ValueError, match="phantom"):
        KeyedShareEngine(key, 0, count=21, chunk=8).fold_pass_fn()
    mesh = make_mesh(db=4, batch=2)
    with pytest.raises(ValueError, match="phantom"):
        ShardedKeyedShareEngine(key, 0, 36, mesh, chunk=4).fold_pass_fn()


def test_keyed_share_view_matches_file(tmp_path):
    """cli._KeyedShareView (host-side lazy keyed share for decrypt) slices
    bit-identical rows to the prepared share file."""
    from mpc_iris_tpu.cli import _KeyedShareView
    from mpc_iris_tpu.io.formats import open_share, write_share

    rng = np.random.default_rng(41)
    enc = rng.integers(0, 1 << 16, size=(9, 12800), dtype=np.uint16)
    key = native.derive_insecure_key(13)
    out = native.share_split(enc, 2, key)
    p = tmp_path / "mpc.share-0"
    write_share(p, out[0])
    view = _KeyedShareView(key, 0, 9)
    file = open_share(p)
    np.testing.assert_array_equal(view[0:9], np.asarray(file[0:9]))
    np.testing.assert_array_equal(view[3:7], np.asarray(file[3:7]))


def test_natural_planes_are_permuted_file_planes():
    """share_planes_natural == shares_to_planes(file rows) under
    k_permutation, and pi is a true permutation of [0, 12800)."""
    import jax.numpy as jnp

    from mpc_iris_tpu.ops.dot import shares_to_planes

    pi = chacha.k_permutation()
    assert sorted(pi.tolist()) == list(range(12800))

    kw = chacha.key_words(bytes(range(32)))
    rows = np.asarray(chacha.share_rows(jnp.asarray(kw), 2, 5, 3))
    lo_f, hi_f = (np.asarray(x) for x in shares_to_planes(rows))
    lo_n, hi_n = (np.asarray(x) for x in
                  chacha.share_planes_natural(jnp.asarray(kw), 2, 5, 3))
    np.testing.assert_array_equal(lo_n, lo_f[:, pi])
    np.testing.assert_array_equal(hi_n, hi_f[:, pi])


def test_stream_id_validation():
    """Negative / rerandomize-reserved stream ids are rejected everywhere
    (they would silently wrap to a wrong-but-well-formed keystream)."""
    from mpc_iris_tpu.cli import _KeyedShareView
    from mpc_iris_tpu.models import KeyedShareEngine

    key = bytes(32)
    for bad in (-1, 0xFFFFFFFF, 2**40):
        with pytest.raises(ValueError, match="stream id"):
            KeyedShareEngine(key, bad, 16)
        with pytest.raises(ValueError, match="stream id"):
            _KeyedShareView(key, bad, 16)


def test_parse_keyed_spec_errors(tmp_path):
    from mpc_iris_tpu.cli import parse_keyed_spec

    kp = tmp_path / "k"
    kp.write_text(bytes(range(32)).hex())
    sid, count, key = parse_keyed_spec(f"keyed:1:4k:{kp}")
    assert (sid, count, key) == (1, 4000, bytes(range(32)))  # SI: 4k = 4000
    for bad in ("keyed:1:10", "keyed:-1:10:" + str(kp),
                "keyed:1:bogus:" + str(kp), "keyed:1:10:/nonexistent"):
        with pytest.raises(ValueError, match="keyed share spec"):
            parse_keyed_spec(bad)
    short = tmp_path / "short"
    short.write_text("aabb")
    with pytest.raises(ValueError, match="keyed share spec"):
        parse_keyed_spec(f"keyed:1:10:{short}")


@pytest.mark.parametrize("row0", [
    0xFFFFFF80,  # reaches 0xFFFFFFFF exactly; no wrap (carry stays 0)
    0xFFFFFFC0,  # the 65th row wraps past 2^32 (carry = 1 from there on)
    0xFFFFFFF0,  # wrap after 16 rows
])
def test_natural_planes_match_host_chacha(row0):
    """The XLA natural-plane emitter (the keyed engines' regeneration path)
    matches the host ChaCha20 (native.chacha20_stream) bit for bit, after
    the k_permutation and the -128 plane offset — with key words whose high
    bit is set, the max valid uint32 stream id (>= 2^31, which a naive int32
    conversion rejects), and the u64-nonce carry at none, a late and an
    early row."""
    import jax.numpy as jnp

    key = native.derive_insecure_key(12345)  # sha256 bytes: high bits set
    assert any(b & 0x80 for b in key[3::4])  # ensure the wrap path is real
    kw = jnp.asarray(chacha.key_words(key))
    sid = 0xFFFFFFFE  # max valid share stream id (SPEC §4.1)
    n = 128
    lo, hi = chacha.share_planes_natural(kw, np.uint32(sid), np.uint32(row0), n)
    perm = chacha.k_permutation()
    for i in range(n):
        row = row0 + i  # may pass 2^32: the nonce carries into R_hi
        nonce = sid.to_bytes(4, "little") + row.to_bytes(8, "little")
        s = np.frombuffer(native.chacha20_stream(key, 0, nonce, 2 * 12800),
                          "<u2")[perm]
        np.testing.assert_array_equal(
            np.asarray(lo[i]), ((s & 0xFF).astype(np.int16) - 128).astype(np.int8))
        np.testing.assert_array_equal(
            np.asarray(hi[i]), ((s >> 8).astype(np.int16) - 128).astype(np.int8))
