"""Cross-implementation byte-interop vectors.

No byte produced by the Rust reference binary is available in this
environment, so this module pins interop the next-strongest way: every
``_spec_*`` helper below is an INDEPENDENT from-scratch implementation of the
reference's byte semantics, written in plain Python ints directly against the
cited reference lines, importing nothing from ``mpc_iris_tpu``. The fixture
files/wire bytes are hand-constructed from closed-form byte formulas, and the
expected values the spec implementation produces are additionally FROZEN as
literals in this file — so the repo code, the spec implementation, and the
frozen vectors must all agree three ways. Any byte-layout drift in the repo's
readers, writers, engines or wire breaks this file.

Reference byte semantics implemented here:
- Bits: 1600 bytes; bit i at byte i//8, bit i%8 LSB-first
  (src/bits.rs:44-57, pinned by the reference's own test_index
  src/bits.rs:219-232); 64 rows x 200 cols; 25 bytes per row.
- Bits rotation: per 25-byte row, row-bit p -> (p + r) mod 200
  (src/bits.rs:17-28,178-205: positive amounts byte-rotate right +
  bit-shift left with carry chain == +r bit rotation).
- EncodedBits: 12,800 u16 little-endian (Pod cast, src/main.rs:338,428);
  rotation per 200-u16 row, index i -> (i + r) mod 200
  (src/encoded_bits.rs:40-57).
- encode(): pattern &= mask; enc = mask - 2*pattern mod 2^16, giving
  {1, 0, 0xFFFF} for unset/masked/set (src/lib.rs:15-26).
- dot_u16: wrapping sum of wrapping products mod 2^16
  (src/arch/generic.rs:11-16); dot_bool: popcount of AND
  (src/arch/generic.rs:4-9).
- Distance record: [dot(rot(enc(q), r), entry) for r in -15..=15]
  (src/lib.rs:28-52); denominator record likewise over mask Bits
  (src/lib.rs:55-80).
- decode_distance: min over rotations of ((d - n) mod 2^16 / 2) / d as f64,
  d == 0 contributing NaN which f64::min skips (src/lib.rs:96-107).
- Files: masks = concatenated raw Bits, share-i = concatenated raw
  EncodedBits (src/main.rs:294-309,338); wire query = pattern||mask raw
  Template (src/main.rs:417-420); reply = [u16; 31] LE records in DB order
  (src/main.rs:428-445).
"""

import asyncio

import numpy as np
import pytest

BITS = 12_800
COLS = 200
ROWS = 64
ROW_BYTES = COLS // 8  # 25


# --------------------------------------------------------------- spec impl
# Plain-int reimplementation of the reference semantics. Deliberately slow and
# simple; shares no code with mpc_iris_tpu.


def _spec_bit(raw: bytes, i: int) -> int:
    return (raw[i // 8] >> (i % 8)) & 1


def _spec_bits_from_bools(bools) -> bytes:
    out = bytearray(BITS // 8)
    for i, b in enumerate(bools):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def _spec_rotate_bits(raw: bytes, r: int) -> bytes:
    bools = [0] * BITS
    for row in range(ROWS):
        for p in range(COLS):
            src = row * COLS + p
            dst = row * COLS + (p + r) % COLS
            bools[dst] = _spec_bit(raw, src)
    return _spec_bits_from_bools(bools)


def _spec_encode(pattern: bytes, mask: bytes) -> list:
    enc = []
    for i in range(BITS):
        m = _spec_bit(mask, i)
        p = _spec_bit(pattern, i) & m
        enc.append((m - 2 * p) % 65536)
    return enc


def _spec_rotate_encoded(enc: list, r: int) -> list:
    out = [0] * BITS
    for row in range(ROWS):
        for i in range(COLS):
            out[row * COLS + (i + r) % COLS] = enc[row * COLS + i]
    return out


def _spec_dot_u16(a: list, b: list) -> int:
    acc = 0
    for x, y in zip(a, b):
        acc = (acc + x * y) % 65536
    return acc


def _spec_dot_bool(a: bytes, b: bytes) -> int:
    return sum(bin(x & y).count("1") for x, y in zip(a, b)) % 65536


def _spec_distance_record(q_pattern: bytes, q_mask: bytes, entry_enc: list):
    q_enc = _spec_encode(q_pattern, q_mask)
    return [_spec_dot_u16(_spec_rotate_encoded(q_enc, r), entry_enc)
            for r in range(-15, 16)]


def _spec_denominator_record(q_mask: bytes, e_mask: bytes):
    return [_spec_dot_bool(_spec_rotate_bits(q_mask, r), e_mask)
            for r in range(-15, 16)]


def _spec_decode(dists, dens) -> float:
    best = float("inf")
    for n, d in zip(dists, dens):
        if d == 0:
            continue  # n/0 -> NaN; f64::min skips NaN (src/lib.rs:105)
        best = min(best, ((d - n) % 65536) // 2 / d)
    return best


# ------------------------------------------------------------ fixture bytes
# Closed-form byte formulas — dense, irregular, and independent of any RNG.


def fx_pattern(e: int) -> bytes:
    return bytes((37 * e + 11 * j + 5) % 256 for j in range(BITS // 8))


def fx_mask(e: int) -> bytes:
    # Mostly-set masks with entry-dependent holes (masked-out bits exercise
    # the 0 lanes of the encoding).
    return bytes(255 - ((j * (e + 3)) % 7 == 0) * (1 << (j % 8))
                 for j in range(BITS // 8))


def fx_share0(e: int) -> list:
    return [(12_345 * e + 7 * i + 1) % 65536 for i in range(BITS)]


N_ENTRIES = 8
QUERY_PATTERN = fx_pattern(9)
QUERY_MASK = fx_mask(9)

# ------------------------------------------------------ frozen known answers
# Produced once by the spec implementation above and frozen; guards both the
# repo and the spec impl against silent drift. Entry 1's full distance and
# denominator records for the fixture query, plus the decoded distances of all
# four entries.
FROZEN_DIST_RECORD_E1 = [
    64, 20, 65522, 65500, 4, 30, 65432, 62662, 6, 50, 10, 16, 12, 65474, 58,
    2559, 66, 65472, 6, 65532, 65528, 48, 6, 64468, 65436, 66, 32, 30, 18,
    65506, 36,
]
FROZEN_DEN_RECORD_E1 = [
    12342, 12342, 12342, 12342, 12342, 12342, 12342, 12342, 12342, 12342,
    12342, 12342, 12342, 12342, 12342, 12571, 12342, 12342, 12342, 12342,
    12342, 12342, 12342, 12342, 12342, 12342, 12342, 12342, 12342, 12342,
    12342,
]
FROZEN_DISTANCES = [
    0.43550478042456653, 0.3982181210723093, 0.2532004537352131,
    0.4519926815686898, 0.4224569711319552, 0.49659698590179874,
    0.48152649489547883, 0.437773456490034,
]


@pytest.fixture(scope="module")
def spec_world():
    """Per-entry spec-side data: encodings, share pairs, expected records."""
    entries = []
    for e in range(N_ENTRIES):
        pat, msk = fx_pattern(e), fx_mask(e)
        enc = _spec_encode(pat, msk)
        s0 = fx_share0(e)
        s1 = [(v - w) % 65536 for v, w in zip(enc, s0)]
        entries.append({
            "pattern": pat, "mask": msk, "enc": enc, "s0": s0, "s1": s1,
            "dists": _spec_distance_record(QUERY_PATTERN, QUERY_MASK, enc),
            "dens": _spec_denominator_record(QUERY_MASK, msk),
        })
    return entries


def _u16s_to_le_bytes(vals) -> bytes:
    return b"".join(int(v).to_bytes(2, "little") for v in vals)


class TestFrozenVectors:
    """The spec implementation must reproduce its own frozen literals."""

    def test_records_frozen(self, spec_world):
        assert spec_world[1]["dists"] == FROZEN_DIST_RECORD_E1
        assert spec_world[1]["dens"] == FROZEN_DEN_RECORD_E1

    def test_decoded_distances_frozen(self, spec_world):
        got = [_spec_decode(e["dists"], e["dens"]) for e in spec_world]
        assert got == FROZEN_DISTANCES


class TestTypesAgainstSpec:
    def test_bits_indexing_and_rotation(self):
        from mpc_iris_tpu.types import Bits

        raw = fx_pattern(2)
        b = Bits.from_bytes(raw)
        assert b.to_bytes() == raw
        arr = np.unpackbits(
            np.frombuffer(raw, np.uint8), bitorder="little"
        )
        for i in (0, 1, 7, 8, 63, 64, 199, 200, 12_799):
            assert int(arr[i]) == _spec_bit(raw, i)
        for r in (-15, -8, -1, 0, 1, 7, 8, 15):
            assert b.rotated(r).to_bytes() == _spec_rotate_bits(raw, r)

    def test_encoded_rotation_and_encode(self):
        from mpc_iris_tpu.ops.encode import encode_template
        from mpc_iris_tpu.types import EncodedBits, Template

        pat, msk = fx_pattern(0), fx_mask(0)
        t = Template.from_bytes(pat + msk)
        enc = encode_template(t)
        assert enc.data.tolist() == _spec_encode(pat, msk)
        eb = EncodedBits.from_bytes(_u16s_to_le_bytes(enc.data))
        for r in (-15, -3, 0, 4, 15):
            assert eb.rotated(r).data.tolist() == _spec_rotate_encoded(
                _spec_encode(pat, msk), r
            )

    def test_template_wire_bytes(self):
        """Wire query = raw pattern||mask (src/main.rs:417-420; #[repr(C)]
        field order src/template.rs:26-29)."""
        from mpc_iris_tpu.types import Template

        raw = QUERY_PATTERN + QUERY_MASK
        t = Template.from_bytes(raw)
        assert t.to_bytes() == raw
        assert t.pattern.to_bytes() == QUERY_PATTERN
        assert t.mask.to_bytes() == QUERY_MASK


class TestFilesAgainstSpec:
    def test_masks_file(self, spec_world, tmp_path):
        from mpc_iris_tpu.io.formats import open_masks, write_masks

        path = tmp_path / "mpc.masks"
        path.write_bytes(b"".join(e["mask"] for e in spec_world))
        masks = open_masks(path)
        assert masks.shape == (N_ENTRIES, 1600)
        for e, row in zip(spec_world, masks):
            assert row.tobytes() == e["mask"]
        # writer round-trips the same bytes
        out = tmp_path / "rt.masks"
        write_masks(out, np.asarray(masks))
        assert out.read_bytes() == path.read_bytes()

    def test_share_files_reconstruct(self, spec_world, tmp_path):
        from mpc_iris_tpu import native
        from mpc_iris_tpu.io.formats import open_share, write_share

        p0, p1 = tmp_path / "mpc.share-0", tmp_path / "mpc.share-1"
        p0.write_bytes(b"".join(_u16s_to_le_bytes(e["s0"]) for e in spec_world))
        p1.write_bytes(b"".join(_u16s_to_le_bytes(e["s1"]) for e in spec_world))
        s0, s1 = open_share(p0), open_share(p1)
        assert s0.shape == s1.shape == (N_ENTRIES, BITS)
        total = native.share_sum([np.asarray(s0), np.asarray(s1)])
        for e, row in zip(spec_world, total):
            assert row.tolist() == e["enc"]
        out = tmp_path / "rt.share-0"
        write_share(out, np.asarray(s0))
        assert out.read_bytes() == p0.read_bytes()


class TestEnginesAgainstSpec:
    def test_share_engine_records(self, spec_world):
        """Participant dot records == independent spec, via both share DBs
        summed mod 2^16 (src/main.rs:597-612)."""
        from mpc_iris_tpu.models import ShareEngine

        db0 = np.array([e["s0"] for e in spec_world], dtype=np.uint16)
        db1 = np.array([e["s1"] for e in spec_world], dtype=np.uint16)
        qpat = np.frombuffer(QUERY_PATTERN, np.uint8)[None]
        qmsk = np.frombuffer(QUERY_MASK, np.uint8)[None]
        d0 = ShareEngine(db0, chunk=4).dots(qpat, qmsk)[0]
        d1 = ShareEngine(db1, chunk=4).dots(qpat, qmsk)[0]
        total = (d0.astype(np.uint32) + d1) % 65536
        for e, rec in zip(spec_world, total):
            assert rec.tolist() == e["dists"]

    def test_masks_engine_records(self, spec_world):
        from mpc_iris_tpu.models import MasksEngine

        db = np.stack([np.frombuffer(e["mask"], np.uint8) for e in spec_world])
        qmsk = np.frombuffer(QUERY_MASK, np.uint8)[None]
        dens = MasksEngine(db, chunk=4).dots(qmsk)[0]
        for e, rec in zip(spec_world, dens):
            assert rec.tolist() == e["dens"]


class TestProtocolAgainstSpec:
    def test_raw_wire_reply_bytes(self, spec_world):
        """Drive a participant server with hand-built query bytes and check
        the raw reply stream byte-for-byte against the spec records."""
        from mpc_iris_tpu.models import ShareEngine
        from mpc_iris_tpu.protocol import ParticipantServer

        db0 = np.array([e["s0"] for e in spec_world], dtype=np.uint16)

        async def go():
            server = ParticipantServer(ShareEngine(db0, chunk=4),
                                       "127.0.0.1", 0)
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(QUERY_PATTERN + QUERY_MASK)
            await writer.drain()
            data = await reader.read(-1)
            writer.close()
            await writer.wait_closed()
            await server.close()
            return data

        data = asyncio.run(go())
        assert len(data) == N_ENTRIES * 62
        recs = np.frombuffer(data, "<u2").reshape(N_ENTRIES, 31)
        q_enc = _spec_encode(QUERY_PATTERN, QUERY_MASK)
        for e, rec in zip(spec_world, recs):
            expect = [_spec_dot_u16(_spec_rotate_encoded(q_enc, r), e["s0"])
                      for r in range(-15, 16)]
            assert rec.tolist() == expect

    def test_end_to_end_distance(self, spec_world):
        """Full 2-party protocol from the hand-built byte world: the decoded
        winner equals the frozen spec distances."""
        from mpc_iris_tpu.models import MasksEngine, ShareEngine
        from mpc_iris_tpu.protocol import Coordinator, ParticipantServer
        from mpc_iris_tpu.types import Template

        db0 = np.array([e["s0"] for e in spec_world], dtype=np.uint16)
        db1 = np.array([e["s1"] for e in spec_world], dtype=np.uint16)
        masks = np.stack(
            [np.frombuffer(e["mask"], np.uint8) for e in spec_world]
        )

        async def go():
            servers = [
                ParticipantServer(ShareEngine(m, chunk=4), "127.0.0.1", 0)
                for m in (db0, db1)
            ]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(MasksEngine(masks, chunk=4), addrs)
            try:
                return await coord.query(
                    Template.from_bytes(QUERY_PATTERN + QUERY_MASK)
                )
            finally:
                for s in servers:
                    await s.close()

        outcome = asyncio.run(go())
        assert outcome.total == N_ENTRIES
        assert outcome.index == int(np.argmin(FROZEN_DISTANCES))
        assert outcome.distance == min(FROZEN_DISTANCES)


# ===================================================================== keyed
# Keyed-stream addressing (SPEC 4.1, our extension) pinned the same
# three-way: an independent pure-int ChaCha20 (RFC 8439) below, the repo's
# native/XLA implementations, and frozen literals. Covers every stream-id
# class: small share ids, ids past 2^31 (u32 sign pitfalls), the maximum
# assignable id 2^32-2, and the reserved re-randomization stream 2^32-1 —
# plus u64 rows needing the nonce-word carry.


def _spec_rotl32(x, n):
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _spec_quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _spec_rotl32(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _spec_rotl32(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _spec_rotl32(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _spec_rotl32(s[b] ^ s[c], 7)


def _spec_chacha_block(key: bytes, counter: int, nonce_words) -> bytes:
    st = (
        [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
        + [int.from_bytes(key[i * 4:i * 4 + 4], "little") for i in range(8)]
        + [counter & 0xFFFFFFFF]
        + list(nonce_words)
    )
    w = list(st)
    for _ in range(10):
        _spec_quarter(w, 0, 4, 8, 12)
        _spec_quarter(w, 1, 5, 9, 13)
        _spec_quarter(w, 2, 6, 10, 14)
        _spec_quarter(w, 3, 7, 11, 15)
        _spec_quarter(w, 0, 5, 10, 15)
        _spec_quarter(w, 1, 6, 11, 12)
        _spec_quarter(w, 2, 7, 8, 13)
        _spec_quarter(w, 3, 4, 9, 14)
    return b"".join(((a + b) & 0xFFFFFFFF).to_bytes(4, "little")
                    for a, b in zip(w, st))


def _spec_keyed_row_u16(key: bytes, stream_id: int, row: int, n_u16: int):
    """SPEC 4.1: keystream for share `stream_id` of global row `row` is
    ChaCha20(key, counter=0.., nonce = sid:4LE || row:8LE), read as LE u16."""
    nonce = (stream_id & 0xFFFFFFFF, row & 0xFFFFFFFF,
             (row >> 32) & 0xFFFFFFFF)
    nbytes = n_u16 * 2
    ks = b"".join(_spec_chacha_block(key, c, nonce)
                  for c in range(-(-nbytes // 64)))[:nbytes]
    return [int.from_bytes(ks[i * 2:i * 2 + 2], "little")
            for i in range(n_u16)]


KEY_A = bytes(range(32))
KEY_B = bytes(range(1, 33))

FROZEN_KEYED_ROWS = {
    (0, 0): [64825, 32043, 50649, 27161],
    (1, 1): [27390, 27408, 23409, 47431],
    (5, 1000): [60086, 61944, 29730, 63774],
    (2147483648, 4294967296): [1764, 10301, 43630, 27855],
    (4294967294, 1099511627775): [17723, 57347, 18570, 44325],
    (4294967295, 3): [20680, 25815, 31232, 15733],
}
FROZEN_REKEYED_DATA_ROW2_PREFIX = [
    63895, 48453, 19472, 47573, 18156, 43470, 16146, 57207,
]


class TestKeyedStreamKATs:
    def test_rfc8439_block_vector(self):
        """The spec ChaCha20 reproduces the RFC 8439 §2.3.2 test block."""
        nw = tuple(int.from_bytes(bytes.fromhex(h), "little")
                   for h in ("00000009", "0000004a", "00000000"))
        blk = _spec_chacha_block(KEY_A, 1, nw)
        assert blk[:16].hex() == "10f1e7e4d13b5915500fdd1fa32071c4"

    @pytest.mark.parametrize("sid,row", sorted(FROZEN_KEYED_ROWS))
    def test_keyed_row_addressing_three_way(self, sid, row):
        """spec == frozen == native for every stream-id/row class."""
        from mpc_iris_tpu import native

        spec4 = _spec_keyed_row_u16(KEY_A, sid, row, 4)
        assert spec4 == FROZEN_KEYED_ROWS[(sid, row)]
        nonce = (sid & 0xFFFFFFFF).to_bytes(4, "little") + \
            (row & (2**64 - 1)).to_bytes(8, "little")
        got = np.asarray(
            native.chacha20_stream(KEY_A, 0, nonce, 8)
        ).view("<u2").tolist()
        assert got == spec4

    def test_keyed_row_xla_path(self):
        """ops.chacha.share_rows (the device regen path) matches the spec
        for a full 12,800-u16 row."""
        from mpc_iris_tpu.ops.chacha import key_words, share_rows

        sid, row = 5, 1000
        want = _spec_keyed_row_u16(KEY_A, sid, row, BITS)
        got = np.asarray(
            share_rows(key_words(KEY_A), sid, np.uint32(row), 1)
        )[0].tolist()
        assert got == want

    def test_rekey_epoch_frozen(self, tmp_path, monkeypatch):
        """SPEC 4.3 key rotation over a hand-built keyed store: the rewritten
        data share must equal enc - keystream(new key) per row — checked
        against the spec formula, the frozen prefix, and reconstruction."""
        import os as _os

        from mpc_iris_tpu.cli import main

        base = str(tmp_path / "kat")
        rows = list(range(N_ENTRIES))
        encs = [_spec_encode(fx_pattern(e), fx_mask(e)) for e in rows]
        ks_a = [_spec_keyed_row_u16(KEY_A, 0, r, BITS) for r in rows]
        with open(f"{base}.share-0", "wb") as f:
            for r in rows:
                f.write(_u16s_to_le_bytes(ks_a[r]))
        with open(f"{base}.share-1", "wb") as f:
            for r in rows:
                f.write(_u16s_to_le_bytes(
                    [(e - k) % 65536 for e, k in zip(encs[r], ks_a[r])]
                ))
        with open(f"{base}.oldkey", "w") as f:
            f.write(KEY_A.hex())  # key files carry 64 hex digits
        monkeypatch.setattr(_os, "urandom",
                            lambda n: KEY_B[:n] if n == 32 else b"\0" * n)
        rc = main(["rekey", base, "--count", "2",
                   "--old-key", f"{base}.oldkey",
                   "--new-key-out", f"{base}.newkey"])
        assert rc == 0
        with open(f"{base}.newkey") as kf:
            assert bytes.fromhex(kf.read().strip()) == KEY_B

        got0 = np.fromfile(f"{base}.share-0", "<u2").reshape(N_ENTRIES, BITS)
        got1 = np.fromfile(f"{base}.share-1", "<u2").reshape(N_ENTRIES, BITS)
        for r in rows:
            ks_b = _spec_keyed_row_u16(KEY_B, 0, r, BITS)
            assert got0[r].tolist() == ks_b  # keyed file rewritten to k'
            want_data = [(e - k) % 65536 for e, k in zip(encs[r], ks_b)]
            assert got1[r].tolist() == want_data
            # reconstruction preserved: share-0 + share-1 == enc (mod 2^16)
            assert ((got0[r].astype(np.int64) + got1[r]) % 65536
                    ).tolist() == encs[r]
        assert got1[2][:8].tolist() == FROZEN_REKEYED_DATA_ROW2_PREFIX


# =========================================================== extension wires
# Frozen byte vectors for the SPEC §5 wires this framework adds beyond the
# reference: batched block framing, chain records, the
# persistent query/reply transcript, and a 2-epoch rekey sequence. Each wire
# is hand-built from its closed-form byte formula (no framework writer) and
# checked against the framework's reader/server side — plus frozen literals.

KEY_C = bytes(range(2, 34))

# struct.pack("<qdQ", argmin, min_distance, 8) for the fixture query over the
# 8-entry spec world (index 2, 0.2532004537352131), and for a query equal to
# entry 3's template (exact duplicate: index 3, distance 0.0).
FROZEN_PERSIST_REPLY_Q1 = "0200000000000000a90108ad6f34d03f0800000000000000"
FROZEN_PERSIST_REPLY_Q2 = "030000000000000000000000000000000800000000000000"

# After rekeying KEY_A -> KEY_B -> KEY_C (2 epochs), row 2 of the keyed
# share-0 is keystream(KEY_C, row 2) and the data share-1 is enc - that.
FROZEN_EPOCH2_KEYED_ROW2_PREFIX = [
    30545, 48494, 47148, 9944, 54428, 41030, 63475, 65345,
]
FROZEN_EPOCH2_DATA_ROW2_PREFIX = [
    34991, 17041, 18387, 55591, 11109, 24507, 2060, 192,
]


def _hand_batched_query(templates: list) -> bytes:
    """Closed-form batched-wire request (SPEC 5.3): magic "IRB1" + u32-LE
    count + B raw 3,200-byte templates (protocol/wire.py contract, built
    here WITHOUT the framework writer)."""
    body = b"".join(templates)
    return b"IRB1" + len(templates).to_bytes(4, "little") + body


def _hand_chain_query(templates: list, upstream: list) -> bytes:
    """Closed-form chain-wire request (SPEC 5.4): magic "IRC1" + batched
    body + u16-LE address count + per address u16-LE length + bytes."""
    body = len(templates).to_bytes(4, "little") + b"".join(templates)
    tail = len(upstream).to_bytes(2, "little")
    for addr in upstream:
        raw = addr.encode()
        tail += len(raw).to_bytes(2, "little") + raw
    return b"IRC1" + body + tail


class TestBatchedWireAgainstSpec:
    def test_request_framing_bytes(self):
        """The framework writer emits exactly the closed-form framing."""
        from mpc_iris_tpu.protocol.wire import batched_query_bytes

        pats = np.stack([np.frombuffer(fx_pattern(e), np.uint8)
                         for e in (9, 3)])
        msks = np.stack([np.frombuffer(fx_mask(e), np.uint8)
                         for e in (9, 3)])
        hand = _hand_batched_query(
            [fx_pattern(9) + fx_mask(9), fx_pattern(3) + fx_mask(3)])
        assert batched_query_bytes(pats, msks) == hand

    def test_reply_stream_bytes(self, spec_world):
        """Drive a batched-wire participant with HAND-BUILT request bytes;
        the raw reply must be entry-major groups — per DB entry, B
        consecutive [u16; 31] LE records — matching the spec dot records."""
        from mpc_iris_tpu.models import ShareEngine
        from mpc_iris_tpu.protocol import ParticipantServer

        db0 = np.array([e["s0"] for e in spec_world], dtype=np.uint16)
        q1 = QUERY_PATTERN + QUERY_MASK
        q2 = fx_pattern(3) + fx_mask(3)

        async def go():
            server = ParticipantServer(ShareEngine(db0, chunk=4),
                                       "127.0.0.1", 0, wire="batched")
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(_hand_batched_query([q1, q2]))
            await writer.drain()
            data = await reader.read(-1)
            writer.close()
            await writer.wait_closed()
            await server.close()
            return data

        data = asyncio.run(go())
        assert len(data) == N_ENTRIES * 2 * 62
        recs = np.frombuffer(data, "<u2").reshape(N_ENTRIES, 2, 31)
        for (qp, qm), q in (((QUERY_PATTERN, QUERY_MASK), 0),
                            ((fx_pattern(3), fx_mask(3)), 1)):
            q_enc = _spec_encode(qp, qm)
            for e, ent in zip(spec_world, recs):
                expect = [_spec_dot_u16(_spec_rotate_encoded(q_enc, r),
                                        e["s0"]) for r in range(-15, 16)]
                assert ent[q].tolist() == expect


class TestChainWireAgainstSpec:
    def test_request_framing_bytes(self):
        from mpc_iris_tpu.protocol.wire import chain_query_bytes

        pats = np.frombuffer(QUERY_PATTERN, np.uint8)[None]
        msks = np.frombuffer(QUERY_MASK, np.uint8)[None]
        ups = ["127.0.0.1:4441", "10.0.0.7:9"]
        hand = _hand_chain_query([QUERY_PATTERN + QUERY_MASK], ups)
        assert chain_query_bytes(pats, msks, ups) == hand

    def test_aggregated_stream_reconstructs_full_records(self, spec_world):
        """2-party chain driven by HAND-BUILT request bytes: the head adds
        its own dot shares to its upstream's stream, so the aggregated
        reply records equal the FULL spec distance records (s0 + s1 == enc
        mod 2^16) — including the frozen record of entry 1."""
        from mpc_iris_tpu.models import ShareEngine
        from mpc_iris_tpu.protocol import ParticipantServer

        db0 = np.array([e["s0"] for e in spec_world], dtype=np.uint16)
        db1 = np.array([e["s1"] for e in spec_world], dtype=np.uint16)

        async def go():
            up = ParticipantServer(ShareEngine(db0, chunk=4),
                                   "127.0.0.1", 0, wire="chain")
            uh, upp = await up.start()
            head = ParticipantServer(ShareEngine(db1, chunk=4),
                                     "127.0.0.1", 0, wire="chain")
            hh, hp = await head.start()
            reader, writer = await asyncio.open_connection(hh, hp)
            writer.write(_hand_chain_query(
                [QUERY_PATTERN + QUERY_MASK], [f"{uh}:{upp}"]))
            await writer.drain()
            data = await reader.read(-1)
            writer.close()
            await writer.wait_closed()
            await head.close()
            await up.close()
            return data

        data = asyncio.run(go())
        assert len(data) == N_ENTRIES * 62
        recs = np.frombuffer(data, "<u2").reshape(N_ENTRIES, 31)
        for e, rec in zip(spec_world, recs):
            assert rec.tolist() == e["dists"]
        assert recs[1].tolist() == FROZEN_DIST_RECORD_E1


class TestPersistentWireAgainstSpec:
    def test_transcript_bytes(self, spec_world):
        """Persistent serving wire (SPEC 5.5) as raw bytes: 8-byte magic
        "MPCIRSQ1", then per record a raw 3,200-byte template out and a
        24-byte <qdQ (index, f64 distance, total) reply back — two records
        on ONE connection, each checked against its frozen literal."""
        from mpc_iris_tpu.models import MasksEngine, ShareEngine
        from mpc_iris_tpu.protocol import (
            Coordinator,
            ParticipantServer,
            QueryServer,
        )

        db0 = np.array([e["s0"] for e in spec_world], dtype=np.uint16)
        db1 = np.array([e["s1"] for e in spec_world], dtype=np.uint16)
        masks = np.stack(
            [np.frombuffer(e["mask"], np.uint8) for e in spec_world])

        async def go():
            part = ParticipantServer(ShareEngine(db1, chunk=4),
                                     "127.0.0.1", 0)
            addr = await part.start()
            coord = Coordinator(
                MasksEngine(masks, chunk=4), [addr],
                local_engine=ShareEngine(db0, chunk=4),
            )
            front = QueryServer(coord, "127.0.0.1", 0)
            host, port = await front.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(b"MPCIRSQ1")
            replies = []
            for q in (QUERY_PATTERN + QUERY_MASK,
                      fx_pattern(3) + fx_mask(3)):
                writer.write(q)
                await writer.drain()
                replies.append(await reader.readexactly(24))
            writer.close()
            await writer.wait_closed()
            await front.close()
            await part.close()
            return replies

        r1, r2 = asyncio.run(go())
        assert r1.hex() == FROZEN_PERSIST_REPLY_Q1
        assert r2.hex() == FROZEN_PERSIST_REPLY_Q2
        # and the frozen literals decode to the frozen spec distances
        import struct as _struct

        idx, dist, total = _struct.unpack("<qdQ", r1)
        assert (idx, total) == (int(np.argmin(FROZEN_DISTANCES)), N_ENTRIES)
        assert dist == min(FROZEN_DISTANCES)
        idx2, dist2, _ = _struct.unpack("<qdQ", r2)
        assert (idx2, dist2) == (3, 0.0)


class TestTwoEpochRekey:
    def test_two_epoch_sequence_frozen(self, tmp_path, monkeypatch):
        """SPEC 4.3 key rotation applied TWICE (KEY_A -> KEY_B -> KEY_C)
        over the hand-built keyed store: after each epoch the keyed share is
        exactly keystream(current key) and reconstruction is preserved;
        epoch-2 rows pinned by frozen literals."""
        import os as _os

        from mpc_iris_tpu.cli import main

        base = str(tmp_path / "kat")
        rows = list(range(N_ENTRIES))
        encs = [_spec_encode(fx_pattern(e), fx_mask(e)) for e in rows]
        ks_a = [_spec_keyed_row_u16(KEY_A, 0, r, BITS) for r in rows]
        with open(f"{base}.share-0", "wb") as f:
            for r in rows:
                f.write(_u16s_to_le_bytes(ks_a[r]))
        with open(f"{base}.share-1", "wb") as f:
            for r in rows:
                f.write(_u16s_to_le_bytes(
                    [(e - k) % 65536 for e, k in zip(encs[r], ks_a[r])]))
        with open(f"{base}.key-a", "w") as f:
            f.write(KEY_A.hex())

        for old, new, newkey_path in (
            (KEY_A, KEY_B, f"{base}.key-b"),
            (KEY_B, KEY_C, f"{base}.key-c"),
        ):
            monkeypatch.setattr(
                _os, "urandom", lambda n, k=new: k[:n] if n == 32 else b"\0" * n)
            with open(f"{base}.oldkey", "w") as f:
                f.write(old.hex())
            rc = main(["rekey", base, "--count", "2",
                       "--old-key", f"{base}.oldkey",
                       "--new-key-out", newkey_path])
            assert rc == 0
            with open(newkey_path) as kf:
                assert bytes.fromhex(kf.read().strip()) == new

        got0 = np.fromfile(f"{base}.share-0", "<u2").reshape(N_ENTRIES, BITS)
        got1 = np.fromfile(f"{base}.share-1", "<u2").reshape(N_ENTRIES, BITS)
        for r in rows:
            ks_c = _spec_keyed_row_u16(KEY_C, 0, r, BITS)
            assert got0[r].tolist() == ks_c
            assert got1[r].tolist() == [
                (e - k) % 65536 for e, k in zip(encs[r], ks_c)]
            assert ((got0[r].astype(np.int64) + got1[r]) % 65536
                    ).tolist() == encs[r]
        assert got0[2][:8].tolist() == FROZEN_EPOCH2_KEYED_ROW2_PREFIX
        assert got1[2][:8].tolist() == FROZEN_EPOCH2_DATA_ROW2_PREFIX
