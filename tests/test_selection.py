"""Exact selection on the match paths == a NumPy rational-argmin oracle.

Every match path — the dense XLA scan, the packed XLA scan and the packed
small-batch Pallas kernel (interpret mode here; the compiled kernel runs in
the ``gpu``-marked test on the card) — must pick the minimal fraction n/d
over the 31 rotations (d == 0 is +inf, ties keep the earliest rotation) and
then over entries (ties keep the lower DB index), mirroring the reference's
fast-vs-slow kernel parity test (src/arch/sve.rs:79-109).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_iris_tpu.constants import BITS, BITS_BYTES, N_ROTATIONS
from mpc_iris_tpu.models.engines import (
    _fractions_scan_packed,
    _match_scan,
    _match_scan_packed,
    _pad_chunks,
    prepare_query_planes,
)
from mpc_iris_tpu.ops.decode import fraction_argmin, fraction_min_rotations
from mpc_iris_tpu.ops.encode import encode_grid_i8, unpack_bits


def _oracle_winners(q_enc, q_mask, db_enc, db_mask):
    """NumPy rational argmin: [3, B] (n, d, index) over a dense [C, c, K]
    DB, with exact Fractions deciding every comparison."""
    qe = np.asarray(q_enc, np.int64)
    qm = np.asarray(q_mask, np.int64)
    de = np.asarray(db_enc, np.int64).reshape(-1, BITS)
    dm = np.asarray(db_mask, np.int64).reshape(-1, BITS)
    dot = np.einsum("brk,nk->brn", qe, de)
    den = np.einsum("brk,nk->brn", qm, dm)
    num = (den - dot) >> 1
    out = []
    for b in range(qe.shape[0]):
        best = None  # (Fraction, n, d, index)
        for i in range(de.shape[0]):
            ent = None
            for r in range(N_ROTATIONS):  # earliest rotation keeps ties
                d = int(den[b, r, i])
                if d and (ent is None or Fraction(int(num[b, r, i]), d) < ent[0]):
                    ent = (Fraction(int(num[b, r, i]), d), int(num[b, r, i]), d)
            if ent is None:
                ent = (None, int(num[b, 0, i]), 0)
            if best is None or (ent[0] is not None and (
                    best[0] is None or ent[0] < best[0])):
                best = (*ent, i)
        out.append(best[1:])
    return np.array(out).T


def _random_case(rng, b=8, chunk=256, n_chunks=1, masked_fraction=0.0):
    enc = rng.integers(-1, 2, size=(b, N_ROTATIONS, BITS)).astype(np.int8)
    if masked_fraction:
        drop = rng.random((b, 1, BITS)) < masked_fraction
        enc = np.where(drop, 0, enc)
    q_enc = jnp.asarray(enc)
    q_mask = (q_enc != 0).astype(jnp.int8)
    db = rng.integers(-1, 2, size=(n_chunks, chunk, BITS)).astype(np.int8)
    db_enc = jnp.asarray(db)
    db_mask = (db_enc != 0).astype(jnp.int8)
    return q_enc, q_mask, db_enc, db_mask


def test_fused_matches_xla(rng):
    """The dense XLA scan against the oracle over a two-chunk DB."""
    q_enc, q_mask, db_enc, db_mask = _random_case(rng, b=3, n_chunks=2)
    got = np.asarray(_match_scan(q_enc, q_mask, db_enc, db_mask))
    np.testing.assert_array_equal(got, _oracle_winners(q_enc, q_mask,
                                                       db_enc, db_mask))


def test_fused_matches_xla_with_invalid_entries(rng):
    """Fully-masked queries/entries (den == 0 everywhere) behave as +inf."""
    q_enc, q_mask, db_enc, db_mask = _random_case(rng, b=3, masked_fraction=0.4)
    db_enc = db_enc.at[0, 3].set(0)
    db_mask = db_mask.at[0, 3].set(0)
    q_enc = q_enc.at[2].set(0)
    q_mask = q_mask.at[2].set(0)
    got = np.asarray(_match_scan(q_enc, q_mask, db_enc, db_mask))
    np.testing.assert_array_equal(got, _oracle_winners(q_enc, q_mask,
                                                       db_enc, db_mask))
    assert got[1, 2] == 0  # the all-invalid query finds no valid entry


def test_select_chunk_ties_prefer_low_index(rng):
    """Duplicate winning entries: the lower DB index must win."""
    q_enc, q_mask, db_enc, db_mask = _random_case(rng, b=2)
    for pos in (70, 150):
        db_enc = db_enc.at[0, pos].set(db_enc[0, 10])
        db_mask = db_mask.at[0, pos].set(db_mask[0, 10])
    q_enc = q_enc.at[0].set(jnp.broadcast_to(db_enc[0, 70], (N_ROTATIONS, BITS)))
    q_mask = q_mask.at[0].set(jnp.broadcast_to(db_mask[0, 70], (N_ROTATIONS, BITS)))
    got = np.asarray(_match_scan(q_enc, q_mask, db_enc, db_mask))
    np.testing.assert_array_equal(got, _oracle_winners(q_enc, q_mask,
                                                       db_enc, db_mask))
    assert got[2, 0] == 10 and got[0, 0] == 0


def test_select_chunk_oracle(rng):
    """fraction_min_rotations + fraction_argmin against the oracle on raw
    (num, den) planes, including equal fractions in different terms at
    different rotations (1/2 vs 2/4: the earliest rotation's terms win)."""
    b, n = 3, 300
    den = rng.integers(0, 12801, size=(b, N_ROTATIONS, n)).astype(np.int64)
    num = np.minimum(rng.integers(0, 12801, size=(b, N_ROTATIONS, n)), den)
    den[:, :, 7] = 0  # an all-invalid entry
    num[0, :, 5], den[0, :, 5] = 9000, 9000
    num[0, 4, 5], den[0, 4, 5] = 2, 4
    num[0, 2, 5], den[0, 2, 5] = 1, 2  # earlier rotation, equal value
    n_r, d_r, _ = fraction_min_rotations(jnp.asarray(num, jnp.int32),
                                         jnp.asarray(den, jnp.int32), axis=1)
    assert (int(n_r[0, 5]), int(d_r[0, 5])) == (1, 2)
    n_c, d_c, i_c = fraction_argmin(n_r, d_r, axis=-1, index_offset=37)
    for q in range(b):
        vals = [Fraction(int(x), int(y)) if y else None
                for x, y in zip(np.asarray(n_r[q]), np.asarray(d_r[q]))]
        best = min((v, i) for i, v in enumerate(vals) if v is not None)
        assert int(i_c[q]) == best[1] + 37
        assert Fraction(int(n_c[q]), int(d_c[q])) == best[0]


# -------------------------------------------------- packed small-batch kernel


class TestPackedSmallB:
    """ops/packed_match.py: the small-batch Pallas kernel (interpret mode
    here) must be bit-identical to the packed XLA scan at every small batch
    size, including planted self-matches, all-invalid entries, ties, and
    padded tail chunks."""

    @staticmethod
    def _world(rng, n):
        pat = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
        msk = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
        msk[5] = 0  # all-invalid entry: d == 0 -> +inf, never wins
        return pat, msk

    @pytest.mark.parametrize("b", [1, 2, 3, 8])
    def test_matches_packed_scan(self, rng, b):
        from mpc_iris_tpu.ops.packed_match import match_packed_small_b

        n, chunk = 512, 256
        pat, msk = self._world(rng, n)
        qpat = pat[rng.integers(0, n, b)].copy()  # planted exact matches
        qmsk = msk[rng.integers(0, n, b)].copy()
        qpat[0], qmsk[0] = pat[17], msk[17]       # self-match for query 0
        q_enc, q_mask = prepare_query_planes(qpat, qmsk)
        db_pat = jnp.asarray(pat).reshape(n // chunk, chunk, -1)
        db_msk = jnp.asarray(msk).reshape(n // chunk, chunk, -1)
        want = np.asarray(_match_scan_packed(q_enc, q_mask, db_pat, db_msk))
        got = np.asarray(match_packed_small_b(
            q_enc, q_mask, db_pat, db_msk, interpret=True))
        assert np.array_equal(got, want)
        assert got[2, 0] == 17 and got[0, 0] == 0  # exact self-match

    def test_padded_tail_and_duplicate_tie(self, rng):
        """Zero-padded tail rows never win (mask 0 = invalid) and duplicate
        entries tie to the LOWER DB index, matching the scan semantics."""
        from mpc_iris_tpu.ops.packed_match import match_packed_small_b

        n, chunk = 300, 256  # pads to 512 with 212 zero rows
        pat, msk = self._world(rng, n)
        pat[270], msk[270] = pat[30], msk[30]  # duplicate pair
        qpat, qmsk = pat[30:31].copy(), msk[30:31].copy()
        q_enc, q_mask = prepare_query_planes(qpat, qmsk)
        pat_c, _ = _pad_chunks(pat, chunk)
        msk_c, _ = _pad_chunks(msk, chunk)
        db_pat, db_msk = jnp.asarray(pat_c), jnp.asarray(msk_c)
        want = np.asarray(_match_scan_packed(q_enc, q_mask, db_pat, db_msk))
        got = np.asarray(match_packed_small_b(
            q_enc, q_mask, db_pat, db_msk, interpret=True))
        assert np.array_equal(got, want)
        assert got[2, 0] == 30  # lower index of the duplicate pair

    def test_engine_dispatches_small_b(self, rng):
        """PlaintextEngine packed storage routes small batches through the
        small-batch dispatch (the kernel where compiled for CUDA) and
        returns scan-identical self-matches."""
        from mpc_iris_tpu.models.engines import PlaintextEngine

        n = 512
        pat, msk = self._world(rng, n)
        eng = PlaintextEngine(pat, msk, chunk=256, storage="packed")
        r = eng.match(pat[:3], msk[:3])
        assert [m.index for m in r] == [0, 1, 2]
        assert all(m.distance == 0.0 for m in r)

    def test_small_b_ok_policy(self):
        from mpc_iris_tpu.ops.packed_match import (
            SMALL_B_MAX,
            small_b_ok,
            tile_for,
        )

        assert small_b_ok(1, 512) and small_b_ok(SMALL_B_MAX, 1024)
        assert not small_b_ok(SMALL_B_MAX + 1, 512)  # the XLA scan wins there
        assert not small_b_ok(0, 512)
        assert not small_b_ok(1, tile_for(1) + 1)  # tile must divide the chunk
        assert not small_b_ok(1, 300)

    @pytest.mark.parametrize("b", [1, 8])
    def test_fractions_kernel_matches_scan(self, rng, b):
        """The audit spectrum (fractions_packed_small_b) must equal
        _fractions_scan_packed element for element, including the d == 0
        invalid entry and padded tail rows, and find_under through the
        engine must agree between its compacted and full paths."""
        from mpc_iris_tpu.models.engines import PlaintextEngine
        from mpc_iris_tpu.ops.packed_match import fractions_packed_small_b

        n, chunk = 300, 256  # padded tail
        pat, msk = self._world(rng, n)
        qpat = pat[rng.integers(0, n, b)].copy()
        qmsk = msk[rng.integers(0, n, b)].copy()
        q_enc, q_mask = prepare_query_planes(qpat, qmsk)
        pat_c, _ = _pad_chunks(pat, chunk)
        msk_c, _ = _pad_chunks(msk, chunk)
        db_pat, db_msk = jnp.asarray(pat_c), jnp.asarray(msk_c)
        want = np.asarray(_fractions_scan_packed(q_enc, q_mask, db_pat, db_msk))
        got = np.asarray(fractions_packed_small_b(
            q_enc, q_mask, db_pat, db_msk, interpret=True))
        assert np.array_equal(got, want)

        eng = PlaintextEngine(pat, msk, chunk=chunk, storage="packed")
        t = 0.47
        fast = eng.find_under(qpat, qmsk, t, compact_k=64)
        full = eng.find_under(qpat, qmsk, t)
        as_t = lambda rows: [
            [(m.index, m.distance, m.numerator, m.denominator) for m in r]
            for r in rows]
        assert as_t(fast) == as_t(full)
        assert sum(len(r) for r in full) > 0  # non-vacuous threshold


def test_congruent_duplicate_index_tie(rng):
    """Exact duplicates at columns congruent mod 128 (129/257, 1/1025,
    640/1920 of a 2048-entry DB) must tie to the LOWER index on every path:
    the dense scan, the packed scan and the packed kernel."""
    from mpc_iris_tpu.ops.packed_match import match_packed_small_b

    n, chunk = 2048, 1024
    dpat = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    dmsk = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    for lo, hi in ((129, 257), (1, 1025), (640, 1920)):
        dpat[hi], dmsk[hi] = dpat[lo], dmsk[lo]
    p = unpack_bits(jnp.asarray(dpat)).astype(jnp.int8)
    m = unpack_bits(jnp.asarray(dmsk)).astype(jnp.int8)
    enc = encode_grid_i8(p, m).reshape(n // chunk, chunk, -1)
    mask = m.reshape(n // chunk, chunk, -1)
    db_pat = jnp.asarray(dpat).reshape(n // chunk, chunk, -1)
    db_msk = jnp.asarray(dmsk).reshape(n // chunk, chunk, -1)
    qpat, qmsk = dpat[[129, 1, 640]].copy(), dmsk[[129, 1, 640]].copy()
    q_enc, q_mask = prepare_query_planes(qpat, qmsk)
    dense = np.asarray(_match_scan(q_enc, q_mask, enc, mask))
    packed = np.asarray(_match_scan_packed(q_enc, q_mask, db_pat, db_msk))
    kernel = np.asarray(match_packed_small_b(q_enc, q_mask, db_pat, db_msk,
                                             interpret=True))
    assert np.array_equal(dense, packed) and np.array_equal(dense, kernel)
    assert list(dense[2]) == [129, 1, 640] and (dense[0] == 0).all()


def test_fraction_key_is_exact_order():
    """The kernel's integer key floor(n * 2^28 / d) orders every pair of
    fractions with n <= d <= 12,800 exactly as the rationals do (equal
    fractions share a key), including the extremes of the range."""
    from mpc_iris_tpu.ops.packed_match import _fraction_key

    rng = np.random.default_rng(3)
    d = rng.integers(1, 12801, 4000)
    n = (rng.random(4000) * (d + 1)).astype(np.int64).clip(0, d)
    extra = np.array([[0, 1], [1, 12800], [1, 12799], [12799, 12800],
                      [12800, 12800], [6400, 12800], [1, 2], [6399, 12799],
                      [6400, 12799], [0, 0], [5, 0]])
    n = np.concatenate([n, extra[:, 0]])
    d = np.concatenate([d, extra[:, 1]])
    keys = np.asarray(_fraction_key(jnp.asarray(n, jnp.int32),
                                    jnp.asarray(d, jnp.int32))).astype(np.int64)
    valid = d > 0
    assert (keys[~valid] == 2**31 - 1).all()
    nv, dv, kv = n[valid], d[valid], keys[valid]
    assert (kv == (nv << 28) // dv).all()
    # order and equality agree with the rationals on every sampled pair
    i = rng.integers(0, nv.size, 20000)
    j = rng.integers(0, nv.size, 20000)
    lhs, rhs = nv[i] * dv[j], nv[j] * dv[i]
    assert ((kv[i] < kv[j]) == (lhs < rhs)).all()
    assert ((kv[i] == kv[j]) == (lhs == rhs)).all()
    # adjacent Farey neighbours near 1 differ by 1/(d1*d2) ~ 6e-9
    assert int(_fraction_key(jnp.int32(12798), jnp.int32(12799))) < int(
        _fraction_key(jnp.int32(12799), jnp.int32(12800)))


def test_small_batch_dispatch_by_batch_size():
    """The packed dispatch picks the kernel or the XLA scan by batch size
    alone: batches up to SMALL_B_MAX carry the Pallas kernel in their
    program (compiled where the program targets CUDA), larger ones do not.
    No backend check: the same jaxpr is traced on every platform."""
    from mpc_iris_tpu.models.engines import match_scan_packed_auto
    from mpc_iris_tpu.ops.packed_match import SMALL_B_MAX

    db = jnp.zeros((1, 256, BITS_BYTES), jnp.uint8)

    def jaxpr(b):
        q = jnp.zeros((b, N_ROTATIONS, BITS), jnp.int8)
        return str(jax.make_jaxpr(match_scan_packed_auto)(q, q, db, db))

    assert "pallas_call" in jaxpr(1)
    assert "pallas_call" in jaxpr(SMALL_B_MAX)
    assert "pallas_call" not in jaxpr(SMALL_B_MAX + 1)
    assert "platform_index" in jaxpr(1)  # cuda: kernel, elsewhere: XLA scan


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
def test_compiled_kernel_matches_scan_on_gpu(gpu, b):
    """The kernel as compiled for the card (Triton route) == the XLA scan,
    at several chunks with a padded tail."""
    from mpc_iris_tpu.ops.packed_match import fractions_packed_small_b

    rng = np.random.default_rng(b)
    pat = rng.integers(0, 256, (5000, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (5000, BITS_BYTES), dtype=np.uint8)
    pat_c, _ = _pad_chunks(pat, 2048)
    msk_c, _ = _pad_chunks(msk, 2048)
    db_pat = jax.device_put(pat_c, gpu)
    db_msk = jax.device_put(msk_c, gpu)
    q_enc, q_mask = prepare_query_planes(pat[:b], msk[:b])
    got = np.asarray(fractions_packed_small_b(q_enc, q_mask, db_pat, db_msk))
    want = np.asarray(_fractions_scan_packed(q_enc, q_mask, db_pat, db_msk))
    assert np.array_equal(got, want)
