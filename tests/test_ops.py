"""L0 kernel tests: encoding table, int8 matmul formulations vs scalar oracles,
and the exact integer fraction selection — mirroring reference tests test_preprocess
(src/lib.rs:117-132), test_dotproduct (src/lib.rs:134-163) and the kernel-equivalence
test (src/arch/sve.rs:79-109)."""

from fractions import Fraction

import numpy as np
import pytest

import jax.numpy as jnp

from mpc_iris_tpu.constants import BITS, MAX_ROTATION, N_ROTATIONS
from mpc_iris_tpu.ops.decode import (
    decode_distance,
    decode_distance_batch_np,
    fraction_argmin,
    fraction_min_rotations,
    numerators,
)
from mpc_iris_tpu.ops.dot import (
    dot_bits_batch,
    dot_share_batch,
    dot_u16_oracle,
    planes_to_shares,
    shares_to_planes,
)
from mpc_iris_tpu.ops.encode import (
    decode_encoded,
    encode_grid_i8,
    encode_template,
    pack_bits,
    unpack_bits,
)
from mpc_iris_tpu.types import Bits, EncodedBits, Template

from oracles import bit_at


class TestPackUnpack:
    def test_roundtrip_np(self, rng):
        raw = rng.integers(0, 256, size=(3, 200), dtype=np.uint8)
        bits = unpack_bits(raw, xp=np)
        assert bits.shape == (3, 1600)
        assert np.array_equal(pack_bits(bits, xp=np), raw)

    def test_matches_numpy_unpackbits(self, rng):
        raw = rng.integers(0, 256, size=1600, dtype=np.uint8)
        assert np.array_equal(
            unpack_bits(raw, xp=np), np.unpackbits(raw, bitorder="little")
        )

    def test_jnp_matches_np(self, rng):
        raw = rng.integers(0, 256, size=(2, 100), dtype=np.uint8)
        assert np.array_equal(np.asarray(unpack_bits(jnp.asarray(raw))),
                              unpack_bits(raw, xp=np))


class TestEncode:
    def test_preprocess_table(self, rng):
        """Mirror of reference test_preprocess: encode in {0, 1, 0xFFFF} keyed on
        (mask, pattern) per bit (src/lib.rs:117-132)."""
        t = Template.random(rng)
        enc = encode_template(t)
        praw, mraw = t.pattern.to_bytes(), t.mask.to_bytes()
        for i in rng.integers(0, BITS, size=500):
            i = int(i)
            v = int(enc.data[i])
            m, p = bit_at(mraw, i), bit_at(praw, i)
            if v == 0xFFFF:
                assert m == 1 and p == 1
            elif v == 0:
                assert m == 0
            elif v == 1:
                assert m == 1 and p == 0
            else:
                pytest.fail(f"invalid encode value {v}")

    def test_i8_matches_u16_mod(self, rng):
        t = Template.random(rng)
        p = unpack_bits(t.pattern.data, xp=np)
        m = unpack_bits(t.mask.data, xp=np)
        enc16 = encode_template(t).data.astype(np.int32)
        enc8 = encode_grid_i8(p, m, xp=np).astype(np.int32)
        assert np.array_equal(enc8 & 0xFFFF, enc16)

    def test_dotproduct_identity(self, rng):
        """Mirror of reference test_dotproduct (src/lib.rs:134-163):
        dot = #equal - #unequal; denominator = #equal + #unequal."""
        a, b = Template.random(rng), Template.random(rng)
        ea, eb = encode_template(a), encode_template(b)
        equal = uneq = den = 0
        ap, am = a.pattern.to_bytes(), a.mask.to_bytes()
        bp, bm = b.pattern.to_bytes(), b.mask.to_bytes()
        for i in range(BITS):
            if bit_at(am, i) and bit_at(bm, i):
                den += 1
                if bit_at(ap, i) == bit_at(bp, i):
                    equal += 1
                else:
                    uneq += 1
        dot = (ea * eb).sum()
        assert dot == (equal - uneq) & 0xFFFF
        assert den == equal + uneq
        assert a.mask.dot(b.mask) == den

    def test_decrypt_roundtrip(self, rng):
        """encode -> decode recovers mask exactly and pattern up to masked-out bits."""
        t = Template.random(rng)
        back = decode_encoded(encode_template(t))
        assert back.mask == t.mask
        assert (back.pattern & back.mask) == (t.pattern & t.mask)
        assert (back.pattern & ~back.mask) == Bits()


class TestDotKernels:
    def test_dot_bits_popcount(self, rng):
        """{0,1} int8 matmul == pairwise AND-popcount (dot_bool)."""
        a = rng.integers(0, 2, size=(5, BITS)).astype(np.int8)
        b = rng.integers(0, 2, size=(7, BITS)).astype(np.int8)
        out = np.asarray(dot_bits_batch(jnp.asarray(a), jnp.asarray(b)))
        expect = (a.astype(np.int32) @ b.T.astype(np.int32))
        assert np.array_equal(out, expect)

    def test_planes_roundtrip(self, rng):
        s = rng.integers(0, 1 << 16, size=(4, BITS), dtype=np.uint16)
        lo, hi = shares_to_planes(jnp.asarray(s))
        back = np.asarray(planes_to_shares(lo, hi))
        assert np.array_equal(back, s)

    def test_dot_share_matches_oracle(self, rng):
        """The 2-matmul lo/hi decomposition is bit-identical to wrapping-u16 dot
        (the reference's fast-kernel-vs-scalar bar, src/arch/sve.rs:79-109)."""
        n_q, n_db = 6, 9
        q = rng.integers(-1, 2, size=(n_q, BITS)).astype(np.int8)
        s = rng.integers(0, 1 << 16, size=(n_db, BITS), dtype=np.uint16)
        lo, hi = shares_to_planes(jnp.asarray(s))
        out = np.asarray(dot_share_batch(jnp.asarray(q), lo, hi))
        assert out.dtype == np.uint16
        for i in range(n_q):
            qi = (q[i].astype(np.int64)) & 0xFFFF  # ternary as u16 ring element
            for j in range(n_db):
                assert out[i, j] == dot_u16_oracle(qi, s[j]), (i, j)

    def test_dot_share_extremes(self):
        """All-ones query against extreme share values exercises the offset/carry
        corrections."""
        q = np.ones((1, BITS), dtype=np.int8)
        for val in (0, 1, 127, 128, 255, 256, 32768, 65535):
            s = np.full((1, BITS), val, dtype=np.uint16)
            lo, hi = shares_to_planes(jnp.asarray(s))
            out = np.asarray(dot_share_batch(jnp.asarray(q), lo, hi))
            assert out[0, 0] == (val * BITS) & 0xFFFF, val


class TestDecode:
    def test_numerators(self):
        dots = jnp.asarray(np.array([[5, 65530]], dtype=np.uint16))
        dens = jnp.asarray(np.array([[9, 4]], dtype=np.uint16))
        out = np.asarray(numerators(dots, dens))
        # (9-5)/2 = 2 ; (4 - 65530) mod 2^16 = 10 -> 5
        assert out.tolist() == [[2, 5]]

    def test_decode_distance_reference_semantics(self):
        dots = np.zeros(N_ROTATIONS, dtype=np.uint16)
        dens = np.zeros(N_ROTATIONS, dtype=np.uint16)
        # all 0/0 -> NaN everywhere -> fold keeps +inf
        assert decode_distance(dots, dens) == float("inf")
        dens[3] = 100
        dots[3] = 40  # num = 30, d = 100 -> 0.3
        assert decode_distance(dots, dens) == 0.3

    def test_decode_batch_matches_scalar(self, rng):
        dots = rng.integers(0, 1 << 16, size=(50, N_ROTATIONS), dtype=np.uint16)
        dens = rng.integers(0, 12801, size=(50, N_ROTATIONS), dtype=np.uint16)
        dens[7] = 0  # an all-invalid row
        batch = decode_distance_batch_np(dots, dens)
        for i in range(50):
            assert batch[i] == decode_distance(dots[i], dens[i]), i

    def _exact_min(self, nums, dens):
        best = None
        for k, (n, d) in enumerate(zip(nums, dens)):
            f = Fraction(int(n), int(d)) if d > 0 else None
            if f is not None and (best is None or f < best[0]):
                best = (f, k)
        return best

    def test_fraction_min_rotations_exact(self, rng):
        nums = rng.integers(0, 6400, size=(4, N_ROTATIONS)).astype(np.int32)
        dens = rng.integers(0, 12801, size=(4, N_ROTATIONS)).astype(np.int32)
        dens[2, :] = 0
        n, d, r = (np.asarray(x) for x in fraction_min_rotations(
            jnp.asarray(nums), jnp.asarray(dens), axis=1))
        for i in range(4):
            best = self._exact_min(nums[i], dens[i])
            if best is None:
                assert d[i] == 0
            else:
                assert Fraction(int(n[i]), int(d[i])) == best[0], i

    def test_fraction_argmin_exact_and_ties(self):
        # 2/4 == 1/2 tie -> first index wins; 0-den skipped
        nums = jnp.asarray(np.array([[2, 1, 1, 5]], dtype=np.int32))
        dens = jnp.asarray(np.array([[4, 0, 2, 8]], dtype=np.int32))
        n, d, i = (np.asarray(x) for x in fraction_argmin(nums, dens, axis=1))
        assert (i[0], n[0], d[0]) == (0, 2, 4)
        # strictly smaller later value wins
        nums = jnp.asarray(np.array([[2, 1]], dtype=np.int32))
        dens = jnp.asarray(np.array([[4, 3]], dtype=np.int32))
        n, d, i = (np.asarray(x) for x in fraction_argmin(nums, dens, axis=1))
        assert i[0] == 1

    def test_fraction_argmin_random_vs_exact(self, rng):
        nums = rng.integers(0, 12800, size=(3, 257)).astype(np.int32)
        dens = rng.integers(0, 12801, size=(3, 257)).astype(np.int32)
        n, d, i = (np.asarray(x) for x in fraction_argmin(
            jnp.asarray(nums), jnp.asarray(dens), axis=1))
        for b in range(3):
            best = self._exact_min(nums[b], dens[b])
            assert best is not None
            f, k = best
            assert Fraction(int(n[b]), int(d[b])) == f
            assert i[b] == k, "ties must keep the first index"

    def test_fraction_argmin_offset(self):
        nums = jnp.asarray(np.array([[1, 0]], dtype=np.int32))
        dens = jnp.asarray(np.array([[2, 2]], dtype=np.int32))
        _, _, i = fraction_argmin(nums, dens, axis=1, index_offset=100)
        assert int(i[0]) == 101


class TestShareSplitDevice:
    def test_reconstructs_to_encoding(self, rng):
        from mpc_iris_tpu.ops.encode import (
            encode_grid_u16, share_split_device, unpack_bits,
        )

        key = bytes(range(32))
        pats = rng.integers(0, 256, (3, 1600), dtype=np.uint8)
        msks = rng.integers(0, 256, (3, 1600), dtype=np.uint8)
        shares = np.asarray(share_split_device(pats, msks, 4, key))
        assert shares.shape == (4, 3, 12800)
        total = shares[0].copy()
        for s in shares[1:]:
            total += s  # uint16 wraps
        ref = np.asarray(encode_grid_u16(
            unpack_bits(pats, xp=np), unpack_bits(msks, xp=np), xp=np
        )).astype(np.uint16)
        np.testing.assert_array_equal(total, ref)
        # randomness sanity: the random shares are not degenerate
        assert len(np.unique(shares[0])) > 1000

    def test_device_prepare_matches_host_prepare(self, rng):
        """Device and host prepare are byte-identical for the same key
        (both draw the SPEC section 4.1 addressable ChaCha20 streams)."""
        from mpc_iris_tpu import native
        from mpc_iris_tpu.ops.encode import share_split_device

        key = native.derive_insecure_key(77)
        pats = rng.integers(0, 256, (5, 1600), dtype=np.uint8)
        msks = rng.integers(0, 256, (5, 1600), dtype=np.uint8)
        dev = np.asarray(share_split_device(pats, msks, 3, key, row_offset=9))
        enc = native.encode_u16_native(pats, msks)
        host = native.share_split(enc, 3, key, row_offset=9)
        np.testing.assert_array_equal(dev, np.asarray(host))


class TestSelectionOrderTheorem:
    """SPEC 5.1: on this domain (0 <= n <= d <= 12,800) the reference's f64
    quotient order IS the exact rational order — distinct fractions are
    >= 1/12,800^2 apart while correctly-rounded quotients are perturbed
    < 2^-52, so exact-rational selection is bit-identical to the reference's
    f64 compare chain, index and value. These tests pin the theorem at its
    adversarial extremes."""

    D = 12_800

    def test_farey_neighbor_extremes(self):
        """The tightest possible gaps: pairs with |n1*d2 - n2*d1| == 1 at
        the maximal denominators (Farey neighbors of 12,799/12,800). Every
        such pair must have distinct f64 quotients in the exact order."""
        d1, d2 = self.D - 1, self.D
        # n2/d2 vs n1/d1 with n1*d2 - n2*d1 = ±1: since d2 ≡ 1 (mod d1),
        # n1 ≡ ±1 (mod d1) gives integer n2 = (n1*d2 ∓ 1)/d1.
        pairs = []
        for n1 in (1, d1 - 1):
            for sign in (1, -1):
                num = n1 * d2 - sign
                if num % d1 == 0 and 0 <= num // d1 <= d2:
                    pairs.append((n1, d1, num // d1, d2))
        assert pairs, "construction produced no Farey pairs"
        for n1, dd1, n2, dd2 in pairs:
            assert abs(n1 * dd2 - n2 * dd1) == 1  # minimal possible gap
            q1 = np.float64(n1) / np.float64(dd1)
            q2 = np.float64(n2) / np.float64(dd2)
            assert q1 != q2
            assert (q1 < q2) == (Fraction(n1, dd1) < Fraction(n2, dd2))

    def test_f64_order_equals_exact_order_randomized(self):
        """Randomized sweep including near-tie pairs: the f64 quotient order
        must equal the exact rational order for every sampled pair."""
        rng = np.random.default_rng(0xF64)
        d = rng.integers(1, self.D + 1, size=4096)
        n = (rng.random(4096) * (d + 1)).astype(np.int64)
        n = np.minimum(n, d)
        # adversarial near-ties: for random (n1, d1) pick n2 = round(n1*d2/d1)
        d1, n1 = d[:2048], n[:2048]
        d2 = rng.integers(1, self.D + 1, size=2048)
        n2 = np.minimum(np.round(n1 * d2 / d1).astype(np.int64), d2)
        q1 = n1.astype(np.float64) / d1
        q2 = n2.astype(np.float64) / d2
        cross1 = n1 * d2
        cross2 = n2 * d1
        distinct = cross1 != cross2
        # distinct rationals -> distinct f64s, in the exact order
        assert (q1[distinct] != q2[distinct]).all()
        assert ((q1 < q2) == (cross1 < cross2))[distinct].all()
        # equal rationals -> equal f64s (both sides then tie on index)
        assert (q1[~distinct] == q2[~distinct]).all()

    def test_device_argmin_equals_f64_argmin(self):
        """End to end: the device exact-rational argmin over a spectrum with
        planted near-ties equals a host f64 argmin implementing the
        reference's fold (strict-less update = earliest index on ties)."""
        from mpc_iris_tpu.ops.decode import fraction_argmin

        rng = np.random.default_rng(7)
        n_ent = 513
        d = rng.integers(1, self.D + 1, size=n_ent).astype(np.int32)
        n = np.minimum((rng.random(n_ent) * d).astype(np.int32), d)
        d[100] = 0  # invalid: +inf, must never win
        # plant exact duplicates of the running minimum (index tie)
        jmin = int(np.argmin(np.where(d > 0, n / np.where(d > 0, d, 1), 2.0)))
        n[400], d[400] = n[jmin], d[jmin]
        nw, dw, iw = (int(x) for x in np.asarray(fraction_argmin(
            jnp.asarray(n), jnp.asarray(d), axis=0)))
        # reference fold: f64 quotients, strict-less update, NaN/0-den skipped
        best, best_i = np.inf, -1
        for j in range(n_ent):
            if d[j] == 0:
                continue
            q = np.float64(n[j]) / np.float64(d[j])
            if q < best:
                best, best_i = q, j
        assert (iw, np.float64(nw) / np.float64(dw)) == (best_i, best)
