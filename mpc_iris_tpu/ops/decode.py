"""Distance decoding and f64-free minimum selection.

The reference decodes per-entry distances on the coordinator (src/lib.rs:97-107):

    numerator n_r = (d_r.wrapping_sub(dot_r)) / 2        (u16, exact: = #unequal)
    distance     = min over 31 rotations of n_r / d_r    (f64; 0/0 = NaN is skipped
                                                          by the f64::min fold)

and tracks the running argmin over DB entries in f64 (src/main.rs:581-621).

The device needs no f64: n <= 32,767 and d <= 65,535, so the exact
rational order of n1/d1 vs n2/d2 is decided by the int32 comparison
n1*d2 < n2*d1 (products <= 32,767 * 65,535 < 2^31). Entries with d == 0 are treated as
+infinity, which reproduces the reference's NaN-skipping min fold (NaN and +inf both
lose every `<` comparison, and an all-invalid entry keeps distance = +inf).

Device selection therefore returns the *winning integer pair* (n, d) plus index; the
reported f64 value is then computed on the host with exactly the reference's formula,
giving bit-identical results (ties in the exact rational order are broken toward the
lower index / earlier rotation, matching the reference's strict-less updates).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax



def numerators(dots, dens):
    """u16 numerators from dot shares and denominators.

    ``n = (d - dot) mod 2^16 >> 1`` — the wrapping subtraction of
    reference src/lib.rs:104. Accepts any matching shapes; returns int32 (values fit
    u16).
    """
    d = jnp.asarray(dens).astype(jnp.int32)
    t = jnp.asarray(dots).astype(jnp.int32)
    return ((d - t) & jnp.int32(0xFFFF)) >> 1


def _frac_less(n1, d1, n2, d2):
    """Exact: (n1/d1) < (n2/d2) with d == 0 treated as +inf."""
    v1 = d1 > 0
    v2 = d2 > 0
    return (v1 & ~v2) | (v1 & v2 & (n1 * d2 < n2 * d1))


def _frac_select(n1, d1, i1, n2, d2, i2):
    """Select the smaller fraction; ties (and both-invalid) keep the smaller index.

    Single pair of int32 cross-products; validity is folded in by keying invalid (d == 0) entries to +inf-like behavior.
    """
    p1 = n1 * d2
    p2 = n2 * d1
    v1 = d1 > 0
    v2 = d2 > 0
    less = (v1 & ~v2) | (v1 & v2 & (p1 < p2))
    greater = (v2 & ~v1) | (v1 & v2 & (p2 < p1))
    pick1 = less | (~greater & (i1 <= i2))
    return (
        jnp.where(pick1, n1, n2),
        jnp.where(pick1, d1, d2),
        jnp.where(pick1, i1, i2),
    )


def fraction_min_rotations(nums, dens, axis=-1):
    """Reduce the rotation axis: per entry, the minimal (n, d) fraction.

    Args: int32 arrays [..., 31] (or ``axis`` elsewhere). Returns (n, d, r) int32
    arrays without that axis, r being the winning rotation slot 0..30 (rotation
    r - 15). Static 31-way tree of elementwise selects.
    """
    nums = jnp.asarray(nums, dtype=jnp.int32)
    dens = jnp.asarray(dens, dtype=jnp.int32)
    axis = axis % nums.ndim
    k = nums.shape[axis]
    # Slice (not moveaxis) so every leaf reads the original buffer and the whole
    # static select tree fuses into one elementwise pass.
    shape = tuple(s for a, s in enumerate(nums.shape) if a != axis)
    items = [
        (
            lax.index_in_dim(nums, i, axis, keepdims=False),
            lax.index_in_dim(dens, i, axis, keepdims=False),
            jnp.full(shape, i, dtype=jnp.int32),
        )
        for i in range(k)
    ]
    while len(items) > 1:
        nxt = []
        for j in range(0, len(items) - 1, 2):
            nxt.append(_frac_select(*items[j], *items[j + 1]))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def fraction_argmin(nums, dens, axis=-1, index_offset=0):
    """Argmin of exact fractions along ``axis`` via a vectorized halving tree.

    Args:
      nums, dens: int32 arrays of matching shape.
      index_offset: added to the returned indices (may be traced, for chunked scans).

    Returns (n, d, idx) int32 arrays with ``axis`` reduced; ties keep the smallest
    index. A log2(n) sequence of elementwise selects, which XLA fuses into
    plain elementwise passes (an XLA variadic reduce with a custom comparator
    is a harder pattern for its emitters).
    """
    nums = jnp.asarray(nums, dtype=jnp.int32)
    dens = jnp.asarray(dens, dtype=jnp.int32)
    axis = axis % nums.ndim
    n = nums.shape[axis]
    nums = jnp.moveaxis(nums, axis, -1)
    dens = jnp.moveaxis(dens, axis, -1)
    idx_shape = [1] * nums.ndim
    idx_shape[-1] = n
    # index_offset may be a traced scalar (chunked scans), so add it after arange.
    idx = jnp.arange(n, dtype=jnp.int32) + jnp.asarray(index_offset, jnp.int32)
    idx = jnp.broadcast_to(idx.reshape(idx_shape), nums.shape)

    # Pad to a power of two with invalid (d = 0) entries that lose every compare.
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        pad = [(0, 0)] * (nums.ndim - 1) + [(0, pow2 - n)]
        nums = jnp.pad(nums, pad)
        dens = jnp.pad(dens, pad)
        idx = jnp.pad(idx, pad, constant_values=2**31 - 1)

    while pow2 > 1:
        half = pow2 // 2
        nums, dens, idx = _frac_select(
            nums[..., :half], dens[..., :half], idx[..., :half],
            nums[..., half:], dens[..., half:], idx[..., half:],
        )
        pow2 = half
    return nums[..., 0], dens[..., 0], idx[..., 0]


def running_min(state, n, d, i):
    """Fold a new (n, d, idx) candidate batch result into carried best state
    (for lax.scan over DB chunks)."""
    return _frac_select(*state, n, d, i)


def fold_candidates(n, d, idx, axis=-1):
    """Fold candidate winner triples along ``axis`` (ties keep the lower idx,
    which need not follow slot order — e.g. per-shard winners)."""
    axis = axis % n.ndim
    size = n.shape[axis]
    n = jnp.moveaxis(n, axis, -1)
    d = jnp.moveaxis(d, axis, -1)
    idx = jnp.moveaxis(idx, axis, -1)
    pow2 = 1 << (size - 1).bit_length()
    if pow2 != size:
        pad = [(0, 0)] * (n.ndim - 1) + [(0, pow2 - size)]
        n = jnp.pad(n, pad)
        d = jnp.pad(d, pad)  # d == 0 pads lose every compare
        idx = jnp.pad(idx, pad, constant_values=2**31 - 1)
    while pow2 > 1:
        half = pow2 // 2
        n, d, idx = _frac_select(
            n[..., :half], d[..., :half], idx[..., :half],
            n[..., half:], d[..., half:], idx[..., half:],
        )
        pow2 = half
    return n[..., 0], d[..., 0], idx[..., 0]


# ----------------------------------------------------------------- host decode (f64)


def decode_distance(dots, dens) -> float:
    """Reference-exact f64 decode of one entry's 31 (dot, den) pairs
    (src/lib.rs:97-107). Host-side NumPy; used for reported values and as the oracle.
    """
    dots = np.asarray(dots, dtype=np.uint16).astype(np.int64)
    dens = np.asarray(dens, dtype=np.uint16).astype(np.int64)
    n = ((dens - dots) & 0xFFFF) >> 1
    best = float("inf")
    for nr, dr in zip(n.tolist(), dens.tolist()):
        with np.errstate(invalid="ignore", divide="ignore"):
            v = float(np.float64(nr) / np.float64(dr))
        if v < best:  # NaN compares false -> skipped, like Rust f64::min
            best = v
    return best


def decode_distance_batch_np(dots, dens) -> np.ndarray:
    """Vectorized host decode: [N, 31] u16 dots & dens -> [N] f64 distances.

    Bit-identical to :func:`decode_distance` per row (correctly-rounded f64 division
    and NaN-skipping min), but vectorized for the coordinator's bulk decode path
    (reference src/main.rs:597-612).
    """
    dots = np.asarray(dots, dtype=np.uint16).astype(np.int64)
    dens = np.asarray(dens, dtype=np.uint16).astype(np.int64)
    n = ((dens - dots) & 0xFFFF) >> 1
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = n.astype(np.float64) / dens.astype(np.float64)
    # NaN-skipping min per row; all-NaN rows give +inf.
    vals = np.where(np.isnan(vals), np.inf, vals)
    return vals.min(axis=-1)


def fractions_to_f64_np(nums, dens) -> np.ndarray:
    """Vectorized host decode of (numerator, denominator) pairs to f64.

    Correctly-rounded f64 division per element (bit-identical to
    :func:`fraction_to_f64`); d == 0 collapses to +inf (the reference's
    0/0 -> NaN -> skipped-by-min-fold semantics)."""
    n = np.asarray(nums, dtype=np.int64)
    d = np.asarray(dens, dtype=np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = n.astype(np.float64) / d.astype(np.float64)
    return np.where(d == 0, np.inf, vals)


def under_threshold_mask_np(nums, dens, threshold: float) -> np.ndarray:
    """EXACT boolean mask of ``n/d < threshold`` per element (d == 0 never
    matches: an all-invalid comparison has distance +inf).

    The comparison is exact in the rational order — ``threshold`` (a finite
    f64) is interpreted as the exact binary rational it represents. Fast
    path: the correctly-rounded f64 quotient decides every element whose
    quotient differs from the threshold (monotone rounding to a representable
    bound cannot cross it); elements whose f64 quotient EQUALS the threshold
    are the only ambiguous ones (the true rational may be on either side) and
    are settled with arbitrary-precision integer cross-products. This keeps
    uniqueness verdicts exact even for thresholds adversarially placed on a
    representable distance (strict ``<``: an exactly-equal distance is NOT
    under the threshold) — the same strictness as the reference's f64
    ``<`` compare in its running argmin (src/main.rs:613-621).
    """
    n = np.asarray(nums, dtype=np.int64)
    d = np.asarray(dens, dtype=np.int64)
    t = float(threshold)
    valid = d > 0
    if np.isnan(t) or t <= 0.0:
        return np.zeros(n.shape, dtype=bool)
    if np.isinf(t):
        return valid  # every valid distance is < +inf
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = n.astype(np.float64) / d.astype(np.float64)
    definite = valid & (vals < t)
    ambiguous = valid & (vals == t)
    if ambiguous.any():
        # Settle n/d vs tn/td by exact cross-products, VECTORIZED: a served
        # audit client can place the threshold exactly on a popular
        # representable distance (e.g. 1/2) and push the whole DB through
        # this branch, so it must stay O(ms) at millions of entries.
        tn, td = t.as_integer_ratio()
        na = n[ambiguous]
        da = d[ambiguous]
        # int64 is exact when both cross-products fit: n,d here are u16-ish
        # (n <= 32767, d <= 65535), but bound against the actual data so
        # arbitrary int64 inputs stay correct too.
        nmax = int(abs(na).max(initial=0))
        dmax = int(da.max(initial=0))
        if tn * dmax < 2**63 and td * max(nmax, 1) < 2**63:
            res = na * np.int64(td) < np.int64(tn) * da
        else:
            # Extreme thresholds (subnormal/huge as_integer_ratio terms):
            # exact arbitrary-precision math over object-dtype arrays —
            # still one vectorized pass, no Python-level indexing loop.
            res = (na.astype(object) * td < tn * da.astype(object)
                   ).astype(bool)
        definite[ambiguous] = res
    return definite


def fraction_to_f64(n: int, d: int) -> float:
    """Host f64 of a winning integer pair, with the reference's 0/0 -> NaN -> +inf
    min-fold semantics collapsed to +inf."""
    if d == 0:
        return float("inf")
    return float(np.float64(int(n)) / np.float64(int(d)))
