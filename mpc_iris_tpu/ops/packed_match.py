"""Pallas kernel (Triton route): small-batch fraction spectrum straight from
the BIT-PACKED DB planes.

The serving shapes — one query per connection (reference
src/main.rs:411-447) and the few-query threshold audit — are bound by
memory traffic, not by multiply-adds. The XLA scan unpacks every chunk into
int8 encoding and mask planes in device memory (25.6 KB per entry written
and read back) before its GEMMs; the packed planes themselves are only
3.2 KB per entry. This kernel reads the packed bytes once and never
materializes the planes:

- each program owns ``tile_n`` DB entries of one chunk;
- it walks K in 64-byte slabs of the packed row (1600 = 25 x 64 bytes), and
  for each slab unpacks the 8 bit-planes in registers to int8 encodings
  {-1, 0, 1} and masks {0, 1};
- each unpacked plane feeds two int8 x int8 -> int32 tensor-core dots against
  the matching K rows of the (bit-plane-major) query block;
- after the K loop it takes the exact rational minimum over the rotations
  in registers and writes one ``n | d << 16`` word per (query, entry).

The K order is bit-plane-major (k = bit * 1600 + byte): the dot is invariant
under one permutation applied to both operands' K axes, and in this order
each unpacked bit-plane of a byte slab is a contiguous K slab, so only the
small query side is permuted, once per batch.

Programs run in no order and carry nothing between them. The argmin over
entries (for :func:`match_packed_small_b`) is an XLA reduction over the
spectrum, which is 4 bytes per (query, entry) against the 3,200 bytes of DB
each entry costs to read.

Exact selection without a custom comparator: Triton reduces only with its
built-in combiners, so each fraction n/d (n <= d <= 12,800) is mapped to the
integer key floor(n * 2^28 / d). Two distinct fractions differ by at least
1 / (d1 * d2) > 2^-28, so the key is strictly monotone in the rational
value and equal fractions share a key; ``argmin`` over keys therefore picks
the minimal fraction and, on ties, the earliest rotation — the semantics of
``ops.decode.fraction_min_rotations``. d == 0 (invalid) keys to int32 max.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mpc_iris_tpu.constants import BITS, BITS_BYTES, N_ROTATIONS
from mpc_iris_tpu.ops.decode import fraction_argmin

PLANE = BITS_BYTES  # 1600 packed bytes per entry = one bit-plane's K slab
SLAB = 64  # packed bytes per K step (1600 = 25 * 64)
ROT_PAD = 32  # rotation rows per query, padded to a power of two
# Largest batch the kernel serves. B=5..7 pad to the B=8 query block, where
# the XLA scan is faster on the H100 (PERF.md); larger batches use the scan.
SMALL_B_MAX = 4
_INVALID_KEY = 2**31 - 1


def tile_for(b: int) -> int:
    """Entries per program: the int32 accumulators hold 2 * tile * 32 * B'
    values (B' = B padded to a power of two), so the tile shrinks as the
    query block grows to keep them in registers. Measured on the H100 at 1M
    entries (PERF.md): 64 is fastest at B=1, 32 at B=2..4."""
    return 64 if b == 1 else 32


def _pow2(b: int) -> int:
    return 1 << (b - 1).bit_length()


def small_b_ok(b: int, chunk: int) -> bool:
    """True when the kernel serves this shape: 1..SMALL_B_MAX queries and a
    chunk that the entry tile divides (otherwise the XLA scan does)."""
    return 1 <= b <= SMALL_B_MAX and chunk % tile_for(b) == 0


@functools.cache
def _bitplane_perm() -> np.ndarray:
    """K permutation natural -> bit-plane-major: position j = bit*1600 + byte
    holds natural index byte*8 + bit (bit i lives at byte i//8, bit i%8,
    LSB-first; reference src/bits.rs:44-57). A host array: caching a jnp
    array would capture the first trace's tracer."""
    j = np.arange(BITS)
    return (j % PLANE) * 8 + j // PLANE


def _query_block(q, bp: int):
    """int8 [B, 31, K] natural-order query planes -> int8 [K, bp*32] in
    bit-plane-major K order; padded rotation rows and padded queries are
    all-zero (mask 0 -> den 0 -> invalid)."""
    b = q.shape[0]
    q = jnp.pad(q, ((0, bp - b), (0, ROT_PAD - N_ROTATIONS), (0, 0)))
    q = q[:, :, jnp.asarray(_bitplane_perm())]
    return q.reshape(bp * ROT_PAD, BITS).T


def _fraction_key(n, d):
    """Exact order key of n/d for 0 <= n <= d <= 12,800: floor(n * 2^28 / d)
    by two base-2^14 long-division steps in int32; d == 0 -> int32 max."""
    ds = jnp.maximum(d, 1)
    hi = jax.lax.div(n << 14, ds)
    lo = jax.lax.div(jax.lax.rem(n << 14, ds) << 14, ds)
    return jnp.where(d > 0, (hi << 14) | lo, _INVALID_KEY)


def _spectrum_kernel(qe_ref, qm_ref, pat_ref, msk_ref, out_ref, *, bp, tile_n):
    m = bp * ROT_PAD

    def k_step(step, acc):
        # One loop over (slab, bit) pairs: a single dot pair per iteration
        # keeps the shared-memory staging to one operand set per pipeline
        # stage (unrolling the 8 bits multiplies it by 8).
        acc_dot, acc_den = acc
        j, bit = jax.lax.div(step, 8), jax.lax.rem(step, 8)
        start = pl.multiple_of(j * SLAB, SLAB)
        pat = pat_ref[:, pl.ds(start, SLAB)]  # uint8 [tile_n, 64]
        msk = msk_ref[:, pl.ds(start, SLAB)]
        shift = bit.astype(jnp.uint8)
        p_b = (pat >> shift) & 1
        m_b = (msk >> shift) & 1
        m8 = m_b.astype(jnp.int8)
        e8 = jnp.where((p_b & m_b) != 0, jnp.int8(-1), m8)
        rows = pl.ds(pl.multiple_of(bit * PLANE + start, SLAB), SLAB)
        acc_dot += jax.lax.dot(e8, qe_ref[rows, :],
                               preferred_element_type=jnp.int32)
        acc_den += jax.lax.dot(m8, qm_ref[rows, :],
                               preferred_element_type=jnp.int32)
        return acc_dot, acc_den

    zero = jnp.zeros((tile_n, m), jnp.int32)
    dot, den = jax.lax.fori_loop(0, 8 * (PLANE // SLAB), k_step,
                                 (zero, zero))
    # Plaintext path: den - dot = 2 * #unequal >= 0, exact in int32.
    num = ((den - dot) >> 1).reshape(tile_n, bp, ROT_PAD)
    den = den.reshape(tile_n, bp, ROT_PAD)
    rot = jnp.argmin(_fraction_key(num, den), axis=2)  # earliest on ties
    pick = jax.lax.broadcasted_iota(jnp.int32, num.shape, 2) == rot[:, :, None]
    n = jnp.sum(jnp.where(pick, num, 0), axis=2)
    d = jnp.sum(jnp.where(pick, den, 0), axis=2)
    out_ref[...] = (n | (d << 16)).T  # [bp, tile_n]


@functools.partial(jax.jit, static_argnames=("interpret",))
def fractions_packed_small_b(q_enc, q_mask, db_pat, db_msk, *,
                             interpret=False):
    """Per-entry min-over-31-rotations exact fractions over a bit-packed DB.

    Args:
      q_enc, q_mask: int8 [B, 31, K] prepared query planes (natural K order,
        engines.prepare_query_planes), 1 <= B <= SMALL_B_MAX.
      db_pat, db_msk: uint8 [C, c, 1600] packed chunks (c divisible by
        ``tile_for(B)``; padded entries all-zero: mask 0 -> d 0 -> invalid).

    Returns uint16 [2, B, C*c] (numerator, denominator) pairs — the values of
    `engines._fractions_scan_packed` (padded rows report d == 0; callers trim
    to the true count).
    """
    b = q_enc.shape[0]
    bp = _pow2(b)
    tile_n = tile_for(b)
    n_chunks, chunk = db_pat.shape[0], db_pat.shape[1]
    tiles = chunk // tile_n
    m = bp * ROT_PAD
    db_spec = pl.BlockSpec((None, tile_n, PLANE), lambda i, t: (i, t, 0))
    q_spec = pl.BlockSpec((BITS, m), lambda i, t: (0, 0))
    out = pl.pallas_call(
        functools.partial(_spectrum_kernel, bp=bp, tile_n=tile_n),
        grid=(n_chunks, tiles),
        in_specs=[q_spec, q_spec, db_spec, db_spec],
        out_specs=pl.BlockSpec(
            (bp, tile_n), lambda i, t, _tiles=tiles: (0, i * _tiles + t)),
        out_shape=jax.ShapeDtypeStruct((bp, n_chunks * chunk), jnp.int32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="packed_spectrum",
    )(_query_block(q_enc, bp), _query_block(q_mask, bp), db_pat, db_msk)[:b]
    n = (out & 0xFFFF).astype(jnp.uint16)
    d = jax.lax.shift_right_logical(out, 16).astype(jnp.uint16)
    return jnp.stack([n, d])


@functools.partial(jax.jit, static_argnames=("interpret",))
def match_packed_small_b(q_enc, q_mask, db_pat, db_msk, *, interpret=False):
    """Small-batch match over a bit-packed DB: the kernel's spectrum, then
    the exact argmin over entries in XLA (ties to the lowest index).

    Returns int32 [3, B] stacked (numerator, denominator, index), identical
    to `engines._match_scan_packed`."""
    nd = fractions_packed_small_b(q_enc, q_mask, db_pat, db_msk,
                                  interpret=interpret).astype(jnp.int32)
    n, d, i = fraction_argmin(nd[0], nd[1], axis=-1)
    return jnp.stack([n, d, i])
