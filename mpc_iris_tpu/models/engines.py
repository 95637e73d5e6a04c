"""Single-chip match engines over an HBM-resident template database.

Roles mirrored from the reference:

- :class:`ShareEngine`     == participant's `DistanceEngine` (src/lib.rs:28-52): dot
                              shares of rotated encoded queries against a u16 share DB.
- :class:`MasksEngine`     == coordinator's `MasksEngine` (src/lib.rs:55-80):
                              denominator popcounts against the plaintext masks DB.
- :class:`PlaintextEngine` == the scalar oracle `Template::distance`
                              (src/template.rs:43-64) industrialized: full fused
                              min-distance search (distances + denominators + exact
                              argmin) in one jitted chunk-scan — the non-MPC flagship
                              path and the per-party compute shape of the MPC path.

Design notes:
- The DB is laid out [num_chunks, chunk, K] (K = 12,800) so a `lax.scan` streams it
  through int8 GEMMs with bounded intermediates.
- Queries are expanded to 31 rotations on device (LHS rows), never the DB.
- Selection is exact integer fraction comparison (ops/decode.py); f64 only on host.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from mpc_iris_tpu.constants import BITS, COLS, N_ROTATIONS, ROWS
from mpc_iris_tpu.ops.decode import (
    fraction_argmin,
    fraction_min_rotations,
    fraction_to_f64,
    running_min,
)
from mpc_iris_tpu.ops.dot import (
    dot_bits_batch,
    dot_share_batch,
    kernel_self_test,
)
from mpc_iris_tpu.ops.encode import encode_grid_i8, unpack_bits
from mpc_iris_tpu.ops.packed_match import (
    fractions_packed_small_b,
    match_packed_small_b,
    small_b_ok,
)
from mpc_iris_tpu.ops.rotations import expand_rotations_flat

# Entries per scan step. It fits the H100 at every batch the repo serves,
# but it is not tuned there.
DEFAULT_CHUNK = 8192


# --------------------------------------------------------------------- query prep


@jax.jit
def prepare_query_planes(patterns_packed, masks_packed):
    """Packed query templates -> rotation-expanded matmul LHS planes.

    Args:
      patterns_packed, masks_packed: uint8 [B, 1600] packed bit planes.

    Returns:
      q_enc:  int8 [B, 31, K] with values {-1, 0, 1} (ring encoding, rotated),
      q_mask: int8 [B, 31, K] with values {0, 1} (mask plane, rotated).

    Rotating the encoded/mask grids per rotation r matches the reference, which
    rotates the already-encoded query (src/lib.rs:33-40); rotation and encoding
    commute since encoding is elementwise.
    """
    p = unpack_bits(patterns_packed).reshape(-1, ROWS, COLS)
    m = unpack_bits(masks_packed).reshape(-1, ROWS, COLS)
    enc = encode_grid_i8(p, m)  # [B, ROWS, COLS]
    q_enc = expand_rotations_flat(enc).astype(jnp.int8)  # [B, 31, K]
    q_mask = expand_rotations_flat(m.astype(jnp.int8)).astype(jnp.int8)
    return q_enc, q_mask


def _pad_chunks(arr: np.ndarray, chunk: int, pad_value=0):
    """Host-side: pad leading axis to a multiple of ``chunk`` and reshape to
    [num_chunks, chunk, ...]. Returns (reshaped, true_count)."""
    n = arr.shape[0]
    num_chunks = max(1, -(-n // chunk))
    padded = num_chunks * chunk
    if padded != n:
        pad_width = [(0, padded - n)] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(arr, pad_width, constant_values=pad_value)
    return arr.reshape(num_chunks, chunk, *arr.shape[1:]), n


# --------------------------------------------------------------------- jitted kernels


@jax.jit
def _match_scan(q_enc, q_mask, db_enc, db_mask):
    """Fused plaintext min-distance search.

    q_enc/q_mask: int8 [B, 31, K]; db_enc/db_mask: int8 [C, c, K].
    Returns int32 [3, B]: stacked winning (numerator, denominator, DB index) —
    one array, one host transfer; tuple unpacking (``n, d, i = ...``) still
    works.
    """
    b = q_enc.shape[0]
    qe = q_enc.reshape(b * N_ROTATIONS, BITS)
    qm = q_mask.reshape(b * N_ROTATIONS, BITS)
    chunk = db_enc.shape[1]

    def step(carry, xs):
        enc_c, mask_c, offset = xs
        dot = dot_bits_batch(qe, enc_c).reshape(b, N_ROTATIONS, chunk)
        den = dot_bits_batch(qm, mask_c).reshape(b, N_ROTATIONS, chunk)
        # Plaintext path: den - dot = 2 * #unequal >= 0, exact in int32.
        num = (den - dot) >> 1
        n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)  # [B, c]
        n_c, d_c, i_c = fraction_argmin(n_r, d_r, axis=-1, index_offset=offset)
        return running_min(carry, n_c, d_c, i_c), None

    init = (
        jnp.zeros(b, jnp.int32),
        jnp.zeros(b, jnp.int32),
        jnp.full(b, 2**31 - 1, jnp.int32),
    )
    offsets = jnp.arange(db_enc.shape[0], dtype=jnp.int32) * chunk
    (n, d, i), _ = jax.lax.scan(step, init, (db_enc, db_mask, offsets))
    return jnp.stack([n, d, i])


def match_scan_packed_auto(q_enc, q_mask, db_pat, db_msk):
    """Dispatch for the packed-storage match step: B in 1..SMALL_B_MAX with
    a chunk the kernel tile divides -> the packed small-batch kernel
    (ops/packed_match.py, which reads the packed bytes once instead of
    materializing int8 planes per chunk); anything else -> the XLA scan.
    Both are bit-identical."""
    if small_b_ok(q_enc.shape[0], db_pat.shape[1]):
        return _match_small_b(q_enc, q_mask, db_pat, db_msk)
    return _match_scan_packed(q_enc, q_mask, db_pat, db_msk)


# Pallas compiles the small-batch kernel for CUDA only. Where a program is
# compiled for another platform (the CPU tests and rehearsals), the same
# batch takes the XLA scan; lax.platform_dependent picks at lowering time.
@jax.jit
def _match_small_b(q_enc, q_mask, db_pat, db_msk):
    return jax.lax.platform_dependent(
        q_enc, q_mask, db_pat, db_msk,
        cuda=match_packed_small_b, default=_match_scan_packed)


@jax.jit
def _fractions_small_b(q_enc, q_mask, db_pat, db_msk):
    return jax.lax.platform_dependent(
        q_enc, q_mask, db_pat, db_msk,
        cuda=fractions_packed_small_b, default=_fractions_scan_packed)


@jax.jit
def _match_scan_packed(q_enc, q_mask, db_pat, db_msk):
    """Match scan over a BIT-PACKED DB: uint8 [C, c, 1600] pattern/mask planes.

    Packed storage holds 3.2 KB/entry instead of 25.6 KB/entry at the cost of
    an on-device unpack+encode per chunk. Semantics identical to
    `_match_scan`.
    """
    b = q_enc.shape[0]
    chunk = db_pat.shape[1]
    qe = q_enc.reshape(b * N_ROTATIONS, BITS)
    qm = q_mask.reshape(b * N_ROTATIONS, BITS)

    def step(carry, xs):
        pat_c, msk_c, offset = xs
        p = unpack_bits(pat_c).astype(jnp.int8)  # [c, 12800]
        m = unpack_bits(msk_c).astype(jnp.int8)
        enc_c = encode_grid_i8(p, m)
        dot = dot_bits_batch(qe, enc_c).reshape(b, N_ROTATIONS, chunk)
        den = dot_bits_batch(qm, m).reshape(b, N_ROTATIONS, chunk)
        num = (den - dot) >> 1
        n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)
        n_c, d_c, i_c = fraction_argmin(n_r, d_r, axis=-1, index_offset=offset)
        return running_min(carry, n_c, d_c, i_c), None

    init = (
        jnp.zeros(b, jnp.int32),
        jnp.zeros(b, jnp.int32),
        jnp.full(b, 2**31 - 1, jnp.int32),
    )
    offsets = jnp.arange(db_pat.shape[0], dtype=jnp.int32) * chunk
    (n, d, i), _ = jax.lax.scan(step, init, (db_pat, db_msk, offsets))
    return jnp.stack([n, d, i])


@jax.jit
def _fractions_scan(q_enc, q_mask, db_enc, db_mask):
    """Per-entry minimal fractions over a dense DB scan.

    q_enc/q_mask: int8 [B, 31, K]; db_enc/db_mask: int8 [C, c, K].
    Returns uint16 [2, B, C*c]: per entry the min-over-31-rotations exact
    (numerator, denominator) pair — the full distance *spectrum* of the scan
    (vs `_match_scan`, which folds it to the single argmin winner). Feeds the
    threshold-audit path (`PlaintextEngine.find_under`); both values fit u16
    (num <= den <= 12,800)."""
    b = q_enc.shape[0]
    qe = q_enc.reshape(b * N_ROTATIONS, BITS)
    qm = q_mask.reshape(b * N_ROTATIONS, BITS)
    chunk = db_enc.shape[1]

    def step(_, xs):
        enc_c, mask_c = xs
        dot = dot_bits_batch(qe, enc_c).reshape(b, N_ROTATIONS, chunk)
        den = dot_bits_batch(qm, mask_c).reshape(b, N_ROTATIONS, chunk)
        num = (den - dot) >> 1
        n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)  # [B, c]
        return None, jnp.stack([n_r.astype(jnp.uint16), d_r.astype(jnp.uint16)])

    _, ys = jax.lax.scan(step, None, (db_enc, db_mask))
    # ys: [C, 2, B, c] -> [2, B, C*c]
    return jnp.moveaxis(ys, 0, 2).reshape(2, b, -1)


@jax.jit
def _fractions_scan_packed(q_enc, q_mask, db_pat, db_msk):
    """`_fractions_scan` over BIT-PACKED uint8 [C, c, 1600] DB planes
    (on-device unpack+encode per chunk, same as `_match_scan_packed`)."""
    b = q_enc.shape[0]
    qe = q_enc.reshape(b * N_ROTATIONS, BITS)
    qm = q_mask.reshape(b * N_ROTATIONS, BITS)
    chunk = db_pat.shape[1]

    def step(_, xs):
        pat_c, msk_c = xs
        p = unpack_bits(pat_c).astype(jnp.int8)
        m = unpack_bits(msk_c).astype(jnp.int8)
        enc_c = encode_grid_i8(p, m)
        dot = dot_bits_batch(qe, enc_c).reshape(b, N_ROTATIONS, chunk)
        den = dot_bits_batch(qm, m).reshape(b, N_ROTATIONS, chunk)
        num = (den - dot) >> 1
        n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)
        return None, jnp.stack([n_r.astype(jnp.uint16), d_r.astype(jnp.uint16)])

    _, ys = jax.lax.scan(step, None, (db_pat, db_msk))
    return jnp.moveaxis(ys, 0, 2).reshape(2, b, -1)


def _compact_under_device(nd, t_hi, k):
    """Device-side audit compaction: keep only CANDIDATE entries.

    nd: uint16 [2, B, Np] per-entry minimal (num, den) pairs (on device).
    t_hi: f32 scalar, a CONSERVATIVE upper bound of the threshold — the
    float32 prefilter ``n < t_hi * d`` must be a SUPERSET of the exact
    rational ``n/d < t`` (multiplication-only: n, d <= 65,535 are exact in
    f32, so one correctly-rounded multiply is the only rounding; the caller
    inflates t by ~1e-4 relative, orders of magnitude above that error).
    d == 0 is excluded for free (n < t_hi*0 is false). The EXACT strict-<
    decision happens on host over the compacted candidates.

    TWO-LEVEL compaction: one flat ``at[tgt].set`` over [B, Np] scatters
    every entry, while the candidates are a tiny fraction of them. So:
    first compact the indices of 128-lane BLOCKS containing any candidate
    (a scatter over Np/128 elements), gather those blocks, then
    fine-compact within the gathered [B, kb*128] slab — both scatters are
    orders of magnitude smaller than Np. Blocks are compacted in ascending
    order and lanes are ascending within a block, so candidate indices come
    out globally ascending, exactly like the flat scatter. If candidates
    spread over more than kb blocks, the reported count is forced past k so
    the caller takes the identical-results full-fetch fallback (same
    contract as count overflow).

    Returns (meta int32 [B, k+1], nd_out uint16 [2, B, k]) — two arrays, two
    host fetches: meta[:, 0] = candidate count (may
    exceed k: caller must then fall back to the full fetch), meta[:, 1:] =
    candidate DB indices ascending (-1 padding)."""
    n = nd[0].astype(jnp.float32)
    d = nd[1].astype(jnp.float32)
    mask = n < t_hi * d  # [B, Np] conservative superset
    counts = mask.sum(axis=1).astype(jnp.int32)
    b, np_ = mask.shape

    def scatter(fill, t, s):
        return fill.at[t].set(s, mode="drop")

    lb = 128
    nb = -(-np_ // lb)
    pad = nb * lb - np_
    n_u = nd[0]
    d_u = nd[1]
    if pad:
        # padded lanes: d == 0 -> never a candidate
        mask = jnp.pad(mask, ((0, 0), (0, pad)))
        n_u = jnp.pad(n_u, ((0, 0), (0, pad)))
        d_u = jnp.pad(d_u, ((0, 0), (0, pad)))
    mask3 = mask.reshape(b, nb, lb)
    blk_hit = mask3.any(axis=2)  # [B, nb]
    blk_count = blk_hit.sum(axis=1).astype(jnp.int32)
    # block capacity: enough for 2k candidates even if 128x spread out;
    # small Np degenerates to "all blocks" (capacity == everything)
    kb = min(nb, max(256, -(-2 * k // lb)))

    bpos = jnp.cumsum(blk_hit.astype(jnp.int32), axis=1) - 1
    btgt = jnp.where(blk_hit, bpos, kb)  # kb = out of bounds -> dropped
    bsrc = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32), (b, nb))
    blk_idx = jax.vmap(scatter)(
        jnp.full((b, kb), nb, jnp.int32), btgt, bsrc
    )
    take = blk_idx.clip(0, nb - 1)[:, :, None]  # sentinel -> dup last block
    g_n = jnp.take_along_axis(n_u.reshape(b, nb, lb), take, axis=1)
    g_d = jnp.take_along_axis(d_u.reshape(b, nb, lb), take, axis=1)
    g_idx = (take * lb + jnp.arange(lb, dtype=jnp.int32)).reshape(b, kb * lb)
    g_n = g_n.reshape(b, kb * lb)
    g_d = g_d.reshape(b, kb * lb)
    # valid = real (non-sentinel) block AND candidate lane
    slot_ok = (
        jnp.arange(kb, dtype=jnp.int32)[None, :] < blk_count[:, None]
    )
    g_mask = (
        jnp.repeat(slot_ok, lb, axis=1)
        & (g_n.astype(jnp.float32) < t_hi * g_d.astype(jnp.float32))
    )

    pos = jnp.cumsum(g_mask.astype(jnp.int32), axis=1) - 1
    tgt = jnp.where(g_mask, pos, k)
    idx_out = jax.vmap(scatter)(
        jnp.full((b, k), -1, jnp.int32), tgt, g_idx
    )
    n_out = jax.vmap(scatter)(jnp.zeros((b, k), jnp.uint16), tgt, g_n)
    d_out = jax.vmap(scatter)(jnp.zeros((b, k), jnp.uint16), tgt, g_d)
    # block-capacity overflow forces the caller's full-fetch fallback
    counts = jnp.where(blk_count > kb, jnp.maximum(counts, k + 1), counts)
    meta = jnp.concatenate([counts[:, None], idx_out], axis=1)
    return meta, jnp.stack([n_out, d_out])


# Standalone jit of the compaction for callers whose spectrum already lives
# on device (ShardedPlaintextEngine.find_under); module-level so repeat calls
# hit the jit cache.
_compact_under_jit = functools.partial(
    jax.jit, static_argnames=("k",)
)(_compact_under_device)


@functools.partial(jax.jit, static_argnames=("k",))
def _fractions_under_compact(q_enc, q_mask, db_enc, db_mask, t_hi, k):
    return _compact_under_device(
        _fractions_scan(q_enc, q_mask, db_enc, db_mask), t_hi, k
    )


def fractions_scan_packed_auto(q_enc, q_mask, db_pat, db_msk):
    """Audit-spectrum dispatch for packed storage, the policy of
    :func:`match_scan_packed_auto`: small batches -> the packed kernel, else
    the scan. Identical uint16 [2, B, N_padded] values either way."""
    if small_b_ok(q_enc.shape[0], db_pat.shape[1]):
        return _fractions_small_b(q_enc, q_mask, db_pat, db_msk)
    return _fractions_scan_packed(q_enc, q_mask, db_pat, db_msk)


@functools.partial(jax.jit, static_argnames=("k",))
def fractions_under_compact_packed_auto(q_enc, q_mask, db_pat, db_msk,
                                        t_hi, k):
    """Fused spectrum+compaction (same policy as
    :func:`fractions_scan_packed_auto`); one device dispatch either way."""
    return _compact_under_device(
        fractions_scan_packed_auto(q_enc, q_mask, db_pat, db_msk), t_hi, k)


@jax.jit
def _unpack_encode_chunk(pat_c, msk_c):
    """Packed uint8 [c, 1600] plane pair -> (enc, mask) int8 [c, 12800]
    (the per-chunk on-device unpack the packed scans fuse inline; exposed
    for utilities like distances() that need the dense chunk directly)."""
    p = unpack_bits(pat_c).astype(jnp.int8)
    m = unpack_bits(msk_c).astype(jnp.int8)
    return encode_grid_i8(p, m), m


@jax.jit
def _plaintext_chunk_fractions(q_enc, q_mask, enc_c, mask_c):
    """Per-entry per-rotation (num, den) for one chunk: int32 [B, c, 31] each."""
    b = q_enc.shape[0]
    chunk = enc_c.shape[0]
    dot = dot_bits_batch(q_enc.reshape(b * N_ROTATIONS, BITS), enc_c)
    den = dot_bits_batch(q_mask.reshape(b * N_ROTATIONS, BITS), mask_c)
    dot = dot.reshape(b, N_ROTATIONS, chunk).transpose(0, 2, 1)
    den = den.reshape(b, N_ROTATIONS, chunk).transpose(0, 2, 1)
    return (den - dot) >> 1, den


@jax.jit
def _share_dots_chunk(q_enc, db_lo, db_hi):
    """Dot shares for one chunk: uint16 [B, c, 31] in wire order
    (entry-major, rotations -15..15 innermost; reference src/main.rs:428-434)."""
    b = q_enc.shape[0]
    chunk = db_lo.shape[0]
    dots = dot_share_batch(q_enc.reshape(b * N_ROTATIONS, BITS), db_lo, db_hi)
    return dots.reshape(b, N_ROTATIONS, chunk).transpose(0, 2, 1)


@jax.jit
def _shares_reformat(chunk_u16):
    """Raw u16 share chunk [c, K] -> stacked int8 [2, c, K] (lo, hi) planes.

    Runs on device so engine construction never byte-munges on the host: the
    memmap'd file is `device_put` as-is and split into int8 planes here."""
    from mpc_iris_tpu.ops.dot import shares_to_planes

    lo, hi = shares_to_planes(chunk_u16)
    return jnp.stack([lo, hi])


@jax.jit
def _share_dots_chunk_u16(q_enc, chunk_u16):
    """Dot shares straight from a raw u16 chunk (streamed out-of-core path):
    the lo/hi byte split happens inline in the same dispatch."""
    from mpc_iris_tpu.ops.dot import shares_to_planes

    lo, hi = shares_to_planes(chunk_u16)
    return _share_dots_chunk(q_enc, lo, hi)


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _keyed_planes_chunk(kw, stream_id, row0, n_rows):
    """Regenerate one chunk's rows and return stacked int8 [2, n, K] lo/hi
    planes in NATURAL K order (for the keyed engine's resident head; pair
    with `_queries_to_natural_k`)."""
    from mpc_iris_tpu.ops.chacha import share_planes_natural

    lo, hi = share_planes_natural(kw, stream_id, row0, n_rows)
    return jnp.stack([lo, hi])


@jax.jit
def _queries_to_natural_k(q_enc):
    """[B, 31, K] file-order query planes -> the keyed kernels' natural K
    order (ops.chacha.k_permutation): the share dot is K-permutation
    invariant when both operands agree, and permuting the small query side
    once per batch is ~free while emitting keystream planes in natural order
    skips a serialization pass as costly as the ChaCha rounds themselves."""
    from mpc_iris_tpu.ops.chacha import k_permutation

    return q_enc[..., jnp.asarray(k_permutation())]


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _share_dots_chunk_keyed(q_nat, kw, stream_id, row0, n_rows):
    """Dot shares against rows REGENERATED on device from the share key:
    ChaCha20 -> natural-order planes -> matmuls, one dispatch, zero DB I/O.
    ``q_nat`` must be natural-K-order queries (`_queries_to_natural_k`)."""
    from mpc_iris_tpu.ops.chacha import share_planes_natural

    lo, hi = share_planes_natural(kw, stream_id, row0, n_rows)
    return _share_dots_chunk(q_nat, lo, hi)


@jax.jit
def _to_entry_major(block):
    """[B, c, 31] -> [c, B, 31] on device (the batched wire's byte order) —
    saves the host-side transpose copy on every streamed chunk."""
    return jnp.transpose(block, (1, 0, 2))


@jax.jit
def _mask_dots_chunk(q_mask, db_mask):
    """Denominators for one chunk: uint16 [B, c, 31] in wire order
    (den <= 12,800, so the u16 narrowing is exact)."""
    b = q_mask.shape[0]
    chunk = db_mask.shape[0]
    dots = dot_bits_batch(q_mask.reshape(b * N_ROTATIONS, BITS), db_mask)
    return dots.reshape(b, N_ROTATIONS, chunk).transpose(0, 2, 1).astype(jnp.uint16)


@jax.jit
def _mask_dots_chunk_packed(q_mask, db_mask_packed):
    """`_mask_dots_chunk` over a bit-packed uint8 [c, 1600] mask chunk
    (1.6 KB/entry in device memory; unpacked on device)."""
    return _mask_dots_chunk(q_mask, unpack_bits(db_mask_packed).astype(jnp.int8))


# --------------------------------------------------------------------- streaming


def pipelined_stream(dispatch, num_chunks: int, count: int, chunk_entries: int,
                     depth: int = 4, entry_axis: int = 1):
    """Yield host arrays from per-chunk device dispatches, ``depth`` in flight.

    ``dispatch(c)`` returns an async device array for chunk c with DB entries on
    ``entry_axis`` ([B, n, 31] query-major or [n, B, 31] entry-major); this
    generator keeps up to ``depth`` dispatches pending so device compute and
    host transfer overlap (deeper than the reference's 1-deep mpsc pipeline).
    The final chunk is trimmed to
    ``count`` total entries.
    """
    from collections import deque

    pending = deque()
    for c in range(min(depth, num_chunks)):
        pending.append((c, dispatch(c)))
    nxt = depth
    while pending:
        c, dev = pending.popleft()
        if nxt < num_chunks:
            pending.append((nxt, dispatch(nxt)))
            nxt += 1
        host = np.asarray(dev)
        start = c * chunk_entries
        end = min(count, start + chunk_entries)
        if entry_axis == 0:
            yield host[: end - start]
        else:
            yield host[:, : end - start]


# --------------------------------------------------------------------- results


@dataclass
class MatchResult:
    """Winner of a min-distance search for one query."""

    index: int
    distance: float  # reference-exact f64 of numerator/denominator
    numerator: int
    denominator: int


class AuditLimitExceeded(RuntimeError):
    """An under-threshold audit produced more matches than the caller's
    limit allows (a server-side guard: a network client choosing a huge
    threshold must not force an O(N) match list / reply buffer)."""


def hits_under_from_fractions(nums, dens, threshold: float,
                              limit: int | None = None, indices=None):
    """Shared host epilogue of every threshold-audit path: per-entry minimal
    (numerator, denominator) int arrays [N] -> (idx, dist, n, d) arrays of
    the entries EXACTLY under the threshold
    (ops.decode.under_threshold_mask_np), ascending by reported f64 distance,
    index-ordered within equal-f64 ties. Raises :class:`AuditLimitExceeded`
    BEFORE building any per-hit objects when more than ``limit`` entries
    match.

    ``indices``: optional global DB indices of the rows (for pre-compacted
    candidate arrays — the device-side audit compaction); defaults to
    positional 0..N-1."""
    from mpc_iris_tpu.ops.decode import (
        fractions_to_f64_np,
        under_threshold_mask_np,
    )

    sel = np.nonzero(under_threshold_mask_np(nums, dens, threshold))[0]
    idx = sel if indices is None else np.asarray(indices)[sel]
    if limit is not None and idx.size > limit:
        raise AuditLimitExceeded(
            f"{idx.size} entries under threshold {threshold} exceeds the "
            f"configured match limit {limit}"
        )
    n_b = np.asarray(nums)[sel].astype(np.int64)
    d_b = np.asarray(dens)[sel].astype(np.int64)
    dist = fractions_to_f64_np(n_b, d_b)
    order = np.lexsort((idx, dist))
    return idx[order], dist[order], n_b[order], d_b[order]


def settle_compacted_under(meta, nd_c, k: int, count: int, threshold: float,
                           limit: int | None = None
                           ) -> list[list[MatchResult]] | None:
    """Host epilogue of the device-compacted audit (_compact_under_device):
    exact rational settle of the candidate superset -> per-query match
    lists, or None when any query's candidates overflowed the compact
    buffer (the caller must rerun via the full-spectrum path)."""
    meta = np.asarray(meta)
    counts = meta[:, 0]
    if (counts > k).any():
        return None
    nd_c = np.asarray(nd_c)
    results: list[list[MatchResult]] = []
    for q in range(meta.shape[0]):
        c = int(counts[q])
        # compacted rows could only include padded entries >= count if the
        # scan padding produced d > 0 — it cannot (mask-0 padding), but
        # trim defensively against index space anyway
        idx_g = meta[q, 1:1 + c]
        keep = idx_g < count
        idx, dist, n_b, d_b = hits_under_from_fractions(
            nd_c[0, q, :c][keep].astype(np.int64),
            nd_c[1, q, :c][keep].astype(np.int64),
            threshold, limit=limit, indices=idx_g[keep],
        )
        results.append([
            MatchResult(int(i), float(v), int(nn), int(dd))
            for i, v, nn, dd in zip(idx, dist, n_b, d_b)
        ])
    return results


def orchestrate_find_under(count: int, b: int, threshold: float,
                           limit, compact_k, full_nd_fn, compact_fn
                           ) -> list[list[MatchResult]]:
    """Shared audit orchestration (single-chip AND sharded engines — one
    copy of the policy): threshold classification, compact-buffer sizing,
    the conservative f32 bound incl. its soundness guards, the compacted
    attempt + exact settle, and the overflow fallback.

    full_nd_fn() -> host uint16 [2, B, count] spectrum (the exact path).
    compact_fn(t_hi, k) -> (meta, nd_c) device outputs of
    :func:`_compact_under_device`.

    f32-bound guards: t_hi = f32(t·(1+1e-4)) is only a guaranteed SUPERSET
    bound while it is a NORMAL finite f32 — a subnormal t_hi (t < ~1.2e-38)
    may be flushed to zero by device arithmetic, turning ``n < t_hi·d`` into
    ``0 < 0`` and silently EXCLUDING genuine matches (exact duplicates have
    n = 0); such thresholds take the exact full path instead."""
    import math as _math

    t = float(threshold)
    if _math.isnan(t) or t <= 0.0:
        return [[] for _ in range(b)]
    k = compact_k if compact_k is not None else max(
        65536, 2 * limit if limit else 0
    )
    k = min(k, count)
    with np.errstate(over="ignore"):  # overflow handled by the isfinite guard
        t_hi = np.float32(t * (1.0 + 1e-4))
    if (_math.isinf(t) or k == count
            or not np.isfinite(t_hi) or t_hi < np.finfo(np.float32).tiny):
        # everything matches / no compaction possible / the f32 bound is
        # unsound (subnormal or overflowed): exact full path
        return find_under_from_fractions(full_nd_fn(), t, limit=limit)
    meta, nd_c = compact_fn(t_hi, k)
    compacted = settle_compacted_under(meta, nd_c, k, count, t, limit=limit)
    if compacted is None:
        # candidate superset overflowed the compact buffer (adversarial
        # boundary pile-up): identical results via the full fetch
        return find_under_from_fractions(full_nd_fn(), t, limit=limit)
    return compacted


def find_under_from_fractions(nd: np.ndarray, threshold: float,
                              limit: int | None = None
                              ) -> list[list[MatchResult]]:
    """Host half of the threshold audit: uint16 [2, B, N] per-entry minimal
    (numerator, denominator) pairs -> per query, every entry with distance
    EXACTLY under the threshold, ascending by reported f64 distance
    (index-ordered within equal-f64 ties)."""
    results: list[list[MatchResult]] = []
    for b in range(nd.shape[1]):
        idx, dist, n_b, d_b = hits_under_from_fractions(
            nd[0, b], nd[1, b], threshold, limit=limit
        )
        results.append([
            MatchResult(int(i), float(v), int(nn), int(dd))
            for i, v, nn, dd in zip(idx, dist, n_b, d_b)
        ])
    return results


def _results_from_triples(n, d, i) -> list[MatchResult]:
    n, d, i = np.asarray(n), np.asarray(d), np.asarray(i)
    return [
        MatchResult(int(ii), fraction_to_f64(int(nn), int(dd)), int(nn), int(dd))
        for nn, dd, ii in zip(n, d, i)
    ]


# --------------------------------------------------------------------- engines


class PlaintextEngine:
    """Fused plaintext min-distance search over a device-resident template DB."""

    def __init__(self, patterns_packed: np.ndarray, masks_packed: np.ndarray,
                 chunk: int = DEFAULT_CHUNK, device=None, storage: str = "auto"):
        """Args:
        patterns_packed, masks_packed: uint8 [N, 1600] packed planes (host).
        chunk: DB chunk size for the scan (entries per matmul).
        storage: "packed" (the "auto" choice) keeps the raw bit planes
          (3.2 KB/entry) and unpacks per chunk on device; "dense" (int8
          encodings in device memory, 25.6 KB/entry) remains for explicit
          use.
        """
        kernel_self_test()
        n = patterns_packed.shape[0]
        chunk = min(chunk, max(128, n))
        if storage == "auto":
            storage = "packed"  # 8x the capacity of dense
        self.storage = storage
        put = functools.partial(jax.device_put, device=device)
        if storage == "packed":
            # Zero padding => mask 0 => invalid entries that lose every compare.
            pat_c, self.count = _pad_chunks(
                np.ascontiguousarray(patterns_packed, dtype=np.uint8), chunk
            )
            msk_c, _ = _pad_chunks(
                np.ascontiguousarray(masks_packed, dtype=np.uint8), chunk
            )
            self.db_pat = put(pat_c)
            self.db_msk = put(msk_c)
            self.db_enc = self.db_mask = None
        else:
            p = unpack_bits(np.asarray(patterns_packed), xp=np).astype(np.int8)
            m = unpack_bits(np.asarray(masks_packed), xp=np).astype(np.int8)
            enc = encode_grid_i8(p, m, xp=np)
            enc_c, self.count = _pad_chunks(enc, chunk)
            mask_c, _ = _pad_chunks(m, chunk)
            self.db_enc = put(enc_c)
            self.db_mask = put(mask_c)
        self.chunk = chunk

    def match(self, patterns_packed, masks_packed) -> list[MatchResult]:
        """Min-distance entry per query. uint8 [B, 1600] packed query planes."""
        q_enc, q_mask = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        n, d, i = np.asarray(self.match_arrays(q_enc, q_mask))
        return _results_from_triples(n, d, i)

    def match_arrays(self, q_enc, q_mask):
        """Raw jit-to-jit entry: prepared query planes -> int32 [3, B] stacked
        (numerator, denominator, DB index); tuple-unpackable."""
        if self.storage == "packed":
            return match_scan_packed_auto(
                q_enc, q_mask, self.db_pat, self.db_msk
            )
        return _match_scan(q_enc, q_mask, self.db_enc, self.db_mask)

    def distances(self, patterns_packed, masks_packed) -> np.ndarray:
        """Full f64 distance matrix [B, N] (for tests / small DBs); bit-identical to
        the scalar oracle Template.distance per pair."""
        from mpc_iris_tpu.ops.decode import decode_distance_batch_np

        q_enc, q_mask = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        packed = self.storage == "packed"
        n_chunks = (self.db_pat if packed else self.db_enc).shape[0]
        out = []
        for c in range(n_chunks):
            if packed:
                enc_c, mask_c = _unpack_encode_chunk(
                    self.db_pat[c], self.db_msk[c])
            else:
                enc_c, mask_c = self.db_enc[c], self.db_mask[c]
            num, den = _plaintext_chunk_fractions(
                q_enc, q_mask, enc_c, mask_c
            )
            num, den = np.asarray(num), np.asarray(den)
            b = num.shape[0]
            vals = decode_distance_batch_np(
                # decode expects u16 "dots"; reconstruct dot = den - 2*num (exact ints)
                (den - 2 * num).astype(np.int64) & 0xFFFF,
                den,
            ).reshape(b, -1)
            out.append(vals)
        return np.concatenate(out, axis=1)[:, : self.count]

    def _guard_spectrum(self, b: int) -> None:
        """The fraction-spectrum device output costs 4·B bytes per padded
        entry; both the full-fetch path and the compacted path materialize
        it on device, so both share this blow-up guard."""
        db = self.db_pat if self.storage == "packed" else self.db_enc
        out_bytes = 4 * b * db.shape[0] * db.shape[1]
        if out_bytes > 4 * (1 << 30):
            raise ValueError(
                f"min_fractions output would be {out_bytes / 2**30:.1f} GiB "
                f"on device (B={b}); split the query batch"
            )

    def min_fractions(self, patterns_packed, masks_packed) -> np.ndarray:
        """Per-entry minimal exact fractions: uint16 [2, B, N] of the
        min-over-31-rotations (numerator, denominator) pair per (query, entry).

        This is the full distance spectrum of the scan, in exact integer form
        (`fractions_to_f64_np` decodes it bit-identically to the reference) —
        one device array per dispatch. Costs 4·B bytes of device output per
        entry, so it's meant for audit-sized batches (B up to a few dozen at
        multi-million-entry DBs), not the bulk-throughput path."""
        q_enc, q_mask = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        self._guard_spectrum(q_enc.shape[0])
        if self.storage == "packed":
            out = fractions_scan_packed_auto(
                q_enc, q_mask, self.db_pat, self.db_msk)
        else:
            out = _fractions_scan(q_enc, q_mask, self.db_enc, self.db_mask)
        return np.asarray(out)[:, :, : self.count]

    def find_under(self, patterns_packed, masks_packed, threshold: float,
                   limit: int | None = None,
                   compact_k: int | None = None) -> list[list[MatchResult]]:
        """ALL DB entries with distance strictly under ``threshold``, per query
        (ascending distance, index-ordered within ties) — the dedup-audit
        complement of `match` (which returns only the argmin winner).

        The spec's uniqueness flow compares the minimum distance against a
        threshold (specification.ipynb "Uniqueness"); this returns the entire
        collision list instead, with the same exactness bar: the device
        streams exact integer fractions and the threshold comparison is exact
        in the rational order (ops.decode.under_threshold_mask_np), so a
        threshold placed exactly ON a representable distance excludes it
        (strict <) deterministically.

        Fetch is O(matches), not O(N): the device pass compacts a
        CONSERVATIVE candidate superset (float32 prefilter with margin —
        never excludes a true match) and only those (index, num, den)
        triples cross to the host, where the exact rational compare settles
        them. At a 1M-entry DB this turns a 4·B·N-byte spectrum fetch into
        kilobytes. Falls back to the full-spectrum path when candidates
        exceed ``compact_k`` (default: limit-scaled, >= 65,536) — e.g. an
        adversarial threshold sitting on a popular distance — so results
        are identical in every case.

        ``limit``: raise :class:`AuditLimitExceeded` when any query matches
        more than this many entries (the serving guard).

        The compacted attempt runs as ONE fused dispatch (scan +
        compaction); the rare overflow
        fallback therefore re-runs the scan via min_fractions, accepting a
        doubled device pass on adversarial thresholds rather than taxing
        the common path."""
        q_enc, q_mask = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        b = q_enc.shape[0]
        self._guard_spectrum(b)

        def compact_fn(t_hi, k):
            if self.storage == "packed":
                return fractions_under_compact_packed_auto(
                    q_enc, q_mask, self.db_pat, self.db_msk, t_hi, k)
            return _fractions_under_compact(
                q_enc, q_mask, self.db_enc, self.db_mask, t_hi, k)

        return orchestrate_find_under(
            self.count, b, threshold, limit, compact_k,
            lambda: self.min_fractions(patterns_packed, masks_packed),
            compact_fn,
        )


# Device memory kept free beside the share engines' resident planes for what
# every scan step needs whatever its shape: XLA's scratch, the query planes
# and the compiled programs. The batch- and chunk-scaled part of a step is
# `scan_workspace`.
FIXED_WORKSPACE = 2 << 30


def default_hbm_budget(device=None) -> int:
    """Device bytes the share engines may pin resident (lo/hi planes).

    MPC_IRIS_HBM_BUDGET (bytes) overrides. Otherwise the device's free pool
    — ``memory_stats()["bytes_limit"]`` less what is already in use — less
    FIXED_WORKSPACE. A backend without a device pool (the CPU) reports no
    stats and gets no limit: everything stays resident."""
    import os

    env = os.environ.get("MPC_IRIS_HBM_BUDGET")
    if env:
        return int(env)
    stats = (device or jax.local_devices()[0]).memory_stats()
    if not stats or "bytes_limit" not in stats:
        return 1 << 62
    free = stats["bytes_limit"] - stats.get("bytes_in_use", 0)
    return max(0, free - FIXED_WORKSPACE)


def scan_workspace(batch: int, chunk: int) -> int:
    """Device bytes one share-scan step holds beside the resident planes, at
    ``batch`` queries and ``chunk`` entries: two chunks of raw rows (a
    streamed u16 chunk and its prefetched successor, or a regenerated
    chunk's keystream words and int8 planes: 4*BITS bytes per entry) plus
    the int32 lo and hi GEMM outputs and the u16 reply block (10 bytes per
    rotation x query x entry)."""
    return (4 * BITS + 10 * N_ROTATIONS * batch) * chunk


_OOC_POOL = None
_OOC_POOL_LOCK = threading.Lock()


def _ooc_prefetch_pool():
    """Process-wide single-worker executor for out-of-core chunk prefetch.

    Shared by every engine: one 'ooc-prefetch' thread total (no per-engine
    leak when engines are rebuilt after growth), lazy creation guarded by a
    lock (engines are driven from asyncio.to_thread workers, so first touch
    can race). One worker also keeps page-ins serialized — the right shape
    for a single host disk/NIC feeding one device."""
    global _OOC_POOL
    with _OOC_POOL_LOCK:
        if _OOC_POOL is None:
            import concurrent.futures

            _OOC_POOL = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="ooc-prefetch")
    return _OOC_POOL


class ShareEngine:
    """Participant-side engine: dot shares of queries against a u16 share DB
    (== reference `DistanceEngine`, src/lib.rs:28-52).

    Capacity model (SURVEY.md hard part #3): shares are full-entropy u16 —
    25.6 KB/entry of HBM with no packed representation possible. Chunks that
    fit ``hbm_budget`` stay resident as int8 lo/hi planes; the remainder is
    served **out-of-core**: raw u16 chunks are `device_put` straight from the
    (memmap'd) source per query batch and byte-split on device — the
    equivalent of the reference's mmap-streaming participant
    (src/main.rs:386-400), where DB size is bounded by the file system, not
    memory. Peak host RAM = one chunk; peak extra HBM = one streamed chunk
    (u16 + planes)."""

    def __init__(self, shares_u16: np.ndarray, chunk: int = DEFAULT_CHUNK,
                 device=None, hbm_budget: int | None = None,
                 batch_hint: int = 512):
        """shares_u16: uint16 [N, 12800] share matrix (host, e.g. np.memmap).

        batch_hint: largest query batch this engine will serve. In
        out-of-core mode every streamed chunk adds a device transient
        (`scan_workspace`) ON TOP of the resident head, so the default
        budget carves that headroom out of the resident planes — the same
        rule as KeyedShareEngine. Ignored when an explicit hbm_budget is given, and
        moot when the whole DB fits resident (no streamed transient)."""
        kernel_self_test()
        n = shares_u16.shape[0]
        self._chunk_req = chunk  # pre-clamp request, for refresh() warnings
        chunk = min(chunk, max(128, n))
        num_chunks = max(1, -(-n // chunk))
        self._explicit_budget = hbm_budget is not None
        if hbm_budget is None:
            hbm_budget = default_hbm_budget(device)
        self._hbm_budget = hbm_budget
        self._batch_hint = batch_hint
        self._num_chunks = num_chunks
        self._n_resident = min(num_chunks, self._max_resident(num_chunks, chunk))
        self._put = functools.partial(jax.device_put, device=device)
        self._source = shares_u16
        self.count = n
        self.chunk = chunk
        # Out-of-core prefetch: one worker thread pages in + device_puts the
        # NEXT streamed chunk while the current one computes (the
        # reference's mmap participant gets this overlap from the OS
        # readahead + DMA, src/main.rs:386-400). One future at a time;
        # MPC_IRIS_NO_OOC_PREFETCH=1 disables (A/B measurement). The worker
        # pool is PROCESS-wide (module-level), so engines never leak threads
        # and lazy creation cannot race. The dict maps chunk -> (epoch,
        # future) under a lock: concurrent scans (multiple pump threads per
        # engine are supported) mutate it safely, and refresh() bumps the
        # epoch so a pre-growth future can never serve a post-growth scan.
        # Active only under the DEFAULT budget policy, which reserves the
        # second raw-chunk transient; an explicit hbm_budget is the caller's
        # exact accounting and must not gain a hidden +2*BITS*chunk peak.
        self._prefetch: dict[int, tuple[int, object]] = {}
        self._prefetch_lock = threading.Lock()
        self._prefetch_epoch = 0
        self._resident = []
        for c in range(self._n_resident):
            self._resident.append(_shares_reformat(self._put(self._chunk_u16(c))))
        if self._n_resident < num_chunks:
            import sys

            print(
                f"ShareEngine: {self._n_resident}/{num_chunks} chunks resident "
                f"({self._n_resident * chunk} of {n} entries); the rest stream "
                "host->device per query batch (out-of-core)", file=sys.stderr,
            )

    def _max_resident(self, num_chunks: int, chunk: int) -> int:
        """Resident-chunk cap under the engine's budget policy.

        int8 lo+hi planes cost 2*BITS bytes per entry when resident. When the
        default budget cannot hold every chunk (out-of-core), reserve the
        streamed-chunk transient, `scan_workspace`."""
        max_resident = max(0, int(self._hbm_budget // (2 * BITS * chunk)))
        if not self._explicit_budget and max_resident < num_chunks:
            stream_ws = scan_workspace(self._batch_hint, chunk)
            max_resident = max(
                0, int((self._hbm_budget - stream_ws) // (2 * BITS * chunk))
            )
        return max_resident

    def refresh(self, shares_u16: np.ndarray) -> int:
        """Adopt a grown (append-only) share source; returns entries added.

        The reference leaves participant DB sync as a TODO
        (src/main.rs:402,415: "Sync from database and add to memmapped
        file"); here a re-opened memmap of the appended-to share file slots
        straight in. Previously-resident full chunks are reused as-is; a
        previously-padded tail chunk is re-transferred, and residency is
        re-fit to the budget (growing past HBM demotes resident chunks to
        the streamed out-of-core path). Safe to call concurrently with
        serving: the resident list is REPLACED, never mutated, so an
        in-flight dots_chunk that snapshotted the old list keeps valid
        slots, and it reads identical bytes either way (the source is
        append-only and streams trim to the count captured at generator
        start)."""
        n_new = shares_u16.shape[0]
        if shares_u16.ndim != 2 or shares_u16.shape[1] != BITS:
            raise ValueError(f"share source must be [N, {BITS}] u16")
        if n_new < self.count:
            raise ValueError(
                f"refresh is append-only: new count {n_new} < current "
                f"{self.count} (rebuild the engine for a shrunk/rewritten DB)"
            )
        added = n_new - self.count
        full_before = self.count // self.chunk  # chunks that had no padding
        # Invalidate prefetches ATOMICALLY with the source/count swap: a
        # prefetched pre-growth PADDED tail chunk would feed zeros where
        # appended rows now exist to a scan that starts mid-refresh with the
        # NEW count. Submits capture (epoch, source, count) under the same
        # lock, so a future tagged with epoch E always holds epoch-E bytes
        # and consumers reject any tag != current.
        with self._prefetch_lock:
            self._prefetch_epoch += 1
            while self._prefetch:
                self._prefetch.popitem()[1][1].cancel()
            self._source = shares_u16
            self.count = n_new
        self._num_chunks = max(1, -(-n_new // self.chunk))
        self._warn_frozen_layout(n_new)
        n_res = min(self._num_chunks,
                    self._max_resident(self._num_chunks, self.chunk))
        keep = min(len(self._resident), full_before, n_res)
        resident = self._resident[:keep]  # full chunks: device copies reused
        for c in range(keep, n_res):
            resident.append(_shares_reformat(self._put(self._chunk_u16(c))))
        self._resident = resident  # atomic swap under the GIL
        self._n_resident = n_res
        return added

    def _warn_frozen_layout(self, n_new: int) -> None:
        """Growth keeps the construction-time chunk (it is baked into every
        compiled shape); warn when a fresh build on the grown DB would pick
        a much larger one — every chunk costs a dispatch and a fetch, so a
        rebuild is worth it."""
        fresh = min(self._chunk_req, max(128, n_new))
        if fresh >= 4 * self.chunk:
            import sys

            print(
                f"{type(self).__name__}: DB grew to {n_new} but the engine "
                f"keeps its construction-time chunk {self.chunk} (a fresh "
                f"build would pick {fresh}); rebuild for fewer, larger "
                "dispatches", file=sys.stderr,
            )

    def _chunk_u16(self, c: int, src=None, count=None) -> np.ndarray:
        """Host u16 [chunk, K] view for chunk c, zero-padded at the tail.

        Full chunks are returned as direct views (a memmap slice feeds
        `device_put` without an extra host copy — host passes are the
        bottleneck on bandwidth-starved hosts). ``src``/``count`` pin a
        snapshot (the prefetch worker's epoch consistency); default = the
        engine's current source."""
        src = self._source if src is None else src
        count = self.count if count is None else count
        start = c * self.chunk
        end = min(count, start + self.chunk)
        s = src[start:end]
        if (isinstance(s, np.ndarray) and s.dtype == np.uint16
                and s.flags.c_contiguous and end - start == self.chunk):
            return s
        s = np.ascontiguousarray(s, dtype=np.uint16)
        if end - start < self.chunk:
            s = np.pad(s, [(0, self.chunk - (end - start)), (0, 0)])
        return s

    def num_chunks(self) -> int:
        return self._num_chunks

    @property
    def resident_entries(self) -> int:
        return min(self.count, self._n_resident * self.chunk)

    def _prefetch_submit(self, c: int) -> None:
        """Queue page-in + device transfer of streamed chunk c on the worker
        thread (no-op for resident/out-of-range chunks, explicit budgets —
        which don't reserve the second raw-chunk transient — or when
        disabled)."""
        import os as _os

        if (self._explicit_budget
                or c >= self._num_chunks or c < len(self._resident)
                or _os.environ.get("MPC_IRIS_NO_OOC_PREFETCH")):
            return
        with self._prefetch_lock:
            if c in self._prefetch:
                return
            # Bind the worker to THIS epoch's source/count (captured under
            # the same lock refresh() swaps them under) so an epoch-E tag
            # always labels epoch-E bytes.
            epoch = self._prefetch_epoch
            src, cnt = self._source, self.count
            self._prefetch[c] = (epoch, _ooc_prefetch_pool().submit(
                lambda: self._put(self._chunk_u16(c, src, cnt))))

    def dots_chunk(self, q_enc, chunk_index: int):
        """uint16 [B, chunk, 31] for one DB chunk (device array, async).

        Resident chunks dispatch immediately; out-of-core chunks pay a
        host->device transfer of the raw u16 rows first (the hot loop is then
        transfer-bound, exactly like the reference's mmap-streaming
        participant on a memory-bandwidth-starved host). Sequential scans
        overlap that cost: chunk c+1's page-in + transfer runs on a worker
        thread while chunk c computes (concurrent scans at different
        positions evict each other's prefetch and degrade to the synchronous
        path — never to wrong bytes)."""
        res = self._resident  # snapshot: refresh() swaps the list, never mutates
        if chunk_index < len(res):
            planes = res[chunk_index]
            if chunk_index + 1 == len(res):
                # entering the streamed tail next: warm its first chunk
                self._prefetch_submit(chunk_index + 1)
            return _share_dots_chunk(q_enc, planes[0], planes[1])
        with self._prefetch_lock:
            hit = self._prefetch.pop(chunk_index, None)
            # Drop prefetches a sequential scan can no longer use (random
            # access or a competing scan) so at most one future pins HBM +
            # a worker slot; cancel() skips not-yet-started page-ins so the
            # shared worker never transfers a chunk nobody will consume.
            for k in [k for k in self._prefetch if k != chunk_index + 1]:
                self._prefetch.pop(k)[1].cancel()
            epoch_now = self._prefetch_epoch
        self._prefetch_submit(chunk_index + 1)
        fut = None
        if hit is not None:
            epoch, f = hit
            if epoch == epoch_now:
                fut = f
            else:
                f.cancel()  # pre-refresh future: bytes may be stale-padded
        raw = fut.result() if fut is not None else self._put(
            self._chunk_u16(chunk_index))
        return _share_dots_chunk_u16(q_enc, raw)

    # Hook: engines whose DB lives in a transformed K order (KeyedShareEngine)
    # override this to transform the query planes once per batch.
    def _q_transform(self, q_enc):
        return q_enc

    def dots(self, patterns_packed, masks_packed) -> np.ndarray:
        """Full reply tensor uint16 [B, N, 31] in reference wire order."""
        q_enc, _ = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        q_enc = self._q_transform(q_enc)
        parts = [self.dots_chunk(q_enc, c) for c in range(self.num_chunks())]
        return np.concatenate([np.asarray(p) for p in parts], axis=1)[:, : self.count]

    def stream(self, patterns_packed, masks_packed, entry_major: bool = False):
        """Yield per-chunk host uint16 arrays, pipelining device compute with
        host transfer (== the participant's chunked reply stream,
        src/main.rs:423-445). The final chunk is trimmed to the true DB size.

        entry_major: yield [chunk, B, 31] (the batched wire's byte order,
        transposed on device) instead of [B, chunk, 31].
        """
        q_enc, _ = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        q_enc = self._q_transform(q_enc)
        if entry_major:
            dispatch = lambda c: _to_entry_major(self.dots_chunk(q_enc, c))
        else:
            dispatch = lambda c: self.dots_chunk(q_enc, c)
        yield from pipelined_stream(
            dispatch, self.num_chunks(), self.count, self.chunk,
            entry_axis=0 if entry_major else 1,
        )


class KeyedShareEngine:
    """Participant engine for a party whose share is pure PRF output — the DB
    is REGENERATED on device from the 32-byte share key instead of stored.

    `prepare` derives every share s < n-1 of row R as the ChaCha20 keystream
    addressed by (key, s, R) (docs/SPEC.md §4.1; the last share carries the
    data and cannot be keyed). For those parties this engine serves queries
    with zero share I/O: no 25.6 KB/entry file on disk, in host RAM, or in
    HBM — each chunk's rows are regenerated inside the same dispatch as the
    byte-split and matmuls (`_share_dots_chunk_keyed`), bit-identical to
    serving the share file. This turns the DB-larger-than-HBM participant
    from host-transfer-bound into compute-bound, and the DB size is bounded
    only by u64 row addressing.

    Caveats (documented in SPEC §4.1): valid only for the ORIGINAL prepare
    output — `rerandomize`d share files are no longer pure keystreams; and
    holding the key is exactly as sensitive as holding the share file.

    The reference has no analogue (it always stores shares,
    src/main.rs:294-309).
    """

    def __init__(self, key: bytes, stream_id: int, count: int,
                 chunk: int = DEFAULT_CHUNK, hbm_budget: int | None = None,
                 batch_hint: int = 512):
        """hbm_budget: device bytes for a RESIDENT head of pre-regenerated
        lo/hi planes (default = `default_hbm_budget` minus
        `scan_workspace` at ``batch_hint``). Head chunks pay the ChaCha cost once at
        construction; only the tail regenerates per query batch — the keyed
        analogue of ShareEngine's resident/streamed split, except the
        'streaming' is on-device compute, not host I/O.

        batch_hint: largest query batch this engine will serve. The pass's
        transient workspace (the regenerated chunk, the int32 dot blocks and
        the uint16 reply block) grows with B·chunk, so larger batches need
        more headroom carved out of the resident-plane budget (ignored when
        an explicit hbm_budget is given)."""
        from mpc_iris_tpu.ops.chacha import check_stream_id, key_words

        kernel_self_test()
        self._kw = jnp.asarray(key_words(key))
        # uint32 from construction: a raw Python int in [2^31, 2^32-2] —
        # which check_stream_id admits — would overflow the default int32
        # conversion when passed as a traced jit argument.
        self._sid = jnp.uint32(check_stream_id(stream_id))
        self.count = int(count)
        self._chunk_req = chunk  # pre-clamp request, for refresh() warnings
        self.chunk = min(chunk, max(128, self.count))
        if hbm_budget is None:
            hbm_budget = max(0, default_hbm_budget()
                             - scan_workspace(batch_hint, self.chunk))
        self._max_resident = max(0, int(hbm_budget // (2 * BITS * self.chunk)))
        self._n_resident = min(self.num_chunks(), self._max_resident)
        self._resident = [
            _keyed_planes_chunk(self._kw, self._sid,
                                np.uint32(c * self.chunk), self.chunk)
            for c in range(self._n_resident)
        ]

    def refresh(self, count: int) -> int:
        """Adopt a grown logical DB size; returns entries added.

        A keyed party's 'DB sync' (reference TODO src/main.rs:402,415) is
        just learning the new row count — every row is derived from the
        32-byte key on demand, so nothing is loaded. Resident-head planes
        are whole keystream chunks and stay valid under growth; the head is
        extended if the budget still has room. Concurrency-safe like
        ShareEngine.refresh: the resident list is replaced, not mutated."""
        count = int(count)
        if count < self.count:
            raise ValueError(
                f"refresh is append-only: new count {count} < current "
                f"{self.count} (rebuild the engine for a shrunk DB)"
            )
        added = count - self.count
        self.count = count
        ShareEngine._warn_frozen_layout(self, count)
        n_res = min(self.num_chunks(), self._max_resident)
        resident = self._resident[:]
        for c in range(len(resident), n_res):
            resident.append(
                _keyed_planes_chunk(self._kw, self._sid,
                                    np.uint32(c * self.chunk), self.chunk)
            )
        self._resident = resident  # atomic swap under the GIL
        self._n_resident = n_res
        return added

    def num_chunks(self) -> int:
        return max(1, -(-self.count // self.chunk))

    @property
    def resident_entries(self) -> int:
        return min(self.count, self._n_resident * self.chunk)

    def _q_transform(self, q_enc):
        # All keyed planes (resident and regenerated) live in natural K order.
        return _queries_to_natural_k(q_enc)

    def dots_chunk(self, q_nat, chunk_index: int):
        """uint16 [B, chunk, 31] for one DB chunk (async): resident head
        planes dispatch straight into the matmuls; tail chunks regenerate
        inside the dispatch. ``q_nat`` = `_q_transform`'d query planes."""
        res = self._resident  # snapshot: refresh() swaps the list, never mutates
        if chunk_index < len(res):
            planes = res[chunk_index]
            return _share_dots_chunk(q_nat, planes[0], planes[1])
        # np.uint32 row offset: raw ints >= 2^31 (valid row addresses)
        # overflow jit's default int32 argument conversion.
        return _share_dots_chunk_keyed(
            q_nat, self._kw, self._sid,
            np.uint32(chunk_index * self.chunk), self.chunk
        )

    # Same streaming surface as ShareEngine (participant/pipeline compatible).
    dots = ShareEngine.dots
    stream = ShareEngine.stream

    def fold_pass_fn(self, segments: int = 1):
        """Build a whole-DB checksum pass in ``segments`` dispatches
        (bench/self-test).

        The per-chunk `dots_chunk` loop pays one dispatch + one fetch per
        chunk. This folds every chunk into one jitted call: the resident head
        chunks are unrolled jit ARGUMENTS (closure capture would embed the
        multi-GiB head as jaxpr constants; stacking would transiently double
        its device footprint) and
        the tail regenerates inside a `lax.scan`. Returns
        ``run(q_enc) -> uint32`` checksum; the protocol path still streams
        per-chunk outputs to the host instead (its egress IS the product
        there).

        segments > 1 splits the chunk range into that many contiguous
        dispatches (queued back-to-back; one fetch each, deferred) and sums
        their checksums mod 2^32 — identical value to the single dispatch;
        it bounds the device time of each dispatch."""
        if self.num_chunks() * self.chunk != self.count:
            raise ValueError(
                f"fold_pass_fn folds whole chunks: count={self.count} is not "
                f"a multiple of chunk={self.chunk} (the checksum would "
                "include phantom padding rows); use dots()/stream() for "
                "ragged row counts"
            )
        total = self.num_chunks()
        segments = max(1, min(int(segments), total))
        if segments == 1:
            n_tail = total - self._n_resident
            return functools.partial(
                _keyed_fold_pass, kw=self._kw, sid=self._sid,
                resident=tuple(self._resident), chunk=self.chunk,
                n_tail=n_tail, tail_start=self._n_resident,
            )

        bounds = [round(s * total / segments) for s in range(segments + 1)]
        fns = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            res_slice = tuple(self._resident[lo:min(hi, self._n_resident)])
            tail_start = max(lo, self._n_resident)
            fns.append(functools.partial(
                _keyed_fold_pass, kw=self._kw, sid=self._sid,
                resident=res_slice, chunk=self.chunk,
                n_tail=max(0, hi - tail_start), tail_start=tail_start,
            ))

        def run(q_enc):
            pending = [fn(q_enc) for fn in fns]  # all queued before any fetch
            acc = 0
            for p in pending:
                acc = (acc + int(np.asarray(p))) & 0xFFFFFFFF
            return np.uint32(acc)

        return run


@functools.partial(jax.jit, static_argnames=("chunk", "n_tail", "tail_start"))
def _keyed_fold_pass(q_enc, *, kw, sid, resident, chunk: int, n_tail: int,
                     tail_start: int):
    """One-dispatch keyed checksum (sub-)pass: unrolled resident head (tuple
    of [2, chunk, K] plane arrays, passed as real jit args) + `lax.scan` over
    ``n_tail`` regenerated chunks starting at chunk index ``tail_start``.
    See KeyedShareEngine.fold_pass_fn (which also builds segmented passes)."""
    q_nat = _queries_to_natural_k(q_enc)
    acc = jnp.uint32(0)
    for planes in resident:
        out = _share_dots_chunk(q_nat, planes[0], planes[1])
        acc = acc + out.astype(jnp.uint32).sum()
    if n_tail:
        def tail_step(acc, t):
            row0 = (tail_start + t) * chunk
            out = _share_dots_chunk_keyed(q_nat, kw, sid, row0, chunk)
            return acc + out.astype(jnp.uint32).sum(), None

        acc, _ = jax.lax.scan(
            tail_step, acc, jnp.arange(n_tail, dtype=jnp.uint32)
        )
    return acc


class MasksEngine:
    """Coordinator-side denominator engine over the plaintext masks DB
    (== reference `MasksEngine`, src/lib.rs:55-80)."""

    def __init__(self, masks_packed: np.ndarray, chunk: int = DEFAULT_CHUNK,
                 device=None, storage: str = "auto"):
        """masks_packed: uint8 [N, 1600] packed mask planes (host, e.g. np.memmap).

        storage: "dense" = unpacked int8 planes in HBM (12.8 KB/entry);
        "packed" = raw bit planes (1.6 KB/entry, 8x capacity) unpacked per
        chunk on device; "auto" picks packed past 400k entries.

        The DB lives as PER-CHUNK device arrays (like ShareEngine's resident
        list) so :meth:`refresh` transfers only appended chunks — O(added),
        not O(total) — and the list swap keeps concurrent streams valid.
        """
        kernel_self_test()
        n = masks_packed.shape[0]
        chunk = min(chunk, max(128, n))
        if storage == "auto":
            storage = "packed" if n > 400_000 else "dense"
        self.storage = storage
        self._device = device
        self._source = masks_packed
        self.count = n
        self.chunk = chunk
        num_chunks = max(1, -(-n // chunk))
        self._blocks = [self._put_chunk(c) for c in range(num_chunks)]

    def _put_chunk(self, c: int):
        """Host chunk c (packed uint8 or unpacked int8 per storage mode),
        zero-padded at the tail, transferred to the device."""
        start = c * self.chunk
        end = min(self.count, start + self.chunk)
        rows = np.ascontiguousarray(self._source[start:end], dtype=np.uint8)
        if self.storage != "packed":
            rows = unpack_bits(rows, xp=np).astype(np.int8)
        if end - start < self.chunk:
            rows = np.pad(rows, [(0, self.chunk - (end - start)), (0, 0)])
        return jax.device_put(rows, device=self._device)

    def refresh(self, masks_packed: np.ndarray) -> int:
        """Adopt a grown (append-only) masks source; returns entries added.

        The coordinator half of the reference's DB-sync TODO
        (src/main.rs:402). Cost is O(added): full device chunks are reused
        as-is; only a previously-padded tail chunk is re-transferred and new
        chunks appended — the same per-block policy as the share engines, so
        enroll-style hot appends stay cheap at any DB size. Safe concurrently
        with serving: the block list is REPLACED, never mutated, so an
        in-flight stream that snapshotted the old list keeps valid chunks
        (the source is append-only and streams trim to the count captured at
        generator start)."""
        n_new = masks_packed.shape[0]
        if n_new < self.count:
            raise ValueError(
                f"refresh is append-only: new count {n_new} < current "
                f"{self.count} (rebuild the engine for a shrunk/rewritten DB)"
            )
        added = n_new - self.count
        if added == 0:
            return 0
        full_before = self.count // self.chunk  # chunks that had no padding
        self._source = masks_packed
        self.count = n_new
        num_chunks = max(1, -(-n_new // self.chunk))
        blocks = self._blocks[:full_before]  # device copies reused
        for c in range(full_before, num_chunks):
            blocks.append(self._put_chunk(c))
        self._blocks = blocks  # atomic swap under the GIL
        return added

    def num_chunks(self) -> int:
        return len(self._blocks)

    def dots_chunk(self, q_mask, chunk_index: int):
        blocks = self._blocks  # snapshot: refresh() swaps, never mutates
        if self.storage == "packed":
            return _mask_dots_chunk_packed(q_mask, blocks[chunk_index])
        return _mask_dots_chunk(q_mask, blocks[chunk_index])

    def dots(self, masks_packed) -> np.ndarray:
        """Full denominator tensor uint16 [B, N, 31] in wire order."""
        q = jnp.asarray(masks_packed)
        _, q_mask = prepare_query_planes(jnp.zeros_like(q), q)
        parts = [self.dots_chunk(q_mask, c) for c in range(self.num_chunks())]
        return np.concatenate([np.asarray(p) for p in parts], axis=1)[:, : self.count]

    def stream(self, masks_packed, entry_major: bool = False):
        """Yield per-chunk host uint16 arrays (trimmed at the end); see
        ShareEngine.stream for the entry_major layout."""
        q = jnp.asarray(masks_packed)
        _, q_mask = prepare_query_planes(jnp.zeros_like(q), q)
        if entry_major:
            dispatch = lambda c: _to_entry_major(self.dots_chunk(q_mask, c))
        else:
            dispatch = lambda c: self.dots_chunk(q_mask, c)
        yield from pipelined_stream(
            dispatch, self.num_chunks(), self.count, self.chunk,
            entry_axis=0 if entry_major else 1,
        )
