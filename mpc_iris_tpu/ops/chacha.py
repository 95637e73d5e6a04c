"""ChaCha20 (RFC 8439) as a jittable JAX op — share-stream regeneration on device.

Why this exists: `prepare` (cli.py) derives every share s < n-1 of DB row R as
the pure keystream ChaCha20(key, counter=0.., nonce=[s, R_lo32, R_hi32]) read
as 12,800 little-endian u16 lanes (native/iris_codec.cpp `ic_share_split`;
normative spec docs/SPEC.md §4.1). Those share files are therefore
*reproducible from the 32-byte key alone* — so a participant for party
s < n-1 does not need its 25.6 KB/entry share DB in HBM, host RAM, or even on
disk: it can regenerate any chunk of rows on device and feed the share
matmuls directly (see `models.engines.KeyedShareEngine`). This makes the
DB-larger-than-HBM participant compute-bound instead of host-transfer-bound,
and it upgrades the `prepare --backend device` path from jax.threefry
(not a cryptographic generator) to the same CSPRNG stream as the
host path — bit-identical output for the same key.

The reference has no analogue (it stores all shares; src/main.rs:294-309) —
this is a capability extension enabled by the addressable-stream design.

Everything is uint32 jnp arithmetic (wrapping adds, xors, rotates) — pure
elementwise work that XLA fuses; no hand-written kernel. Exactness is pinned
three ways in tests/test_chacha.py: against the C++ core, against the
`cryptography` package's ChaCha20, and against RFC 8439 test vectors.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mpc_iris_tpu.constants import BITS

_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"
BLOCKS_PER_ROW = (2 * BITS) // 64  # 400 x 64-byte blocks = 25,600 B = one row


def check_stream_id(stream_id) -> int:
    """Validate a share stream index (SPEC §4.1): [0, 2^32-2]; 2^32-1 is the
    re-randomization stream and negatives would wrap silently on device."""
    sid = int(stream_id)
    if not 0 <= sid < 0xFFFFFFFF:
        raise ValueError(
            f"share stream id must be in [0, 2^32-2], got {stream_id}"
        )
    return sid


def key_words(key: bytes) -> np.ndarray:
    """32-byte key -> uint32[8] little-endian words (RFC 8439 sec 2.3)."""
    key = bytes(key)
    if len(key) != 32:
        raise ValueError("ChaCha20 key must be exactly 32 bytes")
    return np.frombuffer(key, dtype="<u4").copy()


def _rotl(x, k):
    return (x << jnp.uint32(k)) | (x >> jnp.uint32(32 - k))


def _quarter(s, a, b, c, d):
    sa, sb, sc, sd = s[a], s[b], s[c], s[d]
    sa = sa + sb
    sd = _rotl(sd ^ sa, 16)
    sc = sc + sd
    sb = _rotl(sb ^ sc, 12)
    sa = sa + sb
    sd = _rotl(sd ^ sa, 8)
    sc = sc + sd
    sb = _rotl(sb ^ sc, 7)
    s[a], s[b], s[c], s[d] = sa, sb, sc, sd


def _block_words(init):
    """20 ChaCha rounds over a 16-list of broadcast uint32 arrays; returns the
    16 output words (working state + initial state)."""
    x = list(init)
    for _ in range(10):  # 10 double rounds, unrolled columns/diagonals
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return [a + b for a, b in zip(x, init)]


def _row_block_words(kw, stream_id, row0, n_rows: int):
    """Shared state setup + rounds for one share-stream row range: the 16
    output word arrays uint32 [n_rows, BLOCKS_PER_ROW]. Single source of
    truth for the row addressing (u64 nonce via u32 + carry — callers index
    < 2^32 rows, a 110 PB share DB; no x64 dependency) used by both the
    file-order and natural-plane emitters — they must never diverge."""
    kw = jnp.asarray(kw, jnp.uint32)
    r0 = jnp.asarray(row0, jnp.uint32)
    idx = jnp.arange(n_rows, dtype=jnp.uint32)
    lo = r0 + idx
    n_lo = lo[:, None]  # [R, 1]
    n_hi = (lo < idx).astype(jnp.uint32)[:, None]  # carry into bits 32..63
    ctr = jnp.arange(BLOCKS_PER_ROW, dtype=jnp.uint32)[None, :]  # [1, B]
    sid = jnp.asarray(stream_id, jnp.uint32)

    shape = jnp.broadcast_shapes(n_lo.shape, ctr.shape)  # [R, B]
    init = [jnp.broadcast_to(jnp.uint32(c), shape) for c in _CONSTS]
    init += [jnp.broadcast_to(kw[i], shape) for i in range(8)]
    init += [
        jnp.broadcast_to(ctr, shape),
        jnp.broadcast_to(sid, shape),
        jnp.broadcast_to(n_lo, shape),
        jnp.broadcast_to(n_hi, shape),
    ]
    return _block_words(init)


def _u32_scalar(v):
    """Coerce a raw Python-int jit argument to uint32: jit's default weak
    int32 conversion raises OverflowError for admitted values >= 2^31
    (stream ids run to 2^32-2, row offsets to 2^32-1). Traced values and
    arrays pass through untouched."""
    return np.uint32(v) if isinstance(v, int) else v


def share_rows(kw, stream_id, row0, n_rows: int):
    """Regenerate share rows [row0, row0 + n_rows) of one share stream.

    Args:
      kw:        uint32[8] key words (see :func:`key_words`).
      stream_id: uint32 scalar — the share index s (SPEC §4.1 stream address).
      row0:      int64-ish scalar — first global DB row.
      n_rows:    static row count.

    Returns:
      uint16 [n_rows, 12,800] — byte-identical to the share file rows written
      by `prepare` for the same key/stream (little-endian u16 lanes of the
      keystream; iris_codec.cpp row_nonce/ic_share_split).
    """
    return _share_rows_jit(kw, _u32_scalar(stream_id), _u32_scalar(row0),
                           n_rows)


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _share_rows_jit(kw, stream_id, row0, n_rows: int):
    words = _row_block_words(kw, stream_id, row0, n_rows)
    # Serialize: block bytes are word0..word15 LE; u16 lanes of that byte
    # stream are (w & 0xFFFF, w >> 16) pairs in word order.
    stacked = jnp.stack(words, axis=-1)  # [R, B, 16]
    lo = (stacked & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    hi = (stacked >> jnp.uint32(16)).astype(jnp.uint16)
    lanes = jnp.stack([lo, hi], axis=-1)  # [R, B, 16, 2]
    return lanes.reshape(n_rows, 2 * BITS // 2)


def k_permutation() -> np.ndarray:
    """π mapping NATURAL plane columns to file-order K indices.

    The u16 serialization in :func:`share_rows` interleaves 16 word arrays
    into block-major lane order, a pass over the whole keystream. The share
    dot is invariant under any fixed
    permutation applied to BOTH operands' K axis, so the fast path emits
    planes in the rounds' natural order — concatenating per-word byte
    planes, column j = l*6400 + w*400 + b for u16 lane l, word w, block b —
    and the engines permute the query side once per batch instead:
    q_natural[..., j] = q_file[..., π[j]] with π[j] = b*32 + 2w + l.
    """
    j = np.arange(BITS)  # 12,800 u16 lanes per row
    l, rem = np.divmod(j, 16 * BLOCKS_PER_ROW)  # lane l in {0, 1}
    w, b = np.divmod(rem, BLOCKS_PER_ROW)
    return (b * 32 + 2 * w + l).astype(np.int32)


def share_planes_natural(kw, stream_id, row0, n_rows: int):
    """Regenerated share rows as matmul-ready int8 (lo, hi) planes [n, 12,800]
    in NATURAL K order (see :func:`k_permutation`), offset -128 exactly like
    ops.dot.shares_to_planes. Skips the u16 serialization entirely: each
    plane is a cheap concatenation of per-word byte extracts."""
    return _share_planes_natural_jit(kw, _u32_scalar(stream_id),
                                     _u32_scalar(row0), n_rows)


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _share_planes_natural_jit(kw, stream_id, row0, n_rows: int):
    words = _row_block_words(kw, stream_id, row0, n_rows)

    lo_parts, hi_parts = [], []
    for lane_shift in (0, 16):  # u16 lane l = 0, 1
        for w in words:
            v = w >> jnp.uint32(lane_shift)
            lo_parts.append(
                ((v & jnp.uint32(0xFF)).astype(jnp.int32) - 128).astype(jnp.int8)
            )
            hi_parts.append(
                (((v >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.int32)
                 - 128).astype(jnp.int8)
            )
    return (jnp.concatenate(lo_parts, axis=1),
            jnp.concatenate(hi_parts, axis=1))


def keystream_bytes(key: bytes, counter: int, nonce12: bytes, nbytes: int) -> bytes:
    """Raw keystream for test pinning (mirrors native.chacha20_stream)."""
    kw = jnp.asarray(key_words(key))
    n = np.frombuffer(bytes(nonce12), dtype="<u4")
    blocks = -(-nbytes // 64)
    ctr = jnp.arange(blocks, dtype=jnp.uint32) + jnp.uint32(counter)
    shape = ctr.shape
    init = [jnp.broadcast_to(jnp.uint32(c), shape) for c in _CONSTS]
    init += [jnp.broadcast_to(kw[i], shape) for i in range(8)]
    init += [ctr] + [jnp.broadcast_to(jnp.uint32(x), shape) for x in n]
    words = np.asarray(jnp.stack(_block_words(init), axis=-1))  # [B, 16] u32
    return words.astype("<u4").tobytes()[:nbytes]
