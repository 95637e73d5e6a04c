"""Ring encoding of templates, and packed-bit <-> unpacked conversions.

The ring embedding (reference src/lib.rs:16-26): per bit,

    encode(t) = mask - 2 * (pattern & mask)   in u16

yielding {0, 1, 0xFFFF} = {masked-out, unset, set} = {0, +1, -1} over Z_2^16
(verified exhaustively by the reference's test_preprocess, src/lib.rs:117-132).

For the int8 matmuls we use the signed int8 view {0, 1, -1} directly; the u16 view is the
protocol/storage form. Both are produced here, plus bit pack/unpack helpers shared by
host (NumPy) and device (jnp) code — the functions are backend-agnostic where possible.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mpc_iris_tpu.constants import BITS, COLS, ROWS
from mpc_iris_tpu.types.encoded import EncodedBits
from mpc_iris_tpu.types.template import Template

# Bit-position masks for LSB-first unpacking: bit i of a byte.
_BIT_SHIFTS = np.arange(8, dtype=np.uint8)


def unpack_bits(packed, xp=jnp):
    """Unpack uint8 [..., n_bytes] -> uint8 {0,1} [..., 8*n_bytes], LSB-first.

    Matches the reference's bit order (bit i at byte i//8, position i%8;
    src/bits.rs:44-57, pinned by test_index src/bits.rs:218-232).
    Works for both jnp and np via the ``xp`` argument.
    """
    packed = xp.asarray(packed, dtype=xp.uint8)
    expanded = (packed[..., :, None] >> _BIT_SHIFTS) & xp.uint8(1)
    return expanded.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def pack_bits(bits, xp=jnp):
    """Pack uint8/bool {0,1} [..., 8*n] -> uint8 [..., n], LSB-first (inverse of
    :func:`unpack_bits`)."""
    bits = xp.asarray(bits, dtype=xp.uint8)
    n = bits.shape[-1]
    if n % 8:
        raise ValueError("bit count must be a multiple of 8")
    grouped = bits.reshape(*bits.shape[:-1], n // 8, 8)
    weights = (xp.uint8(1) << _BIT_SHIFTS.astype(np.uint8)).astype(xp.uint8)
    # Sum of distinct powers of two fits uint8 exactly.
    return (grouped * weights).sum(axis=-1).astype(xp.uint8)


def encode_grid_u16(pattern_bits, mask_bits, xp=jnp):
    """u16 ring encoding from {0,1} bit arrays of any matching shape.

    ``mask - 2*(pattern & mask)`` with wrapping u16 arithmetic
    (reference src/lib.rs:16-26).
    """
    p = xp.asarray(pattern_bits, dtype=xp.uint16)
    m = xp.asarray(mask_bits, dtype=xp.uint16)
    return (m - xp.uint16(2) * (p & m)).astype(xp.uint16)


def encode_grid_i8(pattern_bits, mask_bits, xp=jnp):
    """Signed int8 view of the ring encoding: {-1, 0, +1} = {set, masked, unset}.

    Equal to :func:`encode_grid_u16` reinterpreted mod 2^16 into [-1, 1] — the form
    the int8 matmuls consume.
    """
    p = xp.asarray(pattern_bits, dtype=xp.int8)
    m = xp.asarray(mask_bits, dtype=xp.int8)
    return (m - xp.int8(2) * (p & m)).astype(xp.int8)


def _share_split_device_jit(p, m, kw, row0, *, n_shares):
    from mpc_iris_tpu.ops.chacha import share_rows

    bits_p = unpack_bits(p)
    bits_m = unpack_bits(m)
    enc = encode_grid_u16(bits_p, bits_m)
    n = p.shape[0]
    rand = [share_rows(kw, s, row0, n) for s in range(n_shares - 1)]
    total = enc
    for r in rand:
        total = total - r  # wrapping u16
    return jnp.stack(rand + [total])


_share_split_device_compiled = None


def share_split_device(patterns_packed, masks_packed, n_shares: int, key,
                       row_offset: int = 0):
    """Device-side prepare: packed planes -> additive Z_2^16 shares.

    Crypto-grade and BYTE-IDENTICAL to the host path: the n_shares-1 random
    shares are the same addressable ChaCha20 streams (key, s, row) the C++
    core writes (docs/SPEC.md §4.1; ops/chacha.py on-device keystream),
    keyed by the same 32-byte ``key``. One jit: unpack + ring-encode +
    keystream shares + wrapping difference (reference share semantics,
    src/encoded_bits.rs:22-38).

    Args:
      key: 32-byte ChaCha20 key (same as native.share_split).
      row_offset: global DB row of the first template in this batch.

    Returns uint16 [n_shares, n, 12800] (device).
    """
    from mpc_iris_tpu.ops.chacha import key_words

    global _share_split_device_compiled
    if _share_split_device_compiled is None:
        import jax

        _share_split_device_compiled = jax.jit(
            _share_split_device_jit, static_argnames=("n_shares",)
        )
    return _share_split_device_compiled(
        jnp.asarray(patterns_packed), jnp.asarray(masks_packed),
        jnp.asarray(key_words(key)), row_offset, n_shares=n_shares,
    )


def encode_template(template: Template) -> EncodedBits:
    """Host oracle: encode a Template into its u16 ring vector
    (reference ``encode``, src/lib.rs:16-26)."""
    pattern = unpack_bits(template.pattern.data, xp=np)
    mask = unpack_bits(template.mask.data, xp=np)
    return EncodedBits(encode_grid_u16(pattern, mask, xp=np))


def decode_encoded(enc: EncodedBits) -> Template:
    """Invert :func:`encode_template` (used by the `decrypt` role, which the reference
    declares but leaves unimplemented, src/main.rs:71,687).

    mask bit = (enc != 0); pattern bit = (enc == 0xFFFF). Pattern bits under a zero
    mask are irrecoverable (encode zeroes them) and decode to 0.
    """
    from mpc_iris_tpu.types.bits import Bits

    e = enc.data
    mask = (e != 0).astype(np.uint8)
    pattern = (e == 0xFFFF).astype(np.uint8)
    return Template(
        Bits(pack_bits(pattern, xp=np)),
        Bits(pack_bits(mask, xp=np)),
    )


def template_grids(template: Template, xp=np):
    """(pattern, mask) as {0,1} uint8 [64, 200] grids."""
    p = unpack_bits(template.pattern.data, xp=np).reshape(ROWS, COLS)
    m = unpack_bits(template.mask.data, xp=np).reshape(ROWS, COLS)
    if xp is not np:
        p, m = xp.asarray(p), xp.asarray(m)
    return p, m
