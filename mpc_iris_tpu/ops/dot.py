"""Batched dot-product kernels — the reference's `arch::dot_bool` / `arch::dot_u16`
(src/arch/generic.rs:4-16, src/arch/sve.rs:27-77) reformulated as int8 matmuls.

Shapes follow the matmul view of the match problem (SURVEY.md section 7):

    D[M, N] = Q[M, K] @ DB[N, K]^T,   K = 12,800

where M = batch x 31 rotations of the query side and N = DB entries.

Exact Z_2^16 on int8 tensor cores
---------------------------------
The tensor cores multiply int8 x int8 into int32. The share DB is u16, but the *query* side is
always the ternary encoding q in {-1, 0, 1} (reference src/lib.rs:16-26), so a u16
share s = s_lo + 256*s_hi (s_lo, s_hi in [0, 255]) gives

    sum_k q*s  =  (Q @ S_lo^T)  +  256 * (Q @ S_hi^T)        (exact in int32)

To fit the unsigned byte planes into int8 we store them offset by -128 and correct with
a rank-1 term: Q @ S_lo^T = Q @ (S_lo - 128)^T + 128 * rowsum(Q), where rowsum(Q) is a
per-LHS-row scalar. All magnitudes stay < 2^30, so int32 accumulation over K = 12,800
is exact; the final result is reduced mod 2^16 — bit-identical to the reference's
wrapping-u16 accumulation (verified against the scalar oracle, mirroring the
reference's SVE-vs-generic kernel test src/arch/sve.rs:79-109).

This costs 2 int8 matmuls per share dot — vs 1 for the plaintext/denominator paths —
and is the only exact formulation that keeps the DB operand in int8.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_DOT_DIMS = (((1,), (1,)), ((), ()))  # contract K against K, no batch dims


def _matmul_i8(q, db):
    """int8 [M, K] x int8 [N, K] -> int32 [M, N]."""
    return lax.dot_general(q, db, dimension_numbers=_DOT_DIMS, preferred_element_type=jnp.int32)


def dot_bits_batch(q, db):
    """Batched `dot_bool`-family kernel: int8 Q [M, K] x int8 DB [N, K] -> int32 [M, N].

    With {0,1} operands this is AND-popcount (reference dot_bool,
    src/arch/generic.rs:4-9); with {-1,0,1} operands it is the plaintext encoded dot
    (#equal - #unequal over jointly masked bits). Exact in int32 (|sum| <= 12,800).
    """
    return _matmul_i8(q, db)


def shares_to_planes(shares_u16):
    """u16 share matrix [N, K] -> (lo, hi) int8 planes [N, K], offset by -128.

    lo = (s & 255) - 128, hi = (s >> 8) - 128, both in [-128, 127].
    """
    s = jnp.asarray(shares_u16)
    if s.dtype != jnp.uint16:
        s = s.astype(jnp.uint16)
    lo = (s & jnp.uint16(0xFF)).astype(jnp.int32) - 128
    hi = (s >> jnp.uint16(8)).astype(jnp.int32) - 128
    return lo.astype(jnp.int8), hi.astype(jnp.int8)


def planes_to_shares(lo, hi):
    """Inverse of :func:`shares_to_planes` (for tests / decrypt)."""
    lo_u = (lo.astype(jnp.int32) + 128).astype(jnp.uint16)
    hi_u = (hi.astype(jnp.int32) + 128).astype(jnp.uint16)
    return (lo_u | (hi_u << jnp.uint16(8))).astype(jnp.uint16)


def dot_share_batch(q_i8, db_lo, db_hi):
    """Exact wrapping-u16 dot of ternary queries against a u16 share DB.

    Args:
      q_i8:   int8 [M, K] with values in {-1, 0, 1} (rotated encoded queries).
      db_lo:  int8 [N, K] low-byte plane, offset -128 (see :func:`shares_to_planes`).
      db_hi:  int8 [N, K] high-byte plane, offset -128.

    Returns:
      uint16 [M, N], bit-identical to the reference's `arch::dot_u16`
      (src/arch/generic.rs:11-16) applied pairwise.
    """
    q_i8 = q_i8.astype(jnp.int8)
    d_lo = _matmul_i8(q_i8, db_lo)  # Q @ (S_lo - 128)^T
    d_hi = _matmul_i8(q_i8, db_hi)  # Q @ (S_hi - 128)^T
    # Rank-1 offset correction: +128 * rowsum(Q) for each plane.
    rowsum = jnp.sum(q_i8.astype(jnp.int32), axis=1, keepdims=True)  # [M, 1]
    corr = 128 * rowsum
    total = (d_lo + corr) + ((d_hi + corr) << 8)
    return (total & jnp.int32(0xFFFF)).astype(jnp.uint16)


def dot_u16_oracle(a, b):
    """Scalar NumPy oracle for wrapping-u16 dot (for parity tests)."""
    import numpy as np

    prod = np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64)
    return np.uint16(np.sum(prod) & 0xFFFF)


_self_test_done = False


def kernel_self_test():
    """One-time runtime canary: the device matmul paths == NumPy oracles.

    The share and mask dots rely on backend integer semantics (exact int32
    accumulation of int8 products, wrapping reduction mod 2^16); a backend or compiler change that broke them would corrupt
    results silently. This runs
    once per process (engines call it lazily) and raises on any mismatch —
    the runtime analogue of the reference's asm-vs-generic kernel test
    (src/arch/sve.rs:79-109). Costs one tiny dispatch.
    """
    global _self_test_done
    if _self_test_done:
        return
    import numpy as np

    import jax

    rng = np.random.default_rng(0xC0DE)
    k = 12800
    q = rng.integers(-1, 2, size=(4, k)).astype(np.int8)
    # Extreme + random share rows.
    s = rng.integers(0, 1 << 16, size=(4, k)).astype(np.uint16)
    s[0, :] = 0xFFFF
    s[1, :] = 0x8000
    s[2, :2] = [0, 0xFFFF]
    m = rng.integers(0, 2, size=(4, k)).astype(np.int8)

    # One jit, one dispatch.
    @jax.jit
    def run(q, s, m):
        lo, hi = shares_to_planes(s)
        return jnp.stack([
            dot_share_batch(q, lo, hi).astype(jnp.int32),
            dot_bits_batch(q, m),
        ])

    got, got_mask = np.asarray(run(q, s, m))
    for i in range(4):
        for j in range(4):
            want = int(dot_u16_oracle(q[i], s[j]))
            if int(got[i, j]) != want:
                raise RuntimeError(
                    f"share-dot kernel self-test FAILED at [{i},{j}]: "
                    f"{int(got[i, j])} != {want} — backend integer semantics "
                    "changed; results would be corrupt"
                )
            want_m = int((q[i].astype(np.int64) * m[j]).sum())
            if int(got_mask[i, j]) != want_m:
                raise RuntimeError(
                    f"mask-dot kernel self-test FAILED at [{i},{j}]"
                )
    _self_test_done = True
