"""Rotation expansion — the 31x unfolding of a query over column rotations.

The reference precomputes 31 rotated copies of the encoded query and loops over them
per DB entry (src/lib.rs:33-52). Here the 31 rotations become extra rows of
the matmul LHS: the DB (the big operand) is never rotated.

Rotation semantics (pinned by reference test_rotated_number,
src/encoded_bits.rs:205-219): rotating by ``amount`` places the value of old column
``(j - amount) mod 200`` at new column ``j`` — i.e. ``jnp.roll(..., shift=amount,
axis=-1)`` on the [..., 64, 200] grid.
"""

from __future__ import annotations

import jax.numpy as jnp

from mpc_iris_tpu.constants import COLS, MAX_ROTATION, N_ROTATIONS, ROWS


def rotate_grid(grid, amount: int):
    """Rotate a [..., ROWS, COLS] grid by a static amount along columns."""
    if amount % COLS == 0:
        return grid
    return jnp.roll(grid, shift=amount, axis=-1)


def expand_rotations(grid):
    """[..., ROWS, COLS] -> [N_ROTATIONS, ..., ROWS, COLS].

    Rotation index r runs over -15..+15 in order (matching the reference's reply
    record layout, src/lib.rs:33-40 and src/main.rs:428-434). The loop is static and
    unrolls under jit into 31 cheap gathers fused by XLA.
    """
    return jnp.stack(
        [rotate_grid(grid, r) for r in range(-MAX_ROTATION, MAX_ROTATION + 1)],
        axis=0,
    )


def expand_rotations_flat(grid):
    """[B, ROWS, COLS] -> [B, N_ROTATIONS, ROWS*COLS] rotation-expanded and flattened
    to matmul-LHS rows, grouped per query so reply records stay contiguous."""
    rots = expand_rotations(grid)  # [31, B, ROWS, COLS]
    rots = jnp.moveaxis(rots, 0, 1)  # [B, 31, ROWS, COLS]
    return rots.reshape(rots.shape[0], N_ROTATIONS, ROWS * COLS)
