"""Device kernels (layer L0 of SURVEY.md) — the accelerator compute path.

The reference's hot loops are per-entry SIMD dot products (src/arch/generic.rs,
src/arch/sve.rs). Here they are reformulated as batched int8 matmuls:

- plaintext / denominator paths: {0,1} and {-1,0,1} int8 matmuls (exact in int32),
- the Z_2^16 share path: an exact lo/hi byte-plane decomposition into two int8
  matmuls plus a rank-1 correction (see ops/dot.py),
- rotations: a 31x expansion of the query (LHS) only, via jnp.roll on the 64x200 grid,
- score selection: exact integer fraction comparison (no f64 on device).

Everything is shape-static and jit-friendly; scalar NumPy oracles for each kernel live
next to it for parity testing (mirroring the reference's kernel-equivalence tests,
src/arch/sve.rs:79-109).
"""

from mpc_iris_tpu.ops.encode import (
    encode_template,
    encode_grid_u16,
    encode_grid_i8,
    unpack_bits,
    pack_bits,
)
from mpc_iris_tpu.ops.rotations import expand_rotations, rotate_grid
from mpc_iris_tpu.ops.dot import (
    dot_bits_batch,
    dot_share_batch,
    shares_to_planes,
    planes_to_shares,
)
from mpc_iris_tpu.ops.decode import (
    decode_distance,
    decode_distance_batch_np,
    fractions_to_f64_np,
    under_threshold_mask_np,
    numerators,
    fraction_min_rotations,
    fraction_argmin,
)

__all__ = [
    "encode_template",
    "encode_grid_u16",
    "encode_grid_i8",
    "unpack_bits",
    "pack_bits",
    "expand_rotations",
    "rotate_grid",
    "dot_bits_batch",
    "dot_share_batch",
    "shares_to_planes",
    "planes_to_shares",
    "decode_distance",
    "decode_distance_batch_np",
    "fractions_to_f64_np",
    "under_threshold_mask_np",
    "numerators",
    "fraction_min_rotations",
    "fraction_argmin",
]
