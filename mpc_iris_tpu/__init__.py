"""mpc_iris_tpu — a JAX framework for privacy-preserving iris-code matching on GPUs.

Built on JAX / XLA / Pallas with the capability set of the Rust reference
`mpc-iris-code` (see SURVEY.md):

- 12,800-bit masked iris codes on a 64x200 grid (reference: src/lib.rs:10-12),
- masked fractional Hamming distance, minimum over 31 column rotations
  (reference: src/template.rs:43-64),
- additive secret sharing of the database over Z_2^16 among N parties
  (reference: src/encoded_bits.rs:22-38),
- a streaming N-party match protocol (reference: src/main.rs).

The compute path is reformulated for accelerators: the reference's per-core SIMD u16
dot-product loops (src/arch/) become batched int8 matmuls with an exact
lo/hi-byte-plane decomposition for Z_2^16, rotations become a 31x expansion of the
query (LHS) only, and argmin over rotations/entries is an exact integer fraction
comparison on device. See README.md for the architecture.

Layout of this package:

- ``types``     host-side data types and codecs (Bits / EncodedBits / Template)
- ``ops``       device kernels: encode, rotations, matmul engines, decode/argmin
- ``models``    match engines (plaintext, masks/denominator, share/distance) and the
                end-to-end uniqueness pipeline
- ``parallel``  device meshes, sharding specs, sharded engines, collective argmin
- ``io``        reference-compatible file formats (.masks / .share-i / template JSON)
                and streaming JSON ingest
- ``protocol``  asyncio TCP coordinator/participant roles (reference wire format)
- ``utils``     config, progress reporting, profiling helpers
"""

from mpc_iris_tpu.constants import (
    BITS,
    BITS_BYTES,
    COLS,
    ENCODED_BYTES,
    MAX_ROTATION,
    N_ROTATIONS,
    ROTATIONS,
    ROWS,
    ROW_BYTES,
    TEMPLATE_BYTES,
)
from mpc_iris_tpu.types import Bits, EncodedBits, Template

__version__ = "0.1.0"

__all__ = [
    "BITS",
    "BITS_BYTES",
    "COLS",
    "ENCODED_BYTES",
    "MAX_ROTATION",
    "N_ROTATIONS",
    "ROTATIONS",
    "ROWS",
    "ROW_BYTES",
    "TEMPLATE_BYTES",
    "Bits",
    "EncodedBits",
    "Template",
    "__version__",
]
