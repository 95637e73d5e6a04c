#!/usr/bin/env bash
# Turnkey cross-implementation interop gate against the Rust reference.
# Builds the reference checkout ($MPC_IRIS_REFERENCE) READ-ONLY (CARGO_TARGET_DIR
# points elsewhere) and cross-checks, in both directions:
#   1. prepare: identical masks bytes from the same JSON input
#   2. our `decrypt` reconstructs rust-prepared share files exactly
#   3. wire A: a rust `participant` serving a rust-prepared share answers our
#      raw-template query with reply records BYTE-IDENTICAL to our engine's
#   4. wire B: the rust `coordinator` drives OUR participant implementation
#      over an our-prepared store; its printed (index, distance) must equal
#      our oracle's for the captured query (exact f64 via shortest-roundtrip)
#
# Skips cleanly (exit 0, "SKIP") where cargo is unavailable — e.g. this
# container has no Rust toolchain; run it on any dev box with cargo + network
# (the reference's 201 locked crates must be fetchable or cached).
set -euo pipefail

REF="${MPC_IRIS_REFERENCE:-/root/reference}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"

if ! command -v cargo >/dev/null 2>&1; then
    echo "SKIP: cargo not found — install a Rust toolchain to run the" \
         "cross-implementation gate"
    exit 0
fi
if [ ! -f "$REF/Cargo.toml" ]; then
    echo "SKIP: reference checkout not found at $REF" \
         "(set MPC_IRIS_REFERENCE)"
    exit 0
fi

WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT
# The reference checkout is read-only: build artifacts go elsewhere.
export CARGO_TARGET_DIR="$WORK/target"

echo "building reference (release, locked deps) ..."
cargo build --release --locked --manifest-path "$REF/Cargo.toml"
RUST_BIN="$CARGO_TARGET_DIR/release/mpc-iris-code"
[ -x "$RUST_BIN" ] || { echo "FAIL: $RUST_BIN not produced"; exit 1; }

exec python "$REPO/scripts/interop_vs_rust.py" --rust-bin "$RUST_BIN" \
    --workdir "$WORK/inter"
