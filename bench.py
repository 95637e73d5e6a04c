#!/usr/bin/env python
"""Headline benchmark: masked-Hamming comparisons/sec on one device.

One "comparison" = one full masked fractional-Hamming-distance evaluation between a
(rotated) 12,800-bit query and a DB template — numerator (pattern dot) + denominator
(mask popcount dot) + exact min/argmin selection, i.e. the complete per-pair work of
the reference's match pipeline (src/lib.rs:42-80 + decode). A full 31-rotation match
therefore counts as 31 comparisons.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "comparisons/s", "vs_baseline": N}
vs_baseline is against the 1e9 cmp/s/chip north star (BASELINE.md).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _ensure_share_file(path: str, entries: int):
    """Create/extend a share-file of ChaCha20 random bytes to >= entries rows
    (25,600 B each). One-time cost at disk-write speed; reused across runs."""
    from mpc_iris_tpu import native
    from mpc_iris_tpu.constants import BITS

    os.makedirs(os.path.dirname(path), exist_ok=True)
    row_bytes = 2 * BITS
    need = entries * row_bytes
    have = os.path.getsize(path) if os.path.exists(path) else 0
    if have % row_bytes:  # interrupted previous synthesis: drop the torn row
        have -= have % row_bytes
        with open(path, "r+b") as f:
            f.truncate(have)
    if have >= need:
        return
    log(f"synthesizing {(need - have) / 1e9:.1f} GB of share data -> {path} "
        "(one-time, disk-write bound)")
    import shutil
    import subprocess

    if shutil.which("dd"):  # kernel CSPRNG, single write pass
        bs = 1 << 24
        count = -(-(need - have) // bs)
        subprocess.run(
            # iflag=fullblock: short urandom reads would otherwise count as
            # whole blocks and the truncate below would zero-fill the gap.
            ["dd", "if=/dev/urandom", f"of={path}", f"bs={bs}", f"count={count}",
             "iflag=fullblock", "oflag=append", "conv=notrunc", "status=none"],
            check=True,
        )
        with open(path, "r+b") as f:
            f.truncate(need)
        return
    key = native.derive_insecure_key(0xBE7C)
    step_rows = 4096
    with open(path, "ab") as f:
        row = have // row_bytes
        while row * row_bytes < need:
            k = min(step_rows, entries - row)
            nonce = row.to_bytes(8, "little") + b"\x00\x00\x00\x00"
            f.write(memoryview(native.chacha20_stream(key, 0, nonce, k * row_bytes)))
            row += k


def _run_suite() -> None:
    """Headline + the 4 secondary shapes, one subprocess each.

    Fresh process per shape: device memory never fragments across modes,
    and the parent process touches no device state (one JAX process per
    card: a second one would fail for want of memory). Every shape appends
    its median±MAD entry to docs/BENCH_HISTORY.jsonl via its own
    append_history; stdout stays ONE JSON line (the headline's), as the
    bench contract requires."""
    import subprocess

    shapes = [
        ("headline packed/1M", []),
        ("share-keyed/1M", ["--mode", "share-keyed"]),
        ("latency/1M", ["--latency"]),
        ("audit-compact/1M", ["--mode", "audit"]),
        ("share/262k", ["--mode", "share"]),
    ]
    headline_json = None
    failures = []
    for name, extra in shapes:
        log(f"=== suite: {name} ===")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__)] + extra,
            stdout=subprocess.PIPE, timeout=3600,
        )
        out = proc.stdout.decode().strip()
        if proc.returncode != 0 or not out:
            failures.append(name)
            log(f"suite shape FAILED: {name} (rc={proc.returncode})")
            continue
        log(f"{name}: {out}  [{time.monotonic() - t0:.0f}s]")
        if headline_json is None:
            headline_json = out
    if failures or headline_json is None:
        log(f"suite: {len(failures)} shape(s) failed: {failures}")
        sys.exit(1)
    log(f"suite: all {len(shapes)} shapes recorded in the ledger")
    print(headline_json)


def main():
    from mpc_iris_tpu.utils.config import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument(
        "--db", type=int, default=None,
        help="DB entries on this chip (default: 1048576 packed / 262144 dense "
        "modes)",
    )
    p.add_argument(
        "--batch", type=int, default=None,
        help="queries per batch (default per mode: 2048 packed / 1536 "
        "share-keyed / 1024 plaintext / 8 audit / 256 otherwise; they fit "
        "the H100 but are not tuned there)",
    )
    p.add_argument("--chunk", type=int, default=None,
                   help="DB chunk per scan step (default per mode: 65536 "
                   "latency / 8192 packed and plaintext / 32768 otherwise; "
                   "not tuned on the H100)")
    p.add_argument("--iters", type=int, default=None,
                   help="timed passes (default 3; 15 in --latency mode)")
    p.add_argument(
        "--latency", action="store_true",
        help="single-query latency mode: B=1, report the p50 per-query "
        "end-to-end wall time (one dispatch + one result fetch, i.e. the "
        "one-query-per-connection serving shape of the reference, "
        "src/main.rs:411-447) instead of batched throughput. The JSON line "
        "reports value = p50 seconds/query (unit s/query); vs_baseline is "
        "the equivalent cmp/s against the 1e9 north star",
    )
    p.add_argument(
        "--latency-pad", type=int, default=1, metavar="P",
        help="in --latency mode, dispatch the single query replicated to P "
        "LHS rows (an experiment on row utilization at B=1; the report "
        "still counts one query)",
    )
    p.add_argument(
        "--suite", action="store_true",
        help="run the full regression suite: the headline shape plus the 4 "
        "secondary shapes (share-keyed/1M, latency/1M, audit-compact/1M, "
        "share/262k), one subprocess each (fresh device memory per mode), recording "
        "every shape in docs/BENCH_HISTORY.jsonl with its delta. The single "
        "stdout JSON line is still the headline result (driver contract)",
    )
    p.add_argument(
        "--threshold", type=float, default=0.375,
        help="audit mode: distance threshold for the compacted find_under "
        "pass (default 0.375; ~uniform-random match rate keeps the "
        "candidate set small, the production audit regime)",
    )
    p.add_argument(
        "--compact-k", type=int, default=65536,
        help="audit mode: device-side candidate capacity per query "
        "(overflow falls back to the exact full fetch)",
    )
    p.add_argument(
        "--mode",
        choices=["plaintext", "packed", "share", "share-keyed", "audit"],
        default="packed",
        help="packed (default) = bit-packed HBM storage (3.2 KB/entry; the "
        "north-star 1M-entry DB fits on one chip) with on-device unpack per "
        "chunk; plaintext = dense int8 storage; share = MPC participant path "
        "(HBM-resident when it fits, out-of-core streamed from a share file "
        "beyond that — shares are incompressible at 25.6 KB/entry); "
        "share-keyed = PRF-backed participant regenerating its share DB on "
        "device from a 32-byte key (zero share I/O, any DB size); "
        "audit = threshold-audit serving shape (find_under): full fraction "
        "spectrum on device + O(matches) compacted fetch + exact host "
        "settle (models.engines.fractions_under_compact_packed_auto)",
    )
    p.add_argument(
        "--share-file", default=os.path.join(REPO, "data", "bench_shares.dat"),
        help="backing file for the out-of-core share bench (created/extended "
        "with ChaCha20 random bytes on demand)",
    )
    args = p.parse_args()

    if args.suite:
        return _run_suite()

    import jax
    import jax.numpy as jnp

    from mpc_iris_tpu.constants import BITS, BITS_BYTES
    from mpc_iris_tpu.models.engines import (
        _match_scan,
        _share_dots_chunk,
        prepare_query_planes,
    )

    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} ({dev.platform})")
    if dev.platform != "gpu":
        log("warning: no GPU — times below are the CPU's, not a device metric")

    from mpc_iris_tpu.models.engines import default_hbm_budget

    if args.db is None:
        args.db = 262144 if args.mode in ("plaintext", "share") else 1048576
    if args.chunk is None:
        # Defaults that fit the H100's memory at the default batches; none
        # is tuned there yet.
        if args.latency:
            args.chunk = 65536
        elif args.mode in ("packed", "plaintext"):
            args.chunk = 8192
        else:
            args.chunk = 32768
    if args.iters is None:
        args.iters = 15 if args.latency else 3
    if args.latency:
        if args.batch not in (None, 1):
            p.error("--latency is the B=1 serving shape; drop --batch")
        if args.latency_pad < 1:
            p.error("--latency-pad must be >= 1")
        # The dispatch carries latency_pad REPLICAS of the one real query
        # (identical rows, identical winners); the report counts one query.
        args.batch = args.latency_pad
    if args.batch is None:
        # audit: the serving audit shape is a few queries at a time.
        args.batch = {"packed": 2048, "share-keyed": 1536,
                      "plaintext": 1024, "audit": 8}.get(args.mode, 256)
    share_resident = args.db * 2 * BITS <= default_hbm_budget()
    if args.mode == "plaintext" and args.db > 500_000:
        log(f"warning: {args.db} entries in dense storage likely exceeds "
            "HBM; use --mode packed for million-entry DBs")
    n = args.db
    chunk = min(args.chunk, n)
    n_chunks = max(1, n // chunk)
    n = n_chunks * chunk
    b = args.batch
    log(f"DB={n} entries, batch={b} queries, chunk={chunk} x {n_chunks}")

    # Synthesize the DB directly on device (values don't affect int8 matmul speed,
    # but keep them semantically valid: enc in {-1,0,1}, mask = (enc != 0)).
    key = jax.random.key(0)
    kq, kdb = jax.random.split(key)

    rng = np.random.default_rng(0)
    qpat = rng.integers(0, 256, size=(b, BITS_BYTES), dtype=np.uint8)
    qmsk = rng.integers(0, 256, size=(b, BITS_BYTES), dtype=np.uint8)
    if args.latency:
        # One real query replicated across the padded LHS rows.
        qpat = np.broadcast_to(qpat[:1], qpat.shape).copy()
        qmsk = np.broadcast_to(qmsk[:1], qmsk.shape).copy()
    q_enc, q_mask = prepare_query_planes(qpat, qmsk)
    q_enc = jax.block_until_ready(q_enc)

    if args.mode == "plaintext":
        # random.bits avoids randint's int32 temporaries (4x the final footprint).
        gen_enc = jax.jit(
            lambda k: (
                jax.random.bits(k, (n_chunks, chunk, BITS), jnp.uint8) % 3
            ).astype(jnp.int8) - 1
        )
        db_enc = jax.block_until_ready(gen_enc(kdb))
        db_mask = jax.block_until_ready((db_enc != 0).astype(jnp.int8))
        # np.asarray forces ONE host transfer of the stacked [3, B] result.
        run = lambda: np.asarray(_match_scan(q_enc, q_mask, db_enc, db_mask))
        # per pass: numerator + denominator matmuls
        macs_per_pass = 2 * (31 * b) * n * BITS
    elif args.mode == "packed":
        # random.bits avoids randint's int32 temporaries (4x the final footprint).
        genp = jax.jit(
            lambda k: jax.random.bits(k, (n_chunks, chunk, BITS_BYTES), jnp.uint8)
        )
        db_pat = jax.block_until_ready(genp(kdb))
        db_msk = jax.block_until_ready(genp(kq))
        # Dispatch (engines.match_scan_packed_auto): small batches -> the
        # packed small-batch kernel, larger ones -> the XLA scan.
        from mpc_iris_tpu.models.engines import match_scan_packed_auto

        run = lambda: np.asarray(
            match_scan_packed_auto(q_enc, q_mask, db_pat, db_msk)
        )
        macs_per_pass = 2 * (31 * b) * n * BITS
    elif args.mode == "audit":
        # Threshold-audit serving shape (PlaintextEngine.find_under): the
        # full 31-rotation fraction spectrum stays on device; only the
        # O(matches) compacted candidate set reaches the host, then the
        # exact host settle filters it (same two-stage policy as
        # engines.orchestrate_find_under; == reference exactness bar,
        # src/lib.rs:97-107).
        from mpc_iris_tpu.models.engines import (
            fractions_under_compact_packed_auto,
        )
        from mpc_iris_tpu.ops.decode import under_threshold_mask_np

        genp = jax.jit(
            lambda k: jax.random.bits(k, (n_chunks, chunk, BITS_BYTES), jnp.uint8)
        )
        db_pat = jax.block_until_ready(genp(kdb))
        db_msk = jax.block_until_ready(genp(kq))
        t_hi = np.float32(args.threshold * (1.0 + 1e-4))

        def run():
            meta, nd_c = fractions_under_compact_packed_auto(
                q_enc, q_mask, db_pat, db_msk, t_hi, args.compact_k)
            meta = np.asarray(meta)
            nd_c = np.asarray(nd_c)
            total = 0
            for q in range(b):
                c = int(meta[q, 0])
                if c > args.compact_k:
                    raise RuntimeError(
                        f"candidate overflow ({c} > {args.compact_k}); "
                        "raise --compact-k or lower --threshold")
                total += int(under_threshold_mask_np(
                    nd_c[0, q, :c].astype(np.int64),
                    nd_c[1, q, :c].astype(np.int64), args.threshold).sum())
            return total

        macs_per_pass = 2 * (31 * b) * n * BITS
    elif args.mode == "share-keyed":
        # PRF-backed participant: every chunk's share rows are regenerated on
        # device from the 32-byte key inside the dot dispatch — zero share
        # I/O, DB size unbounded by device memory (models.KeyedShareEngine; the
        # reference must mmap a 25.6 GB file for the same DB).
        from mpc_iris_tpu.models.engines import KeyedShareEngine

        log("building KeyedShareEngine (resident head regenerates once)...")
        t0 = time.monotonic()
        eng = KeyedShareEngine(bytes(range(32)), 0, n, chunk=chunk,
                               batch_hint=b)
        log(f"engine built in {time.monotonic() - t0:.0f}s; "
            f"{eng.resident_entries}/{n} entries resident")
        # ONE dispatch + ONE scalar fetch for the whole pass (the
        # per-chunk dots_chunk loop pays a dispatch and a fetch per chunk).
        fused = eng.fold_pass_fn()
        run = lambda: np.asarray(fused(q_enc))

        # 2 share matmuls; ChaCha regen is elementwise work not counted
        # as MACs (reported rate is end-to-end regardless).
        macs_per_pass = 2 * (31 * b) * n * BITS
    elif share_resident and args.mode == "share":
        # random.bits avoids randint's int32 temporaries (4x the final footprint).
        gen = jax.jit(
            lambda k: jax.lax.bitcast_convert_type(
                jax.random.bits(k, (n_chunks, chunk, BITS), jnp.uint8), jnp.int8
            )
        )
        db_lo = jax.block_until_ready(gen(kdb))
        db_hi = jax.block_until_ready(gen(kq))
        qe = q_enc

        @jax.jit
        def share_pass(qe, lo, hi):
            def stepf(c, xs):
                lo_c, hi_c = xs
                out = _share_dots_chunk(qe, lo_c, hi_c)
                # fold to keep the pass compute-bound on device (the protocol path
                # streams `out` to the host instead)
                return c + out.astype(jnp.uint32).sum(), None

            acc, _ = jax.lax.scan(stepf, jnp.uint32(0), (lo, hi))
            return acc

        run = lambda: np.asarray(share_pass(qe, db_lo, db_hi))
        macs_per_pass = 2 * (31 * b) * n * BITS
    else:
        # Out-of-core participant: device-resident head + host-streamed tail from
        # a real on-disk share file (== the reference's mmap'd 25.6 GB DB,
        # src/main.rs:386-400). The pass is bound by host->device
        # bandwidth; per-chunk results are
        # folded on device, as the protocol path's egress is benched separately.
        from mpc_iris_tpu.models.engines import ShareEngine

        _ensure_share_file(args.share_file, n)
        mm = np.memmap(args.share_file, dtype=np.uint16, mode="r",
                       shape=(n, BITS))
        log(f"building ShareEngine (resident head loads at host bandwidth)...")
        t0 = time.monotonic()
        eng = ShareEngine(mm, chunk=chunk, batch_hint=b)
        log(f"engine built in {time.monotonic() - t0:.0f}s; "
            f"{eng.resident_entries}/{n} entries resident")
        fold = jax.jit(lambda x: x.astype(jnp.uint32).sum())

        def run():
            total = np.uint64(0)
            for c in range(eng.num_chunks()):
                total += np.asarray(fold(eng.dots_chunk(q_enc, c)))
            return total

        macs_per_pass = 2 * (31 * b) * n * BITS
        if args.iters > 1:
            log("out-of-core mode: forcing --iters 1 (each pass re-streams "
                "the tail)")
            args.iters = 1

        def warm():  # compile both chunk variants without a full pass
            np.asarray(fold(eng.dots_chunk(q_enc, 0)))
            if eng.num_chunks() > eng._n_resident:
                np.asarray(fold(eng.dots_chunk(q_enc, eng.num_chunks() - 1)))

    from mpc_iris_tpu.utils.stats import (
        append_history,
        delta_line,
        format_summary,
        summarize_timings,
    )

    try:
        warm
    except NameError:
        warm = run
    log("compiling + warmup...")
    t0 = time.monotonic()
    warm()
    warmup_s = time.monotonic() - t0
    log(f"warmup {warmup_s:.1f}s")

    times = []
    for i in range(args.iters):
        t0 = time.monotonic()
        run()
        dt = time.monotonic() - t0
        times.append(dt)
        log(f"iter {i}: {dt:.3f}s")

    comparisons = b * n * 31
    if args.latency:
        stats = summarize_timings(times)
        p50 = stats["median_clean"]
        rate = n * 31 / p50  # ONE real query; padded rows are not counted
        pad_note = f", pad {b}" if b > 1 else ""
        log(
            f"p50 query latency: {p50 * 1e3:.1f} ms "
            f"({format_summary(stats, 'ms', 1e3)}) over {len(times)} "
            f"queries{pad_note}; equivalent {rate:.3e} cmp/s"
        )
        entry = {
            "key": f"{dev.device_kind}/latency/{args.mode}/db{n}/pad{b}",
            "value": p50,
            "unit": "s/query",
            "median_s": p50,
            "mad_s": stats["mad"],
            "samples": stats["n"],
            "outliers_rejected": stats["outliers_rejected"],
            "warmup_s": round(warmup_s, 1),
            "date": time.strftime("%Y-%m-%d"),
        }
        d = delta_line(entry, append_history(entry))
        if d:
            log(d)
        print(
            json.dumps(
                {
                    "metric": f"p50 single-query latency ({args.mode} path, "
                    f"{n}-entry DB, B=1{pad_note}; equivalent cmp/s in "
                    "vs_baseline x 1e9)",
                    "value": p50,
                    "unit": "s/query",
                    "vs_baseline": rate / 1e9,
                    "mad_s": stats["mad"],
                    "samples": stats["n"],
                    "warmup_s": round(warmup_s, 1),
                }
            )
        )
        return

    stats = summarize_timings(times)
    dt = stats["min"]
    rate = comparisons / dt
    tops = macs_per_pass / dt / 1e12
    log(
        f"best pass: {dt:.3f}s  -> {rate:.3e} cmp/s, {tops:.1f} int8-TOP/s "
        f"({b} queries x {n} entries x 31 rotations)"
    )
    log(f"pass time {format_summary(stats)}; "
        f"median-based rate {comparisons / stats['median_clean']:.3e} cmp/s")
    full_matches = b * n / dt
    log(f"full 31-rotation matches/s: {full_matches:.3e}")

    # Round-over-round regression ledger (criterion-style record: dispersion
    # + warmup + delta vs the last committed entry at the SAME shape key).
    entry = {
        # The key leads with the device kind so a run is only ever compared
        # with runs on the same chip. The share mode's residency decision
        # changes what is measured (device scan vs host-streamed
        # out-of-core), so each gets its own key.
        "key": (f"{dev.device_kind}/{args.mode}-ooc/db{n}/b{b}/c{chunk}"
                if args.mode == "share" and not share_resident
                else f"{dev.device_kind}/{args.mode}/db{n}/b{b}/c{chunk}"),
        "value": rate,
        "unit": "comparisons/s",
        "median_s": stats["median_clean"],
        "mad_s": stats["mad"],
        "samples": stats["n"],
        "outliers_rejected": stats["outliers_rejected"],
        "warmup_s": round(warmup_s, 1),
        "date": time.strftime("%Y-%m-%d"),
    }
    prev = append_history(entry)
    d = delta_line(entry, prev)
    if d:
        log(d)

    print(
        json.dumps(
            {
                "metric": f"masked-Hamming comparisons/sec/chip ({args.mode} path, "
                f"{n}-entry DB, batch {b})",
                "value": rate,
                "unit": "comparisons/s",
                "vs_baseline": rate / 1e9,
                "median_s": stats["median_clean"],
                "mad_s": stats["mad"],
                "samples": stats["n"],
                "warmup_s": round(warmup_s, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
