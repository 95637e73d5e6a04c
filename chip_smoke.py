#!/usr/bin/env python
"""Smoke test of the matcher's main path on NVIDIA GPUs.

    python chip_smoke.py              # one card: the phases below
    python chip_smoke.py --chips 4    # four cards: the sharded engines only

One card, 1,048,576 packed entries (the spec's uniqueness check runs at
~3M), data and queries made from ``--seed``:

  1. device and canary: the engines' kernel self-test on the card;
  2. uniqueness: ``PlaintextEngine(storage="packed").match`` at B=2048,
     B=8 and B=1, with planted self-matches, a near-duplicate and a tied
     duplicate pair; winners must agree across the batch sizes and equal,
     bit for bit, a NumPy reference over the whole DB (uint64 popcounts
     over the 31 rotations, exact argmin, ties to the lowest index); the
     f64 distances must equal the scalar ``Template.distance``;
  3. threshold audit at B=8: ``find_under`` (device compaction), the full
     spectrum fetch and the NumPy reference must list the same entries;
  4. one MPC round in this process over localhost TCP: a file-backed
     ``ShareEngine`` (25.6 GB of shares), a ``KeyedShareEngine`` and the
     ``MasksEngine`` behind ``ParticipantServer`` / ``Coordinator`` /
     ``QueryServer``, over the one-shot and the persistent client wires;
     the reconstructed winners must equal phase 2's;
  5. the CLI (``generate``, ``prepare``, ``match``) as subprocesses on a
     4,096-entry DB, each with its own small share of the card's memory;
     self-matches must report distance 0.0. It runs first.

``--chips 4`` builds a 4-card ``("db",)`` mesh and compares, bit for bit,
``ShardedPlaintextEngine`` (>= 3M packed entries, B=1/8/2048 and an audit),
``ShardedShareEngine`` (>= 1M file-backed) and ``ShardedKeyedShareEngine``
(>= 1M) with the one-card engines on device 0, each with a ragged tail.

Without a GPU it exits non-zero and prints no result. Its last stdout line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
``--cpu-rehearsal`` runs the same phases on the CPU at a small ``--entries``
to find faults without a card; it never prints that line.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data", "chip_smoke")
ENTRIES = 1 << 20
CLI_ENTRIES = 4096
PARENT_MEM_FRACTION = "0.88"  # the CLI children get CHILD_MEM_FRACTION each
CHILD_MEM_FRACTION = "0.05"
THRESHOLD = (7, 16)  # audit threshold 7/16, dyadic: exact in f64 and int64


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Wall time and device peak memory per phase."""

    def __init__(self, dev):
        self.dev = dev
        self.t0 = time.monotonic()

    @contextlib.contextmanager
    def __call__(self, name: str):
        log(f"--- {name}")
        t = time.monotonic()
        yield
        stats = self.dev.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        peak_s = f"{peak / 2**30:.2f} GiB" if peak is not None else "n/a"
        log(f"--- {name}: ok, {time.monotonic() - t:.1f} s, "
            f"device peak {peak_s}")


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ NumPy reference


_LUT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_last(x: np.ndarray) -> np.ndarray:
    """Popcount of a uint64 array summed over its last axis."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).sum(axis=-1, dtype=np.int64)
    return _LUT[x.view(np.uint8)].sum(axis=-1, dtype=np.int64)


def reference_fractions(qpat, qmsk, dpat, dmsk, block: int = 128):
    """Per (query, entry) minimal (n, d) over the 31 query rotations:
    n = popcount((a ^ b) & ma & mb), d = popcount(ma & mb), minimum by the
    exact value n/d (d == 0 is +inf), the earliest rotation on ties.

    n, d <= 12,800, so two distinct fractions differ by more than 2^-28 and
    their correctly rounded f64 quotients order them exactly. Returns int64
    [2, B, N]."""
    from mpc_iris_tpu.constants import MAX_ROTATION
    from mpc_iris_tpu.types import Bits

    rots = range(-MAX_ROTATION, MAX_ROTATION + 1)
    qp = np.stack([[Bits(p).rotated(r).data for r in rots] for p in qpat])
    qm = np.stack([[Bits(m).rotated(r).data for r in rots] for m in qmsk])
    qp = qp.view(np.uint64)  # [B, 31, 200]
    qm = qm.view(np.uint64)
    dp = np.ascontiguousarray(dpat).view(np.uint64)  # [N, 200]
    dm = np.ascontiguousarray(dmsk).view(np.uint64)
    b, n = qp.shape[0], dp.shape[0]
    out = np.zeros((2, b, n), np.int64)

    def run(lo):
        hi = min(n, lo + block)
        dpb, dmb = dp[None, lo:hi], dm[None, lo:hi]
        mm = np.empty((qp.shape[1], hi - lo, qp.shape[2]), np.uint64)
        x = np.empty_like(mm)
        cols = np.arange(hi - lo)
        for q in range(b):
            np.bitwise_and(qm[q][:, None], dmb, out=mm)
            dd = _popcount_last(mm)  # [31, block]
            np.bitwise_xor(qp[q][:, None], dpb, out=x)
            np.bitwise_and(x, mm, out=x)
            nn = _popcount_last(x)
            v = np.where(dd > 0, nn / np.maximum(dd, 1), np.inf)
            r = np.argmin(v, axis=0)  # first minimum = the earliest rotation
            out[0, q, lo:hi] = nn[r, cols]
            out[1, q, lo:hi] = dd[r, cols]

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        list(pool.map(run, range(0, n, block)))
    return out


def reference_winners(nd):
    """Exact argmin over entries of [2, B, N] fractions, lowest index on
    ties -> int64 [3, B] (n, d, index)."""
    n, d = nd
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.where(d > 0, n / np.maximum(d, 1), np.inf)
    i = np.argmin(v, axis=1)  # first occurrence = lowest index
    rows = np.arange(n.shape[0])
    return np.stack([n[rows, i], d[rows, i], i])


def reference_under(nd, q: int) -> list[tuple[int, float, int, int]]:
    """Entries of query q with n/d < 7/16 exactly, ascending by f64
    distance, index within ties."""
    n, d = nd[0, q], nd[1, q]
    tn, td = THRESHOLD
    idx = np.nonzero((d > 0) & (n * td < tn * d))[0]
    dist = n[idx] / d[idx]
    order = np.lexsort((idx, dist))
    return [(int(idx[k]), float(dist[k]), int(n[idx[k]]), int(d[idx[k]]))
            for k in order]


# ------------------------------------------------------------------ data


def make_db(rng, n: int):
    from mpc_iris_tpu.constants import BITS_BYTES

    pat = np.frombuffer(rng.bytes(n * BITS_BYTES), np.uint8).reshape(n, -1)
    msk = np.frombuffer(rng.bytes(n * BITS_BYTES), np.uint8).reshape(n, -1)
    return pat.copy(), msk.copy()


def plant_queries(rng, pat, msk):
    """8 queries: four exact self-matches (three of them rotated), a query
    whose match has a duplicate at a higher index (tie -> lower index), a
    near-duplicate (query 5), and two random, unplanted queries (6, 7).
    Modifies the DB for the duplicate. Returns the planted exact matches
    {query: index} and the near-duplicate's source index."""
    from mpc_iris_tpu.types import Bits

    n = pat.shape[0]
    i = rng.choice(n // 2, size=6, replace=False)
    dup_hi = n - 3
    pat[dup_hi], msk[dup_hi] = pat[i[4]], msk[i[4]]
    qp, qm = [], []
    for k, r in zip(i[:4], (0, 7, -13, 15)):
        qp.append(Bits(pat[k]).rotated(r).data)
        qm.append(Bits(msk[k]).rotated(r).data)
    qp.append(pat[i[4]].copy())
    qm.append(msk[i[4]].copy())
    near = pat[i[5]].copy()
    flip = rng.choice(near.size, size=near.size // 20, replace=False)
    near[flip] ^= np.uint8(1) << rng.integers(0, 8, flip.size).astype(np.uint8)
    qp.append(near)
    qm.append(msk[i[5]].copy())
    for _ in range(2):
        qp.append(np.frombuffer(rng.bytes(pat.shape[1]), np.uint8).copy())
        qm.append(np.frombuffer(rng.bytes(pat.shape[1]), np.uint8).copy())
    planted = {q: int(i[q]) for q in range(5)}
    return np.stack(qp), np.stack(qm), planted, int(i[5])


def triples(results):
    return np.array([[r.numerator, r.denominator, r.index] for r in results]).T


def write_last_share(path, pat, msk, key, chunk: int = 8192):
    """File-backed share of the last party for a 2-party split whose first
    share is the keyed ChaCha20 stream 0 (docs/SPEC.md section 4.1), made on
    the device chunk by chunk (``prepare --backend device``'s split) and
    written to a memmap. Checks the device keystream against the host's."""
    from mpc_iris_tpu import native
    from mpc_iris_tpu.constants import BITS
    from mpc_iris_tpu.ops.encode import share_split_device

    n = pat.shape[0]
    mm = np.memmap(path, dtype=np.uint16, mode="w+", shape=(n, BITS))
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        sh = share_split_device(pat[lo:hi], msk[lo:hi], 2, key, row_offset=lo)
        if lo == 0 or hi == n:
            row = hi - 1
            nonce = (0).to_bytes(4, "little") + row.to_bytes(8, "little")
            want = np.frombuffer(native.chacha20_stream(key, 0, nonce, 2 * BITS),
                                 "<u2")
            check(np.array_equal(np.asarray(sh[0, row - lo]), want),
                  f"device keystream != host ChaCha20 at row {row}")
        mm[lo:hi] = np.asarray(sh[1])
    mm.flush()
    del mm
    return np.memmap(path, dtype=np.uint16, mode="r", shape=(n, BITS))


def share_rows_that_fit(n: int, chunk: int) -> int:
    """Entries of 25.6 KB shares the data directory's disk can hold (a
    multiple of ``chunk``, at most ``n``)."""
    from mpc_iris_tpu.constants import BITS

    free = shutil.disk_usage(DATA).free - (2 << 30)
    fit = max(chunk, (free // (2 * BITS)) // chunk * chunk)
    return min(n, fit)


# ------------------------------------------------------------------ phases


def phase_cli(seed: int) -> None:
    env = dict(os.environ, PYTHONPATH=REPO,
               XLA_PYTHON_CLIENT_MEM_FRACTION=CHILD_MEM_FRACTION)
    db = os.path.join(DATA, "cli.json")
    out = os.path.join(DATA, "cli")

    def cli(*argv):
        r = subprocess.run(
            [sys.executable, "-m", "mpc_iris_tpu", *argv], env=env,
            capture_output=True, text=True, timeout=600, cwd=REPO)
        check(r.returncode == 0,
              f"CLI {argv[0]} failed (rc={r.returncode}): {r.stderr[-2000:]}")
        return r.stdout

    cli("generate", db, str(CLI_ENTRIES), "--replace", "--seed", str(seed))
    cli("prepare", db, "2", out, "--insecure-seed", str(seed))
    for suffix in (".share-0", ".share-1", ".masks"):
        check(os.path.getsize(out + suffix) > 0, f"prepare wrote no {suffix}")
    for batch in (1, 8):
        stdout = cli("match", db, "--batch", str(batch), "--seed", str(seed))
        dists = re.findall(r"closest entry \d+ at distance (\S+)", stdout)
        check(len(dists) == batch and all(float(x) == 0.0 for x in dists),
              f"CLI match --batch {batch}: self-matches not at 0.0: {stdout}")
        log(f"CLI match --batch {batch}: {batch} self-matches at 0.0")


def phase_uniqueness(eng, qpat, qmsk, ref_nd, planted, near, rng, big_batch):
    from mpc_iris_tpu.models.engines import _match_scan_packed, prepare_query_planes
    from mpc_iris_tpu.types import Template

    want = reference_winners(ref_nd)
    t = time.monotonic()
    r8 = triples(eng.match(qpat, qmsk))
    log(f"B=8 match {time.monotonic() - t:.3f} s (incl. compile)")
    r1 = np.concatenate([triples(eng.match(qpat[k:k + 1], qmsk[k:k + 1]))
                         for k in range(len(qpat))], axis=1)
    r4 = triples(eng.match(qpat[:4], qmsk[:4]))
    extra_p, extra_m = make_db(rng, big_batch - len(qpat))
    bp, bm = np.concatenate([qpat, extra_p]), np.concatenate([qmsk, extra_m])
    q_enc, q_mask = prepare_query_planes(bp, bm)
    compiled = _match_scan_packed.lower(q_enc, q_mask, eng.db_pat,
                                        eng.db_msk).compile()
    log(f"B={big_batch} step memory_analysis: {compiled.memory_analysis()}")
    eng.match(bp, bm)  # warm (compile-cache load)
    t = time.monotonic()
    rb = triples(eng.match(bp, bm))[:, :len(qpat)]
    log(f"B={big_batch} match {time.monotonic() - t:.3f} s (compiled)")
    check(np.array_equal(r8, r1), f"B=8 != B=1 winners:\n{r8}\n{r1}")
    check(np.array_equal(r8[:, :4], r4), "B=8 != B=4 winners")
    check(np.array_equal(r8, rb), f"B=8 != B={big_batch} winners")
    check(np.array_equal(r8, want), f"winners != NumPy reference:\n{r8}\n{want}")
    for q, idx in planted.items():
        check(r8[2, q] == idx and r8[0, q] == 0, f"planted query {q} missed")
    check(r8[2, 5] == near and r8[0, 5] > 0, "near-duplicate missed")
    results = eng.match(qpat, qmsk)
    for q, r in enumerate(results):
        qt = Template.from_bytes(bytes(qpat[q]) + bytes(qmsk[q]))
        dt = Template.from_bytes(bytes(eng_db_row(eng, r.index)))
        check(r.distance == qt.distance(dt),
              f"query {q}: f64 distance != Template.distance")
    log(f"winners (n, d, index) == NumPy reference for all {len(qpat)} "
        f"queries, incl. 2 random: {r8[:, -2:].T.tolist()}")
    return results


def eng_db_row(eng, index: int) -> bytes:
    c, p = divmod(index, eng.chunk)
    return (np.asarray(eng.db_pat[c, p]).tobytes()
            + np.asarray(eng.db_msk[c, p]).tobytes())


def phase_audit(eng, qpat, qmsk, ref_nd):
    """find_under (device compaction) at B=8 and at B=4 (the small-batch
    spectrum path) == the lists of the full-spectrum fetch == NumPy."""
    from mpc_iris_tpu.models.engines import find_under_from_fractions

    tn, td = THRESHOLD
    as_t = lambda rows: [[(m.index, m.distance, m.numerator, m.denominator)
                          for m in r] for r in rows]
    lists = as_t(eng.find_under(qpat, qmsk, tn / td))
    spectrum = eng.min_fractions(qpat, qmsk)
    check(np.array_equal(spectrum.astype(np.int64), ref_nd),
          "full spectrum != NumPy reference")
    check(lists == as_t(find_under_from_fractions(spectrum, tn / td)),
          "find_under != the full-spectrum lists")
    check(lists[:4] == as_t(eng.find_under(qpat[:4], qmsk[:4], tn / td)),
          "find_under at B=4 != B=8")
    for q, got in enumerate(lists):
        check(got == reference_under(ref_nd, q),
              f"find_under list of query {q} != NumPy reference")
    log(f"find_under == full-spectrum lists == NumPy reference "
        f"({sum(map(len, lists))} entries under {tn}/{td} across "
        f"{len(lists)} queries)")


def phase_mpc(pat, msk, qpat, qmsk, want, seed):
    from mpc_iris_tpu import native
    from mpc_iris_tpu.models import KeyedShareEngine, MasksEngine, ShareEngine
    from mpc_iris_tpu.protocol import (
        Coordinator,
        ParticipantServer,
        PersistentQueryClient,
        QueryServer,
        query_remote,
    )
    from mpc_iris_tpu.types import Template

    key = native.derive_insecure_key(seed)
    n = pat.shape[0]
    t = time.monotonic()
    shares = write_last_share(os.path.join(DATA, "party1.share"), pat, msk, key)
    log(f"wrote {shares.nbytes / 1e9:.1f} GB share file in "
        f"{time.monotonic() - t:.1f} s")
    t = time.monotonic()
    party1 = ShareEngine(shares)
    party0 = KeyedShareEngine(key, 0, n)
    masks = MasksEngine(msk)
    log(f"engines built in {time.monotonic() - t:.1f} s: file-backed "
        f"{party1.resident_entries}/{n} resident, keyed "
        f"{party0.resident_entries}/{n} resident")
    queries = [Template.from_bytes(bytes(p) + bytes(m))
               for p, m in zip(qpat, qmsk)]

    async def serve():
        parts = [ParticipantServer(e, "127.0.0.1", 0) for e in (party0, party1)]
        addrs = [await p.start() for p in parts]
        front = QueryServer(Coordinator(masks, addrs), "127.0.0.1", 0)
        host, port = await front.start()
        try:
            one_shot = [await query_remote(host, port, q) for q in queries]
            client = await PersistentQueryClient.connect(host, port)
            try:
                persistent = [await client.query(q) for q in queries]
            finally:
                await client.close()
            return one_shot, persistent
        finally:
            await front.close()
            for p in parts:
                await p.close()

    t = time.monotonic()
    one_shot, persistent = asyncio.run(serve())
    log(f"{2 * len(queries)} MPC queries in {time.monotonic() - t:.1f} s")
    for wire, outs in (("one-shot", one_shot), ("persistent", persistent)):
        got = [(o.index, o.distance, o.total) for o in outs]
        check(got == [(r.index, r.distance, n) for r in want],
              f"MPC winners over the {wire} wire != plaintext winners")
    log("MPC winners (one-shot and persistent wires) == plaintext winners")


def single_card(args, dev, phases):
    from mpc_iris_tpu.models import PlaintextEngine
    from mpc_iris_tpu.ops.dot import kernel_self_test

    with phases("phase 5: CLI generate/prepare/match (subprocesses)"):
        phase_cli(args.seed)
    with phases("phase 1: device and canary"):
        kernel_self_test()
    rng = np.random.default_rng(args.seed)
    with phases(f"phase 2: uniqueness at {args.entries} packed entries"):
        pat, msk = make_db(rng, args.entries)
        qpat, qmsk, planted, near = plant_queries(rng, pat, msk)
        t = time.monotonic()
        ref_nd = reference_fractions(qpat, qmsk, pat, msk)
        log(f"NumPy reference over {args.entries} entries x {len(qpat)} "
            f"queries: {time.monotonic() - t:.1f} s")
        eng = PlaintextEngine(pat, msk, storage="packed", device=dev)
        want = phase_uniqueness(eng, qpat, qmsk, ref_nd, planted, near, rng,
                                args.big_batch)
    with phases("phase 3: threshold audit at B=8"):
        phase_audit(eng, qpat, qmsk, ref_nd)
    del eng
    with phases("phase 4: MPC round (file-backed + keyed parties)"):
        n_fit = share_rows_that_fit(args.entries, 8192)
        if n_fit < args.entries:
            log(f"CUT: the disk holds shares for {n_fit} of {args.entries} "
                "entries; the MPC round runs on that prefix")
            pat, msk = pat[:n_fit], msk[:n_fit]
            want = PlaintextEngine(pat, msk, storage="packed").match(qpat, qmsk)
        phase_mpc(pat, msk, qpat, qmsk, want, args.seed)


def four_cards(args, phases):
    import jax

    from mpc_iris_tpu import native
    from mpc_iris_tpu.models import (
        KeyedShareEngine,
        PlaintextEngine,
        ShareEngine,
    )
    from mpc_iris_tpu.parallel import (
        ShardedKeyedShareEngine,
        ShardedPlaintextEngine,
        ShardedShareEngine,
        make_mesh,
    )

    devs = jax.devices()
    check(len(devs) >= 4, f"--chips 4 needs 4 devices, found {len(devs)}")
    mesh = make_mesh(db=4, batch=1, devices=devs[:4])
    rng = np.random.default_rng(args.seed)
    n_plain = 3 * args.entries + 5_000  # ragged tail across the shards
    n_share = args.entries + 3_000
    with phases(f"sharded plaintext at {n_plain} packed entries"):
        pat, msk = make_db(rng, n_plain)
        qpat, qmsk, _, _ = plant_queries(rng, pat, msk)
        extra = make_db(rng, args.big_batch - len(qpat))
        bp, bm = np.concatenate([qpat, extra[0]]), np.concatenate([qmsk, extra[1]])
        single = PlaintextEngine(pat, msk, storage="packed", device=devs[0])
        sharded = ShardedPlaintextEngine(pat, msk, mesh, storage="packed")
        log(f"sharded chunk {sharded.chunk}: "
            f"{sharded.db_enc.shape[0]} chunks per shard")
        for b in (1, 8, args.big_batch):
            secs = []
            for eng in (single, sharded):
                eng.match(bp[:b], bm[:b])  # compile
                t = time.monotonic()
                secs.append((triples(eng.match(bp[:b], bm[:b])),
                             time.monotonic() - t))
            (a, ta), (c, tc) = secs
            check(np.array_equal(a, c), f"sharded != one-card winners at B={b}")
            log(f"B={b}: sharded == one-card winners (one card {ta:.3f} s, "
                f"4 cards {tc:.3f} s, compiled)")
        tn, td = THRESHOLD
        as_t = lambda ls: [[(m.index, m.numerator, m.denominator) for m in r]
                           for r in ls]
        check(as_t(single.find_under(qpat, qmsk, tn / td))
              == as_t(sharded.find_under(qpat, qmsk, tn / td)),
              "sharded find_under != one-card")
        log("B=8 audit: sharded == one-card lists")
        del single, sharded
    key = native.derive_insecure_key(args.seed)
    q4p, q4m = qpat[:4], qmsk[:4]
    with phases(f"sharded file-backed shares at {n_share} entries"):
        shares = write_last_share(os.path.join(DATA, "party1.share"),
                                  pat[:n_share], msk[:n_share], key)
        a = ShareEngine(shares, device=devs[0]).dots(q4p, q4m)
        c = ShardedShareEngine(shares, mesh).dots(q4p, q4m)
        check(np.array_equal(a, c), "ShardedShareEngine != ShareEngine")
        log(f"dot shares {a.shape}: sharded == one-card")
        del a, c
    with phases(f"sharded keyed shares at {n_share} entries"):
        a = KeyedShareEngine(key, 0, n_share).dots(q4p, q4m)
        c = ShardedKeyedShareEngine(key, 0, n_share, mesh).dots(q4p, q4m)
        check(np.array_equal(a, c), "ShardedKeyedShareEngine != KeyedShareEngine")
        log(f"keyed dot shares {a.shape}: sharded == one-card")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=20261016)
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    p.add_argument("--entries", type=int, default=ENTRIES,
                   help="DB entries (default 1,048,576; --chips 4 shards 3x)")
    p.add_argument("--big-batch", type=int, default=2048)
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="run on the CPU at a small --entries; prints no result")
    args = p.parse_args()

    os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", PARENT_MEM_FRACTION)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu_rehearsal:
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r}); nothing "
              "was run", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True) if shutil.which("nvidia-smi") else None
    log(smi.stdout.strip() if smi and smi.returncode == 0 else "nvidia-smi: n/a")
    stats = dev.memory_stats() or {}
    log(f"JAX {jax.__version__}; {len(jax.devices())} x {dev.device_kind} "
        f"({dev.platform}); pool bytes_limit {stats.get('bytes_limit')}")

    from mpc_iris_tpu.utils.config import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    os.makedirs(DATA, exist_ok=True)
    phases = Phases(dev)
    try:
        if args.chips == 4:
            four_cards(args, phases)
        else:
            single_card(args, dev, phases)
    finally:
        shutil.rmtree(DATA, ignore_errors=True)
    log(f"all phases passed in {time.monotonic() - phases.t0:.1f} s")
    if args.cpu_rehearsal:
        log("rehearsal on the CPU: no device result")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
