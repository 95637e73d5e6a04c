"""Multi-host party smoke: N CPU processes form one jax.distributed universe
and run the sharded match step (what a real multi-host party does across its hosts).

Run (single machine, CPU backend, 2 processes):

    JAX_PLATFORMS=cpu python scripts/multihost_smoke.py --procs 2

The launcher forks the workers; each initializes via parallel.multihost,
loads its local DB rows, builds the global mesh, and executes one sharded
plaintext match; process 0 prints the winners. Exit code 0 = all ranks agreed.
"""

import argparse
import os
import subprocess
import sys


def worker(rank: int, procs: int, port: int) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from mpc_iris_tpu.parallel import (
        ShardedPlaintextEngine,
        ShardedShareEngine,
        make_mesh,
        multihost,
    )

    multihost.init_party(
        coordinator_address=f"127.0.0.1:{port}", num_processes=procs, process_id=rank
    )
    info = multihost.party_info()
    assert info["process_count"] == procs, info

    rng = np.random.default_rng(7)  # same underlying DB on every rank
    n, chunk = 64, 8
    dpat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    dmsk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    qpat, qmsk = dpat[5:7].copy(), dmsk[5:7].copy()  # self-match queries

    mesh = make_mesh(db=len(jax.devices()), batch=1)

    # Disjoint-loading proof: poison every row OUTSIDE this rank's spans. If
    # any engine read a non-local row the winners would be garbage.
    spans = multihost.local_entry_spans(n, chunk, mesh)
    local_mask = np.zeros(n, dtype=bool)
    for s, e in spans:
        local_mask[s:e] = True
    dpat_l, dmsk_l = dpat.copy(), dmsk.copy()
    dpat_l[~local_mask] = 0xEE
    dmsk_l[~local_mask] = 0xEE

    eng = ShardedPlaintextEngine(dpat_l, dmsk_l, mesh, chunk=chunk)
    results = eng.match(qpat, qmsk)
    ok = [r.index for r in results] == [5, 6] and all(
        r.distance == 0.0 for r in results
    )

    # Share engine: 2-party additive sharing of the encoded DB, each rank
    # loading only its poisoned-complement slice; reconstructed dot records
    # must match the single-chip oracle computed from the clean DB.
    from mpc_iris_tpu.models import ShareEngine
    from mpc_iris_tpu.ops.encode import encode_grid_u16, unpack_bits

    enc = np.asarray(encode_grid_u16(
        unpack_bits(dpat, xp=np), unpack_bits(dmsk, xp=np), xp=np
    )).astype(np.uint16)
    srng = np.random.default_rng(13)
    s0 = srng.integers(0, 65536, enc.shape, dtype=np.uint16)
    s1 = (enc.astype(np.uint32) - s0) % 65536
    s1 = s1.astype(np.uint16)
    s0_l = s0.copy()
    s0_l[~local_mask] = 0xBEEF
    sharded = ShardedShareEngine(s0_l, mesh, chunk=chunk)
    got = sharded.dots(qpat[:1], qmsk[:1])
    want = ShareEngine(s0, chunk=chunk).dots(qpat[:1], qmsk[:1])
    ok = ok and np.array_equal(got, want)

    if rank == 0:
        print(f"rank0: winners {[r.index for r in results]}, "
              f"distances {[r.distance for r in results]}, "
              f"share dots disjoint-load {'OK' if np.array_equal(got, want) else 'MISMATCH'}, "
              f"local rows {int(local_mask.sum())}/{n}, "
              f"devices={info['global_devices']} procs={procs} -> "
              f"{'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--port", type=int, default=29401)
    p.add_argument("--rank", type=int, default=None, help="(internal)")
    args = p.parse_args()

    if args.rank is not None:
        sys.exit(worker(args.rank, args.procs, args.port))

    procs = []
    for r in range(args.procs):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--procs", str(args.procs),
             "--port", str(args.port), "--rank", str(r)],
        ))
    rc = max(p.wait() for p in procs)
    print("multihost smoke:", "OK" if rc == 0 else "FAILED")
    sys.exit(rc)


if __name__ == "__main__":
    main()
