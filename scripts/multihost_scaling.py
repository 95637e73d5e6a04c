"""CPU weak-scaling curve of the sharded engines over 1..N processes.

Weak scaling: each process contributes a fixed number of DB rows (its own
slice, loaded disjointly), so the GLOBAL DB grows with the process count and
ideal scaling keeps the per-pass wall time flat (throughput grows ~linearly).

This is a *topology* measurement, not a speed record: all processes share
this machine's CPU, so the curve mostly shows the sharding/collective
overhead added per process. On a multi-host deployment the same code paths
run one process per host.

Run:  JAX_PLATFORMS=cpu python scripts/multihost_scaling.py --procs-list 1,2,4
Prints one line per process count: global rows, pass time, query-entries/s.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def worker(rank: int, procs: int, port: int, rows_per_proc: int,
           batch: int, iters: int, engine: str) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from mpc_iris_tpu.parallel import (
        ShardedKeyedShareEngine, ShardedPlaintextEngine, make_mesh, multihost,
    )

    multihost.init_party(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=procs, process_id=rank,
    )
    n = rows_per_proc * procs
    chunk = max(128, rows_per_proc // 4)
    rng = np.random.default_rng(7)  # same global DB definition on every rank
    dpat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    dmsk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    qpat, qmsk = dpat[: batch].copy(), dmsk[: batch].copy()

    mesh = make_mesh(db=len(jax.devices()), batch=1)
    if engine == "keyed":
        # Keyed party: NO data is loaded or moved anywhere — every process
        # derives its rows from the 32-byte key (the purest weak-scaling
        # shape: adding hosts adds DB capacity with zero bytes of traffic).
        from mpc_iris_tpu.models.engines import prepare_query_planes

        key = bytes(range(32))
        eng = ShardedKeyedShareEngine(key, 0, n, mesh, chunk=chunk)
        q_enc, _ = prepare_query_planes(qpat, qmsk)
        run = eng.fold_pass_fn()
        got = int(np.asarray(run(q_enc)))  # warm compile
        if procs == 1:  # correctness anchor vs the single-chip engine
            from mpc_iris_tpu.models import KeyedShareEngine

            single = KeyedShareEngine(key, 0, n, chunk=chunk)
            want = int(np.asarray(single.fold_pass_fn()(q_enc)))
            assert got == want, (got, want)
        step = lambda: np.asarray(run(q_enc))
    else:
        eng = ShardedPlaintextEngine(dpat, dmsk, mesh, chunk=chunk,
                                     storage="dense")
        results = eng.match(qpat, qmsk)  # warm compile + correctness anchor
        assert [r.index for r in results] == list(range(batch)), (
            [r.index for r in results]
        )
        step = lambda: eng.match(qpat, qmsk)

    t0 = time.monotonic()
    for _ in range(iters):
        step()
    dt = (time.monotonic() - t0) / iters
    if rank == 0:
        qe = batch * n / dt
        print(json.dumps({
            "engine": engine, "procs": procs, "global_rows": n,
            "batch": batch, "pass_s": round(dt, 4),
            "query_entries_per_s": round(qe),
        }), flush=True)
    return 0


def run_world(procs: int, port: int, rows: int, batch: int, iters: int,
              engine: str) -> int:
    ps = []
    for r in range(procs):
        ps.append(subprocess.Popen(
            [sys.executable, __file__, "--procs", str(procs),
             "--port", str(port), "--rows-per-proc", str(rows),
             "--batch", str(batch), "--iters", str(iters),
             "--engine", engine, "--rank", str(r)],
        ))
    return max(p.wait() for p in ps)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--procs-list", default="1,2,4")
    p.add_argument("--rows-per-proc", type=int, default=4096)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--engine", choices=["plaintext", "keyed"],
                   default="plaintext")
    p.add_argument("--port", type=int, default=29411)
    p.add_argument("--procs", type=int, default=None, help="(internal)")
    p.add_argument("--rank", type=int, default=None, help="(internal)")
    args = p.parse_args()

    if args.rank is not None:
        sys.exit(worker(args.rank, args.procs, args.port, args.rows_per_proc,
                        args.batch, args.iters, args.engine))

    rc = 0
    for i, procs in enumerate(int(x) for x in args.procs_list.split(",")):
        rc = max(rc, run_world(procs, args.port + i, args.rows_per_proc,
                               args.batch, args.iters, args.engine))
    sys.exit(rc)


if __name__ == "__main__":
    main()
