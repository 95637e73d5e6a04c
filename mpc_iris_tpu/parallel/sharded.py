"""Sharded match engines: the single-chip engines of models/engines.py distributed
over a `jax.sharding.Mesh` with explicit `shard_map` SPMD.

Data distribution (strided-by-chunk):

The padded DB of G = C_local * D chunks (chunk = c entries) is laid out as a global
array [C_local, D, c, K] whose second axis shards over the ``"db"`` mesh axis, so
device i holds the global chunks {j*D + i}. Consequences:

- global entry index of (local chunk j, device i, position p) = (j*D + i)*c + p,
- one sharded "block step" at local chunk j computes the D *consecutive* global
  chunks j*D .. j*D+D-1 in parallel, so protocol reply streams come out in DB order
  (reference wire order, src/main.rs:428-434) while every device stays busy.

Queries shard over ``"batch"``; the global match winner is combined with
`fraction_allmin` over ``"db"`` (exact integer fractions, one all-gather).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

try:  # JAX >= 0.4.35 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

from mpc_iris_tpu.models.engines import (
    DEFAULT_CHUNK,
    _mask_dots_chunk,
    _match_scan,
    _results_from_triples,
    _share_dots_chunk,
    match_scan_packed_auto,
    prepare_query_planes,
)
from mpc_iris_tpu.ops.dot import shares_to_planes
from mpc_iris_tpu.ops.encode import encode_grid_i8, unpack_bits
from mpc_iris_tpu.parallel.collectives import fraction_allmin


def effective_chunk(chunk: int, total_rows: int, n_shards: int) -> int:
    """The chunk size the sharded engines ACTUALLY use.

    Callers may pass any chunk; it is clamped so tiny DBs don't pad one
    shard-block to a huge chunk. Every layout consumer — the engines below
    AND multihost.local_entry_spans — must apply this same clamp, or a
    host's prefetch offsets silently diverge from the rows the engine
    reads (zero-filled rows ⇒ wrong dot records with no error)."""
    return min(chunk, max(128, -(-total_rows // n_shards)))


def local_db_span(mesh) -> tuple[int, int]:
    """Contiguous [lo, hi) range of the mesh's ``"db"`` axis whose devices are
    addressable from this process.

    Multi-host loading contract (SURVEY §7 hard part 5): each process loads
    ONLY the DB rows its own devices serve. Requires the ``"db"`` axis to
    group devices by process — true for meshes built from the default
    ``jax.devices()`` order (make_mesh); raises otherwise, since a
    process-interleaved axis has no contiguous local slab."""
    pid = jax.process_index()
    # Locate the "db" axis by NAME — a mesh built with a different axis order
    # (e.g. ("batch", "db")) must not silently span the wrong axis.
    db_axis = mesh.axis_names.index("db")
    grid = np.moveaxis(np.atleast_2d(mesh.devices), db_axis, 0)
    mine = [
        i for i in range(grid.shape[0])
        if any(d.process_index == pid for d in grid[i].flat)
    ]
    if not mine:
        raise ValueError("this process addresses no devices on the 'db' axis")
    lo, hi = mine[0], mine[-1] + 1
    if mine != list(range(lo, hi)):
        raise ValueError(
            "mesh 'db' axis interleaves processes; build the mesh over the "
            "default jax.devices() order so each host's shards are contiguous"
        )
    return lo, hi


def _local_chunk_iter(n: int, chunk: int, d: int, lo: int, hi: int):
    """Yield (block j, local row li, src start, src end) for every DB chunk
    this process loads under the strided-by-chunk layout (global chunk of
    (j, li) = j*D + lo + li; tail chunks may be empty/short)."""
    block = chunk * d
    g_blocks = max(1, -(-n // block))
    for j in range(g_blocks):
        for li in range(hi - lo):
            start = (j * d + lo + li) * chunk
            end = min(n, start + chunk)
            yield j, li, start, max(start, end)


class _ShardedBase:
    def __init__(self, mesh, chunk: int):
        self.mesh = mesh
        self.n_shards = mesh.shape["db"]
        self.chunk = chunk
        self.db_sharding = NamedSharding(mesh, P(None, "db", None, None))
        # [lo, hi) of the "db" axis this process loads (multi-host: a strict
        # subset — each host touches only its own slice of the source, so a
        # memmap'd share/masks file never pages in other hosts' rows).
        self.db_span = local_db_span(mesh)

    def _put_db_local(self, local: np.ndarray):
        """Local blocked slab [G, hi-lo, chunk, ...] -> global sharded array
        [G, D, chunk, ...] on the mesh (device_put when single-process)."""
        if jax.process_count() == 1:
            return jax.device_put(local, self.db_sharding)
        global_shape = (local.shape[0], self.n_shards) + local.shape[2:]
        return jax.make_array_from_process_local_data(
            self.db_sharding, local, global_shape
        )

    def _blocked_local(self, src, transform=None, dtype=None, tail_shape=None):
        """Build this process's blocked slab [G, hi-lo, chunk, ...] by reading
        ONLY local chunks from ``src`` (host RAM peak = the local shard; a
        memmap source is the DB-larger-than-host-RAM path, matching the
        reference's mmap'd DB, src/main.rs:386-400)."""
        n = src.shape[0]
        lo, hi = self.db_span
        block = self.chunk * self.n_shards
        g_blocks = max(1, -(-n // block))
        if transform is None:
            probe = np.asarray(src[:1])
        else:
            probe = transform(np.asarray(src[:1]))
        out = np.zeros(
            (g_blocks, hi - lo, self.chunk) + probe.shape[1:],
            dtype=dtype or probe.dtype,
        )
        for j, li, s, e in _local_chunk_iter(n, self.chunk, self.n_shards, lo, hi):
            if e > s:
                rows = np.asarray(src[s:e])
                out[j, li, : e - s] = transform(rows) if transform else rows
        return out, n

    def _query_sharding(self):
        return NamedSharding(self.mesh, P("batch", None, None))

    def _q_transform(self, q_enc):
        """Hook: engines with a transformed DB K-order override (keyed)."""
        return q_enc

    def _fetchable(self, arr):
        """Make a device result fetchable on THIS host. Single-process: no-op.
        Multi-process: one all-gather to a fully-replicated layout
        (a host can only fetch addressable shards; reply blocks leave the
        party through one host's TCP socket, so it must see the whole block)."""
        if jax.process_count() == 1:
            return arr
        rep = getattr(self, "_rep_jit", None)
        if rep is None:
            rep = jax.jit(
                lambda x: x, out_shardings=NamedSharding(self.mesh, P())
            )
            self._rep_jit = rep
        return rep(arr)


class ShardedPlaintextEngine(_ShardedBase):
    """Fused plaintext min-distance search over a DB sharded across chips."""

    def __init__(self, patterns_packed, masks_packed, mesh,
                 chunk: int = DEFAULT_CHUNK, storage: str = "auto"):
        """storage: as in models.PlaintextEngine — "packed" (the "auto"
        choice) keeps raw bit planes per shard (3.2 KB/entry) and unpacks
        per chunk on device."""
        n = patterns_packed.shape[0]
        chunk = effective_chunk(chunk, n, mesh.shape["db"])
        super().__init__(mesh, chunk)
        if storage == "auto":
            storage = "packed"
        self.storage = storage
        if storage == "packed":
            pat_b, self.count = self._blocked_local(
                np.asarray(patterns_packed, dtype=np.uint8)
            )
            msk_b, _ = self._blocked_local(
                np.asarray(masks_packed, dtype=np.uint8)
            )
            self.db_enc = self._put_db_local(pat_b)  # packed pattern planes
            self.db_mask = self._put_db_local(msk_b)  # packed mask planes
        else:
            # Per-chunk unpack+encode of LOCAL rows only (no full-DB host
            # materialization; other hosts' rows are never touched).
            pats = np.asarray(patterns_packed)
            msks = np.asarray(masks_packed)
            lo, hi = self.db_span
            g_blocks = max(1, -(-n // (chunk * self.n_shards)))
            enc_b = np.zeros((g_blocks, hi - lo, chunk, 12_800), np.int8)
            mask_b = np.zeros_like(enc_b)
            for j, li, s, e in _local_chunk_iter(
                n, chunk, self.n_shards, lo, hi
            ):
                if e <= s:
                    continue
                p = unpack_bits(pats[s:e], xp=np).astype(np.int8)
                m = unpack_bits(msks[s:e], xp=np).astype(np.int8)
                enc_b[j, li, : e - s] = encode_grid_i8(p, m, xp=np)
                mask_b[j, li, : e - s] = m
            self.count = n
            self.db_enc = self._put_db_local(enc_b)
            self.db_mask = self._put_db_local(mask_b)

        c, d = self.chunk, self.n_shards
        packed = storage == "packed"

        def spmd(q_enc, q_mask, db_a, db_b):
            # local: q [B_local, 31, K]; db [C_local, 1, c, K or K/8]
            local_a = db_a.reshape(db_a.shape[0], c, db_a.shape[-1])
            local_b = db_b.reshape(db_b.shape[0], c, db_b.shape[-1])
            # the single-chip dispatch policy on the per-shard batch
            scan = match_scan_packed_auto if packed else _match_scan
            n_, d_, l = scan(q_enc, q_mask, local_a, local_b)
            # local l = j*c + p  ->  global (j*D + i)*c + p
            i_rank = lax.axis_index("db").astype(jnp.int32)
            g = (l // c) * (d * c) + i_rank * c + (l % c)
            return fraction_allmin(n_, d_, g, "db")

        self._match = jax.jit(
            shard_map(
                spmd,
                mesh=self.mesh,
                in_specs=(P("batch", None, None), P("batch", None, None),
                          P(None, "db", None, None), P(None, "db", None, None)),
                out_specs=(P("batch"), P("batch"), P("batch")),
                check_vma=False,
            )
        )

        def spmd_fractions(q_enc, q_mask, db_a, db_b):
            # local: q [B_local, 31, K]; db [C_local, 1, c, K or K/8].
            # Returns [2, B_local, C_local, 1, c]: the shard axis re-expanded
            # so the GLOBAL array's flattened entry order is the strided
            # layout's global order ((j*D + i)*c + p — see module docstring).
            from mpc_iris_tpu.models.engines import (
                _fractions_scan,
                fractions_scan_packed_auto,
            )

            local_a = db_a.reshape(db_a.shape[0], c, db_a.shape[-1])
            local_b = db_b.reshape(db_b.shape[0], c, db_b.shape[-1])
            # packed dispatch includes the small-B audit kernel (the audit
            # serving shape; same policy as the single-device engine)
            scan = fractions_scan_packed_auto if packed else _fractions_scan
            nd = scan(q_enc, q_mask, local_a, local_b)  # [2, B, C_local*c]
            b = nd.shape[1]
            return nd.reshape(2, b, db_a.shape[0], 1, c)

        self._fractions = jax.jit(
            shard_map(
                spmd_fractions,
                mesh=self.mesh,
                in_specs=(P("batch", None, None), P("batch", None, None),
                          P(None, "db", None, None), P(None, "db", None, None)),
                out_specs=P(None, "batch", None, "db", None),
                check_vma=False,
            )
        )

    def match_arrays(self, q_enc, q_mask):
        return self._match(q_enc, q_mask, self.db_enc, self.db_mask)

    def match(self, patterns_packed, masks_packed):
        q_enc, q_mask = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        q_enc = jax.device_put(q_enc, self._query_sharding())
        q_mask = jax.device_put(q_mask, self._query_sharding())
        n, d, i = self.match_arrays(q_enc, q_mask)
        return _results_from_triples(n, d, i)

    def min_fractions(self, patterns_packed, masks_packed) -> np.ndarray:
        """uint16 [2, B, N]: per-entry minimal (numerator, denominator) pair,
        gathered across the mesh in global DB order (the sharded sibling of
        models.PlaintextEngine.min_fractions; same audit-batch caveats)."""
        q_enc, q_mask = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        # Same blow-up guard as the single-chip engine (and _fetchable
        # additionally replicates the output per host in multi-process runs).
        b = q_enc.shape[0]
        n_padded = self.db_enc.shape[0] * self.n_shards * self.chunk
        if 4 * b * n_padded > 4 * (1 << 30):
            raise ValueError(
                f"min_fractions output would be "
                f"{4 * b * n_padded / 2**30:.1f} GiB on device (B={b}); "
                "split the query batch"
            )
        q_enc = jax.device_put(q_enc, self._query_sharding())
        q_mask = jax.device_put(q_mask, self._query_sharding())
        out = self._fetchable(
            self._fractions(q_enc, q_mask, self.db_enc, self.db_mask)
        )
        nd = np.asarray(out)
        b = nd.shape[1]
        return nd.reshape(2, b, -1)[:, :, : self.count]

    def find_under(self, patterns_packed, masks_packed, threshold: float,
                   limit: int | None = None, compact_k: int | None = None):
        """ALL DB entries with distance strictly under ``threshold`` per query
        (== models.PlaintextEngine.find_under, DB sharded across the mesh).

        Same O(matches) fetch as the single-chip engine (one shared policy:
        engines.orchestrate_find_under): the sharded fraction pass stays on
        device; one compaction jit over the gathered [2, B, N] spectrum
        fetches only candidate triples (the conservative f32 prefilter +
        exact host settle), falling back to the full fetch on overflow —
        identical results in every case. The spectrum device array is
        computed ONCE and reused by the fallback (no second sharded pass);
        the min_fractions blow-up guard applies to both paths."""
        import math as _math

        from mpc_iris_tpu.models.engines import (
            _compact_under_jit,
            orchestrate_find_under,
        )

        t = float(threshold)
        b = np.asarray(patterns_packed).shape[0]
        if _math.isnan(t) or t <= 0.0:
            return [[] for _ in range(b)]
        # Same device-output blow-up guard as min_fractions — the spectrum
        # is materialized on the mesh for either path.
        n_padded = self.db_enc.shape[0] * self.n_shards * self.chunk
        if 4 * b * n_padded > 4 * (1 << 30):
            raise ValueError(
                f"find_under spectrum would be "
                f"{4 * b * n_padded / 2**30:.1f} GiB on device (B={b}); "
                "split the query batch"
            )

        q_enc, q_mask = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        q_enc = jax.device_put(q_enc, self._query_sharding())
        q_mask = jax.device_put(q_mask, self._query_sharding())
        out = self._fetchable(
            self._fractions(q_enc, q_mask, self.db_enc, self.db_mask)
        )
        nd_dev = out.reshape(2, b, -1)  # global DB order (module docstring)

        return orchestrate_find_under(
            self.count, b, threshold, limit, compact_k,
            lambda: np.asarray(nd_dev)[:, :, : self.count],
            lambda t_hi, k: _compact_under_jit(nd_dev, t_hi, k=k),
        )


class ShardedShareEngine(_ShardedBase):
    """Participant dot-share engine over a share DB sharded across chips."""

    def __init__(self, shares_u16, mesh, chunk: int = DEFAULT_CHUNK):
        """shares_u16: uint16 [N, 12800] (host, e.g. np.memmap).

        Loading is out-of-core AND process-local: each host reads only its own
        devices' slice of each block (one contiguous source slice per block —
        a shared memmap'd file never pages in other hosts' rows), transfers
        the raw u16 rows, and byte-splits into int8 lo/hi planes on device.
        Peak host RAM = one local block slice; multi-process universes go
        through `jax.make_array_from_process_local_data`. Device HBM must
        hold the full shard (25.6 KB/entry/shard); for a DB past the mesh's
        combined HBM use the single-chip ShareEngine's streamed mode per
        party or a bigger mesh. The reference mmaps its share file the same
        way (src/main.rs:386-400), minus the multi-host axis it lacks."""
        n = shares_u16.shape[0]
        self._chunk_req = chunk  # pre-clamp request, for refresh() warnings
        chunk = effective_chunk(chunk, n, mesh.shape["db"])
        super().__init__(mesh, chunk)
        n, k = shares_u16.shape
        d = self.n_shards
        block = chunk * d
        g_blocks = max(1, -(-n // block))
        self.count = n
        self._u16_sharding = NamedSharding(mesh, P("db", None, None))
        planes_sharding = NamedSharding(mesh, P("db", None, None, None))
        # Cached across refreshes: a fresh lambda per call would miss jit's
        # cache and retrace on every DB-growth event.
        self._reformat = jax.jit(
            lambda s: jnp.stack(shares_to_planes(s), axis=1),
            out_shardings=planes_sharding,
        )
        # per block: int8 [D, 2, chunk, K], sharded on "db"
        self._blocks = [self._load_block(j, shares_u16, n)
                        for j in range(g_blocks)]

        def spmd(q_enc, planes_j):
            # local: planes_j [1, 2, c, K] -> [B, c, 31]
            return _share_dots_chunk(q_enc, planes_j[0, 0], planes_j[0, 1])

        self._block = jax.jit(
            shard_map(
                spmd,
                mesh=self.mesh,
                in_specs=(P(None, None, None), P("db", None, None, None)),
                out_specs=P(None, "db", None),
                check_vma=False,
            ),
        )

    def _load_block(self, j: int, src, n: int):
        """Transfer block j's process-local slice and byte-split on device.

        Within one block, this process's chunks are consecutive in global
        entry order: ONE contiguous source slice per block (a shared
        memmap'd file never pages in other hosts' rows)."""
        d = self.n_shards
        lo, hi = self.db_span
        span_rows = (hi - lo) * self.chunk
        k = src.shape[1]
        start = (j * d + lo) * self.chunk
        end = min(n, start + span_rows)
        rows = np.ascontiguousarray(
            src[start:end], dtype=np.uint16
        ) if end > start else np.zeros((0, k), np.uint16)
        if rows.shape[0] < span_rows:
            rows = np.pad(rows, [(0, span_rows - rows.shape[0]), (0, 0)])
        local = rows.reshape(hi - lo, self.chunk, k)
        if jax.process_count() == 1:
            dev = jax.device_put(local, self._u16_sharding)
        else:
            dev = jax.make_array_from_process_local_data(
                self._u16_sharding, local, (d, self.chunk, k)
            )
        return self._reformat(dev)

    def num_blocks(self) -> int:
        return len(self._blocks)

    def refresh(self, shares_u16) -> int:
        """Adopt a grown (append-only) share source; returns entries added.

        The sharded half of the reference's participant DB-sync TODO
        (src/main.rs:402,415). Complete blocks are reused; a previously
        padded tail block is re-loaded and new blocks appended (each process
        reads only its own slice, as at construction). The grown DB must
        still fit the mesh's combined HBM. In multi-process universes every
        process must call refresh() with its own re-opened source before
        the next query (the per-block global arrays are assembled from
        process-local data). The block list is replaced, never mutated, so
        an in-flight stream keeps valid slots (and identical prefix bytes)."""
        n_new, _ = shares_u16.shape
        if n_new < self.count:
            raise ValueError(
                f"refresh is append-only: new count {n_new} < current "
                f"{self.count} (rebuild the engine for a shrunk/rewritten DB)"
            )
        added = n_new - self.count
        if added == 0:
            self.count = n_new
            return 0
        fresh = effective_chunk(self._chunk_req, n_new, self.n_shards)
        if fresh >= 4 * self.chunk:
            import sys

            print(
                f"ShardedShareEngine: DB grew to {n_new} but keeps its "
                f"construction-time chunk {self.chunk} (a fresh build would "
                f"pick {fresh}); rebuild for fewer, larger dispatches",
                file=sys.stderr,
            )
        block = self.chunk * self.n_shards
        full_before = self.count // block  # blocks with no padded rows
        g_blocks = max(1, -(-n_new // block))
        blocks = self._blocks[:full_before]  # device copies reused
        for j in range(full_before, g_blocks):
            blocks.append(self._load_block(j, shares_u16, n_new))
        self._blocks = blocks  # atomic swap under the GIL
        self.count = n_new
        return added

    def block(self, q_enc, j: int):
        """Global chunks j*D .. j*D+D-1: uint16 [B, D*chunk, 31] in DB order."""
        return self._fetchable(self._block(q_enc, self._blocks[j]))

    def stream(self, patterns_packed, masks_packed, entry_major: bool = False):
        """Yield host uint16 blocks in DB order, trimmed ([B, n, 31] or
        entry-major [n, B, 31])."""
        from mpc_iris_tpu.models.engines import _to_entry_major, pipelined_stream

        q_enc, _ = prepare_query_planes(
            jnp.asarray(patterns_packed), jnp.asarray(masks_packed)
        )
        q_enc = self._q_transform(q_enc)
        if entry_major:
            dispatch = lambda j: _to_entry_major(self.block(q_enc, j))
        else:
            dispatch = lambda j: self.block(q_enc, j)
        yield from pipelined_stream(
            dispatch, self.num_blocks(), self.count, self.chunk * self.n_shards,
            entry_axis=0 if entry_major else 1,
        )

    def dots(self, patterns_packed, masks_packed) -> np.ndarray:
        return np.concatenate(list(self.stream(patterns_packed, masks_packed)), axis=1)


class ShardedKeyedShareEngine(_ShardedBase):
    """Multi-chip participant for a PRF-backed share (s < n-1): every shard
    REGENERATES its own rows on device from the 32-byte key.

    The purest form of the keyed design (models.KeyedShareEngine): there is no
    DB to distribute at all — each device derives its global chunk's rows from
    its own axis index via the addressable ChaCha20 stream (SPEC §4.1), so
    scaling a keyed party to more devices moves ZERO bytes of share data
    between hosts or devices. Replies stream in DB order exactly like
    ShardedShareEngine."""

    def __init__(self, key: bytes, stream_id: int, count: int, mesh,
                 chunk: int = DEFAULT_CHUNK):
        from mpc_iris_tpu.models.engines import kernel_self_test
        from mpc_iris_tpu.ops.chacha import (
            check_stream_id, key_words, share_planes_natural,
        )

        kernel_self_test()
        stream_id = check_stream_id(stream_id)
        n = int(count)
        chunk = effective_chunk(chunk, n, mesh.shape["db"])
        super().__init__(mesh, chunk)
        self.count = n
        d = self.n_shards
        self._g_blocks = max(1, -(-n // (chunk * d)))
        kw = jnp.asarray(key_words(key))
        sid = int(stream_id)

        def spmd(q_nat, kw_, j):
            i = lax.axis_index("db").astype(jnp.int32)
            row0 = (j * d + i) * chunk
            # Natural-K-order planes; queries arrive pre-permuted via
            # _q_transform (the dot is K-permutation invariant).
            lo, hi = share_planes_natural(kw_, sid, row0, chunk)
            return _share_dots_chunk(q_nat, lo, hi)

        self._kw = kw
        self._sid = sid
        self._block_fn = jax.jit(
            shard_map(
                spmd,
                mesh=self.mesh,
                in_specs=(P(None, None, None), P(None), P()),
                out_specs=P(None, "db", None),
                check_vma=False,
            ),
        )

    def num_blocks(self) -> int:
        return self._g_blocks

    def refresh(self, count: int) -> int:
        """Adopt a grown logical DB size; returns entries added. Every row
        regenerates from the key, so sync = updating the count (see
        models.KeyedShareEngine.refresh)."""
        count = int(count)
        if count < self.count:
            raise ValueError(
                f"refresh is append-only: new count {count} < current "
                f"{self.count} (rebuild the engine for a shrunk DB)"
            )
        added = count - self.count
        self.count = count
        self._g_blocks = max(1, -(-count // (self.chunk * self.n_shards)))
        return added

    def fold_pass_fn(self):
        """Single-dispatch whole-DB checksum pass over the mesh (the sharded
        analogue of KeyedShareEngine.fold_pass_fn): every device scans its own
        regenerated chunks, partial checksums combine with one `psum` over
        ``"db"``. Bench/self-test utility — the protocol path streams blocks.
        """
        from mpc_iris_tpu.models.engines import _queries_to_natural_k
        from mpc_iris_tpu.ops.chacha import share_planes_natural

        d, chunk, sid = self.n_shards, self.chunk, self._sid
        g_blocks = self._g_blocks
        if g_blocks * d * chunk != self.count:
            raise ValueError(
                f"fold_pass_fn folds whole per-shard chunks: count="
                f"{self.count} != {g_blocks}x{d}x{chunk} (the checksum would "
                "include phantom padding rows); use a chunk*n_shards-aligned "
                "count or the streaming path"
            )

        def spmd(q_enc, kw_):
            q_nat = _queries_to_natural_k(q_enc)
            i = lax.axis_index("db").astype(jnp.int32)

            def step(acc, j):
                row0 = ((j * d + i) * chunk).astype(jnp.uint32)
                lo, hi = share_planes_natural(kw_, sid, row0, chunk)
                out = _share_dots_chunk(q_nat, lo, hi)
                return acc + out.astype(jnp.uint32).sum(), None

            acc, _ = lax.scan(
                step, jnp.uint32(0), jnp.arange(g_blocks, dtype=jnp.int32)
            )
            return lax.psum(acc, "db")

        fn = jax.jit(
            shard_map(
                spmd, mesh=self.mesh,
                in_specs=(P(None, None, None), P(None)),
                out_specs=P(), check_vma=False,
            ),
        )
        return lambda q_enc: fn(q_enc, self._kw)

    def _q_transform(self, q_enc):
        from mpc_iris_tpu.models.engines import _queries_to_natural_k

        return _queries_to_natural_k(q_enc)

    def block(self, q_nat, j: int):
        return self._fetchable(
            self._block_fn(q_nat, self._kw, jnp.int32(j))
        )

    # Reply streaming is identical to the data-holding sharded engine.
    stream = ShardedShareEngine.stream
    dots = ShardedShareEngine.dots


class ShardedMasksEngine(_ShardedBase):
    """Coordinator denominator engine over a masks DB sharded across chips."""

    def __init__(self, masks_packed, mesh, chunk: int = DEFAULT_CHUNK,
                 storage: str = "auto"):
        """The masks DB lives as PER-BLOCK sharded device arrays (like
        ShardedShareEngine._blocks) so :meth:`refresh` transfers only
        appended blocks — O(added), not O(total)."""
        n = masks_packed.shape[0]
        chunk = effective_chunk(chunk, n, mesh.shape["db"])
        super().__init__(mesh, chunk)
        if storage == "auto":
            storage = "packed" if n // mesh.shape["db"] > 400_000 else "dense"
        self.storage = storage
        packed = storage == "packed"
        self._packed = packed
        self._mask_sharding = NamedSharding(mesh, P("db", None, None))
        self.count = n
        self._source = masks_packed
        block = chunk * self.n_shards
        g_blocks = max(1, -(-n // block))
        self._blocks = [self._load_block(j, masks_packed, n)
                        for j in range(g_blocks)]

        def spmd(q_mask, mask_j):
            if packed:
                from mpc_iris_tpu.models.engines import _mask_dots_chunk_packed

                return _mask_dots_chunk_packed(q_mask, mask_j[0])
            return _mask_dots_chunk(q_mask, mask_j[0])

        self._block = jax.jit(
            shard_map(
                spmd,
                mesh=self.mesh,
                in_specs=(P(None, None, None), P("db", None, None)),
                out_specs=P(None, "db", None),
                check_vma=False,
            ),
        )

    def _load_block(self, j: int, src, n: int):
        """Transfer block j's process-local slice (one contiguous source
        read; a shared memmap'd masks file never pages in other hosts'
        rows), storage-transformed on host, as a [D, chunk, W] sharded
        array."""
        d = self.n_shards
        lo, hi = self.db_span
        span_rows = (hi - lo) * self.chunk
        start = (j * d + lo) * self.chunk
        end = min(n, start + span_rows)
        rows = (np.ascontiguousarray(src[start:end], dtype=np.uint8)
                if end > start else np.zeros((0, src.shape[1]), np.uint8))
        if not self._packed:
            rows = unpack_bits(rows, xp=np).astype(np.int8)
        if rows.shape[0] < span_rows:
            rows = np.pad(rows, [(0, span_rows - rows.shape[0]), (0, 0)])
        local = rows.reshape(hi - lo, self.chunk, rows.shape[1])
        if jax.process_count() == 1:
            return jax.device_put(local, self._mask_sharding)
        return jax.make_array_from_process_local_data(
            self._mask_sharding, local, (d, self.chunk, local.shape[2])
        )

    def num_blocks(self) -> int:
        return len(self._blocks)

    def refresh(self, masks_packed) -> int:
        """Adopt a grown (append-only) masks source; returns entries added.

        Cost is O(added): complete blocks are reused; a previously-padded
        tail block is re-loaded and new blocks appended (each process reads
        only its own slice, as at construction). Same multi-process contract
        as ShardedShareEngine.refresh; the block list is replaced, never
        mutated, so in-flight streams keep valid slots. The construction-time
        storage choice is frozen (it is baked into the compiled step); warn
        when growth crosses the auto-storage threshold where a fresh build
        would have picked packed."""
        n_new = masks_packed.shape[0]
        if (not self._packed
                and n_new // self.mesh.shape["db"] > 400_000):
            import sys

            print(
                f"ShardedMasksEngine: DB grew to {n_new} with dense "
                "storage (12.8 KB/entry/shard); a fresh build would pick "
                "packed (1.6 KB) — rebuild to avoid exhausting HBM",
                file=sys.stderr,
            )
        if n_new < self.count:
            raise ValueError(
                f"refresh is append-only: new count {n_new} < current "
                f"{self.count} (rebuild the engine for a shrunk/rewritten DB)"
            )
        if n_new == self.count:
            return 0
        added = n_new - self.count
        block = self.chunk * self.n_shards
        full_before = self.count // block  # blocks with no padded rows
        g_blocks = max(1, -(-n_new // block))
        self._source = masks_packed
        self.count = n_new
        blocks = self._blocks[:full_before]  # device copies reused
        for j in range(full_before, g_blocks):
            blocks.append(self._load_block(j, masks_packed, n_new))
        self._blocks = blocks  # atomic swap under the GIL
        return added

    def stream(self, masks_packed, entry_major: bool = False):
        from mpc_iris_tpu.models.engines import _to_entry_major, pipelined_stream

        q = jnp.asarray(masks_packed)
        _, q_mask = prepare_query_planes(jnp.zeros_like(q), q)
        blocks = self._blocks  # snapshot: refresh() swaps, never mutates
        if entry_major:
            dispatch = lambda j: self._fetchable(
                _to_entry_major(self._block(q_mask, blocks[j]))
            )
        else:
            dispatch = lambda j: self._fetchable(self._block(q_mask, blocks[j]))
        # len(blocks)/count captured together with the snapshot so a refresh
        # racing this generator cannot index past the snapshot list.
        yield from pipelined_stream(
            dispatch, len(blocks), min(self.count, len(blocks) * self.chunk
                                       * self.n_shards),
            self.chunk * self.n_shards,
            entry_axis=0 if entry_major else 1,
        )

    def dots(self, masks_packed) -> np.ndarray:
        return np.concatenate(list(self.stream(masks_packed)), axis=1)
