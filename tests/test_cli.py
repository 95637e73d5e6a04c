"""CLI role end-to-end tests (the reference leaves main.rs entirely untested —
SURVEY.md section 4 flags that as a gap this suite closes).

generate -> prepare -> decrypt roundtrip and a local match smoke, all through
cli.main() on tiny data (CPU backend from conftest).
"""

import json
import os

import numpy as np
import pytest

from mpc_iris_tpu import native
from mpc_iris_tpu.cli import main
from mpc_iris_tpu.io.formats import open_masks, open_share


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _planes(path):
    pats, msks = [], []
    with open(path, "rb") as f:
        for p, m in native.parse_templates_stream(f):
            pats.append(p)
            msks.append(m)
    return np.concatenate(pats), np.concatenate(msks)


def test_generate_prepare_decrypt_roundtrip(workdir):
    assert main(["generate", "db.json", "24", "--seed", "3"]) == 0
    raw = (workdir / "db.json").read_bytes()
    objs = json.loads(raw)
    assert len(objs) == 24 and set(objs[0]) == {"pattern", "mask"}

    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "9"]) == 0
    masks = open_masks("mpc.masks")
    assert masks.shape == (24, 1600)
    s0, s1 = open_share("mpc.share-0"), open_share("mpc.share-1")
    assert s0.shape == s1.shape == (24, 12800)

    # Shares reconstruct to the ring encoding of the inputs.
    pats, msks_in = _planes("db.json")
    assert np.array_equal(np.asarray(masks), msks_in)
    enc = native.encode_u16_native(pats, msks_in)
    total = (np.asarray(s0, np.uint16) + np.asarray(s1, np.uint16)).astype(np.uint16)
    assert np.array_equal(total, enc)

    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "--output", "dec.json"]) == 0
    dp, dm = _planes("dec.json")
    assert np.array_equal(dm, msks_in)
    assert np.array_equal(dp & dm, pats & msks_in)  # pattern defined under mask
    assert not np.any(dp & ~dm)  # no leakage outside the mask


def test_generate_refuses_overwrite(workdir):
    assert main(["generate", "db.json", "4"]) == 0
    assert main(["generate", "db.json", "4"]) == 1
    assert main(["generate", "db.json", "4", "--replace"]) == 0


def test_match_smoke(workdir, capsys):
    assert main(["generate", "db.json", "40", "--seed", "11"]) == 0
    assert main(["match", "db.json", "--batch", "4", "--seed", "2"]) == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("query ")]
    assert len(lines) == 4
    # self-match queries are sampled from the DB -> exact hits at distance 0.0
    assert all("at distance 0.0" in l for l in lines)


def test_match_all_under_lists_duplicates(workdir, capsys):
    """Dedup audit: --all-under lists every entry under the threshold (the
    self-match queries are rotated DB entries, so each query has >= 1 exact
    zero-distance hit)."""
    assert main(["generate", "db.json", "40", "--seed", "11"]) == 0
    assert main(["match", "db.json", "--batch", "4", "--seed", "2",
                 "--all-under", "1e-6"]) == 0
    out = capsys.readouterr().out
    heads = [l for l in out.splitlines() if l.startswith("query ")]
    hits = [l for l in out.splitlines() if l.lstrip().startswith("entry ")]
    assert len(heads) == 4
    assert len(hits) >= 4
    assert all("at distance 0.0" in l for l in hits)
    # strict <: a zero threshold excludes the exact duplicates
    assert main(["match", "db.json", "--batch", "4", "--seed", "2",
                 "--all-under", "0.0"]) == 0
    out = capsys.readouterr().out
    assert all(" 0 entries under " in l
               for l in out.splitlines() if l.startswith("query "))


def test_coordinator_queries_file_all_under(workdir, capsys):
    """--queries-file drives REAL templates (instead of self-generated random
    ones) through the coordinator; with --all-under each DB-drawn query must
    list its own entry at distance 0.0. Exercised with a 1-party local share
    (no sockets: the coordinator holds the only share)."""
    assert main(["generate", "db.json", "12", "--seed", "31"]) == 0
    assert main(["prepare", "db.json", "1", "mpc", "--insecure-seed", "8"]) == 0
    assert main(["coordinator", "--masks", "mpc.masks", "--share",
                 "mpc.share-0", "--queries-file", "db.json", "--queries", "3",
                 "--all-under", "1e-9", "--no-warmup"]) == 0
    out = capsys.readouterr().out
    heads = [l for l in out.splitlines() if l.startswith("query ")]
    hits = [l for l in out.splitlines() if l.lstrip().startswith("entry ")]
    assert len(heads) == 3
    assert [f"entry {i} at distance 0.0" in h for i, h in enumerate(hits)] \
        == [True, True, True]
    # argmin mode consumes the same file; self-queries win at distance 0.0
    assert main(["coordinator", "--masks", "mpc.masks", "--share",
                 "mpc.share-0", "--queries-file", "db.json", "--queries", "2",
                 "--no-warmup"]) == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("query ")]
    assert len(lines) == 2
    assert all("at distance 0.0" in l for l in lines)
    for i, l in enumerate(lines):
        assert f"closest entry {i} " in l


def test_match_distances_out(workdir, capsys):
    """--distances-out exports the [B, N] f64 spectrum; self-match queries
    must show exact 0.0 at their planted entries and the argmin of the
    exported matrix must agree with the match winners."""
    assert main(["generate", "db.json", "24", "--seed", "13"]) == 0
    assert main(["match", "db.json", "--batch", "3", "--seed", "5",
                 "--distances-out", "d.npy"]) == 0
    dist = np.load(workdir / "d.npy")
    assert dist.shape == (3, 24) and dist.dtype == np.float64
    assert (dist.min(axis=1) == 0.0).all()  # planted self-matches
    capsys.readouterr()
    assert main(["match", "db.json", "--batch", "3", "--seed", "5"]) == 0
    out = capsys.readouterr().out
    for b, line in enumerate(l for l in out.splitlines()
                             if l.startswith("query ")):
        assert f"closest entry {int(dist[b].argmin())} " in line


def test_store_check(workdir, capsys):
    """fsck for the share store: clean stores pass (incl. --key/--deep);
    corruption, desync, torn tails (--strict) and bad sidecars are caught."""
    assert main(["generate", "db.json", "10", "--seed", "41"]) == 0
    assert main(["prepare", "db.json", "3", "mpc", "--insecure-seed", "6",
                 "--save-key", "mpc.key"]) == 0
    ok = ["store-check", "mpc", "--count", "3", "--key", "mpc.key", "--deep"]
    assert main(ok) == 0

    # corrupt one sampled row of share-1: --deep catches the desync
    with open(workdir / "mpc.share-1", "r+b") as f:
        f.seek(0)
        f.write(b"\xff" * 16)
    assert main(ok) == 1
    err = capsys.readouterr().err
    assert "PROBLEM" in err
    # restore via fresh prepare
    for p in workdir.glob("mpc.*"):
        p.unlink()
    assert main(["prepare", "db.json", "3", "mpc", "--insecure-seed", "6",
                 "--save-key", "mpc.key"]) == 0

    # a rerandomized store is no longer the pure keystream: --key fails,
    # but --deep (reconstruction) still passes
    assert main(["rerandomize", "mpc.share-0", "--index", "0",
                 "--pair", "1:777"]) == 0
    assert main(["rerandomize", "mpc.share-1", "--index", "1",
                 "--pair", "0:777"]) == 0
    assert main(["store-check", "mpc", "--deep"]) == 0
    assert main(["store-check", "mpc", "--key", "mpc.key"]) == 1
    capsys.readouterr()

    # torn trailing bytes: warning by default, problem under --strict
    with open(workdir / "mpc.masks", "ab") as f:
        f.write(b"\x00" * 7)
    assert main(["store-check", "mpc"]) == 0
    assert "warning" in capsys.readouterr().err
    assert main(["store-check", "mpc", "--strict"]) == 1

    # count sidecar disagreement
    (workdir / "mpc.count").write_text("99\n")
    assert main(["store-check", "mpc"]) == 1
    capsys.readouterr()

    # fsck must SURVIVE the garbage it exists to find: a non-numeric count
    # sidecar and a stray non-numeric share filename are PROBLEM reports,
    # not tracebacks
    (workdir / "mpc.count").write_text("not-a-number\n")
    assert main(["store-check", "mpc"]) == 1
    assert "unparseable" in capsys.readouterr().err
    (workdir / "mpc.count").unlink()
    (workdir / "mpc.share-backup").write_bytes(b"junk")
    assert main(["store-check", "mpc"]) == 1
    assert "unrecognized share filename" in capsys.readouterr().err


def test_coordinator_serve_flag_validation(workdir):
    """Contradictory serving flags fail fast with rc 1 (before engine builds)."""
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--audit"]) == 1  # --audit needs --serve
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--serve", "--queries-file", "x.json"]) == 1
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--serve", "--all-under", "0.3"]) == 1
    # --strict-scan + --watch: documented-illegitimate pairing is rejected
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--strict-scan", "--watch"]) == 1


def test_rerandomize_cli_roundtrip(workdir):
    """CLI-level regression for the memmap segfault: share files must actually
    change on disk while reconstruction stays identical."""
    assert main(["generate", "db.json", "8", "--seed", "4"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "6"]) == 0
    before0 = (workdir / "mpc.share-0").read_bytes()
    before1 = (workdir / "mpc.share-1").read_bytes()
    assert main(["decrypt", "mpc.share-0", "mpc.share-1",
                 "--output", "before.json"]) == 0
    assert main(["rerandomize", "mpc.share-0", "--index", "0",
                 "--pair", "1:777"]) == 0
    assert main(["rerandomize", "mpc.share-1", "--index", "1",
                 "--pair", "0:777"]) == 0
    assert (workdir / "mpc.share-0").read_bytes() != before0
    assert (workdir / "mpc.share-1").read_bytes() != before1
    assert main(["decrypt", "mpc.share-0", "mpc.share-1",
                 "--output", "after.json"]) == 0
    assert (workdir / "before.json").read_bytes() == (workdir / "after.json").read_bytes()


def test_prepare_append_extends_store_byte_identically(workdir):
    """Incremental ETL (`prepare --append`, the reference's sync TODO,
    src/main.rs:402): preparing 6 entries then appending 4 with the SAME key
    must produce byte-identical files to a one-shot 10-entry prepare — the
    appended rows continue the same addressable keystreams, so existing
    keyed:<s>:... specs stay valid for the grown count."""
    assert main(["generate", "db.json", "10", "--seed", "21"]) == 0
    objs = json.loads((workdir / "db.json").read_bytes())
    (workdir / "head.json").write_text(json.dumps(objs[:6]))
    (workdir / "tail.json").write_text(json.dumps(objs[6:]))

    assert main(["prepare", "db.json", "2", "ref", "--insecure-seed", "5"]) == 0
    assert main(["prepare", "head.json", "2", "mpc", "--insecure-seed", "5",
                 "--save-key", "mpc.key"]) == 0
    # Append with the saved key (the production path: --key, not the seed).
    assert main(["prepare", "tail.json", "2", "mpc", "--key", "mpc.key",
                 "--append"]) == 0
    for name in ["masks", "share-0", "share-1"]:
        assert (workdir / f"mpc.{name}").read_bytes() == \
            (workdir / f"ref.{name}").read_bytes(), name


def test_prepare_writes_count_sidecar(workdir):
    """`prepare` maintains `<base>.count` (the keyed parties' growth signal,
    consumed by `participant --watch --watch-count`)."""
    assert main(["generate", "db.json", "6", "--seed", "23"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--save-key", "mpc.key"]) == 0
    assert (workdir / "mpc.count").read_text().strip() == "6"
    assert main(["prepare", "db.json", "2", "mpc", "--key", "mpc.key",
                 "--append"]) == 0
    assert (workdir / "mpc.count").read_text().strip() == "12"


def test_participant_watch_flag_validation(workdir):
    assert main(["generate", "db.json", "4", "--seed", "24"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--save-key", "mpc.key"]) == 0
    # keyed + --watch needs a count source
    assert main(["participant", "keyed:0:4:mpc.key", "127.0.0.1:0",
                 "--watch", "--no-warmup"]) == 1
    # file share + --watch-count is contradictory
    assert main(["participant", "mpc.share-0", "127.0.0.1:0", "--watch",
                 "--watch-count", "mpc.count", "--no-warmup"]) == 1
    # --watch-count without --watch does nothing: refuse it
    assert main(["participant", "mpc.share-0", "127.0.0.1:0",
                 "--watch-count", "mpc.count", "--no-warmup"]) == 1


def test_prepare_append_validation(workdir):
    assert main(["generate", "db.json", "4", "--seed", "22"]) == 0
    # --append needs an existing store.
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--append"]) == 1
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--save-key", "mpc.key"]) == 0
    # --key and --insecure-seed are mutually exclusive.
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--key", "mpc.key", "--append"]) == 1
    # Torn file: not a whole number of records.
    with open(workdir / "mpc.masks", "ab") as f:
        f.write(b"x" * 100)
    assert main(["prepare", "db.json", "2", "mpc", "--key", "mpc.key",
                 "--append"]) == 1
    with open(workdir / "mpc.masks", "ab") as f:
        f.write(b"x" * 1500)  # whole record again, but counts now disagree
    assert main(["prepare", "db.json", "2", "mpc", "--key", "mpc.key",
                 "--append"]) == 1
    # Appending with a SMALLER share count than the store was built with
    # would write (n-1)-party share math into an n-party store: refused.
    assert main(["prepare", "db.json", "3", "mpc3", "--insecure-seed", "5",
                 "--save-key", "mpc3.key"]) == 0
    assert main(["prepare", "db.json", "2", "mpc3", "--key", "mpc3.key",
                 "--append"]) == 1
    # A missing/typo'd key file is a clean error, not a traceback.
    assert main(["prepare", "db.json", "3", "mpc3", "--key", "nope.key",
                 "--append"]) == 1


def test_rekey_epoch_rotation(workdir):
    """`rekey` rotates the keyed epoch: plaintext is preserved (never
    reconstructed), the NEW key's streams match the rewritten files, and the
    OLD key's no longer do."""
    assert main(["generate", "db.json", "9", "--seed", "51"]) == 0
    assert main(["prepare", "db.json", "3", "mpc", "--insecure-seed", "4",
                 "--save-key", "mpc.key"]) == 0
    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "mpc.share-2",
                 "--output", "before.json"]) == 0
    olds = {i: (workdir / f"mpc.share-{i}").read_bytes() for i in range(3)}

    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key",
                 "--new-key-out", "mpc.key2", "--insecure-new-seed", "5",
                 "--batch", "4"]) == 0
    for i in range(3):  # every local share file was rewritten
        assert (workdir / f"mpc.share-{i}").read_bytes() != olds[i], i

    # File reconstruction unchanged; the new key regenerates the keyed files.
    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "mpc.share-2",
                 "--output", "after.json"]) == 0
    assert (workdir / "before.json").read_bytes() == \
        (workdir / "after.json").read_bytes()
    assert main(["decrypt", "keyed:0:9:mpc.key2", "keyed:1:9:mpc.key2",
                 "mpc.share-2", "--output", "after2.json"]) == 0
    assert (workdir / "after2.json").read_bytes() == \
        (workdir / "after.json").read_bytes()
    # The old epoch's key now reconstructs garbage.
    assert main(["decrypt", "keyed:0:9:mpc.key", "mpc.share-1", "mpc.share-2",
                 "--output", "stale.json"]) == 0
    assert (workdir / "stale.json").read_bytes() != \
        (workdir / "after.json").read_bytes()

    # Keyed deployment shape: party 0 keeps no share file locally — rekey
    # rewrites only what is local; keyed:0 with the next key still works.
    os.remove(workdir / "mpc.share-0")
    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key2",
                 "--new-key-out", "mpc.key3", "--insecure-new-seed", "6",
                 "--batch", "4"]) == 0
    assert main(["decrypt", "keyed:0:9:mpc.key3", "mpc.share-1",
                 "mpc.share-2", "--output", "after3.json"]) == 0
    assert (workdir / "after3.json").read_bytes() == \
        (workdir / "after.json").read_bytes()

    # Refusals: overwrite a key file, rotate to the same key, missing data.
    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key3",
                 "--new-key-out", "mpc.key2"]) == 1
    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key3",
                 "--new-key-out", "k4", "--insecure-new-seed", "6"]) == 1
    assert main(["rekey", "mpc", "--count", "2", "--old-key", "mpc.key3",
                 "--new-key-out", "k4", "--insecure-new-seed", "7"]) == 1
    # A wrong --old-key (or a rerandomized store) would silently corrupt:
    # the keystream spot-check refuses it when a keyed file is local.
    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key2",
                 "--new-key-out", "k4", "--insecure-new-seed", "7"]) == 1


def test_rekey_refuses_rerandomized_store(workdir):
    """After rerandomize the keyed files are keystream + noise; rotating
    them as if pure keystream corrupts reconstruction — rekey must refuse."""
    assert main(["generate", "db.json", "5", "--seed", "52"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "4",
                 "--save-key", "mpc.key"]) == 0
    assert main(["rerandomize", "mpc.share-0", "--index", "0",
                 "--pair", "1:99"]) == 0
    assert main(["rerandomize", "mpc.share-1", "--index", "1",
                 "--pair", "0:99"]) == 0
    assert main(["rekey", "mpc", "--count", "2", "--old-key", "mpc.key",
                 "--new-key-out", "k2", "--insecure-new-seed", "8"]) == 1
    assert not os.path.exists(workdir / "k2")


def test_share_engine_from_spec_dispatch(workdir):
    """The unified share constructor behind participant and coordinator
    --share: a file path opens a ShareEngine, a keyed:<s>:<count>:<keyfile>
    spec builds a keyed engine with identical dot streams (share 0 of n=2 is
    PRF-backed, SPEC section 4.2), and malformed specs raise ValueError."""
    from mpc_iris_tpu.cli import _share_engine_from_spec
    from mpc_iris_tpu.ops.encode import pack_bits

    assert main(["generate", "db.json", "16", "--seed", "5"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "8",
                 "--save-key", "mpc.key"]) == 0

    file_eng = _share_engine_from_spec("mpc.share-0", 8)
    keyed_eng = _share_engine_from_spec(f"keyed:0:16:{workdir}/mpc.key", 8)

    rng = np.random.default_rng(2)
    pat = pack_bits(rng.integers(0, 2, size=(1, 31, 12800)).astype(bool))
    msk = pack_bits(np.ones((1, 31, 12800), bool))
    np.testing.assert_array_equal(
        np.asarray(file_eng.dots(pat, msk)), np.asarray(keyed_eng.dots(pat, msk))
    )

    with pytest.raises(ValueError):
        _share_engine_from_spec("keyed:0:16:/nonexistent-key", 8)


def test_query_client_cli(workdir, capsys):
    """`query` client against a live QueryServer (SPEC section 5.2): verdicts
    and distances come back over the 24-byte serving wire."""
    import asyncio
    import threading

    from mpc_iris_tpu.models import MasksEngine, ShareEngine
    from mpc_iris_tpu.protocol import Coordinator, QueryServer

    assert main(["generate", "db.json", "12", "--seed", "31"]) == 0
    assert main(["prepare", "db.json", "1", "mpc", "--insecure-seed", "2"]) == 0
    masks = open_masks("mpc.masks")
    share = open_share("mpc.share-0")

    loop = asyncio.new_event_loop()
    ready = threading.Event()
    state = {}

    async def serve():
        coord = Coordinator(
            MasksEngine(np.asarray(masks), chunk=8), [],
            local_engine=ShareEngine(np.asarray(share), chunk=8),
        )
        server = QueryServer(coord, "127.0.0.1", 0)
        await server.start()
        state["server"] = server
        state["port"] = server.port
        ready.set()
        await server.serve_forever()

    def run_loop():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(serve())
        except (asyncio.CancelledError, RuntimeError):
            pass  # RuntimeError: loop.stop() fired before serve() finished
        finally:
            # Retire whatever is still pending (serve(), micro-batcher,
            # handler tasks) so interpreter-exit GC never sees a pending
            # task or an open loop.
            pending = asyncio.all_tasks(loop)
            for task in pending:
                task.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()
            asyncio.set_event_loop(None)

    t = threading.Thread(target=run_loop, daemon=True)
    t.start()
    assert ready.wait(timeout=60)
    try:
        # Self-queries from the DB itself: every verdict is DUPLICATE at 0.0.
        # default: >1 template reuses ONE persistent connection (SPEC 5.5);
        # --one-shot restores the reference's connection-per-query. Outcomes
        # must be identical.
        for extra in ([], ["--one-shot"]):
            rc = main(["query", f"127.0.0.1:{state['port']}", "db.json",
                       "--count", "3", "--threshold", "0.5"] + extra)
            assert rc == 0
            out = capsys.readouterr().out
            lines = [l for l in out.splitlines() if l.startswith("query ")]
            assert len(lines) == 3
            for i, l in enumerate(lines):
                assert f"closest entry {i} of 12" in l
                assert "at distance 0.0" in l and "DUPLICATE" in l
    finally:
        fut = asyncio.run_coroutine_threadsafe(state["server"].close(), loop)
        try:
            fut.result(timeout=10)
        except Exception:
            pass
        try:
            loop.call_soon_threadsafe(loop.stop)
        except RuntimeError:
            pass  # serve() already returned and run_loop closed the loop
        t.join(timeout=10)


def test_serving_observability_signals(tmp_path, capsys):
    """SIGUSR1 dumps a one-line JSON stats snapshot; SIGUSR2 toggles a
    device trace into --profile-dir (fresh subdir per capture, closed
    cleanly); without a profile dir SIGUSR2 logs a hint. None of it requires
    restarting the role."""
    import asyncio
    import os as _os
    import signal as _signal

    from mpc_iris_tpu.cli import _attach_observability

    prof = tmp_path / "prof"
    prof.mkdir()

    async def go():
        loop = asyncio.get_running_loop()
        cleanup = _attach_observability(
            loop, "participant", stats_fn=lambda: {"served": 3, "failed": 0},
            profile_dir=str(prof))
        _os.kill(_os.getpid(), _signal.SIGUSR1)   # stats dump
        await asyncio.sleep(0.05)
        _os.kill(_os.getpid(), _signal.SIGUSR2)   # trace start
        await asyncio.sleep(0.05)
        _os.kill(_os.getpid(), _signal.SIGUSR2)   # trace stop
        await asyncio.sleep(0.05)
        cleanup()

        # no profile dir: SIGUSR2 is a hint, not a crash
        cleanup2 = _attach_observability(loop, "query server",
                                         stats_fn=None, profile_dir=None)
        _os.kill(_os.getpid(), _signal.SIGUSR2)
        await asyncio.sleep(0.05)
        cleanup2()

    asyncio.run(go())
    err = capsys.readouterr().err
    assert '"served": 3' in err and '"trace_active": false' in err
    assert "device trace STARTED" in err and "device trace stopped" in err
    assert "SIGUSR2 ignored" in err
    # the capture produced a real trace directory with content
    subdirs = list(prof.iterdir())
    assert len(subdirs) == 1 and any(subdirs[0].rglob("*"))


def test_serving_observability_trace_closed_at_shutdown(tmp_path, capsys):
    """An open SIGUSR2 trace is stopped by cleanup() (drain path) so the
    capture is readable, never torn."""
    import asyncio
    import os as _os
    import signal as _signal

    from mpc_iris_tpu.cli import _attach_observability

    prof = tmp_path / "prof"
    prof.mkdir()

    async def go():
        loop = asyncio.get_running_loop()
        cleanup = _attach_observability(loop, "participant",
                                        stats_fn=None,
                                        profile_dir=str(prof))
        _os.kill(_os.getpid(), _signal.SIGUSR2)   # start, never stop
        await asyncio.sleep(0.05)
        cleanup()

    asyncio.run(go())
    err = capsys.readouterr().err
    assert "device trace STARTED" in err
    assert "closed at shutdown" in err
