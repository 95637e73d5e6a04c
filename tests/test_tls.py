"""TLS on the coordinator↔participant wire (protocol/tlsutil.py).

The reference protocol is raw TCP with no transport security or peer
authentication (src/main.rs:405-445); this framework layers standard TLS
(1.3+) over the byte-identical wire. Covers: a full query through a TLS
tunnel matching the plaintext-oracle winner, mutual-TLS client auth, and
rejection of untrusted peers in both directions.
"""

import asyncio
import pathlib
import ssl

import numpy as np
import pytest

from mpc_iris_tpu.models import MasksEngine, ShareEngine
from mpc_iris_tpu.protocol import Coordinator, ParticipantServer
from mpc_iris_tpu.protocol import keyagree, tlsutil
from mpc_iris_tpu.types import Template

from test_protocol import build_party_data  # tests/ is on sys.path under pytest

# The TLS contexts are stdlib ssl, but the test certificates are minted with
# the optional `cryptography` package (like tests/test_keyagree.py).
pytestmark = pytest.mark.skipif(
    not keyagree.have_crypto(), reason="cryptography package not installed"
)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    out = {}
    for name in ("p0", "p1", "coord", "rogue"):
        key, crt = tlsutil.generate_self_signed(str(d / name), name)
        out[name] = (key, crt)
    # trust bundle of both participants for the coordinator
    bundle = d / "parties.pem"
    bundle.write_bytes(
        pathlib.Path(out["p0"][1]).read_bytes()
        + pathlib.Path(out["p1"][1]).read_bytes()
    )
    out["bundle"] = str(bundle)
    return out


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    db = [Template.random(rng) for _ in range(13)]
    query = Template.random(rng)
    db[4] = query.rotated(-3)  # plant the winner
    masks = np.stack([t.mask.data for t in db])
    mats = build_party_data(rng, db, 2)
    return db, query, masks, mats


def _run(world, server_ssl, client_ssl):
    db, query, masks, mats = world

    async def go():
        servers = [
            ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0,
                              ssl_context=ctx)
            for m, ctx in zip(mats, server_ssl)
        ]
        addrs = [await s.start() for s in servers]
        coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                            batch_records=5, ssl_context=client_ssl)
        try:
            return await coord.query(query)
        finally:
            for s in servers:
                await s.close()

    return asyncio.run(go())


def test_query_through_tls_tunnel(world, certs):
    """2-party query over TLS == the plaintext scalar oracle (the wire inside
    the tunnel is unchanged)."""
    db, query, masks, mats = world
    server_ssl = [
        tlsutil.server_context(certs[p][1], certs[p][0]) for p in ("p0", "p1")
    ]
    client_ssl = tlsutil.client_context(certs["bundle"])
    outcome = _run(world, server_ssl, client_ssl)
    oracle = np.array([query.distance(t) for t in db])
    assert (outcome.index, outcome.distance) == (
        int(np.argmin(oracle)), oracle.min())


def test_mutual_tls_client_auth(world, certs):
    """Participants requiring mutual TLS accept a coordinator presenting a
    trusted certificate and reject one presenting none."""
    db, query, masks, mats = world
    server_ssl = [
        tlsutil.server_context(certs[p][1], certs[p][0], ca=certs["coord"][1])
        for p in ("p0", "p1")
    ]
    good = tlsutil.client_context(certs["bundle"], certfile=certs["coord"][1],
                                  keyfile=certs["coord"][0])
    outcome = _run(world, server_ssl, good)
    oracle = np.array([query.distance(t) for t in db])
    assert outcome.distance == oracle.min()

    anon = tlsutil.client_context(certs["bundle"])  # no client certificate
    with pytest.raises((ConnectionError, ssl.SSLError, asyncio.IncompleteReadError)):
        _run(world, server_ssl, anon)


def test_untrusted_server_rejected(world, certs):
    """A participant serving a certificate outside the coordinator's trust
    bundle fails the handshake — no share data flows to an imposter."""
    server_ssl = [
        tlsutil.server_context(certs["rogue"][1], certs["rogue"][0]),
        tlsutil.server_context(certs["p1"][1], certs["p1"][0]),
    ]
    client_ssl = tlsutil.client_context(certs["bundle"])
    with pytest.raises(ConnectionError):
        _run(world, server_ssl, client_ssl)


def test_cli_tls_flag_validation(tmp_path, monkeypatch):
    """Inconsistent --tls-* flag combinations fail fast with rc 1 and a
    clean message on every role — before any engine build or connection."""
    from mpc_iris_tpu.cli import main

    monkeypatch.chdir(tmp_path)
    # cert without key (participant), cert without ca (coordinator/benchmark),
    # missing PEM file (participant): all must return 1, never traceback.
    assert main(["participant", "nonexistent.share", "--tls-cert", "x.crt"]) == 1
    assert main(["benchmark", "127.0.0.1:1", "--tls-cert", "x.crt"]) == 1
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--tls-cert", "x.crt"]) == 1
    (tmp_path / "k.key").write_text("not a pem")
    assert main(["participant", "nonexistent.share", "--tls-cert", "x.crt",
                 "--tls-key", "k.key"]) == 1
    # serving-socket TLS flags: need --serve, need cert AND key, PEM must load
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--serve-tls-cert", "x.crt"]) == 1
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--serve", "--serve-tls-cert", "x.crt"]) == 1
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--serve", "--serve-tls-cert", "x.crt",
                 "--serve-tls-key", "k.key"]) == 1


def test_tls_cert_cli_mints_usable_pair(tmp_path, monkeypatch):
    """`tls-cert` output loads into both server and client contexts."""
    from mpc_iris_tpu.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["tls-cert", "party0", "p0"]) == 0
    assert main(["tls-cert", "party0", "p0"]) == 1  # refuses overwrite
    import os

    assert os.stat(tmp_path / "p0.key").st_mode & 0o777 == 0o600
    tlsutil.server_context("p0.crt", "p0.key")
    tlsutil.client_context("p0.crt")
    with pytest.raises(ValueError, match="both"):
        tlsutil.client_context("p0.crt", certfile="p0.crt")


def test_plaintext_client_to_tls_server_fails(world, certs):
    """A non-TLS coordinator cannot talk to a TLS participant (and vice
    versa the handshake never completes) — misconfiguration fails loudly
    rather than exchanging bytes."""
    server_ssl = [
        tlsutil.server_context(certs[p][1], certs[p][0]) for p in ("p0", "p1")
    ]
    with pytest.raises((ConnectionError, asyncio.IncompleteReadError, ValueError)):
        _run(world, server_ssl, None)


def test_query_server_client_facing_tls(world, certs):
    """The SERVING socket (QueryServer / coordinator --serve-tls-*) carries
    TLS independently of the participant wire: a trusted client gets the
    oracle winner and an untrusted-CA client is rejected at the handshake."""
    from mpc_iris_tpu.protocol import QueryServer, query_remote

    db, query, masks, mats = world
    oracle = np.array([query.distance(t) for t in db])
    key, crt = certs["coord"]
    server_ssl = tlsutil.server_context(crt, key)
    good = tlsutil.client_context(crt)          # trusts the server's cert
    bad = tlsutil.client_context(certs["rogue"][1])  # trusts a rogue CA only

    async def go():
        parts = [
            ParticipantServer(ShareEngine(m, chunk=8), "127.0.0.1", 0)
            for m in mats
        ]
        addrs = [await p.start() for p in parts]
        coord = Coordinator(MasksEngine(masks, chunk=8), addrs,
                            batch_records=5)
        server = QueryServer(coord, "127.0.0.1", 0, ssl_context=server_ssl)
        host, port = await server.start()
        try:
            outcome = await query_remote(host, port, query, ssl_context=good)
            with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
                await query_remote(host, port, query, ssl_context=bad)
            return outcome
        finally:
            await server.close()
            for p in parts:
                await p.close()

    outcome = asyncio.run(go())
    assert outcome.total == len(db)
    assert outcome.index == int(np.argmin(oracle))
    assert outcome.distance == oracle.min()


def test_chain_hops_over_mutual_tls(world, certs):
    """Chained aggregation (SPEC 5.4) with every link in TLS: coordinator ->
    head and head -> upstream hop each carry independent TLS (the hop
    presents the head's own certificate as its client identity)."""
    from mpc_iris_tpu.models import MasksEngine as ME, ShareEngine as SE
    from mpc_iris_tpu.ops.encode import encode_template

    db, query, masks, _mats = world
    rng = np.random.default_rng(11)
    mats = build_party_data(rng, db, 3)

    async def go():
        # root party p0: TLS server demanding a client cert from p1
        root = ParticipantServer(
            SE(mats[0], chunk=8), "127.0.0.1", 0, wire="chain",
            ssl_context=tlsutil.server_context(
                certs["p0"][1], certs["p0"][0], ca=certs["p1"][1]
            ),
        )
        root_addr = await root.start()
        # head party p1: TLS server for the coordinator, TLS CLIENT to p0
        head = ParticipantServer(
            SE(mats[1], chunk=8), "127.0.0.1", 0, wire="chain",
            ssl_context=tlsutil.server_context(certs["p1"][1], certs["p1"][0]),
            upstream_ssl_context=tlsutil.client_context(
                certs["p0"][1], certfile=certs["p1"][1],
                keyfile=certs["p1"][0],
            ),
        )
        head_addr = await head.start()
        coord = Coordinator(
            ME(masks, chunk=8), [root_addr, head_addr],
            local_engine=SE(mats[2], chunk=8), batch_records=5,
            ssl_context=tlsutil.client_context(certs["p1"][1]), chain=True,
        )
        try:
            return await coord.query(query)
        finally:
            await head.close()
            await root.close()

    outcome = asyncio.run(go())
    oracle = np.array([query.distance(t) for t in db])
    assert (outcome.index, outcome.distance, outcome.total) == (
        int(np.argmin(oracle)), oracle.min(), len(db),
    )


def test_chain_disallowed_upstream_aborts(world, certs):
    """allowed_upstreams: a chain request naming an address outside the
    allowlist is refused with an abort — the relay/SSRF guard."""
    from mpc_iris_tpu.models import MasksEngine as ME, ShareEngine as SE

    db, query, masks, mats = world

    async def go():
        head = ParticipantServer(
            SE(mats[0], chunk=8), "127.0.0.1", 0, wire="chain",
            allowed_upstreams={"10.0.0.1:1234"},  # not what we'll request
        )
        head_addr = await head.start()
        coord = Coordinator(
            ME(masks, chunk=8), [("127.0.0.1", 9), head_addr],
            local_engine=SE(mats[1], chunk=8), batch_records=5, chain=True,
        )
        try:
            with pytest.raises(ConnectionError):
                await coord.query_batch([query])
        finally:
            await head.close()

    asyncio.run(go())
