"""Golden end-to-end parity tests (the reference's test_distance_ref and
test_encrypted_distances, src/template.rs:101-112 and src/lib.rs:165-193).

tests/golden_distances.json records f64 distances computed by the pure-Python
bit-by-bit oracle (tests/oracles.py) on deterministically generated templates. Every
pipeline — NumPy scalar, fused plaintext device engine, and the full N-party encoded
path — must reproduce them exactly (stricter than the reference's 1-ulp bar: our f64
values are computed from identical integers, so they are bit-identical).
"""

import json
import os

import numpy as np
import pytest

from mpc_iris_tpu.models import MasksEngine, PlaintextEngine, ShareEngine
from mpc_iris_tpu.ops.decode import decode_distance
from mpc_iris_tpu.ops.encode import encode_template
from mpc_iris_tpu.types import Bits, Template

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_distances.json")


def generate_templates(seed: int):
    """Deterministic fixture generation — must not change, or regenerate the golden
    file with tests/oracles.py's distance_slow."""
    rng = np.random.default_rng(seed)
    templates = [Template.random(rng) for _ in range(8)]
    for i in range(8):
        base = templates[i]
        r = int(rng.integers(-15, 16))
        t = base.rotated(r)
        noise = rng.random(12800) < 0.05
        pat = np.unpackbits(t.pattern.data, bitorder="little") ^ noise
        templates.append(
            Template(Bits(np.packbits(pat, bitorder="little")), Bits(t.mask.data))
        )
    templates.append(Template(Bits(), Bits()))
    return templates


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        data = json.load(f)
    templates = generate_templates(data["seed"])
    assert len(templates) == data["n_templates"]
    return templates, data["distances"]


def _expect(d):
    return float("inf") if d is None else float(d)


def test_scalar_oracle_matches_golden(golden):
    templates, dists = golden
    for rec in dists:
        got = templates[rec["left"]].distance(templates[rec["right"]])
        assert got == _expect(rec["distance"]), rec


def test_plaintext_engine_matches_golden(golden):
    templates, dists = golden
    right_ids = sorted({r["right"] for r in dists})
    dpat = np.stack([templates[i].pattern.data for i in right_ids])
    dmsk = np.stack([templates[i].mask.data for i in right_ids])
    eng = PlaintextEngine(dpat, dmsk, chunk=4)
    left_ids = sorted({r["left"] for r in dists})
    qpat = np.stack([templates[i].pattern.data for i in left_ids])
    qmsk = np.stack([templates[i].mask.data for i in left_ids])
    mat = eng.distances(qpat, qmsk)
    for rec in dists:
        qi = left_ids.index(rec["left"])
        di = right_ids.index(rec["right"])
        assert mat[qi, di] == _expect(rec["distance"]), rec


def test_encoded_path_matches_golden(golden):
    """Full MPC math per pair: 2-party share split, dot shares summed, f64 decode."""
    templates, dists = golden
    rng = np.random.default_rng(5)
    for rec in dists:
        q, e = templates[rec["left"]], templates[rec["right"]]
        shares = encode_template(e).share(2, rng)
        engines = [ShareEngine(s.data[None], chunk=128) for s in shares]
        masks_eng = MasksEngine(e.mask.data[None], chunk=128)
        dots = sum(
            eng.dots(q.pattern.data[None], q.mask.data[None]).astype(np.int64)
            for eng in engines
        ) & 0xFFFF
        dens = masks_eng.dots(q.mask.data[None])
        got = decode_distance(
            dots[0, 0].astype(np.uint16), dens[0, 0].astype(np.uint16)
        )
        assert got == _expect(rec["distance"]), rec
