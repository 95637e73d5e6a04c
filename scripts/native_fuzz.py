"""Fixed-seed byte-mutation fuzz of the native template-JSON parser.

Part of the memory-safety gate for the C++ codec (`pytest -m native_asan` —
the discipline the Rust reference gets from its compiler for free,
SURVEY.md §5): builds a seed corpus of well-formed
reference-format template JSON (src/main.rs:294-309 layout via the repo's
own renderer), then drives ``TemplateParser.feed`` over thousands of
mutated variants — byte flips, truncations, duplications, splices — in
randomized chunk sizes. Every outcome must be a clean parse or a Python
``ValueError``; anything else (ASan report, abort, segfault) fails the
process. Deterministic: seed fixed, so a failure reproduces.

Run standalone (plain or ASan-preloaded):
    PYTHONPATH=/root/repo JAX_PLATFORMS=cpu python scripts/native_fuzz.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 0xF022
N_CASES = 2000


def build_corpus(rng) -> list:
    from mpc_iris_tpu import native

    pats = rng.integers(0, 256, (3, 1600), dtype=np.uint8)
    msks = rng.integers(0, 256, (3, 1600), dtype=np.uint8)
    valid = native.render_templates(pats, msks)
    one = native.render_templates(pats[:1], msks[:1])
    return [
        valid,
        one,
        b"[]",
        b"[\n]",
        valid[:-2] + b",",          # trailing comma, no close
        b" \t\n" + valid,            # leading whitespace
        valid.replace(b'"pattern"', b'"mask"', 1),  # duplicate key name
        one[: len(one) // 2],        # mid-template truncation
    ]


def mutate(rng, base: bytes) -> bytes:
    raw = bytearray(base)
    op = rng.integers(0, 5)
    if op == 0 and raw:              # flip random bytes
        for _ in range(int(rng.integers(1, 8))):
            raw[int(rng.integers(0, len(raw)))] = int(rng.integers(0, 256))
    elif op == 1 and raw:            # truncate
        raw = raw[: int(rng.integers(0, len(raw)))]
    elif op == 2:                    # duplicate a slice
        if raw:
            a = int(rng.integers(0, len(raw)))
            b = int(rng.integers(a, min(len(raw), a + 64)))
            raw = raw[:b] + raw[a:b] + raw[b:]
    elif op == 3:                    # splice two corpus members
        raw = raw[: int(rng.integers(0, len(raw) + 1))] + bytes(
            reversed(raw[: int(rng.integers(0, min(len(raw), 128)))]))
    else:                            # insert structural noise
        noise = rng.choice([b"[", b"]", b"{", b"}", b'"', b",", b"\\", b"\0"])
        pos = int(rng.integers(0, len(raw) + 1))
        raw = raw[:pos] + bytes(noise) + raw[pos:]
    return bytes(raw)


def drive(parser_cls, rng, data: bytes) -> str:
    """Feed `data` in random chunk sizes; classify the outcome."""
    parser = parser_cls(max_batch=7)
    pos = 0
    try:
        while pos < len(data):
            step = int(rng.integers(1, 4097))
            chunk = data[pos:pos + step]
            pos += step
            for _ in parser.feed(chunk, final=pos >= len(data)):
                pass
        return "parsed" if parser.finished else "incomplete"
    except ValueError:
        return "rejected"


def main() -> int:
    from mpc_iris_tpu import native

    if not native.available():
        print("native library unavailable — nothing to fuzz", file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    corpus = build_corpus(rng)
    outcomes = {"parsed": 0, "rejected": 0, "incomplete": 0}

    # the whole corpus must survive un-mutated first
    for base in corpus:
        outcomes[drive(native.TemplateParser, rng, base)] += 1

    for i in range(N_CASES):
        base = corpus[int(rng.integers(0, len(corpus)))]
        data = mutate(rng, base)
        outcomes[drive(native.TemplateParser, rng, data)] += 1
        if i and i % 500 == 0:
            print(f"  {i}/{N_CASES} cases: {outcomes}", file=sys.stderr)

    assert outcomes["parsed"] > 0, "corpus never parsed — fuzz is vacuous"
    assert outcomes["rejected"] > 0, "no case rejected — mutator is vacuous"
    print(f"native fuzz OK: {N_CASES + len(corpus)} cases, {outcomes}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
