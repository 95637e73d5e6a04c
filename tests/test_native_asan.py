"""AddressSanitizer + UBSan gate for the native C++ codec.

The reference gets memory safety from the Rust compiler (SURVEY.md §5); the
equivalent discipline for `native/iris_codec.cpp` is this gate: build the
instrumented library (`make -C mpc_iris_tpu/native asan`), LD_PRELOAD the
sanitizer runtimes into a fresh python, point the package at the
instrumented .so via ``MPC_IRIS_NATIVE_SO``, and drive

1. the full native test module (malformed / chunk-boundary-adversarial
   parser suite, codec round trips, ChaCha parity — tests/test_native.py),
2. the fixed-seed byte-mutation fuzz loop (scripts/native_fuzz.py).

Any heap overflow, UaF, or UB aborts the subprocess (ASAN_OPTIONS
abort_on_error + -fno-sanitize-recover) and fails the gate.

Excluded from the default run (pyproject addopts): select it with
    python -m pytest -m native_asan -q
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "mpc_iris_tpu", "native")
ASAN_SO = os.path.join(NATIVE_DIR, "build", "libiris_codec_asan.so")

pytestmark = pytest.mark.native_asan


def _runtime(name: str) -> str | None:
    out = subprocess.run(
        ["g++", f"-print-file-name={name}"], capture_output=True, text=True
    ).stdout.strip()
    return out if out and os.path.sep in out and os.path.exists(out) else None


@pytest.fixture(scope="module")
def asan_env():
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    build = subprocess.run(["make", "-C", NATIVE_DIR, "asan"],
                           capture_output=True, text=True)
    if build.returncode != 0 or not os.path.exists(ASAN_SO):
        pytest.skip(f"asan build unavailable: {build.stderr[-400:]}")
    libasan = _runtime("libasan.so")
    libubsan = _runtime("libubsan.so")
    if libasan is None:
        pytest.skip("libasan runtime not found")
    env = dict(os.environ)
    env.update(
        LD_PRELOAD=" ".join(p for p in (libasan, libubsan) if p),
        ASAN_OPTIONS="detect_leaks=0:abort_on_error=1:"
                     "verify_asan_link_order=0",
        UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1",
        MPC_IRIS_NATIVE_SO=ASAN_SO,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO,
    )
    return env


def _run_under_asan(argv, env, timeout=1200):
    proc = subprocess.run(argv, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    tail = (proc.stdout + proc.stderr)[-4000:]
    assert proc.returncode == 0, f"{argv} failed under ASan:\n{tail}"
    assert "ERROR: AddressSanitizer" not in tail, tail
    assert "runtime error:" not in tail, tail  # UBSan report marker
    return tail


def test_native_suite_under_asan(asan_env):
    """tests/test_native.py (incl. the malformed/chunk-adversarial parser
    cases) runs clean against the instrumented library."""
    tail = _run_under_asan(
        [sys.executable, "-m", "pytest", "tests/test_native.py", "-q",
         "-p", "no:cacheprovider"],
        asan_env,
    )
    assert " passed" in tail
    # prove the subprocess really loaded the instrumented .so
    probe = _run_under_asan(
        [sys.executable, "-c",
         "from mpc_iris_tpu import native; import mpc_iris_tpu.native as n;"
         "assert native.available(); print(n._SO)"],
        asan_env,
    )
    assert "libiris_codec_asan.so" in probe


def test_fuzz_loop_under_asan(asan_env):
    """Fixed-seed byte-mutation fuzz over TemplateParser.feed, instrumented."""
    tail = _run_under_asan(
        [sys.executable, "scripts/native_fuzz.py"], asan_env
    )
    assert "native fuzz OK" in tail
