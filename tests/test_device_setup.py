"""Where the program puts its compile cache, how much device memory the share
engines take, and what the GPU smoke test does without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mpc_iris_tpu.models import engines
from mpc_iris_tpu.utils import config

REPO = Path(__file__).resolve().parents[1]


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert config.compile_cache_dir() == str(tmp_path / "c")


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.compile_cache_dir()
    assert path == config.DEFAULT_CACHE_DIR == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text()


def test_compile_cache_can_be_disabled(monkeypatch):
    monkeypatch.setenv("MPC_IRIS_NO_COMPILE_CACHE", "1")
    assert config.enable_compile_cache() is None


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_default_budget_from_bytes_limit(monkeypatch):
    """Free pool (bytes_limit less bytes_in_use) less the fixed workspace."""
    monkeypatch.delenv("MPC_IRIS_HBM_BUDGET", raising=False)
    gib = 1 << 30
    dev = _Dev({"bytes_limit": 60 * gib, "bytes_in_use": 10 * gib})
    assert engines.default_hbm_budget(dev) == 50 * gib - engines.FIXED_WORKSPACE
    full = _Dev({"bytes_limit": gib, "bytes_in_use": gib})
    assert engines.default_hbm_budget(full) == 0


def test_default_budget_env_and_no_pool(monkeypatch):
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", "12345")
    assert engines.default_hbm_budget(_Dev({"bytes_limit": 1})) == 12345
    monkeypatch.delenv("MPC_IRIS_HBM_BUDGET")
    # a backend without a device pool (the CPU) keeps everything resident
    assert engines.default_hbm_budget(_Dev(None)) >= 1 << 60


def test_share_engine_budget_follows_device_stats(monkeypatch, rng):
    """The resident head shrinks to what the stubbed device pool holds."""
    import numpy as np

    monkeypatch.delenv("MPC_IRIS_HBM_BUDGET", raising=False)
    chunk, plane = 128, 2 * 12800 * 128
    limit = engines.FIXED_WORKSPACE + engines.scan_workspace(8, chunk) + 3 * plane
    monkeypatch.setattr(engines, "default_hbm_budget",
                        lambda device=None: limit - engines.FIXED_WORKSPACE)
    share = rng.integers(0, 1 << 16, size=(8 * chunk, 12800), dtype=np.uint16)
    eng = engines.ShareEngine(share, chunk=chunk, batch_hint=8)
    assert eng.resident_entries == 3 * chunk


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert not _has_result(r.stdout)
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert not _has_result(r.stdout)


def test_chip_smoke_cpu_rehearsal():
    """Every phase of chip_smoke.py at a small size on the CPU: the CLI
    subprocesses, the uniqueness checks against the NumPy reference, the
    audit and the in-process MPC round. No device result is printed."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cpu-rehearsal",
         "--entries", "8192", "--big-batch", "16"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "all phases passed" in r.stdout
    assert "MPC winners (one-shot and persistent wires) == plaintext" in r.stdout
    assert not _has_result(r.stdout)
