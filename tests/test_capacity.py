"""Device-capacity model (utils/capacity.py) and the compile-cache setup
(cholesky_tpu.setup_compilation_cache)."""

import os
import subprocess
import sys

import jax
import pytest

import cholesky_tpu
from cholesky_tpu.utils import capacity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 1 << 30


class _FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_thresholds_from_env_capacity(monkeypatch):
    """At the 15.75 GiB capacity the thresholds were first sized for, every
    derived threshold equals the byte constant it replaced; at 4x the
    capacity each is 4x."""
    monkeypatch.setenv("CHOLESKY_TPU_HBM_BYTES", str(int(15.75 * GIB)))
    assert capacity.device_bytes() == int(15.75 * GIB)
    sized = {"stream": 5 * GIB, "f32_store": 7 * GIB, "offload": 9 * GIB,
             "hbm_budget": int(14.5 * GIB), "gathermm_cap": 8 * GIB,
             "two_piece": 512 << 20, "u_offload": 2 * GIB,
             "update_bf16": 3 << 29, "solve_headroom": 3584 << 20,
             "bench_donate": 2 * GIB}
    assert set(sized) == set(capacity.FRACTIONS)
    for name, want in sized.items():
        assert abs(capacity.threshold(name) - want) <= 1, name
    monkeypatch.setenv("CHOLESKY_TPU_HBM_BYTES", str(63 * GIB))
    for name, want in sized.items():
        assert abs(capacity.threshold(name) - 4 * want) <= 4, name


def test_capacity_from_bytes_limit(monkeypatch):
    """Without the env override the capacity is the device's reported
    bytes_limit, and the thresholds follow it."""
    monkeypatch.delenv("CHOLESKY_TPU_HBM_BYTES", raising=False)
    limit = 60 * 10 ** 9
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice({"bytes_limit": limit})])
    assert capacity.device_bytes() == limit
    assert capacity.threshold("stream") == int(
        capacity.FRACTIONS["stream"] * limit)
    assert capacity.threshold("stream") > 5 * GIB


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_capacity_raises_without_stats(monkeypatch, stats):
    """An accelerator that reports no bytes_limit is an error, not a
    guess."""
    monkeypatch.delenv("CHOLESKY_TPU_HBM_BYTES", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(stats)])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        capacity.device_bytes()


def test_capacity_cpu_fallback(monkeypatch):
    monkeypatch.delenv("CHOLESKY_TPU_HBM_BYTES", raising=False)
    assert jax.devices()[0].platform == "cpu"
    assert capacity.device_bytes() == capacity.CPU_FALLBACK_BYTES


def test_compilation_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache lands there: a fresh
    process compiles one program and its entry appears in that
    directory."""
    cache = tmp_path / "cc"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache))
    code = ("import cholesky_tpu, jax, jax.numpy as jnp; "
            "cholesky_tpu.force_cpu(); d = cholesky_tpu.setup_compilation_"
            "cache(); jax.config.update('jax_persistent_cache_min_compile_"
            "time_secs', 0); jax.jit(lambda x: jnp.sin(x) * 3.25)"
            "(jnp.ones(7)).block_until_ready(); print(d)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_compilation_cache_default_in_checkout(monkeypatch):
    """Without the variable the cache is the fixed <checkout>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        d = cholesky_tpu.setup_compilation_cache()
        assert d == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
