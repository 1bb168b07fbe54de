"""Collective (multi-chip) root-front factorization tests on the 8-device
CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import random

from cholesky_tpu.parallel.dist_cholesky import (
    _grid_for, _pick_scheme, collective_cholesky, distributed_cholesky,
    distributed_cholesky_2d)
from cholesky_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


@pytest.mark.parametrize("F", [512, 1000, 2048])
def test_distributed_cholesky_matches_numpy(F, mesh):
    k = random.PRNGKey(0)
    a = random.normal(k, (F, F), jnp.float64)
    spd = a @ a.T + F * jnp.eye(F, dtype=jnp.float64)
    L = distributed_cholesky(spd, mesh, block=128)
    Lref = np.linalg.cholesky(np.asarray(spd))
    np.testing.assert_allclose(np.asarray(L), Lref, rtol=1e-10, atol=1e-8)
    # strict upper triangle is zero
    assert np.allclose(np.triu(np.asarray(L), 1), 0.0)


def test_distributed_cholesky_large_scale(mesh):
    """Root-front scale: F=8192 — a 100^3-problem-class root
    front — verified against LAPACK on the 8-device mesh, including the
    block-cyclic gather/permutation machinery at many steps (32 panel
    rounds, 4 local blocks per chip)."""
    k = random.PRNGKey(3)
    F = 8192
    g = random.normal(k, (F, F), jnp.float64) / np.sqrt(F)
    spd = g @ g.T + 4.0 * jnp.eye(F, dtype=jnp.float64)
    L = distributed_cholesky(spd, mesh, block=256)
    Lref = np.linalg.cholesky(np.asarray(spd))
    np.testing.assert_allclose(np.asarray(L), Lref, rtol=1e-9, atol=1e-9)


def test_distributed_cholesky_nondivisible_padding(mesh):
    """Fp % (ndev*block) != 0 at scale: F=4243 pads to 4608 with unit
    pivots; the result must match LAPACK on the original extent."""
    k = random.PRNGKey(4)
    F = 4243
    g = random.normal(k, (F, F), jnp.float64) / np.sqrt(F)
    spd = g @ g.T + 4.0 * jnp.eye(F, dtype=jnp.float64)
    L = distributed_cholesky(spd, mesh, block=192)
    Lref = np.linalg.cholesky(np.asarray(spd))
    np.testing.assert_allclose(np.asarray(L), Lref, rtol=1e-9, atol=1e-9)
    assert np.allclose(np.triu(np.asarray(L), 1), 0.0)


def test_distributed_cholesky_bf16_input(mesh):
    """A bf16 slab (bf16-stored factors feeding a distributed root) computes
    in f32 and returns bf16 with f32-level relative accuracy against the
    same-values f32 factorization."""
    k = random.PRNGKey(5)
    F = 512
    g = np.asarray(random.normal(k, (F, F), jnp.float32)) / np.sqrt(F)
    spd64 = g.astype(np.float64)
    spd64 = spd64 @ spd64.T + 4.0 * np.eye(F)
    spd_bf = jnp.asarray(spd64).astype(jnp.bfloat16)
    L = distributed_cholesky(spd_bf, mesh, block=128)
    assert L.dtype == jnp.bfloat16
    Lref = np.linalg.cholesky(np.asarray(spd_bf, np.float64))
    np.testing.assert_allclose(np.asarray(L, np.float64), Lref,
                               rtol=2e-2, atol=2e-2)


def test_distributed_cholesky_inside_jit(mesh):
    k = random.PRNGKey(1)
    F = 640
    a = random.normal(k, (F, F), jnp.float64)
    spd = a @ a.T + F * jnp.eye(F, dtype=jnp.float64)

    @jax.jit
    def f(x):
        return jnp.sum(distributed_cholesky(x, mesh, block=128))

    v = float(f(spd))
    assert np.isfinite(v)


def test_collective_root_in_solver(mesh, monkeypatch):
    """Full distributed solve with the collective root front forced on.
    A spy asserts distributed_cholesky really runs — the env knob used to be
    consulted only at dispatch while the level program re-checked the module
    constant, so this test previously passed WITHOUT the collective root."""
    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.parallel import dist_cholesky as dc
    from cholesky_tpu.utils.laplacian import generate_problem

    calls = []
    real = dc.distributed_cholesky

    def spy(a, m, block=256):
        calls.append(a.shape)
        return real(a, m, block)

    monkeypatch.setattr(dc, "distributed_cholesky", spy)
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_DIST_MIN", "16")
    n, r, c, v, o, cl, b = generate_problem((20, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10
    assert calls, "collective root front was not engaged"
    # same answer as the single-device, non-collective path
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl)
    np.testing.assert_allclose(x, s2.solve(b), rtol=1e-9, atol=1e-9)

    # and the fp32 production path through the collective root,
    # refined to the 1e-10 contract
    calls.clear()
    s32 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                  mesh=mesh)
    x32 = s32.solve(b, tol=1e-10)
    assert s32.residual(b, x32) <= 1e-10
    assert calls, "collective root front was not engaged (fp32)"


@pytest.mark.parametrize("F,blk", [(512, 64), (1000, 64), (2048, 128)])
def test_distributed_cholesky_2d_matches_numpy(F, blk, mesh):
    """2-D block-cyclic scheme (4x2 grid on 8 devices) vs LAPACK,
    including non-divisible F (1000 pads to the lcm grid extent)."""
    k = random.PRNGKey(7)
    a = random.normal(k, (F, F), jnp.float64)
    spd = a @ a.T + F * jnp.eye(F, dtype=jnp.float64)
    L = distributed_cholesky_2d(spd, mesh, block=blk)
    Lref = np.linalg.cholesky(np.asarray(spd))
    np.testing.assert_allclose(np.asarray(L), Lref, rtol=1e-10, atol=1e-8)
    assert np.allclose(np.triu(np.asarray(L), 1), 0.0)


def test_distributed_cholesky_2d_large_scale(mesh):
    """F=4096 at block=128 through the 2-D grid — 32 panel rounds, 16
    local column blocks per chip at 4x2, and exactly the F >= 4*ndev*block
    threshold the router sends to the 2-D scheme (F=8192/block=256 passes
    identically but costs 8x the suite time)."""
    k = random.PRNGKey(8)
    F = 4096
    g = random.normal(k, (F, F), jnp.float64) / np.sqrt(F)
    spd = g @ g.T + 4.0 * jnp.eye(F, dtype=jnp.float64)
    L = distributed_cholesky_2d(spd, mesh, block=128)
    Lref = np.linalg.cholesky(np.asarray(spd))
    np.testing.assert_allclose(np.asarray(L), Lref, rtol=1e-9, atol=1e-9)


def test_distributed_cholesky_2d_bf16(mesh):
    k = random.PRNGKey(9)
    F = 512
    g = np.asarray(random.normal(k, (F, F), jnp.float32)) / np.sqrt(F)
    spd64 = g.astype(np.float64)
    spd64 = spd64 @ spd64.T + 4.0 * np.eye(F)
    L = distributed_cholesky_2d(jnp.asarray(spd64).astype(jnp.bfloat16),
                                mesh, block=128)
    assert L.dtype == jnp.bfloat16
    Lref = np.linalg.cholesky(np.asarray(spd64))
    np.testing.assert_allclose(np.asarray(L, np.float64), Lref,
                               rtol=2e-2, atol=2e-2)


def test_root_scheme_routing(mesh, monkeypatch):
    """collective_cholesky picks 1-D for short/latency-bound fronts and
    2-D once the wire-volume model wins (1/pr + 1/pc < 1 and F >= 4·ndev·
    block); env override forces either."""
    assert _grid_for(8) == (4, 2)
    assert _grid_for(16) == (4, 4)
    assert _grid_for(7) == (7, 1)
    assert _pick_scheme(1024, 8, 256) == "1d"      # short panel
    assert _pick_scheme(8192, 8, 256) == "2d"
    assert _pick_scheme(65536, 7, 256) == "1d"     # prime mesh: no grid
    assert _pick_scheme(8192, 4, 256) == "1d"      # 2x2: 1/2+1/2 == 1
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_SCHEME", "2d")
    assert _pick_scheme(64, 8, 256) == "2d"
    # routed result matches LAPACK either way
    k = random.PRNGKey(10)
    F = 768
    a = random.normal(k, (F, F), jnp.float64)
    spd = a @ a.T + F * jnp.eye(F, dtype=jnp.float64)
    L = collective_cholesky(spd, mesh, block=128)
    np.testing.assert_allclose(np.asarray(L),
                               np.linalg.cholesky(np.asarray(spd)),
                               rtol=1e-10, atol=1e-8)


def test_collective_root_2d_in_solver(mesh, monkeypatch):
    """End-to-end mesh solve with the 2-D root front forced on: a spy
    asserts the 2-D kernel really ran inside the level program."""
    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.parallel import dist_cholesky as dc
    from cholesky_tpu.utils.laplacian import generate_problem

    calls = []
    real = dc.distributed_cholesky_2d

    def spy(a, m, block=256):
        calls.append(a.shape)
        return real(a, m, block)

    monkeypatch.setattr(dc, "distributed_cholesky_2d", spy)
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_DIST_MIN", "16")
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_SCHEME", "2d")
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_BLOCK", "16")
    n, r, c, v, o, cl, b = generate_problem((20, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10
    assert calls, "2-D collective root front was not engaged"
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl)
    np.testing.assert_allclose(x, s2.solve(b), rtol=1e-9, atol=1e-9)


def test_selinv_on_mesh(mesh):
    """Selected inversion over slot-sharded factors: the recursion is
    batched over the slot axis, so GSPMD partitions it with the same
    subtree sharding as the factorization — no selinv-specific collective
    code."""
    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem((8, 8, 8), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64,
                                mesh=mesh)
    d = s.inv_diag()
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    np.testing.assert_allclose(d, s2.inv_diag(), rtol=1e-11)
    vals = s.inv_entries(r[:50], c[:50])
    np.testing.assert_allclose(vals, s2.inv_entries(r[:50], c[:50]),
                               rtol=1e-11)


# ---- four devices: the four-card target (1-D mesh, 2x2 grid for 2-D)

@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(4)


@pytest.mark.parametrize("scheme,F,blk", [("1d", 512, 64), ("1d", 1000, 64),
                                          ("2d", 512, 64), ("2d", 1000, 64)])
def test_root_front_on_4dev(scheme, F, blk, mesh4):
    """Both root-front schemes on 4 devices (2-D on the 2x2 grid) match
    LAPACK, including a non-divisible F."""
    k = random.PRNGKey(11)
    g = random.normal(k, (F, F), jnp.float64) / np.sqrt(F)
    spd = g @ g.T + 4.0 * jnp.eye(F, dtype=jnp.float64)
    fn = distributed_cholesky_2d if scheme == "2d" else distributed_cholesky
    L = fn(spd, mesh4, block=blk)
    Lref = np.linalg.cholesky(np.asarray(spd))
    np.testing.assert_allclose(np.asarray(L), Lref, rtol=1e-10, atol=1e-9)
    assert np.allclose(np.triu(np.asarray(L), 1), 0.0)


def test_root_scheme_routing_4dev(mesh4, monkeypatch):
    """On 4 devices the 2x2 grid ties with 1-D in wire volume, so the router
    keeps 1-D at every F; the env override still forces 2-D, and the
    routed result matches LAPACK."""
    monkeypatch.delenv("CHOLESKY_TPU_ROOT_SCHEME", raising=False)
    assert _grid_for(4) == (2, 2)
    for F in (1024, 6400, 65536):
        assert _pick_scheme(F, 4, 256) == "1d"
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_SCHEME", "2d")
    assert _pick_scheme(1024, 4, 256) == "2d"
    k = random.PRNGKey(12)
    F = 512
    g = random.normal(k, (F, F), jnp.float64) / np.sqrt(F)
    spd = g @ g.T + 4.0 * jnp.eye(F, dtype=jnp.float64)
    L = collective_cholesky(spd, mesh4, block=64)
    np.testing.assert_allclose(np.asarray(L),
                               np.linalg.cholesky(np.asarray(spd)),
                               rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("scheme", ["1d", "2d"])
def test_collective_root_in_solver_4dev(scheme, mesh4, monkeypatch):
    """End-to-end solve on 4 devices with the collective root front forced
    on under each scheme: a spy asserts the routed kernel ran, and the
    answer matches the single-device path."""
    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.parallel import dist_cholesky as dc
    from cholesky_tpu.utils.laplacian import generate_problem

    name = "distributed_cholesky_2d" if scheme == "2d" \
        else "distributed_cholesky"
    calls = []
    real = getattr(dc, name)

    def spy(a, m, block=256):
        calls.append(m.devices.size)
        return real(a, m, block)

    monkeypatch.setattr(dc, name, spy)
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_DIST_MIN", "16")
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_SCHEME", scheme)
    monkeypatch.setenv("CHOLESKY_TPU_ROOT_BLOCK", "16")
    n, r, c, v, o, cl, b = generate_problem((20, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh4)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10
    assert calls and calls[0] == 4, calls
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl)
    np.testing.assert_allclose(x, s2.solve(b), rtol=1e-9, atol=1e-9)
