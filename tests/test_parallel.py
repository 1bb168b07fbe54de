"""Multichip distribution tests on the 8-virtual-CPU-device mesh
(conftest.py forces jax_num_cpu_devices=8)."""

import jax
import numpy as np
import pytest

from cholesky_tpu import SparseCholesky
from cholesky_tpu.parallel.mesh import (
    TREE_AXIS, make_mesh, panel_sharding, rhs_sharding)
from cholesky_tpu.utils.laplacian import generate_problem


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


def test_sharding_policy(mesh):
    from cholesky_tpu.io.ordering import Ordering
    from cholesky_tpu.symbolic.plan import build_plan

    # wide levels shard over the tree axis; NARROW mid-tree levels shard
    # rows over per-front subgroups (dist_level layout)
    s3 = panel_sharding(mesh, 3)   # 8 slots on 8 devices
    assert s3.spec == jax.sharding.PartitionSpec(TREE_AXIS, None, None)
    s1 = panel_sharding(mesh, 1)   # 2 slots < 8 devices -> (fb, rg) rows
    assert s1.spec == jax.sharding.PartitionSpec("fb", "rg", None)
    assert len(s1.mesh.devices.reshape(-1)) == 8
    s5 = panel_sharding(mesh, 5)   # 32 slots, divisible
    assert s5.spec == jax.sharding.PartitionSpec(TREE_AXIS, None, None)
    assert rhs_sharding(mesh, 4).spec == jax.sharding.PartitionSpec(TREE_AXIS, None)


def test_distributed_factor_solve(mesh):
    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh)
    s.factorize()
    assert len(s.panels[4].sharding.device_set) == 8
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_distributed_matches_single_device(mesh):
    n, r, c, v, o, cl, b = generate_problem((17, 19), 4)
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl)
    sD = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh)
    x1 = s1.solve(b)
    xD = sD.solve(b)
    # distributed execution must be numerically identical work
    np.testing.assert_allclose(x1, xD, rtol=1e-12, atol=1e-12)


def test_narrow_level_distribution(mesh, monkeypatch):
    """Narrow mid-tree levels (1 < B < ndev) factor over per-front chip
    subgroups (parallel/dist_level) instead of replicating. Asserts engagement via a spy, output shardings that
    span the full mesh, numerical identity with the single-chip path,
    and the 1e-10 contract; CHOLESKY_TPU_DIST_MID=0 must disable."""
    from cholesky_tpu.parallel import dist_level

    calls = []
    orig = dist_level.factor_level_sharded

    def spy(fp, lvl, piv, U, m, update_dtype):
        calls.append(lvl)
        return orig(fp, lvl, piv, U, m, update_dtype)

    monkeypatch.setattr(dist_level, "factor_level_sharded", spy)
    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    sD = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh,
                                 dtype=np.float32)
    sD.factorize()
    assert sorted(set(calls)) == [1, 2]       # B=2, B=4 < ndev=8
    for lvl in (1, 2):
        assert len(sD.panels[lvl].sharding.device_set) == 8
    xD = sD.solve(b)
    assert sD.residual(b, xD) <= 1e-10
    # identical operations -> identical factor values vs single chip
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s1.factorize()
    for lvl in (1, 2):
        np.testing.assert_allclose(np.asarray(sD.panels[lvl]),
                                   np.asarray(s1.panels[lvl]),
                                   rtol=1e-6, atol=1e-6)
    # env kill switch
    calls.clear()
    monkeypatch.setenv("CHOLESKY_TPU_DIST_MID", "0")
    from cholesky_tpu.numeric import frontal as _fr

    _fr._LEVEL_JIT_CACHE.clear()
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh,
                                 dtype=np.float32)
    s2.factorize()
    assert calls == []


def test_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_graft_entry_compiles():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert all(np.isfinite(np.asarray(o)).all() for o in out)


def test_family_shards_over_mesh(mesh):
    """factorize_many with a mesh: SYSTEM axis shards K/ndev per chip,
    results identical to single-device; K not divisible falls back to
    replicated but still solves."""
    from cholesky_tpu.utils.laplacian import generate_problem as gen

    n, r, c, v, o, cl, b = gen((12, 12), 3)
    rng = np.random.default_rng(11)
    k = 8
    vals = (1.0 + rng.uniform(0, 2, size=k))[:, None] * v[None, :]
    vals[:, r == c] += rng.uniform(0, 1, size=(k, int((r == c).sum())))

    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl)
    sD = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh)
    bf1 = s1.factorize_many(vals)
    bfD = sD.factorize_many(vals)
    # the system axis really is sharded over all 8 devices
    assert len(bfD.factors[0].sharding.device_set) == 8
    B = rng.standard_normal((k, n))
    x1 = bf1.solve(B)
    xD = bfD.solve(B)
    np.testing.assert_allclose(x1, xD, rtol=1e-12, atol=1e-12)
    assert np.all(bfD.residual(B, xD) <= 1e-10)

    # K=5 doesn't divide 8 devices: the family PADS to 8 with copies of
    # the last system and still shards (each chip owns one), rather than
    # replicating all 5 on every chip
    bf5 = sD.factorize_many(vals[:5])
    assert bf5.pad == 3
    assert bf5.factors[0].shape[0] == 8
    assert len(bf5.factors[0].sharding.device_set) == 8
    x5 = bf5.solve(B[:5])
    assert np.all(bf5.residual(B[:5], x5) <= 1e-10)
    assert bf5.logdet().shape == (5,)


def test_mesh_fp32_production_solve(mesh):
    """The flagship production configuration under the mesh: fp32 factor,
    slot-sharded panels, device-resident double-float iterative refinement,
    gated at the framework's 1e-10 residual contract."""
    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                mesh=mesh)
    s.factorize()
    assert len(s.panels[4].sharding.device_set) == 8
    x = s.solve(b, tol=1e-10)
    assert s.residual(b, x) <= 1e-10


def test_mesh_fp32_streamed_factorization(mesh):
    """mesh x streamed: the level-streamed donating programs consume
    slot-sharded fronts; fp32 + IR still meets the 1e-10 contract."""
    import os

    os.environ["CHOLESKY_TPU_STREAM"] = "1"
    try:
        n, r, c, v, o, cl, b = generate_problem((22, 26), 5)
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    mesh=mesh)
        s.factorize()
        assert len(s.panels[4].sharding.device_set) == 8
        x = s.solve(b, tol=1e-10)
        assert s.residual(b, x) <= 1e-10
    finally:
        del os.environ["CHOLESKY_TPU_STREAM"]


def _env(**kv):
    """Context manager setting env knobs and restoring them."""
    import contextlib
    import os

    @contextlib.contextmanager
    def ctx():
        old = {k: os.environ.get(k) for k in kv}
        os.environ.update({k: str(v) for k, v in kv.items()})
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return ctx()


def test_mesh_bf16_store(mesh):
    """mesh x bf16 factor store: the streamed path stores each level's
    factor bfloat16 under slot sharding; fp32 pivot inverses + IR recover
    the 1e-10 contract. This is the capacity regime that halves per-chip
    factor residency ON TOP of the 1/ndev slot sharding."""
    with _env(CHOLESKY_TPU_STREAM="1", CHOLESKY_TPU_STORE_DTYPE="bfloat16"):
        n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    mesh=mesh)
        s.factorize()
        import jax.numpy as jnp

        assert s.panels[4].dtype == jnp.bfloat16
        assert len(s.panels[4].sharding.device_set) == 8
        x = s.solve(b, tol=1e-10)
        assert s.residual(b, x) <= 1e-10


def test_mesh_chunked_levels(mesh):
    """mesh x batch-chunked level programs: a level too big for one
    transition runs as nc donating chunk programs over block slices, each
    slice still slot-sharded over the mesh. Forced via
    CHOLESKY_TPU_LEVEL_CHUNKS on a small problem; matches the unchunked
    mesh result exactly."""
    n, r, c, v, o, cl, b = generate_problem((26, 22), 6)   # leaf level: 32 blocks
    with _env(CHOLESKY_TPU_STREAM="1", CHOLESKY_TPU_LEVEL_CHUNKS="5:2,4:2"):
        sC = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                     mesh=mesh)
        sC.factorize()
        xC = sC.solve(b, tol=1e-10)
        assert sC.residual(b, xC) <= 1e-10
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(sC.panels[0]), np.asarray(s1.factorize()[0]),
        rtol=1e-5, atol=1e-5)


def test_mesh_offload(mesh):
    """mesh x host offload: each completed level's stored factor moves to
    host during factorization, then re-uploads WITH its slot sharding
    restored (a bare device_put would collapse onto one chip). Residual
    contract holds through the round trip."""
    import jax as _jax

    with _env(CHOLESKY_TPU_STREAM="1", CHOLESKY_TPU_OFFLOAD="1"):
        n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    mesh=mesh)
        s.factorize()
        # re-uploaded wide level regained the 8-device slot sharding
        assert isinstance(s.panels[4], _jax.Array)
        assert len(s.panels[4].sharding.device_set) == 8
        x = s.solve(b, tol=1e-10)
        assert s.residual(b, x) <= 1e-10


def test_mesh_capacity_composition(mesh):
    """All capacity regimes at once under the mesh: streamed + chunked +
    bf16 store + offload — the full big-problem configuration on 8 devices,
    still meeting 1e-10."""
    with _env(CHOLESKY_TPU_STREAM="1", CHOLESKY_TPU_LEVEL_CHUNKS="5:2",
              CHOLESKY_TPU_STORE_DTYPE="bfloat16", CHOLESKY_TPU_OFFLOAD="1"):
        n, r, c, v, o, cl, b = generate_problem((26, 22), 6)
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                    mesh=mesh)
        s.factorize()
        x = s.solve(b, tol=1e-10)
        assert s.residual(b, x) <= 1e-10


def test_mesh_quasi_definite(mesh):
    """LDLᵀ under the mesh: the signed factor/solve programs are pure jit
    over slot-sharded fronts, so GSPMD distributes them like the SPD path.
    f64 direct to 1e-10; identical to the single-chip factor."""
    n, r, c, v, o, cl, b = generate_problem((16, 16), 4)
    rng = np.random.default_rng(3)
    s = np.where(rng.random(n) < 0.4, -1.0, 1.0)
    # make it quasi-definite with this signature: flip diagonal signs and
    # add dominance margin
    diag = r == c
    vq = v.copy()
    vq[diag] = s[r[diag]] * (np.abs(v[diag]) + 1.0)

    s1 = SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=s)
    sD = SparseCholesky.from_coo(n, r, c, vq, o, cl, signs=s, mesh=mesh)
    sD.factorize()
    assert len(sD.panels[3].sharding.device_set) == 8
    xD = sD.solve(b)
    assert sD.residual(b, xD) <= 1e-10
    np.testing.assert_allclose(xD, s1.solve(b), rtol=1e-12, atol=1e-12)
    # slogdet agrees across the two placements
    (sg1, ld1), (sgD, ldD) = s1.slogdet(), sD.slogdet()
    assert sg1 == sgD
    np.testing.assert_allclose(ld1, ldD, rtol=1e-12)


def test_mesh_per_chip_memory_scaling(mesh):
    """AOT memory_analysis (per-device under SPMD): the widest level's
    donating program holds ~1/8 the bytes per chip when its operands are
    slot-sharded over the 8-device mesh — the Realm memory-capacity-scaling
    property (SURVEY §5) demonstrated on virtual devices. Threshold 0.2
    leaves headroom over the exact 0.125 for replicated edges."""
    import sys

    sys.path.insert(0, "/root/repo/tools")
    import memcheck_mesh as mm
    from cholesky_tpu.numeric import frontal
    from cholesky_tpu.symbolic.plan import build_plan

    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    plan = build_plan(o, cl)
    fp = frontal.build_frontal_plan(plan, r, c)
    lvl = fp.levels - 1                       # 16 blocks on 8 devices
    one = mm.analyze(fp, lvl, None, 8 << 30)
    eight = mm.analyze(fp, lvl, mesh, 8 << 30)
    peak1 = one["args"] + one["temp"] + max(0, one["out"] - one["alias"])
    peak8 = (eight["args"] + eight["temp"]
             + max(0, eight["out"] - eight["alias"]))
    assert peak8 <= 0.2 * peak1, (peak8, peak1)


def test_mesh_family_fp32_refined(mesh):
    """mesh x factorize_many x fp32: the system-sharded family refines to
    the 1e-10 contract (family refinement loops until every member meets
    tol)."""
    n, r, c, v, o, cl, b = generate_problem((14, 14), 3)
    rng = np.random.default_rng(5)
    k = 8
    vals = (1.0 + rng.uniform(0, 2, size=k))[:, None] * v[None, :]
    vals[:, r == c] += rng.uniform(0, 1, size=(k, int((r == c).sum())))
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                mesh=mesh)
    bf = s.factorize_many(vals)
    assert len(bf.factors[0].sharding.device_set) == 8
    B = rng.standard_normal((k, n))
    X = bf.solve(B, tol=1e-10)
    assert np.all(bf.residual(B, X) <= 1e-10)


# ---- four devices: the four-card target (1-D mesh over 4 devices)

@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(4)


def test_sharding_policy_4dev(mesh4):
    """On 4 devices levels with >= 4 slots shard the slot axis; the B=2
    level shards rows over 2-device subgroups; slot blocks are contiguous
    per device."""
    P = jax.sharding.PartitionSpec
    assert panel_sharding(mesh4, 2).spec == P(TREE_AXIS, None, None)
    assert panel_sharding(mesh4, 5).spec == P(TREE_AXIS, None, None)
    s1 = panel_sharding(mesh4, 1)
    assert s1.spec == P("fb", "rg", None)
    assert s1.mesh.devices.shape == (2, 2)
    assert panel_sharding(mesh4, 0).spec == P(None, None, None)
    assert rhs_sharding(mesh4, 4).spec == P(TREE_AXIS, None)
    arr = jax.device_put(np.zeros((8, 4, 4)), panel_sharding(mesh4, 3))
    order = list(mesh4.devices.flat)
    for d, idx in arr.sharding.devices_indices_map((8, 4, 4)).items():
        assert (idx[0].start or 0) // 2 == order.index(d)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_on_4dev(mesh4, dtype):
    """Full factorize+solve on the 4-device mesh: the leaf level shards
    over all 4 devices, the 1e-10 contract holds (f64 direct, f32 through
    iterative refinement), and f64 matches the single-device path."""
    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype, mesh=mesh4)
    s.factorize()
    assert len(s.panels[4].sharding.device_set) == 4
    x = s.solve(b, tol=1e-10)
    assert s.residual(b, x) <= 1e-10
    if dtype == np.float64:
        s1 = SparseCholesky.from_coo(n, r, c, v, o, cl)
        np.testing.assert_allclose(x, s1.solve(b), rtol=1e-12, atol=1e-12)


def test_family_on_4dev(mesh4):
    """factorize_many shards the SYSTEM axis over the 4 devices."""
    n, r, c, v, o, cl, b = generate_problem((12, 12), 3)
    rng = np.random.default_rng(7)
    k = 8
    vals = (1.0 + rng.uniform(0, 2, size=k))[:, None] * v[None, :]
    vals[:, r == c] += rng.uniform(0, 1, size=(k, int((r == c).sum())))
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh4)
    bf = s.factorize_many(vals)
    assert len(bf.factors[0].sharding.device_set) == 4
    B = rng.standard_normal((k, n))
    X = bf.solve(B)
    assert np.all(bf.residual(B, X) <= 1e-10)
