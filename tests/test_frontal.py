"""Multifrontal engine tests: boundary structure, extend-add maps, engine
equivalence with the panel engine, and end-to-end correctness."""

import numpy as np
import pytest
import scipy.linalg

from cholesky_tpu import SparseCholesky
from cholesky_tpu.io import mmio
from cholesky_tpu.numeric import frontal
from cholesky_tpu.symbolic.plan import permute_matrix_dense
from cholesky_tpu.utils import capacity
from cholesky_tpu.utils.laplacian import generate_problem
from tests.conftest import fixture_paths


def test_boundary_structure_9x9():
    p = fixture_paths("lapl_9x9")
    s = SparseCholesky.from_files(p["mat"], p["separators"], p["clusters"])
    fp = s.fplan
    # leaf seps 1,2 couple to the root separator (sep 3, rows 6..8)
    fr_leaf = fp.front_rows[1]     # level 1 = leaves for levels=2
    assert fp.levels == 2
    for sl in range(2):
        bnd = fr_leaf[sl][fp.W[1]:]
        real = bnd[bnd < s.plan.n]
        assert set(real).issubset(set(range(6, 9)))
    # root has no boundary
    assert fp.F[0] == fp.W[0]


def test_same_shape_different_ordering_no_cache_collision():
    """Two plans can share every bucket shape (levels, W, F, n) while
    differing in structure — here the geometric ND of a 5x5 grid and the
    same separators with each one's dofs listed in reverse. The
    level-program trace caches key on FrontalPlan.key(); before the
    structural fingerprint was added, the second plan silently reused the
    first's compiled programs (constants baked at trace time) and factored
    WRONG. Both must be exact."""
    from cholesky_tpu.io.ordering import Ordering

    n, r, c, v, o, cl, b = generate_problem((5, 5), 3)
    s_gen = SparseCholesky.from_coo(n, r, c, v, o, cl)
    s_gen.factorize()

    o_rev = Ordering(o.levels, o.num_separators,
                     {k: d[::-1].copy() for k, d in o.dofs.items()})
    s_rev = SparseCholesky.from_coo(n, r, c, v, o_rev, cl)
    fg, fr = s_gen.fplan, s_rev.fplan
    assert (fg.levels, fg.W, fg.F) == (fr.levels, fr.W, fr.F)
    assert any(not np.array_equal(a_, b_)
               for a_, b_ in zip(fg.front_rows, fr.front_rows))
    assert fr.key() != fg.key()
    import scipy.sparse

    off = r != c
    a = scipy.sparse.coo_matrix(
        (np.concatenate([v, v[off]]),
         (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
        shape=(n, n)).toarray()
    for s in (s_gen, s_rev):
        lref = np.linalg.cholesky(a[np.ix_(s.plan.perm, s.plan.perm)])
        np.testing.assert_allclose(s.factor_dense(), lref,
                                   rtol=1e-12, atol=1e-12)


def test_front_sizes_beat_panels():
    """Fronts must be no larger than the dense ancestor-path panels, and
    strictly smaller on 3-D problems (the entire point of the engine)."""
    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    fsz = sum((1 << l) * fp.F[l] * fp.W[l] for l in range(fp.levels))
    psz = sum((1 << l) * int(s.plan.H[l]) * int(s.plan.S[l])
              for l in range(fp.levels))
    assert fsz < 0.7 * psz


def test_extend_add_maps_cover_children():
    n, r, c, v, o, cl, b = generate_problem((21, 17), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    for lvl in range(1, fp.levels):
        inv = fp.inv_child[lvl]
        bndK = fp.F[lvl] - fp.W[lvl]
        assert inv.shape == (1 << lvl, fp.F[lvl - 1])
        # each child's real boundary rows all appear exactly once
        for sl in range(1 << lvl):
            real = fp.front_rows[lvl][sl][fp.W[lvl]:]
            nreal = int((real < s.plan.n).sum())
            hits = inv[sl][inv[sl] < bndK]
            assert len(np.unique(hits)) == len(hits)
            assert len(hits) == nreal


@pytest.mark.parametrize("name", ["lapl_9x9", "lapl_25x25", "lapl_400x400"])
def test_frontal_factor_matches_scipy(name):
    p = fixture_paths(name)
    s = SparseCholesky.from_files(p["mat"], p["separators"], p["clusters"])
    s.factorize()
    a = mmio.read_dense(p["mat"])
    pmat = permute_matrix_dense(s.plan, a)
    lref = scipy.linalg.cholesky(pmat + np.tril(pmat, -1).T, lower=True)
    assert np.allclose(s.factor_dense(), lref, rtol=1e-9, atol=1e-9)


def test_frontal_matches_panels_oracle():
    """The production engine against the explicitly-named verification
    oracle (verify/oracle.py): same solution to f64 roundoff."""
    from cholesky_tpu.verify.oracle import PanelsOracle

    n, r, c, v, o, cl, b = generate_problem((14, 14, 14), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10
    oracle = PanelsOracle(s.plan, s.rows, s.cols, s.vals)
    x_o = oracle.solve(b)
    assert s.residual(b, x_o) <= 1e-10
    np.testing.assert_allclose(x, x_o, rtol=1e-9, atol=1e-9)


def test_frontal_fp32_ir():
    n, r, c, v, o, cl, b = generate_problem((20, 20, 10), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_frontal_distributed():
    from cholesky_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    n, r, c, v, o, cl, b = generate_problem((24, 24), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, mesh=mesh)
    s.factorize()
    assert len(s.panels[4].sharding.device_set) == 8
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_frontal_irregular_shapes():
    """Odd grid shapes produce ragged separator sizes and empty corners —
    the padding/sentinel machinery must absorb them."""
    for shape, levels in [((7, 5), 4), ((11, 3, 2), 4), ((30, 1), 3)]:
        n, r, c, v, o, cl, b = generate_problem(shape, levels)
        s = SparseCholesky.from_coo(n, r, c, v, o, cl)
        x = s.solve(b)
        assert s.residual(b, x) <= 1e-10, (shape, levels)


def test_multi_rhs():
    """Multiple right-hand sides solve in one batched call with refinement."""
    import scipy.sparse

    n, r, c, v, o, cl, b = generate_problem((18, 17), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    rng = np.random.default_rng(0)
    B = rng.normal(size=(n, 5))
    X = s.solve(B)
    assert X.shape == (n, 5)
    off = r != c
    A = scipy.sparse.coo_matrix(
        (np.concatenate([v, v[off]]),
         (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
        shape=(n, n)).toarray()
    assert np.linalg.norm(A @ X - B) / np.linalg.norm(B) <= 1e-10


def test_extadd_strategies_agree():
    """Every extend-add strategy produces the same factors (machine
    precision in f64) — scatter is the semantic reference; matmul, gather,
    gathermm and the fused/hybrid dispatchers must all match it."""
    import jax.numpy as jnp

    n, r, c, v, o, cl, _ = generate_problem((15, 15, 15), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    fronts = tuple(jnp.asarray(f) for f in frontal.assemble_fronts(
        fp, s.rows, s.cols, s.vals, dtype=np.float64))
    ref = frontal.frontal_factor(fp, fronts, extadd="scatter")
    for strat in ("matmul", "gather", "gathermm", "fused",
                  "hybrid", "hybrid2", "hybrid3"):
        out = frontal.frontal_factor(fp, fronts, extadd=strat)
        for a, b in zip(ref, out):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-11, atol=1e-11, err_msg=strat)


def test_tri_solve_chunked(monkeypatch):
    """Batch-chunked triangular solves (frontal._TRI_MAX_BATCH) match the
    unchunked path exactly."""
    monkeypatch.setattr(frontal, "_TRI_MAX_BATCH", 2)
    n, r, c, v, o, cl, b = generate_problem((13, 11), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_streamed_factor_matches_monolithic():
    """The level-streamed factorization (one donating program per level)
    produces the same factors as the monolithic program, for every extadd
    dispatch tier."""
    import jax.numpy as jnp

    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    fronts = frontal.assemble_fronts(fp, s.rows, s.cols, s.vals,
                                     dtype=np.float64)
    ref = frontal.frontal_factor(
        fp, tuple(jnp.asarray(f) for f in fronts))
    out = frontal.frontal_factor_streamed(
        fp, tuple(jnp.asarray(f) for f in fronts))
    for a_, b_ in zip(ref, out):
        np.testing.assert_allclose(np.asarray(a_), np.asarray(b_),
                                   rtol=1e-12, atol=1e-12)


def test_streamed_solve_end_to_end(monkeypatch):
    """CHOLESKY_TPU_STREAM=1 routes factor() through the streamed driver;
    the full solve still meets the residual contract."""
    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    n, r, c, v, o, cl, b = generate_problem((13, 12), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_two_piece_bf16_updates(monkeypatch):
    """Forced two-piece extend-add with bfloat16 update storage (the 1M-dof
    HBM configuration) still meets the residual contract through IR."""
    monkeypatch.setitem(capacity.FRACTIONS, "two_piece", 0)
    monkeypatch.setattr(frontal, "_CAST_CHUNK", 16)
    monkeypatch.setenv("CHOLESKY_TPU_UPDATE_DTYPE", "bfloat16")
    n, r, c, v, o, cl, b = generate_problem((14, 13), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_two_piece_gather_tier(monkeypatch):
    """Two-piece via the scatter-free gather tier (gathermm cap floored to
    its 256 MB minimum, so small tests route B2<4 transitions through
    _apply_gather_2) matches the plain factorization."""
    import jax.numpy as jnp

    monkeypatch.setitem(capacity.FRACTIONS, "two_piece", 0)
    monkeypatch.setitem(capacity.FRACTIONS, "gathermm_cap", 0)
    n, r, c, v, o, cl, b = generate_problem((15, 14), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    fronts = tuple(jnp.asarray(f) for f in frontal.assemble_fronts(
        fp, s.rows, s.cols, s.vals, dtype=np.float64))
    out = frontal.frontal_factor(fp, fronts)
    ref = frontal.frontal_factor(fp, fronts, extadd="scatter")
    for a_, b_ in zip(ref, out):
        np.testing.assert_allclose(np.asarray(a_), np.asarray(b_),
                                   rtol=1e-11, atol=1e-11)


import jax.numpy as jnp


def test_streamed_compressed_offload(monkeypatch):
    """Host-streamed front uploads with bfloat16-stored factors (the
    fallback when fronts must materialize on host, e.g. device assembly
    disabled): factor() auto-selects upload + compressed store when host
    fronts exceed the offload threshold, and the solve still meets the
    residual contract through iterative refinement."""
    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    monkeypatch.setenv("CHOLESKY_TPU_DEVICE_ASSEMBLE", "0")
    monkeypatch.setitem(capacity.FRACTIONS, "offload", 0)
    n, r, c, v, o, cl, b = generate_problem((16, 15), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    assert all(p.dtype == jnp.bfloat16 for p in s.panels)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_streamed_factor_offload(monkeypatch):
    """Per-level host offload of finished factors (the >12 GiB-of-fronts
    configuration): factor residency never accumulates in HBM during the
    run. With re-upload headroom the factor comes back device-resident;
    with none (ceiling forced to 0) the solve consumes host-resident
    factor levels — both must meet the residual contract."""
    import jax

    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    monkeypatch.setenv("CHOLESKY_TPU_OFFLOAD", "1")
    n, r, c, v, o, cl, b = generate_problem((16, 15), 4)

    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    assert all(isinstance(p, jax.Array) for p in s.panels)  # re-uploaded
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10

    monkeypatch.setitem(capacity.FRACTIONS, "f32_store", 0)  # bf16 store
    # the re-upload gate is capacity-aware (stored + solve headroom vs the
    # device's capacity); a headroom past the capacity models "no room"
    monkeypatch.setitem(capacity.FRACTIONS, "solve_headroom", 2.0)
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s2.factorize()
    assert all(isinstance(p, np.ndarray) for p in s2.panels[1:])
    assert all(p.dtype == jnp.bfloat16 for p in s2.panels)  # past ceiling
    x2 = s2.solve(b)
    assert s2.residual(b, x2) <= 1e-10


def test_chunked_levels_match_unchunked():
    """Batch-chunked level programs (the >2M-dof configuration where ONE
    level transition exceeds HBM) match the unchunked streamed run across
    mixed chunk maps — including entry-boundary slicing (unchunked child
    feeding a chunked parent), aligned piece handoff, and exit-boundary
    reconciliation (chunked child feeding an unchunked parent)."""
    n, r, c, v, o, cl, b = generate_problem((12, 12, 12), 6)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    asm = frontal.FrontAssembler(fp, s.rows, s.cols)
    fronts = tuple(asm(s.vals, dtype=np.float64))
    ref = frontal.frontal_factor_streamed(fp, fronts, donate=False,
                                          chunks={})
    for chunks in ({5: 2, 4: 2}, {5: 4, 4: 2, 3: 2}, {5: 8, 3: 4, 2: 2},
                   {4: 4}):
        lz = frontal.LazyFronts(asm, s.vals, dtype=np.float64)
        out = frontal.frontal_factor_streamed(fp, lz, donate=True,
                                              offload=True, chunks=chunks)
        for a_, b_ in zip(ref, out):
            np.testing.assert_allclose(np.asarray(a_), np.asarray(b_),
                                       rtol=1e-12, atol=1e-12)


def test_chunked_update_spill_matches(monkeypatch):
    """The offload-mode spill of big emitted child-update pieces to host
    (the 140^3 HBM fix: u_in + u_out at the level boundary were the OOM)
    must be numerically invisible — force the spill for every chunked
    level via a 1-byte threshold and compare against the unchunked run."""
    monkeypatch.setitem(capacity.FRACTIONS, "u_offload", 0)
    n, r, c, v, o, cl, b = generate_problem((12, 12, 12), 6)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    asm = frontal.FrontAssembler(fp, s.rows, s.cols)
    fronts = tuple(asm(s.vals, dtype=np.float64))
    ref = frontal.frontal_factor_streamed(fp, fronts, donate=False,
                                          chunks={})
    lz = frontal.LazyFronts(asm, s.vals, dtype=np.float64)
    out = frontal.frontal_factor_streamed(fp, lz, donate=True,
                                          offload=True,
                                          chunks={5: 4, 4: 2, 3: 2})
    for a_, b_ in zip(ref, out):
        np.testing.assert_allclose(np.asarray(a_), np.asarray(b_),
                                   rtol=1e-12, atol=1e-12)


def test_chunk_assembly_matches_slab_slice():
    """Per-chunk lazy assembly produces exactly the corresponding slice of
    the full level slab (incl. padded-diagonal ones)."""
    n, r, c, v, o, cl, b = generate_problem((14, 13), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    asm = frontal.FrontAssembler(fp, s.rows, s.cols)
    lz = frontal.LazyFronts(asm, s.vals, dtype=np.float32)
    for lvl in range(1, fp.levels):
        full = np.asarray(lz[lvl])
        B = 1 << lvl
        for nc in (2, B):
            cb = B // nc
            got = np.concatenate([np.asarray(lz.chunk(lvl, c * cb,
                                                      (c + 1) * cb))
                                  for c in range(nc)], axis=0)
            np.testing.assert_array_equal(full, got)


def test_chunk_count_decision():
    """_level_chunk_counts: a forced-small budget chunks the big mid
    levels, never the root, and halves the floor per doubling; the default
    budget leaves toy problems unchunked; the env override wins."""
    import os

    n, r, c, v, o, cl, b = generate_problem((12, 12, 12), 6)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    assert frontal._level_chunk_counts(fp, np.float32, None) == {}
    forced = frontal._level_chunk_counts(fp, np.float32, None,
                                         budget=1 << 20)
    assert forced and 0 not in forced
    assert all(nc >= 2 and (1 << lvl) % nc == 0
               for lvl, nc in forced.items())
    os.environ["CHOLESKY_TPU_LEVEL_CHUNKS"] = "4:2,3:2"
    try:
        assert frontal._level_chunk_counts(fp, np.float32, None) == {
            4: 2, 3: 2}
    finally:
        del os.environ["CHOLESKY_TPU_LEVEL_CHUNKS"]


def test_chunked_end_to_end_residual(monkeypatch):
    """Full solve through env-forced chunked streamed factorization (fp32
    factor + IR) meets the 1e-10 residual contract."""
    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    monkeypatch.setenv("CHOLESKY_TPU_LEVEL_CHUNKS", "3:2,2:2")
    n, r, c, v, o, cl, b = generate_problem((16, 15), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_streamed_upload_matches_monolithic():
    """upload=True (host arrays shipped level by level) with no storage
    cast produces bit-identical factors to the monolithic program."""
    n, r, c, v, o, cl, b = generate_problem((14, 14, 7), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    fronts = frontal.assemble_fronts(fp, s.rows, s.cols, s.vals,
                                     dtype=np.float64)
    import jax.numpy as jnp2

    ref = frontal.frontal_factor(fp, tuple(jnp2.asarray(f) for f in fronts))
    out = frontal.frontal_factor_streamed(
        fp, [f.copy() for f in fronts], upload=True)
    for a_, b_ in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a_), np.asarray(b_))


def test_streamed_top_fusion_matches_monolithic(monkeypatch):
    """Top-of-tree fusion: on deep trees the streamed driver
    runs the dispatch-bound narrow levels (B <= 8) as ONE jitted program.
    The fused path must engage (deep plan, default budget) and produce
    bit-identical factors to both the monolithic program and the unfused
    per-level streamed path."""
    n, r, c, v, o, cl, b = generate_problem((23, 21), 6)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fp = s.fplan
    start = frontal._top_fuse_start(fp, 8)
    assert start >= 1, "fusion must engage on a 6-level tree"
    assert start <= 3, "fusion must stay below the wide levels (B <= 8)"

    fronts = frontal.assemble_fronts(fp, s.rows, s.cols, s.vals,
                                     dtype=np.float64)
    ref = frontal.frontal_factor(fp, tuple(jnp.asarray(f) for f in fronts))
    fused = frontal.frontal_factor_streamed(
        fp, tuple(jnp.asarray(f) for f in fronts))
    monkeypatch.setattr(frontal, "_TOP_FUSE_BYTES", 0)
    unfused = frontal.frontal_factor_streamed(
        fp, tuple(jnp.asarray(f) for f in fronts))
    for a_, b_, c_ in zip(ref, fused, unfused):
        np.testing.assert_array_equal(np.asarray(a_), np.asarray(b_))
        np.testing.assert_array_equal(np.asarray(b_), np.asarray(c_))


def test_streamed_top_fusion_offload_store(monkeypatch):
    """Fused top levels compose with upload + bf16 factor store + host
    offload (the out-of-core configuration): factors above level 0 come
    back host-resident in the store dtype and the solve path's inputs are
    identical to the unfused streamed run."""
    n, r, c, v, o, cl, b = generate_problem((23, 21), 6)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    fp = s.fplan
    assert frontal._top_fuse_start(fp, 4) >= 1

    def make():
        return [f.copy() for f in frontal.assemble_fronts(
            fp, s.rows, s.cols, s.vals, dtype=np.float32)]

    fused = frontal.frontal_factor_streamed(
        fp, make(), upload=True, store_dtype=jnp.bfloat16, offload=True)
    monkeypatch.setattr(frontal, "_TOP_FUSE_BYTES", 0)
    unfused = frontal.frontal_factor_streamed(
        fp, make(), upload=True, store_dtype=jnp.bfloat16, offload=True)
    for lvl, (a_, b_) in enumerate(zip(fused, unfused)):
        assert a_.dtype == jnp.bfloat16 and b_.dtype == jnp.bfloat16
        if lvl > 0:
            assert isinstance(a_, np.ndarray), "offload: host-resident"
        np.testing.assert_array_equal(np.asarray(a_), np.asarray(b_))


def test_device_assembly_matches_host():
    """FrontAssembler (one compiled scatter per level, values-only upload)
    must produce bit-identical slabs to the host assemble_fronts pass, for
    single [nnz] and batched [K, nnz] values."""
    from cholesky_tpu.numeric.frontal import FrontAssembler, assemble_fronts

    n, r, c, v, o, cl, b = generate_problem((9, 8, 7), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fa = FrontAssembler(s.fplan, s.rows, s.cols)
    for dtype in (np.float32, np.float64):
        host = assemble_fronts(s.fplan, s.rows, s.cols, s.vals, dtype=dtype)
        dev = fa(s.vals, dtype=dtype)
        for h, d in zip(host, dev):
            np.testing.assert_array_equal(h, np.asarray(d))
    rng = np.random.default_rng(0)
    vk = rng.standard_normal((3, s.vals.shape[0]))
    host = assemble_fronts(s.fplan, s.rows, s.cols, vk, dtype=np.float64)
    dev = fa(vk, dtype=np.float64)
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, np.asarray(d))


def test_update_values_device_assembly_roundtrip():
    """update_values -> factorize via the device-assembly path solves to
    the gate, and matches a freshly built solver on the same values."""
    n, r, c, v, o, cl, b = generate_problem((11, 11), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    x0 = s.solve(b)
    v2 = 2.5 * v.copy()
    v2[r == c] += 1.0
    s.update_values(v2)
    assert s._device_assembly_ok()
    x2 = s.solve(b)
    fresh = SparseCholesky.from_coo(n, r, c, v2, o, cl)
    np.testing.assert_allclose(x2, fresh.solve(b), rtol=1e-12, atol=1e-12)
    assert s.residual(b, x2) <= 1e-10
    assert not np.allclose(x2, x0)


def test_lazy_fronts_match_eager():
    """LazyFronts (per-level device assembly inside the streamed
    factorization) must produce the same factors as eager assembly +
    the monolithic program."""
    n, r, c, v, o, cl, b = generate_problem((12, 12), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    fp = s.fplan
    asm = frontal.FrontAssembler(fp, s.rows, s.cols)
    eager = frontal.factor(fp, asm(s.vals, dtype=np.float64))
    lazy = frontal.LazyFronts(asm, s.vals, dtype=np.float64)
    # slabs assembled on demand are identical to the eager ones
    for lvl in range(fp.levels):
        np.testing.assert_array_equal(np.asarray(lazy[lvl]),
                                      np.asarray(asm(s.vals,
                                                     dtype=np.float64)[lvl]))
    streamed = frontal.frontal_factor_streamed(fp, lazy)
    for a, bb in zip(eager, streamed):
        np.testing.assert_allclose(np.asarray(a), np.asarray(bb),
                                   rtol=1e-13, atol=1e-13)


def test_big_slab_assembly_matches_flat(monkeypatch):
    """Levels whose slab reaches 2^31 elements scatter via (slot, rem)
    int32 pairs instead of a flat index (which jnp silently downcasts to
    int32 without x64 — OverflowError at trace time, garbage past it).
    Exercise the big path by lowering the limit so EVERY level routes
    through it; slabs and end-to-end factors must be identical."""
    n, r, c, v, o, cl, b = generate_problem((12, 12), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    fp = s.fplan
    asm = frontal.FrontAssembler(fp, s.rows, s.cols)
    flat_slabs = asm(s.vals, dtype=np.float64)
    lazy_flat = [np.asarray(frontal.LazyFronts(asm, s.vals,
                                               dtype=np.float64)[lvl])
                 for lvl in range(fp.levels)]
    monkeypatch.setattr(frontal, "_INT32_SCATTER_LIMIT", 1)
    asm2 = frontal.FrontAssembler(fp, s.rows, s.cols)
    big_slabs = asm2(s.vals, dtype=np.float64)
    lazy2 = frontal.LazyFronts(asm2, s.vals, dtype=np.float64)
    for lvl in range(fp.levels):
        np.testing.assert_array_equal(np.asarray(big_slabs[lvl]),
                                      np.asarray(flat_slabs[lvl]))
        np.testing.assert_array_equal(np.asarray(lazy2[lvl]),
                                      lazy_flat[lvl])
    # the batched [K, nnz] path (factorize_many) through the big branch
    # (compare before factoring: frontal.factor DONATES its input slabs)
    many = asm2(np.stack([s.vals, 2.0 * s.vals]), dtype=np.float64)
    twice = asm(2.0 * s.vals, dtype=np.float64)
    for lvl in range(fp.levels):
        np.testing.assert_array_equal(np.asarray(many[lvl][0]),
                                      np.asarray(flat_slabs[lvl]))
        np.testing.assert_array_equal(np.asarray(many[lvl][1]),
                                      np.asarray(twice[lvl]))
    streamed = frontal.frontal_factor_streamed(fp, lazy2)
    eager = frontal.factor(fp, flat_slabs)
    for a, bb in zip(eager, streamed):
        np.testing.assert_allclose(np.asarray(a), np.asarray(bb),
                                   rtol=1e-13, atol=1e-13)


def test_lazy_fronts_dispatch_through_factor():
    """frontal.factor() routes a LazyFronts through the streamed driver
    regardless of size, and the API solve built on it hits the residual
    contract."""
    n, r, c, v, o, cl, b = generate_problem((10, 10), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    fp = s.fplan
    lazy = frontal.LazyFronts(frontal.FrontAssembler(fp, s.rows, s.cols),
                              s.vals, dtype=np.float64)
    factors = frontal.factor(fp, lazy)
    s.panels = list(factors)
    s.factored = True
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10
