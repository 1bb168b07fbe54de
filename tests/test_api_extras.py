"""API extras beyond the reference: factor checkpoint/resume, logdet,
condest, SPD failure diagnosis.

The reference has no resumable state (SURVEY §5: its -m/-o outputs are
MatrixMarket dumps) — this is a production capability on top: factor once,
serve solves from any process.
"""

import numpy as np
import pytest

from cholesky_tpu import SparseCholesky
from cholesky_tpu.utils.laplacian import generate_problem


def _build():
    return generate_problem((7, 7, 7), 4)


def test_save_load_round_trip(tmp_path):
    n, r, c, v, o, cl, b = _build()
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s1.factorize()
    x_ref = s1.solve(b)
    path = s1.save_factor(str(tmp_path / "factor"))

    # fresh solver from the same inputs: loads the factor, never factorizes
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s2.load_factor(path)
    assert s2.factored
    x2 = s2.solve(b)
    assert s2.residual(b, x2) <= 1e-10
    np.testing.assert_allclose(x2, x_ref, rtol=1e-8, atol=1e-10)


def test_load_rejects_mismatched_matrix(tmp_path):
    n, r, c, v, o, cl, b = _build()
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    path = s1.save_factor(str(tmp_path / "factor"))

    v2 = v.copy()
    v2[0] *= 2.0
    s2 = SparseCholesky.from_coo(n, r, c, v2, o, cl, dtype=np.float32)
    with pytest.raises(ValueError, match="does not match"):
        s2.load_factor(path)


def test_load_rejects_mismatched_padding(tmp_path):
    """Same matrix/ordering but a different pad_to gives different panel
    shapes — the fingerprint must cover the panel layout, not just perm."""
    n, r, c, v, o, cl, b = _build()
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 pad_to=8)
    path = s1.save_factor(str(tmp_path / "factor"))
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 pad_to=16)
    if s2.plan.S.tolist() == s1.plan.S.tolist() and \
            s2.plan.H.tolist() == s1.plan.H.tolist():
        pytest.skip("pad_to 8 vs 16 produced identical buckets here")
    with pytest.raises(ValueError, match="does not match"):
        s2.load_factor(path)


def test_load_rejects_mismatched_dtype(tmp_path):
    n, r, c, v, o, cl, b = _build()
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    path = s1.save_factor(str(tmp_path / "factor"))
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    with pytest.raises(ValueError, match="does not match"):
        s2.load_factor(path)


def test_save_load_f64(tmp_path):
    n, r, c, v, o, cl, b = _build()
    s1 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    path = s1.save_factor(str(tmp_path / "factor"))
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    s2.load_factor(path)
    x = s2.solve(b)
    assert s2.residual(b, x) <= 1e-10


def test_logdet_matches_scipy():
    import scipy.sparse

    n, r, c, v, o, cl, b = _build()
    for dtype in (np.float64, np.float32):
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
        s.factorize()
        off = r != c
        a = scipy.sparse.coo_matrix(
            (np.concatenate([v, v[off]]),
             (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
            shape=(n, n)).toarray()
        sign, ref = np.linalg.slogdet(a)
        assert sign > 0
        rtol = 1e-10 if dtype == np.float64 else 1e-4
        assert abs(s.logdet() - ref) <= rtol * abs(ref)


def test_condest_matches_numpy():
    import scipy.sparse

    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    off = r != c
    a = scipy.sparse.coo_matrix(
        (np.concatenate([v, v[off]]),
         (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
        shape=(n, n)).toarray()
    ref = np.linalg.cond(a, 2)
    est = s.condest(iters=30)
    # power iteration underestimates; expect within a small factor
    assert 0.5 * ref <= est <= 1.02 * ref


def test_factorize_check_rejects_indefinite():
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    s.factorize(check=True)          # SPD: passes

    v2 = v.copy()
    diag = r == c
    v2[diag] = -v2[diag]             # flip all diagonal signs: indefinite
    s2 = SparseCholesky.from_coo(n, r, c, v2, o, cl, dtype=np.float64)
    with pytest.raises(ArithmeticError, match="not positive definite"):
        s2.factorize(check=True)


def test_update_values_refactorizes():
    """Same sparsity, new coefficients: the solver refactors in place and
    every value-derived cache (CSR, ELL planes, pivot inverses) follows."""
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    x1 = s.solve(b)
    assert s.residual(b, x1) <= 1e-10

    s.update_values(3.0 * s.vals)    # A -> 3A, exact expected x/3
    assert not s.factored
    x2 = s.solve(b)
    assert s.residual(b, x2) <= 1e-10          # residual vs the NEW matrix
    np.testing.assert_allclose(x2, x1 / 3.0, rtol=1e-9, atol=1e-12)


def test_update_values_accepts_any_coo_layout():
    """rows/cols form: upper-triangle entries and a permuted entry order of
    the same pattern are normalized and matched against the plan."""
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    x1 = s.solve(b)

    shuffle = np.random.default_rng(0).permutation(len(r))
    # transpose the coordinates: upper triangle, shuffled order, same pattern
    s.update_values(2.0 * v[shuffle], rows=c[shuffle], cols=r[shuffle])
    x2 = s.solve(b)
    assert s.residual(b, x2) <= 1e-10
    np.testing.assert_allclose(x2, x1 / 2.0, rtol=1e-9, atol=1e-12)


def test_update_values_rejects_new_pattern():
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    with pytest.raises(ValueError, match="aligned with"):
        s.update_values(np.ones(len(s.vals) + 1))
    with pytest.raises(ValueError, match="pattern differs"):
        s.update_values(v[1:], rows=r[1:], cols=c[1:])
    with pytest.raises(ValueError, match="both rows and cols"):
        s.update_values(v, rows=r)


def test_update_values_refreshes_refinement_path():
    """fp32 + iterative refinement: the refinement loop's matvec and pivot
    inverses must see the new values, or convergence silently targets the
    stale matrix."""
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    x1 = s.solve(b)
    assert s.residual(b, x1) <= 1e-10

    rng = np.random.default_rng(1)
    v2 = v.copy()
    diag = r == c
    v2[diag] *= rng.uniform(1.5, 2.5, diag.sum())   # SPD-safe: boost diagonal
    s.update_values(v2)
    x2 = s.solve(b)
    assert s.residual(b, x2) <= 1e-10
    assert not np.allclose(x2, x1)


def test_solve_updated_woodbury():
    """Low-rank-updated solves reuse the factor: (A + U diag(w) U^T)x = b
    against a dense reference, including a down-date and multi-RHS."""
    import scipy.sparse

    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    off = r != c
    a = scipy.sparse.coo_matrix(
        (np.concatenate([v, v[off]]),
         (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
        shape=(n, n)).toarray()
    rng = np.random.default_rng(2)
    u = rng.standard_normal((n, 3))
    w = np.array([2.0, 0.5, -1e-3])          # includes a mild down-date
    m = a + u @ np.diag(w) @ u.T
    assert np.all(np.linalg.eigvalsh(m) > 0)  # still SPD

    x = s.solve_updated(b, u, w)
    np.testing.assert_allclose(x, np.linalg.solve(m, b), rtol=1e-9,
                               atol=1e-11)

    # rank-1 vector form, default weight
    u1 = rng.standard_normal(n)
    x1 = s.solve_updated(b, u1)
    np.testing.assert_allclose(
        x1, np.linalg.solve(a + np.outer(u1, u1), b), rtol=1e-9, atol=1e-11)

    # multi-RHS
    bs = rng.standard_normal((n, 2))
    xs = s.solve_updated(bs, u, w)
    np.testing.assert_allclose(xs, np.linalg.solve(m, bs), rtol=1e-9,
                               atol=1e-11)

    with pytest.raises(ValueError, match="nonzero"):
        s.solve_updated(b, u, [1.0, 0.0, 1.0])


def test_logdet_updated():
    """Matrix determinant lemma against dense slogdet, including a
    down-date and an indefinite rejection."""
    import scipy.sparse

    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    off = r != c
    a = scipy.sparse.coo_matrix(
        (np.concatenate([v, v[off]]),
         (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
        shape=(n, n)).toarray()
    rng = np.random.default_rng(4)
    u = rng.standard_normal((n, 2))
    w = np.array([1.5, -1e-3])
    ref = np.linalg.slogdet(a + u @ np.diag(w) @ u.T)[1]
    got = s.logdet_updated(u, w)
    assert abs(got - ref) <= 1e-9 * abs(ref)

    # a down-date strong enough to break positive definiteness must raise
    u1 = u[:, :1] / np.linalg.norm(u[:, 0])   # unit vector
    lam_max = float(np.linalg.eigvalsh(a).max())
    with pytest.raises(ArithmeticError, match="not positive definite"):
        s.logdet_updated(u1, -2.0 * lam_max)


def test_precision_knob():
    """Matmul-precision override: accepted at construction and per
    factorize(), rejected when unknown, and the raised-precision factor
    solves to the same contract. (On CPU all precisions are f32 matmuls —
    this tests the plumbing; chip_smoke.py measures the effect on the
    card.)"""
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                precision="highest")
    assert s.precision == "highest"
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10

    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s2.factorize(precision="high")      # sticky override
    assert s2.precision == "high"
    x2 = s2.solve(b)
    assert s2.residual(b, x2) <= 1e-10

    with pytest.raises(ValueError, match="precision"):
        SparseCholesky.from_coo(n, r, c, v, o, cl, precision="f16")


def test_precision_auto_ladder(monkeypatch):
    """Unset precision resolves from plan statistics: small
    fp32 problems are solve-dominated and pick the 6-pass 'highest' factor;
    past the executed-FLOP threshold (or for f64) the one-pass default wins.
    The resolution pins once factored — solves must apply the factor at the
    precision it was built with."""
    from cholesky_tpu import api

    n, r, c, v, o, cl, b = _build()

    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    assert s.precision == "highest"          # tiny problem: auto ladder up
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10

    # explicit 'default' forces the one-pass factor (escape hatch)
    sd = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                 precision="default")
    assert sd.precision is None

    # f64 needs no ladder
    s64 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    assert s64.precision is None

    # past the threshold the one-pass factor wins (simulate a big problem)
    monkeypatch.setattr(api, "_AUTO_HIGHEST_FLOPS", 0.0)
    sb = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    assert sb.precision is None

    # the resolution pins at factorization: flipping the threshold after
    # factoring must not change what solves apply
    monkeypatch.setattr(api, "_AUTO_HIGHEST_FLOPS", 1e12)
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s2.factorize()
    monkeypatch.setattr(api, "_AUTO_HIGHEST_FLOPS", 0.0)
    assert s2.precision == "highest"
    x2 = s2.solve(b)
    assert s2.residual(b, x2) <= 1e-10

    # the env knob is read at use time, like every sibling knob
    monkeypatch.setattr(api, "_AUTO_HIGHEST_FLOPS", 1e12)
    monkeypatch.setenv("CHOLESKY_TPU_AUTO_HIGHEST_FLOPS", "0")
    se = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    assert se.precision is None


def test_save_load_preserves_precision(tmp_path, monkeypatch):
    """A loaded factor must be APPLIED at the matmul precision it was built
    with — the AUTO ladder must not re-resolve in the loading process (whose
    env threshold may differ). The checkpoint meta carries the precision."""
    from cholesky_tpu import api

    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    assert s.precision == "highest"
    p = s.save_factor(str(tmp_path / "ck"))

    # loader process simulated with the opposite AUTO decision
    monkeypatch.setenv("CHOLESKY_TPU_AUTO_HIGHEST_FLOPS", "0")
    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s2.load_factor(p)
    assert s2.precision == "highest"
    x = s2.solve(b)
    assert s2.residual(b, x) <= 1e-10


def test_inv_pivots_gate_capacity_aware(monkeypatch):
    """The streamed-regime branch of _want_inv_pivots must be CAPACITY
    gated, not unconditionally True: at 140^3 the stored bf16 factor
    (11.9 GiB) plus 6.7 GiB of f32 inverses exceeded the 16 GiB chip and
    the solve died with RESOURCE_EXHAUSTED. Model both sides of the gate
    by pinning the device capacity."""
    from cholesky_tpu.utils import capacity

    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    # force the streamed-regime branch regardless of problem size
    monkeypatch.setitem(capacity.FRACTIONS, "stream", 0)

    monkeypatch.setenv("CHOLESKY_TPU_HBM_BYTES", str(64 << 30))
    assert s._want_inv_pivots()          # plenty of room: inverses pay off

    monkeypatch.setenv("CHOLESKY_TPU_HBM_BYTES", "1")
    assert not s._want_inv_pivots()      # factor + inverses cannot co-host

    # explicit override still wins in both directions
    monkeypatch.setenv("CHOLESKY_TPU_INV_PIVOTS", "1")
    assert s._want_inv_pivots()
    monkeypatch.setenv("CHOLESKY_TPU_INV_PIVOTS", "0")
    assert not s._want_inv_pivots()


def test_solve_chunked_casts_match(monkeypatch):
    """The chunk-local f32 casts in _tri_solve / frontal_solve's x_apply
    (bf16 out-of-core factors, batch > _TRI_MAX_BATCH) are arithmetically
    identical to the whole-level promotion they replaced: force 1-wide
    chunks on a small bf16-stored problem and hold the residual contract
    through the plain (no-inverses) solve path."""
    from cholesky_tpu.numeric import frontal
    from cholesky_tpu.utils import capacity

    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    monkeypatch.setitem(capacity.FRACTIONS, "f32_store", 0)   # bf16 store
    monkeypatch.setenv("CHOLESKY_TPU_INV_PIVOTS", "0")    # plain path
    monkeypatch.setattr(frontal, "_TRI_MAX_BATCH", 1)     # chunk everything
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    assert all(p.dtype == "bfloat16" for p in s.panels)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_save_load_bf16_factor(tmp_path, monkeypatch):
    """bf16 (out-of-core) factors checkpoint as uint16 BIT patterns (v2
    storage: no widened f32 intermediate on disk or at load) and solve to
    the contract after a round trip through a fresh solver."""
    from cholesky_tpu.utils import capacity

    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    monkeypatch.setitem(capacity.FRACTIONS, "f32_store", 0)   # force bf16 store
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    assert all(str(p.dtype) == "bfloat16" for p in s.panels)
    p = s.save_factor(str(tmp_path / "ck140"))

    s2 = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s2.load_factor(p)
    assert all(str(q.dtype) == "bfloat16" for q in s2.panels)
    for a, q in zip(s.panels, s2.panels):
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(q, np.float32))
    x = s2.solve(b)
    assert s2.residual(b, x) <= 1e-10


def test_device_ir_routing_bf16_capacity(monkeypatch):
    """With raw bf16 panels and no inverses, the device-IR while loop's
    hoisted f32 promotions hold ~2x the stored factor live across the
    loop (the 140^3 21.94 GB OOM); when 3x stored cannot fit, the solve
    must route to the host-driven loop — and still meet the contract."""
    from cholesky_tpu.utils import capacity

    monkeypatch.setenv("CHOLESKY_TPU_STREAM", "1")
    monkeypatch.setitem(capacity.FRACTIONS, "f32_store", 0)   # bf16 store
    monkeypatch.setenv("CHOLESKY_TPU_INV_PIVOTS", "0")    # plain inner
    n, r, c, v, o, cl, b = _build()
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    assert all(str(p.dtype) == "bfloat16" for p in s.panels)
    assert s._device_ir_fits()          # tiny factor: while-loop is fine

    called = {"n": 0}
    import cholesky_tpu.numeric.refine as refine
    orig = refine.solve_refined_df

    def spy(*a, **k):
        called["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(refine, "solve_refined_df", spy)
    monkeypatch.setenv("CHOLESKY_TPU_HBM_BYTES", str(1 << 20))
    assert not s._device_ir_fits()
    x = s.solve(b, tol=1e-10)           # host-driven loop
    assert called["n"] == 0
    assert s.residual(b, x) <= 1e-10
