"""Double-float (f32-pair) compensated arithmetic and the device-resident
refinement loop built on it (numeric/refine.py)."""

import numpy as np
import pytest
import scipy.sparse

from cholesky_tpu import SparseCholesky
from cholesky_tpu.numeric import refine
from cholesky_tpu.utils.laplacian import generate_problem


def test_two_sum_exact():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(4096).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(4096).astype(np.float32) * 1e-3)
    s, e = refine._two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64), exact)


def test_two_prod_exact():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(4096).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(4096).astype(np.float32))
    p, e = refine._two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(e, np.float64), exact)


def test_df_matvec_near_f64():
    """The double-float ELL matvec matches the f64 sparse matvec to ~1e-13
    relative — the property the refinement loop's convergence rests on."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    n, nnz = 700, 6000
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    A = scipy.sparse.coo_matrix((v, (r, c)), shape=(n, n)).tocsr().tocoo()
    idx, ah, al = refine.build_ell(n, A.row.astype(np.int64),
                                   A.col.astype(np.int64), A.data)
    x64 = rng.standard_normal(n)
    xh, xl = refine.split_f64(x64)
    yh, yl = refine.df_matvec(
        jnp.asarray(idx), jnp.asarray(ah), jnp.asarray(al),
        jnp.concatenate([jnp.asarray(xh), jnp.zeros(1, jnp.float32)]),
        jnp.concatenate([jnp.asarray(xl), jnp.zeros(1, jnp.float32)]))
    y = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    yref = A.tocsr() @ x64
    scale = np.max(np.abs(yref))
    assert np.max(np.abs(y - yref)) / scale < 1e-13


def test_df_matvec_multi_near_f64():
    """The multi-RHS double-float matvec (the block refinement loop's
    residual) matches the f64 CSR matvec column by column to 1e-13, on the
    symmetrized grid Laplacian it runs on in the solver."""
    import jax.numpy as jnp

    from cholesky_tpu.io import mmio
    from cholesky_tpu.utils.laplacian import grid_laplacian

    n, r, c, v = grid_laplacian((9, 8, 7))
    r, c, v = mmio.symmetrize_coo(r, c, v)
    A = scipy.sparse.csr_matrix((v, (r, c)), shape=(n, n))
    idx, ah, al = refine.build_ell(n, r, c, v)
    X = np.random.default_rng(3).standard_normal((n, 5))
    xh, xl = refine.split_f64(X)
    z = np.zeros((1, 5), np.float32)
    yh, yl = refine.df_matvec_multi(
        jnp.asarray(idx), jnp.asarray(ah), jnp.asarray(al),
        jnp.asarray(np.concatenate([xh, z])),
        jnp.asarray(np.concatenate([xl, z])))
    Y = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    Yref = A @ X
    err = np.max(np.abs(Y - Yref), axis=0) / np.max(np.abs(Yref), axis=0)
    assert np.all(err < 1e-13), err


def test_build_ell_row_overflow_returns_none():
    n = refine.ELL_MAX_K + 10
    rows = np.zeros(n, dtype=np.int64)        # one dense row
    cols = np.arange(n, dtype=np.int64)
    vals = np.ones(n)
    assert refine.build_ell(n, rows, cols, vals) is None


def test_device_ir_df_end_to_end():
    """fp32 factor + double-float device refinement reaches the 1e-10 gate
    and agrees with the host refinement loop."""
    n, r, c, v, o, cl, b = generate_problem((16, 16, 8), 5)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    x = s.solve(b)                            # default: df device IR
    assert s.residual(b, x) <= 1e-10

    import os

    os.environ["CHOLESKY_TPU_DEVICE_IR"] = "0"
    try:
        x2 = s.solve(b)
    finally:
        del os.environ["CHOLESKY_TPU_DEVICE_IR"]
    np.testing.assert_allclose(x, x2, rtol=1e-8, atol=1e-10)


def test_device_ir_df_multilevel_sizes():
    for shape, levels in [((9, 9), 3), ((13, 11, 7), 5)]:
        n, r, c, v, o, cl, b = generate_problem(shape, levels)
        s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
        x = s.solve(b)
        assert s.residual(b, x) <= 1e-10, (shape, levels)


def test_device_ir_df_multi_rhs():
    """Multi-RHS device-resident refinement: a [n, k] block of f32+IR solves
    converges every column to the residual contract in ONE while_loop (the
    api routes 2-D b here instead of the per-iteration host CSR loop)."""
    import scipy.sparse as sp

    n, r, c, v, o, cl, _ = generate_problem((13, 11), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((n, 5))
    B[:, 2] = 0.0                       # zero column must not divide by 0
    X = s.solve(B)
    assert X.shape == (n, 5)
    off = r != c
    a = sp.coo_matrix(
        (np.concatenate([v, v[off]]),
         (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
        shape=(n, n)).tocsr()
    for j in range(5):
        bn = np.linalg.norm(B[:, j])
        rj = np.linalg.norm(a @ X[:, j] - B[:, j])
        assert rj <= 1e-10 * max(bn, 1.0), (j, rj)

    # direct call: reported max relative residual is honest
    bp = B[s.plan.perm, :].astype(np.float64)
    ell = s._ell_perm()
    Xp, iters, rn = refine.solve_refined_df_multi(
        s.fplan, s.panels, bp, ell, tol=1e-12, max_iter=40)
    assert iters >= 1 and rn <= 1e-11


def test_zero_column_rhs_block():
    """A [n, 0] RHS block returns [n, 0] instead of crashing the
    device-refinement branch (review finding: jnp.max over an empty
    per-column residual vector)."""
    n, r, c, v, o, cl, _ = generate_problem((9, 9), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    X = s.solve(np.zeros((n, 0)))
    assert X.shape == (n, 0)


def test_rhs_and_ell_device_caches():
    """The device-side rhs/ELL caches must be correct, not just fast: a
    repeat solve against the same rhs reuses the staged device planes
    (identical result), a DIFFERENT rhs misses the content-keyed cache
    and still solves to contract, and mutating the rhs content (same
    array object) is detected by the digest."""
    from cholesky_tpu.numeric import refine as rf

    n, r, c, v, o, cl, b = generate_problem((12, 12), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    s.factorize()
    rf._BS_CACHE.clear()
    x1 = s.solve(b, tol=1e-10)
    n_bs = len(rf._BS_CACHE)
    x2 = s.solve(b, tol=1e-10)
    assert len(rf._BS_CACHE) == n_bs          # hit, no new entry
    np.testing.assert_array_equal(x1, x2)
    assert s.residual(b, x1) <= 1e-10
    b3 = b + 1.0                              # different content -> miss
    x3 = s.solve(b3, tol=1e-10)
    assert len(rf._BS_CACHE) == n_bs + 1
    assert s.residual(b3, x3) <= 1e-10
    b4 = b.copy()
    x4a = s.solve(b4, tol=1e-10)
    b4[0] += 2.5                              # in-place mutation
    x4b = s.solve(b4, tol=1e-10)
    assert s.residual(b4, x4b) <= 1e-10
    assert not np.allclose(x4a, x4b)
