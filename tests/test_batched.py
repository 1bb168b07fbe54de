"""Batched same-pattern factorization: K matrices through one vmapped
program (SparseCholesky.factorize_many). The batched form of the
reference's --iterations refill/refactor loop (mmat.rg:1212-1224) — instead
of re-running a task graph per matrix, the family rides a batch axis.
"""

import numpy as np
import pytest
import scipy.linalg

from cholesky_tpu import SparseCholesky
from cholesky_tpu.utils.laplacian import generate_problem


def _family(shape=(8, 8), levels=3, k=4, dtype=np.float64):
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
    rng = np.random.default_rng(7)
    # scale + diagonal shift per system: all SPD, same pattern
    scales = 1.0 + rng.uniform(0, 2, size=k)
    shifts = rng.uniform(0, 1, size=k)
    vals = scales[:, None] * v[None, :]
    vals[:, r == c] += shifts[:, None]
    return s, vals, b


def _dense_k(s, vals_k):
    a = np.zeros((s.plan.n, s.plan.n))
    a[s.rows, s.cols] = vals_k
    a[s.cols, s.rows] = vals_k
    return a


def test_batched_solve_matches_dense():
    s, vals, b = _family()
    bf = s.factorize_many(vals)
    rng = np.random.default_rng(3)
    B = rng.standard_normal((bf.k, s.plan.n))
    X = bf.solve(B)
    for i in range(bf.k):
        x_ref = np.linalg.solve(_dense_k(s, vals[i]), B[i])
        np.testing.assert_allclose(X[i], x_ref, rtol=1e-9, atol=1e-11)
    assert np.all(bf.residual(B, X) <= 1e-10)


def test_batched_shared_rhs_and_logdet():
    s, vals, b = _family((7, 7, 7), 4, k=3)
    bf = s.factorize_many(vals)
    X = bf.solve(b)                      # one rhs shared across the family
    assert X.shape == (3, s.plan.n)
    assert np.all(bf.residual(b, X) <= 1e-10)
    ld = bf.logdet()
    for i in range(3):
        sign, ref = np.linalg.slogdet(_dense_k(s, vals[i]))
        assert sign > 0
        np.testing.assert_allclose(ld[i], ref, rtol=1e-10)


def test_batched_f32_refinement():
    s, vals, b = _family((8, 8, 8), 4, k=3, dtype=np.float32)
    bf = s.factorize_many(vals)
    X = bf.solve(b)
    assert np.all(bf.residual(b, X) <= 1e-10)


def test_batched_matches_sequential():
    """Each batched factor solves identically (to tolerance) to a fresh
    single-matrix solver over the same values."""
    s, vals, b = _family(k=3)
    bf = s.factorize_many(vals)
    X = bf.solve(b)
    for i in range(3):
        s.update_values(vals[i])
        np.testing.assert_allclose(X[i], s.solve(b), rtol=1e-9, atol=1e-11)


def test_batched_leaves_solver_state_alone():
    s, vals, b = _family()
    s.factorize()
    x0 = s.solve(b)
    _ = s.factorize_many(vals)
    np.testing.assert_allclose(s.solve(b), x0)


def test_batched_validates_shape():
    s, vals, b = _family()
    with pytest.raises(ValueError):
        s.factorize_many(vals[:, :-1])
    with pytest.raises(ValueError):
        s.factorize_many(vals[0])
