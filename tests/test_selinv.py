"""Selected inversion (diag(A^{-1})): the top-down batched recursion of
numeric/selinv.py against dense NumPy inverses. Beyond the reference, which
has no inverse capability (SURVEY §5)."""

import numpy as np
import pytest

from cholesky_tpu import SparseCholesky
from cholesky_tpu.utils.laplacian import generate_problem


def _dense(n, r, c, v):
    off = r != c
    import scipy.sparse

    return scipy.sparse.coo_matrix(
        (np.concatenate([v, v[off]]),
         (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
        shape=(n, n)).toarray()


def test_inv_diag_grid_f64():
    n, r, c, v, o, cl, b = generate_problem((7, 7, 7), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    d = s.inv_diag()
    ref = np.diag(np.linalg.inv(_dense(n, r, c, v)))
    np.testing.assert_allclose(d, ref, rtol=1e-10, atol=0)


def test_inv_diag_grid_f32():
    n, r, c, v, o, cl, b = generate_problem((6, 6, 6), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    d = s.inv_diag()
    ref = np.diag(np.linalg.inv(_dense(n, r, c, v)))
    # f32 factor: inverse entries carry ~kappa * eps_f32
    np.testing.assert_allclose(d, ref, rtol=5e-3, atol=0)


def test_inv_diag_fixture_9x9():
    from tests.conftest import fixture_paths

    p = fixture_paths("lapl_9x9")
    s = SparseCholesky.from_files(p["mat"], p["separators"], p["clusters"],
                                  dtype=np.float64)
    from cholesky_tpu.io import mmio

    _, r, c, v = mmio.read_coo(p["mat"])
    r, c, v = mmio.dedup_lower(r, c, v)
    ref = np.diag(np.linalg.inv(_dense(9, r, c, v)))
    np.testing.assert_allclose(s.inv_diag(), ref, rtol=1e-10)


def test_inv_diag_auto_nd_irregular():
    """Irregular sparsity through graph nested dissection (variable boundary
    sizes, uneven fronts — exercises the fwd_child gather with sentinels)."""
    from tests.test_nd import random_spd

    rng = np.random.default_rng(5)
    n = 400
    r, c, v = random_spd(n, 5, rng)
    s = SparseCholesky.from_matrix(n, r, c, v, dtype=np.float64)
    ref = np.diag(np.linalg.inv(_dense(n, r, c, v)))
    np.testing.assert_allclose(s.inv_diag(), ref, rtol=1e-9)


def test_inv_diag_vs_panels_oracle_factor():
    """inv_diag against a dense inverse built from the ORACLE engine's
    factor — two independent factorizations, one answer."""
    import scipy.linalg

    from cholesky_tpu.verify.oracle import PanelsOracle

    n, r, c, v, o, cl, b = generate_problem((5, 5), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    oracle = PanelsOracle(s.plan, s.rows, s.cols, s.vals)
    L = oracle.factor_dense()
    linv = scipy.linalg.solve_triangular(L, np.eye(n), lower=True)
    ref = np.empty(n)
    ref[s.plan.perm] = (linv * linv).sum(axis=0)
    np.testing.assert_allclose(s.inv_diag(), ref, rtol=1e-10)


def test_inv_diag_consistent_with_solve():
    """Cross-check against explicit unit-vector solves on a few columns."""
    n, r, c, v, o, cl, b = generate_problem((6, 6), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    d = s.inv_diag()
    for i in (0, n // 2, n - 1):
        e = np.zeros(n)
        e[i] = 1.0
        x = s.solve(e)
        np.testing.assert_allclose(d[i], x[i], rtol=1e-10)


def test_inv_diag_memory_guard(monkeypatch):
    """Past-HBM problems fail with an estimate, not an opaque device OOM."""
    from cholesky_tpu.utils import capacity

    n, r, c, v, o, cl, b = generate_problem((6, 6), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    s.factorize()
    monkeypatch.setattr(capacity, "selinv_memory_bytes",
                        lambda fp, item=4: 1 << 60)
    with pytest.raises(MemoryError, match="selected inversion needs"):
        s.inv_diag()
    monkeypatch.setenv("CHOLESKY_TPU_SELINV", "force")
    d = s.inv_diag()                 # override runs it anyway
    ref = np.diag(np.linalg.inv(_dense(n, r, c, v)))
    np.testing.assert_allclose(d, ref, rtol=1e-10)


def test_inv_entries_on_pattern():
    """Arbitrary in-pattern entries (diagonal, same-separator off-diagonal,
    cross-level couplings) against the dense inverse, in both index
    orders."""
    n, r, c, v, o, cl, b = generate_problem((7, 7, 7), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    s.factorize()
    phi = np.linalg.inv(_dense(n, r, c, v))

    # every stored entry of A is in the pattern of L + L^T + I
    got = s.inv_entries(r, c)
    np.testing.assert_allclose(got, phi[r, c], rtol=1e-9)
    got_t = s.inv_entries(c, r)                  # symmetric order
    np.testing.assert_allclose(got_t, phi[r, c], rtol=1e-9)

    # consistency with inv_diag on the diagonal subset
    diag_idx = np.arange(0, n, 7)
    np.testing.assert_allclose(s.inv_entries(diag_idx, diag_idx),
                               s.inv_diag()[diag_idx], rtol=1e-12)


def test_inv_entries_fill_pattern():
    """Entries created by FILL (in pattern(L) but not in A) are valid
    requests too: check via the factor's own coordinates."""
    n, r, c, v, o, cl, b = generate_problem((6, 6), 3)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    fr, fc, fv = s.factor_coo()                  # permuted coords, with fill
    keep = np.abs(fv) > 1e-12
    orig_r = s.plan.perm[fr[keep]]
    orig_c = s.plan.perm[fc[keep]]
    phi = np.linalg.inv(_dense(n, r, c, v))
    got = s.inv_entries(orig_r, orig_c)
    np.testing.assert_allclose(got, phi[orig_r, orig_c], rtol=1e-9,
                               atol=1e-12)


def test_inv_entries_rejects_outside_pattern():
    """Two dofs in sibling subtrees never couple in L: must raise."""
    n, r, c, v, o, cl, b = generate_problem((6, 6, 6), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float64)
    s.factorize()
    t = s.plan.tree
    lvl = s.plan.levels - 1
    s1, s2 = t.sep_at(lvl, 0), t.sep_at(lvl, 1)  # sibling leaves
    i = int(s.plan.perm[s.plan.sep_offset[s1]])
    j = int(s.plan.perm[s.plan.sep_offset[s2]])
    with pytest.raises(ValueError, match="outside the factor pattern"):
        s.inv_entries([i], [j])
