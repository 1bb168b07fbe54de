"""SPD gallery end-to-end: structurally diverse problems (anisotropic,
FEM/Wathen-style, elasticity-style vector blocks, random/circuit graphs)
through the no-ordering entry point `SparseCholesky.from_matrix` — auto
nested dissection (symbolic/nd.py) + frontal factorization + solve to the
1e-10 residual contract. The reference can't run any of these: it requires
offline ord/clust files and ships only grid-Laplacian fixtures."""

import numpy as np
import pytest
import scipy.sparse as sp

from cholesky_tpu import SparseCholesky
from cholesky_tpu.utils import problems


def _dense(n, r, c, v):
    a = sp.coo_matrix((v, (r, c)), shape=(n, n)).toarray()
    return a + np.tril(a, -1).T


@pytest.mark.parametrize("name", sorted(problems.GALLERY))
def test_gallery_spd(name):
    n, r, c, v = problems.GALLERY[name]()
    a = _dense(n, r, c, v)
    w = np.linalg.eigvalsh(a)
    assert w.min() > 0, f"{name} not SPD (lambda_min={w.min():.3e})"


@pytest.mark.parametrize("name", sorted(problems.GALLERY))
def test_gallery_solve_f64(name):
    n, r, c, v = problems.GALLERY[name]()
    s = SparseCholesky.from_matrix(n, r, c, v)
    s.factorize()
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


@pytest.mark.parametrize("name", ["wathen", "circuit"])
def test_gallery_solve_f32_refined(name):
    # fp32 factor + mixed-precision iterative refinement still meets the
    # contract on non-grid structures
    n, r, c, v = problems.GALLERY[name]()
    s = SparseCholesky.from_matrix(n, r, c, v, dtype=np.float32)
    s.factorize()
    rng = np.random.default_rng(11)
    b = rng.standard_normal(n)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_gallery_logdet_matches_scipy():
    n, r, c, v = problems.fem_q4(10, 10, seed=4)
    s = SparseCholesky.from_matrix(n, r, c, v)
    s.factorize()
    a = _dense(n, r, c, v)
    sign, ref = np.linalg.slogdet(a)
    assert sign == 1.0
    assert abs(s.logdet() - ref) <= 1e-8 * max(1.0, abs(ref))


def test_anisotropic_isotropic_matches_grid_laplacian():
    from cholesky_tpu.utils.laplacian import grid_laplacian

    n, r, c, v = problems.anisotropic_laplacian((7, 5, 3))
    a = _dense(n, r, c, v)
    nr, rr, rc, rv = grid_laplacian((7, 5, 3))
    b = _dense(nr, rr, rc, rv)
    np.testing.assert_allclose(a, b)


def test_vector_laplacian_is_kron_plus_shift():
    n, r, c, v = problems.vector_laplacian((4, 3), ncomp=2, shift=0.5)
    a = _dense(n, r, c, v)
    nl, lr, lc, lv = problems.anisotropic_laplacian((4, 3))
    lap = _dense(nl, lr, lc, lv)
    cmat = 2.0 * np.eye(2) + np.eye(2, k=1) + np.eye(2, k=-1)
    ref = np.kron(lap, cmat) + 0.5 * np.eye(n)
    np.testing.assert_allclose(a, ref)


def test_random_spd_diagonally_dominant():
    n, r, c, v = problems.random_spd(400, avg_degree=10, seed=5, skew=True)
    a = _dense(n, r, c, v)
    off = np.abs(a).sum(axis=1) - np.abs(np.diag(a))
    assert np.all(np.diag(a) >= off + 0.999)


def test_dense_rows_are_dense():
    n, r, c, v = problems.dense_row_spd((12, 12), k_dense=2)
    a = _dense(n, r, c, v)
    # the last two rows couple to every dof
    assert np.all(a[-1, :] != 0) and np.all(a[-2, :-1] != 0)


def _padding_efficiency(s):
    from cholesky_tpu.symbolic import fill as fillmod
    from cholesky_tpu.utils import capacity
    from cholesky_tpu.verify import schedule as schedmod

    fa = fillmod.analyze_fill(s.plan, s.rows, s.cols, s.vals)
    ops = schedmod.generate_schedule(fa)
    return capacity.padding_efficiency(s.fplan, schedmod.schedule_flops(ops))


@pytest.mark.parametrize("name,floor", [
    # bucket-padding waste must stay bounded on hostile structures
    #. Floors are ~25% under measured values — regression
    # bands, not aspirations: dense_rows 0.35, imbalanced 0.28,
    # random/circuit 0.99 (the auto-depth policy collapses expander graphs
    # to the dense root rather than paying bucket-max padding at depth).
    ("dense_rows", 0.26),
    ("imbalanced", 0.21),
    ("random", 0.75),
    ("circuit", 0.75),
])
def test_hostile_padding_efficiency_bounded(name, floor):
    n, r, c, v = problems.GALLERY[name]()
    s = SparseCholesky.from_matrix(n, r, c, v)
    assert _padding_efficiency(s) >= floor


def test_expander_auto_depth_collapses():
    """On an expander graph every ND level multiplies bucket-max boundary
    work; the auto-depth policy must refuse to build a deep tree whose
    executed FLOPs exceed the dense factorization's."""
    from cholesky_tpu.utils import capacity

    n, r, c, v = problems.GALLERY["random"]()
    s = SparseCholesky.from_matrix(n, r, c, v)
    assert capacity.frontal_flops(s.fplan) <= 1.5 * (n ** 3 / 3)
