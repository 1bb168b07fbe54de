"""General-graph nested-dissection tests: the auto-ordering path for
arbitrary SPD matrices (no precomputed ord/clust files)."""

import numpy as np
import pytest

from cholesky_tpu import SparseCholesky
from cholesky_tpu.numeric.assemble import assemble_panels_numpy
from cholesky_tpu.symbolic.nd import nested_dissection_graph
from cholesky_tpu.symbolic.plan import build_plan
from cholesky_tpu.utils.laplacian import grid_laplacian


def random_spd(n, density, rng):
    """Random sparse strictly-diagonally-dominant SPD matrix (lower COO)."""
    nnz = int(n * density)
    r = rng.integers(1, n, size=nnz)
    c = (rng.random(nnz) * r).astype(np.int64)
    uniq = np.unique(r * n + c)
    r, c = uniq // n, uniq % n
    v = rng.uniform(-1.0, 1.0, size=len(r))
    deg = np.zeros(n)
    np.add.at(deg, r, np.abs(v))
    np.add.at(deg, c, np.abs(v))
    rows = np.concatenate([np.arange(n), r])
    cols = np.concatenate([np.arange(n), c])
    vals = np.concatenate([deg + 1.0, v])
    return rows, cols, vals


def test_separator_property():
    """The ordering must satisfy the ND invariant: no entry couples two
    separators outside an ancestor relation (check_structure enforces)."""
    rng = np.random.default_rng(3)
    n = 500
    rows, cols, vals = random_spd(n, 6, rng)
    o, cl = nested_dissection_graph(n, rows, cols)
    plan = build_plan(o, cl)
    assemble_panels_numpy(plan, rows, cols, vals, check_structure=True)


def _check_split_invariants(n, rows, cols):
    from cholesky_tpu.symbolic.nd import _build_adjacency, _split

    indptr, indices = _build_adjacency(n, rows, cols)
    a, b, s = _split(indptr, indices, np.arange(n, dtype=np.int64))
    in_a = np.zeros(n, bool); in_a[a] = True
    in_b = np.zeros(n, bool); in_b[b] = True
    for vtx in s:
        nbrs = indices[indptr[vtx]:indptr[vtx + 1]]
        assert in_a[nbrs].any() and in_b[nbrs].any()
    for vtx in a:
        assert not in_b[indices[indptr[vtx]:indptr[vtx + 1]]].any()
    return len(a), len(b), len(s)


def test_separator_vertices_all_needed():
    """Refinement invariant (_split): every vertex kept in a separator has
    at least one neighbor on EACH side it separates — a vertex with all its
    edges into one side plus the separator would have been returned to the
    far side instead of enlarging the root front. Random graphs exercise
    both frontier branches (separator drawn from `rest` or from `a_side`)."""
    rng = np.random.default_rng(11)
    n, r, c, v = grid_laplacian((20, 20))
    p = rng.permutation(n)
    na, nb, ns = _check_split_invariants(n, p[r], p[c])
    assert na and nb and ns
    for seed in range(6):
        rng = np.random.default_rng(seed)
        m = 400
        rr, cc, _ = random_spd(m, 4, rng)
        off = rr != cc
        _check_split_invariants(m, rr[off], cc[off])


def test_partition_is_complete():
    n = 300
    rng = np.random.default_rng(0)
    rows, cols, vals = random_spd(n, 5, rng)
    o, _ = nested_dissection_graph(n, rows, cols, levels=4)
    all_dofs = np.concatenate([o.dofs[s] for s in range(1, 16)])
    assert sorted(all_dofs) == list(range(n))


def test_solve_random_spd():
    rng = np.random.default_rng(7)
    n = 800
    rows, cols, vals = random_spd(n, 6, rng)
    s = SparseCholesky.from_matrix(n, rows, cols, vals)
    b = rng.normal(size=n)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_solve_shuffled_grid():
    """A grid Laplacian with randomly-permuted vertex ids — geometric
    structure hidden, the graph bisection must find it."""
    rng = np.random.default_rng(1)
    n, r, c, v = grid_laplacian((24, 24))
    p = rng.permutation(n)
    s = SparseCholesky.from_matrix(n, p[r], p[c], v, levels=5)
    b = rng.normal(size=n)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_ordering_quality_vs_geometric():
    """FM-refined graph ND must stay within 1.5x of the geometric
    generator's schedule FLOPs on a shuffled grid (it has no idea the graph
    is a grid). Pre-refinement the gap was ~4x in 2-D — this is the
    regression gate for separator quality AND leaf balance (loose balance
    windows compound into oversized leaves whose dense work is cubic)."""
    from cholesky_tpu.symbolic.fill import analyze_fill
    from cholesky_tpu.symbolic.plan import build_plan
    from cholesky_tpu.utils.laplacian import generate_problem
    from cholesky_tpu.verify.schedule import generate_schedule, schedule_flops

    def flops_of(n, rows, cols, o, cl):
        plan = build_plan(o, cl)
        fill = analyze_fill(plan, rows, cols, np.ones(len(rows)))
        return schedule_flops(generate_schedule(fill))

    rng = np.random.default_rng(7)
    for shape, levels in [((32, 32), 5), ((12, 12, 12), 6)]:
        n, r, c, v, o_geo, cl_geo, _ = generate_problem(shape, levels)
        geo = flops_of(n, r, c, o_geo, cl_geo)
        perm = rng.permutation(n)
        pr, pc = perm[r], perm[c]
        rr, cc = np.maximum(pr, pc), np.minimum(pr, pc)
        o, cl = nested_dissection_graph(n, rr, cc, levels=levels)
        graph = flops_of(n, rr, cc, o, cl)
        assert graph <= 1.5 * geo, (shape, graph / geo)


def test_native_nd_matches_python():
    """The native ordering core (mndio.cc nd_order) is a statement-level
    mirror of the Python implementation — same BFS cuts, FM heap
    tie-breaking, sorted-unique semantics — so its output must be
    BIT-IDENTICAL, not merely equivalent. Any divergence means the two
    implementations drifted."""
    pytest.importorskip("cholesky_tpu.native.ext")
    rng = np.random.default_rng(7)

    def check(n, rows, cols, levels):
        o1, _ = nested_dissection_graph(n, rows, cols, levels=levels,
                                        native=False)
        o2, _ = nested_dissection_graph(n, rows, cols, levels=levels,
                                        native=True)
        assert o1.levels == o2.levels
        for k in o1.dofs:
            np.testing.assert_array_equal(o1.dofs[k], o2.dofs[k])

    n, r, c, _ = grid_laplacian((20, 20))
    p = rng.permutation(n)
    check(n, np.maximum(p[r], p[c]), np.minimum(p[r], p[c]), 5)
    n, r, c, _ = grid_laplacian((9, 10, 11))
    p = rng.permutation(n)
    check(n, np.maximum(p[r], p[c]), np.minimum(p[r], p[c]), 6)
    for seed in range(3):
        rr, cc, _ = random_spd(500, 5, np.random.default_rng(seed))
        check(500, rr, cc, 4)
    # disconnected components
    n1, r1, c1, _ = grid_laplacian((9, 9))
    n2, r2, c2, _ = grid_laplacian((7, 8))
    check(n1 + n2, np.concatenate([r1, r2 + n1]),
          np.concatenate([c1, c2 + n1]), 4)


def test_native_nd_threads_identical():
    """nd_order_mt's thread pool must be invisible in the output: parts at
    one tree depth are disjoint subgraphs split by workers with PRIVATE
    stamped workspaces, so any thread count yields the serial ordering
    bit-for-bit. The graph is big enough (> 2^16 vertices per depth) that
    the parallel branch actually engages."""
    ext = pytest.importorskip("cholesky_tpu.native.ext")
    rng = np.random.default_rng(3)
    n, r, c, _ = grid_laplacian((42, 42, 42))      # 74k dofs
    p = rng.permutation(n)
    rows, cols = np.maximum(p[r], p[c]), np.minimum(p[r], p[c])
    ref = ext.nd_order(n, rows, cols, 8, threads=1)
    for t in (2, 4, 7):
        np.testing.assert_array_equal(
            ext.nd_order(n, rows, cols, 8, threads=t), ref)


def test_disconnected_graph():
    """Two disconnected components (block-diagonal SPD)."""
    rng = np.random.default_rng(2)
    n1, r1, c1, v1 = grid_laplacian((9, 9))
    n2, r2, c2, v2 = grid_laplacian((7, 8))
    n = n1 + n2
    rows = np.concatenate([r1, r2 + n1])
    cols = np.concatenate([c1, c2 + n1])
    vals = np.concatenate([v1, v2])
    s = SparseCholesky.from_matrix(n, rows, cols, vals, levels=4)
    b = rng.normal(size=n)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_tiny_matrix():
    rows = np.array([0, 1, 1])
    cols = np.array([0, 0, 1])
    vals = np.array([4.0, 1.0, 3.0])
    s = SparseCholesky.from_matrix(2, rows, cols, vals)
    x = s.solve(np.array([1.0, 2.0]))
    a = np.array([[4.0, 1.0], [1.0, 3.0]])
    np.testing.assert_allclose(a @ x, [1.0, 2.0], atol=1e-12)


def test_solve_fem_delaunay():
    """Unstructured 2-D FEM: P1 stiffness + mass matrix on a random Delaunay
    triangulation — realistic irregular sparsity (variable vertex degree, no
    grid structure) through the full auto-ND pipeline. The fixture ladder and
    grid generators never exercise this shape of graph."""
    import scipy.spatial

    rng = np.random.default_rng(7)
    n = 1500
    pts = rng.random((n, 2))
    tri = scipy.spatial.Delaunay(pts)

    rows_l, cols_l, vals_l = [], [], []
    for simplex in tri.simplices:
        p = pts[simplex]                      # [3, 2]
        # P1 gradients: area and edge normals
        b = np.array([p[1, 1] - p[2, 1], p[2, 1] - p[0, 1], p[0, 1] - p[1, 1]])
        cc = np.array([p[2, 0] - p[1, 0], p[0, 0] - p[2, 0], p[1, 0] - p[0, 0]])
        e1, e2 = p[1] - p[0], p[2] - p[0]
        area = 0.5 * abs(e1[0] * e2[1] - e1[1] * e2[0])
        ke = (np.outer(b, b) + np.outer(cc, cc)) / (4.0 * area)
        me = area / 12.0 * (np.ones((3, 3)) + np.eye(3))   # lumped-ish mass
        for i in range(3):
            for j in range(3):
                if simplex[i] >= simplex[j]:               # lower triangle
                    rows_l.append(simplex[i])
                    cols_l.append(simplex[j])
                    vals_l.append(ke[i, j] + me[i, j])
    rows = np.asarray(rows_l)
    cols = np.asarray(cols_l)
    vals = np.asarray(vals_l)
    # sum duplicate COO entries (element assembly overlaps)
    key = rows * n + cols
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(len(uniq))
    np.add.at(acc, inv, vals)
    rows, cols, vals = uniq // n, uniq % n, acc

    s = SparseCholesky.from_matrix(n, rows, cols, vals, dtype=np.float64)
    b_rhs = rng.standard_normal(n)
    x = s.solve(b_rhs)
    assert s.residual(b_rhs, x) <= 1e-10

    import scipy.sparse

    off = rows != cols
    a = scipy.sparse.coo_matrix(
        (np.concatenate([vals, vals[off]]),
         (np.concatenate([rows, cols[off]]), np.concatenate([cols, rows[off]]))),
        shape=(n, n)).toarray()
    np.testing.assert_allclose(x, np.linalg.solve(a, b_rhs), rtol=1e-8,
                               atol=1e-10)


def test_out_of_range_indices_raise():
    """1-based COO input (a common mistake) must raise IndexError on BOTH
    ordering paths — the native core previously indexed n-sized arrays with
    the raw values (review finding: heap corruption instead of an error)."""
    rows = np.array([1, 2, 3, 4, 5])
    cols = np.array([0, 1, 2, 3, 4])
    with pytest.raises(IndexError):
        nested_dissection_graph(5, rows, cols, levels=2, native=True)
    with pytest.raises(IndexError):
        nested_dissection_graph(5, rows, cols, levels=2, native=False)


def test_nd_vs_rcm_on_irregular_graphs():
    """Ordering quality vs the in-image alternative (scipy RCM) on the
    gallery's irregular problems — exact symbolic-elimination FLOPs of the
    DEEP ND ordering must beat RCM by at least the banded margin (measured
    ratios ~25% tighter: random 0.56, circuit 0.50, dense_rows 0.05,
    imbalanced 0.38). The engine's auto-depth policy may still COLLAPSE the
    expander trees for batched execution (test_problems.py covers that);
    this test pins the quality of the ordering itself."""
    from cholesky_tpu.symbolic.quality import nd_cost, rcm_cost
    from cholesky_tpu.utils import problems

    bands = {"random": 0.75, "circuit": 0.70,
             "dense_rows": 0.25, "imbalanced": 0.60}
    for name, band in bands.items():
        n, r, c, v = problems.GALLERY[name]()
        f_nd, _ = nd_cost(n, r, c, levels=8)
        f_rcm, _ = rcm_cost(n, r, c, v)
        assert f_nd <= band * f_rcm, (name, f_nd / f_rcm)


def test_nd_vs_mmd_bands():
    """Ordering quality vs the HONEST in-image fill-reducing baseline —
    SuperLU's MMD_AT_PLUS_A extracted from scipy splu. Round 4's minimum-degree hybrid
    (symbolic/mdtree: MD ordering -> elimination tree -> legal binary
    separator tree, auto-selected by symbolic FLOPs) closed the round-3
    1.7-2.3x irregular-graph gap to ~parity; these bands sit ~5-10%
    above the newly measured scale-1 ratios (aniso2d 1.19, random 1.00,
    circuit 0.99, dense_rows 1.09, imbalanced 1.27
    asked for <= 1.3 on random/circuit/imbalanced). The 3-D ND win is
    pinned separately below."""
    from cholesky_tpu.symbolic.quality import nd_cost, superlu_cost
    from cholesky_tpu.utils import problems

    bands = {"aniso2d": 1.30, "random": 1.10, "circuit": 1.10,
             "dense_rows": 1.20, "imbalanced": 1.35}
    for name, band in bands.items():
        n, r, c, v = problems.GALLERY[name]()
        f_nd, _ = nd_cost(n, r, c, levels=8)
        f_mmd, _ = superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        assert f_nd <= band * f_mmd, (name, f_nd / f_mmd)


def test_nd_vs_mmd_3d_scaling():
    """On 3-D problems — the framework's design-target class — deep ND
    must BEAT MMD, and the win must widen with n (measured deep/MMD:
    0.74 at n=1728, 0.45 at n=13824; classical asymptotics: O(n²) ND fill
    FLOPs vs super-quadratic minimum-degree in 3-D)."""
    from cholesky_tpu.symbolic.quality import nd_cost, superlu_cost
    from cholesky_tpu.utils import problems

    ratios = {}
    for scale in (1, 2):
        n, r, c, v = problems.make_gallery(scale)["aniso3d"]()
        f_nd, _ = nd_cost(n, r, c, levels=8)
        f_mmd, _ = superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        ratios[scale] = f_nd / f_mmd
    assert ratios[1] <= 0.85, ratios
    assert ratios[2] <= 0.55, ratios
    assert ratios[2] < ratios[1], ratios
