"""Minimum-degree hybrid ordering (symbolic/mdtree): MD quality, the
linear-extension fill-parity theorem the tree construction rests on,
separator-tree legality, end-to-end solves through the engine, and the
auto-selection policy in nested_dissection_graph."""

import numpy as np
import pytest

import cholesky_tpu

cholesky_tpu.force_cpu()

from cholesky_tpu import SparseCholesky                       # noqa: E402
from cholesky_tpu.symbolic import mdtree                      # noqa: E402
from cholesky_tpu.symbolic.quality import (                   # noqa: E402
    permuted_cost, superlu_cost)
from cholesky_tpu.utils import problems                       # noqa: E402


@pytest.mark.parametrize("name", ["random", "circuit", "imbalanced"])
def test_tree_inherits_md_fill_exactly(name):
    """The heap-indexed tree's induced permutation is a linear extension
    of the MD elimination tree, so its fill/FLOPs equal MD's EXACTLY —
    the invariant that lets the batched engine run MD-quality orderings."""
    n, r, c, v = problems.GALLERY[name]()
    md = mdtree.min_degree_perm(n, r, c)
    f_md, nnz_md = permuted_cost(n, r, c, md)
    dofs = mdtree.tree_from_elimination(n, r, c, md, 8)
    mdtree.check_separator_tree(n, r, c, dofs, 8)
    nsep = (1 << 8) - 1
    perm_tree = np.concatenate([dofs[h] for h in range(nsep, 0, -1)])
    f_tree, nnz_tree = permuted_cost(n, r, c, perm_tree)
    assert nnz_tree == nnz_md
    assert abs(f_tree - f_md) <= 1e-9 * f_md


def test_md_quality_near_superlu_mmd():
    """Our approximate-degree MD must track SuperLU's MMD on the graphs
    the hybrid exists for (within 10%)."""
    for name in ("random", "circuit"):
        n, r, c, v = problems.GALLERY[name]()
        md = mdtree.min_degree_perm(n, r, c)
        f_md, _ = permuted_cost(n, r, c, md)
        f_mmd, _ = superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        assert f_md <= 1.10 * f_mmd, (name, f_md / f_mmd)


def test_etree_parents_follow_children():
    n, r, c, v = problems.GALLERY["random"]()
    md = mdtree.min_degree_perm(n, r, c)
    parent = mdtree.etree(n, r, c, md)
    ok = (parent == -1) | (parent > np.arange(n))
    assert ok.all()


@pytest.mark.parametrize("name", ["circuit", "imbalanced"])
def test_md_tree_solves_through_engine(name):
    """An MD-built separator tree must drive the full frontal engine —
    plan, fill analysis, factorization, solve — to the 1e-10 contract
    (build_frontal_plan's boundary-coverage assertions are the structural
    gate)."""
    from cholesky_tpu.io.ordering import Ordering
    from cholesky_tpu.symbolic.nd import nested_dissection_graph
    from cholesky_tpu.utils.laplacian import make_clusters

    n, r, c, v = problems.GALLERY[name]()
    o, cl = nested_dissection_graph(n, r, c, levels=6, method="md")
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)
    x = s.solve(b)
    assert s.residual(b, x) <= 1e-10


def test_auto_selection_policy(monkeypatch):
    """auto keeps ND on mesh-like graphs (its 3-D win) and picks the MD
    tree on expanders; CHOLESKY_TPU_MD_MAX=0 disables the candidate."""
    from cholesky_tpu.symbolic.nd import nested_dissection_graph
    from cholesky_tpu.symbolic.plan import build_plan

    n, r, c, v = problems.GALLERY["random"]()
    o_auto, cl_a = nested_dissection_graph(n, r, c, levels=8)
    f_auto, _ = permuted_cost(n, r, c, build_plan(o_auto, cl_a).perm)
    monkeypatch.setenv("CHOLESKY_TPU_MD_MAX", "0")
    o_nd, cl_n = nested_dissection_graph(n, r, c, levels=8)
    f_nd, _ = permuted_cost(n, r, c, build_plan(o_nd, cl_n).perm)
    monkeypatch.delenv("CHOLESKY_TPU_MD_MAX")
    assert f_auto < 0.75 * f_nd          # expander: MD tree wins big

    n3, r3, c3, v3 = problems.GALLERY["aniso3d"]()
    o3, cl3 = nested_dissection_graph(n3, r3, c3, levels=8)
    f3, _ = permuted_cost(n3, r3, c3, build_plan(o3, cl3).perm)
    md3 = mdtree.min_degree_perm(n3, r3, c3)
    f3_md, _ = permuted_cost(n3, r3, c3, md3)
    assert f3 <= f3_md                   # 3-D: ND retained


def test_native_md_matches_python():
    """mndio.cc md_order is a statement-level mirror whose lazy (deg, v)
    heap makes pop order container-independent — output must be
    IDENTICAL to the Python implementation (14-41x faster measured)."""
    pytest.importorskip("cholesky_tpu.native.ext")
    for name in ("random", "circuit", "imbalanced"):
        n, r, c, v = problems.GALLERY[name]()
        pn = mdtree.min_degree_perm(n, r, c, native=True)
        pp = mdtree.min_degree_perm(n, r, c, native=False)
        assert np.array_equal(pn, pp), name


def test_native_col_counts_match_python():
    """mndio.cc col_counts (Gilbert-Ng-Peyton leaf counting) must be
    BIT-identical to the Python set-merge symbolic elimination it
    replaces as the ordering-selection oracle — exactness is what lets
    the auto selector trust FLOP comparisons between candidates."""
    pytest.importorskip("cholesky_tpu.native.ext")
    from cholesky_tpu.native import ext
    from cholesky_tpu.symbolic.quality import _fill_flops_python

    rng = np.random.default_rng(7)
    cases = []
    for _ in range(12):                       # random sparse patterns
        n = int(rng.integers(4, 80))
        m = int(rng.integers(n, 5 * n))
        cases.append((n, rng.integers(0, n, m), rng.integers(0, n, m)))
    for name in ("random", "circuit", "wathen", "imbalanced"):
        n, r, c, v = problems.GALLERY[name]()
        cases.append((n, r, c))
    for n, r, c in cases:
        cc = ext.col_counts(n, r, c)
        f_py, z_py = _fill_flops_python(n, r, c)
        assert float((cc.astype(np.float64) ** 2).sum()) == f_py
        assert int(cc.sum()) == z_py


def test_md_hybrid_band_scale3(monkeypatch):
    """Scale-3 band: with the native MD + col-counts
    cores the hybrid reaches n ~ 24k irregular problems (the old 16,384
    cap silently fell back to pure ND and its measured 1.7-2.3x FLOP
    penalty there); hybrid/SuperLU-MMD must stay <= 1.35."""
    pytest.importorskip("cholesky_tpu.native.ext")
    pytest.importorskip("scipy")
    from cholesky_tpu.symbolic.quality import nd_cost, superlu_cost

    n, r, c, v = problems.random_spd(24576, 6, 0)
    f_auto, _ = nd_cost(n, r, c)
    f_mmd, _ = superlu_cost(n, r, c, v)
    assert f_auto <= 1.35 * f_mmd, f_auto / f_mmd
