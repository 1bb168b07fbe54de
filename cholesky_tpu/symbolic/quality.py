"""Ordering-quality metrics: exact symbolic-elimination cost of a
permutation, for comparing the graph nested-dissection ordering against
alternatives (RCM, natural) on irregular graphs.

The reference consumes precomputed orderings (SURVEY.md: ordering computed
offline, mnd.c:22 reads it); this module is the evidence layer for the
rebuild's own ordering generator (symbolic/nd.py) — scalar column-update
FLOPs and nnz(L) under any candidate permutation, engine-independent.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def fill_flops(n: int, rows: np.ndarray, cols: np.ndarray
               ) -> Tuple[float, int]:
    """Exact symbolic factorization of the symmetric pattern: returns
    (sum cnt_j^2 column FLOPs, nnz(L)) for elimination in natural order.

    Dispatches to the native Gilbert-Ng-Peyton column-count core
    (mndio.cc col_counts, O(nnz*alpha) — it never materializes L's
    structure, so the 98k-random query that takes the set-merge
    elimination 172 s answers in ~0.1 s); falls back to the Python
    set-merge elimination below when the library is unavailable.
    Bit-parity asserted in tests/test_mdtree.py."""
    try:
        from cholesky_tpu.native import ext

        cc = ext.col_counts(n, rows, cols)
        return float((cc.astype(np.float64) ** 2).sum()), int(cc.sum())
    except Exception:  # noqa: BLE001 — no native lib / build failure
        return _fill_flops_python(n, rows, cols)


def _fill_flops_python(n: int, rows: np.ndarray, cols: np.ndarray
                       ) -> Tuple[float, int]:
    """Set-merge symbolic elimination (O(nnz(L)) set work): child
    structures merge into their elimination-tree parent once each. The
    pure-Python reference the native core is tested against."""
    adj = [set() for _ in range(n)]
    for r, c in zip(rows, cols):
        if r == c:
            continue
        lo, hi = (c, r) if r > c else (r, c)
        adj[lo].add(hi)
    children = [[] for _ in range(n)]
    struct = [None] * n
    flops = 0.0
    nnz = 0
    for j in range(n):
        s = adj[j]
        for ch in children[j]:
            s |= struct[ch]
            struct[ch] = None
        s.discard(j)
        struct[j] = s
        cnt = len(s) + 1
        flops += float(cnt) * cnt
        nnz += cnt
        if s:
            children[min(s)].append(j)
    return flops, nnz


def permuted_cost(n: int, rows: np.ndarray, cols: np.ndarray,
                  perm: np.ndarray) -> Tuple[float, int]:
    """Cost of eliminating in the order given by perm (perm[k] = original
    dof eliminated k-th)."""
    iperm = np.empty(n, dtype=np.int64)
    iperm[np.asarray(perm)] = np.arange(n)
    return fill_flops(n, iperm[rows], iperm[cols])


def nd_cost(n, rows, cols, vals=None, levels=None) -> Tuple[float, int]:
    """Symbolic cost of this package's graph-ND ordering (auto depth when
    levels is None — including the expander depth-collapse policy; pass an
    explicit levels to measure the deep ordering itself)."""
    from cholesky_tpu.symbolic.nd import nested_dissection_graph
    from cholesky_tpu.symbolic.plan import build_plan

    o, cl = nested_dissection_graph(n, rows, cols, levels=levels)
    return permuted_cost(n, rows, cols, build_plan(o, cl).perm)


def _sym_csr(n, rows, cols, vals):
    import scipy.sparse

    off = rows != cols
    return scipy.sparse.csr_matrix(
        (np.concatenate([vals, vals[off]]),
         (np.concatenate([rows, cols[off]]),
          np.concatenate([cols, rows[off]]))), shape=(n, n))


def rcm_cost(n, rows, cols, vals) -> Tuple[float, int]:
    """Symbolic cost of scipy's reverse Cuthill-McKee ordering — a
    BANDWIDTH orderer, the weakest in-image rival (kept for context)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = np.asarray(reverse_cuthill_mckee(_sym_csr(n, rows, cols, vals),
                                            symmetric_mode=True))
    return permuted_cost(n, rows, cols, perm)


def superlu_cost(n, rows, cols, vals,
                 permc_spec: str = "MMD_AT_PLUS_A") -> Tuple[float, int]:
    """Symbolic cost of SuperLU's production FILL-REDUCING orderings,
    extracted from scipy.sparse.linalg.splu's column permutation:
    'MMD_AT_PLUS_A' (multiple minimum degree on the symmetric structure —
    the standard direct-solver ordering for symmetric systems) or
    'COLAMD'. Unlike RCM these are the honest available baseline for the
    package's graph-ND generator. Row pivoting (perm_r)
    does not affect perm_c, so the numeric factorization splu performs is
    only a means to the ordering."""
    from scipy.sparse.linalg import splu

    a = _sym_csr(n, rows, cols, vals).tocsc()
    lu = splu(a, permc_spec=permc_spec,
              options=dict(SymmetricMode=True, DiagPivotThresh=0.0))
    # scipy's perm_c maps ORIGINAL index -> permuted position; this
    # module's convention is perm[k] = original dof eliminated k-th
    # (verified against splu's own nnz(L) on a 48x48 grid: the inverse
    # reproduces it, the as-is orientation is ~70x worse than natural)
    pc = np.asarray(lu.perm_c)
    perm = np.empty_like(pc)
    perm[pc] = np.arange(n)
    return permuted_cost(n, rows, cols, perm)
