"""Host-side assembly: scatter the COO matrix into per-level panel buffers.

Replacement for the reference's hashed-COO ingest + per-block fill
(read_matrix mnd.c:152-199 builds an open-addressing hash table; fill_block
mmat.rg:530-633 probes it per block entry). The numeric phase wants
statically-shaped batched device buffers, so assembly instead computes, for every
nonzero, its (level, slot, row, col) destination in the panel arrays with
vectorized integer arithmetic and scatters once. A C++ fast path lives in
cholesky_tpu.native for large matrices.
"""

from __future__ import annotations

from typing import List

import numpy as np

from cholesky_tpu.symbolic.plan import SolvePlan


def empty_panels(plan: SolvePlan, dtype=np.float64) -> List[np.ndarray]:
    """Allocate zeroed panel arrays, one [2^L, H(L), S(L)] per level, with the
    padded diagonal set to identity so batched Cholesky stays well-posed."""
    panels = []
    for lvl in range(plan.levels):
        B, Hh, W = plan.panel_shape(lvl)
        p = np.zeros((B, Hh, W), dtype=dtype)
        panels.append(p)
    _pad_identity(plan, panels)
    return panels


def _pad_identity(plan: SolvePlan, panels: List[np.ndarray]) -> None:
    t = plan.tree
    for lvl in range(plan.levels):
        W = int(plan.S[lvl])
        for slot in range(1 << lvl):
            sz = int(plan.sep_sizes[t.sep_at(lvl, slot)])
            if sz < W:
                idx = np.arange(sz, W)
                panels[lvl][slot, idx, idx] = 1.0


def assemble_panels(plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                    vals: np.ndarray, dtype=np.float64,
                    check_structure: bool = False) -> List[np.ndarray]:
    """Assemble panels from a COO lower triangle (original dof indexing).

    Entries are mirrored to both (i,j) and (j,i) and routed to the block that
    exists for the pair: diagonal blocks keep the lower triangle only
    (fill_block's `idx.y <= idx.x` guard, mmat.rg:591), ancestor blocks take
    the full entry (the reference's symmetric-index swap, mmat.rg:581-585).
    """
    try:
        from cholesky_tpu.native import ext as _ext

        panels = empty_panels(plan, dtype=np.float64)
        _ext.assemble_panels(
            np.ascontiguousarray(rows, dtype=np.int64),
            np.ascontiguousarray(cols, dtype=np.int64),
            np.ascontiguousarray(vals, dtype=np.float64),
            plan.sep_of_dof, plan.loc_of_dof,
            np.int64(plan.num_separators), np.int64(plan.levels),
            np.ascontiguousarray(plan.row_off), panels)
        if dtype != np.float64:
            panels = [p.astype(dtype) for p in panels]
        return panels
    except ImportError:
        pass
    return assemble_panels_numpy(plan, rows, cols, vals, dtype=dtype,
                                 check_structure=check_structure)


def assemble_panels_numpy(plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                          vals: np.ndarray, dtype=np.float64,
                          check_structure: bool = False) -> List[np.ndarray]:
    """Pure-NumPy assembly (fallback and parity oracle for the native path)."""
    off = rows != cols
    r = np.concatenate([rows, cols[off]])
    c = np.concatenate([cols, rows[off]])
    v = np.concatenate([vals, vals[off]])

    nsep = plan.num_separators
    sr = plan.sep_of_dof[r]
    sc = plan.sep_of_dof[c]
    lr = plan.loc_of_dof[r]
    lc = plan.loc_of_dof[c]
    heap_r = nsep - sr + 1
    heap_c = nsep - sc + 1
    lvl_r = np.int64(np.log2(heap_r))
    lvl_c = np.int64(np.log2(heap_c))

    diag = (sr == sc) & (lr >= lc)
    anc = (lvl_r < lvl_c) & ((heap_c >> (lvl_c - lvl_r).clip(0)) == heap_r)

    if check_structure:
        bad = ~(diag | anc | ((sr == sc) & (lr < lc)) |
                ((lvl_c < lvl_r) & ((heap_r >> (lvl_r - lvl_c).clip(0)) == heap_c)))
        if bad.any():
            k = int(np.argmax(bad))
            raise ValueError(
                f"matrix entry ({r[k]},{c[k]}) couples non-ancestor separators "
                f"{sr[k]} and {sc[k]}: invalid nested-dissection ordering")

    panels = empty_panels(plan, dtype=dtype)
    slot_c = heap_c - (np.int64(1) << lvl_c)
    prow = np.where(sr == sc, lr, plan.row_off[lvl_c.clip(0, plan.levels - 1),
                                               lvl_r.clip(0, plan.levels - 1)] + lr)
    keep = diag | anc
    for lvl in range(plan.levels):
        m = keep & (lvl_c == lvl)
        panels[lvl][slot_c[m], prow[m], lc[m]] = v[m].astype(dtype)
    return panels


def assemble_rhs(plan: SolvePlan, b: np.ndarray, dtype=np.float64) -> List[np.ndarray]:
    """Permute the RHS into per-level [2^L, S(L)] slabs (fill_b, mmat.rg:770-783)."""
    b = np.asarray(b).reshape(-1)
    t = plan.tree
    out = []
    for lvl in range(plan.levels):
        W = int(plan.S[lvl])
        arr = np.zeros((1 << lvl, W), dtype=dtype)
        for slot in range(1 << lvl):
            s = t.sep_at(lvl, slot)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            arr[slot, :sz] = b[plan.perm[off:off + sz]]
        out.append(arr)
    return out


def extract_solution(plan: SolvePlan, xlv: List[np.ndarray]) -> np.ndarray:
    """Un-permute the per-level solution slabs back to original dof order
    (mmat.rg:1483-1491)."""
    t = plan.tree
    x = np.zeros(plan.n, dtype=np.asarray(xlv[0]).dtype)
    for lvl in range(plan.levels):
        arr = np.asarray(xlv[lvl])
        for slot in range(1 << lvl):
            s = t.sep_at(lvl, slot)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            x[plan.perm[off:off + sz]] = arr[slot, :sz]
    return x


def extract_factor_dense(plan: SolvePlan, panels: List[np.ndarray]) -> np.ndarray:
    """Materialize the factor L as a dense [n, n] lower-triangular array in
    permuted coordinates (for verification and .mtx output, parity with the
    reference's write_matrix of its dense region, mmat.rg:103-147)."""
    t = plan.tree
    L = np.zeros((plan.n, plan.n))
    for lvl in range(plan.levels):
        arr = np.asarray(panels[lvl])
        W = int(plan.S[lvl])
        for slot in range(1 << lvl):
            s = t.sep_at(lvl, slot)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            L[off:off + sz, off:off + sz] = np.tril(arr[slot, :sz, :sz])
            for a in t.ancestors(s):
                la = t.level_of(a)
                ro = int(plan.row_off[lvl, la])
                ao = int(plan.sep_offset[a])
                asz = int(plan.sep_sizes[a])
                L[ao:ao + asz, off:off + sz] = arr[slot, ro:ro + asz, :sz]
    return L
