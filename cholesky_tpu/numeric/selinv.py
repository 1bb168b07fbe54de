"""Selected inversion: diag(A^{-1}) (and the separator-block entries of the
inverse) from the frontal Cholesky factor, by a top-down batched recursion
over the separator tree.

Math. Let s be a separator with pivot factor L_ss and off-diagonal strip
L_Ss (rows S = s's front boundary, all in ancestor separators). With
X = L_Ss L_ss^{-1} and Phi = A^{-1}:

    Phi_Ss = -Phi_SS X
    Phi_ss =  L_ss^{-T} L_ss^{-1} + X^T Phi_SS X

which follows from the restricted-inverse identity (A^{-1})_{TT} =
(Schur complement of A onto T)^{-1} applied to the trailing set at s's
elimination step, whose Cholesky factor is exactly [[L_ss, 0], [L_Ss, *]].
Phi_SS is the TRUE global inverse on s's boundary rows — and since a child's
boundary is contained in its parent's front (asserted at plan build,
frontal.py), Phi_SS is a gather from the parent's front-inverse block
P_parent = Phi over (parent pivot ∪ parent boundary). The recursion runs
root → leaves, one batched step per tree level: every operation is a
[B, ·, ·] batched matmul, mirroring the factorization's level structure
in reverse.

Cost: ~2 extra factorizations' worth of FLOPs; memory: P is [B, F, F] per
level (F/W times the front array), held for two adjacent levels — in-core
for the scales the monolithic factor path handles.

Reference parity: none — the reference (syamajala/cholesky) has no inverse
capability. This is a standard production feature of sparse direct solvers
(Takahashi equations; PSelInv) that the batched frontal layout makes
a sequence of batched matmuls.
"""

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from cholesky_tpu.numeric.frontal import FrontalPlan, _tri_solve


def _inv_L(fac, W: int, dtype):
    """Explicit inverse of the batched pivot Cholesky factors [B, W, W]."""
    Ld = fac[:, :W, :].astype(dtype)
    eye = jnp.broadcast_to(jnp.eye(W, dtype=dtype), Ld.shape)
    return _tri_solve(Ld, eye, left_side=True, lower=True)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _selinv_root(W: int, dtype_name: str, fac):
    """Root separator: no ancestors, P = (L L^T)^{-1} over the pivot."""
    invL = _inv_L(fac, W, jnp.dtype(dtype_name))
    P = jnp.einsum("bki,bkj->bij", invL, invL,
                   preferred_element_type=invL.dtype)
    return P, jnp.diagonal(P, axis1=1, axis2=2)


def _selinv_core(W: int, dtype, fac, idx, P_prev):
    """Shared per-level math: returns (Phi_ss [B, W, W], PX [B, bnd, W],
    Pp [B, bnd, bnd]).

    The parent-inverse restriction Pp = P_prev[parent][idx, idx] is computed
    as two one-hot batched matmuls (G @ P @ G^T), not an advanced-index
    gather: XLA lowered the 2-D gather element-wise (269M gathered
    elements at 50^3/L8) on the first target, while the one-hot
    contraction is ~3.8 TFLOP of matmul work — the same trade the extend-add's
    gathermm strategy measured (frontal.py). The one-hot products are exact
    (1.0 times a float is exact in every matmul precision), and sentinel
    positions (padded boundary rows, idx == F_prev) produce all-zero one-hot
    rows, so no clamping and no gathered garbage: padded rows of Pp/PX are
    exactly zero, and padded pivot diagonal entries are dropped at scatter
    time via the sentinel row id n.
    """
    invL = _inv_L(fac, W, dtype)
    S = jnp.einsum("bki,bkj->bij", invL, invL, preferred_element_type=dtype)
    B = fac.shape[0]
    Fp = P_prev.shape[1]
    bnd = fac.shape[1] - W
    # one-hot rows: G2[p, c, i, q] = 1 iff child (p,c)'s boundary row i sits
    # at parent front position q; contracted against P_prev without ever
    # materializing the 2x-expanded parent array
    G2 = (idx.reshape(B // 2, 2, bnd, 1)
          == jnp.arange(Fp, dtype=idx.dtype).reshape(1, 1, 1, Fp)
          ).astype(dtype)                                  # [B/2, 2, bnd, Fp]
    M = jnp.einsum("bpq,bciq->bcip", P_prev, G2,
                   preferred_element_type=dtype)           # [B/2, 2, bnd, Fp]
    Pp = jnp.einsum("bcip,bcjp->bcij", M, G2,
                    preferred_element_type=dtype).reshape(B, bnd, bnd)
    Xs = jnp.einsum("bik,bkj->bij", fac[:, W:, :].astype(dtype), invL,
                    preferred_element_type=dtype)          # [B, bnd, W]
    PX = jnp.einsum("bik,bkj->bij", Pp, Xs,
                    preferred_element_type=dtype)          # [B, bnd, W]
    Phi_ss = S + jnp.einsum("bki,bkj->bij", Xs, PX,
                            preferred_element_type=dtype)
    return Phi_ss, PX, Pp


@functools.partial(jax.jit, static_argnums=(0, 1))
def _selinv_step(W: int, dtype_name: str, fac, idx, P_prev):
    """One tree level down: fac [B, F, W] (pivot factor + strip L_Ss),
    idx = fwd_child [B, F-W] (child boundary position -> parent front
    position, sentinel F_prev), P_prev [B/2, F_prev, F_prev]. Returns
    (P [B, F, F], pivot diagonal [B, W])."""
    Phi_ss, PX, Pp = _selinv_core(W, jnp.dtype(dtype_name), fac, idx, P_prev)
    top = jnp.concatenate([Phi_ss, -PX.transpose(0, 2, 1)], axis=2)
    bot = jnp.concatenate([-PX, Pp], axis=2)
    P = jnp.concatenate([top, bot], axis=1)                # [B, F, F]
    return P, jnp.diagonal(Phi_ss, axis1=1, axis2=2)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _selinv_step_last(W: int, dtype_name: str, fac, idx, P_prev):
    """Leaf level: nothing consumes P below, so skip assembling the
    [B, F, F] block matrix (a ~1 GiB concatenate at 50^3/L8) and return
    only the pivot diagonal."""
    Phi_ss, _, _ = _selinv_core(W, jnp.dtype(dtype_name), fac, idx, P_prev)
    return jnp.diagonal(Phi_ss, axis1=1, axis2=2)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _selinv_step_noP(W: int, dtype_name: str, fac, idx, P_prev):
    """Entry-extraction variant for the leaf level: (Phi_ss, PX) only,
    skipping the [B, F, F] block assembly (Phi_off = -PX)."""
    Phi_ss, PX, _ = _selinv_core(W, jnp.dtype(dtype_name), fac, idx, P_prev)
    return Phi_ss, PX


def _compute_dtype(factors) -> str:
    return ("float64" if jnp.dtype(factors[0].dtype) == jnp.float64
            else "float32")


def selinv_diag(fp: FrontalPlan, factors: Sequence[jax.Array],
                dtype: Optional[str] = None) -> np.ndarray:
    """diag(A^{-1}) in PERMUTED coordinates, [n] float64.

    Accuracy follows the factor precision: ~1e-13 relative from an f64
    factor, ~kappa(A)*1e-7 from f32/bf16 (the inverse has no cheap residual
    to iterate on — unlike solve, selected inversion has no refinement
    loop; use dtype=float64 when the diagonal must be tight).
    """
    dt = dtype or _compute_dtype(factors)
    n = fp.plan.n
    diag = np.zeros(n + 1, dtype=np.float64)               # slot n = padding
    P = None
    for lvl in range(fp.levels):
        W = fp.W[lvl]
        if lvl == 0:
            P, d = _selinv_root(W, dt, factors[0])
        elif lvl == fp.levels - 1:
            d = _selinv_step_last(W, dt, factors[lvl],
                                  jnp.asarray(fp.fwd_child[lvl]), P)
        else:
            P, d = _selinv_step(W, dt, factors[lvl],
                                jnp.asarray(fp.fwd_child[lvl]), P)
        ids = fp.front_rows[lvl][:, :W]                    # sentinel = n
        diag[ids.ravel()] = np.asarray(d, dtype=np.float64).ravel()
    return diag[:n]


def _locate_entries(fp: FrontalPlan, pr: np.ndarray, pc: np.ndarray):
    """Map permuted entry coordinates (i, j) to (level, slot, row_pos,
    col_pos) in that level's front blocks. Each entry is normalized so the
    COLUMN index belongs to the deeper separator; the row index must then
    appear in that separator's front (pivot or boundary) — i.e. the entry
    lies in the pattern of L + L^T + I. Raises ValueError otherwise (those
    entries are not computed by selected inversion; use solves)."""
    plan = fp.plan
    t = plan.tree
    # separator of each PERMUTED index (plan.sep_of_dof is original-indexed)
    sep_of = plan.sep_of_dof[plan.perm]

    out = []
    for k in range(len(pr)):
        i, j = int(pr[k]), int(pc[k])
        si, sj = int(sep_of[i]), int(sep_of[j])
        if t.level_of(si) > t.level_of(sj):                # deeper = column
            i, j, si, sj = j, i, sj, si                    # Phi is symmetric
        lvl = t.level_of(sj)
        slot = t.slot_of(sj)
        col_pos = j - int(plan.sep_offset[sj])
        if si == sj:
            row_pos = i - int(plan.sep_offset[sj])
        else:
            bnd = fp.front_rows[lvl][slot, fp.W[lvl]:]     # sorted, sentinel n
            p = int(np.searchsorted(bnd, i))
            if p >= len(bnd) or bnd[p] != i:
                raise ValueError(
                    f"entry ({pr[k]}, {pc[k]}) (permuted) is outside the "
                    f"factor pattern — selected inversion only computes "
                    f"Phi on pattern(L + L^T); solve unit vectors for "
                    f"arbitrary entries")
            row_pos = fp.W[lvl] + p
        out.append((lvl, slot, row_pos, col_pos, k))
    return out


def selinv_entries(fp: FrontalPlan, factors: Sequence[jax.Array],
                   pr: np.ndarray, pc: np.ndarray,
                   dtype: Optional[str] = None) -> np.ndarray:
    """Selected entries Phi[pr[k], pc[k]] of A^{-1} (PERMUTED coordinates),
    for entries within the factor pattern: same recursion as selinv_diag,
    reading requested values out of each level's front-inverse blocks
    (non-leaf levels directly from P = [[Phi_ss, -PX^T], [-PX, Pp]]; the
    leaf level from (Phi_ss, PX) without assembling P)."""
    dt = dtype or _compute_dtype(factors)
    located = _locate_entries(fp, np.atleast_1d(np.asarray(pr)),
                              np.atleast_1d(np.asarray(pc)))
    by_level = {}
    for lvl, slot, rp, cp, k in located:
        by_level.setdefault(lvl, []).append((slot, rp, cp, k))

    vals = np.empty(len(located), dtype=np.float64)
    if not located:
        return vals
    P = None
    max_lvl = max(by_level)                # recursion stops at the deepest
    for lvl in range(max_lvl + 1):         # requested level
        W = fp.W[lvl]
        terminal = lvl == max_lvl
        blocks = None
        if lvl == 0:
            P, _ = _selinv_root(W, dt, factors[0])
        elif terminal:                     # P is never consumed below here
            blocks = _selinv_step_noP(W, dt, factors[lvl],
                                      jnp.asarray(fp.fwd_child[lvl]), P)
        else:
            P, _ = _selinv_step(W, dt, factors[lvl],
                                jnp.asarray(fp.fwd_child[lvl]), P)
        want = by_level.get(lvl, ())
        if not want:
            continue
        slots = np.array([w[0] for w in want])
        rps = np.array([w[1] for w in want])
        cps = np.array([w[2] for w in want])
        ks = np.array([w[3] for w in want])
        if blocks is None:
            got = np.asarray(P[slots, rps, cps], dtype=np.float64)
        else:
            Phi_ss, PX = blocks
            got = np.empty(len(ks), dtype=np.float64)
            piv = rps < W
            if piv.any():
                got[piv] = np.asarray(
                    Phi_ss[slots[piv], rps[piv], cps[piv]], dtype=np.float64)
            if (~piv).any():
                got[~piv] = -np.asarray(
                    PX[slots[~piv], rps[~piv] - W, cps[~piv]],
                    dtype=np.float64)
        vals[ks] = got
    return vals
