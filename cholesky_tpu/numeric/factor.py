"""Batched dense-ancestor-path Cholesky — the ORACLE engine.

This module is NOT the production numeric path (that is numeric/frontal.py,
the exact-boundary multifrontal engine); it is the verification/teaching
engine behind cholesky_tpu.verify.oracle.PanelsOracle. Its value is that it
is the most literal batched translation of the reference's per-level task
schedule
(mmat.rg:1211-1358): instead of one Legion leaf task per block per BLAS call
(fused_dpotrf/fused_dtrsm/fused_dsyrk/fused_dgemm, blas.rg:293-503), each tree
level is processed by THREE batched dense kernels over the stacked panel
array — which is exactly the work batched matrix units want:

  1. POTRF   : batched Cholesky of the [B, S, S] diagonal blocks
               (== the reference's phase-1 index launch, mmat.rg:1240-1245)
  2. TRSM    : batched right triangular solve of the [B, H-S, S] sub-diagonal
               panel against L^T (phase 2, mmat.rg:1259-1274; the reference's
               cblas_dtrsm Right/Lower/Trans/NonUnit, blas.rg:99)
  3. SYRK    : ONE batched [B, H-S, S] x [B, S, H-S] matmul building the whole
               update (Schur) matrix U = X X^T per separator, then
               segment-summed extend-add slabs into every ancestor level's
               panels (phase 3, mmat.rg:1293-1346; alpha=-1, beta=1 as in
               blas.rg:139,187).

All shapes are static; the per-level Python loop unrolls into a single XLA
program. Sibling contributions heading to the same ancestor are combined with
`segment_sum` over the slot axis (slot >> level-delta is the ancestor slot —
the heap arithmetic of mmat.rg:1265-1270), which XLA lowers to efficient
reductions and, under sharding, to collectives.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from cholesky_tpu.symbolic.plan import SolvePlan


def _level_meta(plan: SolvePlan):
    """Static per-level geometry consumed by the traced code."""
    return (tuple(int(s) for s in plan.S),
            tuple(int(h) for h in plan.H),
            tuple(tuple(int(x) for x in row) for row in plan.row_off),
            tuple(tuple(int(x) for x in row) for row in plan.u_off))


def factor_panels(plan: SolvePlan, panels: Sequence[jax.Array]) -> Tuple[jax.Array, ...]:
    """Factor the assembled panels in place (functionally); returns panels
    holding L: diag blocks lower-triangular, sub-diagonal blocks solved."""
    S, H, row_off, u_off = _level_meta(plan)
    levels = plan.levels
    panels = list(panels)

    for lvl in range(levels - 1, -1, -1):
        W = S[lvl]
        A = panels[lvl]
        D = A[:, :W, :]
        Ld = lax.linalg.cholesky(D, symmetrize_input=False)
        if H[lvl] > W:
            X = lax.linalg.triangular_solve(
                Ld, A[:, W:, :], left_side=False, lower=True, transpose_a=True)
            A = jnp.concatenate([Ld, X], axis=1)
        else:
            A = Ld
            X = None
        panels[lvl] = A

        if lvl == 0 or X is None:
            continue

        # Schur update. Key layout property: a panel's rows are ordered
        # [own, parent, grandparent, ..., root] and X's rows are ordered
        # [parent, grandparent, ..., root], so for a target ancestor at
        # level lam the contribution X[:, u_off(lam):, :] @ X_lam^T is a
        # [B, H(lam), S(lam)] block that aligns with the ENTIRE target panel
        # contiguously — one batched matmul + segment-sum + subtract per
        # ancestor level, no slicing or scatter. The full update matrix
        # X X^T is never materialized and strictly-upper block products are
        # never computed (the SYRK saving, blas.rg:187).
        slots = jnp.arange(1 << lvl)
        for lam in range(lvl - 1, -1, -1):        # target ancestor level
            co = u_off[lvl][lam]
            Xp = X[:, co:co + S[lam], :]
            tail = X[:, co:, :]                    # rows for levels lam..0
            contrib = jnp.einsum("bik,bjk->bij", tail, Xp,
                                 preferred_element_type=X.dtype)
            seg = slots >> (lvl - lam)
            contrib = jax.ops.segment_sum(
                contrib, seg, num_segments=1 << lam, indices_are_sorted=True)
            panels[lam] = panels[lam] - contrib

    return tuple(panels)


def solve_forward(plan: SolvePlan, panels: Sequence[jax.Array],
                  b: Sequence[jax.Array]) -> Tuple[jax.Array, ...]:
    """Forward substitution L y = b, level-scheduled leaves-to-root
    (mmat.rg:1395-1435: dtrsv Lower/NoTrans then dgemv alpha=-1 into ancestors)."""
    S, H, _, u_off = _level_meta(plan)
    levels = plan.levels
    b = list(b)
    for lvl in range(levels - 1, -1, -1):
        W = S[lvl]
        A = panels[lvl]
        Ld = A[:, :W, :]
        y = lax.linalg.triangular_solve(
            Ld, b[lvl][..., None], left_side=True, lower=True)[..., 0]
        b[lvl] = y
        if lvl == 0 or H[lvl] == W:
            continue
        contrib_all = jnp.einsum("bij,bj->bi", A[:, W:, :], y,
                                 preferred_element_type=y.dtype)
        slots = jnp.arange(1 << lvl)
        for lam in range(lvl - 1, -1, -1):
            o = u_off[lvl][lam]
            seg = slots >> (lvl - lam)
            b[lam] = b[lam] - jax.ops.segment_sum(
                contrib_all[:, o:o + S[lam]], seg,
                num_segments=1 << lam, indices_are_sorted=True)
    return tuple(b)


def solve_backward(plan: SolvePlan, panels: Sequence[jax.Array],
                   y: Sequence[jax.Array]) -> Tuple[jax.Array, ...]:
    """Backward substitution L^T x = y, root-to-leaves
    (mmat.rg:1438-1479: dtrsv Lower/Trans then transposed dgemv fan-out —
    here each separator *gathers* its ancestors' solutions instead, turning
    the reference's 2^(lvl-par_lvl) fan-out writes into one batched gather)."""
    S, H, _, u_off = _level_meta(plan)
    levels = plan.levels
    x: List[jax.Array] = [None] * levels
    for lvl in range(levels):
        W = S[lvl]
        A = panels[lvl]
        rhs = y[lvl]
        if lvl > 0 and H[lvl] > W:
            slots = jnp.arange(1 << lvl)
            parts = []
            for lam in range(lvl - 1, -1, -1):  # matches panel row order
                parts.append(x[lam][slots >> (lvl - lam)])
            z = jnp.concatenate(parts, axis=1)          # [B, H-W]
            rhs = rhs - jnp.einsum("bij,bi->bj", A[:, W:, :], z,
                                   preferred_element_type=rhs.dtype)
        x[lvl] = lax.linalg.triangular_solve(
            A[:, :W, :], rhs[..., None], left_side=True, lower=True,
            transpose_a=True)[..., 0]
    return tuple(x)


@functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
def _factor_jit(meta, panels):
    plan = _PLAN_CACHE[meta]
    return factor_panels(plan, panels)


@functools.partial(jax.jit, static_argnums=0)
def _solve_jit(meta, panels, b):
    plan = _PLAN_CACHE[meta]
    y = solve_forward(plan, panels, b)
    return solve_backward(plan, panels, y)


@functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
def _factor_solve_jit(meta, panels, b):
    plan = _PLAN_CACHE[meta]
    panels = factor_panels(plan, panels)
    y = solve_forward(plan, panels, b)
    return panels, solve_backward(plan, panels, y)


# jit caches key on a tiny hashable geometry summary; the plan itself is
# host-side and unhashable (holds numpy arrays).
_PLAN_CACHE = {}


def _plan_key(plan: SolvePlan):
    key = (plan.levels, tuple(int(s) for s in plan.S), tuple(int(h) for h in plan.H))
    _PLAN_CACHE[key] = plan
    return key


def factor(plan: SolvePlan, panels) -> Tuple[jax.Array, ...]:
    """JIT-compiled factorization entry point."""
    return _factor_jit(_plan_key(plan), tuple(jnp.asarray(p) for p in panels))


def solve(plan: SolvePlan, panels, b) -> Tuple[jax.Array, ...]:
    """JIT-compiled forward+backward solve with an already-factored panel set."""
    return _solve_jit(_plan_key(plan), tuple(panels), tuple(jnp.asarray(x) for x in b))


def factor_and_solve(plan: SolvePlan, panels, b):
    return _factor_solve_jit(_plan_key(plan),
                             tuple(jnp.asarray(p) for p in panels),
                             tuple(jnp.asarray(x) for x in b))
