"""Symmetric quasi-definite LDLᵀ: the signed-Cholesky factorization

    A = L̃ · S · L̃ᵀ,   S = diag(s),  s ∈ {+1, −1}ⁿ,  L̃ lower triangular

for saddle-point / KKT systems  [[H, Bᵀ], [B, −C]]  (H, C SPD) — the matrix
class of interior-point and equality-constrained least-squares methods.
Quasi-definite matrices factor STABLY WITHOUT PIVOTING under any symmetric
permutation (Vanderbei, "Symmetric quasi-definite matrices", SIAM J. Optim.
5(1), 1995), so the whole multifrontal machinery of the SPD path — nested
dissection, separator tree, fill plan, batched per-level kernels,
extend-add — applies unchanged: the Schur complement of a pivot block P is
still  B·P⁻¹·Bᵀ  regardless of P's signature, and the signature itself is
preserved by elimination.

This capability is BEYOND the reference (syamajala/cholesky is SPD-only:
its dpotrf, blas.rg:63-79, fails on any negative pivot); it rides the same
symbolic plan (`FrontalPlan`) and differs from `frontal.py` only in the
three sign touch-points:

  factor:  L̃d = signed Cholesky of the pivot block;
           X̃ = A₂₁·L̃d⁻ᵀ·S   (the true global off-diagonal factor block);
           Schur update U = X·S·Xᵀ = (X̃·S)·X̃ᵀ
  solve:   z = L̃⁻¹b;  w = S·z;  x = L̃⁻ᵀw    (one sign scale mid-solve)
  logdet:  log|det A| = 2·Σ log diag(L̃d),  sign(det A) = (−1)^{#negative}

Scope: frontal engine, in-core, monolithic program. Under a device mesh the
factor and solve programs are pure jit over slot-sharded fronts, so GSPMD
distributes them exactly like the SPD path (tests/test_parallel.py::
test_mesh_quasi_definite). f64 reaches the 1e-10 residual gate directly;
f32 factors pair with the host-driven iterative-refinement loop in
`api.SparseCholesky.solve`.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cholesky_tpu.numeric.frontal import (
    _CHOL_BS, _FPLAN_CACHE, FrontalPlan, _expand_child_updates_gathermm,
    _expand_child_updates_matmul, _tri_solve)

# ---------------------------------------------------------------------------
# Signed Cholesky of dense batched pivot blocks


def _signed_cholesky_scan(a: jax.Array, s: jax.Array) -> jax.Array:
    """Unblocked signed Cholesky of [B, W, W] with signature s [B, W]:
    returns lower L̃ with a = L̃·diag(s)·L̃ᵀ. Column recurrence as a
    lax.scan of masked rank-1 updates (vectorized over the batch; no
    dynamic slicing). A signature violation (s_j·d_j ≤ 0, i.e. the matrix
    is not quasi-definite with this signature) produces NaNs, matching the
    SPD path's LAPACK-info-free contract."""
    B, W, _ = a.shape
    eye = jnp.eye(W, dtype=a.dtype)
    below = (jnp.arange(W)[:, None] > jnp.arange(W)[None, :]).astype(a.dtype)

    def step(carry, j):
        A, L = carry
        ej = eye[j]                                       # one-hot [W]
        mask_b = below[:, j]                              # strictly below j
        d = jnp.einsum("bij,i,j->b", A, ej, ej)           # A[:, j, j]
        sj = jnp.einsum("bi,i->b", s.astype(a.dtype), ej)
        ljj = jnp.sqrt(sj * d)                            # NaN if violated
        col = jnp.einsum("bij,j->bi", A, ej)              # A[:, :, j]
        lcol = mask_b[None, :] * col / (sj * ljj)[:, None] \
            + ej[None, :] * ljj[:, None]
        A = A - sj[:, None, None] * lcol[:, :, None] * lcol[:, None, :]
        L = L + lcol[:, :, None] * ej[None, None, :]
        return (A, L), None

    (_, L), _ = lax.scan(step, (a, jnp.zeros_like(a)), jnp.arange(W))
    return L


def blocked_signed_cholesky(a: jax.Array, s: jax.Array) -> jax.Array:
    """Batched blocked right-looking signed Cholesky of [B, W, W] (lower
    triangle read): panels factor by the column scan, panel solves and
    trailing updates run as batched matmuls."""
    B, W, _ = a.shape
    if W <= _CHOL_BS:
        return _signed_cholesky_scan(a, s)
    out = jnp.zeros_like(a)
    for c0 in range(0, W, _CHOL_BS):
        w = min(_CHOL_BS, W - c0)
        sb = s[:, c0:c0 + w].astype(a.dtype)
        ld = _signed_cholesky_scan(a[:, c0:c0 + w, c0:c0 + w], sb)
        out = out.at[:, c0:c0 + w, c0:c0 + w].set(ld)
        if c0 + w < W:
            pan = a[:, c0 + w:, c0:c0 + w]
            x = _tri_solve(ld, pan, left_side=False, lower=True,
                           transpose_a=True)                 # A21·L̃11⁻ᵀ
            xt = x * sb[:, None, :]                          # the true L̃21
            out = out.at[:, c0 + w:, c0:c0 + w].set(xt)
            upd = jnp.einsum("bik,bjk->bij", x, xt,
                             preferred_element_type=x.dtype)  # X·S·Xᵀ
            a = a.at[:, c0 + w:, c0 + w:].add(-upd)
    return out


# ---------------------------------------------------------------------------
# Per-level signature slabs


def sign_slabs(fp: FrontalPlan, signs: np.ndarray) -> List[np.ndarray]:
    """Per-level pivot signatures [B, W] from the ORIGINAL-order sign
    vector [n]: permuted, grouped by separator slot, padding gets +1 (the
    padded unit diagonal factors as +1·1·1)."""
    sp = np.concatenate([np.asarray(signs, dtype=np.float64)[fp.plan.perm],
                         [1.0]])                       # sentinel id n -> +1
    return [sp[fp.front_rows[lvl][:, :fp.W[lvl]]].astype(np.float32)
            for lvl in range(fp.levels)]


# ---------------------------------------------------------------------------
# Factorization


def _factor_level_qd(fp: FrontalPlan, lvl: int, piv, U, s_lvl):
    """One level: mirror of frontal._factor_level's baseline square-front
    branch with the three sign touch-points (module docstring)."""
    Wl, Fl = fp.W[lvl], fp.F[lvl]
    B = piv.shape[0]
    s_lvl = s_lvl.astype(piv.dtype)
    full = jnp.concatenate(
        [piv, jnp.zeros((B, Fl, Fl - Wl), piv.dtype)], axis=2)
    if U is not None and U.shape[1] > 0:
        if B >= 4:
            E = _expand_child_updates_gathermm(fp, U, lvl + 1)
        else:
            E = _expand_child_updates_matmul(fp, U, lvl + 1)
        full = full - E.astype(full.dtype)
    Ld = blocked_signed_cholesky(full[:, :Wl, :Wl], s_lvl)
    if Fl == Wl:
        return Ld, (None if lvl == 0 else jnp.zeros((B, 0, 0), piv.dtype))
    X = _tri_solve(Ld, full[:, Wl:, :Wl], left_side=False, lower=True,
                   transpose_a=True)                     # A21·L̃d⁻ᵀ
    Xt = X * s_lvl[:, None, :]                           # true L̃21 = X·S
    fac = jnp.concatenate([Ld, Xt], axis=1)
    if lvl == 0:
        return fac, None
    U2 = (jnp.einsum("bik,bjk->bij", X, Xt,
                     preferred_element_type=X.dtype)     # X·S·Xᵀ
          - full[:, Wl:, Wl:])
    return fac, U2


@functools.partial(jax.jit, static_argnums=(0,))
def _factor_qd_jit(key, fronts, s_lvls):
    fp = _FPLAN_CACHE[key]
    out: List[jax.Array] = [None] * fp.levels
    U = None
    for lvl in range(fp.levels - 1, -1, -1):
        out[lvl], U = _factor_level_qd(fp, lvl, fronts[lvl], U, s_lvls[lvl])
    return tuple(out)


def factor_qd(fp: FrontalPlan, fronts: Sequence, signs: np.ndarray
              ) -> Tuple[jax.Array, ...]:
    """Factor the assembled fronts of a quasi-definite matrix with
    signature `signs` ([n], ±1, original dof order). Returns per-level
    [B, F, W] factors: rows :W the signed-Cholesky L̃d, rows W: the true
    off-diagonal factor block L̃21."""
    sl = tuple(jnp.asarray(s) for s in sign_slabs(fp, signs))
    return _factor_qd_jit(fp.key(), tuple(jnp.asarray(f) for f in fronts), sl)


# ---------------------------------------------------------------------------
# Solve


@functools.partial(jax.jit, static_argnums=(0,))
def _solve_qd_jit(key, factors, s_lvls, b_perm):
    fp = _FPLAN_CACHE[key]
    n = fp.plan.n
    levels = fp.levels
    bg = jnp.concatenate([b_perm, jnp.zeros((1,), b_perm.dtype)])
    piv_idx = [jnp.asarray(fp.front_rows[l][:, :fp.W[l]])
               for l in range(levels)]
    bnd_idx = [jnp.asarray(fp.front_rows[l][:, fp.W[l]:])
               for l in range(levels)]
    # forward: z = L̃⁻¹ b
    for lvl in range(levels - 1, -1, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        Ld = factors[lvl][:, :Wl, :].astype(bg.dtype)
        y = _tri_solve(Ld, bg[piv_idx[lvl]][..., None],
                       left_side=True, lower=True)[..., 0]
        bg = bg.at[piv_idx[lvl]].set(y, mode="drop")
        if Fl > Wl:
            Xt = factors[lvl][:, Wl:, :].astype(y.dtype)
            bg = bg.at[bnd_idx[lvl]].add(
                -jnp.einsum("bij,bj->bi", Xt, y,
                            preferred_element_type=y.dtype))
    # backward: x = L̃⁻ᵀ (S z)
    for lvl in range(levels):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        rhs = s_lvls[lvl].astype(bg.dtype) * bg[piv_idx[lvl]]
        if Fl > Wl:
            Xt = factors[lvl][:, Wl:, :].astype(rhs.dtype)
            z = bg[bnd_idx[lvl]]
            rhs = rhs - jnp.einsum("bij,bi->bj", Xt, z,
                                   preferred_element_type=z.dtype)
        Ld = factors[lvl][:, :Wl, :].astype(rhs.dtype)
        x = _tri_solve(Ld, rhs[..., None], left_side=True, lower=True,
                       transpose_a=True)[..., 0]
        bg = bg.at[piv_idx[lvl]].set(x)
    return bg[:n]


def solve_qd(fp: FrontalPlan, factors: Sequence, signs: np.ndarray,
             b_perm) -> jax.Array:
    """x = A⁻¹b through the signed factor (b and x in PERMUTED order)."""
    sl = tuple(jnp.asarray(s) for s in sign_slabs(fp, signs))
    return _solve_qd_jit(fp.key(), tuple(factors), sl, jnp.asarray(b_perm))


def logdet_qd(fp: FrontalPlan, factors: Sequence, signs: np.ndarray
              ) -> Tuple[int, float]:
    """(sign, log|det A|) from the signed factor: |det A| = Π diag(L̃d)²
    (padded diagonal 1s contribute 0), sign = (−1)^#negative."""
    total = 0.0
    for lvl in range(fp.levels):
        Wl = fp.W[lvl]
        d = jnp.diagonal(factors[lvl][:, :Wl, :Wl], axis1=1, axis2=2)
        total += 2.0 * float(jnp.sum(jnp.log(d.astype(jnp.float64)
                                             if jax.config.x64_enabled
                                             else d.astype(jnp.float32))))
    neg = int(np.sum(np.asarray(signs) < 0))
    return (-1) ** neg, total


def inertia(signs: np.ndarray) -> Tuple[int, int, int]:
    """(n₊, n₋, n₀) of a successfully factored quasi-definite matrix: the
    signature IS the inertia (Sylvester's law through L̃·S·L̃ᵀ)."""
    s = np.asarray(signs)
    return int(np.sum(s > 0)), int(np.sum(s < 0)), 0
