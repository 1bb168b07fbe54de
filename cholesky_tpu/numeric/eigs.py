"""Spectral analysis through the factor: Lanczos eigenpairs and a tight κ₂.

The reference solver (syamajala/cholesky) has no eigen capability — but a
completed sparse Cholesky factorization is exactly the engine a shift-invert
eigensolver needs (ARPACK's ``sigma=0`` mode is classically driven by a
CHOLMOD/direct factorization). This module supplies that companion:

- **Smallest eigenpairs** come from Lanczos on the *inverse* operator
  ``v ↦ A⁻¹v``, where every application is one forward/backward triangular
  solve pair through the already-computed factor (mixed-precision refined, so
  an fp32 factor still yields f64-accurate Ritz pairs). Convergence is
  governed by the gaps of 1/λ, which are wide exactly where A's smallest
  eigenvalues cluster — the regime where plain Lanczos on A stalls.
- **Largest eigenpairs** use plain Lanczos on the sparse matvec (no factor
  needed beyond the symmetrized CSR the solver already holds).
- ``cond2`` pairs the two for a converged κ₂(A) = λmax/λmin, a strictly
  tighter answer than the power-iteration ``condest`` estimate.

All orchestration is host-side f64 NumPy on [n]-vectors (the O(n·m) Lanczos
bookkeeping is noise next to the solves); the heavy work per step — the
triangular solves — runs on device through ``SparseCholesky.solve``.

Algorithm: m-step Lanczos with full two-pass reorthogonalization (robust to
the slight nonsymmetry of inexact solves), Rayleigh–Ritz on the tridiagonal,
explicit residual check ‖Ax−λx‖ ≤ tol·‖A‖₁ against the true matrix, and
basis-doubling restarts until converged.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def _lanczos(apply: Callable[[np.ndarray, np.ndarray], np.ndarray], n: int,
             m: int, seed: int = 0,
             minner: Callable[[np.ndarray], np.ndarray] | None = None,
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """m-step Lanczos with full reorthogonalization in the M-inner product.

    `apply(q, Mq)` applies the operator (receives both the basis vector and
    its M-image so a generalized shift-invert step K⁻¹·M·q costs no extra
    matvec); `minner` maps v ↦ M·v (identity when None — standard Lanczos).
    Returns (V, alpha, beta) with V [n, j] M-orthonormal and
    T = tridiag(beta, alpha, beta) the operator's projection; stops early on
    breakdown (invariant subspace found)."""
    mm = minner if minner is not None else (lambda v: v)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(n)
    mq = np.asarray(mm(q), dtype=np.float64).reshape(n)
    q = q / np.sqrt(q @ mq)
    V = np.zeros((n, m))
    MV = np.zeros((n, m))    # M·V cached so reorth needs no extra matvecs
    alpha = np.zeros(m)
    beta = np.zeros(max(m - 1, 0))
    for j in range(m):
        V[:, j] = q
        MV[:, j] = np.asarray(mm(q), dtype=np.float64).reshape(n)
        w = np.asarray(apply(q, MV[:, j]), dtype=np.float64).reshape(n)
        a = float(w @ MV[:, j])
        alpha[j] = a
        w = w - a * q
        if j > 0:
            w = w - beta[j - 1] * V[:, j - 1]
        # full reorthogonalization, two passes (classical Gram-Schmidt
        # twice): keeps the basis M-orthonormal despite inexact solves
        for _ in range(2):
            w -= V[:, :j + 1] @ (MV[:, :j + 1].T @ w)
        if j + 1 == m:
            break
        mw = np.asarray(mm(w), dtype=np.float64).reshape(n)
        b2 = float(w @ mw)
        if b2 <= (1e-13 * max(1.0, abs(a))) ** 2:
            return V[:, :j + 1], alpha[:j + 1], beta[:j]
        b = np.sqrt(b2)
        beta[j] = b
        q = w / b
    return V, alpha, beta


def _ritz(V, alpha, beta):
    j = len(alpha)
    T = np.diag(alpha)
    if j > 1:
        T += np.diag(beta[:j - 1], 1) + np.diag(beta[:j - 1], -1)
    theta, Y = np.linalg.eigh(T)
    return theta, V @ Y


def eigsh(solver, k: int = 6, which: str = "smallest", tol: float = 1e-9,
          m: int | None = None, seed: int = 0, solve_tol: float = 1e-11,
          max_restarts: int = 4, M=None) -> Tuple[np.ndarray, np.ndarray]:
    """k extremal eigenpairs of the solver's matrix A, or of the generalized
    pencil (A, M) when a mass matrix M is given.

    which='smallest': Lanczos on A⁻¹ (one refined solve per step through the
    factor — shift-invert at σ=0; SPD only). which='largest': Lanczos on the
    sparse matvec (any symmetric matrix). Returns (w, V): eigenvalues
    ascending [k], orthonormal eigenvectors [n, k], converged to
    ‖Av−λv‖ ≤ tol·‖A‖₁ (columns of V have unit norm).

    M (scipy sparse / dense, full symmetric, SPD): solve A·x = λ·M·x
    instead — the FEM modal problem K·x = ω²·M·x. Requires
    which='smallest' (the physical modes). Lanczos then runs on K⁻¹M in the
    M-inner product; returned eigenvectors are **mass-normalized**
    (VᵀMV = I), the FEM convention, and convergence is gated on
    ‖Av−λMv‖ ≤ tol·(‖A‖₁+|λ|‖M‖₁).

    Raises RuntimeError if the residual target is not met after
    `max_restarts` basis-doubling restarts (pathological clustering; loosen
    `tol` or pass a larger starting basis `m`).
    """
    if which not in ("smallest", "largest"):
        raise ValueError(f"which must be 'smallest' or 'largest', got {which!r}")
    n = int(solver.plan.n)
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    csr = solver._matrix_csr()
    anorm = float(np.abs(csr).sum(axis=1).max())   # ‖A‖₁ = ‖A‖∞ (symmetric)
    mcsr = minner = None
    mnorm = 0.0
    if M is not None:
        if which != "smallest":
            raise ValueError(
                "generalized eigsh (mass matrix M) supports which='smallest'"
                " only — largest would need a factorization of M")
        import scipy.sparse

        mcsr = scipy.sparse.csr_matrix(M)
        if mcsr.shape != (n, n):
            raise ValueError(f"M must be [{n}, {n}], got {mcsr.shape}")
        mnorm = float(np.abs(mcsr).sum(axis=1).max())

        def minner(v):
            return mcsr @ v

        def apply(q, mq):             # shift-invert step: K⁻¹·(M·q)
            return solver.solve(mq, tol=solve_tol)
    elif which == "smallest":
        def apply(q, mq):
            return solver.solve(q, tol=solve_tol)
    else:
        def apply(q, mq):
            return csr @ q

    mj = int(m) if m is not None else min(n, max(2 * k + 16, 32))
    mj = max(mj, k + 2) if n > k + 2 else n
    res = None
    for _ in range(max_restarts):
        V, a, b = _lanczos(apply, n, min(mj, n), seed, minner=minner)
        theta, X = _ritz(V, a, b)
        # the wanted pairs sit at the top of the Ritz spectrum in every
        # mode: (K⁻¹M)'s and A⁻¹'s largest θ are the pencil's/A's smallest
        # λ; A's largest θ are its largest λ
        idx = np.argsort(theta)[::-1][:k]
        theta_k = theta[idx]
        if which == "smallest":
            if np.any(theta_k <= 0):
                raise RuntimeError(
                    "shift-invert Lanczos produced a non-positive Ritz "
                    "value - the matrix/pencil is not positive definite to "
                    "solver accuracy")
            lam = 1.0 / theta_k
        else:
            lam = theta_k
        Xk = X[:, idx]
        if mcsr is not None:
            # mass-normalize: xᵀMx = 1 (the Lanczos basis is M-orthonormal
            # already; renormalize to clean up reorthogonalization drift)
            mnrm = np.sqrt(np.sum(Xk * (mcsr @ Xk), axis=0))
            Xk = Xk / mnrm
            res = np.linalg.norm(csr @ Xk - (mcsr @ Xk) * lam, axis=0)
            gate = tol * (anorm + np.abs(lam) * mnorm)
        else:
            Xk = Xk / np.linalg.norm(Xk, axis=0, keepdims=True)
            res = np.linalg.norm(csr @ Xk - Xk * lam, axis=0)
            gate = tol * anorm
        if np.all(res <= gate) or mj >= n:
            order = np.argsort(lam)
            return lam[order], Xk[:, order]
        mj = min(n, 2 * mj)
    raise RuntimeError(
        f"eigsh({which}) did not converge: worst residual "
        f"{float(res.max()):.3e} > gate {float(np.max(gate)):.3e} after "
        f"{max_restarts} restarts (final basis {mj})")


def cond2(solver, tol: float = 1e-8, seed: int = 0) -> float:
    """κ₂(A) = λmax(A)/λmin(A) with both extremes converged by Lanczos —
    the tight version of the power-iteration `condest` estimate."""
    lo, _ = eigsh(solver, k=1, which="smallest", tol=tol, seed=seed)
    hi, _ = eigsh(solver, k=1, which="largest", tol=tol, seed=seed)
    return float(hi[0] / lo[0])
