"""Device-resident mixed-precision iterative refinement with a double-float
(f32-pair) compensated sparse matvec.

The refinement loop x += (LL^T)^{-1}(b - Ax) needs residuals accurate to
~1e-14 relative to reach the 1e-10 residual contract from an fp32 factor.
This module computes the residual in double-float arithmetic: every value
is an (hi, lo) pair of f32 with hi+lo ~ 49-bit precision; products use
Dekker's TwoProd (exact via split multiplies, no FMA needed) and sums use
Knuth's TwoSum — all branch-free f32 elementwise ops. It was written for a
device whose f64 was emulated; on a card with native f64 it is kept while
it holds its accuracy there (tests/test_gpu.py compares it with an f64
matvec on the card), and a plain f64 residual is the alternative to
measure against it.

The matrix is stored in ELL form ([n, K] column indices + f32 hi/lo value
planes, rows padded with a sentinel column n -> x=0), so the matvec is K
gathers + K compensated multiply-accumulates — no f64 op anywhere in the
loop. The whole refinement runs in one XLA while_loop: zero host round
trips (the host-loop variant pays a device->host transfer and a host CSR
matvec per iteration).

Equivalent of the reference's solve correctness contract (verify.py:290-302)
at the tighter BASELINE 1e-10 residual gate; the reference itself factors in
f64 and needs no refinement.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_SPLIT = np.float32(4097.0)        # Dekker split constant for f32: 2^12 + 1

# beyond this max row degree the ELL form is too padded to be worthwhile;
# callers fall back to the f64 segment-sum path
ELL_MAX_K = 96

_HIST_CAP = 128     # trace_hist buffer size (max recorded iterations)

_BS_CACHE = {}      # (fp_key, banded, rhs digest) -> resident [2, n] planes

_ELL_DEV_CACHE = {}  # (fp_key, banded) -> (host tuple ref, device planes)


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly without an FMA, provided the
    compiler does not contract _split's multiply-subtract into one."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def split_f64(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split an f64 array into an (hi, lo) f32 pair with hi+lo == x64 to
    f32(lo) rounding (~2^-49 relative)."""
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def build_ell(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """Pack a symmetrized COO matrix into ELL planes for the double-float
    matvec: (idx [n, K] int32 with sentinel n, a_hi [n, K] f32, a_lo [n, K]
    f32). Returns None when the max row degree exceeds ELL_MAX_K."""
    counts = np.bincount(rows, minlength=n)
    K = int(counts.max()) if len(counts) else 0
    if K > ELL_MAX_K:
        return None
    order = np.argsort(rows, kind="stable")
    slot = np.arange(len(rows)) - np.concatenate(
        [[0], np.cumsum(counts)])[rows[order]]
    idx = np.full((n, K), n, dtype=np.int32)
    a64 = np.zeros((n, K), dtype=np.float64)
    idx[rows[order], slot] = cols[order].astype(np.int32)
    a64[rows[order], slot] = vals[order]
    a_hi, a_lo = split_f64(a64)
    return idx, a_hi, a_lo


def df_matvec(idx, a_hi, a_lo, x_hi, x_lo):
    """y = A @ x in double-float. One 2-D gather per x plane fetches all
    [n, K] operands at once (instead of K separate 1-D gathers), then the
    products and the TwoSum accumulation fold are pure elementwise work. x planes are length n+1 with a trailing zero (the
    sentinel slot)."""
    K = idx.shape[1]
    if K == 0:
        z = jnp.zeros(idx.shape[0], jnp.float32)
        return z, z
    xg = jnp.stack([x_hi, x_lo], axis=-1)[idx]           # ONE [n, K, 2] gather
    xh = xg[..., 0]
    xl = xg[..., 1]
    p, pe = _two_prod(a_hi, xh)
    # cross terms are O(eps * |a x|); their own rounding is O(eps^2)
    cross = a_hi * xl + a_lo * xh
    e_all = pe + cross
    s = p[:, 0]
    c = e_all[:, 0]
    for k in range(1, K):
        s, se = _two_sum(s, p[:, k])
        c = c + (se + e_all[:, k])
    return s, c


def _df_add(a_hi, a_lo, b_hi, b_lo):
    """(a) + (b) in double-float with renormalization."""
    s, e = _two_sum(a_hi, b_hi)
    lo = e + (a_lo + b_lo)
    hi, lo = _two_sum(s, lo)
    return hi, lo


def pad_ell(fp, ell):
    """Relabel ELL planes of the symmetrized PERMUTED matrix into frontal's
    banded padded basis (frontal._banded_maps): rows reordered to padded
    positions (pad rows all-sentinel/zero), column ids relabeled, one extra
    all-sentinel row n_pad so the refinement loop's state vectors carry
    their zero slot inline. One-time per factorization — cache the result
    (api caches it next to the permuted ELL)."""
    from cholesky_tpu.numeric import frontal

    idx, a_hi, a_lo = ell
    n, K = idx.shape
    n_pad, _, inv_map, pad_of, _ = frontal._banded_maps(fp)
    pad_ext = np.concatenate([pad_of, [n_pad]]).astype(np.int32)  # sent n
    idx_p = np.full((n_pad + 1, K), n_pad, dtype=np.int32)
    a_hi_p = np.zeros((n_pad + 1, K), dtype=np.float32)
    a_lo_p = np.zeros((n_pad + 1, K), dtype=np.float32)
    real = inv_map < n                                 # [n_pad]
    src = inv_map[real]
    rows = np.nonzero(real)[0]
    idx_p[rows] = pad_ext[idx[src]]
    a_hi_p[rows] = a_hi[src]
    a_lo_p[rows] = a_lo[src]
    return idx_p, a_hi_p, a_lo_p


def solve_refined_df(fp, factors: Sequence, b64: np.ndarray, ell,
                     tol: float = 1e-12, max_iter: int = 40,
                     inv_pivots=None, trace_hist: bool = False,
                     ell_pad=None):
    """Device-resident IR: f32 triangular solves + double-float residuals in
    one while_loop. `b64` is the PERMUTED f64 RHS; `ell` from build_ell on
    the symmetrized PERMUTED matrix; `inv_pivots` optional precomputed pivot
    inverses (frontal.invert_pivots) replacing the latency-bound vector
    triangular solves with batched matvecs.

    With inv_pivots the WHOLE loop — solves, residual matvec, state — runs
    in frontal's banded padded basis: pivot values are static slices of the
    work vector and the per-solve entry/exit relabel gathers vanish; the
    only remaining indexed ops are the boundary
    extend-add and the ELL gather. `ell_pad` optionally supplies the
    pad_ell() planes (api caches them); computed here if absent.

    Returns (x_perm64, iters, rn_rel): the f64 solution in permuted order,
    the iteration count, and the loop's own (double-float) estimate of the
    final RELATIVE residual. Everything comes back in ONE [2, n+1] packed
    device->host transfer. With trace_hist=True a 4th element is appended: the
    per-iteration residual-norm history (diagnostics; extra transfer)."""
    from cholesky_tpu.numeric import frontal

    b64 = np.asarray(b64, np.float64)
    bnorm = float(np.linalg.norm(b64))
    inv = tuple(inv_pivots) if inv_pivots is not None else None
    banded = inv is not None
    # inner triangular-solve engine: the XLA banded chain when pivot
    # inverses are supplied, the permuted-basis frontal_solve otherwise.
    inner = "banded" if banded else "plain"
    if banded:
        if ell_pad is None:
            ell_pad = pad_ell(fp, ell)
        idx, a_hi, a_lo = ell_pad
        _, _, inv_map, pad_of, _ = frontal._banded_maps(fp)
    else:
        idx, a_hi, a_lo = ell
        pad_of = None
    if trace_hist:
        # the history buffer is a fixed _HIST_CAP entries; clamp so the
        # while_loop can never scatter out of bounds (silently dropped
        # under jit)
        max_iter = min(int(max_iter), _HIST_CAP - 1)
    # Content-keyed device cache for the packed RHS planes: repeat solves
    # against the same right-hand side — time stepping, benchmarking,
    # refinement ladders — skip the [2, n_pad] upload and the host-side
    # relabel/split. Keyed by (plan, rhs bytes); whether it still pays on
    # a locally attached card awaits measurement. Tiny LRU so long-lived
    # solvers don't pin stale vectors.
    import hashlib

    bkey = (fp.key(), banded,
            hashlib.blake2b(b64.tobytes(), digest_size=16).digest())
    bs = _BS_CACHE.get(bkey)
    if bs is None:
        if banded:
            n = b64.shape[0]
            b_ext = np.concatenate([b64, [0.0]])
            b_pad = b_ext[np.concatenate([inv_map, [n]])]   # sentinel 0
            b_hi, b_lo = split_f64(b_pad)
        else:
            b_hi, b_lo = split_f64(b64)
        bs = jnp.asarray(np.stack([b_hi, b_lo]))      # ONE upload
        _BS_CACHE[bkey] = bs
        while len(_BS_CACHE) > 8:
            _BS_CACHE.pop(next(iter(_BS_CACHE)))
    # Device-resident ELL planes, identity-cached per plan: jnp.asarray on
    # the host planes would re-upload ~23 MB PER SOLVE at 50^3. The api
    # caches the host tuple, so identity is a stable key; holding the host
    # ref in the entry keeps id() collisions impossible.
    ekey = (fp.key(), banded)
    hit = _ELL_DEV_CACHE.get(ekey)
    if hit is not None and hit[0] is (ell_pad if banded else ell):
        idx_d, a_hi_d, a_lo_d = hit[1]
    else:
        idx_d, a_hi_d, a_lo_d = (jnp.asarray(idx), jnp.asarray(a_hi),
                                 jnp.asarray(a_lo))
        _ELL_DEV_CACHE[ekey] = ((ell_pad if banded else ell),
                                (idx_d, a_hi_d, a_lo_d))
        while len(_ELL_DEV_CACHE) > 8:
            _ELL_DEV_CACHE.pop(next(iter(_ELL_DEV_CACHE)))
    import os

    demote = os.environ.get("CHOLESKY_TPU_APPLY_PRECISION",
                            "one_pass") != "ambient"
    # device-side padded->permuted gather: the result comes back [2, n+1]
    # instead of [2, n_pad+1] (one less host gather, a smaller readback)
    pad_of_d = None
    if banded:
        pkey = (fp.key(), "pad_of")
        pad_of_d = _ELL_DEV_CACHE.get(pkey)
        if pad_of_d is None:
            pad_of_d = jnp.asarray(pad_of.astype(np.int32))
            _ELL_DEV_CACHE[pkey] = pad_of_d
    out = _run(fp.key(), tuple(factors), inv, idx_d, a_hi_d, a_lo_d,
               bs, np.int32(max_iter), np.float32(tol * bnorm),
               bool(trace_hist), inner, demote, pad_of_d)
    # the np.asarray readback is the sync point
    if trace_hist:
        out, hist = out
    arr = np.asarray(out, np.float64)                 # ONE readback
    x = arr[0, :-1] + arr[1, :-1]
    iters = int(arr[1, -1])
    rn_rel = float(arr[0, -1]) / bnorm if bnorm else 0.0
    if trace_hist:
        return x, iters, rn_rel, np.asarray(hist)
    return x, iters, rn_rel


def _residual_df(idx, a_hi, a_lo, b_hi, b_lo, x_hi, x_lo):
    xh = jnp.concatenate([x_hi, jnp.zeros(1, jnp.float32)])
    xl = jnp.concatenate([x_lo, jnp.zeros(1, jnp.float32)])
    y_hi, y_lo = df_matvec(idx, a_hi, a_lo, xh, xl)
    return _df_add(b_hi, b_lo, -y_hi, -y_lo)


@functools.partial(jax.jit, static_argnums=(0, 9, 10, 11))
def _run(key, factors, inv_pivots, idx, a_hi, a_lo, bs, max_iter,
         tol_abs, trace_hist=False, inner="plain", demote_apply=True,
         pad_of=None):
    """max_iter is a TRACED operand (while_loop bound), not static — one
    compiled program serves every iteration budget (large programs take
    minutes to compile, so program-count hygiene matters). inner selects the
    triangular-solve engine: "plain" = permuted-basis frontal_solve;
    "banded" = frontal's padded basis (every operand is an
    [n_pad + 1] vector whose sentinel slot stays 0 by construction,
    pad_ell planes; no relabel gathers or concats in the loop body),
    solved by the XLA banded level chain."""
    from cholesky_tpu.numeric import frontal

    fp = frontal._FPLAN_CACHE[key]
    banded = inner == "banded"
    b_hi, b_lo = bs[0], bs[1]

    def solve(rhs):
        # The inner solve APPLICATION runs at default matmul precision
        # even under a raised ambient precision (the api ladder's
        # "highest" factor): convergence is carried by the FACTOR's
        # accuracy plus the double-float residual (elementwise,
        # precision-context-free), while the apply's own rounding only
        # needs f32-class matvecs. Whether "highest" applies cost sweeps
        # or time on the card awaits measurement.
        # demote_apply is STATIC (resolved from
        # CHOLESKY_TPU_APPLY_PRECISION by the caller) so flipping the env
        # retraces instead of silently reusing the cached program.
        import contextlib

        import jax as _jax

        ctx = (_jax.default_matmul_precision("bfloat16") if demote_apply
               else contextlib.nullcontext())
        with ctx:
            if inner == "banded":
                return frontal._solve_banded_core(fp, factors, inv_pivots,
                                                  rhs)
            return frontal.frontal_solve(fp, factors, rhs,
                                         inv_pivots=inv_pivots)

    def resid(x_hi, x_lo):
        if banded:
            # state vectors carry their zero sentinel slot inline and the
            # padded ELL has an all-sentinel last row, so r keeps the
            # sentinel-0 invariant with no concatenation
            y_hi, y_lo = df_matvec(idx, a_hi, a_lo, x_hi, x_lo)
            return _df_add(b_hi, b_lo, -y_hi, -y_lo)
        return _residual_df(idx, a_hi, a_lo, b_hi, b_lo, x_hi, x_lo)

    def rnorm_of(r_hi):
        # scaled 2-norm: residual entries underflow f32 squares near
        # convergence, so normalize by the max magnitude first
        m = jnp.maximum(jnp.max(jnp.abs(r_hi)), jnp.float32(1e-30))
        return m * jnp.linalg.norm(r_hi / m)

    # NOTE (140^3 postmortem): with raw bf16 panels the plain inner's
    # per-level f32 promotions are loop-invariant, and XLA hoists every
    # one of them out of the while body — ~2x the stored factor bytes
    # live across the whole loop (measured 21.94 GB buffer assignment on
    # a 16 GiB device). jax.checkpoint does NOT prevent this (it only
    # affects the backward pass; forward-only it is a no-op — measured:
    # identical 21.94 GB with and without). The api therefore routes
    # around this while-loop entirely when the hoisted casts cannot fit
    # (api._solve_impl: host-driven refinement over straight-line solve
    # programs, whose casts are transient).
    x0 = solve(b_hi)
    x_hi, x_lo = _two_sum(x0, jnp.zeros_like(x0))
    r_hi, r_lo = resid(x_hi, x_lo)

    def cond(st):
        i, x_hi, x_lo, r_hi, r_lo, rn, prev, hist = st
        # stop on tolerance OR stagnation (< 2x improvement: the loop has
        # reached the double-float residual floor; a tol below the floor
        # must not spin to max_iter)
        return (i < max_iter) & (rn > tol_abs) & (rn < 0.5 * prev)

    def body(st):
        i, x_hi, x_lo, r_hi, r_lo, rn, _, hist = st
        dx = solve(r_hi)
        x_hi, x_lo = _df_add(x_hi, x_lo, dx, jnp.zeros_like(dx))
        r_hi, r_lo = resid(x_hi, x_lo)
        rn2 = rnorm_of(r_hi)
        if trace_hist:
            hist = hist.at[i + 1].set(rn2)
        return i + 1, x_hi, x_lo, r_hi, r_lo, rn2, rn, hist

    rn0 = rnorm_of(r_hi)
    hist = jnp.zeros(_HIST_CAP, jnp.float32).at[0].set(rn0) \
        if trace_hist else jnp.zeros(0, jnp.float32)
    st = (jnp.int32(0), x_hi, x_lo, r_hi, r_lo, rn0,
          jnp.float32(jnp.inf), hist)
    i, x_hi, x_lo, r_hi, r_lo, rn, _, hist = lax.while_loop(cond, body, st)
    if pad_of is not None:
        # padded -> permuted on DEVICE: smaller readback, no host gather
        x_hi = x_hi[pad_of]
        x_lo = x_lo[pad_of]
    # pack (x_hi | rn), (x_lo | iters) into one [2, n(+pad)+1] readback
    extra = jnp.stack([rn, i.astype(jnp.float32)])
    out = jnp.concatenate([jnp.stack([x_hi, x_lo]), extra[:, None]], axis=1)
    if trace_hist:
        return out, hist
    return out


# ---------------------------------------------------------------------------
# Multi-RHS device-resident refinement: same loop, [n, k] right-hand sides.
# The single-RHS path's host fallback would otherwise run k-wide CSR matvecs
# and an [n, k] host<->device round trip per iteration; here the whole block
# of solutions refines in one while_loop (solves vmapped over columns, the
# double-float residual batched through one [n, K, k]-operand gather).
#
# NOTE: this section deliberately parallels the single-RHS loop above
# rather than folding it into a k=1 call: (a) tolerance semantics differ by
# design (single-RHS takes an ABSOLUTE tol_abs = tol*||b||; the block loop
# gates on the worst PER-COLUMN relative residual — a shared absolute tol
# would over/under-solve columns of different scale), and (b) the
# single-RHS program above is the hot compiled path whose source lines key
# the persistent compile cache. When touching the residual/stagnation
# logic (the 0.5*prev rule, the scaled-norm underflow guard), change BOTH.


def df_matvec_multi(idx, a_hi, a_lo, x_hi, x_lo):
    """Y = A @ X in double-float for X planes [n+1, k] (sentinel row n = 0).
    Returns (y_hi, y_lo), each [n, k]."""
    K = idx.shape[1]
    k = x_hi.shape[1]
    if K == 0:
        z = jnp.zeros((idx.shape[0], k), jnp.float32)
        return z, z
    xg = jnp.stack([x_hi, x_lo], axis=-1)[idx]        # [n, K, k, 2]
    xh = xg[..., 0]
    xl = xg[..., 1]
    ah = a_hi[:, :, None]
    al = a_lo[:, :, None]
    p, pe = _two_prod(ah, xh)
    cross = ah * xl + al * xh
    e_all = pe + cross
    s = p[:, 0, :]
    c = e_all[:, 0, :]
    for j in range(1, K):
        s, se = _two_sum(s, p[:, j, :])
        c = c + (se + e_all[:, j, :])
    return s, c


def solve_refined_df_multi(fp, factors: Sequence, B64: np.ndarray, ell,
                           tol: float = 1e-12, max_iter: int = 40,
                           inv_pivots=None):
    """Device-resident IR for a block of right-hand sides. `B64` is the
    PERMUTED f64 [n, k] RHS block. Returns (X_perm64 [n, k], iters,
    rn_rel_max): iterations are shared across columns (every column gets the
    correction each round; the loop stops on the worst column's relative
    residual). One packed [2, n+1, k] readback."""
    idx, a_hi, a_lo = ell
    B64 = np.asarray(B64, np.float64)
    b_hi, b_lo = split_f64(B64)
    bnorms = np.linalg.norm(B64, axis=0)
    bnorms_safe = np.where(bnorms > 0, bnorms, 1.0).astype(np.float32)
    inv = tuple(inv_pivots) if inv_pivots is not None else None
    bs = jnp.asarray(np.stack([b_hi, b_lo]))          # ONE upload [2, n, k]
    out = _run_multi(fp.key(), tuple(factors), inv, jnp.asarray(idx),
                     jnp.asarray(a_hi), jnp.asarray(a_lo), bs,
                     jnp.asarray(bnorms_safe),
                     np.int32(max_iter), np.float32(tol))
    arr = np.asarray(out, np.float64)                 # ONE readback
    X = arr[0, :-1, :] + arr[1, :-1, :]
    rn_rel_max = float(arr[0, -1, :].max())
    iters = int(arr[1, -1, 0])
    return X, iters, rn_rel_max


@functools.partial(jax.jit, static_argnums=0)
def _run_multi(key, factors, inv_pivots, idx, a_hi, a_lo, bs, bnorms,
               max_iter, tol_rel):
    from cholesky_tpu.numeric import frontal

    fp = frontal._FPLAN_CACHE[key]
    b_hi, b_lo = bs[0], bs[1]
    n, k = b_hi.shape

    def solve(rhs):
        return jax.vmap(
            lambda rc: frontal.frontal_solve(fp, factors, rc,
                                             inv_pivots=inv_pivots),
            in_axes=1, out_axes=1)(rhs)

    zrow = jnp.zeros((1, k), jnp.float32)

    def resid(x_hi, x_lo):
        xh = jnp.concatenate([x_hi, zrow])
        xl = jnp.concatenate([x_lo, zrow])
        y_hi, y_lo = df_matvec_multi(idx, a_hi, a_lo, xh, xl)
        return _df_add(b_hi, b_lo, -y_hi, -y_lo)

    def rel_norms(r_hi):
        m = jnp.maximum(jnp.max(jnp.abs(r_hi), axis=0), jnp.float32(1e-30))
        return m * jnp.linalg.norm(r_hi / m[None, :], axis=0) / bnorms

    x0 = solve(b_hi)
    x_hi, x_lo = _two_sum(x0, jnp.zeros_like(x0))
    r_hi, r_lo = resid(x_hi, x_lo)

    def cond(st):
        i, x_hi, x_lo, r_hi, r_lo, rn, prev = st
        return (i < max_iter) & (rn > tol_rel) & (rn < 0.5 * prev)

    def body(st):
        i, x_hi, x_lo, r_hi, r_lo, rn, _ = st
        dx = solve(r_hi)
        x_hi, x_lo = _df_add(x_hi, x_lo, dx, jnp.zeros_like(dx))
        r_hi, r_lo = resid(x_hi, x_lo)
        rn2 = jnp.max(rel_norms(r_hi))
        return i + 1, x_hi, x_lo, r_hi, r_lo, rn2, rn

    rn0 = jnp.max(rel_norms(r_hi))
    st = (jnp.int32(0), x_hi, x_lo, r_hi, r_lo, rn0, jnp.float32(jnp.inf))
    i, x_hi, x_lo, r_hi, r_lo, rn, _ = lax.while_loop(cond, body, st)
    extra = jnp.stack([rel_norms(r_hi),
                       jnp.full((k,), i, jnp.float32)])     # [2, k]
    return jnp.concatenate(
        [jnp.stack([x_hi, x_lo]), extra[:, None, :]], axis=1)
