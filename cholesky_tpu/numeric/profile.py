"""Per-phase/per-level profiling of the factorization.

Resurrects the reference's dormant BLAS timing instrumentation
(blas.rg:68-74,97-103,137-145,185-192 — commented-out
`BLAS: {'op': ..., 'Time': ...}` printfs, and the unused factor_start
timer mmat.rg:1226) as a first-class tool: each level's POTRF / TRSM /
update stage runs as its own jitted call timed to jax.block_until_ready,
and emits one structured line per stage in the reference's format.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from cholesky_tpu.symbolic.plan import SolvePlan


def _timed(fn, *args, iters: int = 3):
    """(last output, min wall over `iters` synced calls after one warm-up)."""
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, min(ts)


def profile_frontal(fp, fronts: Sequence, iters: int = 3,
                    emit=print) -> List[dict]:
    """Stage-by-stage timing of the multifrontal engine (extend-add, POTRF,
    TRSM, Schur per level)."""
    from cholesky_tpu.numeric import frontal as fr

    records = []

    def timed(fn, *args):
        return _timed(fn, *args, iters=iters)

    fronts = [jnp.asarray(f) for f in fronts]
    U = None
    for lvl in range(fp.levels - 1, -1, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        B = 1 << lvl
        piv = fronts[lvl]
        if U is not None:
            # time the PRODUCTION extend-add dispatch (hybrid3 default:
            # gathermm at child batch >= 4, fused gather-scatter below)
            import os

            strat = os.environ.get("CHOLESKY_TPU_EXTADD", "hybrid3")

            def apply_extadd(fu, u):
                if strat in ("hybrid3", "gathermm") and u.shape[0] >= 4:
                    return fu - fr._expand_child_updates_gathermm(
                        fp, u, lvl + 1).astype(fu.dtype)
                if strat == "hybrid2" and u.shape[0] >= 16:
                    return fu - fr._expand_child_updates_matmul(
                        fp, u, lvl + 1).astype(fu.dtype)
                if strat == "scatter":
                    return fu - fr._expand_child_updates(fp, u, lvl + 1)
                return fr._apply_child_updates_fused(fp, fu, u, lvl + 1)

            full0 = jnp.concatenate(
                [piv, jnp.zeros((B, Fl, Fl - Wl), piv.dtype)], axis=2)
            full, t = timed(jax.jit(apply_extadd), full0, U)
            rec = {"op": "EXTEND_ADD", "level": lvl, "batch": B,
                   "time_us": int(t * 1e6)}
            records.append(rec)
            emit(f"BLAS: {{'op': 'EXTADD', 'Level': {lvl}, 'Batch': {B}, "
                 f"'F': {Fl}, 'Time': {rec['time_us']}}}")
        else:
            full = jnp.concatenate(
                [piv, jnp.zeros((B, Fl, Fl - Wl), piv.dtype)], axis=2)

        # the pivot factorization as production dispatches it
        potrf = jax.jit(lambda a: lax.linalg.cholesky(
            a[:, :Wl, :Wl], symmetrize_input=False))
        Ld, t = timed(potrf, full)
        fl = B * Wl ** 3 / 3
        rec = {"op": "POTRF", "level": lvl, "batch": B, "n": Wl,
               "time_us": int(t * 1e6),
               "gflops": fl / max(t, 1e-12) / 1e9}
        records.append(rec)
        emit(f"BLAS: {{'op': 'POTRF', 'Level': {lvl}, 'Batch': {B}, "
             f"'N': {Wl}, 'Time': {rec['time_us']}}}")

        if Fl > Wl:
            m = Fl - Wl
            trsm = jax.jit(lambda ld, a: fr._tri_solve(
                ld, a[:, Wl:, :Wl], left_side=False, lower=True,
                transpose_a=True))
            X, t = timed(trsm, Ld, full)
            rec = {"op": "TRSM", "level": lvl, "batch": B, "m": m,
                   "n": Wl, "time_us": int(t * 1e6),
                   "gflops": B * m * Wl * Wl / max(t, 1e-12) / 1e9}
            records.append(rec)
            emit(f"BLAS: {{'op': 'TRSM', 'Level': {lvl}, 'Batch': {B}, "
                 f"'M': {m}, 'N': {Wl}, 'Time': {rec['time_us']}}}")
            if lvl > 0:
                schur = jax.jit(lambda x, f: jnp.einsum(
                    "bik,bjk->bij", x, x,
                    preferred_element_type=x.dtype) - f[:, Wl:, Wl:])
                U, t = timed(schur, X, full)
                rec = {"op": "SYRK", "level": lvl, "batch": B, "m": m,
                       "k": Wl, "time_us": int(t * 1e6),
                       "gflops": B * m * m * Wl / max(t, 1e-12) / 1e9}
                records.append(rec)
                emit(f"BLAS: {{'op': 'SYRK', 'Level': {lvl}, 'Batch': {B}, "
                     f"'M': {m}, 'K': {Wl}, 'Time': {rec['time_us']}}}")
        elif lvl > 0:
            U = jnp.zeros((B, 0, 0), piv.dtype)
    return records


def profile_factor(plan: SolvePlan, panels: Sequence, iters: int = 3,
                   emit=print) -> List[dict]:
    """Run the factorization stage by stage, timing each; returns records and
    emits reference-format `BLAS:` lines. Stages mutate a working copy of the
    panels so numerics match the production path."""
    S = [int(s) for s in plan.S]
    H = [int(h) for h in plan.H]
    u_off = plan.u_off
    levels = plan.levels
    panels = [jnp.asarray(p) for p in panels]
    records = []

    def timed(fn, *args):
        return _timed(fn, *args, iters=iters)

    for lvl in range(levels - 1, -1, -1):
        W = S[lvl]
        B = 1 << lvl
        A = panels[lvl]

        potrf = jax.jit(lambda a: lax.linalg.cholesky(
            a[:, :W, :], symmetrize_input=False))
        Ld, t = timed(potrf, A)
        fl = B * W ** 3 / 3
        rec = {"op": "POTRF", "level": lvl, "batch": B, "n": W,
               "time_us": int(t * 1e6), "gflops": fl / max(t, 1e-12) / 1e9}
        records.append(rec)
        emit(f"BLAS: {{'op': 'POTRF', 'Level': {lvl}, 'Batch': {B}, "
             f"'N': {W}, 'Time': {rec['time_us']}}}")

        if H[lvl] > W:
            trsm = jax.jit(lambda ld, a: lax.linalg.triangular_solve(
                ld, a[:, W:, :], left_side=False, lower=True,
                transpose_a=True))
            X, t = timed(trsm, Ld, A)
            m = H[lvl] - W
            fl = B * m * W * W
            rec = {"op": "TRSM", "level": lvl, "batch": B, "m": m, "n": W,
                   "time_us": int(t * 1e6), "gflops": fl / max(t, 1e-12) / 1e9}
            records.append(rec)
            emit(f"BLAS: {{'op': 'TRSM', 'Level': {lvl}, 'Batch': {B}, "
                 f"'M': {m}, 'N': {W}, 'Time': {rec['time_us']}}}")
            panels[lvl] = jnp.concatenate([Ld, X], axis=1)
        else:
            X = None
            panels[lvl] = Ld

        if lvl == 0 or X is None:
            continue

        def update_stage(x, targets):
            # same contiguous-update scheme as factor_panels
            slots = jnp.arange(1 << lvl)
            outs = []
            for lam in range(lvl - 1, -1, -1):
                co = int(u_off[lvl][lam])
                xp = x[:, co:co + S[lam], :]
                tail = x[:, co:, :]
                contrib = jnp.einsum("bik,bjk->bij", tail, xp,
                                     preferred_element_type=x.dtype)
                seg = slots >> (lvl - lam)
                contrib = jax.ops.segment_sum(
                    contrib, seg, num_segments=1 << lam,
                    indices_are_sorted=True)
                outs.append(targets[lvl - 1 - lam] - contrib)
            return tuple(outs)

        targets = tuple(panels[lam] for lam in range(lvl - 1, -1, -1))
        upd = jax.jit(update_stage)
        new_targets, t = timed(upd, X, targets)
        for i, lam in enumerate(range(lvl - 1, -1, -1)):
            panels[lam] = new_targets[i]
        m = H[lvl] - W
        fl = B * (m * (m + 1) / 2) * W * 2
        rec = {"op": "UPDATE", "level": lvl, "batch": B, "m": m, "k": W,
               "time_us": int(t * 1e6), "gflops": fl / max(t, 1e-12) / 1e9}
        records.append(rec)
        emit(f"BLAS: {{'op': 'GEMM', 'Level': {lvl}, 'Batch': {B}, "
             f"'M': {m}, 'K': {W}, 'Time': {rec['time_us']}}}")

    return records
