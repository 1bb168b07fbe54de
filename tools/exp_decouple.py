"""Experiment: decouple FACTOR matmul precision from the
IR loop's APPLY precision at 50^3, tol matching the bench gate (1e-11).

The hypothesis: a 'high'/'highest'-precision factor sets the IR contraction
rate (few sweeps), while the per-sweep triangular apply can run at default
(bf16-pass) matmul precision without stalling convergence — giving
few-sweeps x cheap-sweeps. Prints one JSON line per config.

Run: python tools/exp_decouple.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import numpy as np
import jax

import cholesky_tpu; cholesky_tpu.setup_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from cholesky_tpu import SparseCholesky
from cholesky_tpu.api import _precision_ctx
from cholesky_tpu.numeric import frontal, refine

shape, levels = (50, 50, 50), 8
from cholesky_tpu.utils.laplacian import generate_problem
n, r, c, v, o, cl, b = generate_problem(shape, levels)

solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
fp = solver.fplan
fronts = solver.assemble()
bp = np.asarray(b, np.float64)[solver.plan.perm]
ell = solver._ell_perm()

panels = {}
for prec in ("default", "high", "highest"):
    ctx = None if prec == "default" else prec
    t0 = time.time()
    with _precision_ctx(ctx):
        p = jax.block_until_ready(frontal.frontal_factor(fp, fronts))
    panels[prec] = p
    print(f"# factor[{prec}] first call {time.time()-t0:.1f}s", flush=True)

TOL = 1e-11 / 3.0      # the bench gate's device target


def run(fprec, aprec):
    ctx = None if aprec == "default" else aprec
    with _precision_ctx(ctx):
        inv = frontal.invert_pivots(fp, panels[fprec])
        x, iters, rn, hist = refine.solve_refined_df(
            fp, panels[fprec], bp, ell, tol=TOL, max_iter=30,
            inv_pivots=inv, trace_hist=True)
        # warm timing (programs now compiled)
        ts = []
        for _ in range(4):
            t0 = time.perf_counter()
            refine.solve_refined_df(fp, panels[fprec], bp, ell, tol=TOL,
                                    max_iter=30, inv_pivots=inv)
            ts.append(time.perf_counter() - t0)
    wall = min(ts)
    hist = [float(f"{h:.2e}") for h in np.asarray(hist[:iters + 1])]
    print(json.dumps({"factor": fprec, "apply": aprec, "iters": iters,
                      "rn_rel": float(f"{rn:.2e}"),
                      "solve_wall_s": round(wall, 4), "hist": hist}),
          flush=True)


for fprec, aprec in [("default", "default"), ("high", "default"),
                     ("high", "high"), ("highest", "default"),
                     ("highest", "high")]:
    run(fprec, aprec)
