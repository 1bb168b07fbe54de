"""Experiment: factor/solve wall vs matmul precision at 50^3.

For each precision config: factor wall (timed by checksum readback),
solve wall at tol=1e-10 (the contract) and 1e-11 (bench margin), IR
iteration counts. Prints one JSON line per config.

Run: python tools/exp_solve_matrix.py [default high highest]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import numpy as np
import jax
import jax.numpy as jnp

import cholesky_tpu; cholesky_tpu.setup_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from cholesky_tpu import SparseCholesky
from cholesky_tpu.numeric import frontal
from cholesky_tpu.utils.laplacian import generate_problem

configs = sys.argv[1:] or ["default", "high", "highest"]

shape, levels = (50, 50, 50), 8
n, r, c, v, o, cl, b = generate_problem(shape, levels)


def timeit(f, iters=4):
    f()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter(); f(); ts.append(time.perf_counter() - t0)
    return min(ts)


for prec in configs:
    precision = None if prec == "default" else prec
    solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32,
                                     precision=precision)
    fp = solver.fplan
    t0 = time.time()
    solver.factorize()
    print(f"# [{prec}] factorize first (incl compile) {time.time()-t0:.1f}s",
          flush=True)

    # timed factor: checksum-read the frontal_factor program like bench.py
    fronts = solver.assemble()
    from cholesky_tpu.api import _precision_ctx

    with _precision_ctx(precision):
        cs_fn = jax.jit(lambda fs: sum(
            jnp.sum(p.astype(jnp.float32))
            for p in frontal.frontal_factor(fp, fs)))
        t_factor = timeit(lambda: float(cs_fn(fronts)))

    out = {"precision": prec, "factor_wall_s": round(t_factor, 4)}
    for tol in (1e-10, 1e-11):
        # fresh caches per tol not needed; programs keyed identically
        x = solver.solve(b, tol=tol)
        res = solver.residual(b, x)
        t_solve = timeit(lambda: solver.solve(b, tol=tol))
        # iteration count via the refine loop directly
        from cholesky_tpu.numeric import refine
        ell = solver._ell_perm()
        inv = solver._inv_pivots() if solver._want_inv_pivots() else None
        with _precision_ctx(precision):
            _, iters, rn = refine.solve_refined_df(
                fp, solver.panels, b[solver.plan.perm], ell, tol=tol / 3.0,
                inv_pivots=inv)
        out[f"solve_wall_s_tol{tol:.0e}"] = round(t_solve, 4)
        out[f"iters_tol{tol:.0e}"] = iters
        out[f"residual_tol{tol:.0e}"] = float(f"{res:.3e}")
    print(json.dumps(out), flush=True)
