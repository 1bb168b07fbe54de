"""Decompose the 50^3 solve wall: run the device IR program
at several iteration budgets (max_iter is a TRACED operand — one compiled
program serves all budgets) and extract constant + per-sweep cost from the
slope. Plus the full api solve for the host pre/post overhead.

Run: python tools/exp_solve_profile.py
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
from cholesky_tpu.numeric import frontal, refine
from cholesky_tpu.utils.laplacian import generate_problem

shape, levels = (50, 50, 50), 8
n, r, c, v, o, cl, b = generate_problem(shape, levels)


def timeit(f, iters=6):
    f()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter(); f(); ts.append(time.perf_counter() - t0)
    return min(ts)


solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
fp = solver.fplan
t0 = time.time(); solver.factorize()
print(f"# factorize (incl compile) {time.time()-t0:.1f}s", flush=True)
panels = tuple(solver.panels)
inv = tuple(frontal.invert_pivots(fp, panels))
ell = solver._ell_perm()
idx, a_hi, a_lo = [jnp.asarray(a) for a in ell]
bp = np.asarray(b, np.float64)[solver.plan.perm]
b_hi, b_lo = refine.split_f64(bp)
bs = jnp.asarray(np.stack([b_hi, b_lo]))

out = {}
# tol=0 forces the loop to run exactly max_iter sweeps (no early exit);
# one compiled program serves every budget (max_iter is traced)
for mi in (0, 1, 2, 4, 8):
    fn = lambda mi=mi: np.asarray(refine._run(
        fp.key(), panels, inv, idx, a_hi, a_lo, bs,
        jnp.int32(mi), np.float32(0.0)))
    out[f"run_iter{mi}_ms"] = round(timeit(fn) * 1e3, 2)
    print(f"# run_iter{mi} {out[f'run_iter{mi}_ms']:.2f} ms", flush=True)

# no-inverse variant: how much do the explicit pivot inverses buy per sweep
for mi in (0, 4):
    fn = lambda mi=mi: np.asarray(refine._run(
        fp.key(), panels, None, idx, a_hi, a_lo, bs,
        jnp.int32(mi), np.float32(0.0)))
    out[f"run_noinv_iter{mi}_ms"] = round(timeit(fn) * 1e3, 2)
    print(f"# run_noinv_iter{mi} {out[f'run_noinv_iter{mi}_ms']:.2f} ms",
          flush=True)

out["per_sweep_ms"] = round(
    (out["run_iter8_ms"] - out["run_iter0_ms"]) / 8, 2)
out["constant_ms"] = out["run_iter0_ms"]

x = solver.solve(b, tol=1e-10)
out["api_solve_tol1e10_ms"] = round(
    timeit(lambda: solver.solve(b, tol=1e-10)) * 1e3, 2)
out["residual"] = float(f"{solver.residual(b, x):.3e}")

print(json.dumps(out), flush=True)
