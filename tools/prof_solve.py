"""Profile the solve path stage by stage on the live backend.

Usage: python tools/prof_solve.py [stage ...]
Stages: solve1 (frontal_solve w/ inv_pivots), refine (full df loop + iter
count), api (SparseCholesky.solve), resid (df residual alone).
Default: refine api.
"""
import time, sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import numpy as np
import jax, jax.numpy as jnp
import cholesky_tpu; cholesky_tpu.setup_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from cholesky_tpu import SparseCholesky
from cholesky_tpu.numeric import frontal, refine
from cholesky_tpu.utils.laplacian import generate_problem

stages = sys.argv[1:] or ["refine", "api"]

shape, levels = (50, 50, 50), 8
n, r, c, v, o, cl, b = generate_problem(shape, levels)
solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
t0 = time.time()
solver.factorize()
print(f"factorize (incl compile): {time.time()-t0:.2f}s", flush=True)

fp = solver.fplan
factors = solver.panels

def timeit(f, iters=5):
    t0 = time.time(); f(); print(f"  (first call {time.time()-t0:.1f}s)", flush=True)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter(); f(); ts.append(time.perf_counter()-t0)
    return min(ts)


bp = jnp.asarray(b[solver.plan.perm].astype(np.float32))

if "upload" in stages:
    blob = np.random.rand(125000, 21).astype(np.float32)   # ~10.5 MB
    t = timeit(lambda: jax.block_until_ready(jax.device_put(blob)), iters=3)
    print(f"device_put 10.5MB: {t*1e3:.1f} ms", flush=True)

if "solve1" in stages:
    inv = solver._inv_pivots()
    import functools
    @functools.partial(jax.jit, static_argnums=0)
    def sol1(key, fac, iv, bb):
        return frontal.frontal_solve(frontal._FPLAN_CACHE[key], fac, bb,
                                     inv_pivots=iv)
    t = timeit(lambda: np.asarray(sol1(fp.key(), factors, inv, bp)))
    print(f"frontal_solve(inv_pivots) 1x: {t*1e3:.1f} ms", flush=True)
    t = timeit(lambda: jax.block_until_ready(
        frontal.invert_pivots(fp, factors)))
    print(f"invert_pivots: {t*1e3:.1f} ms", flush=True)

if "tri" in stages:
    t = timeit(lambda: np.asarray(frontal.solve(fp, factors, bp)))
    print(f"frontal_solve(triangular) 1x: {t*1e3:.1f} ms", flush=True)

if "resid" in stages:
    ell = solver._ell_perm()
    idx, a_hi, a_lo = [jnp.asarray(x) for x in ell]
    b_hi, b_lo = refine.split_f64(b[solver.plan.perm].astype(np.float64))
    b_hi, b_lo = jnp.asarray(b_hi), jnp.asarray(b_lo)
    res1 = jax.jit(lambda ix, ah, al, bh, bl, xh, xl:
                   refine._residual_df(ix, ah, al, bh, bl, xh, xl))
    xh = bp; xl = jnp.zeros_like(bp)
    t = timeit(lambda: np.asarray(
        res1(idx, a_hi, a_lo, b_hi, b_lo, xh, xl)[0]))
    print(f"df residual 1x: {t*1e3:.1f} ms", flush=True)

if "refine" in stages:
    ell = solver._ell_perm()
    inv = solver._inv_pivots()
    x_, iters, rn = refine.solve_refined_df(
        fp, factors, b[solver.plan.perm], ell, inv_pivots=inv)
    print(f"refine iterations: {iters} rn_rel={rn:.2e}", flush=True)
    def full():
        refine.solve_refined_df(
            fp, factors, b[solver.plan.perm], ell, inv_pivots=inv)
    t = timeit(full)
    print(f"solve_refined_df full: {t*1e3:.1f} ms", flush=True)

if "conv" in stages:
    ell = solver._ell_perm()
    inv = solver._inv_pivots()
    bn = float(np.linalg.norm(b))
    x_, it, rn, hist = refine.solve_refined_df(
        fp, factors, b[solver.plan.perm], ell, inv_pivots=inv,
        trace_hist=True, tol=1e-13)
    h = hist[:it+1] / bn
    print(f"conv(inv): iters={it} hist={[f'{v:.2e}' for v in h]}", flush=True)
    x_, it, rn, hist = refine.solve_refined_df(
        fp, factors, b[solver.plan.perm], ell, inv_pivots=None,
        trace_hist=True, tol=1e-13)
    h = hist[:it+1] / bn
    print(f"conv(tri): iters={it} hist={[f'{v:.2e}' for v in h]}", flush=True)

if "api" in stages:
    t = timeit(lambda: solver.solve(b))
    print(f"api solve: {t*1e3:.1f} ms", flush=True)
