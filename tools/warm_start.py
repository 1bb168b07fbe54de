#!/usr/bin/env python
"""Warm-start cost of a FRESH process with a warm persistent compile cache.

Production programs take tens of seconds to compile; the persistent
compile cache (`setup_compilation_cache`: JAX_COMPILATION_CACHE_DIR, else
<checkout>/.jax_cache) is what lets a fresh process skip that. This script
is the measurement: run it in a fresh interpreter after a bench/CLI run
has populated the cache, with no other process holding the card, and it
times exactly what a production caller pays end-to-end — symbolic
analysis, device assembly, `factorize()` (compile-or-cache-hit + first
run), first `solve()` (same), and the warm per-call walls, each synced
with jax.block_until_ready.

Run: python tools/warm_start.py [dim levels]

Reference analogue: Legion's `__demand(__trace)` replay makes repeat
iterations free in-run (mmat.rg:1211); the persistent cache is the
cross-process equivalent.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

import cholesky_tpu

cache_dir = cholesky_tpu.setup_compilation_cache()

from cholesky_tpu import SparseCholesky
from cholesky_tpu.utils.laplacian import generate_problem


def main() -> int:
    dim = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    levels = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    try:
        n_cached = sum(1 for f in os.listdir(cache_dir)
                       if not f.startswith("."))
    except OSError:
        n_cached = 0

    t_all = time.time()
    n, r, c, v, o, cl, b = generate_problem((dim, dim, dim), levels)
    solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
    solver.fplan                     # symbolic analysis + frontal plan
    t_plan = time.time() - t_all

    t0 = time.time()
    jax.block_until_ready(solver.factorize())   # compile-or-cache-hit + run
    t_factor_first = time.time() - t0
    t0 = time.time()
    jax.block_until_ready(solver.factorize())
    t_factor_warm = time.time() - t0

    t0 = time.time()
    x = solver.solve(b, tol=1e-10)   # compiles/loads the solve programs
    t_solve_first = time.time() - t0
    t0 = time.time()
    x = solver.solve(b, tol=1e-10)
    t_solve_warm = time.time() - t0
    res = float(solver.residual(b, x))

    out = {
        "key": f"{dim}^3_L{levels}",
        "cache_entries": n_cached,
        "plan_s": round(t_plan, 1),
        "factor_first_s": round(t_factor_first, 1),
        "factor_warm_s": round(t_factor_warm, 3),
        "solve_first_s": round(t_solve_first, 1),
        "solve_warm_s": round(t_solve_warm, 3),
        "process_total_s": round(time.time() - t_all, 1),
        "residual": float(f"{res:.3e}"),
        "residual_ok": bool(res <= 1e-10),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
