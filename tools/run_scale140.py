"""140^3 (2,744,000 dofs) end-to-end verified-row run on one card.

Full out-of-core pipeline via the production api path: lazy per-level
device assembly, level-streamed donating programs with auto batch
chunking + child-update spill, bf16 factor store, host offload, then the
capacity-aware re-upload and the no-inverses (plain) refined solve —
the path that avoids the RESOURCE_EXHAUSTED this scale first hit.
Prints a wall + residual row.

Usage: python tools/run_scale140.py [dim levels]  (default 140 14)
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import cholesky_tpu

cholesky_tpu.setup_compilation_cache()

from cholesky_tpu import SparseCholesky
from cholesky_tpu.utils.laplacian import generate_problem

dim = int(sys.argv[1]) if len(sys.argv) > 1 else 140
levels = int(sys.argv[2]) if len(sys.argv) > 2 else 14
ckpt = os.environ.get("CHOLESKY_TPU_RUN140_CKPT")      # optional .npz path
skip_warm_factor = os.environ.get("CHOLESKY_TPU_RUN140_NO_WARM") == "1"

t0 = time.time()
n, r, c, v, o, cl, b = generate_problem((dim, dim, dim), levels)
print(f"gen {time.time()-t0:.0f}s n={n}", flush=True)

t0 = time.time()
solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
fp = solver.fplan            # triggers symbolic analysis + frontal plan
print(f"symbolic+frontal plan {time.time()-t0:.0f}s "
      f"(levels={fp.levels})", flush=True)

wall = None
if ckpt and os.path.exists(ckpt if ckpt.endswith(".npz") else ckpt + ".npz"):
    t0 = time.time()
    solver.load_factor(ckpt)
    print(f"factor loaded from checkpoint {time.time()-t0:.0f}s", flush=True)
else:
    t0 = time.time()
    solver.factorize()
    print(f"factorize #1 (incl. compiles) {time.time()-t0:.0f}s", flush=True)
    if ckpt:
        t0 = time.time()
        solver.save_factor(ckpt)
        print(f"factor checkpointed {time.time()-t0:.0f}s", flush=True)
import jax

resident = all(isinstance(p, jax.Array) for p in solver.panels)
print(f"panels resident={resident} dtypes="
      f"{[str(p.dtype) for p in solver.panels]}", flush=True)
print(f"want_inv_pivots={solver._want_inv_pivots()}", flush=True)

# SOLVE FIRST (the verified-row gate), then the optional warm factor wall
t0 = time.time()
x = solver.solve(b, tol=1e-10)
t_solve1 = time.time() - t0
print(f"solve #1 (incl. compiles) {t_solve1:.0f}s", flush=True)
t0 = time.time()
x = solver.solve(b, tol=1e-10)
t_solve = time.time() - t0
res = solver.residual(b, x)
print(f"solve wall (warm) {t_solve:.1f}s residual {res:.3e} "
      f"ok={res <= 1e-10}", flush=True)

if not skip_warm_factor:
    # timed second factorization (programs warm in-process)
    t0 = time.time()
    solver.factorize()
    wall = time.time() - t0
    print(f"factor wall (warm) {wall:.1f}s", flush=True)
import json

print(json.dumps({"n": n, "key": f"{dim}^3_L{levels}",
                  "factor_wall_s": round(wall, 1) if wall else None,
                  "solve_wall_s": round(t_solve, 1),
                  "residual": float(f"{res:.3e}"),
                  "residual_ok": bool(res <= 1e-10)}), flush=True)
