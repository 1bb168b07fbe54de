"""Measure the top-of-tree fusion win on the streamed path.

Times frontal_factor_streamed (lazy device assembly, donate) at a
streamed-regime scale with fusion on (default 256 MB budget) and off
(CHOLESKY_TPU_TOP_FUSE_BYTES=0 via monkeypatch), warm, by checksum
readback. Prints one JSON line.

Run: python tools/exp_topfuse.py [dim [levels]]   (default 80^3 L8)
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

dim = int(sys.argv[1]) if len(sys.argv) > 1 else 80
levels = int(sys.argv[2]) if len(sys.argv) > 2 else 8
shape = (dim, dim, dim)
n, r, c, v, o, cl, b = generate_problem(shape, levels)

solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=np.float32)
fp = solver.fplan
asm = frontal.FrontAssembler(fp, solver.rows, solver.cols)
print(f"# plan: levels={fp.levels} F={list(fp.F)}", flush=True)
print(f"# fuse_start={frontal._top_fuse_start(fp, 4)}", flush=True)


def run_once():
    lazy = frontal.LazyFronts(asm, solver.vals, dtype=np.float32)
    out = frontal.frontal_factor_streamed(fp, lazy)
    # force completion: scalar slice from the root factor
    return float(jnp.sum(out[0][:1, :1, 0]))


res = {}
for tag, budget in (("fused", frontal._TOP_FUSE_BYTES), ("unfused", 0)):
    frontal._TOP_FUSE_BYTES = budget
    t0 = time.time(); run_once()
    print(f"# [{tag}] first call {time.time()-t0:.1f}s", flush=True)
    ts = []
    for _ in range(4):
        t0 = time.perf_counter(); run_once()
        ts.append(time.perf_counter() - t0)
    res[f"{tag}_factor_wall_s"] = round(min(ts), 4)
    print(f"# [{tag}] {res[f'{tag}_factor_wall_s']}s", flush=True)

res["speedup"] = round(res["unfused_factor_wall_s"] /
                       res["fused_factor_wall_s"], 3)
res["n"] = n
res["levels"] = levels
print(json.dumps(res), flush=True)
