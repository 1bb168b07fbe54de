#!/usr/bin/env python
"""Per-device memory accounting of the level-streamed factorization under
a device mesh — AOT compile only, no execution.

Proves the reference's implicit Realm property (a problem too big for one
node spans the machine's aggregate memory — cholesky.cc:65-73 placement +
Realm movement) holds for the rebuild: slot-sharding the level programs
over an N-device mesh divides per-chip argument/output/temp bytes ~1/N on
every wide level (narrow top levels replicate by policy, mesh.py:40-47).

For each tree level, the SAME donating level-step program the streamed
factorization dispatches (frontal._level_step_jit) is lowered twice —
single-device and slot-sharded over an 8-device mesh — and XLA's
memory_analysis (per-device under SPMD) is recorded.

    JAX_PLATFORMS=cpu python tools/memcheck_mesh.py 80,80,80 10

writes a markdown table to stdout (docs/performance.md embeds the 80^3
result) and a JSON summary to MEMSCALE.json when --json is passed.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp
import numpy as np

import cholesky_tpu

cholesky_tpu.setup_compilation_cache()

from cholesky_tpu.numeric import frontal
from cholesky_tpu.parallel.mesh import make_mesh, panel_sharding
from cholesky_tpu.symbolic.plan import build_plan
from cholesky_tpu.utils.laplacian import generate_problem


def level_specs(fp, lvl, mesh=None, dtype=jnp.float32):
    """(piv_spec, utag, u_spec) for level lvl's step program; slot-sharded
    over `mesh` when given (replicated where the policy replicates)."""
    B = 1 << lvl
    piv_shape = (B, fp.F[lvl], fp.W[lvl])
    if mesh is not None:
        piv = jax.ShapeDtypeStruct(piv_shape, dtype,
                                   sharding=panel_sharding(mesh, lvl))
    else:
        piv = jax.ShapeDtypeStruct(piv_shape, dtype)
    if lvl == fp.levels - 1:
        return piv, "none", None
    cl = lvl + 1
    Kc = fp.F[cl] - fp.W[cl]
    utag = "xxt" if cl == fp.levels - 1 else "arr"
    cols = fp.W[cl] if utag == "xxt" else Kc
    u_dtype = frontal._update_dtype_for(dtype, frontal._u_bytes(fp, cl))
    u_shape = (2 * B, Kc, cols)
    if mesh is not None:
        u = jax.ShapeDtypeStruct(u_shape, u_dtype,
                                 sharding=panel_sharding(mesh, lvl + 1))
    else:
        u = jax.ShapeDtypeStruct(u_shape, u_dtype)
    return piv, utag, u


def analyze(fp, lvl, mesh, gm_cap, store_dtype=None, dtype=jnp.float32):
    piv, utag, u = level_specs(fp, lvl, mesh, dtype)
    update_dtype = frontal._update_dtype_for(dtype, frontal._u_bytes(fp, lvl))
    # forward the mesh spec exactly as the streamed driver does: the
    # collective root at lvl 0 AND the narrow mid-tree levels
    # (parallel/dist_level) — replicate-by-policy is gone
    spec = (frontal._mesh_for_level(fp, lvl,
                                    frontal._effective_root_mesh(fp, mesh))
            if mesh is not None else None)
    fn = frontal._level_step_jit(fp, lvl, utag, "hybrid3", gm_cap,
                                 update_dtype, spec, donate=True,
                                 store_dtype=store_dtype)
    args = (piv,) if utag == "none" else (piv, u)
    ma = fn.lower(*args).compile().memory_analysis()
    return {
        "args": int(ma.argument_size_in_bytes),
        "out": int(ma.output_size_in_bytes),
        "temp": int(ma.temp_size_in_bytes),
        "alias": int(ma.alias_size_in_bytes),
    }


def main():
    shape = tuple(int(x) for x in
                  (sys.argv[1] if len(sys.argv) > 1 else "80,80,80").split(","))
    levels = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    as_json = "--json" in sys.argv
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    plan = build_plan(o, cl)
    fp = frontal.build_frontal_plan(plan, r, c)
    mesh = make_mesh(8)
    total_front = sum((1 << l) * fp.F[l] * fp.W[l] * 4
                      for l in range(fp.levels))
    gm_cap = frontal._effective_gathermm_cap(total_front)
    print(f"# n={n} levels={fp.levels} fronts={total_front/2**30:.2f} GiB "
          f"(f32) backend={jax.default_backend()} ndev=8", flush=True)
    print("| level | B | F | W | single-chip peak | per-chip peak (8 dev) "
          "| ratio |")
    print("|---|---|---|---|---|---|---|")
    rows = []
    worst = 0.0
    for lvl in range(fp.levels - 1, -1, -1):
        one = analyze(fp, lvl, None, gm_cap)
        eight = analyze(fp, lvl, mesh, gm_cap)
        # peak resident bytes while this level's program runs: its args +
        # outputs + temps (donation aliases args into outputs, so count
        # max(args, out) + temps, conservative: args + temps + (out - alias))
        peak1 = one["args"] + one["temp"] + max(0, one["out"] - one["alias"])
        peak8 = (eight["args"] + eight["temp"]
                 + max(0, eight["out"] - eight["alias"]))
        ratio = peak8 / peak1 if peak1 else 1.0
        worst = max(worst, ratio)
        rows.append({"level": lvl, "B": 1 << lvl, "F": fp.F[lvl],
                     "W": fp.W[lvl], "single_bytes": peak1,
                     "per_chip_bytes": peak8, "ratio": round(ratio, 3),
                     "detail_single": one, "detail_mesh": eight})
        print(f"| {lvl} | {1 << lvl} | {fp.F[lvl]} | {fp.W[lvl]} "
              f"| {peak1/2**20:,.1f} MiB | {peak8/2**20:,.1f} MiB "
              f"| {ratio:.3f} |", flush=True)
    print(f"# worst per-chip/single ratio over ALL levels: {worst:.3f} "
          "(wide levels slot-shard; narrow levels row-shard per front via "
          "dist_level; root factors collectively)")
    if as_json:
        with open(os.path.join(os.path.dirname(__file__), "..",
                               "MEMSCALE.json"), "w") as f:
            json.dump({"n": n, "levels": fp.levels, "ndev": 8,
                       "worst_sharded_ratio": round(worst, 3),
                       "rows": rows}, f, indent=1)
        print("# wrote MEMSCALE.json")


if __name__ == "__main__":
    main()
