#!/usr/bin/env python
"""Microbenchmark: extend-add strategies per level transition.

For each level transition (children at L+1 -> parents at L) times each
strategy producing the updated parent full fronts, with compile excluded.
Times are µs of wall-clock per synced call.

Usage: python tools/bench_extadd.py [--shape 50,50,50 --levels 8]
       [--strategies scatter,matmul,gather,gathermm,fused]
"""

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="50,50,50")
    ap.add_argument("--levels", default=8, type=int)
    ap.add_argument("--strategies",
                    default="scatter,matmul,gather,gathermm,fused")
    ap.add_argument("--iters", default=5, type=int)
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split(","))
    strategies = args.strategies.split(",")

    import jax

    import cholesky_tpu; cholesky_tpu.setup_compilation_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    import jax.numpy as jnp

    from cholesky_tpu.numeric import frontal as fr
    from cholesky_tpu.symbolic.plan import build_plan
    from cholesky_tpu.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem(shape, args.levels)
    plan = build_plan(o, cl)
    fp = fr.build_frontal_plan(plan, r, c)
    print(f"# n={n} F={list(fp.F)} W={list(fp.W)}", file=sys.stderr)

    key = jax.random.PRNGKey(0)

    EXPAND = {
        "scatter": fr._expand_child_updates,
        "matmul": fr._expand_child_updates_matmul,
        "gather": fr._expand_child_updates_gather,
        "gathermm": fr._expand_child_updates_gathermm,
    }

    for lvl in range(fp.levels - 2, -1, -1):
        child = lvl + 1
        B2 = 1 << child
        K = fp.F[child] - fp.W[child]
        Fp = fp.F[lvl]
        B = 1 << lvl
        if K == 0:
            continue
        U = full = None
        for attempt in range(4):
            try:
                U = jax.random.normal(key, (B2, K, K), jnp.float32)
                full = jax.random.normal(key, (B, Fp, Fp), jnp.float32)
                jax.block_until_ready((U, full))
                break
            except Exception:  # noqa: BLE001 — worker restarting
                print(f"# lvl {lvl}: alloc failed, waiting for worker",
                      file=sys.stderr)
                time.sleep(75)
        if U is None:
            continue
        for s in strategies:
            try:
                if s == "fused":
                    f = jax.jit(lambda fu, u: fr._apply_child_updates_fused(
                        fp, fu, u, child))
                    f(full, U).block_until_ready()
                    ts = []
                    for _ in range(args.iters):
                        t0 = time.perf_counter()
                        out = f(full, U)
                        float(jnp.sum(out[0, 0]))
                        ts.append(time.perf_counter() - t0)
                else:
                    g = jax.jit(lambda fu, u: fu - EXPAND[s](
                        fp, u, child).astype(fu.dtype))
                    g(full, U).block_until_ready()
                    ts = []
                    for _ in range(args.iters):
                        t0 = time.perf_counter()
                        out = g(full, U)
                        float(jnp.sum(out[0, 0]))
                        ts.append(time.perf_counter() - t0)
                t = min(ts)
                gb = (U.nbytes + 2 * full.nbytes) / 2**30
                print(f"lvl {lvl:2d} B2={B2:4d} K={K:5d} Fp={Fp:5d} "
                      f"{s:9s} {t*1e6:9.0f} us  "
                      f"({gb / max(t, 1e-9):6.1f} GiB/s eff)")
            except Exception as e:  # noqa: BLE001
                print(f"lvl {lvl:2d} {s:9s} FAILED {type(e).__name__}")
                time.sleep(75)   # give a crashed worker time to restart
        del U, full
    return 0


if __name__ == "__main__":
    sys.exit(main())
