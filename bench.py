#!/usr/bin/env python
"""Benchmark: sparse Cholesky factorization throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...},
naming the device (platform, kind, count) and the card's name and power
limit as nvidia-smi reports them. Refuses to measure without a GPU.

Default workload is the reference's aspirational design target
(utils.py:43-47): a 50^3 grid Laplacian, 125,000 dofs, geometric nested
dissection — factored in fp32 with mixed-precision iterative refinement to
the 1e-10 residual contract. The metric is useful factorization FLOPs (the
cluster-level schedule's work, what a CPU BLAS implementation of the
reference would execute) divided by wall-clock of the batched factorization.

vs_baseline compares against the same schedule replayed with NumPy/BLAS on
the host CPU (the reference's compute engine is per-task OpenBLAS on 3 CPU
procs, test_matrices.py:27). The pinned number below was measured with
--measure-baseline; re-measure any time.

Timing: walls around jax.block_until_ready (or a host readback that ends
the timed call). Warm start against the persistent compile cache is its own
process: python tools/warm_start.py SIZE LEVELS, run with no other process
holding the card.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Host-CPU schedule-replay GFLOP/s, measured with --measure-baseline on this
# image (NumPy + system BLAS executing the exact per-cluster op schedule —
# the reference's execution model: one BLAS call per filled cluster pair).
# 20^3 measured 1.27, 27^3 measured 0.34 (smaller clusters, more op overhead);
# 50^3 cannot be replayed densely (125k^2 matrix), so its baseline reuses the
# 20^3 rate — conservative in our favor's *dis*favor, since real cluster
# sizes at 50^3 are no larger.
PINNED_CPU_BASELINE_GFLOPS = {
    "50x50x50_L8": 1.27,
    "27x27x27_L6": 0.34,
    "20x20x20_L5": 1.27,
}


def parse_shape(s):
    return tuple(int(x) for x in s.split(","))


def _device_info() -> dict:
    """Where the numbers come from: JAX's device, and the card's name and
    power limit as nvidia-smi reports them."""
    import jax

    d = jax.devices()[0]
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": out.stdout.strip()}


def _solve_series_builder(fp, inner_s, tol_abs, R):
    """R full refined solves inside ONE fori_loop program (device solve
    time without the per-call dispatch cost). All device operands ride as
    jit ARGUMENTS — jit bakes closures into the HLO as constants."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from cholesky_tpu.numeric import refine as refmod

    def _series(facs, bs, inv_a, idx_a, ahi_a, alo_a):
        def body(i, carry):
            b2 = bs + jnp.asarray(1e-12, bs.dtype) * (i + 1)
            out = refmod._run.__wrapped__(
                fp.key(), facs, inv_a, idx_a, ahi_a, alo_a, b2,
                jnp.int32(40), tol_abs, False, inner_s)
            return carry + jnp.sum(out[0])
        return lax.fori_loop(0, R, body, jnp.float32(0))
    return jax.jit(_series)


def _matmul_rates(include_potrf=False, iters=4):
    """Shared large-front kernel-rate harness: a large-matmul rate measured
    in the same run (4096^2 fp32 matmuls), the root-front SYRK rate at the
    50^3 root Schur shape, optionally root POTRF. Returns TFLOP/s floats.

    Each measured program runs hundreds of sequential ops inside ONE
    lax.fori_loop so device time dwarfs the per-call dispatch. The SYRK
    loop refreshes its operand every iteration (required so LICM can't
    hoist the einsum), which costs some extra memory traffic — the
    reported SYRK rate is a mild underestimate."""
    import jax
    import jax.numpy as jnp
    from jax import lax, random

    k = random.PRNGKey(0)

    def timeit(f, *a):
        float(f(*a))
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            float(f(*a))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    n, r_mm = 4096, 300
    a = random.normal(k, (n, n), jnp.float32)
    # spectral norm ~0.5 keeps the 300-deep product chain finite
    y2 = random.normal(k, (n, n), jnp.float32) / (2.0 * np.sqrt(n))

    def chain_mm(x, y):
        return jnp.sum(lax.fori_loop(0, r_mm, lambda i, acc: acc @ y, x))

    t = timeit(jax.jit(chain_mm), a, y2) / r_mm
    peak = 2 * n ** 3 / t / 1e12

    m_, k_ = 2504, 1256               # 50^3 root front Schur shape
    x = random.normal(k, (m_, k_), jnp.float32)
    r_sy = 2000

    def many_sy(x):
        def body(i, c):
            # fresh operand each step (i-dependent, carry-chained): not
            # hoistable, not algebraically factorable across iterations
            z = x + (1e-7 * i + 1e-30 * c)
            return c + 1e-12 * jnp.sum(jnp.einsum(
                "ik,jk->ij", z, z, preferred_element_type=jnp.float32))
        return lax.fori_loop(0, r_sy, body, jnp.float32(0))

    t = timeit(jax.jit(many_sy), x) / r_sy
    syrk = 2 * m_ * m_ * k_ / t / 1e12

    potrf = None
    if include_potrf:
        spd = x @ x.T + m_ * jnp.eye(m_, dtype=jnp.float32)
        r_ch, eye = 200, jnp.eye(m_, dtype=jnp.float32)

        def many_ch(d):
            def body(i, c):
                L = lax.linalg.cholesky(d + (1e-6 * i + 1e-30 * c) * eye,
                                        symmetrize_input=False)
                return c + 1e-9 * jnp.sum(L)
            return lax.fori_loop(0, r_ch, body, jnp.float32(0))

        t = timeit(jax.jit(many_ch), spd) / r_ch
        potrf = m_ ** 3 / 3 / t / 1e12
    return peak, syrk, potrf


def measure_peak_fraction():
    """The BASELINE '>=60% of matmul peak on large fronts' gate, against
    the large-matmul rate measured in the same run."""
    peak, syrk, _ = _matmul_rates()
    return {"gemm_peak_tflops": round(peak, 1),
            "syrk_root_tflops": round(syrk, 1),
            "peak_fraction": round(syrk / peak, 3)}


def bench_fixture(fixture_dir, mtx, ordf, clustf, rhs, dtype="float32"):
    """Second-scale row: end-to-end factor+solve on a reference fixture
    (default: lapl_3375x3375, the reference's largest committed problem,
    test_matrices.py:120). Returns a compact dict for the bench JSON."""
    import os

    import jax
    import jax.numpy as jnp

    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.io import mmio
    from cholesky_tpu.numeric import frontal
    from cholesky_tpu.symbolic import fill as fillmod
    from cholesky_tpu.verify import schedule as schedmod

    solver = SparseCholesky.from_files(
        os.path.join(fixture_dir, mtx), os.path.join(fixture_dir, ordf),
        os.path.join(fixture_dir, clustf), dtype=np.dtype(dtype))
    # AUTO precision — the same ladder the flagship production solver
    # resolves (at 3375 dofs it picks the multi-pass f32 factor, whose
    # deeper factor accuracy takes the refined residual from ~2e-11 to
    # the production 1e-12 class); the factor series
    # below times the SAME configuration so the row stays a consistent
    # (factor, solve) pair.
    b = mmio.read_array(os.path.join(fixture_dir, rhs)).reshape(-1)
    fa = fillmod.analyze_fill(solver.plan, solver.rows, solver.cols,
                              solver.vals)
    useful = schedmod.schedule_flops(schedmod.generate_schedule(fa))

    # resolve the AUTO ladder BEFORE the factor exists (the property pins
    # itself once factored) and run the raw frontal timing calls under
    # the same matmul-precision context the api methods apply
    from cholesky_tpu.api import _precision_ctx

    prec = solver.precision

    fp = solver.fplan
    fronts = tuple(frontal.FrontAssembler(fp, solver.rows, solver.cols)(
        solver.vals, dtype=np.dtype(dtype)))
    def _factor_cs(fs):
        with _precision_ctx(prec):
            out = frontal.frontal_factor(fp, fs)
        return out, sum(jnp.sum(p.astype(jnp.float32)) for p in out)

    cs_fn = jax.jit(_factor_cs)

    factors, cs = cs_fn(fronts)
    float(cs)

    # the 3375-dof factor is sub-ms on device: time R factorizations inside
    # ONE fori_loop program so the per-call dispatch is paid once
    from jax import lax

    R = 500

    def _factor_loop(fs):
        def body(i, carry):
            eps = jnp.asarray(1e-12, fs[0].dtype) * (i + 1)
            with _precision_ctx(prec):
                out = frontal.frontal_factor(fp, tuple(f + eps for f in fs))
            return carry + jnp.sum(out[0].astype(jnp.float32))
        return lax.fori_loop(0, R, body, jnp.float32(0))

    lfn = jax.jit(_factor_loop)
    float(lfn(fronts))
    t_factor = min(_t(lambda: float(lfn(fronts))) for _ in range(2)) / R

    solver.panels = factors
    solver.factored = True
    x = solver.solve(b)
    tss = []
    for _ in range(3):
        t0 = time.perf_counter()
        x = solver.solve(b)
        tss.append(time.perf_counter() - t0)
    t_solve = min(tss)
    residual = solver.residual(b, x)
    out = {"n": solver.plan.n,
           "factor_gflops": round(useful / t_factor / 1e9, 1),
           "factor_device_s": round(t_factor, 5),
           "solve_wall_s": round(t_solve, 4),
           "precision": f"{prec or 'default'} (auto)",
           "residual": float(f"{residual:.3e}"),
           "residual_ok": bool(residual <= 1e-10)}
    if prec not in (None, "default"):
        # the 'default'-precision configuration's wall alongside (the
        # flagship row reports the same pair)
        sd = SparseCholesky.from_files(
            os.path.join(fixture_dir, mtx),
            os.path.join(fixture_dir, ordf),
            os.path.join(fixture_dir, clustf), dtype=np.dtype(dtype),
            precision="default")
        sd.factorize()
        xd = sd.solve(b)
        tds = []
        for _ in range(3):
            t0 = time.perf_counter()
            xd = sd.solve(b)
            tds.append(time.perf_counter() - t0)
        out["solve_wall_s_default"] = round(min(tds), 4)
        out["residual_default"] = float(f"{sd.residual(b, xd):.3e}")
    return out


def _t(f):
    t0 = time.perf_counter()
    f()
    return time.perf_counter() - t0


def bench_irregular(dtype="float32"):
    """Irregular-matrix row: a 3-component vector-elasticity-type problem
    (grid Laplacian ⊗ SPD coupling, ~255k dofs, vertex-block structure)
    with NO precomputed ordering — from_matrix runs the auto ND/MD
    selection (native cores), then factor + refined solve at the 1e-10
    contract on the chip. Reports the same fields as the fixture row
    plus the auto-ordering wall."""
    import jax

    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.symbolic import fill as fillmod
    from cholesky_tpu.utils import problems
    from cholesky_tpu.verify import schedule as schedmod

    n, r, c, v = problems.vector_laplacian((44, 44, 44), 3)
    b = np.random.default_rng(7).standard_normal(n)
    t0 = time.time()
    solver = SparseCholesky.from_matrix(n, r, c, v, dtype=np.dtype(dtype))
    plan_s = solver.plan            # auto ordering + separator tree
    t_order = time.time() - t0
    fa = fillmod.analyze_fill(plan_s, solver.rows, solver.cols,
                              solver.vals)
    useful = schedmod.schedule_flops(schedmod.generate_schedule(fa))

    jax.block_until_ready(solver.factorize())      # compiles
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(solver.factorize())
        ts.append(time.perf_counter() - t0)
    t_factor = min(ts)
    x = solver.solve(b, tol=1e-10)  # compiles the solve programs
    tss = []
    for _ in range(3):
        t0 = time.perf_counter()
        x = solver.solve(b, tol=1e-10)
        tss.append(time.perf_counter() - t0)
    t_solve = min(tss)
    residual = solver.residual(b, x)
    return {"problem": "vector_laplacian(44^3, 3) elasticity-type",
            "n": n,
            "ordering_wall_s": round(t_order, 2),
            "levels": int(plan_s.levels),
            "factor_wall_s": round(t_factor, 4),
            "factor_gflops": round(useful / t_factor / 1e9, 1),
            "useful_gflop": round(useful / 1e9, 1),
            "solve_wall_s": round(t_solve, 4),
            "precision": f"{solver.precision or 'default'} (auto)",
            "residual": float(f"{residual:.3e}"),
            "residual_ok": bool(residual <= 1e-10)}


def kernel_rates():
    """Measure large-front kernel throughput vs a large matmul measured in
    the same run (the BASELINE 'large-front POTRF/GEMM >= 60% of matmul
    peak' target), through the shared _matmul_rates harness (plus root
    POTRF)."""
    import jax

    import cholesky_tpu; cholesky_tpu.setup_compilation_cache()

    if jax.default_backend() != "gpu":
        print(f"# bench.py measures the GPU; JAX found "
              f"'{jax.default_backend()}'", file=sys.stderr)
        return 2
    peak, syrk, potrf = _matmul_rates(include_potrf=True, iters=6)
    out = {"metric": "kernel_rates", "unit": "TFLOP/s", "vs_baseline": None,
           "device": _device_info(),
           "gemm_4096_tflops": round(peak, 1),
           "syrk_2504x1256_tflops": round(syrk, 1),
           "potrf_2504_tflops": round(potrf, 2)}
    out["value"] = out["syrk_2504x1256_tflops"]
    out["syrk_pct_of_peak"] = round(
        100 * out["syrk_2504x1256_tflops"] / out["gemm_4096_tflops"], 1)
    import json as _json

    print(_json.dumps(out))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="50,50,50", type=parse_shape)
    ap.add_argument("--levels", default=8, type=int)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--iters", default=3, type=int)
    ap.add_argument("--quick", action="store_true",
                    help="small problem for local smoke runs")
    ap.add_argument("--measure-baseline", action="store_true",
                    help="replay the schedule on host CPU and report its GFLOP/s")
    ap.add_argument("--cluster-size", default=16, type=int,
                    help="interval-0 cluster granularity for FLOP accounting")
    ap.add_argument("--kernel-rates", action="store_true",
                    help="measure large-front kernel rates vs matmul peak")
    ap.add_argument("--no-extras", action="store_true",
                    help="skip the peak-fraction and second-scale extras")
    args = ap.parse_args(argv)

    if args.kernel_rates:
        return kernel_rates()

    if args.quick:
        args.shape, args.levels = (20, 20, 20), 5
        args.no_extras = True          # smoke runs stay seconds-scale

    key = "x".join(map(str, args.shape)) + f"_L{args.levels}"

    import jax

    import cholesky_tpu; cholesky_tpu.setup_compilation_cache()
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.numeric import frontal
    from cholesky_tpu.symbolic import fill as fillmod
    from cholesky_tpu.utils.laplacian import generate_problem
    from cholesky_tpu.verify import schedule as schedmod

    t0 = time.time()
    n, r, c, v, o, cl, b = generate_problem(
        args.shape, args.levels, cluster_size=args.cluster_size)
    dtype = np.dtype(args.dtype)
    # the factor timing chain + gate run the max-throughput (one-pass)
    # configuration; the production AUTO precision ladder is timed
    # separately below (solve_wall_s) so the two stay consistent pairs
    solver = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype,
                                     precision="default")
    plan = solver.plan
    print(f"# problem {key}: n={n}, levels={plan.levels}, "
          f"gen {time.time()-t0:.1f}s", file=sys.stderr)

    # useful-FLOP accounting from the cluster-level schedule
    t0 = time.time()
    fa = fillmod.analyze_fill(plan, solver.rows, solver.cols, solver.vals)
    ops = schedmod.generate_schedule(fa)
    useful_flops = schedmod.schedule_flops(ops)
    print(f"# schedule: {len(ops)} ops, {useful_flops/1e9:.1f} GFLOP "
          f"(analysis {time.time()-t0:.1f}s)", file=sys.stderr)

    if args.measure_baseline:
        from cholesky_tpu.io import ordering as ordio  # noqa: F401
        from cholesky_tpu.verify import replay
        import scipy.sparse

        dense_gib = n * n * 8 / 2 ** 30
        if dense_gib > 32:
            print(f"# --measure-baseline replays a dense {n}^2 matrix "
                  f"({dense_gib:.0f} GiB) on the host — use --quick or a "
                  f"smaller --shape", file=sys.stderr)
            return 2
        off = solver.rows != solver.cols
        a_full = scipy.sparse.coo_matrix(
            (np.concatenate([solver.vals, solver.vals[off]]),
             (np.concatenate([solver.rows, solver.cols[off]]),
              np.concatenate([solver.cols, solver.rows[off]]))),
            shape=(n, n)).toarray()
        pmat = np.tril(a_full[np.ix_(plan.perm, plan.perm)])
        t0 = time.time()
        replay.replay_schedule(pmat, ops)
        dt = time.time() - t0
        gflops = useful_flops / dt / 1e9
        print(json.dumps({"metric": "cpu_baseline_factor_gflops",
                          "value": round(gflops, 2), "unit": "GFLOP/s",
                          "vs_baseline": 1.0, "key": key,
                          "wall_s": round(dt, 3)}))
        return 0

    if jax.default_backend() != "gpu":
        print(f"# bench.py measures the GPU; JAX found "
              f"'{jax.default_backend()}'", file=sys.stderr)
        return 2
    device = _device_info()

    # --- frontal symbolic plan, assemble ---
    t0 = time.time()
    fp = solver.fplan
    front_bytes = sum((1 << l) * fp.F[l] * fp.W[l]
                      for l in range(fp.levels)) * np.dtype(dtype).itemsize
    print(f"# frontal plan {time.time()-t0:.1f}s, "
          f"front buffers {front_bytes/2**30:.2f} GiB "
          f"(F per level: {list(fp.F)})", file=sys.stderr)

    import os

    from cholesky_tpu.utils import capacity

    stream_bytes = capacity.threshold("stream")
    # out-of-core configuration: fronts stay on HOST, uploaded level by
    # level inside the streamed factorization (and the factor is stored
    # bf16) — no upfront device transfer; upload time is part of the
    # measured factorization wall, as in any out-of-core solver
    offload = os.environ.get("CHOLESKY_TPU_UPLOAD_STREAM") == "1"
    streamed_incore = not offload and front_bytes > stream_bytes
    # past the f32-store ceiling f32 factors can't all stay resident:
    # frontal.factor() stores them bf16, and each timed iteration re-runs
    # assembly+factor (there is no f32 factor set to chain on)
    big = (front_bytes > capacity.threshold("f32_store")
           and np.dtype(dtype) == np.float32)
    if offload:
        t0 = time.time()
        fronts_host = frontal.assemble_fronts(
            fp, solver.rows, solver.cols, solver.vals, dtype=dtype)
        fronts = None                  # the streamed driver reads fronts_host
        print(f"# out-of-core: host-streamed fronts, bf16-stored factors "
              f"(host assemble {time.time()-t0:.1f}s)", file=sys.stderr)
    elif streamed_incore:
        # streamed in-core (fronts fit the device but the monolithic
        # program's temps don't): lazy per-level device assembly —
        # values-only upload, and only the CURRENT level's input slab
        # resides alongside the accumulating factors
        fronts = frontal.LazyFronts(
            frontal.FrontAssembler(fp, solver.rows, solver.cols),
            solver.vals, dtype=dtype)
        print("# lazy device assembly (per-level scatter inside the "
              "streamed factorization)", file=sys.stderr)
    else:
        # in-core: device-side assembly — only the [nnz] values cross
        # host->device; the refill scatter runs on the device
        t0 = time.time()
        fronts = tuple(frontal.FrontAssembler(fp, solver.rows, solver.cols)(
            solver.vals, dtype=dtype))
        jax.block_until_ready(fronts)
        print(f"# device assemble+transfer {time.time()-t0:.1f}s",
              file=sys.stderr)

    extadd = os.environ.get("CHOLESKY_TPU_EXTADD", "hybrid3")
    # Past the donation threshold the non-donating program cannot hold
    # input fronts + output factors + extend-add temps (memory_analysis at
    # 80^3: 4.67 args + 4.67 out + 8.87 temp GiB). Donate instead, and
    # time by CHAINING the program on its own output — the factors have the
    # same shapes as the fronts, and wall time is value-independent
    # (fixed-trip loops only), so iteration k donates iteration k-1's
    # buffers.
    donate = (front_bytes > capacity.threshold("bench_donate")
              or os.environ.get("CHOLESKY_TPU_BENCH_DONATE") == "1")

    stream = os.environ.get("CHOLESKY_TPU_STREAM", "auto")
    use_stream = stream == "1" or (
        stream == "auto" and front_bytes > stream_bytes)
    # host-resident fronts can only be consumed by the level-streamed upload
    # driver — without this the monolithic program would silently re-transfer
    # the numpy fronts inside every timed iteration
    use_stream = use_stream or offload
    donate = donate or use_stream      # streamed level programs always donate

    if use_stream:
        # level-streamed path (one donating program per level). Checksum
        # via a separate small jit — every level's program already executes
        # unconditionally, so DCE is not a concern.
        csum = jax.jit(
            lambda out: sum(jnp.sum(p.astype(jnp.float32)) for p in out))
        print(f"# streamed factorization ({fp.levels} level programs)",
              file=sys.stderr)

        def factor_cs(fs):
            if offload:
                # pass a fresh ref list per call: the streamed driver
                # consumes its list, while fronts_host retains the masters
                # for the next timing iteration
                out = frontal.factor(fp, list(fronts_host), extadd=extadd)
            else:
                # route through the dispatcher: it picks bf16 factor
                # storage past the offload threshold (LazyFronts or a
                # chained factor set alike)
                out = frontal.factor(fp, fs, extadd=extadd)
            return out, csum(out)
    else:
        def _factor_cs_fn(fs):
            # ONE compiled program serves both timing and the correctness
            # gate. The checksum touches EVERY output element so XLA
            # cannot dead-code-eliminate subtrees.
            out = frontal.frontal_factor(fp, fs, extadd=extadd)
            return out, sum(jnp.sum(p.astype(jnp.float32)) for p in out)

        factor_cs = (jax.jit(_factor_cs_fn, donate_argnums=0) if donate
                     else jax.jit(_factor_cs_fn))

    def factor_checksum(fs):
        return factor_cs(fs)[1]

    # Device-time factor series: R factorizations inside ONE fori_loop
    # program, so the per-call dispatch is paid once per chain. Runs BEFORE
    # the donating warmup (which consumes `fronts`); skipped in streamed/big
    # regimes, where per-level dispatch is part of the real execution model
    # and the wall is long enough to time directly.
    t_factor_device = None
    R_dev = 0
    compile_s = {}                 # compile+first-run seconds per program
    if not use_stream and not big and not args.no_extras:
        from jax import lax

        R_dev = int(np.clip(round(2.0 / max(useful_flops / 5e12, 1e-3)),
                            10, 200))

        def _factor_loop(fs):
            def body(i, carry):
                eps = jnp.asarray(1e-12, fs[0].dtype) * (i + 1)
                f2 = tuple(fr + eps for fr in fs)   # fresh operand per step
                out = frontal.frontal_factor(fp, f2, extadd=extadd)
                return carry + jnp.sum(out[0].astype(jnp.float32))
            return lax.fori_loop(0, R_dev, body, jnp.float32(0))

        lfn = jax.jit(_factor_loop)
        t0 = time.time()
        float(lfn(fronts))
        compile_s["series"] = round(time.time() - t0, 1)
        print(f"# device-series compile+first {compile_s['series']}s "
              f"(R={R_dev})", file=sys.stderr)
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            float(lfn(fronts))
            ts.append(time.perf_counter() - t0)
        t_factor_device = min(ts) / R_dev

    # warm up (compile)
    t0 = time.time()
    factors0, cs = factor_cs(fronts)
    float(cs)
    compile_s["factor"] = round(time.time() - t0, 1)
    print(f"# factor compile+first run {compile_s['factor']}s",
          file=sys.stderr)
    if donate and not big:
        fronts = None              # consumed by the first call
        # (big keeps `fronts`: the LazyFronts is not consumed — each timed
        # iteration re-runs assembly+factor from it, since bf16 factors
        # can't chain as f32 fronts)

    # --- correctness gate BEFORE the timing loop (in donate mode the timing
    # chain consumes the factors): full factor+solve with IR to 1e-10 ---
    t_solve = None
    t_solve_device = None
    t_pair = None
    R_solve = 0
    solver.panels = factors0
    solver.factored = True
    x = solver.solve(b, tol=1e-10)       # compiles the solve programs
    # tol = 1e-10, the framework's residual contract (BASELINE.md)
    t0 = time.perf_counter()
    x = solver.solve(b, tol=1e-10)
    t_solve = time.perf_counter() - t0
    residual = solver.residual(b, x)

    # Device-time solve series (the factor series' twin): R full refined
    # solves inside ONE fori_loop program — per-solve device time without
    # the per-call dispatch. Skipped where the extras are off or memory is
    # the story.
    if not use_stream and not big and not args.no_extras:
        from cholesky_tpu.numeric import refine as refmod

        ell_pad = solver._ell_padded()
        if ell_pad is not None:
            inv_s = (tuple(solver._inv_pivots())
                     if solver._want_inv_pivots() else None)
            banded = inv_s is not None
            inner_s = "banded" if banded else "plain"
            if banded:
                idx_e, a_hi_e, a_lo_e = ell_pad
                n_, _, inv_map_, pad_of_, _ = frontal._banded_maps(fp)
                b_ext = np.concatenate(
                    [b[plan.perm].astype(np.float64), [0.0]])
                b_pad = b_ext[np.concatenate([inv_map_, [plan.n]])]
                bh, bl = refmod.split_f64(b_pad)
            else:
                idx_e, a_hi_e, a_lo_e = [
                    jnp.asarray(t) for t in solver._ell_perm()]
                bh, bl = refmod.split_f64(
                    b[plan.perm].astype(np.float64))
            bs_dev = jnp.asarray(np.stack([bh, bl]))
            bnorm_g = float(np.linalg.norm(b))
            tol_abs = np.float32(1e-10 / 3.0 * bnorm_g)

            R_solve = 10
            sfn = _solve_series_builder(fp, inner_s, tol_abs, R_solve)
            t0 = time.time()
            float(sfn(tuple(factors0), bs_dev, inv_s, idx_e, a_hi_e, a_lo_e))
            compile_s["solve_series"] = round(time.time() - t0, 1)
            print(f"# solve series compile+first "
                  f"{compile_s['solve_series']}s (R={R_solve})",
                  file=sys.stderr)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(sfn(tuple(factors0), bs_dev, inv_s, idx_e, a_hi_e,
                          a_lo_e))
                ts.append(time.perf_counter() - t0)
            t_solve_device = min(ts) / R_solve

            # The production pair as ONE program: factor + pivot inversion
            # + refined solve in a single dispatch (fronts in, x out) — the
            # whole end-to-end latency a caller pays per (values, rhs) pair.
            if not donate and fronts is not None:
                def _pair_fn(fs, bs):
                    facs = frontal.frontal_factor(fp, fs, extadd=extadd)
                    inv_p = (frontal.invert_pivots(fp, facs)
                             if banded else None)
                    return refmod._run.__wrapped__(
                        fp.key(), tuple(facs), inv_p, idx_e, a_hi_e,
                        a_lo_e, bs, jnp.int32(40), tol_abs, False, inner_s)

                pfn = jax.jit(_pair_fn)
                t0 = time.time()
                jax.block_until_ready(pfn(fronts, bs_dev))
                compile_s["pair"] = round(time.time() - t0, 1)
                print(f"# pair program compile+first {compile_s['pair']}s",
                      file=sys.stderr)
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    jax.block_until_ready(pfn(fronts, bs_dev))
                    ts.append(time.perf_counter() - t0)
                t_pair = min(ts)
    solver.panels = None           # about to be donated away
    # free the gate's device caches before the timing chain: the pivot
    # inverses + ELL planes would otherwise sit on the device under the
    # factorization's transition temps
    solver._inv_cache = None
    solver._inv_cache_key = None
    for _attr in ("_ell_cache", "_ell_pad_cache"):
        if hasattr(solver, _attr):
            delattr(solver, _attr)

    # Timing is one synced call per measurement, min over iters. (A chain
    # of async donating dispatches synced once would let several
    # monolithic executions' temps coexist.)
    times = []
    cur = factors0 if donate else fronts
    for _ in range(args.iters):
        if use_stream and (offload or big):
            cur = None                 # free factors before re-running
            factors0 = None            # (first iteration: drop the gate's set)
            t0 = time.perf_counter()
            cur, cs = factor_cs(None if offload else fronts)
            float(cs)
            times.append(time.perf_counter() - t0)
            continue
        t0 = time.perf_counter()
        if donate:
            # chain: factors have the fronts' shapes; each call donates the
            # previous output (values go garbage/NaN — wall time does not
            # depend on values, only the gate above needs real numerics)
            cur, cs = factor_cs(cur)
            float(cs)
        else:
            float(factor_checksum(cur))
        times.append(time.perf_counter() - t0)
    t_factor = min(times)

    gflops = useful_flops / t_factor / 1e9
    base = PINNED_CPU_BASELINE_GFLOPS.get(key)
    result = {
        "metric": "factor_gflops",
        "value": round(gflops, 1),
        "unit": "GFLOP/s",
        "vs_baseline": round(gflops / base, 2) if base else None,
        "key": key,
        "n": n,
        "dtype": args.dtype,
        "device": device,
        "factor_wall_s": round(t_factor, 4),
        "useful_gflop": round(useful_flops / 1e9, 1),
        "residual": float(f"{residual:.3e}"),
        "residual_ok": bool(residual <= 1e-10),
    }
    if t_factor_device is not None:
        # headline GFLOP/s from the amortized device series; the per-call
        # wall stays as factor_wall_s and its GFLOP/s as factor_gflops_wall
        result["factor_device_s"] = round(t_factor_device, 4)
        result["factor_gflops_wall"] = result["value"]
        gd = useful_flops / t_factor_device / 1e9
        result["value"] = round(gd, 1)
        if base:
            result["vs_baseline"] = round(gd / base, 2)
        result["timing"] = (f"device series: {R_dev} factorizations in one "
                            f"fori_loop program")
    if t_solve is not None:
        result["solve_wall_s"] = round(t_solve, 4)
    if t_solve_device is not None:
        result["t_solve_device"] = round(t_solve_device, 4)
    if t_pair is not None:
        # factor + pivot inversion + refined solve as ONE dispatch — the
        # end-to-end latency a caller pays per (values, rhs) pair
        result["t_pair_wall_s"] = round(t_pair, 4)
    # compile+first-run seconds per program: compile time is a real
    # product cost
    for k_, v_ in compile_s.items():
        result[f"compile_{k_}_s"] = v_

    # padding efficiency: useful cluster-schedule FLOPs / executed
    # padded-bucket FLOPs of the frontal engine
    result["padding_efficiency"] = round(
        capacity.padding_efficiency(fp, useful_flops), 3)

    if not args.no_extras:
        # production solve: the API default resolves the matmul-precision
        # ladder from plan statistics (api.SparseCholesky.precision). When
        # it picks a raised-precision factor, time that CONSISTENT pair —
        # solve_wall_s then reports the production configuration at the
        # tol=1e-10 contract; the gate chain's 'default' pair moves to
        # solve_wall_s_default.
        prod = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype)
        prod._fplan = fp     # reuse the measured plan: .precision would
        #                      otherwise rebuild the frontal symbolic
        #                      analysis from scratch
        if prod.precision not in (None, "default"):
            cur = None          # free the timing chain's factor set
            prod.factorize()
            x = prod.solve(b, tol=1e-10)
            tps = []
            for _ in range(3):
                t0 = time.perf_counter()
                x = prod.solve(b, tol=1e-10)
                tps.append(time.perf_counter() - t0)
            rres = float(prod.residual(b, x))
            result["solve_wall_s_default"] = result.pop("solve_wall_s")
            result["solve_wall_s"] = round(min(tps), 4)
            result["solve_precision"] = f"{prod.precision} (auto)"
            result["residual_production"] = float(f"{rres:.3e}")
            result["residual_ok"] = bool(result["residual_ok"]
                                         and rres <= 1e-10)
            # Production-ladder solve DEVICE series: the same fori series,
            # TRACED under the production precision context with the
            # production factor set.
            if not use_stream and not big:
                from cholesky_tpu.api import _precision_ctx
                from cholesky_tpu.numeric import refine as refmod

                inv_pp = (tuple(prod._inv_pivots())
                          if prod._want_inv_pivots() else None)
                inner_pp = "banded" if inv_pp is not None else "plain"
                if inv_pp is not None:
                    idx_pp, ahi_pp, alo_pp = prod._ell_padded()
                    _, _, inv_map_p, _, _ = frontal._banded_maps(fp)
                    b_ext_p = np.concatenate(
                        [b[plan.perm].astype(np.float64), [0.0]])
                    bh_p, bl_p = refmod.split_f64(
                        b_ext_p[np.concatenate([inv_map_p, [plan.n]])])
                else:
                    idx_pp, ahi_pp, alo_pp = [
                        jnp.asarray(t) for t in prod._ell_perm()]
                    bh_p, bl_p = refmod.split_f64(
                        b[plan.perm].astype(np.float64))
                bs_pp = jnp.asarray(np.stack([bh_p, bl_p]))
                tol_pp = np.float32(1e-10 / 3.0 * np.linalg.norm(b))
                R_p = 10
                sfn_p = _solve_series_builder(fp, inner_pp, tol_pp, R_p)
                pargs = (tuple(prod.panels), bs_pp, inv_pp,
                         idx_pp, ahi_pp, alo_pp)
                with _precision_ctx(prod.precision):
                    t0 = time.time()
                    float(sfn_p(*pargs))
                compile_s["solve_series_production"] = round(
                    time.time() - t0, 1)
                tsp = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    float(sfn_p(*pargs))
                    tsp.append(time.perf_counter() - t0)
                result["t_solve_device_production"] = round(
                    min(tsp) / R_p, 4)
        # the >=60%-of-matmul-peak BASELINE gate and a second scale row
        # (the generated equivalent of the reference's largest committed
        # fixture); failures record their message, never kill the primary
        # metric
        try:
            result.update(measure_peak_fraction())
        except Exception as e:  # noqa: BLE001 — extras never kill the row
            result["peak_fraction_error"] = f"{type(e).__name__}: {e}"
        try:
            result["fixture_3375"] = _bench_generated_fixture(args.dtype)
        except Exception as e:  # noqa: BLE001
            result["fixture_3375"] = {"error": f"{type(e).__name__}: {e}"}
        try:
            result["irregular_elasticity"] = bench_irregular(args.dtype)
        except Exception as e:  # noqa: BLE001 — never kills the primary
            result["irregular_elasticity"] = {
                "error": f"{type(e).__name__}: {e}"}
    # Field order = reading order: the gates (per-call wall GFLOP/s,
    # peak_fraction, residual) come right after the headline; the CPU-replay
    # ratio vs_baseline trails them (it compares against a NumPy schedule
    # replay — see README).
    front = ["metric", "value", "unit", "device", "factor_gflops_wall",
             "factor_wall_s", "factor_device_s", "peak_fraction",
             "gemm_peak_tflops", "syrk_root_tflops", "residual",
             "residual_ok", "solve_wall_s", "residual_production",
             "vs_baseline"]
    result = {**{k: result[k] for k in front if k in result},
              **{k: v for k, v in result.items() if k not in front}}
    print(json.dumps(result))
    return 0


def _bench_generated_fixture(dtype):
    """bench_fixture on the generated 15^3 (3,375-dof) equivalent of the
    reference's largest committed fixture, written to a temp directory."""
    import tempfile

    from cholesky_tpu.io import mmio, ordering as ordio
    from cholesky_tpu.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    with tempfile.TemporaryDirectory() as d:
        mmio.write_coo(f"{d}/A.mtx", r, c, v, (n, n), symmetry="hermitian")
        ordio.write_ordering(f"{d}/ord.txt", o)
        ordio.write_clusters(f"{d}/clust.txt", cl)
        with open(f"{d}/B.mtx", "w") as f:
            f.write(f"%%MatrixMarket matrix array integer general\n%\n"
                    f"{n} 1\n")
            f.writelines(f"{int(x)}\n" for x in b)
        return bench_fixture(d, "A.mtx", "ord.txt", "clust.txt", "B.mtx",
                             dtype=dtype)


if __name__ == "__main__":
    sys.exit(main())
