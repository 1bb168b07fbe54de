#!/usr/bin/env python
"""End-to-end check of the solver's main path on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: only the 4-card mesh path

Phases (one card), each printed as one line (phase, n, residual, refinement
sweeps, factor wall, solve wall, peak device memory so far):

  cli        the CLI (cholesky_tpu.cli.main, in-process) on the generated
             15^3 fixture with -o/-m; solution and factor checked against
             SciPy at the reference harness tolerance
  50^3 f32   125,000-dof grid Laplacian (L8), fp32 factor + iterative
             refinement, under the AUTO precision and under 'default'
  50^3 f64   the same problem with a float64 factor and no refinement
  100^3 f32  1,000,000 dofs (L13), fp32 + iterative refinement
  kernels    the card-only tests (tests/test_gpu.py, marker `gpu`): the
             per-level diagonal stage, blocked vs plain, and the
             double-float residual against an f64 matvec

--four factors 80^3 (L10, 512,000 dofs) over make_mesh(4) with the
narrow-level subgroups and the 2-D root front asserted through call spies,
and compares it with the same problem on one card of the same process.

Every residual is ||b - A x|| / ||b|| from a SciPy CSR matvec on the host in
f64. The script exits non-zero, and prints no result line, when JAX finds
no GPU or any phase fails; its last line is then the only JSON object it
prints: {"ok": true, "device": {...}}. It runs in one process.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-10          # the solver's relative-residual contract


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _csr(n, r, c, v):
    """Full symmetric CSR from a lower-triangle COO."""
    import scipy.sparse

    off = r != c
    return scipy.sparse.coo_matrix(
        (np.concatenate([v, v[off]]),
         (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
        shape=(n, n)).tocsr()


def _relres(a, b, x) -> float:
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - a @ np.asarray(x, np.float64))
                 / np.linalg.norm(b))


def _peak_gib() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2 ** 30


class _Sweeps:
    """Counts the device refinement loop's sweeps and the host-driven
    solves (a direct f64 solve, or api._solve_impl's host refinement loop)
    during one solve."""

    def __init__(self):
        from cholesky_tpu import api
        from cholesky_tpu.numeric import refine

        self.device = 0
        self.host = 0
        self._refine, self._api = refine, api
        self._orig_df = refine.solve_refined_df
        self._orig_once = api.SparseCholesky._solve_once

    def __enter__(self):
        def df(*a, **k):
            out = self._orig_df(*a, **k)
            self.device += int(out[1])
            return out

        def once(solver, b):
            self.host += 1
            return self._orig_once(solver, b)

        self._refine.solve_refined_df = df
        self._api.SparseCholesky._solve_once = once
        return self

    def __exit__(self, *exc):
        self._refine.solve_refined_df = self._orig_df
        self._api.SparseCholesky._solve_once = self._orig_once

    def __str__(self):
        return f"{self.device} host_solves={self.host}"


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _print_phase(name, n, res, sweeps, t_fac, t_sol, extra=""):
    print(f"phase={name} n={n} residual={res:.3e} sweeps={sweeps} "
          f"factor_s={t_fac:.4f} solve_s={t_sol:.4f} "
          f"peak_gib={_peak_gib():.3f}{extra}", flush=True)


def phase_cli():
    """CLI on the generated 15^3 fixture, -o and -m, checked like the
    reference harness (verify.py:278-302)."""
    import scipy.io
    import scipy.linalg
    import scipy.sparse.linalg

    from cholesky_tpu import cli
    from cholesky_tpu.io import mmio, ordering as ordio
    from cholesky_tpu.symbolic.plan import build_plan, permute_matrix_dense
    from cholesky_tpu.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem((15, 15, 15), 5)
    with tempfile.TemporaryDirectory() as d:
        mtx, ordf = os.path.join(d, "A.mtx"), os.path.join(d, "ord.txt")
        clf, bf = os.path.join(d, "clust.txt"), os.path.join(d, "B.mtx")
        sol, fac = os.path.join(d, "sol.txt"), os.path.join(d, "L.mtx")
        mmio.write_coo(mtx, r, c, v, (n, n), symmetry="hermitian")
        ordio.write_ordering(ordf, o)
        ordio.write_clusters(clf, cl)
        with open(bf, "w") as f:
            f.write(f"%%MatrixMarket matrix array integer general\n%\n"
                    f"{n} 1\n")
            f.writelines(f"{int(x)}\n" for x in b)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(["-i", mtx, "-s", ordf, "-c", clf, "-b", bf,
                           "-o", sol, "-m", fac])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc}:\n{log.getvalue()}")
        x = np.loadtxt(sol)
        lf = np.tril(scipy.io.mmread(fac).toarray())
    a = _csr(n, r, c, v)
    ref = scipy.sparse.linalg.spsolve(a.tocsc(), b)
    if not np.allclose(ref, x, rtol=1e-4, atol=1e-4):
        raise AssertionError("CLI solution differs from SciPy")
    pmat = permute_matrix_dense(build_plan(o), a.toarray())
    lref = scipy.linalg.cholesky(pmat, lower=True)
    if not np.allclose(lref, lf, rtol=1e-4, atol=1e-4):
        raise AssertionError("CLI factor differs from SciPy")
    res = _relres(a, b, x)
    if res > TOL:
        raise AssertionError(f"CLI residual {res:.3e} > {TOL}")
    times = {k: float(s.split("'time_s': ")[1].split(",")[0].rstrip("}"))
             for k, s in (("factor", _grep(log, "FACTOR:")),
                          ("solve", _grep(log, "SOLVE:")))}
    _print_phase("cli_15^3_f64", n, res, "n/a", times["factor"],
                 times["solve"],
                 f" cli_wall_s={wall:.2f}")


def _grep(log, prefix):
    return next(l for l in log.getvalue().splitlines() if l.startswith(prefix))


def _grid_phase(name, shape, levels, dtype, precision=None, mesh=None):
    """from_coo -> factorize -> solve at one configuration. The first
    factorize/solve compile; the second of each is the reported wall."""
    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl, dtype=dtype, mesh=mesh,
                                precision=precision)
    _, t_fac0 = _timed(s.factorize)
    _, t_fac = _timed(s.factorize)
    _, t_sol0 = _timed(lambda: s.solve(b, tol=TOL))
    with _Sweeps() as sw:
        x, t_sol = _timed(lambda: s.solve(b, tol=TOL))
    res = _relres(_csr(n, r, c, v), b, x)
    _print_phase(name, n, res, sw, t_fac, t_sol,
                 f" precision={s.precision or 'default'}"
                 f" first_factor_s={t_fac0:.2f} first_solve_s={t_sol0:.2f}")
    if not np.isfinite(res) or res > TOL:
        raise AssertionError(f"{name}: residual {res:.3e} > {TOL}")
    return s, x


def phase_kernels():
    """The card-only tests, run in this process (pytest in-process: a
    second JAX process could not get the card's memory)."""
    import pytest

    class Outcomes:
        def __init__(self):
            self.counts = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] = \
                    self.counts.get(report.outcome, 0) + 1

    # tests/conftest.py pins the CPU unless JAX_PLATFORMS names another
    # platform; the backend here is already up on the card
    os.environ["JAX_PLATFORMS"] = "cuda"
    oc = Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[oc])
    passed = oc.counts.get("passed", 0)
    print(f"phase=kernels tests_passed={passed} outcomes={oc.counts} "
          f"wall_s={time.perf_counter() - t0:.1f} peak_gib={_peak_gib():.3f}",
          flush=True)
    if rc != 0 or passed == 0 or set(oc.counts) != {"passed"}:
        raise AssertionError(f"card-only tests: rc={rc} {oc.counts}")


def phase_four(shape=(80, 80, 80), levels=10):
    """80^3 L10 over make_mesh(4): narrow-level subgroups and the 2-D root
    front engaged (call spies), leaf level sharded over all 4 devices,
    compared with the same problem on one card of this process."""
    import jax

    from cholesky_tpu.numeric import frontal
    from cholesky_tpu.parallel import dist_cholesky, dist_level
    from cholesky_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, found "
                           f"{len(jax.devices())}")
    calls = {"narrow": 0, "root2d": 0}
    orig_narrow = dist_level.factor_level_sharded
    orig_2d = dist_cholesky.distributed_cholesky_2d

    def spy_narrow(*a, **k):
        calls["narrow"] += 1
        return orig_narrow(*a, **k)

    def spy_2d(*a, **k):
        calls["root2d"] += 1
        return orig_2d(*a, **k)

    # the wire-volume router keeps 1-D at a 2x2 grid (dist_cholesky.
    # _pick_scheme); force the 2-D scheme so the 4-card run exercises it
    os.environ["CHOLESKY_TPU_ROOT_SCHEME"] = "2d"
    dist_level.factor_level_sharded = spy_narrow
    dist_cholesky.distributed_cholesky_2d = spy_2d
    frontal._LEVEL_JIT_CACHE.clear()
    try:
        mesh = make_mesh(4)
        s4, x4 = _grid_phase("4card_f32", shape, levels, np.float32,
                             mesh=mesh)
        leaf = s4.panels[s4.fplan.levels - 1]
        ndev_leaf = len(leaf.sharding.device_set)
    finally:
        dist_level.factor_level_sharded = orig_narrow
        dist_cholesky.distributed_cholesky_2d = orig_2d
        os.environ.pop("CHOLESKY_TPU_ROOT_SCHEME")
    if calls["narrow"] == 0 or calls["root2d"] == 0:
        raise AssertionError(f"4-card path not engaged: {calls}")
    if ndev_leaf != 4:
        raise AssertionError(f"leaf level on {ndev_leaf} devices, not 4")
    del s4
    _, x1 = _grid_phase("1card_f32", shape, levels, np.float32)
    rel = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
    print(f"phase=4card_vs_1card rel_diff={rel:.3e} narrow_calls="
          f"{calls['narrow']} root2d_calls={calls['root2d']} "
          f"leaf_devices={ndev_leaf}", flush=True)
    if rel > 1e-8:
        raise AssertionError(f"4-card vs 1-card solutions differ: {rel:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"'{jax.default_backend()}'", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import cholesky_tpu

    if not os.path.abspath(cholesky_tpu.__file__).startswith(ROOT + os.sep):
        print(f"chip_smoke: cholesky_tpu imported from "
              f"{cholesky_tpu.__file__}, not from {ROOT}", file=sys.stderr)
        return 2
    cholesky_tpu.enable_x64()
    cholesky_tpu.setup_compilation_cache()
    print(_card_line(), flush=True)

    if args.four:
        phases = [phase_four]
    else:
        phases = [
            phase_cli,
            lambda: _grid_phase("50^3_f32_auto", (50, 50, 50), 8,
                                np.float32),
            lambda: _grid_phase("50^3_f32_default", (50, 50, 50), 8,
                                np.float32, precision="default"),
            lambda: _grid_phase("50^3_f64", (50, 50, 50), 8, np.float64),
            lambda: _grid_phase("100^3_f32", (100, 100, 100), 13,
                                np.float32),
            phase_kernels,
        ]
    failed = 0
    for ph in phases:
        try:
            ph()
        except Exception:   # noqa: BLE001 — recorded, and fails the run
            failed += 1
            print("phase failed:", file=sys.stderr)
            traceback.print_exc()
    if failed:
        print(f"chip_smoke: {failed} phase(s) failed", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
