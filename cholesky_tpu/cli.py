"""Command-line driver, flag-compatible with the reference solver binary.

The reference is driven as `regent.py mmat.rg -i M.mtx -s ord.txt -c clust.txt
-b B.mtx -o sol.txt -m factor.mtx [-p perm.mtx] [-d dbgdir] [--iterations N]`
plus Legion/Realm runtime flags (mmat.rg:1072-1093; test_matrices.py:23-35).
This driver accepts the same flags; Legion-specific runtime flags (-ll:cpu,
-ll:csize, -fflow, -fcuda, -lg:*) are accepted and ignored so the reference's
test harness command lines work verbatim.

Run: python -m cholesky_tpu.cli -i M.mtx -s ord.txt -c clust.txt -b B.mtx -o sol.txt
"""

from __future__ import annotations

import sys
import time

import numpy as np


_LEGION_PREFIXES = ("-ll:", "-lg:", "-level", "-logfile")
_LEGION_FLAGS_WITH_ARG = {"-fflow", "-fcuda", "-fopenmp", "-fjobs"}


def parse_args(argv):
    """Hand-rolled argv scan mirroring mmat.rg:1072-1093."""
    opts = {
        "matrix_file": "", "separator_file": "", "clusters_file": "",
        "b_file": "", "solution_file": "", "factor_file": "",
        "permuted_matrix_file": "", "debug_path": "", "debug": False,
        "iterations": 1, "dtype": "float64", "devices": 0,
        "bench": False,
        "profile": False, "debug_dumps": False,
        "save_factor": "", "load_factor": "", "inv_diag_file": "",
        "signs_file": "",
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            opts["matrix_file"] = argv[i + 1]; i += 2
        elif a == "-s":
            opts["separator_file"] = argv[i + 1]; i += 2
        elif a == "-c":
            opts["clusters_file"] = argv[i + 1]; i += 2
        elif a == "-m":
            opts["factor_file"] = argv[i + 1]; i += 2
        elif a == "-p":
            opts["permuted_matrix_file"] = argv[i + 1]; i += 2
        elif a == "-o":
            opts["solution_file"] = argv[i + 1]; i += 2
        elif a == "-b":
            opts["b_file"] = argv[i + 1]; i += 2
        elif a == "-d":
            opts["debug_path"] = argv[i + 1]; opts["debug"] = True; i += 2
        elif a == "--iterations":
            opts["iterations"] = int(argv[i + 1]); i += 2
        elif a == "--dtype":
            opts["dtype"] = argv[i + 1]; i += 2
        elif a == "--devices":
            opts["devices"] = int(argv[i + 1]); i += 2
        elif a == "--profile":
            opts["profile"] = True; i += 1
        elif a == "--debug-dumps":
            opts["debug_dumps"] = True; i += 1
        elif a == "--save-factor":
            opts["save_factor"] = argv[i + 1]; i += 2
        elif a == "--load-factor":
            opts["load_factor"] = argv[i + 1]; i += 2
        elif a == "--bench":
            opts["bench"] = True; i += 1
        elif a == "--inv-diag":
            opts["inv_diag_file"] = argv[i + 1]; i += 2
        elif a == "--signs":
            opts["signs_file"] = argv[i + 1]; i += 2
        elif a in _LEGION_FLAGS_WITH_ARG or a.startswith(_LEGION_PREFIXES):
            # Legion runtime passthroughs — accepted, ignored. Consume a
            # following value only when it is not itself a flag: zero-arg
            # Legion flags (-lg:spy, -ll:show_rsrv, ...) must not swallow
            # the next real option.
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 2
            else:
                i += 1
        else:
            i += 1
    return opts


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_args(argv)

    import cholesky_tpu

    if opts["dtype"] == "float64":
        cholesky_tpu.enable_x64()
    cholesky_tpu.setup_compilation_cache()
    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.io import mmio

    if not opts["matrix_file"]:
        print("usage: python -m cholesky_tpu.cli -i matrix.mtx [-s ord.txt] "
              "[-c clust.txt] [-b B.mtx] [-o solution.txt] [-m factor.mtx] "
              "[-p permuted.mtx] [-d debug_dir] [--iterations N] "
              "[--dtype float64|float32] [--devices N] "
              "[--profile] "
              "[--save-factor ckpt.npz] [--load-factor ckpt.npz] "
              "[--inv-diag out.txt] [--signs signs.txt]\n"
              "Without -s, a nested-dissection ordering is computed from the "
              "matrix sparsity graph.")
        return 2

    print(f"Iterations: {opts['iterations']}")
    banner = mmio.read_banner(opts["matrix_file"])
    print(f"M: {banner.rows} N: {banner.cols} nz: {banner.nnz} "
          f"typecode: {banner.typecode}")

    dtype = np.dtype(opts["dtype"])
    signs = None
    if opts["signs_file"]:
        # one +1/-1 per dof: symmetric quasi-definite LDL^T (numeric/ldlt)
        signs = np.loadtxt(opts["signs_file"], dtype=np.float64).reshape(-1)
        print(f"signature: {int((signs > 0).sum())} positive, "
              f"{int((signs < 0).sum())} negative (quasi-definite LDL^T)")
    mesh = None
    if opts["devices"] > 1:
        from cholesky_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(opts["devices"])
    if opts["separator_file"]:
        solver = SparseCholesky.from_files(
            opts["matrix_file"], opts["separator_file"],
            opts["clusters_file"] or None, dtype=dtype, mesh=mesh,
            signs=signs)
    else:
        # no ordering provided: compute nested dissection from the sparsity
        # graph (capability beyond the reference, which requires ord files)
        print("No separator file; computing nested-dissection ordering.")
        _, r, c_, v = mmio.read_coo(opts["matrix_file"])
        solver = SparseCholesky.from_matrix(
            banner.rows, r, c_, v, dtype=dtype, mesh=mesh, signs=signs)
    plan = solver.plan
    print(f"levels: {plan.levels}")
    print(f"separators: {plan.num_separators}")

    if opts["debug"]:
        from cholesky_tpu.symbolic import fill as fillmod
        from cholesky_tpu.verify import debuglog, schedule

        fa = fillmod.analyze_fill(plan, solver.rows, solver.cols, solver.vals)
        ops = schedule.generate_schedule(fa)
        log_path = debuglog.write_structure_log(
            plan, opts["debug_path"], fa, ops)
        print(f"debug log: {log_path}")
        if opts["debug_dumps"]:
            # per-op matrix snapshots for the bisecting oracle
            # (write_blocks parity, mmat.rg:174-218)
            from cholesky_tpu.verify import replay as replaymod

            pmat = solver.permuted_dense()
            replaymod.replay_schedule(pmat, ops, dump_dir=opts["debug_path"])
            print(f"debug dumps: {opts['debug_path']}/")

    if opts["permuted_matrix_file"]:
        pmat = solver.permuted_dense()
        print(f"saving matrix to: {opts['permuted_matrix_file']}\n")
        mmio.write_dense_coo(opts["permuted_matrix_file"], pmat,
                             symmetry=banner.symmetry)

    print("Done fill.")

    import jax

    if opts["profile"]:
        from cholesky_tpu.numeric import profile as prof

        from cholesky_tpu.numeric import frontal

        fronts = frontal.assemble_fronts(
            solver.fplan, solver.rows, solver.cols, solver.vals,
            dtype=dtype)
        prof.profile_frontal(solver.fplan, fronts)

    factor_times = []
    if opts["load_factor"]:
        # resume a checkpointed factorization (fingerprint-verified)
        solver.load_factor(opts["load_factor"])
        print(f"Loaded factor: {opts['load_factor']}")
    else:
        for iteration in range(opts["iterations"]):
            solver.assemble()
            t0 = time.perf_counter()
            panels = solver.factorize()
            jax.block_until_ready(panels)
            dt = time.perf_counter() - t0
            factor_times.append(dt)
            print(f"Done factoring Iteration: {iteration}.")
            print(f"FACTOR: {{'op': 'factor', 'iteration': {iteration}, "
                  f"'time_s': {dt:.6f}}}")
    if opts["save_factor"]:
        print(f"Saved factor: {solver.save_factor(opts['save_factor'])}")

    if opts["factor_file"]:
        fr, fc, fv = solver.factor_coo()
        print(f"saving matrix to: {opts['factor_file']}\n")
        mmio.write_coo(opts["factor_file"], fr, fc, fv,
                       (banner.rows, banner.cols), symmetry=banner.symmetry)

    if opts["b_file"]:
        b = mmio.read_array(opts["b_file"]).reshape(-1)
        t0 = time.perf_counter()
        x = solver.solve(b)
        solve_t = time.perf_counter() - t0
        print("Done solve.")
        print(f"SOLVE: {{'op': 'solve', 'time_s': {solve_t:.6f}, "
              f"'residual': {solver.residual(b, x):.3e}}}")
        if opts["solution_file"]:
            print(f"Saving solution to: {opts['solution_file']}")
            with open(opts["solution_file"], "w") as f:
                for v in x:
                    f.write(f"{v:.17g}\n")

    if opts["inv_diag_file"]:
        # selected inversion: diag(A^-1) in original dof order, one value
        # per line (numeric/selinv.py; beyond the reference)
        t0 = time.perf_counter()
        d = solver.inv_diag()
        print(f"INVDIAG: {{'op': 'inv_diag', "
              f"'time_s': {time.perf_counter() - t0:.6f}}}")
        with open(opts["inv_diag_file"], "w") as f:
            for v in d:
                f.write(f"{v:.17g}\n")
        print(f"Saved diag(A^-1) to: {opts['inv_diag_file']}")

    if opts["bench"]:
        import json

        if factor_times:
            print(json.dumps({"metric": "factor_wall_s",
                              "value": min(factor_times), "unit": "s"}))
        else:
            print(json.dumps({"metric": "factor_wall_s", "value": None,
                              "unit": "s", "note": "--iterations 0"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
