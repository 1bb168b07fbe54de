#!/usr/bin/env python
"""Solve an arbitrary SPD MatrixMarket file end to end, no ordering files.

    python examples/solve_mtx.py A.mtx [B.mtx]

Computes a nested-dissection ordering from the sparsity graph, factors in
fp32 with iterative refinement to 1e-10 (f64 on request via
--dtype float64), reports residual, logdet, and a condition estimate.
The reference solver requires precomputed ord/clust files for this; here
they are derived (symbolic/nd.py).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("matrix")
    ap.add_argument("rhs", nargs="?", help="MatrixMarket array RHS (default: random)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--levels", type=int, default=None)
    args = ap.parse_args()

    import cholesky_tpu

    if args.dtype == "float64":
        cholesky_tpu.enable_x64()
    cholesky_tpu.setup_compilation_cache()
    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.io import mmio

    banner, r, c, v = mmio.read_coo(args.matrix)
    print(f"{args.matrix}: {banner.rows}x{banner.cols}, nnz={banner.nnz}")

    t0 = time.time()
    s = SparseCholesky.from_matrix(banner.rows, r, c, v,
                                   levels=args.levels,
                                   dtype=np.dtype(args.dtype))
    print(f"ordering+plan: {time.time()-t0:.2f}s "
          f"({s.plan.levels} levels, {s.plan.num_separators} separators)")

    t0 = time.time()
    s.factorize(check=True)
    print(f"factorize: {time.time()-t0:.2f}s (includes compile)")

    b = (mmio.read_array(args.rhs).reshape(-1) if args.rhs
         else np.random.default_rng(0).standard_normal(banner.rows))
    t0 = time.time()
    x = s.solve(b)
    print(f"solve: {time.time()-t0:.2f}s")
    print(f"residual ||Ax-b||/||b||: {s.residual(b, x):.3e}")
    print(f"logdet(A): {s.logdet():.6g}")
    print(f"condest(A): {s.condest():.3e}")


if __name__ == "__main__":
    main()
