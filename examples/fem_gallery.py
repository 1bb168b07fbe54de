#!/usr/bin/env python
"""Factor and solve every problem in the SPD gallery (utils/problems.py):
anisotropic stencils, Wathen-style random-coefficient FEM, elasticity-style
vector blocks, random/circuit graphs — all through scipy interop and the
auto-nested-dissection path, to the 1e-10 residual contract.

    python examples/fem_gallery.py [--dtype float32] [--scale 2]

--scale multiplies the default problem sizes (the gallery defaults are
CPU-test-sized; --scale 4 reaches ~100k-dof problems worth running on the
card). The reference solver cannot run any of these: it requires offline
ord/clust files and ships only grid-Laplacian fixtures.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="run on host CPU (JAX_PLATFORMS env is ignored "
                         "by this image's jax; only the config works)")
    args = ap.parse_args()

    import cholesky_tpu

    if args.cpu:
        cholesky_tpu.force_cpu()
    if args.dtype == "float64":
        cholesky_tpu.enable_x64()
    cholesky_tpu.setup_compilation_cache()
    import scipy.sparse as sp

    from cholesky_tpu import SparseCholesky
    from cholesky_tpu.utils import problems

    gallery = problems.make_gallery(args.scale)
    rng = np.random.default_rng(0)
    for name, gen in gallery.items():
        n, r, c, v = gen()
        a = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
        b = rng.standard_normal(n)
        t0 = time.time()
        s = SparseCholesky.from_scipy(a, dtype=args.dtype)
        t_plan = time.time() - t0
        t0 = time.time()
        s.factorize()
        x = s.solve(b)
        t_solve = time.time() - t0
        print(f"{name:11s} n={n:>8d} nnz={a.nnz:>9d} "
              f"plan {t_plan:6.2f}s  factor+solve {t_solve:6.2f}s  "
              f"residual {s.residual(b, x):.2e}")


if __name__ == "__main__":
    main()
