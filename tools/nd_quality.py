"""Ordering-quality comparison CLI: auto-ND vs RCM vs natural.

For each gallery problem, compute the scalar sparse-Cholesky cost of the
permutation produced by (a) cholesky_tpu's graph nested dissection — both at
auto depth (with the expander depth-collapse policy) and at a forced deep
tree, (b) scipy's reverse Cuthill-McKee, and (c) the natural ordering — via
exact symbolic elimination (symbolic/quality.py). Ratios < 1 mean ND is
cheaper.

Run: python tools/nd_quality.py [scale]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from cholesky_tpu.symbolic.quality import (fill_flops, nd_cost, rcm_cost,
                                           superlu_cost)
from cholesky_tpu.utils import problems


def compare(names=None, scale=1, deep_levels=8):
    gallery = problems.make_gallery(scale)
    out = {}
    for name in (names or gallery):
        n, r, c, v = gallery[name]()
        f_auto, z_auto = nd_cost(n, r, c)
        f_deep, z_deep = nd_cost(n, r, c, levels=deep_levels)
        f_rcm, z_rcm = rcm_cost(n, r, c, v)
        f_mmd, z_mmd = superlu_cost(n, r, c, v, "MMD_AT_PLUS_A")
        f_cola, z_cola = superlu_cost(n, r, c, v, "COLAMD")
        f_nat, _ = fill_flops(n, r, c)
        out[name] = {"n": n, "nd_auto_flops": f_auto,
                     "nd_deep_flops": f_deep, "rcm_flops": f_rcm,
                     "mmd_flops": f_mmd, "colamd_flops": f_cola,
                     "nat_flops": f_nat, "nd_deep_nnz": z_deep,
                     "rcm_nnz": z_rcm, "mmd_nnz": z_mmd,
                     "deep_vs_rcm": f_deep / f_rcm,
                     "deep_vs_mmd": f_deep / f_mmd,
                     "nnz_vs_rcm": z_deep / z_rcm,
                     "nnz_vs_mmd": z_deep / z_mmd}
    return out


if __name__ == "__main__":
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    rows = compare(scale=scale)
    print(f"{'problem':<12} {'n':>7} {'ND-auto':>9} {'ND-deep':>9} "
          f"{'MMD':>9} {'COLAMD':>9} {'RCM':>9} {'natural':>9} "
          f"{'deep/MMD':>9} {'nnzD/MMD':>9}   (GFLOP)")
    for name, d in rows.items():
        print(f"{name:<12} {d['n']:>7} {d['nd_auto_flops']/1e9:>9.3f} "
              f"{d['nd_deep_flops']/1e9:>9.3f} {d['mmd_flops']/1e9:>9.3f} "
              f"{d['colamd_flops']/1e9:>9.3f} {d['rcm_flops']/1e9:>9.3f} "
              f"{d['nat_flops']/1e9:>9.3f} {d['deep_vs_mmd']:>9.3f} "
              f"{d['nnz_vs_mmd']:>9.3f}")
