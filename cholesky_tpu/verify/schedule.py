"""Reference-schedule generation: the exact per-cluster op sequence the
reference executes (mmat.rg:1227-1355 driving the fused_* tasks,
blas.rg:293-503), derived from the host-side fill analysis.

This is NOT the fast path — the numeric phase runs batched panel kernels.
The explicit op list exists for (a) the `-d` debug log + replay oracle,
(b) cluster-level FLOP accounting, (c) parity tests: replaying this schedule
in NumPy must reproduce the fast path's factor bit-for-bit-ish (1e-12).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

from cholesky_tpu.symbolic.fill import FillAnalysis

Rect = Tuple[int, int, int, int]   # inclusive (lo_r, lo_c, hi_r, hi_c)


@dataclasses.dataclass
class Op:
    kind: str                      # 'POTRF' | 'TRSM' | 'SYRK' | 'GEMM'
    level: int
    interval: int                  # interval label (levels-1-level)
    a: Tuple[int, int, int]        # A cluster color (row_sep, col_sep, z)
    a_rect: Rect
    b: Optional[Tuple[int, int, int]] = None
    b_rect: Optional[Rect] = None
    c: Optional[Tuple[int, int, int]] = None
    c_rect: Optional[Rect] = None

    @property
    def block(self) -> Tuple[int, int]:
        """The block a debug log line attributes the op to (the written one)."""
        if self.kind == "POTRF":
            return (self.a[0], self.a[1])
        if self.kind == "TRSM":
            return (self.b[0], self.b[1])
        return (self.c[0], self.c[1])


def generate_schedule(fill: FillAnalysis) -> List[Op]:
    return list(iter_schedule(fill))


def iter_schedule(fill: FillAnalysis) -> Iterator[Op]:
    plan = fill.plan
    t = plan.tree
    levels = plan.levels

    for lvl in range(levels - 1, -1, -1):
        lbl = fill.label_for_level(lvl)
        snap = fill.snapshots[lbl]

        # Phase 1 — POTRF over filled diagonal clusters (fused_dpotrf,
        # blas.rg:293-315; launched per separator, mmat.rg:1240-1245)
        for s in t.level_seps(lvl):
            bc = snap[(s, s)]
            for z, (r, c) in _filled_z(bc):
                yield Op("POTRF", lvl, lbl, (s, s, z),
                         bc.cluster_rect(plan, r, c))

        # Phase 2 — TRSM of every ancestor off-diagonal block against the
        # pivot (fused_dtrsm, blas.rg:318-351; mmat.rg:1259-1290)
        for s in t.level_seps(lvl):
            pivot = snap[(s, s)]
            piv_filled = list(_filled_z(pivot))
            for par in t.ancestors(s):
                bc = snap[(par, s)]
                for za, (ra, ca) in piv_filled:
                    for zb, (rb, cb) in _filled_z(bc):
                        yield Op("TRSM", lvl, lbl,
                                 (s, s, za), pivot.cluster_rect(plan, ra, ca),
                                 (par, s, zb), bc.cluster_rect(plan, rb, cb))

        # Phase 3 — Schur updates (fused_dsyrk/fused_dgemm, blas.rg:353-504;
        # mmat.rg:1293-1346). A=(gp,sep), B=(par,sep), C=(gp,par).
        for s in t.level_seps(lvl):
            anc = t.ancestors(s)
            for pi, par in enumerate(anc):
                for gp in [par] + anc[pi + 1:]:
                    A = snap[(gp, s)]
                    B = snap[(par, s)]
                    C = snap[(gp, par)]
                    ncC = C.nc
                    for za, (ra, ca) in _filled_z(A):
                        for zb, (rb, cb) in _filled_z(B):
                            row, col = za, zb   # strips: z == row index
                            if gp == par and col > row:
                                continue        # upper triangle skipped (blas.rg:399,417)
                            zc = row * ncC + col
                            cr, cc = row, col
                            kind = "SYRK" if (gp == par and col == row) else "GEMM"
                            yield Op(kind, lvl, lbl,
                                     (gp, s, za), A.cluster_rect(plan, ra, ca),
                                     (par, s, zb), B.cluster_rect(plan, rb, cb),
                                     (gp, par, zc), C.cluster_rect(plan, cr, cc))


def _filled_z(bc) -> List[Tuple[int, Tuple[int, int]]]:
    """Filled clusters in z order (z = row * nc + col — the region iteration
    order of the reference's Filled lists)."""
    out = []
    nc = bc.nc
    for r in range(bc.nr):
        for c in range(nc):
            if bc.filled[r, c]:
                out.append((r * nc + c, (r, c)))
    return out


def schedule_flops(ops: List[Op]) -> float:
    """Cluster-level FLOP count of the factorization schedule (the work the
    reference actually does — the yardstick for GFLOP/s accounting)."""
    total = 0.0
    for op in ops:
        m = op.a_rect[2] - op.a_rect[0] + 1
        n = op.a_rect[3] - op.a_rect[1] + 1
        if op.kind == "POTRF":
            total += n ** 3 / 3.0
        elif op.kind == "TRSM":
            bm = op.b_rect[2] - op.b_rect[0] + 1
            total += bm * n * n
        elif op.kind == "SYRK":
            cn = op.c_rect[3] - op.c_rect[1] + 1
            total += cn * (cn + 1) * n
        else:  # GEMM
            cm = op.c_rect[2] - op.c_rect[0] + 1
            cn = op.c_rect[3] - op.c_rect[1] + 1
            total += 2.0 * cm * cn * n
    return total
