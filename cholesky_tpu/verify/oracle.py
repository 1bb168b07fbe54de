"""PanelsOracle — the teaching/verification engine.

This is the rebuild's ORACLE, not a production path: the dense ancestor-path
panel engine (numeric/factor.py + numeric/assemble.py) wrapped as a small,
explicitly-named cross-check. Its numeric structure is the most literal
batched translation of the reference's per-level schedule (one batched
POTRF/TRSM/SYRK triple per level over full ancestor-path panels,
mmat.rg:1211-1358), which makes it easy to audit — and its results validate
the production frontal engine's exact-boundary machinery in tests.

It stores each separator against its FULL ancestor path (O(path) memory and
FLOPs — fine at test sizes, wasteful at scale), supports one dtype and one
chip, and exposes only factorize/solve/factor_dense. Production code goes
through `cholesky_tpu.SparseCholesky` (the frontal engine).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cholesky_tpu.numeric import assemble
from cholesky_tpu.numeric import factor as nfactor
from cholesky_tpu.symbolic.plan import SolvePlan


class PanelsOracle:
    """Reference-structured panel factorization used to cross-check the
    production frontal engine (see tests/test_frontal.py)."""

    def __init__(self, plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, dtype=np.float64):
        self.plan = plan
        self.rows, self.cols, self.vals = rows, cols, vals
        self.dtype = dtype
        self.panels: Optional[list] = None

    def factorize(self):
        panels = assemble.assemble_panels(
            self.plan, self.rows, self.cols, self.vals, dtype=self.dtype)
        self.panels = nfactor.factor(self.plan, panels)
        return self.panels

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b (original dof order), one direct pass — the oracle
        has no refinement; use f64 for tight residuals."""
        if self.panels is None:
            self.factorize()
        blv = assemble.assemble_rhs(self.plan, b, dtype=self.dtype)
        xlv = nfactor.solve(self.plan, self.panels, blv)
        return assemble.extract_solution(self.plan,
                                         [np.asarray(x) for x in xlv])

    def factor_dense(self) -> np.ndarray:
        """The factor L as a dense lower-triangular array (permuted)."""
        if self.panels is None:
            self.factorize()
        return assemble.extract_factor_dense(
            self.plan, [np.asarray(p) for p in self.panels])
