"""High-level user API: load → plan → assemble → factor → solve.

The equivalent of the reference driver's main() flow (mmat.rg:1056-1496) as a
library object instead of a CLI-only binary.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from cholesky_tpu.io import mmio, ordering as ordio
from cholesky_tpu.numeric import assemble
from cholesky_tpu.symbolic.plan import SolvePlan, build_plan

_PRECISIONS = ("default", "high", "highest", "bfloat16", "tensorfloat32",
               "float32")

# AUTO precision ladder (precision=None, fp32): executed frontal FLOPs at or
# below this pick the 'highest' (full-f32) factor, which costs factor time
# but cuts refinement sweeps; above it the factorization wall dominates and
# the 'default' factor wins. 50^3 executes ~0.35 TFLOP, 80^3 ~2.2 TFLOP.
# The value was calibrated on the first target device and awaits re-setting
# from card measurements (chip_smoke.py prints the 50^3 default/highest
# pair; tools/exp_solve_matrix.py sweeps it). The env knob is read at use
# time like every sibling CHOLESKY_TPU_* knob (setting it after import must
# work).
_AUTO_HIGHEST_FLOPS = 1e12


def _auto_highest_flops() -> float:
    env = os.environ.get("CHOLESKY_TPU_AUTO_HIGHEST_FLOPS")
    return float(env) if env is not None else _AUTO_HIGHEST_FLOPS


def _precision_ctx(prec: Optional[str]):
    """Context manager applying a matmul-precision override for everything
    traced inside (the config value is part of jax's jit cache key, so
    per-precision programs coexist). On the GPU, f32 matmuls at 'default'
    may run as TF32 on the tensor cores (10-bit mantissa operands, f32
    accumulation); 'highest'/'float32' run full-f32 FMA on the CUDA cores.
    f64 matmuls are native f64 whatever the setting."""
    import contextlib

    if not prec or prec == "default":
        return contextlib.nullcontext()
    import jax

    return jax.default_matmul_precision(prec)


def _with_precision(fn):
    """Method decorator: run the body under the solver's matmul-precision
    override, so EVERY factor-application surface (solves, selected
    inversion, sampling, Schur reads, gradients) delivers the accuracy the
    precision knob paid for — not just factorize/solve. Nesting with an
    identical inner context is harmless."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with _precision_ctx(self.precision):
            return fn(self, *args, **kwargs)
    return wrapper


class SparseCholesky:
    """Sparse SPD Cholesky solver over a nested-dissection ordering.

    Usage:
        solver = SparseCholesky.from_files(mtx, ord_file, clust_file)
        solver.factorize()
        x = solver.solve(b)          # b in original dof order
    """

    def __init__(self, plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, dtype=np.float64, mesh=None,
                 signs=None, precision: Optional[str] = None):
        import os

        precision = precision or os.environ.get("CHOLESKY_TPU_PRECISION")
        if precision is not None and precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}")
        # Matmul precision of the factorization AND of the refinement loop's
        # factor applications (both must match: the refinement contraction
        # rate is set by the WORSE of factor-construction and factor-
        # application error). 'default' maximizes factor throughput (TF32
        # tensor cores) at the cost of more IR sweeps; 'highest' (full f32)
        # needs fewer sweeps at a higher factor wall. None = AUTO: resolve
        # from plan statistics at first use (see precision property); pass
        # 'default' to force the fast factor.
        self._precision = precision
        self.plan = plan
        self.rows, self.cols, self.vals = rows, cols, vals
        self.dtype = dtype
        self.mesh = mesh            # optional jax.sharding.Mesh for multichip
        self.signs = None           # quasi-definite signature (numeric/ldlt)
        if signs is not None:
            signs = np.asarray(signs, dtype=np.float64).reshape(-1)
            if signs.shape[0] != plan.n or not np.all(np.abs(signs) == 1.0):
                raise ValueError("signs must be [n] of +1/-1")
            if np.all(signs == 1.0):
                signs = None        # all-positive signature IS Cholesky
            self.signs = signs
        self.panels = None          # assembled (pre-factor) or factored panels
        self.factored = False
        self._csr = None            # cached scipy CSR for residual/matvec
        self._fplan = None          # frontal symbolic plan

    # ------------------------------------------------------------------
    @property
    def precision(self) -> Optional[str]:
        """Effective matmul precision. Explicit (ctor kwarg, env, factorize
        override) wins; otherwise AUTO from plan statistics: fp32 factors
        whose executed frontal FLOPs are at most _AUTO_HIGHEST_FLOPS are
        solve-dominated and take the 'highest' factor, which costs factor
        wall but cuts IR sweeps; past the threshold the factorization
        dominates and the 'default' factor is used."""
        if self._precision is not None:
            return None if self._precision == "default" else self._precision
        if (np.dtype(self.dtype) != np.float32 or self.signs is not None
                or self.factored):
            # f64 needs no ladder; LDL^T solves host-side; a factor that
            # already exists was built at the resolved-then precision —
            # never flip mid-life (solve must apply at the factor's own
            # precision)
            return self._precision_resolved \
                if getattr(self, "_precision_resolved", None) else None
        from cholesky_tpu.utils import capacity

        auto = ("highest" if capacity.frontal_flops(self.fplan)
                <= _auto_highest_flops() else None)
        self._precision_resolved = auto
        return auto

    @precision.setter
    def precision(self, value: Optional[str]) -> None:
        self._precision = value
        self._precision_resolved = None

    @classmethod
    def from_files(cls, matrix_file: str, separator_file: str,
                   clusters_file: Optional[str] = None, dtype=np.float64,
                   pad_to: int = 8, mesh=None, signs=None,
                   precision: Optional[str] = None) -> "SparseCholesky":
        ordng = ordio.parse_ordering(separator_file)
        clusters = ordio.parse_clusters(clusters_file) if clusters_file else None
        plan = build_plan(ordng, clusters, pad_to=pad_to)
        banner, r, c, v = mmio.read_coo(matrix_file)
        if banner.rows != plan.n:
            raise ValueError(
                f"matrix dim {banner.rows} != ordering dof count {plan.n}")
        # normalize to lower triangle; 'general'-symmetry files store both
        # triangles, so deduplicate (mmio.dedup_lower)
        r2, c2, v2 = mmio.dedup_lower(r, c, v)
        return cls(plan, r2, c2, v2, dtype=dtype, mesh=mesh,
                   signs=signs, precision=precision)

    @classmethod
    def from_matrix(cls, n: int, rows, cols, vals, levels=None,
                    dtype=np.float64, mesh=None,
                    signs=None, precision: Optional[str] = None,
                    _canonical: bool = False):
        """Solve an arbitrary SPD — or, with `signs`, symmetric
        quasi-definite — matrix with NO precomputed ordering: a nested-
        dissection ordering is computed from the sparsity graph
        (symbolic/nd.py). The reference has no equivalent — it requires
        offline ord/clust files and is SPD-only.

        `_canonical=True` asserts the COO is already lower-triangle with
        unique coordinates (from_scipy's fold guarantees this), skipping a
        redundant O(nnz log nnz) dedup pass."""
        from cholesky_tpu.symbolic.nd import nested_dissection_graph

        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        ordng, clusters = nested_dissection_graph(n, rows, cols, levels)
        return cls.from_coo(n, rows, cols, vals, ordng, clusters,
                            dtype=dtype, mesh=mesh,
                            signs=signs, precision=precision,
                            _canonical=_canonical)

    @classmethod
    def from_scipy(cls, a, dtype=None, levels=None, mesh=None,
                   signs=None, precision: Optional[str] = None):
        """Build from a scipy sparse matrix (any format) or a dense
        symmetric ndarray. Accepts the lower triangle, the upper triangle,
        or a fully-populated symmetric matrix: (i,j)/(j,i) pairs fold to
        the lower triangle by averaging, so a full symmetric store and a
        one-triangle store give identical input. `dtype=None` keeps the
        matrix's own dtype."""
        import scipy.sparse as _sp

        if _sp.issparse(a):
            if a.shape[0] != a.shape[1]:
                raise ValueError("matrix must be square")
            # canonicalize through CSR first: scipy's COO convention sums
            # duplicate coordinates; the triangle fold below must then see
            # at most one entry per (i,j)
            coo = a.tocsr().tocoo()
            n, r, c, v = coo.shape[0], coo.row, coo.col, coo.data
        else:
            arr = np.asarray(a)
            if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
                raise ValueError("dense input must be square 2-D")
            r, c = np.nonzero(arr)
            n, v = arr.shape[0], arr[r, c]
        # a full symmetric store carries each off-diagonal twice; fold
        # (i,j)/(j,i) to the lower triangle by MEAN so one-triangle and
        # full-symmetric stores produce identical COO input
        off = r != c
        lo_r = np.where(off & (r < c), c, r)
        lo_c = np.where(off & (r < c), r, c)
        key = lo_r.astype(np.int64) * n + lo_c
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        v64 = np.asarray(v, dtype=np.float64)[order]
        uniq, start, counts = np.unique(key_s, return_index=True,
                                        return_counts=True)
        vsum = np.add.reduceat(v64, start)
        vmean = vsum / counts
        # symmetry guard: where BOTH triangles are stored, (i,j) and (j,i)
        # must agree — silently averaging a nonsymmetric matrix would
        # return a confidently wrong answer for the system the user meant
        both = counts == 2
        if np.any(both):
            second = np.minimum(start + 1, v64.size - 1)
            va, vb = v64[start[both]], v64[second[both]]
            scale = np.maximum(np.abs(va), np.abs(vb))
            bad = np.abs(va - vb) > 1e-8 * np.maximum(scale, 1e-30)
            if np.any(bad):
                k = int(np.flatnonzero(bad)[0])
                ij = uniq[both][k]
                raise ValueError(
                    f"matrix is not symmetric: A[{ij // n},{ij % n}] stores "
                    f"{va[k]!r} and {vb[k]!r} across the two triangles "
                    "(this solver is for symmetric positive-definite "
                    "systems; symmetrize explicitly if intended)")
        rr, cc = uniq // n, uniq % n
        if dtype is None:
            dtype = np.asarray(v).dtype
            if np.dtype(dtype).kind != "f":
                dtype = np.float64
        return cls.from_matrix(int(n), rr, cc, vmean, levels=levels,
                               dtype=dtype, mesh=mesh,
                               signs=signs, precision=precision,
                               _canonical=True)

    @classmethod
    def from_coo(cls, n: int, rows, cols, vals, ordng: ordio.Ordering,
                 clusters=None, dtype=np.float64, pad_to: int = 8, mesh=None,
                 signs=None, precision: Optional[str] = None,
                 _canonical: bool = False):
        plan = build_plan(ordng, clusters, pad_to=pad_to)
        if plan.n != n:
            raise ValueError("ordering does not cover the matrix dimension")
        if _canonical:
            r2 = np.asarray(rows, dtype=np.int64)
            c2 = np.asarray(cols, dtype=np.int64)
            v2 = np.asarray(vals, dtype=np.float64)
        else:
            r2, c2, v2 = mmio.dedup_lower(rows, cols, vals)
        return cls(plan, r2, c2, v2, dtype=dtype, mesh=mesh,
                   signs=signs, precision=precision)

    # ------------------------------------------------------------------
    @property
    def fplan(self):
        if self._fplan is None:
            from cholesky_tpu.numeric import frontal

            self._fplan = frontal.build_frontal_plan(
                self.plan, self.rows, self.cols)
        return self._fplan

    def assemble(self) -> List[np.ndarray]:
        """(Re)build the numeric buffers from the COO input (the reference's
        fill loop, mmat.rg:1175-1183; re-run per --iterations, mmat.rg:1216)."""
        from cholesky_tpu.numeric import frontal

        if self._device_assembly_ok():
            # in-core: refill runs as one compiled scatter per level on
            # device — only the [nnz] values cross host->device (the
            # reference re-runs host fill_block per iteration,
            # mmat.rg:1216-1224)
            buffers = self._assembler()(self.vals, dtype=self.dtype)
        elif self._lazy_assembly_ok():
            # streamed regime: per-level on-device assembly right before
            # each level's program (LazyFronts) — values-only upload
            # like the in-core path, but only the CURRENT level's slab
            # ever resides in HBM alongside the factors
            buffers = frontal.LazyFronts(self._assembler(), self.vals,
                                         dtype=self.dtype)
        else:
            buffers = frontal.assemble_fronts(
                self.fplan, self.rows, self.cols, self.vals,
                dtype=self.dtype)
        if self.mesh is not None:
            from cholesky_tpu.parallel.mesh import distribute_panels

            buffers = distribute_panels(buffers, self.mesh)
        self.panels = buffers
        self.factored = False
        return self.panels

    def coo_pattern(self):
        """The canonical sparsity pattern (0-based lower-triangle rows, cols)
        that `update_values(vals)` must align with."""
        return self.rows, self.cols

    def update_values(self, vals, rows=None, cols=None):
        """Replace the matrix's numeric values, keeping the sparsity pattern
        and every symbolic artifact (ordering, fill plan, panel shapes).

        The next factorize()/solve() re-runs only the numeric phase through
        the already-compiled per-level programs — no recompilation, since the
        shapes are unchanged. This is the production "same structure, new
        coefficients" loop (time stepping, Newton iterations) and the API
        form of the reference's per-iteration refill (mmat.rg:1212-1224,
        which re-runs fill_block then refactors under the same partitions).

        With only `vals`, entries must align with `coo_pattern()` (the
        deduplicated lower triangle). With `rows`/`cols`, any COO layout of
        the SAME pattern is accepted (either triangle, duplicates dropped as
        at construction) and checked against the stored pattern.
        """
        if (rows is None) != (cols is None):
            raise ValueError("pass both rows and cols, or neither")
        if rows is not None:
            r2, c2, v2 = mmio.dedup_lower(rows, cols, vals)
            # dedup_lower preserves input entry order, so compare patterns
            # canonically and realign the values to the stored entry order
            n = int(self.plan.n)
            key_new = r2 * n + c2
            key_old = self.rows * n + self.cols
            order_new = np.argsort(key_new)
            order_old = np.argsort(key_old)
            if (len(r2) != len(self.rows)
                    or not np.array_equal(key_new[order_new],
                                          key_old[order_old])):
                raise ValueError(
                    "sparsity pattern differs from the planned matrix — "
                    "build a new SparseCholesky for a new pattern")
            vals = np.empty_like(v2)
            vals[order_old] = v2[order_new]
        else:
            vals = np.asarray(vals, dtype=np.float64)
            if vals.shape != self.vals.shape:
                raise ValueError(
                    f"expected {self.vals.shape[0]} values aligned with "
                    f"coo_pattern(), got {vals.shape}")
        self.vals = vals
        # drop everything derived from the old values; symbolic state
        # (plan, fplan) and compiled programs are value-independent
        self.panels = None
        self.factored = False
        self._csr = None
        for attr in ("_ell_cache", "_ell_pad_cache", "_perm_coo_cache",
                     "_inv_cache", "_inv_cache_key"):
            if hasattr(self, attr):
                delattr(self, attr)

    def factorize(self, check: bool = False,
                  precision: Optional[str] = None):
        """Numeric factorization. With `check=True`, verify every pivot came
        out finite and positive afterwards and raise ArithmeticError naming
        the first bad separator — the LAPACK `info`-style diagnosis the
        reference also lacks (its dpotrf return is ignored, blas.rg:63-79).
        Off by default: the check syncs the device once per level.

        `precision` overrides the solver-level matmul precision for this
        factorization (see __init__; sticky — solves apply the factor at the
        same precision)."""
        if precision is not None:
            if precision not in _PRECISIONS:
                raise ValueError(f"precision must be one of {_PRECISIONS}")
            self.precision = precision
        if self.panels is None or self.factored:
            self.assemble()
        with _precision_ctx(self.precision):
            if self.signs is not None:
                from cholesky_tpu.numeric import ldlt

                self.panels = ldlt.factor_qd(self.fplan, self.panels,
                                             self.signs)
            else:
                from cholesky_tpu.numeric import frontal

                self.panels = frontal.factor(self.fplan, self.panels,
                                             root_mesh=self.mesh)
        self.factored = True
        if check:
            self._check_pivots()
        return self.panels

    def _check_pivots(self) -> None:
        """Raise if any factor pivot is non-finite or <= 0 (non-SPD input,
        or catastrophic cancellation in low precision)."""
        import jax.numpy as jnp

        widths = self.fplan.W
        for lvl, p in enumerate(self.panels):
            w = int(widths[lvl])
            if w == 0 or p.shape[0] == 0:
                continue
            d = np.asarray(jnp.diagonal(p[:, :w, :w], axis1=1, axis2=2)
                           ).astype(np.float64)
            bad = ~(np.isfinite(d) & (d > 0))
            if bad.any():
                slot, idx = np.argwhere(bad)[0]
                raise ArithmeticError(
                    f"factorization failed: non-positive/non-finite pivot at "
                    f"tree level {lvl}, separator slot {slot}, local dof "
                    f"{idx} — input matrix is not positive definite (or lost "
                    f"definiteness in {np.dtype(self.dtype).name})")

    def _solve_once(self, b: np.ndarray) -> np.ndarray:
        if not self.factored:
            self.factorize()
        if self.signs is not None:
            from cholesky_tpu.numeric import ldlt

            b = np.asarray(b, dtype=self.dtype)
            squeeze = b.ndim == 1
            bp = b.reshape(self.plan.n, -1)[self.plan.perm]
            xp = np.stack([
                np.asarray(ldlt.solve_qd(self.fplan, self.panels, self.signs,
                                         bp[:, j]))
                for j in range(bp.shape[1])], axis=1)
            x = np.empty_like(xp)
            x[self.plan.perm] = xp
            return x[:, 0] if squeeze else x
        from cholesky_tpu.numeric import frontal

        b = np.asarray(b, dtype=self.dtype)
        if b.ndim == 2:
            bp = b[self.plan.perm, :]
            x_perm = np.asarray(
                frontal.solve_multi(self.fplan, self.panels, bp))
            x = np.empty_like(x_perm)
            x[self.plan.perm, :] = x_perm
            return x
        bp = b.reshape(-1)[self.plan.perm]
        x_perm = np.asarray(frontal.solve(self.fplan, self.panels, bp))
        x = np.empty(self.plan.n, dtype=x_perm.dtype)
        x[self.plan.perm] = x_perm
        return x

    def solve(self, b: np.ndarray, refine: str = "auto", tol: float = 1e-10,
              max_iter: int = 50) -> np.ndarray:
        """Solve A x = b; b and x are in ORIGINAL dof order.

        refine: 'auto' runs mixed-precision iterative refinement when the
        factor is below float64 — the standard recipe for hitting the 1e-10
        residual contract with a fast low-precision factorization (factor in
        fp32, residual in f64, repeat). 'never' disables it,
        'always' forces it even for f64 factors.

        tol: relative-residual target. The default is the framework's 1e-10
        residual contract (BASELINE.md); each refinement sweep gains several
        digits, so solves typically land well under it (~5e-12 at 50³). A
        tol below ~1e-13 sits under the double-float residual floor and just
        runs the device loop to its stagnation guard (~2 wasted sweeps,
        ~40% of solve wall at 125k dofs) — pass 1e-12 only when the extra
        digit is actually needed. Derived-quantity helpers that compose
        several solves (solve_updated, solve_grad, …) keep a tighter 1e-12
        default because their error amplifies.
        """
        with _precision_ctx(self.precision):
            return self._solve_impl(b, refine, tol, max_iter)

    def _solve_impl(self, b, refine, tol, max_iter):
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 1 or b.shape[1] == 1:
            b = b.reshape(-1)
        want_ir = refine == "always" or (
            refine == "auto" and np.dtype(self.dtype) != np.float64)
        if not want_ir:
            return self._solve_once(b).astype(np.float64)

        import os

        import jax

        mode = os.environ.get("CHOLESKY_TPU_DEVICE_IR", "df")
        if self.signs is not None:
            mode = "0"      # quasi-definite: host Richardson loop below
                            # (the device-IR programs assume the SPD factor)
        x = None
        if mode == "1" and b.ndim == 1 and jax.config.jax_enable_x64:
            # legacy device-resident refinement with an f64 segment-sum
            # matvec
            from cholesky_tpu.numeric import frontal

            if not self.factored:
                self.factorize()
            pr, pc, pv = self._perm_coo()
            x_perm, _ = frontal.solve_refined_device(
                self.fplan, self.panels, b[self.plan.perm], pr, pc, pv,
                tol=tol, max_iter=max_iter)
            x = np.empty(self.plan.n)
            x[self.plan.perm] = np.asarray(x_perm)
            return x
        if b.ndim == 2 and b.shape[1] == 0:
            return np.zeros((self.plan.n, 0))
        if mode != "0" and b.ndim == 2:
            # multi-RHS device-resident refinement: the whole [n, k] block
            # refines in one while_loop (solves vmapped over columns; one
            # batched double-float residual) — the host fallback would pay
            # a k-wide CSR matvec plus an [n, k] round trip per iteration
            from cholesky_tpu.numeric import refine

            if not self.factored:
                self.factorize()
            ell = self._ell_perm()
            if ell is not None and not self._multi_ir_fits(
                    ell[0].shape[1], b.shape[1]):
                # very wide blocks: the batched double-float residual holds
                # several [n, K, k] temporaries — past the budget, fall to
                # the host loop (CSR matvec + batched device solves), which
                # is memory-flat in k
                ell = None
            if ell is not None and not self._device_ir_fits():
                ell = None      # see _device_ir_fits (cast hoisting)
            if ell is not None:
                x_perm, _, rn_rel = refine.solve_refined_df_multi(
                    self.fplan, self.panels, b[self.plan.perm, :], ell,
                    tol=tol / 3.0, max_iter=max_iter,
                    inv_pivots=(self._inv_pivots()
                                if self._want_inv_pivots() else None))
                x = np.empty((self.plan.n, b.shape[1]))
                x[self.plan.perm, :] = x_perm
                if rn_rel <= tol:
                    return x
        if mode != "0" and b.ndim == 1:
            # default device-resident refinement: f32 triangular solves +
            # double-float (f32-pair) compensated residuals in one jitted
            # while_loop — no f64 emulation, no per-iteration host round
            # trips (numeric/refine.py). Falls through to the host loop
            # (warm-started) if the tolerance was not reached.
            from cholesky_tpu.numeric import refine

            if not self.factored:
                self.factorize()
            ell = self._ell_perm()
            if ell is not None and not self._device_ir_fits():
                ell = None      # see _device_ir_fits (cast hoisting)
            if ell is not None:
                # device loop targets tol/3: the f32 residual-norm estimate
                # can sit slightly above the true f64 residual, and a
                # borderline exit would trip the host safety-net loop below
                # into a full extra solve (~10x the cost of one more device
                # iteration)
                use_inv = self._want_inv_pivots()
                x_perm, _, rn_rel = refine.solve_refined_df(
                    self.fplan, self.panels, b[self.plan.perm], ell,
                    tol=tol / 3.0, max_iter=max_iter,
                    inv_pivots=self._inv_pivots() if use_inv else None,
                    ell_pad=self._ell_padded(ell) if use_inv else None)
                x = np.empty(self.plan.n)
                x[self.plan.perm] = x_perm
                if rn_rel <= tol:
                    # device-verified convergence (df residual, ~1e-14
                    # floor, targeted tol/3): skip the host re-check — a
                    # CSR matvec and a device round trip per solve
                    return x

        a = self._matrix_csr()
        bnorm = np.linalg.norm(b)
        if x is None:
            x = self._solve_once(b).astype(np.float64)
        for _ in range(max_iter):
            r = b - a @ x
            if np.linalg.norm(r) <= tol * bnorm:
                break
            x = x + self._solve_once(r).astype(np.float64)
        return x

    def _device_ir_fits(self) -> bool:
        """Whether the device-resident refinement WHILE-LOOP program fits
        device memory. With raw sub-f32 (bf16 out-of-core) panels and no
        pivot inverses, the plain inner solve's per-level f32 promotions are
        loop-invariant and XLA hoists every one of them out of the while
        body — ~2x the stored factor bytes stay live across the whole
        loop (at 140^3: a 21.94 GB buffer assignment, RESOURCE_EXHAUSTED
        at compile on a 16 GiB device; jax.checkpoint
        does not help — forward-only remat is a no-op). When that cannot
        fit, the caller falls to the host-driven refinement loop, whose
        per-sweep solves are straight-line programs with transient
        casts."""
        if self._want_inv_pivots():
            return True         # banded inner: f32 inverses, no casts
        if not self.factored or self.panels is None:
            return True
        if all(np.dtype(getattr(p, "dtype", np.float32)).itemsize >= 4
               for p in self.panels):
            return True         # f32 panels: the casts are no-ops
        stored = self._factor_bytes()
        return 3 * stored + (2 << 30) <= self._hbm_budget(0.95)

    def _multi_ir_fits(self, ell_k: int, k: int) -> bool:
        """Whether the [n, k] device-resident refinement's residual
        temporaries (~6 live [n, K, k] f32 operands in df_matvec_multi)
        fit a conservative slice of HBM alongside the factor."""
        need = 6 * self.plan.n * max(ell_k, 1) * k * 4
        return need <= self._hbm_budget(0.20)

    @staticmethod
    def _panel_itemsize(p) -> int:
        return np.dtype(p.dtype).itemsize if hasattr(p, "dtype") else 4

    @staticmethod
    def _hbm_budget(fraction: float) -> int:
        """Usable device-memory budget: `fraction` of the device capacity
        (capacity.device_bytes)."""
        from cholesky_tpu.utils import capacity

        return int(capacity.device_bytes() * fraction)

    def _assembler(self):
        """Pattern-bound device assembler, built once and kept across
        update_values — the scatter indices are value-free."""
        if getattr(self, "_fasm", None) is None:
            from cholesky_tpu.numeric import frontal

            self._fasm = frontal.FrontAssembler(
                self.fplan, self.rows, self.cols)
        return self._fasm

    def _device_assembly_ok(self) -> bool:
        """Device-side assembly applies in the in-core regime only: past
        the "stream" capacity threshold the factorization streams fronts
        from HOST memory
        level by level, so the slabs must materialize on the host; with a
        mesh the slabs go straight host->sharded without staging through
        one device."""
        import os

        if os.environ.get("CHOLESKY_TPU_DEVICE_ASSEMBLE", "1") == "0":
            return False
        if self.mesh is not None:
            return False
        from cholesky_tpu.utils import capacity

        return self._factor_bytes() <= capacity.threshold("stream")

    def _lazy_assembly_ok(self) -> bool:
        """Past the "stream" capacity threshold the factorization runs
        level-streamed; lazy
        per-level device assembly keeps the values-only-upload property
        there without the full front set's residency. Quasi-definite
        factorization (signs) consumes materialized panels."""
        import os

        if os.environ.get("CHOLESKY_TPU_LAZY_ASSEMBLE", "1") == "0":
            return False
        if os.environ.get("CHOLESKY_TPU_DEVICE_ASSEMBLE", "1") == "0":
            return False        # "no device-side assembly" means lazy too
        if self.mesh is not None or self.signs is not None:
            return False
        return np.asarray(self.vals).ndim == 1

    def _factor_bytes(self) -> int:
        """Device residency of the factors: actual panel dtypes when
        factored (out-of-core factors are bf16), planned front sizes
        otherwise."""
        if self.factored and self.panels is not None:
            return sum(int(np.prod(p.shape)) * self._panel_itemsize(p)
                       for p in self.panels)
        fp = self.fplan
        item = np.dtype(self.dtype).itemsize
        return sum((1 << l) * fp.F[l] * fp.W[l] * item
                   for l in range(fp.levels))

    def _want_inv_pivots(self) -> bool:
        """Explicit pivot inverses trade HBM for per-iteration speed in the
        refinement loop (batched matmuls instead of latency-bound triangular
        solves). At large scale the factor + inverses + solve temps can
        exceed HBM — skip the inverses when the estimated footprint leaves
        too little headroom (the triangular-solve path is slower per
        iteration but needs no extra residency). Override with
        CHOLESKY_TPU_INV_PIVOTS=0/1."""
        import os

        flag = os.environ.get("CHOLESKY_TPU_INV_PIVOTS")
        if flag in ("0", "1"):
            return flag == "1"
        fp = self.fplan
        factor_bytes = self._factor_bytes()
        # inverses are computed in f32 regardless of factor storage
        # (frontal._invert_pivot_level_jit)
        inv_bytes = sum(
            (1 << l) * fp.W[l] * fp.W[l] * 4 for l in range(fp.levels))
        budget = self._hbm_budget(0.85)
        # Streamed factorizations (fronts past the "stream" threshold)
        # bound per-level residency; the failure mode is the MONOLITHIC
        # donating factor program, whose multi-GiB HLO-temp working set
        # leaves less usable headroom than steady-state arithmetic suggests
        # (80^3: OOM at 4.65 GiB factor + 2.38 GiB inverses on a 16 GiB
        # device).
        from cholesky_tpu.utils import capacity

        # The stream decision keys on the INPUT front bytes (frontal.factor),
        # not the stored factor bytes — an out-of-core bf16-stored factor is
        # half the size of the f32 fronts that forced streaming.
        front_bytes = sum(
            (1 << l) * fp.F[l] * fp.W[l] * np.dtype(self.dtype).itemsize
            for l in range(fp.levels))
        if front_bytes > capacity.threshold("stream"):
            # Streamed factorizations bound per-level residency, so the
            # factor program's HLO temps are no longer the constraint —
            # but the SOLVE then co-hosts the stored factor AND the f32
            # inverses (at 140^3: 11.9 GiB of bf16 factor plus >3 GiB of
            # inverses exceeded a 16 GiB device). Gate on the actual
            # stored bytes: _factor_bytes() already reports the compressed
            # (bf16) panel sizes once factored, and predicts them
            # pre-factor.
            stored = self._factor_bytes()
            if (not self.factored
                    and front_bytes > capacity.threshold("f32_store")):
                stored //= 2        # factor() will store bf16 at this size
            return (stored + inv_bytes + capacity.threshold("solve_headroom")
                    <= self._hbm_budget(0.95))
        # monolithic path: factor + inverses + inversion/transposition temps
        # + fixed slack for solve chunk buffers, ELL planes, fragmentation
        slack = 2 << 30
        return factor_bytes + 3 * inv_bytes + slack <= budget

    def _inv_pivots(self):
        """Cached per-level explicit pivot-factor inverses for the
        refinement loop (invalidated with the factorization)."""
        if getattr(self, "_inv_cache_key", None) != id(self.panels):
            from cholesky_tpu.numeric import frontal

            with _precision_ctx(self.precision):
                self._inv_cache = frontal.invert_pivots(self.fplan,
                                                        self.panels)
            self._inv_cache_key = id(self.panels)
        return self._inv_cache

    def _ell_perm(self):
        """ELL planes of the symmetrized permuted matrix for the
        double-float matvec (None when a row exceeds ELL_MAX_K nonzeros)."""
        if not hasattr(self, "_ell_cache"):
            from cholesky_tpu.numeric import refine

            pr, pc, pv = self._perm_coo()
            ell = refine.build_ell(self.plan.n, pr, pc, pv)
            if ell is not None:
                # ship to device ONCE — not ~10 MB of ELL planes per solve
                import jax.numpy as jnp

                ell = tuple(jnp.asarray(a) for a in ell)
            self._ell_cache = ell
        return self._ell_cache

    def _ell_padded(self, ell=None):
        """ELL planes relabeled into frontal's banded padded basis
        (refine.pad_ell) for the device refinement loop — shipped to device
        once and cached with the other pattern caches. Built from the host
        COO (the permuted-basis device planes in _ell_cache are not pulled
        back)."""
        if not hasattr(self, "_ell_pad_cache"):
            from cholesky_tpu.numeric import refine

            pr, pc, pv = self._perm_coo()
            host = refine.build_ell(self.plan.n, pr, pc, pv)
            if host is None:
                self._ell_pad_cache = None
            else:
                import jax.numpy as jnp

                self._ell_pad_cache = tuple(
                    jnp.asarray(a)
                    for a in refine.pad_ell(self.fplan, host))
        return self._ell_pad_cache

    def _perm_coo(self):
        """Symmetrized COO in permuted coordinates (for device matvec)."""
        if not hasattr(self, "_perm_coo_cache") or self._perm_coo_cache is None:
            r, c, v = mmio.symmetrize_coo(self.rows, self.cols, self.vals)
            self._perm_coo_cache = (self.plan.iperm[r], self.plan.iperm[c], v)
        return self._perm_coo_cache

    def _matrix_csr(self):
        if self._csr is None:
            import scipy.sparse

            r, c, v = mmio.symmetrize_coo(self.rows, self.cols, self.vals)
            self._csr = scipy.sparse.csr_matrix(
                (v, (r, c)), shape=(self.plan.n, self.plan.n))
        return self._csr

    # ------------------------------------------------------------------
    def factor_dense(self) -> np.ndarray:
        """The factor L as a dense lower-triangular array in permuted coords."""
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import frontal

        return frontal.extract_factor_dense(self.fplan, self.panels)

    def factor_coo(self):
        """The factor L as COO (0-based permuted coordinates, lower
        triangle) — scales to problems where a dense n^2 factor is
        infeasible."""
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import frontal

        return frontal.extract_factor_coo(self.fplan, self.panels)

    @_with_precision
    def inv_diag(self) -> np.ndarray:
        """diag(A⁻¹) in original dof order, by selected inversion on the
        factor (numeric/selinv.py): a top-down batched recursion over the
        separator tree — never forms A⁻¹ or solves n right-hand sides.
        Production use: marginal variances (A⁻¹ as a GP/Bayesian posterior
        covariance), leverage scores, error estimation. The reference has
        no inverse capability. Accuracy follows the factor precision
        (f64 factor ≈ 1e-13 relative; f32 ≈ κ(A)·1e-7)."""
        self._require_spd("selected inversion")
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import selinv

        out = np.empty(self.plan.n)
        self._selinv_guard()
        out[self.plan.perm] = selinv.selinv_diag(self.fplan, self.panels)
        return out

    def _selinv_guard(self) -> None:
        """Selected inversion is in-core only: two adjacent levels of
        front-inverse blocks (plus one-hot transients) and the resident
        factors must fit HBM — fail with the numbers, not a device OOM.
        CHOLESKY_TPU_SELINV=force overrides."""
        import os

        from cholesky_tpu.utils.capacity import selinv_memory_bytes

        if os.environ.get("CHOLESKY_TPU_SELINV") == "force":
            return
        item = 8 if np.dtype(self.dtype) == np.float64 else 4
        need = selinv_memory_bytes(self.fplan, item) + self._factor_bytes()
        budget = self._hbm_budget(0.9)
        if need > budget:
            raise MemoryError(
                f"selected inversion needs ~{need / 2**30:.1f} GiB "
                f"(front-inverse blocks of two adjacent levels + one-hot "
                f"transients + factors) but ~{budget / 2**30:.1f} GiB is "
                f"available; it has no streamed path. "
                f"CHOLESKY_TPU_SELINV=force overrides.")

    @_with_precision
    def inv_entries(self, rows, cols) -> np.ndarray:
        """Selected entries (A⁻¹)[rows[k], cols[k]] in original dof order,
        for entries within the factor pattern (L + Lᵀ + I): covariances
        between coupled sites in a GMRF, off-diagonal posterior terms. Same
        recursion as inv_diag, stopping at the deepest requested tree
        level. Entries outside the pattern raise ValueError (solve unit
        vectors for those)."""
        self._require_spd("selected inversion")
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import selinv

        self._selinv_guard()
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        return selinv.selinv_entries(
            self.fplan, self.panels,
            self.plan.iperm[rows], self.plan.iperm[cols])

    # ------------------------------------------------------------------
    # Static condensation (substructuring / domain decomposition): the Schur
    # complement of A onto the ROOT separator dofs. The caller chooses the
    # interface by making it the root separator of the ordering (from_coo
    # with a custom Ordering puts any dof set there). Beyond the reference,
    # which always factors to completion.

    def _root_extent(self):
        root = self.plan.tree.sep_at(0, 0)
        off = int(self.plan.sep_offset[root])
        sz = int(self.plan.sep_sizes[root])
        return off, sz

    def schur_dofs(self) -> np.ndarray:
        """Original dof ids of the root separator — the index set of
        schur_complement()/condense_rhs() entries, in their row order."""
        off, sz = self._root_extent()
        return self.plan.perm[off:off + sz]

    @_with_precision
    def schur_complement(self) -> np.ndarray:
        """Dense Schur complement S = A_rr − A_ro·A_oo⁻¹·A_or of A onto the
        root separator dofs (rows/cols ordered as schur_dofs()).

        In the multifrontal elimination the fully-assembled root front IS
        this Schur complement (the level-0 extend-add accumulates every
        interior subtree's update — the sum the reference accumulates
        through its SYRK/GEMM chain, mmat.rg:1293-1346), and the factor
        stores its Cholesky L_S — so S = L_S·L_Sᵀ is recovered from the
        factor at the cost of one matmul, no refactorization. Accuracy
        follows the factor precision (f64 exact to roundoff; f32 ≈ 1e-7
        relative; bf16-stored out-of-core factors correspondingly less)."""
        self._require_spd("schur_complement")
        if not self.factored:
            self.factorize()
        import jax.numpy as jnp

        _, sz = self._root_extent()
        ld = np.tril(np.asarray(
            jnp.asarray(self.panels[0][0, :sz, :sz], jnp.float64)))
        return ld @ ld.T

    @_with_precision
    def condense_rhs(self, b: np.ndarray) -> np.ndarray:
        """Condensed right-hand side b̂ = b_r − A_ro·A_oo⁻¹·b_o of the
        interface system S·x_r = b̂ (partial forward substitution over the
        interior levels). `b` is the FULL rhs in original dof order; the
        result is ordered as schur_dofs()."""
        self._require_spd("condense_rhs")
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import frontal

        b = np.asarray(b, dtype=np.float64).reshape(-1)
        bg = frontal.forward_partial(self.fplan, self.panels,
                                     b[self.plan.perm].astype(self.dtype))
        off, sz = self._root_extent()
        return np.asarray(bg[off:off + sz], dtype=np.float64)

    @_with_precision
    def expand_solution(self, b: np.ndarray, x_root: np.ndarray) -> np.ndarray:
        """Recover the full solution from an interface solution: given x_r
        solving S·x_r = condense_rhs(b) (computed by any external solver),
        back-substitute the interior, x_o = A_oo⁻¹(b_o − A_or·x_r). Returns
        x in original dof order. The (b, x_root) pair must be consistent —
        the interior recovery reuses the partial forward pass of b."""
        self._require_spd("expand_solution")
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import frontal

        b = np.asarray(b, dtype=np.float64).reshape(-1)
        _, sz = self._root_extent()
        x_root = np.asarray(x_root, dtype=np.float64).reshape(-1)
        if x_root.shape[0] != sz:
            raise ValueError(
                f"x_root has {x_root.shape[0]} entries; root separator "
                f"has {sz}")
        w0 = self.fplan.W[0]
        xr = np.zeros(w0, dtype=self.dtype)
        xr[:sz] = x_root
        bg = frontal.forward_partial(self.fplan, self.panels,
                                     b[self.plan.perm].astype(self.dtype))
        x_perm = np.asarray(frontal.backward_partial(
            self.fplan, self.panels, bg, xr), dtype=np.float64)
        x = np.empty(self.plan.n)
        x[self.plan.perm] = x_perm
        return x

    # ------------------------------------------------------------------
    @_with_precision
    def sample(self, z: np.ndarray) -> np.ndarray:
        """Samples with covariance A⁻¹ from standard-normal draws: with
        A_perm = L·Lᵀ, x_perm = L⁻ᵀ z has covariance A_perm⁻¹ — the sparse
        Cholesky sampler for GMRF / GP posteriors (A the precision matrix;
        moments from inv_diag/inv_entries, draws from here). `z` is [n] or
        [n, k] standard normal; returns samples in ORIGINAL dof order.
        Accuracy follows the factor dtype (f64 exact to roundoff; f32
        covariance error ~1e-7 relative — far below sampling noise)."""
        self._require_spd("sample")
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import frontal

        z = np.asarray(z, dtype=self.dtype)
        squeeze = z.ndim == 1
        zp = z.reshape(self.plan.n, -1)[self.plan.perm]
        xp = np.asarray(frontal.upper_solve(self.fplan, self.panels, zp))
        x = np.empty_like(xp)
        x[self.plan.perm] = xp
        x = x.astype(np.float64)
        return x[:, 0] if squeeze else x

    @_with_precision
    def whiten(self, x: np.ndarray) -> np.ndarray:
        """The inverse transform of sample(): z = L⁻¹ P x. For
        x ~ N(0, A⁻¹) (in original dof order) the result is standard
        normal — residual whitening / standardized innovations for model
        checking. `x` is [n] or [n, k]."""
        self._require_spd("whiten")
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import frontal

        x = np.asarray(x, dtype=self.dtype)
        squeeze = x.ndim == 1
        xp = x.reshape(self.plan.n, -1)[self.plan.perm]
        zp = np.asarray(frontal.upper_matvec(self.fplan, self.panels, xp))
        z = np.empty_like(zp)
        z[self.plan.perm] = zp        # whiten(sample(z)) == z coordinate-wise
        return (z[:, 0] if squeeze else z).astype(np.float64)

    # ------------------------------------------------------------------
    def factorize_many(self, vals_many) -> "BatchedFactors":
        """Factor K matrices sharing THIS solver's sparsity pattern in one
        batched program: `vals_many` is [K, nnz] aligned with
        coo_pattern(). The whole family runs through one vmapped
        factorization — the matrix units see K-fold larger batches, so a kernel
        family (GP hyperparameter candidates, MCMC proposals, time steps)
        costs far less than K sequential factorizations. Returns a
        BatchedFactors handle (solve / logdet / residual per system);
        this solver's own factor state is untouched. In-core only. With
        a mesh, the SYSTEM axis shards over the devices — each chip owns
        ⌈K/ndev⌉ independent factorizations (embarrassingly parallel; the
        mesh shards the family here, not the tree). K that doesn't divide
        the mesh is padded with copies of the last system and sliced back
        (≤ ndev−1 redundant factorizations instead of full replication)."""
        self._require_spd("factorize_many")
        vals_many = np.asarray(vals_many, dtype=np.float64)
        if vals_many.ndim != 2 or vals_many.shape[1] != self.vals.shape[0]:
            raise ValueError(
                f"vals_many must be [K, {self.vals.shape[0]}] aligned with "
                f"coo_pattern(); got {vals_many.shape}")
        k = vals_many.shape[0]
        ndev = int(self.mesh.devices.size) if self.mesh is not None else 1
        pad = (-k) % ndev
        if pad:
            # non-divisible K still SHARDS: pad the family to the next
            # multiple of the mesh with copies of the last system (≤ ndev−1
            # redundant factorizations — each chip owns ⌈K/ndev⌉ systems,
            # vs replication's K-per-chip), then slice the results back
            vals_padded = np.concatenate(
                [vals_many, np.repeat(vals_many[-1:], pad, axis=0)], axis=0)
        else:
            vals_padded = vals_many
        kp = k + pad
        # in-core guard (per chip): ⌈K/ndev⌉ fronts + factors + temps
        need = 3 * (kp // ndev) * self._factor_bytes()
        budget = self._hbm_budget(0.85)
        if need > budget:
            raise MemoryError(
                f"batched factorization of K={k} needs ~{need / 2**30:.1f} "
                f"GiB but ~{budget / 2**30:.1f} GiB is available — split "
                f"the family into chunks")
        from cholesky_tpu.numeric import frontal

        if self.mesh is None and self._device_assembly_ok():
            # upload [K, nnz] once; the K-fold slabs never exist on host
            fronts = self._assembler()(vals_padded, dtype=self.dtype)
        else:
            fronts = frontal.assemble_fronts(
                self.fplan, self.rows, self.cols, vals_padded,
                dtype=self.dtype)
        with _precision_ctx(self.precision):
            factors = frontal.factor_many(self.fplan, fronts, mesh=self.mesh)
        return BatchedFactors(self, factors, vals_many, pad=pad)

    # ------------------------------------------------------------------
    # Closed-form gradients w.r.t. the matrix values (the COO entries
    # aligned with coo_pattern()). Together these give exact gradients of
    # any scalar built from solves and logdet — e.g. the GP marginal
    # log-likelihood −½(bᵀA⁻¹b + logdet A + n·log 2π) — without
    # differentiating through the factorization.

    @_with_precision
    def logdet_grad(self) -> np.ndarray:
        """∂ logdet(A) / ∂v, aligned with coo_pattern(): since
        d logdet = tr(A⁻¹ dA) and entry v_k appears at (r_k, c_k) AND
        (c_k, r_k), the gradient is 2·(A⁻¹)[r_k, c_k] off the diagonal and
        (A⁻¹)[r_k, r_k] on it. The inverse entries come from selected
        inversion on the factor (inv_entries — A's pattern is always inside
        the factor pattern), so the cost is ~one extra factorization-shaped
        pass, not n solves. Memory envelope is selected inversion's
        (in-core; see _selinv_guard)."""
        self._require_spd("logdet_grad")
        g = self.inv_entries(self.rows, self.cols)
        return np.where(self.rows == self.cols, g, 2.0 * g)

    @_with_precision
    def solve_grad(self, b: np.ndarray, xbar: np.ndarray,
                   x: Optional[np.ndarray] = None, tol: float = 1e-12):
        """Adjoint of x = A⁻¹b: given the cotangent x̄ = ∂f/∂x of a scalar
        f(x), returns (vbar, bbar) with

            bbar = A⁻¹x̄                         (∂f/∂b)
            vbar_k = −(λ_{r_k} x_{c_k} + λ_{c_k} x_{r_k})   off-diagonal
                     −λ_{r_k} x_{r_k}                        diagonal

        (λ = bbar), aligned with coo_pattern() — the standard implicit-
        function adjoint dA ↦ −λ xᵀ restricted to the symmetric pattern.
        Pass x if already computed (saves one solve). Cost: one or two
        solves, independent of the number of pattern entries."""
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        if x is None:
            x = self.solve(b, tol=tol)
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        lam = np.asarray(self.solve(np.asarray(xbar, dtype=np.float64)
                                    .reshape(-1), tol=tol))
        r, c = self.rows, self.cols
        vbar = -(lam[r] * x[c] + lam[c] * x[r])
        vbar[r == c] = -(lam[r] * x[r])[r == c]
        return vbar, lam

    @_with_precision
    def quadform_grad(self, b: np.ndarray, x: Optional[np.ndarray] = None,
                      tol: float = 1e-12) -> np.ndarray:
        """∂(bᵀA⁻¹b)/∂v aligned with coo_pattern(): −x_r x_c doubled off
        the diagonal (x = A⁻¹b). One solve; with logdet_grad this is the
        whole GP evidence gradient."""
        self._require_spd("quadform_grad")
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        if x is None:
            x = self.solve(b, tol=tol)
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        r, c = self.rows, self.cols
        g = -2.0 * x[r] * x[c]
        g[r == c] = -(x[r] * x[r])[r == c]
        return g

    @_with_precision
    def solve_updated(self, b: np.ndarray, u: np.ndarray, w=None,
                      tol: float = 1e-12) -> np.ndarray:
        """Solve (A + U·diag(w)·Uᵀ) x = b via the Woodbury identity, reusing
        the existing factorization of A — no refactorization for low-rank
        modifications (observation insertion/deletion, regularizer or
        boundary-condition tweaks, GP inducing-point updates):

            M⁻¹b = A⁻¹b − A⁻¹U (diag(w)⁻¹ + UᵀA⁻¹U)⁻¹ UᵀA⁻¹b

        U is [n, k] (or [n] for k=1) in original dof order; w is a scalar or
        [k] of update weights (negative entries down-date; the caller must
        keep A + U diag(w) Uᵀ nonsingular — a singular capacitance matrix
        raises LinAlgError). Cost: one k-RHS solve + one 1-RHS solve + an
        O(k³) dense solve, against a full refactorization."""
        u = np.asarray(u, dtype=np.float64)
        if u.ndim == 1:
            u = u[:, None]
        k = u.shape[1]
        if w is None:
            w = np.ones(k)
        w = np.broadcast_to(np.asarray(w, dtype=np.float64), (k,))
        if np.any(w == 0.0):
            raise ValueError("update weights must be nonzero")
        # solve() squeezes a [n, 1] RHS to [n]; restore the column axis
        ainv_u = np.asarray(self.solve(u, tol=tol)).reshape(self.plan.n, k)
        x = self.solve(b, tol=tol)
        cap = np.diag(1.0 / w) + u.T @ ainv_u            # [k, k] capacitance
        correction = ainv_u @ np.linalg.solve(cap, u.T @ x)
        return x - correction

    @_with_precision
    def solve_perturbed(self, b: np.ndarray, rows: np.ndarray,
                        cols: np.ndarray, vals: np.ndarray,
                        tol: float = 1e-10, max_iter: int = 200) -> np.ndarray:
        """Solve (A + ΔA)·x = b for a GENERAL symmetric perturbation ΔA
        without refactorizing: preconditioned conjugate gradients with this
        factor as the preconditioner. The complement to `solve_updated`'s
        low-rank Woodbury path — use it when coefficients drift everywhere
        (time-dependent PDE coefficients, quasi-Newton lags) but stay close
        enough that the old factor keeps the preconditioned spectrum
        clustered. Each iteration costs one sparse matvec plus one
        triangular-solve pair through the factor; when iteration counts
        grow, refactor with `update_values` instead.

        ΔA is COO in the input matrix's lower-triangle convention
        (rows ≥ cols; off-diagonal entries imply their transposes); the
        perturbed matrix must remain SPD. b is [n] or [n, k] in original
        dof order. Uses the flexible (Polak–Ribière) CG update so the
        low-precision preconditioner solve cannot stall convergence.
        Converges to ‖(A+ΔA)x−b‖/‖b‖ ≤ tol or raises RuntimeError."""
        self._require_spd("solve_perturbed")
        if not self.factored:
            self.factorize()
        import scipy.sparse

        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        if np.any(rows < cols):
            raise ValueError(
                "perturbation must be lower-triangle COO (rows >= cols), "
                "matching the input matrix convention")
        dr, dc, dv = mmio.symmetrize_coo(rows, cols, vals)
        a_pert = self._matrix_csr() + scipy.sparse.csr_matrix(
            (dv, (dr, dc)), shape=(self.plan.n, self.plan.n))

        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 2:
            return np.stack([
                self.solve_perturbed(b[:, j], rows, cols, vals, tol=tol,
                                     max_iter=max_iter)
                for j in range(b.shape[1])], axis=1)
        bnorm = float(np.linalg.norm(b))
        if bnorm == 0.0:
            return np.zeros_like(b)
        x = np.zeros_like(b)
        r = b.copy()
        z = self._solve_once(r).astype(np.float64)
        p = z.copy()
        rz = float(r @ z)
        for _ in range(max_iter):
            ap = a_pert @ p
            pap = float(p @ ap)
            if pap <= 0.0:
                raise RuntimeError(
                    "CG direction with non-positive curvature — the "
                    "perturbed matrix is not positive definite")
            alpha = rz / pap
            x += alpha * p
            r_new = r - alpha * ap
            if np.linalg.norm(r_new) <= tol * bnorm:
                return x
            z_new = self._solve_once(r_new).astype(np.float64)
            # flexible (Polak–Ribière) beta: robust to the inexact,
            # slightly nonsymmetric fp32 preconditioner solve
            beta = float(z_new @ (r_new - r)) / rz
            rz = float(r_new @ z_new)
            p = z_new + beta * p
            r, z = r_new, z_new
        raise RuntimeError(
            f"solve_perturbed did not reach tol={tol:g} in {max_iter} "
            f"iterations (relative residual "
            f"{np.linalg.norm(r) / bnorm:.3e}) — the perturbation is too "
            f"large for this factor; refactor with update_values")

    @_with_precision
    def logdet_updated(self, u: np.ndarray, w=None, tol: float = 1e-12
                       ) -> float:
        """log det(A + U·diag(w)·Uᵀ) by the matrix determinant lemma,
        reusing the factor (companion to solve_updated — e.g. GP evidence
        under observation updates):

            log det(M) = log det(A) + Σ log w + log det(diag(w)⁻¹ + UᵀA⁻¹U)

        Raises ArithmeticError when the update makes the matrix lose
        positive definiteness (negative determinant sign)."""
        self._require_spd("logdet_updated")
        u = np.asarray(u, dtype=np.float64)
        if u.ndim == 1:
            u = u[:, None]
        k = u.shape[1]
        if w is None:
            w = np.ones(k)
        w = np.broadcast_to(np.asarray(w, dtype=np.float64), (k,))
        if np.any(w == 0.0):
            raise ValueError("update weights must be nonzero")
        ainv_u = np.asarray(self.solve(u, tol=tol)).reshape(self.plan.n, k)
        cap = np.diag(1.0 / w) + u.T @ ainv_u
        sign, logabs = np.linalg.slogdet(cap)
        sign_w = float(np.prod(np.sign(w)))
        if sign * sign_w <= 0:
            raise ArithmeticError(
                "A + U diag(w) U^T is not positive definite")
        return float(self.logdet() + np.log(np.abs(w)).sum() + logabs)

    # ------------------------------------------------------------------
    def logdet(self) -> float:
        """log det(A) = 2 Σ log diag(L), read off the factor's per-level
        pivot blocks. Padded diagonal entries are exactly 1
        (assemble_fronts) and contribute nothing. Standard
        SPD-solver capability (GP likelihoods, model evidence) the reference
        lacks."""
        if not self.factored:
            self.factorize()
        import jax.numpy as jnp

        widths = self.fplan.W
        total = 0.0
        for lvl, p in enumerate(self.panels):
            w = int(widths[lvl])
            if w == 0 or p.shape[0] == 0:
                continue
            d = jnp.diagonal(p[:, :w, :w], axis1=1, axis2=2)
            total += float(np.log(np.asarray(d).astype(np.float64)).sum())
        if self.signs is not None:
            raise ValueError(
                "quasi-definite matrix: det may be negative — use slogdet()")
        return 2.0 * total

    def slogdet(self):
        """(sign, log|det A|) — like numpy.linalg.slogdet, read off the
        factor: SPD gives (1, logdet()); a quasi-definite factorization
        gives sign = (−1)^{#negative in the signature} (the signature IS
        the inertia, Sylvester's law through L̃·S·L̃ᵀ)."""
        if self.signs is None:
            return 1, self.logdet()
        if not self.factored:
            self.factorize()
        from cholesky_tpu.numeric import ldlt

        return ldlt.logdet_qd(self.fplan, self.panels, self.signs)

    def inertia(self):
        """(n₊, n₋, n₀) of the factored matrix: the quasi-definite
        signature for LDLᵀ, (n, 0, 0) for SPD. Interior-point methods use
        this to verify a KKT system's expected inertia."""
        from cholesky_tpu.numeric import ldlt

        if self.signs is None:
            return int(self.plan.n), 0, 0
        return ldlt.inertia(self.signs)

    def _require_spd(self, what: str):
        if self.signs is not None:
            raise NotImplementedError(
                f"{what} requires an SPD (Cholesky) factorization — this "
                f"solver holds a quasi-definite LDL^T factor")

    @_with_precision
    def eigsh(self, k: int = 6, which: str = "smallest", tol: float = 1e-9,
              m: int | None = None, seed: int = 0, M=None):
        """k extremal eigenpairs of A (eigenvalues ascending, orthonormal
        eigenvectors [n, k]), converged to ‖Av−λv‖ ≤ tol·‖A‖₁.

        which='smallest' runs shift-invert Lanczos at σ=0: each step is one
        refined triangular-solve pair through the existing factor (the
        classical direct-solver-driven ARPACK mode; an fp32 factor still
        yields f64-accurate pairs because every solve refines to ~1e-11).
        Smallest modes of an SPD operator are the physically interesting
        ones — vibration/diffusion modes of a FEM stiffness matrix, the
        smoothest components of a GMRF precision. which='largest' needs only
        sparse matvecs (works for quasi-definite LDLᵀ solvers too). The
        reference has no eigen capability (SURVEY §2); this is the standard
        companion a direct SPD factorization enables.

        M (scipy sparse / dense, full symmetric, SPD mass matrix): solve the
        generalized pencil A·x = λ·M·x — the FEM modal problem
        K·x = ω²·M·x, with M-inner-product Lanczos on K⁻¹M and
        mass-normalized eigenvectors (VᵀMV = I)."""
        from cholesky_tpu.numeric import eigs

        if which == "smallest":
            self._require_spd("eigsh(which='smallest') (shift-invert)")
            if not self.factored:
                self.factorize()
        return eigs.eigsh(self, k=k, which=which, tol=tol, m=m, seed=seed,
                          M=M)

    @_with_precision
    def condest(self, iters: int = 12, seed: int = 0,
                method: str = "power") -> float:
        """2-norm condition-number estimate κ₂(A) ≈ λmax(A)/λmin(A) by power
        iteration: λmax on A (sparse matvecs), 1/λmin on A⁻¹ (triangular
        solves through the factor). For SPD matrices the 2-norm equals the
        spectral radius, so both iterations converge monotonically from
        random starts. Cost: `iters` matvecs + `iters` solves.

        method='lanczos' instead converges both spectrum ends with Lanczos
        (`numeric/eigs.py`) — tighter than power iteration when either end
        is clustered (power iteration's error decays like (λ₂/λ₁)^iters;
        Lanczos accelerates past it with the same per-step cost)."""
        if not self.factored:
            self.factorize()
        if method == "lanczos":
            from cholesky_tpu.numeric import eigs

            self._require_spd("condest(method='lanczos')")
            return eigs.cond2(self, seed=seed)
        a = self._matrix_csr()
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(self.plan.n)
        v /= np.linalg.norm(v)
        lam_max = 0.0
        for _ in range(iters):
            w = a @ v
            lam_max = float(np.linalg.norm(w))
            if lam_max == 0.0:
                break
            v = w / lam_max
        v = rng.standard_normal(self.plan.n)
        v /= np.linalg.norm(v)
        inv_max = 0.0
        for _ in range(iters):
            w = self._solve_once(v).astype(np.float64)
            inv_max = float(np.linalg.norm(w))
            if not np.isfinite(inv_max) or inv_max == 0.0:
                return float("inf")
            v = w / inv_max
        return lam_max * inv_max

    # ------------------------------------------------------------------
    def _factor_fingerprint(self) -> str:
        """Identity of (matrix, ordering, dtype) a saved factor binds to."""
        import hashlib

        h = hashlib.sha256()
        h.update(np.int64(self.plan.n).tobytes())
        h.update(np.ascontiguousarray(self.plan.perm, dtype=np.int64).tobytes())
        # panel layout: sep boundaries + padded bucket shapes (covers pad_to —
        # same perm with different padding yields incompatible panel shapes)
        h.update(np.ascontiguousarray(self.plan.sep_sizes,
                                      dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.plan.S, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.plan.H, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.rows, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.cols, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.vals, dtype=np.float64).tobytes())
        h.update(str(np.dtype(self.dtype)).encode())
        h.update(b"frontal")        # engine tag kept for checkpoint compat
        return h.hexdigest()

    @staticmethod
    def _npz_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save_factor(self, path: str) -> str:
        """Checkpoint the completed factorization to `path` (.npz): the
        factored per-level panels plus a fingerprint binding them to this
        exact matrix/ordering/dtype. A solver in another process built from
        the same inputs can `load_factor` and solve immediately — the
        expensive numeric phase is skipped. (The reference has no resumable
        state; its -m/-o outputs are MatrixMarket dumps, SURVEY §5.)
        Returns the written path."""
        self._require_spd("save_factor/load_factor")
        if not self.factored:
            self.factorize()
        import json

        arrays = {}
        dtypes = []
        for i, p in enumerate(self.panels):
            a = np.asarray(p)
            dtypes.append(str(a.dtype))
            if a.dtype.kind != "f" or a.dtype.itemsize < 4:
                # sub-f32 float panels (bf16 out-of-core factors) store as
                # BIT patterns: widening a 12 GiB bf16 factor to f32 both
                # doubles the file and makes the loader's device-side
                # downcast hold f32+bf16 copies concurrently (an OOM at
                # 140^3); the uint16 view round-trips exactly
                arrays[f"panel_{i}"] = a.view(np.uint16)
            else:
                arrays[f"panel_{i}"] = a
        meta = {"version": 2, "engine": "frontal", "storage": "bits",
                "n_panels": len(dtypes), "panel_dtypes": dtypes,
                "fingerprint": self._factor_fingerprint(),
                # the factor was built at this matmul precision; a loader
                # must apply solves at the same precision (the AUTO ladder's
                # env threshold may differ in the loading process)
                "precision": self.precision}
        arrays["meta"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        path = self._npz_path(path)
        # uncompressed: factor panels are high-entropy floats (zlib gains
        # ~nothing and costs many single-core minutes at 12 GiB)
        np.savez(path, **arrays)
        return path

    def load_factor(self, path: str) -> None:
        """Load a factorization written by `save_factor`. Refuses a factor
        whose fingerprint does not match this solver's matrix/ordering/dtype
        (a mismatched factor would silently solve the wrong system)."""
        self._require_spd("save_factor/load_factor")
        import json

        import jax.numpy as jnp

        with np.load(self._npz_path(path)) as data:
            meta = json.loads(bytes(data["meta"].tobytes()).decode())
            if meta.get("fingerprint") != self._factor_fingerprint():
                raise ValueError(
                    "saved factor does not match this solver's "
                    "matrix/ordering/dtype/engine")
            panels = []
            for i in range(meta["n_panels"]):
                a = data[f"panel_{i}"]
                want = jnp.dtype(meta["panel_dtypes"][i])
                if meta.get("storage") == "bits" and a.dtype == np.uint16:
                    # bit-pattern storage (v2): device-side bitcast, no
                    # widened intermediate
                    import jax as _jax

                    panels.append(_jax.lax.bitcast_convert_type(
                        jnp.asarray(a), want))
                else:
                    panels.append(jnp.asarray(a).astype(want))
        if self.mesh is not None:
            from cholesky_tpu.parallel.mesh import distribute_panels

            panels = distribute_panels(panels, self.mesh)
        # pin the loaded factor's matmul precision BEFORE factored=True —
        # solves must apply at the precision the factor was built at, not
        # re-resolve the AUTO ladder in this process (checkpoints from
        # before the meta key resolve from plan statistics, which is the
        # same deterministic decision the writer made under equal env)
        if self._precision is None:
            if "precision" in meta:
                self._precision_resolved = meta["precision"]
            else:
                _ = self.precision      # resolve while factored is False
        self.panels = tuple(panels)
        self.factored = True

    def aslinearoperator(self, inverse: bool = True, tol: float = 1e-10):
        """A scipy.sparse.linalg.LinearOperator view of A⁻¹ (default) or A,
        in original dof order — plugs the factored solver into any scipy
        iterative code as a black-box preconditioner/operator
        (`scipy.sparse.linalg.eigsh(..., OPinv=s.aslinearoperator())`,
        `cg(..., M=s.aslinearoperator())`, LOBPCG, …). Each `matvec` of the
        inverse operator is one refined triangular-solve pair through the
        factor; `matmat` maps to the batched multi-RHS solve."""
        import scipy.sparse.linalg

        n = int(self.plan.n)
        if inverse:
            if not self.factored:
                self.factorize()
            return scipy.sparse.linalg.LinearOperator(
                (n, n), dtype=np.float64,
                matvec=lambda v: np.asarray(
                    self.solve(np.asarray(v).reshape(n), tol=tol)),
                matmat=lambda V: np.asarray(
                    self.solve(np.asarray(V), tol=tol)).reshape(n, -1))
        csr = self._matrix_csr()
        return scipy.sparse.linalg.aslinearoperator(csr)

    def permuted_dense(self) -> np.ndarray:
        """The permuted (unfactored) matrix as written by -p (mmat.rg:1187-1189)."""
        panels = assemble.assemble_panels(
            self.plan, self.rows, self.cols, self.vals, dtype=np.float64)
        dense = assemble.extract_factor_dense(self.plan, panels)
        # strip the identity padding artifacts: extract_factor_dense never
        # copies padded rows/cols, so dense is exactly the permuted matrix.
        return dense

    def residual(self, b: np.ndarray, x: np.ndarray) -> float:
        """Relative residual ||Ax-b|| / ||b|| against the original COO
        matrix. For a multi-RHS block ([n, k] b and x) this is the WORST
        column's relative residual — the same gate every column must meet."""
        b = np.asarray(b)
        x = np.asarray(x)
        if b.ndim == 2 and b.shape[1] > 1:
            r = self._matrix_csr() @ x - b
            bn = np.linalg.norm(b, axis=0)
            bn = np.where(bn > 0, bn, 1.0)
            return float((np.linalg.norm(r, axis=0) / bn).max())
        b = b.reshape(-1)
        ax = self._matrix_csr() @ x.reshape(-1)
        return float(np.linalg.norm(ax - b) / np.linalg.norm(b))


class BatchedFactors:
    """Handle over K same-pattern factorizations (SparseCholesky.
    factorize_many): per-system solve (with mixed-precision refinement for
    low-precision factors), logdet, residual. All device work is vmapped —
    one program for the whole family."""

    def __init__(self, solver: SparseCholesky, factors, vals_many,
                 pad: int = 0):
        self._s = solver
        self.factors = factors       # per-level [K+pad, B, F, W]
        self.vals_many = vals_many   # [K, nnz] f64, solver's coo_pattern
        self.k = int(vals_many.shape[0])
        self.pad = pad               # mesh-divisibility padding (copies of
        #                              the last system); sliced off every
        #                              user-facing result
        self._csr = None

    def _csr_family(self):
        """One CSR structure shared by the family, plus the map from the
        pattern-aligned value vector to CSR data order."""
        if self._csr is None:
            import scipy.sparse

            s = self._s
            nnz = s.vals.shape[0]
            sr, sc, sidx = mmio.symmetrize_coo(
                s.rows, s.cols, np.arange(nnz, dtype=np.float64))
            coo = scipy.sparse.coo_matrix(
                (np.arange(len(sr), dtype=np.float64), (sr, sc)),
                shape=(s.plan.n, s.plan.n))
            csr = coo.tocsr()
            # csr.data holds the sym-entry index at each CSR slot; compose
            # with the sym->pattern map to index vals_many directly
            self._csr = (csr, sidx.astype(np.int64)[csr.data.astype(np.int64)])
        return self._csr

    def _matvec(self, x):
        """A_k @ x_k for every system: [K, n] -> [K, n]."""
        csr, vmap_idx = self._csr_family()
        out = np.empty_like(x)
        for i in range(self.k):
            csr.data = self.vals_many[i, vmap_idx]
            out[i] = csr @ x[i]
        return out

    def _solve_once(self, b):
        from cholesky_tpu.numeric import frontal

        s = self._s
        bp = np.asarray(b, dtype=s.dtype)[:, s.plan.perm]
        if self.pad:
            bp = np.concatenate(
                [bp, np.repeat(bp[-1:], self.pad, axis=0)], axis=0)
        xp = np.asarray(frontal.solve_many_systems(
            s.fplan, self.factors, bp, mesh=s.mesh))[:self.k]
        x = np.empty_like(xp)
        x[:, s.plan.perm] = xp
        return x.astype(np.float64)

    def solve(self, b, refine: str = "auto", tol: float = 1e-10,
              max_iter: int = 50) -> np.ndarray:
        """Solve A_k x_k = b_k for all systems. `b` is [K, n], or [n] to
        share one rhs across the family. Refinement ('auto', like
        SparseCholesky.solve) iterates the whole family together until
        every system meets tol (default: the 1e-10 residual contract)."""
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 1:
            b = np.broadcast_to(b, (self.k, b.shape[0])).copy()
        if b.shape != (self.k, self._s.plan.n):
            raise ValueError(f"b must be [{self.k}, {self._s.plan.n}]")
        with _precision_ctx(self._s.precision):
            x = self._solve_once(b)
            want_ir = refine == "always" or (
                refine == "auto" and np.dtype(self._s.dtype) != np.float64)
            if not want_ir:
                return x
            bnorm = np.linalg.norm(b, axis=1)
            for _ in range(max_iter):
                r = b - self._matvec(x)
                if np.all(np.linalg.norm(r, axis=1) <= tol * bnorm):
                    break
                x = x + self._solve_once(r)
        return x

    def residual(self, b, x) -> np.ndarray:
        """Per-system relative residuals ||A_k x_k − b_k|| / ||b_k||, [K]."""
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 1:
            b = np.broadcast_to(b, (self.k, b.shape[0]))
        r = self._matvec(np.asarray(x, dtype=np.float64)) - b
        return np.linalg.norm(r, axis=1) / np.linalg.norm(b, axis=1)

    def logdet(self) -> np.ndarray:
        """log det(A_k) for every system, [K] (padded pivot diagonals are
        exactly 1 and contribute nothing)."""
        import jax.numpy as jnp

        fp = self._s.fplan
        total = np.zeros(self.k)
        for lvl, p in enumerate(self.factors):
            w = int(fp.W[lvl])
            d = np.asarray(jnp.diagonal(p[:self.k, :, :w, :w],
                                        axis1=2, axis2=3)).astype(np.float64)
            total += np.log(d).sum(axis=(1, 2))
        return 2.0 * total


def solve_spd(matrix_file: str, separator_file: str, b: np.ndarray,
              clusters_file: Optional[str] = None, dtype=np.float64) -> np.ndarray:
    """One-shot convenience: factor and solve from files."""
    s = SparseCholesky.from_files(matrix_file, separator_file, clusters_file,
                                  dtype=dtype)
    s.factorize()
    return s.solve(b)


def spsolve(a, b: np.ndarray, dtype=None, levels=None, tol: float = 1e-10,
            **kw) -> np.ndarray:
    """scipy.sparse.linalg.spsolve-shaped one-shot: solve A x = b for a
    symmetric positive-definite scipy sparse (or dense symmetric) matrix,
    ordering computed automatically (graph nested dissection). Either
    triangle (or both) of A may be populated. `dtype=None` keeps A's dtype
    (float32 engages the fp32 factor + iterative refinement to `tol`).
    A sparse `b` (scipy.sparse.linalg.spsolve accepts one) is densified —
    a direct factor-solve has no sparsity to exploit in the RHS. Extra
    kwargs pass through to `SparseCholesky.from_scipy`."""
    import scipy.sparse as _sp

    if _sp.issparse(b):
        b = b.toarray()
        if b.ndim == 2 and b.shape[1] == 1:
            b = b.reshape(-1)
    s = SparseCholesky.from_scipy(a, dtype=dtype, levels=levels, **kw)
    s.factorize()
    return s.solve(b, tol=tol)
