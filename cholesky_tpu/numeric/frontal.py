"""Batched multifrontal engine with exact row-level boundary structure.

This is the production numeric engine. Where `factor.py`'s panel engine
stores each separator against its FULL ancestor path (dense rows, zero-padded
— simple but O(path) memory and FLOPs), this engine builds classical
multifrontal *fronts*: for separator s, the dense square matrix over

    front(s) = dofs(s)  ∪  bnd(s)

where bnd(s) — the boundary — is the exact set of ancestor rows structurally
nonzero in L's columns dofs(s): orig nonzeros of the (ancestor, s) strips
unioned with the children's boundaries (the standard elimination-tree
recurrence). Contributions flow one level at a time: each front's Schur
complement U = X X^T − T (T = accumulated children updates in the trailing
block) is *extend-added* into the parent's front through precomputed
position maps — the batched form of the reference's SYRK/GEMM accumulation
chain (mmat.rg:1293-1346), with Legion's region movement replaced by static
gathers + a sibling segment-sum.

Everything is batched per tree level over [2^L, F, *] arrays with padded
buckets; gathers/scatters use CONSTANT index arrays baked at trace time
(sentinel index n routes padding to a dummy slot). Cluster-level sparsity is
thus exploited at row granularity — tighter than the reference's cluster
masks (blas.rg fused_* skip whole clusters; here every structurally-zero row
is dropped from the front).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cholesky_tpu.symbolic.plan import SolvePlan
from cholesky_tpu.utils import capacity, round_up


def _round_up(x: int, m: int) -> int:
    # shared rule, with the frontal engine's zero-size clamp (an empty
    # separator still gets a 1-row (-> pad_to) slot so level shapes are valid)
    return round_up(max(x, 1), m)


@dataclasses.dataclass
class FrontalPlan:
    plan: SolvePlan
    W: Tuple[int, ...]                 # padded pivot width per level (= plan.S)
    F: Tuple[int, ...]                 # padded front size per level
    front_rows: List[np.ndarray]       # per level: [B, F] global permuted row
                                       # ids (pivot rows first, then sorted
                                       # boundary), sentinel = n
    inv_child: List[Optional[np.ndarray]]
                                       # per level L: [B, F(L-1)] mapping each
                                       # parent-front position to this child's
                                       # boundary position, or bndK sentinel
    fwd_child: List[Optional[np.ndarray]] = None
                                       # per level L: [B, bndK] mapping each
                                       # child boundary position to its parent
                                       # front position, or F(L-1) sentinel
                                       # (strictly increasing per slot)
    fingerprint: str = ""              # structural hash (front_rows + perm):
                                       # distinguishes same-shape plans with
                                       # different sparsity/ordering in the
                                       # trace caches (key() users)

    @property
    def levels(self) -> int:
        return self.plan.levels

    def key(self):
        """Static identity for trace caches. MUST separate any two plans
        whose compiled programs differ: the level programs bake front_rows /
        inv_child / fwd_child in as constants, and two problems can share
        every bucket shape (levels, W, F, n) while differing in structure —
        e.g. the same grid under two orderings. The fingerprint hashes the
        structure so such plans never collide (they did, silently, before:
        the second plan reused the first's executables and factored wrong)."""
        return (self.levels, self.W, self.F, self.plan.n, self.fingerprint)


_FPLAN_CACHE = {}


def build_frontal_plan(plan: SolvePlan, rows: np.ndarray, cols: np.ndarray,
                       pad_to: int = 8) -> FrontalPlan:
    """Symbolic frontal analysis: exact boundaries, front row lists, and
    extend-add maps. `rows/cols` is the COO lower triangle in ORIGINAL dof
    numbering (values not needed — this is structure only)."""
    t = plan.tree
    n = plan.n
    nsep = t.num_separators

    # permuted coordinates, lower triangle
    pr = plan.iperm[rows]
    pc = plan.iperm[cols]
    swap = pc > pr
    pr2 = np.where(swap, pc, pr)
    pc2 = np.where(swap, pr, pc)

    # separator of each permuted index
    sep_of_perm = np.empty(n, dtype=np.int64)
    for s in range(1, nsep + 1):
        off = int(plan.sep_offset[s])
        sep_of_perm[off:off + int(plan.sep_sizes[s])] = s

    col_sep = sep_of_perm[pc2]
    # original below-diagonal rows per column-separator: one global sort by
    # (col_sep, row) then contiguous slices — a per-separator mask over the
    # whole entry array is O(nnz * nsep) and takes minutes at 1M dofs
    order = np.lexsort((pr2, col_sep))
    cs_sorted = col_sep[order]
    pr_sorted = pr2[order]
    starts = np.searchsorted(cs_sorted, np.arange(1, nsep + 2))
    sep_hi = plan.sep_offset[1:nsep + 1] + plan.sep_sizes[1:nsep + 1]
    orig_rows = {}
    for s in range(1, nsep + 1):
        rr = pr_sorted[starts[s - 1]:starts[s]]      # sorted ascending
        lo = np.searchsorted(rr, int(sep_hi[s - 1]))
        seg = rr[lo:]
        if len(seg):
            seg = seg[np.concatenate([[True], seg[1:] != seg[:-1]])]
        orig_rows[s] = seg

    # bottom-up boundary recurrence (children have smaller sep numbers)
    bnd = {}
    for s in range(1, nsep + 1):
        h = t.heap_of(s)
        parts = [orig_rows[s]]
        if 2 * h <= nsep:                       # internal node: two children
            parts.append(bnd[t.sep_of(2 * h)])
            parts.append(bnd[t.sep_of(2 * h + 1)])
        u = np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64)
        hi = int(plan.sep_offset[s] + plan.sep_sizes[s])
        bnd[s] = u[u >= hi]

    levels = plan.levels
    W_list = []
    F_list = []
    front_rows = []
    for lvl in range(levels):
        B = 1 << lvl
        max_sz = max(int(plan.sep_sizes[t.sep_at(lvl, sl)]) for sl in range(B))
        bndK = max((len(bnd[t.sep_at(lvl, sl)]) for sl in range(B)),
                   default=0)
        Wl = _round_up(max_sz, pad_to)
        Fl = Wl + _round_up(bndK, pad_to) if bndK else Wl
        fr = np.full((B, Fl), n, dtype=np.int64)
        for sl in range(B):
            s = t.sep_at(lvl, sl)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            fr[sl, :sz] = np.arange(off, off + sz)
            bs = bnd[s]
            fr[sl, Wl:Wl + len(bs)] = bs
        W_list.append(Wl)
        F_list.append(Fl)
        front_rows.append(fr)
    W = tuple(W_list)

    inv_child: List[Optional[np.ndarray]] = [None] * levels
    for lvl in range(1, levels):
        B = 1 << lvl
        Fp = F_list[lvl - 1]
        bndK = F_list[lvl] - W[lvl]
        inv = np.full((B, Fp), bndK, dtype=np.int32)
        for sl in range(B):
            s = t.sep_at(lvl, sl)
            c_bnd = bnd[s]
            if len(c_bnd) == 0:
                continue
            prow = front_rows[lvl - 1][sl >> 1]
            # position of each parent-front row in this child's boundary
            pos = np.searchsorted(c_bnd, prow)
            pos_ok = pos < len(c_bnd)
            hit = np.zeros(Fp, dtype=bool)
            hit[pos_ok] = c_bnd[pos[pos_ok]] == prow[pos_ok]
            inv[sl, hit] = pos[hit]
            # every child boundary row must appear in the parent front
            assert hit.sum() == len(c_bnd), (
                f"extend-add: child sep {s} boundary not covered by parent front")
        inv_child[lvl] = inv

    fwd_child: List[Optional[np.ndarray]] = [None] * levels
    for lvl in range(1, levels):
        B = 1 << lvl
        Fp = F_list[lvl - 1]
        bndK = F_list[lvl] - W[lvl]
        fwd = np.full((B, bndK), Fp, dtype=np.int32)
        inv = inv_child[lvl]
        for sl in range(B):
            js = np.nonzero(inv[sl] != bndK)[0]
            fwd[sl, inv[sl][js]] = js
        fwd_child[lvl] = fwd

    import hashlib

    h = hashlib.blake2b(digest_size=12)
    h.update(np.ascontiguousarray(plan.perm, dtype=np.int64).tobytes())
    for fr in front_rows:
        h.update(np.ascontiguousarray(fr, dtype=np.int32).tobytes())
    fp = FrontalPlan(plan, W, tuple(F_list), front_rows, inv_child, fwd_child,
                     fingerprint=h.hexdigest())
    _FPLAN_CACHE[fp.key()] = fp
    return fp


# ---------------------------------------------------------------------------
# Host assembly


def _front_scatter_indices(fp: FrontalPlan, rows: np.ndarray,
                           cols: np.ndarray):
    """Where every original COO entry lands in the pivot-column slabs: per
    level, (val_sel, flat_idx, ones_flat) with `vals[val_sel]` going to flat
    position `flat_idx` of the [B*F*W] slab and `ones_flat` the padded pivot
    diagonal positions (set to 1 for well-posed Cholesky under padding).
    Pure pattern bookkeeping — computed once, reused for every refill (the
    reference recomputes hash lookups per fill_block call, mmat.rg:530-633)."""
    plan = fp.plan
    t = plan.tree
    pr = plan.iperm[rows]
    pc = plan.iperm[cols]
    swap = pc > pr
    pr2 = np.where(swap, pc, pr)
    pc2 = np.where(swap, pr, pc)

    # group entries by column separator once (one sort) instead of masking
    # the whole entry array per slot
    col_sep = plan.sep_of_dof[plan.perm[pc2]]
    order = np.argsort(col_sep, kind="stable")
    starts = np.searchsorted(col_sep[order],
                             np.arange(1, plan.num_separators + 2))
    starts = np.concatenate([[0], starts])

    out = []
    for lvl in range(plan.levels):
        B = 1 << lvl
        Fl, Wl = fp.F[lvl], fp.W[lvl]
        sels, flats, ones = [], [], []
        for sl in range(B):
            s = t.sep_at(lvl, sl)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            grp = order[starts[s]:starts[s + 1]]
            if len(grp):
                rr = pr2[grp]
                fr = fp.front_rows[lvl][sl]
                pos = np.searchsorted(fr[Wl:], rr)
                in_piv = rr < off + sz
                rpos = np.where(in_piv, rr - off, Wl + pos)
                sels.append(grp)
                flats.append((sl * Fl + rpos) * Wl + (pc2[grp] - off))
            if sz < Wl:
                d = np.arange(sz, Wl, dtype=np.int64)
                ones.append((sl * Fl + d) * Wl + d)
        cat = lambda xs: (np.concatenate(xs) if xs
                          else np.zeros(0, dtype=np.int64))
        out.append((cat(sels).astype(np.int64), cat(flats).astype(np.int64),
                    cat(ones).astype(np.int64)))
    return out


def assemble_fronts(fp: FrontalPlan, rows: np.ndarray, cols: np.ndarray,
                    vals: np.ndarray, dtype=np.float32) -> List[np.ndarray]:
    """Scatter original entries into the pivot-column slabs [B, F, W] of each
    level's fronts (original entries only ever live in pivot columns; the
    trailing block is filled by extend-add on device). Padded pivot diagonal
    entries are set to 1 (well-posed Cholesky under padding).

    `vals` may be [nnz] (one matrix) or [K, nnz] (K same-pattern matrices —
    the batched-factorization path): the scatter indices are computed once
    and applied across the leading axis, yielding [K, B, F, W] slabs."""
    plan = fp.plan
    vals = np.asarray(vals)
    batched = vals.ndim == 2
    out = []
    for lvl, (sel, flat, ones) in enumerate(
            _front_scatter_indices(fp, rows, cols)):
        B = 1 << lvl
        Fl, Wl = fp.F[lvl], fp.W[lvl]
        if batched:
            arr = np.zeros((vals.shape[0], B * Fl * Wl), dtype=dtype)
            arr[:, ones] = 1.0
            arr[:, flat] = vals[:, sel]
            arr = arr.reshape(vals.shape[0], B, Fl, Wl)
        else:
            arr = np.zeros(B * Fl * Wl, dtype=dtype)
            arr[ones] = 1.0
            arr[flat] = vals[sel]
            arr = arr.reshape(B, Fl, Wl)
        out.append(arr)
    return out


class FrontAssembler:
    """Device-side front assembly: the reference's per-iteration refill
    (fill_block hash probes, mmat.rg:530-633, re-run each --iterations pass
    at :1216-1224) becomes ONE compiled scatter per level. Re-factorization
    with new values (update_values / factorize_many / --iterations) then
    uploads only the [nnz] value vector — not the assembled slabs — and the
    whole refill runs at HBM bandwidth on device. Indices are pattern-only:
    built once, valid for every value set."""

    def __init__(self, fp: FrontalPlan, rows: np.ndarray, cols: np.ndarray):
        self.fp = fp
        self.idx = _front_scatter_indices(fp, rows, cols)
        self.shapes = tuple((1 << lvl, fp.F[lvl], fp.W[lvl])
                            for lvl in range(fp.plan.levels))

    def __call__(self, vals, dtype=np.float32) -> List[jax.Array]:
        """vals [nnz] or [K, nnz] → per-level device slabs [B, F, W] or
        [K, B, F, W]."""
        dtype = np.dtype(dtype)
        vals = np.asarray(vals)
        if vals.dtype.itemsize > dtype.itemsize:
            vals = vals.astype(dtype)       # halve the upload before H2D
        if any(int(np.prod(s)) >= _INT32_SCATTER_LIMIT for s in self.shapes):
            # huge-front regime: per-level programs; >= 2^31-element slabs
            # go through the (slot, rem) int32-safe scatter
            v = jnp.asarray(vals)
            outs = []
            for lvl, shape in enumerate(self.shapes):
                big = int(np.prod(shape)) >= _INT32_SCATTER_LIMIT
                raw = _big_level_idx(self, lvl) if big else self.idx[lvl]
                idx = tuple(jnp.asarray(a) for a in raw)
                fn = _assemble_level_big_jit if big else _assemble_level_jit
                one = lambda x: fn(shape, str(dtype), x, idx)  # noqa: B023
                outs.append(jax.vmap(one)(v) if v.ndim == 2 else one(v))
            return outs
        idx = tuple(tuple(jnp.asarray(a) for a in lvl) for lvl in self.idx)
        out = _assemble_device_jit(self.shapes, str(dtype), jnp.asarray(vals),
                                   idx)
        return list(out)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _assemble_device_jit(shapes, dtype, vals, idx):
    dt = jnp.dtype(dtype)

    def one(v):
        outs = []
        for (B, Fl, Wl), (sel, flat, ones) in zip(shapes, idx):
            slab = jnp.zeros((B * Fl * Wl,), dt)
            slab = slab.at[ones].set(jnp.asarray(1.0, dt),
                                     indices_are_sorted=True,
                                     unique_indices=True)
            slab = slab.at[flat].set(v[sel].astype(dt), unique_indices=True)
            outs.append(slab.reshape(B, Fl, Wl))
        return tuple(outs)

    return jax.vmap(one)(vals) if vals.ndim == 2 else one(vals)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _assemble_level_jit(shape, dtype, vals, idx):
    B, Fl, Wl = shape
    sel, flat, ones = idx
    dt = jnp.dtype(dtype)
    slab = jnp.zeros((B * Fl * Wl,), dt)
    slab = slab.at[ones].set(jnp.asarray(1.0, dt), indices_are_sorted=True,
                             unique_indices=True)
    slab = slab.at[flat].set(vals[sel].astype(dt), unique_indices=True)
    return slab.reshape(B, Fl, Wl)


# jnp scatter indices are int32 without x64; a level slab with >= 2^31
# elements (bf16-streamed huge-front regimes) must scatter per-slot
_INT32_SCATTER_LIMIT = 1 << 31


@functools.partial(jax.jit, static_argnums=(0, 1))
def _assemble_level_big_jit(shape, dtype, vals, idx):
    """Level slab with >= 2^31 elements: a flat index would overflow int32
    (x64-off jnp downcasts int64 indices), so scatter into [B, Fl*Wl] with
    (slot, remainder) int32 pairs — each component stays < 2^31 because a
    SINGLE front never reaches 2^31 elements (8.6 GB f32)."""
    B, Fl, Wl = shape
    sel, slot, rem, oslot, orem = idx
    dt = jnp.dtype(dtype)
    slab = jnp.zeros((B, Fl * Wl), dt)
    slab = slab.at[oslot, orem].set(jnp.asarray(1.0, dt),
                                    unique_indices=True)
    slab = slab.at[slot, rem].set(vals[sel].astype(dt), unique_indices=True)
    return slab.reshape(B, Fl, Wl)


def _big_level_idx(asm: "FrontAssembler", lvl: int):
    """(sel, slot, rem, ones_slot, ones_rem) int32 host arrays for a
    >= 2^31-element level, memoized on the assembler."""
    cache = getattr(asm, "_big_idx_cache", None)
    if cache is None:
        cache = asm._big_idx_cache = {}
    if lvl not in cache:
        _, Fl, Wl = asm.shapes[lvl]
        fw = Fl * Wl
        sel, flat, ones = asm.idx[lvl]
        cache[lvl] = (sel.astype(np.int32),
                      (flat // fw).astype(np.int32),
                      (flat % fw).astype(np.int32),
                      (ones // fw).astype(np.int32),
                      (ones % fw).astype(np.int32))
    return cache[lvl]


def _chunk_level_idx(asm: "FrontAssembler", lvl: int, c0: int, c1: int):
    """Scatter indices restricted to blocks [c0, c1) of a level, shifted to
    chunk-local flat positions — lets a batch-chunked level program assemble
    ONLY its slice [c0:c1, F, W] (the full level slab never materializes).
    Memoized on the assembler; pattern-only like the base indices."""
    cache = getattr(asm, "_chunk_idx_cache", None)
    if cache is None:
        cache = asm._chunk_idx_cache = {}
    ck = (lvl, c0, c1)
    if ck not in cache:
        _, Fl, Wl = asm.shapes[lvl]
        per = Fl * Wl
        lo, hi = c0 * per, c1 * per
        sel, flat, ones = asm.idx[lvl]
        m = (flat >= lo) & (flat < hi)
        mo = (ones >= lo) & (ones < hi)
        cache[ck] = (np.ascontiguousarray(sel[m]),
                     np.ascontiguousarray(flat[m] - lo),
                     np.ascontiguousarray(ones[mo] - lo))
    return cache[ck]


def _assemble_level_chunk(asm: "FrontAssembler", vals_dev, lvl: int,
                          c0: int, c1: int, dtype) -> jax.Array:
    """Assemble the [c1-c0, F, W] slice of a level's slab on device from the
    (already uploaded) value vector."""
    _, Fl, Wl = asm.shapes[lvl]
    shape = (c1 - c0, Fl, Wl)
    if int(np.prod(shape)) >= _INT32_SCATTER_LIMIT:
        sel, flat, ones = _chunk_level_idx(asm, lvl, c0, c1)
        fw = Fl * Wl
        idx = tuple(jnp.asarray(a) for a in (
            sel.astype(np.int32), (flat // fw).astype(np.int32),
            (flat % fw).astype(np.int32), (ones // fw).astype(np.int32),
            (ones % fw).astype(np.int32)))
        return _assemble_level_big_jit(shape, str(np.dtype(dtype)),
                                       vals_dev, idx)
    idx = tuple(jnp.asarray(a)
                for a in _chunk_level_idx(asm, lvl, c0, c1))
    return _assemble_level_jit(shape, str(np.dtype(dtype)), vals_dev, idx)


class LazyFronts:
    """Sequence view over an UNASSEMBLED front set: each level's slab is
    scattered on device at first access and not retained, so the streamed
    factorization holds only the CURRENT level's input slab on the device
    — never
    the whole multi-GiB front set. Keeps device-side assembly's one-upload
    property (only the [nnz] value vector crosses host->device, like the
    reference's region-resident fill, mnd.c:152-199) in the streamed
    regime, where eagerly assembling every level's device slab upfront
    (6.5 GiB at 1M dofs) plus transition temps exhausts a 16 GiB device."""

    def __init__(self, asm: "FrontAssembler", vals, dtype=np.float32):
        self.asm = asm
        self.dtype = np.dtype(dtype)
        self.shapes = asm.shapes
        vals = np.asarray(vals)
        if vals.ndim != 1:
            raise ValueError("LazyFronts serves single-matrix assembly")
        if vals.dtype.itemsize > self.dtype.itemsize:
            vals = vals.astype(self.dtype)
        self.vals = jnp.asarray(vals)               # the ONE upload

    def __len__(self) -> int:
        return len(self.shapes)

    def __getitem__(self, lvl: int) -> jax.Array:
        shape = self.shapes[lvl]
        if int(np.prod(shape)) >= _INT32_SCATTER_LIMIT:
            idx = tuple(jnp.asarray(a) for a in _big_level_idx(self.asm, lvl))
            return _assemble_level_big_jit(shape, str(self.dtype),
                                           self.vals, idx)
        idx = tuple(jnp.asarray(a) for a in self.asm.idx[lvl])
        return _assemble_level_jit(shape, str(self.dtype), self.vals, idx)

    def chunk(self, lvl: int, c0: int, c1: int) -> jax.Array:
        """Assemble only blocks [c0, c1) of a level (batch-chunked levels)."""
        return _assemble_level_chunk(self.asm, self.vals, lvl, c0, c1,
                                     self.dtype)

    def nbytes_of(self, lvl: int) -> int:
        return int(np.prod(self.shapes[lvl])) * self.dtype.itemsize


# ---------------------------------------------------------------------------
# Device factor / solve


def _expand_child_updates_matmul(fp: FrontalPlan, U, child_lvl: int):
    """Matmul-based expansion: E = S U S^T with S the one-hot selection
    matrix built from the forward map — puts the extend-add on the matrix
    units instead of scatter hardware. Wins when scatter bandwidth dominates."""
    fwd = jnp.asarray(fp.fwd_child[child_lvl])            # [2B, K]
    B2, K = fwd.shape
    Fp = fp.F[child_lvl - 1]
    rows = lax.broadcasted_iota(jnp.int32, (Fp, 1), 0)
    S = (fwd[:, None, :] == rows[None, :, :]).astype(U.dtype)  # [2B, Fp, K]
    acc = jnp.promote_types(U.dtype, jnp.float32)   # f32 accum for bf16 U
    US = jnp.einsum("bkj,bfj->bkf", U, S, preferred_element_type=acc)
    E = jnp.einsum("bfk,bkg->bfg", S.astype(acc), US,
                   preferred_element_type=acc)
    seg = jnp.arange(B2) >> 1
    return jax.ops.segment_sum(E, seg, num_segments=B2 // 2,
                               indices_are_sorted=True)


def _fold_maps(fp: FrontalPlan, child_lvl: int, nrows: int):
    """Sibling-folded row-gather maps, precomputed in NumPy (the plan's
    index arrays are host constants): idx[b, 2f+c] = c*nrows +
    clamp(inv[2b+c, f]) selects from the two children stacked along rows,
    mask marks parent positions actually present in child c (inv sentinel
    = child boundary size). Lets the gather emit the sibling-folded
    operand layout [B, Fp, 2C] directly — the post-gather
    swapaxes+reshape of the unfolded form is a full-array HBM copy."""
    inv = fp.inv_child[child_lvl]                    # [2B, Fp]
    B2, Fp = inv.shape
    inv2 = inv.reshape(B2 // 2, 2, Fp)
    valid = inv2 < nrows
    idx = (np.minimum(inv2, nrows - 1)
           + (np.arange(2, dtype=np.int32) * nrows)[None, :, None])
    idx_fold = np.swapaxes(idx, 1, 2).reshape(B2 // 2, 2 * Fp)
    mask_fold = np.swapaxes(valid, 1, 2).reshape(B2 // 2, 2 * Fp)
    return idx_fold.astype(np.int32), mask_fold


def _folded_row_gather(fp: FrontalPlan, child_lvl: int, arr):
    """Gather rows of the per-child arr [2B, R, C] into parent coordinates
    in sibling-folded layout [B, Fp, 2C] in ONE pass: the two siblings are
    a free reshape of arr ([2B, R, C] -> [B, 2R, C] row-major), the fold
    indices offset into it, and [B, 2Fp, C] -> [B, Fp, 2C] is again a
    free row-major reshape — no transpose copy, no sentinel pad copy."""
    B2, R, C = arr.shape
    idx, mask = _fold_maps(fp, child_lvl, R)
    g = _chunked_row_gather(arr.reshape(B2 // 2, 2 * R, C),
                            jnp.asarray(idx))        # [B, 2Fp, C]
    g = jnp.where(jnp.asarray(mask)[:, :, None], g, 0)
    return g.reshape(B2 // 2, idx.shape[1] // 2, 2 * C)


def _folded_onehot(fp: FrontalPlan, child_lvl: int, dtype):
    """One-hot column-reindex operand in sibling-folded layout [B, Fp, 2K],
    generated directly from fwd (fwd sentinel = Fp never matches the iota,
    so padded child columns contribute zero)."""
    fwd = fp.fwd_child[child_lvl]                    # [2B, K]
    B2, K = fwd.shape
    Fp = fp.F[child_lvl - 1]
    fwd_pair = jnp.asarray(
        fwd.reshape(B2 // 2, 2 * K).astype(np.int32))
    rows = lax.broadcasted_iota(jnp.int32, (Fp, 1), 0)
    return (fwd_pair[:, None, :] == rows[None, :, :]).astype(dtype)


def _expand_child_updates_gathermm(fp: FrontalPlan, U, child_lvl: int):
    """Half-gather matmul expansion: rows of U are gathered into parent
    coordinates (gathers run near HBM bandwidth), then a single one-hot
    einsum reindexes the columns — with both siblings folded into the
    contraction axis, so the sibling segment-sum is free. Saves the
    [K,K]x[K,Fp] einsum (2B*K^2*Fp FLOPs) of the full matmul expansion and
    its separate segment-sum pass. Both operands are produced directly in
    the folded layout (_folded_row_gather/_folded_onehot) — the earlier
    gather-then-swapaxes form paid two full-array HBM transpose copies."""
    acc = jnp.promote_types(U.dtype, jnp.float32)
    Gr = _folded_row_gather(fp, child_lvl, U)        # [B, Fp, 2K]
    Sr = _folded_onehot(fp, child_lvl, acc)          # [B, Fp, 2K]
    return jnp.einsum("bfj,bgj->bfg", Gr, Sr,
                      preferred_element_type=acc)


# ---------------------------------------------------------------------------
# Two-piece extend-add: the factorization only ever reads the pivot-column
# slab [B, F, W] and the trailing block [B, K, K] of each front, so the
# square [B, F, F] update (and the square front itself) never needs to
# exist. At an 80^3 problem one mid-tree level's square fronts alone are
# ~3.9 GiB; materializing them (plus the expanded square updates) pushes the
# monolithic factor program past a 16 GiB device. These variants
# emit (E_slab [B, Fp, W], E_T [B, K, K]) directly.


def _masked_row_gather(arr, idx, nrows: int):
    """Row gather with sentinel masking instead of a padded operand copy:
    positions with idx >= nrows read zero. jnp.pad of a GiB-scale child
    update is a full HBM copy; clip+mask touches only the (smaller)
    output."""
    g = _chunked_row_gather(arr, jnp.minimum(idx, nrows - 1))
    return jnp.where((idx < nrows)[:, :, None], g, 0)


def _masked_minor_gather(arr, idx, ncols: int):
    """Minor-axis gather with sentinel masking (see _masked_row_gather)."""
    g = _minor_gather(arr, jnp.minimum(idx, ncols - 1))
    return jnp.where((idx < ncols)[:, None, :], g, 0)


def _expand_xxt_2(fp: FrontalPlan, X, child_lvl: int, W: int,
                  t_dtype=None):
    """Leaf-transition two-piece expansion straight from X: a leaf child's
    update is exactly X X^T (no accumulated trailing block), so X's rows are
    gathered into parent coordinates and the Schur product is computed
    there, siblings folded into the contraction:

        E = [P1 X1 | P2 X2] [P1 X1 | P2 X2]^T        (two einsums, slab + T)

    vs materializing U = X X^T (2B*K^2*W FLOPs, [2B, K, K] in HBM) and
    reindexing it with a contraction over 2K. Leaf boundaries are much wider
    than leaf pivots (K ~ 5-10x W), so this cuts the widest transition's
    matmul FLOPs ~K/W x, skips the [2B, K, K] HBM round trip, and rounds X
    to a low-precision matmul operand once instead of twice."""
    Fp = fp.F[child_lvl - 1]
    acc = jnp.promote_types(X.dtype, jnp.float32)
    Gr = _folded_row_gather(fp, child_lvl, X)       # [B, Fp, 2Wc]
    E_slab = jnp.einsum("bfj,bgj->bfg", Gr, Gr[:, :W, :],
                        preferred_element_type=acc)
    E_T = (_einsum_rows_cast(Gr[:, W:, :], Gr[:, W:, :], t_dtype or acc)
           if Fp > W else None)
    return E_slab, E_T


def _expand_gathermm_2(fp: FrontalPlan, U, child_lvl: int, W: int,
                       t_dtype=None):
    """gathermm two-piece expansion (row-gather + one-hot column einsum,
    siblings folded, both operands produced directly in folded layout),
    emitting the slab and trailing pieces separately."""
    Fp = fp.F[child_lvl - 1]
    acc = jnp.promote_types(U.dtype, jnp.float32)
    Gr = _folded_row_gather(fp, child_lvl, U)                      # [B, Fp, 2K]
    Sr = _folded_onehot(fp, child_lvl, acc)                        # [B, Fp, 2K]
    E_slab = jnp.einsum("bfj,bgj->bfg", Gr, Sr[:, :W, :],
                        preferred_element_type=acc)
    E_T = (_einsum_rows_cast(Gr[:, W:, :], Sr[:, W:, :], t_dtype or acc)
           if Fp > W else None)
    return E_slab, E_T


_CAST_CHUNK = 1024


def _einsum_rows_cast(Ga, Gb, out_dtype):
    """einsum("bfj,bgj->bfg", Ga, Gb) accumulated in f32 but STORED as
    out_dtype, chunked over the f axis so the full-size f32 result never
    materializes — the [B, K, K] trailing pieces are multi-GiB at 1M dofs
    and out_dtype bf16 halves their residency."""
    acc = jnp.promote_types(Ga.dtype, jnp.float32)
    if jnp.dtype(out_dtype) == acc:
        return jnp.einsum("bfj,bgj->bfg", Ga, Gb,
                          preferred_element_type=acc)
    F = Ga.shape[1]
    # fori_loop, NOT an unrolled chunk loop: unrolled chunks are data-
    # independent and XLA schedules them all concurrently, keeping every
    # chunk buffer live at once. The last window is tail-aligned (start
    # clamped to F-ch) — it recomputes a few rows, which is value-identical.
    ch = min(_CAST_CHUNK, F)
    nch = -(-F // ch)
    out0 = jnp.zeros((Ga.shape[0], F, Gb.shape[1]), out_dtype)
    z = jnp.int32(0)

    def body(i, out):
        f0 = jnp.minimum(i * ch, F - ch).astype(jnp.int32)
        ga = lax.dynamic_slice(Ga, (z, f0, z),
                               (Ga.shape[0], ch, Ga.shape[2]))
        pc = jnp.einsum("bfj,bgj->bfg", ga, Gb, preferred_element_type=acc)
        return lax.dynamic_update_slice(out, pc.astype(out_dtype),
                                        (z, f0, z))

    return lax.fori_loop(jnp.int32(0), jnp.int32(nch), body, out0)


def _schur_update_cast(X, E_T, out_dtype, fp=None, child_lvl=None):
    """U2 = X X^T (+ E_T), f32 accumulation, stored as out_dtype, chunked
    over rows (see _einsum_rows_cast). When E_T already has the output
    dtype it SEEDS the fori carry, so the accumulation happens in place
    (the while-loop carry aliases) instead of holding E_T and U2 — two
    multi-GiB trailing buffers — simultaneously.

    E_T may also be the DEFERRED tag ("gather2", U) from
    _apply_extadd_two_piece(defer_T=True): the trailing extend-add is then
    computed row-chunk by row-chunk INSIDE this loop (the same masked
    gathers _apply_gather_2 would run) and never materialized — at a
    1.7M-dof mid level the materialized [B, K, K] E_T plus its padded
    fori carry were ~4 GiB of the level program's 15.96 GiB peak."""
    acc = jnp.promote_types(X.dtype, jnp.float32)
    gather2 = isinstance(E_T, tuple) and E_T[0] == "gather2"
    if jnp.dtype(out_dtype) == acc and E_T is None:
        return jnp.einsum("bik,bjk->bij", X, X, preferred_element_type=acc)
    K = X.shape[1]
    # fori_loop with tail-aligned windows (see _einsum_rows_cast). A
    # tail-overlap re-ADD would double-count, so the tail window is
    # handled by clamping the einsum rows instead: windows stay disjoint
    # via exact chunking over ceil-divided rows with a masked final write.
    ch = min(_CAST_CHUNK, K)
    if gather2:
        U = E_T[1]
        W = X.shape[2]
        inv = jnp.asarray(fp.inv_child[child_lvl]).astype(jnp.int32)
        B2, Kc = U.shape[0], U.shape[1]
        col_idx = inv[:, W:]                                 # [2B, K]
        # bound the per-chunk gather buffers like _apply_gather_2 does
        ch = max(128, min(ch, (256 << 20)
                          // max(1, B2 * Kc * jnp.dtype(U.dtype).itemsize)))
        ch = min(ch, K)
    nch = -(-K // ch)
    z = jnp.int32(0)
    if (E_T is not None and not gather2
            and E_T.dtype == jnp.dtype(out_dtype)):
        carry0 = E_T
        seeded = True
    else:
        carry0 = jnp.zeros((X.shape[0], K, K), out_dtype)
        seeded = False

    def body(i, out):
        f0 = jnp.minimum(i * ch, K - ch).astype(jnp.int32)
        xc = lax.dynamic_slice(X, (z, f0, z), (X.shape[0], ch, X.shape[2]))
        pc = jnp.einsum("bik,bjk->bij", xc, X, preferred_element_type=acc)
        tc = lax.dynamic_slice(out, (z, f0, z), (out.shape[0], ch, K)) \
            if seeded else None
        if seeded:
            pc = pc + tc.astype(acc)
        elif gather2:
            # the trailing rows [W+f0, W+f0+ch) of the child extend-add,
            # computed in place of slicing a materialized E_T
            idxc = lax.dynamic_slice(inv, (z, W + f0), (B2, ch))
            G = _masked_row_gather(U, idxc, Kc)              # [2B, ch, Kc]
            E = _masked_minor_gather(G, col_idx, Kc)         # [2B, ch, K]
            pc = pc + E.reshape(-1, 2, ch, K).sum(1).astype(acc)
        elif E_T is not None:
            tc = lax.dynamic_slice(E_T, (z, f0, z),
                                   (E_T.shape[0], ch, E_T.shape[2]))
            pc = pc + tc.astype(acc)
        if nch * ch != K:
            # tail window overlaps the previous one; rows already written
            # must keep their value (they were computed with the identical
            # formula, so overwriting is safe for the unseeded path, but the
            # seeded path would re-add E_T rows it already consumed — mask
            # overlapped rows to their existing content)
            rows = f0 + lax.broadcasted_iota(jnp.int32, (ch, 1), 0)
            fresh = rows >= (i * ch)
            cur = lax.dynamic_slice(out, (z, f0, z), (out.shape[0], ch, K))
            pc = jnp.where(fresh[None], pc.astype(out_dtype),
                           cur).astype(acc)
        return lax.dynamic_update_slice(out, pc.astype(out_dtype),
                                        (z, f0, z))

    return lax.fori_loop(jnp.int32(0), jnp.int32(nch), body, carry0)


def _apply_gather_2(fp: FrontalPlan, slab, U, child_lvl: int, t_dtype=None,
                    chunk_bytes: int = 256 << 20, defer_T: bool = False):
    """Scatter-free two-piece extend-add for the largest levels: both pieces
    are built row-chunk by row-chunk with masked gathers and CONCATENATED —
    no scatter-add chains (XLA materializes copy buffers around functional
    scatter updates; the chunked-scatter variant holds 7-9 GiB of HLO temps
    at a 1M-dof mid level, this one holds ~2 chunk buffers).

      E[b, f, g] = sum_sib U[2b+sib, inv[2b+sib, f], inv[2b+sib, g]]

    with sentinel-masked gathers (inv == Kc → 0). Each T chunk is written
    exactly once, so T needs no zero-init and no accumulation."""
    inv = jnp.asarray(fp.inv_child[child_lvl]).astype(jnp.int32)   # [2B, Fp]
    B2, Kc = U.shape[0], U.shape[1]
    B = B2 // 2
    Fp = fp.F[child_lvl - 1]
    W = slab.shape[2]
    K = Fp - W
    itemsize = jnp.dtype(U.dtype).itemsize
    ch = max(128, min(4096, chunk_bytes // max(1, B2 * Kc * itemsize)))

    # The chunk loop MUST be a lax.fori_loop, not a Python loop: unrolled
    # chunks are data-independent, so XLA's scheduler overlaps all of them
    # and the program holds every chunk buffer at once (measured: 20 live
    # 504 MB gather outputs at a 1M-dof mid level = 10 GiB of temps). The
    # loop's sequential semantics bound residency to one chunk.
    def e_chunk(idxc, col_idx):
        # [2B, ch, Kc] row gather, then minor gather to parent columns
        G = _masked_row_gather(U, idxc, Kc)
        E = _masked_minor_gather(G, col_idx, Kc)        # [2B, ch, |cols|]
        return E.reshape(B, 2, ch, E.shape[2]).sum(1)

    z = jnp.int32(0)

    def run(carry_rows, row_lo, col_idx, combine):
        nch = -(-carry_rows.shape[1] // ch)
        pad_rows = nch * ch - carry_rows.shape[1]
        carry0 = jnp.pad(carry_rows, ((0, 0), (0, pad_rows), (0, 0)))
        inv_pad = jnp.pad(inv, ((0, 0), (0, max(0, row_lo + nch * ch - Fp))),
                          constant_values=Kc)

        def body(i, carry):
            f0 = (i * ch + row_lo).astype(jnp.int32)
            idxc = lax.dynamic_slice(inv_pad, (z, f0), (B2, ch))
            Ef = e_chunk(idxc, col_idx)
            cur = lax.dynamic_slice(
                carry, (z, (i * ch).astype(jnp.int32), z),
                (B, ch, carry.shape[2]))
            return lax.dynamic_update_slice(
                carry, combine(cur, Ef), (z, (i * ch).astype(jnp.int32), z))

        out = lax.fori_loop(jnp.int32(0), jnp.int32(nch), body, carry0)
        return out[:, :carry_rows.shape[1], :]

    slab = run(slab, 0, inv[:, :W],
               lambda cur, Ef: cur - Ef.astype(cur.dtype))
    if K == 0:
        return slab, None
    if defer_T:
        # the trailing piece is consumed exactly once, row-chunk by
        # row-chunk, by _schur_update_cast — hand it the tag instead of
        # materializing a [B, K, K] buffer plus its padded fori carry
        return slab, ("gather2", U)
    td = t_dtype or jnp.promote_types(U.dtype, jnp.float32)
    T = run(jnp.zeros((B, K, K), td), W, inv[:, W:],
            lambda cur, Ef: Ef.astype(cur.dtype))
    return slab, T


def _apply_extadd_two_piece(fp: FrontalPlan, slab, U, child_lvl: int,
                            cap: Optional[int] = None, t_dtype=None,
                            defer_T: bool = False):
    """Dispatch the two-piece extend-add: xxt from a leaf tag, gathermm when
    its intermediates fit the byte cap, chunked fused scatter otherwise.
    Returns (slab - E_slab, E_T or None). E_T is stored as t_dtype —
    except on the chunked-gather path with defer_T, where it is the tag
    ("gather2", U) for _schur_update_cast to consume lazily."""
    if cap is None:
        cap = capacity.threshold("gathermm_cap")
    W = slab.shape[2]
    Fp = fp.F[child_lvl - 1]
    if isinstance(U, tuple) and U[0] == "xxt":
        Xc = U[1]
        B2 = Xc.shape[0]
        if 2 * (B2 * Fp * Xc.shape[2] * Xc.dtype.itemsize) <= cap:
            E_slab, E_T = _expand_xxt_2(fp, Xc, child_lvl, W,
                                        t_dtype=t_dtype)
            return slab - E_slab.astype(slab.dtype), E_T
        acc = jnp.promote_types(Xc.dtype, jnp.float32)
        U = jnp.einsum("bik,bjk->bij", Xc, Xc,
                       preferred_element_type=acc).astype(Xc.dtype)
    B2, Kc = U.shape[0], U.shape[1]
    if Kc == 0:
        return slab, None
    if B2 >= 4 and 2 * (B2 * Fp * Kc * U.dtype.itemsize) <= cap:
        E_slab, E_T = _expand_gathermm_2(fp, U, child_lvl, W,
                                         t_dtype=t_dtype)
        return slab - E_slab.astype(slab.dtype), E_T
    return _apply_gather_2(fp, slab, U, child_lvl, t_dtype=t_dtype,
                           defer_T=defer_T)


def _apply_child_updates_fused(fp: FrontalPlan, full, U, child_lvl: int):
    """Subtract both children's updates directly into the parent's full
    fronts [B, Fp, Fp] in one gather + one scatter-add:

      * columns: minor-axis gather from the (small) padded child update,
        putting each child row into parent column coordinates;
      * rows: scatter-add the child rows at their parent positions, siblings
        combined by duplicate batch indices.

    Avoids materializing the expanded [2B, Fp, Fp] update, both transposes,
    and the separate segment-sum + subtract passes of the standalone
    expansion (~2.5x less HBM traffic)."""
    inv = jnp.asarray(fp.inv_child[child_lvl]).astype(jnp.int32)   # [2B, Fp]
    fwd = jnp.asarray(fp.fwd_child[child_lvl]).astype(jnp.int32)   # [2B, K]
    B2, K = fwd.shape
    Fp = fp.F[child_lvl - 1]
    Upad = jnp.pad(U, ((0, 0), (0, 0), (0, 1)))                    # col sentinel
    e1 = _minor_gather(Upad, inv)                                  # [2B, K, Fp]
    seg = (jnp.arange(B2) >> 1)[:, None]
    fullpad = jnp.pad(full, ((0, 0), (0, 1), (0, 0)))              # row sentinel
    # NOTE: deliberately no indices_are_sorted/unique hints — sibling pairs
    # share a batch index, and a scatter lowering may drop duplicate
    # contributions when the hints claim uniqueness. (Splitting into two
    # hinted scatters is correct but slower: two full passes.)
    fullpad = fullpad.at[seg, fwd, :].add(-e1.astype(full.dtype))
    return fullpad[:, :Fp, :]


_MINOR_CHUNK = 2048


def _minor_gather(arr, idx):
    """take_along_axis(arr, idx[:, None, :], axis=2), chunked over the
    operand's minor axis: gathers whose operand minor dimension exceeded
    ~2048 faulted on the backend this solver was first built for, so wide
    operands are processed in masked 2048-column chunks (whether the GPU
    backend needs this awaits re-bisection on the card)."""
    Kc = arr.shape[2]
    if Kc <= _MINOR_CHUNK:
        return jnp.take_along_axis(arr, idx[:, None, :], axis=2)
    out = None
    for base in range(0, Kc, _MINOR_CHUNK):
        size = min(_MINOR_CHUNK, Kc - base)
        part = arr[:, :, base:base + size]
        local = idx - base
        mask = (local >= 0) & (local < size)
        g = jnp.take_along_axis(
            part, jnp.clip(local, 0, size - 1)[:, None, :], axis=2)
        g = jnp.where(mask[:, None, :], g, 0.0)
        out = g if out is None else out + g
    return out


_GATHER_CHUNK = 1024


def _chunked_row_gather(arr, idx):
    """take_along_axis(arr, idx[:, :, None], axis=1), chunked two ways:
    output rows in ~_GATHER_CHUNK batches and the operand minor axis in
    ~_MINOR_CHUNK column slabs (both faulted unchunked on the backend this
    solver was first built for; see _minor_gather)."""
    Kc = arr.shape[2]
    if Kc > _MINOR_CHUNK:
        return jnp.concatenate(
            [_chunked_row_gather(arr[:, :, b:b + _MINOR_CHUNK], idx)
             for b in range(0, Kc, _MINOR_CHUNK)], axis=2)
    Fp = idx.shape[1]
    if Fp <= _GATHER_CHUNK:
        return jnp.take_along_axis(arr, idx[:, :, None], axis=1)
    parts = []
    for c0 in range(0, Fp, _GATHER_CHUNK):
        part_idx = idx[:, c0:c0 + _GATHER_CHUNK]
        parts.append(jnp.take_along_axis(arr, part_idx[:, :, None], axis=1))
    return jnp.concatenate(parts, axis=1)


def _expand_child_updates_gather(fp: FrontalPlan, U, child_lvl: int):
    """Gather-based expansion (chunked): parent-position -> child-position
    maps drive row/column gathers from the zero-padded child update, for
    backends where gathers run near memory bandwidth and scatters
    serialize."""
    inv = jnp.asarray(fp.inv_child[child_lvl]).astype(jnp.int32)  # [2B, Fp]
    Upad = jnp.pad(U, ((0, 0), (0, 1), (0, 1)))
    e1 = _chunked_row_gather(Upad, inv)                   # [2B, Fp, K+1]
    e1t = jnp.swapaxes(e1, 1, 2)                          # [2B, K+1, Fp]
    e = _chunked_row_gather(e1t, inv)                     # [2B, Fp, Fp]
    e = jnp.swapaxes(e, 1, 2)
    seg = jnp.arange(inv.shape[0]) >> 1
    return jax.ops.segment_sum(e, seg, num_segments=inv.shape[0] // 2,
                               indices_are_sorted=True)


def _expand_child_updates(fp: FrontalPlan, U, child_lvl: int):
    """Scatter each child's update matrix into the parent front index space
    and sum sibling pairs: [2B, K, K] -> [B, F(parent), F(parent)].

    Scatter-based (not gather-based): the forward map child-boundary-pos ->
    parent-front-pos is strictly increasing and unique per slot, which XLA
    lowers efficiently — and the intermediates stay [2B, F, K] instead of
    [2B, F, F]."""
    fwd = jnp.asarray(fp.fwd_child[child_lvl])            # [2B, K]
    B2, K = fwd.shape
    Fp = fp.F[child_lvl - 1]
    bidx = jnp.arange(B2)[:, None]
    # rows: child row k -> parent row fwd[k]   ([2B, Fp+1, K], sentinel row Fp)
    e1 = jnp.zeros((B2, Fp + 1, K), U.dtype).at[bidx, fwd, :].set(
        U, indices_are_sorted=True, unique_indices=True)[:, :Fp, :]
    # cols: same map on the trailing axis (scatter on axis 1 of the transpose)
    e1t = jnp.swapaxes(e1, 1, 2)                           # [2B, K, Fp]
    e = jnp.zeros((B2, Fp + 1, Fp), U.dtype).at[bidx, fwd, :].set(
        e1t, indices_are_sorted=True, unique_indices=True)[:, :Fp, :]
    e = jnp.swapaxes(e, 1, 2)                              # [2B, Fp, Fp]
    seg = jnp.arange(B2) >> 1
    return jax.ops.segment_sum(e, seg, num_segments=B2 // 2,
                               indices_are_sorted=True)


import os as _os

_TRI_MAX_BATCH = int(_os.environ.get("CHOLESKY_TPU_TRI_MAX_BATCH", "512"))


_TRI_RHS_CHUNK = int(_os.environ.get("CHOLESKY_TPU_TRI_RHS_CHUNK", "2048"))


def _tri_solve(Ld, rhs, **kw):
    """lax.linalg.triangular_solve wrapped to bound its memory:

    * batch axis chunked at _TRI_MAX_BATCH — the lowering of the backend
      this solver was first built for allocated scratch proportional to
      batch and failed to compile at [4096, 216, 216] (1M-dof leaf level;
      whether the GPU backend needs this awaits re-bisection);
    * for right-side solves, RHS ROWS chunked in a fori_loop — XLA's solve
      holds HLO temps ~20x the RHS size ([2, 10000, 5000]: 7.9 GiB of
      temps), and rows of a right-side solve are independent, so a
      sequential loop of row windows bounds residency to one window.
    """
    B = Ld.shape[0]
    if B > _TRI_MAX_BATCH:
        # cast INSIDE each chunk: a bf16 out-of-core factor level is
        # multi-GiB, and promoting the whole level to f32 up front would
        # transiently double it (2 GiB at 140^3's leaf level) — the
        # chunk-local cast bounds the transient to one window. No-op for
        # f32 factors (astype to the same dtype).
        return jnp.concatenate(
            [lax.linalg.triangular_solve(
                Ld[i:i + _TRI_MAX_BATCH].astype(rhs.dtype),
                rhs[i:i + _TRI_MAX_BATCH], **kw)
             for i in range(0, B, _TRI_MAX_BATCH)], axis=0)
    if Ld.dtype != rhs.dtype:
        Ld = Ld.astype(rhs.dtype)
    ch = _TRI_RHS_CHUNK
    z = jnp.int32(0)
    left = kw.get("left_side", False)
    # independent axis of the RHS: rows for right-side solves, columns for
    # left-side solves
    ax = 2 if left else 1
    M = rhs.shape[ax]
    if M <= 2 * ch:
        return lax.linalg.triangular_solve(Ld, rhs, **kw)
    nch = -(-M // ch)
    out0 = jnp.zeros_like(rhs)

    def body(i, out):
        # tail-aligned window: the last chunk re-solves a few rows/cols
        # (they are independent and pure, so values are identical)
        f0 = jnp.minimum(i * ch, M - ch).astype(jnp.int32)
        start = (z, z, f0) if left else (z, f0, z)
        size = ((B, rhs.shape[1], ch) if left else (B, ch, rhs.shape[2]))
        rc = lax.dynamic_slice(rhs, start, size)
        xc = lax.linalg.triangular_solve(Ld, rc, **kw)
        return lax.dynamic_update_slice(out, xc, start)

    return lax.fori_loop(jnp.int32(0), jnp.int32(nch), body, out0)


def _tri_solve_lowprec(Ld, rhs, transpose=False):
    """Blocked batched substitution against a SUB-F32 (bf16 out-of-core)
    lower triangle, promoting only [B, ., 128] slices to f32: a
    whole-level promotion of a big bf16 level is GiB-scale (the 140^3
    root alone casts to 1.44 GB f32, and the forward/backward sweeps'
    shared casts kept every level's promotion live across the whole
    solve program — a 20.4 GB buffer assignment at 140^3).
    Ld [B, W, W] sub-f32, rhs [B, W] f32 -> [B, W] f32. Same recurrence
    as the LAPACK-style solve up to f32 rounding order; the refinement
    loop absorbs the difference."""
    B, W, _ = Ld.shape
    bs = _CHOL_BS
    x = rhs
    if not transpose:
        for j0 in range(0, W, bs):
            w = min(bs, W - j0)
            d = Ld[:, j0:j0 + w, j0:j0 + w].astype(rhs.dtype)
            xj = _tri_solve(d, x[:, j0:j0 + w, None], left_side=True,
                            lower=True)[..., 0]
            x = lax.dynamic_update_slice(x, xj, (0, j0))
            if j0 + w < W:
                Lb = Ld[:, j0 + w:, j0:j0 + w].astype(rhs.dtype)
                upd = jnp.einsum("bij,bj->bi", Lb, xj,
                                 preferred_element_type=rhs.dtype)
                x = lax.dynamic_update_slice(
                    x, x[:, j0 + w:] - upd, (0, j0 + w))
    else:
        nb = -(-W // bs)
        for k in range(nb - 1, -1, -1):
            j0 = k * bs
            w = min(bs, W - j0)
            rj = x[:, j0:j0 + w]
            if j0 + w < W:
                Lb = Ld[:, j0 + w:, j0:j0 + w].astype(rhs.dtype)
                rj = rj - jnp.einsum("bij,bi->bj", Lb, x[:, j0 + w:],
                                     preferred_element_type=rhs.dtype)
            d = Ld[:, j0:j0 + w, j0:j0 + w].astype(rhs.dtype)
            xj = _tri_solve(d, rj[..., None], left_side=True, lower=True,
                            transpose_a=True)[..., 0]
            x = lax.dynamic_update_slice(x, xj, (0, j0))
    return x


# panel width of the blocked sub-f32 substitution above and of the blocked
# LDL^T (numeric/ldlt.py)
_CHOL_BS = 128


def _effective_gathermm_cap(total_front_bytes: int) -> int:
    """Scale the gathermm intermediate cap to what the device can actually
    hold. Calibrated for the DONATING call (inputs aliased into outputs,
    ~1.2x front bytes resident plus code): past the donation threshold the
    non-donating program holds 2x front bytes + temps (80^3
    memory_analysis: 4.67 in + 4.67 out + 7.6 temp GiB). Below the cap the
    chunked fused scatter path (tiny intermediates) takes over."""
    free = capacity.threshold("hbm_budget") - int(1.2 * total_front_bytes)
    return max(256 << 20, min(capacity.threshold("gathermm_cap"), free // 2))


def _gathermm_bytes(fp: FrontalPlan, U, child_lvl: int) -> int:
    """Approximate extra HBM the gathermm expansion materializes: the
    folded G [B, Fp, 2K] and one-hot S [B, Fp, 2K] operands plus the
    [B, Fp, Fp] output. Kept at the pre-folding 4x(B2*Fp*K) coefficient:
    the folded form has no transpose copies, but XLA's transient
    double-buffering around the gather/einsum means the calibrated cap
    (which this estimate feeds) still reflects actual peak residency —
    halving it admits gathermm at 1M-dof levels that then OOM."""
    B2, K, _ = U.shape
    Fp = fp.F[child_lvl - 1]
    it = U.dtype.itemsize
    return 4 * (B2 * Fp * K * it) + (B2 // 2) * Fp * Fp * 4


ROOT_DIST_MIN = 2048   # min root-front size for the collective factorization


class _RootSpec(tuple):
    """Hashable (mesh, scheme, block) resolved at dispatch — it rides the
    trace-cache keys, so flipping CHOLESKY_TPU_ROOT_SCHEME/_ROOT_BLOCK
    between calls gets a fresh program instead of a stale cached one."""

    __slots__ = ()

    def __new__(cls, mesh, scheme: str, block: int):
        return super().__new__(cls, (mesh, scheme, block))

    @property
    def mesh(self):
        return self[0]

    @property
    def scheme(self):
        return self[1]

    @property
    def block(self):
        return self[2]


def _effective_root_mesh(fp: "FrontalPlan", root_mesh):
    """Resolve the collective-root decision ONCE at dispatch: the mesh is
    forwarded to the level programs only when the root front is wide enough
    to amortize the per-step collectives (CHOLESKY_TPU_ROOT_DIST_MIN
    overrides the default), wrapped as a _RootSpec carrying the 1-D/2-D
    scheme and block-size routing (dist_cholesky._pick_scheme).
    _factor_level trusts a non-None root_mesh."""
    if root_mesh is None:
        return None
    if isinstance(root_mesh, _RootSpec):     # already resolved
        return root_mesh
    dist_min = int(_os.environ.get("CHOLESKY_TPU_ROOT_DIST_MIN",
                                   ROOT_DIST_MIN))
    block = int(_os.environ.get("CHOLESKY_TPU_ROOT_BLOCK", "256"))
    if fp.W[0] < dist_min:
        # root too small to amortize the per-step collectives: the spec
        # still travels (scheme "off") so NARROW mid-tree levels can
        # distribute (parallel/dist_level) — only the lvl-0 collective is
        # gated off
        return _RootSpec(root_mesh, "off", block)
    from cholesky_tpu.parallel.dist_cholesky import _pick_scheme

    ndev = int(root_mesh.devices.size)
    return _RootSpec(root_mesh, _pick_scheme(fp.W[0], ndev, block), block)


def _update_dtype_for(dtype, u_bytes: int = 0):
    """Storage dtype for a level's accumulated child update of `u_bytes`
    (f32 size). CHOLESKY_TPU_UPDATE_DTYPE=bfloat16/float32 forces it;
    default 'auto' switches to bf16 past the "update_bf16" capacity
    threshold: at deep trees the f32 update, the trailing piece E_T, and
    the Schur result U2 coexist at multi-GiB each (1M dofs, level 5: u 3.1
    + E_T 2.9 + U2 2.9 GiB). bf16 halves all three; iterative refinement
    absorbs the precision loss."""
    import os

    if jnp.dtype(dtype) != jnp.float32:
        return dtype
    mode = os.environ.get("CHOLESKY_TPU_UPDATE_DTYPE", "auto")
    if mode == "bfloat16":
        return jnp.bfloat16
    if mode == "auto" and u_bytes > capacity.threshold("update_bf16"):
        return jnp.bfloat16
    return dtype



def _mesh_for_level(fp: "FrontalPlan", lvl: int, root_mesh):
    """Forward the mesh spec to a level's program when that level USES it:
    the collective root (lvl 0) or an eligible narrow mid-tree level
    (parallel/dist_level.eligible). Keeping it None elsewhere preserves
    the mesh-free programs' trace-cache keys."""
    if root_mesh is None:
        return None
    if lvl == 0:
        return root_mesh if root_mesh.scheme != "off" else None
    from cholesky_tpu.parallel import dist_level

    if dist_level.eligible(fp, lvl, 1 << lvl, root_mesh.mesh):
        return root_mesh
    return None


def _factor_level(fp: FrontalPlan, lvl: int, piv, U, extadd: str,
                  gm_cap: int, update_dtype, root_mesh=None):
    """One level of the multifrontal factorization. Consumes the level's
    pivot slabs `piv` [B, F, W] and the children's accumulated updates `U`
    (None at the entry level; a [2B, K, K] array; or ("xxt", X) — a deferred
    leaf Schur product). Returns (factor [B, F, W], U_next) where U_next
    feeds the parent level (None when lvl == 0). Extracted from the level
    loop so the monolithic program (frontal_factor) and the streamed
    per-level programs (frontal_factor_streamed) share one implementation."""
    Wl, Fl = fp.W[lvl], fp.F[lvl]
    B = piv.shape[0]

    def expand(fp_, U_, child_lvl):
        if extadd == "matmul" or (
                extadd == "hybrid" and U_.shape[0] <= 16):
            return _expand_child_updates_matmul(fp_, U_, child_lvl)
        if extadd == "gather":
            return _expand_child_updates_gather(fp_, U_, child_lvl)
        if extadd == "gathermm":
            return _expand_child_updates_gathermm(fp_, U_, child_lvl)
        return _expand_child_updates(fp_, U_, child_lvl)

    def u_empty():
        return jnp.zeros((B, 0, 0), piv.dtype)

    if U is None:
        # leaf levels: no children, so the square front is never needed —
        # factor the [B, F, W] pivot slab directly (the full [B, F, F]
        # materialization would dominate HBM at deep trees)
        # one batched POTRF per level (dpotrf, blas.rg:63-79): on the GPU a
        # single lax.linalg.cholesky beat a 128-wide blocked variant at
        # every level of 50^3 and 100^3 (tests/test_gpu.py)
        Ld = lax.linalg.cholesky(piv[:, :Wl, :], symmetrize_input=False)
        if Fl > Wl:
            X = _tri_solve(
                Ld, piv[:, Wl:, :], left_side=False, lower=True,
                transpose_a=True)
            fac = jnp.concatenate([Ld, X], axis=1)
            if lvl == 0:
                return fac, None
            # defer the leaf Schur product: the parent expands X directly
            # (_expand_xxt_2) or materializes X X^T there if its strategy
            # needs U
            return fac, ("xxt", X.astype(update_dtype))
        return Ld, (None if lvl == 0 else u_empty())

    if root_mesh is not None and lvl >= 1:
        # NARROW mid-tree levels (1 < B < ndev): factor each front over a
        # subgroup of ndev/B chips instead of replicating — the level's
        # extend-add temps, slab, and Schur output all shard ~1/G
        # (parallel/dist_level.py).
        # The sharded path owns its extend-add, so it replaces this whole
        # body for eligible levels.
        from cholesky_tpu.parallel import dist_level

        if dist_level.eligible(fp, lvl, B, root_mesh.mesh):
            return dist_level.factor_level_sharded(
                fp, lvl, piv, U, root_mesh.mesh, update_dtype)

    if (extadd in ("gathermm", "hybrid3")
            and B * Fl * Fl * 4 > capacity.threshold("two_piece")):
        # two-piece path for levels whose square fronts are large: the
        # factorization reads only the pivot slab [B, F, W] and the
        # trailing block [B, K, K], so the square [B, F, F] front is
        # never built — mid-tree square fronts alone are multi-GiB at
        # 512k+ dofs. At small/mid scale the single square einsum is
        # expected to win (the split pieces re-slice the gathered
        # operands, ~2x extra memory traffic; the crossover awaits
        # measurement on the card), so this only kicks in past the byte
        # threshold.
        slab = piv
        E_T = None
        if isinstance(U, tuple) or U.shape[1] > 0:
            slab, E_T = _apply_extadd_two_piece(fp, slab, U, lvl + 1,
                                                cap=gm_cap,
                                                t_dtype=update_dtype,
                                                defer_T=True)
        if (lvl == 0 and root_mesh is not None and B == 1
                and root_mesh.scheme != "off"):
            # collective root-front factorization over the device mesh
            # (root_mesh is a _RootSpec pre-resolved by _effective_root_mesh:
            # 1-D column-cyclic vs 2-D block-cyclic routed by F and ndev)
            from cholesky_tpu.parallel import dist_cholesky as _dc

            fn = (_dc.distributed_cholesky_2d if root_mesh.scheme == "2d"
                  else _dc.distributed_cholesky)
            return fn(slab[0, :Wl, :Wl], root_mesh.mesh,
                      block=root_mesh.block)[None], None
        Ld = lax.linalg.cholesky(slab[:, :Wl, :], symmetrize_input=False)
        if Fl > Wl:
            X = _tri_solve(
                Ld, slab[:, Wl:, :], left_side=False, lower=True,
                transpose_a=True)
            fac = jnp.concatenate([Ld, X], axis=1)
        else:
            fac = Ld
        if lvl == 0:
            return fac, None
        if Fl > Wl:
            X = fac[:, Wl:, :]
            U2 = _schur_update_cast(X, E_T, update_dtype,
                                    fp=fp, child_lvl=lvl + 1)
            return fac, U2
        return fac, u_empty()

    full = jnp.concatenate(
        [piv, jnp.zeros((B, Fl, Fl - Wl), piv.dtype)], axis=2)
    if isinstance(U, tuple) and U[0] == "xxt":
        # baseline strategies need the materialized child update
        Xc = U[1]
        acc = jnp.promote_types(Xc.dtype, jnp.float32)
        U = jnp.einsum("bik,bjk->bij", Xc, Xc,
                       preferred_element_type=acc).astype(Xc.dtype)
    if U is not None:
        if extadd == "hybrid2" and U.shape[0] >= 16:
            full = full - _expand_child_updates_matmul(
                fp, U, lvl + 1).astype(full.dtype)
        elif (extadd == "hybrid3" and U.shape[0] >= 4
              and _gathermm_bytes(fp, U, lvl + 1) <= gm_cap):
            # gathermm at child batches >= 4 (the per-level strategy
            # order awaits re-measurement on the card with
            # tools/bench_extadd.py)
            full = full - _expand_child_updates_gathermm(
                fp, U, lvl + 1).astype(full.dtype)
        elif (extadd == "hybrid3" and U.shape[0] >= 16
              and _gathermm_bytes(fp, U, lvl + 1) // 2 <= gm_cap):
            # middle tier for very large levels: the matmul expansion's
            # intermediates are ~half of gathermm's
            full = full - _expand_child_updates_matmul(
                fp, U, lvl + 1).astype(full.dtype)
        elif extadd in ("fused", "hybrid2", "hybrid3"):
            full = _apply_child_updates_fused(fp, full, U, lvl + 1)
        else:
            full = full - expand(fp, U, lvl + 1).astype(full.dtype)
    if (lvl == 0 and root_mesh is not None and B == 1
            and root_mesh.scheme != "off"):
        # collective root-front factorization over the device mesh
        # (root_mesh is a _RootSpec pre-resolved by _effective_root_mesh:
        # 1-D column-cyclic vs 2-D block-cyclic routed by F and ndev)
        from cholesky_tpu.parallel import dist_cholesky as _dc

        _fn = (_dc.distributed_cholesky_2d if root_mesh.scheme == "2d"
               else _dc.distributed_cholesky)
        Ld = _fn(full[0, :Wl, :Wl], root_mesh.mesh,
                 block=root_mesh.block)[None]
    else:
        Ld = lax.linalg.cholesky(full[:, :Wl, :Wl], symmetrize_input=False)
    if Fl > Wl:
        X = _tri_solve(
            Ld, full[:, Wl:, :Wl], left_side=False, lower=True,
            transpose_a=True)
        fac = jnp.concatenate([Ld, X], axis=1)
        if lvl == 0:
            return fac, None
        U2 = (jnp.einsum("bik,bjk->bij", X, X,
                         preferred_element_type=X.dtype)
              - full[:, Wl:, Wl:])
        return fac, U2.astype(update_dtype)
    return Ld, (None if lvl == 0 else u_empty())


def frontal_factor(fp: FrontalPlan, fronts: Sequence[jax.Array],
                   extadd: str = "hybrid3",
                   root_mesh=None) -> Tuple[jax.Array, ...]:
    """Factor all fronts level by level; returns per-level [B, F, W] factors
    (pivot Cholesky stacked over the solved boundary strip)."""
    root_mesh = _effective_root_mesh(fp, root_mesh)
    total_front_bytes = sum(
        int(np.prod(f.shape)) * jnp.dtype(f.dtype).itemsize for f in fronts)
    gm_cap = _effective_gathermm_cap(total_front_bytes)
    levels = fp.levels
    out: List[jax.Array] = [None] * levels
    U = None
    for lvl in range(levels - 1, -1, -1):
        out[lvl], U = _factor_level(fp, lvl, fronts[lvl], U, extadd,
                                    gm_cap,
                                    _update_dtype_for(fronts[0].dtype,
                                                      _u_bytes(fp, lvl)),
                                    root_mesh)
    return tuple(out)


def _u_bytes(fp: FrontalPlan, lvl: int) -> int:
    """f32 size of the accumulated child update a level's program EMITS
    ([B, K, K], K = boundary width)."""
    K = fp.F[lvl] - fp.W[lvl]
    return (1 << lvl) * K * K * 4


# ---------------------------------------------------------------------------
# Streamed factorization: one jitted (donating) program PER LEVEL instead of
# one monolithic program. XLA schedules a monolithic program with temp live
# ranges spanning level boundaries — at 1M dofs its HLO-temp peak is 14.3 GiB
# on top of the (aliased) 6.5 GiB of fronts and compilation fails outright on
# a 16 GiB device. Per-level programs bound the peak at
#   fronts + one transition's temps,
# dispatch asynchronously (no host sync between levels), and compile/cache
# independently (shared levels across problems reuse their executables).

_LEVEL_JIT_CACHE = {}


def _level_step_jit(fp: FrontalPlan, lvl: int, utag: str, extadd: str,
                    gm_cap: int, update_dtype, root_mesh, donate: bool,
                    store_dtype=None):
    key = (fp.key(), lvl, utag, extadd, gm_cap,
           jnp.dtype(update_dtype).name, root_mesh, donate,
           jnp.dtype(store_dtype).name if store_dtype else None)
    fn = _LEVEL_JIT_CACHE.get(key)
    if fn is not None:
        return fn

    def finish(fac, U2):
        # compressed factor storage: the numerics above ran in the compute
        # dtype; only the STORED factor is cast (U2/X were derived from the
        # full-precision fac inside _factor_level)
        if store_dtype is not None and fac.dtype != jnp.dtype(store_dtype):
            fac = fac.astype(store_dtype)
        if U2 is None:
            return fac
        return (fac, U2[1]) if isinstance(U2, tuple) else (fac, U2)

    if utag == "none":
        def step(piv):
            return finish(*_factor_level(fp, lvl, piv, None, extadd, gm_cap,
                                         update_dtype, root_mesh))
        fn = jax.jit(step, donate_argnums=(0,) if donate else ())
    else:
        def step(piv, u_arr):
            U = ("xxt", u_arr) if utag == "xxt" else u_arr
            return finish(*_factor_level(fp, lvl, piv, U, extadd, gm_cap,
                                         update_dtype, root_mesh))
        fn = jax.jit(step, donate_argnums=(0, 1) if donate else ())
    _LEVEL_JIT_CACHE[key] = fn
    return fn


_STREAM_SYNC_BYTES = int(_os.environ.get(
    "CHOLESKY_TPU_STREAM_SYNC_BYTES", str(256 << 20)))

# Top-of-tree fusion for the streamed path: once the REMAINING levels'
# combined working set (slabs + square-front temps + carry) fits under this
# budget, they run as ONE jitted program instead of one dispatch per level.
# The narrow top of a deep tree (B = 1, 2, 4) is dispatch-bound — each
# per-level program pays a dispatch for sub-millisecond compute — and
# fusing recovers the reference's data-driven overlap across phase
# boundaries at the top of the tree (Legion overlaps wherever region
# dependences allow, SURVEY §2; the big levels keep per-level programs for
# memory reasons). 0 disables.
_TOP_FUSE_BYTES = int(_os.environ.get("CHOLESKY_TPU_TOP_FUSE_BYTES",
                                      str(256 << 20)))


def _top_fuse_start(fp: "FrontalPlan", front_itemsize: int) -> int:
    """Highest level s (>= 1) such that levels s..0 can run as one fused
    program within _TOP_FUSE_BYTES, or -1 when fusion never applies.
    Budget per level: pivot slab + square-front f32 temp + child carry."""
    if _TOP_FUSE_BYTES <= 0 or fp.levels < 3:
        return -1
    total = 0
    start = -1
    # cap at B <= 8 (lvl <= 3) — fusion targets the dispatch-bound narrow
    # top — and always leave the entry level on the per-level path so the
    # donating/throttled streaming machinery still governs the wide levels
    for lvl in range(min(4, fp.levels - 1)):   # accumulate from root down
        B = 1 << lvl
        slab = B * fp.F[lvl] * fp.W[lvl] * front_itemsize
        square = B * fp.F[lvl] * fp.F[lvl] * 4
        total += slab + square + _u_bytes(fp, lvl)
        if total > _TOP_FUSE_BYTES:
            break
        start = lvl
    # fusing a single level is just the per-level program with extra cache
    # surface; require at least two
    return start if start >= 1 else -1


def _top_fused_jit(fp: "FrontalPlan", start_lvl: int, utag: str, extadd: str,
                   gm_cap: int, front_dtype, root_mesh, donate: bool,
                   store_dtype=None):
    """One compiled program running levels start_lvl..0 back to back.
    Takes (pivs tuple ordered start_lvl..0, u_arr or None); returns the
    factors in the same order."""
    key = (fp.key(), "topfuse", start_lvl, utag, extadd, gm_cap,
           jnp.dtype(front_dtype).name, root_mesh, donate,
           jnp.dtype(store_dtype).name if store_dtype else None)
    fn = _LEVEL_JIT_CACHE.get(key)
    if fn is not None:
        return fn

    def run(pivs, U):
        outs = []
        for i, lvl in enumerate(range(start_lvl, -1, -1)):
            fac, U = _factor_level(
                fp, lvl, pivs[i], U, extadd, gm_cap,
                _update_dtype_for(jnp.dtype(front_dtype), _u_bytes(fp, lvl)),
                _mesh_for_level(fp, lvl, root_mesh))
            if store_dtype is not None and fac.dtype != jnp.dtype(store_dtype):
                fac = fac.astype(store_dtype)
            outs.append(fac)
        return tuple(outs)

    if utag == "none":
        def step(pivs):
            return run(pivs, None)
        fn = jax.jit(step, donate_argnums=(0,) if donate else ())
    else:
        def step(pivs, u_arr):
            U = ("xxt", u_arr) if utag == "xxt" else u_arr
            return run(pivs, U)
        fn = jax.jit(step, donate_argnums=(0, 1) if donate else ())
    _LEVEL_JIT_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# Batch-chunked level programs: past ~2M dofs a SINGLE mid-tree level
# transition no longer fits a 16 GiB device — at 128^3 (levels=14) the
# level-6 program peaks at 18.54 GiB (AOT memory_analysis), with levels
# 3-5 at 14-16 GiB. The batch axis is the natural cut: blocks within a
# level are independent, and sibling pairs (2i, 2i+1) merge into parent i,
# so any even split of a level's blocks [c0, c1) is a closed sub-problem
# consuming exactly child rows [2*c0, 2*c1) of the accumulated update.
# Each chunk runs as its own donating program over a _BatchView (the plan's
# extend-add maps sliced to the chunk's rows), scaling the transition peak
# down ~1/nc. Chunking changes neither the per-block math nor any
# accumulation order; results match the unchunked program to within XLA's
# batch-size-dependent dot tiling (measured <= 6e-9 relative in f32).


class _BatchView:
    """FrontalPlan view over the block slice [c0, c1) of level `lvl`. The
    level-step call graph touches F / W / levels / plan and the child maps
    inv_child[lvl+1] / fwd_child[lvl+1] (sliced here to rows [2c0, 2c1));
    key() separates each chunk's programs in the trace caches."""

    def __init__(self, fp: FrontalPlan, lvl: int, c0: int, c1: int):
        self._key = (fp.key(), "bslice", lvl, c0, c1)
        self.plan = fp.plan
        self.W, self.F = fp.W, fp.F
        self.levels = fp.levels
        self.inv_child = list(fp.inv_child)
        self.fwd_child = list(fp.fwd_child)
        cl = lvl + 1
        if cl < fp.levels and fp.inv_child[cl] is not None:
            self.inv_child[cl] = fp.inv_child[cl][2 * c0:2 * c1]
            self.fwd_child[cl] = fp.fwd_child[cl][2 * c0:2 * c1]

    def key(self):
        return self._key


# analytic floor -> peak fudge: XLA's scheduler overlaps temp live ranges
# on top of the unavoidable arguments + outputs + boundary-solve X; measured
# peak/floor ratios across the 128^3 level programs span 1.2-1.65
# (memory_analysis), so the decision uses the worst observed ratio.
_CHUNK_FUDGE = float(_os.environ.get("CHOLESKY_TPU_CHUNK_FUDGE", "1.65"))


def _level_floor_bytes(fp: "FrontalPlan", lvl: int, utag: str,
                       front_itemsize: int, u_itemsize: int,
                       store_itemsize: int, nc: int) -> int:
    """Lower bound on one level-chunk program's resident bytes: its piv
    slab + update input + factor output + emitted update + f32 boundary
    solve X. XLA adds overlapped temps on top (_CHUNK_FUDGE)."""
    B = (1 << lvl) // nc
    W, F = fp.W[lvl], fp.F[lvl]
    K = F - W
    total = B * F * W * front_itemsize            # piv slab in
    total += B * F * W * store_itemsize           # stored factor out
    if utag != "none" and lvl + 1 < fp.levels:
        Kc = fp.F[lvl + 1] - fp.W[lvl + 1]
        Wc = fp.W[lvl + 1]
        cols = Wc if utag == "xxt" else Kc
        total += 2 * B * Kc * cols * u_itemsize   # child update in
    if lvl > 0 and K > 0:
        total += B * K * K * u_itemsize           # emitted update out
        total += B * K * W * 4                    # boundary solve X (f32)
    return total


def _level_chunk_counts(fp: "FrontalPlan", front_dtype, store_dtype,
                        budget: Optional[int] = None) -> dict:
    """Chunk count per level (1 = unchunked). CHOLESKY_TPU_LEVEL_CHUNKS
    ("lvl:nc,lvl:nc") overrides; otherwise the analytic floor times
    _CHUNK_FUDGE against the HBM budget decides. Levels 0 (root) and the
    fused narrow top are never chunked."""
    manual = _os.environ.get("CHOLESKY_TPU_LEVEL_CHUNKS")
    out = {}
    if manual:
        for part in manual.split(","):
            l, nc = part.split(":")
            out[int(l)] = int(nc)
        return out
    if budget is None:
        budget = capacity.threshold("hbm_budget")
    fi = jnp.dtype(front_dtype).itemsize
    si = jnp.dtype(store_dtype).itemsize if store_dtype else fi
    utag = "none"
    for lvl in range(fp.levels - 1, 0, -1):
        # update dtype mirrors the driver's per-level auto choice
        ui = jnp.dtype(_update_dtype_for(front_dtype,
                                         _u_bytes(fp, lvl))).itemsize
        nc = 1
        while (nc < (1 << lvl)
               and _level_floor_bytes(fp, lvl, utag, fi, ui, si, nc)
               * _CHUNK_FUDGE > budget):
            nc *= 2
        if nc > 1:
            out[lvl] = nc
        utag = "xxt" if utag == "none" and fp.F[lvl] > fp.W[lvl] else "arr"
    return out


def _take_child_rows(pieces: List, counts: List[int], r0: int, r1: int):
    """Row slice [r0, r1) of the logical concatenation of `pieces` (child
    update arrays stacked along axis 0, sizes `counts`). Returns a whole
    piece without copying when the span matches one exactly; otherwise
    slices/concatenates on device."""
    if len(pieces) == 1 and r0 == 0 and r1 == counts[0]:
        return pieces[0]
    parts = []
    off = 0
    for arr, cnt in zip(pieces, counts):
        lo, hi = max(r0 - off, 0), min(r1 - off, cnt)
        if lo < hi:
            parts.append(arr if (lo == 0 and hi == cnt) else arr[lo:hi])
        off += cnt
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)


def frontal_factor_streamed(fp: FrontalPlan, fronts: Sequence[jax.Array],
                            extadd: str = "hybrid3", root_mesh=None,
                            donate: bool = True, store_dtype=None,
                            upload: bool = False,
                            offload: bool = False,
                            chunks: Optional[dict] = None
                            ) -> Tuple[jax.Array, ...]:
    """Level-streamed factorization (see note above): same math and result
    as frontal_factor, executed as `levels` donating programs. `fronts` are
    CONSUMED when donate=True (like the donating monolithic jit).

    Dispatch is throttled: PJRT allocates a program's outputs and temps at
    ENQUEUE, so letting all level programs queue up re-creates the
    monolithic peak. After any level whose working set exceeds
    _STREAM_SYNC_BYTES, wait for it to finish before enqueueing the next —
    at most one multi-GiB transition is ever in flight. (Small levels keep
    async dispatch; the sync is a scalar slice readback.)

    store_dtype: cast each level's STORED factor (e.g. bfloat16) — halves
    factor residency so problems whose f32 fronts exceed HBM still keep a
    device-resident factor for the solve; the level numerics stay f32.
    upload=True: `fronts` are HOST arrays, shipped level by level right
    before use (the full front set never resides in HBM — required past
    ~10 GiB of fronts).

    `fronts` may also be a LazyFronts: each level's slab is then assembled
    on device right before its program runs (values-only upload, current
    level's slab as the only front residency — the in-core analogue of
    upload=True).

    offload=True: each completed level's STORED factor is moved to host
    right away, so factor residency never accumulates in HBM — during the
    factorization the device holds only the current level's slab plus the
    extend-add carry. Required past ~12 GiB of fronts, where even a bf16
    factor store plus the near-root f32 working slabs exceed HBM. The
    returned tuple then contains host (NumPy) arrays for the offloaded
    levels (level 0 stays on device); callers may device_put them back if
    the total fits.

    chunks: {lvl: nc} batch-chunk overrides (see _level_chunk_counts);
    None = decide from the analytic floor vs the device-memory budget.
    Levels whose single program cannot fit run as nc donating chunk
    programs over block slices — on a 16 GiB device, past ~2M dofs."""
    root_mesh = _effective_root_mesh(fp, root_mesh)
    lazy = isinstance(fronts, LazyFronts)
    if upload and not isinstance(fronts, list):
        fronts = list(fronts)
    front_dtype = fronts.dtype if lazy else fronts[0].dtype
    if lazy:
        total_front_bytes = sum(fronts.nbytes_of(l) for l in range(len(fronts)))
    else:
        total_front_bytes = sum(
            int(np.prod(f.shape)) * jnp.dtype(f.dtype).itemsize
            for f in fronts)
    gm_cap = _effective_gathermm_cap(total_front_bytes)
    if chunks is None:
        chunks = _level_chunk_counts(fp, front_dtype, store_dtype)
    levels = fp.levels
    out: List[jax.Array] = [None] * levels
    u_arr = None
    u_pieces: Optional[List] = None     # child update as batch pieces
    u_counts: Optional[List[int]] = None
    utag = "none"
    debug = _os.environ.get("CHOLESKY_TPU_STREAM_DEBUG") == "1"
    fuse_start = _top_fuse_start(fp, jnp.dtype(front_dtype).itemsize)
    for lvl in range(levels - 1, -1, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        nc = chunks.get(lvl, 1) if lvl > 0 and lvl != fuse_start else 1
        if nc > 1:
            cb = (1 << lvl) // nc
            if debug:
                print(f"# stream lvl{lvl}: {nc} chunks x {cb} blocks",
                      flush=True)
            update_dtype = _update_dtype_for(jnp.dtype(front_dtype),
                                             _u_bytes(fp, lvl))
            fac_pieces, new_pieces = [], []
            for c in range(nc):
                view = _BatchView(fp, lvl, c * cb, (c + 1) * cb)
                fn = _level_step_jit(view, lvl, utag, extadd, gm_cap,
                                     update_dtype, None, donate,
                                     store_dtype=store_dtype)
                if lazy:
                    piv_c = fronts.chunk(lvl, c * cb, (c + 1) * cb)
                else:
                    # upload (host fronts) and eager (device fronts) share
                    # this: slicing a host array ships only the chunk H2D;
                    # slicing a device array copies the chunk on device so
                    # the chunk program can donate it
                    piv_c = jnp.asarray(fronts[lvl][c * cb:(c + 1) * cb])
                if utag == "none":
                    res = fn(piv_c)
                else:
                    u_c = _take_child_rows(u_pieces, u_counts,
                                           2 * c * cb, 2 * (c + 1) * cb)
                    # drop fully-consumed pieces: with aligned chunking the
                    # piece IS the chunk's input and donation frees it; a
                    # sliced parent piece is freed once its last chunk ran
                    off = 0
                    for i, cnt in enumerate(u_counts):
                        if off + cnt <= 2 * (c + 1) * cb:
                            u_pieces[i] = None
                        off += cnt
                    res = fn(piv_c, u_c)
                    del u_c
                del piv_c
                fac_c, nxt = res
                # Past ~2.74M dofs the ACCUMULATED child-update pieces are
                # the memory killer the per-chunk floor cannot see: the level
                # boundary holds u_in (being consumed) + u_out (being
                # emitted) at 6-7 GB EACH in bf16 at 140^3, on top of the
                # running chunk's working set (OOMed the first 140^3
                # attempt). In offload mode big emitted pieces spill to
                # host like the factors do; the consumer's chunk slicing
                # re-uploads only its rows (the "u_offload" capacity
                # threshold gates each level's emitted update).
                if (offload and nxt is not None
                        and not isinstance(nxt, tuple)
                        and nc * int(np.prod(nxt.shape))
                        * jnp.dtype(nxt.dtype).itemsize
                        > capacity.threshold("u_offload")):
                    new_pieces.append(jax.device_get(nxt))
                else:
                    new_pieces.append(nxt)
                del nxt
                if offload:
                    fac_pieces.append(jax.device_get(fac_c))
                else:
                    np.asarray(fac_c[:1, :1, 0])   # completion sync
                    fac_pieces.append(fac_c)
                del fac_c, res
            if upload:
                fronts[lvl] = None
            out[lvl] = (np.concatenate(fac_pieces, axis=0) if offload
                        else jnp.concatenate(fac_pieces, axis=0))
            del fac_pieces
            utag = ("xxt" if utag == "none" and Fl > Wl else "arr")
            u_pieces, u_counts = new_pieces, [cb] * nc
            if debug:
                o = out[lvl]
                print(f"# stream lvl{lvl} done (chunked x{nc}): "
                      f"out={o.shape}{o.dtype}", flush=True)
            continue
        if utag != "none":
            # reconcile chunk pieces into the single update operand the
            # unchunked program consumes (no copy when already one piece)
            u_arr = _take_child_rows(u_pieces, u_counts, 0, sum(u_counts))
            u_pieces = [u_arr]
            u_counts = [sum(u_counts)]
        if lvl == fuse_start:
            # the remaining (narrow) levels run as one fused program
            ffn = _top_fused_jit(fp, lvl, utag, extadd, gm_cap, front_dtype,
                                 root_mesh, donate, store_dtype=store_dtype)
            pivs = []
            for l in range(lvl, -1, -1):
                pivs.append(jnp.asarray(fronts[l]) if upload or lazy
                            else fronts[l])
                if upload:
                    fronts[l] = None
            pivs = tuple(pivs)
            facs = ffn(pivs) if utag == "none" else ffn(pivs, u_arr)
            for i, l in enumerate(range(lvl, -1, -1)):
                out[l] = (jax.device_get(facs[i]) if offload and l > 0
                          else facs[i])
            return tuple(out)
        fn = _level_step_jit(fp, lvl, utag, extadd, gm_cap,
                             _update_dtype_for(jnp.dtype(front_dtype),
                                               _u_bytes(fp, lvl)),
                             _mesh_for_level(fp, lvl, root_mesh), donate,
                             store_dtype=store_dtype)
        work = (fronts.nbytes_of(lvl) if lazy else
                int(np.prod(fronts[lvl].shape)) * fronts[lvl].dtype.itemsize)
        if u_arr is not None:
            work += int(np.prod(u_arr.shape)) * u_arr.dtype.itemsize
        piv_dev = jnp.asarray(fronts[lvl]) if upload else fronts[lvl]
        if upload:
            # drop this list's reference; the host array is freed once the
            # caller holds no other reference (factor()/api pass their own
            # list through, so the front set shrinks as levels complete)
            fronts[lvl] = None
        res = fn(piv_dev) if utag == "none" else fn(piv_dev, u_arr)
        del piv_dev
        if lvl == 0:
            out[0] = res
            break
        fac, nxt = res
        if utag == "none" and Fl > Wl:
            # leaf step emitted the deferred Schur operand X (already cast)
            u_arr, utag = nxt, "xxt"
        else:
            u_arr, utag = nxt, "arr"
        u_pieces, u_counts = [u_arr], [1 << lvl]
        if offload:
            # move the stored factor to host immediately (blocks until the
            # level program finishes — this is also the dispatch throttle)
            out[lvl] = jax.device_get(fac)
            del fac, res
        else:
            out[lvl] = fac
            if work > _STREAM_SYNC_BYTES:
                np.asarray(fac[:1, :1, 0])    # forced completion sync
        if _os.environ.get("CHOLESKY_TPU_STREAM_DEBUG") == "1":
            o = out[lvl]
            if not offload:
                np.asarray(fac[:1, :1, 0])
            stats = {}
            try:
                stats = jax.devices()[0].memory_stats() or {}
            except Exception:  # noqa: BLE001
                pass
            used = stats.get("bytes_in_use", -1)
            peak = stats.get("peak_bytes_in_use", -1)
            print(f"# stream lvl{lvl} done: out={o.shape}{o.dtype} "
                  f"u={getattr(u_arr, 'shape', None)}"
                  f"{getattr(u_arr, 'dtype', '')} "
                  f"hbm_in_use={used/2**30:.2f} GiB "
                  f"peak={peak/2**30:.2f} GiB", flush=True)
    return tuple(out)


_BANDED_CACHE = {}


def _banded_maps(fp: FrontalPlan):
    """Level-major padded relabeling of the permuted dofs for the solve
    chain. Each (level, slot) front gets a CONTIGUOUS block of W[lvl] slots
    (real pivot dofs first, then dead pad slots), bands ordered leaves →
    root, so a level's pivot values are a static slice of the padded work
    vector instead of a [B, W] gather + scatter pair. The level chain is
    latency-bound on indexed ops (gather/scatter cost per element where
    slices are nearly free — tools/prof_scatter.py), and pivot indexing
    is 2 of the 3 indexed ops per level step; this removes both. Returns
    (n_pad, offs, inv_map [n_pad] padded→permuted with sentinel n,
    pad_of [n+1] permuted→padded, bnd_pad per-level [B, F−W] int32
    boundary ids in the padded basis, sentinel n_pad)."""
    key = fp.key()
    hit = _BANDED_CACHE.get(key)
    if hit is not None:
        return hit
    n = fp.plan.n
    levels = fp.levels
    offs = [0] * levels
    off = 0
    for lvl in range(levels - 1, -1, -1):
        offs[lvl] = off
        off += fp.front_rows[lvl].shape[0] * fp.W[lvl]
    n_pad = off
    pad_of = np.full(n + 1, n_pad, dtype=np.int64)
    inv_map = np.full(n_pad, n, dtype=np.int64)
    for lvl in range(levels):
        frp = fp.front_rows[lvl][:, :fp.W[lvl]]
        pos = offs[lvl] + np.arange(frp.size).reshape(frp.shape)
        real = frp < n
        pad_of[frp[real]] = pos[real]
        inv_map[pos[real]] = frp[real]
    # cache HOST arrays only: jnp.asarray inside a trace yields tracers,
    # and caching those across calls leaks them (UnexpectedTracerError)
    bnd_pad = [pad_of[fp.front_rows[lvl][:, fp.W[lvl]:]].astype(np.int32)
               for lvl in range(levels)]
    maps = (n_pad, offs, inv_map, np.ascontiguousarray(pad_of[:n]), bnd_pad)
    _BANDED_CACHE[key] = maps
    return maps


def _solve_banded_core(fp: FrontalPlan, factors, inv_pivots, g):
    """frontal_solve's inner loops in the level-major padded basis (see
    _banded_maps): per level the forward step is slice + 2 einsums +
    boundary scatter-add and the backward step is boundary gather +
    2 einsums + static update — only ONE indexed op each where the
    permuted-basis loop pays three (tools/prof_scatter.py measures the
    per-op cost of indexed ops against slices). `g` is the PADDED rhs [n_pad + 1] with the
    sentinel slot 0; returns x padded [n_pad + 1], sentinel 0.
    Bitwise-identical arithmetic to the permuted-basis inv_pivots loop
    (same einsums, same operands), so refinement convergence is
    unchanged."""
    levels = fp.levels
    n_pad, offs, _, _, bnd_pad_h = _banded_maps(fp)
    bnd_pad = [jnp.asarray(bp) for bp in bnd_pad_h]
    # forward scatter-add garbage landing in the sentinel slot is never
    # read: band slices stop at n_pad, and the backward pass gathers the
    # sentinel only for pad boundary rows whose X rows are zero
    ys = [None] * levels
    for lvl in range(levels - 1, -1, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        B = fp.front_rows[lvl].shape[0]
        band = lax.slice(g, (offs[lvl],),
                         (offs[lvl] + B * Wl,)).reshape(B, Wl)
        y = jnp.einsum("bij,bj->bi", inv_pivots[lvl], band,
                       preferred_element_type=band.dtype)
        ys[lvl] = y
        if Fl > Wl:
            X = factors[lvl][:, Wl:, :].astype(y.dtype)
            contrib = jnp.einsum("bij,bj->bi", X, y,
                                 preferred_element_type=y.dtype)
            g = g.at[bnd_pad[lvl]].add(-contrib, mode="drop")
    xg = jnp.zeros(g.shape[0], g.dtype)
    for lvl in range(levels):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        rhs = ys[lvl]
        if Fl > Wl:
            X = factors[lvl][:, Wl:, :].astype(rhs.dtype)
            z = xg[bnd_pad[lvl]]                    # ancestor solutions
            rhs = rhs - jnp.einsum("bij,bi->bj", X, z,
                                   preferred_element_type=z.dtype)
        x = jnp.einsum("bji,bj->bi", inv_pivots[lvl], rhs,
                       preferred_element_type=rhs.dtype)
        xg = lax.dynamic_update_slice(xg, x.reshape(-1), (offs[lvl],))
    return xg


def _solve_banded(fp: FrontalPlan, factors, inv_pivots, b_perm):
    """Permuted-basis wrapper around _solve_banded_core: one [n_pad] entry
    gather + one [n] exit gather (the device-resident refinement loop
    avoids both by running entirely in the padded basis, refine._run)."""
    n_pad, _, inv_map_h, pad_of_h, _ = _banded_maps(fp)
    b_ext = jnp.concatenate([b_perm, jnp.zeros((1,), b_perm.dtype)])
    g = jnp.concatenate([b_ext[jnp.asarray(inv_map_h)],
                         jnp.zeros((1,), b_perm.dtype)])       # [n_pad + 1]
    xg = _solve_banded_core(fp, factors, inv_pivots, g)
    return xg[jnp.asarray(pad_of_h)]


def frontal_solve(fp: FrontalPlan, factors: Sequence[jax.Array],
                  b_perm: jax.Array,
                  inv_pivots: Optional[Sequence[jax.Array]] = None
                  ) -> jax.Array:
    """Forward + backward substitution against the frontal factors. `b_perm`
    is the RHS in PERMUTED order, [n]; returns x in permuted order.

    inv_pivots: optional per-level explicit pivot inverses (invert_pivots).
    Vector-RHS triangular_solve is latency-bound (a sequential recurrence
    per block); applying a precomputed inverse is one batched matvec, and
    the level chain then runs in the banded
    padded basis (_solve_banded) to cut the indexed ops per step 3 → 1.
    Used by the iterative-refinement loop, where the O(kappa*eps)
    inverse-application error washes out.

    (A fused per-level operator M = [L_d^{-1}; X·L_d^{-1}] — one einsum per
    level step instead of two — was implemented and deleted: the f32
    product X·L_d^{-1} costs refinement 7 sweeps instead of 3.)"""
    plan = fp.plan
    n = plan.n
    levels = fp.levels
    bg = jnp.concatenate([b_perm, jnp.zeros((1,), b_perm.dtype)])

    if inv_pivots is not None:
        return _solve_banded(fp, factors, inv_pivots, b_perm)

    piv_idx = [jnp.asarray(fp.front_rows[l][:, :fp.W[l]]) for l in range(levels)]
    bnd_idx = [jnp.asarray(fp.front_rows[l][:, fp.W[l]:]) for l in range(levels)]

    def lower_solve(lvl, pan, rhs):
        if inv_pivots is not None:
            return jnp.einsum("bij,bj->bi", inv_pivots[lvl], rhs,
                              preferred_element_type=rhs.dtype)
        Ld = pan[:, :fp.W[lvl], :]
        if jnp.dtype(Ld.dtype).itemsize < 4:
            # sub-f32 panels: blocked substitution with slice-local
            # promotion (a level-sized f32 cast is GiB-scale out of core)
            return _tri_solve_lowprec(Ld, rhs)
        # the f32 cast of a bf16 panel happens chunk-wise inside _tri_solve
        return _tri_solve(
            Ld, rhs[..., None], left_side=True, lower=True)[..., 0]

    def upper_solve(lvl, pan, rhs):
        if inv_pivots is not None:
            return jnp.einsum("bji,bj->bi", inv_pivots[lvl], rhs,
                              preferred_element_type=rhs.dtype)
        Ld = pan[:, :fp.W[lvl], :]
        if jnp.dtype(Ld.dtype).itemsize < 4:
            return _tri_solve_lowprec(Ld, rhs, transpose=True)
        return _tri_solve(
            Ld, rhs[..., None], left_side=True, lower=True,
            transpose_a=True)[..., 0]

    def x_apply(X, vec, forward):
        """Boundary-block einsum with the f32 promotion chunked over the
        batch axis (same rationale as _tri_solve's chunk-local cast: a
        whole-level bf16->f32 promotion is a 2 GiB transient at 140^3's
        leaf level). Identical arithmetic to the unchunked einsum."""
        spec = "bij,bj->bi" if forward else "bij,bi->bj"
        B = X.shape[0]
        if X.dtype == vec.dtype or B <= _TRI_MAX_BATCH:
            return jnp.einsum(spec, X.astype(vec.dtype), vec,
                              preferred_element_type=vec.dtype)
        return jnp.concatenate(
            [jnp.einsum(spec, X[i:i + _TRI_MAX_BATCH].astype(vec.dtype),
                        vec[i:i + _TRI_MAX_BATCH],
                        preferred_element_type=vec.dtype)
             for i in range(0, B, _TRI_MAX_BATCH)], axis=0)

    for lvl in range(levels - 1, -1, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        bp = bg[piv_idx[lvl]]                              # [B, W]
        y = lower_solve(lvl, factors[lvl], bp)
        bg = bg.at[piv_idx[lvl]].set(y, mode="drop",
                                     indices_are_sorted=False)
        if Fl > Wl:
            contrib = x_apply(factors[lvl][:, Wl:, :], y, True)
            bg = bg.at[bnd_idx[lvl]].add(-contrib)

    for lvl in range(levels):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        pan = factors[lvl]
        if jnp.dtype(pan.dtype).itemsize < 4:
            # The backward sweep reads the SAME panel slices the forward
            # sweep cast to f32; XLA CSE would share those converts and
            # keep every level's promotion live from its forward use to
            # its backward use — the whole factor in f32 (~2x stored
            # bytes) mid-program (measured 20.4 GB assignment at 140^3).
            # An optimization barrier makes the backward casts distinct
            # ops, so each sweep's promotions die within the sweep.
            pan = lax.optimization_barrier(pan)
        rhs = bg[piv_idx[lvl]]
        if Fl > Wl:
            z = bg[bnd_idx[lvl]]                           # ancestor solutions
            rhs = rhs - x_apply(pan[:, Wl:, :], z, False)
        x = upper_solve(lvl, pan, rhs)
        bg = bg.at[piv_idx[lvl]].set(x)

    return bg[:n]


def frontal_forward_partial(fp: FrontalPlan, factors: Sequence[jax.Array],
                            b_perm: jax.Array) -> jax.Array:
    """Forward substitution over levels levels-1 .. 1 ONLY (the interior of
    the tree, everything below the root separator). Returns the working
    vector bg [n+1] (sentinel slot last): at the root separator's pivot rows
    it holds the CONDENSED right-hand side

        b_hat = b_r − A_ro · A_oo⁻¹ · b_o

    of static condensation (the Schur-complement system S·x_r = b_hat), and
    at interior pivot rows the intermediate y = L_oo⁻¹ b_o needed by
    frontal_backward_partial. Same recurrence as frontal_solve's forward
    loop, stopped before the root."""
    levels = fp.levels
    bg = jnp.concatenate([b_perm, jnp.zeros((1,), b_perm.dtype)])
    for lvl in range(levels - 1, 0, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        piv_idx = jnp.asarray(fp.front_rows[lvl][:, :Wl])
        bp = bg[piv_idx]
        Ld = factors[lvl][:, :Wl, :].astype(bp.dtype)
        y = _tri_solve(Ld, bp[..., None], left_side=True, lower=True)[..., 0]
        bg = bg.at[piv_idx].set(y, mode="drop", indices_are_sorted=False)
        if Fl > Wl:
            X = factors[lvl][:, Wl:, :].astype(y.dtype)
            contrib = jnp.einsum("bij,bj->bi", X, y,
                                 preferred_element_type=y.dtype)
            bg = bg.at[jnp.asarray(fp.front_rows[lvl][:, Wl:])].add(-contrib)
    return bg


def frontal_backward_partial(fp: FrontalPlan, factors: Sequence[jax.Array],
                             bg: jax.Array, x_root: jax.Array) -> jax.Array:
    """Backward substitution over levels 1 .. levels-1 given the interface
    solution `x_root` ([W0], padded with zeros past the root separator size)
    and the working vector from frontal_forward_partial: recovers the
    interior, x_o = A_oo⁻¹ (b_o − A_or · x_r). Returns x in PERMUTED order
    [n] (root rows = x_root)."""
    n = fp.plan.n
    levels = fp.levels
    bg = bg.at[jnp.asarray(fp.front_rows[0][:, :fp.W[0]])].set(
        x_root[None, :].astype(bg.dtype), mode="drop")
    for lvl in range(1, levels):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        piv_idx = jnp.asarray(fp.front_rows[lvl][:, :Wl])
        rhs = bg[piv_idx]
        if Fl > Wl:
            X = factors[lvl][:, Wl:, :].astype(rhs.dtype)
            z = bg[jnp.asarray(fp.front_rows[lvl][:, Wl:])]
            rhs = rhs - jnp.einsum("bij,bi->bj", X, z,
                                   preferred_element_type=z.dtype)
        Ld = factors[lvl][:, :Wl, :].astype(rhs.dtype)
        x = _tri_solve(Ld, rhs[..., None], left_side=True, lower=True,
                       transpose_a=True)[..., 0]
        bg = bg.at[piv_idx].set(x)
    return bg[:n]


def frontal_upper_solve(fp: FrontalPlan, factors: Sequence[jax.Array],
                        z_perm: jax.Array) -> jax.Array:
    """x = L⁻ᵀ z (PERMUTED coordinates): the backward-substitution loop of
    frontal_solve on a raw right-hand side. Since A_perm = L·Lᵀ, x has
    covariance A_perm⁻¹ when z ~ N(0, I) — the sparse-Cholesky sampler for
    GMRF/GP posteriors (pairs with inv_diag/inv_entries for moments)."""
    n = fp.plan.n
    bg = jnp.concatenate([z_perm, jnp.zeros((1,), z_perm.dtype)])
    for lvl in range(fp.levels):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        piv_idx = jnp.asarray(fp.front_rows[lvl][:, :Wl])
        rhs = bg[piv_idx]
        if Fl > Wl:
            X = factors[lvl][:, Wl:, :].astype(rhs.dtype)
            z = bg[jnp.asarray(fp.front_rows[lvl][:, Wl:])]
            rhs = rhs - jnp.einsum("bij,bi->bj", X, z,
                                   preferred_element_type=z.dtype)
        Ld = factors[lvl][:, :Wl, :].astype(rhs.dtype)
        x = _tri_solve(Ld, rhs[..., None], left_side=True, lower=True,
                       transpose_a=True)[..., 0]
        bg = bg.at[piv_idx].set(x)
    return bg[:n]


def frontal_lower_solve(fp: FrontalPlan, factors: Sequence[jax.Array],
                        b_perm: jax.Array) -> jax.Array:
    """y = L⁻¹ b (PERMUTED coordinates): the forward-substitution loop of
    frontal_solve alone — the whitening transform (L⁻¹x ~ N(0, I) for
    x ~ N(0, A_perm))."""
    n = fp.plan.n
    bg = jnp.concatenate([b_perm, jnp.zeros((1,), b_perm.dtype)])
    for lvl in range(fp.levels - 1, -1, -1):
        Wl, Fl = fp.W[lvl], fp.F[lvl]
        piv_idx = jnp.asarray(fp.front_rows[lvl][:, :Wl])
        bp = bg[piv_idx]
        Ld = factors[lvl][:, :Wl, :].astype(bp.dtype)
        y = _tri_solve(Ld, bp[..., None], left_side=True, lower=True)[..., 0]
        bg = bg.at[piv_idx].set(y, mode="drop", indices_are_sorted=False)
        if Fl > Wl:
            X = factors[lvl][:, Wl:, :].astype(y.dtype)
            contrib = jnp.einsum("bij,bj->bi", X, y,
                                 preferred_element_type=y.dtype)
            bg = bg.at[jnp.asarray(fp.front_rows[lvl][:, Wl:])].add(-contrib)
    return bg[:n]


def frontal_upper_matvec(fp: FrontalPlan, factors: Sequence[jax.Array],
                         x_perm: jax.Array) -> jax.Array:
    """z = Lᵀ x (PERMUTED coordinates) — the whitening transform: for
    x ~ N(0, A_perm⁻¹), Lᵀx ~ N(0, I). Unlike the solves this has no
    recursion at all: each separator's output rows are one batched
    contraction of its factor column block against the front's x values,
    z_piv(s) = L_pivᵀ x_piv(s) + Xᵀ x_bnd(s)."""
    n = fp.plan.n
    bg = jnp.concatenate([x_perm, jnp.zeros((1,), x_perm.dtype)])
    out = jnp.zeros_like(bg)
    for lvl in range(fp.levels):
        Wl = fp.W[lvl]
        piv_idx = jnp.asarray(fp.front_rows[lvl][:, :Wl])
        fac = factors[lvl].astype(bg.dtype)
        # stored pivot blocks are lower triangular by construction; tril
        # defensively
        fac = jnp.concatenate(
            [jnp.tril(fac[:, :Wl, :]), fac[:, Wl:, :]], axis=1)
        xf = bg[jnp.asarray(fp.front_rows[lvl])]            # [B, F]
        z = jnp.einsum("bkj,bk->bj", fac, xf,
                       preferred_element_type=xf.dtype)
        out = out.at[piv_idx].set(z, mode="drop")
    return out[:n]


@functools.partial(jax.jit, static_argnums=0)
def _upper_matvec_jit(key, factors, x_perm):
    fp = _FPLAN_CACHE[key]
    if x_perm.ndim == 2:
        return jax.vmap(lambda xc: frontal_upper_matvec(fp, factors, xc),
                        in_axes=1, out_axes=1)(x_perm)
    return frontal_upper_matvec(fp, factors, x_perm)


def upper_matvec(fp: FrontalPlan, factors, x_perm) -> jax.Array:
    return _upper_matvec_jit(fp.key(), tuple(factors), jnp.asarray(x_perm))


@functools.partial(jax.jit, static_argnums=0)
def _upper_solve_jit(key, factors, z_perm):
    fp = _FPLAN_CACHE[key]
    if z_perm.ndim == 2:
        return jax.vmap(lambda zc: frontal_upper_solve(fp, factors, zc),
                        in_axes=1, out_axes=1)(z_perm)
    return frontal_upper_solve(fp, factors, z_perm)


@functools.partial(jax.jit, static_argnums=0)
def _lower_solve_jit(key, factors, b_perm):
    fp = _FPLAN_CACHE[key]
    if b_perm.ndim == 2:
        return jax.vmap(lambda bc: frontal_lower_solve(fp, factors, bc),
                        in_axes=1, out_axes=1)(b_perm)
    return frontal_lower_solve(fp, factors, b_perm)


def upper_solve(fp: FrontalPlan, factors, z_perm) -> jax.Array:
    return _upper_solve_jit(fp.key(), tuple(factors), jnp.asarray(z_perm))


def lower_solve(fp: FrontalPlan, factors, b_perm) -> jax.Array:
    return _lower_solve_jit(fp.key(), tuple(factors), jnp.asarray(b_perm))


@functools.partial(jax.jit, static_argnums=0)
def _forward_partial_jit(key, factors, b_perm):
    return frontal_forward_partial(_FPLAN_CACHE[key], factors, b_perm)


@functools.partial(jax.jit, static_argnums=0)
def _backward_partial_jit(key, factors, bg, x_root):
    return frontal_backward_partial(_FPLAN_CACHE[key], factors, bg, x_root)


def forward_partial(fp: FrontalPlan, factors, b_perm) -> jax.Array:
    return _forward_partial_jit(fp.key(), tuple(factors), jnp.asarray(b_perm))


def backward_partial(fp: FrontalPlan, factors, bg, x_root) -> jax.Array:
    return _backward_partial_jit(fp.key(), tuple(factors), bg,
                                 jnp.asarray(x_root))


@functools.partial(jax.jit, static_argnums=1)
def _invert_pivot_level_jit(fac, W):
    Ld = fac[:, :W, :].astype(jnp.float32)   # invert in f32 even for a
    eye = jnp.broadcast_to(jnp.eye(W, dtype=Ld.dtype), Ld.shape)   # bf16-
    return _tri_solve(Ld, eye, left_side=True, lower=True)   # stored factor


def invert_pivots(fp: FrontalPlan, factors) -> Tuple[jax.Array, ...]:
    """Per-level explicit inverses of the pivot Cholesky factors — a
    one-time batched matrix-RHS triangular solve, amortized over the many
    vector solves of the refinement loop. One jitted program per level: a
    monolithic all-levels program is a multi-GiB compile at 1M dofs."""
    return tuple(_invert_pivot_level_jit(factors[lvl], fp.W[lvl])
                 for lvl in range(fp.levels))


def solve_refined(fp: FrontalPlan, factors: Sequence[jax.Array],
                  b_perm: jax.Array, a_rows: jax.Array, a_cols: jax.Array,
                  a_vals: jax.Array, tol: float = 1e-12,
                  max_iter: int = 40):
    """Device-resident mixed-precision iterative refinement: the whole loop
    (low-precision triangular solves + f64 sparse residuals via segment-sum
    matvec) runs in one XLA while_loop — no host round trips per iteration.
    `a_rows/a_cols/a_vals` is the SYMMETRIZED matrix in PERMUTED coordinates.
    Returns (x_perm[f64], final relative residual)."""
    n = fp.plan.n
    b64 = b_perm.astype(jnp.float64)
    bnorm = jnp.linalg.norm(b64)
    ftype = factors[0].dtype

    def matvec(x):
        return jax.ops.segment_sum(a_vals * x[a_cols], a_rows,
                                   num_segments=n)

    def cond(state):
        i, x, rnorm = state
        return (i < max_iter) & (rnorm > tol * bnorm)

    def body(state):
        i, x, _ = state
        r = b64 - matvec(x)
        dx = frontal_solve(fp, factors, r.astype(ftype))
        x = x + dx.astype(jnp.float64)
        r2 = b64 - matvec(x)
        return i + 1, x, jnp.linalg.norm(r2)

    x0 = frontal_solve(fp, factors, b_perm.astype(ftype)).astype(jnp.float64)
    r0 = jnp.linalg.norm(b64 - matvec(x0))
    i, x, rnorm = lax.while_loop(cond, body, (0, x0, r0))
    return x, rnorm / bnorm


# ---------------------------------------------------------------------------
# JIT wrappers


@functools.partial(jax.jit, static_argnums=(0, 2, 3), donate_argnums=1)
def _factor_jit(key, fronts, extadd, root_mesh):
    return frontal_factor(_FPLAN_CACHE[key], fronts, extadd=extadd,
                          root_mesh=root_mesh)


@functools.partial(jax.jit, static_argnums=(0, 4, 5))
def _solve_refined_jit(key, factors, b_perm, acoo, tol, max_iter):
    a_rows, a_cols, a_vals = acoo
    return solve_refined(_FPLAN_CACHE[key], factors, b_perm, a_rows, a_cols,
                         a_vals, tol=tol, max_iter=max_iter)


def solve_refined_device(fp: FrontalPlan, factors, b_perm, a_rows, a_cols,
                         a_vals, tol: float = 1e-12, max_iter: int = 40):
    acoo = (jnp.asarray(a_rows), jnp.asarray(a_cols),
            jnp.asarray(a_vals, jnp.float64))
    return _solve_refined_jit(fp.key(), tuple(factors),
                              jnp.asarray(b_perm), acoo, float(tol),
                              int(max_iter))


@functools.partial(jax.jit, static_argnums=0)
def _solve_jit(key, factors, b_perm):
    return frontal_solve(_FPLAN_CACHE[key], factors, b_perm)


@functools.partial(jax.jit, static_argnums=0)
def _solve_multi_jit(key, factors, b_perm):
    """Multiple right-hand sides [n, k]: vmapped over the RHS axis."""
    fp = _FPLAN_CACHE[key]
    return jax.vmap(lambda bc: frontal_solve(fp, factors, bc),
                    in_axes=1, out_axes=1)(b_perm)


def solve_multi(fp: FrontalPlan, factors, b_perm) -> jax.Array:
    return _solve_multi_jit(fp.key(), tuple(factors), jnp.asarray(b_perm))


# ---------------------------------------------------------------------------
# Batched same-pattern factorization: K matrices sharing one sparsity
# pattern, factored/solved as ONE vmapped program over [K, B, F, W] slabs.
# Where the reference re-runs its whole task graph per matrix
# (--iterations, mmat.rg:1212-1224), this form adds a batch axis — the
# matrix units see K-fold larger matmul batches, amortizing every dispatch and
# small-kernel launch across the family (GP hyperparameter sweeps, MCMC,
# parametric studies).


@functools.partial(jax.jit, static_argnums=(0, 2))
def _factor_many_jit(key, fronts, extadd):
    fp = _FPLAN_CACHE[key]
    return jax.vmap(lambda fr: frontal_factor(fp, fr, extadd=extadd))(fronts)


def factor_many(fp: FrontalPlan, fronts, extadd: Optional[str] = None,
                mesh=None) -> Tuple[jax.Array, ...]:
    """Factor K same-pattern matrices at once. `fronts` is the per-level
    list of [K, B, F, W] slabs from assemble_fronts with 2-D vals.

    With `mesh`, the SYSTEM axis shards over the devices (each device owns
    K/ndev independent factorizations — zero collectives; GSPMD keeps the
    partitioning through the whole program from the input shardings)."""
    import os

    if extadd is None:
        extadd = os.environ.get("CHOLESKY_TPU_EXTADD", "hybrid3")
    if mesh is not None:
        from cholesky_tpu.parallel.mesh import distribute_family

        fronts = distribute_family([jnp.asarray(f) for f in fronts], mesh)
    return _factor_many_jit(fp.key(),
                            tuple(jnp.asarray(f) for f in fronts), extadd)


@functools.partial(jax.jit, static_argnums=0)
def _solve_many_systems_jit(key, factors, b_perm):
    fp = _FPLAN_CACHE[key]
    return jax.vmap(lambda fac, bb: frontal_solve(fp, fac, bb))(
        factors, b_perm)


def solve_many_systems(fp: FrontalPlan, factors, b_perm,
                       mesh=None) -> jax.Array:
    """One solve per system: factors [K, B, F, W] per level, b_perm [K, n]
    (PERMUTED order); returns x_perm [K, n]. With `mesh`, the rhs shards
    over the system axis to match system-sharded factors."""
    b_perm = jnp.asarray(b_perm)
    if mesh is not None:
        from cholesky_tpu.parallel.mesh import family_sharding

        b_perm = jax.device_put(
            b_perm, family_sharding(mesh, int(b_perm.shape[0]), ndim=2))
    return _solve_many_systems_jit(fp.key(), tuple(factors), b_perm)


def factor(fp: FrontalPlan, fronts, extadd: Optional[str] = None,
           root_mesh=None) -> Tuple[jax.Array, ...]:
    import os

    if extadd is None:
        extadd = os.environ.get("CHOLESKY_TPU_EXTADD", "hybrid3")
    # the UNGATED mesh governs data distribution (offload re-upload
    # shardings); _effective_root_mesh only gates the collective root front
    dist_mesh = root_mesh.mesh if isinstance(root_mesh, _RootSpec) \
        else root_mesh
    root_mesh = _effective_root_mesh(fp, root_mesh)
    lazy = isinstance(fronts, LazyFronts)
    if lazy:
        total = sum(fronts.nbytes_of(l) for l in range(len(fronts)))
    else:
        total = sum(int(np.prod(f.shape)) * jnp.dtype(f.dtype).itemsize
                    for f in fronts)
    mode = os.environ.get("CHOLESKY_TPU_STREAM", "auto")
    offload_bytes = capacity.threshold("offload")
    if lazy or mode == "1" or (
            mode == "auto" and total > capacity.threshold("stream")):
        # past the stream threshold the monolithic program's cross-level
        # temp live ranges exceed device memory (1M dofs: 14.3 GiB of HLO
        # temps); stream one donating program per level instead
        sd = os.environ.get("CHOLESKY_TPU_STORE_DTYPE")
        store_dtype = jnp.dtype(sd) if sd else None
        f0_dtype = fronts.dtype if lazy else fronts[0].dtype
        upload = not lazy and (
            os.environ.get("CHOLESKY_TPU_UPLOAD_STREAM") == "1" or (
                total > offload_bytes and isinstance(fronts[0], np.ndarray)))
        if (store_dtype is None and jnp.dtype(f0_dtype) == jnp.float32
                and (upload or total > capacity.threshold("f32_store"))):
            # f32 fronts past the f32-store ceiling cannot all stay
            # resident as factors either — compress the stored factor.
            # Host-streamed uploads imply the same: if the fronts don't
            # fit on the device, neither does an f32 copy of the factor.
            # (f32 only: an f64 factor must not silently degrade — its
            # solve path skips iterative refinement.)
            store_dtype = jnp.bfloat16
        # past the offload threshold even the compressed factor cannot
        # accumulate on the device alongside the near-root f32 working slabs:
        # move each finished level's stored factor to host as it completes
        ofl = os.environ.get("CHOLESKY_TPU_OFFLOAD")
        offload = (ofl == "1" if ofl in ("0", "1")
                   else total > offload_bytes)
        if not upload and not lazy:
            fronts = tuple(jnp.asarray(f) for f in fronts)
        out = frontal_factor_streamed(
            fp, fronts, extadd=extadd, root_mesh=root_mesh,
            store_dtype=store_dtype, upload=upload, offload=offload)
        if offload:
            # with the working slabs gone, the stored factor alone may fit
            # back on the device — re-upload so the solve stays
            # device-resident (one PCIe pass; otherwise every solve
            # re-ships the factor)
            stored = sum(int(np.prod(f.shape))
                         * jnp.dtype(getattr(f, "dtype", jnp.float32)).itemsize
                         for f in out)
            need = stored + capacity.threshold("solve_headroom")
            if dist_mesh is not None:
                # per-device residency is stored/ndev on the sharded levels
                # — scale the re-upload gate by the mesh and restore the
                # slot shardings (a bare device_put would collapse the
                # factor onto one device and defeat the capacity scaling)
                from cholesky_tpu.parallel.mesh import panel_sharding

                ndev = int(dist_mesh.devices.size)
                if need <= capacity.device_bytes() * ndev:
                    out = tuple(
                        f if isinstance(f, jax.Array)
                        else jax.device_put(f, panel_sharding(dist_mesh, lvl))
                        for lvl, f in enumerate(out))
            elif need <= capacity.device_bytes():
                # the factor goes back once if it fits alongside the
                # solve's working set — per-level f32 pivot casts + ELL
                # planes + refinement vectors
                out = tuple(f if isinstance(f, jax.Array)
                            else jax.device_put(f) for f in out)
        return out
    return _factor_jit(fp.key(), tuple(jnp.asarray(f) for f in fronts),
                       extadd, root_mesh)


def solve(fp: FrontalPlan, factors, b_perm) -> jax.Array:
    return _solve_jit(fp.key(), tuple(factors), jnp.asarray(b_perm))


# ---------------------------------------------------------------------------
# Extraction (verification / .mtx output)


def extract_factor_coo(fp: FrontalPlan, factors: Sequence,
                       drop_tol: float = 0.0):
    """Extract the factor L as COO (permuted coordinates, lower triangle) —
    the scalable form of the reference's factored-matrix dump (write_matrix,
    mmat.rg:103-147, which walks its dense region). Returns (rows, cols,
    vals) with 0-based permuted indices."""
    plan = fp.plan
    t = plan.tree
    out_r, out_c, out_v = [], [], []
    for lvl in range(fp.levels):
        arr = np.asarray(factors[lvl], dtype=np.float64)
        Wl = fp.W[lvl]
        for sl in range(1 << lvl):
            s = t.sep_at(lvl, sl)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            fr = fp.front_rows[lvl][sl]
            piv = np.tril(arr[sl][:sz, :sz])
            pr_, pc_ = np.nonzero(np.abs(piv) > drop_tol)
            out_r.append(pr_ + off)
            out_c.append(pc_ + off)
            out_v.append(piv[pr_, pc_])
            bnd = fr[Wl:]
            bv = bnd < plan.n
            strip = arr[sl][Wl:, :sz][bv]
            br, bc = np.nonzero(np.abs(strip) > drop_tol)
            out_r.append(bnd[bv][br])
            out_c.append(bc + off)
            out_v.append(strip[br, bc])
    return (np.concatenate(out_r), np.concatenate(out_c),
            np.concatenate(out_v))


def extract_factor_dense(fp: FrontalPlan, factors: Sequence) -> np.ndarray:
    """Materialize L (permuted coordinates, lower triangular)."""
    plan = fp.plan
    L = np.zeros((plan.n, plan.n))
    t = plan.tree
    for lvl in range(fp.levels):
        arr = np.asarray(factors[lvl], dtype=np.float64)
        Wl = fp.W[lvl]
        for sl in range(1 << lvl):
            s = t.sep_at(lvl, sl)
            off = int(plan.sep_offset[s])
            sz = int(plan.sep_sizes[s])
            fr = fp.front_rows[lvl][sl]
            cols = np.arange(off, off + sz)
            L[np.ix_(cols, cols)] = np.tril(arr[sl][:sz, :sz])
            bnd = fr[Wl:]
            bv = bnd < plan.n
            L[np.ix_(bnd[bv], cols)] = arr[sl][Wl:, :sz][bv]
    return L
