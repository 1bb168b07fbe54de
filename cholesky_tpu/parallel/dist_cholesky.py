"""Collective (multi-chip) dense Cholesky for top-of-tree fronts.

The elimination-tree sharding in parallel/mesh.py replicates levels with
fewer separators than chips; for very large root fronts (a 128^3 grid has a
16384^2 root front) that wastes the mesh exactly where the FLOPs peak. This
module factors a single large front cooperatively with a **1-D block-cyclic
right-looking blocked Cholesky** inside `shard_map`:

  * column block k (width `block`) is OWNED by chip k % ndev — cyclic
    ownership keeps every chip's trailing-update work balanced to within one
    block for the whole factorization (a contiguous column layout idles the
    chips that own leading columns: chip 0 does ~1/ndev of the FLOPs of the
    last chip, measured 1.9x wall at F=8192 on the 8-device mesh);
  * per step, the active panel is broadcast with one `psum` over the device
    interconnect (the owner contributes, others zero): Fp·block·4 bytes per
    step, and with nb = Fp/block steps the total collective volume is
    Fp²·4 bytes per device for the whole factorization — the same order as
    reading the matrix once (a ring all-reduce moves 2·(ndev−1)/ndev ≈ 2x
    that on the wire; at Fp = 16384 that is 2 GiB, small next to the
    16384³/3 = 1.5 TFLOP of compute);
  * every chip redundantly factors the [block, block] diagonal block
    (block³/3 FLOPs — cheaper than a second collective) and triangular-
    solves the panel below it;
  * the trailing update of a chip's own columns is one [Fp, block] x
    [block, local] matmul per step — each chip updates only the columns
    it owns, so compute per step is Fp·block·Fp/ndev flops, balanced by the
    cyclic layout.

Per-chip HBM: Fp·(Fp/ndev)·4 bytes of local columns plus one [Fp, block]
panel — a 16384² root front on 8 chips is 128 MiB of local columns + 16 MiB
panel, comfortably in-core where the replicated front (1 GiB + its Schur
temps) is not.

This replaces the reference's implicit Legion/Realm distribution of the
root-separator POTRF chain (mmat.rg:1240-1245 at lvl=0; placement policy
cholesky.cc:55-73) with explicit XLA collectives — the "collective root-front
factorization" of the rebuild plan.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cholesky_tpu.utils import round_up as _round_up


def _cyclic_perm(Fp: int, ndev: int, block: int) -> np.ndarray:
    """Global column -> block-cyclic storage position: column c of block
    k = c // block moves to owner d = k % ndev, local block j = k // ndev;
    its storage position is d * (Fp // ndev) + j * block + (c % block).
    Returns `to_slot` with to_slot[c] = storage slot of column c."""
    k = np.arange(Fp) // block
    within = np.arange(Fp) % block
    d = k % ndev
    j = k // ndev
    return d * (Fp // ndev) + j * block + within


def _grid_for(ndev: int) -> tuple:
    """Near-square 2-D process grid (pr, pc) with pr*pc = ndev, pr >= pc."""
    pr = int(np.sqrt(ndev))
    while ndev % pr:
        pr -= 1
    return max(pr, ndev // pr), min(pr, ndev // pr)


def _pick_scheme(F: int, ndev: int, block: int) -> str:
    """Route the collective root front: the 1-D column-cyclic scheme moves
    ~2·F²·4 bytes per chip over the whole factorization (one [F, block]
    panel all-reduce per step); the 2-D (pr, pc) grid moves
    ~2·F²·4·(1/pr + 1/pc) plus a diagonal-tile broadcast — a win once
    1/pr + 1/pc < 1, i.e. ndev ≥ 6 non-prime grids, and the panel is tall
    enough that the extra latency of two group collectives per step
    amortizes (F/ndev ≥ 4 blocks per device per direction). At 4 devices
    the 2x2 grid ties with 1-D (1/2 + 1/2 = 1), so 1-D is kept there.
    CHOLESKY_TPU_ROOT_SCHEME=1d/2d overrides."""
    import os

    forced = os.environ.get("CHOLESKY_TPU_ROOT_SCHEME")
    if forced in ("1d", "2d"):
        return forced
    pr, pc = _grid_for(ndev)
    if pc < 2:                      # prime/tiny meshes: no useful grid
        return "1d"
    if 1.0 / pr + 1.0 / pc >= 1.0:
        return "1d"
    if F < 4 * ndev * block:        # short panels: latency-bound, keep 1-D
        return "1d"
    return "2d"


def distributed_cholesky(a: jax.Array, mesh: Mesh, block: int = 256) -> jax.Array:
    """Cholesky of an SPD matrix [F, F] (lower triangle referenced), computed
    cooperatively over `mesh`'s devices with 1-D block-cyclic column
    ownership. Returns L (lower triangular, zero above) in the matrix's
    dtype. jit-composable: shardings are applied with
    with_sharding_constraint, so this can be called inside a larger jitted
    program (the frontal engine's root-front path).

    Accepts f32/f64 input; a bf16 input (bf16-stored factor slabs feeding a
    distributed root) is computed in f32 and returned bf16.

    Depth-1 lookahead: the step-k panel arrives through the loop carry.
    After factoring it, the owner of block k+1 applies ONLY step k's
    update to its next [Fp, block] column slab (one small matmul) and the
    all-reduce for panel k+1 is issued BEFORE the O(Fp·block·Fp/ndev)
    trailing update of the local columns — the collective has no data
    dependence on the big matmul, so XLA's async collectives overlap the
    transfer with the step's dominant compute instead of serializing
    after it (the classic broadcast/update overlap that right-looking
    distributed Cholesky needs past ~8-16 devices; cost: one duplicated
    [Fp, block]×[block, block] update of the lookahead column)."""
    axes = mesh.axis_names                  # ("tree",) from make_mesh
    axes_spec = axes if len(axes) > 1 else axes[0]
    ndev = int(mesh.devices.size)
    F = a.shape[0]
    in_dtype = a.dtype
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    Fp = _round_up(F, ndev * block)
    if Fp != F:
        pad = Fp - F
        a = jnp.pad(a, ((0, pad), (0, pad)))
        diag = jnp.arange(F, Fp)
        a = a.at[diag, diag].set(1.0)
    cols_per_dev = Fp // ndev
    nb = Fp // block

    # permute columns into block-cyclic storage order so the TREE_AXIS
    # sharding's contiguous device slices hold each device's cyclic blocks
    # (host-constant index arrays; the gathers are baked at trace time)
    to_slot = _cyclic_perm(Fp, ndev, block)       # column c -> storage slot
    from_slot = np.empty_like(to_slot)
    from_slot[to_slot] = np.arange(Fp)            # storage slot -> column c
    a = a[:, jnp.asarray(from_slot)]

    a = jax.lax.with_sharding_constraint(
        a, NamedSharding(mesh, P(None, axes_spec)))

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P(None, axes_spec),
        out_specs=P(None, axes_spec))
    def _chol(local):                      # local: [Fp, cols_per_dev]
        d = jnp.int32(0)                   # flattened device index
        for name in axes:
            d = d * jnp.int32(mesh.shape[name]) + \
                lax.axis_index(name).astype(jnp.int32)
        rows = lax.broadcasted_iota(jnp.int32, (Fp, 1), 0)
        # global column index of each of my storage slots (block-cyclic):
        # slot j*block + t  ->  column (j*ndev + d)*block + t
        jloc = lax.broadcasted_iota(jnp.int32, (1, cols_per_dev), 1)
        cols_glob = ((jloc // block) * ndev + d) * block + (jloc % block)

        def step(k, carry):
            local, panel = carry            # panel: pre-update col k, via
            kb = (k * block).astype(jnp.int32)   # the lookahead carry
            owner = (k % ndev) == d
            loc_off = ((k // ndev) * block).astype(jnp.int32)
            zero = jnp.int32(0)
            # 1) redundant small factorization of the diagonal block
            dblk = lax.dynamic_slice(panel, (kb, zero), (block, block))
            ld = lax.linalg.cholesky(dblk, symmetrize_input=False)
            below = jnp.where(rows >= kb + block, panel, 0.0)
            x = lax.linalg.triangular_solve(
                ld, below, left_side=False, lower=True, transpose_a=True)
            lpanel = x + jnp.where(
                (rows >= kb) & (rows < kb + block),
                lax.dynamic_update_slice(jnp.zeros_like(panel), ld,
                                         (kb, zero)),
                0.0)
            # 2) owner stores the factored panel into its local columns
            stored = lax.dynamic_update_slice(local, lpanel, (zero, loc_off))
            local = jnp.where(owner, stored, local)
            # 3) LOOKAHEAD: apply step k's update to the NEXT block column
            #    only (one [Fp, block] matmul) and issue its all-reduce now,
            #    before the trailing update it does not depend on — XLA
            #    overlaps the collective with step 4's big matmul.
            k1 = jnp.minimum(k + 1, jnp.int32(nb - 1))
            owner1 = (k1 % ndev) == d
            loc_off1 = ((k1 // ndev) * block).astype(jnp.int32)
            slab1 = lax.dynamic_slice(local, (zero, loc_off1), (Fp, block))
            xj1 = lax.dynamic_slice(x, (k1 * block, zero), (block, block))
            slab1 = slab1 - jnp.dot(x, xj1.T,
                                    preferred_element_type=x.dtype)
            panel_next = lax.psum(
                jnp.where(owner1, slab1, jnp.zeros_like(slab1)), axes)
            # 4) trailing update of MY columns: local[:, c] -= X · X[g(c), :]ᵀ
            #    where g(c) is slot c's global column (block-cyclic gather);
            #    includes the lookahead column exactly once (panel_next took
            #    its own copy above)
            xj = x[cols_glob[0]]                        # [cols_per_dev, block]
            active = cols_glob >= kb + block            # cols right of panel
            upd = jnp.dot(x, xj.T, preferred_element_type=x.dtype)
            local = local - jnp.where(active, upd, 0.0)
            return local, panel_next

        # prologue: broadcast block column 0 (owner is device 0, slot 0)
        my0 = lax.dynamic_slice(local, (jnp.int32(0), jnp.int32(0)),
                                (Fp, block))
        panel0 = lax.psum(
            jnp.where(d == 0, my0, jnp.zeros_like(my0)), axes)
        local, _ = lax.fori_loop(jnp.int32(0), jnp.int32(nb), step,
                                 (local, panel0))
        # zero strict upper triangle of my columns
        return jnp.where(rows >= cols_glob, local, 0.0)

    out = _chol(a)
    # un-permute the columns back to natural order
    out = out[:, jnp.asarray(to_slot)]
    return out[:F, :F].astype(in_dtype)


def distributed_cholesky_2d(a: jax.Array, mesh: Mesh,
                            block: int = 256) -> jax.Array:
    """Cholesky of an SPD [F, F] over a 2-D block-cyclic process grid —
    the ScaLAPACK layout, built from `mesh`'s devices reshaped to a
    near-square (pr, pc) grid. Tile (i, j) (block indexing) is owned by
    device (i mod pr, j mod pc); per step k:

      1. the [block, block] diagonal tile broadcasts to all devices (one
         small psum over both axes) and factors redundantly;
      2. column-k owners (dc = k mod pc) triangular-solve their panel rows
         locally — each row group's panel piece exists on exactly one
         device;
      3. ROW broadcast: one psum over the column axis ("cg", pc members)
         gives every device the panel rows of ITS row group —
         2·(F/pr)·block·4 bytes per chip per step on a ring;
      4. COLUMN broadcast: each device contributes the L[j,k] tiles it
         holds for its local column blocks (a block-granular gather from
         the row-broadcast panel), one psum over the row axis ("rg", pr
         members) — 2·(F/pc)·block·4 bytes per chip per step;
      5. trailing update of the local tiles: ONE [F/pr, block] x
         [block, F/pc] matmul.

    Per-chip wire volume over the whole factorization is therefore
    ~2·F²·4·(1/pr + 1/pc) bytes vs the 1-D column-cyclic scheme's ~2·F²·4
    (its [F, block] panel all-reduce per step): 0.75x at 8 = 4x2, 0.5x at
    16 = 4x4, 0.25x at 64 = 8x8 — the 2-D grid is what keeps the root
    front scaling past ~8-16 chips. Per-chip HBM is F²·4/(pr·pc) of local
    tiles plus one [F/pr, block] + [F/pc, block] panel pair. Compute per
    step is one (F/pr)·block·(F/pc) matmul per chip, balanced by the
    cyclic layout to within one block row/column.

    jit-composable like the 1-D scheme (sharding constraints only). The
    routing between the two lives in collective_cholesky."""
    ndev = int(mesh.devices.size)
    pr, pc = _grid_for(ndev)
    mesh2 = Mesh(mesh.devices.reshape(pr, pc), ("rg", "cg"))
    F = a.shape[0]
    in_dtype = a.dtype
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    lcm = pr * pc // np.gcd(pr, pc)
    Fp = _round_up(F, lcm * block)
    if Fp != F:
        pad = Fp - F
        a = jnp.pad(a, ((0, pad), (0, pad)))
        diag = jnp.arange(F, Fp)
        a = a.at[diag, diag].set(1.0)
    Fr, Fc = Fp // pr, Fp // pc
    nb = Fp // block
    nbc = Fc // block

    # block-cyclic storage permutations (host constants)
    to_r = _cyclic_perm(Fp, pr, block)
    from_r = np.empty_like(to_r)
    from_r[to_r] = np.arange(Fp)
    to_c = _cyclic_perm(Fp, pc, block)
    from_c = np.empty_like(to_c)
    from_c[to_c] = np.arange(Fp)
    a = a[jnp.asarray(from_r)][:, jnp.asarray(from_c)]
    a = jax.lax.with_sharding_constraint(
        a, NamedSharding(mesh2, P("rg", "cg")))

    @functools.partial(jax.shard_map, mesh=mesh2, in_specs=P("rg", "cg"),
                       out_specs=P("rg", "cg"))
    def _chol(local):                          # local: [Fr, Fc]
        dr = lax.axis_index("rg").astype(jnp.int32)
        dc = lax.axis_index("cg").astype(jnp.int32)
        lrow = lax.broadcasted_iota(jnp.int32, (Fr, 1), 0)
        grow = ((lrow // block) * pr + dr) * block + lrow % block
        lcol = lax.broadcasted_iota(jnp.int32, (1, Fc), 1)
        gcol = ((lcol // block) * pc + dc) * block + lcol % block
        # my local column blocks' global block ids and their row-group
        # owners (for the column broadcast's block-granular gather)
        jc = lax.broadcasted_iota(jnp.int32, (nbc, 1), 0)
        jglob = jc * pc + dc                             # [nbc, 1]
        mrow = lax.broadcasted_iota(jnp.int32, (Fc, 1), 0)
        jglob_row = (mrow // block) * pc + dc            # [Fc, 1]
        src_row = (jglob_row // pr) * block + mrow % block
        mine = (jglob_row % pr)                          # owner row group

        def step(k, carry):
            # 1) the diagonal tile arrives through the lookahead carry: its
            #    two-axis psum was issued in step k-1 BEFORE the trailing matmul, so
            #    its latency hides behind that step's dominant compute
            local, dblk = carry
            kr = (k % pr).astype(jnp.int32)
            kc = (k % pc).astype(jnp.int32)
            rk = ((k // pr) * block).astype(jnp.int32)
            ck = ((k // pc) * block).astype(jnp.int32)
            zero = jnp.int32(0)
            colk = lax.dynamic_slice(local, (zero, ck), (Fr, block))
            ld = lax.linalg.cholesky(dblk, symmetrize_input=False)
            # 2) panel solve (real only on dc == kc; masked elsewhere)
            below = jnp.where(grow >= (k + 1) * block, colk, 0.0)
            x = lax.linalg.triangular_solve(
                ld, below, left_side=False, lower=True, transpose_a=True)
            # owner writes the factored column block back (rows above the
            # diagonal block zero — masked at the end anyway)
            diag_put = lax.dynamic_update_slice(
                jnp.zeros((Fr, block), local.dtype), ld, (rk, zero))
            panel_store = x + jnp.where(dr == kr, diag_put, 0.0)
            stored = lax.dynamic_update_slice(local, panel_store,
                                              (zero, ck))
            local = jnp.where(dc == kc, stored, local)
            # 3) row broadcast over the column axis: panel rows of MY row
            #    group (psum; the dc == kc member contributes)
            Pk = lax.psum(jnp.where(dc == kc, x, jnp.zeros_like(x)), "cg")
            # 4) column broadcast over the row axis: L[j, k] tiles for my
            #    local column blocks (block-granular gather from Pk)
            gath = jnp.take_along_axis(
                Pk, jnp.broadcast_to(src_row, (Fc, block)), axis=0)
            contrib = jnp.where((mine == dr) & (jglob_row > k), gath, 0.0)
            Yk = lax.psum(contrib, "rg")                 # [Fc, block]
            Ykm = jnp.where(jglob_row > k, Yk, 0.0)
            # 5) LOOKAHEAD: pre-update the NEXT diagonal tile (two small
            #    [block, block] matmul slices of the trailing update) and
            #    issue its two-axis psum before the big matmul it does not
            #    depend on
            k1 = jnp.minimum(k + 1, jnp.int32(nb - 1))
            kr1 = (k1 % pr).astype(jnp.int32)
            kc1 = (k1 % pc).astype(jnp.int32)
            rk1 = ((k1 // pr) * block).astype(jnp.int32)
            ck1 = ((k1 // pc) * block).astype(jnp.int32)
            tile = lax.dynamic_slice(local, (rk1, ck1), (block, block))
            pr1 = lax.dynamic_slice(Pk, (rk1, zero), (block, block))
            yc1 = lax.dynamic_slice(Ykm, (ck1, zero), (block, block))
            tile = tile - jnp.dot(pr1, yc1.T,
                                  preferred_element_type=pr1.dtype)
            own1 = (dr == kr1) & (dc == kc1)
            dblk_next = lax.psum(
                jnp.where(own1, tile, jnp.zeros_like(tile)), ("rg", "cg"))
            # 6) trailing update of my tiles (one matmul; includes the
            #    lookahead tile exactly once — dblk_next took its own copy)
            upd = jnp.dot(Pk, Ykm.T, preferred_element_type=Pk.dtype)
            return local - upd, dblk_next

        # prologue: broadcast diagonal tile 0 (owner is grid device (0, 0))
        t0 = lax.dynamic_slice(local, (jnp.int32(0), jnp.int32(0)),
                               (block, block))
        dblk0 = lax.psum(
            jnp.where((dr == 0) & (dc == 0), t0, jnp.zeros_like(t0)),
            ("rg", "cg"))
        local, _ = lax.fori_loop(jnp.int32(0), jnp.int32(nb), step,
                                 (local, dblk0))
        return jnp.where(grow >= gcol, local, 0.0)

    out = _chol(a)
    out = out[jnp.asarray(to_r)][:, jnp.asarray(to_c)]
    return out[:F, :F].astype(in_dtype)


def collective_cholesky(a: jax.Array, mesh: Mesh,
                        block: Optional[int] = None) -> jax.Array:
    """Route a root-front factorization to the 1-D column-cyclic or 2-D
    block-cyclic scheme by (F, ndev, block) — see _pick_scheme for the
    wire-volume model. CHOLESKY_TPU_ROOT_BLOCK overrides the block size."""
    import os

    if block is None:
        block = int(os.environ.get("CHOLESKY_TPU_ROOT_BLOCK", "256"))
    ndev = int(mesh.devices.size)
    if _pick_scheme(int(a.shape[0]), ndev, block) == "2d":
        return distributed_cholesky_2d(a, mesh, block=block)
    return distributed_cholesky(a, mesh, block=block)
