"""Distributed factorization of NARROW mid-tree levels (1 < B < ndev).

The elimination-tree sharding in parallel/mesh.py slot-shards a level's
[B, F, W] panels only when B >= ndev; narrower levels replicated by
policy, which capped aggregate device-memory scaling one step below the
root: at 80^3 on 8 devices the level-1 (B=2) streamed program was 4,453 MiB
PER DEVICE at ratio 1.000 while every wide level sat at 0.125 (AOT
memory_analysis, tools/memcheck_mesh.py). Legion places those block
tasks across the machine like any others (placement-agnostic index
launches mmat.rg:1240-1294; mapper cholesky.cc:65-73); this module closes
the gap here.

Scheme: the mesh reshapes to a (fb = B fronts, rg = ndev/B chips) grid —
each front factors over its own rg subgroup inside ONE shard_map:

  1. extend-add: each chip assembles ITS contiguous F/G slab rows from
     the front's two child updates (replicated per subgroup; the
     positional gathers use the same inv_child maps as the single-chip
     paths, row-sliced by the sharding) — the multi-GiB expansion temps
     of the replicated program shard ~1/G;
  2. the pivot block factors REDUNDANTLY on the subgroup after one
     tiled all_gather of the slab rows (W^2 + F*W/G per chip; the same
     redundant-small-factorization trade dist_cholesky.py makes for its
     diagonal blocks — cheaper than a second collective, and the pivot
     is O(W^3/3) next to the level's O(F*W^2));
  3. boundary TRSM runs on local rows only (X = rows @ L_d^{-T});
  4. one all_gather of the factored rows gives every chip X in full, and
     each chip emits ITS rows of the Schur update U2 = X X^T + E_T —
     the output [B, K, K] leaves row-sharded for the parent program.

Per-chip wire volume: 2 * F * W * 4 bytes per level (two row gathers)
over the interconnect — the same order as reading the slab once.
Per-device memory:
F*W/G owned + F*W gathered + 2*Kc^2 child updates + K^2/G emitted,
vs the replicated program's B*F*W + B*F^2-order temps.

Numerics are IDENTICAL operations to the replicated dense path
(POTRF + triangular_solve + one Schur matmul); only the row
partitioning differs, so the virtual-mesh tests gate at the same 1e-10
contract as the single-chip path.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

FB_AXIS = "fb"      # front axis (B subgroups)
RG_AXIS = "rg"      # row-group axis (ndev/B chips per front)


def eligible(fp, lvl: int, B: int, mesh) -> bool:
    """Narrow-level distribution preconditions: a real mesh, a mid-tree
    level with fewer fronts than chips, even divisibility of chips over
    fronts and of the slab rows / Schur rows over each subgroup.
    CHOLESKY_TPU_DIST_MID=0 disables."""
    if mesh is None or lvl < 1:
        return False
    if os.environ.get("CHOLESKY_TPU_DIST_MID", "1") == "0":
        return False
    ndev = int(mesh.devices.size)
    if not (1 < B < ndev) or ndev % B:
        return False
    G = ndev // B
    F, W = fp.F[lvl], fp.W[lvl]
    K = F - W
    if F % G or (K and K % G):
        return False
    return True


def level_mesh(mesh, B: int) -> Mesh:
    """(fb, rg) grid over the mesh's devices: front b is owned by the
    contiguous device group b."""
    ndev = int(mesh.devices.size)
    return Mesh(mesh.devices.reshape(B, ndev // B), (FB_AXIS, RG_AXIS))


def factor_level_sharded(fp, lvl: int, piv, U, mesh, update_dtype):
    """Drop-in for the _factor_level mid-tree dense path on an eligible
    narrow level: returns (fac [B, F, W] row-sharded, U2 [B, K, K]
    row-sharded, cast to update_dtype). `U` is the children's accumulated
    update — dense [2B, Kc, Kc] or the deferred leaf tag ("xxt", Xc)."""
    B = piv.shape[0]
    F, W = fp.F[lvl], fp.W[lvl]
    K = F - W
    G = int(mesh.devices.size) // B
    m2 = level_mesh(mesh, B)
    cl = lvl + 1

    xxt = isinstance(U, tuple) and U[0] == "xxt"
    Xc = U[1] if xxt else None
    Ud = None if xxt else U
    Kc = fp.F[cl] - fp.W[cl]

    # host-constant positional maps, passed as sharded operands (shard_map
    # bodies must receive per-shard data as arguments, not closures)
    inv = fp.inv_child[cl].astype(np.int32).reshape(B, 2, F)  # sentinel Kc
    inv_rows = jnp.asarray(inv)                    # row-sharded over F
    inv_cols = jnp.asarray(inv[:, :, :W])          # replicated per front
    inv_bnd = jnp.asarray(inv[:, :, W:])           # replicated per front

    rows_per = F // G
    urows_per = K // G if K else 0

    in_specs = [P(FB_AXIS, RG_AXIS, None),          # piv rows
                P(FB_AXIS, None, RG_AXIS),          # inv_rows (row maps)
                P(FB_AXIS, None, None),             # inv_cols
                P(FB_AXIS, None, None)]             # inv_bnd
    out_specs = (P(FB_AXIS, RG_AXIS, None),
                 P(FB_AXIS, RG_AXIS, None))
    if xxt:
        in_specs.append(P(FB_AXIS, None, None, None))   # Xc pair
        uarg = Xc.reshape(B, 2, Xc.shape[1], Xc.shape[2])
    else:
        in_specs.append(P(FB_AXIS, None, None, None))   # U pair
        uarg = Ud.reshape(B, 2, Kc, Kc)

    @functools.partial(jax.shard_map, mesh=m2, in_specs=tuple(in_specs),
                       out_specs=out_specs)
    def _level(piv_l, invr_l, invc_l, invb_l, u_l):
        g = lax.axis_index(RG_AXIS)
        cdt = jnp.promote_types(piv_l.dtype, jnp.float32)   # compute dtype
        pivl = piv_l[0].astype(cdt)                  # [F/G, W]
        if xxt:
            xc = u_l[0].astype(cdt)                  # [2, Kc, Wc]
            up = jnp.einsum("cik,cjk->cij", xc, xc,
                            preferred_element_type=cdt)
        else:
            up = u_l[0].astype(cdt)                  # [2, Kc, Kc]
        # zero row+column absorb the sentinel index Kc
        up = jnp.pad(up, ((0, 0), (0, 1), (0, 1)))
        invr = invr_l[0]                             # [2, F/G]
        invc = invc_l[0]                             # [2, W]
        invb = invb_l[0]                             # [2, K]

        # 1) extend-add into MY slab rows (pivot columns only)
        contrib = sum(up[c][invr[c][:, None], invc[c][None, :]]
                      for c in range(2))             # [F/G, W]
        slab_l = pivl - contrib

        # 2) redundant pivot factorization after one row gather
        slab_full = lax.all_gather(slab_l, RG_AXIS, axis=0, tiled=True)
        Ld = lax.linalg.cholesky(slab_full[:W, :],
                                 symmetrize_input=False)       # [W, W]

        # 3) boundary TRSM on local rows (pivot rows masked below)
        sol_l = lax.linalg.triangular_solve(
            Ld[None], slab_l[None], left_side=False, lower=True,
            transpose_a=True)[0]
        rows_glob = g * rows_per + jnp.arange(rows_per)
        ld_rows = Ld[jnp.clip(rows_glob, 0, W - 1)]
        fac_l = jnp.where(rows_glob[:, None] < W, ld_rows, sol_l)

        # 4) my rows of the Schur update U2 = X X^T + E_T
        if K:
            fac_full = lax.all_gather(fac_l, RG_AXIS, axis=0, tiled=True)
            X_full = fac_full[W:]                    # [K, W]
            r0 = g * urows_per
            Xr = lax.dynamic_slice(X_full, (r0, jnp.int32(0)),
                                   (urows_per, W))
            myrows = r0 + jnp.arange(urows_per)
            ib_r = jnp.stack([invb[c][myrows] for c in range(2)])
            T_l = sum(up[c][ib_r[c][:, None], invb[c][None, :]]
                      for c in range(2))             # [K/G, K]
            U2_l = jnp.dot(Xr, X_full.T,
                           preferred_element_type=cdt) + T_l
        else:
            U2_l = jnp.zeros((0, 0), cdt)
        return (fac_l[None].astype(piv_l.dtype),
                U2_l[None].astype(update_dtype))

    fac, U2 = _level(piv, inv_rows, inv_cols, inv_bnd, uarg)
    return fac, U2
