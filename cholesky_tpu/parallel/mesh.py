"""Multi-chip distribution over a jax.sharding.Mesh.

Replacement for the reference's Legion mapper + Realm data
movement (cholesky.cc:28-91 places per-block tasks; Realm moves regions).
Here the elimination tree itself is the distribution: each level's panel
array [2^L, H, W] is sharded over its slot (separator) axis of a 1-D device
mesh, so independent subtrees land on different chips — the analogue of the
reference's per-separator index launches spread across Legion processors
(mmat.rg:1240-1294). Extend-add contributions that cross subtree boundaries
become XLA collectives (NCCL on the GPU), inserted automatically by GSPMD from the
sharding annotations (segment-sum over slots>>k in numeric/factor.py).

Shallow levels (fewer separators than chips) are replicated: every chip
redundantly factors the top fronts, which removes all communication from the
top of the tree at the cost of duplicate FLOPs — the standard trade for
small root fronts. Root fronts large enough to amortize collectives instead
factor cooperatively with the column-block-sharded Cholesky in
parallel/dist_cholesky.py (enabled via the frontal engine's root_mesh).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TREE_AXIS = "tree"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (TREE_AXIS,))


def panel_sharding(mesh: Mesh, level: int) -> NamedSharding:
    """Sharding for a level's [2^L, H, W] panel array: slot-sharded when
    the level is wide enough; NARROW mid-tree levels (1 < 2^L < ndev)
    shard rows over a per-front subgroup, matching the layout
    parallel/dist_level.factor_level_sharded emits (each of the B fronts
    owned by ndev/B chips along its row axis); replicated otherwise."""
    ndev = int(mesh.devices.size)
    nslots = 1 << level
    if nslots >= ndev and nslots % ndev == 0:
        return NamedSharding(mesh, P(TREE_AXIS, None, None))
    if 1 < nslots < ndev and ndev % nslots == 0:
        from cholesky_tpu.parallel.dist_level import FB_AXIS, RG_AXIS

        view = Mesh(mesh.devices.reshape(nslots, ndev // nslots),
                    (FB_AXIS, RG_AXIS))
        return NamedSharding(view, P(FB_AXIS, RG_AXIS, None))
    return NamedSharding(mesh, P(None, None, None))


def rhs_sharding(mesh: Mesh, level: int) -> NamedSharding:
    ndev = int(mesh.devices.size)
    nslots = 1 << level
    if nslots >= ndev and nslots % ndev == 0:
        return NamedSharding(mesh, P(TREE_AXIS, None))
    return NamedSharding(mesh, P(None, None))


def family_sharding(mesh: Mesh, k: int, ndim: int = 4) -> NamedSharding:
    """Sharding for batched same-pattern families: the SYSTEM axis (leading
    K of [K, B, F, W] fronts / [K, n] right-hand sides) shards over the
    mesh — each chip owns K/ndev whole factorizations, zero cross-chip
    communication (the family members are independent). Replicated when K
    doesn't divide."""
    ndev = int(mesh.devices.size)
    spec = [None] * ndim
    if k >= ndev and k % ndev == 0:
        spec[0] = TREE_AXIS
    return NamedSharding(mesh, P(*spec))


def distribute_family(fronts: Sequence, mesh: Mesh) -> List[jax.Array]:
    k = int(fronts[0].shape[0])
    return [jax.device_put(f, family_sharding(mesh, k)) for f in fronts]


def distribute_panels(panels: Sequence, mesh: Mesh) -> List[jax.Array]:
    return [jax.device_put(p, panel_sharding(mesh, lvl))
            for lvl, p in enumerate(panels)]


def distribute_rhs(b: Sequence, mesh: Mesh) -> List[jax.Array]:
    return [jax.device_put(x, rhs_sharding(mesh, lvl))
            for lvl, x in enumerate(b)]
