"""Capacity planning: tree-depth / leaf-size / memory / FLOP trade-offs.

Parity with the reference's utils.py:6-21 (depth, leaf_size, subregions for a
target dof count — used to pick nested-dissection depth for a 50^3 problem,
utils.py:43-56), extended with the panel-memory and FLOP estimators that
matter on an accelerator (device memory is the binding constraint, not task
counts), and the one place where the factor/solve regimes' memory thresholds
are derived from the device's capacity.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np

# Capacity assumed for the CPU backend, which reports no memory_stats (the
# test suite's virtual devices). An accelerator must report its own.
CPU_FALLBACK_BYTES = 12 << 30

# The regime thresholds below were first sized as absolute byte counts for a
# device with 15.75 GiB usable; each is kept as its ratio to that capacity, so
# a device of that size routes exactly as before and a larger one scales.
# Re-tuning the fractions for a larger card awaits measurement on it.
_SIZED_FOR = 15.75 * (1 << 30)
FRACTIONS = {
    # fronts past this factor level-streamed instead of as one program
    "stream": (5 << 30) / _SIZED_FOR,
    # streamed factors past this are stored bfloat16
    "f32_store": (7 << 30) / _SIZED_FOR,
    # fronts past this stream from the host and spill finished levels
    "offload": (9 << 30) / _SIZED_FOR,
    # per-device budget for extend-add intermediates and level chunking
    "hbm_budget": (14.5 * (1 << 30)) / _SIZED_FOR,
    # ceiling on the gathermm extend-add's materialized operands
    "gathermm_cap": (8 << 30) / _SIZED_FOR,
    # square fronts past this use the two-piece extend-add
    "two_piece": (512 << 20) / _SIZED_FOR,
    # a chunked level's emitted update past this spills to the host
    "u_offload": (2 << 30) / _SIZED_FOR,
    # a level's accumulated child update past this is stored bfloat16
    "update_bf16": (3 << 29) / _SIZED_FOR,
    # room the solve needs beside a device-resident factor
    "solve_headroom": (3584 << 20) / _SIZED_FOR,
    # fronts past this make the benchmark donate its factor inputs
    "bench_donate": (2 << 30) / _SIZED_FOR,
}


def device_bytes() -> int:
    """Memory capacity of one device in bytes: CHOLESKY_TPU_HBM_BYTES when
    set, else the device's memory_stats()['bytes_limit']. The CPU backend
    reports no stats and gets CPU_FALLBACK_BYTES; any other backend that
    reports none is an error rather than a guess."""
    env = os.environ.get("CHOLESKY_TPU_HBM_BYTES")
    if env:
        return int(env)
    import jax

    d = jax.devices()[0]
    stats = d.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if d.platform == "cpu":
        return CPU_FALLBACK_BYTES
    raise RuntimeError(
        f"device {d.device_kind!r} ({d.platform}) reports no memory "
        "capacity (memory_stats()['bytes_limit']); set "
        "CHOLESKY_TPU_HBM_BYTES to its usable bytes")


def threshold(name: str) -> int:
    """The regime threshold `name` (a key of FRACTIONS) in bytes for the
    current device."""
    return int(FRACTIONS[name] * device_bytes())


def depth(dim: int, max_size: int = 64) -> int:
    """Tree depth so leaf blocks are at most `max_size` dofs (utils.py:6-8),
    clamped to >= 1 so small problems (dim <= max_size) still get a valid
    single-level plan instead of a zero/negative depth."""
    return max(1, int(math.ceil(math.log2(dim / max_size))) + 1)


def leaf_size(dim: int, levels: int) -> float:
    """Expected leaf dof count at a given depth (utils.py:10-12)."""
    return dim / (2 ** (levels - 1))


def subregions(levels: int) -> int:
    """Total separators in a complete tree of `levels` (utils.py:14-16)."""
    return (1 << levels) - 1


def plan_memory_bytes(plan, dtype_bytes: int = 4) -> int:
    """HBM footprint of the panel buffers for a SolvePlan."""
    total = 0
    for lvl in range(plan.levels):
        b, h, w = plan.panel_shape(lvl)
        total += b * h * w * dtype_bytes
    return total


def selinv_memory_bytes(fp, dtype_bytes: int = 4) -> int:
    """Peak HBM of selected inversion (numeric/selinv.py). Per step at
    level l the program holds: the parent blocks P_{l-1} [B/2, Fp, Fp],
    the output P_l [B, F, F] plus its pieces still live during the block
    concatenate (counted as a second P_l), and the one-hot transients
    G2 + M (each B·bnd·Fp elements). Deliberately conservative — XLA may
    free G2/M before the concatenate — because this backs the
    fail-with-numbers guard in api.inv_diag/inv_entries. selinv is in-core
    only."""
    p_bytes = [(1 << l) * fp.F[l] * fp.F[l] * dtype_bytes
               for l in range(fp.levels)]
    if len(p_bytes) == 1:
        return p_bytes[0]
    peaks = []
    for l in range(1, fp.levels):
        bnd = fp.F[l] - fp.W[l]
        onehot = 2 * (1 << l) * bnd * fp.F[l - 1] * dtype_bytes
        peaks.append(p_bytes[l - 1] + 2 * p_bytes[l] + onehot)
    return max(peaks)


def plan_flops(plan) -> float:
    """Dense-path factorization FLOPs (what the batched kernels execute,
    before cluster masking; unpadded sizes)."""
    t = plan.tree
    total = 0.0
    for lvl in range(plan.levels):
        for slot in range(1 << lvl):
            s = t.sep_at(lvl, slot)
            n_s = int(plan.sep_sizes[s])
            m = sum(int(plan.sep_sizes[a]) for a in t.ancestors(s))
            total += n_s ** 3 / 3 + m * n_s * n_s + (m * (m + 1) / 2) * n_s * 2
    return total


def frontal_flops(fp) -> float:
    """FLOPs the frontal engine's batched kernels EXECUTE on padded
    [B, F, W] front buckets (full-matmul counting — the Schur update runs
    as a plain dot, 2·K²·W): per level, B·(W³/3 + K·W² + 2·K²·W) with
    K = F − W. The ratio schedule_flops/frontal_flops is the engine's
    padding efficiency — how much of the executed work the reference's
    cluster-level op schedule (verify/schedule.py) would call useful.
    Bucket padding, sentinel rows, and exact-boundary-vs-cluster slack all
    land in the gap."""
    total = 0.0
    for lvl in range(fp.levels):
        b = 1 << lvl
        w = int(fp.W[lvl])
        k = int(fp.F[lvl]) - w
        total += b * (w ** 3 / 3 + k * w * w + 2.0 * k * k * w)
    return total


def padding_efficiency(fp, useful_flops: float) -> float:
    """useful (cluster-schedule) FLOPs / executed (padded frontal) FLOPs."""
    ex = frontal_flops(fp)
    return float(useful_flops / ex) if ex > 0 else 0.0


def grid_plan_table(shape: Tuple[int, ...], levels_range=None,
                    dtype_bytes: int = 4):
    """Tabulate depth choices for a grid problem: (levels, leaf_dofs,
    separators, panel_GiB, dense_GFLOP). The analogue of the reference's
    plotly figure (utils.py:21-62)."""
    from cholesky_tpu.symbolic.plan import build_plan
    from cholesky_tpu.utils.laplacian import nested_dissection

    dim = int(np.prod(shape))
    if levels_range is None:
        d = depth(dim)
        levels_range = range(max(2, d - 3), d + 2)
    rows = []
    for lv in levels_range:
        if (1 << (lv - 1)) > dim:
            break
        o, cl = nested_dissection(shape, lv)
        plan = build_plan(o, cl)
        rows.append({
            "levels": lv,
            "leaf_dofs": leaf_size(dim, lv),
            "separators": subregions(lv),
            "panel_gib": plan_memory_bytes(plan, dtype_bytes) / 2 ** 30,
            "dense_gflop": plan_flops(plan) / 1e9,
        })
    return rows


def main(argv=None):
    """CLI parity with running the reference's utils.py (its __main__ prints
    depths/leaf sizes/subregions for a 125,000-dof target and opens a plotly
    figure — plotly is gated here since this image lacks it)."""
    import argparse

    ap = argparse.ArgumentParser(description="nested-dissection capacity planner")
    ap.add_argument("shape", nargs="?", default="50,50,50",
                    help="grid shape, e.g. 50,50,50 (dim parity: 125000)")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split(","))
    rows = grid_plan_table(shape)
    hdr = f"{'levels':>6} {'leaf_dofs':>10} {'separators':>10} " \
          f"{'panel_GiB':>10} {'dense_GFLOP':>12}"
    print(hdr)
    for r in rows:
        print(f"{r['levels']:>6} {r['leaf_dofs']:>10.1f} "
              f"{r['separators']:>10} {r['panel_gib']:>10.3f} "
              f"{r['dense_gflop']:>12.1f}")
    try:  # optional: the reference's plotly figure when plotly exists
        import plotly.graph_objs as go
        from plotly.offline import plot

        traces = [
            go.Scatter(x=[r["levels"] for r in rows],
                       y=[r["leaf_dofs"] for r in rows],
                       mode="lines+markers", name="Depth vs Block Size"),
            go.Scatter(x=[r["levels"] for r in rows],
                       y=[r["separators"] for r in rows],
                       mode="lines+markers", name="Depth vs Num Subregions",
                       yaxis="y2"),
        ]
        layout = go.Layout(title=f"{shape} Laplacian Depth vs Block Size",
                           xaxis={"title": "Depth"},
                           yaxis={"title": "Block Size"},
                           yaxis2={"title": "Num Subregions",
                                   "overlaying": "y", "side": "right"})
        plot({"data": traces, "layout": layout})
    except ImportError:
        pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
