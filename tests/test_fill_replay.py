"""Fill-analysis + schedule + replay-oracle tests: the op-by-op debugging
contract of the reference (`-d` flag + verify.py:debug_factor)."""

import numpy as np
import pytest
import scipy.linalg

from cholesky_tpu import SparseCholesky
from cholesky_tpu.io import mmio
from cholesky_tpu.symbolic import fill as fillmod
from cholesky_tpu.symbolic.plan import permute_matrix_dense
from cholesky_tpu.verify import debuglog, replay, schedule
from tests.conftest import fixture_paths


def setup_fixture(name):
    p = fixture_paths(name)
    s = SparseCholesky.from_files(p["mat"], p["separators"], p["clusters"])
    fa = fillmod.analyze_fill(s.plan, s.rows, s.cols, s.vals)
    a = mmio.read_dense(p["mat"])
    pmat = permute_matrix_dense(s.plan, a)
    return s, fa, pmat


def test_fill_9x9_single_clusters():
    s, fa, _ = setup_fixture("lapl_9x9")
    # 2 levels -> 2 snapshots; every block is a single cluster (clust file
    # declares one interval, boundaries [0, size])
    assert len(fa.snapshots) == 2
    for snap in fa.snapshots:
        for bc in snap.values():
            assert bc.nr == 1 and bc.nc == 1
    # diagonal blocks are filled; off-diagonal leaf->root blocks are filled
    snap0 = fa.snapshots[0]
    assert snap0[(1, 1)].filled.all() and snap0[(3, 3)].filled.all()
    assert snap0[(3, 1)].filled.all() and snap0[(3, 2)].filled.all()


def test_fill_interval_schedule():
    s, fa, _ = setup_fixture("lapl_400x400")
    # levels=5: lvl4,lvl3 -> interval 0; lvl2 -> 1; lvl1 -> 2; lvl0 -> 3
    assert [fa.interval_for_level(l) for l in [4, 3, 2, 1, 0]] == [0, 0, 1, 2, 3]
    assert [fa.label_for_level(l) for l in [4, 3, 2, 1, 0]] == [0, 1, 2, 3, 4]


def test_fill_propagation_subset():
    """Filled flags only grow within a snapshot sequence after accounting for
    merges, and every structurally nonzero cluster is marked."""
    s, fa, pmat = setup_fixture("lapl_25x25")
    # snapshot at root level: root diag block must be fully filled by then
    root = s.plan.num_separators
    last = fa.snapshots[-1][(root, root)]
    assert last.filled.all()


@pytest.mark.parametrize("name", ["lapl_9x9", "lapl_25x25", "lapl_400x400"])
def test_replay_schedule_matches_scipy(name):
    s, fa, pmat = setup_fixture(name)
    ops = schedule.generate_schedule(fa)
    replayed = replay.replay_schedule(pmat, ops)
    lref = scipy.linalg.cholesky(pmat + np.tril(pmat, -1).T, lower=True)
    assert np.allclose(np.tril(replayed), lref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", ["lapl_25x25", "lapl_400x400"])
def test_replay_schedule_matches_fast_path(name):
    """The batched device path and the reference-schedule replay agree."""
    s, fa, pmat = setup_fixture(name)
    ops = schedule.generate_schedule(fa)
    replayed = np.tril(replay.replay_schedule(pmat, ops))
    fast = s.factor_dense()
    assert np.allclose(replayed, fast, rtol=1e-11, atol=1e-11)


def test_log_roundtrip(tmp_path):
    """Write a reference-format log, parse it back, replay it — identical
    factor. Proves log lines are parseable Python dicts with correct rects
    (the contract verify.py:26-29 eval_line relies on)."""
    s, fa, pmat = setup_fixture("lapl_25x25")
    ops = schedule.generate_schedule(fa)
    log = debuglog.write_structure_log(s.plan, str(tmp_path / "dbg"), fa, ops)
    blocks, clusters, parsed_ops = replay.parse_log(log)
    assert len(parsed_ops) == len(ops)
    assert len(blocks) > 0 and len(clusters) > 0
    replayed = replay.replay_log(pmat, log)
    lref = scipy.linalg.cholesky(pmat + np.tril(pmat, -1).T, lower=True)
    assert np.allclose(np.tril(replayed), lref, rtol=1e-10, atol=1e-10)


def test_log_line_formats():
    """Spot-check exact reference printf formats (blas.rg:308, mmat.rg:331)."""
    s, fa, _ = setup_fixture("lapl_9x9")
    ops = schedule.generate_schedule(fa)
    potrf = next(op for op in ops if op.kind == "POTRF")
    line = debuglog.format_op_line(potrf)
    assert line.startswith("POTRF: {'A': (")
    assert "'A_Lo': (" in line and "'SizeA': (" in line
    assert "'Level': " in line and "'Interval': " in line
    gemm = next(op for op in ops if op.kind in ("GEMM", "SYRK"))
    gline = debuglog.format_op_line(gemm)
    assert gline.startswith("GEMM: {")       # SYRK logs as GEMM (blas.rg:422)
    assert "'sizeA': (" in gline             # lowercase in GEMM lines
    blk = next(iter(debuglog.format_block_lines(s.plan)))
    assert blk.startswith("Block: {'Block': (")


def test_schedule_flops_positive():
    s, fa, _ = setup_fixture("lapl_400x400")
    ops = schedule.generate_schedule(fa)
    fl = schedule.schedule_flops(ops)
    assert fl > 0
    # root POTRF alone contributes n^3/3 with n = root separator size
    root_n = int(s.plan.sep_sizes[s.plan.num_separators])
    assert fl > root_n ** 3 / 3.0


def test_debug_factor_oracle(tmp_path):
    """End-to-end -d workflow: CLI-style debug log + per-op dumps, then the
    reference-semantics debug_factor oracle replays and bisects."""
    p = fixture_paths("lapl_25x25")
    s, fa, pmat = setup_fixture("lapl_25x25")
    ops = schedule.generate_schedule(fa)
    dbg = str(tmp_path / "dbg")
    log = debuglog.write_structure_log(s.plan, dbg, fa, ops)
    replay.replay_schedule(pmat, ops, dump_dir=dbg)
    # factored matrix file from the fast path
    from cholesky_tpu.io import mmio as mmio_mod

    fr, fc, fv = s.factor_coo()
    fac = str(tmp_path / "factored.mtx")
    mmio_mod.write_coo(fac, fr, fc, fv, (s.plan.n, s.plan.n))
    assert replay.debug_factor(p["mat"], p["separators"], fac, log,
                               directory=dbg)


def test_debug_factor_catches_corruption(tmp_path):
    """The oracle must FAIL when a dump is corrupted (bisection actually
    bisects)."""
    import os

    s, fa, pmat = setup_fixture("lapl_9x9")
    p = fixture_paths("lapl_9x9")
    ops = schedule.generate_schedule(fa)
    dbg = str(tmp_path / "dbg")
    log = debuglog.write_structure_log(s.plan, dbg, fa, ops)
    replay.replay_schedule(pmat, ops, dump_dir=dbg)
    # corrupt the first potrf dump
    victim = next(f for f in sorted(os.listdir(dbg)) if f.startswith("potrf"))
    path = os.path.join(dbg, victim)
    txt = open(path).read().splitlines()
    txt[-1] = txt[-1].rsplit(" ", 1)[0] + " 999.0"
    open(path, "w").write("\n".join(txt) + "\n")
    from cholesky_tpu.io import mmio as mmio_mod

    fr, fc, fv = s.factor_coo()
    fac = str(tmp_path / "factored.mtx")
    mmio_mod.write_coo(fac, fr, fc, fv, (s.plan.n, s.plan.n))
    with pytest.raises(AssertionError, match="diverges"):
        replay.debug_factor(p["mat"], p["separators"], fac, log,
                            directory=dbg)


def test_fill_lines_skip_eliminated_separators():
    """Interval label 1 must not emit Fill: lines for separators already
    eliminated at the deepest level (same filter as Cluster: lines)."""
    import re

    from cholesky_tpu.utils.laplacian import generate_problem

    n, r, c, v, o, cl, b = generate_problem((11, 11), 4)
    s = SparseCholesky.from_coo(n, r, c, v, o, cl)
    fa = fillmod.analyze_fill(s.plan, s.rows, s.cols, s.vals)
    t = s.plan.tree
    for line in debuglog.format_fill_lines(s.plan, fa):
        m = re.search(r"'Level': (\d+), 'Interval': (\d+), "
                      r"'Block': \((\d+), (\d+)\)", line)
        lvl, lbl, rs, cs = map(int, m.groups())
        assert t.level_of(cs) <= lvl, line
