"""Nested-dissection ordering (`*_ord_*.txt`) and cluster-hierarchy
(`*_clust_*.txt`) file parsers.

Equivalents of the reference's Legion-region readers
(reference: read_separators mnd.c:22-69, read_clusters mnd.c:71-150), producing
plain NumPy/host structures instead of writing into Legion physical regions.

File formats (reference fixtures, e.g. tests/lapl_25x25/):

  ord file:   line 0:  "<levels> <num_separators>"
              line k:  "<sep0>;<dof>,<dof>,...,"     sep ids are 0-based in the
              file and become 1-based in memory (mnd.c:50 `atoi(...)+1`).

  clust file: line 0:  "<levels> <num_separators>"
              line k:  "<sep0>;<b>,<b>,...,;<b>,...,;"  one ';'-group per
              interval; each group is the ascending boundary list of that
              interval's clusters. Interval 0 boundaries index the separator's
              dof list; interval i>0 boundaries index interval i-1's boundary
              list (see partition_separator, mmat.rg:400-422).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Ordering:
    """Separator ordering: which original dofs belong to each separator.

    Separators are numbered 1..num_separators; numbering is level-ordered with
    the deepest level first and the root last (the reference's
    build_separator_tree assigns node=num_separators to the root,
    mmat.rg:835-849).
    """

    levels: int
    num_separators: int
    dofs: Dict[int, np.ndarray]  # sep (1-based) -> original dof indices, file order

    @property
    def n(self) -> int:
        return sum(len(d) for d in self.dofs.values())

    def sizes(self) -> np.ndarray:
        """Separator sizes indexed 1..num_separators (index 0 unused)."""
        out = np.zeros(self.num_separators + 1, dtype=np.int64)
        for s, d in self.dofs.items():
            out[s] = len(d)
        return out


@dataclasses.dataclass
class ClusterHierarchy:
    """Per-separator hierarchical cluster boundaries.

    intervals[sep][i] is the boundary array of interval i for separator `sep`
    (1-based). A separator may define fewer intervals than `levels`; shallow
    separators only need intervals up to their own elimination step
    (merge_filled_clusters guards on empty intervals, mmat.rg:660).
    """

    levels: int
    num_separators: int
    intervals: Dict[int, List[np.ndarray]]

    def num_clusters(self, sep: int, interval: int) -> int:
        ivs = self.intervals.get(sep, [])
        if interval >= len(ivs):
            return 0
        return max(len(ivs[interval]) - 1, 0)

    def cluster_dof_ranges(self, sep: int, interval: int) -> np.ndarray:
        """Resolve interval-`interval` cluster boundaries down to dof indices
        within the separator (the reference's chain-chasing in
        partition_separator, mmat.rg:405-422). Returns the boundary array in
        dof units, shape [n_clusters+1]."""
        b = self.intervals[sep][interval]
        for i in range(interval - 1, -1, -1):
            b = self.intervals[sep][i][b]
        return b


def parse_ordering(path: str) -> Ordering:
    dofs: Dict[int, np.ndarray] = {}
    with open(path, "r") as f:
        first = f.readline().split()
        levels, num_separators = int(first[0]), int(first[1])
        for line in f:
            line = line.strip()
            if not line:
                continue
            sep_s, rest = line.split(";", 1)
            sep = int(sep_s) + 1
            toks = [t for t in rest.split(",") if t.strip() != ""]
            dofs[sep] = np.array([int(t) for t in toks], dtype=np.int64)
    return Ordering(levels, num_separators, dofs)


def parse_clusters(path: str) -> ClusterHierarchy:
    intervals: Dict[int, List[np.ndarray]] = {}
    with open(path, "r") as f:
        first = f.readline().split()
        levels, num_separators = int(first[0]), int(first[1])
        for line in f:
            line = line.strip()
            if not line:
                continue
            groups = line.split(";")
            sep = int(groups[0]) + 1
            ivs = []
            for g in groups[1:]:
                toks = [t for t in g.split(",") if t.strip() != ""]
                if not toks:
                    continue
                ivs.append(np.array([int(t) for t in toks], dtype=np.int64))
            intervals[sep] = ivs
    return ClusterHierarchy(levels, num_separators, intervals)


def write_ordering(path: str, ordering: Ordering) -> None:
    with open(path, "w") as f:
        f.write(f"{ordering.levels} {ordering.num_separators}\n")
        for sep in range(1, ordering.num_separators + 1):
            dof_s = ",".join(str(int(d)) for d in ordering.dofs[sep])
            f.write(f"{sep - 1};{dof_s},\n")


def write_clusters(path: str, clusters: ClusterHierarchy) -> None:
    with open(path, "w") as f:
        f.write(f"{clusters.levels} {clusters.num_separators}\n")
        for sep in range(1, clusters.num_separators + 1):
            groups = ";".join(
                ",".join(str(int(b)) for b in iv) + "," for iv in clusters.intervals[sep]
            )
            f.write(f"{sep - 1};{groups};\n")
