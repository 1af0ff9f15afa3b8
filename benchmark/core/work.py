"""The least work of each measured piece, counted from shapes and from
the rows each level really holds, and the least time the card's peaks
allow for it. Rooflines and `mfu` shares divide these least times by
measured time, so every reader counts the same work whatever implements
it.

Each count is (bytes, float adds, int32 operations); `least_s` takes the
larger of the bytes over the memory bandwidth and the operations over
their rates (float adds at half the FMA rate, int32 compares at the
int32 rate), as `peaks/*.json` give them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    f32_adds: float = 0.0
    int32_ops: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.bytes + o.bytes, self.f32_adds + o.f32_adds,
                    self.int32_ops + o.int32_ops)

    def scaled(self, k: float) -> "Work":
        return Work(self.bytes * k, self.f32_adds * k, self.int32_ops * k)


def least_s(w: Work, peaks: dict) -> float:
    ops_s = (w.f32_adds / peaks["f32_adds_per_s"]
             + w.int32_ops / peaks["int32_ops_per_s"])
    return max(w.bytes / peaks["hbm_bytes_per_s"], ops_s)


def built_rows(level_rows: list) -> list:
    """Per level below the leaves: (rows, nodes) whose histograms the
    algorithm needs built. The root's rows at level 0; below it, the
    smaller child of each split, the least that sibling subtraction
    needs (a child of an unsplit parent holds no rows)."""
    out = [(int(level_rows[0].sum()), 1)]
    for c in level_rows[1:-1]:
        pairs = np.asarray(c, np.int64).reshape(-1, 2)
        split = pairs.min(1) > 0
        out.append((int(pairs.min(1).sum()), int(split.sum())))
    return out


def hist_work(levels: list, n_features: int, n_bins: int) -> Work:
    """K1's least work for one tree: each built row's node index (4 B),
    its F bin bytes, g and h (4 B each) read once; each built node's
    f32 (g, h) sums of every (feature, bin) written once; two adds a
    (row, feature)."""
    w = Work()
    for rows, nodes in levels:
        w += Work(bytes=rows * (4 + n_features + 8)
                  + nodes * n_features * n_bins * 8,
                  f32_adds=2.0 * rows * n_features)
    return w


def round_rest_work(n_rows: int, n_classes: int, max_depth: int) -> Work:
    """A round's least work outside the histograms: at each level one read
    of each row's node index (4 B) and split-feature bin (1 B) and one
    write of its new index (4 B), per tree; once a round the labels (4 B),
    and the margins, g and h (4 B each, per class)."""
    per_tree = Work(bytes=max_depth * n_rows * 9.0)
    return per_tree.scaled(n_classes) + Work(
        bytes=n_rows * (4 + 12.0 * n_classes))


def traverse_work(n_rows: int, n_features: int, n_trees: int,
                  n_nodes: int, compares: float) -> Work:
    """K3's least work for a batch: the binned rows (1 B a value), the
    trees (feature, threshold, leaf value: 12 B a node) and the margins
    (4 B a row) moved once; `compares` int32 compares on the rows' real
    paths and one f32 add a (row, tree)."""
    return Work(bytes=n_rows * n_features + n_trees * n_nodes * 12.0
                + n_rows * 4.0,
                f32_adds=float(n_rows) * n_trees, int32_ops=compares)


def binning_work(n_rows: int, n_features: int, n_bins: int) -> Work:
    """Binning on the card: f32 rows in, uint8 bins out, the edges read
    once."""
    return Work(bytes=n_rows * n_features * 5.0
                + n_features * (n_bins - 1) * 4.0)
