"""Cluster tree for HSS compression (host numpy; a copy of repro.core.tree).

The paper relies on STRUMPACK's geometry-aware preprocessing (recursive
clustering + approximate-nearest-neighbour sampling).  TPU adaptation
(DESIGN.md §3.2): a *perfect* binary tree built by recursive
widest-dimension median bisection so that every leaf holds exactly
``leaf_size`` points — all downstream HSS arrays then have static shapes and
every per-level operation is a batched dense op.

The tree is built once per dataset on the host (numpy); everything after is
torch.  Datasets whose size is not ``leaf_size * 2**levels`` are padded with
*inert* far-away points (see ``pad_dataset``): their kernel rows are ~0, the
SVM box constraint pins their dual variables to 0, so the padded problem's
solution restricted to real points equals the original one (core/svm.py).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterTree:
    """A perfect binary partition of ``n`` points.

    perm[i]   — original index of the i-th point in tree (leaf-major) order.
    levels    — number of binary splits; n_leaves == 2**levels.
    leaf_size — points per leaf; n == leaf_size * n_leaves.
    """

    perm: np.ndarray
    levels: int
    leaf_size: int

    @property
    def n(self) -> int:
        return self.perm.shape[0]

    @property
    def n_leaves(self) -> int:
        return 2 ** self.levels

    def inverse_perm(self) -> np.ndarray:
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(self.n)
        return inv


def _split_once(x: np.ndarray, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split ``idx`` into two equal halves along the widest coordinate."""
    pts = x[idx]
    widths = pts.max(axis=0) - pts.min(axis=0)
    dim = int(np.argmax(widths))
    order = np.argsort(pts[:, dim], kind="stable")
    half = idx.shape[0] // 2
    return idx[order[:half]], idx[order[half:]]


def build_tree(x: np.ndarray, leaf_size: int = 256, levels: int | None = None) -> ClusterTree:
    """Recursive median-bisection tree. ``len(x)`` must be leaf_size * 2**levels."""
    n = x.shape[0]
    if levels is None:
        levels = max(int(round(math.log2(n / leaf_size))), 0)
    if n != leaf_size * 2 ** levels:
        raise ValueError(
            f"n={n} != leaf_size*2**levels={leaf_size * 2 ** levels}; pad first "
            "(see pad_dataset)"
        )
    groups = [np.arange(n)]
    for _ in range(levels):
        nxt = []
        for g in groups:
            a, b = _split_once(x, g)
            nxt.extend((a, b))
        groups = nxt
    perm = np.concatenate(groups) if groups else np.arange(n)
    return ClusterTree(perm=perm, levels=levels, leaf_size=leaf_size)


def padded_size(n: int, leaf_size: int) -> tuple[int, int]:
    """Smallest (n_padded, levels) with n_padded = leaf_size*2**levels >= n."""
    levels = max(math.ceil(math.log2(max(n, 1) / leaf_size)), 0)
    while leaf_size * 2 ** levels < n:
        levels += 1
    return leaf_size * 2 ** levels, levels


def pad_dataset(
    x: np.ndarray, y: np.ndarray, leaf_size: int, min_levels: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad (x, y) with mutually-far inert points to a perfect-tree size.

    Pads are placed along the first feature axis with spacing ~1e3x the data
    diameter, so every Gaussian kernel value involving a pad (including
    pad-pad for distinct pads) underflows to ~0 and the padded kernel matrix
    is blockdiag(K_real, ~I).  Returns (x_pad, y_pad, real_mask, levels).

    ``min_levels`` forces at least that many splits — the mesh-parallel
    build (core.engine) uses it to guarantee the leaf count divides the
    device count, at the cost of a few more inert leaves.
    """
    n = x.shape[0]
    n_pad_total, levels = padded_size(n, leaf_size)
    if min_levels > levels:
        levels = min_levels
        n_pad_total = leaf_size * 2 ** levels
    n_extra = n_pad_total - n
    if n_extra == 0:
        return x, y, np.ones(n, dtype=bool), levels
    lo, hi = x.min(axis=0), x.max(axis=0)
    diam = float(np.linalg.norm(hi - lo)) or 1.0
    pads = np.tile(hi[None, :], (n_extra, 1))
    pads[:, 0] = hi[0] + diam * 1e3 * (1.0 + np.arange(n_extra))
    x_out = np.concatenate([x, pads.astype(x.dtype)], axis=0)
    y_out = np.concatenate([y, np.ones(n_extra, dtype=y.dtype)], axis=0)
    mask = np.concatenate([np.ones(n, dtype=bool), np.zeros(n_extra, dtype=bool)])
    return x_out, y_out, mask, levels


def leaf_slices(tree: ClusterTree) -> list[slice]:
    m = tree.leaf_size
    return [slice(i * m, (i + 1) * m) for i in range(tree.n_leaves)]


def node_span(tree: ClusterTree, level_from_leaf: int, node: int) -> slice:
    """Half-open slice of permuted indices covered by ``node`` at a level.

    level_from_leaf = 0 — leaves; == tree.levels — the root.
    """
    width = tree.leaf_size * 2 ** level_from_leaf
    return slice(node * width, (node + 1) * width)
