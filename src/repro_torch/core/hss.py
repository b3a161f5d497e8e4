"""Hierarchically Semi-Separable matrix container + telescoping apply.

Counterpart of ``repro.core.hss``.  Skeleton (interpolative) form, symmetric
kernel case (paper §3.1):

  - leaf diagonal blocks D_i = K(X_i, X_i)                       (dense, exact)
  - leaf bases U_i (m, r0): interpolation onto r0 skeleton points per leaf,
    U_i[skel rows] = I
  - per internal level k: transfer matrices P (2 r_{k-1}, r_k) stacking the
    children transfers, and skeleton indices (global point ids)
  - sibling couplings B at level k: B_p = K(X[skel_c1], X[skel_c2]).

Level indexing: k = 0 are the leaves, k = K = levels is the root; level k
has n_k = 2**(K-k) nodes.  Arrays are stacked over nodes per level, so every
operation is a batch of small dense products.  An adaptive-rank build
carries per-node rank vectors; ``shrink_to_fit`` slices each level down to
its largest observed rank.

Under a mesh (``repro_torch.dist.api``) each rank holds the nodes it owns
at the levels below ``cut`` and every node above it: ``mesh`` and ``cut``
record that, ``node_range`` reads it, and ``matmat`` runs its sweeps on the
rank's own nodes with one gather at the cut.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import api as dist_api


def rank_mask(ranks: torch.Tensor, cap: int, dtype=torch.float32) -> torch.Tensor:
    """(n,) per-node rank vector -> (n, cap) skeleton-liveness mask.

    1.0 on live slots (j < rank), 0.0 on truncated ones: the one definition
    of liveness that compression, ``HSSMatrix.rank_masks`` and the
    factorization share.
    """
    return (torch.arange(cap, device=ranks.device)[None, :]
            < ranks[:, None]).to(dtype)


@dataclasses.dataclass(frozen=True)
class HSSMatrix:
    """Symmetric HSS approximation of a kernel matrix over permuted points."""

    x: torch.Tensor           # (N, f)  permuted data points
    d_leaf: torch.Tensor      # (n_leaf, m, m)
    u_leaf: torch.Tensor      # (n_leaf, m, r0)
    skel_leaf: torch.Tensor   # (n_leaf, r0) int32 — global permuted-space indices
    transfers: tuple[torch.Tensor, ...]   # per k = 1..K-1: (n_k, 2 r_{k-1}, r_k)
    skels: tuple[torch.Tensor, ...]       # per k = 1..K-1: (n_k, r_k) int32
    b_mats: tuple[torch.Tensor, ...]      # per k = 1..K: (n_k, r_{k-1}, r_{k-1})
    levels: int
    leaf_size: int
    # Adaptive-rank builds only; None / () = fixed rank.  Columns ≥ rank of a
    # node's u_leaf/transfer block are exactly zero, as are the b_mats rows
    # and columns of its dead skeletons; shapes stay at the rank cap.
    leaf_ranks: torch.Tensor | None = None          # (n_leaf,) int32
    level_ranks: tuple[torch.Tensor, ...] = ()      # per k=1..K-1: (n_k,) int32
    # Node-split build (``compression.compress_sharded``): the mesh, and the
    # first replicated level (``dist.api.shard_levels``); the arrays of the
    # levels below it hold this rank's nodes only, ``x`` its leaves' points.
    mesh: object = None
    cut: int = 0

    @property
    def n(self) -> int:
        """Rows this rank holds (all of them without a mesh)."""
        return self.d_leaf.shape[0] * self.leaf_size

    @property
    def n_total(self) -> int:
        """Rows of the whole matrix."""
        return self.leaf_size << self.levels

    def node_range(self, k: int) -> tuple[int, int]:
        """[lo, hi) of the level-k nodes this rank holds."""
        n_k = 1 << (self.levels - k)
        if self.mesh is None or k >= self.cut:
            return 0, n_k
        return dist_api.owned_range(self.mesh, n_k)

    @property
    def n_leaves(self) -> int:
        return self.d_leaf.shape[0]

    @property
    def ranks(self) -> list[int]:
        """Per-level stored rank caps (array column counts), k = 0..K-1."""
        return [self.u_leaf.shape[-1]] + [t.shape[-1] for t in self.transfers]

    @property
    def adaptive(self) -> bool:
        return self.leaf_ranks is not None

    def observed_ranks(self) -> list[int]:
        """Per-level max numerical rank over the level's nodes (``ranks`` for
        a fixed-rank build).  One host transfer for all levels."""
        if not self.adaptive:
            return self.ranks
        maxima = torch.stack([r.max() for r in (self.leaf_ranks, *self.level_ranks)])
        # every rank must shrink to the same widths: the max over all ranks
        maxima = dist_api.all_reduce_max(maxima, self.mesh)
        return [int(r) for r in maxima.tolist()]

    def stored_rank_sum(self) -> int:
        """Σ_levels n_k · (stored rank cap): the paper's O(N r) storage in
        skeleton slots — decreases under ``shrink_to_fit``."""
        return sum(r << (self.levels - k) for k, r in enumerate(self.ranks))

    def rank_masks(self) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]] | None:
        """(leaf_mask (n_leaf, r0), level_masks[k-1] (n_k, r_k)), 1.0 on live
        skeleton slots and 0.0 on truncated ones; None for fixed rank."""
        if not self.adaptive:
            return None
        dtype = self.u_leaf.dtype
        leaf = rank_mask(self.leaf_ranks, self.u_leaf.shape[-1], dtype)
        lvls = tuple(rank_mask(r, t.shape[-1], dtype)
                     for r, t in zip(self.level_ranks, self.transfers))
        return leaf, lvls

    def to(self, device) -> "HSSMatrix":
        """The same matrix with every tensor on ``device``."""
        def mv(v):
            if isinstance(v, tuple):
                return tuple(t.to(device) for t in v)
            return v.to(device) if isinstance(v, torch.Tensor) else v
        return dataclasses.replace(self, **{f.name: mv(getattr(self, f.name))
                                            for f in dataclasses.fields(self)})

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K̃ @ v in O(N r) — single-RHS view of ``matmat``."""
        return self.matmat(v[:, None])[:, 0]

    def matmat(self, v: torch.Tensor) -> torch.Tensor:
        """K̃ @ V for V (N, c) — one telescoping sweep over the RHS block.

        Under a mesh ``v`` and the result are this rank's rows: the upward
        sweep runs on the rank's nodes up to the cut, gathers that level's
        skeleton coordinates once, runs the upper levels replicated, and the
        downward sweep keeps the rank's nodes again below the cut.
        """
        K = self.levels
        n_leaf, m = self.n_leaves, self.leaf_size
        c = v.shape[1]
        vl = v.reshape(n_leaf, m, c)
        diag = self.d_leaf @ vl
        if K == 0:
            return diag.reshape(-1, c)
        mesh, cut = self.mesh, self.cut

        # Upward: project into skeleton coordinates at every level.
        vt = [self.u_leaf.transpose(1, 2) @ vl]              # (n_leaf, r0, c)
        for k in range(1, K + 1):
            if mesh is not None and k == cut:                 # the one gather
                vt[k - 1] = dist_api.all_gather_nodes(vt[k - 1], mesh)
            if k == K:
                break
            t = self.transfers[k - 1]                         # (n_k, 2 r_{k-1}, r_k)
            prev = vt[-1].reshape(t.shape[0], t.shape[1], c)  # pair children
            vt.append(t.transpose(1, 2) @ prev)

        # Downward: accumulate incoming far field per node, top level first.
        w = None
        for k in range(K, 0, -1):
            b = self.b_mats[k - 1]                            # (n_k, r, r)
            pair = vt[k - 1].reshape(b.shape[0], 2, b.shape[1], c)
            coup = torch.stack([b @ pair[:, 1], b.transpose(1, 2) @ pair[:, 0]],
                               dim=1)                         # (n_k, 2, r, c)
            if w is not None:
                down = self.transfers[k - 1] @ w
                coup = coup + down.reshape(coup.shape)
            w = coup.reshape(-1, coup.shape[-2], c)           # (n_{k-1}, r, c)
            if mesh is not None and k == cut:                 # back to own nodes
                w = dist_api.local_rows(w, mesh)

        out = diag + self.u_leaf @ w
        return out.reshape(-1, c)

    def todense(self) -> torch.Tensor:
        """Dense reconstruction (tests and small problems only; no mesh)."""
        if self.mesh is not None:
            raise ValueError("todense needs the whole matrix on one rank")
        K = self.levels
        n_leaf, m = self.n_leaves, self.leaf_size
        out = torch.zeros((self.n, self.n), dtype=self.d_leaf.dtype,
                          device=self.d_leaf.device)
        for i in range(n_leaf):
            out[i * m:(i + 1) * m, i * m:(i + 1) * m] = self.d_leaf[i]
        ubig = [self.u_leaf[i] for i in range(n_leaf)]
        for k in range(1, K + 1):
            b = self.b_mats[k - 1]
            width = m * 2 ** (k - 1)
            for p in range(b.shape[0]):
                blk = ubig[2 * p] @ b[p] @ ubig[2 * p + 1].T
                r0, c0 = 2 * p * width, (2 * p + 1) * width
                out[r0:r0 + width, c0:c0 + width] = blk
                out[c0:c0 + width, r0:r0 + width] = blk.T
            if k < K:
                t = self.transfers[k - 1]
                rc = t.shape[1] // 2
                ubig = [torch.cat([ubig[2 * p] @ t[p, :rc], ubig[2 * p + 1] @ t[p, rc:]])
                        for p in range(b.shape[0])]
        return out

    def memory_bytes(self) -> int:
        """Storage of the representation (the paper's 'Memory [MB]' column),
        rank vectors included; under a mesh, this rank's."""
        arrays = (self.d_leaf, self.u_leaf, self.skel_leaf,
                  *self.transfers, *self.skels, *self.b_mats)
        if self.adaptive:
            arrays += (self.leaf_ranks, *self.level_ranks)
        return sum(a.numel() * a.element_size() for a in arrays)


def shard(hss: HSSMatrix, mesh, cut: int | None = None) -> HSSMatrix:
    """This rank's part of a whole HSS matrix: the nodes it owns at the
    levels below ``cut`` (``dist.api.shard_levels`` by default), every node
    above.  A node-split build (``compression.compress_sharded``) returns
    exactly this."""
    K = hss.levels
    if hss.mesh is not None:
        raise ValueError("the matrix is already split over a mesh")
    cut = dist_api.shard_levels(mesh, K) if cut is None else cut
    if cut == 0:
        return hss

    def own(a, k):
        return dist_api.local_rows(a, mesh) if k < cut else a

    lo, hi = dist_api.owned_range(mesh, hss.n_leaves)
    return dataclasses.replace(
        hss, x=hss.x[lo * hss.leaf_size:hi * hss.leaf_size],
        d_leaf=own(hss.d_leaf, 0), u_leaf=own(hss.u_leaf, 0),
        skel_leaf=own(hss.skel_leaf, 0),
        transfers=tuple(own(t, k) for k, t in enumerate(hss.transfers, 1)),
        skels=tuple(own(t, k) for k, t in enumerate(hss.skels, 1)),
        b_mats=tuple(own(b, k) for k, b in enumerate(hss.b_mats, 1)),
        leaf_ranks=None if hss.leaf_ranks is None else own(hss.leaf_ranks, 0),
        level_ranks=tuple(own(r, k) for k, r in enumerate(hss.level_ranks, 1)),
        mesh=mesh, cut=cut)


def shrink_to_fit(hss: HSSMatrix, multiple: int = 1) -> HSSMatrix:
    """Slice every level's stacked arrays down to the level's max observed rank.

    Exact, not approximate: every sliced-away slot is structurally zero
    (dead u/transfer columns, dead b_mats rows and columns).  ``multiple``
    rounds each new cap up.  The slices are copied, so the full-cap arrays
    can be freed.  Fixed-rank builds come back unchanged.  Under a mesh the
    observed ranks are the max over all ranks, so every rank cuts the same
    widths.
    """
    if not hss.adaptive:
        return hss
    caps = hss.ranks
    new_caps = [min(cap, max(1, -(-obs // multiple) * multiple))
                for cap, obs in zip(caps, hss.observed_ranks())]
    if new_caps == caps:
        return hss
    transfers, skels, b_mats = [], [], []
    for k in range(1, hss.levels + 1):
        rc = new_caps[k - 1]                     # child-level cap
        b_mats.append(hss.b_mats[k - 1][:, :rc, :rc].contiguous())
        if k == hss.levels:
            break
        rk = new_caps[k]
        t = hss.transfers[k - 1]
        n_k, two_rc_old = t.shape[0], t.shape[1]
        t = t.reshape(n_k, 2, two_rc_old // 2, t.shape[2])[:, :, :rc, :rk]
        transfers.append(t.reshape(n_k, 2 * rc, rk))
        skels.append(hss.skels[k - 1][:, :rk].contiguous())
    r0 = new_caps[0]
    return dataclasses.replace(
        hss, u_leaf=hss.u_leaf[:, :, :r0].contiguous(),
        skel_leaf=hss.skel_leaf[:, :r0].contiguous(),
        transfers=tuple(transfers), skels=tuple(skels), b_mats=tuple(b_mats))


def inert_pads(hss: HSSMatrix, real: torch.Tensor) -> HSSMatrix:
    """K̃ with its pad block set to what it is in exact arithmetic: I.

    Pads (``tree.pad_dataset``) sit 1e3·diam and more from every point and
    from each other, so their kernel entries are 0 off the diagonal and 1 on
    it.  In f32 the expanded squared distance of two pads ~1e7·diam out is
    cancellation noise, and their Gaussian entry comes out anywhere in
    [0, 1]: harmless under the SVM's β of 1e2–1e4, but under KRR/GP's λ of
    ~1 it leaves K̃ + λI indefinite (the factorization's leaf Cholesky
    fails; the reference's returns NaN).  Zeroes every pad-pad entry of the
    leaf blocks D and the couplings B, then puts 1 on the pads' diagonal;
    with few pads (no cancellation) it changes nothing.  ``real`` is the
    (N,) real-point mask in tree order, all N rows under a mesh too.
    """
    pad = ~real.to(torch.bool)
    lo, hi = hss.node_range(0)
    pl = pad[lo * hss.leaf_size:hi * hss.leaf_size].reshape(hss.n_leaves, hss.leaf_size)
    d_leaf = (hss.d_leaf.masked_fill(pl[:, :, None] & pl[:, None, :], 0.0)
              + torch.diag_embed(pl.to(hss.d_leaf.dtype)))
    skels = (hss.skel_leaf, *hss.skels)       # level k's skeletons, k = 0..K-1
    b_mats = []
    for k, b in enumerate(hss.b_mats):        # the couplings of level k's sibling pairs
        s = skels[k]
        if hss.mesh is not None and k + 1 == hss.cut:    # B replicated, skeletons split
            s = dist_api.all_gather_nodes(s, hss.mesh)
        sp = pad[s.long()].reshape(b.shape[0], 2, -1)
        b_mats.append(b.masked_fill(sp[:, 0, :, None] & sp[:, 1, None, :], 0.0))
    return dataclasses.replace(hss, d_leaf=d_leaf, b_mats=tuple(b_mats))


def shrink_report(hss: HSSMatrix) -> tuple[HSSMatrix, dict]:
    """``shrink_to_fit`` plus the rank fields of ``FitReport``
    (ranks_pre/ranks_post/rank_sum_pre/rank_sum_post)."""
    info = dict(ranks_pre=tuple(hss.ranks), rank_sum_pre=hss.stored_rank_sum())
    hss = shrink_to_fit(hss)
    info.update(ranks_post=tuple(hss.ranks), rank_sum_post=hss.stored_rank_sum())
    return hss, info
