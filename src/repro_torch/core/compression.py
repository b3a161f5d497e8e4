"""HSS-ANN-style compression of a kernel matrix, partially matrix-free.

Counterpart of ``repro.core.compression`` (the resident, single-device
``compress``, fixed or adaptive rank).  Paper §3.1 / Chávez et al. IPDPS'20:

  * proxy columns per node = NEAR points (KD-tree neighbours of a leaf; the
    sibling's candidate skeletons above) + FAR points (uniform sample of the
    complement) — index sets built once on the host with numpy/scipy, drawn
    from ``np.random.default_rng(params.seed)`` exactly as the JAX package
    draws them, so both packages pick the same proxies;
  * skeleton selection per node = interpolative decomposition via pivoted QR
    on the sampled block, one batched launch per tree level (kernel K2);
  * total kernel evaluations O(N · n_proxy) — never the full matrix;
  * with ``CompressionParams.rtol`` set, each node's numerical rank is
    detected from the pivoted-QR diagonal decay; the arrays keep the rank
    cap's shape and the truncated slots are exact zeros.

``compress_sharded`` is the mesh-parallel build (each rank builds the
nodes it owns, ``repro_torch.dist.api``), and ``compress_streamed`` is the out-of-core build (``repro``'s counterpart of
the same name): the data stay on the host, the device sees one batch of
nodes at a time, and each completed level can be checkpointed and resumed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.hss import HSSMatrix, rank_mask
from repro_torch.core.kernelfn import KernelSpec, kernel_block
from repro_torch.core.tree import ClusterTree
from repro_torch.kernels.compress import ops as cops

# Counting-kernel instrumentation state (see ``counting_kernel_evals``).
_EVAL_STATE: dict | None = None


@contextlib.contextmanager
def counting_kernel_evals():
    """Count the kernel entries a ``compress`` call evaluates.

    Every kernel evaluation of the build flows through the two seams below
    (``_batched_kernel_block`` / ``_batched_row_id``), which add the logical
    block sizes to this counter.  Yields a dict whose ``"count"`` entry is
    the running total, pinned against ``kernel_eval_count`` by the tests.
    """
    global _EVAL_STATE
    prev = _EVAL_STATE
    _EVAL_STATE = {"count": 0}
    try:
        yield _EVAL_STATE
    finally:
        _EVAL_STATE = prev


def _note_evals(count: int) -> None:
    if _EVAL_STATE is not None:
        _EVAL_STATE["count"] += count


def _batched_kernel_block(spec: KernelSpec, xa: torch.Tensor,
                          xb: torch.Tensor) -> torch.Tensor:
    """``kernel_block`` over (B, ·, f) stacks, one kernel call — the eval-count seam."""
    _note_evals(xa.shape[0] * xa.shape[1] * xb.shape[1])
    return kernel_block(spec, xa, xb)


def _batched_row_id(spec: KernelSpec, xc: torch.Tensor, xp: torch.Tensor, k: int,
                    rtol: float | None, adaptive: bool,
                    cmask: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All row IDs of one tree level through the fused assemble+ID wrapper.

    xc (B, m, f) candidate points, xp (B, s, f) proxy points, cmask (B, m)
    candidate liveness.  Returns (piv (B, k) int32, p_mat (B, m, k), ranks
    (B,) int32).  On the card the sampled blocks K(xc_i, xp_i) live only in
    shared memory; on the CPU the wrapper runs the plain assemble +
    ``cpqr_select`` + ``finish_interp``.
    """
    _note_evals(xc.shape[0] * xc.shape[1] * xp.shape[1])
    return cops.batched_assemble_id(
        xc, xp, k, h=spec.h, rtol=1e-5 if rtol is None else rtol,
        kernel_name=spec.name, adaptive=adaptive, cmask=cmask)


@dataclasses.dataclass(frozen=True)
class CompressionParams:
    """Accuracy knobs, analogous to the paper's STRUMPACK parameters.

    rtol    ~ rel_tol (Table 4 "crude": 1e-2, Table 5 "accurate": 1e-4).
              None = fixed rank: every node stores ``rank`` columns.  A float
              switches on the adaptive build: each node's numerical rank is
              detected against rtol, truncated columns are exact zeros, and
              ``hss.shrink_to_fit`` slices each level to its largest rank.
    rank    ~ hss_max_rank (per level): the rank itself, or its cap with rtol
    n_near  ~ hss_approximate_neighbors
    n_far   — far-field proxy sample size
    """

    rank: int = 32
    n_near: int = 32
    n_far: int = 32
    seed: int = 0
    rtol: float | None = None

    @property
    def n_proxy(self) -> int:
        return self.n_near + self.n_far

    @classmethod
    def crude(cls, **kw) -> "CompressionParams":
        """Paper Table 4 regime: loose tolerance, small cap/neighbourhoods."""
        return cls(**{**dict(rank=32, n_near=32, n_far=32, rtol=1e-2), **kw})

    @classmethod
    def accurate(cls, **kw) -> "CompressionParams":
        """Paper Table 5 regime: tight tolerance, larger cap/neighbourhoods."""
        return cls(**{**dict(rank=64, n_near=64, n_far=128, rtol=1e-4), **kw})


def kernel_eval_count(tree: ClusterTree, params: CompressionParams) -> int:
    """Exact number of kernel entries ``compress`` evaluates for this tree:
    leaf diagonal blocks + leaf sampled blocks + per-level candidate×proxy
    blocks + B couplings."""
    m, K = tree.leaf_size, tree.levels
    n_leaf = 2 ** K
    r0 = min(params.rank, m)
    total = n_leaf * (m * m + m * params.n_proxy)
    r_prev = r0
    for k in range(1, K + 1):
        n_k = 2 ** (K - k)
        total += n_k * r_prev * r_prev                  # sibling couplings B
        if k == K:
            break
        total += n_k * (2 * r_prev) * (2 * r_prev + params.n_far)
        r_prev = min(params.rank, 2 * r_prev)
    return total


def _cand_mask(ranks: torch.Tensor, rp: int, dtype) -> torch.Tensor:
    """(2·n,) child rank vector -> (n, 2·rp) candidate-slot liveness: the two
    children's ``rank_mask`` rows side by side, one row per parent."""
    return rank_mask(ranks, rp, dtype).reshape(-1, 2 * rp)


def _mask_b(b: torch.Tensor, cm: torch.Tensor, rp: int) -> torch.Tensor:
    """Zero B rows/columns of dead child skeletons (exact structural zeros)."""
    return b * cm[:, :rp, None] * cm[:, rp:][:, None, :]


def _complement_sample(
    rng: np.random.Generator, n: int, span_start: int, span_width: int, count: int
) -> np.ndarray:
    """Uniform sample of indices in [0, n) \\ [span_start, span_start+width)."""
    u = rng.integers(0, n - span_width, size=count)
    return np.where(u < span_start, u, u + span_width).astype(np.int32)


def _host_proxy_indices(
    tree: ClusterTree, params: CompressionParams
) -> list[np.ndarray]:
    """Per-level FAR proxy index arrays: far[k] has shape (n_k, n_far)."""
    rng = np.random.default_rng(params.seed)
    n, m, K = tree.n, tree.leaf_size, tree.levels
    out = []
    for k in range(K):  # levels 0..K-1 need bases/skeletons
        n_k = 2 ** (K - k)
        width = m * 2 ** k
        rows = [
            _complement_sample(rng, n, node * width, width, params.n_far)
            for node in range(n_k)
        ]
        out.append(np.stack(rows, axis=0))
    return out


def _host_leaf_near(
    tree: ClusterTree, params: CompressionParams, x_perm: np.ndarray | None = None,
    mesh=None,
) -> np.ndarray:
    """(n_leaf, n_near) NEAR-proxy indices per leaf.

    The paper's HSS-ANN strategy: the dominant entries of a leaf's
    off-diagonal block row correspond to its points' nearest neighbours in
    *other* clusters.  With data available we find them with a KD-tree
    (scipy) — the exact analogue of STRUMPACK's ANN preprocessing; without
    data we fall back to sampling the sibling leaf (tree-adjacent ≈ near).

    With ``mesh`` the rows are those of the rank's own leaves
    (``dist.api.owned_range``), equal to the same rows of the whole array:
    the KD-tree spans every point but is queried for the rank's points
    only, and the few deficit rows (candidate pool below n_near) of all
    ranks are gathered, so that every rank replays the one seeded top-up
    draw in leaf order.
    """
    from repro_torch.dist import api as dist_api

    rng = np.random.default_rng(params.seed + 1)
    m, K = tree.leaf_size, tree.levels
    n_leaf = 2 ** K
    lo, hi = dist_api.owned_range(mesh, n_leaf)
    out = np.empty((hi - lo, params.n_near), dtype=np.int32)
    if x_perm is not None and n_leaf > 1:
        from scipy.spatial import cKDTree

        x_f32 = np.asarray(x_perm, np.float32)
        kdt = cKDTree(x_f32)
        k_query = min(max(2 * params.n_near // m + 4, 4), tree.n)
        x_own = x_f32[lo * m:hi * m]
        _, nbr = kdt.query(x_own, k=k_query, workers=-1)   # (n, k) incl. self; all cores
        leaf_of = np.arange(tree.n) // m
        # Vectorized over all leaves: each leaf's candidate pool is its
        # points' neighbour lists, flattened.
        cand = nbr.reshape(hi - lo, m * k_query).astype(np.int64)
        own = leaf_of[cand] == np.arange(lo, hi)[:, None]   # in-leaf -> drop
        # Duplicate suppression: sort ids per row, mark repeats, scatter the
        # mask back to original positions.
        order = np.argsort(cand, axis=1, kind="stable")
        sorted_ids = np.take_along_axis(cand, order, axis=1)
        dup_sorted = np.zeros_like(own)
        dup_sorted[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
        dup = np.zeros_like(own)
        np.put_along_axis(dup, order, dup_sorted, axis=1)
        invalid = own | dup
        # Rank candidates by distance to the leaf centroid; invalid -> +inf.
        centroid = x_own.reshape(hi - lo, m, -1).mean(axis=1)
        dist = np.linalg.norm(
            x_f32[cand] - centroid[:, None, :], axis=2)
        dist[invalid] = np.inf
        pick = np.argsort(dist, axis=1, kind="stable")[:, : params.n_near]
        out[:] = np.take_along_axis(cand, pick, axis=1)
        # Deficit rows (candidate pool smaller than n_near — tiny problems
        # only): top up from the sibling leaf, excluding candidates already
        # placed; repeats only once the whole sibling leaf is exhausted.
        counts = (~invalid).sum(axis=1)
        short_rows = np.nonzero(counts < params.n_near)[0]
        rows = np.concatenate([(short_rows + lo)[:, None], counts[short_rows, None],
                               out[short_rows]], axis=1).astype(np.int64)
        if mesh is not None:
            rows = _gather_host_rows(rows, mesh)
        for i, c, *placed in rows.tolist():
            short = params.n_near - c
            sib = i ^ 1
            pool = np.setdiff1d(
                np.arange(m, dtype=np.int64) + sib * m, placed[:c])
            if len(pool) >= short:
                fill = rng.choice(pool, size=short, replace=False)
            else:
                extra = rng.choice(m, size=short - len(pool)) + sib * m
                fill = np.concatenate([pool, extra])
            if lo <= i < hi:
                out[i - lo, c:] = fill
        return out
    for i in range(n_leaf):
        sib = i ^ 1
        row = rng.choice(m, size=params.n_near, replace=params.n_near > m) + sib * m
        if lo <= i < hi:
            out[i - lo] = row
    return out


def _gather_host_rows(rows: np.ndarray, mesh) -> np.ndarray:
    """Every rank's (n_r, w) int64 host rows, stacked in rank order (the
    counts differ by rank: one sum of the counts, one gather of the rows
    padded to the largest)."""
    from repro_torch.dist import api as dist_api

    counts = np.zeros(mesh.size, np.int64)
    counts[mesh.rank] = rows.shape[0]
    counts = dist_api.all_reduce_sum(torch.as_tensor(counts), mesh).numpy()
    width, most = rows.shape[1], int(counts.max())
    if most == 0:
        return rows
    padded = np.zeros((most, width), np.int64)
    padded[:rows.shape[0]] = rows
    every = dist_api.all_gather_nodes(torch.as_tensor(padded), mesh).numpy()
    return np.concatenate([every[r * most:r * most + counts[r]]
                           for r in range(mesh.size)])


def compress(
    x_perm: np.ndarray | torch.Tensor,
    tree: ClusterTree,
    spec: KernelSpec,
    params: CompressionParams = CompressionParams(),
    device: str | torch.device = "cuda",
) -> HSSMatrix:
    """Build the HSS approximation of K(x_perm, x_perm).

    ``x_perm`` must already be in tree (leaf-major) order.  A host numpy
    array is moved to ``device``; a tensor stays where it is.  The host copy
    feeds the proxy preprocessing either way.
    """
    n, m, K = tree.n, tree.leaf_size, tree.levels
    n_leaf = 2 ** K
    if x_perm.shape[0] != n:
        raise ValueError(f"x has {x_perm.shape[0]} rows, tree expects {n}")
    r0 = min(params.rank, m)
    adaptive, rtol = params.rtol is not None, params.rtol

    if isinstance(x_perm, np.ndarray):
        x_host = x_perm
        x_perm = torch.as_tensor(x_host, device=device)
    else:
        x_host = x_perm.cpu().numpy()
    dev = x_perm.device
    far_idx = [torch.as_tensor(a, device=dev).long()
               for a in _host_proxy_indices(tree, params)]
    leaf_near = torch.as_tensor(_host_leaf_near(tree, params, x_host),
                                device=dev).long()

    x_leaves = x_perm.reshape(n_leaf, m, -1)

    # ---------------- leaves ---------------- #
    d_leaf = _batched_kernel_block(spec, x_leaves, x_leaves)

    prox0 = torch.cat([leaf_near, far_idx[0]], dim=1)
    piv0, u_leaf, leaf_ranks = _batched_row_id(
        spec, x_leaves, x_perm[prox0], r0, rtol, adaptive)
    leaf_starts = torch.arange(n_leaf, dtype=torch.int32, device=dev) * m
    skel_leaf = leaf_starts[:, None] + piv0

    # ---------------- internal levels ---------------- #
    transfers: list[torch.Tensor] = []
    skels: list[torch.Tensor] = []
    b_mats: list[torch.Tensor] = []
    level_ranks: list[torch.Tensor] = []
    skel_prev = skel_leaf                     # (n_{k-1}, r_{k-1})
    rank_prev = leaf_ranks                    # (n_{k-1},) numerical ranks
    r_prev = r0
    for k in range(1, K + 1):
        n_k = 2 ** (K - k)
        cand = skel_prev.reshape(n_k, 2 * r_prev).long()   # children skeleton ids
        # B couplings: K(skel_c1, skel_c2) — pure kernel evaluations.  In the
        # adaptive build the rows/columns of dead skeletons are exact zeros.
        b_k = _batched_kernel_block(
            spec, x_perm[cand[:, :r_prev]], x_perm[cand[:, r_prev:]])
        cmask = _cand_mask(rank_prev, r_prev, x_perm.dtype) if adaptive else None
        b_mats.append(_mask_b(b_k, cmask, r_prev) if adaptive else b_k)
        if k == K:
            break
        r_k = min(params.rank, 2 * r_prev)
        # NEAR proxies: the sibling node's candidate skeletons.
        sib = cand.reshape(n_k // 2, 2, 2 * r_prev).flip(1).reshape(n_k, 2 * r_prev)
        prox = torch.cat([sib, far_idx[k]], dim=1)
        # Dead candidates (adaptive) are zero rows of the sampled block: they
        # get zero interpolation weights and sort behind every live pivot.
        piv_k, t_k, rank_k = _batched_row_id(
            spec, x_perm[cand], x_perm[prox], r_k, rtol, adaptive, cmask=cmask)
        skel_k = torch.gather(cand, 1, piv_k.long()).to(torch.int32)
        transfers.append(t_k)
        skels.append(skel_k)
        level_ranks.append(rank_k)
        skel_prev, rank_prev, r_prev = skel_k, rank_k, r_k

    return HSSMatrix(
        x=x_perm,
        d_leaf=d_leaf,
        u_leaf=u_leaf,
        skel_leaf=skel_leaf,
        transfers=tuple(transfers),
        skels=tuple(skels),
        b_mats=tuple(b_mats),
        levels=K,
        leaf_size=m,
        leaf_ranks=leaf_ranks if adaptive else None,
        level_ranks=tuple(level_ranks) if adaptive else (),
    )


def compress_sharded(
    x_perm: np.ndarray | torch.Tensor,
    tree: ClusterTree,
    spec: KernelSpec,
    params: CompressionParams = CompressionParams(),
    mesh=None,
    device: str | torch.device = "cuda",
    cut: int | None = None,
) -> HSSMatrix:
    """Mesh-parallel HSS build (the reference's ``compress_sharded``): each
    rank builds the nodes it owns.

    Every rank holds the whole ``x_perm`` on the host (the proxy sets need
    it) and moves only its own leaves' points, and the proxy points of its
    nodes, to ``device``:

      * host preprocessing yields the reference's exact index sets: every
        rank makes the whole seeded FAR draw and takes its rows, and the
        KD-tree is queried for the rank's own leaves (``_host_leaf_near``);
      * the leaf stage (K1 or K4 for D, K2 for the IDs) runs on the rank's
        n_leaf/P leaves;
      * each level carries only the skeleton POINTS and their global ids
        upward, and stays on the rank's own nodes while ``dist.api``'s rule
        keeps it split (``cut``, ``shard_levels`` by default: a smaller cut
        gives the same numbers);
      * at the cut one gather of the skeleton points, ids and ranks, after
        which every rank computes the small upper tree.

    The result holds the rank's part (``HSSMatrix.mesh``/``cut``; ``x`` is
    its leaves' points).  Without a mesh, with no tree levels, or when P
    does not divide the leaf count, this is ``compress`` (the reference's
    fallback).  Numerically the same decompositions of the same sampled
    blocks as ``compress``.
    """
    from repro_torch.dist import api as dist_api

    n, m, K = tree.n, tree.leaf_size, tree.levels
    n_leaf = 2 ** K
    x_host = x_perm.cpu().numpy() if isinstance(x_perm, torch.Tensor) else x_perm
    if x_host.shape[0] != n:
        raise ValueError(f"x has {x_host.shape[0]} rows, tree expects {n}")
    cut = dist_api.shard_levels(mesh, K) if cut is None else cut
    if cut == 0:
        return compress(x_host, tree, spec, params, device=device)
    dev = torch.device(device)
    r0 = min(params.rank, m)
    adaptive, rtol = params.rtol is not None, params.rtol

    lo, hi = dist_api.owned_range(mesh, n_leaf)
    far_idx = _host_proxy_indices(tree, params)
    leaf_near = _host_leaf_near(tree, params, x_host, mesh=mesh)
    prox0 = np.concatenate([leaf_near, far_idx[0][lo:hi]], axis=1)
    x_own = torch.as_tensor(x_host[lo * m:hi * m], device=dev)
    x_leaves = x_own.reshape(hi - lo, m, -1)
    f = x_leaves.shape[-1]

    def take(pts, piv):                       # (B, c, f) points at (B, k) slots
        return torch.gather(pts, 1, piv.long()[:, :, None].expand(-1, -1, f))

    # ---------------- leaves: the rank's own ---------------- #
    d_leaf = _batched_kernel_block(spec, x_leaves, x_leaves)
    piv0, u_leaf, leaf_ranks = _batched_row_id(
        spec, x_leaves, torch.as_tensor(x_host[prox0], device=dev), r0, rtol, adaptive)
    starts = torch.arange(lo, hi, dtype=torch.int32, device=dev) * m
    skel_leaf = starts[:, None] + piv0
    spts, sids, sranks = take(x_leaves, piv0), skel_leaf, leaf_ranks

    # ---------------- internal levels ---------------- #
    transfers: list[torch.Tensor] = []
    skels: list[torch.Tensor] = []
    b_mats: list[torch.Tensor] = []
    level_ranks: list[torch.Tensor] = []
    r_prev = r0
    for k in range(1, K + 1):
        n_k = 2 ** (K - k)
        if k == cut:
            # The one gather: skeleton points, ids and ranks of level k-1
            # (O(r n_k) each); the upper tree is replicated from here.
            spts, sids, sranks = (dist_api.all_gather_nodes(a, mesh)
                                  for a in (spts, sids, sranks))
        lo_k, hi_k = dist_api.owned_range(mesh, n_k) if k < cut else (0, n_k)
        cp = spts.reshape(hi_k - lo_k, 2 * r_prev, f)           # candidate points
        ci = sids.reshape(hi_k - lo_k, 2 * r_prev)
        cmask = _cand_mask(sranks, r_prev, cp.dtype) if adaptive else None
        b_k = _batched_kernel_block(spec, cp[:, :r_prev], cp[:, r_prev:])
        b_mats.append(_mask_b(b_k, cmask, r_prev) if adaptive else b_k)
        if k == K:
            break
        r_k = min(params.rank, 2 * r_prev)
        # NEAR proxies: the sibling node's candidates (on this rank: a split
        # level holds an even number of nodes per rank).
        sib = cp.reshape(-1, 2, 2 * r_prev, f).flip(1).reshape(hi_k - lo_k, 2 * r_prev, f)
        far = torch.as_tensor(x_host[far_idx[k][lo_k:hi_k]], device=dev)
        piv_k, t_k, sranks = _batched_row_id(
            spec, cp, torch.cat([sib, far], dim=1), r_k, rtol, adaptive, cmask=cmask)
        sids = torch.gather(ci, 1, piv_k.long()).to(torch.int32)
        spts = take(cp, piv_k)
        transfers.append(t_k)
        skels.append(sids)
        level_ranks.append(sranks)
        r_prev = r_k

    return HSSMatrix(
        x=x_own,
        d_leaf=d_leaf,
        u_leaf=u_leaf,
        skel_leaf=skel_leaf,
        transfers=tuple(transfers),
        skels=tuple(skels),
        b_mats=tuple(b_mats),
        levels=K,
        leaf_size=m,
        leaf_ranks=leaf_ranks if adaptive else None,
        level_ranks=tuple(level_ranks) if adaptive else (),
        mesh=mesh,
        cut=cut,
    )


# --------------------------------------------------------------------- #
# streamed (out-of-core) build                                          #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class StreamParams:
    """Knobs of the out-of-core streamed build (``compress_streamed``).

    batch_leaves      — nodes per device round trip.  The build's device
                        working set is O(batch·m·(m + n_proxy)) plus the
                        batch's outputs, whatever N.  Internal levels take
                        the same node count, rounded down to even so the
                        sibling NEAR exchange stays inside a batch.
    ckpt_dir          — directory of the per-level checkpoints
                        (``repro_torch.ckpt``); None: no checkpoints, and
                        the build cannot be resumed.
    ckpt_every_levels — checkpoint cadence in completed levels (the leaf
                        stage counts as one).
    max_restarts      — in-process restart budget of
                        ``dist.fault.run_resilient``.
    assemble          — "device": the finished HSS as tensors on the
                        build's device; "host": as CPU tensors, for callers
                        that keep or inspect it without a device footprint.
    """

    batch_leaves: int = 64
    ckpt_dir: str | None = None
    ckpt_every_levels: int = 1
    max_restarts: int = 3
    assemble: str = "device"


@dataclasses.dataclass
class StreamStats:
    """What one streamed build did (the reference's record, plus the
    measurements that only the port takes)."""

    peak_stream_bytes: int = 0      # max over batches of in+out device bytes (a count)
    n_batches: int = 0
    resumed_level: int | None = None    # completed levels found on disk
    restarts: int = 0                   # in-process run_resilient restarts
    checkpointed_levels: int = 0
    # Port only.  On a CUDA device: the largest bytes allocated during the
    # level loop above those allocated when the build began
    # (torch.cuda.max_memory_allocated after reset_peak_memory_stats; None
    # elsewhere).  Host seconds: gathering each batch's points and copying
    # them to the device; copying the outputs back (which waits for the
    # batch's kernels); writing and reading checkpoints.
    device_peak_bytes: int | None = None
    upload_s: float = 0.0
    download_s: float = 0.0
    ckpt_save_s: float = 0.0
    ckpt_load_s: float = 0.0


def _stream_leaf_batch(spec, xl, xp, r0, rtol, adaptive: bool):
    """One node batch of the streamed leaf stage: the diagonal blocks and
    the proxy-sampled row ID, through the same two seams as ``compress``."""
    d = _batched_kernel_block(spec, xl, xl)
    piv, u, rks = _batched_row_id(spec, xl, xp, r0, rtol, adaptive)
    return d, u, piv, rks


def _stream_level_batch(spec, cp, xp, cm, rk, rtol, adaptive: bool):
    """One node batch of a streamed internal level: the sibling couplings B
    and the candidate -> proxy row ID.  ``cp`` (b, 2·r_prev, f) candidate
    points, ``xp`` (b, 2·r_prev + n_far, f) proxy points, ``cm`` candidate
    liveness (None at fixed rank)."""
    rp = cp.shape[1] // 2
    b = _batched_kernel_block(spec, cp[:, :rp], cp[:, rp:])
    if adaptive:
        b = _mask_b(b, cm, rp)
    piv, t, rks = _batched_row_id(spec, cp, xp, rk, rtol, adaptive,
                                  cmask=cm if adaptive else None)
    return b, piv, t, rks


def _stream_root_batch(spec, cp, cm, adaptive: bool):
    """The root level stores only the sibling coupling B."""
    rp = cp.shape[1] // 2
    b = _batched_kernel_block(spec, cp[:, :rp], cp[:, rp:])
    if adaptive:
        b = _mask_b(b, cm, rp)
    return b


def _device_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _stream_fingerprint(n, m, K, spec, params, dtype, device, mesh=None, cut=0) -> dict:
    """Identity of a streamed build: a checkpoint of any other problem (data
    size, tree, kernel, accuracy knobs, dtype, implementation, and under a
    mesh the rank, the world and the cut) is never resumed into this one.
    ``impl`` names this package and the device type, since the card's
    kernels and the CPU's plain versions differ in the last bits.  Kept in
    the manifest's ``extra`` and compared after a JSON round trip, so the
    values are plain scalars."""
    fp = dict(
        kind="hss_streamed_build", n=int(n), leaf_size=int(m), levels=int(K),
        rank=int(params.rank), n_near=int(params.n_near),
        n_far=int(params.n_far), seed=int(params.seed),
        rtol=None if params.rtol is None else float(params.rtol),
        kernel=spec.name, h=float(spec.h), impl=f"repro_torch-{device.type}",
        dtype=str(np.dtype(dtype)))
    if mesh is not None:
        fp.update(mesh_rank=int(mesh.rank), mesh_world=int(mesh.size), cut=int(cut))
    return fp


def compress_streamed(
    x_perm: np.ndarray | torch.Tensor,
    tree: ClusterTree,
    spec: KernelSpec,
    params: CompressionParams = CompressionParams(),
    stream: StreamParams = StreamParams(),
    on_level=None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> tuple[HSSMatrix, StreamStats]:
    """Out-of-core HSS build: the data stay on the host, the device sees one
    batch of nodes at a time.

    ``compress`` puts the (N, f) data and every level's arrays on the
    device.  Here the leaf level is walked in ``stream.batch_leaves``-node
    batches: per batch, gather the batch's points and proxy points from the
    host array, run the SAME seams (``_batched_kernel_block`` -> K1 or K4,
    ``_batched_row_id`` -> K2), and copy the results into host
    accumulators.  Upper levels carry skeleton ids and gather their points
    from the host per batch, so the device's working set is
    O(batch·m·(m + n_proxy)) whatever N (``StreamStats.peak_stream_bytes``
    counts it; on a CUDA device ``device_peak_bytes`` measures it).

    With ``stream.ckpt_dir`` set, each completed level's host state is
    checkpointed (``repro_torch.ckpt``) and the level loop runs under
    ``dist.fault.run_resilient``: an interrupted build (in-process through
    the restart budget, or a fresh call on the same directory) resumes at
    the last completed level and gives BIT-IDENTICAL output, since the
    state is saved as raw bytes and each level is a deterministic function
    of it.  A checkpoint whose fingerprint does not match is ignored.

    The same points reach the same seams in the same order, only the batch
    axis is cut, so on the CPU the skeletons equal ``compress``'s exactly
    and ``counting_kernel_evals`` counts the same total.  ``on_level(i)``
    is called before level i runs (0 is the leaves): the hook of the
    failure drills.  Returns ``(HSSMatrix, StreamStats)``.

    ``mesh``: the node-split build streamed (the reference builds, then
    places by the node rule; here each rank streams only the batches of
    the nodes it owns).  Below ``dist.api.shard_levels``' cut a rank walks
    its own nodes, with the reference's index sets (``compress_sharded``'s
    host preprocessing); at the cut one gather of the level's skeleton ids
    and ranks, after which every rank streams the small upper tree.  The
    result is ``compress_sharded``'s (the rank's part; skeletons equal).
    Each rank checkpoints into ``ckpt_dir/rank<r>_of_<P>``, its
    fingerprint naming its rank and world, and the ranks resume at the
    newest level that all of them hold.  Without a split (no mesh, or P
    not dividing the leaf count) this is the local streamed build.
    """
    import os

    from repro_torch import ckpt
    from repro_torch.dist import api as dist_api
    from repro_torch.dist.fault import run_resilient

    n, m, K = tree.n, tree.leaf_size, tree.levels
    n_leaf = 2 ** K
    if K == 0:
        raise ValueError("streamed build needs at least one tree level")
    x_host = x_perm.cpu().numpy() if isinstance(x_perm, torch.Tensor) else x_perm
    if x_host.shape[0] != n:
        raise ValueError(f"x has {x_host.shape[0]} rows, tree expects {n}")
    if stream.assemble not in ("device", "host"):
        raise ValueError(f"unknown assemble mode {stream.assemble!r}")
    dev = torch.device(device)
    r0 = min(params.rank, m)
    adaptive, rtol = params.rtol is not None, params.rtol
    cut = dist_api.shard_levels(mesh, K)
    if cut == 0:
        mesh = None                          # the local build

    lo, hi = dist_api.owned_range(mesh, n_leaf)
    far_idx = _host_proxy_indices(tree, params)          # host, per level
    leaf_near = _host_leaf_near(tree, params, x_host, mesh=mesh)
    prox0 = np.concatenate([leaf_near, far_idx[0][lo:hi]], axis=1)
    x_leaves = x_host.reshape(n_leaf, m, -1)
    stats = StreamStats()
    fp = _stream_fingerprint(n, m, K, spec, params, x_host.dtype, dev, mesh, cut)
    ckpt_dir = stream.ckpt_dir
    if ckpt_dir is not None and mesh is not None:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{mesh.rank}_of_{mesh.size}")

    def up(*arrays):
        t0 = time.perf_counter()
        out = [torch.as_tensor(a, device=dev) for a in arrays]
        stats.upload_s += time.perf_counter() - t0
        return out

    def down(*tensors):
        t0 = time.perf_counter()
        out = [t.cpu().numpy() for t in tensors]
        stats.download_s += time.perf_counter() - t0
        return out

    def _run_leaves(state: dict) -> dict:
        bsz = max(1, stream.batch_leaves)
        n_own = hi - lo
        d_out = np.empty((n_own, m, m), x_host.dtype)
        u_out = np.empty((n_own, m, r0), x_host.dtype)
        skel_out = np.empty((n_own, r0), np.int32)
        rank_out = np.empty((n_own,), np.int32)
        for s in range(lo, hi, bsz):
            e = min(s + bsz, hi)
            xl, xp = up(x_leaves[s:e], x_host[prox0[s - lo:e - lo]])
            d, u, piv, rks = _stream_leaf_batch(spec, xl, xp, r0, rtol, adaptive)
            stats.peak_stream_bytes = max(stats.peak_stream_bytes,
                                          _device_bytes(xl, xp, d, u, piv, rks))
            stats.n_batches += 1
            a, b = s - lo, e - lo
            d_out[a:b], u_out[a:b], piv_h, rank_out[a:b] = down(d, u, piv, rks)
            skel_out[a:b] = piv_h + np.arange(s, e, dtype=np.int32)[:, None] * m
        state = dict(state)
        state.update(d_leaf=d_out, u_leaf=u_out, skel_leaf=skel_out, ranks_leaf=rank_out)
        return state

    def _run_level(state: dict, k: int) -> dict:
        skel_prev = state["skel_leaf"] if k == 1 else state[f"skel_{k - 1}"]
        rank_prev = state["ranks_leaf"] if k == 1 else state[f"ranks_{k - 1}"]
        r_prev = skel_prev.shape[1]
        n_k = 2 ** (K - k)
        if mesh is not None and k == cut:
            # the one gather: level k-1's skeleton ids and ranks (O(r n_k));
            # the upper tree is every rank's from here
            skel_prev, rank_prev = (
                dist_api.all_gather_nodes(torch.from_numpy(np.ascontiguousarray(a)),
                                          mesh).numpy()
                for a in (skel_prev, rank_prev))
        lo_k, hi_k = dist_api.owned_range(mesh, n_k) if k < cut else (0, n_k)
        cand = skel_prev.reshape(hi_k - lo_k, 2 * r_prev)
        # host-side candidate liveness, the rule of hss.rank_mask
        cm_all = ((np.arange(r_prev)[None, :] < rank_prev[:, None])
                  .reshape(hi_k - lo_k, 2 * r_prev).astype(x_host.dtype))
        bsz = max(2, stream.batch_leaves - stream.batch_leaves % 2)
        state = dict(state)
        if k == K:                                       # root: B only
            cp, = up(x_host[cand])
            cm = up(cm_all)[0] if adaptive else None
            b = _stream_root_batch(spec, cp, cm, adaptive)
            stats.peak_stream_bytes = max(stats.peak_stream_bytes, _device_bytes(cp, b))
            stats.n_batches += 1
            state[f"b_{k}"], = down(b)
            return state
        r_k = min(params.rank, 2 * r_prev)
        n_own = hi_k - lo_k
        b_out = np.empty((n_own, r_prev, r_prev), x_host.dtype)
        t_out = np.empty((n_own, 2 * r_prev, r_k), x_host.dtype)
        skel_out = np.empty((n_own, r_k), np.int32)
        rank_out = np.empty((n_own,), np.int32)
        for s in range(0, n_own, bsz):
            e = min(s + bsz, n_own)              # n_own, bsz even -> e - s even
            cand_b = cand[s:e]
            # NEAR proxies: the sibling's candidates, exchanged inside the
            # batch (batches are even-aligned, so both siblings are in it)
            sib = cand_b.reshape(-1, 2, 2 * r_prev)[:, ::-1].reshape(e - s, 2 * r_prev)
            far = far_idx[k][lo_k + s:lo_k + e]
            cp, xp = up(x_host[cand_b],
                        np.concatenate([x_host[sib], x_host[far]], axis=1))
            cm = up(cm_all[s:e])[0] if adaptive else None
            b, piv, t, rks = _stream_level_batch(spec, cp, xp, cm, r_k, rtol, adaptive)
            stats.peak_stream_bytes = max(stats.peak_stream_bytes,
                                          _device_bytes(cp, xp, b, piv, t, rks))
            stats.n_batches += 1
            b_out[s:e], t_out[s:e], piv_h, rank_out[s:e] = down(b, t, piv, rks)
            skel_out[s:e] = np.take_along_axis(cand_b, piv_h, axis=1)
        state.update({f"b_{k}": b_out, f"t_{k}": t_out,
                      f"skel_{k}": skel_out, f"ranks_{k}": rank_out})
        return state

    def _step(state: dict, i: int) -> dict:
        if on_level is not None:
            on_level(i)
        return _run_leaves(state) if i == 0 else _run_level(state, i)

    def _save(state: dict, completed: int) -> None:
        if ckpt_dir is None:
            return
        t0 = time.perf_counter()
        ckpt.save_checkpoint(ckpt_dir, state, completed, extra=fp)
        stats.ckpt_save_s += time.perf_counter() - t0
        stats.checkpointed_levels = completed

    def _restore():
        if ckpt_dir is None:
            return None
        step = ckpt.latest_step(ckpt_dir)
        loaded = None
        if step is not None:
            t0 = time.perf_counter()
            loaded = ckpt.load_checkpoint_arrays(ckpt_dir, step)
            stats.ckpt_load_s += time.perf_counter() - t0
            if {key: loaded[2].get(key) for key in fp} != fp:
                loaded, step = None, None    # someone else's checkpoint
        if mesh is not None:
            # the newest level every rank holds (levels are kept, not pruned);
            # a rank that holds none (+1 here) makes it none
            mine = torch.tensor([1 if step is None else -step], dtype=torch.int64)
            agreed = -int(dist_api.all_reduce_max(mine, mesh)[0])
            if agreed <= 0:
                return None
            if agreed != step:
                t0 = time.perf_counter()
                loaded = ckpt.load_checkpoint_arrays(ckpt_dir, agreed)
                stats.ckpt_load_s += time.perf_counter() - t0
        if loaded is None:
            return None
        arrays, got, _ = loaded
        stats.resumed_level = got
        return arrays, got

    on_card = dev.type == "cuda"
    if on_card:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    state, report = run_resilient(
        K + 1, dict, _step, _save, _restore,
        ckpt_every=stream.ckpt_every_levels if ckpt_dir else 0,
        max_restarts=stream.max_restarts)
    stats.restarts = report["restarts"]
    if on_card:
        stats.device_peak_bytes = torch.cuda.max_memory_allocated(dev) - base

    # ---------------- assembly ---------------- #
    if stream.assemble == "host":
        put = torch.from_numpy
    else:
        def put(a):
            return torch.as_tensor(a, device=dev)
    hss = HSSMatrix(
        x=put(x_host[lo * m:hi * m]),
        d_leaf=put(state["d_leaf"]),
        u_leaf=put(state["u_leaf"]),
        skel_leaf=put(state["skel_leaf"]),
        transfers=tuple(put(state[f"t_{k}"]) for k in range(1, K)),
        skels=tuple(put(state[f"skel_{k}"]) for k in range(1, K)),
        b_mats=tuple(put(state[f"b_{k}"]) for k in range(1, K + 1)),
        levels=K,
        leaf_size=m,
        leaf_ranks=put(state["ranks_leaf"]) if adaptive else None,
        level_ranks=tuple(put(state[f"ranks_{k}"]) for k in range(1, K)) if adaptive else (),
        mesh=mesh,
        cut=cut if mesh is not None else 0,
    )
    return hss, stats


def compression_error(hss: HSSMatrix, spec: KernelSpec, probes: torch.Tensor
                      ) -> torch.Tensor:
    """Stochastic relative Frobenius error ||K̃ − K||_F / ||K||_F.

    ``probes`` (N, n_probe) is the probe block, an argument here (the
    reference draws it from ``jax.random``).  The exact product goes through
    the streamed kernel matvec, so K is never materialized.
    """
    from repro_torch.core.kernelfn import kernel_matvec_streamed

    probes = probes.to(device=hss.x.device, dtype=hss.x.dtype)
    kv = kernel_matvec_streamed(spec, hss.x, hss.x, probes)
    kv_hss = hss.matmat(probes)
    return torch.linalg.vector_norm(kv_hss - kv) / torch.clamp(
        torch.linalg.vector_norm(kv), min=1e-30)
