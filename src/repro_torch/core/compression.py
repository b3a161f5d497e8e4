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
"""
from __future__ import annotations

import contextlib
import dataclasses

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
    tree: ClusterTree, params: CompressionParams, x_perm: np.ndarray | None = None
) -> np.ndarray:
    """(n_leaf, n_near) NEAR-proxy indices per leaf.

    The paper's HSS-ANN strategy: the dominant entries of a leaf's
    off-diagonal block row correspond to its points' nearest neighbours in
    *other* clusters.  With data available we find them with a KD-tree
    (scipy) — the exact analogue of STRUMPACK's ANN preprocessing; without
    data we fall back to sampling the sibling leaf (tree-adjacent ≈ near).
    """
    rng = np.random.default_rng(params.seed + 1)
    m, K = tree.leaf_size, tree.levels
    n_leaf = 2 ** K
    out = np.empty((n_leaf, params.n_near), dtype=np.int32)
    if x_perm is not None and n_leaf > 1:
        from scipy.spatial import cKDTree

        x_f32 = np.asarray(x_perm, np.float32)
        kdt = cKDTree(x_f32)
        k_query = min(max(2 * params.n_near // m + 4, 4), tree.n)
        _, nbr = kdt.query(x_f32, k=k_query, workers=-1)   # (n, k) incl. self; all cores
        leaf_of = np.arange(tree.n) // m
        # Vectorized over all leaves: each leaf's candidate pool is its
        # points' neighbour lists, flattened.
        cand = nbr.reshape(n_leaf, m * k_query).astype(np.int64)
        own = leaf_of[cand] == np.arange(n_leaf)[:, None]   # in-leaf -> drop
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
        centroid = x_f32.reshape(n_leaf, m, -1).mean(axis=1)
        dist = np.linalg.norm(
            x_f32[cand] - centroid[:, None, :], axis=2)
        dist[invalid] = np.inf
        pick = np.argsort(dist, axis=1, kind="stable")[:, : params.n_near]
        out[:] = np.take_along_axis(cand, pick, axis=1)
        # Deficit rows (candidate pool smaller than n_near — tiny problems
        # only): top up from the sibling leaf, excluding candidates already
        # placed; repeats only once the whole sibling leaf is exhausted.
        counts = (~invalid).sum(axis=1)
        for i in np.nonzero(counts < params.n_near)[0]:
            c = int(counts[i])
            short = params.n_near - c
            sib = int(i) ^ 1
            pool = np.setdiff1d(
                np.arange(m, dtype=np.int64) + sib * m, out[i, :c])
            if len(pool) >= short:
                fill = rng.choice(pool, size=short, replace=False)
            else:
                extra = rng.choice(m, size=short - len(pool)) + sib * m
                fill = np.concatenate([pool, extra])
            out[i, c:] = fill
        return out
    for i in range(n_leaf):
        sib = i ^ 1
        out[i] = rng.choice(m, size=params.n_near, replace=params.n_near > m) + sib * m
    return out


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
