"""SVM training and prediction via HSS + ADMM (counterpart of ``repro.core.svm``).

Paper Algorithm 3: compress K̃ once, factorize K̃ + βI once, then per C a
few ADMM iterations, the bias from eq. (7) with ONE HSS matmat, and
prediction sign(Σ (z_y)_i K(f_i, f) + b) through streamed kernel blocks.
Pads (tree.pad_dataset) get the box [0, 0], so the restriction of the ADMM
fixed point to real points solves the original problem.  Everything a
trainer builds lives on its ``device`` ("cuda" unless the caller asks for
another).  ``build`` also takes the out-of-core streamed compression
(``compression.compress_streamed``), and ``prolong_duals`` lifts a coarse
problem's duals to the fine points (the engine's multilevel warm start).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import admm as admm_mod
from repro_torch.core import compression, factorization, tree as tree_mod
from repro_torch.core.hss import HSSMatrix, inert_pads, shrink_report
from repro_torch.core.kernelfn import (
    DEFAULT_SCORE_BLOCK, KernelSpec, kernel_matvec_streamed,
)
from repro_torch.dist import api as dist_api


def sync(device: torch.device) -> None:
    """Wait for queued device work, so a host clock reads the device's time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class SVMModel:
    """A trained binary classifier: support coefficients in permuted order."""

    x_perm: torch.Tensor   # (N, f) padded+permuted training points
    z_y: torch.Tensor      # (N,)  y_i * z_i  (pads are exactly 0)
    bias: float
    spec: KernelSpec
    c_value: float

    def decision_function(self, x_test, block: int = DEFAULT_SCORE_BLOCK
                          ) -> torch.Tensor:
        x_test = torch.as_tensor(x_test, dtype=torch.float32, device=self.x_perm.device)
        return kernel_matvec_streamed(self.spec, x_test, self.x_perm, self.z_y,
                                      block=block) + self.bias

    def predict(self, x_test, block: int = DEFAULT_SCORE_BLOCK) -> torch.Tensor:
        return torch.where(self.decision_function(x_test, block=block) >= 0, 1, -1)


@dataclasses.dataclass
class FitReport:
    """Timings mirroring the paper's Tables 4/5 columns, plus the exact
    number of kernel entries the compression evaluated and the per-problem
    ADMM iterations of the last ``train``."""

    compression_s: float
    factorization_s: float
    admm_s: float
    memory_mb: float
    hss_levels: int
    beta: float
    ranks_pre: tuple | None = None
    ranks_post: tuple | None = None
    rank_sum_pre: int | None = None
    rank_sum_post: int | None = None
    kernel_evals: int | None = None
    iters_run: tuple | None = None
    # streamed build (compression.StreamStats): the counted peak device bytes
    # of any one batch, the batch count, and the resume / restart record
    peak_stream_bytes: int | None = None
    stream_batches: int | None = None
    stream_resumed_level: int | None = None
    stream_restarts: int | None = None
    # port only: the measured level-loop device peak on a CUDA card
    # (StreamStats.device_peak_bytes), None elsewhere
    stream_device_peak_bytes: int | None = None
    # adaptive ρ, the last train(): the final β and the rescale count
    rho_final: float | None = None
    rho_rescales: int | None = None
    # the ranks the build was split over: 1 on the local path, which a mesh
    # falls back to where the tree cannot split over it (port only; under a
    # mesh memory_mb is this rank's share)
    mesh_ranks: int = 1


def compute_bias_batched(hss: HSSMatrix, ys: torch.Tensor, z: torch.Tensor,
                         c_mat: torch.Tensor, masks: torch.Tensor,
                         margin_tol: float = 1e-6) -> torch.Tensor:
    """Paper eq. (7) for P problems sharing one kernel, with ONE HSS matmat.

    b_p = (z_yᵀ K̃ ē − Σ_{j∈M_p} y_j) / |M_p| where M_p = margin support
    vectors {j : 0 < z_jp < C_jp} of problem p; the average functional
    margin over all bounded SVs when M_p is empty.  ``ys``/``z``/``c_mat``/
    ``masks`` are (d, P) column blocks; returns (P,).  On a node-split
    ``hss`` the blocks are the rank's rows, and the column sums are local
    partials summed by one all-reduce.
    """
    on_margin = ((z > margin_tol) & (z < c_mat - margin_tol)
                 & (masks > 0)).to(z.dtype)
    kz = hss.matmat(ys * z)                 # K̃ (Y z) — one O(N r) sweep
    sv = ((z > margin_tol) & (masks > 0)).to(z.dtype)
    sums = torch.stack([on_margin.sum(0), (on_margin * kz).sum(0), (on_margin * ys).sum(0),
                        sv.sum(0), (sv * kz).sum(0), (sv * ys).sum(0)])
    n_m, mk, my, n_sv, sk, sy = dist_api.all_reduce_sum(sums, hss.mesh)
    b_margin = -(mk - my) / torch.clamp(n_m, min=1.0)
    b_all = -(sk - sy) / torch.clamp(n_sv, min=1.0)
    return torch.where(n_m > 0, b_margin, b_all)


def compute_bias(hss: HSSMatrix, y: torch.Tensor, z: torch.Tensor, c_value: float,
                 mask: torch.Tensor, margin_tol: float = 1e-6) -> torch.Tensor:
    """Paper eq. (7) for a single binary problem (P = 1 view)."""
    c_mat = torch.full((z.shape[0], 1), c_value, dtype=z.dtype, device=z.device)
    return compute_bias_batched(
        hss, y[:, None], z[:, None], c_mat, mask[:, None], margin_tol)[0]


def build(x_perm: np.ndarray, tree: tree_mod.ClusterTree, real: np.ndarray,
          spec: KernelSpec, comp: compression.CompressionParams, beta: float,
          device: torch.device, store_dtype: str | None = None,
          stream: compression.StreamParams | None = None, mesh=None
          ) -> tuple[HSSMatrix, factorization.HSSFactorization, FitReport]:
    """Compress ONCE and factorize ONCE (Alg. 3 lines 1–6), timed on the host
    clock around synchronised device work.  ``stream`` takes the streamed
    build.  An adaptive build is shrunk to its observed ranks before
    factorizing, so the factorization and every solve run at the detected
    ranks, and the pad block is made exactly the identity
    (``hss.inert_pads``; ``real`` is the tree-order mask).  ``mesh`` takes
    the node-split build (``compression.compress_sharded``, or the streamed
    one's mesh form), which falls back to the local one where the tree
    does not split over it."""
    sync(device)
    t0 = time.perf_counter()
    sstats = None
    if stream is not None:
        hss, sstats = compression.compress_streamed(x_perm, tree, spec, comp, stream,
                                                    device=device, mesh=mesh)
        hss = hss.to(device)       # a host-assembled build factorizes on the device
    elif mesh is not None:
        hss = compression.compress_sharded(x_perm, tree, spec, comp, mesh, device=device)
    else:
        hss = compression.compress(x_perm, tree, spec, comp, device=device)
    hss, rank_info = shrink_report(hss)
    hss = inert_pads(hss, torch.as_tensor(real, device=device))
    sync(device)
    t1 = time.perf_counter()
    fac = factorization.factorize(hss, beta, store_dtype=store_dtype)
    sync(device)
    report = FitReport(
        compression_s=t1 - t0, factorization_s=time.perf_counter() - t1, admm_s=0.0,
        memory_mb=hss.memory_bytes() / 1e6, hss_levels=tree.levels, beta=beta,
        kernel_evals=compression.kernel_eval_count(tree, comp),
        mesh_ranks=dist_api.mesh_ndev(hss.mesh), **rank_info)
    if sstats is not None:
        report.peak_stream_bytes = sstats.peak_stream_bytes
        report.stream_batches = sstats.n_batches
        report.stream_resumed_level = sstats.resumed_level
        report.stream_restarts = sstats.restarts
        report.stream_device_peak_bytes = sstats.device_peak_bytes
    return hss, fac, report


@dataclasses.dataclass
class HSSSVMTrainer:
    """compress-once / factor-once / train-many trainer (binary ±1 labels):
    the reference's interface over one ``HSSSVMEngine``."""

    spec: KernelSpec
    comp: compression.CompressionParams = dataclasses.field(
        default_factory=compression.CompressionParams)
    leaf_size: int = 128
    beta: float | None = None     # default: the paper's rule by dataset size
    max_it: int = 10
    tol: float | None = None      # ADMM residual early-stop (paper's rule)
    device: str | torch.device = "cuda"
    engine: object = dataclasses.field(default=None, init=False)   # prepare() builds it

    def prepare(self, x: np.ndarray, y: np.ndarray) -> FitReport:
        """Pad, build tree, compress, factorize (paper Alg. 3 lines 1–6)."""
        from repro_torch.core.engine import HSSSVMEngine
        self.engine = HSSSVMEngine(
            spec=self.spec, comp=self.comp, leaf_size=self.leaf_size, beta=self.beta,
            admm=admm_mod.ADMMParams(max_it=self.max_it, tol=self.tol),
            device=self.device)
        report = self.engine.prepare(x, y)
        if not self.engine._binary:
            raise ValueError("HSSSVMTrainer needs ±1 labels (MulticlassHSSSVMTrainer "
                             "takes k classes)")
        return report

    def train(self, c_value: float,
              warm: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> tuple[SVMModel, tuple[torch.Tensor, torch.Tensor]]:
        """One ADMM run for a fixed C, reusing the cached factorization."""
        assert self.engine is not None, "call prepare() first"
        if warm is not None:
            warm = (warm[0][:, None], warm[1][:, None])
        m, (z, mu) = self.engine.train(c_value, warm=warm)
        model = SVMModel(x_perm=m.x_perm, z_y=m.z_y[:, 0], bias=float(m.biases[0]),
                         spec=self.spec, c_value=c_value)
        return model, (z[:, 0], mu[:, 0])

    def fit(self, x: np.ndarray, y: np.ndarray, c_value: float = 1.0) -> SVMModel:
        self.prepare(x, y)
        model, _ = self.train(c_value)
        return model

    @property
    def report(self) -> FitReport:
        assert self.engine is not None, "call prepare() first"
        return self.engine.report


def prolong_duals(x_coarse: np.ndarray, z_coarse: np.ndarray,
                  x_fine: np.ndarray) -> np.ndarray:
    """Nearest-neighbour prolongation of per-point dual columns.

    The AML-SVM multilevel scheme (arXiv 2011.02592): a dual vector trained
    on a coarse subsample is lifted to the fine set by giving every fine
    point its nearest coarse point's dual value, so the fine ADMM starts
    near its fixed point instead of at zero.  ``x_coarse`` (n_c, f) /
    ``x_fine`` (n_f, f) are point sets in any consistent order, ``z_coarse``
    is (n_c,) or (n_c, P); returns the matching (n_f, ...) array.
    Distances are ranked in f32 and the dual VALUES are copied untouched;
    the KD-tree query runs on every host core (``workers=-1``: the same
    neighbours as one worker).  Task-dependent mass rescaling is
    ``tasks.prolong_scale``.
    """
    from scipy.spatial import cKDTree

    xc = np.asarray(x_coarse, np.float32)
    xf = np.asarray(x_fine, np.float32)
    _, nn = cKDTree(xc).query(xf, k=1, workers=-1)
    return np.asarray(z_coarse)[nn]


def accuracy_score(model, x_val, y_val) -> float:
    """Classification accuracy of ``model.predict`` on (x_val, y_val)."""
    return float((model.predict(x_val).cpu().numpy() == np.asarray(y_val)).mean())


def run_grid_search(make_trainer, x: np.ndarray, y: np.ndarray | None,
                    x_val: np.ndarray, y_val: np.ndarray, hs: Sequence[float],
                    cs: Sequence[float], score_fn=None) -> tuple[object, dict]:
    """Generic (h, knob) grid search shared by every box-QP task sweep.

    Per h: ONE trainer (one compression + one factorization via prepare);
    the knob sweep (C, ε or ν) reuses them and warm-starts consecutive
    values.  The best model is picked by ``score_fn(model, x_val, y_val)``
    (higher is better; default: accuracy).  Returns it and a results table
    whose ``accuracy`` entries hold the score.
    """
    score_fn = score_fn or accuracy_score
    results = {}
    best = (None, -np.inf, None, None)
    for h in hs:
        trainer = make_trainer(float(h))
        trainer.prepare(x, y)
        warm = None
        admm_seen = 0.0
        for c in cs:
            model, warm = trainer.train(float(c), warm=warm)
            acc = score_fn(model, x_val, y_val)
            admm_total = trainer.report.admm_s
            results[(h, c)] = dict(accuracy=acc, admm_s=admm_total - admm_seen,
                                   compression_s=trainer.report.compression_s,
                                   factorization_s=trainer.report.factorization_s)
            admm_seen = admm_total
            if acc > best[1]:
                best = (model, acc, h, c)
    return best[0], dict(results=results, best_h=best[2], best_c=best[3],
                         best_accuracy=best[1])


def resolve_rtol(trainer_kwargs: dict | None, rtol: float | None) -> dict:
    """Fold the paper-facing accuracy knob (STRUMPACK's rel_tol: crude ≈
    1e-2, accurate ≈ 1e-4) into a trainer kwargs dict's ``comp``."""
    kw = dict(trainer_kwargs or {})
    if rtol is not None:
        base = kw.get("comp", compression.CompressionParams())
        kw["comp"] = dataclasses.replace(base, rtol=rtol)
    return kw


def grid_search(x: np.ndarray, y: np.ndarray, x_val: np.ndarray, y_val: np.ndarray,
                hs: Sequence[float], cs: Sequence[float],
                trainer_kwargs: dict | None = None, rtol: float | None = None
                ) -> tuple[SVMModel, dict]:
    """(h, C) grid search (paper §3.3) for the binary trainer; ``rtol``
    switches each h's build to the adaptive compression."""
    kw = resolve_rtol(trainer_kwargs, rtol)
    return run_grid_search(lambda h: HSSSVMTrainer(spec=KernelSpec(h=h), **kw),
                           x, y, x_val, y_val, hs, cs)
