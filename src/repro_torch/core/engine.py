"""One orchestration layer for the HSS-ADMM pipeline (paper Algorithm 3).

Counterpart of ``repro.core.engine`` on one device: partition (pad +
cluster tree) → HSS compression → ULV-equivalent factorization → batched
ADMM (or one solve) → bias → prediction.  Everything the engine builds
lives on ``device`` ("cuda" unless the caller asks for another); nothing
moves between devices behind the caller's back.

Both kernels, fixed or adaptive rank (an adaptive build is shrunk to its
observed ranks before factorizing), f32 or bf16 factor storage, and every
task of the reference on the shared factorization:

  * ``"svm"``      — classification; the knob is C; binary ±1 labels train
    one problem, other labels k-class OVR or OVO problems (``strategy``);
  * ``"svr"``      — ε-SVR; the knob is ε, the box bound ``svr_c``;
  * ``"oneclass"`` — ν one-class SVM; the knob is ν, ``y`` is ignored;
  * ``"krr"`` / ``"gp"`` — kernel ridge regression / GP posterior mean: the
    knob λ rides the factorization's β shift (one refactorization per
    visited λ), and ``train`` is ONE multi-RHS solve with ZERO ADMM
    iterations; ``log_marginal`` scores a λ for ``"gp"``.

``top_eigenpairs``/``spectral_embed`` run Lanczos on K̃ for any prepared
task.  ``stream`` takes the out-of-core streamed build in ``prepare``
(checkpointed and resumable with ``stream.ckpt_dir``); ``admm.adapt_rho``
balances the residuals by rescaling β, one factorization per visited β (as
the reference does; ``admm.rho_guard`` adds the port's floor ``rho_floor()``
against an indefinite K̃);
``train_multilevel`` warm-starts from a coarse subsample.

``mesh`` (a ``repro_torch.dist.api.Mesh``, one process per rank) runs every
stage node-split: each rank is given the whole ``x``/``y`` on the host, as
the reference's single controller holds them, builds and factorizes the
nodes it owns (``compression.compress_sharded``, ``factorization``'s split
schedule), trains on its rows of every (d, P) block with one all-reduce per
sum over the samples, and its models hold its rows of the support
(``EngineModel.mesh``): scoring sums the ranks' partial scores with one
all-reduce (the reference's ``_mesh_scorer``).  Every rank makes every call.
The effective mesh (``FitReport.mesh_ranks``) falls back to the local path
for a rank count that is not a power of two, as the reference's does.
With ``stream`` too, each rank streams the batches of the nodes it owns
(``compression.compress_streamed(mesh=)``), with the same result as the
resident node-split build.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import admm as admm_mod
from repro_torch.core import compression, factorization, krr as krr_mod
from repro_torch.core import lanczos as lanczos_mod, tasks as tasks_mod, tree as tree_mod
from repro_torch.core.hss import HSSMatrix
from repro_torch.core.kernelfn import (
    DEFAULT_SCORE_BLOCK, KernelSpec, kernel_matvec_streamed,
)
from repro_torch.core.multiclass import class_index, ovo_problems, ovr_problems
from repro_torch.core.svm import FitReport, build, compute_bias_batched, prolong_duals, sync
from repro_torch.dist import api as dist_api

TASKS = ("svm", "svr", "oneclass", "krr", "gp")
_REGRESSION = ("svr", "krr", "gp")


@dataclasses.dataclass
class EngineModel:
    """A trained model of any task: binary or k-class classifier, regressor
    or one-class detector."""

    x_perm: torch.Tensor   # (d, f) padded+permuted training points
    z_y: torch.Tensor      # (d, P) per-problem s_i * z_i columns (pads are 0;
                           #  y_i z_i for SVM, the dual coefficients α else)
    biases: torch.Tensor   # (P,)  (−ρ for one-class)
    classes: np.ndarray    # (k,) class labels ([-1, 1] placeholder off "svm")
    spec: KernelSpec
    c_value: float         # the task knob it was trained at (C / ε / ν / λ)
    binary: bool = True
    strategy: str = "ovr"
    task: str = "svm"
    pairs: np.ndarray | None = None     # (P, 2) class indices, ovo only
    beta: float | None = None   # β of the factorization it was trained on
    # trained under a mesh: x_perm / z_y are this rank's rows of the support
    mesh: object = None

    @property
    def n_classes(self) -> int:
        return int(self.classes.shape[0])

    def gathered(self) -> "EngineModel":
        """The same model with the whole support on every rank and no mesh
        (one gather of the rows; itself when there is no mesh)."""
        if self.mesh is None:
            return self
        return dataclasses.replace(
            self, x_perm=dist_api.all_gather_nodes(self.x_perm, self.mesh),
            z_y=dist_api.all_gather_nodes(self.z_y, self.mesh), mesh=None)

    def decision_function(self, x_test, block: int = DEFAULT_SCORE_BLOCK
                          ) -> torch.Tensor:
        """Scores (n_test, P); single-column models (binary SVM, SVR,
        one-class, KRR/GP) return the flat (n_test,) column.  Under a mesh
        each rank scores against its rows of the support and one all-reduce
        sums the partial scores (every rank passes the same ``x_test``)."""
        x_test = torch.as_tensor(x_test, dtype=torch.float32,
                                 device=self.x_perm.device)
        scores = kernel_matvec_streamed(
            self.spec, x_test, self.x_perm, self.z_y, block=block)
        scores = dist_api.all_reduce_sum(scores, self.mesh)
        scores = scores + self.biases[None, :]
        if self.binary or self.task != "svm":
            return scores[:, 0]
        return scores

    def predict(self, x_test, block: int = DEFAULT_SCORE_BLOCK) -> torch.Tensor:
        scores = self.decision_function(x_test, block=block)
        if self.task in _REGRESSION:
            return scores               # regression: the scores are the predictions
        if self.binary or self.task == "oneclass":    # ±1 (one-class: +1 inlier)
            return torch.where(scores >= 0, 1, -1)
        idx = class_index(scores, self.strategy, self.pairs, self.n_classes)
        return torch.as_tensor(self.classes, device=idx.device)[idx]


@dataclasses.dataclass
class HSSSVMEngine:
    """pad + tree → compress → factorize → ADMM (or solve) → bias/predict."""

    spec: KernelSpec
    comp: compression.CompressionParams = dataclasses.field(
        default_factory=compression.CompressionParams)
    leaf_size: int = 128
    beta: float | None = None     # default: the paper's rule by dataset size
    admm: admm_mod.ADMMParams = dataclasses.field(     # max_it, residual tol
        default_factory=admm_mod.ADMMParams)
    mesh: object = None
    strategy: str = "ovr"         # multiclass reduction: "ovr" | "ovo"
    store_dtype: str | None = None
    task: str = "svm"             # "svm" | "svr" | "oneclass" | "krr" | "gp"
    svr_c: float = 1.0            # SVR box bound C (ε is the train knob)
    stream: compression.StreamParams | None = None   # out-of-core build
    device: str | torch.device = "cuda"

    # populated by prepare():
    _hss: HSSMatrix | None = None
    _fac: factorization.HSSFactorization | None = None
    _ys: torch.Tensor | None = None       # (P, d) per-problem labels / targets
    _pmask: torch.Tensor | None = None    # (P, d) participation masks
    _classes: np.ndarray | None = None
    _pairs: np.ndarray | None = None
    _binary: bool = False
    _report: FitReport | None = None
    _n_real: int = 0                      # input rows (pads dropped on the way back)
    _perm_host: np.ndarray | None = None  # the tree permutation (host)
    _fac_cache: dict | None = None        # β -> factorization
    _rho_floor: float | None = None       # adaptive ρ's β floor (``rho_floor``)
    # the multilevel warm start's inputs (host)
    _x_raw: np.ndarray | None = None
    _y_raw: np.ndarray | None = None
    _xp_host: np.ndarray | None = None    # padded + permuted points
    _maskp_host: np.ndarray | None = None  # (d,) real-point mask, tree order
    # The EFFECTIVE mesh: ``mesh``, or None where the tree cannot split over
    # it (a rank count that is not a power of two): the local path then.
    _mesh: object = None

    def __post_init__(self):
        self.device = torch.device(self.device)

    def _min_levels(self) -> int:
        """Enough tree levels that the leaf count divides the rank count
        (the reference's rule: none for a count that is not a power of two,
        which then runs the local path)."""
        p = dist_api.mesh_ndev(self.mesh)
        if self.mesh is None or p & (p - 1):
            return 0
        return p.bit_length() - 1

    def _rows(self, a: np.ndarray, axis: int = 0) -> np.ndarray:
        """This rank's rows (samples on ``axis``) of a full-length host array."""
        if self._mesh is None:
            return a
        lo, hi = dist_api.owned_range(self._mesh, a.shape[axis])
        return a[lo:hi] if axis == 0 else a[:, lo:hi]

    # ------------------------------------------------------------------ #
    def prepare(self, x: np.ndarray, y: np.ndarray | None = None) -> FitReport:
        """Pad + tree + compress ONCE + factorize ONCE (Alg. 3 lines 1–6)."""
        if self.strategy not in ("ovr", "ovo"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}")
        x = np.asarray(x, np.float32)
        if self.task == "svm":
            if y is None:
                raise ValueError("task='svm' needs labels")
            y = np.asarray(y)
            classes = np.unique(y)
            if classes.shape[0] < 2:
                raise ValueError("need at least 2 classes")
            try:
                vals = set(np.asarray(classes, np.float64).tolist())
            except (TypeError, ValueError):
                vals = set()
            self._binary = classes.shape[0] == 2 and vals == {-1.0, 1.0}
        else:
            if self.task in _REGRESSION and y is None:
                raise ValueError(f"task={self.task!r} needs regression targets")
            y = np.zeros(x.shape[0], np.float32) if y is None else np.asarray(y)
            classes = np.array([-1.0, 1.0], np.float32)
            self._binary = False
        d_real = x.shape[0]
        x_pad, y_pad, mask, levels = tree_mod.pad_dataset(
            x, y.astype(np.float32), self.leaf_size, min_levels=self._min_levels())
        p = dist_api.mesh_ndev(self.mesh)
        self._mesh = self.mesh if dist_api.shard_levels(self.mesh, levels) else None
        if self.mesh is not None and p & (p - 1):
            self._mesh = None           # the reference's fallback: the local path
        t = tree_mod.build_tree(x_pad, self.leaf_size, levels)
        xp_host = x_pad[t.perm]
        yp, maskp = y_pad[t.perm], mask[t.perm]
        if self.task != "svm":
            # one problem column: the (mask-zeroed) targets; the mask pins
            # pads to the inert [0, 0] box
            ys = (yp * maskp)[None, :].astype(np.float32)
            pmasks = maskp[None, :].astype(np.float32)
            pairs = None
        elif self._binary:
            ys = np.where(yp > 0, 1.0, -1.0)[None, :].astype(np.float32)
            pmasks = maskp[None, :].astype(np.float32)
            pairs = None
        else:
            problems = ovr_problems if self.strategy == "ovr" else ovo_problems
            ys, pmasks, pairs = problems(yp, classes.astype(np.float32), maskp)

        beta = self.beta if self.beta is not None else admm_mod.paper_beta(d_real)
        self._hss, self._fac, self._report = build(
            xp_host, t, maskp, self.spec, self.comp, beta, self.device, self.store_dtype,
            stream=self.stream, mesh=self._mesh)
        self._ys = torch.as_tensor(self._rows(ys, axis=1), device=self.device)
        self._pmask = torch.as_tensor(self._rows(pmasks, axis=1), device=self.device)
        self._classes, self._pairs = classes, pairs
        self._n_real, self._perm_host = d_real, t.perm
        self._x_raw, self._y_raw = x, y
        self._xp_host, self._maskp_host = xp_host, maskp.astype(np.float32)
        self._fac_cache = {float(beta): self._fac}
        self._rho_floor = None
        return self._report

    # ------------------------------------------------------------------ #
    @property
    def n_problems(self) -> int:
        assert self._ys is not None, "call prepare() first"
        return int(self._ys.shape[0])

    @property
    def problem_labels(self) -> torch.Tensor:
        """(P, d) per-problem ±1 labels (or regression targets) in tree order."""
        assert self._ys is not None, "call prepare() first"
        return self._ys

    @property
    def problem_masks(self) -> torch.Tensor:
        """(P, d) participation masks (0 pins a coordinate to the [0,0] box)."""
        assert self._pmask is not None, "call prepare() first"
        return self._pmask

    @property
    def hss(self) -> HSSMatrix:
        assert self._hss is not None, "call prepare() first"
        return self._hss

    @property
    def fac(self) -> factorization.HSSFactorization:
        assert self._fac is not None, "call prepare() first"
        return self._fac

    @property
    def report(self) -> FitReport:
        assert self._report is not None
        return self._report

    # ------------------------------------------------------------------ #
    def train(self, c_value: float,
              warm: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> tuple[EngineModel, tuple[torch.Tensor, torch.Tensor]]:
        """ONE batched ADMM run over all P subproblems for a fixed knob:
        C for classification, ε for SVR (box bound ``svr_c``), ν for
        one-class; for KRR/GP, λ and one solve.  With ``admm.adapt_rho``
        the run rescales β between chunks (``admm_boxqp_adaptive``) and the
        report records the final β and the rescale count."""
        assert self._fac is not None, "call prepare() first"
        if self.task in ("krr", "gp"):
            return self._train_krr(c_value)
        if self.task == "oneclass" and not 0.0 < c_value <= 1.0:
            # ν > 1 makes eᵀα = 1 infeasible, ν <= 0 divides by zero
            raise ValueError(f"oneclass needs 0 < nu <= 1, got {c_value}")
        if self.task == "svr" and c_value < 0.0:
            raise ValueError(f"svr needs epsilon >= 0, got {c_value}")
        fac, ys, pmask = self._fac, self._ys, self._pmask
        z0, mu0 = (None, None) if warm is None else warm

        sync(self.device)
        t0 = time.perf_counter()
        task = self._build_task(ys, pmask, c_value)
        rho_info = None
        if self.admm.adapt_rho:
            state, trace, rho_info = admm_mod.admm_boxqp_adaptive(
                lambda b: self._fac_for(b).solve_mat, task, fac.beta, self.admm,
                z0=z0, mu0=mu0,
                beta_min=self.rho_floor() if self.admm.rho_guard else 0.0,
                mesh=self._mesh)
        else:
            state, trace = admm_mod.admm_boxqp(
                fac.solve_mat, task, fac.beta, self.admm.max_it, tol=self.admm.tol,
                z0=z0, mu0=mu0, mesh=self._mesh)
        sync(self.device)
        t1 = time.perf_counter()
        z = state.z
        if self.task == "svr":
            biases = tasks_mod.compute_bias_svr_batched(
                self._hss, ys.T, z, self.svr_c * pmask.T, pmask.T, c_value)
        elif self.task == "oneclass":
            biases = -tasks_mod.compute_rho_oneclass_batched(
                self._hss, z, task.hi, pmask.T)
        else:
            biases = compute_bias_batched(
                self._hss, ys.T, z, c_value * pmask.T, pmask.T)
        self._report.admm_s += t1 - t0
        self._report.iters_run = tuple(int(i) for i in trace.iters_run.tolist())
        if rho_info is not None:
            self._report.rho_final = rho_info["beta"]
            self._report.rho_rescales = rho_info["rescales"]

        model = EngineModel(
            x_perm=self._hss.x, z_y=task.sign * z, biases=biases,
            classes=self._classes, spec=self.spec, c_value=c_value,
            binary=self._binary, strategy=self.strategy, task=self.task,
            pairs=self._pairs, beta=float(fac.beta), mesh=self._mesh)
        return model, (z, state.mu)

    def _build_task(self, ys: torch.Tensor, pmask: torch.Tensor, knob: float
                    ) -> admm_mod.BoxQPTask:
        """The engine's knob → BoxQPTask rule."""
        if self.task == "svr":
            return tasks_mod.svr_task(ys, self.svr_c * pmask, knob)
        if self.task == "oneclass":     # the box needs the real count of all ranks
            return tasks_mod.one_class_task(
                pmask, knob, n_real=dist_api.all_reduce_sum(pmask.sum(1), self._mesh))
        return admm_mod.svm_task(ys, knob * pmask)

    def rho_floor(self) -> float:
        """The β below which ADMM can diverge on K̃: 2·|λ_min(K̃)|, with
        |λ_min| at Lanczos' bound ρ − θ (``lanczos.lowest_eigenvalue``), and
        0 when that bound says K̃ is positive semidefinite.  Under
        ``admm.rho_guard`` residual balancing never rescales β below it.

        Why twice: a crude compression of a positive-definite kernel can
        leave K̃ indefinite, and the x-step then minimizes a nonconvex
        quadratic.  Near a solution the box blocks every direction of
        negative curvature, since the minimum sits against it.  Take a
        blocked eigendirection of K̃ with eigenvalue −|λ|.  One ADMM step
        (Douglas–Rachford form) multiplies its error by
        ½(1 − (β + |λ|)/(β − |λ|)) = −|λ|/(β − |λ|): the resolvent's
        reflection times the box's reflection, −1 on a blocked coordinate.
        That factor has modulus below 1 only if β > 2|λ|.  Between |λ| and
        2|λ| the error grows with alternating sign; at β ≤ |λ| the x-step
        has no minimum at all.  The factor of 2 is the worst case, a
        direction blocked in every coordinate; the boundaries measured on
        blobs K̃ lie just below it (tests/test_torch_rho_floor.py;
        chip_smoke.py's [adaptive-rho]).  Computed once per prepared K̃.
        The reference has no floor."""
        assert self._hss is not None, "call prepare() first"
        if self._rho_floor is None:
            theta, resid = lanczos_mod.lowest_eigenvalue(self._hss)
            self._rho_floor = 2.0 * max(0.0, resid - theta)
        return self._rho_floor

    def _fac_for(self, beta: float) -> factorization.HSSFactorization:
        """Factorization of K̃ + βI, cached per visited β (one O(N r²)
        refactorization the first time each β is visited)."""
        fac = self._fac_cache.get(float(beta))
        if fac is None:      # a node-split K̃ gives a node-split factorization
            fac = factorization.factorize(self._hss, beta, store_dtype=self.store_dtype)
            self._fac_cache[float(beta)] = fac
        return fac

    def _train_krr(self, lam: float
                   ) -> tuple[EngineModel, tuple[torch.Tensor, torch.Tensor]]:
        """KRR / GP-mean train: ONE multi-RHS solve, ZERO ADMM iterations;
        λ rides the factorization's β slot (``_fac_for``)."""
        if not lam > 0.0:
            raise ValueError(f"{self.task} needs lambda > 0, got {lam}")
        ys, pmask = self._ys, self._pmask
        n_prob = ys.shape[0]
        sync(self.device)
        t0 = time.perf_counter()
        fac = self._fac_for(float(lam))
        sync(self.device)
        t1 = time.perf_counter()
        # pads decouple exactly ((1+λ)I block, zero targets); the mask only
        # clips factorization float noise off the pad coefficients
        alpha = krr_mod.krr_solve(fac, ys.T) * pmask.T
        sync(self.device)
        t2 = time.perf_counter()
        self._report.factorization_s += t1 - t0
        self._report.admm_s += t2 - t1
        self._report.iters_run = (0,) * n_prob
        model = EngineModel(
            x_perm=self._hss.x, z_y=alpha,
            biases=torch.zeros((n_prob,), dtype=torch.float32, device=self.device),
            classes=self._classes, spec=self.spec, c_value=lam, binary=False,
            strategy=self.strategy, task=self.task, pairs=None, beta=float(fac.beta),
            mesh=self._mesh)
        return model, (alpha, alpha)

    def log_marginal(self, lam: float, n_probes: int = 4, num_iters: int = 20,
                     seed: int = 0, probes: torch.Tensor | None = None) -> float:
        """GP log marginal likelihood estimate at noise λ
        (``krr.gp_log_marginal``): the ``task="gp"`` (h, λ) grid score.
        ``probes`` (n_probes, d) are of full length under a mesh too."""
        assert self._fac is not None, "call prepare() first"
        if self.task not in ("krr", "gp"):
            raise ValueError(f"log_marginal needs task='krr'/'gp', got {self.task!r}")
        return krr_mod.gp_log_marginal(
            self._hss, self._fac_for(float(lam)), self._ys[0], mask=self._pmask[0],
            n_probes=n_probes, num_iters=num_iters, probes=probes, seed=seed)

    def top_eigenpairs(self, k: int, num_iters: int | None = None, seed: int = 0,
                       v0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Leading k eigenpairs of the compressed kernel (Lanczos on the
        O(N r) matvec), in permuted/padded row order — any prepared task.
        Under a mesh the vectors are this rank's rows; ``v0`` is of full
        length."""
        assert self._hss is not None, "call prepare() first"
        return lanczos_mod.top_eigenpairs(self._hss, k, num_iters=num_iters, v0=v0,
                                          seed=seed)

    def spectral_embed(self, k: int, num_iters: int | None = None, seed: int = 0,
                       v0: torch.Tensor | None = None) -> np.ndarray:
        """Kernel-PCA coordinates (n, k) for the ORIGINAL input rows:
        eigenvectors scaled by √eigenvalue, mapped back through the tree
        permutation with pad rows dropped."""
        evals, vecs = self.top_eigenpairs(k, num_iters=num_iters, seed=seed, v0=v0)
        vecs = dist_api.all_gather_nodes(vecs, self._mesh)     # every rank: all rows
        emb = (vecs * torch.sqrt(torch.clamp(evals, min=0.0))[None, :]).cpu().numpy()
        out = np.zeros((self._n_real, k), np.float32)
        real = self._perm_host < self._n_real
        out[self._perm_host[real]] = emb[real]
        return out

    def train_multilevel(
        self,
        c_value: float,
        coarse_frac: float = 0.125,
        coarse_comp: compression.CompressionParams | None = None,
        coarse_leaf_size: int | None = None,
        seed: int = 0,
    ) -> tuple[EngineModel, dict]:
        """AML-SVM-style multilevel warm start (arXiv 2011.02592).

        Train the same task on a ``coarse_frac`` subsample with a CRUDE
        compression (``CompressionParams.crude`` unless overridden) on a
        resident engine, prolong the coarse duals to the full point set by
        nearest-neighbour interpolation (``prolong_duals`` over the padded,
        permuted host points, times ``tasks.prolong_scale``; fine pads get
        zero), and let the warm-started ADMM finish: ``FitReport.iters_run``
        then shows the iterations saved against a cold ``train``.  The
        subsample is stratified per class for classification, so the coarse
        problem set (OVR columns / OVO pairs) matches the fine one.

        Returns (model, info) with the coarse size and both iteration
        records.  Needs ``prepare``; the fine factorization is reused.
        Under a mesh every rank trains the same coarse problem locally.
        """
        assert self._fac is not None, "call prepare() first"
        x, y = self._x_raw, self._y_raw
        n = x.shape[0]
        leaf_c = coarse_leaf_size or min(self.leaf_size, 64)
        n_c = int(max(min(n, 2 * leaf_c), round(n * coarse_frac)))
        rng = np.random.default_rng(seed)
        if self.task == "svm":
            parts = []
            for cls in self._classes:
                rows = np.nonzero(y == cls)[0]
                want = max(1, int(round(len(rows) * n_c / n)))
                parts.append(rng.choice(rows, size=min(want, len(rows)), replace=False))
            idx = np.sort(np.concatenate(parts))
        else:
            idx = np.sort(rng.choice(n, size=min(n_c, n), replace=False))

        coarse = HSSSVMEngine(
            spec=self.spec, comp=coarse_comp or compression.CompressionParams.crude(),
            leaf_size=leaf_c, beta=self.beta, admm=self.admm, strategy=self.strategy,
            store_dtype=self.store_dtype, task=self.task, svr_c=self.svr_c,
            device=self.device)
        coarse.prepare(x[idx], None if self.task == "oneclass" else y[idx])
        _, (z_c, mu_c) = coarse.train(c_value)

        scale = tasks_mod.prolong_scale(
            self.task, int(coarse._maskp_host.sum()), int(self._maskp_host.sum()))
        mask = self._maskp_host[:, None]          # fine pads carry no dual mass
        warm = tuple(         # prolonged on the host, then this rank's rows
            torch.as_tensor(self._rows(
                (prolong_duals(coarse._xp_host, v.cpu().numpy(), self._xp_host)
                 * scale * mask).astype(np.float32)), device=self.device)
            for v in (z_c, mu_c))
        model, _ = self.train(c_value, warm=warm)
        info = dict(coarse_n=int(idx.shape[0]),
                    coarse_iters_run=coarse.report.iters_run,
                    iters_run=self.report.iters_run)
        return model, info

    # ------------------------------------------------------------------ #
    def train_grid(self, c_values: Sequence[float], warm_start: bool = True
                   ) -> list[EngineModel]:
        """Warm-started knob sweep (C / ε / ν / λ) reusing the one
        compression + factorization."""
        warm = None
        models = []
        for c in c_values:
            model, w = self.train(float(c), warm=warm)
            if warm_start:
                warm = w
            models.append(model)
        return models

    def fit(self, x: np.ndarray, y: np.ndarray | None = None,
            c_value: float = 1.0) -> EngineModel:
        self.prepare(x, y)
        model, _ = self.train(c_value)
        return model
