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
task.  A mesh (ROADMAP queue 1 item 13), a streamed build, adaptive ρ and
the multilevel warm start (item 10) raise NotImplementedError.
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
from repro_torch.core.svm import FitReport, build, compute_bias_batched, sync

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

    @property
    def n_classes(self) -> int:
        return int(self.classes.shape[0])

    def decision_function(self, x_test, block: int = DEFAULT_SCORE_BLOCK
                          ) -> torch.Tensor:
        """Scores (n_test, P); single-column models (binary SVM, SVR,
        one-class, KRR/GP) return the flat (n_test,) column."""
        x_test = torch.as_tensor(x_test, dtype=torch.float32,
                                 device=self.x_perm.device)
        scores = kernel_matvec_streamed(
            self.spec, x_test, self.x_perm, self.z_y, block=block)
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
    stream: object = None
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

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError("a mesh is ROADMAP queue 1 item 13")
        if self.stream is not None:
            raise NotImplementedError("the streamed build is ROADMAP queue 1 item 10")
        self.device = torch.device(self.device)

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
            x, y.astype(np.float32), self.leaf_size)
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
            xp_host, t, maskp, self.spec, self.comp, beta, self.device, self.store_dtype)
        self._ys = torch.as_tensor(ys, device=self.device)
        self._pmask = torch.as_tensor(pmasks, device=self.device)
        self._classes, self._pairs = classes, pairs
        self._n_real, self._perm_host = d_real, t.perm
        self._fac_cache = {float(beta): self._fac}
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
        one-class; for KRR/GP, λ and one solve."""
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
        state, trace = admm_mod.admm_boxqp(
            fac.solve_mat, task, fac.beta, self.admm.max_it, tol=self.admm.tol,
            z0=z0, mu0=mu0)
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

        model = EngineModel(
            x_perm=self._hss.x, z_y=task.sign * z, biases=biases,
            classes=self._classes, spec=self.spec, c_value=c_value,
            binary=self._binary, strategy=self.strategy, task=self.task,
            pairs=self._pairs, beta=float(fac.beta))
        return model, (z, state.mu)

    def _build_task(self, ys: torch.Tensor, pmask: torch.Tensor, knob: float
                    ) -> admm_mod.BoxQPTask:
        """The engine's knob → BoxQPTask rule."""
        if self.task == "svr":
            return tasks_mod.svr_task(ys, self.svr_c * pmask, knob)
        if self.task == "oneclass":
            return tasks_mod.one_class_task(pmask, knob)
        return admm_mod.svm_task(ys, knob * pmask)

    def _fac_for(self, beta: float) -> factorization.HSSFactorization:
        """Factorization of K̃ + βI, cached per visited β (one O(N r²)
        refactorization the first time each β is visited)."""
        fac = self._fac_cache.get(float(beta))
        if fac is None:
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
            strategy=self.strategy, task=self.task, pairs=None, beta=float(fac.beta))
        return model, (alpha, alpha)

    def log_marginal(self, lam: float, n_probes: int = 4, num_iters: int = 20,
                     seed: int = 0, probes: torch.Tensor | None = None) -> float:
        """GP log marginal likelihood estimate at noise λ
        (``krr.gp_log_marginal``): the ``task="gp"`` (h, λ) grid score."""
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
        O(N r) matvec), in permuted/padded row order — any prepared task."""
        assert self._hss is not None, "call prepare() first"
        return lanczos_mod.top_eigenpairs(self._hss, k, num_iters=num_iters, v0=v0,
                                          seed=seed)

    def spectral_embed(self, k: int, num_iters: int | None = None, seed: int = 0,
                       v0: torch.Tensor | None = None) -> np.ndarray:
        """Kernel-PCA coordinates (n, k) for the ORIGINAL input rows:
        eigenvectors scaled by √eigenvalue, mapped back through the tree
        permutation with pad rows dropped."""
        evals, vecs = self.top_eigenpairs(k, num_iters=num_iters, seed=seed, v0=v0)
        emb = (vecs * torch.sqrt(torch.clamp(evals, min=0.0))[None, :]).cpu().numpy()
        out = np.zeros((self._n_real, k), np.float32)
        real = self._perm_host < self._n_real
        out[self._perm_host[real]] = emb[real]
        return out

    def train_multilevel(self, c_value: float, **kw):
        raise NotImplementedError(
            "the multilevel warm start (prolong_duals) is ROADMAP queue 1 item 10")

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
