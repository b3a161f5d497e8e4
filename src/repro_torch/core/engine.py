"""One orchestration layer for the HSS-ADMM SVM pipeline (paper Algorithm 3).

Counterpart of ``repro.core.engine`` on its local binary path:
partition (pad + cluster tree) → HSS compression → ULV-equivalent
factorization → ADMM → bias → prediction, on one device.  Everything the
engine builds lives on ``device`` ("cuda" unless the caller asks for
another); nothing moves between devices behind the caller's back.

Both kernels (``KernelSpec("gaussian" | "laplacian")``), fixed or adaptive
rank (``CompressionParams.rtol``, the ``.crude()``/``.accurate()`` presets;
an adaptive build is shrunk to its observed ranks before factorizing), and
f32 or bf16 factor storage (``store_dtype``).  Outside this slice —
multiclass labels, ``task`` other than "svm", a mesh, a streamed build or
adaptive ρ — the engine raises NotImplementedError naming the ROADMAP queue
item that ports it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import admm as admm_mod
from repro_torch.core import compression, factorization, tree as tree_mod
from repro_torch.core.hss import HSSMatrix, shrink_report
from repro_torch.core.kernelfn import (
    DEFAULT_SCORE_BLOCK, KernelSpec, kernel_matvec_streamed,
)
from repro_torch.core.svm import FitReport, compute_bias_batched


def _sync(device: torch.device) -> None:
    """Wait for queued device work, so a host clock reads the device's time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class EngineModel:
    """A trained binary classifier."""

    x_perm: torch.Tensor   # (d, f) padded+permuted training points
    z_y: torch.Tensor      # (d, P) per-problem y_i * z_i columns (pads are 0)
    biases: torch.Tensor   # (P,)
    classes: np.ndarray    # (2,) original class labels
    spec: KernelSpec
    c_value: float
    beta: float | None = None   # β of the factorization it was trained on

    def decision_function(self, x_test, block: int = DEFAULT_SCORE_BLOCK
                          ) -> torch.Tensor:
        """Scores (n_test,) of the binary problem."""
        x_test = torch.as_tensor(x_test, dtype=torch.float32,
                                 device=self.x_perm.device)
        scores = kernel_matvec_streamed(
            self.spec, x_test, self.x_perm, self.z_y, block=block)
        return (scores + self.biases[None, :])[:, 0]

    def predict(self, x_test, block: int = DEFAULT_SCORE_BLOCK) -> torch.Tensor:
        return torch.where(self.decision_function(x_test, block=block) >= 0, 1, -1)


@dataclasses.dataclass
class HSSSVMEngine:
    """pad + tree → compress → factorize → ADMM → bias/predict, one device."""

    spec: KernelSpec
    comp: compression.CompressionParams = dataclasses.field(
        default_factory=compression.CompressionParams)
    leaf_size: int = 128
    beta: float | None = None     # default: the paper's rule by dataset size
    admm: admm_mod.ADMMParams = dataclasses.field(     # max_it, residual tol
        default_factory=admm_mod.ADMMParams)
    mesh: object = None
    store_dtype: str | None = None
    task: str = "svm"
    stream: object = None
    device: str | torch.device = "cuda"

    # populated by prepare():
    _hss: HSSMatrix | None = None
    _fac: factorization.HSSFactorization | None = None
    _ys: torch.Tensor | None = None       # (P, d) per-problem ±1 labels
    _pmask: torch.Tensor | None = None    # (P, d) participation masks
    _classes: np.ndarray | None = None
    _report: FitReport | None = None

    def __post_init__(self):
        if self.task != "svm":
            raise NotImplementedError(
                f"task={self.task!r} is ROADMAP queue 1 items 7 and 9")
        if self.mesh is not None:
            raise NotImplementedError("a mesh is ROADMAP queue 1 item 13")
        if self.stream is not None:
            raise NotImplementedError("the streamed build is ROADMAP queue 1 item 10")
        self.device = torch.device(self.device)

    # ------------------------------------------------------------------ #
    def prepare(self, x: np.ndarray, y: np.ndarray) -> FitReport:
        """Pad + tree + compress ONCE + factorize ONCE (Alg. 3 lines 1–6)."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y)
        classes = np.unique(y)
        if classes.shape[0] < 2:
            raise ValueError("need at least 2 classes")
        if classes.shape[0] != 2 or set(classes.astype(np.float64).tolist()) != {-1.0, 1.0}:
            raise NotImplementedError(
                "labels other than binary ±1 (multiclass) are ROADMAP queue 1 item 7")
        d_real = x.shape[0]
        x_pad, y_pad, mask, levels = tree_mod.pad_dataset(
            x, y.astype(np.float32), self.leaf_size)
        t = tree_mod.build_tree(x_pad, self.leaf_size, levels)
        xp_host = x_pad[t.perm]
        ys = np.where(y_pad[t.perm] > 0, 1.0, -1.0)[None, :].astype(np.float32)
        pmasks = mask[t.perm][None, :].astype(np.float32)

        _sync(self.device)
        t0 = time.perf_counter()
        hss = compression.compress(xp_host, t, self.spec, self.comp,
                                   device=self.device)
        # Adaptive builds: slice every level to its observed max rank before
        # factorizing, so the factorization and every solve run at the
        # detected ranks.  Fixed-rank builds pass through.
        hss, rank_info = shrink_report(hss)
        _sync(self.device)
        t1 = time.perf_counter()
        beta = self.beta if self.beta is not None else admm_mod.paper_beta(d_real)
        fac = factorization.factorize(hss, beta, store_dtype=self.store_dtype)
        _sync(self.device)
        t2 = time.perf_counter()

        self._hss, self._fac = hss, fac
        self._ys = torch.as_tensor(ys, device=self.device)
        self._pmask = torch.as_tensor(pmasks, device=self.device)
        self._classes = classes
        self._report = FitReport(
            compression_s=t1 - t0,
            factorization_s=t2 - t1,
            admm_s=0.0,
            memory_mb=hss.memory_bytes() / 1e6,
            hss_levels=t.levels,
            beta=beta,
            kernel_evals=compression.kernel_eval_count(t, self.comp),
            **rank_info,
        )
        return self._report

    # ------------------------------------------------------------------ #
    @property
    def n_problems(self) -> int:
        assert self._ys is not None, "call prepare() first"
        return int(self._ys.shape[0])

    @property
    def problem_labels(self) -> torch.Tensor:
        """(P, d) per-problem ±1 labels in tree order."""
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
        """ONE batched ADMM run for a fixed C, reusing the factorization."""
        assert self._fac is not None, "call prepare() first"
        fac, ys, pmask = self._fac, self._ys, self._pmask
        z0, mu0 = (None, None) if warm is None else warm

        _sync(self.device)
        t0 = time.perf_counter()
        task = admm_mod.svm_task(ys, c_value * pmask)
        state, trace = admm_mod.admm_boxqp(
            fac.solve_mat, task, fac.beta, self.admm.max_it, tol=self.admm.tol,
            z0=z0, mu0=mu0)
        _sync(self.device)
        t1 = time.perf_counter()
        biases = compute_bias_batched(
            self._hss, ys.T, state.z, c_value * pmask.T, pmask.T)
        self._report.admm_s += t1 - t0
        self._report.iters_run = tuple(int(i) for i in trace.iters_run.tolist())

        model = EngineModel(
            x_perm=self._hss.x, z_y=task.sign * state.z, biases=biases,
            classes=self._classes, spec=self.spec, c_value=c_value,
            beta=float(fac.beta),
        )
        return model, (state.z, state.mu)

    def fit(self, x: np.ndarray, y: np.ndarray, c_value: float = 1.0) -> EngineModel:
        self.prepare(x, y)
        model, _ = self.train(c_value)
        return model
