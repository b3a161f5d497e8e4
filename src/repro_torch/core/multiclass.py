"""Multiclass SVM training on ONE shared HSS factorization (paper Alg. 3 × k).

Counterpart of ``repro.core.multiclass``.  K̃ + βI does not depend on the
labels, so a one-vs-rest (or one-vs-one) reduction of a k-class problem
needs ONE compression and ONE factorization for every binary subproblem:
``HSSSVMEngine`` runs all of them as one (d, P) block (one multi-RHS solve
per iteration), the biases come from ONE ``HSSMatrix.matmat``, and
prediction streams each test × support kernel block against all P
coefficient columns.  This module holds the reductions and the vote the
engine uses, and the reference's trainer interface over the engine.
One-vs-one keeps the full padded coordinate set and pins every point
outside the pair to the box [0, 0], the mechanism that makes tree padding
inert.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import compression
from repro_torch.core.admm import ADMMParams
from repro_torch.core.kernelfn import KernelSpec
from repro_torch.core.svm import FitReport, resolve_rtol, run_grid_search


def ovr_problems(y: np.ndarray, classes: np.ndarray, real_mask: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, None]:
    """One-vs-rest label matrix (k, d) and participation masks (k, d)."""
    ys = np.where(y[None, :] == classes[:, None], 1.0, -1.0)
    masks = np.broadcast_to(real_mask[None, :], ys.shape)
    return ys.astype(np.float32), masks.astype(np.float32), None


def ovo_problems(y: np.ndarray, classes: np.ndarray, real_mask: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-vs-one problems: (P, d) labels and masks, (P, 2) class-index pairs.

    Points outside a pair keep label -1 but get the box [0, 0] via the mask.
    """
    k = classes.shape[0]
    pairs = np.array([(a, b) for a in range(k) for b in range(a + 1, k)],
                     dtype=np.int32).reshape(-1, 2)
    ys, masks = [], []
    for a, b in pairs:
        in_pair = (y == classes[a]) | (y == classes[b])
        ys.append(np.where(y == classes[a], 1.0, -1.0))
        masks.append((real_mask & in_pair).astype(np.float32))
    return (np.stack(ys).astype(np.float32), np.stack(masks).astype(np.float32),
            pairs)


def ovo_vote(scores: torch.Tensor, pairs: np.ndarray, n_classes: int) -> torch.Tensor:
    """One-vs-one decision: (n_test, P) pair scores -> (n_test,) class indices.

    Each pair votes for its winner; ties break toward the larger summed
    functional margin (votes + 1e-3·tanh(margin)), the first maximum winning.
    """
    pairs_t = torch.as_tensor(np.asarray(pairs), dtype=torch.long, device=scores.device)
    winner = torch.where(scores >= 0, pairs_t[:, 0][None, :], pairs_t[:, 1][None, :])
    votes = torch.nn.functional.one_hot(winner, n_classes).sum(1).to(scores.dtype)
    margin = torch.zeros_like(votes)
    margin.index_add_(1, pairs_t[:, 0], scores)
    margin.index_add_(1, pairs_t[:, 1], -scores)
    return torch.argmax(votes + 1e-3 * torch.tanh(margin), dim=1)


def class_index(scores: torch.Tensor, strategy: str, pairs: np.ndarray | None,
                n_classes: int) -> torch.Tensor:
    """(n_test, P) scores -> class indices: argmax (OVR) or the vote (OVO)."""
    if strategy == "ovr":
        return torch.argmax(scores, dim=1)
    return ovo_vote(scores, pairs, n_classes)


def __getattr__(name: str):
    # MulticlassSVMModel is the engine's model; engine.py imports this
    # module, so the name is looked up on first use
    if name == "MulticlassSVMModel":
        from repro_torch.core.engine import EngineModel
        return EngineModel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class MulticlassHSSSVMTrainer:
    """compress-once / factor-once / train-ALL-classes-at-once trainer: the
    reference's interface over one ``HSSSVMEngine``, whose models it returns
    (``MulticlassSVMModel`` is ``EngineModel``)."""

    spec: KernelSpec
    comp: compression.CompressionParams = dataclasses.field(
        default_factory=compression.CompressionParams)
    leaf_size: int = 128
    beta: float | None = None     # default: the paper's rule by dataset size
    max_it: int = 10
    strategy: str = "ovr"         # "ovr" | "ovo"
    device: str | torch.device = "cuda"
    engine: object = dataclasses.field(default=None, init=False)   # prepare() builds it
    _classes: np.ndarray | None = dataclasses.field(default=None, init=False)

    def prepare(self, x: np.ndarray, y: np.ndarray) -> FitReport:
        """Pad, build tree, compress ONCE, factorize ONCE for all classes."""
        from repro_torch.core.engine import HSSSVMEngine
        # the engine sees class indices, so two classes (±1 too) stay k-class
        self._classes, idx = np.unique(np.asarray(y), return_inverse=True)
        if self._classes.shape[0] < 2:
            raise ValueError("need at least 2 classes")
        self.engine = HSSSVMEngine(
            spec=self.spec, comp=self.comp, leaf_size=self.leaf_size, beta=self.beta,
            admm=ADMMParams(max_it=self.max_it), strategy=self.strategy,
            device=self.device)
        return self.engine.prepare(x, idx)

    @property
    def n_problems(self) -> int:
        assert self.engine is not None, "call prepare() first"
        return self.engine.n_problems

    def train(self, c_value: float,
              warm: tuple[torch.Tensor, torch.Tensor] | None = None):
        """ONE batched ADMM run training every class subproblem for fixed C."""
        assert self.engine is not None, "call prepare() first"
        model, state = self.engine.train(c_value, warm=warm)
        return dataclasses.replace(model, classes=self._classes), state

    def fit(self, x: np.ndarray, y: np.ndarray, c_value: float = 1.0):
        self.prepare(x, y)
        model, _ = self.train(c_value)
        return model

    @property
    def report(self) -> FitReport:
        assert self.engine is not None, "call prepare() first"
        return self.engine.report


def grid_search_multiclass(x: np.ndarray, y: np.ndarray, x_val: np.ndarray,
                           y_val: np.ndarray, hs: Sequence[float],
                           cs: Sequence[float], trainer_kwargs: dict | None = None,
                           rtol: float | None = None
                           ) -> tuple[object, dict]:
    """(h, C) grid over the full (C × class) product: per h ONE compression
    and ONE factorization serve the C sweep of all k subproblems, each C
    warm-started from the previous (d, P) iterates."""
    kw = resolve_rtol(trainer_kwargs, rtol)
    return run_grid_search(
        lambda h: MulticlassHSSSVMTrainer(spec=KernelSpec(h=h), **kw),
        x, y, x_val, y_val, hs, cs)
