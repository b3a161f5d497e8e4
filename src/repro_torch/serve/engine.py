"""High-throughput serving engine: many models, one process, batched ticks.

Counterpart of ``repro.serve.engine`` on one device.  Scoring is a streamed
kernel matvec over the support set, and every model trained on one
``(K̃ + βI)`` factorization scores against the same support points, so:

  * **Shared-factorization score cache.**  Loaded models are grouped by
    ``(kernel, h, β, support-set digest)``; one LRU entry per key holds the
    ONE device copy of the support points plus the (d, ΣP) block of every
    member model's dual-coefficient columns.  k models of one factorization
    cost one support upload, and one kernel pass scores all of them.
  * **Request-level dynamic batching.**  ``submit`` enqueues; a *tick*
    (``flush``: the max-batch threshold, the threaded driver's max-wait
    timer, or an explicit call) concatenates every queued query of a group
    into one block, pads it to a fixed BUCKET shape and runs one
    multi-column scorer launch per bucket-sized chunk.  Scores come back to
    the host once per tick and are de-interleaved per request.
  * **One CUDA graph per bucket.**  The reference compiles one XLA program
    per bucket.  On a CUDA device the engine captures the scorer once per
    (group, bucket, column count) into a ``torch.cuda.CUDAGraph`` (one
    memory pool shared by the engine's graphs) and replays it; each bucket
    has a fixed staging buffer the host chunk is copied into.  Replacing a
    group's device tensors (eviction, re-upload, appended columns) drops
    its graphs.  On the CPU the scorer runs eagerly.
  * **bf16 block evaluation.**  ``BatchPolicy.compute_dtype="bfloat16"``
    evaluates the test×support blocks from bf16 operands with every product
    and sum in f32.

The f32 scorer is ``kernelfn.kernel_matvec_streamed``: K1 (gaussian) or K4
(laplacian) on CUDA tensors, their plain versions on CPU tensors.  A graph
replay runs no Python, so the engine adds each graph's captured kernel
launches to ``kernels._build.launch_counts`` on every replay.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.engine import EngineModel
from repro_torch.core.kernelfn import (
    DEFAULT_SCORE_BLOCK, KernelSpec, kernel_block, kernel_matvec_streamed,
)
from repro_torch.kernels import _build


# --------------------------------------------------------------------- #
# scoring                                                                #
# --------------------------------------------------------------------- #
def _bf16_matvec_streamed(spec: KernelSpec, x_rows: torch.Tensor, x_cols: torch.Tensor,
                          v: torch.Tensor, block: int) -> torch.Tensor:
    """``kernel_matvec_streamed`` from bf16 operands, f32 products and sums.

    Gaussian blocks use the matmul expansion.  The bf16-rounded operands are
    upcast and multiplied in f32 (TF32 off): a product of two bf16 values is
    exact in f32, so this is the reference's bf16×bf16→f32 contraction.  A
    bf16×bf16 ``torch.matmul`` would round the cross term to bf16 instead.
    Laplacian blocks run K4 on bf16 operands (L1 summed in f32, the block
    rounded to bf16), then the score product in f32.
    """
    bf16 = torch.bfloat16
    xc = x_cols.to(bf16)
    vc = v.to(bf16).float()
    out = []
    if spec.name == "gaussian":
        xcf = xc.float()
        nb = (xcf * xcf).sum(1)
        scale = -0.5 / (spec.h * spec.h)
        for i in range(0, x_rows.shape[0], block):
            xb = x_rows[i:i + block].to(bf16).float()
            na = (xb * xb).sum(1)
            sq = torch.clamp(na[:, None] + nb[None, :] - 2.0 * (xb @ xcf.T), min=0.0)
            out.append(torch.exp(sq * scale) @ vc)
    else:
        for i in range(0, x_rows.shape[0], block):
            out.append(kernel_block(spec, x_rows[i:i + block].to(bf16), xc).float() @ vc)
    return torch.cat(out, dim=0)


def batched_scores(xq: torch.Tensor, xs: torch.Tensor, zy: torch.Tensor,
                   biases: torch.Tensor, *, spec: KernelSpec,
                   block: int = DEFAULT_SCORE_BLOCK,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """Scores ``(n_q, P) = K(xq, xs) @ zy + biases`` for a column block
    covering any number of same-factorization models.

    The f32 path is ``kernel_matvec_streamed``, the code
    ``EngineModel.decision_function`` runs.
    """
    if compute_dtype == "float32":
        scores = kernel_matvec_streamed(spec, xq, xs, zy, block=block)
    elif compute_dtype == "bfloat16":
        scores = _bf16_matvec_streamed(spec, xq, xs, zy, block)
    else:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return scores + biases[None, :]


# --------------------------------------------------------------------- #
# per-task decode (host side, once per tick)                             #
# --------------------------------------------------------------------- #
def _ovo_vote_np(scores: np.ndarray, pairs: np.ndarray, n_classes: int
                 ) -> np.ndarray:
    """Numpy twin of ``multiclass.ovo_vote`` (same tie-break, host-side).

    The per-class scatter-adds are matmuls against fixed (P, k) incidence
    matrices (``np.add.at`` is an order of magnitude slower)."""
    scores = scores.astype(np.float32)
    winner = np.where(scores >= 0, pairs[:, 0][None, :], pairs[:, 1][None, :])
    votes = (winner[:, :, None] == np.arange(n_classes)[None, None, :]).sum(axis=1)
    inc = np.zeros((pairs.shape[0], n_classes), np.float32)
    rows = np.arange(pairs.shape[0])
    inc[rows, pairs[:, 0]] = 1.0
    inc[rows, pairs[:, 1]] = -1.0
    margin = scores @ inc
    return np.argmax(votes + 1e-3 * np.tanh(margin), axis=1)


def decode_predictions(scores: np.ndarray, *, task: str, binary: bool,
                       strategy: str, classes: np.ndarray,
                       pairs: np.ndarray | None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(decision values, predictions) from a model's (n, P) score columns,
    matching ``EngineModel.decision_function`` / ``predict``: single-column
    tasks return the flat score column."""
    if task in ("svr", "krr", "gp"):     # regression: raw-value decode
        flat = scores[:, 0]
        return flat, flat
    if task == "oneclass" or binary:
        flat = scores[:, 0]
        return flat, np.where(flat >= 0, 1, -1)
    if strategy == "ovr":
        idx = np.argmax(scores, axis=1)
    else:
        idx = _ovo_vote_np(scores, pairs, int(classes.shape[0]))
    return scores, np.asarray(classes)[idx]


# --------------------------------------------------------------------- #
# batching policy / tickets / groups                                     #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Tick policy knobs.

    ``buckets`` are the padded batch shapes a tick may launch: occupancy is
    padded UP to the smallest fitting bucket, so the scorer is captured once
    per bucket (and per loaded column count), never once per queue length.
    Oversize ticks are chunked at ``buckets[-1]``.  ``max_batch`` queued
    queries trigger an immediate tick; ``max_wait_ms`` is the threaded
    driver's tick period.  ``block`` is the streamed score block size.
    """

    max_batch: int = 4096
    max_wait_ms: float = 2.0
    buckets: tuple = (64, 256, 1024, 4096)
    block: int = DEFAULT_SCORE_BLOCK
    compute_dtype: str = "float32"      # "float32" | "bfloat16"

    def __post_init__(self):
        if not self.buckets or tuple(sorted(self.buckets)) != self.buckets:
            raise ValueError("buckets must be ascending and non-empty")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]


class Ticket:
    """Handle for one submitted request; resolved at the covering tick."""

    __slots__ = ("_engine", "_event", "scores", "predictions", "t_submit", "t_done")

    def __init__(self, engine: "ServingEngine"):
        self._engine = engine
        self._event = threading.Event()
        self.scores = None
        self.predictions = None
        self.t_submit = time.perf_counter()
        self.t_done = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, scores, predictions) -> None:
        self.scores, self.predictions = scores, predictions
        self.t_done = time.perf_counter()
        self._event.set()

    def result(self, timeout: float | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(decision values, predictions).  Without the threaded driver a
        pending ticket is resolved by running a tick now."""
        if not self._event.is_set() and not self._engine.running:
            self._engine.flush()
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        return self.scores, self.predictions

    @property
    def latency_s(self) -> float:
        assert self.t_done is not None, "not resolved yet"
        return self.t_done - self.t_submit


@dataclasses.dataclass
class _ModelEntry:
    key: tuple
    col0: int
    col1: int
    task: str
    binary: bool
    strategy: str
    classes: np.ndarray
    pairs: np.ndarray | None


@dataclasses.dataclass
class _Graph:
    """One captured scorer launch: its staging buffer, its output and the
    kernel launches one replay makes."""

    graph: torch.cuda.CUDAGraph
    x_in: torch.Tensor
    out: torch.Tensor
    launches: dict


class _Group:
    """One cache entry: host master copies + the device-resident mirrors."""

    def __init__(self, key: tuple, spec: KernelSpec, xs: np.ndarray):
        self.key = key
        self.spec = spec
        self.xs_host = xs                     # (d, f): shared, immutable
        self.zy_host = np.zeros((xs.shape[0], 0), np.float32)
        self.biases_host = np.zeros((0,), np.float32)
        self.xs_dev: torch.Tensor | None = None      # uploaded at most once
        self.zy_dev: torch.Tensor | None = None      # per residency span
        self.biases_dev: torch.Tensor | None = None
        self.graphs: dict[tuple, _Graph] = {}  # (bucket, n_cols) -> graph
        self.queue: list[tuple[Ticket, _ModelEntry, np.ndarray]] = []
        self.queued_rows = 0

    @property
    def resident(self) -> bool:
        return self.xs_dev is not None

    def drop_device(self, support: bool) -> None:
        """Forget the device mirrors (the support points too if
        ``support``), and every graph captured on their addresses."""
        if support:
            self.xs_dev = None
        self.zy_dev = self.biases_dev = None
        self.graphs.clear()

    def append_columns(self, zy: np.ndarray, biases: np.ndarray) -> tuple[int, int]:
        col0 = self.zy_host.shape[1]
        self.zy_host = np.concatenate([self.zy_host, zy.astype(np.float32)], axis=1)
        self.biases_host = np.concatenate(
            [self.biases_host, biases.astype(np.float32).reshape(-1)])
        # the column block changed shape: its device mirror (and the graphs
        # reading it) are stale; the support points are not
        self.drop_device(support=False)
        return col0, self.zy_host.shape[1]


def _support_digest(xs: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(str((xs.shape, str(xs.dtype))).encode())
    h.update(np.ascontiguousarray(xs).tobytes())
    return h.hexdigest()


def group_key(model: EngineModel, xs_host: np.ndarray) -> tuple:
    """The factorization-sharing cache key: models agreeing on it were
    trained on the same ``(K̃ + βI)`` build and score against the same
    device-resident support state.  (The port's ``KernelSpec`` has no
    ``impl``: one implementation per device.)"""
    spec = model.spec
    beta = None if model.beta is None else float(model.beta)
    return (spec.name, float(spec.h), beta, _support_digest(xs_host))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------- #
# the engine                                                             #
# --------------------------------------------------------------------- #
class ServingEngine:
    """Many trained models behind one process, scored in batched ticks.

    ``max_resident`` bounds how many cache entries hold device memory at
    once (LRU): evicting drops the entry's device tensors and graphs only;
    the host master copies stay, and the next request to a member model
    re-uploads (counted in ``stats()['support_uploads']``).  ``device`` is
    where support points live and scoring runs ("cuda" unless the caller
    asks for another).
    """

    def __init__(self, policy: BatchPolicy = BatchPolicy(), registry=None,
                 max_resident: int = 8, device: str | torch.device = "cuda"):
        self.policy = policy
        self.registry = registry
        self.max_resident = max_resident
        self.device = torch.device(device)
        self._groups: "OrderedDict[tuple, _Group]" = OrderedDict()
        self._models: dict[str, _ModelEntry] = {}
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._running = False
        self._counter = 0
        self._latencies: list[float] = []
        self._n_uploads = 0
        self._n_evictions = 0
        self._n_ticks = 0
        self._n_launches = 0
        self._n_queries = 0
        self._n_requests = 0
        self._n_captures = 0
        self._n_replays = 0
        # distinct scorer signatures: what the reference's jit cache keys on
        self._signatures: set = set()
        self._pool = None        # the engine's graphs share one memory pool

    # ------------------------------------------------------------------ #
    # model management                                                    #
    # ------------------------------------------------------------------ #
    def add_model(self, model: EngineModel, model_id: str | None = None) -> str:
        """Register an in-memory model; returns its id.  Same-key models
        join the existing cache entry (no second support upload).  A model
        trained under a mesh is gathered once (every rank of the mesh must
        make this call): serving holds the whole support in one process."""
        model = model.gathered()
        xs = _host(model.x_perm).astype(np.float32)
        zy = _host(model.z_y)
        if zy.ndim == 1:
            zy = zy[:, None]
        biases = _host(model.biases).reshape(-1)
        key = group_key(model, xs)
        with self._lock:
            if model_id is None:
                self._counter += 1
                model_id = f"m{self._counter}"
            if model_id in self._models:
                raise ValueError(f"model id {model_id!r} already loaded")
            group = self._groups.get(key)
            if group is None:
                group = _Group(key, model.spec, xs)
                self._groups[key] = group
            col0, col1 = group.append_columns(zy, biases)
            self._models[model_id] = _ModelEntry(
                key=key, col0=col0, col1=col1, task=model.task, binary=model.binary,
                strategy=model.strategy, classes=np.asarray(model.classes),
                pairs=None if model.pairs is None else np.asarray(model.pairs))
        return model_id

    def load(self, name: str, version: int | None = None,
             prune_tol: float | None = None, model_id: str | None = None) -> str:
        """Load a registry model into the engine; returns its id."""
        if self.registry is None:
            raise RuntimeError("engine was built without a registry")
        model, info = self.registry.load(name, version=version, prune_tol=prune_tol,
                                         device=self.device)
        return self.add_model(model, model_id=model_id or f"{name}@v{info.version}")

    def model_group(self, model_id: str) -> _Group:
        """The cache entry a model scores through (tests/introspection)."""
        return self._groups[self._models[model_id].key]

    # ------------------------------------------------------------------ #
    # cache residency                                                     #
    # ------------------------------------------------------------------ #
    def _ensure_resident(self, group: _Group) -> None:
        self._groups.move_to_end(group.key)          # LRU touch
        if group.xs_dev is None:
            group.xs_dev = torch.as_tensor(group.xs_host, device=self.device)
            self._n_uploads += 1
        if group.zy_dev is None:
            group.zy_dev = torch.as_tensor(group.zy_host, device=self.device)
            group.biases_dev = torch.as_tensor(group.biases_host, device=self.device)
        # evict least-recently-used resident entries past the budget
        # (device tensors and graphs only: the host master copies stay)
        resident = [g for g in self._groups.values() if g.resident and g.key != group.key]
        excess = len(resident) + 1 - self.max_resident
        for g in resident[:max(excess, 0)]:
            g.drop_device(support=True)
            self._n_evictions += 1

    # ------------------------------------------------------------------ #
    # request path                                                        #
    # ------------------------------------------------------------------ #
    def submit(self, model_id: str, x) -> Ticket:
        """Enqueue a request of one or more query points; returns a ticket
        resolved at the next covering tick."""
        entry = self._models[model_id]
        xq = np.asarray(x, np.float32)
        if xq.ndim == 1:
            xq = xq[None, :]
        ticket = Ticket(self)
        with self._lock:
            group = self._groups[entry.key]
            group.queue.append((ticket, entry, xq))
            group.queued_rows += xq.shape[0]
            if group.queued_rows >= self.policy.max_batch:
                if self._running:
                    self._cond.notify()       # wake the driver for the tick
                else:
                    self._flush_group(group)
        return ticket

    def score(self, model_id: str, x, timeout: float | None = 30.0
              ) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous scoring entry point: submit + tick + result.  Under
        the threaded driver it waits for the covering tick."""
        return self.submit(model_id, x).result(timeout=timeout)

    def flush(self) -> int:
        """Run one tick: score every queued request, group by group.
        Returns the number of requests resolved."""
        n = 0
        with self._lock:
            for group in list(self._groups.values()):
                n += self._flush_group(group)
        return n

    def _flush_group(self, group: _Group) -> int:
        queue, group.queue = group.queue, []
        group.queued_rows = 0
        if not queue:
            return 0
        self._ensure_resident(group)
        xq = np.concatenate([q for _, _, q in queue], axis=0)
        scores = self._score_rows(group, xq)
        self._n_ticks += 1
        # de-interleave: rows per request, columns per model
        row = 0
        for ticket, entry, q in queue:
            sl = scores[row:row + q.shape[0], entry.col0:entry.col1]
            row += q.shape[0]
            vals, preds = decode_predictions(
                sl, task=entry.task, binary=entry.binary, strategy=entry.strategy,
                classes=entry.classes, pairs=entry.pairs)
            ticket._resolve(vals, preds)
            self._latencies.append(ticket.latency_s)
        self._n_requests += len(queue)
        return len(queue)

    def _scorer(self, group: _Group, xq: torch.Tensor, block: int) -> torch.Tensor:
        return batched_scores(xq, group.xs_dev, group.zy_dev, group.biases_dev,
                              spec=group.spec, block=block,
                              compute_dtype=self.policy.compute_dtype)

    def _score_rows(self, group: _Group, xq: np.ndarray) -> np.ndarray:
        """One (or, past the largest bucket, a few) padded scorer launches
        covering every queued query row of the tick."""
        pol = self.policy
        out = []
        top = pol.buckets[-1]
        for start in range(0, xq.shape[0], top):
            chunk = xq[start:start + top]
            bucket = pol.bucket_for(chunk.shape[0])
            pad = bucket - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, chunk.shape[1]), chunk.dtype)])
            # row streaming bounds memory on LARGE query sets: a small bucket
            # must not pad up to a full policy.block of kernel rows
            block = min(pol.block, bucket)
            self._signatures.add((bucket, group.xs_host.shape, group.zy_host.shape[1],
                                  group.spec))
            if self.device.type == "cuda":
                scores = self._replay(group, chunk, block)
            else:
                scores = self._scorer(group, torch.from_numpy(chunk).to(self.device), block)
            self._n_launches += 1
            self._n_queries += bucket - pad
            out.append(_host(scores)[:bucket - pad])
        return np.concatenate(out, axis=0) if len(out) > 1 else out[0]

    def _replay(self, group: _Group, chunk: np.ndarray, block: int) -> torch.Tensor:
        """Score one padded chunk on the card through the group's graph of
        this shape.  The first chunk of a shape runs eagerly (the capture's
        warm-up, and this tick's result), then the graph is captured; later
        chunks are copied into its staging buffer and replayed.  A failed
        capture raises: there is no eager fallback."""
        key = (chunk.shape[0], group.zy_host.shape[1])
        g = group.graphs.get(key)
        if g is not None:
            g.x_in.copy_(torch.from_numpy(chunk))
            g.graph.replay()
            for name, n in g.launches.items():
                _build.launch_counts[name] += n
            self._n_replays += 1
            return g.out
        x_in = torch.as_tensor(chunk, device=self.device)
        scores = self._scorer(group, x_in, block)
        before = dict(_build.launch_counts)
        # the driver thread's current device need not be the engine's
        with torch.cuda.device(self.device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = self._scorer(group, x_in, block)
        # capturing launches nothing: keep what it recorded for the replays,
        # and take back only that (another thread may count launches too)
        launches = {k: v - before[k] for k, v in _build.launch_counts.items()
                    if v != before[k]}
        for k, n in launches.items():
            _build.launch_counts[k] -= n
        group.graphs[key] = _Graph(graph, x_in, out, launches)
        self._n_captures += 1
        return scores

    # ------------------------------------------------------------------ #
    # threaded max-wait driver                                            #
    # ------------------------------------------------------------------ #
    @property
    def running(self) -> bool:
        return self._running

    def start(self) -> None:
        """Background tick loop: flush every ``max_wait_ms`` or as soon as
        a group hits ``max_batch`` queued queries."""
        with self._lock:
            if self._running:
                return
            self._running = True

        def loop():
            while True:
                with self._cond:
                    if not self._running:
                        return
                    self._cond.wait(self.policy.max_wait_ms / 1e3)
                    if not self._running:
                        return
                self.flush()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.flush()                         # drain anything still queued

    # ------------------------------------------------------------------ #
    # observability                                                       #
    # ------------------------------------------------------------------ #
    def drain_latencies(self) -> list[float]:
        with self._lock:
            out, self._latencies = self._latencies, []
        return out

    def scorer_compiles(self) -> int:
        """Distinct scorer signatures (bucket, support shape, column count,
        spec): the reference's jit cache entries, one per (bucket,
        column-count) shape of each support set.  On the card each is
        captured once per residency span (``graph_captures``)."""
        return len(self._signatures)

    def stats(self) -> dict:
        with self._lock:
            resident = [g for g in self._groups.values() if g.resident]
            return dict(
                models=len(self._models),
                groups=len(self._groups),
                cache_entries=len(resident),
                resident_support_bytes=sum(g.xs_host.nbytes for g in resident),
                support_uploads=self._n_uploads,
                evictions=self._n_evictions,
                ticks=self._n_ticks,
                launches=self._n_launches,
                queries=self._n_queries,
                requests=self._n_requests,
                scorer_compiles=self.scorer_compiles(),
                graph_captures=self._n_captures,
                graph_replays=self._n_replays,
            )
