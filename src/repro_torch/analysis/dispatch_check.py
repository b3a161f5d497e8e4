"""Layer 2: dispatch-level checks over the port's hot paths.

Counterpart of the reference's ``repro.analysis.jaxpr_check``.  There the
hot paths are traced with ``jax.make_jaxpr`` and the jaxpr is walked; eager
torch builds no program, so here each probe RUNS on a small synthetic
problem under a ``TorchDispatchMode`` (:class:`Recorder`) that records every
aten op with its input and output dtypes, and the record is walked.  The
facts asserted are the reference's:

  * **no-downcast** — no ``aten.mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
    ``linear`` / ``convolution`` / ``_scaled_mm`` with floating inputs has a
    bf16/f16 output (its accumulator), whatever the spelling above it
    (``@``, ``einsum``, ``F.linear``) — what ``precision-accumulate`` asks at
    the source level (``dtype_downcasts``);
  * **no-host-sync** — the twin of the reference's no-host-callback: no
    ``aten._local_scalar_dense`` (``.item()``, ``int(t)``, ``bool(t)``), no
    op whose output shape depends on the data (``nonzero``,
    ``masked_select``, ``unique``, ``bincount``, ``repeat_interleave``
    without ``output_size``, boolean-mask indexing), no linalg info read
    back to raise (``_linalg_check_errors``), no copy from the card to the
    host (``host_syncs``);
  * **one-compile-per-sweep** — a warm 4-point C-grid compresses once and
    factorizes once, and its ADMM iterations record no host sync
    (``check_recompile_engine``); the serving tier keeps one scorer per
    bucket — two over eight occupancies — and, on the card, two CUDA-graph
    captures (``check_serve_path``);
  * **streamed-stage purity**, the **compression kernels**' wrappers and the
    **kernel linear algebra** (``check_streamed_stage``,
    ``check_compress_kernels``, ``check_kernel_linalg``), as in the
    reference;
  * **mesh placement** — on 2 gloo ranks (``dist.api.spawn``) each rank's
    factor leaves have the shapes ``core.distributed.fac_shardings`` gives,
    its node range is ``dist.api.owned_range``'s, and ``hss.d_leaf`` /
    ``u_leaf`` / ``x`` are whole on no rank (``check_mesh_placement``).
    The reference also walks the mesh matmat / solve for its sharding
    pins, which the port does not have; their products are the local
    paths' (``check_hot_paths``) between the collectives.

On the card (``device="cuda"``) every probe also runs under
``torch.cuda.set_sync_debug_mode("error")``, so a sync the recorder cannot
see (inside a library call) raises and is reported, and TF32 must read
back off.  The recorder does not see inside the hand-written kernels (a
ctypes launch is no aten op); their accumulators are checked in the CUDA
sources by ``precision-accumulate``'s text scan.

Like the reference, ``compression.compress`` is not probed: it is
host-orchestrated by design (proxy selection in numpy).  Its per-level
device stages are (``check_compress_kernels``, ``check_streamed_stage``).

Findings carry line 0, the probe's entry as ``<trace:entry>`` and, as
``line_content``, a short stable description of what was seen, so that a
baseline entry suppresses that one fact and nothing else of the entry.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.findings import Finding

# ops that contract and accumulate: their output dtype is the accumulator's
_ACCUM_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "linear", "matmul",
              "convolution", "_convolution", "_scaled_mm", "dot", "vdot",
              "mv", "addmv"}
_LOW_PRECISION = {torch.bfloat16, torch.float16}
# ops whose output shape depends on the data: the host reads a size back
_DATA_SHAPE_OPS = {"nonzero", "nonzero_numpy", "masked_select", "argwhere",
                   "bincount", "_unique", "_unique2", "unique_dim",
                   "unique_consecutive", "unique_dim_consecutive"}
_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
# ops that sync on the card inside their CUDA implementation although the CPU
# dispatch shows nothing (found under set_sync_debug_mode("error") on an H100)
_CUDA_SYNCING = {"_linalg_eigh": "CUDA's eigh reads its result back to the host"}

PROBE_SEED = 0


class NoDevice(RuntimeError):
    """``--check`` asked for the card and there is none (no CPU fallback)."""


# --------------------------------------------------------------------- #
# the recorder and its walkers                                           #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class OpRecord:
    name: str                  # aten overload, e.g. "aten.mm.default"
    base: str                  # op name without namespace / overload: "mm"
    ins: tuple                 # dtypes of the floating tensor inputs
    outs: tuple = ()           # dtypes of the tensor outputs
    sync: str | None = None    # why this op waits for the card, if it does


def _tensors(obj) -> list[torch.Tensor]:
    return [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]


def _sync_reason(base: str, func, args, kwargs) -> str | None:
    if base == "_local_scalar_dense":
        return "a tensor read as a Python number (.item() / int() / bool())"
    if base in ("equal", "is_nonzero"):
        return f"aten.{base} returns a Python bool"
    if base in _DATA_SHAPE_OPS:
        return "its output shape depends on the data"
    if base == "repeat_interleave" and func._overloadname == "Tensor" \
            and kwargs.get("output_size") is None:
        return "tensor repeats without output_size: a data-dependent shape"
    if base in _CUDA_SYNCING:
        return _CUDA_SYNCING[base]
    if base == "_linalg_check_errors":
        return "linalg info read back to the host to raise on failure"
    if base in _INDEX_OPS:
        idx = args[1] if len(args) > 1 else ()
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in (idx or ())):
            return "boolean-mask indexing: a data-dependent shape"
    if base == "_to_copy":
        dev = kwargs.get("device")
        src = args[0] if args else None
        if dev is not None and torch.device(dev).type == "cpu" \
                and isinstance(src, torch.Tensor) and src.is_cuda:
            return "a copy from the card to the host"
    if base == "copy_" and len(args) >= 2:
        dst, src = args[0], args[1]
        if isinstance(dst, torch.Tensor) and isinstance(src, torch.Tensor) \
                and not dst.is_cuda and src.is_cuda:
            return "a copy from the card to the host"
    return None


class Recorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active.  The record is
    made before the op runs.  ``strict`` (on the card, under
    ``set_sync_debug_mode("error")``): an op the record already names as a
    sync runs with the debug mode lifted, so that the probe goes on and the
    walker reports it; any other sync raises."""

    def __init__(self, strict: bool = False):
        super().__init__()
        self.strict = strict
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        base = func.overloadpacket.__name__
        rec = OpRecord(
            name=str(func), base=base,
            ins=tuple(t.dtype for t in _tensors((args, kwargs))
                      if t.is_floating_point()),
            sync=_sync_reason(base, func, args, kwargs))
        self.ops.append(rec)
        if self.strict and rec.sync is not None:
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                out = func(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(before)
        else:
            out = func(*args, **kwargs)
        rec.outs = tuple(t.dtype for t in _tensors(out))
        return out


def dtype_downcasts(ops: list[OpRecord]) -> list[str]:
    """Contractions whose ACCUMULATOR (= output) is bf16/f16: floating
    inputs and a low-precision output."""
    bad = []
    for op in ops:
        if op.base not in _ACCUM_OPS or not op.ins:
            continue
        for d in op.outs:
            if d in _LOW_PRECISION:
                bad.append(f"{op.name}: {[str(x) for x in op.ins]} -> {d}")
    return bad


def host_syncs(ops: list[OpRecord]) -> list[str]:
    """Ops that wait for the card (the twin of ``host_callbacks``)."""
    return [f"{op.name}: {op.sync}" for op in ops if op.sync is not None]


# --------------------------------------------------------------------- #
# running a probe                                                        #
# --------------------------------------------------------------------- #
def _finding(entry: str, message: str, key: str = "") -> Finding:
    return Finding(rule="trace-check", path=f"<trace:{entry}>", line=0,
                   message=message, line_content=key)


def _check_ops(entry: str, ops: list[OpRecord]) -> list[Finding]:
    out = []
    for bad in dict.fromkeys(dtype_downcasts(ops)):
        out.append(_finding(entry, f"low-precision accumulation: {bad} — "
                            "cast an operand to f32 or pass out_dtype", bad))
    for bad in dict.fromkeys(host_syncs(ops)):
        out.append(_finding(entry, f"host sync inside a hot path: {bad}", bad))
    return out


def probe(entry: str, fn, device: torch.device, findings: list[Finding]):
    """Run ``fn()`` under the recorder (and, on the card, under
    ``set_sync_debug_mode("error")``); append what the walkers find to
    ``findings`` and return ``fn``'s result (None if a sync raised)."""
    strict = device.type == "cuda"
    rec = Recorder(strict)
    result = None
    if strict:
        torch.cuda.synchronize(device)      # nothing of the set-up in flight
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with rec:
            result = fn()
    except RuntimeError as exc:
        if not strict or "synchroniz" not in str(exc).lower():
            raise
        last = rec.ops[-1].name if rec.ops else "?"
        findings.append(_finding(
            entry, f"a host sync raised under set_sync_debug_mode('error') "
                   f"at {last}: {exc}", f"sync-debug error at {last}"))
    finally:
        if strict:
            torch.cuda.set_sync_debug_mode(before)
    findings.extend(_check_ops(entry, rec.ops))
    return result


# --------------------------------------------------------------------- #
# probe problem                                                          #
# --------------------------------------------------------------------- #
def _blobs(n: int, seed: int = PROBE_SEED):
    """The reference's probe data (``jaxpr_check._blobs``), the same numbers."""
    r = np.random.default_rng(seed)
    half = n // 2
    mu = np.zeros(4, np.float32)
    mu[0] = 2.5
    x = np.concatenate([r.normal(size=(half, 4)) + mu,
                        r.normal(size=(n - half, 4)) - mu]).astype(np.float32)
    y = np.concatenate([np.ones(half), -np.ones(n - half)]).astype(np.float32)
    return x, y


def _probe_params():
    from repro_torch.core import compression
    from repro_torch.core.kernelfn import KernelSpec

    return KernelSpec("gaussian", 1.0), compression.CompressionParams(
        rank=16, n_near=16, n_far=24)


def build_probe(device: torch.device, n: int = 256, leaf: int = 32,
                store_dtype: str | None = None):
    """A small compress + factorize instance for probing the hot paths (the
    reference's ``build_probe``: blobs(256), leaf 32, rank 16, 16 + 24
    proxies, β 8)."""
    from repro_torch.core import compression, factorization, tree as tree_mod

    x, y = _blobs(n)
    t = tree_mod.build_tree(x, leaf_size=leaf)
    spec, params = _probe_params()
    hss = compression.compress(x[t.perm], t, spec, params, device=device)
    fac = factorization.factorize(hss, 8.0, store_dtype=store_dtype)
    yp = torch.as_tensor(y[t.perm], device=device)
    return hss, fac, yp


# --------------------------------------------------------------------- #
# the checks                                                             #
# --------------------------------------------------------------------- #
def check_hot_paths(device: torch.device,
                    store_dtype: str | None = "bfloat16") -> list[Finding]:
    """matmat / solve_mat / factorize / the ADMM iterations / the bias, on a
    bf16-stored factorization by default (where a missing f32 cast
    bites)."""
    from repro_torch.core import admm as admm_mod, factorization
    from repro_torch.core.svm import compute_bias_batched

    hss, fac, yp = build_probe(device, store_dtype=store_dtype)
    n = hss.n
    v = torch.zeros((n, 2), dtype=torch.float32, device=device)
    findings: list[Finding] = []
    probe("HSSMatrix.matmat", lambda: hss.matmat(v), device, findings)
    probe("hss_solve_mat", lambda: fac.solve_mat(v), device, findings)
    probe("factorize", lambda: factorization.factorize(hss, 8.0, store_dtype=store_dtype),
          device, findings)

    ys = yp[None, :]
    pmask = torch.ones_like(ys)
    z0 = torch.zeros((n, 1), dtype=torch.float32, device=device)

    def admm_run():
        task = admm_mod.svm_task(ys, 1.0 * pmask)
        state, trace = admm_mod.admm_boxqp(fac.solve_mat, task, fac.beta, 4,
                                           z0=z0, mu0=z0)
        return state.z

    probe("admm_boxqp", admm_run, device, findings)
    probe("compute_bias_batched",
          lambda: compute_bias_batched(hss, ys.T, z0, pmask.T, pmask.T),
          device, findings)
    return findings


def check_compress_kernels(device: torch.device) -> list[Finding]:
    """K2's and K4's entry points (``kernels.compress.ops
    .batched_assemble_id``, ``laplacian_block``) on bf16 inputs, gaussian
    and laplacian.  On the card K2's kernel takes f32 only (it refuses bf16
    before launching: the port's builds feed it f32), so there its probe
    runs on f32 inputs; K4 runs bf16 on both devices."""
    from repro_torch.kernels.compress import ops as cops
    from repro_torch.kernels.compress.laplacian import laplacian_block

    b, m, s, f, k = 2, 32, 16, 4, 8
    k2_dtype = torch.float32 if device.type == "cuda" else torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(PROBE_SEED)
    xc = torch.randn((b, m, f), generator=gen).to(device, k2_dtype)
    xp = torch.randn((b, s, f), generator=gen).to(device, k2_dtype)
    findings: list[Finding] = []
    for name in ("gaussian", "laplacian"):
        probe(f"fused_assemble_id[{name}]",
              lambda: cops.batched_assemble_id(xc, xp, k, h=1.0, rtol=1e-4,
                                               kernel_name=name, adaptive=True),
              device, findings)
    xa = torch.randn((33, f), generator=gen).to(device, torch.bfloat16)
    xb = torch.randn((65, f), generator=gen).to(device, torch.bfloat16)
    probe("laplacian_block", lambda: laplacian_block(xa, xb, 1.0), device, findings)
    return findings


def check_streamed_stage(device: torch.device) -> list[Finding]:
    """The streamed build's three per-batch stages, fixed rank and adaptive,
    in f32 (the streamed path computes in the input dtype)."""
    from repro_torch.core import compression as comp
    from repro_torch.core.kernelfn import KernelSpec

    spec = KernelSpec("gaussian", 1.0)
    b, m, f, r0, nf = 2, 32, 4, 8, 12
    gen = torch.Generator(device="cpu").manual_seed(PROBE_SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(device)

    xl, xp_leaf = rand(b, m, f), rand(b, m + nf, f)
    cp, xp_lvl = rand(b, 2 * r0, f), rand(b, 2 * r0 + nf, f)
    cm = torch.ones((b, 2 * r0), dtype=torch.float32, device=device)
    findings: list[Finding] = []
    for adaptive in (False, True):
        tag = "adaptive" if adaptive else "fixed"
        rtol = 1e-4 if adaptive else None
        probe(f"stream_leaf_batch[{tag}]",
              lambda: comp._stream_leaf_batch(spec, xl, xp_leaf, r0, rtol, adaptive),
              device, findings)
        probe(f"stream_level_batch[{tag}]",
              lambda: comp._stream_level_batch(spec, cp, xp_lvl, cm if adaptive else None,
                                               r0, rtol, adaptive),
              device, findings)
        probe(f"stream_root_batch[{tag}]",
              lambda: comp._stream_root_batch(spec, cp, cm if adaptive else None, adaptive),
              device, findings)
    return findings


@contextlib.contextmanager
def _counting(module, name: str, counts: dict):
    """Count the calls of ``module.name`` while the block runs."""
    orig = getattr(module, name)

    def counted(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return orig(*args, **kw)

    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, orig)


def check_recompile_engine(device: torch.device,
                           c_grid=(0.5, 1.0, 2.0, 4.0)) -> list[Finding]:
    """A warm-started C-sweep on the engine must compress once and factorize
    once (the port's form of one compile per sweep: ``_fac_cache`` keeps
    the factorization of K̃ + βI), and its ADMM iterations record no host
    sync."""
    from repro_torch.core import admm as admm_mod, compression, factorization
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.engine import HSSSVMEngine

    x, y = _blobs(256)
    spec, params = _probe_params()
    engine = HSSSVMEngine(spec=spec, comp=params, leaf_size=32,
                          admm=ADMMParams(max_it=4), device=device)
    counts: dict = {}
    findings: list[Finding] = []
    orig_admm = admm_mod.admm_boxqp

    def watched_admm(*args, **kw):
        return probe("engine.train_grid:admm", lambda: orig_admm(*args, **kw),
                     device, findings)

    with _counting(compression, "compress", counts), \
            _counting(factorization, "factorize", counts):
        engine.prepare(x, y)
        admm_mod.admm_boxqp = watched_admm
        try:
            engine.train_grid(list(c_grid))
        finally:
            admm_mod.admm_boxqp = orig_admm
    for name in ("compress", "factorize"):
        got = counts.get(name, 0)
        if got != 1:
            findings.append(_finding(
                "engine.train_grid",
                f"{len(c_grid)}-point C-sweep ran {name} {got}x (expected 1): "
                "the sweep must reuse the one compression and the one "
                "factorization of K̃ + βI", f"{name} x{got}"))
    return findings


def check_serve_path(device: torch.device) -> list[Finding]:
    """The serving tier, both halves of its contract: ``batched_scores`` in
    f32 and bf16 accumulates in f32 and syncs nowhere, and eight queue
    occupancies over buckets (16, 64) give two scorer signatures
    (``ServingEngine.scorer_compiles``) and, on the card, two CUDA-graph
    captures (``stats()["graph_captures"]``) — never one per occupancy."""
    from repro_torch.core.engine import EngineModel
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.serve import BatchPolicy, ServingEngine, batched_scores

    d, f, p = 64, 4, 3
    spec = KernelSpec("gaussian", 1.0)
    gen = torch.Generator(device="cpu").manual_seed(PROBE_SEED)
    xs = torch.randn((d, f), generator=gen).to(device)
    zy = torch.randn((d, p), generator=gen).to(device)
    biases = torch.zeros((p,), dtype=torch.float32, device=device)
    xq = torch.randn((32, f), generator=gen).to(device)
    findings: list[Finding] = []
    for dt in ("float32", "bfloat16"):
        probe(f"serve.batched_scores[{dt}]",
              lambda: batched_scores(xq, xs, zy, biases, spec=spec, block=16,
                                     compute_dtype=dt),
              device, findings)

    model = EngineModel(
        x_perm=xs, z_y=zy, biases=biases,
        classes=np.array([0.0, 1.0, 2.0], np.float32), spec=spec,
        c_value=1.0, binary=False, strategy="ovr", task="svm", beta=8.0)
    engine = ServingEngine(policy=BatchPolicy(buckets=(16, 64), block=16),
                           device=device)
    mid = engine.add_model(model)
    occupancies = (1, 3, 7, 11, 16, 20, 40, 64)   # 2 buckets, 8 shapes
    for occ in occupancies:
        engine.score(mid, np.zeros((occ, f), np.float32))
    compiles = engine.scorer_compiles()
    if compiles != 2:
        findings.append(_finding(
            "serve.tick",
            f"{len(occupancies)} tick occupancies over 2 buckets gave "
            f"{compiles} scorer signatures (expected 2): queue shapes reach "
            "the scorer unpadded — the bucket padding rule broke",
            f"scorer_compiles {compiles}"))
    if device.type == "cuda":
        captures = engine.stats()["graph_captures"]
        if captures != 2:
            findings.append(_finding(
                "serve.tick",
                f"{len(occupancies)} tick occupancies over 2 buckets captured "
                f"{captures} CUDA graphs (expected 2)",
                f"graph_captures {captures}"))
    return findings


def check_kernel_linalg(device: torch.device) -> list[Finding]:
    """The kernel linear-algebra family: the raw streamed scoring matvec in
    f32 and bf16, the KRR/GP solve on a bf16-stored factorization, and the
    Lanczos sweep on the HSS matvec."""
    from repro_torch.core import krr as krr_mod, lanczos as lanczos_mod
    from repro_torch.core.kernelfn import KernelSpec, kernel_matvec_streamed

    findings: list[Finding] = []
    spec = KernelSpec("gaussian", 1.0)
    gen = torch.Generator(device="cpu").manual_seed(PROBE_SEED)
    for dt in (torch.float32, torch.bfloat16):
        xr = torch.randn((40, 4), generator=gen).to(device, dt)
        xc = torch.randn((64, 4), generator=gen).to(device, dt)
        v = torch.randn((64, 3), generator=gen).to(device, dt)
        probe(f"kernel_matvec_streamed[{str(dt).replace('torch.', '')}]",
              lambda: kernel_matvec_streamed(spec, xr, xc, v, block=16),
              device, findings)

    hss, fac, _ = build_probe(device, store_dtype="bfloat16")
    targets = torch.zeros((hss.n, 2), dtype=torch.float32, device=device)
    probe("krr.krr_solve", lambda: krr_mod.krr_solve(fac, targets), device, findings)
    v0 = torch.randn((hss.n_total,), generator=gen).to(device)
    probe("lanczos.top_eigenpairs",
          lambda: lanczos_mod.top_eigenpairs(hss, 4, v0=v0), device, findings)
    return findings


# --------------------------------------------------------------------- #
# mesh placement (2 gloo ranks)                                          #
# --------------------------------------------------------------------- #
def _fac_leaves(fac) -> dict:
    """name -> tensor of a factorization, named as ``factorization_shapes``."""
    out = {"e_leaf": fac.e_leaf, "g_leaf": fac.g_leaf,
           "root_lu": fac.root_lu, "root_piv": fac.root_piv}
    for k, (e, g) in enumerate(zip(fac.e_lvls, fac.g_lvls)):
        out[f"e_lvls.{k}"], out[f"g_lvls.{k}"] = e, g
    return out


def mesh_rank(mesh, x_perm: np.ndarray, leaf: int) -> dict:
    """One rank of ``check_mesh_placement`` (``dist.api.spawn`` runs it):
    the node-split build and factorization of the probe, their shapes and
    the rank's factor rows."""
    from repro_torch.core import compression, factorization, tree as tree_mod

    t = tree_mod.build_tree(x_perm, leaf_size=leaf)
    spec, params = _probe_params()
    hss = compression.compress_sharded(x_perm, t, spec, params, mesh, device="cpu")
    fac = factorization.factorize_sharded(hss, 8.0, mesh)
    return dict(
        rank=mesh.rank,
        fac={k: a.clone() for k, a in _fac_leaves(fac).items()},
        hss={name: tuple(getattr(hss, name).shape) for name in ("d_leaf", "u_leaf", "x")})


def check_mesh_placement(world: int = 2) -> list[Finding]:
    """On ``world`` gloo ranks (CPU): each rank's factor leaves have the
    shapes ``fac_shardings`` gives (a split leaf holds n_k / P nodes, a
    replicated one all), a split leaf holds the rows of the whole
    factorization at ``owned_range``, and no O(N·m) compression array
    (``hss.d_leaf``, ``u_leaf``, ``x``) is whole on a rank."""
    from repro_torch.core import compression, factorization, tree as tree_mod
    from repro_torch.core.distributed import fac_shardings, factorization_shapes
    from repro_torch.dist import api as dist_api

    leaf = 32
    n = leaf * world * 2
    x, _ = _blobs(n)
    t = tree_mod.build_tree(x, leaf_size=leaf)
    xp = x[t.perm]
    runs = dist_api.spawn(mesh_rank, world, xp, leaf)
    spec, params = _probe_params()
    whole = _fac_leaves(factorization.factorize(
        compression.compress(xp, t, spec, params, device="cpu"), 8.0))
    shapes = factorization_shapes(n, leaf, params.rank)
    want = fac_shardings(shapes, {"data": world})
    findings: list[Finding] = []
    for run in runs:
        r = run["rank"]
        for name, spec_ in want.items():
            full = shapes["leaves"][name][0]
            got = run["fac"].get(name)
            split = spec_[0] is not None
            expect = ((full[0] // world,) + tuple(full[1:])) if split else tuple(full)
            key = (f"{name} {tuple(got.shape) if got is not None else None}; "
                   f"fac_shardings: {expect}")
            if got is None or tuple(got.shape) != expect:
                findings.append(_finding(
                    "mesh:fac", f"factor leaf {name} of rank {r} has shape "
                    f"{tuple(got.shape) if got is not None else None}, but "
                    f"fac_shardings places {expect} there "
                    f"({'split' if split else 'replicated'})", key))
                continue
            if split:
                lo, hi = dist_api.owned_range(_Mesh(world, r), full[0])
                ref = whole[name][lo:hi]
            else:
                ref = whole[name]
            if not torch.allclose(got.float(), ref.float(), rtol=1e-4, atol=1e-4):
                findings.append(_finding(
                    "mesh:fac", f"factor leaf {name} of rank {r} is not the "
                    f"whole factorization's rows at owned_range", f"{name} rows on rank {r}"))
        for name, shape in run["hss"].items():
            if shape[0] * world != (n if name == "x" else n // leaf):
                findings.append(_finding(
                    "mesh:hss", f"hss.{name} shape {shape} on rank {r} is not 1/{world} "
                    "of the whole: an O(N·m) artifact landed whole on a rank",
                    f"hss.{name} {shape} on rank {r}"))
    return findings


@dataclasses.dataclass(frozen=True)
class _Mesh:
    """What ``owned_range`` reads of a mesh: its size and this rank."""
    size: int
    rank: int


# --------------------------------------------------------------------- #
def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDevice("--check runs its probes on the card (--device cuda), and "
                       "no CUDA device is available; pass --device cpu to run "
                       "them on the CPU")
    return dev


CHECKS = (check_hot_paths, check_compress_kernels, check_streamed_stage,
          check_recompile_engine, check_serve_path, check_kernel_linalg)


def run_all(device: str | torch.device = "cuda", mesh_world: int = 2,
            seconds: dict | None = None) -> list[Finding]:
    """Every dispatch-level check on ``device`` (the mesh check on gloo CPU
    ranks, spawned on a worker thread while the others run); an empty
    result means the hot paths are clean.  ``seconds``, if given, receives
    each check's wall time."""
    dev = resolve_device(device)
    findings: list[Finding] = []
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        findings.append(_finding(
            "tf32", "torch.backends.cuda.matmul.allow_tf32 reads True: f32 "
            "products would round their operands to TF32", "allow_tf32 True"))

    def timed(name, run):
        t0 = time.perf_counter()
        out = run()
        if seconds is not None:
            seconds[name] = time.perf_counter() - t0
        return out

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        mesh = pool.submit(timed, "check_mesh_placement",
                           lambda: check_mesh_placement(mesh_world))
        for check in CHECKS:
            findings += timed(check.__name__, lambda: check(dev))
        findings += mesh.result()
    return findings
