"""Distributed HSS-ADMM SVM training: placements, the C-grid functions and
the mesh cell.

Counterpart of ``repro.core.distributed``.  The sample
dimension d is split over every rank of the mesh (``repro_torch.dist.api``):
the leaf-level factors and the rows of every ADMM vector live on the rank
that owns them, the upper levels of the factorization are replicated, and
the only traffic between ranks is

  * one gather of the projected right-hand side at the cut of every solve
    (O(r n_k)), and
  * the scalar reductions of each iteration (eᵀw, the residual norms):
    one all-reduce each,

the communication pattern of distributed-memory HSS solvers (STRUMPACK).
A whole factorization passed in is first cut to the rank's nodes
(``factorization.shard``, the port's counterpart of placing it with
``fac_shardings``); a node-split one (``factorize_sharded``) is used as it is.
The labels and per-coordinate C vectors are of full length, as the
reference's single controller holds them; each rank takes its rows.

Placements as the reference writes them, a spec per leaf (``dist.sharding``'s
form: None or the mesh axes of each dim): ``fac_shardings`` splits each
node-stacked level over every mesh axis where its node count divides the
rank count (the reference's ``node_partition_spec``), ``vec_sharding`` and
``mat_sharding`` the sample axis of the ADMM vectors and blocks.
``factorization_shapes`` is a factorization's skeleton for an n-point
problem, and ``build_svm_cell`` the ADMM step of one C on one rank: on a
meta mesh (the dry run) over the rank's part of a factorization of
``factorization_shapes`` placed by ``fac_shardings``, or over a live
node-split factorization that ``HSSSVMEngine(mesh=)`` builds from data.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.admm import admm_svm, admm_svm_batched
from repro_torch.core.factorization import HSSFactorization, hss_solve, shard
from repro_torch.dist import api as dist_api


def factorization_shapes(n: int, leaf: int, rank: int, dtype=torch.float32) -> dict:
    """The leaves of an n-point problem's factorization at fixed ``rank``:
    name -> (shape, dtype), with ``levels``, ``leaf_size`` and ``beta``.
    ``dtype`` is the E/G factors' storage; the root LU stays f32."""
    levels = int(math.log2(n // leaf))
    n_leaf = n // leaf
    out = {"e_leaf": ((n_leaf, leaf, rank), dtype), "g_leaf": ((n_leaf, leaf, leaf), dtype)}
    for k in range(1, levels):
        n_k = n_leaf // 2 ** k
        out[f"e_lvls.{k - 1}"] = ((n_k, 2 * rank, rank), dtype)
        out[f"g_lvls.{k - 1}"] = ((n_k, 2 * rank, 2 * rank), dtype)
    out["root_lu"] = ((2 * rank, 2 * rank), torch.float32)
    out["root_piv"] = ((2 * rank,), torch.int32)
    return dict(leaves=out, levels=levels, leaf_size=leaf, beta=1e4)


def _sizes(mesh) -> dict:
    """Axis name -> size of a Mesh or of a dict of axis sizes."""
    return dict(mesh.shape) if isinstance(mesh, dist_api.Mesh) else dict(mesh)


def _node_axes(mesh) -> tuple:
    """Every mesh axis: the node / sample axis spans all ranks."""
    return tuple(_sizes(mesh))


def fac_shardings(fac_shapes: dict, mesh) -> dict:
    """Name -> spec of each leaf of ``factorization_shapes``: a node-stacked
    (n_k, ·, ·) level splits its node axis over every mesh axis where n_k
    is a multiple of the rank count and exceeds 1; anything else (a small
    upper level, the root LU and its pivots) is replicated.  ``mesh``: a
    Mesh or a dict of axis sizes."""
    sizes = _sizes(mesh)
    p = math.prod(sizes.values())
    out = {}
    for name, (shape, _) in fac_shapes["leaves"].items():
        split = len(shape) >= 3 and shape[0] % p == 0 and shape[0] > 1
        out[name] = ((tuple(sizes),) if split else (None,)) + (None,) * (len(shape) - 1)
    return out


def vec_sharding(mesh) -> tuple:
    """(n,) ADMM iterate vectors: the sample axis over every mesh axis."""
    return (_node_axes(mesh),)


def mat_sharding(mesh) -> tuple:
    """(n, k) iterate blocks: samples over every mesh axis, classes whole."""
    return (_node_axes(mesh), None)


def make_distributed_admm_step(beta: float, max_it: int = 10, solve_dtype=None):
    """The unit of the cell: ADMM training for one C (paper Alg. 3 lines
    7-14) on this rank's rows: ``step(fac, y, c)`` -> (z, primal_res
    trace), ``fac`` node-split over its mesh (or whole), ``y`` and ``c``
    the rank's rows (``c`` also a scalar).  ``solve_dtype``: the right-hand
    sides cast to it for the solve and back."""
    def step(fac: HSSFactorization, y: torch.Tensor, c_value):
        if solve_dtype is not None:
            def solver(b):
                return hss_solve(fac, b.to(solve_dtype)).to(b.dtype)
        else:
            def solver(b):
                return hss_solve(fac, b)
        state, trace = admm_svm(solver, y, c_value, beta, max_it, mesh=fac.mesh)
        return state.z, trace.primal_res

    return step


def admm_train_distributed(fac: HSSFactorization, y, c_values, mesh, max_it: int = 10,
                           warm_start: bool = True) -> list:
    """The ADMM C-grid over ``mesh`` (paper Alg. 3 lines 7-14).

    ``y`` (n,) ±1 labels; ``c_values`` entries are scalars or (n,)
    per-coordinate bounds (0 pins a pad).  Consecutive C values warm-start
    from the previous (z, μ), as ``svm.grid_search`` does on one device.
    Returns one (z, primal_res trace) per C, z as this rank's rows.
    """
    def run(fac_, y_, c, z0, mu0):
        state, trace = admm_svm(fac_.solve, y_, c, fac_.beta, max_it, z0=z0, mu0=mu0,
                                mesh=mesh)
        return state.z, state.mu, trace.primal_res

    def make_c(c):
        c = torch.as_tensor(c, dtype=torch.float32, device=y_r.device)
        return dist_api.local_rows(c, mesh) if c.dim() == 1 else c

    y_r = dist_api.local_rows(torch.as_tensor(y, dtype=torch.float32), mesh)
    y_r = y_r.to(fac.e_leaf.device)
    return _run_c_grid(fac, y_r, c_values, mesh, run, make_c, torch.zeros_like(y_r),
                       warm_start)


def admm_train_multiclass_distributed(fac: HSSFactorization, ys, c_values, mesh,
                                      max_it: int = 10, warm_start: bool = True,
                                      pmask=None) -> list:
    """The batched multiclass ADMM C-grid over ``mesh``.

    ``ys`` (P, n) per-class (or per-pair) labels; the iterate blocks are
    (n, P) with the sample axis split over the ranks and the class axis
    whole on each, so the P-fold right-hand side adds no traffic beyond P
    columns in the same collectives.  ``pmask`` (P, n) pins
    non-participating coordinates to [0, 0] (one-vs-one pairs).  Returns
    one (z (n_rank, P), primal_res (max_it, P)) per C.
    """
    def rows(a):
        return dist_api.local_rows(torch.as_tensor(a, dtype=torch.float32).T, mesh
                                   ).T.to(fac.e_leaf.device)

    ys_r = rows(ys)
    mask_r = torch.ones_like(ys_r) if pmask is None else rows(pmask)

    def run(fac_, ys_, c_upper, z0, mu0):
        state, trace = admm_svm_batched(fac_.solve_mat, ys_, c_upper, fac_.beta, max_it,
                                        z0=z0, mu0=mu0, mesh=mesh)
        return state.z, state.mu, trace.primal_res

    def make_c(c):
        return torch.as_tensor(c, dtype=torch.float32) * mask_r

    zeros = torch.zeros(ys_r.T.shape, dtype=torch.float32, device=ys_r.device)
    return _run_c_grid(fac, ys_r, c_values, mesh, run, make_c, zeros, warm_start)


def _run_c_grid(fac, labels, c_values, mesh, run, make_c, zeros, warm_start) -> list:
    """Shared warm-started C-grid loop of the vector and (n, P) block
    paths: cut the factorization to the rank's nodes once (unless it is
    already node-split), then sweep C reusing it."""
    fac_r = fac if fac.mesh is not None else shard(fac, mesh)
    z0, mu0 = zeros, zeros
    out = []
    for c in c_values:
        z, mu, res = run(fac_r, labels, make_c(c), z0, mu0)
        out.append((z, res))
        if warm_start:
            z0, mu0 = z, mu
    return out


def _level(name: str) -> int:
    """The tree level of a factorization leaf (0: the leaves; -1: the root's)."""
    if name.startswith("root"):
        return -1
    return 0 if name.endswith("leaf") else int(name.split(".")[1]) + 1


def _held_specs(names, cut: int, mesh) -> dict:
    """The specs of a factorization's leaves split below level ``cut`` (the
    node axis over every mesh axis), the upper levels and the root whole."""
    return {n: (((_node_axes(mesh),) if 0 <= _level(n) < cut else (None,))
                + (None,) * (0 if n == "root_piv" else 1 if n == "root_lu" else 2))
            for n in names}


def _placed_factorization(fac_shapes: dict, mesh) -> HSSFactorization:
    """This rank's part of a factorization of ``fac_shapes`` placed by
    ``fac_shardings``, as empty tensors on the mesh's device (meta for the
    dry run); its ``cut`` is its first replicated level."""
    specs = fac_shardings(fac_shapes, mesh)
    levels = fac_shapes["levels"]
    cut = min([_level(n) for n, sp in specs.items() if sp[0] is None and _level(n) >= 0]
              + [levels])
    t = {}
    for name, (shape, dt) in fac_shapes["leaves"].items():
        if specs[name][0] is not None:
            shape = (shape[0] // mesh.size, *shape[1:])
        t[name] = torch.empty(shape, dtype=dt, device=mesh.device)
    return HSSFactorization(
        e_leaf=t["e_leaf"], g_leaf=t["g_leaf"],
        e_lvls=tuple(t[f"e_lvls.{k}"] for k in range(levels - 1)),
        g_lvls=tuple(t[f"g_lvls.{k}"] for k in range(levels - 1)),
        root_lu=t["root_lu"], root_piv=t["root_piv"], levels=levels,
        leaf_size=fac_shapes["leaf_size"], beta=fac_shapes["beta"],
        mesh=mesh if cut else None, cut=cut)


def build_svm_cell(mesh, n: int = 1 << 22, leaf: int = 256, rank: int = 64,
                   beta: float = 1e4, max_it: int = 10, dtype=torch.float32,
                   solve_dtype=None, data=None, spec=None, comp=None,
                   c_value: float = 1.0):
    """(fn, args, in_shardings) of the SVM distributed training cell on this
    rank of ``mesh``: ``fn(*args)`` trains one C (``make_distributed_admm_step``).

    Without ``data`` the dry-run cell: ``args`` are this rank's part of a
    factorization of ``factorization_shapes(n, leaf, rank)`` placed by
    ``fac_shardings``, its rows of the labels and the scalar C, as empty
    tensors on the mesh's device (meta: the dry run; n = 2^22 by default,
    the susy-scale regime).  With ``data=(x, y)`` the cell runs for real:
    ``HSSSVMEngine(mesh=)`` builds the node-split compression and
    factorization, and ``args`` are (its factorization, the rank's rows of
    the permuted labels, of the per-coordinate C bound: ``c_value`` on real
    points and 0 on pads).  To sweep C, rescale: ``fn(fac, y, new_c /
    c_value * args[2])``.  ``spec``/``comp``: the kernel and compression
    knobs (the engine's defaults otherwise).  ``in_shardings``: the specs
    of the factorization's leaves as the rank holds them, then of y and c.
    """
    fn = make_distributed_admm_step(beta, max_it, solve_dtype=solve_dtype)
    if data is None:
        shapes = factorization_shapes(n, leaf, rank, dtype=dtype)
        fac = _placed_factorization(shapes, mesh)
        rows = n if fac.mesh is None else n // mesh.size
        y = torch.empty((rows,), dtype=torch.float32, device=mesh.device)
        c = torch.empty((), dtype=torch.float32, device=mesh.device)
        in_sh = (fac_shardings(shapes, mesh), vec_sharding(mesh), ())
        return fn, (fac, y, c), in_sh

    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec

    x, y = data
    eng = HSSSVMEngine(
        spec=spec if spec is not None else KernelSpec(h=1.0),
        comp=comp if comp is not None else CompressionParams(rank=rank),
        leaf_size=leaf, beta=beta, admm=ADMMParams(max_it=max_it), mesh=mesh,
        store_dtype=None if dtype == torch.float32 else str(dtype).replace("torch.", ""),
        device=mesh.device)
    eng.prepare(x, y)
    fac = eng.fac
    y_r = eng.problem_labels[0]                   # the rank's rows already
    c_r = c_value * eng.problem_masks[0]
    names = ["e_leaf", "g_leaf", "root_lu", "root_piv"] + \
        [f"{k}_lvls.{i}" for i in range(fac.levels - 1) for k in ("e", "g")]
    fac_sh = _held_specs(names, fac.cut if fac.mesh is not None else 0, mesh)
    return fn, (fac, y_r, c_r), (fac_sh, vec_sharding(mesh), vec_sharding(mesh))
