"""The port's mesh: named axes over torch.distributed, the node-ownership
rules of the SVM stack, and the collectives of both.

Counterpart of ``repro.dist.api``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group's ranks,
one process per rank, with named axes: ``("data",)`` by default (the SVM
stack's), or any shape such as ``(dp, mp), ("data", "model")`` or ``(n,),
("stage",)``, with one process group per axis.  Where the JAX package lets
XLA's partitioner move arrays between devices, the port calls collectives
by hand.

Logical axes.  Model code names LOGICAL axes, as the reference's does:
``"data"`` is the mesh's ("pod", "data") axes, those present, composed
major to minor; ``"model"`` and ``"stage"`` are themselves.
``use_mesh(mesh)`` makes a mesh the current one in this thread and
``current()`` returns it (None outside); ``resolve_spec`` maps a logical
spec onto it with the reference's divisibility fallback.  Outside a
``use_mesh`` block every hook is the identity and the model code runs as
on one device.

Collectives by axis (``psum``, ``pmean``, ``pmax``, ``all_gather``,
``all_to_all``, ``reduce_scatter``, ``ppermute``) take a logical or mesh
axis name, or a tuple of them (``ALL`` is every axis), and are the identity
on an axis of size 1.  The autograd pairs of tensor parallelism (Megatron's
f and g) are ``copy_to`` (identity forward, sum backward) and
``reduce_from`` (sum forward, identity backward); ``gather_copies`` is a
gather whose backward slices (every rank then computes the same thing from
the whole tensor), ``gather_shards`` one whose backward is a reduce-scatter
(the ranks use the whole tensor on different data: FSDP), and
``from_owner`` hands one rank's tensor to the others along an axis (its
backward sums the gradients back to that rank).

Node ownership (the SVM stack).  At a level with n_k nodes over P ranks,
rank r owns nodes [r·n_k/P, (r+1)·n_k/P) (``owned_range``).  Which levels
are split that way is ONE rule, ``shard_levels``, that the build, the
factorization, the solve and the matmat all defer to: the leaves are always
split (the caller falls back to the local path when P does not divide the
leaf count), and level k ≥ 1 stays split while n_k/P is even, so that every
pairing of a split level (the children of a node, the sibling of a node) is
rank-local.  From the first level that fails it, the upper tree is
replicated: each rank gathers the level below once and computes the same
small upper levels.  The reference's ``node_partition_spec`` would also
split the level with one node per device (n_k = P); the port's cut lies one
level lower on the factorization's and the solve's side, which moves where
the one gather happens and changes no number (tests/test_torch_dist.py
holds the cut at 1 against the rule's).  These use the whole mesh, all its
axes: ``all_gather_nodes`` (the ranks' node-stacked blocks, concatenated
along the node axis in rank order) and ``all_reduce_sum`` /
``all_reduce_max``.

Transport.  Every collective runs on the tensors' own device: NCCL for
CUDA tensors, gloo for CPU ones, and gloo for CUDA tensors too where NCCL
cannot run (two ranks on one card).  The card's gloo (PyTorch 2.11) takes
all_gather, all_reduce, reduce_scatter, all_to_all_single and broadcast of
CUDA tensors (not the list form of all_to_all, which the port does not
use); its point-to-point sends of CUDA tensors fail, so ``ppermute`` stages
them through the host, and ``Mesh.stats["host_staged_bytes"]`` counts what
crossed.
``Mesh.describe()`` prints the backend and device, ``Mesh.stats`` counts
calls, bytes and the host seconds inside the calls per kind (gloo returns
once its copies to and from the host are done, so on CUDA tensors these
seconds hold the transfer; NCCL returns at the enqueue), and ``Mesh.ring``
the bytes each kind puts on a ring of its group's size (×2(n−1)/n for an
all-reduce, and so on: ``RING``).

The dry run.  ``make_mesh("meta", shape, names, rank=r)`` is a mesh that
moves nothing: a "fake" process group of prod(shape) ranks, in which this
process stands for rank r; its tensors live on the meta device (shapes and
types, no memory), and its collectives return at once, counted in
``stats`` and ``ring`` as on a real mesh.  ``launch/dryrun.py`` runs one
rank's step on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

AXIS = "data"
ALL = "__all__"               # every axis of the mesh

# logical axis -> candidate mesh axes, in composition (major-to-minor) order
_LOGICAL_AXES = {"data": ("pod", "data"), "model": ("model",), "stage": ("stage",)}
_KINDS = ("all_gather", "all_reduce", "all_to_all", "reduce_scatter", "send_recv")


# bytes that one call of each kind puts on a ring of n ranks, from the bytes
# it was handed (the shard for a gather, the whole for the others)
RING = {
    "all_reduce": lambda b, n: 2 * b * (n - 1) / n,
    "all_gather": lambda b, n: b * (n - 1),
    "reduce_scatter": lambda b, n: b * (n - 1) / n,
    "all_to_all": lambda b, n: b * (n - 1) / n,
    "send_recv": lambda b, n: float(b),
}


def _zero_stats() -> dict:
    out = {}
    for kind in _KINDS:
        out[f"{kind}_calls"] = 0
        out[f"{kind}_bytes"] = 0
        out[f"{kind}_s"] = 0.0
    out["host_staged_bytes"] = 0
    return out


@dataclasses.dataclass(eq=False)
class Mesh:
    """A device mesh of named axes over the process group."""

    device_mesh: object                  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device                 # where this rank's tensors live
    # per collective kind: calls and the bytes this rank handed to it
    stats: dict = dataclasses.field(default_factory=_zero_stats)
    # composite axes (several mesh axes in one group): tuple -> group
    composite: dict = dataclasses.field(default_factory=dict)
    # per collective kind: the bytes on a ring of its group's size (RING)
    ring: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(_KINDS, 0.0))

    @property
    def axis_names(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        """Mesh axis name -> size."""
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    @property
    def rank(self) -> int:
        """This rank's position in the whole mesh (row-major over the axes)."""
        if len(self.axis_names) == 1:
            return self.device_mesh.get_local_rank()
        return _axis_ranks(self, self.axis_names).index(dist.get_rank())

    @property
    def group(self):
        """The group of every rank of the mesh."""
        if len(self.axis_names) == 1:
            return self.device_mesh.get_group()
        return dist.group.WORLD

    def coordinate(self, name: str) -> int:
        return self.device_mesh.get_local_rank(mesh_dim=name)

    def describe(self) -> str:
        if len(self.axis_names) == 1:
            return (f"mesh {self.device_mesh.mesh_dim_names} of {self.size} ranks, backend "
                    f"{dist.get_backend(self.group)}: all_gather and all_reduce on "
                    f"{self.device.type} tensors")
        return (f"mesh {self.axis_names} {tuple(self.shape.values())} of {self.size} ranks, "
                f"backend {dist.get_backend(self.group)}: collectives by axis on "
                f"{self.device.type} tensors")

    def reset_stats(self) -> None:
        for key in self.stats:
            self.stats[key] = 0
        for key in self.ring:
            self.ring[key] = 0.0


def _fake_group(world: int, rank: int) -> None:
    """A "fake" process group of ``world`` ranks in which this process is
    ``rank`` (started, or restarted at another rank); a real group in this
    process is an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError("a meta mesh needs a process without a real process group")
        if (dist.get_world_size(), dist.get_rank()) == (world, rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def make_mesh(device: str | torch.device, shape: tuple | None = None,
              names: tuple = (AXIS,), rank: int = 0) -> Mesh:
    """The mesh of ``shape`` (default: every rank of the initialised process
    group on one axis) with axes ``names``, one process group per axis; the
    ("pod", "data") pair, where both are present, also gets a group of its
    own (the logical "data" axis).  ``device="meta"``: the dry run's mesh
    over a fake group of prod(``shape``) ranks, this process as ``rank``
    (module docstring)."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    if device.type == "meta":
        _fake_group(math.prod(shape), rank)
    shape = (dist.get_world_size(),) if shape is None else tuple(int(n) for n in shape)
    names = tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
    dm = init_device_mesh("cpu" if device.type == "meta" else device.type, shape,
                          mesh_dim_names=names)
    mesh = Mesh(device_mesh=dm, device=device)
    if "pod" in names and "data" in names:
        axes = ("pod", "data")
        ranks = dm.mesh.movedim([names.index(a) for a in axes], [0, 1]).flatten(0, 1)
        ranks = ranks.reshape(ranks.shape[0], -1)
        me = dist.get_rank()
        for col in range(ranks.shape[1]):        # every rank creates every group
            members = ranks[:, col].tolist()
            g = dist.new_group(members)
            if me in members:
                mesh.composite[axes] = g
    return mesh


# ---------------------------------------------------------------------- #
# the current mesh and logical axes                                      #
# ---------------------------------------------------------------------- #
_state = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the current one in this thread (None: no mesh)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current() -> Mesh | None:
    """The mesh of the enclosing ``use_mesh`` block, or None."""
    return getattr(_state, "mesh", None)


def mesh_axes(mesh: Mesh | dict, axis) -> tuple:
    """The mesh axes that a logical or mesh axis name (or a tuple of them,
    or ``ALL``) stands for on ``mesh`` (a Mesh, or a dict of axis sizes),
    major to minor; () where none is present."""
    names = tuple(mesh.shape) if isinstance(mesh, Mesh) else tuple(mesh)
    if axis is None:
        return ()
    if axis == ALL:
        return names
    out: list = []
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        for m in _LOGICAL_AXES.get(a, (a,)):
            if m in names and m not in out:
                out.append(m)
    return tuple(m for m in names if m in out)


def _sizes(mesh) -> dict:
    return mesh.shape if isinstance(mesh, Mesh) else dict(mesh)


def axis_size(axis, mesh: Mesh | None = None) -> int:
    """Ranks along ``axis`` of ``mesh`` (the current one by default); 1
    without a mesh or where the axis is absent."""
    mesh = current() if mesh is None else mesh
    if mesh is None:
        return 1
    n = 1
    for a in mesh_axes(mesh, axis):
        n *= _sizes(mesh)[a]
    return n


def axis_index(axis, mesh: Mesh | None = None) -> int:
    """This rank's index along ``axis`` (major-to-minor over its mesh axes)."""
    mesh = current() if mesh is None else mesh
    if mesh is None:
        return 0
    idx = 0
    for a in mesh_axes(mesh, axis):
        idx = idx * mesh.shape[a] + mesh.coordinate(a)
    return idx


def resolve_spec(spec: tuple, shape: tuple, mesh: Mesh | dict | None = None) -> tuple:
    """Map a logical spec onto the current mesh (or ``mesh``, a Mesh or a
    dict of axis sizes) with the reference's divisibility fallback.

    Per dimension: the logical entry resolves to its mesh axes; axes are
    dropped (major first) until the dimension's extent divides the remaining
    axes' total size, degrading to None (replicated) when nothing fits.  An
    entry naming a mesh axis directly passes through the same check; an
    unknown entry, and every entry without a mesh, resolves to None."""
    mesh = current() if mesh is None else mesh
    if mesh is None:
        return tuple(None for _ in spec)
    sizes = _sizes(mesh)
    out: list = []
    used: set = set()
    for entry, dim in zip(spec, shape):
        axes = () if entry is None else mesh_axes(sizes, entry)
        axes = tuple(a for a in axes if a not in used)

        def total(ax):
            n = 1
            for a in ax:
                n *= sizes[a]
            return n
        while axes and (dim % total(axes) or dim == 0):
            axes = axes[1:]                 # drop the major axis, try again
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


# ---------------------------------------------------------------------- #
# collectives by axis                                                    #
# ---------------------------------------------------------------------- #
def _group(mesh: Mesh, axes: tuple):
    if len(axes) == len(mesh.axis_names):
        return mesh.group
    if len(axes) == 1:
        return mesh.device_mesh.get_group(mesh_dim=axes[0])
    return mesh.composite[axes]


def _axis_ranks(mesh: Mesh, axes: tuple) -> list:
    """The global ranks along mesh ``axes`` through this rank, in axis order."""
    m = mesh.device_mesh.mesh
    coord = (m == dist.get_rank()).nonzero()[0].tolist()
    idx = tuple(slice(None) if n in axes else coord[i] for i, n in enumerate(mesh.axis_names))
    return [int(r) for r in m[idx].flatten().tolist()]


def _setup(axis, mesh):
    """(mesh, group, size) of ``axis``, or None where it is the identity."""
    mesh = current() if mesh is None else mesh
    if mesh is None:
        return None
    axes = mesh_axes(mesh, axis)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    if size == 1:
        return None
    return mesh, _group(mesh, axes), size


@contextlib.contextmanager
def _counted(mesh: Mesh, kind: str, t: torch.Tensor, size: int, n: int = 1):
    """Count ``n`` collectives of ``kind`` each handing over ``t`` in a group
    of ``size`` ranks, their ring bytes, and the time of the block."""
    nbytes = n * t.numel() * t.element_size()
    mesh.stats[f"{kind}_calls"] += n
    mesh.stats[f"{kind}_bytes"] += nbytes
    mesh.ring[kind] += RING[kind](nbytes, size)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        mesh.stats[f"{kind}_s"] += time.perf_counter() - t0


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a point-to-point send of ``t`` goes through the host (gloo
    and a CUDA tensor: the card's gloo takes every collective of CUDA
    tensors that the port calls, but not sends and receives)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    mesh.stats["host_staged_bytes"] += t.numel() * t.element_size()
    return t.cpu()


def psum(t: torch.Tensor, axis, mesh: Mesh | None = None, op=None) -> torch.Tensor:
    """Σ over ``axis`` of each rank's ``t`` (a new tensor; ``t`` untouched)."""
    s = _setup(axis, mesh)
    if s is None:
        return t
    mesh, group, size = s
    x = t.contiguous().clone()
    with _counted(mesh, "all_reduce", x, size):
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return x


def pmean(t: torch.Tensor, axis, mesh: Mesh | None = None) -> torch.Tensor:
    return psum(t, axis, mesh) / axis_size(axis, mesh)


def pmax(t: torch.Tensor, axis, mesh: Mesh | None = None) -> torch.Tensor:
    return psum(t, axis, mesh, op=dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, axis, dim: int = 0, mesh: Mesh | None = None
               ) -> torch.Tensor:
    """The ranks' ``t`` along ``axis``, concatenated along ``dim`` in axis order."""
    s = _setup(axis, mesh)
    if s is None:
        return t
    mesh, group, size = s
    x = t.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    with _counted(mesh, "all_gather", x, size):
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def all_to_all(t: torch.Tensor, axis, split_dim: int = 0, concat_dim: int = 0,
               mesh: Mesh | None = None) -> torch.Tensor:
    """``t`` cut into as many chunks along ``split_dim`` as ``axis`` has
    ranks; chunk j goes to rank j, and the chunks received are concatenated
    along ``concat_dim`` in axis order (``jax.lax.all_to_all``, tiled)."""
    s = _setup(axis, mesh)
    if s is None:
        return t
    mesh, group, size = s
    if t.shape[split_dim] % size:
        raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not split over {size}")
    x = t.movedim(split_dim, 0).contiguous()
    got = torch.empty_like(x)
    with _counted(mesh, "all_to_all", t, size):
        dist.all_to_all_single(got, x, group=group)
    return torch.cat([c.movedim(0, split_dim) for c in got.chunk(size, 0)], concat_dim)


def reduce_scatter(t: torch.Tensor, axis, dim: int = 0, mesh: Mesh | None = None
                   ) -> torch.Tensor:
    """Σ over ``axis`` of the ranks' ``t``, of which each rank keeps its
    chunk along ``dim``."""
    s = _setup(axis, mesh)
    if s is None:
        return t
    mesh, group, size = s
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {size}")
    ins = [c.contiguous() for c in torch.chunk(t, size, dim)]
    out = torch.empty_like(ins[0])
    with _counted(mesh, "reduce_scatter", t, size):
        dist.reduce_scatter(out, ins, group=group)
    return out


def ppermute(t: torch.Tensor, axis, perm, mesh: Mesh | None = None) -> torch.Tensor:
    """Send ``t`` from axis index i to j for each (i, j) of ``perm``; returns
    what this rank received, zeros where it receives nothing
    (``jax.lax.ppermute``).  Point-to-point sends and receives."""
    s = _setup(axis, mesh)
    if s is None:
        return torch.zeros_like(t)
    mesh, group, size = s
    me = axis_index(axis, mesh)
    ranks = _axis_ranks(mesh, mesh_axes(mesh, axis))
    staged = _staged(group, t)
    x = t.contiguous()
    out = torch.zeros_like(x)
    buf_out = _host(mesh, x) if staged else x
    buf_in = torch.zeros_like(buf_out)
    ops = []
    for i, j in perm:
        if i == me:
            ops.append(dist.P2POp(dist.isend, buf_out, ranks[j], group=group))
        if j == me:
            ops.append(dist.P2POp(dist.irecv, buf_in, ranks[i], group=group))
    if ops:
        # one count a send; a rank that only receives counts its wait
        with _counted(mesh, "send_recv", x, size, n=sum(1 for i, _ in perm if i == me)):
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    if any(j == me for _, j in perm):
        out = buf_in.to(t.device) if staged else buf_in
    return out


# ---------------------------------------------------------------------- #
# autograd pairs                                                         #
# ---------------------------------------------------------------------- #
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis, ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh, shards):
        ctx.axis, ctx.dim, ctx.mesh, ctx.shards = axis, dim, mesh, shards
        return all_gather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.shards:
            return reduce_scatter(g, ctx.axis, ctx.dim, ctx.mesh), None, None, None, None
        n = axis_size(ctx.axis, ctx.mesh)
        i = axis_index(ctx.axis, ctx.mesh)
        return g.chunk(n, ctx.dim)[i].contiguous(), None, None, None, None


class _FromOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: str, owner: int, shape: tuple, mesh: Mesh):
        ctx.axis, ctx.owner, ctx.mesh, ctx.local = axis, owner, mesh, x.shape
        mine = axis_index(axis, mesh) == owner
        full = x if mine else torch.zeros(shape, dtype=x.dtype, device=x.device)
        return psum(full, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        total = psum(g, ctx.axis, ctx.mesh)
        if axis_index(ctx.axis, ctx.mesh) != ctx.owner:
            total = torch.zeros(ctx.local, dtype=g.dtype, device=g.device)
        return total, None, None, None, None


def _active(axis, mesh):
    mesh = current() if mesh is None else mesh
    return mesh if mesh is not None and axis_size(axis, mesh) > 1 else None


def copy_to(x: torch.Tensor, axis, mesh: Mesh | None = None) -> torch.Tensor:
    """Megatron's f: identity forward, Σ over ``axis`` backward (the input of
    a layer whose ranks each compute a part from the whole ``x``)."""
    mesh = _active(axis, mesh)
    return x if mesh is None else _CopyTo.apply(x, axis, mesh)


def reduce_from(x: torch.Tensor, axis, mesh: Mesh | None = None) -> torch.Tensor:
    """Megatron's g: Σ over ``axis`` forward, identity backward (the ranks'
    parts of one value that every rank then uses alike)."""
    mesh = _active(axis, mesh)
    return x if mesh is None else _ReduceFrom.apply(x, axis, mesh)


def gather_copies(x: torch.Tensor, axis, dim: int, mesh: Mesh | None = None
                  ) -> torch.Tensor:
    """All-gather along ``dim``; backward: this rank's slice of the gradient
    (every rank computes the same thing from the whole tensor)."""
    mesh = _active(axis, mesh)
    return x if mesh is None else _Gather.apply(x, axis, dim, mesh, False)


def gather_shards(x: torch.Tensor, axis, dim: int, mesh: Mesh | None = None
                  ) -> torch.Tensor:
    """All-gather along ``dim``; backward: a reduce-scatter (the ranks use
    the whole tensor on different data, as FSDP's gather)."""
    mesh = _active(axis, mesh)
    return x if mesh is None else _Gather.apply(x, axis, dim, mesh, True)


def from_owner(x: torch.Tensor, axis, owner: int, shape, mesh: Mesh | None = None
               ) -> torch.Tensor:
    """The tensor of shape ``shape`` that the rank at index ``owner`` of
    ``axis`` holds, on every rank of the axis (the others pass a
    placeholder); backward: the ranks' gradients summed on the owner."""
    mesh = _active(axis, mesh)
    return x if mesh is None else _FromOwner.apply(x, axis, owner, tuple(shape), mesh)


# ---------------------------------------------------------------------- #
# node ownership (the SVM stack)                                         #
# ---------------------------------------------------------------------- #
def mesh_ndev(mesh: Mesh | None) -> int:
    """Rank count of a mesh (1 without one)."""
    return 1 if mesh is None else mesh.size


def shard_levels(mesh: Mesh | None, levels: int) -> int:
    """THE transition rule: the number of node-split tree levels from the
    leaves up (levels 0 .. cut-1 split, cut .. levels replicated).

    0 without a mesh or when P does not divide the leaf count (the local
    path).  Otherwise the leaves are split, and level k ≥ 1 is while n_k/P
    is even: its nodes' children and siblings are then on the same rank.
    """
    p = mesh_ndev(mesh)
    n_leaf = 2 ** levels
    if mesh is None or levels == 0 or n_leaf % p:
        return 0
    cut = 1
    while cut < levels and (n_leaf >> cut) % p == 0 and ((n_leaf >> cut) // p) % 2 == 0:
        cut += 1
    return cut


def owned_range(mesh: Mesh | None, n_k: int) -> tuple[int, int]:
    """Rank r's nodes [r·n_k/P, (r+1)·n_k/P) of a split level of n_k nodes
    (all of them without a mesh)."""
    p = mesh_ndev(mesh)
    if mesh is None or p == 1:
        return 0, n_k
    if n_k % p:
        raise ValueError(f"{n_k} nodes do not split over {p} ranks")
    per = n_k // p
    return mesh.rank * per, (mesh.rank + 1) * per


def local_rows(t, mesh: Mesh | None):
    """This rank's slice of the leading axis of a full-length array."""
    lo, hi = owned_range(mesh, t.shape[0])
    return t[lo:hi]


def all_gather_nodes(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Concatenate every rank's (n_loc, ...) block along axis 0, in rank
    order; each rank gets the whole (P·n_loc, ...) array on ``t``'s device
    (host arrays go through the mesh's device)."""
    if mesh is None:
        return t
    x = t.contiguous().to(mesh.device)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    with _counted(mesh, "all_gather", x, mesh.size):
        dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, 0).to(t.device)


def _all_reduce(t: torch.Tensor, mesh: Mesh | None, op) -> torch.Tensor:
    if mesh is None:
        return t
    x = t.to(mesh.device, copy=True)
    with _counted(mesh, "all_reduce", x, mesh.size):
        dist.all_reduce(x, op=op, group=mesh.group)
    return x.to(t.device)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Σ over ranks of each rank's ``t`` (a new tensor; ``t`` is untouched)."""
    return _all_reduce(t, mesh, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Elementwise max over ranks of each rank's ``t``."""
    return _all_reduce(t, mesh, dist.ReduceOp.MAX)


@contextlib.contextmanager
def process_group_mesh(device: str | torch.device):
    """The mesh of the process group a launcher describes, or of one rank.

    Under ``torchrun`` (RANK and WORLD_SIZE in the environment) the group
    comes from the environment: NCCL for a CUDA device, which becomes
    ``cuda:LOCAL_RANK``, gloo for the CPU.  Without it the group has one
    rank, through a FileStore in a fresh temporary directory.  Yields the
    mesh (its ``device`` is the one this rank computes on) and tears the
    group down on exit if this call started it.
    """
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    started = not dist.is_initialized()
    store_dir = None
    if started:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            store_dir = tempfile.mkdtemp()
            store = dist.FileStore(os.path.join(store_dir, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
    try:
        yield make_mesh(device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


def _rank_main(rank: int, world: int, root: str, backend: str, device: str, fn,
               args, mesh_shape=None, mesh_names=(AXIS,)) -> None:
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        else:               # one thread a CPU rank, as torchrun sets OMP_NUM_THREADS
            torch.set_num_threads(1)
        out = fn(make_mesh(dev, mesh_shape, mesh_names), *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    except BaseException:
        # torch.multiprocessing reports the first rank that failed; a rank
        # whose peer failed first then fails too, on a closed connection
        print(f"rank {rank} of {world} failed:\n{traceback.format_exc()}", file=sys.stderr,
              flush=True)
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo", device: str = "cpu",
          mesh_shape: tuple | None = None, mesh_names: tuple = (AXIS,)) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new processes, one rank each.

    The processes (``torch.multiprocessing``, start method spawn) join one
    process group through a FileStore in a fresh temporary directory (no
    port), build the mesh (``mesh_shape`` over ``mesh_names``; by default
    ("data",) over every rank), and each returns its result by
    ``torch.save``; the list comes back in rank order.  A CPU rank computes
    on one thread, as under ``torchrun``.  ``fn`` must be importable by name
    (a module-level function); CUDA tensors among ``args`` reach the ranks
    by CUDA IPC, without a copy.
    """
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        mp.spawn(_rank_main, args=(world, root, backend, device, fn, args, mesh_shape,
                                   mesh_names), nprocs=world, join=True)
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
