"""The port's mesh: node ownership and two collectives over torch.distributed.

Counterpart of ``repro.dist.api``'s node-axis rules (``mesh_ndev``,
``node_partition_spec``).  The mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` named ``("data",)`` over the
process group's ranks, one process per rank.  Where the JAX package lets
XLA's partitioner move node-stacked arrays between devices, the port calls
two collectives by hand, and only these two:

  * ``all_gather_nodes``: the ranks' node-stacked blocks, concatenated along
    the node axis in rank order;
  * ``all_reduce_sum`` (and ``all_reduce_max`` for the adaptive build's
    observed ranks): a sum of per-rank partials that every rank receives.

Node ownership.  At a level with n_k nodes over P ranks, rank r owns nodes
[r·n_k/P, (r+1)·n_k/P) (``owned_range``).  Which levels are split that way is
ONE rule, ``shard_levels``, that the build, the factorization, the solve and
the matmat all defer to: the leaves are always split (the caller falls back
to the local path when P does not divide the leaf count), and level k ≥ 1
stays split while n_k/P is even, so that every pairing of a split level (the
children of a node, the sibling of a node) is rank-local.  From the first
level that fails it, the upper tree is replicated: each rank gathers the
level below once and computes the same small upper levels.  The reference's
``node_partition_spec`` would also split the level with one node per device
(n_k = P); the port's cut lies one level lower on the factorization's and
the solve's side, which moves where the one gather happens and changes no
number (tests/test_torch_dist.py holds the cut at 1 against the rule's).

Transport.  The gather is ``dist.all_gather`` and the sums
``dist.all_reduce``, on the tensors' own device: NCCL for CUDA tensors,
gloo for CPU ones, and gloo for CUDA tensors too where NCCL cannot run (two
ranks on one card; the PyTorch 2.11 gloo takes all_gather of CUDA tensors).
``Mesh.describe()`` prints the backend and device, ``Mesh.stats`` counts
calls and bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

AXIS = "data"


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D device mesh over the process group."""

    device_mesh: object                  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device                 # where this rank's tensors live
    # per collective kind: calls and the bytes this rank handed to it
    stats: dict = dataclasses.field(default_factory=lambda: {
        "all_gather_calls": 0, "all_gather_bytes": 0,
        "all_reduce_calls": 0, "all_reduce_bytes": 0})

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    @property
    def rank(self) -> int:
        return self.device_mesh.get_local_rank()

    @property
    def group(self):
        return self.device_mesh.get_group()

    def describe(self) -> str:
        return (f"mesh {self.device_mesh.mesh_dim_names} of {self.size} ranks, backend "
                f"{dist.get_backend(self.group)}: all_gather and all_reduce on "
                f"{self.device.type} tensors")

    def reset_stats(self) -> None:
        for key in self.stats:
            self.stats[key] = 0


def make_mesh(device: str | torch.device) -> Mesh:
    """The ("data",) mesh over every rank of the initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    dm = init_device_mesh(device.type, (dist.get_world_size(),), mesh_dim_names=(AXIS,))
    return Mesh(device_mesh=dm, device=device)


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
    mesh.stats["all_gather_calls"] += 1
    mesh.stats["all_gather_bytes"] += x.numel() * x.element_size()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, 0).to(t.device)


def _all_reduce(t: torch.Tensor, mesh: Mesh | None, op) -> torch.Tensor:
    if mesh is None:
        return t
    x = t.to(mesh.device, copy=True)
    mesh.stats["all_reduce_calls"] += 1
    mesh.stats["all_reduce_bytes"] += x.numel() * x.element_size()
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
               args) -> None:
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        else:               # one thread a CPU rank, as torchrun sets OMP_NUM_THREADS
            torch.set_num_threads(1)
        out = fn(make_mesh(dev), *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo", device: str = "cpu") -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new processes, one rank each.

    The processes (``torch.multiprocessing``, start method spawn) join one
    process group through a FileStore in a fresh temporary directory (no
    port), build the ("data",) mesh, and each returns its result by
    ``torch.save``; the list comes back in rank order.  A CPU rank computes
    on one thread, as under ``torchrun``.  ``fn`` must be importable by name
    (a module-level function); CUDA tensors among ``args`` reach the ranks
    by CUDA IPC, without a copy.
    """
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        mp.spawn(_rank_main, args=(world, root, backend, device, fn, args), nprocs=world,
                 join=True)
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
