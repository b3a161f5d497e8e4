"""Placement plans for parameters, optimizer state, batches and decode
caches, and the model's slices on each rank.

Twin of ``repro.dist.sharding``: the same four rules give, per leaf, which
dimension lies on which mesh axis.  Megatron-style tensor parallelism by
parameter name (wq/wk/wv/w_gate/w_up/in_proj/head split their last dim on
"model", wo/w_down/out_proj their second-to-last; MoE expert stacks split
the expert axis; ``embed`` the vocab), optionally ZeRO/FSDP: the largest
remaining axis on the data axes.  Every entry is divisibility-guarded
(``_fit``): a dim that does not divide its axes stays replicated.

A plan is a dict from the reference's tree path (a tuple of names, such as
``("layers", "attn", "wq")``) to a spec: a tuple with one entry per dim,
None or a mesh axis name (a tuple of names where ("pod", "data") compose),
as the reference's ``PartitionSpec``.  Plans are computed on the
reference's STACKED shapes (every per-layer leaf with its (L, ...) axis in
front), since FSDP's "largest free axis" is chosen there; ``ref_path`` maps
the port's parameter names onto those paths.

``shard_model`` then gives each rank its slices of every parameter of a
full ``Model``, in place: per layer, the stacked plan without its layer
entry.  Where FSDP chose the layer axis itself, each rank of the data axis
owns whole layers (the rank at index i the i-th run of L/n layers) and
``from_owner`` hands a layer's tensor to the others when it runs.  The
expert stacks lie on "model" as the mesh MoE computes them: the expert axis
zero-padded to ``e_pad`` (a multiple of 16) and split in runs of e_pad/mp,
of which each rank stores the real experts only (the padded ones receive no
token and have zero weights).  ``Model`` reads ``model.placement`` to
gather what FSDP split before a layer runs (``layer_weight``);
``gather_model`` is the inverse of ``shard_model`` (the tests' view).

A decode cache is held as ``cache_shardings`` places it: ``local_shape``
gives a rank's part of any plan's leaf (``Model.cache_plan``), and
``cache_heads`` the run of kv or SSM heads that the rank's cache holds.
``placed_shape`` gives any rank's part of a parameter from the mesh's
sizes alone, the dry run's per-rank bytes (``launch/specs.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import api as dist_api

# parameter names whose LAST dim carries the output features -> "model"
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "head"}
# parameter names whose SECOND-TO-LAST dim carries input features -> "model"
_ROW_PARALLEL = {"wo", "w_down", "out_proj"}
EXPERT_PAD = 16


def _sizes(mesh) -> dict:
    return dict(mesh.shape) if isinstance(mesh, dist_api.Mesh) else dict(mesh)


def _mesh_axes(sizes: dict):
    model = "model" if "model" in sizes else None
    data = tuple(a for a in ("pod", "data") if a in sizes) or None
    return data, model


def _size(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes[a]
    return n


def _fit(spec: list, shape: tuple, sizes: dict) -> tuple:
    """Replicate any entry whose dimension doesn't divide its mesh axes."""
    out = []
    used: set = set()
    for entry, dim in zip(spec, shape):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = _size(sizes, entry)
        if any(a in used for a in axes) or dim % n or dim < n:
            out.append(None)
            continue
        used.update(axes)
        out.append(entry)
    return tuple(out)


def _data_entry(data):
    return None if data is None else (data if len(data) > 1 else data[0])


# ---------------------------------------------------------------------- #
# the four plans                                                         #
# ---------------------------------------------------------------------- #
def param_shardings(shapes: dict, mesh, fsdp: bool = False) -> dict:
    """Spec per parameter path (``shapes``: path -> the reference's shape).

    Tensor parallelism by name (see the module docstring); with ``fsdp``
    the largest remaining axis also goes on the data axes (the first of
    equal ones).  Unknown and small leaves replicate."""
    sizes = _sizes(mesh)
    data, model = _mesh_axes(sizes)
    out = {}
    for path, shape in shapes.items():
        name = path[-1] if path else ""
        shape = tuple(shape)
        nd = len(shape)
        spec: list = [None] * nd
        if model and nd >= 2:
            if "moe" in path and nd >= 3 and name in ("w_gate", "w_up", "w_down"):
                spec[nd - 3] = model        # expert axis of (L, E, d, ff)
            elif name in _COL_PARALLEL:
                spec[-1] = model
            elif name in _ROW_PARALLEL:
                spec[-2] = model
            elif name == "embed":
                spec[0] = model             # vocab axis
        if fsdp and data and nd >= 1:
            free = [i for i in range(nd) if spec[i] is None]
            if free:
                i = max(free, key=lambda j: shape[j])
                spec[i] = _data_entry(data)
        out[path] = _fit(spec, shape, sizes)
    return out


def opt_shardings(opt_shapes: dict, params_sh: dict, mesh) -> dict:
    """Optimizer-state specs: a field whose leaves are the parameters'
    paths (AdamW's m and v, Adafactor's vr and vc) mirrors their specs,
    re-fit to each leaf's own shape (a factored moment replicates where the
    spec no longer fits); anything else (the step count) replicates.
    ``opt_shapes``: field -> {path: shape} or a shape."""
    sizes = _sizes(mesh)
    out = {}
    for field, sub in opt_shapes.items():
        if isinstance(sub, dict) and set(sub) == set(params_sh):
            out[field] = {}
            for path, shape in sub.items():
                nd = len(shape)
                spec = (list(params_sh[path]) + [None] * nd)[:nd]
                out[field][path] = _fit(spec, tuple(shape), sizes)
        elif isinstance(sub, dict):
            out[field] = {p: (None,) * len(s) for p, s in sub.items()}
        else:
            out[field] = (None,) * len(sub)
    return out


def batch_shardings(batch_shapes: dict, mesh) -> dict:
    """Inputs shard their leading (batch) dim over the data axes."""
    sizes = _sizes(mesh)
    d_entry = _data_entry(_mesh_axes(sizes)[0])
    out = {}
    for key, shape in batch_shapes.items():
        spec: list = [None] * len(shape)
        if d_entry is not None and len(shape) >= 1:
            spec[0] = d_entry
        out[key] = _fit(spec, tuple(shape), sizes)
    return out


def cache_shardings(cache_shapes: dict, mesh, *, batch: int) -> dict:
    """Decode-cache specs: the batch axis (found by extent, past the stacked
    layer axis) on "data"; K/V leaves' kv-head axis and SSM states' head
    axis on "model"."""
    sizes = _sizes(mesh)
    data, model = _mesh_axes(sizes)
    d_entry = _data_entry(data)
    out = {}
    for key, shape in cache_shapes.items():
        name = key[-1] if isinstance(key, tuple) else key
        shape = tuple(shape)
        nd = len(shape)
        spec: list = [None] * nd
        if d_entry is not None:
            for i in range(1 if nd >= 2 else 0, nd):
                if shape[i] == batch:
                    spec[i] = d_entry
                    break
        if model:
            if name in ("k", "v", "shared_k", "shared_v") and nd >= 2:
                spec[-2] = model            # kv-head axis of (..., S, KV, hd)
            elif name == "ssm_state" and nd >= 3:
                spec[-3] = model            # head axis of (L, B, H, N, P)
        out[key] = _fit(spec, shape, sizes)
    return out


# ---------------------------------------------------------------------- #
# a plan's parts on each rank                                            #
# ---------------------------------------------------------------------- #
def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of each rank's part of a tensor of ``shape`` placed by
    ``spec``: every split dim divided by its axes' size."""
    sizes = _sizes(mesh)
    return tuple(d // _size(sizes, e) for d, e in zip(shape, spec))


def cache_heads(n: int, mesh=None) -> tuple[int, int]:
    """(first, count) of the heads that this rank's part of a decode cache
    holds, for a head axis of ``n`` that ``cache_shardings`` puts on "model"
    (the K/V leaves' kv heads, ``ssm_state``'s heads): the rank's run where
    ``n`` divides the "model" axis, all of them where the plan replicates
    the axis (or without a mesh; ``mesh``: the current one by default)."""
    mesh = dist_api.current() if mesh is None else mesh
    if mesh is None or "model" not in mesh.shape:
        return 0, n
    if _fit(["model"], (n,), _sizes(mesh))[0] is None:
        return 0, n
    per = n // mesh.shape["model"]
    return dist_api.axis_index("model", mesh) * per, per


# ---------------------------------------------------------------------- #
# the port's parameters on the reference's paths                         #
# ---------------------------------------------------------------------- #
_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")
_SSM = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm", "out_proj")


def ref_path(name: str) -> tuple[tuple, int | None]:
    """(the reference's tree path, the layer index or None) of the port's
    parameter ``name`` (``Model.named_parameters``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        layer, rest = int(parts[1]), parts[2:]
        head = ("layers",)
    elif parts[0] == "shared":
        layer, rest = None, parts[1:]
        head = ("shared",)
    else:
        return (name,), None
    leaf = rest[-1]
    if rest[0] == "moe":
        return head + ("moe", leaf), layer
    if leaf in _ATTN:
        return head + ("attn", leaf), layer
    if leaf in _MLP:
        return head + ("mlp", leaf), layer
    if leaf in _SSM:
        return head + ("ssm", leaf), layer
    return head + (leaf,), layer


def stacked_shapes(model) -> dict:
    """The reference's shape of every parameter path of ``model`` (a full
    model): per-layer leaves stacked over L."""
    out = {}
    n_layers = model.cfg.n_layers
    for name, p in model.named_parameters():
        path, layer = ref_path(name)
        if layer is None:
            out[path] = tuple(p.shape)
        elif layer == 0:
            out[path] = (n_layers, *p.shape)
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter's per-layer tensor lies on the mesh."""

    shape: tuple                   # the full per-layer tensor's shape
    model_dim: int | None = None   # dim split on "model"
    data_dim: int | None = None    # dim split on "data" (FSDP)
    owner: int | None = None       # FSDP chose the layer axis: the owning data index
    experts: bool = False          # model_dim is an expert axis, split by e_pad runs


def expert_range(e: int, mp: int, midx: int) -> tuple[int, int, int]:
    """(e_pad, first, end) of the real experts that model rank ``midx``
    owns: the ids [midx·e_loc, (midx+1)·e_loc) of the e_pad padded experts,
    cut at the real count ``e``."""
    e_pad = -(-e // EXPERT_PAD) * EXPERT_PAD
    if e_pad % mp:
        raise ValueError(f"{e_pad} padded experts do not split over {mp} model ranks")
    e_loc = e_pad // mp
    return e_pad, min(midx * e_loc, e), min((midx + 1) * e_loc, e)


def placements(model, mesh, fsdp: bool = False) -> dict:
    """name -> Placement for every parameter of a full ``model``."""
    sizes = _sizes(mesh)
    shapes = stacked_shapes(model)
    plan = param_shardings(shapes, sizes, fsdp)
    out = {}
    for name, p in model.named_parameters():
        path, layer = ref_path(name)
        spec = plan[path]
        owner = None
        if layer is not None:
            if spec[0] is not None:           # FSDP on the layer axis: whole layers
                per = shapes[path][0] // _size(sizes, spec[0])
                owner = layer // per
            spec = spec[1:]
        model_dim = next((i for i, e in enumerate(spec) if e == "model"), None)
        data_dim = next((i for i, e in enumerate(spec) if e is not None and e != "model"),
                        None)
        experts = "moe" in path and path[-1] in _MLP
        if experts and "model" in sizes and sizes["model"] > 1:
            model_dim = 0                      # the mesh MoE's layout
        out[name] = Placement(shape=tuple(p.shape), model_dim=model_dim, data_dim=data_dim,
                              owner=owner, experts=experts and model_dim is not None)
    return out


def placed_shape(pl: Placement, mesh, didx: int, midx: int) -> tuple:
    """The shape of the part of a per-layer tensor that the rank at data
    index ``didx`` and model index ``midx`` of ``mesh`` (a Mesh or a dict of
    axis sizes) holds: ``local_slice``'s, from the sizes alone."""
    sizes = _sizes(mesh)
    if pl.owner is not None and didx != pl.owner:
        return (0,)
    shape = list(pl.shape)
    if pl.model_dim is not None:
        if pl.experts:
            _, lo, hi = expert_range(pl.shape[0], sizes["model"], midx)
            shape[0] = hi - lo
        else:
            shape[pl.model_dim] //= sizes["model"]
    if pl.data_dim is not None:
        shape[pl.data_dim] //= _size(sizes, _mesh_axes(sizes)[0])
    return tuple(shape)


def _bounds(n: int, parts: int, idx: int) -> tuple[int, int]:
    per = n // parts
    return idx * per, (idx + 1) * per


def local_slice(full: torch.Tensor, pl: Placement, mesh) -> torch.Tensor:
    """This rank's part of a full per-layer tensor (a view)."""
    t = full
    if pl.owner is not None and dist_api.axis_index("data", mesh) != pl.owner:
        return t.new_empty((0,))
    if pl.model_dim is not None:
        mp, midx = dist_api.axis_size("model", mesh), dist_api.axis_index("model", mesh)
        if pl.experts:
            _, lo, hi = expert_range(pl.shape[0], mp, midx)
        else:
            lo, hi = _bounds(pl.shape[pl.model_dim], mp, midx)
        t = t.narrow(pl.model_dim, lo, hi - lo)
    if pl.data_dim is not None:
        dp, didx = dist_api.axis_size("data", mesh), dist_api.axis_index("data", mesh)
        lo, hi = _bounds(pl.shape[pl.data_dim], dp, didx)
        t = t.narrow(pl.data_dim, lo, hi - lo)
    return t


def shard_model(model, mesh, fsdp: bool = False, full: dict | None = None):
    """Give this rank its slices of every parameter of the full ``model``,
    in place (each parameter's data becomes a copy of its slice, so the
    full tensors can be freed), and record ``model.placement``.  ``full``:
    the whole tensors by name, for a ``model`` built on the meta device (no
    memory; e.g. tensors another process shares by CUDA IPC): its
    parameters become copies of their slices on those tensors' device."""
    plan = placements(model, mesh, fsdp)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if full is None:
                p.data = local_slice(p.data, plan[name], mesh).clone()
                continue
            t = local_slice(full[name], plan[name], mesh).clone()
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner) if owner else model, attr,
                    torch.nn.Parameter(t, requires_grad=p.requires_grad))
            model.device = t.device
    model.placement = plan
    model.placement_mesh = _sizes(mesh)
    model.weights_changed()
    return model


def _owned_shape(pl: Placement, mesh=None) -> list:
    """The shape of a tensor whose layers FSDP split: the owner's whole
    layer, cut to the rank's "model" slice."""
    shape = list(pl.shape)
    if pl.model_dim is not None:
        mp = dist_api.axis_size("model", mesh)
        if pl.experts:
            _, lo, hi = expert_range(pl.shape[0], mp, dist_api.axis_index("model", mesh))
            shape[0] = hi - lo
        else:
            shape[pl.model_dim] //= mp
    return shape


def layer_weight(t: torch.Tensor, pl: Placement | None) -> torch.Tensor:
    """A parameter (already in the compute type) as the layer computes from
    it on the current mesh: whatever FSDP split on the data axis gathered
    (backward: a reduce-scatter, or the sum back to the owning rank); the
    "model" split stays (the layer reads it from the shape)."""
    if pl is None:
        return t
    if pl.owner is not None:
        return dist_api.from_owner(t, "data", pl.owner, _owned_shape(pl))
    if pl.data_dim is not None:
        return dist_api.gather_shards(t, "data", pl.data_dim)
    return t


def split_on(t: torch.Tensor, full: int, dim: int = -1) -> bool:
    """Whether ``t`` holds a "model" slice of a dim of extent ``full``."""
    return t.shape[dim] != full


def gather_model(model, mesh, grads: bool = False) -> dict:
    """Every parameter (``grads``: its gradient) whole, on every rank: the
    inverse of ``shard_model``.  Name -> full per-layer tensor."""
    return {name: gather_param(model, name, mesh, grads)
            for name, _ in model.named_parameters()}


def gather_param(model, name: str, mesh, grads: bool = False) -> torch.Tensor:
    """One parameter (``grads``: its gradient) whole, on every rank."""
    p = model.get_parameter(name)
    pl = model.placement[name]
    t = p.grad if grads else p.data
    t = torch.zeros_like(p.data) if t is None else t.detach()
    if pl.owner is not None:
        mine = dist_api.axis_index("data", mesh) == pl.owner
        t = dist_api.psum(t if mine else t.new_zeros(_owned_shape(pl, mesh)), "data", mesh)
    elif pl.data_dim is not None:
        t = dist_api.all_gather(t, "data", pl.data_dim, mesh)
    if pl.model_dim is not None:
        if pl.experts:
            t = _gather_experts(t, pl, mesh)
        else:
            t = dist_api.all_gather(t, "model", pl.model_dim, mesh)
    return t


def _gather_experts(t: torch.Tensor, pl: Placement, mesh) -> torch.Tensor:
    """The real experts of every model rank, in expert order (the ranks
    hold runs of different lengths: padded to e_loc for the gather)."""
    mp = dist_api.axis_size("model", mesh)
    e = pl.shape[0]
    e_pad, lo, hi = expert_range(e, mp, dist_api.axis_index("model", mesh))
    e_loc = e_pad // mp
    padded = t.new_zeros((e_loc, *t.shape[1:]))
    padded[:hi - lo] = t
    return dist_api.all_gather(padded, "model", 0, mesh)[:e]


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every leaf of a global batch
    (``batch_shardings``: the leading dim over the data axes)."""
    plan = batch_shardings({k: tuple(v.shape) for k, v in batch.items()}, mesh)
    out = {}
    for k, v in batch.items():
        if plan[k] and plan[k][0] is not None:
            lo, hi = _bounds(v.shape[0], dist_api.axis_size("data", mesh),
                             dist_api.axis_index("data", mesh))
            v = v[lo:hi]
        out[k] = v
    return out


def counted(pl: Placement, mesh) -> bool:
    """Whether this rank's copy of a parameter counts in a sum over every
    rank (a global norm): a copy that the "model" or "data" axis replicates
    counts on that axis's index 0 only."""
    if pl.model_dim is None and dist_api.axis_index("model", mesh) != 0:
        return False
    if pl.owner is not None:
        return dist_api.axis_index("data", mesh) == pl.owner
    if pl.data_dim is None and dist_api.axis_index("data", mesh) != 0:
        return False
    return True


def sync_grads(grads: dict, model, mesh) -> dict:
    """The gradients of the global loss: each rank's own summed over the
    data axis, except where the FSDP gather's backward already did."""
    out = {}
    for name, g in grads.items():
        pl = model.placement[name]
        out[name] = g if (pl.data_dim is not None or pl.owner is not None) \
            else dist_api.psum(g, "data", mesh)
    return out
