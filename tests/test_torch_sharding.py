"""The port's placement plans (``repro_torch.dist.sharding``) against the
JAX package's ``repro.dist.sharding`` for all ten configurations at full
size, on meshes (1, 2), (2, 2), (4, 2) and (1, 8) of ("data", "model").

No ranks: the reference's rules run on ``jax.sharding.AbstractMesh`` (no
devices) over the shapes of ``jax.eval_shape(Model(cfg).init, ...)``, and
the port's on a ``Model`` built on the meta device (no memory) through
``sharding.ref_path``, the name map from the port's parameters to the
reference's tree paths.  Per leaf, the dim and axis of every entry are
held equal: parameters with FSDP off and on, AdamW's and Adafactor's
state, a batch and a decode cache; and ``dist.api.resolve_spec``'s
divisibility fallback against the reference's, ("pod", "data") composed.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.tree_util import DictKey, GetAttrKey, SequenceKey

from repro.configs import get_config as jax_config
from repro.data.tokens import batch_for_config
from repro.dist import api as jdist_api, sharding as jshard
from repro.models.transformer import Model as JModel
from repro.train import optim as joptim
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.dist import api as dist_api, sharding
from repro_torch.models.transformer import Model
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

MESHES = [(1, 2), (2, 2), (4, 2), (1, 8)]
BATCH, SEQ, MAX_LEN = 8, 512, 1024


def _path(path) -> tuple:
    out = []
    for k in path:
        if isinstance(k, DictKey):
            out.append(str(k.key))
        elif isinstance(k, GetAttrKey):
            out.append(k.name)
        elif isinstance(k, SequenceKey):
            out.append(str(k.idx))
    return tuple(out)


def _flat(tree) -> dict:
    return {_path(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _spec(named, ndim) -> tuple:
    spec = tuple(named.spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module", params=sorted(ARCH_IDS))
def arch(request):
    """(name, the reference's parameter shapes by path, the port's)."""
    name = request.param
    jcfg = jax_config(name)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    ref = {p: tuple(v.shape) for p, v in _flat(shapes).items()}
    port = sharding.stacked_shapes(Model(get_config(name), device="meta"))
    return name, jcfg, shapes, ref, port


def test_name_map_covers_every_leaf(arch):
    """Every parameter of the port lands on one of the reference's paths,
    with the reference's stacked shape."""
    _, _, _, ref, port = arch
    assert port == ref


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plans_match_the_reference(arch, mesh_shape):
    name, jcfg, shapes, ref, port = arch
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    sizes = dict(zip(("data", "model"), mesh_shape))
    for fsdp in (False, True):
        want = {p: _spec(s, len(ref[p]))
                for p, s in _flat(jshard.param_shardings(shapes, mesh, fsdp=fsdp)).items()}
        assert sharding.param_shardings(port, sizes, fsdp) == want, (name, fsdp)
    # optimizer state mirrors the (FSDP) parameter plans, re-fit per leaf
    psh = jshard.param_shardings(shapes, mesh, fsdp=True)
    port_psh = sharding.param_shardings(port, sizes, fsdp=True)
    for init in (joptim.adamw_init, joptim.adafactor_init):
        opt = jax.eval_shape(init, shapes)
        got = jshard.opt_shardings(opt, psh, mesh)
        opt_shapes = {f: ({p: tuple(v.shape) for p, v in _flat(getattr(opt, f)).items()}
                          if isinstance(getattr(opt, f), dict) else tuple(getattr(opt, f).shape))
                      for f in opt._fields}
        mine = sharding.opt_shardings(opt_shapes, port_psh, sizes)
        for f in opt._fields:
            sub = getattr(opt, f)
            if isinstance(sub, dict):
                flat_sh = _flat(getattr(got, f))
                assert mine[f] == {p: _spec(flat_sh[p], len(s))
                                   for p, s in opt_shapes[f].items()}, (name, f)
            else:
                assert mine[f] == _spec(getattr(got, f), sub.ndim)
    # a batch, and a decode cache
    batch = {k: np.asarray(v) for k, v in batch_for_config(jcfg, BATCH, SEQ, 0).items()}
    bsh = jshard.batch_shardings(
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}, mesh)
    assert sharding.batch_shardings({k: v.shape for k, v in batch.items()}, sizes) == \
        {k: _spec(bsh[k], v.ndim) for k, v in batch.items()}
    cache = jax.eval_shape(lambda: JModel(jcfg).cache_init(BATCH, MAX_LEN))
    csh = jshard.cache_shardings(cache, mesh, batch=BATCH)
    assert sharding.cache_shardings({k: tuple(v.shape) for k, v in cache.items()}, sizes,
                                    batch=BATCH) == \
        {k: _spec(csh[k], v.ndim) for k, v in cache.items()}


def test_granite_vocab_stays_replicated():
    """granite's vocab of 49155 is odd: embed and head keep it whole on
    every mesh; FSDP puts d_model on "data"."""
    port = sharding.stacked_shapes(Model(get_config("granite-moe-3b-a800m"), device="meta"))
    plan = sharding.param_shardings(port, {"data": 2, "model": 2})
    assert plan[("embed",)] == (None, None) and plan[("head",)] == (None, None)
    plan = sharding.param_shardings(port, {"data": 2, "model": 2}, fsdp=True)
    assert plan[("embed",)] == (None, "data") and plan[("head",)] == ("data", None)
    assert plan[("layers", "moe", "w_gate")] == (None, "model", "data", None)


RESOLVE_CASES = [
    (("data", None), (8, 3)), (("data", "model"), (8, 4)), (("data", "model"), (6, 3)),
    (("model", "data"), (4, 4)), (("stage",), (8,)), (("data",), (0,)),
    (("data",), (2,)), (("data", "data"), (8, 8)), (("model",), (7,)),
    (("unknown", "model"), (8, 8)), (("pod",), (4,)), ((None, "model"), (3, 2)),
]
RESOLVE_MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
                  ((4,), ("stage",)), ((8,), ("data",))]


@pytest.mark.parametrize("mesh_shape,names", RESOLVE_MESHES,
                         ids=["dm", "pdm", "stage", "data"])
def test_resolve_spec_fallback_matches_the_reference(mesh_shape, names):
    mesh = AbstractMesh(mesh_shape, names)
    sizes = dict(zip(names, mesh_shape))
    with jdist_api.use_mesh(mesh):
        want = [jdist_api.resolve_spec(spec, shape) for spec, shape in RESOLVE_CASES]
    got = [dist_api.resolve_spec(spec, shape, sizes) for spec, shape in RESOLVE_CASES]
    assert got == want
    # outside a mesh every entry resolves to None
    assert dist_api.resolve_spec(("data", "model"), (8, 8)) == (None, None)


def test_layer_axis_fsdp_owns_whole_layers():
    """Where FSDP picks the stacked layer axis (mamba2's a_log is (48, 48):
    the first of equal axes), each data rank owns whole layers."""
    model = Model(get_config("mamba2-780m"), device="meta")
    plan = sharding.param_shardings(sharding.stacked_shapes(model), {"data": 4}, fsdp=True)
    assert plan[("layers", "ssm", "a_log")] == ("data", None)
    pl = sharding.placements(model, {"data": 4}, fsdp=True)
    owners = [pl[f"layers.{i}.a_log"].owner for i in range(model.cfg.n_layers)]
    assert owners == [i // 12 for i in range(48)]
    assert pl["layers.0.in_proj"].owner is None and pl["layers.0.in_proj"].data_dim == 1
