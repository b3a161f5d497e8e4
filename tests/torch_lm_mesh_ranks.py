"""What each rank runs in tests/test_torch_lm_mesh.py (``dist.api.spawn``).

Module-level functions of ``(mesh, *args)``, importable without jax: the
ranks import this module only.  Every model is drawn by ``Model.init`` from
a seeded generator, as the test process draws the same one for its
references; each rank returns CPU tensors and numbers.
"""
import torch

from repro_torch.configs.registry import get_config
from repro_torch.dist import api as dist_api, sharding
from repro_torch.dist.pipeline import pipeline_forward
from repro_torch.models.transformer import Model
from repro_torch.train import grad_compress, optim
from repro_torch.train.step import make_train_step

torch.set_float32_matmul_precision("highest")


def _tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def model_of(arch: str, over: dict) -> Model:
    cfg = get_config(arch).reduced(**over)
    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def loss_and_grads(mesh, arch, over, batch, fsdp):
    """The model sharded on ``mesh``: its loss and aux on the rank's rows of
    ``batch``, and (rank 0) every gradient gathered whole, the gradients of
    the global loss (summed over "data")."""
    model = sharding.shard_model(model_of(arch, over), mesh, fsdp=fsdp).trainable()
    params = dict(model.named_parameters())
    with dist_api.use_mesh(mesh):
        loss, metrics = model.loss_fn(sharding.shard_batch(_tensors(batch), mesh))
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = sharding.sync_grads(
            {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), got)}, model, mesh)
        for k, p in params.items():
            p.grad = grads[k]
        whole = sharding.gather_model(model, mesh, grads=True)
    return dict(loss=loss.detach(), ce=metrics["ce"].detach(), aux=metrics["aux"].detach(),
                grads=whole if mesh.rank == 0 else None)


def train_step(mesh, arch, over, batch, fsdp):
    """One AdamW step of the sharded model: the metrics, and the updated
    parameters and the step's gradients gathered whole (rank 0)."""
    model = sharding.shard_model(model_of(arch, over), mesh, fsdp=fsdp)
    step = make_train_step(model)
    state = optim.adamw_init(dict(model.named_parameters()))
    with dist_api.use_mesh(mesh):
        _, metrics = step(state, sharding.shard_batch(_tensors(batch), mesh))
        whole = sharding.gather_model(model, mesh)
        grads = sharding.gather_model(model, mesh, grads=True)
    return dict(metrics={k: v.detach() for k, v in metrics.items()},
                params=whole if mesh.rank == 0 else None,
                grads=grads if mesh.rank == 0 else None,
                layer_owned=sorted(n for n, pl in model.placement.items()
                                   if pl.owner is not None))


def compressed(mesh, grads, block):
    """``compressed_psum_local`` over a ("data",) mesh of every rank: the
    sum of the ranks' rows of ``grads``, this rank's re-quantized codes, and
    the traffic."""
    flat = dist_api.make_mesh(mesh.device)
    g = torch.as_tensor(grads[flat.rank])
    n = flat.size
    flat.reset_stats()
    out = grad_compress.make_compressed_allreduce(flat, "data", block)(g)
    stats = dict(flat.stats)
    # this rank's reduced chunk, as it went on the wire
    reduced = out.reshape(n, -1)[flat.rank]
    codes, scales = grad_compress._quantize(reduced, block)
    with dist_api.use_mesh(flat):
        local = grad_compress.compressed_psum_local(g, "data", n, block)
    return dict(out=out, codes=codes, scales=scales, stats=stats, same_local=torch.equal(
        local, out))


def pipeline(mesh, weights, biases, x):
    """``pipeline_forward`` over a ("stage",) mesh of every rank, stage s
    computing tanh(a @ weights[s] + biases[s])."""
    stages = dist_api.make_mesh(mesh.device, (mesh.size,), ("stage",))
    s = dist_api.axis_index("stage", stages)
    stages.reset_stats()
    out = pipeline_forward(lambda p, a: torch.tanh(a @ p[0] + p[1]),
                           (torch.as_tensor(weights[s]), torch.as_tensor(biases[s])),
                           torch.as_tensor(x), stages)
    return dict(out=out, stats=dict(stages.stats))


def pod(mesh):
    """A ("pod", "data", "model") mesh (2, 1, 2) of every rank: the logical
    "data" axis is ("pod", "data"), one group of its own (make_mesh's
    composite); this rank's index, size, sum and gather along it, and the
    spec a 4-row dim resolves to."""
    m = dist_api.make_mesh(mesh.device, (2, 1, 2), ("pod", "data", "model"))
    me = torch.tensor([float(torch.distributed.get_rank())])
    return dict(index=dist_api.axis_index("data", m), size=dist_api.axis_size("data", m),
                sum=dist_api.psum(me, "data", m), gathered=dist_api.all_gather(me, "data", 0, m),
                spec=dist_api.resolve_spec(("data", "model"), (4, 2), m))


def world(mesh, cases):
    """Every case (function name, args) on this rank, in order."""
    fns = dict(loss_and_grads=loss_and_grads, train_step=train_step, compressed=compressed,
               pipeline=pipeline, pod=pod)
    return [fns[name](mesh, *args) for name, args in cases]
