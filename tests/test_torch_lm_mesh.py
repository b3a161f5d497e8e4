"""The mesh-parallel LM over gloo ranks on the CPU against the JAX package.

``dist.api.spawn`` starts 2 ranks on a ("data", "model") mesh (1, 2) and 4
on (2, 2), once each, while this process builds the references; each rank
runs ``tests/torch_lm_mesh_ranks.py`` on a model drawn by the same seeded
``Model.init`` (``convert.lm_params_to_numpy`` hands the same parameters to
the JAX package).  At ``reduced()`` sizes, f32, remat "block":

  * gemma2 with the reference test's override (h 16, kv 8, hd 16, d 128:
    mp 2 gives 8 query heads and 4 kv heads a rank), zamba2 (hybrid: the
    SSM layers whole on every rank, the shared attention head-parallel) and
    granite (moe, top 2 of 12, padded to 16: experts 0-7 on rank 0, 8-11
    and 4 zero ones on rank 1) on (1, 2): the loss within 1e-5 of JAX's
    single-device ``loss_fn`` and every gathered gradient within 1e-4 of its
    leaf's largest |g| of ``jax.grad``'s (f32 sums in other orders, as
    tests/test_torch_train.py);
  * granite on (2, 2) with FSDP: each data shard routes its own tokens, so
    the function is the reference's shard_map body, composed here from
    ``repro.models.layers._moe_local_chunk`` per (data shard, model index)
    inside JAX's ``loss_fn``: loss and aux to 1e-5 and every gathered
    gradient within 1e-4 of its leaf's largest of ``jax.grad`` of that
    composition (the expert-parallel backward: the gates' and the tokens'
    ``copy_to``, the combine's ``reduce_from``, the aux term); and JAX's
    single-device loss within 2e-2 (the reference test's pin);
  * one AdamW step of zamba2 at 8 layers on (2, 2) with FSDP (where FSDP
    picks the layer axis, whole layers on each data rank): the metrics,
    the gradients and the updated parameters, gathered, against the port's
    local step;
  * ``compressed_psum_local`` at 4 ranks against the reference under
    ``jax.vmap(..., axis_name="data")``: the re-quantized int8 codes equal,
    the sums within 1e-6 of the largest, int8 bytes and f32 scales on the
    wire (``Mesh.stats``);
  * ``pipeline_forward`` on a 4-rank ("stage",) mesh, 6 microbatches,
    against the stages applied in sequence (rtol 1e-5, atol 1e-6);
  * a ("pod", "data", "model") mesh (2, 1, 2): the logical "data" axis
    composed of pod and data, its index, sum and gather.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as dist_ranks
import torch_lm_mesh_ranks as ranks
from repro.configs.registry import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.transformer import Model as JModel
from repro.train import grad_compress as jgc
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.data import tokens
from repro_torch.dist import api as dist_api
from repro_torch.models.transformer import Model
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")

F32 = dict(param_dtype="float32", compute_dtype="float32", remat="block")
GEMMA = ("gemma2-9b", dict(F32, n_heads=16, n_kv_heads=8, head_dim=16, d_model=128))
ZAMBA = ("zamba2-1.2b", F32)
# 12 experts pad to 16: on mp 2 each rank holds real experts, rank 1 four
# of them and four zero ones (granite at full size: 24 and 16 + 8)
GRANITE = ("granite-moe-3b-a800m", dict(F32, n_experts=12))
# 8 layers: a_log, d_skip and dt_bias stack to (8, 8), and FSDP takes the
# first of equal axes, the layer axis: each data rank owns whole layers
ZAMBA8 = ("zamba2-1.2b", dict(F32, n_layers=8))
N_COMP, BLOCK = 4 * 4096, 2048
N_MICRO, MB, WIDTH = 6, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with dist_ranks.torch_threads(1):
        yield


def _batch(arch, over, b, s):
    cfg = get_config(arch).reduced(**over)
    return {k: np.asarray(v) for k, v in tokens.batch_for_config(cfg, b, s, 0).items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _local(arch, over) -> Model:
    return Model(get_config(arch).reduced(**over), device="cpu").init(
        torch.Generator().manual_seed(0))


def _jax_pair(arch, over):
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(_local(arch, over)))
    return JModel(jget_config(arch).reduced(**over)), params


def _mesh_moe_block(dp, mp, tokens_per_chunk=65536, expert_pad=16):
    """The reference's shard_map body of ``moe_block`` on a (dp, mp) mesh,
    run per (data shard, model index) with the reference's own
    ``_moe_local_chunk``; the psum over "model" in index order, aux the
    mean over every axis."""
    def moe_block(x, p, top_k, capacity_factor):
        b, s, d = x.shape
        e = p.router.shape[-1]
        e_pad = -(-e // expert_pad) * expert_pad
        e_loc = e_pad // mp
        pad = ((0, e_pad - e), (0, 0), (0, 0))
        wg, wu, wd = (jnp.pad(w, pad) for w in (p.w_gate, p.w_up, p.w_down))
        t_loc = b * s // dp
        n_chunk = max(1, t_loc // tokens_per_chunk)
        while t_loc % n_chunk:
            n_chunk += 1
        tc = t_loc // n_chunk
        cap = min(int(max(4, (tc * top_k / e) * capacity_factor)), tc)
        xf = x.reshape(b * s, d)
        outs, auxs = [], []
        for di in range(dp):
            out_d = None
            for m in range(mp):
                sl = slice(m * e_loc, (m + 1) * e_loc)
                my = m * e_loc + jnp.arange(e_loc)
                parts = []
                for c in range(n_chunk):
                    xc = xf[di * t_loc + c * tc: di * t_loc + (c + 1) * tc]
                    part, aux = jlayers._moe_local_chunk(
                        xc, p.router, wg[sl].astype(xc.dtype), wu[sl].astype(xc.dtype),
                        wd[sl].astype(xc.dtype), top_k, cap, e_pad, my)
                    parts.append(part)
                    auxs.append(aux)
                part = jnp.concatenate(parts)
                out_d = part if out_d is None else out_d + part
            outs.append(out_d)
        return jnp.concatenate(outs).reshape(b, s, d), jnp.mean(jnp.stack(auxs))
    return moe_block


def _value_and_grad(arch, over, batch):
    """JAX's loss, aux and gradients (jitted) of the seeded model on ``batch``."""
    jm, params = _jax_pair(arch, over)
    (loss, met), grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(loss=float(loss), aux=float(met["aux"]), grads=grads)


def _local_step(arch, over, batch):
    """The port's local AdamW step: its metrics and gradients."""
    model = _local(arch, over)
    state = optim.adamw_init(dict(model.named_parameters()))
    _, met = make_train_step(model)(state, _tbatch(batch))
    return dict(metrics={k: float(v) for k, v in met.items()},
                grads={k: p.grad.clone() for k, p in model.named_parameters()})


@pytest.fixture(scope="module")
def runs():
    """The 2- and 4-rank worlds, spawned at once; meanwhile the references."""
    gemma_b, zamba_b = _batch(*GEMMA, 2, 32), _batch(*ZAMBA, 2, 32)
    granite_b, step_b = _batch(*GRANITE, 4, 32), _batch(*ZAMBA8, 4, 32)
    rng = np.random.default_rng(0)
    comp_g = rng.standard_normal((4, N_COMP)).astype(np.float32)
    pipe_w = (rng.standard_normal((4, WIDTH, WIDTH)) / np.sqrt(WIDTH)).astype(np.float32)
    pipe_b = (0.1 * rng.standard_normal((4, WIDTH))).astype(np.float32)
    pipe_x = rng.standard_normal((N_MICRO, MB, WIDTH)).astype(np.float32)
    two = [("loss_and_grads", (*GEMMA, gemma_b, False)),
           ("loss_and_grads", (*ZAMBA, zamba_b, False)),
           ("loss_and_grads", (*GRANITE, granite_b, False))]
    four = [("loss_and_grads", (*GRANITE, granite_b, True)),
            ("train_step", (*ZAMBA8, step_b, True)),
            ("compressed", (comp_g, BLOCK)),
            ("pipeline", (pipe_w, pipe_b, pipe_x)),
            ("pod", ())]
    joins = {
        2: dist_ranks.in_background(dist_api.spawn, ranks.world, 2, two, mesh_shape=(1, 2),
                                    mesh_names=("data", "model")),
        4: dist_ranks.in_background(dist_api.spawn, ranks.world, 4, four, mesh_shape=(2, 2),
                                    mesh_names=("data", "model"))}
    # on threads: the port's local AdamW step, the compressed all-reduce,
    # gemma2 and zamba2 (no MoE); meanwhile this one traces granite, whose
    # mesh reference stands the shard_map body in for moe_block
    threads = {key: dist_ranks.in_background(_value_and_grad, arch, over, batch)
               for key, (arch, over), batch in (("gemma", GEMMA, gemma_b),
                                                ("zamba", ZAMBA, zamba_b))}
    threads["step"] = dist_ranks.in_background(_local_step, *ZAMBA8, step_b)
    threads["comp"] = dist_ranks.in_background(
        lambda: np.asarray(jax.vmap(lambda g: jgc.compressed_psum_local(g, "data", 4, BLOCK),
                                    axis_name="data")(jnp.asarray(comp_g))))
    ref = {"granite": _value_and_grad(*GRANITE, granite_b)}
    saved = jtransformer.moe_block
    jtransformer.moe_block = _mesh_moe_block(2, 2)
    try:
        ref["granite_mesh"] = _value_and_grad(*GRANITE, granite_b)
    finally:
        jtransformer.moe_block = saved
    seq = torch.as_tensor(pipe_x)
    for s in range(4):
        seq = torch.tanh(seq @ torch.as_tensor(pipe_w[s]) + torch.as_tensor(pipe_b[s]))
    ref["pipe"] = seq
    ref.update({key: join() for key, join in threads.items()})
    return ref, {w: join() for w, join in joins.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _grads_close(arch, over, whole, want, rel):
    """The gathered gradients (port names) against the JAX tree, each leaf
    within ``rel`` of its largest |g|."""
    model = _local(arch, over)
    for name, p in model.named_parameters():
        p.grad = whole[name]
    got = convert.lm_params_to_numpy(model, grads=True)
    flat_g = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    flat_w = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        err = np.abs(flat_g[k] - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), (k, err, np.abs(w).max())


@pytest.mark.parametrize("case,key", [(0, "gemma"), (1, "zamba"), (2, "granite")],
                         ids=["gemma2", "zamba2", "granite"])
def test_model_parallel_loss_and_grads_match_jax(runs, case, key):
    ref, outs = runs
    arch, over = (GEMMA, ZAMBA, GRANITE)[case]
    res = [o[case] for o in outs[2]]
    for r in res:
        assert _rel(r["loss"], ref[key]["loss"]) <= 1e-5, (float(r["loss"]), ref[key]["loss"])
    _grads_close(arch, over, res[0]["grads"], ref[key]["grads"], 1e-4)


def test_expert_parallel_moe_with_fsdp_matches_the_shard_map_body(runs):
    ref, outs = runs
    for o in outs[4]:
        r = o[0]
        assert _rel(r["loss"], ref["granite_mesh"]["loss"]) <= 1e-5
        assert _rel(r["aux"], ref["granite_mesh"]["aux"]) <= 1e-5
        assert _rel(r["loss"], ref["granite"]["loss"]) <= 2e-2
    _grads_close(*GRANITE, outs[4][0][0]["grads"], ref["granite_mesh"]["grads"], 1e-4)


def test_fsdp_adamw_step_matches_the_local_step(runs):
    """The loss and the global grad norm (the squares of every rank's own
    slices, summed once) to 1e-5 of the local step's; the step's gradients,
    gathered, within 1e-4 of each leaf's largest |g| of the local step's;
    and the updated parameters, gathered, equal to the local AdamW applied
    to those gradients with that norm (1e-6 of lr).  The parameters against
    the local step's directly would measure AdamW's first step, which moves
    each by lr·g/(|g| + ε/s): a gradient summed in another order moves it
    by its rounding over |g| (1.2e-2 of lr seen on the smallest)."""
    ref, outs = runs
    for o in outs[4]:
        met = o[1]["metrics"]
        for k in ("loss", "grad_norm", "ce"):
            assert _rel(met[k], ref["step"]["metrics"][k]) <= 1e-5, k
    got = outs[4][0][1]
    assert "layers.7.a_log" in got["layer_owned"] and "layers.0.dt_bias" in got["layer_owned"]
    for name, want in ref["step"]["grads"].items():
        err = (got["grads"][name] - want).abs().max().item()
        assert err <= 1e-4 * max(want.abs().max().item(), 1e-30), name
    model = _local(*ZAMBA8)
    params = dict(model.named_parameters())
    optim.adamw_update_(got["grads"], optim.adamw_init(params), params,
                        norm=outs[4][0][1]["metrics"]["grad_norm"])
    lr = optim.AdamWConfig().lr
    for name, p in params.items():
        assert got["params"][name].shape == p.shape
        assert (got["params"][name] - p).abs().max().item() <= 1e-6 * lr, name


def test_compressed_allreduce_matches_the_reference_under_vmap(runs):
    ref, outs = runs
    want = ref["comp"]
    scale = np.abs(want).max()
    chunk = N_COMP // 4
    for r, o in enumerate(outs[4]):
        c = o[2]
        np.testing.assert_allclose(c["out"].numpy(), want[r], rtol=0, atol=1e-6 * scale)
        q_ref, s_ref = jgc._quantize(jnp.asarray(want[r][r * chunk:(r + 1) * chunk]), BLOCK)
        np.testing.assert_array_equal(c["codes"].numpy(), np.asarray(q_ref))
        assert c["same_local"]
        blocks = chunk // BLOCK
        # int8 codes and f32 scales on the wire, both stages
        assert c["stats"]["all_to_all_bytes"] == N_COMP + 4 * blocks * 4
        assert c["stats"]["all_gather_bytes"] == chunk + blocks * 4


def test_pipeline_forward_matches_sequential_stages(runs):
    ref, outs = runs
    for o in outs[4]:
        p = o[3]
        torch.testing.assert_close(p["out"], ref["pipe"], rtol=1e-5, atol=1e-6)
    # one send per active stage per tick: 3 boundaries x 6 microbatches
    assert sum(o[3]["stats"]["send_recv_calls"] for o in outs[4]) == 3 * N_MICRO


def test_pod_and_data_compose_the_logical_data_axis(runs):
    """On (pod 2, data 1, model 2) the ranks are pod·2 + model; the logical
    "data" axis runs along pod, through the group make_mesh composes."""
    _, outs = runs
    for r, o in enumerate(outs[4]):
        p, col = o[4], r % 2
        assert (p["index"], p["size"]) == (r // 2, 2)
        assert p["sum"].tolist() == [float(2 * col + 2)]
        assert p["gathered"].tolist() == [float(col), float(col + 2)]
        assert p["spec"] == (("pod", "data"), "model")


def test_one_rank_mesh_is_the_local_run():
    """A (1, 1) mesh in this process: every collective has one rank, and the
    mesh code (the MoE's mesh branch, the attention's fallback, the global
    mean) gives the local run's loss and gradients bit for bit."""
    from repro_torch.dist import sharding

    b = _tbatch(_batch(*GRANITE, 2, 32))
    local = _local(*GRANITE).trainable()
    loss_l, met_l = local.loss_fn(b)
    g_l = torch.autograd.grad(loss_l, list(local.parameters()))
    with dist_api.process_group_mesh("cpu"):
        mesh = dist_api.make_mesh("cpu", (1, 1), ("data", "model"))
        model = sharding.shard_model(_local(*GRANITE), mesh).trainable()
        with dist_api.use_mesh(mesh):
            loss_m, met_m = model.loss_fn(b)
            g_m = torch.autograd.grad(loss_m, list(model.parameters()))
    assert torch.equal(loss_l, loss_m) and torch.equal(met_l["aux"], met_m["aux"])
    assert all(torch.equal(a, c) for a, c in zip(g_l, g_m))
