"""The dry-run stack of the port (``configs/shapes``, ``launch/specs``,
``launch/dryrun``, ``roofline/``, the mesh cell of ``core/distributed``)
against the JAX package's, and the kernels' meta path.

Held against the reference where it has the function: ``cell_status`` for
every (arch, shape); ``batch_specs``; ``active_param_count`` and
``model_flops_train`` for every config; ``factorization_shapes``;
``roofline_report``'s terms (on the H100's data-sheet rates, the
reference's on the TPU's).  Per-rank argument bytes of every cell
(``launch.specs.rank_bytes``: parameters, AdamW state, batch, decode cache,
tokens) and of ``fac_shardings`` on a ("data", "model") (2, 4) mesh against
``NamedSharding(AbstractMesh(...), spec).shard_shape`` of the reference's
plans, exactly, with two differences the port makes on purpose: the decode
cache's ``pos`` is a host int (4 bytes fewer), and the MoE expert stacks
lie in runs of the e_pad padded experts (a rank holds its real ones:
granite's 40 pad to 48, 12, 12, 12 and 4 a rank where the reference's plan
splits 40 as 10 a rank), so an expert leaf holds the reference's per-expert
bytes times the rank's real experts.

K5 and K6 on meta tensors: the output shapes, and the FLOPs and bytes that
``roofline.op_cost.OpCounter`` counts for them equal to ``kernels.cost``'s
``k5_work`` / ``k6_work`` (the formulas behind ``chip_smoke.py``'s
bounds); ``visible_pairs`` against the plain mask.  Two subprocesses (the
fake process group lives in the dry run's own process) run
``python -m repro_torch.launch.dryrun`` with jax blocked, for gemma2
``decode_32k`` at 2 layers and the SVM cell on the (2, 16, 16) mesh: exit
0, ``status: ok`` records with the reference's keys.  And the real
``build_svm_cell(data=...)`` on 2 gloo ranks against the JAX local
engine's z for one C (1e-4 of C, as tests/test_torch_dist_engine.py).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

import torch_dist_ranks as dist_ranks
from repro.configs.registry import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.core import distributed as jdist
from repro.core.compression import CompressionParams as JParams
from repro.core.engine import HSSSVMEngine as JEngine
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro.dist import sharding as jshard
from repro.launch import specs as jspecs
from repro.models.transformer import Model as JModel
from repro.roofline import analysis as jra
from repro.train import optim as joptim
from repro_torch.configs import shapes
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import distributed
from repro_torch.dist import api as dist_api
from repro_torch.kernels import cost
from repro_torch.kernels.attention import ops as attn_ops, ref as attn_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import specs
from repro_torch.models.transformer import Model
from repro_torch.roofline import analysis as ra
from repro_torch.roofline.op_cost import OpCounter
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
SIZES = dict(data=2, model=4)
CELL_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
SVM = dict(data=(1024, 256), leaf=128, rank=32, comp=dict(rank=32, n_near=48, n_far=64),
           c=1.0, max_it=10)


def _np_dtype(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", list_archs())
def test_cell_status_and_batch_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, sh in shapes.SHAPES.items():
        jsh = jshapes.SHAPES[name]
        assert (sh.kind, sh.seq_len, sh.global_batch) == (jsh.kind, jsh.seq_len,
                                                         jsh.global_batch)
        assert shapes.cell_status(cfg, sh) == jshapes.cell_status(jcfg, jsh)
        got = {k: (s, _np_dtype(dt)) for k, (s, dt) in specs.batch_specs(cfg, sh).items()}
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in jspecs.batch_specs(jcfg, jsh).items()}
        assert got == want
    assert shapes.all_cells() == jshapes.all_cells()


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert ra.active_param_count(cfg) == jra.active_param_count(jcfg)
    sh = shapes.SHAPES["train_4k"]
    assert ra.model_flops_train(cfg, sh) == jra.model_flops_train(jcfg, jshapes.SHAPES["train_4k"])


def test_roofline_report_terms():
    """The reference's keys; each term the count over the H100's rate."""
    c = {"flops": 3.0e15, "bytes accessed": 2.0e12}
    coll = dict(operand_bytes=9.0e10, ring_bytes=1.5e11, per_op={}, n_collectives=3)
    got, want = ra.roofline_report(c, coll), jra.roofline_report(c, coll)
    assert set(got) == set(want)
    hw = ra.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    assert got["t_compute_s"] == 3.0e15 / 989e12
    assert got["t_memory_s"] == 2.0e12 / 3.35e12
    assert got["t_collective_s"] == 9.0e10 / 450e9
    assert got["t_collective_ring_s"] == 1.5e11 / 450e9
    assert got["dominant"] == "compute" and got["step_time_bound_s"] == got["t_compute_s"]
    # the reference's terms on its own (TPU) rates, the same arithmetic
    assert want["t_compute_s"] == 3.0e15 / jra.HW().peak_flops


def test_factorization_shapes_and_fac_shardings_match_the_reference():
    n, leaf, rank = 1 << 16, 256, 32
    got = distributed.factorization_shapes(n, leaf, rank)
    want = jdist.factorization_shapes(n, leaf, rank)
    assert got["levels"] == want.levels and got["leaf_size"] == want.leaf_size
    flat = {"e_leaf": want.e_leaf, "g_leaf": want.g_leaf, "root_lu": want.root_lu,
            "root_piv": want.root_piv}
    flat.update({f"e_lvls.{i}": a for i, a in enumerate(want.e_lvls)})
    flat.update({f"g_lvls.{i}": a for i, a in enumerate(want.g_lvls)})
    assert {k: (s, _np_dtype(dt)) for k, (s, dt) in got["leaves"].items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in flat.items()}
    mesh = AbstractMesh(MESH, ("data", "model"))
    jsh = jdist.fac_shardings(want, mesh)
    jflat = {"e_leaf": jsh.e_leaf, "g_leaf": jsh.g_leaf, "root_lu": jsh.root_lu,
             "root_piv": jsh.root_piv}
    jflat.update({f"e_lvls.{i}": a for i, a in enumerate(jsh.e_lvls)})
    jflat.update({f"g_lvls.{i}": a for i, a in enumerate(jsh.g_lvls)})
    plan = distributed.fac_shardings(got, SIZES)
    split = 0
    for k, (s, _) in got["leaves"].items():
        want_shape = jflat[k].shard_shape(s)
        p = 8 if plan[k][0] is not None else 1
        assert (s[0] // p, *s[1:]) == tuple(want_shape), k
        split += p > 1
    assert split == 2 * 6          # the 256 leaves and levels 1-5 (128 .. 8 nodes)
    assert distributed.vec_sharding(SIZES) == (("data", "model"),)
    assert distributed.mat_sharding(SIZES) == (("data", "model"), None)


def _ref_bytes(tree, spec_tree, mesh) -> dict:
    """Leaf path -> bytes of one rank's shard (the reference's even plans)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs_ = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    out = {}
    for (path, leaf), sh in zip(flat, specs_):
        shard = NamedSharding(mesh, sh.spec).shard_shape(tuple(leaf.shape))
        out[jax.tree_util.keystr(path)] = int(np.prod(shard)) * leaf.dtype.itemsize
    return out


def _expert_leaves(ref: dict) -> list:
    return [k for k in ref if "'moe'" in k and any(f"'{w}'" in k for w in
                                                   ("w_gate", "w_up", "w_down"))]


@pytest.mark.parametrize("arch", list_archs())
def test_rank_bytes_match_the_references_shard_shapes(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = AbstractMesh(MESH, ("data", "model"))
    jm = JModel(jcfg)
    pshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    psh = jshard.param_shardings(pshapes, mesh, fsdp=True)
    pbytes = _ref_bytes(pshapes, psh, mesh)
    experts = _expert_leaves(pbytes)
    e_pad = -(-cfg.n_experts // 16) * 16 if cfg.n_experts else 0
    model = Model(cfg, device="meta")
    for name in CELL_SHAPES:
        sh, jsh = shapes.SHAPES[name], jshapes.SHAPES[name]
        if not shapes.cell_status(cfg, sh)[0]:
            continue
        got, _ = specs.rank_bytes(model, sh, SIZES, fsdp=True)
        assert len(got) == 8
        want = {"params": sum(pbytes.values())}
        if sh.kind == "train":
            opt = jax.eval_shape(joptim.adamw_init, pshapes)
            osh = jshard.opt_shardings(opt, psh, mesh)
            want["opt"] = sum(_ref_bytes(opt, osh, mesh).values())
            batch = jspecs.batch_specs(jcfg, jsh)
        elif sh.kind == "prefill":
            batch = jspecs.batch_specs(jcfg, jsh)
            batch.pop("labels", None)
            batch.pop("mask_indices", None)
        if sh.kind != "decode":
            want["batch"] = sum(_ref_bytes(batch, jshard.batch_shardings(batch, mesh),
                                           mesh).values())
        else:
            b = jsh.global_batch
            cache = jax.eval_shape(lambda: JModel(jcfg).cache_init(b, jsh.seq_len))
            cbytes = _ref_bytes(cache, jshard.cache_shardings(cache, mesh, batch=b), mesh)
            want["cache"] = sum(v for k, v in cbytes.items() if k != "['pos']")
            tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)
            want["tokens"] = sum(_ref_bytes(tok, jshard.batch_shardings(tok, mesh),
                                            mesh).values())
        for r, row in enumerate(got):
            midx = r % MESH[1]
            expect = dict(want)
            if experts:
                e_loc = e_pad // MESH[1]
                real = min(max(cfg.n_experts - midx * e_loc, 0), e_loc)
                # the experts in the reference's shard: E / mp where it splits them
                ref_e = cfg.n_experts if cfg.n_experts % MESH[1] else cfg.n_experts // MESH[1]
                for k in experts:
                    mine = pbytes[k] * real // ref_e
                    expect["params"] += mine - pbytes[k]
                    if "opt" in expect:
                        expect["opt"] += 2 * (mine - pbytes[k])
            assert row == expect, (name, r, row, expect)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("opts", [dict(causal=True, window=None, prefix_len=0),
                                  dict(causal=True, window=16, prefix_len=0),
                                  dict(causal=True, window=None, prefix_len=24),
                                  dict(causal=False, window=None, prefix_len=0),
                                  dict(causal=False, window=8, prefix_len=4)],
                         ids=["causal", "window", "prefix", "full", "window-prefix"])
def test_k5_meta_path_counts_the_kernels_work(opts):
    b, h, kvh, s, d = 2, 8, 2, 64, 32
    pos = torch.arange(s)
    pairs = int(attn_ref.visible(pos, pos, opts["causal"], opts["window"],
                                 opts["prefix_len"]).sum())
    assert cost.visible_pairs(s, opts["causal"], opts["window"], opts["prefix_len"]) == pairs
    with OpCounter() as oc:
        out = attn_ops.flash_attention(_meta((b, h, s, d)), _meta((b, kvh, s, d)),
                                       _meta((b, kvh, s, d)), **opts)
    assert out.shape == (b, h, s, d) and out.device.type == "meta" and out.dtype == torch.bfloat16
    work = cost.k5_work(b, h, kvh, s, d, 2, pairs)
    assert oc.kernels == {"flash_attention": dict(calls=1, flops=work.flops, bytes=work.bytes)}
    assert work.flops == 4.0 * d * pairs * b * h
    assert cost.k5_cost(b, h, kvh, s, d, 2, pairs) == work.bound()


@pytest.mark.parametrize("return_state", [False, True])
def test_k6_meta_path_counts_the_kernels_work(return_state):
    b, s, h, p, g, n, q = 2, 256, 8, 16, 1, 32, 64
    x = _meta((b, s, h, p))
    args = (x, _meta((b, s, h), torch.float32), _meta((h,), torch.float32),
            _meta((b, s, g, n)), _meta((b, s, g, n)), _meta((h,), torch.float32))
    with OpCounter() as oc:
        out = ssd_ops.ssd_forward(*args, chunk=q, return_state=return_state)
    y, st = out if return_state else (out, None)
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    if return_state:
        assert st.shape == (b, h, n, p) and st.dtype == torch.float32
    work = cost.k6_work(b, s, h, p, g, n, q, 2)
    assert oc.kernels == {"ssd_chunk": dict(calls=1, flops=work.flops, bytes=work.bytes)}
    assert oc.flops == work.flops and oc.bytes == work.bytes
    assert cost.k6_cost(b, s, h, p, g, n, q, 2) == work.bound()


def test_op_counter_counts_a_matmul():
    """FlopCounterMode's 2·M·N·K, the bytes of both operands and the
    product, and the temporaries' peak."""
    a = _meta((256, 512), torch.float32)
    with OpCounter() as oc:
        c = a @ a.T
        d = (c + 1.0).sum()
        del c
    assert oc.flops == 2.0 * 256 * 256 * 512
    assert oc.bytes >= 2 * 256 * 512 * 4 + 256 * 256 * 4
    # c and c + 1 alive at once when the sum is made
    assert oc.temp_peak == 2 * 256 * 256 * 4 + 4 and oc.live_after == 4


def _dryrun(args):
    """``python -m repro_torch.launch.dryrun`` with jax blocked from import."""
    code = ("import sys; sys.modules['jax'] = None; sys.argv = ['dryrun'] + sys.argv[1:]; "
            "from repro_torch.launch.dryrun import main; main()")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)


def _jax_z():
    """The reference's ADMM step of one C on the JAX local engine's
    factorization and labels."""
    je = JEngine(spec=JSpec(h=1.0), comp=JParams(**SVM["comp"]), leaf_size=SVM["leaf"],
                 beta=1e4, max_it=SVM["max_it"])
    je.prepare(*_svm_data())
    fn = jdist.make_distributed_admm_step(je.fac.beta, SVM["max_it"])
    return np.asarray(fn(je.fac, je.problem_labels[0], SVM["c"] * je.problem_masks[0])[0])


def _svm_data():
    n_tr, n_te = SVM["data"]
    return synthetic.train_test("blobs", n_tr, n_te, seed=0)[:2]


@pytest.fixture(scope="module", autouse=True)
def background():
    """Started with the file's first test, the rest running meanwhile: both
    dry-run subprocesses, and the 2 gloo ranks of the real SVM cell."""
    cases = {"gemma2": ["--arch", "gemma2-9b", "--shape", "decode_32k", "--override",
                        "n_layers=2"],
             "svm": ["--arch", "svm-hss-admm", "--shape", "admm_grid", "--multi-pod"]}
    joins = {k: dist_ranks.in_background(_dryrun, a) for k, a in cases.items()}
    joins["cell"] = dist_ranks.in_background(
        dist_api.spawn, dist_ranks.svm_cell, 2, _svm_data(), SVM["leaf"], SVM["rank"],
        SVM["comp"], SVM["c"])
    joins["z_ref"] = dist_ranks.in_background(_jax_z)
    yield joins
    for j in joins.values():
        j()


REC_KEYS = {"arch", "shape", "mesh", "n_devices", "fsdp", "status", "compile_s", "memory",
            "collectives", "roofline"}


@pytest.mark.parametrize("case", ["gemma2", "svm"])
def test_dryrun_cli_runs_the_references_cells(background, case):
    proc = background[case]()
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and REC_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "total_per_device"}
    assert set(rec["collectives"]) == {"operand_bytes", "ring_bytes", "per_op",
                                       "n_collectives"}
    assert set(jra.roofline_report({}, dict(operand_bytes=0, ring_bytes=0))) <= \
        set(rec["roofline"])
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert rec["collectives"]["n_collectives"] > 0
    if case == "gemma2":
        cfg = get_config("gemma2-9b", n_layers=2)
        sh = shapes.SHAPES["decode_32k"]
        per_rank, _ = specs.rank_bytes(Model(cfg, device="meta"), sh,
                                       dict(data=16, model=16), fsdp=True)
        assert rec["memory"]["argument_bytes"] == max(sum(r.values()) for r in per_rank)
        assert rec["n_devices"] == 256 and rec["kind"] == "decode"
        # the logits (B_loc, V) f32 are the step's output
        assert rec["memory"]["output_bytes"] == 128 // 16 * cfg.vocab * 4
    else:
        assert rec["n_devices"] == 512 and rec["mesh"] == "2x16x16"
        fac = distributed.factorization_shapes(1 << 22, 256, 64)
        plan = distributed.fac_shardings(fac, dict(pod=2, data=16, model=16))
        want = sum(np.prod(s) // (512 if plan[k][0] is not None else 1) *
                   torch.empty((), dtype=dt).element_size()
                   for k, (s, dt) in fac["leaves"].items())
        assert rec["argument_bytes_by_group"]["factorization"] == want
        assert rec["argument_bytes_by_group"]["labels"] == (1 << 22) // 512 * 4


def test_real_svm_cell_matches_the_jax_local_engine(background):
    """``build_svm_cell(mesh, data=...)`` on 2 gloo ranks: the concatenated
    z of one C against the reference's ADMM step on the JAX local engine's
    factorization and labels."""
    z_ref = background["z_ref"]()
    res = background["cell"]()
    assert all(r["cut"] > 0 and r["e_leaf"][0] == 4 and r["rows"] == 512 for r in res)
    assert res[0]["spec"] == (("data",), None, None)
    z = torch.cat([r["z"] for r in res]).numpy()
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=1e-4 * SVM["c"])
