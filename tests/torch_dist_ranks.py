"""What each rank runs in tests/test_torch_dist*.py (``dist.api.spawn``).

Module-level functions of ``(mesh, *args)``, importable without jax: the
spawned ranks import this module only.  Each returns plain CPU tensors and
numbers, which the test process gathers and holds against the port's local
functions and the JAX package.
"""
import contextlib
import dataclasses
import threading

import torch

from repro_torch.core import compression, factorization, hss as hss_mod
from repro_torch.core.kernelfn import KernelSpec
from repro_torch.dist import api as dist_api

torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block on ``n`` torch threads, then restore the count: these
    files' CPU work is small, and under pytest-xdist's workers the default
    (one thread a core, in every worker and rank) spins far more than it
    computes."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def in_background(fn, *args, **kw):
    """Run ``fn`` on a thread (the test process spawns its ranks this way
    and builds its references meanwhile); returns a join that gives the
    result or raises the exception."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:          # re-raised by join
            box["err"] = e

    th = threading.Thread(target=run)
    th.start()

    def join():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    return join


def _arrays(obj) -> dict:
    """Every tensor field of an HSSMatrix / HSSFactorization, on the CPU."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.cpu()
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            out[f.name] = [t.cpu() for t in v]
    return out


def collectives(mesh):
    """Both collectives on rank-dependent blocks, float and int."""
    r = mesh.rank
    blk = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    ids = torch.full((3, 2), r, dtype=torch.int32)
    return dict(gather=dist_api.all_gather_nodes(blk, mesh),
                gather_int=dist_api.all_gather_nodes(ids, mesh),
                sum=dist_api.all_reduce_sum(torch.tensor([1.0, float(r)]), mesh),
                max=dist_api.all_reduce_max(torch.tensor([r, -r], dtype=torch.int32), mesh),
                stats=dict(mesh.stats), describe=mesh.describe())


def split_stack(mesh, x_perm, tree, comps, beta, rhs):
    """For each CompressionParams kwargs: the node-split build (shrunk when
    adaptive), its factorization and its solve of this rank's rows of
    ``rhs``, at the rule's cut."""
    spec = KernelSpec(h=1.0)
    rows = dist_api.local_rows(torch.as_tensor(rhs), mesh)
    out = []
    for kw in comps:
        h, _ = hss_mod.shrink_report(compression.compress_sharded(
            x_perm, tree, spec, compression.CompressionParams(**kw), mesh, device="cpu"))
        fac = factorization.factorize(h, beta)
        out.append(dict(hss=_arrays(h), fac=_arrays(fac), cut=h.cut,
                        solve=factorization.hss_solve_mat(fac, rows)))
    return out


def hss_stack(mesh, x_perm, tree, comps, beta, rhs, small, grid):
    """For each CompressionParams kwargs: the node-split build (shrunk when
    adaptive), its factorization, solve and matmat on this rank's rows of
    ``rhs``; the same at cut 1; the whole local build cut to this rank's
    nodes (``hss.shard``) and factorized.  ``small`` = (x, tree) of a
    build whose leaf count the rank count does not divide.  ``grid`` =
    (y (n,), ys (P, n), pmask (P, n), C values): the C-grid functions of
    ``core/distributed.py`` on the first case's split factorization and on
    its whole one.  Each case also streams the build on the mesh
    (``compress_streamed(mesh=)``, 3 nodes a batch) beside
    ``compress_sharded``'s, uninterrupted and through a failure at the cut
    restarted from its checkpoints.  The first rank also returns
    ``local_references``."""
    from repro_torch.core import distributed
    coll = collectives(mesh)
    mesh.reset_stats()
    spec = KernelSpec(h=1.0)
    rows = dist_api.local_rows(torch.as_tensor(rhs), mesh)
    out = []
    for kw in comps:
        comp = compression.CompressionParams(**kw)
        res = {}
        for tag, cut in (("rule", None), ("cut1", 1)):
            h = compression.compress_sharded(x_perm, tree, spec, comp, mesh, device="cpu",
                                             cut=cut)
            h, info = hss_mod.shrink_report(h)
            if cut is None:
                h_rule = h
            fac = factorization.factorize(h, beta)
            res[tag] = dict(hss=_arrays(h), fac=_arrays(fac), cut=h.cut, info=info,
                            solve=factorization.hss_solve_mat(fac, rows),
                            matmat=h.matmat(rows), node_range=h.node_range(0))
        whole = compression.compress(x_perm, tree, spec, comp, device="cpu")
        whole, _ = hss_mod.shrink_report(whole)
        fac = factorization.factorize_sharded(whole, beta, mesh)
        res["from_whole"] = dict(fac=_arrays(fac), solve=factorization.hss_solve_mat(fac, rows))
        res["streamed"] = streamed_on_mesh(mesh, x_perm, tree, spec, comp)
        out.append(res)
        if len(out) == 1:
            y, ys, pmask, cs = grid
            split = factorization.factorize(h_rule, beta)
            whole_fac = factorization.factorize(whole, beta)
            out[0]["grid"] = dict(
                binary=[z for z, _ in distributed.admm_train_distributed(split, y, cs, mesh)],
                binary_whole=[z for z, _ in distributed.admm_train_distributed(
                    whole_fac, y, cs, mesh)],
                multi=[z for z, _ in distributed.admm_train_multiclass_distributed(
                    split, ys, cs, mesh, pmask=pmask)])
    fallback = compression.compress_sharded(small[0], small[1], spec,
                                            compression.CompressionParams(**comps[0]), mesh,
                                            device="cpu")
    reference = (local_references(x_perm, tree, comps, beta, rhs, grid) if mesh.rank == 0
                 else None)
    return dict(cases=out, collectives=coll, fallback_mesh=fallback.mesh is None,
                fallback=_arrays(fallback), stats=dict(mesh.stats), reference=reference)


def streamed_on_mesh(mesh, x_perm, tree, spec, comp):
    """The streamed build on ``mesh`` and ``compress_sharded``'s, unshrunk;
    then the streamed build with checkpoints and a failure at the cut
    level, restarted in process."""
    import tempfile

    from repro_torch.dist.fault import FailureInjector

    sharded = compression.compress_sharded(x_perm, tree, spec, comp, mesh, device="cpu")
    params = compression.StreamParams(batch_leaves=3)
    st, stats = compression.compress_streamed(x_perm, tree, spec, comp, params, mesh=mesh,
                                              device="cpu")
    with tempfile.TemporaryDirectory() as d:
        again, st2 = compression.compress_streamed(
            x_perm, tree, spec, comp, dataclasses.replace(params, ckpt_dir=d),
            on_level=FailureInjector(fail_at=(sharded.cut,)).check, mesh=mesh, device="cpu")
        on_disk = sorted(p.name for p in __import__("pathlib").Path(d).iterdir())
    return dict(hss=_arrays(st), cut=st.cut, sharded=_arrays(sharded),
                sharded_cut=sharded.cut, batches=stats.n_batches, resumed=_arrays(again),
                restarts=st2.restarts, resumed_level=st2.resumed_level, ckpt_dirs=on_disk)


def local_references(x_perm, tree, comps, beta, rhs, grid):
    """The port's local build, factorization, solve and matmat of each case
    (no mesh), and the C-grid functions' reference: the local ADMM,
    warm-started over the same C values."""
    from repro_torch.core import admm

    local = []
    for kw in comps:
        h, _ = hss_mod.shrink_report(compression.compress(
            x_perm, tree, KernelSpec(h=1.0), compression.CompressionParams(**kw), device="cpu"))
        fac = factorization.factorize(h, beta)
        local.append(dict(hss=h, fac=fac,
                          solve=factorization.hss_solve_mat(fac, torch.as_tensor(rhs)),
                          matmat=h.matmat(torch.as_tensor(rhs))))
    y, ys, pmask, cs = grid
    fac = local[0]["fac"]
    warm, warm_m, zs, zs_m = (None, None), (None, None), [], []
    for c in cs:
        st, _ = admm.admm_svm(fac.solve, torch.as_tensor(y), c, beta, 10, *warm)
        warm = (st.z, st.mu)
        zs.append(st.z)
        st, _ = admm.admm_svm_batched(fac.solve_mat, torch.as_tensor(ys),
                                      c * torch.as_tensor(pmask), beta, 10, *warm_m)
        warm_m = (st.z, st.mu)
        zs_m.append(st.z)
    return dict(local=local, grid=dict(binary=zs, multi=zs_m))


def engine_cases(mesh, cases, xte, root):
    """Each case (name, engine kwargs, prepare args, knobs, extra) through
    ``HSSSVMEngine(mesh=mesh)``: this rank's duals, the biases, the psum
    scores and predictions on ``xte[name]``; for "binary" also the local
    scorer of the gathered model, the serving tier and a registry round
    trip, ``top_eigenpairs`` from the given ``v0``, the multilevel warm
    start and an adaptive-ρ run (``ADMMParams(**extra["adaptive"])``); for
    "gp" the log marginal with the given probes."""
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.serve import ModelRegistry, ServingEngine

    out = {}
    for name, kw, prep, knobs, extra in cases:
        kw = dict(kw)
        kw["spec"] = KernelSpec(h=kw.pop("h"))
        kw["comp"] = CompressionParams(**kw.pop("comp"))
        kw["admm"] = ADMMParams(max_it=kw.pop("max_it"))
        eng = HSSSVMEngine(device="cpu", mesh=mesh, **kw)
        rep = eng.prepare(*prep)
        models = eng.train_grid(knobs)
        res = dict(mesh_ranks=rep.mesh_ranks, e_leaf=tuple(eng.fac.e_leaf.shape),
                   cut=eng.hss.cut, n_rows=eng.hss.n, iters=eng.report.iters_run,
                   z_y=[m.z_y for m in models], biases=[m.biases for m in models],
                   scores=[m.decision_function(xte[name]) for m in models],
                   preds=[m.predict(xte[name]) for m in models])
        last = models[-1]
        if name == "binary":
            whole = last.gathered()
            res["local_scores"] = whole.decision_function(xte[name])
            res["whole_rows"] = whole.x_perm.shape[0]
            serve = ServingEngine(device="cpu")
            res["served"] = serve.score(serve.add_model(last), xte[name])[0]
            reg = ModelRegistry(f"{root}/rank{mesh.rank}")
            reg.save("m", last)
            loaded, _ = reg.load("m", device="cpu")
            res["registry_scores"] = loaded.decision_function(xte[name])
            evals, vecs = eng.top_eigenpairs(4, v0=torch.as_tensor(extra["v0"]))
            res["eig"] = (evals, vecs)
            res["embed"] = eng.spectral_embed(3, v0=torch.as_tensor(extra["v0"]))
            res["rho_floor"] = eng.rho_floor()
            ml, info = eng.train_multilevel(1.0, coarse_frac=0.25)
            res["multilevel"] = dict(z_y=ml.z_y, iters=info["iters_run"],
                                     coarse_iters=info["coarse_iters_run"])
            eng.admm = ADMMParams(**extra["adaptive"])      # adaptive ρ: _fac_for per β
            m, _ = eng.train(1.0)
            res["adaptive"] = dict(z_y=m.z_y, iters=eng.report.iters_run,
                                   rho=(eng.report.rho_final, eng.report.rho_rescales))
            # the same engine with the streamed build (2 nodes a batch)
            from repro_torch.core.compression import StreamParams
            st = HSSSVMEngine(device="cpu", mesh=mesh, stream=StreamParams(batch_leaves=2),
                              **kw)
            rep = st.prepare(*prep)
            m = st.train_grid(knobs)[-1]
            res["streamed"] = dict(mesh_ranks=rep.mesh_ranks, batches=rep.stream_batches,
                                   z_y=m.z_y, preds=m.predict(xte[name]))
        if name == "gp":
            res["log_marginal"] = eng.log_marginal(knobs[0], num_iters=20,
                                                   probes=torch.as_tensor(extra["probes"]))
        res["stats"] = dict(mesh.stats) if mesh is not None else {}
        out[name] = res
    return out


def svm_cell(mesh, data, leaf, rank, comp, c_value):
    """``core.distributed.build_svm_cell(mesh, data=...)`` run for real: the
    rank's rows of z and the primal residual trace of one C, the cut and the
    rank's share of the leaves."""
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.distributed import build_svm_cell

    fn, args, in_sh = build_svm_cell(mesh, leaf=leaf, rank=rank, data=data,
                                     spec=KernelSpec(h=1.0),
                                     comp=CompressionParams(**comp), c_value=c_value)
    z, res = fn(*args)
    return dict(z=z, res=res, cut=args[0].cut, e_leaf=tuple(args[0].e_leaf.shape),
                spec=in_sh[0]["e_leaf"], rows=args[1].shape[0])
