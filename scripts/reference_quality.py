#!/usr/bin/env python3
"""Quality references of the JAX package for chip_smoke.py's task paths.

Runs the JAX engine (``repro.core.engine.HSSSVMEngine``, on the CPU) at the
configurations of chip_smoke.py's ``[multi]``, ``[svr]``, ``[oneclass]`` and
``[gp]`` paths and prints one JSON line per path with the quality figures
the card's run is held to (accuracy, R², balanced accuracy), and for
``gp`` the relative residual of the solve and the Ritz residuals from
which chip_smoke.py's bounds are derived (``--impl port`` runs ``gp`` on
the PyTorch port instead, for the same figures).  These are quality
numbers, not times.  From the repository root:

    PYTHONPATH=src python scripts/reference_quality.py --n 1000000 \
        --paths multi,svr,oneclass
    PYTHONPATH=src python scripts/reference_quality.py --n 131072 --paths gp
    PYTHONPATH=src python scripts/reference_quality.py --n 131072 --paths gp --impl port

``--block`` is the scoring block (rows of test × support kernel kept live);
2048 × 2^20 f32 is 8 GB, so the default is smaller.
"""
from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.compression import CompressionParams  # noqa: E402
from repro.core.engine import HSSSVMEngine  # noqa: E402
from repro.core.kernelfn import KernelSpec  # noqa: E402
from repro.core.tasks import oneclass_metrics  # noqa: E402
from repro.data import synthetic  # noqa: E402

N_TEST = 2048
LEAF = 256


def run_multi(n: int, block: int) -> dict:
    xtr, ytr, xte, yte = synthetic.train_test(
        "multiclass_blobs", n, N_TEST, seed=0, n_classes=6, sep=3.0)
    eng = HSSSVMEngine(spec=KernelSpec(h=1.5), comp=CompressionParams.crude(),
                       leaf_size=LEAF, max_it=10, strategy="ovo")
    rep = eng.prepare(xtr, ytr)
    accs = {}
    for c, model in zip((0.5, 1.0, 2.0), eng.train_grid([0.5, 1.0, 2.0])):
        pred = np.asarray(model.predict(jnp.asarray(xte), block=block))
        accs[c] = float(np.mean(pred == yte))
    return dict(path="multi", accuracy=accs[1.0], accuracy_by_c=accs,
                ranks_post=list(rep.ranks_post))


def run_svr(n: int, block: int) -> dict:
    xtr, ytr, xte, yte = synthetic.train_test("noisy_sine", n, N_TEST, seed=0,
                                              noise=0.1)
    eng = HSSSVMEngine(spec=KernelSpec(h=1.0), comp=CompressionParams.crude(),
                       leaf_size=LEAF, max_it=10, task="svr", svr_c=2.0)
    eng.prepare(xtr, ytr)
    model, (z, _) = eng.train(0.1)
    pred = np.asarray(model.predict(jnp.asarray(xte), block=block))
    rmse = float(np.sqrt(np.mean((pred - yte) ** 2)))
    return dict(path="svr", r2=1.0 - rmse ** 2 / float(np.var(yte)), rmse=rmse,
                nonzero_duals=float(np.mean(np.abs(np.asarray(z)) > 1e-8)))


def run_oneclass(n: int, block: int) -> dict:
    xtr, _, xte, yte = synthetic.train_test("blobs_with_outliers", n, N_TEST,
                                            seed=0, outlier_frac=0.1)
    eng = HSSSVMEngine(spec=KernelSpec(h=2.0), comp=CompressionParams.crude(),
                       leaf_size=LEAF, max_it=30, task="oneclass")
    eng.prepare(xtr, None)
    model, _ = eng.train(0.1)
    m = oneclass_metrics(np.asarray(model.predict(jnp.asarray(xte), block=block)),
                         yte)
    return dict(path="oneclass", **m)


def run_gp(n: int, block: int, impl: str = "jax") -> dict:
    """``impl="port"`` runs the PyTorch port's engine (on the CPU) instead."""
    xtr, ytr, xte, yte = synthetic.train_test("noisy_sine", n, N_TEST, seed=0,
                                              noise=0.1)
    if impl == "port":
        from repro_torch.core.compression import CompressionParams as TParams
        from repro_torch.core.engine import HSSSVMEngine as TEngine
        from repro_torch.core.kernelfn import KernelSpec as TSpec
        eng = TEngine(spec=TSpec(h=1.0), comp=TParams.crude(), leaf_size=LEAF,
                      task="gp", device="cpu")
        to_np, x_test = (lambda a: a.numpy()), xte
    else:
        eng = HSSSVMEngine(spec=KernelSpec(h=1.0), comp=CompressionParams.crude(),
                           leaf_size=LEAF, task="gp")
        to_np, x_test = np.asarray, jnp.asarray(xte)
    eng.prepare(xtr, ytr)
    out = dict(path="gp", impl=impl)
    evals, vecs = eng.top_eigenpairs(8)
    ev, vv = to_np(evals), to_np(vecs)
    for lam in (0.5, 2.0):
        model, (alpha, _) = eng.train(lam)
        real = to_np(eng.problem_masks[0]) > 0
        y = to_np(eng.problem_labels[0])[real]
        a = to_np(alpha)[:, 0]
        r = np.linalg.norm((to_np(eng.hss.matmat(alpha))[:, 0] + lam * a)[real] - y)
        out[f"solve_rel_residual_lam{lam:g}"] = float(r / np.linalg.norm(y))
        # normwise backward error, with θ_max + λ standing in for |K̃ + λI|
        out[f"backward_error_lam{lam:g}"] = float(
            r / ((ev[0] + lam) * np.linalg.norm(a) + np.linalg.norm(y)))
        out[f"alpha_over_y_lam{lam:g}"] = float(np.linalg.norm(a) / np.linalg.norm(y))
        pred = to_np(model.predict(x_test, block=block))
        out[f"rmse_lam{lam:g}"] = float(np.sqrt(np.mean((pred - yte) ** 2)))
    kv = to_np(eng.hss.matmat(vecs))
    out["top_eigenvalues"] = ev.tolist()
    out["ritz_rel_residuals"] = (np.linalg.norm(kv - vv * ev[None, :], axis=0)
                                 / np.abs(ev)).tolist()
    out["log_marginal_lam0.5"] = float(eng.log_marginal(0.5))
    return out


PATHS = dict(multi=run_multi, svr=run_svr, oneclass=run_oneclass, gp=run_gp)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10 ** 6, help="training points")
    ap.add_argument("--paths", default="multi,svr,oneclass,gp")
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--impl", choices=("jax", "port"), default="jax",
                    help="gp only: the JAX package or the PyTorch port, both on the CPU")
    args = ap.parse_args()
    for name in args.paths.split(","):
        t0 = time.perf_counter()
        res = (run_gp(args.n, args.block, args.impl) if name == "gp"
               else PATHS[name](args.n, args.block))
        res.update(n_train=args.n, seconds=time.perf_counter() - t0)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
