"""Kernel ridge regression and the GP posterior mean (no ADMM), on the port.

  PYTHONPATH=src python examples/krr_torch.py
  PYTHONPATH=src python examples/krr_torch.py --device cpu --n-train 2048

The twin of ``examples/krr.py``: KRR and the GP mean are one multi-RHS
solve on K̃ + λI; λ rides the factorization's β slot, so a λ sweep is one
cached refactorization and one solve per value.  Then the (h, λ) grid two
ways: holdout RMSE (KRR) and the Hutchinson log marginal (GP).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-train", type=int, default=8192)
    ap.add_argument("--n-test", type=int, default=2048)
    return ap


def main(argv=None) -> dict:
    import numpy as np

    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.krr import grid_search_gp, grid_search_krr
    from repro_torch.data import synthetic

    args = parser().parse_args(argv)
    comp = CompressionParams(rank=32, n_near=48, n_far=64)
    xtr, ytr, xte, yte = synthetic.train_test("noisy_sine", n_train=args.n_train,
                                              n_test=args.n_test, seed=0, noise=0.1)
    engine = HSSSVMEngine(spec=KernelSpec(h=1.0), comp=comp, leaf_size=256, task="krr",
                          device=args.device)
    t0 = time.perf_counter()
    rep = engine.prepare(xtr, ytr)
    print(f"noisy sine, n={args.n_train}: compressed {rep.compression_s:.1f}s ONCE for "
          f"the whole λ sweep")
    sweep = {}
    print(f"{'lam':>6} {'rmse':>8} {'admm iters':>11}")
    for lam in (0.1, 0.5, 2.0, 8.0, 32.0):
        model, _ = engine.train(lam)
        rmse = float(np.sqrt(np.mean((model.predict(xte).cpu().numpy() - yte) ** 2)))
        sweep[lam] = rmse
        print(f"{lam:>6} {rmse:>8.4f} {int(max(engine.report.iters_run)):>11}")
    print(f"[{time.perf_counter() - t0:.1f}s total; the noise floor is 0.1]\n")
    kw = dict(comp=comp, leaf_size=128, device=args.device)
    xtr, ytr, xte, yte = synthetic.train_test("noisy_sine", n_train=args.n_train // 2,
                                              n_test=args.n_test // 2, seed=0, noise=0.1)
    _, info = grid_search_krr(xtr, ytr, xte, yte, hs=[0.5, 1.0], lams=[0.3, 1.0, 4.0],
                              trainer_kwargs=kw)
    print("KRR (h, λ) grid (scores are negated validation RMSE):")
    for (h, lam), rec in sorted(info["results"].items()):
        print(f"{h:>6} {lam:>6} {-rec['accuracy']:>8.4f}")
    xtr, ytr, _, _ = synthetic.train_test("noisy_sine", n_train=args.n_train // 4,
                                          n_test=256, seed=0, noise=0.1)
    _, gp = grid_search_gp(xtr, ytr, hs=[0.5, 1.0], lams=[0.01, 0.1, 1.0],
                           trainer_kwargs=kw)
    print("GP (h, λ) grid scored by the log marginal likelihood, no holdout:")
    for (h, lam), rec in sorted(gp["results"].items()):
        print(f"{h:>6} {lam:>6} {rec['log_marginal']:>12.1f}")
    print(f"best: h={gp['best_h']} λ={gp['best_lam']} "
          f"log p(y)={gp['best_log_marginal']:.1f}")
    return dict(sweep=sweep, krr=info, gp=gp)


if __name__ == "__main__":
    main()
