"""ε-SVR on the shared HSS factorization, on the port.

  PYTHONPATH=src python examples/svr_torch.py
  PYTHONPATH=src python examples/svr_torch.py --device cpu --n-train 2048

The twin of ``examples/svr.py``: the ε-SVR dual rides the same K̃ + βI
factorization the classifier uses; only the linear term and the z-step's
soft-threshold change with (y, ε).  An ε sweep on one compression and
factorization, then the (h, ε) grid.
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

    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.tasks import grid_search_svr
    from repro_torch.data import synthetic

    args = parser().parse_args(argv)
    comp = CompressionParams(rank=32, n_near=48, n_far=64)
    xtr, ytr, xte, yte = synthetic.train_test("noisy_sine", n_train=args.n_train,
                                              n_test=args.n_test, seed=0, noise=0.1)
    engine = HSSSVMEngine(spec=KernelSpec(h=1.0), comp=comp, leaf_size=256,
                          admm=ADMMParams(max_it=10), task="svr", svr_c=2.0,
                          device=args.device)
    t0 = time.perf_counter()
    rep = engine.prepare(xtr, ytr)
    print(f"noisy sine, n={args.n_train}: compressed {rep.compression_s:.1f}s + factorized "
          f"{rep.factorization_s:.2f}s ONCE for the whole ε sweep")
    warm, sweep = None, {}
    print(f"{'eps':>6} {'rmse':>8} {'SV frac':>8}")
    for eps in (0.02, 0.05, 0.1, 0.2, 0.4):
        model, warm = engine.train(eps, warm=warm)
        pred = model.predict(xte).cpu().numpy()
        rmse = float(np.sqrt(np.mean((pred - yte) ** 2)))
        sv_frac = float((model.z_y.abs() > 1e-5).float().mean())
        sweep[eps] = rmse
        print(f"{eps:>6} {rmse:>8.4f} {sv_frac:>8.3f}")
    print(f"[{time.perf_counter() - t0:.1f}s total]\n")
    xtr, ytr, xte, yte = synthetic.train_test("noisy_step", n_train=args.n_train // 2,
                                              n_test=args.n_test // 2, seed=0, noise=0.05)
    _, info = grid_search_svr(
        xtr, ytr, xte, yte, hs=[0.2, 0.5], epsilons=[0.02, 0.1, 0.3], c_value=2.0,
        trainer_kwargs=dict(comp=comp, leaf_size=128, admm=ADMMParams(max_it=10),
                            device=args.device))
    print("noisy step (h, ε) grid (scores are negated validation RMSE):")
    for (h, e), rec in sorted(info["results"].items()):
        print(f"{h:>6} {e:>6} {-rec['accuracy']:>8.4f}")
    print(f"best: h={info['best_h']} eps={info['best_c']} rmse={-info['best_accuracy']:.4f}")
    return dict(sweep=sweep, grid=info)


if __name__ == "__main__":
    main()
