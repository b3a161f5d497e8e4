"""One-class (ν-)SVM novelty detection on the shared HSS factorization, on the port.

  PYTHONPATH=src python examples/one_class_torch.py
  PYTHONPATH=src python examples/one_class_torch.py --device cpu --n-train 2048

The twin of ``examples/one_class.py``: no labels, box [0, 1/(νn)] with
eᵀα = 1, on the classifier's compression and factorization.  A ν sweep on
one factorization with holdout precision and recall against the planted
outliers, then the (h, ν) grid.
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
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.tasks import grid_search_oneclass, oneclass_metrics
    from repro_torch.data import synthetic

    args = parser().parse_args(argv)
    comp = CompressionParams(rank=32, n_near=48, n_far=64)
    xtr, _ = synthetic.blobs_with_outliers(args.n_train, n_features=4, outlier_frac=0.1,
                                           seed=0)
    xte, yte = synthetic.blobs_with_outliers(args.n_test, n_features=4, outlier_frac=0.1,
                                             seed=1)
    engine = HSSSVMEngine(spec=KernelSpec(h=2.0), comp=comp, leaf_size=256,
                          admm=ADMMParams(max_it=30), task="oneclass", device=args.device)
    t0 = time.perf_counter()
    rep = engine.prepare(xtr)             # unsupervised: no labels
    print(f"blobs+outliers, n={args.n_train}: compressed {rep.compression_s:.1f}s + "
          f"factorized {rep.factorization_s:.2f}s ONCE for the whole ν sweep")
    warm, sweep = None, {}
    print(f"{'nu':>6} {'train outlier frac':>19} {'precision':>10} {'recall':>7}")
    for nu in (0.02, 0.05, 0.1, 0.2):
        model, warm = engine.train(nu, warm=warm)
        frac = float((model.predict(xtr) < 0).float().mean())
        m = oneclass_metrics(model.predict(xte), yte)
        sweep[nu] = m
        print(f"{nu:>6} {frac:>19.3f} {m['precision']:>10.3f} {m['recall']:>7.3f}")
    print(f"[{time.perf_counter() - t0:.1f}s total; ν bounds the training outlier "
          f"fraction]\n")
    xtr, _ = synthetic.blobs_with_outliers(args.n_train // 2, n_features=4,
                                           outlier_frac=0.1, seed=0)
    xval, yval = synthetic.blobs_with_outliers(args.n_test // 2, n_features=4,
                                               outlier_frac=0.1, seed=2)
    _, info = grid_search_oneclass(
        xtr, xval, yval, hs=[1.0, 2.0], nus=[0.05, 0.1, 0.2],
        trainer_kwargs=dict(comp=comp, leaf_size=128, admm=ADMMParams(max_it=30),
                            device=args.device))
    print("(h, ν) grid (scores are balanced inlier/outlier accuracy):")
    for (h, nu), rec in sorted(info["results"].items()):
        print(f"{h:>6} {nu:>6} {rec['accuracy']:>13.4f}")
    print(f"best: h={info['best_h']} nu={info['best_c']} "
          f"balanced_acc={info['best_accuracy']:.4f}")
    return dict(sweep=sweep, grid=info)


if __name__ == "__main__":
    main()
