"""Hyper-parameter grid search with compression/factorization amortization, on the port.

  PYTHONPATH=src python examples/svm_gridsearch_torch.py
  PYTHONPATH=src python examples/svm_gridsearch_torch.py --device cpu --n-train 2048

The twin of ``examples/svm_gridsearch.py`` (paper §3.3): for a fixed kernel
width h the HSS approximation and factorization are computed ONCE and
reused for every C, so a grid column costs one ADMM run.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-train", type=int, default=16384)
    ap.add_argument("--n-test", type=int, default=4096)
    return ap


def main(argv=None) -> dict:
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.svm import grid_search
    from repro_torch.data import synthetic

    args = parser().parse_args(argv)
    xtr, ytr, xte, yte = synthetic.train_test("susy_like", n_train=args.n_train,
                                              n_test=args.n_test, seed=0)
    t0 = time.perf_counter()
    _, info = grid_search(
        xtr, ytr, xte, yte, hs=[1.0, 3.0], cs=[0.1, 1.0, 10.0],
        trainer_kwargs=dict(comp=CompressionParams(rank=32, n_near=48, n_far=64),
                            leaf_size=256, max_it=10, device=args.device))
    dt = time.perf_counter() - t0
    print(f"{'h':>6} {'C':>6} {'accuracy':>9} {'admm_s':>8}")
    for (h, c), rec in sorted(info["results"].items()):
        print(f"{h:>6} {c:>6} {rec['accuracy']:>9.4f} {rec['admm_s']:>8.3f}")
    print(f"\nbest: h={info['best_h']} C={info['best_c']} acc={info['best_accuracy']:.4f}")
    print(f"total grid time: {dt:.1f}s for {len(info['results'])} cells "
          f"({len(set(h for h, _ in info['results']))} compressions)")
    return info


if __name__ == "__main__":
    main()
