"""Quickstart on the PyTorch port: a nonlinear SVM with HSS-ADMM.

  PYTHONPATH=src python examples/quickstart_torch.py            # one CUDA card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n-train 2048

The twin of ``examples/quickstart.py``: build the cluster tree, HSS-compress
the Gaussian kernel (partially matrix-free), factorize once, 10 closed-form
ADMM iterations, the bias from one HSS matmat, predict (paper Algorithm 3).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-train", type=int, default=8192)
    ap.add_argument("--n-test", type=int, default=2048)
    return ap


def main(argv=None) -> dict:
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.svm import HSSSVMTrainer, accuracy_score
    from repro_torch.data import synthetic

    args = parser().parse_args(argv)
    xtr, ytr, xte, yte = synthetic.train_test(
        "circles", n_train=args.n_train, n_test=args.n_test, seed=0, n_features=4, gap=0.8)
    trainer = HSSSVMTrainer(
        spec=KernelSpec(name="gaussian", h=1.0),
        comp=CompressionParams(rank=32, n_near=48, n_far=64),
        leaf_size=256, max_it=10, device=args.device)      # the paper fixes MaxIt = 10
    report = trainer.prepare(xtr, ytr)    # compress once + factorize once
    n = args.n_train
    print(f"compression:   {report.compression_s:.2f}s")
    print(f"factorization: {report.factorization_s:.2f}s")
    print(f"HSS memory:    {report.memory_mb:.1f} MB (dense would be {n * n * 4 / 1e6:.0f} MB)")
    model, _ = trainer.train(c_value=1.0)    # ADMM only: reusable per C
    print(f"ADMM (10 iters, one C): {trainer.report.admm_s:.3f}s")
    acc = accuracy_score(model, xte, yte)
    print(f"test accuracy: {acc:.4f}")
    return dict(accuracy=acc, report=report)


if __name__ == "__main__":
    main()
