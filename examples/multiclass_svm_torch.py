"""Multiclass SVM on ONE shared HSS factorization, on the port.

  PYTHONPATH=src python examples/multiclass_svm_torch.py
  PYTHONPATH=src python examples/multiclass_svm_torch.py --device cpu --n-train 2048

The twin of ``examples/multiclass_svm.py``: K̃ + βI never sees the labels,
so a k-class reduction reuses one compression and factorization for every
class subproblem, and each ADMM iteration solves all k systems as one
multi-RHS sweep.  5-class blobs (one-vs-rest, and one-vs-one beside it)
and the (h, C) grid on 3-class spirals.
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
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.multiclass import MulticlassHSSSVMTrainer, grid_search_multiclass
    from repro_torch.core.svm import accuracy_score
    from repro_torch.data import synthetic

    args = parser().parse_args(argv)
    comp = CompressionParams(rank=32, n_near=48, n_far=64)
    xtr, ytr, xte, yte = synthetic.train_test("multiclass_blobs", n_train=args.n_train,
                                              n_test=args.n_test, seed=0, n_classes=5,
                                              sep=3.0)
    out = {}
    for strategy in ("ovr", "ovo"):
        t0 = time.perf_counter()
        trainer = MulticlassHSSSVMTrainer(spec=KernelSpec(h=1.5), comp=comp, leaf_size=256,
                                          max_it=10, strategy=strategy, device=args.device)
        model = trainer.fit(xtr, ytr, c_value=1.0)
        acc = accuracy_score(model, xte, yte)
        rep = trainer.report
        print(f"5-class blobs, {strategy}: {trainer.n_problems} problems in "
              f"{time.perf_counter() - t0:.1f}s, acc={acc:.4f} (1 compression "
              f"{rep.compression_s:.1f}s + 1 factorization {rep.factorization_s:.2f}s + "
              f"batched ADMM {rep.admm_s:.2f}s)")
        out[strategy] = acc
    xtr, ytr, xte, yte = synthetic.train_test("spirals", n_train=args.n_train // 2,
                                              n_test=args.n_test // 2, seed=0, n_classes=3)
    _, info = grid_search_multiclass(
        xtr, ytr, xte, yte, hs=[0.1, 0.3], cs=[0.5, 2.0, 8.0],
        trainer_kwargs=dict(comp=comp, leaf_size=128, max_it=10, device=args.device))
    print("3-class spirals (C x class) grid:")
    for (h, c), rec in sorted(info["results"].items()):
        print(f"{h:>6} {c:>6} {rec['accuracy']:>9.4f}")
    print(f"best: h={info['best_h']} C={info['best_c']} acc={info['best_accuracy']:.4f}")
    out["grid"] = info
    return out


if __name__ == "__main__":
    main()
