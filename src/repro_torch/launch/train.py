"""Training entry point of the port: the kernel tasks' C (or λ) grid.

  PYTHONPATH=src python -m repro_torch.launch.train --task svm \\
      --svm-train 16384 --svm-c-grid 0.1,1,10
  PYTHONPATH=src python -m repro_torch.launch.train --task krr \\
      --svm-train 16384 --svm-c-grid 0.5,2,8 --device cpu

The twin of ``repro.launch.train``'s kernel path on one device:
``HSSSVMEngine.prepare`` (pad, tree, HSS compression, one factorization)
then ``train_grid`` over ``--svm-c-grid``, each model scored on a held-out
set.  ``--task krr`` / ``--task gp`` sweep the ridge λ instead (one cached
refactorization and one multi-RHS solve each, no ADMM) and report RMSE.
On a CUDA device the build runs K1 and K2 and each prediction K1.  LM
training (``--task lm``, the reference's ``train/``) is ROADMAP queue 1
item 14.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def train_svm(args) -> dict:
    """Prepare once, train the grid; print and return its numbers."""
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.data import synthetic

    task = args.task
    device = torch.device(args.device)
    dataset = args.svm_dataset
    if task in ("krr", "gp") and dataset == "blobs":
        dataset = "noisy_sine"        # the regression demo's default
    xtr, ytr, xte, yte = synthetic.train_test(dataset, args.svm_train, args.svm_test, seed=0)
    engine = HSSSVMEngine(
        spec=KernelSpec(h=args.svm_h),
        comp=CompressionParams(rank=args.svm_rank, n_near=48, n_far=64),
        leaf_size=args.svm_leaf, admm=ADMMParams(max_it=10), task=task, device=device)
    t0 = time.perf_counter()
    rep = engine.prepare(xtr, ytr)
    print(f"prepare: compress {rep.compression_s:.1f}s, factorize "
          f"{rep.factorization_s:.2f}s, HSS {rep.memory_mb:.1f} MB, beta {rep.beta:g}")
    c_grid = [float(c) for c in args.svm_c_grid.split(",")]
    regression = task in ("krr", "gp")
    knob_name = "λ" if regression else "C"
    grid = []
    for c, model in zip(c_grid, engine.train_grid(c_grid)):
        pred = model.predict(xte).cpu().numpy()
        if regression:
            rmse = float(np.sqrt(np.mean((pred - yte) ** 2)))
            grid.append(dict(knob=c, rmse=rmse))
            print(f"{knob_name}={c:g}: holdout rmse {rmse:.4f} "
                  f"(admm iters {engine.report.iters_run})")
        else:
            acc = float(np.mean(pred == yte))
            grid.append(dict(knob=c, accuracy=acc))
            print(f"{knob_name}={c:g}: holdout acc {acc:.4f}")
    total = time.perf_counter() - t0
    stage = "solve" if regression else "ADMM"
    print(f"done in {total:.1f}s ({stage} total {engine.report.admm_s:.2f}s across the "
          f"{knob_name} grid)")
    return dict(task=task, device=str(device), dataset=dataset, n_train=args.svm_train,
                compression_s=rep.compression_s, factorization_s=rep.factorization_s,
                admm_s=engine.report.admm_s, memory_mb=rep.memory_mb, beta=rep.beta,
                total_s=total, grid=grid)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="svm", choices=["lm", "svm", "krr", "gp"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--svm-dataset", default="blobs")
    ap.add_argument("--svm-train", type=int, default=16384)
    ap.add_argument("--svm-test", type=int, default=2048)
    ap.add_argument("--svm-h", type=float, default=1.0)
    ap.add_argument("--svm-c-grid", default="0.1,1,10")
    ap.add_argument("--svm-rank", type=int, default=32)
    ap.add_argument("--svm-leaf", type=int, default=256)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.task == "lm":
        raise NotImplementedError("--task lm: LM training (train/) is ROADMAP queue 1 "
                                  "item 14")
    return train_svm(args)


if __name__ == "__main__":
    main()
