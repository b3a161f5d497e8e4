"""Mesh-parallel HSS-ADMM on the PyTorch port: build, factor and train node-split.

  PYTHONPATH=src torchrun --nproc-per-node 4 examples/distributed_svm_torch.py --device cpu
  PYTHONPATH=src python examples/distributed_svm_torch.py --ranks 2 --device cpu
  PYTHONPATH=src python examples/distributed_svm_torch.py        # one card, one rank

The twin of ``examples/distributed_svm.py``.  Every rank is one process of
a ``torch.distributed`` group (NCCL on ``cuda:LOCAL_RANK``, gloo on the
CPU) and holds the nodes it owns: its leaves' kernel blocks, ID bases and
E/G factors, its rows of every ADMM iterate; the small upper tree is
replicated after one gather.  Under ``torchrun`` the group comes from the
environment; with ``--ranks P`` (P > 1) the script spawns P gloo ranks on
the chosen device itself; otherwise it is one rank.  Prints each rank's
``e_leaf`` shape (global / P) and the warm-started C grid's holdout
accuracy (every rank gets the whole scores from one all-reduce).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1,
                    help="spawn this many gloo ranks (without torchrun)")
    ap.add_argument("--n-train", type=int, default=16384)
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--c-grid", default="0.1,1,10")
    return ap


def run(mesh, args) -> dict:
    """One rank's share: prepare and the C grid under ``mesh``."""
    import numpy as np

    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.data import synthetic

    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(mesh.describe())
    xtr, ytr, xte, yte = synthetic.train_test("blobs", args.n_train, args.n_test, seed=0,
                                              n_features=8, sep=1.8)
    engine = HSSSVMEngine(spec=KernelSpec(h=1.0),
                          comp=CompressionParams(rank=32, n_near=48, n_far=64),
                          leaf_size=256, beta=100.0, admm=ADMMParams(max_it=10),
                          mesh=mesh, device=mesh.device)
    rep = engine.prepare(xtr, ytr)        # split compress + factorize, ONCE
    n_leaf = 2 ** rep.hss_levels
    print(f"rank {mesh.rank}: e_leaf {tuple(engine.fac.e_leaf.shape)} of "
          f"({n_leaf}, 256, {engine.fac.e_leaf.shape[-1]}) over {rep.mesh_ranks} ranks; "
          f"compress {rep.compression_s:.2f}s / factorize {rep.factorization_s:.3f}s / "
          f"HSS {rep.memory_mb:.1f} MB on this rank", flush=True)
    grid = [float(c) for c in args.c_grid.split(",")]
    accs = []
    for c, model in zip(grid, engine.train_grid(grid)):
        acc = float(np.mean(model.predict(xte).cpu().numpy() == yte))
        accs.append(acc)
        say(f"C={c:>5}: holdout acc {acc:.4f}")
    return dict(rank=mesh.rank, e_leaf=tuple(engine.fac.e_leaf.shape), accuracy=accs,
                mesh_ranks=rep.mesh_ranks)


def main(argv=None) -> list:
    from repro_torch.dist import api as dist_api

    args = parser().parse_args(argv)
    if args.ranks > 1 and "RANK" not in os.environ:
        return dist_api.spawn(run, args.ranks, args, device=args.device)
    with dist_api.process_group_mesh(args.device) as mesh:
        return [run(mesh, args)]


if __name__ == "__main__":
    main()
