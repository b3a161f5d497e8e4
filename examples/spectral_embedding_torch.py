"""Lanczos spectral embedding on the O(N r) HSS kernel operator, on the port.

  PYTHONPATH=src python examples/spectral_embedding_torch.py
  PYTHONPATH=src python examples/spectral_embedding_torch.py --device cpu --n 2048

The twin of ``examples/spectral_embedding.py``: ``top_eigenpairs`` runs
fully reorthogonalized Lanczos on the HSS matvec; the kernel-PCA rows unfold
the concentric rings that k-means on the raw coordinates cannot split.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=3)
    return ap


def kmeans(x, k: int, iters: int = 30, seed: int = 0):
    """Seeded Lloyd iterations: enough for a purity readout."""
    import numpy as np

    r = np.random.default_rng(seed)
    centers = x[r.choice(x.shape[0], size=k, replace=False)]
    for _ in range(iters):
        assign = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1).argmin(1)
        for c in range(k):
            if np.any(assign == c):
                centers[c] = x[assign == c].mean(0)
    return assign


def purity(assign, labels) -> float:
    """Fraction of points in their cluster's majority class."""
    import numpy as np

    hit = sum(np.unique(labels[assign == c], return_counts=True)[1].max()
              for c in np.unique(assign))
    return hit / len(labels)


def main(argv=None) -> dict:
    import numpy as np

    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.data import synthetic

    args = parser().parse_args(argv)
    x, y = synthetic.circles(args.n, n_features=2, gap=0.8, seed=0)
    # only the compressed operator matters: the krr task with dummy targets
    engine = HSSSVMEngine(spec=KernelSpec(h=0.25),
                          comp=CompressionParams(rank=32, n_near=48, n_far=64),
                          leaf_size=256, task="krr", device=args.device)
    t0 = time.perf_counter()
    engine.prepare(x, np.zeros(args.n, np.float32))
    evals, _ = engine.top_eigenpairs(args.k)
    emb = engine.spectral_embed(args.k)
    print(f"concentric rings, n={args.n}: top-{args.k} Lanczos eigenpairs of the "
          f"{args.n}x{args.n} kernel in {time.perf_counter() - t0:.1f}s (never formed)")
    print("  eigenvalues:", np.round(evals.cpu().numpy(), 1).tolist())
    p_raw, p_emb = purity(kmeans(x, 2), y), purity(kmeans(emb, 2), y)
    print(f"  k-means purity: raw coords {p_raw:.3f} -> spectral embedding {p_emb:.3f}")
    return dict(evals=evals.cpu().numpy(), purity_raw=p_raw, purity_embedding=p_emb)


if __name__ == "__main__":
    main()
