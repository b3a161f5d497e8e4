#!/usr/bin/env python3
"""How often K2's plain version departs from the exact greedy pivots, on the
leaf level of chip_smoke.py's task paths (on the CPU).

Builds the path's leaf inputs as ``compression.compress`` does (the padded
tree, the leaf's NEAR and FAR proxies) and runs, on every ``--stride``-th
real leaf, the plain version of K2 (``fused_assemble_id_ref``, f32, the
squared distance by the norm expansion as the kernel has it), the same
greedy QR on the f32 block with the squared distance taken directly, and
the greedy QR of the block assembled in f64.  Prints one JSON line per
comparison: ``verify.compare_row_ids``'s fields (mismatches, the
deflation-only ``untied``/``off_greedy`` and the ``*_asm`` answers with the
assembly error bound).  From the repository root:

    PYTHONPATH=src python scripts/k2_tie_rate.py --path svr
    PYTHONPATH=src python scripts/k2_tie_rate.py --path oneclass
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core import compression, idqr, tree as tree_mod
from repro_torch.core.compression import CompressionParams
from repro_torch.data import synthetic
from repro_torch.kernels.compress import ref as cref, verify

# chip_smoke.py's task paths: dataset, its options, h; all crude, leaf 256.
PATHS = dict(svr=("noisy_sine", dict(noise=0.1), 1.0),
             oneclass=("blobs_with_outliers", dict(outlier_frac=0.1), 2.0))
LEAF = 256


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=tuple(PATHS), default="svr")
    ap.add_argument("--n", type=int, default=10 ** 6, help="training points")
    ap.add_argument("--stride", type=int, default=2, help="every stride-th leaf")
    args = ap.parse_args()
    torch.set_float32_matmul_precision("highest")
    name, kw, h = PATHS[args.path]
    comp = CompressionParams.crude()
    x = synthetic.train_test(name, args.n, 0, seed=0, **kw)[0]
    x_pad, _, mask, levels = tree_mod.pad_dataset(
        x, np.zeros(x.shape[0], np.float32), LEAF)
    t = tree_mod.build_tree(x_pad, LEAF, levels)
    x_perm = x_pad[t.perm]
    prox = np.concatenate([compression._host_leaf_near(t, comp, x_perm),
                           compression._host_proxy_indices(t, comp)[0]], axis=1)
    xt = torch.as_tensor(x_perm)
    real_leaf = np.flatnonzero(mask[t.perm].reshape(-1, LEAF).all(1))
    sel = torch.as_tensor(real_leaf[::args.stride])
    xc = xt.reshape(-1, LEAF, x.shape[1])[sel]
    xp = xt[torch.as_tensor(prox).long()][sel]
    cm = torch.ones(xc.shape[:2])
    k = min(comp.rank, LEAF)
    runs = {"plain f32": cref.fused_assemble_id_ref(xc, xp, cm, k, h, "gaussian")}
    sq = ((xp[:, :, None, :] - xc[:, None, :, :]) ** 2).sum(-1)
    a_dir = torch.exp(-sq / (2 * h * h))
    piv, q = idqr.cpqr_select(a_dir, k)
    runs["f32, squared distance taken directly"] = (piv, q.transpose(1, 2) @ a_dir)
    a64 = torch.exp(-torch.cdist(xp.double(), xc.double()) ** 2 / (2 * h * h))
    piv, q = idqr.cpqr_select(a64, k)
    exact = (piv, (q.transpose(1, 2) @ a64).float())
    for label, (pa, ra) in runs.items():
        res = verify.compare_row_ids(xc, xp, cm, h, "gaussian", comp.rtol, pa, ra, *exact)
        print(json.dumps(dict(path=args.path, n_train=args.n, leaves=int(sel.numel()),
                              run=label, against="f64 greedy", **res)), flush=True)


if __name__ == "__main__":
    main()
