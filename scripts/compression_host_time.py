#!/usr/bin/env python3
"""Time the port's compression of chip_smoke.py's [main] configuration.

Runs ``repro_torch.core.compression.compress`` on the 10^6-point blobs of
``[main]`` (8 features, sep 1.6, seed 0, padded to 2^20, leaf 256,
gaussian h 1, rank 32 with 32 + 32 proxies; ``--n`` for another size) once
for each source tree given, in the order given, and prints one JSON line per run with the wall time of the
call (host preprocessing, KD-tree query included, synchronised with the
card).  Give two trees (a parent checkout's ``src`` and this one's) in
alternating order to compare them on one machine:

    python3 scripts/compression_host_time.py --src A/src B/src B/src A/src

Each run is a fresh process, so neither tree's imports leak into the other.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
import torch
from repro_torch.core import compression, tree as tree_mod
from repro_torch.core.kernelfn import KernelSpec
from repro_torch.data import synthetic
dev = "cuda" if torch.cuda.is_available() else "cpu"
x, y, _, _ = synthetic.train_test("blobs", int(sys.argv[2]), 2048, seed=0, n_features=8,
                                  sep=1.6)
x_pad, _, _, levels = tree_mod.pad_dataset(x, y, 256)
t = tree_mod.build_tree(x_pad, 256, levels)
xp = x_pad[t.perm]
params = compression.CompressionParams(rank=32, n_near=32, n_far=32)
if dev == "cuda":
    torch.cuda.synchronize()
t0 = time.perf_counter()
hss = compression.compress(xp, t, KernelSpec(h=1.0), params, device=dev)
if dev == "cuda":
    torch.cuda.synchronize()
print(json.dumps(dict(src=sys.argv[1], device=dev, compression_s=time.perf_counter() - t0,
                      checksum=float(hss.d_leaf.double().sum()))))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", nargs="+", required=True, help="source trees, in run order")
    ap.add_argument("--n", type=int, default=10 ** 6, help="training points ([main]: 10^6)")
    args = ap.parse_args()
    for src in args.src:
        path = str(Path(src).resolve())
        out = subprocess.run([sys.executable, "-c", CHILD, path, str(args.n)], check=True,
                             text=True, capture_output=True,
                             env=dict(os.environ, PYTHONPATH=path))
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
