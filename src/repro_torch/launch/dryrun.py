"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell,
counted on meta tensors (counterpart of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch svm-hss-admm --shape admm_grid
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results.jsonl

The reference lowers and compiles each cell for 256 or 512 emulated CPU
devices and reads the compiled module's memory analysis, cost analysis and
HLO.  The port has no compiled program: it runs the step of ONE rank of
the (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model")
mesh on the host, on meta tensors (shapes and types: no memory, no
arithmetic), over a fake process group whose collectives move nothing
(``launch/mesh.py``), and counts what that rank's step does:

  memory.argument_bytes — what the largest rank holds (its parameters, the
      AdamW state, its rows of the batch, its part of the decode cache):
      ``launch/specs.rank_bytes`` from the plans, for every rank; the
      traced rank is the first of the largest; the SVM cell's are its
      factorization's part, its rows of the labels and the scalar C;
  memory.output_bytes — the tensors the step returns that it created (the
      logits, prefill's cache, the train step's metrics; decode's cache
      and AdamW's state are updated in place, as the reference donates
      them);
  memory.temp_bytes — the peak of the storages the step created, alive at
      once, less the outputs (``roofline/op_cost.py``);
  collectives.* — the rank's collectives as its mesh counts them
      (``Mesh.stats``, ``Mesh.ring``; ``roofline/analysis.collective_bytes``);
  roofline.* — ``roofline_report`` of the counted FLOPs and bytes (aten
      ops through ``FlopCounterMode`` and a byte counter, K5 and K6 as the
      kernels' own work, ``kernels/cost.py``) on an H100's data-sheet rates;
  model_flops_global, model_vs_counted_flops — train cells: 6·N·D against
      the counted FLOPs times the rank count.

The reference's ``t_memory_projected_pallas_s``, ``inner_loop_bytes`` and
``projected_kernel_io_bytes`` project the Pallas kernels' IO onto an XLA
fallback's chunk loops; here the kernels are counted as themselves, so
they are dropped, as are ``raw_cost_analysis_flops`` and
``loop_multipliers`` (an eager step runs, and is counted through, every
iteration) and ``code_bytes``.  ``compile_s`` is the seconds to build and
run the cell on meta tensors.  Skipped cells follow ``cell_status``; the
process exits 1 if any cell errors.  One process, one fake group: the
mesh of each cell is made in this process (for its traced rank).
"""
import argparse
import json
import sys
import time
import traceback

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, cell_status
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import analysis as ra
from repro_torch.roofline.op_cost import OpCounter

SVM_ARCH = "svm-hss-admm"


def _sizes(multi_pod: bool) -> dict:
    return dict(pod=2, data=16, model=16) if multi_pod else dict(data=16, model=16)


def _tensors(obj) -> list:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _fac_tensors(fac) -> list:
    return [fac.e_leaf, fac.g_leaf, *fac.e_lvls, *fac.g_lvls, fac.root_lu, fac.root_piv]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def run_cell(arch: str, shape_name: str, multi_pod: bool, fsdp: bool = True,
             overrides: dict | None = None, step_kwargs: dict | None = None) -> dict:
    sizes = _sizes(multi_pod)
    n_dev = 512 if multi_pod else 256
    rec = dict(arch=arch, shape=shape_name, mesh="2x16x16" if multi_pod else "16x16",
               n_devices=n_dev, fsdp=fsdp)
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    t0 = time.time()

    if arch == SVM_ARCH:
        from repro_torch.core.distributed import build_svm_cell

        mesh = make_production_mesh(multi_pod=multi_pod)
        fn, args, _ = build_svm_cell(mesh)
        held = _fac_tensors(args[0]) + list(args[1:])
        arg_bytes = sum(_nbytes(t) for t in held)
        rec.update(traced_rank=0, argument_bytes_by_group=dict(
            factorization=sum(_nbytes(t) for t in _fac_tensors(args[0])),
            labels=_nbytes(args[1]), c=_nbytes(args[2])))
        cfg = shape = None
    else:
        from repro_torch.launch import specs
        from repro_torch.models.transformer import Model

        cfg = get_config(arch, **(overrides or {}))
        shape = SHAPES[shape_name]
        ok, why = cell_status(cfg, shape)
        if not ok:
            rec.update(status="skipped", reason=why)
            return rec
        if step_kwargs:
            rec["step_kwargs"] = {k: str(v) for k, v in step_kwargs.items()}
        per_rank, _ = specs.rank_bytes(Model(cfg, device="meta"), shape, sizes, fsdp)
        rank = specs.largest_rank(per_rank)
        mesh = make_production_mesh(multi_pod=multi_pod, rank=rank)
        cell = specs.build_cell(cfg, shape, mesh, fsdp=fsdp, step_kwargs=step_kwargs)
        fn, args = cell.fn, cell.args
        held = list(cell.model.parameters()) + _tensors(args)
        totals = [sum(r.values()) for r in per_rank]
        arg_bytes = totals[rank]
        rec.update(kind=cell.kind, traced_rank=rank, argument_bytes_by_group=per_rank[rank],
                   argument_bytes_min=min(totals))

    held_keys = {t.untyped_storage()._cdata for t in held}
    mesh.reset_stats()
    with OpCounter() as oc:
        out = fn(*args)
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(out) if t.untyped_storage()._cdata not in held_keys}
    out_bytes = sum(outs.values())
    temp = max(0, oc.temp_peak - out_bytes)
    coll = ra.collective_bytes(mesh)
    roof = ra.roofline_report({"flops": oc.flops, "bytes accessed": oc.bytes}, coll)
    roof["kernels"] = oc.kernels
    roof["aten_ops"] = oc.ops
    rec.update(
        status="ok",
        compile_s=round(time.time() - t0, 1),
        memory=dict(argument_bytes=arg_bytes, output_bytes=out_bytes, temp_bytes=temp,
                    total_per_device=arg_bytes + out_bytes + temp),
        collectives=coll,
        roofline=roof,
    )
    if cfg is not None and shape.kind == "train":
        mf = ra.model_flops_train(cfg, shape)
        rec["model_flops_global"] = mf
        counted = roof["flops_per_device"] * n_dev
        rec["model_vs_counted_flops"] = mf / counted if counted else 0.0
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (int/float/str)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-dtype", default=None)
    args = ap.parse_args()

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in SHAPES:
                cells.append((arch, shape))
        cells.append((SVM_ARCH, "admm_grid"))
    else:
        cells.append((args.arch, args.shape))
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    step_kwargs = {}
    if args.microbatches > 1:
        step_kwargs["num_microbatches"] = args.microbatches
    if args.grad_dtype:
        step_kwargs["grad_dtype"] = args.grad_dtype

    out_f = open(args.out, "a") if args.out else None
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, mp, fsdp=not args.no_fsdp,
                               overrides=overrides or None,
                               step_kwargs=step_kwargs or None)
            except Exception as e:   # noqa: BLE001 — record and continue
                rec = dict(arch=arch, shape=shape,
                           mesh="2x16x16" if mp else "16x16",
                           status="error", error=f"{type(e).__name__}: {e}",
                           trace=traceback.format_exc()[-2000:])
                n_fail += 1
            line = json.dumps(rec)
            print(line, flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
    if out_f:
        out_f.close()
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
