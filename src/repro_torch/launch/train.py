"""Training entry point of the port: LM training, or the kernel tasks' C (or λ) grid.

  PYTHONPATH=src python -m repro_torch.launch.train --task lm --arch zamba2-1.2b \
      --preset full --batch 4 --seq 1024 --steps 6 --ckpt-dir /tmp/run1 \
      --ckpt-every 3 --fail-at 4
  PYTHONPATH=src python -m repro_torch.launch.train --task lm --arch gemma2-9b \
      --preset tiny --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --task svm \
      --svm-train 16384 --svm-c-grid 0.1,1,10
  PYTHONPATH=src python -m repro_torch.launch.train --task krr \
      --svm-train 16384 --svm-c-grid 0.5,2,8 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --task svm --svm-mesh --device cpu

The twin of ``repro.launch.train`` on one device.  ``--task lm`` trains
``--arch`` at a preset: ``tiny``
(``reduced()``), ``small`` (4 layers, d_model 256) or ``full`` (the
config as published).  The weights come from ``Model.init`` with a
generator seeded 0 on the training device (``init_weights``), the batches from
``data.tokens.batch_for_config`` (deterministic in the step), the step from
``train.step.make_train_step`` (AdamW; ``--microbatches``).  The whole
state (parameters, AdamW's step count and moments) is checkpointed every
``--ckpt-every`` steps under ``--ckpt-dir`` (asynchronously), each step
runs under a ``StepGuard``, ``--fail-at`` injects failures, and a failed
step resumes from the latest checkpoint (``fault.run_resilient``).  On a
CUDA device the forward runs K5 and K6; their backward is their plain
versions' gradient.  The run raises where the device is absent.

``--task svm`` runs ``HSSSVMEngine.prepare`` (pad, tree, HSS compression,
one factorization) then ``train_grid`` over ``--svm-c-grid``, each model
scored on a held-out set.  ``--task krr`` / ``--task gp`` sweep the ridge
λ instead (one cached refactorization and one multi-RHS solve each, no
ADMM) and report RMSE.  On a CUDA device the build runs K1 and K2 and each
prediction K1.  ``--svm-mesh`` runs the engine node-split over a mesh of
every rank (``repro_torch.dist.api``): under ``torchrun`` the process group
comes from the environment (NCCL on ``cuda:LOCAL_RANK`` for ``--device
cuda``, gloo for ``--device cpu``), without it the mesh has one rank.
Rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def train_svm(args) -> dict:
    """Prepare once, train the grid; print and return its numbers (under
    ``--svm-mesh``, inside a mesh of every rank)."""
    if not args.svm_mesh:
        return _train_svm(args, torch.device(args.device), None)
    from repro_torch.dist.api import process_group_mesh

    with process_group_mesh(args.device) as mesh:
        if mesh.rank == 0:
            print(mesh.describe())
        return _train_svm(args, mesh.device, mesh)


def _train_svm(args, device, mesh) -> dict:
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.data import synthetic

    task = args.task
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    dataset = args.svm_dataset
    if task in ("krr", "gp") and dataset == "blobs":
        dataset = "noisy_sine"        # the regression demo's default
    xtr, ytr, xte, yte = synthetic.train_test(dataset, args.svm_train, args.svm_test, seed=0)
    engine = HSSSVMEngine(
        spec=KernelSpec(h=args.svm_h),
        comp=CompressionParams(rank=args.svm_rank, n_near=48, n_far=64),
        leaf_size=args.svm_leaf, admm=ADMMParams(max_it=10), task=task, device=device,
        mesh=mesh)
    t0 = time.perf_counter()
    rep = engine.prepare(xtr, ytr)
    if mesh is not None:
        say(f"mesh-parallel build over {rep.mesh_ranks} of {mesh.size} ranks "
            f"(e_leaf {tuple(engine.fac.e_leaf.shape)} on each)")
    say(f"prepare: compress {rep.compression_s:.1f}s, factorize "
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
            say(f"{knob_name}={c:g}: holdout rmse {rmse:.4f} "
                f"(admm iters {engine.report.iters_run})")
        else:
            acc = float(np.mean(pred == yte))
            grid.append(dict(knob=c, accuracy=acc))
            say(f"{knob_name}={c:g}: holdout acc {acc:.4f}")
    total = time.perf_counter() - t0
    stage = "solve" if regression else "ADMM"
    say(f"done in {total:.1f}s ({stage} total {engine.report.admm_s:.2f}s across the "
        f"{knob_name} grid)")
    return dict(task=task, device=str(device), dataset=dataset, n_train=args.svm_train,
                compression_s=rep.compression_s, factorization_s=rep.factorization_s,
                admm_s=engine.report.admm_s, memory_mb=rep.memory_mb, beta=rep.beta,
                total_s=total, grid=grid, mesh_ranks=rep.mesh_ranks)


def lm_config(arch: str, preset: str):
    """``arch`` at a preset: tiny (``reduced()``), small, or full."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    if preset == "tiny":
        return cfg.reduced()
    if preset == "small":
        return cfg.reduced(n_layers=4, d_model=256, n_heads=8, head_dim=32, d_ff=1024,
                           vocab=2048)
    return cfg


def init_weights(model):
    """A run's initial weights: ``Model.init`` from a generator seeded 0 on
    the model's device (a fresh build after a failure with no checkpoint
    draws the same weights)."""
    return model.init(torch.Generator(device=model.device).manual_seed(0))


def _state_tree(model, opt) -> dict:
    """The checkpointed state: the parameters and AdamW's step and moments."""
    return {"params": {k: p.detach() for k, p in model.named_parameters()},
            "opt": {"step": opt.step, "m": opt.m, "v": opt.v}}


def train_lm(args) -> dict:
    """Train ``args.arch`` for ``args.steps`` steps under the restart loop;
    print the reference's step lines and return the run's numbers: the
    metrics of each step this call ran (``steps_run``; a replayed step's
    last run), every step's ms in the order run, the median of all but the
    first (``warm_step_ms``), tokens/s at that pace, the device's peak, and
    the trained ``model`` and its ``opt_state``."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.tokens import batch_for_config, to_device
    from repro_torch.dist import fault
    from repro_torch.launch.serve import _sync
    from repro_torch.models.transformer import Model
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    if args.arch is None:
        raise SystemExit("--arch is required for --task lm")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        torch.cuda.reset_peak_memory_stats(device)
    cfg = lm_config(args.arch, args.preset)
    model = Model(cfg, device=device)
    params = dict(model.named_parameters())
    opt_cfg = optim.AdamWConfig(lr=args.lr)
    step_fn = make_train_step(model, opt_cfg, num_microbatches=args.microbatches)
    injector = fault.FailureInjector(tuple(args.fail_at))
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    record: dict[int, dict] = {}
    step_ms: list[float] = []
    resumed: list[int] = []

    def build_state():
        init_weights(model)
        return optim.adamw_init(params, opt_cfg)

    def one_step(opt, step):
        injector.check(step)
        batch = to_device(batch_for_config(cfg, args.batch, args.seq, step), device)
        _sync(device)
        t0 = time.perf_counter()
        opt, metrics = step_fn(opt, batch)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        record[step] = {k: float(v) for k, v in metrics.items()}
        if step % args.log_every == 0:
            print(f"step {step}: loss={record[step]['loss']:.4f} "
                  f"grad_norm={record[step]['grad_norm']:.3f}", flush=True)
        return opt

    def save(opt, step):
        if manager:
            manager.save_async(_state_tree(model, opt), step)

    def restore():
        if not manager:
            return None
        # the template's leaves give each restored leaf its device (the live
        # parameters stand in for the moments: no new zeros)
        like = optim.AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                                m=params, v=params)
        try:
            tree, step = manager.restore(_state_tree(model, like))
        except FileNotFoundError:
            return None
        optim.apply_(params, tree["params"])
        model.weights_changed()
        resumed.append(step)
        print(f"resumed from step {step}", flush=True)
        return optim.AdamWState(**tree["opt"]), step

    t0 = time.perf_counter()
    opt, report = fault.run_resilient(args.steps, build_state, one_step, save, restore,
                                      ckpt_every=args.ckpt_every,
                                      guard=fault.StepGuard(deadline_s=3600.0))
    if manager:
        manager.wait()
    total = time.perf_counter() - t0
    warm = sorted(step_ms[1:])
    warm_ms = warm[len(warm) // 2] if warm else float("nan")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    print(f"done: {args.steps} steps in {total:.1f}s, restarts={report['restarts']}, "
          f"stragglers={len(report['stragglers'])}; warm step {warm_ms:.1f} ms, "
          f"{args.batch * args.seq / warm_ms * 1e3:.0f} tokens/s"
          + ("" if peak is None else f", peak device memory {peak / 2 ** 30:.2f} GiB"))
    steps = sorted(record)
    return dict(task="lm", arch=cfg.name, preset=args.preset, device=str(device),
                n_layers=cfg.n_layers, d_model=cfg.d_model, compute_dtype=cfg.compute_dtype,
                n_params=sum(p.numel() for p in params.values()), batch=args.batch,
                seq=args.seq, steps=args.steps, steps_run=steps,
                losses=[record[k]["loss"] for k in steps],
                grad_norms=[record[k]["grad_norm"] for k in steps],
                ce=[record[k]["ce"] for k in steps], aux=[record[k]["aux"] for k in steps],
                step_ms=step_ms, warm_step_ms=warm_ms,
                tokens_per_s=args.batch * args.seq / warm_ms * 1e3,
                peak_device_bytes=peak, restarts=report["restarts"], resumed_from=resumed,
                stragglers=len(report["stragglers"]), total_s=total, model=model,
                opt_state=opt, **({"final_save_error": report["final_save_error"]}
                                  if "final_save_error" in report else {}))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="svm", choices=["lm", "svm", "krr", "gp"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default=None, help="LM arch (required for lm)")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, action="append", default=[])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--svm-dataset", default="blobs")
    ap.add_argument("--svm-train", type=int, default=16384)
    ap.add_argument("--svm-test", type=int, default=2048)
    ap.add_argument("--svm-h", type=float, default=1.0)
    ap.add_argument("--svm-c-grid", default="0.1,1,10")
    ap.add_argument("--svm-rank", type=int, default=32)
    ap.add_argument("--svm-leaf", type=int, default=256)
    ap.add_argument("--svm-mesh", action="store_true",
                    help="node-split engine over a mesh of every rank (torchrun's, or one)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.task == "lm":
        return train_lm(args)
    return train_svm(args)


if __name__ == "__main__":
    main()
