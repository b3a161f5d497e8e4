"""repro_torch.analysis — static analysis for the PyTorch port.

Counterpart of ``repro.analysis``.  Two layers guard the invariants the
paper's wall-clock/accuracy claims rest on (see README "Static analysis"):

  * Layer 1 (AST lint, :mod:`repro_torch.analysis.lint` + ``rules/``): the
    reference's five rules, each ported to what it guards in torch — f32
    accumulation in hot-path contractions (and no TF32, no non-f32 mma
    accumulator in the CUDA sources), no host syncs on the hot set, no
    Python branch on a tensor there, explicit RNG generators; the
    traced-scalar knob rule is proven at layer 2 instead.
  * Layer 2 (dispatch level, :mod:`repro_torch.analysis.dispatch_check`):
    the real hot paths run on a small probe under a ``TorchDispatchMode``
    that records every aten op, asserting no low-precision accumulator, no
    host sync, one factorization per C-grid, one scorer per bucket, and
    (on two gloo ranks) that every factor's placement follows the
    node-ownership rule.  On the card each probe also runs under
    ``torch.cuda.set_sync_debug_mode("error")``.

Run ``python -m repro_torch.analysis --check [--device cpu]`` for both
layers; pre-existing, justified exceptions live in ``analysis/baseline.toml``.
The package imports torch, never jax, and nothing of ``repro``.
"""
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import lint_paths, repo_root

__all__ = ["Finding", "lint_paths", "repo_root"]
