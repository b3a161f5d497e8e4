"""Model registry: trained ``EngineModel``s as persistent, versioned artifacts.

Counterpart of ``repro.serve.registry`` with the same layout and the same
fingerprint, so an artifact written by either package loads in the other.
All IO goes through ``repro_torch.ckpt`` (manifest + per-leaf shard files,
atomic rename):

    <root>/
      <name>/
        step_00000001/            # version 1
          manifest.json           # shapes/dtypes + the serve fingerprint
          x_perm.0.npz ...        # (d, f) support points, sharded
          z_y.0.npz ...           # (d, P) dual coefficient columns
          biases.0.npz
          classes.0.npz
          pairs.0.npz             # ovo only
        step_00000002/            # version 2 (a re-train of the same name)

Every version's manifest carries a **fingerprint** (``model_fingerprint``):
artifact kind, format version, task/strategy, kernel, β, shapes and dtypes.
``load`` refuses anything whose fingerprint is missing, foreign (a training
checkpoint, another tool's files) or stale (another FORMAT_VERSION), and
anything whose arrays disagree with it: a rejected artifact raises
``RegistryError`` instead of being reinterpreted.

Load transform: ``prune_tol`` drops support vectors whose dual weight is
negligible across ALL problem columns (a row with
``max_p |z_y[i, p]| <= prune_tol * max|z_y|`` adds nothing detectable to any
score), which cuts the kernel evaluations per query; ``LoadInfo`` records
how many rows were kept.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.core.engine import EngineModel
from repro_torch.core.kernelfn import KernelSpec

# Bump when the saved-artifact schema changes incompatibly; load() rejects
# any other value (stale artifacts are re-exported, never reinterpreted).
FORMAT_VERSION = 1

_KIND = "hss_svm_serve_model"
# The reference's KernelSpec also names an implementation, which the port's
# (one implementation per device) does not have: artifacts written here
# carry the reference's default, so its reader builds a valid spec; the
# port's reader ignores the field.
_IMPL = "xla"


class RegistryError(RuntimeError):
    """A registry artifact is missing, foreign, stale, or inconsistent."""


def model_fingerprint(model: EngineModel) -> dict:
    """Identity of a serve artifact: JSON-plain scalars only (the dict
    round-trips through the checkpoint manifest)."""
    d, f = model.x_perm.shape
    return dict(
        kind=_KIND,
        format_version=FORMAT_VERSION,
        task=model.task,
        strategy=model.strategy,
        binary=bool(model.binary),
        kernel=model.spec.name,
        h=float(model.spec.h),
        impl=_IMPL,
        beta=None if model.beta is None else float(model.beta),
        c_value=float(model.c_value),
        n_support=int(d),
        n_features=int(f),
        n_problems=int(model.z_y.shape[1]),
        n_classes=int(model.classes.shape[0]),
        has_pairs=model.pairs is not None,
        dtype=str(model.x_perm.dtype).replace("torch.", ""),
    )


@dataclasses.dataclass
class LoadInfo:
    """What a load did: which version, and what the pruning transform kept."""

    name: str
    version: int
    n_support_stored: int
    n_support_kept: int
    fingerprint: dict

    @property
    def pruned_frac(self) -> float:
        return 1.0 - self.n_support_kept / max(self.n_support_stored, 1)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class ModelRegistry:
    """Persist / load trained models under one root directory, versioned."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, name: str) -> str:
        if not name or os.sep in name or name.startswith("."):
            raise RegistryError(f"bad model name {name!r}")
        return os.path.join(self.root, name)

    # ------------------------------------------------------------------ #
    def names(self) -> list[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
            and ckpt.latest_step(os.path.join(self.root, d)) is not None)

    def versions(self, name: str) -> list[int]:
        path = self._dir(name)
        if not os.path.isdir(path):
            return []
        return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    # ------------------------------------------------------------------ #
    def save(self, name: str, model: EngineModel, extra: dict | None = None) -> int:
        """Persist ``model`` as the next version of ``name``; returns it.
        The arrays are copied to the host, wherever the model lives; a
        model trained under a mesh is gathered first (every rank makes the
        call, and every rank writes the same artifact: give rank 0 its own
        registry root, or the others a scratch one)."""
        model = model.gathered()
        if model.z_y.dim() != 2:
            raise RegistryError("EngineModel.z_y must be (d, P)")
        version = (ckpt.latest_step(self._dir(name)) or 0) + 1
        tree = dict(x_perm=_host(model.x_perm), z_y=_host(model.z_y),
                    biases=_host(model.biases), classes=np.asarray(model.classes))
        if model.pairs is not None:
            tree["pairs"] = np.asarray(model.pairs)
        meta = dict(fingerprint=model_fingerprint(model))
        if extra:
            meta["extra"] = dict(extra)
        ckpt.save_checkpoint(self._dir(name), tree, step=version, extra=meta)
        return version

    # ------------------------------------------------------------------ #
    def _verify(self, name: str, fp: dict, arrays: dict) -> None:
        if not isinstance(fp, dict) or fp.get("kind") != _KIND:
            raise RegistryError(
                f"{name}: foreign artifact (fingerprint kind "
                f"{fp.get('kind') if isinstance(fp, dict) else None!r}, "
                f"expected {_KIND!r}) — refusing to load")
        if fp.get("format_version") != FORMAT_VERSION:
            raise RegistryError(
                f"{name}: stale artifact format {fp.get('format_version')!r} "
                f"(this build reads {FORMAT_VERSION}) — re-export the model")
        for key in ("x_perm", "z_y", "biases", "classes"):
            if key not in arrays:
                raise RegistryError(f"{name}: artifact is missing {key!r}")
        d, f = arrays["x_perm"].shape
        p = arrays["z_y"].shape[1]
        want = dict(n_support=d, n_features=f, n_problems=p,
                    n_classes=arrays["classes"].shape[0], has_pairs="pairs" in arrays)
        for key, val in want.items():
            if fp.get(key) != val:
                raise RegistryError(
                    f"{name}: fingerprint/{key} says {fp.get(key)!r} but the stored "
                    f"arrays say {val!r} — corrupt or tampered artifact")
        if arrays["z_y"].shape[0] != d or arrays["biases"].shape[0] != p:
            raise RegistryError(f"{name}: inconsistent array shapes")

    def load(self, name: str, version: int | None = None,
             prune_tol: float | None = None, device: str | torch.device = "cuda",
             ) -> tuple[EngineModel, LoadInfo]:
        """Load a version (the latest by default) as an ``EngineModel`` whose
        tensors live on ``device``.  ``prune_tol`` applies the pruning
        transform (module docstring); None keeps the stored arrays
        bit-identically."""
        try:
            arrays, step, meta = ckpt.load_checkpoint_arrays(self._dir(name), step=version)
        except FileNotFoundError as e:
            raise RegistryError(f"{name}: no such model/version") from e
        fp = meta.get("fingerprint", {})
        self._verify(name, fp, arrays)

        x_perm, z_y = arrays["x_perm"], arrays["z_y"]
        n_stored = x_perm.shape[0]
        if prune_tol is not None:
            weight = np.max(np.abs(z_y), axis=1)           # (d,)
            keep = weight > prune_tol * max(float(weight.max()), 1e-30)
            if not keep.any():                  # degenerate: keep the top SV
                keep[int(np.argmax(weight))] = True
            x_perm, z_y = x_perm[keep], z_y[keep]

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        model = EngineModel(
            x_perm=put(x_perm), z_y=put(z_y), biases=put(arrays["biases"]),
            classes=arrays["classes"],
            spec=KernelSpec(name=fp["kernel"], h=fp["h"]),
            c_value=fp["c_value"], binary=fp["binary"], strategy=fp["strategy"],
            task=fp["task"], pairs=arrays.get("pairs"), beta=fp["beta"])
        info = LoadInfo(name=name, version=step, n_support_stored=n_stored,
                        n_support_kept=x_perm.shape[0], fingerprint=fp)
        return model, info
