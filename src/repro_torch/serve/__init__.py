"""Serving tier: the model registry (persistent, versioned, fingerprinted)."""

from repro_torch.serve.registry import (FORMAT_VERSION, LoadInfo, ModelRegistry,
                                        RegistryError, model_fingerprint)

__all__ = ["FORMAT_VERSION", "LoadInfo", "ModelRegistry", "RegistryError",
           "model_fingerprint"]
