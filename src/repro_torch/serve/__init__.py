"""Serving tier: model registry + batched-tick scoring engine.

``ModelRegistry`` persists trained ``EngineModel``s as versioned,
fingerprinted artifacts; ``ServingEngine`` holds many loaded models behind
a shared-factorization LRU cache and scores queued requests in dynamically
batched ticks (one CUDA graph per bucket on the card).  See the module
docstrings for the design.
"""
from repro_torch.serve.engine import (BatchPolicy, ServingEngine, Ticket, batched_scores,
                                      decode_predictions, group_key)
from repro_torch.serve.registry import (FORMAT_VERSION, LoadInfo, ModelRegistry,
                                        RegistryError, model_fingerprint)

__all__ = [
    "BatchPolicy",
    "ServingEngine",
    "Ticket",
    "batched_scores",
    "decode_predictions",
    "group_key",
    "FORMAT_VERSION",
    "LoadInfo",
    "ModelRegistry",
    "RegistryError",
    "model_fingerprint",
]
