"""LM substrate of the port: the ``ssm`` and ``hybrid`` families' serving path."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model

__all__ = ["ModelConfig", "Model"]
