"""Architecture configs (one file per arch, copies of repro.configs) + registry."""

from repro_torch.configs.registry import ARCH_IDS, get_config, list_archs

__all__ = ["ARCH_IDS", "get_config", "list_archs"]
