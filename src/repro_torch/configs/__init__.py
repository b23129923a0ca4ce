from repro_torch.configs.base import ArchConfig, get_arch, list_archs, register

__all__ = ["ArchConfig", "get_arch", "list_archs", "register"]
