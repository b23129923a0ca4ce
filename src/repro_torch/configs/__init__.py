from repro_torch.configs.base import ArchConfig, get_arch, register

__all__ = ["ArchConfig", "get_arch", "register"]
