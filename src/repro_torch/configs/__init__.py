"""Architecture configs of the port (a copy of the JAX package's)."""
from repro_torch.configs.base import (ArchConfig, get_config, list_configs,
                                      register)

__all__ = ["ArchConfig", "get_config", "list_configs", "register"]
