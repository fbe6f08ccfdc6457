"""Architecture configs of the port (a copy of the JAX package's)."""
from repro_torch.configs.base import (ArchConfig, get_config, list_configs,
                                      register)
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape

__all__ = ["ArchConfig", "get_config", "list_configs", "register", "SHAPES",
           "InputShape", "get_shape"]
