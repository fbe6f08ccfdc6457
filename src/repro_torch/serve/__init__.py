"""LM serving of the port (the JAX package's ``serve/engine.py``)."""
from repro_torch.serve.engine import Engine, ServeConfig, sample_logits

__all__ = ["Engine", "ServeConfig", "sample_logits"]
