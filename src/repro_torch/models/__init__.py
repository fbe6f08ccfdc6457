"""Dense attention decoder of the port (the JAX package's ``models``)."""
from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "build_model"]
