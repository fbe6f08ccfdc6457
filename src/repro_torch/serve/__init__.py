"""repro_torch.serve: LM serving and the online prediction tier of MOCHA.

  * :mod:`repro_torch.serve.engine`  -- LM serving (``Engine.generate``,
    the JAX package's ``serve/engine.py``);
  * :mod:`repro_torch.serve.store`   -- immutable versioned
    ``ServedSnapshot``, the one served-weight resolution rule, and the
    atomically swapped ``SnapshotStore``;
  * :mod:`repro_torch.serve.predict` -- the batched ``Predictor`` on the
    card;
  * :mod:`repro_torch.serve.refresh` -- ``ServeSession``: continual cohort
    training in the background, a snapshot published every N folds.

Training state enters the prediction tier only as a ``ServedSnapshot``;
serve code draws no random numbers and writes no ``SystemsTrace``.
"""
from repro_torch.serve.engine import Engine, ServeConfig, sample_logits
from repro_torch.serve.predict import Predictor
from repro_torch.serve.refresh import ServeSession
from repro_torch.serve.store import (ServedSnapshot, SnapshotStore,
                                     resolve_weights)

__all__ = ["Engine", "ServeConfig", "sample_logits", "Predictor",
           "ServeSession", "ServedSnapshot", "SnapshotStore",
           "resolve_weights"]
