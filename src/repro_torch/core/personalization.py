"""MOCHA as a per-task head over a language-model backbone.

The port's copy of the JAX package's ``repro.core.personalization``.  The
paper scopes MOCHA to convex models (section 6); the bridge to the model
zoo is the one the paper suggests (kernelized / convexified models): freeze
the backbone as a feature map, mean-pool its final hidden states, and run
federated multi-task learning -- per-node convex heads w_t plus a learned
task-relationship matrix Omega -- over those features.

    bridge = PersonalizationBridge(model, reg, cfg)
    fed = bridge.build_federation(per_task_batches, labels)
    result = bridge.fit(fed)              # full MOCHA (stragglers and all)
    margins = bridge.predict(batch, result.W[t])

The port's ``Model`` holds its weights, so the methods take no ``params``
argument.  Everything runs on the model's device (the card unless the
model was built elsewhere): the backbone through the flash attention
kernel, MOCHA on ``self.mocha``'s engine (the default ``smooth_hinge``
runs the local engine; ``loss="hinge", engine="kernel"`` the SDCA kernel).
Dense attention families only (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.dual import FederatedData
from repro_torch.core.mocha import MochaConfig, RunResult, _run_mocha
from repro_torch.core.regularizers import Regularizer
from repro_torch.models.transformer import Model

Tensor = torch.Tensor


@dataclasses.dataclass
class PersonalizationBridge:
    model: Model
    regularizer: Regularizer
    mocha: MochaConfig = dataclasses.field(
        default_factory=lambda: MochaConfig(loss="smooth_hinge", rounds=60))
    normalize: bool = True

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _on(self, x) -> Tensor:
        """A tensor or array on the model's device."""
        return (x if torch.is_tensor(x)
                else torch.from_numpy(np.asarray(x))).to(self.device)

    @torch.no_grad()
    def features(self, batch: Dict[str, object]) -> Tensor:
        """Mean-pooled final hidden states, (B, d_model) float32, L2
        normalised (eps 1e-6) unless ``normalize`` is False."""
        h = self.model.features({k: self._on(v) for k, v in batch.items()})
        feats = h.float().mean(dim=1)
        if self.normalize:
            feats = feats / torch.linalg.vector_norm(
                feats, dim=-1, keepdim=True).clamp_min(1e-6)
        return feats

    def build_federation(self, task_batches: Sequence[Dict[str, object]],
                         task_labels: Sequence[object]) -> FederatedData:
        """One entry per task/node: a batch dict and its binary labels
        (+-1), left-packed and masked, on the model's device."""
        feats = [self.features(b) for b in task_batches]
        m, d = len(feats), feats[0].shape[1]
        n_max = max(f.shape[0] for f in feats)
        X = torch.zeros((m, n_max, d), device=self.device)
        y = torch.zeros((m, n_max), device=self.device)
        mask = torch.zeros((m, n_max), device=self.device)
        for t, (f, lab) in enumerate(zip(feats, task_labels)):
            n = f.shape[0]
            X[t, :n] = f
            y[t, :n] = self._on(lab).float()
            mask[t, :n] = 1.0
        return FederatedData(X=X, y=y, mask=mask)

    def fit(self, fed: FederatedData,
            omega0: Optional[Tensor] = None) -> RunResult:
        """MOCHA over the federation, on the federation's device unless
        ``self.mocha.device`` names one."""
        cfg = self.mocha
        if cfg.device is None:
            cfg = dataclasses.replace(cfg, device=str(fed.device))
        return _run_mocha(fed, self.regularizer, cfg, omega0=omega0)

    def predict(self, batch: Dict[str, object], w_t) -> Tensor:
        """Per-task margins for new examples of task t."""
        return self.features(batch) @ self._on(w_t).float()
