"""Language-model training losses: next-token cross-entropy (+ auxiliaries).

The port's copy of the JAX package's ``repro.train.losses`` for the dense
family.  CE is computed as logsumexp(logits) minus the label's logit, as
there (the JAX package chose that form over log_softmax + a gather so that
vocab-sharded logits stay sharded); the label's logit is read with a
gather here, which gives the one-hot product's value exactly.  The audio
and vlm families raise until their models are ported (ROADMAP.md Queue 1
item 14d).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig

Tensor = torch.Tensor

_FAMILIES_LATER = "ROADMAP.md Queue 1 item 14d (vlm/audio)"


def _ce(logits: Tensor, labels: Tensor) -> Tensor:
    """logits: (..., V) (any dtype), labels: (...) int.  Mean CE, float32."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - label_logit.float())


def next_token_loss(cfg: ArchConfig, logits: Tensor,
                    batch: Dict[str, Tensor], aux: Dict[str, Tensor]
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Shifted cross-entropy: logits (B, S, V), labels the tokens shifted
    left.  ``aux`` terms land in the metrics; ``moe_lb`` and ``moe_z`` are
    added to the total.  Returns (total, metrics with ``ce`` and
    ``loss``)."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} loss is not in the port yet "
            f"({_FAMILIES_LATER})")
    tokens = torch.as_tensor(batch["tokens"], device=logits.device)
    ce = _ce(logits[:, :-1], tokens[:, 1:])
    metrics = {"ce": ce}
    total = ce
    for k, v in aux.items():
        metrics[k] = v
        if k in ("moe_lb", "moe_z"):
            total = total + v
    metrics["loss"] = total
    return total, metrics
