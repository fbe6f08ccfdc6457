"""Pack a sampled cohort into the padded ``FederatedData`` layout.

Everything below the sampler is unchanged: a packed cohort is an ordinary
m=K federation on the run's device, so ``_run_mocha`` and both round
engines execute it as they execute a silo federation.  Layout, as in the
JAX package's ``repro.cohort.packing``:

  * left-packed point axis with a fixed width (``PopulationSpec.pad_width``
    by default), so every block of a run has one set of shapes (and, on the
    card, one captured round program);
  * ``xnorm2`` filled at pack time through ``dual.with_xnorm2``, the same
    row-norm table every engine reads.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.cohort.population import Population
from repro_torch.core.dual import FederatedData, with_xnorm2
from repro_torch.core.mocha import CAPTURE_LOCK
from repro_torch.utils.device import resolve_device


def _copy_to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A tensor on ``dev`` that shares no memory with ``a``, made by a
    blocking copy: once it returns, ``a`` may be overwritten."""
    t = torch.from_numpy(a)
    return t.clone() if dev.type == "cpu" else t.to(dev, non_blocking=False)


class CohortPacker:
    """Reusable cohort packer: layout resolved once, host buffers reused.

    The (K, n_pad, d) staging buffers live on the host and are overwritten
    by every ``pack``.  Reuse is safe because ``pack`` copies them to the
    device with a BLOCKING copy: when it returns, no copy from them is
    pending, so the next ``pack`` may overwrite them (the JAX package waits
    on its copies with ``block_until_ready`` for the same reason).  The
    device work of a pack (the copies and the row norms) runs under
    ``mocha.CAPTURE_LOCK``, so it never overlaps a round program's CUDA
    graph capture on the solve thread.

    ``pack`` also returns the cohort's true sizes, from the cheap
    population metadata stream, so the driver needs no device read for
    them.

    NOT thread-safe across concurrent ``pack`` calls (the overlapped driver
    packs on a single worker): the staging buffers are ``# owner: pack``.
    ``pack`` is retry-idempotent: every staging buffer is fully overwritten
    on each call, so the resilience layer may re-run it for the same block
    and get the same federation bit for bit.
    """

    def __init__(self, pop: Population, cohort: int,
                 n_pad: Optional[int] = None,
                 device: Union[str, torch.device, None] = None):
        self.pop = pop
        self.n_pad = int(n_pad or pop.spec.pad_width)
        self.cohort = int(cohort)
        self.device = resolve_device(device)
        d = pop.spec.d
        self._X = np.zeros((self.cohort, self.n_pad, d), np.float32)  # owner: pack
        self._y = np.zeros((self.cohort, self.n_pad), np.float32)  # owner: pack
        self._mask = np.zeros((self.cohort, self.n_pad), np.float32)  # owner: pack

    def pack(self, ids: Sequence[int]) -> Tuple[FederatedData, np.ndarray]:  # worker: pack
        """(m=K federation on the device, (K,) int64 true sizes) for
        cohort ``ids``."""
        if len(ids) != self.cohort:
            raise ValueError(
                f"cohort of {len(ids)} clients in a {self.cohort}-slot "
                "packer (cohort shapes are static per run)")
        X, y, mask = self._X, self._y, self._mask
        X[:] = 0.0
        y[:] = 0.0
        mask[:] = 0.0
        sizes = np.empty(self.cohort, np.int64)
        for slot, t in enumerate(ids):
            block = self.pop.client_block(int(t))
            if block.n > self.n_pad:
                raise ValueError(
                    f"client {int(t)} has n_t={block.n} > n_pad="
                    f"{self.n_pad}; raise PopulationSpec.n_pad (cohort "
                    "shapes are static per run)")
            X[slot, :block.n] = block.X
            y[slot, :block.n] = block.y
            mask[slot, :block.n] = 1.0
            sizes[slot] = block.n
        dev = self.device
        with CAPTURE_LOCK:
            data = with_xnorm2(FederatedData(
                X=_copy_to(X, dev), y=_copy_to(y, dev),
                mask=_copy_to(mask, dev)))
        return data, sizes


def pack_cohort(pop: Population, ids: Sequence[int],
                n_pad: Optional[int] = None,
                device: Union[str, torch.device, None] = None
                ) -> FederatedData:
    """Materialize clients ``ids`` and pack them as an m=K federation on
    ``device`` (the card by default).  Memory is O(K * n_pad * d); slot
    order follows ``ids``."""
    data, _ = CohortPacker(pop, len(ids), n_pad, device).pack(ids)
    return data
