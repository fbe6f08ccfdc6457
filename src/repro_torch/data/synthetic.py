"""Synthetic federated datasets calibrated to the paper's Table 2 / Table 3.

The three real federations (Human Activity, Google Glass, Vehicle Sensor)
are replaced by generators at their published shapes that keep the
phenomena the paper's claims rest on: non-IID tasks (per-task feature
means), latent cluster structure in the true weights, unbalanced n_t (and
Table-3 "skewed" variants spanning two orders of magnitude), label noise.

The generator is numpy and consumes exactly the draws of the JAX package's
``repro.data.synthetic``, so the same seed gives the same arrays bit for
bit; only the returned container holds torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dual import FederatedData
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FederationSpec:
    name: str
    m: int                 # tasks / nodes
    d: int                 # features
    n_min: int
    n_max: int
    clusters: int = 3
    cluster_spread: float = 0.35   # ||w_t - w_cluster|| relative scale
    feature_shift: float = 0.5     # per-task mean shift (non-IID-ness)
    label_noise: float = 0.05
    skewed: bool = False           # Table-3 style two-orders-of-magnitude sizes
    #: per-task conditioning heterogeneity (anisotropic features on some
    #: nodes: statistical stragglers); 0 = homogeneous
    difficulty_spread: float = 0.0


HUMAN_ACTIVITY = FederationSpec("human_activity", m=30, d=561, n_min=210,
                                n_max=306)
GOOGLE_GLASS = FederationSpec("google_glass", m=38, d=180, n_min=524,
                              n_max=581)
VEHICLE_SENSOR = FederationSpec("vehicle_sensor", m=23, d=100, n_min=872,
                                n_max=1933)

HA_SKEW = dataclasses.replace(HUMAN_ACTIVITY, name="ha_skew", n_min=3,
                              skewed=True)
GG_SKEW = dataclasses.replace(GOOGLE_GLASS, name="gg_skew", n_min=6,
                              skewed=True)
VS_SKEW = dataclasses.replace(VEHICLE_SENSOR, name="vs_skew", n_min=19,
                              skewed=True)

SPECS = {s.name: s for s in (
    HUMAN_ACTIVITY, GOOGLE_GLASS, VEHICLE_SENSOR, HA_SKEW, GG_SKEW, VS_SKEW)}


def _sizes(rng: np.random.Generator, spec: FederationSpec) -> np.ndarray:
    # one batched draw: the federation's RNG stream is pinned to it
    if spec.skewed:
        lo, hi = np.log(spec.n_min), np.log(spec.n_max)
        return np.exp(rng.uniform(lo, hi, spec.m)).astype(int)
    return rng.integers(spec.n_min, spec.n_max + 1, spec.m)


def _client_block(rng: np.random.Generator, spec: FederationSpec,
                  w_true: np.ndarray, mu: np.ndarray, feat_scale: np.ndarray,
                  n: int) -> Tuple[np.ndarray, np.ndarray]:
    """One client's (X, y) block from its latent parameters."""
    xt = mu + (rng.normal(0.0, 1.0, (n, spec.d)) * feat_scale) / np.sqrt(
        spec.d)
    margin = xt @ w_true
    yt = np.sign(margin + 1e-12)
    flip = rng.random(n) < spec.label_noise
    yt[flip] = -yt[flip]
    return xt, yt


def make_federation(spec: FederationSpec, seed: int = 0,
                    train_frac: float = 0.75,
                    device: Optional[str] = None,
                    ) -> Tuple[FederatedData, FederatedData]:
    """Generate (train, test) FederatedData for the spec on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sizes = _sizes(rng, spec)

    centers = rng.normal(0.0, 1.0, (spec.clusters, spec.d)) / np.sqrt(spec.d)
    assign = rng.integers(0, spec.clusters, spec.m)
    W_true = centers[assign] + spec.cluster_spread * rng.normal(
        0.0, 1.0, (spec.m, spec.d)) / np.sqrt(spec.d)

    mu = spec.feature_shift * rng.normal(0.0, 1.0, (spec.m, spec.d)) / np.sqrt(
        spec.d)

    if spec.difficulty_spread > 0:
        cond = spec.difficulty_spread * np.abs(rng.normal(0.0, 1.0, spec.m))
        feat_scale = np.exp(cond[:, None] * rng.normal(
            0.0, 1.0, (spec.m, spec.d)))
    else:
        feat_scale = np.ones((spec.m, spec.d))

    def build(split_sizes):
        npad = int(max(split_sizes.max(), 1))
        X = np.zeros((spec.m, npad, spec.d), np.float32)
        y = np.zeros((spec.m, npad), np.float32)
        mask = np.zeros((spec.m, npad), np.float32)
        for t in range(spec.m):
            n = int(split_sizes[t])
            if n == 0:
                continue
            xt, yt = _client_block(rng, spec, W_true[t], mu[t],
                                   feat_scale[t], n)
            X[t, :n] = xt
            y[t, :n] = yt
            mask[t, :n] = 1.0
        return FederatedData(X=torch.from_numpy(X).to(dev),
                             y=torch.from_numpy(y).to(dev),
                             mask=torch.from_numpy(mask).to(dev))

    n_train = np.maximum((sizes * train_frac).astype(int), 1)
    n_test = np.maximum(sizes - n_train, 1)
    return build(n_train), build(n_test)


def tiny_problem(m: int = 4, n: int = 24, d: int = 6, seed: int = 0,
                 clusters: int = 2, device: Optional[str] = None,
                 ) -> Tuple[FederatedData, FederatedData]:
    """Small deterministic problem for unit tests."""
    spec = FederationSpec("tiny", m=m, d=d, n_min=n, n_max=n,
                          clusters=clusters, label_noise=0.0)
    return make_federation(spec, seed=seed, device=device)
