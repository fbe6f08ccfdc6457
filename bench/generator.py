"""Synthetic federations at a Table-2 dataset's published shape, made on
the device from a seed.

The law is the one of ``make_federation`` in
``src/repro_torch/data/synthetic.py`` (lines 112-156 when it was copied):
clustered true weights (``clusters`` centres, ``cluster_spread`` around
them), a per-task feature mean shift (``feature_shift``), features
N(0, 1) / sqrt(d) about that mean, labels ``sign(x . w_t + 1e-12)`` with a
``label_noise`` share flipped, and each task's points split
``train_frac`` : rest into a training and a held-out split, padded on the
right with mask 0.

Two departures, both so that the benchmark's work does not depend on the
seed and its data is made where it is used:

  * the draws come from a ``torch.Generator`` on the run's device, in a
    few large calls, not from numpy on the host;
  * the task sizes are one fixed set, spread evenly over
    [n_min, n_max] (both ends included), dealt to the tasks in an order
    drawn from the seed.  Every seed therefore solves problems of the same
    shapes and step budgets.

Nothing here imports the program: the harness hands the same tensors to
the program, and the reference makes them again from the same seed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Split(NamedTuple):
    """Stacked shuffles of one split: X (S, m, n, d), y and mask (S, m, n),
    real points packed to the left of the n axis."""

    X: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor


def task_sizes(cfg: dict) -> np.ndarray:
    """The fixed (m,) set of task sizes every seed deals out."""
    return np.rint(np.linspace(cfg["n_min"], cfg["n_max"], cfg["m"])
                   ).astype(np.int64)


def split_sizes(cfg: dict):
    """(train, test) sizes of the fixed set, as ``make_federation`` splits
    a task of n points: ``max(int(n * train_frac), 1)`` for training, the
    rest (at least 1) held out."""
    n = task_sizes(cfg)
    n_train = np.maximum((n * cfg["train_frac"]).astype(np.int64), 1)
    return n_train, np.maximum(n - n_train, 1)


def make_shuffles(cfg: dict, shuffles: int, seed: int, device):
    """(train, test) ``Split``s of ``shuffles`` federations of the
    configuration ``cfg`` (a dict of the configuration file), drawn from
    ``seed`` on ``device``."""
    S, m, d = int(shuffles), int(cfg["m"]), int(cfg["d"])
    C = int(cfg["clusters"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    scale = 1.0 / float(np.sqrt(d))

    n_train, n_test = (torch.as_tensor(a, device=device)
                       for a in split_sizes(cfg))
    order = torch.argsort(torch.rand((S, m), **f32), dim=1)
    centres = torch.randn((S, C, d), **f32) * scale
    assign = torch.randint(0, C, (S, m), device=device, generator=g)
    w_true = (torch.gather(centres, 1, assign[..., None].expand(S, m, d))
              + cfg["cluster_spread"] * torch.randn((S, m, d), **f32) * scale)
    mu = cfg["feature_shift"] * torch.randn((S, m, d), **f32) * scale

    def split(sizes: torch.Tensor) -> Split:
        counts = sizes[order]                                 # (S, m)
        npad = int(sizes.max())
        X = mu[:, :, None, :] + torch.randn((S, m, npad, d), **f32) * scale
        mask = (torch.arange(npad, device=device) < counts[..., None]
                ).to(torch.float32)
        # the margin as an elementwise product and sum: no matmul, so no
        # TF32 setting can change the labels
        margin = torch.sum(X * w_true[:, :, None, :], dim=-1)
        y = torch.sign(margin + 1e-12)
        flip = torch.rand((S, m, npad), **f32) < cfg["label_noise"]
        y = torch.where(flip, -y, y)
        return Split(X=X * mask[..., None], y=y * mask, mask=mask)

    return split(n_train), split(n_test)
