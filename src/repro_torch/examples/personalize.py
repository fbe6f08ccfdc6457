"""Federated personalization: MOCHA per-task heads over a frozen backbone.

Each of m simulated user devices has a small labeled dataset of token
sequences; the backbone embeds them (mean-pooled final hidden states,
through the flash attention kernel on the card), and MOCHA learns coupled
per-user classifiers and the task-relationship matrix Omega.

    PYTHONPATH=src python -m repro_torch.examples.personalize [--device cpu]
"""
import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--tasks", type=int, default=6)
    ap.add_argument("--per-task", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core import BudgetConfig, MochaConfig, Probabilistic
    from repro_torch.core.personalization import PersonalizationBridge
    from repro_torch.models import build_model

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=args.device, seed=0)
    rng = np.random.default_rng(0)

    # synthetic per-user data: each user prefers one of two token "topics";
    # labels flag whether a sequence matches the user's topic
    def make_task(t):
        n, s = args.per_task, 32
        labels = np.where(rng.random(n) < 0.5, 1.0, -1.0)
        lo, hi = (0, cfg.vocab_size // 2) if t % 2 == 0 else (
            cfg.vocab_size // 2, cfg.vocab_size)
        toks = np.zeros((n, s), np.int32)
        for i in range(n):
            toks[i] = (rng.integers(lo, hi, s) if labels[i] > 0
                       else rng.integers(0, cfg.vocab_size, s))
        return {"tokens": toks}, labels

    batches, labels = zip(*[make_task(t) for t in range(args.tasks)])
    bridge = PersonalizationBridge(
        model, Probabilistic(lam=1e-3, sigma2=10.0),
        MochaConfig(loss="smooth_hinge", rounds=60, omega_update_every=15,
                    budget=BudgetConfig(passes=2.0, drop_prob=0.1),
                    record_every=59))
    fed = bridge.build_federation(batches, labels)
    result = bridge.fit(fed)
    print(f"arch={cfg.name} on {fed.device}: {args.tasks} users "
          f"personalized, gap={result.final('gap'):.4f}")
    for t in range(args.tasks):
        margin = bridge.predict(batches[t], result.W[t])
        acc = float((torch.sign(margin).cpu().numpy() == labels[t]).mean())
        print(f"  user {t}: train acc {acc:.2f}")
    print("Omega (learned task coupling, rounded):")
    print(np.round(np.asarray(result.omega), 2))


if __name__ == "__main__":
    main()
