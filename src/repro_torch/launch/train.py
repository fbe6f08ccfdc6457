"""Training launcher: AdamW steps of an architecture on the token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --local --device cpu --steps 5 --seq 32 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --seq 512 --batch 4 --ckpt ckpt/smollm

Runs on the card unless ``--device cpu``, in float32; weights are random
from seed 0 and batches come from ``data.tokens.TokenStream``.  ``--ckpt``
saves the trained parameters through ``train.checkpoint``.  The JAX
launcher's ``--dry-run`` and ``--multi-pod`` (XLA compiles of the
production mesh) have no counterpart here (ROADMAP.md Queue 1 item 15).
"""
import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--local", action="store_true",
                    help="the reduced (smoke-test) variant of the arch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default="")
    for flag in ("--dry-run", "--multi-pod"):
        ap.add_argument(flag, action="store_true",
                        help="not ported: XLA's own (ROADMAP.md Queue 1 "
                             "item 15)")
    args = ap.parse_args(argv)
    if args.dry_run or args.multi_pod:
        ap.error("--dry-run and --multi-pod are XLA's own and are not "
                 "ported (ROADMAP.md Queue 1 item 15)")

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, TokenStream
    from repro_torch.models import build_model
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)

    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device, seed=0)
    tc = TrainConfig()
    params, opt_state = init_train_state(model, tc)
    step = make_train_step(model, tc)
    stream = TokenStream(cfg, DataConfig(seq_len=args.seq,
                                         batch_size=args.batch))
    for i, batch in enumerate(stream.batches(args.steps)):
        params, opt_state, metrics = step(params, opt_state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f}")
    if args.ckpt:
        from repro_torch.train.checkpoint import save
        print("saved:", save(args.ckpt, args.steps, params))


if __name__ == "__main__":
    main()
