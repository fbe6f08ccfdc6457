"""End-to-end LM training on the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --steps 20 --seq 64                      # reduced, seconds
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full \
        --steps 300 --seq 512 --batch 8           # SmolLM-360M on the card

Defaults to the reduced config; ``--full`` trains the architecture at its
published widths.  Runs on the card unless ``--device cpu``; the
checkpoint goes to ``--ckpt`` (none unless given).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: reduced)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, TokenStream
    from repro_torch.models import build_model
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)
    from repro_torch.utils.timing import tick

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device, seed=0)
    tc = TrainConfig(lr=3e-4)
    params, opt_state = init_train_state(model, tc)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M on {model.device}")

    step_fn = make_train_step(model, tc)
    stream = TokenStream(cfg, DataConfig(seq_len=args.seq,
                                         batch_size=args.batch))
    t0 = tick()
    for step, batch in enumerate(stream.batches(args.steps)):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss={float(metrics['loss']):.4f}  "
                  f"ce={float(metrics['ce']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"{tick() - t0:.1f}s")
    if args.ckpt:
        from repro_torch.train.checkpoint import save
        print(f"checkpoint -> {save(args.ckpt, args.steps, params)}")


if __name__ == "__main__":
    main()
