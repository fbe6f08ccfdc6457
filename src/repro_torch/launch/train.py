"""Training launcher: AdamW steps of an architecture on the token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --local --device cpu --steps 5 --seq 32 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --seq 512 --batch 4 --ckpt ckpt/smollm
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --dry-run [--multi-pod] [--shape train_4k] --device cpu

``--arch`` is any of ``configs.archs.ALL_ARCHS``.  Runs on the card
unless ``--device cpu``, in float32; weights are random from seed 0 and
batches come from ``data.tokens.TokenStream`` (the family's layout: audio
codebook frames, vlm text after image embeddings).  ``--ckpt``
saves the trained parameters through ``train.checkpoint``.
``--dry-run`` writes the plan of ``--shape`` on the production mesh
(``--multi-pod``: two pods) through ``launch.dryrun.run_case``, held
against the card's memory unless ``--device cpu``.  This launcher
trains on one device.  The step on a mesh, ``launch.specs.build_case``'s
``fn`` for every family, runs as one SPMD program under
``torch.distributed.run`` in ``repro_torch.examples.sharded_lm`` (four
NCCL ranks on four cards, or four gloo ranks on the CPU).
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
    ap.add_argument("--dry-run", action="store_true",
                    help="write the plan of --shape on the production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the dry-run's two-pod mesh")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--out", default=None,
                    help="the dry-run's record directory")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.launch.dryrun import RESULTS_DIR, run_case
        rec = run_case(args.arch, args.shape, args.multi_pod,
                       args.out or RESULTS_DIR, force=True,
                       device=args.device)
        raise SystemExit(0 if rec["status"] == "ok" else 1)
    if args.multi_pod:
        ap.error("--multi-pod goes with --dry-run")

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
