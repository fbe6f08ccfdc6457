"""Serving launcher: batched generate on a selected architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --local --device cpu

``--arch`` is any of ``configs.archs.ALL_ARCHS``.  Runs on the card unless
``--device cpu``, in float32 (the engine's default); weights and prompts
are random from seed 0 (audio: codebook frames; vlm: text after
``frontend_tokens`` random image embeddings).  The JAX launcher's
``--dry-run`` (an XLA compile of the production mesh) has no counterpart
here.
"""
import argparse

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--local", action="store_true",
                    help="the reduced (smoke-test) variant of the arch")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--dry-run", action="store_true",
                    help="not ported: the JAX launcher's XLA compile of the "
                         "production mesh has no counterpart here")
    args = ap.parse_args(argv)
    if args.dry_run:
        ap.error("--dry-run is XLA's own and is not ported")

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device, seed=0)
    prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    engine = Engine(model, ServeConfig(
        max_len=prefix + args.prompt_len + args.new_tokens + 8,
        temperature=0.0))
    rng = np.random.default_rng(0)
    shape = (args.batch, args.prompt_len)
    if cfg.family == "audio":
        shape += (cfg.n_codebooks,)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape)).to(model.device)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (args.batch, prefix, cfg.d_model)).astype(np.float32)).to(
                model.device)
    out = engine.generate(batch, n_new=args.new_tokens)
    print("generated:", out.shape)
    print(out[0].tolist())


if __name__ == "__main__":
    main()
