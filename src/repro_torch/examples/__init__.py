"""Examples of the port, run as modules: ``python -m
repro_torch.examples.<name> [--device cpu]`` (``personalize``,
``serve_cohort``, ``train_lm``).  Each runs on the card unless
``--device cpu``."""
