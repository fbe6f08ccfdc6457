"""repro_torch: MOCHA (Federated Multi-Task Learning) in PyTorch and CUDA.

The PyTorch port of the JAX package ``repro``.  Its layout mirrors
``repro``; the per-task SDCA local solve runs through a CUDA kernel written
for Hopper (``repro_torch.kernels.sdca``).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; a missing card is an error.

    from repro_torch.api import Experiment, Problem, Method, Exec
    from repro_torch.data.synthetic import VEHICLE_SENSOR, make_federation

    train, test = make_federation(VEHICLE_SENSOR, seed=0)
    report = Experiment(problem=Problem(train=train),
                        exec=Exec(engine="kernel")).run(seed=0)

This package imports ``torch`` and numpy only, never ``jax`` or ``repro``.
"""
