"""Training of the port: ``losses`` (next-token cross-entropy),
``optimizer`` (AdamW with f32 masters, SGD, clipping, schedules), ``loop``
(``make_train_step`` and friends over the model's own parameters) and
``checkpoint`` (trees of arrays in one numpy archive)."""
