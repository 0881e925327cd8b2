"""Training plane of the port: optimizers, the train step, checkpoints."""
