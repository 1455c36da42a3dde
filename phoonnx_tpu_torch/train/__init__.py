"""Training pipeline: losses, the G+D train step, data, checkpoints, trainer."""
