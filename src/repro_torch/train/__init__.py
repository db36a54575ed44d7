"""The training step and the training engine."""
