"""Fault tolerance of the training loop: checkpoints, the runner, the straggler watchdog."""
