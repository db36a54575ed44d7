"""Optimizers of the port (``optim/grad_compression.py`` arrives with a later
LM slice)."""
from repro_torch.optim.optimizers import (AdamState, Optimizer, SgdState,
                                          adam, clip_by_global_norm,
                                          global_norm, sgd)
