"""Optimizers and gradient compression of the port."""
from repro_torch.optim.grad_compression import error_feedback_compress
from repro_torch.optim.optimizers import (AdamState, Optimizer, SgdState,
                                          adam, clip_by_global_norm,
                                          global_norm, sgd)
