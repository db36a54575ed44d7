"""Cost arithmetic of the port on one NVIDIA H100 (counterpart of
``repro.analysis``): the roofline terms and the card's published peaks.
The JAX package's HLO cost analyzer (``hlo_cost``) has no counterpart yet
(ROADMAP.md §A)."""
from repro_torch.analysis.roofline import (H100, model_flops_decode,
                                           model_flops_train, roofline_terms)
