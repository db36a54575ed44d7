"""Whole-network fused training: the CUDA kernel (``csrc/fused_train.cu``)
for one step (B1), K SGD steps (B2) and K Adam steps (B3), its plain
PyTorch version and the autograd oracle."""
