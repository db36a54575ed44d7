"""Int8 QAT dense kernels: the per-layer CUDA GEMM, the fused whole-network
CUDA forward, the plain PyTorch paths — all bit-exact against
``repro_torch.core.qat.int_forward``."""
