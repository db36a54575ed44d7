"""Flash attention (B6): the CUDA kernel (``csrc/flash_attn.cu``), its plain
PyTorch version and the naive full-softmax oracle."""
