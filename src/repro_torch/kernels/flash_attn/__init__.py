"""Flash attention (B6): the CUDA kernels (``csrc/flash_attn_sm90.cu`` for
bf16, ``csrc/flash_attn.cu`` for float32), their plain PyTorch version and
the naive full-softmax oracle."""
