"""TF32: off, and Triton's fp32 dot in IEEE fp32."""
import torch
import triton.language as tl

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def kernel(a, b):
    return tl.dot(a, b, input_precision="ieee")
