"""TF32: four ways to turn it on, and a Triton dot in TF32: 5 findings."""
import torch
import triton.language as tl

torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
torch.set_float32_matmul_precision("high")


def kernel(a, b):
    acc = tl.dot(a, b)
    return acc + tl.dot(a, b, input_precision="tf32")
