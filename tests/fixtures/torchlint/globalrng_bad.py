"""GLOBALRNG: draws on the process-global RNG (linted as a module of the
port): 9 findings."""
import torch


def init(shape, x):
    torch.manual_seed(0)
    torch.cuda.manual_seed_all(0)
    a = torch.randn(shape)
    b = torch.rand(shape)
    c = torch.randint(0, 5, shape)
    d = torch.randperm(8)
    e = torch.bernoulli(x)
    x.uniform_()
    x.normal_(0.0, 1.0)
    return a, b, c, d, e
