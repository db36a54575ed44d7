"""GLOBALRNG: every draw on a generator the caller seeded."""
import torch


def init(shape, x, seed):
    gen = torch.Generator().manual_seed(seed)
    kw = dict(generator=gen, dtype=torch.float32)
    a = torch.randn(shape, generator=gen)
    b = torch.rand(shape, **kw)
    c = torch.randint(0, 5, shape, generator=gen)
    x.uniform_(generator=gen)
    return a, b, c, torch.randn_like(x)
