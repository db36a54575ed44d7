"""HOSTSYNC: every host sync a hot-loop module may not make (linted as
``src/repro_torch/serve/decode.py``): 11 findings."""
import numpy as np
import torch


def decode_step(logits, event, stream):
    a = logits.argmax(-1).item()
    b = logits.tolist()
    c = logits.cpu()
    d = logits.numpy()
    e = np.asarray(logits)
    torch.cuda.synchronize()
    event.synchronize()
    stream.synchronize()
    f = float(logits.sum())
    g = int(logits.max())
    h = bool(logits.any())
    return a, b, c, d, e, f, g, h
