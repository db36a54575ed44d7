"""HOSTSYNC: what a hot-loop module may do (linted as
``src/repro_torch/ft/runner.py``): casts of Python numbers, and the
sanctioned sync point ``_chunked_loop.retire``."""
import torch


def decode_step(logits, rows):
    n = int(logits.shape[0])
    k = float(len(rows))
    lo = float("-inf")
    m = int(logits.size(1) * 2)
    w = bool(logits.dim() if n else logits.ndim)
    return torch.argmax(logits, -1), n, k, lo, m, w


def _chunked_loop(chunk):
    def retire(metrics):
        return metrics.cpu()
    return retire(chunk)
