"""FALLBACK: a kernel's failure raises, with context; other errors may be
handled."""
import json

from repro_torch.kernels.qat_dense.kernel import qat_dense_call


def raised(x, w):
    try:
        return qat_dense_call(x, w)
    except RuntimeError as e:
        raise RuntimeError(f"B5 failed on {tuple(x.shape)}") from e


def parsed(text):
    try:
        return json.loads(text)
    except ValueError:
        return None
