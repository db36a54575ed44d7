"""FALLBACK: a kernel that fails must raise: 4 findings."""
from repro_torch.kernels import build
from repro_torch.kernels.qat_dense import ref
from repro_torch.kernels.qat_dense.kernel import qat_dense_call


def to_the_plain_version(x, w):
    try:
        return qat_dense_call(x, w)
    except RuntimeError:
        return ref.qat_dense(x, w)


def swallowed(x, w):
    try:
        return qat_dense_call(x, w)
    except Exception:
        return None


def build_failure_ignored(name):
    try:
        build.load(name)
    except OSError:
        pass


def local_plain(x, fused_call, forward_plain):
    try:
        return fused_call(x)
    except RuntimeError:
        return forward_plain(x)
