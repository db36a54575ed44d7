"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA Hopper card and ``nvcc``; skips elsewhere (the decision is
made inside the fixture, not at import).  Imports nothing of JAX, so it
runs on a machine with PyTorch only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from repro_torch.core import mrf_net, qat
from repro_torch.kernels.qat_dense import fused, kernel, ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _net(hidden, device):
    g = torch.Generator(device=device).manual_seed(0)
    params = mrf_net.init_params(g, mrf_net.layer_sizes(32, hidden))
    qs = qat.init_qat_state(len(params), device=device)
    x = torch.randn((256, 64), generator=g, device=device)
    for _ in range(3):
        _, qs = qat.forward_qat(params, qs, x)
    return ops.prepad_int_layers(qat.export_int8(params, qs))


# the wide net's image (~90 KB) needs the dynamic shared-memory limit raised
@pytest.mark.parametrize("hidden", [mrf_net.ADAPTED_HIDDEN,
                                    mrf_net.ORIGINAL_HIDDEN, (256, 256, 32)])
@pytest.mark.parametrize("m", [1, 129, 1024])
def test_fused_forward_matches_plain(cuda, hidden, m):
    net = _net(hidden, cuda)
    x = torch.randn((m, 64), device=cuda)
    drow = torch.tensor([4000.0, 600.0], device=cuda)
    before = fused.fused_forward_call.launches
    got = fused.fused_forward_call(x, net, drow=drow)
    want = ref.ref_fused_forward(x, net.s_in, net.packed, net.out_dim,
                                 drow=drow)
    torch.cuda.synchronize()
    assert fused.fused_forward_call.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("mkn", [(1024, 64, 64), (130, 200, 300), (1, 4, 4)])
@pytest.mark.parametrize("relu,float_out",
                         [(True, False), (False, False), (False, True)])
def test_qat_dense_matches_plain(cuda, mkn, relu, float_out):
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(sum(mkn))
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-2048, 2048, (n,), generator=g, device=cuda,
                      dtype=torch.int32)
    s = torch.rand((n,), generator=g, device=cuda) * 1e-2 + 1e-4
    before = kernel.qat_dense_call.launches
    got = kernel.qat_dense_call(x, w, b, s, relu=relu, float_out=float_out)
    want = ref.ref_qat_dense(x, w, b, s, relu=relu, float_out=float_out)
    torch.cuda.synchronize()
    assert kernel.qat_dense_call.launches == before + 1
    assert torch.equal(got, want)


def test_empty_outputs_launch_and_count_nothing(cuda):
    net = _net(mrf_net.ADAPTED_HIDDEN, cuda)
    before = (fused.fused_forward_call.launches,
              kernel.qat_dense_call.launches)
    out = fused.fused_forward_call(torch.zeros((0, 64), device=cuda), net)
    assert out.shape == (0, net.out_dim)
    x = torch.zeros((0, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((8, 4), dtype=torch.int8, device=cuda)
    b = torch.zeros((4,), dtype=torch.int32, device=cuda)
    s = torch.ones((4,), device=cuda)
    assert kernel.qat_dense_call(x, w, b, s).shape == (0, 4)
    assert kernel.qat_dense_call(torch.zeros((4, 8), dtype=torch.int8,
                                             device=cuda), w[:, :0], b[:0],
                                 s[:0]).shape == (4, 0)
    assert (fused.fused_forward_call.launches,
            kernel.qat_dense_call.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((8, 4), dtype=torch.int8, device=cuda)
    b = torch.zeros((4,), dtype=torch.int32, device=cuda)
    s = torch.ones((4,), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.qat_dense_call(x.t().contiguous().t(), w.t().contiguous().t()
                              [:, :4], b, s)
    with pytest.raises(ValueError):
        kernel.qat_dense_call(x.float(), w, b, s)
    with pytest.raises(ValueError):
        kernel.qat_dense_call(x, w, b.cpu(), s)
