"""The CUDA row kernels against their plain PyTorch versions, on a card.

Top-k and QSGD must be bitwise equal to their plain versions (exact steps;
QSGD built with -fmad=false); scaled sign + EF sums in another order, so it
holds to rtol 1e-5, atol 1e-6. The machine with the card has no JAX, so this
file needs only PyTorch; without a CUDA device every test skips.

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import qsgd, sign_ef, topk_mask  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(4096, 32), (1000, 1000), (256, 65536),
                                   (7, 33), (3, 1025)])
def test_kernels_match_plain_on_cuda(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=gen)
    e = 0.1 * torch.randn(shape, device=cuda, generator=gen)
    u = torch.rand(shape, device=cuda, generator=gen)
    k = torch.tensor(max(1.0, shape[1] / 100), device=cuda)
    assert torch.equal(topk_mask.topk_rows(x, k),
                       topk_mask.topk_rows_plain(x, k))
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    lv = torch.tensor(256.0, device=cuda)
    assert torch.equal(qsgd.qsgd_rows(x, u, norms, lv),
                       qsgd.qsgd_rows_plain(x, u, norms, lv))
    for got, want in zip(sign_ef.sign_ef_rows(x, e),
                         sign_ef.sign_ef_rows_plain(x, e)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
