"""The CUDA row and tile kernels against their plain PyTorch versions, on a
card.

Top-k and QSGD must be bitwise equal to their plain versions (exact steps;
QSGD built with -fmad=false, its in-kernel norms summed in the order of
``ref.lane_order_norms``); scaled sign + EF sums in another order, so it
holds to rtol 1e-5, atol 1e-6. The tile kernels run in float32 and bf16, at
shapes whose last 1024-wide row is ragged. Secure aggregation on the card
must equal its run without masks, and its field arithmetic the CPU's, bit
for bit. The machine with the card has no JAX, so this file needs only
PyTorch; without a CUDA device every test skips.

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, qsgd, ref, sign_ef, topk_mask  # noqa: E402


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(4096, 32), (999, 32), (4096, 64),
                                   (4096, 128), (7, 36), (1000, 1000),
                                   (3, 1025)])
def test_row_kernels_every_layout_match_plain_on_cuda(cuda, shape, offset):
    """QSGD with its norms given and computed (``norms=None``) bit for bit
    against the plain version, at levels below 1 too (clamped inside), and
    scaled sign + EF to rtol 1e-5, atol 1e-6: row groups within a warp
    (d <= 128), of several warps (1000), block rows (1025); offset 1 makes
    every operand a view one element into its storage, so the row groups
    take 4-byte accesses."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = shape[0] * shape[1]

    def draw(fn, scale=1.0):
        t = scale * fn(offset + n, device=cuda, generator=gen)
        return t[offset:].view(shape)
    x, e, u = draw(torch.randn), draw(torch.randn, 0.1), draw(torch.rand)
    assert bool(x.data_ptr() % 16) == bool(offset)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    for lv in (0.5, 3.0, 256.0):
        lvt = torch.tensor(lv, device=cuda)
        for nm in (None, norms):
            got = qsgd.qsgd_rows(x, u, nm, lvt)
            assert torch.isfinite(got).all()
            assert torch.equal(got, qsgd.qsgd_rows_plain(x, u, nm, lvt)), (
                lv, nm is None)
    for got, want in zip(sign_ef.sign_ef_rows(x, e),
                         sign_ef.sign_ef_rows_plain(x, e)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_qsgd_rows_api_is_one_kernel_on_cuda(cuda):
    """``ops.qsgd_rows`` on the card computes the norms inside its one
    kernel: torch.profiler sees one kernel a call, and the counter one
    launch."""
    from torch.autograd import DeviceType
    x = torch.randn(4096, 32, device=cuda)
    u = torch.rand(4096, 32, device=cuda)
    lv = torch.tensor(256.0, device=cuda)
    ops.qsgd_rows(x, u, lv)  # build and warm up outside the window
    torch.cuda.synchronize()
    before = qsgd.qsgd_rows.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.qsgd_rows(x, u, lv)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    assert len(names) == 3 and all("qsgd_rows" in n for n in names), names
    assert qsgd.qsgd_rows.launches == before + 3


@pytest.mark.requires_cuda
def test_qsgd_rows_flat_past_two_to_the_32_on_cuda(cuda):
    """QSGD given its norms on rows wider than a block's row path: the flat
    pass at (6, 744 497 152), rows x d past 2^32 (six rows of the message of
    gemma-2b at two layers), against the plain version row by row (its
    temporaries at the whole size would not fit beside the operands)."""
    rows, d = 6, 744_497_152
    if torch.cuda.get_device_properties(cuda).total_memory < 72 * 2 ** 30:
        pytest.skip("needs a card with 72 GiB: three 17.9 GB operands")
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, d, device=cuda, generator=gen)
    u = torch.rand(rows, d, device=cuda, generator=gen)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    lv = torch.tensor(256.0, device=cuda)
    out = qsgd.qsgd_rows(x, u, norms, lv)
    for r in range(rows):
        assert torch.equal(out[r:r + 1], qsgd.qsgd_rows_plain(
            x[r:r + 1], u[r:r + 1], norms[r:r + 1], lv)), r
    del x, u, out
    torch.cuda.empty_cache()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(100,), (3, 777), (5, 7, 11), (1 << 18,),
                                   (64, 128), (1000, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_kernels_match_plain_on_cuda(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    e = 0.1 * torch.randn(shape, device=cuda, generator=gen)
    n = x.numel()
    u = torch.rand(-(-n // 8192) * 8, 1024, device=cuda, generator=gen)
    norm = torch.linalg.vector_norm(x.to(torch.float32).reshape(-1))
    for k in (1, 10, 200):
        got = topk_mask.block_topk_tiles(x, k)
        assert got.dtype == dtype
        assert torch.equal(got, topk_mask.block_topk_tiles_plain(x, k))
    for levels in (4, 256):
        got = qsgd.qsgd_tiles(x, u, norm, levels)
        assert got.dtype == dtype
        assert torch.equal(got, qsgd.qsgd_tiles_plain(x, u, norm, levels))
    for got, want in zip(sign_ef.sign_ef_tiles(x, e),
                         sign_ef.sign_ef_tiles_plain(x, e)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()


def _same_bits(a, b) -> bool:
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(4096, 32), (999, 33), (512, 1024),
                                   (64, 3000), (18, 65536)])
def test_topk_kernels_match_plain_on_adversarial_rows_cuda(cuda, shape):
    """Both top-k kernels bit for bit against their plain versions on rows
    with NaN, +inf, -inf, signed zeros, denormals, ties, constants and more
    candidates than a warp row's buffer holds; a NaN row keeps every
    non-NaN value, as the reference's does."""
    x = torch.from_numpy(ref.topk_adversarial(*shape, seed=6)).to(cuda)
    d = shape[1]
    for k in (-1.0, 0.0, 0.5, 1.0, 3.7, 10.0, 40.0, d - 1.0, float(d),
              d + 5.0):
        kt = torch.tensor(k, device=cuda)
        got = topk_mask.topk_rows(x, kt)
        assert _same_bits(got, topk_mask.topk_rows_plain(x, kt)), k
    nan_rows = torch.isnan(x).any(dim=1)
    kept = topk_mask.topk_rows(x, torch.tensor(1.0, device=cuda))[nan_rows]
    xn = x[nan_rows]
    assert torch.equal(kept != 0, ~torch.isnan(xn) & (xn != 0))
    flat = x.reshape(-1)[:x.numel() - 77]
    for dtype in (torch.float32, torch.bfloat16):
        xf = flat.to(dtype)
        for k in (-1, 0, 1, 10, 31, 32, 40, 1023, 1024, 1030):
            assert _same_bits(topk_mask.block_topk_tiles(xf, k),
                              topk_mask.block_topk_tiles_plain(xf, k)), k
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3])
def test_block_topk_unaligned_view_matches_plain_cuda(cuda, dtype, offset):
    """A view that does not start on 16 bytes (one with a storage offset)
    takes the 1024-wide kernel's direct reads, bit for bit as an aligned
    tensor does; through the API too."""
    store = torch.from_numpy(ref.topk_adversarial(40, 1024, seed=7))
    store = store.to(cuda).to(dtype).reshape(-1)
    x = store[offset:offset + store.numel() - 1000]  # ragged last row
    assert x.data_ptr() % 16
    for k in (-1, 0, 1, 10, 31, 40, 1023, 1024):
        assert _same_bits(topk_mask.block_topk_tiles(x, k),
                          topk_mask.block_topk_tiles_plain(x, k)), k
    assert _same_bits(ops.block_topk(x),
                      topk_mask.block_topk_tiles_plain(x, 10))
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_tile_kernels_match_oracles_on_cuda(cuda):
    """At whole tiles the kernels equal the oracles of ``kernels/ref.py``."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(64, 1024, device=cuda, generator=gen)
    e = torch.randn(64, 1024, device=cuda, generator=gen)
    u = torch.rand(64, 1024, device=cuda, generator=gen)
    norm = torch.linalg.vector_norm(x)
    assert torch.equal(topk_mask.block_topk_tiles(x, 10),
                       ref.block_topk_threshold_ref(x, 10))
    assert torch.equal(qsgd.qsgd_tiles(x, u, norm, 16),
                       ref.qsgd_ref(x, u, norm, 16))
    for got, want in zip(sign_ef.sign_ef_tiles(x, e), ref.sign_ef_ref(x, e)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.requires_cuda
def test_tile_apis_launch_once_on_cuda(cuda):
    x = torch.randn(3, 777, device=cuda)
    key = torch.tensor([0, 9], device=cuda)
    for fn, call in ((topk_mask.block_topk_tiles,
                      lambda: ops.block_topk(x)),
                     (qsgd.qsgd_tiles, lambda: ops.qsgd_quantize(key, x)),
                     (sign_ef.sign_ef_tiles,
                      lambda: ops.sign_ef_compress(x, torch.zeros_like(x)))):
        before = fn.launches
        call()
        assert fn.launches == before + 1
    torch.cuda.synchronize()


def _loss(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


@pytest.mark.requires_cuda
def test_secagg_bitwise_unmasked_and_field_ops_on_cuda(cuda):
    """Secure aggregation on the card: at N = 4096, d = 256 (the kernel row
    path, QSGD through B3) in blocks of 1024, secagg's params and losses are
    bit for bit those of the same run without masks; and the field codec
    and the pairwise masks on CUDA tensors equal the CPU's bit for bit."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import privacy
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.core.compression import coding
    from repro_torch.data import make_linear_datagen
    from repro_torch.fl import runtime as rt
    from repro_torch.fl import server
    d = 256
    w_star = np.random.default_rng(42).standard_normal(d).astype(np.float32)
    runs = []
    for priv in ("secagg", "_secagg_unmasked"):
        cfg = rt.SimConfig(
            n_devices=4096, n_scheduled=64, rounds=2, local_steps=2,
            policy="random", compression="qsgd", chunk_size=1024, seed=20,
            privacy=priv, privacy_params=privacy.privacy_params(
                clip=0.5, sigma=0.3),
            algo_params=algos.algo_params(lr=0.1),
            datagen=make_linear_datagen(w_star))
        runs.append(rt.run_simulation_scan(
            cfg, _loss, {"w": np.zeros(d, np.float32)}, device=cuda))
    (pm, lm), (pu, lu) = runs
    assert torch.equal(pm["w"], pu["w"])
    np.testing.assert_array_equal(lm.loss, lu.loss)
    assert (lm.mask_bits > 0).all() and not lu.mask_bits.any()

    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4096, d, device=cuda, generator=gen)
    for clip, fb in ((0.5, 20.0), (0.25, 17.0), (1.3, 24.0)):
        q = coding.to_field(x, clip, fb)
        assert torch.equal(q.cpu(), coding.to_field(x.cpu(), clip, fb))
        assert torch.equal(coding.from_field(q, clip, fb).cpu(),
                           coding.from_field(q.cpu(), clip, fb))
    key = trandom.PRNGKey(3, cuda)
    part = (torch.arange(4096, device=cuda) % 5 == 2).to(torch.float32)
    gsum, cnt = server._mask_prepass(key, 4096, d, part, 1024)
    gsum_c, cnt_c = server._mask_prepass(key.cpu(), 4096, d, part.cpu(), None)
    assert torch.equal(gsum.cpu(), gsum_c) and int(cnt) == int(cnt_c)
    ids = torch.arange(4096, device=cuda)
    assert torch.equal(
        privacy.pairwise_masks(key, ids, d, gsum, cnt).cpu(),
        privacy.pairwise_masks(key.cpu(), ids.cpu(), d, gsum_c, cnt_c))
    torch.cuda.synchronize()
