"""The Hopper ring kernels against their plain versions, on the card.

Runs only where there is an sm_90 GPU and nvcc (the kernels are CUDA C++
for sm_90a, built at first use); elsewhere every test skips with the
reason.  Run on the card with
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_ring_cuda.py``.

Tolerance: none.  Each kernel adds in the plain version's order and dtype
(or only moves data), so the two agree bitwise, in f32 and in bf16, for
16-byte-aligned and unaligned chunk starts and for a member stride of 0.
The reduce-scatter is one launch of the fold kernel a call, with no scratch
beyond its output.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ring as kring  # noqa: E402

pytestmark = pytest.mark.gpu

GS = [1, 2, 3, 4, 8, 16]
NS = [1, 3, 250, 2 ** 20 + 3]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _randn(dev, *shape, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _layouts(dev, G, N, dtype, seed):
    """The same kind of (G, N) stack four ways: contiguous, with an
    unaligned base (starts one element into its storage), with a wider
    member stride, and one row viewed G times (stride 0)."""
    base = _randn(dev, G, N, dtype=dtype, seed=seed)
    shifted = _randn(dev, G * N + 1, dtype=dtype, seed=seed + 1)[1:] \
        .view(G, N)
    wide = _randn(dev, G, N + 5, dtype=dtype, seed=seed + 2)[:, :N]
    row = _randn(dev, N, dtype=dtype, seed=seed + 3).expand(G, N)
    return {"contiguous": base, "unaligned": shifted, "wide": wide,
            "stride0": row}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("G", GS)
def test_reduce_scatter_matches_plain(cuda, G, n, dtype):
    for name, x in _layouts(cuda, G, G * n, dtype, seed=G * 7 + n).items():
        kring.reset_launches()
        got = kring.ring_reduce_scatter(x)
        torch.cuda.synchronize()
        assert kring.launches["ring_reduce_scatter"] == (G > 1), name
        want = kring.ring_reduce_scatter_plain(x)
        assert got.shape == (G, n) and got.dtype == dtype, name
        assert torch.equal(got, want), (name, (got.float() - want.float())
                                        .abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("G", GS)
def test_all_gather_matches_plain(cuda, G, n, dtype):
    for name, x in _layouts(cuda, G, n, dtype, seed=G * 11 + n).items():
        kring.reset_launches()
        got = kring.ring_all_gather(x)
        torch.cuda.synchronize()
        assert kring.launches["ring_all_gather"] == (G > 1), name
        assert got.shape == (G, G * n), name
        assert torch.equal(got, kring.ring_all_gather_plain(x)), name


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("G", [1, 4, 8])
def test_hop_matches_plain(cuda, G, n, dtype):
    recvs = {"recv": _randn(cuda, n, dtype=dtype, seed=n),
             "unaligned recv": _randn(cuda, n + 1, dtype=dtype, seed=n)[1:]}
    for (name, x), (rname, recv) in itertools.product(
            _layouts(cuda, G, n, dtype, seed=G * 13 + n).items(),
            recvs.items()):
        name = f"{name}, {rname}"
        for c in range(G):
            kring.reset_launches()
            got = kring.ring_hop_accum(x, recv, c)
            on_card = kring.ring_hop_accum(
                x, recv, torch.tensor([c], dtype=torch.int32, device=cuda))
            torch.cuda.synchronize()
            assert kring.launches["ring_hop_accum"] == 2
            want = kring.ring_hop_accum_plain(x, recv, c)
            assert torch.equal(got, want), (name, c)
            assert torch.equal(on_card, want), (name, c)


@pytest.mark.parametrize("stride0", [False, True], ids=["partials", "stride0"])
def test_reduce_scatter_allocates_only_its_output(cuda, stride0):
    G, n = 4, 2 ** 20 + 4
    x = _randn(cuda, n * G, dtype=torch.float32, seed=5).expand(G, -1) \
        if stride0 else _randn(cuda, G, G * n, dtype=torch.float32, seed=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = kring.ring_reduce_scatter(x)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    assert grown <= -(-out.numel() * 4 // 512) * 512, grown
    assert torch.equal(out, kring.ring_reduce_scatter_plain(x))


def test_reduce_scatter_past_2_to_the_31_bytes(cuda):
    """G = 8 distinct partials of strips as long as VGG-A's largest bucket's
    at G = 4: a 6.6 GB stack, byte offsets far past 2^31."""
    G, n = 8, 25_690_112
    x = _randn(cuda, G, G * n, dtype=torch.float32, seed=9)
    kring.reset_launches()
    got = kring.ring_reduce_scatter(x)
    torch.cuda.synchronize()
    assert kring.launches["ring_reduce_scatter"] == 1
    assert torch.equal(got, kring.ring_reduce_scatter_plain(x))


def test_round_trip_is_the_sum(cuda):
    x = _randn(cuda, 4, 4 * 1000, dtype=torch.float32, seed=3)
    full = kring.ring_all_gather(kring.ring_reduce_scatter(x))
    torch.testing.assert_close(full, x.sum(0).expand(4, -1), rtol=1e-6,
                               atol=1e-5)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError):
        kring.ring_reduce_scatter(x.half())
    with pytest.raises(ValueError):
        kring.ring_reduce_scatter(torch.zeros(3, 10, device=cuda))
    with pytest.raises(ValueError):
        kring.ring_reduce_scatter(x.t())
    with pytest.raises(ValueError):
        kring.ring_all_gather(x[None])
    with pytest.raises(ValueError):
        kring.ring_hop_accum(x, torch.zeros(8), 0)
    with pytest.raises(ValueError):
        kring.ring_hop_accum(x, torch.zeros(7, device=cuda), 0)
    with pytest.raises(ValueError):
        kring.ring_hop_accum(x, torch.zeros(8, device=cuda), 4)
    with pytest.raises(ValueError):
        kring.ring_hop_accum(x, torch.zeros(8, device=cuda),
                             torch.tensor([1], device=cuda))
