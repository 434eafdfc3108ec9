"""The Hopper wire-format kernels (``int8_quantize``, ``ring_hop_int8``,
``ring_hop_topk``) against their plain versions, on the card.

Runs only where there is an sm_90 GPU and nvcc (the kernels are CUDA C++
for sm_90a, built at first use); elsewhere every test skips with the
reason.  Run on the card with
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_ring_wire_cuda.py``.

Tolerance: none.  The int8 kernel rounds the product and the sum apart and
divides as IEEE division, the plain version too, and its only cross-block
reduction is a max; the top-k kernel adds each unique index once, a plain
load, an IEEE add and a store (no float atomics: they flush subnormals).
So the kernels agree with their plain versions bitwise, for 16-byte-aligned
and unaligned chunk starts, for a member stride of 0 and for subnormal
values.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm.backends.ring import _topk_select, topk_chunk_k  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402

pytestmark = pytest.mark.gpu

GS = [2, 3, 4, 8]
NS = [1, 3, 250, 2 ** 20 + 3]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _randn(dev, *shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev)


def _stacks(dev, G, N, seed):
    """A (G, N) f32 member stack: contiguous, one element into its storage
    (unaligned), with a wider member stride, one row viewed G times, and
    one of subnormal values (below 2^-126: atomics would flush them)."""
    return {"contiguous": _randn(dev, G, N, seed=seed),
            "unaligned": _randn(dev, G * N + 1, seed=seed + 1)[1:].view(G, N),
            "wide": _randn(dev, G, N + 5, seed=seed + 2)[:, :N],
            "stride0": _randn(dev, N, seed=seed + 3).expand(G, N),
            "subnormal": _randn(dev, G, N, seed=seed + 4) * 2.0 ** -130}


def _same(got, want, tag):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, tag
        assert torch.equal(g, w), tag


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("G", GS)
def test_member_batched_kernels_match_plain(cuda, G, n):
    k = topk_chunk_k(n, 0.05)
    for name, st in _stacks(cuda, G, G * n, seed=G * 7 + n).items():
        kring.reset_launches()
        q, s = kring.int8_quantize_members(st)
        _same((q, s), kring.int8_quantize_members_plain(st), (name, "quantize"))
        vals, idx = _topk_select(kring.member_chunks(st, -1), k)
        for step in range(G - 1):
            got = kring.ring_hop_int8_members(st, q, s, step)
            _same(got, kring.ring_hop_int8_members_plain(st, q, s, step),
                  (name, "int8", step))
            q, s = got
            dense = kring.ring_hop_topk_members(st, vals, idx, step)
            _same(dense, kring.ring_hop_topk_members_plain(st, vals, idx, step),
                  (name, "topk", step))
            vals, idx = _topk_select(dense, k)
        torch.cuda.synchronize()
        assert kring.launches["int8_quantize"] == 1
        assert kring.launches["ring_hop_int8"] == G - 1
        assert kring.launches["ring_hop_topk"] == G - 1


@pytest.mark.parametrize("n", NS)
def test_per_member_kernels_match_plain(cuda, n):
    G = 4
    for name, chunks in _stacks(cuda, G, n, seed=n).items():
        x = chunks[1]
        q, s = kring.int8_quantize(x)
        _same((q, s), kring.int8_quantize_plain(x), (name, "quantize"))
        k = topk_chunk_k(n, 0.05)
        vals, idx = _topk_select(x, k)
        for c in range(G):
            cd = torch.tensor([c], dtype=torch.int32, device=cuda)
            want = kring.ring_hop_int8_plain(chunks, q, s, c)
            _same(kring.ring_hop_int8(chunks, q, s, c), want, (name, c))
            _same(kring.ring_hop_int8(chunks, q, s, cd), want, (name, c))
            want = kring.ring_hop_topk_plain(chunks, vals, idx, c)
            _same(kring.ring_hop_topk(chunks, vals, idx, c), want, (name, c))
            _same(kring.ring_hop_topk(chunks, vals, idx, cd), want, (name, c))


# chunk sizes of VGG-A's fusion buckets at G = 4 (chip_smoke.py's
# vgg_buckets): ragged (250, the fc15_b strip), and 16-byte-aligned up to
# the largest, fc13_w
VGG_NS = [250, 240352, 1024000, 25690112]


@pytest.mark.parametrize("ratio", [0.05, 0.25])
@pytest.mark.parametrize("n", VGG_NS)
def test_topk_hop_at_vgg_bucket_strides(cuda, n, ratio):
    """Member-batched over a stride-0 stack and distinct partials, and per
    member with host and on-card chunk indices; messages that hold
    subnormal values (below 2^-126, kept) and a dense part of -0 (+0
    after the hop)."""
    G = 4
    k = topk_chunk_k(n, ratio)
    one = _randn(cuda, G * n, seed=n)
    for name, st in (("stride0", one.expand(G, G * n)),
                     ("distinct", _randn(cuda, G, G * n, seed=n + 1))):
        vals, idx = _topk_select(kring.member_chunks(st, -1), k)
        vals = vals.clone()
        vals[:, ::3] = vals[:, ::3] * 2.0 ** -140      # subnormal entries
        for step in range(G - 1):
            dense = kring.ring_hop_topk_members(st, vals, idx, step)
            _same(dense, kring.ring_hop_topk_members_plain(st, vals, idx,
                                                           step),
                  (name, step))
            vals, idx = _topk_select(dense, k)
    chunks = -torch.zeros(G, n, device=cuda)
    chunks[2] = one[:n]
    vals, idx = _topk_select(one[n:2 * n], k)
    vals = vals * 2.0 ** -140
    for c in (1, 2):
        cd = torch.tensor([c], dtype=torch.int32, device=cuda)
        want = kring.ring_hop_topk_plain(chunks, vals, idx, c)
        assert (want[idx.long()] != 0).any()   # subnormal sums survive
        _same(kring.ring_hop_topk(chunks, vals, idx, c), want, c)
        _same(kring.ring_hop_topk(chunks, vals, idx, cd), want, c)
    off = torch.ones(n, dtype=torch.bool, device=cuda)
    off[idx.long()] = False                  # the dense part alone: +0
    assert not torch.signbit(kring.ring_hop_topk(chunks, vals, idx, 1)[off]
                             ).any()


@pytest.mark.parametrize("k", [1, 6, 5000])
@pytest.mark.parametrize("n", [2 ** 24 + 12, 2 ** 24 + 13])
def test_topk_hop_at_range_edges(cuda, n, k):
    """The kernel writes the chunk in ranges of at most 2^23 elements, each
    a dense pass and then a scatter of the entries that fall in it: entries
    on the first and last element of each of the 3 ranges, n a multiple of
    4 (16-byte path) and not (4-byte path)."""
    size = (-(-n // 3) + 3) // 4 * 4           # the kernel's range size
    edges = [0, size - 1, size, 2 * size - 1, 2 * size, n - 1]
    chunks = _randn(cuda, 2, n, seed=n + k)
    rest = torch.randperm(n, device=cuda)
    rest = rest[~torch.isin(rest, torch.tensor(edges, device=cuda))]
    idx = torch.cat([torch.tensor(edges, device=cuda), rest])[:k]
    idx = idx.to(torch.int32)
    vals = _randn(cuda, k, seed=k + 1)
    for c in (0, 1):
        _same(kring.ring_hop_topk(chunks, vals, idx, c),
              kring.ring_hop_topk_plain(chunks, vals, idx, c), (n, k, c))
    st = _randn(cuda, 2, 2 * n, seed=n)
    rows_v, rows_i = vals.repeat(2, 1), idx.repeat(2, 1)
    _same(kring.ring_hop_topk_members(st, rows_v, rows_i, 0),
          kring.ring_hop_topk_members_plain(st, rows_v, rows_i, 0), (n, k))


def test_all_zero_message_and_signed_zeros(cuda):
    z = torch.zeros(4, 1000, device=cuda)
    q, s = kring.int8_quantize(z[0])
    assert s.item() == 1.0 and not q.any()
    q, s = kring.int8_quantize_members(z)
    assert torch.equal(s, torch.ones(4, device=cuda)) and not q.any()
    neg = -z                       # -0.0 everywhere: the sum is +0.0
    dense = kring.ring_hop_topk(neg, torch.zeros(1, device=cuda),
                                torch.zeros(1, dtype=torch.int32, device=cuda),
                                0)
    assert not torch.signbit(dense).any()


def test_topk_kernel_drops_indices_outside_the_chunk(cuda):
    chunks = _randn(cuda, 2, 100, seed=5)
    vals = torch.ones(3, device=cuda)
    idx = torch.tensor([-1, 7, 100], dtype=torch.int32, device=cuda)
    got = kring.ring_hop_topk(chunks, vals, idx, 1)
    want = chunks[1].clone()
    want[7] += 1
    assert torch.equal(got, want)


def test_wire_kernels_raise_on_what_they_do_not_take(cuda):
    chunks = torch.zeros(4, 8, device=cuda)
    q = torch.zeros(8, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        kring.ring_hop_int8(chunks, q.cpu(), torch.ones(1, device=cuda), 0)
    with pytest.raises(ValueError):
        kring.ring_hop_int8(chunks, q, torch.ones(1, device=cuda),
                            torch.tensor([1], device=cuda))
    with pytest.raises(ValueError):
        kring.ring_hop_topk(chunks.t(), torch.zeros(1, device=cuda),
                            torch.zeros(1, dtype=torch.int32, device=cuda), 0)
