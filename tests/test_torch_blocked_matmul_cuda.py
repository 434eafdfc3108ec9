"""The Hopper blocked-GEMM kernel against its plain version, on the card.

Runs only where there is an sm_90 GPU and nvcc (the kernel is CUDA C++ for
sm_90a, built at first use); elsewhere every test skips with the reason.
Run on the card with
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_blocked_matmul_cuda.py``.

TF32 is off for matmul, so the plain version's cuBLAS products are f32.
Shapes: CD-DNN's three layer shapes at batch 1024, ragged and small ones,
each at every compiled tile, f32 and bf16 inputs; then the edges of the
tensor-core mainloop (``csrc/gemm_tf32x3.cuh``): rows of A that are not
16-byte aligned (K % 4 != 0 for f32, K % 8 != 0 for bf16, or storage that
starts off 16 bytes), K under one wgmma's depth of 8, M = 1.  Tolerance:
2e-5 of the output's max |plain| — each output is an f32 sum of up to 2048
products taken in another order by each side (the kernel's f32 inputs as
three TF32 products each); the rounding of such a sum is a few 1e-6 of its
scale (both sides widen bf16 exactly).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.blocking import GemmBlocking  # noqa: E402
from repro_torch.kernels import blocked_matmul as kmm  # noqa: E402

pytestmark = pytest.mark.gpu

REL_TOL = 2e-5
# (M, N, K)
SHAPES = [(1024, 2048, 440), (1024, 2048, 2048), (1024, 9304, 2048),
          (1, 9304, 2048), (1024, 2048, 1), (3, 7, 5), (130, 70, 200),
          (8, 128, 128), (256, 512, 384), (1000, 1001, 999)]
TILES = [None, (64, 64), (64, 128), (128, 64), (128, 128)]
# K < 8, K % 8 in 1..7, M = 1 and odd N on every tile
EDGES = [(64, 96, 3), (17, 33, 7), (1, 130, 27), (129, 65, 12), (2, 200, 6),
         (96, 40, 1004)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        pytest.skip("no CUDA toolkit (nvcc) to build the kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, M, N, K, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    b = torch.randn(K, N, generator=gen, device=dev).to(dtype)
    return a, b


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "solver" if t is None
                         else f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_kernel_matches_plain(cuda, M, N, K, dtype, tile):
    a, b = _inputs(cuda, M, N, K, dtype, seed=M + N + K)
    blk = None if tile is None else GemmBlocking(*tile, 8, 0, 0.0)
    before = kmm.launches
    got = kmm.blocked_matmul(a, b, blocking=blk)
    torch.cuda.synchronize()
    assert kmm.launches == before + 1
    want = kmm.blocked_matmul_plain(a, b)
    assert got.shape == want.shape == (M, N)
    assert got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), (M, N, K, tile, err)


def _check(a, b, tile):
    blk = None if tile is None else GemmBlocking(*tile, 8, 0, 0.0)
    got = kmm.blocked_matmul(a, b, blocking=blk)
    want = kmm.blocked_matmul_plain(a, b)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), (tile, err)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "solver" if t is None
                         else f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M,N,K", EDGES)
def test_kernel_at_the_mainloops_edges(cuda, M, N, K, dtype, tile):
    a, b = _inputs(cuda, M, N, K, dtype, seed=M * N + K)
    _check(a, b, tile)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "solver" if t is None
                         else f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_on_storage_not_16_byte_aligned(cuda, dtype, tile):
    """K a multiple of a 16-byte chunk, but A starting one element past an
    aligned address: every row is copied an element at a time."""
    M, N, K = 200, 136, 512
    a, b = _inputs(cuda, M, N, K, dtype, seed=5)
    shifted = torch.empty(M * K + 1, dtype=dtype, device=cuda)[1:].view(M, K)
    shifted.copy_(a)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _check(shifted, b, tile)


def test_autograd_grads_match_torch_matmul(cuda):
    a, b = _inputs(cuda, 1024, 9304, 2048, torch.float32, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = torch.randn(1024, 9304, generator=gen, device=cuda)
    grads = []
    for fn in (kmm.matmul, torch.matmul):
        ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
        (fn(ar, br) * g).sum().backward()
        grads.append((ar.grad, br.grad))
    for got, want in zip(grads[0], grads[1]):
        assert (got - want).abs().max().item() \
            <= REL_TOL * want.abs().max().item()


def test_kernel_rejects_bad_inputs(cuda):
    a, b = _inputs(cuda, 4, 5, 3, torch.float32, seed=0)
    with pytest.raises(TypeError):
        kmm.blocked_matmul(a.half(), b.half())
    with pytest.raises(ValueError, match="contiguous"):
        kmm.blocked_matmul(b.t(), a.t())
    with pytest.raises(ValueError, match="no instance"):
        kmm.blocked_matmul(a, b, blocking=GemmBlocking(256, 64, 8, 0, 0.0))
    with pytest.raises(ValueError):
        kmm.blocked_matmul(a, b.cpu())
