"""The Hopper direct-conv kernel against its plain version, on the card.

Runs only where there is an sm_90 GPU and nvcc (the kernel is CUDA C++ for
sm_90a, built at first use); elsewhere every test skips with the reason.
Run on the card with
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_conv2d_cuda.py``.

TF32 is off for cuDNN and matmul, so every side computes in f32.  Shapes:
three VGG-A layers (conv1, the first 256 -> 256 layer, the last 512 -> 512
layer) at batch 2, and OverFeat-FAST conv1 (11x11, stride 4) at batch 4;
every distinct conv shape of both nets at batch 2, and two 2-model-way
shards, each on the instance ``path`` names (the launch counters say
which ran); ragged shapes; and the edges of both instances: C % 4 != 0
(one copy a tap), C % 4 == 0 with K*K*C no multiple of a 16-deep stage,
K*K*C under one stage, F = 96, F = 130 and F = 27 on the 64- and 128-wide
tiles, stride 4, and x that starts off 16 bytes.  The weights updated in
place between two calls (the warp-specialised instance splits them anew
every call), and that instance bitwise the tiled one (the same products in
the same order).  Tolerance: 2e-5 of the layer's max |plain| — each output
is an f32 sum of up to K*K*IFM = 9216 products (the kernel's as three TF32
products each) taken in another order by each side; the rounding of such a
sum is a few 1e-6 of the output's scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402
from repro_torch.kernels.ref import conv2d_ref  # noqa: E402

pytestmark = pytest.mark.gpu

REL_TOL = 2e-5
# (name, N, H, IFM, OFM, K, stride, pad)
LAYERS = [
    ("vgg-a conv1", 2, 224, 3, 64, 3, 1, 1),
    ("vgg-a conv 256->256", 2, 56, 256, 256, 3, 1, 1),
    ("vgg-a conv 512->512 at 14x14", 2, 14, 512, 512, 3, 1, 1),
    ("overfeat-fast conv1", 4, 231, 3, 96, 11, 4, 0),
]




def _net_shapes():
    """(name, H, IFM, OFM, K, stride, pad) of every distinct conv shape of
    VGG-A and OverFeat-FAST, and of two 2-model-way shards (a member's half
    of the output channels): VGG-A conv2's 64 and OverFeat conv2's 128."""
    out, seen = [], set()
    for arch in ("vgg-a", "overfeat-fast"):
        cfg = get_config(arch)
        h, n_conv = cfg.image_size, 0
        for i, lyr in enumerate(cfg.layers):
            if lyr.kind == "pool":
                h //= 2
            if lyr.kind != "conv":
                continue
            n_conv += 1
            shape = (h, lyr.ifm, lyr.ofm, lyr.kernel, lyr.stride, lyr.pad)
            if shape not in seen:
                seen.add(shape)
                out.append((f"{arch} conv{n_conv}", *shape))
            if n_conv == 2:
                out.append((f"{arch} conv2, 2 model ways", h, lyr.ifm,
                            lyr.ofm // 2, *shape[3:]))
            h = lyr.out_hw
    return out


NET_SHAPES = _net_shapes()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, N, H, C, F, K, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, H, H, C, generator=gen, device=dev)
    w = torch.randn(K, K, C, F, generator=gen, device=dev) / np.sqrt(K * K * C)
    return x, w


@pytest.mark.parametrize("name,N,H,C,F,K,s,p", LAYERS,
                         ids=[layer[0] for layer in LAYERS])
def test_kernel_matches_plain(cuda, name, N, H, C, F, K, s, p):
    x, w = _inputs(cuda, N, H, C, F, K, seed=H + C)
    before = kconv.launches
    got = kconv.conv2d_nhwc(x, w, stride=s, padding=p)
    torch.cuda.synchronize()
    assert kconv.launches == before + 1
    want = kconv.conv2d_nhwc_plain(x, w, stride=s, padding=p)
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), (name, err)


@pytest.mark.parametrize("N,H,C,F,K,s,p", [(2, 17, 5, 70, 3, 1, 1),
                                           (3, 23, 16, 96, 5, 2, 2),
                                           (1, 9, 130, 16, 1, 1, 0)])
def test_ragged_shapes(cuda, N, H, C, F, K, s, p):
    """Pixels, channels and taps that are no multiple of the tile."""
    x, w = _inputs(cuda, N, H, C, F, K, seed=C)
    got = kconv.conv2d_nhwc(x, w, stride=s, padding=p)
    want = kconv.conv2d_nhwc_plain(x, w, stride=s, padding=p)
    assert (got - want).abs().max().item() \
        <= REL_TOL * want.abs().max().item()


@pytest.mark.parametrize("N,H,C,F,K,s,p", [(2, 20, 4, 96, 3, 1, 1),
                                           (2, 31, 64, 96, 11, 4, 0),
                                           (1, 16, 3, 130, 3, 2, 1),
                                           (3, 9, 8, 64, 1, 1, 0),
                                           (1, 7, 2, 5, 2, 1, 1),
                                           (2, 12, 12, 27, 3, 1, 1)])
def test_kernel_at_the_mainloops_edges(cuda, N, H, C, F, K, s, p):
    x, w = _inputs(cuda, N, H, C, F, K, seed=C * F)
    got = kconv.conv2d_nhwc(x, w, stride=s, padding=p)
    want = kconv.conv2d_nhwc_plain(x, w, stride=s, padding=p)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() \
        <= REL_TOL * want.abs().max().item()


@pytest.mark.parametrize("F", [64, 128])
def test_kernel_on_storage_not_16_byte_aligned(cuda, F):
    """C % 4 == 0, but x starting one element past an aligned address:
    every tap is copied on its own."""
    x, w = _inputs(cuda, 2, 14, 64, F, 3, seed=F)
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = kconv.conv2d_nhwc(shifted, w, stride=1, padding=1)
    want = kconv.conv2d_nhwc_plain(x, w, stride=1, padding=1)
    assert (got - want).abs().max().item() \
        <= REL_TOL * want.abs().max().item()


def test_autograd_grads_match_reference(cuda):
    x, w = _inputs(cuda, 2, 28, 64, 128, 3, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = torch.randn(2, 28, 28, 128, generator=gen, device=cuda)
    grads = []
    for fn in (kconv.conv2d, conv2d_ref):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(xr, wr, 1, 1) * g).sum().backward()
        grads.append((xr.grad, wr.grad))
    for got, want in zip(grads[0], grads[1]):
        assert (got - want).abs().max().item() \
            <= REL_TOL * want.abs().max().item()


def test_kernel_rejects_bad_inputs(cuda):
    x, w = _inputs(cuda, 1, 8, 4, 16, 3, seed=0)
    with pytest.raises(TypeError):
        kconv.conv2d_nhwc(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        kconv.conv2d_nhwc(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        kconv.conv2d_nhwc(x, w[:, :, :3].contiguous())


@pytest.mark.parametrize("name,H,C,F,K,s,p", NET_SHAPES,
                         ids=[shape[0] for shape in NET_SHAPES])
def test_every_conv_shape_of_both_nets_on_its_path(cuda, name, H, C, F, K, s,
                                                   p):
    x, w = _inputs(cuda, 2, H, C, F, K, seed=H + C + F)
    want_path = kconv.path(C, F, K, s)
    assert want_path == ("tiled" if C == 3 else "ws"), name
    before, before_ws = kconv.launches, kconv.launches_ws
    got = kconv.conv2d_nhwc(x, w, stride=s, padding=p)
    torch.cuda.synchronize()
    assert kconv.launches == before + 1
    assert kconv.launches_ws == before_ws + (want_path == "ws")
    want = kconv.conv2d_nhwc_plain(x, w, stride=s, padding=p)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), (name, err)


def test_weights_updated_in_place_between_calls(cuda):
    """The optimizer updates w in place: the second call computes with the
    new weights, not a split kept from the first."""
    x, w = _inputs(cuda, 2, 28, 64, 128, 3, seed=11)
    assert kconv.path(64, 128, 3, 1) == "ws"
    first = kconv.conv2d_nhwc(x, w, stride=1, padding=1)
    w.mul_(-0.5).add_(0.01)
    second = kconv.conv2d_nhwc(x, w, stride=1, padding=1)
    want = kconv.conv2d_nhwc_plain(x, w, stride=1, padding=1)
    assert (second - want).abs().max().item() \
        <= REL_TOL * want.abs().max().item()
    assert (second - first).abs().max().item() \
        > 0.1 * want.abs().max().item()


@pytest.mark.parametrize("N,H,C,F,K,s,p", [(2, 28, 256, 256, 3, 1, 1),
                                           (3, 23, 16, 130, 5, 2, 2)])
def test_ws_instance_bitwise_the_tiled_one(cuda, N, H, C, F, K, s, p):
    """Both instances issue the same three TF32 products a k8 step in the
    same order, promoted at the same depths, on the same split operands:
    their outputs agree to the bit where both take 128-wide tiles."""
    x, w = _inputs(cuda, N, H, C, F, K, seed=F)
    got = kconv.conv2d_nhwc(x, w, stride=s, padding=p)
    OH, OW = kconv.out_hw(H, H, K, s, p)
    tiled = torch.empty_like(got)
    kconv.launch(kconv._lib().conv2d_nhwc_f32, x.device, x.data_ptr(),
                 w.data_ptr(), tiled.data_ptr(), N, H, H, C, K, F, s, p, OH,
                 OW)
    torch.cuda.synchronize()
    assert torch.equal(got, tiled)
