"""The direct conv of the port against the JAX package, on the CPU.

The port's plain version (``conv2d_nhwc_plain``, and the wrapper that
computes it for CPU tensors) is held against the reference's Pallas kernel
in interpret mode and against its ``lax.conv`` oracle, on the same numpy
inputs; the port's ``conv2d_ref`` against the reference's; the autograd
``conv2d``'s gradients against ``jax.grad`` of the reference's
``conv2d_ref``; and which of the kernel's two instances a call's shape
takes (``path``).

Tolerance: 2e-6 of the output's max magnitude.  Both sides sum the same f32
products (at most 11*11*16 = 1936 of them here) in different orders; the
rounding of such a sum stays below 1e-6 of its scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.conv2d import conv2d_nhwc as jax_conv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402
from repro_torch.kernels.ref import conv2d_ref  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

REL_TOL = 2e-6

# (N, H, IFM, OFM, K, stride, pad): every K in {1, 3, 5, 11}, stride in
# {1, 4}, pad in {0, 1}, IFM in {3, 16} and OFM in {16, 96} appears
CASES = [
    (2, 8, 3, 16, 1, 1, 0),
    (2, 9, 16, 16, 3, 1, 1),
    (1, 12, 3, 96, 3, 1, 0),
    (2, 11, 16, 96, 5, 1, 1),
    (1, 13, 16, 16, 5, 4, 0),
    (2, 23, 3, 96, 11, 4, 0),
    (1, 19, 3, 16, 11, 4, 1),
    (1, 10, 16, 96, 3, 4, 1),
]


def _inputs(seed, N, H, C, F, K):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, H, C)).astype(np.float32)
    w = (rng.standard_normal((K, K, C, F)) / np.sqrt(K * K * C)
         ).astype(np.float32)
    return x, w


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


@pytest.mark.parametrize("N,H,C,F,K,s,p", CASES)
def test_plain_matches_pallas_interpret_and_oracle(N, H, C, F, K, s, p):
    x, w = _inputs(K * 100 + s * 10 + p, N, H, C, F, K)
    pallas = jax_conv(jnp.asarray(x), jnp.asarray(w), stride=s, padding=p,
                      interpret=True)
    oracle = jref.conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride=s,
                             padding=p)
    tx, tw = torch.tensor(x), torch.tensor(w)
    before = kconv.launches
    for got in (kconv.conv2d_nhwc_plain(tx, tw, stride=s, padding=p),
                kconv.conv2d_nhwc(tx, tw, stride=s, padding=p)):
        _close(got.numpy(), pallas)
        _close(got.numpy(), oracle)
    assert kconv.launches == before     # CPU tensors never launch
    _close(conv2d_ref(tx, tw, s, p).numpy(), oracle)


@pytest.mark.parametrize("N,H,C,F,K,s,p", [CASES[1], CASES[3], CASES[5]])
def test_autograd_grads_match_jax_grad_of_ref(N, H, C, F, K, s, p):
    x, w = _inputs(7, N, H, C, F, K)
    OH, OW = kconv.out_hw(H, H, K, s, p)
    g = np.random.default_rng(8).standard_normal(
        (N, OH, OW, F)).astype(np.float32)

    def jloss(x_, w_):
        return jnp.sum(jref.conv2d_ref(x_, w_, stride=s, padding=p) * g)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    (kconv.conv2d(tx, tw, s, p) * torch.tensor(g)).sum().backward()
    _close(tx.grad.numpy(), jgx)
    _close(tw.grad.numpy(), jgw)


def test_autograd_skips_the_input_gradient_of_data():
    x, w = _inputs(9, 1, 6, 3, 16, 3)
    tw = torch.tensor(w, requires_grad=True)
    kconv.conv2d(torch.tensor(x), tw, 1, 1).sum().backward()
    assert tw.grad.shape == tw.shape


def test_out_hw_matches_the_reference_kernel():
    for (N, H, C, F, K, s, p) in CASES:
        x, w = _inputs(0, N, H, C, F, K)
        got = jax.eval_shape(
            lambda a, b: jax_conv(a, b, stride=s, padding=p, interpret=True),
            jnp.asarray(x), jnp.asarray(w)).shape
        assert (N, *kconv.out_hw(H, H, K, s, p), F) == got


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w = (torch.tensor(a) for a in _inputs(0, 1, 8, 4, 16, 3))
    with pytest.raises(TypeError):
        kconv.conv2d_nhwc(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        kconv.conv2d_nhwc(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        kconv.conv2d_nhwc(x, w[:, :, :3].contiguous())      # IFM mismatch
    with pytest.raises(ValueError):
        kconv.conv2d_nhwc(x[0], w)                           # rank
    with pytest.raises(ValueError):
        kconv.conv2d_nhwc(x, w, stride=0)
    with pytest.raises(ValueError):
        kconv.conv2d_nhwc(x[:, :2, :2].contiguous(), w)     # kernel too big
    with pytest.raises(ValueError):
        kconv.conv2d_nhwc(x.to("meta"), w.to("meta"))        # not cpu/cuda


# (arch, conv index, model ways): every conv layer of both nets, whole and
# as one member's half of its output channels at 2 model ways
NET_CONVS = [(arch, i, ways)
             for arch, n in (("vgg-a", 8), ("overfeat-fast", 5))
             for i in range(n) for ways in (1, 2)]


@pytest.mark.parametrize("arch,i,ways", NET_CONVS)
def test_path_of_every_conv_of_both_nets(arch, i, ways):
    """The first layer (C = 3: one 4-byte load a tap) stays on the tiled
    instance; every other layer and its shards take the warp-specialised
    one, 64-wide shards too."""
    lyr = [lyr for lyr in get_config(arch).layers if lyr.kind == "conv"][i]
    got = kconv.path(lyr.ifm, lyr.ofm // ways, lyr.kernel, lyr.stride)
    assert got == ("tiled" if i == 0 else "ws")


# (IFM, OFM, K, stride, x 16-byte aligned, path): the rule's edges
EDGES = [
    (4, 96, 3, 1, True, "ws"),       # the least vectorised IFM
    (16, 16, 1, 1, True, "ws"),      # K*K*IFM exactly one stage
    (12, 16, 1, 1, True, "tiled"),   # K*K*IFM under one stage
    (8, 64, 1, 1, True, "tiled"),
    (12, 27, 3, 1, True, "ws"),      # OFM odd, under a 64-wide tile
    (16, 130, 5, 2, True, "ws"),     # OFM past one 128-wide tile, stride 2
    (64, 96, 11, 4, True, "ws"),     # 11x11, stride 4
    (64, 128, 3, 1, False, "tiled"),  # x off 16 bytes: one load a tap
    (5, 70, 3, 1, True, "tiled"),    # IFM % 4 != 0
    (130, 16, 1, 1, True, "tiled"),
    (3, 130, 3, 2, True, "tiled"),
    (2, 5, 2, 1, True, "tiled"),
]


@pytest.mark.parametrize("C,F,K,s,aligned,want", EDGES)
def test_path_at_the_rules_edges(C, F, K, s, aligned, want):
    assert kconv.path(C, F, K, s, aligned) == want
