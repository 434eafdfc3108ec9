"""The 3xTF32 arithmetic of the blocked GEMM and the direct conv, emulated on
the CPU, against their plain versions.

The CUDA kernels (``csrc/blocked_matmul.cu`` and ``csrc/conv2d.cu``, on the
mainloop of ``csrc/gemm_tf32x3.cuh``) cannot run here, but their rounding
can.  Each f32 operand x is split into hi = rna_tf32(x) (10 mantissa bits,
to nearest, ties away from zero) and lo = rna_tf32(x - hi); each k8 step of
the depth, in ascending order, adds a_lo b_hi, then a_hi b_lo, then a_hi
b_hi to the wgmmas' partial sum, and every 32 of the depth the partial sum
is added (f32, to nearest) to the thread's sum and starts afresh.  A tf32
product is exact in f32; each wgmma adds its 8 products to the partial sum
with one rounding, modelled here to nearest and toward zero.  The card's
accumulator leans toward zero: without the promotion the error over
VGG-A's convs reaches 3.5e-5 of the output's scale on an H100
(``experiments/tf32x3_variants.py``, ``no_promotion``), and the toward-zero
model gives 5.6e-5 at their widest, K*K*C = 4608.  ``_emulate`` repeats all
of that in torch (f64 block sums, f32 sums).

It is held to the kernels' own gates on the card (``chip_smoke.py`` phases 3
and 10, ``tests/test_torch_*_cuda.py``), unchanged: max |kernel - plain| <=
2e-5 max |plain|, at CD-DNN's three layer shapes and VGG-A's eight conv
layers with M cut to a few hundred rows (K and N at full size), and at
ragged depths.  A single TF32 product (a_hi b_hi) fails that gate at every
model shape: that is why there are three.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import blocked_matmul as kmm  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

REL_TOL = 2e-5      # chip_smoke.py's GEMM_REL_TOL and CONV_REL_TOL
KSTEP = 8           # depth of a tf32 wgmma
ROWS = 256          # M cut to this many rows (GEMM) or about this many pixels (conv)
PROMOTE = 32        # depth between promotions (kPromoteDepth in gemm_tf32x3.cuh)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to 10 mantissa bits, to nearest, ties away from zero:
    cvt.rna.tf32.f32, as f32 bits whose low 13 are zero."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = ((u + 0x1000) & 0xFFFFE000).to(torch.int64)
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    return u.view(torch.float32)


def _round(acc64: torch.Tensor, mode: str) -> torch.Tensor:
    """acc64 rounded to f32: to nearest ("rn") or toward zero ("rz")."""
    r = acc64.float()
    if mode == "rz":
        over = r.double().abs() > acc64.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _emulate(a: torch.Tensor, b: torch.Tensor, products: int, mode: str,
             promote: int = PROMOTE):
    """A (M, K) @ B (K, N), f32, the kernel's way: 3 tf32 products a k8
    step (``products=1``: a_hi b_hi alone), the partial sum rounded per
    wgmma, promoted every ``promote`` of the depth (0: never)."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    terms = ([(a_lo, b_hi), (a_hi, b_lo)] if products == 3 else []) \
        + [(a_hi, b_hi)]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    part = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], KSTEP):
        for x, y in terms:
            blk = x[:, k0:k0 + KSTEP].double() @ y[k0:k0 + KSTEP].double()
            part = _round(part.double() + blk, mode)
        if promote and (k0 + KSTEP) % promote == 0:
            acc, part = acc + part, torch.zeros_like(part)
    return acc + part


def _ratio(got, want):
    """max |got - want| over REL_TOL max |want|: the gate's margin (<= 1
    passes)."""
    return ((got - want).abs().max() / (REL_TOL * want.abs().max())).item()


def _gemm_case(M, N, K, seed):
    """phase 10's inputs: unit normal a and b."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32))
    return a, b, kmm.blocked_matmul_plain(a, b)


def _im2col(x, K, stride, pad):
    """x (N, H, W, C) -> (N*OH*OW, K*K*C), depth ordered (kh, kw, c) as the
    kernel walks it and HWIO weights are laid out."""
    N, H, W, C = x.shape
    OH, OW = kconv.out_hw(H, W, K, stride, pad)
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    cols = [xp[:, kh:kh + (OH - 1) * stride + 1:stride,
               kw:kw + (OW - 1) * stride + 1:stride, :]
            for kh in range(K) for kw in range(K)]
    return torch.stack(cols, dim=3).reshape(N * OH * OW, K * K * C)


def _conv_case(C, F, K, stride, pad, seed):
    """phase 3's inputs (unit normal x, w scaled by 1/sqrt(K K C)) on 8
    images of 6 x 6 pixels (288 rows at 3x3, pad 1)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, 6, 6, C), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((K, K, C, F)) / np.sqrt(K * K * C))
                         .astype(np.float32))
    want = kconv.conv2d_nhwc_plain(x, w, stride=stride, padding=pad)
    return _im2col(x, K, stride, pad), w.reshape(K * K * C, F), \
        want.reshape(-1, F)


def _cd_dnn_shapes():
    cfg = get_config("cd-dnn")
    dims = [cfg.input_dim] + [cfg.hidden_dim] * cfg.num_hidden \
        + [cfg.output_dim]
    return sorted({(ROWS, n, k) for k, n in zip(dims[:-1], dims[1:])})


def _vgg_convs():
    cfg = get_config("vgg-a")
    return [(lyr.ifm, lyr.ofm, lyr.kernel, lyr.stride, lyr.pad)
            for lyr in cfg.layers if lyr.kind == "conv"]


GEMMS = _cd_dnn_shapes()                   # (256, 2048, 440), ... 9304
CONVS = sorted(set(_vgg_convs()))          # VGG-A's distinct conv layers
RAGGED = [(ROWS, 70, 5), (ROWS, 130, 27), (ROWS, 96, 363), (ROWS, 200, 999),
          (3, 7, 1)]


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("M,N,K", GEMMS + RAGGED)
def test_gemm_3xtf32_within_the_gate(M, N, K, mode):
    a, b, want = _gemm_case(M, N, K, K + N)
    r = _ratio(_emulate(a, b, 3, mode), want)
    print(f"GEMM ({M}, {N}, {K}) 3xTF32 ({mode}): error / gate {r:.4f}")
    assert r <= 1.0


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("C,F,K,stride,pad", CONVS)
def test_conv_3xtf32_within_the_gate(C, F, K, stride, pad, mode):
    a, b, want = _conv_case(C, F, K, stride, pad, C + F)
    r = _ratio(_emulate(a, b, 3, mode), want)
    print(f"conv {C} -> {F} ({K}x{K}) 3xTF32 ({mode}): error / gate {r:.4f}")
    assert r <= 1.0


@pytest.mark.parametrize("M,N,K", GEMMS)
def test_gemm_one_tf32_product_breaks_the_gate(M, N, K):
    a, b, want = _gemm_case(M, N, K, K + N)
    r = _ratio(_emulate(a, b, 1, "rn"), want)
    print(f"GEMM ({M}, {N}, {K}) one TF32 product: error / gate {r:.4f}")
    assert r > 1.0


@pytest.mark.parametrize("C,F,K,stride,pad", CONVS)
def test_conv_one_tf32_product_breaks_the_gate(C, F, K, stride, pad):
    a, b, want = _conv_case(C, F, K, stride, pad, C + F)
    r = _ratio(_emulate(a, b, 1, "rn"), want)
    print(f"conv {C} -> {F} ({K}x{K}) one TF32 product: error / gate {r:.4f}")
    assert r > 1.0


def test_conv_without_promotion_breaks_the_gate_when_the_sum_truncates():
    """VGG-A's widest reduction (3x3x512) with every wgmma summing into one
    accumulator that rounds toward zero: the drift the card showed."""
    a, b, want = _conv_case(512, 512, 3, 1, 1, 1024)
    r = _ratio(_emulate(a, b, 3, "rz", promote=0), want)
    print(f"conv 512 -> 512 (3x3) 3xTF32 (rz), no promotion: error / gate "
          f"{r:.4f}")
    assert r > 1.0


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                     # tf32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.99,
                      one + ulp * 1.5, 3.0e-39, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         tf32_rna(torch.tensor([3.0e-39]))[0].item(), 0.0],
                        dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    # the split is exact: hi + lo recovers x to 2^-22 of it
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    hi = tf32_rna(y)
    lo = tf32_rna(y - hi)
    assert ((hi.double() + lo.double() - y.double()).abs()
            <= y.double().abs() * 2.0 ** -21).all()
