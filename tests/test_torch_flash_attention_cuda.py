"""The Hopper flash-attention kernel against its plain version, on the card.

Runs only where there is an sm_90 GPU and nvcc (the kernel is CUDA C++ for
sm_90a, built at first use); elsewhere every test skips with the reason.
Run on the card with ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_*_cuda.py``.

Shapes: every compiled head_dim (32, 64, 128, 256), GQA groups 1, 2 and 4,
Sq = 1, a multiple of the 64-row q tile and ragged, Skv = Sq and Sq + 64
(right-aligned queries), causal and not, windows and the softcap; for both
types also Skv = 1024 under a 200-key window (the K/V rings, of 2-4 stages,
wrap many times, and windowed tiles are skipped between live ones), Sq =
130 (no multiple of a 64- or 128-row q tile) and the four model shapes of
chip_smoke.py's phase 12.  bf16: a 16-byte-misaligned view, which TMA
cannot load and the wrapper refuses, and outputs bitwise those of the
build before the f32 redesign (digests below).  f32: views that start 4
bytes past a 16-byte boundary (loaded, not refused), and one call as
exactly two kernels on the card, the K/V split and the attention.
Head dims between the compiled instances (every D % 8 == 0 up to 256 runs
the next instance up, its columns past D zeros): D 8 to 248 over the same
features, and zamba2-2.7b's (D 80, Hq = Hkv = 32) and h2o-danube-3-4b's (D
120, Hq 32, Hkv 8, window 4096) training shapes, in both types.
Tolerances: bf16 output, one bf16 ulp at the largest magnitude of each
(batch, head) slice (both sides compute in f32 and round once); f32
output, 2e-5 of the largest magnitude (f32 sums in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, B, Sq, Skv, Hq, Hkv, D, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


def _assert_agree(got, want, dtype):
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(g).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-5 * np.abs(w).max())
        return
    big = np.abs(w).max(axis=(1, 3), keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert (np.abs(g - w) <= ulp).all(), (np.abs(g - w) / ulp).max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("Sq,extra", [(1, 0), (1, 64), (64, 0), (200, 64),
                                      (256, 0)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 4), (8, 2)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 48, 50.0), (False, 0, 50.0), (False, 48, 0.0)])
def test_kernel_matches_plain(cuda, dtype, D, Sq, extra, Hq, Hkv, causal,
                              window, softcap):
    q, k, v = _inputs(cuda, dtype, 2, Sq, Sq + extra, Hq, Hkv, D)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_agree(got, fa.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("window", [0, 4096])
def test_kernel_at_gemma2_training_shape(cuda, window):
    q, k, v = _inputs(cuda, torch.bfloat16, 2, 1024, 1024, 8, 4, 256, 1)
    kw = dict(causal=True, window=window, logit_softcap=50.0)
    _assert_agree(fa.flash_attention(q, k, v, **kw),
                  fa.flash_attention_plain(q, k, v, **kw), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("Sq", [1, 130, 1024])
@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (True, 50.0),
                                            (False, 0.0)])
def test_kernel_over_a_long_windowed_kv(cuda, dtype, D, Sq, causal, softcap):
    q, k, v = _inputs(cuda, dtype, 2, Sq, 1024, 8, 4, D, Sq + D)
    kw = dict(causal=causal, window=200, logit_softcap=softcap)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_agree(got, fa.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap", [
    (2, 1024, 8, 4, 256, 0, 50.0),      # gemma2-2b global layer
    (2, 1024, 8, 4, 256, 4096, 50.0),   # its local layer
    (1, 8192, 8, 4, 256, 4096, 50.0),   # its local layer at S 8192
    (1, 2048, 32, 8, 128, 0, 0.0)])     # llama3-8b
def test_kernel_at_the_model_shapes(cuda, dtype, B, S, Hq, Hkv, D, window,
                                    softcap):
    q, k, v = _inputs(cuda, dtype, B, S, S, Hq, Hkv, D, S + D)
    kw = dict(causal=True, window=window, logit_softcap=softcap)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_agree(got, fa.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [8, 16, 40, 48, 80, 96, 120, 136, 200, 248])
@pytest.mark.parametrize("Sq,extra", [(1, 64), (200, 64)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 48, 50.0), (False, 0, 50.0)])
def test_padded_head_dims_match_plain(cuda, dtype, D, Sq, extra, causal,
                                      window, softcap):
    q, k, v = _inputs(cuda, dtype, 2, Sq, Sq + extra, 8, 4, D, D)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_agree(got, fa.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (2, 1024, 32, 32, 80, 0),           # zamba2-2.7b's shared attention
    (1, 2048, 32, 8, 120, 4096)])       # h2o-danube-3-4b
def test_kernel_at_the_padded_model_shapes(cuda, dtype, B, S, Hq, Hkv, D,
                                           window):
    q, k, v = _inputs(cuda, dtype, B, S, S, Hq, Hkv, D, S + D)
    kw = dict(causal=True, window=window)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_agree(got, fa.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_f32_kernel_takes_4_byte_aligned_tensors(cuda, which):
    q, k, v = _inputs(cuda, torch.float32, 2, 130, 200, 8, 4, 64, 3)
    t = dict(q=q, k=k, v=v)
    buf = torch.empty(t[which].numel() + 1, device=cuda)
    view = buf[1:].view(t[which].shape)
    view.copy_(t[which])
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    kw = dict(causal=True, window=48, logit_softcap=50.0)
    got = fa.flash_attention(*(view if n == which else t[n]
                               for n in ("q", "k", "v")), **kw)
    torch.cuda.synchronize()
    _assert_agree(got, fa.flash_attention_plain(q, k, v, **kw),
                  torch.float32)


def test_f32_call_is_the_split_and_the_attention_launch(cuda):
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _inputs(cuda, torch.float32, 2, 200, 264, 8, 4, 128)
    fa.flash_attention(q, k, v)    # built and loaded
    torch.cuda.synchronize()
    before = fa.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert fa.launches == before + 1
    assert len(names) == 2, names
    assert "split_kv_kernel" in names[0] and "flash_f32_kernel<128>" in names[1]


# sha256 of the bf16 output's bits from the build before the f32 redesign
# (the parent commit of that change, on an H100 80GB HBM3, CUDA 12.8), on
# _numpy_inputs(seed = D) with (B, Sq, Skv, Hq, Hkv) = (2, 200, 264, 8, 4)
BF16_DIGESTS = {
    (32, True, 0, 0.0):
        "a3f86176bfa924f78ae6e7f4407fcf440d1b42d511cb64f00e2a176dc40ad1a3",
    (64, True, 48, 50.0):
        "ecca159152148d7b9a37d9ed2aae9f4849d2769c564ded0707890e8193a898d5",
    (128, False, 0, 50.0):
        "704b88ed916f191fe3b6272ec424feac4c6edfacd482c067a25b32fcdfc699c6",
    (256, True, 48, 50.0):
        "a8b4cbb2a494530b19f2facb61b28b5ced98189bc649e9d4ae05ae70f7acea0b",
    (256, True, 0, 0.0):
        "fa241fb0982eb62e681d151ead369c3e69528d9d951253c42c50779d470e0df9",
}


def _numpy_inputs(dev, dtype, B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, H, D),
                                                 dtype=np.float32)).to(
        dev).to(dtype) for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


def bf16_digest(out):
    import hashlib
    return hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()


@pytest.mark.parametrize("D,causal,window,softcap", list(BF16_DIGESTS))
def test_bf16_outputs_bitwise_the_earlier_build(cuda, D, causal, window,
                                                softcap):
    q, k, v = _numpy_inputs(cuda, torch.bfloat16, 2, 200, 264, 8, 4, D, D)
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             logit_softcap=softcap)
    assert bf16_digest(out) == BF16_DIGESTS[(D, causal, window, softcap)]


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_wrapper_raises_on_a_misaligned_bf16_tensor(cuda, which):
    q, k, v = _inputs(cuda, torch.bfloat16, 1, 64, 64, 4, 2, 64)
    t = dict(q=q, k=k, v=v)
    buf = torch.empty(t[which].numel() + 1, dtype=torch.bfloat16,
                      device=cuda)
    view = buf[1:1 + t[which].numel()].view(t[which].shape)
    view.copy_(t[which])
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    t[which] = view
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(t["q"], t["k"], t["v"])
    assert fa.launches == before


def test_attention_forward_is_the_kernel_and_backward_the_ref(cuda):
    q, k, v = (t.requires_grad_() for t in _inputs(
        cuda, torch.bfloat16, 2, 128, 128, 8, 4, 64, 2))
    kw = dict(causal=True, window=48, logit_softcap=50.0)
    before = fa.launches
    out = fa.attention(q, k, v, True, 48, 50.0)
    assert fa.launches == before + 1
    assert torch.equal(out, fa.flash_attention(q.detach(), k.detach(),
                                               v.detach(), **kw))
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(attention_ref(q, k, v, **kw), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_raises_on_a_non_contiguous_cuda_tensor(cuda):
    q, k, v = _inputs(cuda, torch.float32, 1, 64, 64, 4, 2, 32)
    before = fa.launches
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    assert fa.launches == before
