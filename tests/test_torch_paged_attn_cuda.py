"""The Hopper paged-decode kernel against its plain version, on the card.

Runs only where there is an sm_90 GPU and nvcc (the kernel is CUDA C++ for
sm_90a, built at first use); elsewhere every test skips with the reason.
Run on the card with ``PYTHONPATH=src python -m pytest -m gpu tests``.

Shapes are the serving path's (llama3-8b: Hq 32, Hkv 8, D 128; page size
16; 34 pages per request) plus gemma2's heads (Hq 8, Hkv 4, D 256),
h2o-danube's (Hq 32, Hkv 8, D 120: 15 lanes a row), gemma-2b's MQA
(Hq 8, Hkv 1, D 256: eight query heads a block) and qwen2-moe's MHA (Hq 16,
Hkv 16, D 128: one query head a block).  The kernel splits each request's pages over blocks (``split_pages``); the split
tests put lengths on a split's edge and inside a split, let a window empty
whole splits, and run B * Hkv under and over the card's 132 SMs.
Tolerance: bf16 output, both sides compute in f32 and round once, in
different summation orders — one bf16 ulp at the largest magnitude of
each request's output (a one-token request returns a raw V row, a long one
an average of hundreds); f32 output — 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attn  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    return torch.device("cuda")


def _inputs(dev, dtype, B, Hq, Hkv, D, ps, n, lengths, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = 1 + B * n
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(dtype)
    pk = torch.randn(P, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    pv = torch.randn(P, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev)[:B * n] + 1
    pt = perm.reshape(B, n).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pk, pv, pt, ln


@pytest.mark.parametrize("Hq,Hkv,D", [(32, 8, 128), (8, 4, 256),
                                      (32, 8, 120), (8, 1, 256),
                                      (16, 16, 128)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 0.0), (0, 50.0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(cuda, Hq, Hkv, D, window, softcap, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    ps, n = 16, 34
    q, pk, pv, pt, ln = _inputs(cuda, dtype, 4, Hq, Hkv, D, ps, n,
                                [1, ps, 300, n * ps])
    kw = dict(window=window, logit_softcap=softcap)
    before = paged_attn.launches
    got = paged_attn.paged_decode_attention(q, pk, pv, pt, ln, **kw)
    torch.cuda.synchronize()
    assert paged_attn.launches == before + 1
    _check_close(got, paged_attn.paged_decode_attention_plain(
        q, pk, pv, pt, ln, **kw), dtype)


def _check_close(got, want, dtype):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    for b in range(want.shape[0]):   # per request: outputs differ in size
        if dtype == torch.bfloat16:
            tol = 2.0 ** (np.floor(np.log2(np.abs(want[b]).max())) - 7)
        else:
            tol = 1e-5
        np.testing.assert_allclose(got[b], want[b], rtol=0, atol=tol,
                                   err_msg=f"request {b}")


@pytest.mark.parametrize("B", [4, 24, 80])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 8, 128), (8, 4, 256),
                                      (8, 1, 256), (16, 16, 128)])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_kernel_at_split_edges(cuda, B, Hq, Hkv, D, window, dtype):
    """B * Hkv of 32 and 16 (B 4), 192 and 96 (B 24) and 640 and 320 (B 80,
    at least one split a page or one split a request)."""
    ps, n = 16, 34
    pps = paged_attn.split_pages(B, Hkv, Hq // Hkv, n)
    edge = pps * ps                       # positions a split
    choices = sorted({min(max(x, 1), n * ps) for x in (
        1, edge, edge + 1, 2 * edge - 3, n * ps - edge, n * ps - 5, n * ps)})
    lengths = [choices[b % len(choices)] for b in range(B)]
    q, pk, pv, pt, ln = _inputs(cuda, dtype, B, Hq, Hkv, D, ps, n, lengths,
                                seed=B + D + window)
    kw = dict(window=window, logit_softcap=0.0)
    before = paged_attn.launches
    got = paged_attn.paged_decode_attention(q, pk, pv, pt, ln, **kw)
    torch.cuda.synchronize()
    assert paged_attn.launches == before + 1
    _check_close(got, paged_attn.paged_decode_attention_plain(
        q, pk, pv, pt, ln, **kw), dtype)


def test_idle_slot_on_null_page(cuda):
    q, pk, pv, _, _ = _inputs(cuda, torch.bfloat16, 2, 32, 8, 128, 16, 3,
                              [1, 1])
    pt = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    ln = torch.ones(2, dtype=torch.int32, device=cuda)
    got = paged_attn.paged_decode_attention(q, pk, pv, pt, ln)
    want = pv[0, 0].repeat_interleave(4, dim=0)[None].expand(2, -1, -1)
    assert torch.equal(got, want)


def test_kernel_rejects_bad_inputs(cuda):
    q, pk, pv, pt, ln = _inputs(cuda, torch.bfloat16, 2, 32, 8, 128, 16, 3,
                                [1, 2])
    with pytest.raises(TypeError):
        paged_attn.paged_decode_attention(q.float(), pk, pv, pt, ln)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attn.paged_decode_attention(q.transpose(0, 1).contiguous()
                                          .transpose(0, 1), pk, pv, pt, ln)
    shifted = torch.empty(pk.numel() + 8, dtype=pk.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        paged_attn.paged_decode_attention(
            q, shifted[1:1 + pk.numel()].view(pk.shape), pv, pt, ln)
