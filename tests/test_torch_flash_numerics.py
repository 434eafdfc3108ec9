"""The bf16 flash kernel's arithmetic, emulated on the CPU, against the plain
version.

The CUDA kernel (``csrc/flash_attention.cu``, bf16 instances) cannot run
here, but the order of its roundings can: it multiplies bf16 q and k on the
tensor cores and sums the exact products in f32, applies the scale to that
f32 score (the plain version scales f32 q before the product), works in
log2 units (``exp2`` of log2(e)-scaled scores), and rounds each tile's P
once to bf16 before P V, while l sums the unrounded f32 p.  ``_emulate``
repeats that over tiles of 64 keys in plain torch.  It is held to the
kernel's own tolerance on the card (``chip_smoke.py`` phase 12 and
``tests/test_torch_flash_attention_cuda.py``), unchanged: one bf16 ulp at
the largest magnitude of each (batch, head) slice of
``flash_attention_plain``'s output.  So a design whose roundings cannot
meet that tolerance fails here before it reaches the card.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

LOG2E = 1.4426950408889634
TILE = 64


def _emulate(q, k, v, causal, window, softcap):
    """The bf16 kernel's arithmetic in f32 torch ops (bf16 in, bf16 out)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    scale, log2e = f32(D ** -0.5), f32(LOG2E)
    c1 = scale / f32(softcap) if softcap > 0 else scale * log2e
    c2 = f32(softcap) * log2e
    qf = q.float().view(B, Sq, Hkv, Hq // Hkv, D)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(Sq) + (Skv - Sq)
    m = torch.full(qf.shape[:-1], fa.NEG_INF)
    lsum = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, Skv, TILE):
        kk = min(TILE, Skv - k0)
        x = torch.einsum("bqhgd,bkhd->bqhgk", qf, kf[:, k0:k0 + kk]) * c1
        if softcap > 0:
            x = torch.tanh(x) * c2
        k_pos = torch.arange(k0, k0 + kk)[None, :]
        keep = torch.ones(Sq, kk, dtype=torch.bool)
        if causal:
            keep &= k_pos <= q_pos[:, None]
        if window > 0:
            keep &= k_pos > q_pos[:, None] - window
        x = torch.where(keep[None, :, None, None, :], x, fa.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        lsum = lsum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.bfloat16().float(), vf[:, k0:k0 + kk])
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).bfloat16()


def _ulps(got, want):
    """Worst |got - want| in bf16 ulps at the largest |want| of each
    (batch, head) slice (chip_smoke.py's flash tolerance)."""
    g, w = got.float(), want.float()
    big = w.abs().amax(dim=(1, 3), keepdim=True)
    return ((g - w).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)).max().item()


def _check(seed, Sq, Skv, Hq, Hkv, D, causal, window, softcap):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, H, D),
                                                    dtype=np.float32)).bfloat16()
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    got = _emulate(q, k, v, causal, window, softcap)
    assert torch.isfinite(got.float()).all()
    r = _ulps(got, fa.flash_attention_plain(q, k, v, **kw))
    assert r <= 1.0, f"{r} ulps"


GRID = list(itertools.product((32, 64, 128, 256), (1, 2, 4),
                              ((True, 0), (True, 48), (False, 0), (False, 48)),
                              (0.0, 50.0)))


@pytest.mark.parametrize("D,g,mask,softcap", GRID)
def test_emulated_kernel_within_one_ulp_of_plain(D, g, mask, softcap):
    i = GRID.index((D, g, mask, softcap))
    Sq = (64, 130, 200, 256)[i % 4]          # a tile multiple, ragged, ...
    Skv = Sq + (0, 64)[(i // 4) % 2]         # right-aligned extra keys
    _check(i, Sq, Skv, 2 * g, 2, D, mask[0], mask[1], softcap)


@pytest.mark.parametrize("Hq,Hkv,D,window,softcap", [
    (8, 4, 256, 0, 50.0),      # gemma2-2b's global layer
    (8, 4, 256, 48, 50.0),     # its local layer, the window binding
    (8, 2, 128, 0, 0.0),       # llama3-8b's grouping
    (4, 4, 64, 48, 0.0)])
def test_emulated_kernel_at_s1024(Hq, Hkv, D, window, softcap):
    _check(D + window, 1024, 1024, Hq, Hkv, D, True, window, softcap)
