"""The arithmetic of the split paged-decode kernel, on the CPU.

``csrc/paged_attn.cu`` splits each request's pages over blocks: split s
takes pages ``[s * pps, (s + 1) * pps)`` (``pps`` from
``paged_attn.split_pages``), clips them to the valid positions, and its four
warps each run an online softmax over their own row groups, a batch of four
groups at a time; the block merges its warps, writes the split's (m, l, acc)
and a second launch merges the splits.  The kernel runs only on the card,
so :func:`split_model` below repeats that arithmetic in torch, position for
position, and is held against the reference's Pallas kernel in interpret
mode and against the port's plain version on the same seeded numpy inputs,
at the split sizes the wrapper chooses and at others.

Tolerance: 1e-5 absolute and relative in f32 (the three sum the same f32
terms in different orders), as ``tests/test_torch_paged_attn.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attn import paged_decode_attention as jax_paged  # noqa: E402
from repro_torch.kernels import paged_attn  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

WARPS, BATCH, LANE_ELEMS = 4, 4, 8   # kWarps, kBatch, kE in the kernel
NEG_INF = -1e30


def split_model(q, pk, pv, pt, ln, *, window, softcap, pps):
    """The kernel's arithmetic in f32: (B, Hq, D)."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = pk.shape
    n = pt.shape[1]
    g = Hq // Hkv
    lanes = D // LANE_ELEMS
    R = 32 // (1 << (max(lanes, 4) - 1).bit_length())   # rows a warp load
    S = -(-n // pps)
    qs = q.float() * D ** -0.5
    out = torch.empty(B, Hq, D)
    for b in range(B):
        L = int(ln[b])
        heads = torch.arange(Hq)
        parts = []                                   # (m, l, acc) a split
        for s in range(S):
            start = max(s * pps * ps, max(0, L - window) if window else 0)
            end = min(min(s * pps + pps, n) * ps, L)
            groups = -(-(end - start) // R) if end > start else 0
            warps = []
            for w in range(WARPS):
                m = torch.full((Hq,), NEG_INF)
                l, acc = torch.zeros(Hq), torch.zeros(Hq, D)
                for rg in range(w, groups, WARPS * BATCH):
                    pos = [start + (rg + u * WARPS) * R + r
                           for u in range(BATCH) for r in range(R)]
                    pos = torch.tensor([p for p in pos if p < end],
                                       dtype=torch.long)
                    if not len(pos):
                        continue
                    page = pt[b, pos // ps].long()
                    k = pk[page, pos % ps].float()[:, heads // g]  # (rows, Hq, D)
                    v = pv[page, pos % ps].float()[:, heads // g]
                    sc = torch.einsum("hd,rhd->hr", qs[b], k)
                    if softcap:
                        sc = torch.tanh(sc / softcap) * softcap
                    m_new = torch.maximum(m, sc.max(1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + torch.einsum("hr,rhd->hd", p, v)
                    m = m_new
                warps.append((m, l, acc))
            M = torch.stack([w[0] for w in warps]).max(0).values
            c = [torch.exp(w[0] - M) for w in warps]
            parts.append((M, sum(ci * w[1] for ci, w in zip(c, warps)),
                          sum(ci[:, None] * w[2] for ci, w in zip(c, warps))))
        M = torch.stack([p[0] for p in parts]).max(0).values
        wt = [torch.exp(p[0] - M) for p in parts]
        lsum = sum(w * p[1] for w, p in zip(wt, parts))
        acc = sum(w[:, None] * p[2] for w, p in zip(wt, parts))
        out[b] = acc / torch.clamp(lsum, min=1e-30)[:, None]
    return out


def _inputs(seed, B, n, ps, Hq, Hkv, D, lengths):
    rng = np.random.default_rng(seed)
    P = 1 + B * n + 3
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    pk = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pv = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pt = (rng.permutation(P - 1)[:B * n].reshape(B, n) + 1).astype(np.int32)
    return q, pk, pv, pt, np.asarray(lengths, np.int32)


def _pallas(q, pk, pv, pt, ln, **kw):
    return np.asarray(jax_paged(*(jnp.asarray(a) for a in (q, pk, pv, pt, ln)),
                                interpret=True, **kw))


def _plain(q, pk, pv, pt, ln, **kw):
    return paged_attn.paged_decode_attention_plain(
        *(torch.tensor(a) for a in (q, pk, pv, pt, ln)), **kw).numpy()


def _model(q, pk, pv, pt, ln, pps, **kw):
    return split_model(*(torch.tensor(a) for a in (q, pk, pv, pt, ln)),
                       window=kw["window"], softcap=kw["logit_softcap"],
                       pps=pps).numpy()


# B 4, Hq 8, Hkv 2, D 64, 80 pages of 4: the wrapper picks 2 pages (8
# positions) a split, 40 splits.  Lengths: one token, the end of split 7
# (56), inside split 8 (61), the whole table (320).
SHAPE = dict(B=4, n=80, ps=4, Hq=8, Hkv=2, D=64)
LENGTHS = [1, 56, 61, 320]


def test_wrapper_split_sizes():
    assert paged_attn.split_pages(4, 2, 4, 80) == 2
    # llama3-8b serving: 4 slots of 34 pages -> 17 splits of 2, 544 blocks
    assert paged_attn.split_pages(4, 8, 4, 34) == 2
    # the long context of chip_smoke.py's phase 1: 4 x 4096 positions
    assert paged_attn.split_pages(4, 8, 4, 256) == 16
    # gemma2's heads (8 query, 4 kv) at the serving table: 17 splits of 2
    assert paged_attn.split_pages(4, 4, 2, 34) == 2
    # more (request, kv head) pairs than blocks wanted: one split a request
    assert paged_attn.split_pages(80, 8, 4, 34) == 34
    # more than 8 query heads a kv head: head groups count as blocks
    assert paged_attn.split_pages(4, 8, 16, 34) == 4
    for B in (1, 3, 64, 600):
        for n in (1, 2, 17, 34, 1000):
            pps = paged_attn.split_pages(B, 8, 4, n)
            assert 1 <= pps <= n and -(-n // pps) <= 65535


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 50.0), (5, 0.0),
                                            (13, 50.0)])
def test_split_model_at_the_wrappers_split_matches_pallas_and_plain(
        window, softcap):
    """window 5 and 13 leave every split but the last one or two of each
    request empty."""
    q, pk, pv, pt, ln = _inputs(window + int(softcap), lengths=LENGTHS,
                                **SHAPE)
    pps = paged_attn.split_pages(SHAPE["B"], SHAPE["Hkv"],
                                 SHAPE["Hq"] // SHAPE["Hkv"], SHAPE["n"])
    kw = dict(window=window, logit_softcap=softcap)
    got = _model(q, pk, pv, pt, ln, pps, **kw)
    np.testing.assert_allclose(got, _pallas(q, pk, pv, pt, ln, **kw),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _plain(q, pk, pv, pt, ln, **kw),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pps", [1, 3, 7, 80])
@pytest.mark.parametrize("window", [0, 9])
def test_split_model_at_other_splits_matches_plain(pps, window):
    """Split sizes the wrapper picks at other shapes: 1 (every page its own
    split), 3 and 7 (splits that do not divide the table) and the whole
    table in one split."""
    q, pk, pv, pt, ln = _inputs(pps * 10 + window, lengths=LENGTHS, **SHAPE)
    kw = dict(window=window, logit_softcap=0.0)
    np.testing.assert_allclose(_model(q, pk, pv, pt, ln, pps, **kw),
                               _plain(q, pk, pv, pt, ln, **kw),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Hq,Hkv,D", [(8, 8, 32), (8, 4, 96), (4, 2, 256)])
def test_split_model_at_other_head_shapes_matches_pallas(Hq, Hkv, D):
    """Rows per warp load 8 (D 32), 2 with 12 of 16 lanes busy (D 96) and
    1 (D 256, gemma2's head dim), GQA 1 and 2."""
    shape = dict(B=2, n=6, ps=4, Hq=Hq, Hkv=Hkv, D=D)
    q, pk, pv, pt, ln = _inputs(D, lengths=[9, 24], **shape)
    kw = dict(window=0, logit_softcap=0.0)
    np.testing.assert_allclose(_model(q, pk, pv, pt, ln, 2, **kw),
                               _pallas(q, pk, pv, pt, ln, **kw),
                               rtol=1e-5, atol=1e-5)
