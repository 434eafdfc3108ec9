"""The f32 flash kernel's arithmetic, emulated on the CPU, against the plain
version.

The CUDA kernel (``csrc/flash_attention.cu``, ``flash_f32_kernel``) cannot
run here, but the order of its roundings can.  Every f32 operand x is split
into three bf16 pieces, x1 = rn_bf16(x), x2 = rn_bf16(x - x1) and x3 =
rn_bf16(x - x1 - x2); q after it is multiplied by the scale in f32, as
``flash_attention_plain`` does.  Each product a b is six products of
pieces, summed smallest first, a3 b1, a2 b2, a1 b3, a2 b1, a1 b2, a1 b1,
every k16 step of the depth (one wgmma each: its 16 exact products added to
the partial sum with one rounding, modelled to nearest and toward zero).
S's depth is summed 32 at a time into a fresh partial sum that is then
added (f32, to nearest) to the score; the scores go to log2 units (times
log2(e), or through the softcap's tanh), are masked to -1e30 and run the
online softmax over tiles of 32 keys; each tile's P is
split into pieces in turn, its P V summed into a fresh partial sum per
tile, and O = fma(O, alpha, partial); l sums the unrounded f32 p.
``_emulate`` repeats all of that in torch (f64 block sums, f32 sums).

It is held to the kernel's own gate on the card (``chip_smoke.py`` phase 12
and ``tests/test_torch_flash_attention_cuda.py``), unchanged: max |kernel -
plain| <= 2e-5 max |plain|, over a small feature grid and at gemma2-2b's
global and local layers and llama3-8b's at S 1024, heads cut to one.  On
sharp scores (q and k of scale 3, scores of scale 9 under the softcap of
50) three products (a1 b1, a1 b2, a2 b1) break the gate: that is why there
are six; and the promotion cuts the error of a sum that rounds toward zero
there by half or more.
"""
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

REL_TOL = 2e-5      # chip_smoke.py's FLASH_F32_TOL
LOG2E = 1.4426950408889634
KSTEP = 16          # depth of a bf16 wgmma
PROMOTE = 32        # S's depth between promotions (kPromoteSteps k16 steps)
# (piece of a, piece of b) of each product, in the kernel's order
SIX = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
THREE = ((1, 0), (0, 1), (0, 0))


def split3(x: torch.Tensor):
    """x (f32) as three bf16 pieces (held as f32): to nearest, each
    difference exact."""
    x1 = x.bfloat16().float()
    r = x - x1
    x2 = r.bfloat16().float()
    return x1, x2, (r - x2).bfloat16().float()


def _round(acc64: torch.Tensor, mode: str) -> torch.Tensor:
    """acc64 rounded to f32: to nearest ("rn") or toward zero ("rz")."""
    r = acc64.float()
    if mode == "rz":
        over = r.double().abs() > acc64.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _products(eq, a, b, prods, mode):
    """The product ``eq`` of pieces a and b over their last axis: k16 steps
    in order, the given products of pieces in each, one rounding a wgmma,
    into a fresh partial sum."""
    part = None
    for k0 in range(0, a[0].shape[-1], KSTEP):
        for i, j in prods:
            blk = torch.einsum(eq, a[i][..., k0:k0 + KSTEP].double(),
                               b[j][..., k0:k0 + KSTEP].double())
            part = _round(blk if part is None else part.double() + blk, mode)
    return part


def _emulate(q, k, v, causal, window, softcap, *, mode, prods=SIX,
             promote=True):
    """The f32 kernel's arithmetic on f32 (B, S, H, D) inputs."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    qs = (q * f32(D ** -0.5)).view(B, Sq, Hkv, Hq // Hkv, D)
    qp, kp, vp = split3(qs), split3(k), split3(v)
    # S: runs of PROMOTE of the depth, each a fresh partial sum
    run = PROMOTE if promote else D
    s = None
    for d0 in range(0, D, run):
        part = _products("bqhgd,bkhd->bqhgk",
                         [x[..., d0:d0 + run] for x in qp],
                         [x[..., d0:d0 + run] for x in kp], prods, mode)
        s = part if s is None else s + part
    if softcap > 0:
        x = torch.tanh(s * (f32(1.0) / f32(softcap))) * (f32(softcap)
                                                         * f32(LOG2E))
    else:
        x = s * f32(LOG2E)
    q_pos = torch.arange(Sq) + (Skv - Sq)
    k_pos = torch.arange(Skv)[None, :]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep &= k_pos <= q_pos[:, None]
    if window > 0:
        keep &= k_pos > q_pos[:, None] - window
    x = torch.where(keep[None, :, None, None, :], x, fa.NEG_INF)
    tk = 32                          # keys a tile (Tf::TK)
    m = torch.full(x.shape[:-1], fa.NEG_INF)
    lsum = torch.zeros_like(m)
    o = torch.zeros_like(qs)
    for t0 in range(0, Skv, tk):
        xt = x[..., t0:t0 + tk]
        m_new = torch.maximum(m, xt.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new[..., None])
        lsum = lsum * alpha + p.sum(-1)
        m = m_new
        vt = [piece[:, t0:t0 + tk].movedim(1, -1) for piece in vp]
        if promote:
            part = _products("bqhgk,bhdk->bqhgd", split3(p), vt, prods, mode)
            o = (o.double() * alpha[..., None].double() + part.double()).float()
        else:   # every wgmma adds to O itself, after the rescale
            o = o * alpha[..., None]
            for k0 in range(0, xt.shape[-1], KSTEP):
                for i, j in prods:
                    blk = torch.einsum(
                        "bqhgk,bhdk->bqhgd",
                        split3(p)[i][..., k0:k0 + KSTEP].double(),
                        vt[j][..., k0:k0 + KSTEP].double())
                    o = _round(o.double() + blk, mode)
    out = o / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D)


def _case(seed, B, Sq, Skv, Hq, Hkv, D, sigma=1.0):
    """Unit-normal q, k, v (q and k times ``sigma``), made with numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D),
                                                    dtype=np.float32))
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    return q * sigma, k * sigma, v


@functools.lru_cache(maxsize=None)
def _ratio(seed, shape, causal, window, softcap, sigma=1.0, **kw):
    """max |emulated - plain| over REL_TOL max |plain| (<= 1 passes);
    remembered, since two tests share the sharp-score case."""
    q, k, v = _case(seed, *shape, sigma=sigma)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    logit_softcap=softcap)
    got = _emulate(q, k, v, causal, window, softcap, **kw)
    assert torch.isfinite(got).all()
    return ((got - want).abs().max() / (REL_TOL * want.abs().max())).item()


GRID = list(itertools.product((32, 64, 128, 256),
                              ((True, 0), (True, 48), (False, 0), (False, 48)),
                              (0.0, 50.0)))


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("D,mask,softcap", GRID)
def test_emulated_f32_kernel_within_the_gate(D, mask, softcap, mode):
    i = GRID.index((D, mask, softcap))
    Sq = (1, 64, 130, 200)[i % 4]             # one row, a tile multiple, ragged
    Skv = Sq + (0, 64)[(i // 4) % 2]          # right-aligned extra keys
    r = _ratio(i, (2, Sq, Skv, 4, 2, D), mask[0], mask[1], softcap, mode=mode)
    print(f"D {D} Sq {Sq} Skv {Skv} {mask} softcap {softcap} ({mode}): "
          f"error / gate {r:.4f}")
    assert r <= 1.0


# the model layers at S 1024, heads cut to one (the grid has the GQA groups)
MODEL = {"gemma2-2b global": ((1, 1024, 1024, 1, 1, 256), 0, 50.0),
         "gemma2-2b local": ((1, 1024, 1024, 1, 1, 256), 4096, 50.0),
         "llama3-8b": ((1, 1024, 1024, 1, 1, 128), 0, 0.0)}


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("name", list(MODEL))
def test_emulated_f32_kernel_at_the_model_layers(name, mode):
    shape, window, softcap = MODEL[name]
    r = _ratio(1, shape, True, window, softcap, mode=mode)
    print(f"{name} {shape} ({mode}): error / gate {r:.4f}")
    assert r <= 1.0


@pytest.mark.parametrize("name", ["gemma2-2b global", "llama3-8b"])
def test_six_products_hold_the_gate_on_sharp_scores(name):
    shape, window, softcap = MODEL[name]
    r = _ratio(0, shape, True, window, softcap, sigma=3.0, mode="rz")
    print(f"{name}, q and k x 3, six products (rz): error / gate {r:.4f}")
    assert r <= 1.0


@pytest.mark.parametrize("name", ["gemma2-2b global", "llama3-8b"])
def test_three_products_break_the_gate_on_sharp_scores(name):
    shape, window, softcap = MODEL[name]
    r = _ratio(0, shape, True, window, softcap, sigma=3.0, mode="rn",
               prods=THREE)
    print(f"{name}, q and k x 3, three products: error / gate {r:.4f}")
    assert r > 1.0


@pytest.mark.parametrize("name", ["gemma2-2b global", "llama3-8b"])
def test_promotion_cuts_the_drift_of_a_sum_toward_zero(name):
    shape, window, softcap = MODEL[name]
    kw = dict(sigma=3.0, mode="rz")
    promoted = _ratio(0, shape, True, window, softcap, **kw)
    unpromoted = _ratio(0, shape, True, window, softcap, promote=False, **kw)
    print(f"{name}, q and k x 3 (rz): error / gate promoted {promoted:.4f}, "
          f"every wgmma into S and O {unpromoted:.4f}")
    assert promoted < unpromoted


def test_split_into_three_bf16_pieces():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32)) * 10.0 ** torch.arange(-3, 3).repeat(
        1667)[:10000].float()
    x1, x2, x3 = split3(x)
    for piece in (x1, x2, x3):
        assert torch.equal(piece, piece.bfloat16().float())
    # each difference is exact in f32, and three pieces keep x to 2^-24
    assert torch.equal((x - x1) - x2, (x.double() - x1 - x2).float())
    err = (x1.double() + x2 + x3 - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -24).all()
    assert torch.equal(split3(torch.tensor([1.0 + 2 ** -8]))[0],
                       torch.tensor([1.0]))   # a tie rounds to even
