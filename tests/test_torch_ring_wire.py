"""The port's compressed wire formats (``repro_torch.kernels.ring``'s
``int8_quantize``, ``ring_hop_int8``, ``ring_hop_topk`` and the
``kernels.ref`` oracles) against the JAX package's: its Pallas kernels run in
interpret mode on the CPU, as ``tests/test_wire_formats.py`` runs them, and
its jnp oracles.

On CPU tensors each wrapper computes its plain version; the same numpy
inputs go through both packages.  Tolerances:
- against the reference's eager oracles: bitwise (``q``, the scale, the
  dense top-k sums, the selections);
- against the reference under ``jit`` (its interpret-mode kernels and its
  jitted oracle), whose XLA on the CPU rewrites ``max|x| / 127`` into a
  product with a rounded reciprocal, which the port does not (it divides,
  as the eager oracle does): ``int8_quantize``'s scale within one f32 ulp,
  and ``q`` within +-1 only where the scale differs (bitwise where it
  agrees).  In ``ring_hop_int8`` XLA also contracts ``q * s + chunk`` into
  one fused multiply-add, which skips the product's rounding, at most half
  an ulp of ``127 * s_in``: there the scale is within that over 127 plus
  two ulps, and ``q`` within +-1;
- top-k hops against the interpret-mode kernel: bitwise.
The member-batched forms equal a loop of the per-member forms bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm.backends.pallas_ring import topk_chunk_k as jtopk_chunk_k  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ring as jring  # noqa: E402
from repro_torch.comm.backends.ring import _topk_select, topk_chunk_k  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402

NS = [1, 3, 250, 1000]
G_HOP = 4
TOPK = [(250, 1), (250, 13), (1000, 50)]      # (n, k)
MEMBER_GS = [2, 3, 4, 8]


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _message(n, seed):
    """A received int8 message: the reference oracle's quantization."""
    q, s = jref.int8_quantize_ref(jnp.asarray(_x(n, seed)))
    return np.asarray(q), np.asarray(s)


@pytest.fixture(scope="module")
def reference():
    """Every reference result of this module, computed once."""
    out = {}
    jit_quant = jax.jit(jref.int8_quantize_ref)
    for n in NS:
        x = jnp.asarray(_x(n, seed=n, scale=10.0))
        out["q", n] = [tuple(map(np.asarray, r)) for r in (
            jref.int8_quantize_ref(x), jring.int8_quantize(x, interpret=True),
            jit_quant(x))]
        chunks = jnp.asarray(_x((G_HOP, n), seed=n + 1))
        q, s = _message(n, seed=n + 2)
        out["hop", n] = [
            [tuple(map(np.asarray, r)) for r in (
                jref.ring_hop_int8_ref(chunks, q, s, c),
                jring.ring_hop_int8(chunks, q, s, jnp.int32(c),
                                    interpret=True))]
            for c in range(G_HOP)]
    for n, k in TOPK:
        chunks = jnp.asarray(_x((G_HOP, n), seed=n + k))
        vals, idx = jref.topk_select_ref(jnp.asarray(_x(n, seed=k)), k)
        out["select", n, k] = (np.asarray(vals), np.asarray(idx))
        out["topk", n, k] = [
            (np.asarray(jref.ring_hop_topk_ref(chunks, vals, idx, c)),
             np.asarray(jring.ring_hop_topk(chunks, vals, idx, jnp.int32(c),
                                            interpret=True)))
            for c in range(G_HOP)]
        out["mask", n, k] = np.asarray(jref.topk_mask_ref(
            jnp.asarray(_x(n, seed=k + 7)), k))
    return out


def _assert_int8_bitwise(got, want):
    q, s = got
    assert q.dtype == torch.int8 and q.shape == want[0].shape
    assert s.dtype == torch.float32 and s.shape == (1,)
    np.testing.assert_array_equal(q.numpy(), want[0])
    np.testing.assert_array_equal(s.numpy(), want[1])


def _assert_int8_within_jit(got, want, s_in=None):
    """The stated tolerance against the reference under jit; ``s_in``: the
    scale of the message a hop received (None for int8_quantize)."""
    q, s = got[0].numpy().astype(np.int32), got[1].numpy()
    wq, ws = want[0].astype(np.int32), want[1]
    ulp = float(np.spacing(np.float32(ws[0])))
    if s_in is None:
        assert abs(float(s[0]) - float(ws[0])) <= ulp
        if s[0] == ws[0]:
            np.testing.assert_array_equal(q, wq)
    else:
        fma = 0.5 * float(np.spacing(np.float32(127 * float(s_in[0])))) / 127
        assert abs(float(s[0]) - float(ws[0])) <= fma + 2 * ulp
    assert np.abs(q - wq).max() <= 1


@pytest.mark.parametrize("n", NS)
def test_int8_quantize_matches_reference(reference, n):
    x = _t(_x(n, seed=n, scale=10.0))
    eager, kernel, jitted = reference["q", n]
    for got in (kring.int8_quantize(x), ref.int8_quantize_ref(x)):
        _assert_int8_bitwise(got, eager)
        _assert_int8_within_jit(got, kernel)
        _assert_int8_within_jit(got, jitted)


@pytest.mark.parametrize("n", NS)
def test_ring_hop_int8_matches_reference(reference, n):
    chunks = _t(_x((G_HOP, n), seed=n + 1))
    q, s = map(_t, _message(n, seed=n + 2))
    for c, (eager, kernel) in enumerate(reference["hop", n]):
        for got in (kring.ring_hop_int8(chunks, q, s, c),
                    kring.ring_hop_int8(chunks, q, s,
                                        torch.tensor([c], dtype=torch.int32)),
                    ref.ring_hop_int8_ref(chunks, q, s, c)):
            _assert_int8_bitwise(got, eager)
            _assert_int8_within_jit(got, kernel, s_in=s.numpy())


def test_int8_scale_is_true_division():
    """The scale is ``max|x| / 127`` rounded once, never the product with a
    rounded reciprocal, on random messages across magnitudes."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        x = (rng.normal(size=64) * 10 ** rng.uniform(-20, 20)).astype(
            np.float32)
        _, s = kring.int8_quantize(_t(x))
        assert s.item() == np.float32(np.abs(x).max()) / np.float32(127)


def test_int8_all_zero_message_and_half_to_even():
    q, s = kring.int8_quantize(torch.zeros(64))
    assert s.item() == 1.0 and not q.any()
    # s = 1 exactly: x / s lands on halves, which round to even as jnp.round
    x = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -127], np.float32)
    q, s = kring.int8_quantize(_t(x))
    assert s.item() == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, -127]
    want = jref.int8_quantize_ref(jnp.asarray(x))[0]
    np.testing.assert_array_equal(q.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", NS)
def test_int8_dequantize_matches_reference(n):
    q, s = _message(n, seed=n + 2)
    np.testing.assert_array_equal(
        ref.int8_dequantize_ref(_t(q), _t(s)).numpy(),
        np.asarray(jref.int8_dequantize_ref(jnp.asarray(q), jnp.asarray(s))))


@pytest.mark.parametrize("n,k", TOPK)
def test_ring_hop_topk_matches_reference(reference, n, k):
    chunks = _t(_x((G_HOP, n), seed=n + k))
    vals, idx = map(_t, reference["select", n, k])
    for c, (eager, kernel) in enumerate(reference["topk", n, k]):
        for got in (kring.ring_hop_topk(chunks, vals, idx, c),
                    kring.ring_hop_topk(chunks, vals, idx,
                                        torch.tensor([c], dtype=torch.int32)),
                    ref.ring_hop_topk_ref(chunks, vals, idx, c)):
            assert got.dtype == torch.float32 and got.shape == (n,)
            np.testing.assert_array_equal(got.numpy(), eager)
            np.testing.assert_array_equal(got.numpy(), kernel)


@pytest.mark.parametrize("n,k", TOPK)
def test_topk_select_and_mask_match_reference(reference, n, k):
    x = _t(_x(n, seed=k))
    for vals, idx in (ref.topk_select_ref(x, k), _topk_select(x, k)):
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(vals.numpy(), reference["select", n, k][0])
        np.testing.assert_array_equal(idx.numpy(), reference["select", n, k][1])
    np.testing.assert_array_equal(
        ref.topk_mask_ref(_t(_x(n, seed=k + 7)), k).numpy(),
        reference["mask", n, k])


def test_topk_ties_go_to_the_lower_index():
    """``lax.top_k``'s rule on ties, which ``torch.topk`` does not
    promise: equal magnitudes (either sign) are taken lowest index first."""
    x = np.zeros(64, np.float32)
    x[[3, 9, 17, 40, 41, 60]] = [2.0, -2.0, 2.0, 5.0, -2.0, 2.0]
    for k in (1, 2, 4, 6, 10):
        want_v, want_i = jref.topk_select_ref(jnp.asarray(x), k)
        got_v, got_i = ref.topk_select_ref(_t(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(
            ref.topk_mask_ref(_t(x), k).numpy(),
            np.asarray(jref.topk_mask_ref(jnp.asarray(x), k)))


def test_topk_scatter_matches_reference_with_duplicates():
    vals = _x(6, seed=3)
    idx = np.array([4, 0, 4, 9, 0, 4], np.int32)
    np.testing.assert_array_equal(
        ref.topk_scatter_ref(_t(vals), _t(idx), 10).numpy(),
        np.asarray(jref.topk_scatter_ref(jnp.asarray(vals), jnp.asarray(idx),
                                         10)))


@pytest.mark.parametrize("n,ratio,floor", [
    (100, 0.05, 1), (10, 0.25, 1), (10, 0.01, 1), (10, 0.01, 4), (3, 1.0, 1),
    (3, 1.0, 8), (25_690_112, 0.05, 1), (102_760_448, 0.05, 4)])
def test_topk_chunk_k_matches_reference(n, ratio, floor):
    assert topk_chunk_k(n, ratio, floor) == jtopk_chunk_k(n, ratio, floor)


@pytest.mark.parametrize("G", MEMBER_GS)
def test_member_batched_forms_equal_the_per_member_loop(G):
    """One hop of all G members at once equals G per-member hops, member m
    reading row (m - 1) % G and adding its chunk (m - 2 - step) % G; the
    member stride of the stack may be 0 (one buffer viewed G times)."""
    n = 37
    stacks = {"distinct": _t(_x((G, G * n), seed=G)),
              "stride0": _t(_x(G * n, seed=G + 1)).expand(G, G * n)}
    for name, st in stacks.items():
        ch = [st[m].view(G, n) for m in range(G)]
        q, s = kring.int8_quantize_members(st)
        msgs = [kring.int8_quantize(ch[m][(m - 1) % G]) for m in range(G)]
        for step in range(G):
            for m in range(G):
                assert torch.equal(q[m], msgs[m][0]), (name, step, m)
                assert torch.equal(s[m:m + 1], msgs[m][1]), (name, step, m)
            if step == G - 1:
                break
            q, s = kring.ring_hop_int8_members(st, q, s, step)
            msgs = [kring.ring_hop_int8(ch[m], *msgs[(m - 1) % G],
                                        (m - 2 - step) % G) for m in range(G)]
        sel = [ref.topk_select_ref(ch[m][(m - 1) % G], 5) for m in range(G)]
        vals, idx = _topk_select(kring.member_chunks(st, -1), 5)
        for step in range(G - 1):
            dense = kring.ring_hop_topk_members(st, vals, idx, step)
            want = [kring.ring_hop_topk(ch[m], *sel[(m - 1) % G],
                                        (m - 2 - step) % G) for m in range(G)]
            assert torch.equal(dense, torch.stack(want)), (name, step)
            vals, idx = _topk_select(dense, 5)
            sel = [ref.topk_select_ref(d, 5) for d in want]


def test_int8_ring_error_is_within_the_quanta():
    """The member-batched int8 ring's strips: within G - 1 quanta (half a
    largest scale per rounding) of the exact sum."""
    G, n = 4, 500
    st = _t(_x((G, G * n), seed=11))
    q, s = kring.int8_quantize_members(st)
    scales = [s.max().item()]
    for step in range(G - 1):
        q, s = kring.ring_hop_int8_members(st, q, s, step)
        scales.append(s.max().item())
    err = (q.float() * s[:, None] - st.view(G, G, n).sum(0)).abs().max()
    assert err.item() <= 0.5 * sum(scales)


def test_wire_wrappers_raise_on_what_they_do_not_take():
    chunks = torch.zeros(4, 8)
    q, s = torch.zeros(8, dtype=torch.int8), torch.ones(1)
    with pytest.raises(TypeError):
        kring.int8_quantize(torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        kring.int8_quantize(torch.zeros(0))
    with pytest.raises(TypeError):
        kring.ring_hop_int8(chunks, q.float(), s, 0)
    with pytest.raises(ValueError):
        kring.ring_hop_int8(chunks, q[:7], s, 0)
    with pytest.raises(ValueError):
        kring.ring_hop_int8(chunks, q, s, 4)
    with pytest.raises(TypeError):
        kring.ring_hop_topk(chunks, torch.zeros(2),
                            torch.zeros(2, dtype=torch.int64), 0)
    with pytest.raises(ValueError):
        kring.ring_hop_topk(chunks, torch.zeros(2),
                            torch.zeros(3, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        kring.int8_quantize_members(torch.zeros(4, 10))
    with pytest.raises(ValueError):
        kring.ring_hop_int8_members(torch.zeros(4, 8),
                                    torch.zeros(4, 2, dtype=torch.int8),
                                    torch.ones(3), 0)
    with pytest.raises(ValueError):
        kring.ring_hop_topk_members(torch.zeros(4, 8), torch.zeros(3, 1),
                                    torch.zeros(3, 1, dtype=torch.int32), 0)
