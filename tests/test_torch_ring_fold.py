"""The order of additions that the ring's fold kernel (``csrc/ring.cu``)
implements, pinned on the CPU before the card sees it.

:func:`fold_model` repeats the kernel's arithmetic in torch: strip p of a
``(G, N)`` member stack is the left fold ``x[p+1, p] + x[p+2, p] + ... +
x[p, p]`` (members mod G, chunk p of each), each add taken in f32 and
rounded to the input dtype (nearest even, as ``__float2bfloat16_rn``); at a
member stride of 0 the kernel reads the one row once and folds it G times,
``((v + v) + v) + v``.  A hop is the fold of two rows, ``recv`` then chunk
``c``.

Tolerance: none.  The model must equal the port's step-by-step replay of
the ring (``ring_reduce_scatter_plain``, the card's oracle) bitwise, and the
JAX package's Pallas ``ring_reduce_scatter`` run in interpret mode (as
``tests/test_torch_ring.py`` runs it) bitwise, in f32 and in bf16: both
round every add once, in the same order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.kernels import ring as jring  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402

GS = [1, 2, 3, 4, 8]
NS = [1, 3, 250, 4099]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LAYOUTS = ["contiguous", "wide", "stride0"]


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One add of the kernel: in f32, rounded once to the input dtype."""
    return (a.float() + b.float()).to(a.dtype)


def fold_model(stacked: torch.Tensor) -> torch.Tensor:
    """The fold kernel's reduce-scatter, one strip at a time."""
    G, N = stacked.shape
    x = stacked.reshape(G, G, N // G)
    strips = []
    for p in range(G):
        if stacked.stride(0) == 0:      # one row, read once, folded G times
            v = x[0, p]
            acc = v
            for _ in range(G - 1):
                acc = _add(acc, v)
        else:
            acc = x[(p + 1) % G, p]
            for k in range(2, G + 1):
                acc = _add(acc, x[(p + k) % G, p])
        strips.append(acc)
    return torch.stack(strips)


def _values(G, n, dt, one_row, seed):
    """(G, G * n) values in both packages, rounded to bf16 once for bf16;
    every row the same where ``one_row``."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(1 if one_row else G, G * n)).astype(np.float32)
    a = np.broadcast_to(a, (G, G * n))
    j = jnp.asarray(a, DTYPES[dt][0])
    return j, torch.tensor(np.asarray(j, np.float32)).to(DTYPES[dt][1])


def _stack(t: torch.Tensor, layout: str) -> torch.Tensor:
    """The same values as a contiguous stack, with a wider member stride,
    or as row 0 viewed G times (member stride 0, the zero1 path's)."""
    G, N = t.shape
    if layout == "wide":
        wide = torch.full((G, N + 5), float("nan"), dtype=t.dtype)
        wide[:, :N] = t
        return wide[:, :N]
    if layout == "stride0":
        return t[0].as_strided((G, N), (0, 1))
    return t


def _seed(G, n, one_row):
    return G * 1000 + n * 2 + one_row


@pytest.fixture(scope="module")
def reference():
    """The reference's Pallas kernel in interpret mode on every case's
    values: distinct partials and one row repeated."""
    out = {}
    for G in GS:
        for n in NS:
            for dt in DTYPES:
                for one_row in (False, True):
                    j, _ = _values(G, n, dt, one_row, _seed(G, n, one_row))
                    out[G, n, dt, one_row] = np.asarray(
                        jring.ring_reduce_scatter(j, interpret=True),
                        np.float32)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("G", GS)
def test_fold_is_the_ring_order(reference, G, n, dt, layout):
    one_row = layout == "stride0"
    _, t = _values(G, n, dt, one_row, _seed(G, n, one_row))
    x = _stack(t, layout)
    assert (x.stride(0) == 0) == one_row and torch.equal(x, t)
    got = fold_model(x)
    assert got.shape == (G, n) and got.dtype == DTYPES[dt][1]
    assert torch.equal(got, kring.ring_reduce_scatter_plain(x))
    assert torch.equal(got, kring.ring_reduce_scatter(x))
    np.testing.assert_array_equal(got.float().numpy(),
                                  reference[G, n, dt, one_row])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_hop_is_the_fold_of_two_rows(n, dt):
    _, chunks = _values(4, n, dt, False, n)
    chunks = chunks[:, :n]
    _, recv = _values(1, n, dt, False, n + 1)
    for c in range(4):
        got = _add(recv[0], chunks[c])
        assert torch.equal(got, kring.ring_hop_accum_plain(chunks, recv[0], c))
        assert torch.equal(got, kring.ring_hop_accum(
            chunks, recv[0], torch.tensor([c], dtype=torch.int32)))


@settings(max_examples=12, deadline=None)
@given(G=st.integers(1, 6), n=st.integers(1, 40),
       dt=st.sampled_from(sorted(DTYPES)),
       layout=st.sampled_from(LAYOUTS), seed=st.integers(0, 2 ** 16))
def test_fold_is_the_ring_order_at_small_shapes(G, n, dt, layout, seed):
    one_row = layout == "stride0"
    j, t = _values(G, n, dt, one_row, seed)
    got = fold_model(_stack(t, layout))
    assert torch.equal(got, kring.ring_reduce_scatter_plain(_stack(t, layout)))
    want = np.asarray(jring.ring_reduce_scatter(j, interpret=True), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
