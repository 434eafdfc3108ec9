"""The port's §3.4 ring (``repro_torch.kernels.ring``) against the JAX
package's Pallas ring kernels, run in interpret mode on the CPU as
``tests/test_kernels.py`` runs them.

On CPU tensors each wrapper computes its plain version, which repeats the
kernel's arithmetic; the same numpy inputs go through both packages.
Tolerances: the reduce-scatter and the hop add in the ring's order in the
input dtype, so f32 agrees bitwise; bf16 within one bf16 ulp (both round
each add to nearest even, but XLA may keep an intermediate in f32).  The
all-gather only moves data: exact.  The port's f32-summing oracle
(``kernels.ref.ring_reduce_scatter_ref``) is held to the reference's
oracle at the reference's tolerances (1e-5 f32, 5e-2 bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ring as jring  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402

GS = [1, 2, 3, 4, 8]
NS = [1, 3, 8, 40]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
AG_CASES = [(G, n, "f32") for G in GS for n in (1, 40)] \
    + [(G, 3, "bf16") for G in GS]
HOP_NS = [1, 24, 250]


def _inputs(shape, dt, seed):
    """The same values in both packages (rounded to bf16 once for bf16)."""
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(a, DTYPES[dt][0])
    return j, torch.tensor(np.asarray(j, np.float32)).to(DTYPES[dt][1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close_ulp(got, want, dt):
    g, w = _np(got), _np(want)
    if dt == "f32":
        np.testing.assert_array_equal(g, w)
        return
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1))) - 7)
    assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w) / ulp)


@pytest.fixture(scope="module")
def reference():
    """Every reference result of this module, computed once: the Pallas
    kernels in interpret mode and the jnp oracles."""
    out = {}
    for G in GS:
        for n in NS:
            for dt in DTYPES:
                j, _ = _inputs((G, G * n), dt, seed=G * 100 + n)
                out["rs", G, n, dt] = (
                    _np(jring.ring_reduce_scatter(j, interpret=True)),
                    _np(jref.ring_reduce_scatter_ref(j)))
    for G, n, dt in AG_CASES:
        j, _ = _inputs((G, n), dt, seed=G * 10 + n)
        out["ag", G, n, dt] = (_np(jring.ring_all_gather(j, interpret=True)),
                               _np(jref.ring_all_gather_ref(j)))
    for n in HOP_NS:
        for dt in DTYPES:
            chunks, _ = _inputs((4, n), dt, seed=n)
            recv, _ = _inputs((n,), dt, seed=n + 1)
            out["hop", n, dt] = [
                _np(jring.ring_hop_accum(chunks, recv, jnp.int32(c),
                                         interpret=True)) for c in range(4)]
    return out


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("G", GS)
def test_reduce_scatter_matches_reference_kernel(reference, G, n, dt):
    _, x = _inputs((G, G * n), dt, seed=G * 100 + n)
    kring.reset_launches()
    got = kring.ring_reduce_scatter(x)
    assert got.shape == (G, n) and got.dtype == DTYPES[dt][1]
    assert torch.equal(got, kring.ring_reduce_scatter_plain(x))
    want, want_ref = reference["rs", G, n, dt]
    _assert_close_ulp(got, want, dt)
    tol = 1e-5 if dt == "f32" else 5e-2
    np.testing.assert_allclose(_np(ref.ring_reduce_scatter_ref(x)), want_ref,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), want_ref, rtol=tol, atol=tol)
    assert kring.launches == dict.fromkeys(kring.launches, 0)


@pytest.mark.parametrize("G,n,dt", AG_CASES)
def test_all_gather_matches_reference_kernel(reference, G, n, dt):
    _, x = _inputs((G, n), dt, seed=G * 10 + n)
    kring.reset_launches()
    got = kring.ring_all_gather(x)
    want, want_ref = reference["ag", G, n, dt]
    assert got.shape == (G, G * n)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(ref.ring_all_gather_ref(x)), want_ref)
    assert kring.launches == dict.fromkeys(kring.launches, 0)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", HOP_NS)
def test_hop_accum_matches_reference_kernel(reference, n, dt):
    _, chunks = _inputs((4, n), dt, seed=n)
    _, recv = _inputs((n,), dt, seed=n + 1)
    kring.reset_launches()
    for c in range(4):
        got = kring.ring_hop_accum(chunks, recv, c)
        as_tensor = kring.ring_hop_accum(
            chunks, recv, torch.tensor([c], dtype=torch.int32))
        assert torch.equal(got, as_tensor)
        assert torch.equal(got, recv + chunks[c])
        _assert_close_ulp(got, reference["hop", n, dt][c], dt)
    assert kring.launches == dict.fromkeys(kring.launches, 0)


def test_ragged_buffer_and_bad_arguments_raise():
    with pytest.raises(ValueError):
        kring.ring_reduce_scatter(torch.zeros(3, 10))
    with pytest.raises(TypeError):
        kring.ring_all_gather(torch.zeros(2, 4, dtype=torch.float16))
    with pytest.raises(ValueError):
        kring.ring_hop_accum(torch.zeros(4, 8), torch.zeros(8), 4)
    with pytest.raises(ValueError):
        kring.ring_hop_accum(torch.zeros(4, 8), torch.zeros(7), 0)


@pytest.mark.parametrize("dt", DTYPES)
def test_stride0_members_equal_a_copy(dt):
    """One buffer viewed G times (the zero1 path's replicated gradient)
    reduces like its materialised copy."""
    _, row = _inputs((4 * 250,), dt, seed=7)
    view = row.expand(4, -1)
    assert view.stride(0) == 0
    assert torch.equal(kring.ring_reduce_scatter(view),
                       kring.ring_reduce_scatter(view.contiguous()))


@pytest.mark.parametrize("G", [2, 4, 8])
def test_round_trip_is_the_all_reduce(G):
    _, x = _inputs((G, G * 16), "f32", seed=G)
    full = kring.ring_all_gather(kring.ring_reduce_scatter(x))
    torch.testing.assert_close(full, x.sum(0).expand(G, -1), rtol=1e-5,
                               atol=1e-5)
