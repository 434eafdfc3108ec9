"""The blocked GEMM of the port against the JAX package, on the CPU.

The port's wrapper (``blocked_matmul``, which computes its plain version for
CPU tensors) and the plain version itself are held against the reference's
Pallas kernel in interpret mode and against its ``matmul_ref`` oracle, on
the same numpy inputs; the autograd ``matmul``'s gradients against
``jax.grad`` of ``matmul_ref``.

Tolerances, the reference's own (``tests/test_kernels.py``): 1e-4 relative
and absolute for f32 inputs, 2e-2 for bf16 inputs (both sides widen the
same bf16 values exactly and sum f32 products, at most 1024 of them, in
different orders; the reference's bf16 kernel path keeps bf16 operands in
its dot).  Gradients: 1e-5 of the largest magnitude (f32 sums of at most
440 products).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.blocking import solve_gemm_blocking as jsolve  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.blocked_matmul import blocked_matmul as jax_mm  # noqa: E402
from repro_torch.core.blocking import (  # noqa: E402
    GemmBlocking,
    solve_gemm_blocking,
    solve_h100_gemm_blocking,
)
from repro_torch.kernels import blocked_matmul as kmm  # noqa: E402
from repro_torch.kernels.ref import matmul_ref  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

# (M, N, K) as tests/test_kernels.py lists them
REF_SHAPES = [(8, 128, 128), (128, 128, 128), (256, 512, 384),
              (64, 256, 1024)]
# shapes the reference's kernel asserts on: CD-DNN's K = 440 and N = 9304,
# small and odd extents
RAGGED = [(4, 2048, 440), (3, 9304, 64), (1, 130, 440), (5, 7, 3),
          (1, 1, 1), (130, 70, 200)]
TOL = {"f32": 1e-4, "bf16": 2e-2}


def _inputs(M, N, K, dt, seed):
    """numpy f32 inputs; for bf16 rounded to bf16 values first, so both
    packages see the same numbers."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    if dt == "bf16":
        a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        b = np.asarray(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32))
    return a, b


def _both(a, b, dt):
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    return (jnp.asarray(a, jdt), jnp.asarray(b, jdt),
            torch.tensor(a).to(tdt), torch.tensor(b).to(tdt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M,N,K", REF_SHAPES)
def test_wrapper_matches_reference_kernel(M, N, K, dt):
    ja, jb, ta, tb = _both(*_inputs(M, N, K, dt, seed=M + N + K), dt)
    want = jax_mm(ja, jb, interpret=True)
    before = kmm.launches
    got = kmm.blocked_matmul(ta, tb)
    assert kmm.launches == before          # the CPU computes the plain version
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL[dt],
                               atol=TOL[dt])


def test_plain_with_an_explicit_solver_blocking():
    """The reference's own explicit-blocking case: its solver's choice at a
    2 MiB budget, the same in both packages, drives both kernels' K slabs."""
    jblk = jsolve(256, 512, 384, vmem_bytes=2 * 2**20)
    blk = solve_gemm_blocking(256, 512, 384, vmem_bytes=2 * 2**20)
    assert (blk.bm, blk.bn, blk.bk) == (jblk.bm, jblk.bn, jblk.bk)
    ja, jb, ta, tb = _both(*_inputs(256, 512, 384, "f32", seed=1), "f32")
    want = jax_mm(ja, jb, blocking=jblk, interpret=True)
    got = kmm.blocked_matmul_plain(ta, tb, bk=blk.bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # that blocking has no kernel instance (bk = 128): the wrapper refuses it
    with pytest.raises(ValueError, match="no instance"):
        kmm.blocked_matmul(ta, tb, blocking=blk)


@pytest.mark.parametrize("tile", [(64, 64), (64, 128), (128, 64),
                                  (128, 128)])
def test_wrapper_with_each_kernel_tile(tile):
    M, N, K = 130, 200, 70
    a, b = _inputs(M, N, K, "f32", seed=7)
    blk = GemmBlocking(*tile, 8, 0, 0.0)
    got = kmm.blocked_matmul(torch.tensor(a), torch.tensor(b), blocking=blk)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.matmul_ref(a, b)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M,N,K", RAGGED)
def test_ragged_shapes_match_matmul_ref(M, N, K, dt):
    ja, jb, ta, tb = _both(*_inputs(M, N, K, dt, seed=K), dt)
    want = np.asarray(jref.matmul_ref(ja, jb))
    got = kmm.blocked_matmul(ta, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dt], atol=TOL[dt])
    np.testing.assert_allclose(matmul_ref(ta, tb).numpy(), want,
                               rtol=TOL[dt], atol=TOL[dt])


def test_reference_kernel_asserts_where_the_port_masks():
    """CD-DNN's first layer: the reference's tiles do not divide K = 440."""
    ja, jb, ta, tb = _both(*_inputs(8, 256, 440, "f32", seed=2), "f32")
    with pytest.raises(AssertionError):
        jax_mm(ja, jb, interpret=True)
    np.testing.assert_allclose(kmm.blocked_matmul(ta, tb).numpy(),
                               np.asarray(jref.matmul_ref(ja, jb)),
                               rtol=1e-4, atol=1e-4)


def test_kernel_tile_maps_the_solver_choice():
    # whole small extents run on the smallest tile, edges masked
    for shape in [(1, 9304, 2048), (3, 7, 5), (8, 128, 128), (1024, 2048, 1)]:
        blk = solve_h100_gemm_blocking(*shape)
        assert kmm.kernel_tile(blk, *shape)[2] == 8
    assert kmm.kernel_tile(GemmBlocking(1, 64, 8, 0, 0.0), 1, 64, 8) \
        == (64, 64, 8)
    for bad in [GemmBlocking(256, 128, 8, 0, 0.0),    # no 256 instance
                GemmBlocking(32, 128, 8, 0, 0.0),     # 32 is not the extent
                GemmBlocking(128, 128, 16, 0, 0.0)]:  # one K depth only
        with pytest.raises(ValueError, match="no instance"):
            kmm.kernel_tile(bad, 1024, 1024, 1024)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = torch.ones(4, 3), torch.ones(3, 5)
    with pytest.raises(TypeError):
        kmm.blocked_matmul(a.double(), b.double())
    with pytest.raises(TypeError):
        kmm.blocked_matmul(a, b.bfloat16())
    with pytest.raises(ValueError, match="differ in K"):
        kmm.blocked_matmul(a, torch.ones(4, 5))
    with pytest.raises(ValueError, match="contiguous"):
        kmm.blocked_matmul(torch.ones(3, 4).t(), b)
    with pytest.raises(ValueError):
        kmm.blocked_matmul(a[None], b)
    with pytest.raises(ValueError, match="empty"):
        kmm.blocked_matmul(torch.ones(0, 3), b)
    with pytest.raises(ValueError):
        kmm.blocked_matmul(a, b.to("meta"))


@pytest.mark.parametrize("M,N,K", [(8, 100, 440), (16, 33, 64)])
def test_matmul_grads_match_jax_grad(M, N, K):
    a, b = _inputs(M, N, K, "f32", seed=11)
    g = np.random.default_rng(12).standard_normal((M, N)).astype(np.float32)
    jga, jgb = jax.grad(lambda x, y: jnp.sum(jref.matmul_ref(x, y) * g),
                        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a).requires_grad_()
    tb = torch.tensor(b).requires_grad_()
    out = kmm.matmul(ta, tb)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jref.matmul_ref(a, b)),
                               rtol=1e-4, atol=1e-4)
    ga, gb = torch.autograd.grad((out * torch.tensor(g)).sum(), [ta, tb])
    for got, want in ((ga, jga), (gb, jgb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
