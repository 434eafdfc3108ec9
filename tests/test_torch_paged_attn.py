"""Paged-decode attention of the port against the JAX package, on the CPU.

The port's plain version (``paged_decode_attention_plain``, and the wrapper
that computes it for CPU tensors) is held against the reference's Pallas
kernel in interpret mode and against its jnp oracle, on the same numpy
inputs.  Tolerances: f32 inputs — 1e-5, the two sides sum the same f32
terms in different orders; bf16 inputs — one bf16 ulp at the output's
largest magnitude, since both compute in f32 and round once to bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_attn import paged_decode_attention as jax_paged  # noqa: E402
from repro_torch.kernels import paged_attn  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))


def _inputs(seed, B, n, ps, Hq, Hkv, D, lengths):
    rng = np.random.default_rng(seed)
    P = 1 + B * n + 3
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    pk = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pv = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    # each request's logical pages scattered over the pool, never page 0
    pt = (rng.permutation(P - 1)[:B * n].reshape(B, n) + 1).astype(np.int32)
    return q, pk, pv, pt, np.asarray(lengths, np.int32)


def _jax(fn, q, pk, pv, pt, ln, dtype, **kw):
    return np.asarray(fn(jnp.asarray(q, dtype), jnp.asarray(pk, dtype),
                         jnp.asarray(pv, dtype), jnp.asarray(pt),
                         jnp.asarray(ln), **kw), np.float32)


def _torch(fn, q, pk, pv, pt, ln, dtype, **kw):
    t = lambda a: torch.tensor(a).to(dtype)  # noqa: E731
    return fn(t(q), t(pk), t(pv), torch.tensor(pt), torch.tensor(ln),
              **kw).float().numpy()


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_plain_matches_pallas_interpret_and_oracle(g, window, softcap):
    B, n, ps, Hkv, D = 3, 4, 4, 2, 32
    # lengths: one token, a page boundary, the full table
    q, pk, pv, pt, ln = _inputs(g * 10 + window, B, n, ps, g * Hkv, Hkv, D,
                                [1, ps, n * ps])
    kw = dict(window=window, logit_softcap=softcap)
    got = _torch(paged_attn.paged_decode_attention_plain, q, pk, pv, pt, ln,
                 torch.float32, **kw)
    pallas = _jax(jax_paged, q, pk, pv, pt, ln, jnp.float32, interpret=True,
                  **kw)
    oracle = _jax(ref.paged_decode_attention_ref, q, pk, pv, pt, ln,
                  jnp.float32, **kw)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 50.0)])
def test_cpu_wrapper_bf16_matches_oracle(window, softcap):
    """The wrapper computes the plain version for CPU tensors, without
    counting a kernel launch; bf16 in, bf16 out."""
    q, pk, pv, pt, ln = _inputs(3, 4, 5, 4, 8, 2, 64, [1, 7, 8, 20])
    kw = dict(window=window, logit_softcap=softcap)
    before = paged_attn.launches
    got = _torch(paged_attn.paged_decode_attention, q, pk, pv, pt, ln,
                 torch.bfloat16, **kw)
    want = _jax(ref.paged_decode_attention_ref, q, pk, pv, pt, ln,
                jnp.bfloat16, **kw)
    assert paged_attn.launches == before
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 0.0), (5, 50.0)])
def test_plain_at_head_dim_120_matches_pallas_and_oracle(window, softcap):
    """h2o-danube-3-4b's heads: Hq 32, Hkv 8, D 120 (f32, 1e-5 as above)."""
    q, pk, pv, pt, ln = _inputs(12, 3, 5, 16, 32, 8, 120, [1, 16, 75])
    kw = dict(window=window, logit_softcap=softcap)
    got = _torch(paged_attn.paged_decode_attention_plain, q, pk, pv, pt, ln,
                 torch.float32, **kw)
    pallas = _jax(jax_paged, q, pk, pv, pt, ln, jnp.float32, interpret=True,
                  **kw)
    oracle = _jax(ref.paged_decode_attention_ref, q, pk, pv, pt, ln,
                  jnp.float32, **kw)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_length_one_on_null_page():
    """Idle serving slots attend one position on page 0."""
    q, pk, pv, _, _ = _inputs(5, 2, 3, 4, 4, 4, 32, [1, 1])
    pt = np.zeros((2, 3), np.int32)
    ln = np.ones((2,), np.int32)
    got = _torch(paged_attn.paged_decode_attention, q, pk, pv, pt, ln,
                 torch.float32)
    # softmax over one position: the output is that position's value row
    np.testing.assert_allclose(got, np.broadcast_to(pv[0, 0][None], got.shape),
                               rtol=1e-6, atol=1e-6)


def _good(**over):
    kw = dict(q=torch.zeros(2, 8, 32, dtype=torch.bfloat16),
              pages_k=torch.zeros(5, 4, 2, 32, dtype=torch.bfloat16),
              pages_v=torch.zeros(5, 4, 2, 32, dtype=torch.bfloat16),
              page_table=torch.zeros(2, 3, dtype=torch.int32),
              lengths=torch.ones(2, dtype=torch.int32),
              window=0, logit_softcap=0.0)
    kw.update(over)
    return kw


def test_kernel_checks_accept_serving_shapes():
    paged_attn._check(**_good())


@pytest.mark.parametrize("D", [8, 32, 64, 80, 120, 128, 192, 256])
def test_kernel_checks_accept_every_config_head_dim(D):
    """Every head_dim of the repo's configs (h2o-danube's 120 among them)
    and any other multiple of 8 up to 256."""
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    paged_attn._check(**_good(q=z(2, 8, D), pages_k=z(5, 4, 2, D),
                              pages_v=z(5, 4, 2, D)))


@pytest.mark.parametrize("over,err", [
    (dict(q=torch.zeros(2, 8, 32)), TypeError),                   # f32 vs bf16 pools
    (dict(lengths=torch.ones(2, dtype=torch.int64)), TypeError),
    (dict(q=torch.zeros(2, 7, 32, dtype=torch.bfloat16)), ValueError),   # Hq % Hkv
    (dict(q=torch.zeros(2, 8, 44, dtype=torch.bfloat16),        # D % 8
          pages_k=torch.zeros(5, 4, 2, 44, dtype=torch.bfloat16),
          pages_v=torch.zeros(5, 4, 2, 44, dtype=torch.bfloat16)), ValueError),
    (dict(q=torch.zeros(2, 8, 264, dtype=torch.bfloat16),       # D > 256
          pages_k=torch.zeros(5, 4, 2, 264, dtype=torch.bfloat16),
          pages_v=torch.zeros(5, 4, 2, 264, dtype=torch.bfloat16)), ValueError),
    (dict(page_table=torch.zeros(3, 2, dtype=torch.int32).t()), ValueError),
    (dict(window=-1), ValueError),
])
def test_kernel_checks_reject(over, err):
    with pytest.raises(err):
        paged_attn._check(**_good(**over))


def test_wrapper_rejects_other_devices():
    kw = _good()
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in kw.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attn.paged_decode_attention(**meta)
