"""Flash attention of the port against the JAX package, on the CPU.

The port's ``attention_ref`` is held against the reference's; the plain
version (``flash_attention_plain``) and the wrapper (``flash_attention``,
which computes the plain version for CPU tensors) against the reference's
Pallas kernel in interpret mode, at shapes its blocks divide, and against
``attention_ref`` at ragged shapes (which the reference's ``ops.attention``
sends to ``attention_ref``); the autograd ``attention``'s gradients against
``jax.grad`` of the reference's ``ops.attention``.  Inputs are numpy draws
from a seed, handed to both packages.

Tolerances:
- f32 outputs, 1e-5 of the largest magnitude: both sides compute the same
  f32 online softmax and sums of at most 256 products per output, in
  different orders (measured ~2e-7);
- bf16 outputs, one bf16 ulp at the largest magnitude of each (batch,
  head) slice: both sides widen the same bf16 values exactly, compute in
  f32 and round once, so they differ only where the f32 values straddle a
  rounding boundary;
- gradients, 1e-5 of the largest magnitude: f32 autograd of the same
  oracle on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

# (causal, window, softcap): every option alone and together
OPTIONS = [(True, 0, 0.0), (True, 64, 50.0), (False, 0, 50.0),
           (False, 64, 0.0)]
SEQS = [(128, 128), (256, 256), (128, 256)]      # (Sq, Skv)
KV_HEADS = [4, 2, 1]                             # Hq = 4: g = 1, 2, 4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, Sq, Skv, Hq, Hkv, D, dt, seed=0):
    """The same q, k, v for both packages: numpy f32 draws, rounded to
    bf16 once by JAX where asked and carried over as f32 values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    jdt, tdt = DTYPES[dt]
    jx = [jnp.asarray(a).astype(jdt) for a in arrs]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt)
          for a in jx]
    return jx, tx


def _close(got, want, dt):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        return
    # one bf16 ulp at the largest magnitude of each (b, h) slice
    big = np.abs(want).max(axis=(1, 3), keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("Sq,Skv,Hkv,causal,window,softcap", [
    (64, 64, 4, True, 0, 0.0), (100, 300, 2, True, 48, 50.0),
    (1, 77, 1, False, 0, 50.0), (37, 37, 2, False, 16, 0.0)])
def test_attention_ref_matches_reference(Sq, Skv, Hkv, causal, window,
                                         softcap, dt):
    jx, tx = _inputs(2, Sq, Skv, 4, Hkv, 32, dt, seed=1)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    got = attention_ref(*tx, **kw)
    assert got.dtype == tx[0].dtype
    _close(got, jref.attention_ref(*jx, **kw), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("opt", range(len(OPTIONS)))
@pytest.mark.parametrize("Hkv", KV_HEADS)
@pytest.mark.parametrize("Sq,Skv", SEQS)
def test_plain_and_wrapper_match_reference_kernel(Sq, Skv, Hkv, opt, dt):
    causal, window, softcap = OPTIONS[opt]
    D = (32, 64)[opt % 2]
    jx, tx = _inputs(2, Sq, Skv, 4, Hkv, D, dt, seed=opt)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    want = jflash(*jx, **kw, interpret=True)
    before = fa.launches
    _close(fa.flash_attention(*tx, **kw), want, dt)
    assert fa.launches == before         # the CPU path launches nothing
    # the reference's blocks, and the kernel's tiles at D = 256 and below
    for bq, bkv in ((128, 128), (64, 32), (64, 64)):
        _close(fa.flash_attention_plain(*tx, **kw, bq=bq, bkv=bkv), want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("Sq,Skv,Hkv,causal,window,softcap", [
    (1, 1, 4, True, 0, 0.0), (1, 77, 2, True, 48, 50.0),
    (37, 300, 1, True, 48, 0.0), (100, 100, 2, True, 0, 50.0),
    (200, 264, 4, False, 48, 50.0), (130, 130, 1, False, 0, 0.0)])
def test_ragged_shapes_match_attention_ref(Sq, Skv, Hkv, causal, window,
                                           softcap, dt):
    """Sq and Skv a multiple of no block: the reference's kernel asserts
    there and ``ops.attention`` falls back to ``attention_ref``; the port's
    kernel masks its ragged edges."""
    jx, tx = _inputs(2, Sq, Skv, 4, Hkv, 64, dt, seed=2)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    want = jref.attention_ref(*jx, **kw)
    _close(fa.flash_attention(*tx, **kw), want, dt)
    _close(fa.flash_attention_plain(*tx, **kw, bq=64, bkv=32), want, dt)


@pytest.mark.parametrize("bq,bkv", [(1, 16), (7, 13), (64, 32), (256, 256)])
@pytest.mark.parametrize("window", [0, 48])
def test_plain_is_independent_of_its_blocks(bq, bkv, window):
    """Skipped blocks and rows wholly masked inside a live block (a window
    row whose live keys start in a later block: weights exp(0) that the
    next live key's alpha of 0 wipes) leave the result as attention_ref's,
    whatever the blocks."""
    jx, tx = _inputs(1, 200, 200, 4, 2, 32, "f32", seed=3)
    kw = dict(causal=True, window=window, logit_softcap=50.0)
    _close(fa.flash_attention_plain(*tx, **kw, bq=bq, bkv=bkv),
           jref.attention_ref(*jx, **kw), "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D,Hq,Hkv,window", [
    (80, 4, 4, 0),        # zamba2-2.7b's shared attention (MHA)
    (120, 4, 1, 64)])     # h2o-danube-3-4b's (GQA, sliding window)
def test_head_dims_between_instances_match_reference_kernel(D, Hq, Hkv,
                                                            window, dt):
    """Head dims that no instance is compiled for, which the kernel runs on
    the next instance up (its columns past D zeros): the plain version and
    the wrapper against the reference's Pallas kernel, whose blocks span
    the whole of D."""
    jx, tx = _inputs(2, 128, 128, Hq, Hkv, D, dt, seed=D)
    kw = dict(causal=True, window=window, logit_softcap=50.0)
    want = jflash(*jx, **kw, interpret=True)
    _close(fa.flash_attention(*tx, **kw), want, dt)
    _close(fa.flash_attention_plain(*tx, **kw, bq=64, bkv=64), want, dt)


@pytest.mark.parametrize("D,inst", [(8, 32), (32, 32), (40, 64), (80, 128),
                                    (120, 128), (128, 128), (136, 256),
                                    (256, 256)])
def test_instance_dim_is_the_least_instance_that_holds_d(D, inst):
    assert fa.instance_dim(D) == inst


def test_explicit_scale():
    jx, tx = _inputs(1, 64, 64, 4, 4, 32, "f32", seed=4)
    _close(fa.flash_attention(*tx, scale=0.3),
           jref.attention_ref(*jx, scale=0.3), "f32")


@pytest.mark.parametrize("Sq,Skv,Hkv,causal,window,softcap", [
    (128, 128, 2, True, 0, 0.0), (128, 128, 4, True, 64, 50.0),
    (128, 256, 1, False, 0, 50.0), (100, 100, 2, True, 48, 0.0)])
def test_attention_gradients_match_reference_ops(Sq, Skv, Hkv, causal,
                                                 window, softcap):
    """The port's ``attention`` (kernel forward, ``attention_ref``'s
    gradient backward) against ``jax.grad`` through the reference's
    ``ops.attention`` (its ``custom_vjp``), as tests/test_kernels.py holds
    the reference's own."""
    jx, tx = _inputs(1, Sq, Skv, 4, Hkv, 32, "f32", seed=5)
    w = np.random.default_rng(6).standard_normal(
        (1, Sq, 4, 32)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jops.attention(q, k, v, causal, window, softcap) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*jx)
    tx = [t.requires_grad_() for t in tx]
    out = fa.attention(*tx, causal, window, softcap)
    got = torch.autograd.grad((out * torch.tensor(w)).sum(), tx)
    for g, r in zip(got, want):
        _close(g, r, "f32")


BAD = {
    "dtypes differ": lambda q, k, v: (q, k.bfloat16(), v),
    "float16": lambda q, k, v: (q.half(), k.half(), v.half()),
    "rank 3": lambda q, k, v: (q[0], k[0], v[0]),
    "Hq % Hkv": lambda q, k, v: (q[:, :, :3].contiguous(), k, v),
    "head_dim 44": lambda q, k, v: (q[..., :44].contiguous(),
                                    k[..., :44].contiguous(),
                                    v[..., :44].contiguous()),
    "head_dim 512": lambda q, k, v: (q.repeat(1, 1, 1, 8),
                                     k.repeat(1, 1, 1, 8),
                                     v.repeat(1, 1, 1, 8)),
    "k and v differ": lambda q, k, v: (q, k, v[:, :16].contiguous()),
    "batch differs": lambda q, k, v: (q, k[:1].contiguous(),
                                      v[:1].contiguous()),
    "causal Sq > Skv": lambda q, k, v: (q, k[:, :8].contiguous(),
                                        v[:, :8].contiguous()),
    "not contiguous": lambda q, k, v: (q.transpose(1, 2).contiguous()
                                       .transpose(1, 2), k, v),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    _, (q, k, v) = _inputs(2, 32, 32, 4, 2, 64, "f32")
    args = BAD[case](q, k, v)
    before = fa.launches
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(*args)
    assert fa.launches == before


def test_wrapper_rejects_bad_options_and_devices():
    _, (q, k, v) = _inputs(1, 16, 16, 4, 2, 32, "f32")
    with pytest.raises(ValueError, match=">= 0"):
        fa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match=">= 0"):
        fa.flash_attention(q, k, v, logit_softcap=-1.0)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*meta)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(q, k.to("meta"), v)


def test_compiled_instances_cover_the_registered_lms():
    from repro_torch.configs import ARCHS, ModelConfig, get_config
    from repro_torch.configs import smoke_variant
    lms = [a for a in ARCHS if isinstance(get_config(a), ModelConfig)]
    assert len(lms) == 11
    for arch in lms:
        for cfg in (get_config(arch), smoke_variant(get_config(arch))):
            assert fa.instance_dim(cfg.head_dim) in fa.HEAD_DIMS
            assert cfg.num_heads % cfg.num_kv_heads == 0

