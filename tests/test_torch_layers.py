"""Layers and the transformer forward of the port against the JAX package.

Same numpy inputs through both, on the CPU.  The layers take f32 inputs,
where both sides do the same f32 arithmetic in different orders: tolerance
1e-5.  ``forward`` runs as the model does, with bf16 activations and bf16
matmuls: the two frameworks round those at different places, and one
flipped bf16 ulp in the residual stream reaches every logit, so logits are
held to 4 bf16 ulps at their largest magnitude, and their mean difference
to half an ulp (a wrong algorithm misses both by far).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.sharding import ShardingCtx  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.core.sharding import ShardingCtx as TShardingCtx  # noqa: E402,E501
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
CTX = ShardingCtx()
TCTX = TShardingCtx()
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **over):
    """The reference's smoke config and the port's copy of it."""
    jc = jax_smoke(jax_get_config(arch))
    if over:
        jc = jc.replace(**over)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _params(jc, seed=0):
    jp = jt.init_params(jc, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps at want's largest magnitude: (max, mean)."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    d = np.abs(got - want) / ulp
    return d.max(), d.mean()


# ---------------------------------------------------------------------------
# configs, params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-2b"])
def test_configs_and_smoke_variant_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert dataclasses.asdict(smoke_variant(get_config(arch))) == \
        dataclasses.asdict(jax_smoke(jax_get_config(arch)))


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-2b"])
def test_init_params_tree_and_distributions(arch):
    jc, tc = _cfgs(arch)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    tp = tt.init_params(tc, seed=0, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x.numpy(), tp))[0]
    assert [(p, a.shape) for p, a in jleaves] == \
        [(p, a.shape) for p, a in tleaves]
    blk = tp["blocks"][0]
    assert not blk["attn"]["norm"].any() and not tp["final_norm"].any()
    assert abs(tp["embed"].std().item() - 0.02) < 0.002
    # stacked (R, in, out) weights: fan-in is shape[-2]
    wq = blk["attn"]["wq"]
    assert abs(wq.std().item() * np.sqrt(wq.shape[-2]) - 1.0) < 0.05
    again = tt.init_params(tc, seed=0, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


# ---------------------------------------------------------------------------
# layers, f32
# ---------------------------------------------------------------------------
def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(w), 1e-6).numpy(),
                               _np(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))),
                               **TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 600, size=(2, 7)).astype(np.int32)
    got = tl.apply_rope(_t(x), _t(pos), theta).numpy()
    want = _np(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # angles reach 600 rad: an f32 ulp of the angle is ~6e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Sq,Skv,chunk", [(24, 24, 8), (24, 24, 7), (6, 20, 4)])
@pytest.mark.parametrize("window,softcap,g", [(0, 0.0, 1), (5, 0.0, 2),
                                              (0, 30.0, 4)])
def test_chunked_attention(Sq, Skv, chunk, window, softcap, g):
    rng = np.random.default_rng(Sq + Skv + chunk)
    q = rng.standard_normal((2, Sq, 2 * g, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, logit_softcap=softcap, chunk=chunk)
    got = tl.chunked_attention(_t(q), _t(k), _t(v), **kw).numpy()
    want = _np(jl.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, want, **TOL)


def _block_params(jc, seed):
    jp, tp = _params(jc, seed)
    jb = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    tb = {k: {kk: vv[0] for kk, vv in d.items()}
          for k, d in tp["blocks"][0].items()}
    return jb, tb


@pytest.mark.parametrize("arch,window,S,cap", [
    ("llama3-8b", 0, 12, 16),      # cache larger than the prompt
    ("gemma2-2b", 8, 12, 8),       # local layer: ring shorter than the prompt
    ("llama3-8b", 0, 1, 16),       # one-token prompt (the reference appends)
])
def test_attention_block_prefill_and_cache(arch, window, S, cap):
    jc, tc = _cfgs(arch)
    jb, tb = _block_params(jc, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    jcache = jl.init_attn_cache(jc, 2, cap, jnp.float32)
    tcache = tl.init_attn_cache(tc, 2, cap, torch.float32)
    jy, jnc = jl.attention_block(jb["attn"], jnp.asarray(x), jc, CTX,
                                 jnp.asarray(pos), window=window,
                                 cache=jcache, update_cache=True)
    ty, tnc = tl.attention_block(tb["attn"], _t(x), tc, TCTX, _t(pos),
                                 window=window, cache=tcache,
                                 update_cache=True)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(tnc.k.numpy(), _np(jnc.k), **TOL)
    np.testing.assert_allclose(tnc.v.numpy(), _np(jnc.v), **TOL)
    assert int(tnc.length) == int(jnc.length) == S


@pytest.mark.parametrize("arch,window,S,cap,steps", [
    ("llama3-8b", 0, 5, 16, 3),    # the ring not yet full
    ("gemma2-2b", 8, 12, 8, 5),    # local layer: the ring wraps each step
])
def test_attention_block_ring_decode(arch, window, S, cap, steps):
    """Decode against the ring buffer: each step writes slot length % C in
    place and attends over min(length + 1, C) entries (f32, 1e-5)."""
    jc, tc = _cfgs(arch)
    jb, tb = _block_params(jc, 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S + steps, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S + steps, dtype=np.int32),
                          (2, S + steps))
    _, jcache = jl.attention_block(
        jb["attn"], jnp.asarray(x[:, :S]), jc, CTX, jnp.asarray(pos[:, :S]),
        window=window, cache=jl.init_attn_cache(jc, 2, cap, jnp.float32),
        update_cache=True)
    _, tcache = tl.attention_block(
        tb["attn"], _t(x[:, :S]), tc, TCTX, _t(pos[:, :S]),
        window=window,
        cache=tl.init_attn_cache(tc, 2, cap, torch.float32),
        update_cache=True)
    for i in range(S, S + steps):
        jy, jcache = jl.attention_block(
            jb["attn"], jnp.asarray(x[:, i:i + 1]), jc, CTX,
            jnp.asarray(pos[:, i:i + 1]), window=window, cache=jcache)
        ty, tcache = tl.attention_block(
            tb["attn"], _t(x[:, i:i + 1]), tc, TCTX, _t(pos[:, i:i + 1]),
            window=window, cache=tcache)
        np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
        np.testing.assert_allclose(tcache.k.numpy(), _np(jcache.k), **TOL)
        np.testing.assert_allclose(tcache.v.numpy(), _np(jcache.v), **TOL)
        assert int(tcache.length) == int(jcache.length) == i + 1


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-2b"])   # swiglu, geglu
def test_mlp_block(arch):
    jc, tc = _cfgs(arch)
    jb, tb = _block_params(jc, 3)
    x = np.random.default_rng(4).standard_normal(
        (2, 5, jc.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        tl.mlp_block(tb["mlp"], _t(x), tc, TCTX).numpy(),
        _np(jl.mlp_block(jb["mlp"], jnp.asarray(x), jc, CTX)), **TOL)


# ---------------------------------------------------------------------------
# forward, bf16 as the model runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,over", [
    ("llama3-8b", {}),                    # the smoke variant: 4 q / 4 kv heads
    ("llama3-8b", {"num_kv_heads": 2}),   # GQA g=2
    ("gemma2-2b", {}),                    # window, attention + final softcap
    ("gemma2-2b", {"num_kv_heads": 2}),   # ... with GQA g=2
])
def test_forward_logits(arch, over):
    jc, tc = _cfgs(arch, **over)
    jp, tp = _params(jc)
    toks = np.random.default_rng(5).integers(
        1, jc.vocab_size, size=(2, 80)).astype(np.int32)   # > gemma's window
    want, _, _ = jt.forward(jp, jc, CTX, tokens=jnp.asarray(toks))
    got, aux, _ = tt.forward(tp, tc, tokens=_t(toks))
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    worst, mean = _bf16_ulps(got.float().numpy(), _np(want))
    assert worst <= 4 and mean <= 0.5, (worst, mean)
