"""The port's frontend stubs, M-RoPE, ``layer_norm`` and the vision and
audio data streams against the JAX package's, on the CPU.

- bitwise: ``mrope_positions`` and ``delay_pattern`` (integer arithmetic),
  and ``vlm_stream`` / ``audio_stream`` batches (the same
  ``np.random.default_rng`` draws; the reference runs its delay pattern
  through ``jnp``), every key, dtype and shape, for several batches; the
  family adapter's dispatch (a vision run's ``seq`` counts the image's
  tokens too, as the reference's);
- f32 to rtol 1e-5 (atol 1e-5 of the largest magnitude: the same f32
  terms in another order): ``apply_mrope`` (positions under 200, so that
  the f32 angles' own rounding, which the two libraries' cos and sin carry
  alike, stays under the tolerance) and ``layer_norm``;
  the M-RoPE attention block on f32 activations on each route (chunked,
  the flash wrapper's plain version, and the ring-buffer decode after a
  prefill) to 1e-5;
- the stubs: shapes, dtypes, scale (0.02 standard normals) and their
  ``torch.Generator`` determinism.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api.families import adapter_for as jadapter_for  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core.params import init_tree as jinit_tree  # noqa: E402
from repro.core.sharding import ShardingCtx  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.api import adapter_for  # noqa: E402
from repro_torch.core.sharding import ShardingCtx as TShardingCtx  # noqa: E402,E501
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
jax.config.update("jax_default_matmul_precision", "highest")
CTX = ShardingCtx()
TCTX = TShardingCtx()
F32_TOL = 1e-5


def _close(got, want, tol=F32_TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _cfgs(arch, **over):
    jc = jsmoke(jget_config(arch)).replace(**over)
    return jc, ModelConfig(**dataclasses.asdict(jc))


# ---------------------------------------------------------------------------
# bitwise: positions, the delay pattern, the streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch,s_img,s_txt,grid_w", [
    (2, 16, 48, 4), (1, 1024, 1024, 32), (3, 0, 17, 32), (2, 10, 5, 3)])
def test_mrope_positions_are_the_reference_bitwise(batch, s_img, s_txt,
                                                   grid_w):
    want = np.asarray(jfront.mrope_positions(batch, s_img, s_txt, grid_w))
    got = tfront.mrope_positions(batch, s_img, s_txt, grid_w)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,S,K,pad", [(2, 16, 4, 0), (1, 3, 4, 7),
                                       (3, 33, 2, 0)])
def test_delay_pattern_is_the_reference_bitwise(B, S, K, pad):
    toks = np.random.default_rng(S).integers(1, 2048, (B, S, K)) \
        .astype(np.int32)
    want = np.asarray(jfront.delay_pattern(jnp.asarray(toks), K, pad))
    got = tfront.delay_pattern(toks, K, pad)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="codebooks"):
        tfront.delay_pattern(toks, K + 1)


def _assert_batches_equal(ours, ref, n=3):
    for _ in range(n):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("arch,batch,seq,seed", [
    ("qwen2-vl-2b", 2, 48, 0), ("qwen2-vl-2b", 3, 17, 5)])
def test_vlm_stream_is_the_reference_bitwise(arch, batch, seq, seed):
    jc, tc = _cfgs(arch)
    _assert_batches_equal(tpipe.vlm_stream(tc, batch, seq, seed),
                          jpipe.vlm_stream(jc, batch, seq, seed))


@pytest.mark.parametrize("arch,batch,seq,seed", [
    ("musicgen-medium", 2, 32, 0), ("musicgen-medium", 1, 9, 3)])
def test_audio_stream_is_the_reference_bitwise(arch, batch, seq, seed):
    jc, tc = _cfgs(arch)
    _assert_batches_equal(tpipe.audio_stream(tc, batch, seq, seed),
                          jpipe.audio_stream(jc, batch, seq, seed))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_family_stream_dispatch_matches_the_reference(arch):
    jc, tc = _cfgs(arch)
    seq = 40 if jc.frontend == "vision" else 24   # vision: 16 image tokens
    _assert_batches_equal(adapter_for(tc).stream(tc, 2, seq, 1),
                          jadapter_for(jc).stream(jc, 2, seq, 1), n=2)


def test_placed_vlm_batch_holds_each_rank_rows():
    _, tc = _cfgs("qwen2-vl-2b")
    batch = next(tpipe.vlm_stream(tc, 2, 8, 0))
    placed = tpipe.make_placer("cpu", shard=(1, 2))(batch)
    assert tuple(placed["positions"].shape) == (1, 24, 3)
    np.testing.assert_array_equal(placed["positions"].numpy(),
                                  batch["positions"][1:])


# ---------------------------------------------------------------------------
# f32: M-RoPE, layer_norm, the M-RoPE attention block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D,sections,theta", [(32, (4, 6, 6), 1e6),
                                              (128, (16, 24, 24), 1e6),
                                              (64, (8, 12, 12), 1e4)])
def test_apply_mrope_matches_reference(D, sections, theta):
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 24, 3, D)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 24, 3)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                               theta)
    got = tlayers.apply_mrope(torch.tensor(x), torch.tensor(pos), sections,
                              theta)
    _close(got.numpy(), want)
    # bf16 in, bf16 out: the same f32 rotation, rounded once
    got16 = tlayers.apply_mrope(torch.tensor(x).bfloat16(),
                                torch.tensor(pos), sections, theta)
    assert got16.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(torch.tensor(x), torch.tensor(pos),
                            (1,) + tuple(sections), theta)


def test_apply_mrope_with_equal_components_is_rope():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 9, 2, 32)).astype(np.float32))
    p = torch.tensor(rng.integers(0, 100, (2, 9)))
    _close(tlayers.apply_mrope(x, p[..., None].expand(2, 9, 3), (4, 6, 6),
                               1e4).numpy(),
           tlayers.apply_rope(x, p, 1e4).numpy())


@pytest.mark.parametrize("shape", [(2, 7, 48), (3, 256)])
def test_layer_norm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jlayers.layer_norm(*map(jnp.asarray, (x, w, b)))
    got = tlayers.layer_norm(*map(torch.tensor, (x, w, b)))
    _close(got.numpy(), want)
    got16 = tlayers.layer_norm(torch.tensor(x).bfloat16(), torch.tensor(w),
                               torch.tensor(b))
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("route", ["chunked", "kernel", "decode"])
def test_mrope_attention_block_matches_reference(route):
    jc, tc = _cfgs("qwen2-vl-2b")
    p = jax.tree.map(np.asarray, jinit_tree(jlayers.attn_specs(jc),
                                            jax.random.PRNGKey(0)))
    S = 24
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    pos = np.asarray(jfront.mrope_positions(2, 16, S - 16, 4))
    tp = params_from_numpy(p, "cpu")
    jp = jax.tree.map(jnp.asarray, p)
    if route == "decode":
        # a prefill of S - 1 positions, then the last one against the ring
        jcache = jlayers.init_attn_cache(jc, 2, S, jnp.float32)
        _, jcache = jlayers.attention_block(
            jp, jnp.asarray(x[:, :-1]), jc, CTX, jnp.asarray(pos[:, :-1]),
            cache=jcache, update_cache=True)
        want, _ = jlayers.attention_block(
            jp, jnp.asarray(x[:, -1:]), jc, CTX, jnp.asarray(pos[:, -1:]),
            cache=jcache)
        tcache = tlayers.init_attn_cache(tc, 2, S, torch.float32)
        _, tcache = tlayers.attention_block(
            tp, torch.tensor(x[:, :-1]), tc, TCTX, torch.tensor(pos[:, :-1]),
            cache=tcache, update_cache=True)
        got, _ = tlayers.attention_block(
            tp, torch.tensor(x[:, -1:]), tc, TCTX, torch.tensor(pos[:, -1:]),
            cache=tcache)
    else:
        want, _ = jlayers.attention_block(jp, jnp.asarray(x), jc, CTX,
                                          jnp.asarray(pos))
        got, _ = tlayers.attention_block(
            tp, torch.tensor(x), tc, TCTX, torch.tensor(pos),
            use_kernel=route == "kernel")
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the stubs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", [tfront.vision_stub_embeds,
                                tfront.audio_stub_embeds])
def test_stub_embeds_draw_from_the_generator(fn):
    a = fn(torch.Generator().manual_seed(3), 2, 64, 32)
    b = fn(torch.Generator().manual_seed(3), 2, 64, 32)
    c = fn(torch.Generator().manual_seed(4), 2, 64, 32)
    assert tuple(a.shape) == (2, 64, 32) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.015 < a.std().item() < 0.025
    assert fn(torch.Generator().manual_seed(3), 1, 4, 8,
              dtype=torch.bfloat16).dtype == torch.bfloat16
