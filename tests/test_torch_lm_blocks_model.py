"""The LM blocks of the port on a model axis (``ShardingCtx`` over a local
mesh of ``{data: D, model: M}``) against the JAX package's blocks, on the
CPU.  The reference's own tests
define the contract (``tests/test_distributed.py:306-533``); the reference
runs here unsharded in this process, since its sharded runs equal its
unsharded ones within those tests' tolerances.

- Blocks on f32 inputs, the same f32 arithmetic in another order:
  attention (GQA with its kv heads split, gemma-2b's MQA with its one kv
  head whole on every member, 6 q / 3 kv heads at 2 ways where each
  member's q heads read kv heads repeated to them, 6 q / 2 kv heads at 4
  ways whose q heads do not split; the chunked route, and the flash
  route's plain version for the first two and the last; prefill and ring
  decode on a whole cache), the MLP, the MoE
  block's routes (experts on the model axis, ``moe_ff`` on it, the two
  decode routes): 1e-5 of the output's largest magnitude, and the
  gradients of a scalar of the output against the port's unsharded
  block's within 1e-5.
- The vocab-parallel embedding, the tied, untied and codebook heads and
  ``chunked_lm_loss``: ``lm_loss`` on f32 activations within 1e-5
  relative of the reference's.
- ``moe_ep_block`` at ``(2, 4)`` against the reference's tensor-parallel
  block (mixtral smoke, capacity factor 4.0): output 1e-4, aux 1e-5
  (``test_explicit_expert_parallel_matches_tensor_parallel``).
- ``seq_shard_carry`` at ``(2, 4)``: the loss within 2e-3
  (``test_seq_shard_carry_preserves_loss``).
- ``sharded_decode_attention`` with softcap 50 and ``cache_seq`` on
  ``"model"`` and on ``"data"``: output 2e-4, the cache 1e-5, length 21
  (``test_sharded_decode_attention_matches_reference``); ``generate``
  through ``hybrid.plan``'s rules equal to the unsharded run's tokens.
- The MoE loss at ``(2, 2)`` 2e-3 (``test_moe_arch_sharded_forward``).

The train steps, the model-axis functions and the gloo runs are
``tests/test_torch_lm_model_steps.py``'s.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core.params import init_tree as jinit_tree  # noqa: E402
from repro.core.sharding import ShardingCtx as JCtx  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core.params import map_tree, tree_leaves  # noqa: E402
from repro_torch.core.sharding import (  # noqa: E402
    ShardingCtx,
    ShardingRules,
    from_members,
)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
JCTX = JCtx()
F32 = 1e-5


def _cfgs(arch, **over):
    """The reference's smoke config (``over`` replaced) and the port's copy
    of it."""
    jc = jsmoke(jget_config(arch)).replace(**over)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _ctx(data=2, model=2, **over):
    return ShardingCtx(make_local_mesh(data, model_ways=model, device="cpu"),
                       ShardingRules().with_overrides(**over))


def _np_tree(specs, seed):
    return jax.tree.map(np.asarray, jinit_tree(specs, jax.random.PRNGKey(
        seed)))


def _close(got, want, tol=F32):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _grads(fn, params, x):
    """Gradients of ``sum(fn(params, x) * w)`` (a fixed random ``w``) with
    respect to ``x`` and every leaf of ``params``."""
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    x = x.clone().requires_grad_()
    y = fn(params, x)
    y = y[0] if isinstance(y, tuple) else y
    w = torch.tensor(_x(tuple(y.shape), 99))
    return torch.autograd.grad((y.float() * w).sum(), [x] + leaves)


def _full_grads(grads, ctx, specs, params):
    it = iter(grads[1:])
    tree = map_tree(lambda _: next(it), params)
    return [grads[0]] + tree_leaves(ctx.full(tree, specs))


@contextlib.contextmanager
def f32_activations(monkeypatch):
    """Both packages' residual stream in f32 (``tests/test_torch_hybrid.py``
    and ``tests/test_torch_families.py`` patch it so)."""
    class F32Jnp:
        bfloat16 = jnp.float32

        def __getattr__(self, name):
            return getattr(jnp, name)
    monkeypatch.setattr(jt, "jnp", F32Jnp())
    monkeypatch.setattr(tt, "ACTIVATION_DTYPE", torch.float32)
    yield


# ---------------------------------------------------------------------------
# attention and MLP blocks
# ---------------------------------------------------------------------------
ATTN_CASES = {
    "gqa-split": ("llama3-8b", dict(num_kv_heads=2), 2),  # 1 kv a member
    "mqa": ("gemma-2b", {}, 2),                   # 4 q, 1 kv: kv whole
    "kv-repeated": ("llama3-8b", dict(num_heads=6, num_kv_heads=3,
                                      head_dim=32), 2),
    "four-ways": ("llama3-8b", {}, 4),            # 4 q, 4 kv: 1 and 1
    "local-softcap": ("gemma2-2b", {}, 2),
    # 6 q / 2 kv heads at 4 ways: q_dim splits, the q heads do not (the
    # four projections whole on every member)
    "q-heads-uneven": ("llama3-8b", dict(num_heads=6, num_kv_heads=2,
                                         head_dim=32), 4),
}


@pytest.mark.parametrize("case,route", [
    (c, r) for c in ATTN_CASES
    for r in (("chunked", "kernel")
              if c in ("gqa-split", "mqa", "q-heads-uneven")
              else ("chunked",))])
def test_attention_block_on_model_ways(case, route):
    arch, over, M = ATTN_CASES[case]
    jc, tc = _cfgs(arch, **over)
    specs = tl.attn_specs(tc)
    p = _np_tree(jl.attn_specs(jc), 1)
    B, S = 2, 16
    x = _x((B, S, tc.d_model), 2)
    pos = np.broadcast_to(np.arange(S), (B, S))
    w = tc.sliding_window if case == "local-softcap" else 0
    want, _ = jl.attention_block(p, jnp.asarray(x), jc, JCTX,
                                 jnp.asarray(pos), window=w)
    ctx = _ctx(4 // M, M)
    tp = ctx.place(params_from_numpy(p, "cpu"), specs)
    assert ctx.sharded(specs["wq"])

    def fn(prm, x, c=ctx):
        return tl.attention_block(prm, x, tc, c, torch.tensor(pos),
                                  window=w, use_kernel=route == "kernel")
    got, _ = fn(tp, torch.tensor(x))
    _close(got.detach().numpy(), want)
    g = _full_grads(_grads(fn, tp, torch.tensor(x)), ctx, specs, tp)
    serial = params_from_numpy(p, "cpu")
    g0 = _grads(lambda q, x: fn(q, x, ShardingCtx()), serial,
                torch.tensor(x))
    for a, b in zip(g, g0):
        _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("case", ["gqa-split", "mqa", "kv-repeated"])
def test_attention_prefill_and_ring_decode_on_model_ways(case):
    arch, over, M = ATTN_CASES[case]
    jc, tc = _cfgs(arch, **over)
    p = _np_tree(jl.attn_specs(jc), 3)
    B, S, cap = 2, 12, 16
    x = _x((B, S + 3, tc.d_model), 4)
    pos = np.broadcast_to(np.arange(S + 3), (B, S + 3))
    ctx = _ctx(4 // M, M)
    tp = ctx.place(params_from_numpy(p, "cpu"), tl.attn_specs(tc))
    jcache = jl.AttnCache(*(jnp.zeros((B, cap, jc.num_kv_heads, jc.head_dim))
                            for _ in range(2)), jnp.asarray(0, jnp.int32))
    _, jcache = jl.attention_block(p, jnp.asarray(x[:, :S]), jc, JCTX,
                                   jnp.asarray(pos[:, :S]), cache=jcache,
                                   update_cache=True)
    tcache = tl.init_attn_cache(tc, B, cap, torch.float32)
    _, tcache = tl.attention_block(tp, torch.tensor(x[:, :S]), tc, ctx,
                                   torch.tensor(pos[:, :S]), cache=tcache,
                                   update_cache=True)
    for i in range(S, S + 3):
        want, jcache = jl.attention_block(
            p, jnp.asarray(x[:, i:i + 1]), jc, JCTX,
            jnp.asarray(pos[:, i:i + 1]), cache=jcache)
        got, tcache = tl.attention_block(
            tp, torch.tensor(x[:, i:i + 1]), tc, ctx,
            torch.tensor(pos[:, i:i + 1]), cache=tcache)
        _close(got.numpy(), want)
    _close(tcache.k.numpy(), jcache.k)
    assert int(tcache.length) == int(jcache.length) == S + 3


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-2b", "musicgen-medium"])
def test_mlp_block_on_model_ways(arch):
    jc, tc = _cfgs(arch)
    specs = tl.mlp_specs(tc)
    p = _np_tree(jl.mlp_specs(jc), 5)
    x = _x((2, 8, tc.d_model), 6)
    want = jl.mlp_block(p, jnp.asarray(x), jc, JCTX)
    ctx = _ctx()
    tp = ctx.place(params_from_numpy(p, "cpu"), specs)
    assert ctx.sharded(specs["w_down"])

    def fn(prm, x, c=ctx):
        return tl.mlp_block(prm, x, tc, c)
    _close(fn(tp, torch.tensor(x)).detach().numpy(), want)
    g = _full_grads(_grads(fn, tp, torch.tensor(x)), ctx, specs, tp)
    g0 = _grads(lambda q, x: fn(q, x, ShardingCtx()),
                params_from_numpy(p, "cpu"), torch.tensor(x))
    for a, b in zip(g, g0):
        _close(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the embedding, the heads and the losses
# ---------------------------------------------------------------------------
# (arch, overrides): the tied head, the untied lm_head, chunked CE over
# the tied head, the codebook heads
HEAD_CASES = {
    "tied": ("gemma2-2b", {}),
    "untied": ("llama3-8b", {}),
    "chunked": ("gemma-2b", dict(loss_chunk=3)),
    "codebooks": ("musicgen-medium", {}),
}


def _batch(jc, seed, B=2, S=16):
    r = np.random.default_rng(seed)
    if jc.frontend == "audio":
        return {"frame_embeds": r.normal(size=(B, S, jc.d_model)).astype(
                    np.float32) * 0.02,
                "codebook_labels": r.integers(0, jc.vocab_size,
                                              (B, S, jc.num_codebooks))}
    return {"tokens": r.integers(0, jc.vocab_size, (B, S))}


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_vocab_parallel_embedding_heads_and_loss(case, monkeypatch):
    arch, over = HEAD_CASES[case]
    jc, tc = _cfgs(arch, **over)
    with f32_activations(monkeypatch):
        jp = jax.tree.map(np.asarray, jt.init_params(jc,
                                                     jax.random.PRNGKey(7)))
        b = _batch(jc, 8)
        want = float(jt.lm_loss(jp, jc, JCTX,
                                jax.tree.map(jnp.asarray, b)))
        ctx = _ctx()
        specs = tt.param_specs(tc)
        tp = ctx.place(params_from_numpy(jp, "cpu"), specs)
        name = {"codebooks": "codebook_heads", "untied": "lm_head"}.get(
            case, "embed")
        assert ctx.sharded(specs[name]) and ctx.sharded(specs["embed"])
        got = float(tt.lm_loss(tp, tc, ctx, {k: torch.tensor(v)
                                             for k, v in b.items()}))
    assert abs(got - want) <= F32 * abs(want)


def test_moe_arch_sharded_loss(monkeypatch):
    jc, tc = _cfgs("qwen2-moe-a2.7b")
    jp = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.PRNGKey(0)))
    b = _batch(jc, 0, B=4, S=32)
    want = float(jt.lm_loss(jp, jc, JCTX, jax.tree.map(jnp.asarray, b)))
    ctx = _ctx()
    tp = ctx.place(params_from_numpy(jp, "cpu"), tt.param_specs(tc))
    got = float(tt.lm_loss(tp, tc, ctx, {"tokens": torch.tensor(
        b["tokens"])}))
    assert abs(got - want) <= 2e-3 * abs(want)


def test_seq_shard_carry_preserves_loss():
    jc, tc = _cfgs("llama3-8b")
    jp = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.PRNGKey(0)))
    b = _batch(jc, 1, B=4, S=32)
    want = float(jt.lm_loss(jp, jc, JCTX, jax.tree.map(jnp.asarray, b)))
    ctx = _ctx(2, 4)
    tc2 = tc.replace(seq_shard_carry=True, remat="block")
    tp = ctx.place(params_from_numpy(jp, "cpu"), tt.param_specs(tc2))
    batch = {"tokens": torch.tensor(b["tokens"])}
    got = float(tt.lm_loss(tp, tc2, ctx, batch))
    assert abs(got - want) <= 2e-3 * abs(want)
    assert got == float(tt.lm_loss(tp, tc, ctx, batch))


# ---------------------------------------------------------------------------
# MoE: the three placements and moe_ep_block
# ---------------------------------------------------------------------------
MOE_CASES = {
    "experts": ("qwen2-moe-a2.7b", {}),             # E = 4: experts shard
    "moe_ff": ("qwen2-moe-a2.7b", dict(num_experts=3,
                                      num_experts_per_tok=2)),
}


@pytest.mark.parametrize("S,B", [(16, 2), (1, 4), (1, 1)],
                         ids=["dispatch", "decode-dense", "decode-sparse"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_on_model_ways(case, S, B):
    arch, over = MOE_CASES[case]
    jc, tc = _cfgs(arch, **over)
    specs = tmoe.moe_specs(tc)
    p = _np_tree(jmoe.moe_specs(jc), 9)
    x = _x((B, S, tc.d_model), 10)
    want, jaux = jmoe.moe_block(p, jnp.asarray(x), jc, JCTX)
    ctx = _ctx()
    tp = ctx.place(params_from_numpy(p, "cpu"), specs)
    held = ctx.held(specs["w_gate"])
    assert held[:1] == (("model",) if case == "experts" else (None,))
    assert "model" in held

    def fn(prm, x, c=ctx):
        return tmoe.moe_block(prm, x, tc, c)
    got, aux = fn(tp, torch.tensor(x))
    _close(got.detach().numpy(), want)
    assert abs(float(aux) - float(jaux)) <= F32 * abs(float(jaux))
    if S > 1:
        g = _full_grads(_grads(fn, tp, torch.tensor(x)), ctx, specs, tp)
        g0 = _grads(lambda q, x: fn(q, x, ShardingCtx()),
                    params_from_numpy(p, "cpu"), torch.tensor(x))
        for a, b in zip(g, g0):
            _close(a.numpy(), b.numpy())


def test_explicit_expert_parallel_matches_tensor_parallel():
    jc, tc = _cfgs("mixtral-8x22b", moe_capacity_factor=4.0)
    p = _np_tree(jmoe.moe_specs(jc), 0)
    x = _x((4, 16, tc.d_model), 0)
    want, jaux = jmoe.moe_block(p, jnp.asarray(x), jc, JCTX)
    ctx = _ctx(2, 4)
    tp = ctx.place(params_from_numpy(p, "cpu"), tmoe.moe_specs(tc))
    got, aux = tmoe.moe_ep_block(tp, torch.tensor(x), tc, ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_block_reaches_moe_ep_block_where_the_reference_does(
        monkeypatch):
    jc, tc = _cfgs("mixtral-8x22b", moe_expert_pad=4)
    calls = []
    real = tmoe.moe_ep_block
    monkeypatch.setattr(tmoe, "moe_ep_block",
                        lambda *a: calls.append(a[3].mesh) or real(*a))
    p = params_from_numpy(_np_tree(jmoe.moe_specs(jc), 0), "cpu")
    x = torch.tensor(_x((2, 8, tc.d_model), 1))
    for ctx, S, hit in ((ShardingCtx(), 8, False), (_ctx(2, 4), 8, True),
                        (_ctx(2, 4), 1, False), (_ctx(4, 1), 8, True),
                        (_ctx(2, 2), 8, True)):
        calls.clear()
        tp = ctx.place(p, tmoe.moe_specs(tc))
        tmoe.moe_block(tp, x[:, :S], tc, ctx)
        assert bool(calls) == hit, (ctx.mesh, S)
    tc3 = tc.replace(moe_expert_pad=1)           # (4 + 1) % 2 != 0
    ctx = _ctx()
    calls.clear()
    p3 = params_from_numpy(_np_tree(jmoe.moe_specs(jc.replace(
        moe_expert_pad=1)), 0), "cpu")
    tmoe.moe_block(ctx.place(p3, tmoe.moe_specs(tc3)), x, tc3, ctx)
    assert not calls


# ---------------------------------------------------------------------------
# the sequence-sharded decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axes,data,model", [(("model",), 2, 4),
                                             (("data",), 4, 1),
                                             (("data",), 2, 2)])
def test_sharded_decode_attention_matches_reference(axes, data, model):
    jc, tc = _cfgs("gemma2-2b", attn_logit_softcap=50.0)
    p = _np_tree(jl.attn_specs(jc), 0)
    B, C = 4, 32
    r = np.random.default_rng(0)
    shp = (B, C, tc.num_kv_heads, tc.head_dim)
    k, v = r.normal(size=shp), r.normal(size=shp)
    x = r.normal(size=(B, 1, tc.d_model))
    pos = np.full((B, 1), 20)
    jcache = jl.AttnCache(jnp.asarray(k, jnp.float32),
                          jnp.asarray(v, jnp.float32),
                          jnp.asarray(20, jnp.int32))
    want, jnc = jl.attention_block(p, jnp.asarray(x, jnp.float32), jc, JCTX,
                                   jnp.asarray(pos), window=0, cache=jcache)
    ctx = _ctx(data, model, cache_seq=axes)
    tp = ctx.place(params_from_numpy(p, "cpu"), tl.attn_specs(tc))
    cache = tl.shard_cache(tl.AttnCache(
        torch.tensor(k, dtype=torch.float32),
        torch.tensor(v, dtype=torch.float32),
        torch.tensor(20, dtype=torch.int32)), ctx)
    assert isinstance(cache, tl.SeqShardedCache)
    n = ctx.mesh.shape[axes[0]]
    assert tuple(cache.k.shape) == (n, B, C // n) + shp[2:]
    got, nc = tl.attention_block(tp, torch.tensor(x, dtype=torch.float32),
                                 tc, ctx, torch.tensor(pos), window=0,
                                 cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    full = from_members(nc.k, (None, axes[0]), ctx.mesh)
    np.testing.assert_allclose(full.numpy(), np.asarray(jnc.k), rtol=1e-5,
                               atol=1e-5)
    assert int(nc.length) == int(jnc.length) == 21


def test_generate_through_the_planned_sharded_decode(monkeypatch):
    """``serve.decode`` at ``hybrid.plan``'s rules for gemma-2b's decode
    (cache_seq on "model": its one kv head does not split): the sharded
    decode runs, and greedy tokens equal the unsharded run's (f32
    activations)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.configs.base import TPU_V5E
    from repro_torch.core import hybrid
    from repro_torch.serve import decode
    _, tc = _cfgs("gemma-2b")
    monkeypatch.setattr(tt, "ACTIVATION_DTYPE", torch.float32)
    mesh = make_local_mesh(2, model_ways=2, device="cpu")
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], global_batch=2)
    plan = hybrid.plan(tc, shape, mesh, TPU_V5E)
    assert plan.rules.rules["cache_seq"] == ("model",)
    ctx = ShardingCtx(mesh, plan.rules)
    params = tt.init_params(tc, 0, "cpu")
    placed = ctx.place(params, tt.param_specs(tc))
    prompt = torch.tensor(np.random.default_rng(3).integers(
        1, tc.vocab_size, (2, 10)))
    seen = []
    real = tl.sharded_decode_attention
    monkeypatch.setattr(tl, "sharded_decode_attention",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    want = decode.generate(params, tc, ShardingCtx(), prompt, 6)
    assert not seen
    got = decode.generate(placed, tc, ctx, prompt, 6)
    assert len(seen) == 5 * tc.num_layers
    assert torch.equal(got, want)


def test_compile_run_dp_step_with_q_heads_that_do_not_split():
    """``compile_run`` under dp at 8 model ways of smoke llama3-8b: its 4 q
    heads do not split, its q_dim of 128 does (the rules shard ``wq``); the
    2-step history is the unsharded run's within 1e-3 relative (the MLP's,
    the embedding's and the head's sums run in another order)."""
    from repro_torch.api import MeshSpec, RunSpec, compile_run
    hist = {}
    for ways in (1, 8):
        spec = RunSpec(arch="llama3-8b", smoke=True, steps=2, batch=2,
                       seq=16, parallel="dp",
                       mesh=MeshSpec(members_per_device=1, model_ways=ways))
        with compile_run(spec, device="cpu") as run:
            if ways == 8:
                wq = tl.attn_specs(run.cfg)["wq"]
                assert run.ctx.sharded(wq) and run.cfg.num_heads % ways
            hist[ways] = [float(h["loss"]) for h in
                          run.fit(log_fn=lambda *_: None)]
    assert len(hist[8]) == 2
    for a, b in zip(hist[8], hist[1]):
        assert abs(a - b) <= 1e-3 * abs(b), (hist[8], hist[1])
