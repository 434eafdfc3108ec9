"""The port's MoE layer and MoE models against the JAX package, on the CPU.

- ``moe.moe_block`` on its three routes (capacity-bounded dispatch, S > 1;
  decode with every expert, B * k >= E; sparse decode, B * k < E), with and
  without shared experts (qwen2-moe's and mixtral's smoke configs: E 4,
  k 2), in f32 and in bf16; the capacity drops, padded experts and the
  load-balance loss;
- the MoE models: forward, ``lm_loss`` and every gradient on both attention
  routes, and a 3-step ``compile_run`` fit.

Params are the reference's (``jax.random`` init) carried over as numpy with
``interop.params_from_numpy``; inputs come from numpy seeds.

Tolerances:
- ``moe_block`` in f32: 1e-5 of the output's largest magnitude; the aux
  loss 1e-6 relative.  Both packages run the same f32 products (router,
  experts, combine), summed in other orders.
- ``moe_block`` in bf16: the router's top-k sets must be equal wherever the
  k-th vs (k+1)-th probability margin exceeds twice the probabilities'
  measured one-ulp sensitivity (the largest change of any probability when
  the normed activations move by one bf16 ulp); tokens routed differently
  under a smaller margin are reported by the assert message and left out
  of the output comparison.  The outputs: 1 bf16 ulp at their largest
  magnitude (mean a quarter of one): every product rounds once to bf16 in
  both packages, at the same places.
- the models' summed aux loss: 1e-2 relative.  The second layer's input
  differs between the packages by an ulp in most elements (bf16 rounding
  at other places), which can flip a near-tied router choice; one flip of
  the N k = 256 (token, choice) pairs moves that layer's raw loss by about
  E p_e / (N k) ~ 4e-3, 2e-3 of the two layers' sum.  Measured: 8.6e-4
  (qwen2-moe, one flip), 8e-5 (mixtral, none).  A wrong coefficient, E
  scale or a missing layer moves it by tens of percents.
- the models: the loss 1e-3 relative and every gradient leaf 5e-2 relative
  L2, as ``tests/test_torch_lm_train.py`` holds the dense LMs (bf16
  activations round at other places in the two frameworks), with the
  router's undecided choices pinned (see the test); measured: the loss
  within 1.9e-5, the worst leaf 1.4e-2 (both archs, both routes); the fit's
  losses 1e-3 and grad norms 1e-2 relative per step, as
  ``tests/test_torch_lm_fit.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import compile_run as jcompile_run  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core.params import Spec as JSpec  # noqa: E402
from repro.core.params import init_tree as jinit_tree  # noqa: E402
from repro.core.sharding import ShardingCtx  # noqa: E402
from repro.data.pipeline import lm_token_stream as jlm_stream  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.api import RunSpec, compile_run  # noqa: E402
from repro_torch.core.sharding import ShardingCtx as TShardingCtx  # noqa: E402,E501
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.paper_cnn_training import use_kernel  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
CTX = ShardingCtx()
TCTX = TShardingCtx()
F32_REL, AUX_REL = 1e-5, 1e-6
BF16_MAX_ULPS, BF16_MEAN_ULPS = 1, 0.25
LOSS_REL, GRAD_REL_L2, GNORM_REL = 1e-3, 5e-2, 1e-2
MODEL_AUX_REL = 1e-2
MOE_ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]   # shared experts, none
# (route, B, S): smoke E 4, k 2, so B * k >= E from B = 2 on
ROUTES = [("dispatch", 2, 16), ("dense-decode", 3, 1),
          ("sparse-decode", 1, 1)]


def _cfgs(arch, **over):
    jc = jsmoke(jget_config(arch)).replace(**over)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _block_params(jc, seed):
    jp = jinit_tree(jmoe.moe_specs(jc), jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _both(jc, tc, jp, tp, x, dtype):
    """(reference out, port out, reference aux, port aux), outputs as f32
    numpy, on the same numpy input ``x`` cast to ``dtype``."""
    xj = jnp.asarray(x, dtype)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    jo, ja = jmoe.moe_block(jp, xj, jc, CTX)
    to, ta = tmoe.moe_block(tp, xt, tc, TCTX)
    return (np.asarray(jo, np.float32), to.float().numpy(), float(ja),
            ta.item(), xj, xt)


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _routing(jc, jp, tp, xj, xt):
    """Each package's top-k sets on its own normed activations, the
    k-th vs (k+1)-th probability margin, and the probabilities' one-ulp
    sensitivity (port's h moved by one bf16 ulp)."""
    k = jc.num_experts_per_tok
    hj = jl.rms_norm(xj, jp["norm"], jc.norm_eps)
    _, ji, _ = jmoe._router(hj, jp["router"], k)
    ht = tl.rms_norm(xt, tp["norm"], jc.norm_eps)
    _, ti, _ = tmoe._router(ht, tp["router"], k)
    probs = torch.softmax(ht.float() @ tp["router"].float(), -1)
    ht2 = (ht.float() * (1 + 2.0 ** -8)).to(ht.dtype)
    probs2 = torch.softmax(ht2.float() @ tp["router"].float(), -1)
    sens = (probs2 - probs).abs().max().item()
    srt = torch.sort(probs, -1, descending=True).values
    margin = (srt[..., k - 1] - srt[..., k]).numpy()
    same = np.all(np.sort(np.asarray(ji), -1)
                  == np.sort(ti.numpy(), -1), -1)
    return same, margin, sens


@pytest.mark.parametrize("route,B,S", ROUTES, ids=[r[0] for r in ROUTES])
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_block_matches_reference(arch, route, B, S, dtype):
    jc, tc = _cfgs(arch)
    jp, tp = _block_params(jc, seed=len(route) + B)
    x = np.random.default_rng(B * 7 + S).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jo, to, ja, ta, xj, xt = _both(jc, tc, jp, tp, x, jdt)
    assert to.shape == jo.shape == (B, S, jc.d_model)
    assert abs(ta - ja) <= AUX_REL * abs(ja), (ta, ja)
    if dtype == "f32":
        assert np.abs(to - jo).max() <= F32_REL * np.abs(jo).max()
        return
    same, margin, sens = _routing(jc, jp, tp, xj, xt)
    assert np.all(same | (margin <= 2 * sens)), (margin[~same], sens)
    d = np.abs(to - jo)[same] / _ulp(jo)
    assert d.max() <= BF16_MAX_ULPS and d.mean() <= BF16_MEAN_ULPS, \
        (d.max(), d.mean(), int((~same).sum()))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_drops_match_reference(arch):
    """capacity_factor 0.25: C = int(S k / E * 0.25) = 2 slots an expert for
    16 tokens x 2 choices, so most choices are dropped, in both packages
    alike (f32)."""
    jc, tc = _cfgs(arch)
    tight_j, tight_t = jc.replace(moe_capacity_factor=0.25), \
        tc.replace(moe_capacity_factor=0.25)
    jp, tp = _block_params(jc, seed=11)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    jo, to, ja, ta, _, xt = _both(tight_j, tight_t, jp, tp, x, jnp.float32)
    assert np.abs(to - jo).max() <= F32_REL * np.abs(jo).max()
    assert abs(ta - ja) <= AUX_REL * abs(ja)
    full, _ = tmoe.moe_block(tp, xt, tc, TCTX)
    assert bool(np.isfinite(to).all())
    assert np.abs(full.numpy() - to).max() > 1e-3      # tokens were dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_padded_experts_never_receive_tokens(arch):
    """``moe_expert_pad`` 2: two zero experts appended; the dispatch and the
    dense decode give the unpadded result, as in the reference (f32)."""
    jc, tc = _cfgs(arch)
    jp, tp = _block_params(jc, seed=5)
    pj, pt_ = _cfgs(arch, moe_expert_pad=2)
    tpp = dict(tp)
    for name in ("w_gate", "w_up", "w_down"):
        w = tp[name]
        tpp[name] = torch.cat([w, torch.zeros((2,) + w.shape[1:])])
    rng = np.random.default_rng(8)
    for B, S in ((2, 16), (3, 1)):
        xt = torch.tensor(rng.standard_normal((B, S, jc.d_model)),
                          dtype=torch.float32)
        want, _ = tmoe.moe_block(tp, xt, tc, TCTX)
        got, _ = tmoe.moe_block(tpp, xt, pt_, TCTX)
        jgot, _ = jmoe.moe_block(
            {k: jnp.asarray(v.numpy()) for k, v in tpp.items()},
            jnp.asarray(xt.numpy()), pj, CTX)
        assert (got - want).abs().max().item() <= F32_REL
        assert np.abs(got.numpy() - np.asarray(jgot)).max() <= F32_REL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_loss_balanced_lower_bound(arch):
    """``E sum_e f_e p_e`` (raw, before ``router_aux_loss_coef``) is >= 1
    up to sampling, with equality when balanced: the reference's bound."""
    jc, tc = _cfgs(arch)
    _, tp = _block_params(jc, seed=2)
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (4, 32, jc.d_model)), dtype=torch.float32)
    _, aux = tmoe.moe_block(tp, x, tc, TCTX)
    assert aux.item() / tc.router_aux_loss_coef >= 0.95


def test_router_ties_go_to_the_lower_index():
    """Equal probabilities: ``lax.top_k`` keeps the lower expert index."""
    h = torch.zeros(3, 8)
    w = torch.zeros(8, 6)
    _, idx, _ = tmoe._router(h, w, 4)
    assert idx.tolist() == [[0, 1, 2, 3]] * 3
    _, jidx = jax.lax.top_k(jnp.full((3, 6), 1 / 6), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("pad", [0, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_specs_match_reference(arch, pad):
    jc, tc = _cfgs(arch, moe_expert_pad=pad)
    js, ts = jmoe.moe_specs(jc), tmoe.moe_specs(tc)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].shape == ts[k].shape and js[k].axes == ts[k].axes
        assert js[k].init == ts[k].init


# ---------------------------------------------------------------------------
# the MoE models
# ---------------------------------------------------------------------------
_REFERENCE = {}


def _reference(arch):
    """The reference's params (numpy), batch, loss, aux loss, gradient
    leaves and each MoE layer's top-k choices (as the forward reaches them),
    computed once per module, eagerly (``jax.disable_jit``) so that the
    recorded choices are those of the computed gradients."""
    if arch not in _REFERENCE:
        jc, _ = _cfgs(arch)
        jp = jt.init_params(jc, jax.random.PRNGKey(3))
        b = next(jlm_stream(jc.vocab_size, 2, 64, seed=3))
        batch = {"tokens": jnp.asarray(b["tokens"])}
        choices = []
        real = jmoe._router

        def spy(h, w, k):
            out = real(h, w, k)
            choices.append(np.asarray(out[1]))
            return out

        with jax.disable_jit():
            jmoe._router = spy
            try:
                aux = jt.forward(jp, jc, CTX, tokens=batch["tokens"])[1]
            finally:
                jmoe._router = real
            loss, grads = jax.value_and_grad(
                lambda p: jt.lm_loss(p, jc, CTX, batch))(jp)
        _REFERENCE[arch] = (jax.tree.map(np.asarray, jp), b, float(loss),
                            float(aux),
                            [np.asarray(g) for g in jax.tree.leaves(grads)],
                            choices)
    return _REFERENCE[arch]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port_routing(params, tc, tokens):
    """The port's aux loss and, per MoE layer, its top-k sets, the k-th vs
    (k+1)-th probability margins and the one-ulp sensitivity of the
    probabilities (the normed activations moved by one bf16 ulp)."""
    k = tc.num_experts_per_tok
    layers_seen = []
    real = tmoe._router

    def spy(h, w, k_):
        out = real(h, w, k_)
        probs = torch.softmax(h.float() @ w.float(), -1)
        h2 = (h.float() * (1 + 2.0 ** -8)).to(h.dtype)
        sens = (torch.softmax(h2.float() @ w.float(), -1) - probs
                ).abs().max().item()
        srt = torch.sort(probs, -1, descending=True).values
        layers_seen.append((out[1].numpy(),
                            (srt[..., k - 1] - srt[..., k]).numpy(), sens))
        return out

    tmoe._router = spy
    try:
        with torch.no_grad():
            aux = tt.forward(params, tc, tokens=tokens)[1].item()
    finally:
        tmoe._router = real
    return aux, layers_seen


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_loss_and_grads_match_reference(arch, route, monkeypatch):
    """The router's choices agree wherever decided (margin above twice the
    one-ulp sensitivity).  A near-tie the two packages break differently
    reroutes one token, which moves every gradient leaf by about
    1/sqrt(tokens) ~ 9% (measured 5-13% on qwen2-moe's smoke batch, one
    flip), far above the bf16 rounding this test holds.  So the loss and
    the gradients are then compared with the port's ``_top_k`` pinned to
    the reference's indices: its own probabilities, weights, aux loss and
    gradients."""
    nparams, b, jloss, jaux, jgrads, jchoices = _reference(arch)
    _, tc = _cfgs(arch)
    params = params_from_numpy(nparams, "cpu")
    tokens = torch.tensor(b["tokens"])
    aux, seen = _port_routing(params, tc, tokens)
    assert aux > 0 and abs(aux - jaux) <= MODEL_AUX_REL * jaux
    assert len(seen) == len(jchoices) == tc.num_layers
    for (ti, margin, sens), ji in zip(seen, jchoices):
        same = np.all(np.sort(ti, -1) == np.sort(ji, -1), -1)
        assert np.all(same | (margin <= 2 * sens)), (margin[~same], sens)

    pinned = iter(jchoices)
    monkeypatch.setattr(tmoe, "_top_k", lambda probs, k: torch.tensor(
        next(pinned), dtype=torch.long))
    calls = []
    real = fa.attention
    monkeypatch.setattr(fa, "attention",
                        lambda *a: calls.append(1) or real(*a))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = tt.lm_loss(params, tc, TCTX, {"tokens": tokens},
                      use_kernel=route == "kernel")
    grads = torch.autograd.grad(loss, leaves)
    assert len(calls) == (tc.num_layers if route == "kernel" else 0)
    assert abs(loss.item() - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)
    assert len(grads) == len(jgrads)
    rel = [_rel_l2(g.numpy(), w) for g, w in zip(grads, jgrads)]
    assert max(rel) <= GRAD_REL_L2, rel


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_tree_matches_reference(arch):
    jc, tc = _cfgs(arch)
    want = [s.shape for s in jax.tree.leaves(
        jt.param_specs(jc), is_leaf=lambda s: isinstance(s, JSpec))]
    tp = tt.init_params(tc, seed=0, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(tp)] == want
    assert set(tp["blocks"][0]) == {"attn", "moe"}


def _quiet(*_):
    pass


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_moe_fit_history_matches_reference(route):
    kw = dict(arch="qwen2-moe-a2.7b", smoke=True, steps=3, batch=2, seq=64,
              log_every=1)
    jrun = jcompile_run(JRunSpec(**kw))
    nparams = jax.tree.map(np.asarray, jrun.params)
    want = jrun.fit(log_fn=_quiet)
    jrun.close()
    run = compile_run(RunSpec(**kw), device="cpu")
    run.params = params_from_numpy(nparams, "cpu")
    run.opt_state = run.optimizer.init(run.params)
    if route == "kernel":
        use_kernel(run)
    with run:
        got = run.fit(log_fn=_quiet)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"]), (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) \
            <= GNORM_REL * abs(w["grad_norm"]), (g, w)
