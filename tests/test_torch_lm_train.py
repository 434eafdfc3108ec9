"""The port's transformer LM training pieces against the JAX package, on the
CPU: the token stream, the family adapter, ``lm_loss`` and its gradients on
both attention routes, the kernel route's use of the flash wrapper, and the
train step with AdamW on the nested param tree.

Params are the reference's (``jax.random`` init), carried over as numpy
with ``interop.params_from_numpy``; token batches come bitwise from both
packages' seeded ``lm_token_stream``.  The smoke configs have 4 q and 4 kv
heads, so ``num_kv_heads=2`` is added to exercise GQA; seq 128 makes
gemma2's smoke window of 64 bind; ``loss_chunk`` covers the chunked CE.

Tolerances:
- ``lm_loss``, 1e-3 relative; every gradient leaf, 5e-2 relative L2.  The
  model runs in bf16 activations and bf16 matmuls, which XLA and PyTorch
  round at different places (``tests/test_torch_layers.py`` holds the
  logits to 4 bf16 ulps).  Measured: the loss within 1.2e-4, the worst
  leaf 2.3e-2 (gemma2).  The gradients are as sensitive as that by
  themselves: scaling the embedding by 1 + 2^-23 moves every leaf of the
  port's own gradient by ~1e-2 relative L2.  A wrong mask, softcap or
  GQA map in the forward moves the loss by far more than 1e-3.
- the chunked CE against the whole one, 1e-5 relative (the same bf16
  logits, f32 sums in another grouping);
- the train step and AdamW on a loss whose gradients are elementwise f32
  arithmetic, identical in both packages: params and moments to 1e-5
  relative (the global norm's sum order moves the clip scale by ulps);
- the token stream: bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core.sharding import ShardingCtx  # noqa: E402
from repro.data.pipeline import lm_token_stream as jlm_stream  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.optim.sgd import MomentumSGD as JMomentumSGD  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.api import RunSpec, adapter_for, compile_run  # noqa: E402
from repro_torch.core.sharding import ShardingCtx as TShardingCtx  # noqa: E402,E501
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.core.params import map_tree, tree_leaves  # noqa: E402
from repro_torch.data.pipeline import lm_token_stream  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.paper_cnn_training import use_kernel  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import AdamW, MomentumSGD  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
CTX = ShardingCtx()
TCTX = TShardingCtx()
LOSS_REL = 1e-3
GRAD_REL_L2 = 5e-2

# (arch, overrides): both smoke LMs, each with GQA, and the chunked CE
CASES = [
    ("llama3-8b", {}),
    ("llama3-8b", {"num_kv_heads": 2}),
    ("gemma2-2b", {}),
    ("gemma2-2b", {"num_kv_heads": 2}),
    ("gemma2-2b", {"loss_chunk": 3}),
    ("llama3-8b", {"num_kv_heads": 2, "loss_chunk": 4}),
]
_REFERENCE = {}


def _cfgs(arch, **over):
    jc = jsmoke(jget_config(arch)).replace(**over)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _reference(case):
    """The reference's params (as numpy), batch, loss and gradient leaves
    for one of ``CASES``, computed once per module."""
    if case not in _REFERENCE:
        arch, over = CASES[case]
        jc, _ = _cfgs(arch, **over)
        jp = jt.init_params(jc, jax.random.PRNGKey(case))
        b = next(jlm_stream(jc.vocab_size, 2, 128, seed=case))
        loss, grads = jax.value_and_grad(lambda p: jt.lm_loss(
            p, jc, CTX, {"tokens": jnp.asarray(b["tokens"])}))(jp)
        _REFERENCE[case] = (jax.tree.map(np.asarray, jp), b, float(loss),
                            [np.asarray(g) for g in jax.tree.leaves(grads)])
    return _REFERENCE[case]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("vocab,batch,seq", [(512, 2, 128),
                                             (256000, 2, 64),
                                             (128256, 3, 17)])
def test_lm_token_stream_is_bitwise_the_reference(vocab, batch, seq):
    ours = lm_token_stream(vocab, batch, seq, seed=7)
    ref = jlm_stream(vocab, batch, seq, seed=7)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        assert a["tokens"].shape == (batch, seq)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-2b"])
def test_transformer_family_adapter(arch):
    cfg = get_config(arch)
    fam = adapter_for(cfg)
    assert fam.family == "transformer" and fam.default_optimizer == "adamw"
    b = next(fam.stream(cfg, 2, 16, 3))
    np.testing.assert_array_equal(
        b["tokens"], next(jlm_stream(cfg.vocab_size, 2, 16, 3))["tokens"])
    # the vision frontend's stream: seq counts the image's tokens too
    vision = cfg.replace(frontend="vision", vision_tokens=4)
    vb = next(fam.stream(vision, 2, 16, 3))
    assert set(vb) == {"tokens", "patch_embeds", "positions"}
    assert vb["tokens"].shape == (2, 12) and vb["positions"].shape[1] == 16


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=[
    "-".join([a] + [f"{k}{v}" for k, v in o.items()]) for a, o in CASES])
def test_lm_loss_and_grads_match_reference(case, route):
    nparams, b, jloss, jgrads = _reference(case)
    arch, over = CASES[case]
    _, tc = _cfgs(arch, **over)
    params = params_from_numpy(nparams, "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = tt.lm_loss(params, tc, TCTX,
                      {"tokens": torch.tensor(b["tokens"])},
                      use_kernel=route == "kernel")
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)
    assert len(grads) == len(jgrads)
    rel = [_rel_l2(g.numpy(), w) for g, w in zip(grads, jgrads)]
    assert max(rel) <= GRAD_REL_L2, rel


@pytest.mark.parametrize("arch,n_chunks", [("gemma2-2b", 3),
                                           ("llama3-8b", 5)])
def test_chunked_loss_equals_the_whole_ce(arch, n_chunks):
    _, tc = _cfgs(arch)
    params = tt.init_params(tc, seed=1, device="cpu")
    tokens = torch.tensor(next(lm_token_stream(tc.vocab_size, 2, 64, 1))
                          ["tokens"])
    whole = tt.lm_loss(params, tc, TCTX, {"tokens": tokens})
    chunked = tt.lm_loss(params, tc.replace(loss_chunk=n_chunks), TCTX,
                         {"tokens": tokens})
    assert abs(chunked.item() - whole.item()) <= 1e-5 * abs(whole.item())


def test_unstack_views_each_stacked_leaf_once():
    _, tc = _cfgs("gemma2-2b")
    params = tt.init_params(tc, seed=0, device="cpu")
    for stacked in params["blocks"]:
        layers = tt._unstack(stacked, tc.pattern_repeats)
        assert len(layers) == tc.pattern_repeats
        for r, layer in enumerate(layers):
            for got, w in zip(tree_leaves(layer), tree_leaves(stacked)):
                assert got.data_ptr() == w[r].data_ptr()
                assert torch.equal(got, w[r])


def test_kernel_route_goes_through_the_flash_wrapper(monkeypatch):
    """On CPU tensors the wrapper computes its plain version: one call per
    attention layer of the forward, none on the plain route; the backward
    recomputes ``attention_ref`` and calls no kernel."""
    calls = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda q, k, v, **kw: calls.append(kw)
                        or plain(q, k, v, **kw))
    run = compile_run(RunSpec(arch="gemma2-2b", smoke=True, steps=2,
                              batch=2, seq=128), device="cpu")
    batch = next(iter(run.data))
    run.close()
    run.loss_fn(run.params, batch)
    assert calls == []
    n = run.cfg.num_layers
    use_kernel(run).loss_fn(run.params, batch)
    assert len(calls) == n
    # local and global layers alternate: window 64, then full attention
    assert [c["window"] for c in calls] == [64, 0] * (n // 2)
    assert all(c["causal"] and c["logit_softcap"] == 50.0 for c in calls)
    run.step(batch)
    assert len(calls) == 2 * n


def _quadratic(scales):
    """A loss whose gradient is elementwise f32 arithmetic (``a^2 * p``),
    the same bits in both packages."""
    def jloss(p, _batch):
        return sum(0.5 * jnp.sum(jnp.square(a * x))
                   for a, x in zip(scales, jax.tree.leaves(p)))

    def tloss(p, _batch):
        return sum(0.5 * torch.sum(torch.square(torch.tensor(a) * x))
                   for a, x in zip(scales, tree_leaves(p)))
    return jloss, tloss


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_train_step_on_the_nested_tree_matches_reference(opt):
    jc, tc = _cfgs("gemma2-2b", num_kv_heads=2)
    nparams = jax.tree.map(np.asarray,
                           jt.init_params(jc, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    scales = [rng.uniform(0.5, 2.0, size=x.shape).astype(np.float32)
              for x in jax.tree.leaves(nparams)]
    jloss, tloss = _quadratic(scales)
    if opt == "adamw":
        jopt, topt = JAdamW(weight_decay=0.01), AdamW(weight_decay=0.01)
    else:
        jopt, topt = JMomentumSGD(0.9, 1e-4), MomentumSGD(0.9, 1e-4)
    jstep = jax.jit(jmake_step(jloss, jopt, lambda s: 1e-2, grad_clip=1.0))
    tstep = make_train_step(tloss, topt, lambda s: 1e-2, grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, nparams)
    js = jopt.init(jp)
    tp = params_from_numpy(nparams, "cpu")
    ts = topt.init(tp)
    for i in range(3):
        jp, js, jm = jstep(jp, js, i, None)
        tp, ts, tm = tstep(tp, ts, i, None)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert float(jm["grad_norm"]) > 1.0          # the clip was active
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    states = ((ts.mu, js.mu), (ts.nu, js.nu)) if opt == "adamw" \
        else ((ts.velocity, js.velocity),)
    for tstate, jstate in states:
        for got, want in zip(tree_leaves(tstate), jax.tree.leaves(jstate)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-9)
    if opt == "adamw":
        assert ts.count == int(js.count) == 3


def test_grads_tree_keeps_the_param_tree_structure():
    _, tc = _cfgs("llama3-8b")
    params = tt.init_params(tc, seed=0, device="cpu")
    seen = {}

    class Spy:
        @staticmethod
        def update(grads, state, p, lr):
            seen["grads"] = grads
            return p, state

    step = make_train_step(lambda p, b: tt.lm_loss(p, tc, TCTX, b), Spy(),
                           lambda s: 0.0)
    tokens = torch.tensor(next(lm_token_stream(tc.vocab_size, 2, 32, 0))
                          ["tokens"])
    step(params, None, 0, {"tokens": tokens})
    shapes = map_tree(lambda x: tuple(x.shape), seen["grads"])
    assert shapes == map_tree(lambda x: tuple(x.shape), params)
    assert isinstance(seen["grads"]["blocks"], tuple)
